#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` alone, with the phase-4 runs it compares
against (the warm-up run, the crack cell pair auto, azerty ``-s`` native
and ``A5_NATIVE=0``, the huge word, the candidates cells).
Run from the root of a checkout, on a GPU::

    python3 scripts/torch_smoke_phase9.py [--json PATH]

Prints ``chip_smoke.py``'s log lines, then the ``{"pod": {...}}`` line and
the card's name and power limit; with ``--json`` the phase's numbers also
go to ``PATH``."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import chip_smoke as cs  # noqa: E402
import numpy as np  # noqa: E402

from hashcat_a5_table_generator_tpu_torch.ops import _native_build  # noqa

t0 = time.monotonic()
_native_build.build([f"{k}_{a}" for k in ("piece_hash", "bytescan_hash",
                                          "buffer_hash") for a in cs.ALGOS])
cs.log(f"built in {time.monotonic() - t0:.1f} s")
card = cs.nvidia_smi("name,power.limit")
work = os.path.join(ROOT, "build", "phase9")
import shutil  # noqa: E402

shutil.rmtree(work, ignore_errors=True)
os.makedirs(work)

words = cs.dictionary(cs.N_WORDS_DEFAULT, seed=0)
azerty_words = cs.dictionary(cs.N_WORDS_DEFAULT - 2000, seed=21,
                             long_lines=False)
rng = np.random.default_rng(22)
for w in dict.fromkeys(cs.azerty_lines(2000, seed=23)):
    azerty_words.insert(int(rng.integers(0, len(azerty_words))), w)
paths = {
    "cyrillic-md5": cs.MainPath("cyrillic-md5", work, words,
                                "qwerty-cyrillic", "md5", {}, seed=10),
    "azerty-md5-s": cs.MainPath(
        "azerty-md5-s", work, azerty_words, "qwerty-azerty", "md5",
        {"mode": "suball"}, seed=25,
        quota={"device_closed": 120, "oracle_fallback": 60}),
}
small = os.path.join(work, "small.txt")
with open(small, "wb") as fh:
    fh.write(b"\n".join(words[:2000]) + b"\n")
warm = [small, "-t", paths["cyrillic-md5"].table, "--backend", "device",
        "--algo", "md5", "--digests", paths["cyrillic-md5"].digests]
out, err, rc = cs.run_cli(warm)
if rc != 0:
    cs.fail(f"warm-up run exited {rc}: {err}")
runs = {("small", "warm-up"): {"argv": warm, "stdout": out}}
for name, arm, extra, native in (
        ("cyrillic-md5", "pair auto", [], None),
        ("azerty-md5-s", "-s", ["-s"], None),
        ("azerty-md5-s", "A5_NATIVE=0 -s", ["-s"], "0")):
    runs[(name, arm)] = paths[name].run(arm, extra, card, native=native)
runs[("huge-word", "per-launch")] = cs.huge_word_run(work, card)
cand_cells = cs.candidates_checks(work, cs.dictionary, card)
pod = cs.pod_phase(work, paths, runs, cand_cells, card)
import json  # noqa: E402

if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(pod, fh, indent=1)
print(json.dumps({"pod": pod}))
print(card)
cs.log(f"phase 9 with its phase-4 runs: {time.monotonic() - t0:.1f} s")
