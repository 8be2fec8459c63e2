#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` alone, with the phase-4 runs it compares
against (the crack cell pair auto, cyrillic-x2-long, azerty ``-s`` native
/ ``A5_NATIVE=0`` / native again, the huge word, the candidates cells).
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


def dictionary(n, seed, long_lines=True):
    out = list(dict.fromkeys(cs.synth_words(n + 1000, seed=seed)))
    out = out[: n - (120 if long_lines else 0)]
    if long_lines:
        rng = np.random.default_rng(4)
        for w in cs.long_words(100, 33, 64, (4, 10), seed=5) + \
                cs.long_words(20, 50, 64, (3, 8), seed=6):
            out.insert(int(rng.integers(0, len(out))), w)
    return out


words = dictionary(cs.N_WORDS_DEFAULT, seed=0)
long_1m = dictionary(cs.N_WORDS - 3000, seed=0, long_lines=False)
rng = np.random.default_rng(81)
for w in cs.long_lines(2000, seed=82) + cs.letter_lines(1000, seed=83):
    long_1m.insert(int(rng.integers(0, len(long_1m))), w)
azerty_words = dictionary(cs.N_WORDS_DEFAULT - 2000, seed=21,
                          long_lines=False)
rng = np.random.default_rng(22)
for w in dict.fromkeys(cs.azerty_lines(2000, seed=23)):
    azerty_words.insert(int(rng.integers(0, len(azerty_words))), w)
paths = {
    "cyrillic-md5": cs.MainPath("cyrillic-md5", work, words,
                                "qwerty-cyrillic", "md5", {}, seed=10),
    "cyrillic-x2-long": cs.MainPath(
        "cyrillic-x2-long", work, long_1m, "qwerty-cyrillic", "md5",
        {"max_substitute": 2}, seed=84),
    "azerty-md5-s": cs.MainPath(
        "azerty-md5-s", work, azerty_words, "qwerty-azerty", "md5",
        {"mode": "suball"}, seed=25,
        quota={"device_closed": 120, "oracle_fallback": 60}),
}
small = os.path.join(work, "small.txt")
with open(small, "wb") as fh:
    fh.write(b"\n".join(words[:2000]) + b"\n")
cs.run_cli([small, "-t", paths["cyrillic-md5"].table, "--backend", "device",
            "--digests", paths["cyrillic-md5"].digests])
runs = {}
for name, arm, extra, native in (
        ("cyrillic-md5", "pair auto", [], None),
        ("cyrillic-x2-long", "-x 2", ["-x", "2"], None),
        ("azerty-md5-s", "-s", ["-s"], None),
        ("azerty-md5-s", "A5_NATIVE=0 -s", ["-s"], "0"),
        ("azerty-md5-s", "-s, native again", ["-s"], None)):
    runs[(name, arm)] = paths[name].run(arm, extra, card, native=native)
runs[("huge-word", "per-launch")] = cs.huge_word_run(work, card)
cand_cells = cs.candidates_checks(work, dictionary, card)
pod = cs.pod_phase(work, paths, runs, cand_cells, card)
import json  # noqa: E402

if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(pod, fh, indent=1)
print(json.dumps({"pod": pod}))
print(card)
cs.log(f"phase 9 with its phase-4 runs: {time.monotonic() - t0:.1f} s")
