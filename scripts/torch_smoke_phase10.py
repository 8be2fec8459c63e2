#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` alone (the resident engine, ``a5gen
serve``), with the phase-4 crack cell run it compares against.  Run from
the root of a checkout, on a GPU::

    python3 scripts/torch_smoke_phase10.py [--json PATH]

Prints ``chip_smoke.py``'s log lines, then the ``{"serve": {...}}`` line
and the card's name and power limit; with ``--json`` the phase's numbers
also go to ``PATH``."""
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import chip_smoke as cs  # noqa: E402

from hashcat_a5_table_generator_tpu_torch.ops import _native_build  # noqa

t0 = time.monotonic()
_native_build.build([f"{k}_{a}" for k in ("piece_hash", "bytescan_hash",
                                          "buffer_hash") for a in cs.ALGOS])
cs.log(f"built in {time.monotonic() - t0:.1f} s")
card = cs.nvidia_smi("name,power.limit")
work = os.path.join(ROOT, "build", "phase10")
shutil.rmtree(work, ignore_errors=True)
os.makedirs(work)

words = cs.dictionary(cs.N_WORDS_DEFAULT, seed=0)
czech = cs.dictionary(cs.N_WORDS_CELL, seed=11, long_lines=False)
paths = {
    "cyrillic-md5": cs.MainPath("cyrillic-md5", work, words,
                                "qwerty-cyrillic", "md5", {}, seed=10),
    "czech-ntlm": cs.MainPath("czech-ntlm", work, czech, "czech", "ntlm",
                              {}, seed=12),
}
runs = {("cyrillic-md5", "pair auto"): paths["cyrillic-md5"].run(
    "pair auto", [], card)}
serve = cs.serve_phase(work, paths, runs, card)
if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(serve, fh, indent=1)
print(json.dumps({"serve": serve}))
print(card)
cs.log(f"phase 10 with its phase-4 run: {time.monotonic() - t0:.1f} s")
