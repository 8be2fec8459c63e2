#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone (the fleet router, ``a5gen fleet
--engines 2`` on one GPU, and the elastic fleet, ``--engines 1
--autoscale 1:2``), with the inputs it takes from phases 4 and 10:
the phase-4 crack cell run and phase 10's tenants with their solo runs
(``chip_smoke.serve_inputs``), but none of phase 10's sessions.  Run from
the root of a checkout, on a GPU::

    python3 scripts/torch_smoke_phase11.py [--json PATH]

Prints ``chip_smoke.py``'s log lines, then the ``{"fleet": {...}}`` line
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

cs.arm_deadline(1180)
t0 = time.monotonic()
_native_build.build([f"{k}_{a}" for k in ("piece_hash", "bytescan_hash",
                                          "buffer_hash") for a in cs.ALGOS])
cs.log(f"built in {time.monotonic() - t0:.1f} s")
card = cs.nvidia_smi("name,power.limit")
work = os.path.join(ROOT, "build", "phase11")
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
inputs = cs.serve_inputs(work, paths, runs)
fleet = cs.fleet_phase(work, inputs, card)
if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(fleet, fh, indent=1)
print(json.dumps({"fleet": fleet}))
print(card)
cs.log(f"phase 11 with its inputs: {time.monotonic() - t0:.1f} s")
