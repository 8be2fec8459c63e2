#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone (the geometry tuner: ``a5gen tune
--smoke``, a bounded matrix through ``runtime.tune.run_autotune``, the
crack cell from the profile it writes), with the input it takes from
phase 4: the crack cell's run.  Run from the root of a checkout, on a
GPU::

    python3 scripts/torch_smoke_phase12.py [--json PATH]

Prints ``chip_smoke.py``'s log lines, then the ``{"tune": {...}}`` line
and the card's name and power limit; with ``--json`` the phase's numbers
also go to ``PATH``.  Profiles go to a directory under ``build/phase12``
(``A5GEN_TUNE_PROFILE``), never to the home directory."""
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

import torch  # noqa: E402

cs.arm_deadline(1180)
t0 = time.monotonic()
work = os.path.join(ROOT, "build", "phase12")
shutil.rmtree(work, ignore_errors=True)
os.makedirs(work)
os.environ["A5GEN_TUNE_PROFILE"] = os.path.join(work, "tune-profiles")
_native_build.build([f"{k}_{a}" for k in ("piece_hash", "bytescan_hash",
                                          "buffer_hash") for a in cs.ALGOS])
cs.log(f"built in {time.monotonic() - t0:.1f} s")
card = cs.nvidia_smi("name,power.limit")
kind = torch.cuda.get_device_name(0)
words = cs.dictionary(cs.N_WORDS_DEFAULT, seed=0)
path = cs.MainPath("cyrillic-md5", work, words, "qwerty-cyrillic", "md5",
                   {}, seed=10)
run = path.run("pair auto", [], card)
tuned = cs.tune_phase(work, path, run, kind, card)
if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(tuned, fh, indent=1)
print(json.dumps({"tune": tuned}))
print(card)
cs.log(f"phase 12 with its input: {time.monotonic() - t0:.1f} s")
