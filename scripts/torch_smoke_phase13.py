#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone (the port's audit: every kernel
instantiation's ptxas registers, stack and spills within its pin in
``csrc/kernel_budgets.json``, and each registered fused body run once at
2^22 lanes on the crack and german cells' first bucket of each route
under ``torch.cuda.set_sync_debug_mode("error")``), with the inputs it
takes from phases 2 and 4: the nvcc builds' ptxas reports and the two
cells' wordlists and digests.  Then, as an observation beside it, the
crack cell's sweep at pipeline depth 2 and 3 (``SweepConfig.
max_in_flight``), in turns.  Run from the root of a checkout, on a GPU::

    python3 scripts/torch_smoke_phase13.py [--json PATH] [--no-depths]

Prints ``chip_smoke.py``'s log lines and every instantiation's ptxas line,
then the ``{"audit": {...}}`` line and the card's name and power limit;
with ``--json`` the phase's numbers (each instantiation's measured
resources included) also go to ``PATH``."""
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
work = os.path.join(ROOT, "build", "phase13")
shutil.rmtree(work, ignore_errors=True)
os.makedirs(work)
libs = [f"{k}_{a}" for k in ("piece_hash", "bytescan_hash", "buffer_hash")
        for a in cs.ALGOS]
reports = _native_build.build(libs)
cs.log(f"built {len(libs)} libraries in {time.monotonic() - t0:.1f} s")
for lib in libs:
    for kernel, info in cs.ptxas_kernels(reports[lib]):
        print(f"  ptxas [{lib}]: {kernel}: {info}")
card = cs.nvidia_smi("name,power.limit")
paths = {
    "cyrillic-md5": cs.MainPath(
        "cyrillic-md5", work, cs.dictionary(cs.N_WORDS_DEFAULT, seed=0),
        "qwerty-cyrillic", "md5", {}, seed=10),
    "german-md5": cs.MainPath("german-md5", work, cs.german_cell_words(),
                              "german", "md5", {}, seed=42),
}
audited = cs.audit_phase(reports, paths, card)
report = {"audit": audited,
          "measured": cs.check_kernel_pins(reports)["measured"]}
if "--no-depths" not in sys.argv:
    from hashcat_a5_table_generator_tpu_torch.native import (
        read_packed_buckets,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.bucketed import (
        BucketedSweep,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        SweepConfig,
    )

    path = paths["cyrillic-md5"]
    buckets = read_packed_buckets(path.wordlist)
    depths = []
    for depth in (2, 3, 3, 2):
        res = BucketedSweep(path.spec, path.sub, buckets, path.digest_rows,
                            SweepConfig(device="cuda", lanes=cs.LANES,
                                        max_in_flight=depth)).run_crack()
        if res.n_hits != len(path.planted):
            cs.fail(f"depth {depth}: {res.n_hits} hits, want "
                    f"{len(path.planted)}")
        depths.append({"max_in_flight": depth, "drive_s": res.drive_s,
                       "wall_s": res.wall_s, "hits": res.n_hits,
                       "emitted": res.n_emitted})
        cs.log(f"crack cell at max_in_flight {depth}: drive "
               f"{res.drive_s:.3f} s, wall {res.wall_s:.3f} s, "
               f"{res.n_hits} hits, {res.n_emitted} emitted")
    report["depths"] = depths
if "--json" in sys.argv:
    with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
        json.dump(report, fh, indent=1)
shutil.rmtree(work, ignore_errors=True)
print(json.dumps({"audit": audited}))
print(card)
cs.log(f"phase 13 with its inputs: {time.monotonic() - t0:.1f} s")
