#!/usr/bin/env python3
"""Several GPUs of one machine: ``--devices N`` and a pod of one process
a card, against one device, on the crack cell and candidates cyrillic of
``chip_smoke.py`` (250k words x qwerty-cyrillic x MD5 with 1M digests;
2e4 words to stdout).  Run from the root of a checkout on a machine with
two or more GPUs::

    python3 scripts/torch_devices_check.py [--json PATH]

Checks, any failure exiting non-zero: ``--devices N`` (N = every card)
and ``--devices auto`` print the one-device stdout byte for byte (the
plain version never runs); ``--devices N+1`` exits non-zero
with the device-count message; candidates mode at ``--devices N`` writes
the one-device stream; a pod of N processes, one a card
(``CUDA_VISIBLE_DEVICES``), over gloo: process 0's gathered stdout and
the ``--giant-job`` one equal the one-device stdout.  Prints each run's
drive, wall and launches, the cards' names and power limit, and one
``{"devices": {...}}`` JSON line (also written to ``PATH``).
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)
import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from hashcat_a5_table_generator_tpu_torch.ops import _native_build  # noqa


def main() -> None:
    n = torch.cuda.device_count()
    if n < 2:
        cs.fail(f"this check needs two or more GPUs, have {n}")
    t0 = time.monotonic()
    _native_build.build([f"{k}_{a}" for k in ("piece_hash", "bytescan_hash",
                                              "buffer_hash")
                         for a in cs.ALGOS])
    card = cs.nvidia_smi("name,power.limit")
    work = os.path.join(ROOT, "build", "devices_check")
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    words = list(dict.fromkeys(cs.synth_words(cs.N_WORDS_DEFAULT + 1000,
                                              seed=0)))[:cs.N_WORDS_DEFAULT]
    cyr = cs.MainPath("cyrillic-md5", work, words, "qwerty-cyrillic",
                      "md5", {}, seed=10)
    report: dict = {"cards": n, "crack": {}, "candidates": {}, "pod": {}}
    one = cyr.run("--devices 1", ["--devices", "1"], card)
    report["crack"]["1"] = {"drive_s": one["drive"], "wall_s": one["wall"],
                            "launches": one["launches"]}
    for arm in (str(n), "auto"):
        run = cyr.run(f"--devices {arm}", ["--devices", arm], card)
        if run["stdout"] != one["stdout"]:
            cs.fail(f"--devices {arm}: stdout differs from one device's")
        report["crack"][arm] = {"drive_s": run["drive"],
                                "wall_s": run["wall"],
                                "launches": run["launches"]}
    argv = [cyr.wordlist, "-t", cyr.table, "--backend", "device",
            "--digests", cyr.digests]
    out, err, rc = cs.run_cli(argv + ["--devices", str(n + 1)])
    msg = f"requested {n + 1} devices, have {n}"
    if rc == 0 or msg not in err:
        cs.fail(f"--devices {n + 1}: exit {rc}: {err}")
    cs.log(f"--devices {n + 1}: exit {rc}, {msg!r}")

    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        emit_table, get_layout,
    )

    cand_words = list(dict.fromkeys(cs.synth_words(21000, seed=71)))[:20000]
    wl = os.path.join(work, "cand.words.txt")
    with open(wl, "wb") as fh:
        fh.write(b"\n".join(cand_words) + b"\n")
    table = os.path.join(work, "qwerty-cyrillic.table")
    emit_table(get_layout("qwerty-cyrillic"), table)
    streams = {}
    for arm in ("1", str(n)):
        t = time.monotonic()
        out, err, rc = cs.run_cli([wl, "-t", table, "--backend", "device",
                                   "--devices", arm])
        wall = time.monotonic() - t
        loop = re.search(r"([\d.]+) s launch loop", err)
        if rc != 0 or not loop:
            cs.fail(f"candidates --devices {arm}: exit {rc}: {err}")
        streams[arm] = out
        report["candidates"][arm] = {"launch_loop_s": float(loop.group(1)),
                                     "wall_s": wall, "bytes": len(out)}
        cs.log(f"candidates cyrillic --devices {arm}: {len(out)} bytes, "
               f"launch loop {loop.group(1)} s, wall {wall:.2f} s on {card}")
    if streams[str(n)] != streams["1"]:
        cs.fail(f"candidates --devices {n}: the stream differs from one "
                "device's")

    for label, extra in (("gathered", []), ("giant job", ["--giant-job"])):
        port = cs.free_port()
        procs, t = [], time.monotonic()
        for p in range(n):
            out = open(os.path.join(work, f"pod{p}.out"), "wb")
            err = open(os.path.join(work, f"pod{p}.err"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
                 *argv, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(p), *extra],
                cwd=ROOT, stdout=out, stderr=err,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=str(p))), out,
                err))
        rows = []
        for proc, out, err in procs:
            rc = proc.wait(timeout=900)
            out.close()
            err.close()
            with open(err.name) as fh:
                text = fh.read()
            rows.append({"rc": rc, "wall_s": time.monotonic() - t,
                         "launches": cs.stderr_launches(text)})
            if rc != 0:
                cs.fail(f"pod [{label}] process exited {rc}: {text[-2000:]}")
        with open(os.path.join(work, "pod0.out"), "rb") as fh:
            got = fh.read()
        if got != one["stdout"]:
            cs.fail(f"pod [{label}, {n} processes, one a card]: process 0's "
                    "stdout differs from one device's")
        report["pod"][label] = rows
        cs.log(f"pod [{label}, {n} processes, one a card]: process 0's "
               f"stdout byte-identical to one device's; " + "; ".join(
                   f"process {p}: wall {r['wall_s']:.2f} s, launches "
                   f"{r['launches']}" for p, r in enumerate(rows))
               + f" on {card}")
    report["wall_s"] = time.monotonic() - t0
    if "--json" in sys.argv:
        with open(sys.argv[sys.argv.index("--json") + 1], "w") as fh:
            json.dump(report, fh, indent=1)
    print(card)
    print(json.dumps({"devices": report}))


if __name__ == "__main__":
    main()
