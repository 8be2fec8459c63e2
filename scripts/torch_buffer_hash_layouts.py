#!/usr/bin/env python3
"""The buffer hash in two layouts on one NVIDIA GPU, in one process.

Run from the root of a checkout::

    python3 scripts/torch_buffer_hash_layouts.py [--reps 20]

The layout the port ships (``csrc/buffer_hash.cu``: one thread per row,
words loaded straight from global memory) beside the tiled layout of
``scripts/torch_buffer_hash_tiled.cu`` (persistent CTAs, each tile of
rows copied into shared memory with 16-byte ``cp.async`` through a
two-stage ring, words read from shared memory; the same ``hash_row``
body).  Per hash x shape — per block count (1, 2, 3, 5) the widest width
it holds and three bytes less, and the main path's XLA widths 376 and
432, 2^22 seeded random rows with lengths uniform in 0..W — both layouts
are held against the plain version on every row (tolerance 0), then
timed with CUDA events in turns (shipped, tiled, tiled, shipped; ``reps``
calls each).  Prints one line per shape, the card's name and power limit,
and as its last line one JSON object with every time.  Exits non-zero
without CUDA or on any mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LANES = 1 << 22
ALGOS = ("md5", "md4", "sha1", "ntlm")
SOURCE = REPO / "scripts" / "torch_buffer_hash_tiled.cu"


def shapes(algo: str) -> list:
    scale = 2 if algo == "ntlm" else 1
    out = []
    for b in (1, 2, 3, 5):
        width = (64 * b - 9) // scale
        out += [width, width - 3]
    return out + [376, 432]


def build() -> dict:
    """One ``nvcc`` per hash, all started together; ``{algo: CDLL}``."""
    from hashcat_a5_table_generator_tpu_torch.ops import _native_build

    out_dir = REPO / "build" / "buffer_hash_tiled"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, algo in enumerate(ALGOS):
        lib = out_dir / f"libbuffer_hash_tiled_{algo}.so"
        procs[algo] = (lib, subprocess.Popen(
            [_native_build.nvcc_path(), *_native_build.NVCC_FLAGS,
             f"-DPIECE_ALGO={i}", f"-I{_native_build.CSRC}", "-o", str(lib),
             str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for algo, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {SOURCE.name} ({algo}):\n{log}")
        for line in log.splitlines():
            if "tiled" in line and ("registers" in line or "stack" in line):
                print(f"ptxas [{algo}] {line.strip()}")
        libs[algo] = ctypes.CDLL(str(lib))
    return libs


def tiled(lib, msg, ln, algo):
    import torch

    from hashcat_a5_table_generator_tpu_torch.ops.hashes import DIGEST_WORDS

    n, width = (int(x) for x in msg.shape)
    state = torch.empty((n, DIGEST_WORDS[algo]), dtype=torch.int32,
                        device=msg.device)
    fn = lib.a5_buffer_hash_tiled
    fn.restype = ctypes.c_int
    err = fn(ctypes.c_void_p(msg.data_ptr()), ctypes.c_void_p(ln.data_ptr()),
             ctypes.c_longlong(n), ctypes.c_int(width),
             ctypes.c_void_p(state.data_ptr()),
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        sys.exit(f"tiled buffer hash ({algo}, width {width}): CUDA error "
                 f"{err}")
    return state


def time_call(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build()
    rows = []
    for algo in ALGOS:
        for width in shapes(algo):
            g = torch.Generator(device="cuda").manual_seed(width)
            msg = torch.randint(0, 256, (LANES, width), dtype=torch.uint8,
                                device="cuda", generator=g)
            ln = torch.randint(0, width + 1, (LANES,), dtype=torch.int32,
                               device="cuda", generator=g)
            want = bh.HASH_FNS[algo](msg, ln)
            got_s = bh.buffer_hash(msg, ln, algo)
            got_t = tiled(libs[algo], msg, ln, algo)
            mis_s = int((got_s != want).any(dim=1).sum())
            mis_t = int((got_t != want).any(dim=1).sum())
            if mis_s or mis_t:
                sys.exit(f"{algo} width {width}: mismatches against the "
                         f"plain version: shipped {mis_s}, tiled {mis_t}")
            t = [time_call(fn, args.reps) for fn in (
                lambda: bh.buffer_hash(msg, ln, algo),
                lambda: tiled(libs[algo], msg, ln, algo),
                lambda: tiled(libs[algo], msg, ln, algo),
                lambda: bh.buffer_hash(msg, ln, algo))]
            shipped, tile = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            rows.append({"algo": algo, "width": width, "rows": LANES,
                         "shipped_ms": shipped, "tiled_ms": tile,
                         "turns_ms": t, "mismatches": 0})
            print(f"buffer_hash/{algo} width {width}, {LANES} rows: shipped "
                  f"{shipped:.4f} ms ({t[0]:.4f} / {t[3]:.4f}), tiled "
                  f"{tile:.4f} ms ({t[1]:.4f} / {t[2]:.4f}), tiled / "
                  f"shipped {tile / shipped:.2f}x; 0 mismatches on either",
                  flush=True)
            del msg, ln, want, got_s, got_t
    print(card)
    print(json.dumps({"card": card, "layouts": rows}))


if __name__ == "__main__":
    main()
