#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name;
2. build every CUDA kernel from ``csrc/`` (``nvcc``, sm_90a) and print the
   ``-Xptxas -v`` register / stack / spill / shared-memory lines;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (2^22 lanes, stride 128, K=1 and pair) plus long-word
   batches that need 2 and 3 hash blocks: emit masks equal and state
   equal on every emitted lane, tolerance 0 (integer arithmetic);
4. the main path through the CLI at full width: a 1M-word rockyou-like
   wordlist x ``qwerty-cyrillic`` against 1M MD5 digests (1000 planted
   hits + decoys), default pair tier, then ``--pair off``; every planted
   plaintext printed exactly once, every printed hit re-hashing to its
   digest, ``candidates hashed`` equal to the host keyspace count, the
   kernels' launch counters above 0 and the plain version never run;
5. each kernel timed with CUDA events at main-path shapes beside its
   bound and its plain version's time.

The last three lines of standard output: the card's name and power limit,
one ``{"kernels": [...]}`` JSON object, and the ``{"ok": true, ...}``
JSON object.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.monotonic()
LANES = 1 << 22
STRIDE = 128
N_WORDS = 1_000_000
N_DIGESTS = 1_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
#: INT32 instructions per MD5 compression on Hopper: per round one LOP3
#: (round function), two IADD3, one SHF (funnel rotate), one IADD.
MD5_OPS_PER_BLOCK = 64 * 5
KERNEL_SOURCE = "hashcat_a5_table_generator_tpu_torch/csrc/piece_md5.cu"
REPLACES = "hashcat_a5_table_generator_tpu/ops/pallas_expand.py:1303"


def log(msg: str) -> None:
    print(f"[{time.monotonic() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# Inputs (made from seeds)
# ---------------------------------------------------------------------------


def synth_words(n: int, seed: int = 0) -> list:
    """Rockyou-like words: lowercase stems of 6-10 letters, 0-2 trailing
    digits (the reference package's bench recipe)."""
    rng = np.random.default_rng(seed)
    stems = rng.integers(ord("a"), ord("z") + 1, size=(n, 10), dtype=np.uint8)
    lens = rng.integers(6, 11, size=n)
    digits = rng.integers(0, 3, size=n)
    words = []
    for i in range(n):
        w = bytes(stems[i, : lens[i]])
        if digits[i]:
            w = w[: -digits[i]] + b"123"[: digits[i]]
        words.append(w)
    return words


def long_words(n: int, lo: int, hi: int, letters: "tuple[int, int]",
               seed: int) -> list:
    """Long dictionary lines (rockyou carries some): digit runs with a few
    letters, ``lo``..``hi`` bytes — they land in the 64- and 128-wide
    buckets, whose candidates need 2 and 3 MD5 blocks."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        w = rng.integers(ord("0"), ord("9") + 1, size=ln, dtype=np.uint8)
        k = int(rng.integers(letters[0], letters[1] + 1))
        pos = rng.choice(ln, size=k, replace=False)
        w[pos] = rng.integers(ord("a"), ord("z") + 1, size=k, dtype=np.uint8)
        out.append(bytes(w))
    return out


def keyspace(plan, spec) -> int:
    """Candidates the plan emits, counted on the host: per word, the
    digit vectors whose chosen count lies in the window (K=1 tables:
    binomials over the active slots)."""
    active = (np.asarray(plan.pat_radix) > 1).sum(axis=1)
    lo, hi = spec.effective_min, spec.max_substitute
    per = {a: sum(math.comb(a, k) for k in range(lo, min(hi, a) + 1))
           for a in np.unique(active).tolist()}
    return int(sum(per[a] for a in active.tolist()))


# ---------------------------------------------------------------------------
# Phase 3 / 5 helpers
# ---------------------------------------------------------------------------


class Case:
    """One kernel input at a given shape: blocks cut on the device from a
    real plan's index."""

    def __init__(self, name, words, sub, *, pair, lanes, stride, device):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, build_plan, cut_blocks, device_arrays,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
        from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
            superstep_index,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.packing import (
            pack_words, piece_schema_for,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.compile import (
            compile_table,
        )

        self.name, self.pair, self.stride = name, pair, stride
        self.spec = AttackSpec()
        ct = compile_table(sub)
        self.plan = build_plan(self.spec, ct, pack_words(words))
        self.pieces = piece_schema_for(self.plan, ct)
        why = fused_expand.kernel_refusal(self.spec, self.plan, ct,
                                          self.pieces)
        if why:
            fail(f"{name}: kernel refuses the plan: {why}")
        rank_stride = stride * (2 if pair else 1)
        idx = superstep_index(self.plan, rank_stride)
        self.arrays = device_arrays(self.plan, self.pieces,
                                    build_digest_set([], "md5"), idx,
                                    device=device)
        nb = lanes // stride
        self.blocks = cut_blocks(self.arrays, 0, nb, rank_stride)[:3]
        self.hash_blocks = fused_expand._hash_blocks_for(self.plan.out_width)
        self.kw = dict(
            pieces=self.pieces, block_stride=stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute, pair=pair,
        )

    def kernel(self):
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

        return fused_expand.fused_expand_md5(*self.blocks, self.arrays,
                                             **self.kw)

    def plain(self):
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand

        kw = dict(self.kw)
        kw.pop("out_width")
        return fused_expand.piece_md5_reference(
            *self.blocks, self.arrays, hash_blocks=self.hash_blocks, **kw
        )

    def bound(self, emit, peak_ops: float) -> "tuple[float, str]":
        """Least time for this input: one MD5 compression per emitted
        candidate (one hash block) over the INT32 peak, against each input
        byte read once and each output byte written once over HBM
        bandwidth."""
        import torch

        assert self.hash_blocks == 1, "timed cases use one hash block"
        ops = float(int(emit.sum())) * MD5_OPS_PER_BLOCK
        words = torch.unique(self.blocks[0])
        row_bytes = sum(
            t[0].numel() * 4 for k, t in self.arrays.items()
            if k in ("pw", "pw16", "pl")
        )
        nb = int(self.blocks[0].shape[0])
        rows = int(emit.shape[0])
        nbytes = (12 * nb + int(words.numel()) * row_bytes
                  + self.arrays["desc"].numel() * 4 + 17 * rows)
        t_ops, t_bytes = ops / peak_ops, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def compare(case) -> dict:
    import torch

    state_k, emit_k = case.kernel()
    state_p, emit_p = case.plain()
    torch.cuda.synchronize()
    emit_mis = int((emit_k != emit_p).sum())
    both = emit_k & emit_p
    diff = (state_k.long() - state_p.long()).abs()[both]
    state_mis = int((diff != 0).any(dim=1).sum()) if diff.numel() else 0
    err = int(diff.max()) if diff.numel() else 0
    log(f"kernel vs plain [{case.name}]: rows {emit_k.shape[0]}, emitted "
        f"{int(emit_p.sum())}, emit mismatches {emit_mis}, state "
        f"mismatches {state_mis}, max abs err {err} (tolerance 0)")
    if emit_mis or state_mis:
        fail(f"{case.name}: kernel disagrees with its plain version")
    return {"mismatches": emit_mis + state_mis, "max_abs_err": err,
            "emit": emit_p}


def time_call(fn, reps: int) -> float:
    """Mean ms per call with CUDA events, after one warm-up call."""
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


def stage_breakdown(case, digest_set) -> None:
    """Where one main-path launch spends its device time: the superstep
    body's stages timed apart at the pair tier's shapes against the 1M
    digest set."""
    import torch

    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        cut_blocks, make_superstep_body, superstep_buffers,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        digest_member,
    )

    dev = torch.device("cuda")
    arrays = dict(case.arrays)
    arrays["rows"] = torch.as_tensor(digest_set.rows.view(np.int32),
                                     device=dev)
    arrays["bitmap"] = torch.as_tensor(digest_set.bitmap.view(np.int32),
                                       device=dev)
    nb = int(case.blocks[0].shape[0])
    rank_stride = case.stride * 2
    state, emit = case.kernel()
    body = make_superstep_body(
        case.spec, num_lanes=nb * case.stride,
        out_width=int(case.plan.out_width), block_stride=case.stride,
        num_blocks=nb, pieces=case.pieces, pair_k=2,
    )
    bufs = superstep_buffers(4096, device=dev)
    t_cut = time_call(lambda: cut_blocks(arrays, 0, nb, rank_stride), 10)
    t_kernel = time_call(case.kernel, 10)
    t_member = time_call(
        lambda: digest_member(state, arrays["rows"], arrays["bitmap"]), 3)
    t_step = time_call(lambda: body(arrays, 0, 1, bufs), 3)
    rest = t_step - t_cut - t_kernel - t_member
    log(f"stage breakdown, one pair launch ({emit.shape[0]} candidate "
        f"rows, {digest_set.size} digests), CUDA events: whole step "
        f"{t_step:.3f} ms = block cut {t_cut:.3f} ms + piece kernel "
        f"{t_kernel:.3f} ms + membership {t_member:.3f} ms + hit "
        f"compaction and the rest {rest:.3f} ms")


# ---------------------------------------------------------------------------
# Phase 4: the main path through the CLI
# ---------------------------------------------------------------------------


def run_cli(argv) -> "tuple[bytes, str, int]":
    """``cli.main(argv)`` with stdout/stderr captured."""
    from hashcat_a5_table_generator_tpu_torch import cli

    out = io.BytesIO()
    real = sys.stdout
    sys.stdout = wrapper = io.TextIOWrapper(out, write_through=True)
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    finally:
        wrapper.flush()
        wrapper.detach()
        sys.stdout = real
    return out.getvalue(), err.getvalue(), rc


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a CUDA device")
    sys.path.insert(0, HERE)
    try:
        from hashcat_a5_table_generator_tpu_torch.ops import (
            _native_build, fused_expand,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
            emit_table, get_layout,
        )
    except ImportError as e:
        fail(f"the PyTorch/CUDA package is not importable here ({e})")

    # -- phase 1: the card --------------------------------------------------
    card = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # The INT32 peak (and so every bound_ms) rests on the clock read here;
    # a failed query fails the smoke rather than assume one.
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_ops = props.multi_processor_count * 64 * clock_mhz * 1e6
    log(f"card: {card}; torch: {kind}; {props.multi_processor_count} SMs, "
        f"max SM clock {clock_mhz:.0f} MHz; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"INT32 peak assumed: SMs x 64 INT32 lanes/clock x max clock = "
        f"{peak_ops:.4g} ops/s (Hopper white paper: 64 INT32 units per "
        f"SM); MD5 = {MD5_OPS_PER_BLOCK} INT32 ops per block per candidate")

    # -- phase 2: build -----------------------------------------------------
    t = time.monotonic()
    reports = _native_build.build(["piece_md5"])
    log(f"built csrc/piece_md5.cu in {time.monotonic() - t:.1f} s "
        f"(nvcc {' '.join(_native_build.NVCC_FLAGS)})")
    for line in reports["piece_md5"].splitlines():
        if re.search(r"Compiling entry|registers|spill|stack frame|smem",
                     line):
            print(f"  ptxas: {line.strip()}")

    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    dev = torch.device("cuda")

    # -- phase 3: kernels vs plain on the card ------------------------------
    head = synth_words(60_000, seed=1)
    cases = {
        "k1": Case("piece_md5_k1, 1 hash block", head, sub, pair=False,
                   lanes=LANES, stride=STRIDE, device=dev),
        "pair": Case("piece_md5_pair", head, sub, pair=True, lanes=LANES,
                     stride=STRIDE, device=dev),
        "k1_hb2": Case("piece_md5_k1, 2 hash blocks",
                       long_words(400, 33, 64, (4, 10), seed=2), sub,
                       pair=False, lanes=1 << 20, stride=STRIDE,
                       device=dev),
        "k1_hb3": Case("piece_md5_k1, 3 hash blocks",
                       long_words(200, 100, 128, (3, 8), seed=3), sub,
                       pair=False, lanes=1 << 19, stride=STRIDE,
                       device=dev),
    }
    for key, hb in (("k1", 1), ("pair", 1), ("k1_hb2", 2), ("k1_hb3", 3)):
        if cases[key].hash_blocks != hb:
            fail(f"{key}: expected {hb} hash blocks, plan gives "
                 f"{cases[key].hash_blocks}")
    checks = {key: compare(case) for key, case in cases.items()}

    # -- phase 4: the main path at full width -------------------------------
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec, build_plan, decode_variant,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        build_digest_set,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        piece_schema_for, read_packed_buckets,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )

    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    table = os.path.join(work, "qwerty-cyrillic.table")
    emit_table(get_layout("qwerty-cyrillic"), table)
    # Unique words: qwerty-cyrillic maps letters one-to-one onto 2-byte
    # Cyrillic, so distinct words never share a candidate and every
    # planted plaintext has exactly one source.
    words = list(dict.fromkeys(synth_words(N_WORDS + 1000, seed=0)))
    words = words[: N_WORDS - 120]
    rng = np.random.default_rng(4)
    for w in long_words(100, 33, 64, (4, 10), seed=5) + \
            long_words(20, 65, 110, (3, 8), seed=6):
        words.insert(int(rng.integers(0, len(words))), w)
    wordlist = os.path.join(work, "words.txt")
    with open(wordlist, "wb") as fh:
        fh.write(b"\n".join(words) + b"\n")

    spec = AttackSpec()
    ct = compile_table(sub)
    prep = {}
    t = time.monotonic()
    buckets = read_packed_buckets(wordlist)
    prep["read_packed_buckets"] = time.monotonic() - t
    planted, want_emitted = {}, 0
    for width, packed in buckets.items():
        t = time.monotonic()
        plan = build_plan(spec, ct, packed)
        prep["build_plan"] = prep.get("build_plan", 0.0) \
            + time.monotonic() - t
        if width == 16:
            t = time.monotonic()
            piece_schema_for(plan, ct)
            prep["piece_schema_for (bucket 16)"] = time.monotonic() - t
        want_emitted += keyspace(plan, spec)
        for row in np.flatnonzero((packed.index % 1000 == 0)
                                  | ((width > 16) & (packed.index % 7 == 0))):
            nv = plan.n_variants[row]
            if nv < 2:
                continue
            cand = decode_variant(plan, ct, spec, int(row), nv // 2)
            planted[hashlib.md5(cand).hexdigest()] = cand
    decoys = rng.integers(0, 256, size=(N_DIGESTS - len(planted), 16),
                          dtype=np.uint8)
    digest_rows = np.concatenate([
        np.frombuffer(b"".join(bytes.fromhex(d) for d in planted),
                      np.uint8).reshape(-1, 16), decoys])
    t = time.monotonic()
    digest_set = build_digest_set(digest_rows, "md5")
    prep["build_digest_set (1M)"] = time.monotonic() - t
    log("host prep on this machine's CPU: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in prep.items()))
    digest_file = os.path.join(work, "digests.txt")
    with open(digest_file, "w") as fh:
        fh.write("\n".join(list(planted) + [d.tobytes().hex()
                                            for d in decoys]) + "\n")
    log(f"main path inputs: {len(words)} words in buckets "
        f"{ {w: p.batch for w, p in buckets.items()} }, "
        f"{N_DIGESTS} digests ({len(planted)} planted), host keyspace "
        f"{want_emitted}")

    small = os.path.join(work, "small.txt")
    with open(small, "wb") as fh:
        fh.write(b"\n".join(words[:2000]) + b"\n")
    base = ["-t", table, "--backend", "device", "--algo", "md5",
            "--digests", digest_file]
    _out, err, rc = run_cli([small] + base)
    if rc != 0:
        fail(f"warm-up run exited {rc}: {err}")

    runs = {}
    for arm, extra in (("pair auto", []), ("pair off", ["--pair", "off"])):
        for k in fused_expand.LAUNCHES:
            fused_expand.LAUNCHES[k] = 0
        fused_expand.PLAIN_CALLS = 0
        t = time.monotonic()
        out, err, rc = run_cli([wordlist] + base + extra)
        wall = time.monotonic() - t
        launches = dict(fused_expand.LAUNCHES)
        plain = fused_expand.PLAIN_CALLS
        if rc != 0:
            fail(f"main path ({arm}) exited {rc}: {err}")
        lines = out.decode("utf-8", "surrogateescape").splitlines()
        hits = [ln.split(":", 1) for ln in lines]
        got = [bytes.fromhex(p[5:-1]) if p.startswith("$HEX[") else
               p.encode("utf-8", "surrogateescape") for _d, p in hits]
        for (d, _p), cand in zip(hits, got):
            if hashlib.md5(cand).hexdigest() != d:
                fail(f"{arm}: printed hit does not re-hash: {d}")
        counts = {}
        for cand in got:
            counts[cand] = counts.get(cand, 0) + 1
        missing = [c for c in planted.values() if counts.get(c, 0) != 1]
        if missing:
            fail(f"{arm}: {len(missing)} planted hits not printed exactly "
                 f"once, e.g. {missing[:3]!r}")
        m = re.search(r"(\d+) hits, (\d+) candidates hashed", err)
        s = re.search(r"([\d.]+) s wall, ([\d.]+) s superstep drive, "
                      r"([\d.e+]+) candidate-hashes/s", err)
        if not m or not s:
            fail(f"{arm}: no summary on stderr: {err}")
        emitted = int(m.group(2))
        if emitted != want_emitted:
            fail(f"{arm}: {emitted} candidates hashed, host keyspace "
                 f"{want_emitted}")
        if plain:
            fail(f"{arm}: the plain version ran {plain} times on the main "
                 "path")
        runs[arm] = dict(hits=sorted(got), launches=launches,
                         emitted=emitted, wall=wall,
                         sweep_wall=float(s.group(1)),
                         drive=float(s.group(2)), rate=float(s.group(3)))
        log(f"main path ({arm}): {len(got)} hits, {emitted} candidates "
            f"hashed, launches {launches}, CLI wall {wall:.2f} s, sweep "
            f"{s.group(1)} s (drive {s.group(2)} s), {s.group(3)} "
            f"candidate-hashes/s on {card}")
    if runs["pair auto"]["hits"] != runs["pair off"]["hits"]:
        fail("--pair off printed different hits")
    if runs["pair auto"]["launches"]["piece_md5_pair"] <= 0:
        fail("the main path never launched piece_md5_pair")
    if runs["pair auto"]["launches"]["piece_md5_k1"] <= 0:
        fail("the main path never launched piece_md5_k1 (long-word buckets)")
    if runs["pair off"]["launches"]["piece_md5_k1"] <= 0:
        fail("--pair off never launched piece_md5_k1")
    shutil.rmtree(work, ignore_errors=True)

    # -- phase 5: timing ----------------------------------------------------
    kernels = []
    for key, name in (("k1", "piece_md5_k1"), ("pair", "piece_md5_pair")):
        case = cases[key]
        ms = time_call(case.kernel, 20)
        plain_ms = time_call(case.plain, 2)
        emit = checks[key]["emit"]
        bound_ms, bound_by = case.bound(emit, peak_ops)
        rows = int(emit.shape[0])
        log(f"{name}: {ms:.4f} ms/launch over {rows} candidate rows "
            f"({rows / ms * 1e3:.4g} candidates/s, "
            f"{int(emit.sum()) / ms * 1e3:.4g} emitted/s); bound "
            f"{bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.3f} ms")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": runs["pair auto"]["launches"][name],
            "launches_pair_off": runs["pair off"]["launches"][name],
            "mismatches": checks[key]["mismatches"],
            "max_abs_err": checks[key]["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    stage_breakdown(cases["pair"], digest_set)
    elapsed = time.monotonic() - T0
    log(f"done in {elapsed:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
