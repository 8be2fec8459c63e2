#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA package on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, the torch device name,
   the SM clock the INT32 peak rests on;
2. build every CUDA library from ``csrc/`` (``nvcc``, sm_90a; the piece
   kernel once per hash, all compilers started together) and print the
   ``-Xptxas -v`` register / stack / spill / shared-memory lines;
3. every kernel entry point x hash against its plain PyTorch version on
   the card, at the main path's shapes (2^22 lanes, stride 128): the
   scalar K=1 and pair tiers, the digit decode (czech, qwerty-azerty, the
   pair tier on a three-option table), the windowed decode (``-x 2``),
   plus batches that need 2 and 3 hash blocks (MD5, NTLM, SHA-1); emit
   masks equal and state equal on every emitted lane, tolerance 0
   (integer arithmetic);
4. the main path through the CLI at full width, 1M dictionary words and
   1M digests of the run's hash (1000 planted hits + decoys) each:
   qwerty-cyrillic x MD5 with the pair tier auto and off, czech x NTLM,
   greek words x greek-hebrew x SHA-1 (pair auto and off), and
   qwerty-cyrillic x MD5 ``-x 2``; every planted plaintext printed
   exactly once, every printed hit re-hashing to its digest, ``candidates
   hashed`` equal to the host keyspace, the expected kernels' launch
   counters above 0 and the plain version never run;
5. each entry point x hash timed with CUDA events at main-path shapes
   beside its bound and its plain version's time; stage breakdowns of one
   launch (membership against the 1M-digest sets) and the masked-row
   share of the czech run.

The last three lines of standard output: the card's name and power limit,
one ``{"kernels": [...]}`` JSON object, and the ``{"ok": true, ...}``
JSON object.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
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
N_PLANTED = 1000
CASE_WORDS = 60_000  # words per phase-3 workload
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
ALGOS = ("md5", "md4", "sha1", "ntlm")
#: INT32 instructions per compression on Hopper, counted from the
#: unrolled rounds of csrc/piece_hash.cu:
#: * MD5: 64 steps x (one LOP3 round function, two IADD3 for
#:   a + f + m + K, one SHF funnel rotate, one IADD for b + rot) = 320;
#: * MD4 (and NTLM): 16 steps x (LOP3, IADD3 a + f + m, SHF) + 32 steps x
#:   (LOP3, IADD3, IADD for + K, SHF) = 48 + 128 = 176;
#: * SHA-1: 16 byte swaps (PRMT) + 64 schedule words x (two LOP3 for the
#:   four-way XOR, one SHF) + 80 steps x (SHF rotl 5, LOP3 round function,
#:   two IADD3 for rotl(a) + f + e + K + w, SHF rotl 30) = 16 + 192 + 400
#:   = 608.
OPS_PER_BLOCK = {"md5": 320, "md4": 176, "ntlm": 176, "sha1": 608}
STATE_WORDS = {"md5": 4, "md4": 4, "ntlm": 4, "sha1": 5}
DIGEST_BYTES = {"md5": 16, "md4": 16, "ntlm": 16, "sha1": 20}
KERNEL_SOURCE = "hashcat_a5_table_generator_tpu_torch/csrc/piece_hash.cu"
PALLAS = "hashcat_a5_table_generator_tpu/ops/pallas_expand.py"
#: The branch of the TPU body (``_make_piece_kernel`` :1303) each entry
#: point replaces, and each hash's rounds.
BRANCHES = {
    "k1": "scalar-units full enumeration (:1415-1421), K=1",
    "pair": "pair=True, scalar decode (:1401-1456)",
    "pair_digits": "pair=True, digit decode (d0p :1430-1435, cc1 :1458, "
                   "idx1 :1571-1579)",
    "digits": "general tier (_decode_tile :773, col_variant :1478, clamp "
              ":1557-1564, merged columns :1565-1570)",
    "windowed": "windowed tier (_decode_tile_windowed :333, cb packing "
                ":1436-1446)",
}
ROUNDS = {"md5": "_md5_rounds", "md4": "_md4_rounds :1129",
          "sha1": "_sha1_rounds :1162",
          "ntlm": "_md4_rounds :1129 + split_pieces :1601-1629"}
LEET3 = {b"a": [b"4", b"@", b"^"], b"e": [b"3", b"&", b"EE"],
         b"s": [b"$", b"5", b"z"], b"o": [b"0", b"()", b"*"]}


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
               seed: int, filler: bytes = b"0123456789",
               alphabet: bytes = bytes(range(ord("a"), ord("z") + 1))
               ) -> list:
    """Long dictionary lines (rockyou carries some): runs of ``filler``
    bytes with a few letters of ``alphabet``, ``lo``..``hi`` bytes — in
    the 64-wide bucket their candidates need 2 or 3 hash blocks."""
    rng = np.random.default_rng(seed)
    fill = np.frombuffer(filler, np.uint8)
    abc = np.frombuffer(alphabet, np.uint8)
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        w = fill[rng.integers(0, len(fill), size=ln)].copy()
        k = int(rng.integers(letters[0], letters[1] + 1))
        pos = rng.choice(ln, size=k, replace=False)
        w[pos] = abc[rng.integers(0, len(abc), size=k)]
        out.append(bytes(w))
    return out


def wide_words(n: int, seed: int) -> list:
    """40-64-byte lines of 19 ``1``s, 3 letters and ``0``s: under
    :func:`wide_table` their candidates need 3 hash blocks at token width
    64 (22 slots)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = np.full(int(rng.integers(40, 65)), ord("0"), np.uint8)
        pos = rng.choice(len(w), size=22, replace=False)
        w[pos[:19]] = ord("1")
        w[pos[19:]] = rng.integers(ord("a"), ord("z") + 1, size=3,
                                   dtype=np.uint8)
        out.append(bytes(w))
    return out


#: Letters czech maps (the slots of a czech plan) and letters it does not.
CZECH_KEYS = b"acdeinorstuyz"
CZECH_FILLER = b"bfghjklmpqvwx"


def greek_words(words: list) -> list:
    """Words mapped letter by letter through ``qwerty-greek``: the
    greek-dictionary stand-in of the greek-hebrew configuration."""
    from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
        get_layout,
    )

    qg = get_layout("qwerty-greek").to_substitution_map()
    lut = {c: qg.get(bytes([c]), [bytes([c])])[0] for c in range(256)}
    return [b"".join(lut[c] for c in w) for w in words]


def wide_table(sub: dict) -> dict:
    """``sub`` plus ``1`` -> a 4-byte value: 19 of them take a 64-byte
    line's candidates past 2 MD5 blocks (3-block batches at token width
    64, which the reference's gate requires)."""
    return {**sub, b"1": [b"\xf0\x9f\x98\x80"]}


def keyspace(plan, spec) -> int:
    """Candidates the plan emits, counted on the host from its radices:
    per word, the digit vectors whose chosen count lies in the window —
    the elementary symmetric sums of the slots' option counts."""
    opts = (np.asarray(plan.pat_radix, np.int64) - 1).clip(min=0)
    lo, hi = spec.effective_min, spec.max_substitute
    e = np.zeros((opts.shape[0], opts.shape[1] + 1), np.int64)
    e[:, 0] = 1
    for s in range(opts.shape[1]):
        e[:, 1:] = e[:, 1:] + opts[:, s:s + 1] * e[:, :-1]
    return int(e[:, lo:min(hi, opts.shape[1]) + 1].sum())


# ---------------------------------------------------------------------------
# Phase 3 / 5 helpers
# ---------------------------------------------------------------------------

_PLANS: dict = {}


def plan_for(key, sub, words, spec, width=None):
    """(plan, ct, pieces) of a workload, built once for every hash (plans
    and schemas do not depend on the hash); ``width`` packs the words at
    a bucket's width."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import build_plan
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        pack_words, piece_schema_for,
    )
    from hashcat_a5_table_generator_tpu_torch.tables.compile import (
        compile_table,
    )

    if key not in _PLANS:
        ct = compile_table(sub)
        plan = build_plan(spec, ct, pack_words(words, width=width))
        _PLANS[key] = (plan, ct, piece_schema_for(plan, ct))
    return _PLANS[key]


class Case:
    """One kernel input at a given shape: blocks cut on the device from a
    real plan's index, with the plan's decode tier."""

    def __init__(self, name, workload, words, sub, *, algo="md5", mx=15,
                 pair=False, lanes=None, stride=STRIDE, width=None, device):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, cut_blocks, device_arrays,
        )
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
        from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
            superstep_index,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )

        self.name, self.algo, self.pair = name, algo, pair
        self.stride = stride
        self.spec = AttackSpec(algo=algo, max_substitute=mx)
        self.plan, self.ct, self.pieces = plan_for(
            (workload, mx), sub, words, self.spec, width)
        ct = self.ct
        why = fused_expand.kernel_refusal(self.spec, self.plan, ct,
                                          self.pieces)
        if why:
            fail(f"{name}: kernel refuses the plan: {why}")
        self.decode, pack_cb = fused_expand.decode_for(self.plan)
        self.key = fused_expand.launch_key(algo, self.decode, pair)
        rank_stride = stride * (2 if pair else 1)
        idx = superstep_index(self.plan, rank_stride)
        self.arrays = device_arrays(self.plan, self.pieces,
                                    build_digest_set([], algo), idx,
                                    device=device)
        nb = (lanes or LANES) // stride
        self.blocks = cut_blocks(self.arrays, 0, nb, rank_stride,
                                 self.decode)[:3]
        self.hash_blocks = fused_expand._hash_blocks_for(
            self.plan.out_width, 2 if algo == "ntlm" else 1)
        self.kw = dict(
            pieces=self.pieces, block_stride=stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute, pair=pair, algo=algo,
            decode=self.decode, pack_cb=pack_cb,
            k_opts=fused_expand.k_vals_for(self.plan),
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

    def lane_blocks(self) -> int:
        """Compressions the longest candidate of any word here needs: the
        word plus each slot's widest option (the kernel stops after each
        lane's own padding block, whatever its static block count)."""
        plan, ct = self.plan, self.ct
        opts = np.asarray(plan.match_radix) - 1
        grow = np.zeros(opts.shape, np.int64)
        for o in range(int(opts.max(initial=0))):
            row = np.clip(np.asarray(plan.match_val_start) + o, 0,
                          len(ct.val_len) - 1)
            grow = np.maximum(grow, np.where(
                opts > o, ct.val_len[row] - np.asarray(plan.match_len), 0))
        longest = int((np.asarray(plan.lengths) + grow.sum(axis=1)).max())
        scale = 2 if self.algo == "ntlm" else 1
        return -(-(longest * scale + 9) // 64)

    def bound(self, emit, peak_ops: float) -> "tuple[float, str]":
        """Least time for this input: one compression per emitted
        candidate (every lane here needs exactly one) over the INT32 peak,
        against each input byte read once and each output byte written
        once over HBM bandwidth."""
        import torch

        if self.lane_blocks() != 1:
            fail(f"{self.name}: timed lanes need more than one compression")
        ops = float(int(emit.sum())) * OPS_PER_BLOCK[self.algo]
        words = torch.unique(self.blocks[0])
        row_bytes = sum(
            t[0].numel() * 4 for k, t in self.arrays.items()
            if k in ("pw", "pw16", "pl")
            or (k in ("radix", "win_v") and self.decode != "scalar")
        )
        nb = int(self.blocks[0].shape[0])
        rows = int(emit.shape[0])
        nbytes = (8 * nb + self.blocks[2].numel() * 4
                  + int(words.numel()) * row_bytes
                  + self.arrays["desc"].numel() * 4
                  + (4 * STATE_WORDS[self.algo] + 1) * rows)
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
    emitted = int(emit_p.sum())
    log(f"kernel vs plain [{case.name}, {case.key}, {case.hash_blocks} "
        f"hash block(s)]: rows {emit_k.shape[0]}, emitted {emitted} "
        f"({100.0 * (1 - emitted / emit_k.shape[0]):.1f}% masked), emit "
        f"mismatches {emit_mis}, state mismatches {state_mis}, max abs "
        f"err {err} (tolerance 0)")
    if emit_mis or state_mis:
        fail(f"{case.name}: kernel disagrees with its plain version")
    if not emitted:
        fail(f"{case.name}: no emitted rows to compare")
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


def stage_breakdown(case, digest_set, pair_k) -> None:
    """Where one main-path launch spends its device time: the superstep
    body's stages timed apart at the case's shapes against a 1M digest
    set of its hash."""
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
    rank_stride = case.stride * (pair_k or 1)
    state, emit = case.kernel()
    body = make_superstep_body(
        case.spec, num_lanes=nb * case.stride,
        out_width=int(case.plan.out_width), block_stride=case.stride,
        num_blocks=nb, pieces=case.pieces, pair_k=pair_k,
        decode=case.decode, pack_cb=case.kw["pack_cb"],
        k_opts=case.kw["k_opts"],
    )
    bufs = superstep_buffers(4096, device=dev)
    t_cut = time_call(
        lambda: cut_blocks(arrays, 0, nb, rank_stride, case.decode), 10)
    t_kernel = time_call(case.kernel, 10)
    t_member = time_call(
        lambda: digest_member(state, arrays["rows"], arrays["bitmap"]), 3)
    t_step = time_call(lambda: body(arrays, 0, 1, bufs), 3)
    rest = t_step - t_cut - t_kernel - t_member
    log(f"stage breakdown [{case.name}, {case.key}], one launch "
        f"({emit.shape[0]} candidate rows, {int(emit.sum())} emitted, "
        f"{digest_set.size} {case.algo} digests), CUDA events: whole step "
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


def unique_sources(cand: bytes, inverse: dict, words: set) -> int:
    """How many dictionary words can splice to ``cand``: every value
    character of the table stands for one of its keys (no dictionary word
    holds a value character), every other character for itself."""
    alts = [inverse.get(ch, [ch.encode()]) for ch in cand.decode("utf-8")]
    n = 0
    for combo in itertools.islice(itertools.product(*alts), 4096):
        n += b"".join(combo) in words
    return n


class MainPath:
    """One configuration of the main path: a wordlist file and a digest
    file of its hash, 1000 planted hits decoded by the port's
    ``decode_variant`` and hashed by ``HOST_DIGEST``, and the host
    keyspace."""

    def __init__(self, name, work, words, layout, algo, spec_kw, seed):
        from hashcat_a5_table_generator_tpu_torch.models.attack import (
            AttackSpec, build_plan, decode_variant,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.membership import (
            build_digest_set,
        )
        from hashcat_a5_table_generator_tpu_torch.ops.packing import (
            read_packed_buckets,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.compile import (
            compile_table,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
            emit_table, get_layout,
        )
        from hashcat_a5_table_generator_tpu_torch.utils.digests import (
            HOST_DIGEST,
        )

        self.name, self.algo = name, algo
        self.table = os.path.join(work, f"{layout}.table")
        emit_table(get_layout(layout), self.table)
        sub = get_layout(layout).to_substitution_map()
        self.wordlist = os.path.join(work, f"{name}.words.txt")
        with open(self.wordlist, "wb") as fh:
            fh.write(b"\n".join(words) + b"\n")
        spec = AttackSpec(algo=algo, **spec_kw)
        ct = compile_table(sub)
        inverse: dict = {}
        for key, vals in sub.items():
            for v in vals:
                inverse.setdefault(v.decode("utf-8"), []).append(key)
        word_set = set(words)
        rng = np.random.default_rng(seed)
        self.prep = {}
        t = time.monotonic()
        buckets = read_packed_buckets(self.wordlist)
        self.prep["read_packed_buckets"] = time.monotonic() - t
        self.planted, self.want_emitted = {}, 0
        self.windowed = False
        for width, packed in buckets.items():
            t = time.monotonic()
            plan = build_plan(spec, ct, packed)
            self.prep["build_plan"] = self.prep.get("build_plan", 0.0) \
                + time.monotonic() - t
            self.windowed |= bool(plan.windowed)
            self.want_emitted += keyspace(plan, spec)
            share = packed.batch / len(words)
            rows = rng.permutation(packed.batch)
            want = max(1, round(N_PLANTED * share))
            got = 0
            for row in rows.tolist():
                if got >= want:
                    break
                nv = plan.n_variants[row]
                if nv < 2:
                    continue
                cand = decode_variant(plan, ct, spec, row, nv // 2)
                if unique_sources(cand, inverse, word_set) != 1:
                    continue  # another word splices the same plaintext
                self.planted[HOST_DIGEST[algo](cand).hex()] = cand
                got += 1
        width = DIGEST_BYTES[algo]
        decoys = rng.integers(0, 256, size=(N_DIGESTS - len(self.planted),
                                            width), dtype=np.uint8)
        digest_rows = np.concatenate([
            np.frombuffer(b"".join(bytes.fromhex(d) for d in self.planted),
                          np.uint8).reshape(-1, width), decoys])
        t = time.monotonic()
        self.digest_set = build_digest_set(digest_rows, algo)
        self.prep["build_digest_set (1M)"] = time.monotonic() - t
        self.digests = os.path.join(work, f"{name}.digests.txt")
        with open(self.digests, "w") as fh:
            fh.write("\n".join(list(self.planted) + [
                d.tobytes().hex() for d in decoys]) + "\n")
        self.buckets = {w: p.batch for w, p in buckets.items()}
        log(f"main path [{name}] inputs: {len(words)} words in buckets "
            f"{self.buckets}, {N_DIGESTS} {algo} digests ({len(self.planted)}"
            f" planted), host keyspace {self.want_emitted}, windowed "
            f"{self.windowed}; host prep on this machine's CPU: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in self.prep.items()))

    def run(self, arm, extra, card) -> dict:
        from hashcat_a5_table_generator_tpu_torch.ops import fused_expand
        from hashcat_a5_table_generator_tpu_torch.utils.digests import (
            HOST_DIGEST,
        )

        for k in fused_expand.LAUNCHES:
            fused_expand.LAUNCHES[k] = 0
        fused_expand.PLAIN_CALLS = 0
        argv = [self.wordlist, "-t", self.table, "--backend", "device",
                "--algo", self.algo, "--digests", self.digests] + extra
        t = time.monotonic()
        out, err, rc = run_cli(argv)
        wall = time.monotonic() - t
        launches = {k: v for k, v in fused_expand.LAUNCHES.items() if v}
        plain = fused_expand.PLAIN_CALLS
        what = f"{self.name} ({arm})"
        if rc != 0:
            fail(f"main path {what} exited {rc}: {err}")
        lines = out.decode("utf-8", "surrogateescape").splitlines()
        hits = [ln.split(":", 1) for ln in lines]
        got = [bytes.fromhex(p[5:-1]) if p.startswith("$HEX[") else
               p.encode("utf-8", "surrogateescape") for _d, p in hits]
        for (d, _p), cand in zip(hits, got):
            if HOST_DIGEST[self.algo](cand).hex() != d:
                fail(f"{what}: printed hit does not re-hash: {d}")
        counts: dict = {}
        for cand in got:
            counts[cand] = counts.get(cand, 0) + 1
        missing = [c for c in self.planted.values() if counts.get(c, 0) != 1]
        if missing:
            fail(f"{what}: {len(missing)} planted hits not printed exactly "
                 f"once, e.g. {missing[:3]!r}")
        m = re.search(r"(\d+) hits, (\d+) candidates hashed", err)
        s = re.search(r"([\d.]+) s wall, ([\d.]+) s superstep drive, "
                      r"([\d.e+]+) candidate-hashes/s", err)
        if not m or not s:
            fail(f"{what}: no summary on stderr: {err}")
        emitted = int(m.group(2))
        if emitted != self.want_emitted:
            fail(f"{what}: {emitted} candidates hashed, host keyspace "
                 f"{self.want_emitted}")
        if plain:
            fail(f"{what}: the plain version ran {plain} times on the main "
                 "path")
        rows = max(1, sum(v * LANES * (2 if k.startswith("piece_pair") else 1)
                          for k, v in launches.items()))
        log(f"main path {what}: {len(got)} hits ({len(self.planted)} "
            f"planted), {emitted} candidates hashed, launches {launches}, "
            f"{rows} candidate rows ({100.0 * (1 - emitted / rows):.1f}% "
            f"masked), CLI wall {wall:.2f} s, sweep {s.group(1)} s (drive "
            f"{s.group(2)} s), {s.group(3)} candidate-hashes/s on {card}")
        return dict(hits=sorted(got), launches=launches, emitted=emitted,
                    wall=wall, sweep_wall=float(s.group(1)),
                    drive=float(s.group(2)), rate=float(s.group(3)))


def expect_launched(run, keys, what) -> None:
    for key in keys:
        if run["launches"].get(key, 0) <= 0:
            fail(f"{what} never launched {key}")


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
            get_layout,
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
        f"SM); INT32 instructions per compression: {OPS_PER_BLOCK}")

    # -- phase 2: build -----------------------------------------------------
    t = time.monotonic()
    libs = [f"piece_hash_{a}" for a in ALGOS]
    reports = _native_build.build(libs)
    log(f"built {len(libs)} libraries from csrc/piece_hash.cu in "
        f"{time.monotonic() - t:.1f} s (nvcc "
        f"{' '.join(_native_build.NVCC_FLAGS)} -DPIECE_ALGO=n, in parallel)")
    for lib in libs:
        for line in reports[lib].splitlines():
            if re.search(r"Compiling entry|registers|spill|stack frame|smem",
                         line):
                print(f"  ptxas [{lib}]: {line.strip()}")

    cyr = get_layout("qwerty-cyrillic").to_substitution_map()
    czech = get_layout("czech").to_substitution_map()
    azerty = get_layout("qwerty-azerty").to_substitution_map()
    gh = get_layout("greek-hebrew").to_substitution_map()
    dev = torch.device("cuda")

    # -- phase 3: kernels vs plain on the card ------------------------------
    head = synth_words(CASE_WORDS, seed=1)
    greek_head = greek_words(head)
    mid = synth_words(CASE_WORDS, seed=7)
    # Count-windowed at -x 2 (at least a 2x lane saving): 9-13 letters for
    # qwerty-cyrillic; 9-10 letters with 6 czech slots for czech, so NTLM
    # keeps one hash block.
    tail = [w + b"xyz" for w in synth_words(CASE_WORDS, seed=8)]
    czech_tail = long_words(CASE_WORDS, 9, 10, (6, 6), seed=9,
                            filler=CZECH_FILLER, alphabet=CZECH_KEYS)
    long64 = long_words(400, 33, 64, (4, 10), seed=2)
    # (entry, algo) -> (workload, words, table, max_substitute, pair).
    timed = {}
    for algo in ALGOS:
        timed[("k1", algo)] = ("cyr", head, cyr, 15, False)
        timed[("pair", algo)] = ("cyr", head, cyr, 15, True)
        timed[("digits", algo)] = ("czech", mid, czech, 15, False)
        timed[("pair_digits", algo)] = ("leet3", mid, LEET3, 15, True)
        timed[("windowed", algo)] = ("cyr-x2", tail, cyr, 2, False)
    # The configurations' own workloads where one hash has its own.
    timed[("digits", "md5")] = ("azerty", mid, azerty, 15, False)
    timed[("k1", "sha1")] = ("greek", greek_head, gh, 15, False)
    timed[("pair", "sha1")] = ("greek", greek_head, gh, 15, True)
    timed[("windowed", "ntlm")] = ("czech-x2", czech_tail, czech, 2, False)
    cases = {}
    for (entry, algo), (wl, words, sub, mx, pair) in timed.items():
        # czech packs at the main path's bucket width, 16: NTLM then runs
        # its 2-block instantiation there, as the czech x NTLM run does
        # (every lane still needs one compression).
        cases[(entry, algo)] = Case(
            f"{wl} x {algo}", wl, words, sub, algo=algo, mx=mx, pair=pair,
            width=16 if wl == "czech" else None, device=dev)
    multi = {
        ("k1-2", "md5"): ("long64", long64, cyr, 2),
        ("k1-3", "md5"): ("wide64", wide_words(200, seed=3), wide_table(cyr),
                          3),
        ("k1-2", "sha1"): ("long64", long64, cyr, 2),
        ("k1-3", "sha1"): ("wide64", wide_words(200, seed=3),
                           wide_table(cyr), 3),
        ("digits-2", "ntlm"): ("czech24", [w * 2 + w[:4] for w in mid[:8000]],
                               czech, 2),
        ("digits-3", "ntlm"): ("czech-long", long_words(
            4000, 50, 64, (12, 12), seed=4, filler=CZECH_FILLER,
            alphabet=CZECH_KEYS), czech, 3),
    }
    for (entry, algo), (wl, words, sub, hb) in multi.items():
        lanes = LANES >> (2 if hb == 2 else 3)
        cases[(entry, algo)] = Case(f"{wl} x {algo}", wl, words, sub,
                                    algo=algo, lanes=lanes, device=dev)
    for (entry, algo), case in cases.items():
        want_key = f"piece_{entry.split('-')[0]}/{algo}"
        want_hb = int(entry.split("-")[1]) if "-" in entry else (
            2 if (entry, algo) == ("digits", "ntlm") else 1)
        if case.key != want_key or case.hash_blocks != want_hb:
            fail(f"{case.name}: runs {case.key} with {case.hash_blocks} "
                 f"hash blocks, expected {want_key} with {want_hb}")
    checks = {key: compare(case) for key, case in cases.items()}

    # -- phase 4: the main path at full width -------------------------------
    work = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # Unique words: qwerty-cyrillic and czech map letters one-to-one, so
    # distinct words never share a candidate; greek-hebrew does not
    # (MainPath plants only plaintexts with one source word).
    words = list(dict.fromkeys(synth_words(N_WORDS + 1000, seed=0)))
    words = words[: N_WORDS - 120]
    rng = np.random.default_rng(4)
    for w in long_words(100, 33, 64, (4, 10), seed=5) + \
            long_words(20, 50, 64, (3, 8), seed=6):
        words.insert(int(rng.integers(0, len(words))), w)
    paths = {
        "cyrillic-md5": MainPath("cyrillic-md5", work, words,
                                 "qwerty-cyrillic", "md5", {}, seed=10),
        "czech-ntlm": MainPath(
            "czech-ntlm", work,
            list(dict.fromkeys(synth_words(N_WORDS + 1000, seed=11)))[
                :N_WORDS], "czech", "ntlm", {}, seed=12),
        "greek-hebrew-sha1": MainPath(
            "greek-hebrew-sha1", work, greek_words(list(dict.fromkeys(
                synth_words(N_WORDS + 1000, seed=13)))[:N_WORDS]),
            "greek-hebrew", "sha1", {}, seed=14),
        "cyrillic-md5-x2": MainPath("cyrillic-md5-x2", work, words,
                                    "qwerty-cyrillic", "md5",
                                    {"max_substitute": 2}, seed=15),
    }
    if not paths["cyrillic-md5-x2"].windowed:
        fail("the -x 2 run's plans are not count-windowed")
    small = os.path.join(work, "small.txt")
    with open(small, "wb") as fh:
        fh.write(b"\n".join(words[:2000]) + b"\n")
    base = ["-t", paths["cyrillic-md5"].table, "--backend", "device",
            "--algo", "md5", "--digests", paths["cyrillic-md5"].digests]
    _out, err, rc = run_cli([small] + base)
    if rc != 0:
        fail(f"warm-up run exited {rc}: {err}")

    runs = {}
    for name, arm, extra in (
        ("cyrillic-md5", "pair auto", []),
        ("cyrillic-md5", "pair off", ["--pair", "off"]),
        ("czech-ntlm", "pair auto", []),
        ("greek-hebrew-sha1", "pair auto", []),
        ("greek-hebrew-sha1", "pair off", ["--pair", "off"]),
        ("cyrillic-md5-x2", "-x 2", ["-x", "2"]),
    ):
        runs[(name, arm)] = paths[name].run(arm, extra, card)
    for name in ("cyrillic-md5", "greek-hebrew-sha1"):
        if runs[(name, "pair auto")]["hits"] != runs[(name, "pair off")][
                "hits"]:
            fail(f"{name}: --pair off printed different hits")
    expect_launched(runs[("cyrillic-md5", "pair auto")],
                    ["piece_pair/md5", "piece_k1/md5"],
                    "cyrillic-md5 (pair auto; long-word buckets: k1)")
    expect_launched(runs[("cyrillic-md5", "pair off")], ["piece_k1/md5"],
                    "cyrillic-md5 (pair off)")
    expect_launched(runs[("czech-ntlm", "pair auto")], ["piece_digits/ntlm"],
                    "czech-ntlm")
    expect_launched(runs[("greek-hebrew-sha1", "pair auto")],
                    ["piece_pair/sha1"], "greek-hebrew-sha1 (pair auto)")
    expect_launched(runs[("greek-hebrew-sha1", "pair off")],
                    ["piece_k1/sha1"], "greek-hebrew-sha1 (pair off)")
    expect_launched(runs[("cyrillic-md5-x2", "-x 2")],
                    ["piece_windowed/md5"], "cyrillic-md5-x2")
    main_launches: dict = {}
    for run in runs.values():
        for k, v in run["launches"].items():
            main_launches[k] = main_launches.get(k, 0) + v
    czech = runs[("czech-ntlm", "pair auto")]
    czech_rows = max(1, sum(czech["launches"].values()) * LANES)
    log(f"czech-ntlm main path: {czech['emitted']} candidates on "
        f"{czech_rows} rows: {100.0 * (1 - czech['emitted'] / czech_rows):.1f}"
        f"% of the rows masked")

    # -- phase 5: timing ----------------------------------------------------
    kernels = []
    for (entry, algo), case in cases.items():
        if (entry, algo) in multi:
            continue
        ms = time_call(case.kernel, 20)
        plain_ms = time_call(case.plain, 2)
        emit = checks[(entry, algo)]["emit"]
        bound_ms, bound_by = case.bound(emit, peak_ops)
        rows = int(emit.shape[0])
        multi_checks = {f"{e}/{a}": checks[(e, a)]["mismatches"]
                        for (e, a) in multi if a == algo
                        and e.split("-")[0] == entry}
        log(f"{case.key} [{case.name}, {case.hash_blocks} hash block(s) "
            f"compiled]: {ms:.4f} ms/launch over {rows} "
            f"candidate rows ({rows / ms * 1e3:.4g} candidates/s, "
            f"{int(emit.sum()) / ms * 1e3:.4g} emitted/s); bound "
            f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.0f}% of "
            f"it reached); plain {plain_ms:.3f} ms")
        kernels.append({
            "name": case.key,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"{PALLAS}:1303",
            "branch": f"{BRANCHES[entry]}; {ROUNDS[algo]}",
            "workload": case.name,
            "hash_blocks": case.hash_blocks,
            "launches": main_launches.get(case.key, 0),
            "main_path": case.key in main_launches,
            "mismatches": checks[(entry, algo)]["mismatches"],
            "multi_block_mismatches": multi_checks,
            "max_abs_err": checks[(entry, algo)]["max_abs_err"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    stage_breakdown(cases[("pair", "md5")], paths["cyrillic-md5"].digest_set,
                    2)
    stage_breakdown(cases[("digits", "ntlm")],
                    paths["czech-ntlm"].digest_set, None)
    stage_breakdown(cases[("pair", "sha1")],
                    paths["greek-hebrew-sha1"].digest_set, 2)
    shutil.rmtree(work, ignore_errors=True)
    elapsed = time.monotonic() - T0
    log(f"done in {elapsed:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
