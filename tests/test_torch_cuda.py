"""The PyTorch/CUDA package's kernels on a GPU (``cuda`` marker).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch with CUDA::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU.)  Without a
GPU every test here skips.  Inputs come from seeds through the package's
own host code; each kernel entry point, for every hash and decode tier,
is held against its plain PyTorch version on the card (equal emit masks,
equal state on every emitted row, tolerance 0) over match and
substitute-all schemas (the suball selectors, the cascade closure), as is
every byte-scan kernel (rows 7-9: the scalar-units variants, the match
and substitute-all scans, closed and windowed, 1-3 hash blocks), and
small sweeps on the GPU — default, reverse and substitute-all mode, with
oracle-fallback words, german's ``ss`` words and ``A5GEN_EMIT=bytescan``
— must equal the same sweeps on the CPU.  The XLA expand + hash route:
the buffer hash (TPU row 10 and its siblings) against its plain version
for every hash at 1, 2, 3 and 5 blocks and in buffers that are not
4-byte aligned, the windowed tier's CTA edges, and XLA-route crack sweeps
(nine options, long lines, ``A5GEN_PALLAS=off``) and candidates-mode
streams on the GPU equal to the CPU's.
"""

import hashlib
import io

import numpy as np
import pytest
import torch

from hashcat_a5_table_generator_tpu_torch.models.attack import (
    AttackSpec,
    build_plan,
    cut_blocks,
    decode_variant,
    device_arrays,
)
from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh
from hashcat_a5_table_generator_tpu_torch.ops import bytescan as bs
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.ops.blocks import superstep_index
from hashcat_a5_table_generator_tpu_torch.ops.membership import (
    build_digest_set,
)
from hashcat_a5_table_generator_tpu_torch.ops.packing import (
    pack_words,
    piece_schema_for,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.compile import (
    compile_table,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

pytestmark = pytest.mark.cuda

SUB = get_layout("qwerty-cyrillic").to_substitution_map()
CZECH = get_layout("czech").to_substitution_map()
#: 1 -> a 4-byte value: 19 of them take a 64-byte word past 2 MD5 blocks.
SUB_WIDE = {**SUB, b"1": [b"\xf0\x9f\x98\x80"]}
LEET3 = {b"a": [b"4", b"@", b"^"], b"e": [b"3", b"&", b"EE"],
         b"s": [b"$", b"5", b"z"], b"o": [b"0", b"()", b"*"]}
AZERTY = get_layout("qwerty-azerty").to_substitution_map()
#: One option per key, fixed and mixed widths: the suball pair tier.
SINGLE = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def letter_words(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(97, 123, size=int(rng.integers(lo, hi + 1)),
                               dtype=np.uint8)) for _ in range(n)]


def czech_long_words(n, lo, hi, k, seed):
    """``lo``..``hi`` letters, ``k`` of them czech keys (the slots), the
    rest letters czech does not map."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = np.frombuffer(b"bfghjklmpqvwx", np.uint8)[rng.integers(
            0, 13, size=int(rng.integers(lo, hi + 1)))].copy()
        pos = rng.choice(len(w), size=k, replace=False)
        w[pos] = np.frombuffer(b"acdeinorstuyz", np.uint8)[rng.integers(
            0, 13, size=k)]
        out.append(bytes(w))
    return out


def words_for(case, seed=0):
    rng = np.random.default_rng(seed)
    if case in ("k1", "pair"):
        return letter_words(300, 3, 10, seed)
    if case == "3-hash-blocks":
        out = []
        for _ in range(40):
            w = np.full(int(rng.integers(40, 65)), ord("0"), np.uint8)
            pos = rng.choice(len(w), size=22, replace=False)
            w[pos[:19]] = ord("1")
            w[pos[19:]] = rng.integers(97, 123, size=3, dtype=np.uint8)
            out.append(bytes(w))
        return out
    lo, hi = (40, 64)
    out = []
    for _ in range(40):
        w = rng.integers(48, 58, size=int(rng.integers(lo, hi + 1)),
                         dtype=np.uint8)
        pos = rng.choice(len(w), size=6, replace=False)
        w[pos] = rng.integers(97, 123, size=6, dtype=np.uint8)
        out.append(bytes(w))
    return out


class Case:
    """Blocks cut on the card from a real plan's index, and the wrapper
    arguments of the plan's decode tier."""

    def __init__(self, sub, words, device, *, algo="md5", mx=15, pair=False,
                 stride=128, nb=256, mode="default", mn=0):
        spec = AttackSpec(mode=mode, algo=algo, min_substitute=mn,
                          max_substitute=mx)
        ct = compile_table(sub)
        plan = build_plan(spec, ct, pack_words(words))
        pieces = piece_schema_for(plan, ct)
        assert fe.opts_for(spec, plan, ct) is not None
        assert fe.schema_refusal(plan, pieces) is None
        self.plan = plan
        self.decode, pack_cb = fe.decode_for(plan)
        rank_stride = stride * (2 if pair else 1)
        self.arrays = device_arrays(
            plan, pieces, build_digest_set([], algo),
            superstep_index(plan, rank_stride), device=device)
        self.blocks = cut_blocks(self.arrays, 0, nb, rank_stride,
                                 self.decode)[:3]
        self.hash_blocks = fe._hash_blocks_for(plan.out_width,
                                               2 if algo == "ntlm" else 1)
        self.key = fe.launch_key(algo, pieces, self.decode, pair)
        self.kw = dict(pieces=pieces, block_stride=stride,
                       min_substitute=spec.effective_min,
                       max_substitute=mx, pair=pair, algo=algo,
                       decode=self.decode, pack_cb=pack_cb,
                       k_opts=fe.k_vals_for(plan))

    def check(self):
        launches = dict(fe.LAUNCHES)
        state, emit = fe.fused_expand_md5(
            *self.blocks, self.arrays, out_width=int(self.plan.out_width),
            **self.kw)
        assert fe.LAUNCHES[self.key] == launches[self.key] + 1
        want_state, want_emit = fe.piece_md5_reference(
            *self.blocks, self.arrays, hash_blocks=self.hash_blocks,
            **self.kw)
        torch.cuda.synchronize()
        assert emit.any()
        assert torch.equal(emit, want_emit)
        assert torch.equal(state[emit], want_state[emit])


@pytest.mark.parametrize("case", ["k1", "pair", "2-hash-blocks",
                                  "3-hash-blocks"])
def test_kernel_matches_plain_version(case, cuda):
    sub = SUB_WIDE if case == "3-hash-blocks" else SUB
    c = Case(sub, words_for(case), cuda, pair=case == "pair")
    assert c.hash_blocks == {"k1": 1, "pair": 1, "2-hash-blocks": 2,
                             "3-hash-blocks": 3}[case]
    c.check()


#: (entry, hash) -> (table, words, max_substitute, pair, hash blocks).
_ENTRY_CASES = {}
for _algo in ("md5", "md4", "sha1", "ntlm"):
    _ENTRY_CASES[("k1", _algo)] = (SUB, letter_words(300, 3, 8, 1), 15,
                                   False, 1)
    _ENTRY_CASES[("pair", _algo)] = (SUB, letter_words(300, 3, 8, 2), 15,
                                     True, 1)
    _ENTRY_CASES[("digits", _algo)] = (CZECH, letter_words(300, 3, 8, 3),
                                       15, False, 1)
    _ENTRY_CASES[("pair_digits", _algo)] = (
        LEET3, letter_words(300, 3, 8, 4), 15, True, 1)
    _ENTRY_CASES[("windowed", _algo)] = (
        (CZECH if _algo in ("ntlm", "md4") else SUB),
        letter_words(300, 9, 12, 5), 2, False, 1)
_ENTRY_CASES[("digits-2", "ntlm")] = (CZECH, letter_words(200, 18, 26, 6),
                                      15, False, 2)
_ENTRY_CASES[("digits-3", "ntlm")] = (
    CZECH, czech_long_words(200, 50, 64, 12, 7), 15, False, 3)
_ENTRY_CASES[("k1-2", "sha1")] = (SUB, words_for("2-hash-blocks", 8), 15,
                                  False, 2)
_ENTRY_CASES[("k1-3", "sha1")] = (SUB_WIDE, words_for("3-hash-blocks", 9),
                                  15, False, 3)


@pytest.mark.parametrize("entry,algo", sorted(_ENTRY_CASES),
                         ids=[f"{e}-{a}" for e, a in sorted(_ENTRY_CASES)])
def test_every_entry_point_matches_plain_version(entry, algo, cuda):
    sub, words, mx, pair, blocks = _ENTRY_CASES[(entry, algo)]
    c = Case(sub, words, cuda, algo=algo, mx=mx, pair=pair)
    assert c.key == f"piece_{entry.split('-')[0]}/{algo}"
    assert c.hash_blocks == blocks
    c.check()


def keyed_words(n, lo, hi, seed, keys, filler, k):
    """``lo``..``hi`` bytes of ``filler`` with ``k`` bytes of ``keys``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = np.frombuffer(filler, np.uint8)[rng.integers(
            0, len(filler), size=int(rng.integers(lo, hi + 1)))].copy()
        pos = rng.choice(len(w), size=min(k, len(w)), replace=False)
        w[pos] = np.frombuffer(keys, np.uint8)[rng.integers(
            0, len(keys), size=len(pos))]
        out.append(bytes(w))
    return out


def pair_words(n, seed):
    """Each word's lowest-sorted pattern (``a``) occurs once, first: slot
    0 drives column 0 only, as the suball pair gate needs."""
    return [b"a" + w for w in keyed_words(n, 2, 8, seed, b"eos", b"bcdfgh",
                                          2)]


AZ_FILL = b"bcdefghijklnoprstuvxy"
#: (suball entry, hash) -> (table, words, max_substitute, pair, blocks).
_SUBALL_CASES = {}
for _algo in ("md5", "md4", "sha1", "ntlm"):
    _SUBALL_CASES[("suball_k1", _algo)] = (
        SUB, letter_words(300, 3, 8, 21), 15, False, 1)
    _SUBALL_CASES[("suball_digits", _algo)] = (
        CZECH, letter_words(300, 3, 8, 22), 15, False, 1)
    _SUBALL_CASES[("suball_closed", _algo)] = (
        AZERTY, [b"aq" + w for w in keyed_words(300, 2, 8, 23, b"aqzwAQm",
                                                AZ_FILL, 2)] + [b"AQq"],
        15, False, 1)
    _SUBALL_CASES[("suball_windowed", _algo)] = (
        SUB, keyed_words(300, 11, 12, 24, b"qwertyuiopasdf", b"0123456789",
                         10), 2, False, 1)
    _SUBALL_CASES[("suball_windowed-digits", _algo)] = (
        CZECH, czech_long_words(300, 11, 12, 10, 25), 2, False, 1)
    _SUBALL_CASES[("suball_closed_windowed", _algo)] = (
        AZERTY, [b"aq134567" + w for w in keyed_words(300, 1, 3, 26,
                                                      b"zwm", AZ_FILL, 1)],
        2, False, 1)
    _SUBALL_CASES[("suball_pair", _algo)] = (
        SINGLE, pair_words(300, 27), 15, True, 1)
    _SUBALL_CASES[("suball_pair_digits", _algo)] = (
        LEET3, pair_words(300, 28), 15, True, 1)
_SUBALL_CASES[("suball_k1-2", "md5")] = (
    SUB, keyed_words(100, 40, 64, 29, b"qwerty", b"0123456789", 6), 15,
    False, 2)
_SUBALL_CASES[("suball_k1-3", "sha1")] = (
    SUB_WIDE, words_for("3-hash-blocks", 30), 15, False, 3)
_SUBALL_CASES[("suball_closed-2", "ntlm")] = (
    AZERTY, [b"aq" + w for w in keyed_words(100, 20, 26, 31, b"aqzw",
                                            AZ_FILL, 4)], 15, False, 2)


@pytest.mark.parametrize("entry,algo", sorted(_SUBALL_CASES),
                         ids=[f"{e}-{a}" for e, a in sorted(_SUBALL_CASES)])
def test_every_suball_entry_matches_plain_version(entry, algo, cuda):
    sub, words, mx, pair, blocks = _SUBALL_CASES[(entry, algo)]
    c = Case(sub, words, cuda, algo=algo, mx=mx, pair=pair, mode="suball")
    name = entry.split("-")[0]
    assert c.key == f"piece_{name}/{algo}"
    assert c.hash_blocks == blocks
    c.check()


@pytest.mark.parametrize("table,mode,algo,mx", [
    ("qwerty-azerty", "suball", "md5", 15),
    ("qwerty-azerty", "suball-reverse", "sha1", 15),
    ("qwerty-cyrillic", "suball", "sha1", 2),
    ("czech", "suball-reverse", "ntlm", 15),
    ("qwerty-cyrillic", "reverse", "md5", 15),
])
def test_suball_and_reverse_sweeps_on_the_gpu_equal_the_cpu(
        table, mode, algo, mx, cuda):
    """Oracle-fallback words (qwerty-azerty ``m,;`` lines) interleave in
    the same places on both devices."""
    sub = get_layout(table).to_substitution_map()
    words = letter_words(200, 2, 8 if mx == 15 else 12, 12)
    words[5:5] = [b"m,;", b"aqua", b"AQq", b"am,;q"]
    spec = AttackSpec(mode=mode, algo=algo, max_substitute=mx)
    cfg = dict(lanes=4096, num_blocks=32)
    probe = Sweep(spec, sub, words, [], SweepConfig(device="cpu", **cfg))
    digests = [HOST_DIGEST[algo](decode_variant(
        probe.plan, probe.ct, spec, row, probe.plan.n_variants[row] // 2))
        for row in range(0, len(words), 5)
        if probe.plan.n_variants[row] >= 2]
    results = [Sweep(spec, sub, words, digests,
                     SweepConfig(device=dev, **cfg)).run_crack()
               for dev in ("cuda", "cpu")]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want and len(got) >= len(digests)
    assert results[0].n_emitted == results[1].n_emitted
    assert results[0].routing == results[1].routing


def test_sweep_on_the_gpu_equals_the_cpu(cuda):
    words = words_for("k1", seed=1) + words_for("2-hash-blocks", seed=2)[:5]
    digests = [hashlib.md5(w).digest() for w in words[:5]]  # never emitted
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words[:40]))
    for row in range(0, 40, 4):
        digests.append(hashlib.md5(decode_variant(
            plan, ct, spec, row, plan.n_variants[row] // 2)).digest())
    results = [
        Sweep(spec, SUB, words, digests,
              SweepConfig(device=dev, lanes=4096, num_blocks=32,
                          superstep_hit_cap=3)).run_crack()
        for dev in ("cuda", "cpu")
    ]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want and len(got) == 10
    assert results[0].n_emitted == results[1].n_emitted
    assert results[0].superstep["replays"] > 0


@pytest.mark.parametrize("table,algo,mx", [
    ("czech", "ntlm", 15), ("greek-hebrew", "sha1", 15),
    ("qwerty-cyrillic", "md5", 2), ("czech", "ntlm", 2),
])
def test_other_tiers_sweep_on_the_gpu_equals_the_cpu(table, algo, mx, cuda):
    sub = get_layout(table).to_substitution_map()
    if table == "greek-hebrew":
        qg = get_layout("qwerty-greek").to_substitution_map()
        words = [b"".join(qg.get(bytes([c]), [bytes([c])])[0] for c in w)
                 for w in letter_words(200, 2, 8, 10)]
    else:
        words = letter_words(200, 2 if mx == 15 else 9, 12, 11)
    spec = AttackSpec(algo=algo, max_substitute=mx)
    cfg = dict(lanes=4096, num_blocks=32)
    probe = Sweep(spec, sub, words, [], SweepConfig(device="cpu", **cfg))
    assert probe.plan.windowed == (mx == 2)
    digests = [HOST_DIGEST[algo](decode_variant(
        probe.plan, probe.ct, spec, row, probe.plan.n_variants[row] // 2))
        for row in range(0, 200, 7) if probe.plan.n_variants[row] >= 2]
    results = [Sweep(spec, sub, words, digests,
                     SweepConfig(device=dev, **cfg)).run_crack()
               for dev in ("cuda", "cpu")]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want and len(got) >= len(digests)
    assert results[0].n_emitted == results[1].n_emitted


# ---------------------------------------------------------------------------
# The byte-scan kernels (TPU kernel rows 7-9)
# ---------------------------------------------------------------------------

GERMAN = get_layout("german").to_substitution_map()
#: Keys colliding at one start: K=1 plans off the scalar tier (row 8).
COLLIDE = {b"s": [b"Z"], b"ss": ["ß".encode()]}
#: x -> a 4-byte value (no table here maps x): long lines past 2 blocks.
WIDE = {b"x": [b"\xf0\x9f\x98\x80"]}


def german_words(n, lo, hi, seed, sss_every=3):
    """Lowercase words, every ``sss_every``-th holding "sss" (two
    overlapping ``ss`` matches), the others ``ss`` or none."""
    out = []
    for i, w in enumerate(letter_words(n, lo, hi, seed)):
        w = w.replace(b"s", b"t")
        at = i % len(w)
        piece = b"sss" if i % sss_every == 0 else (b"ss" if i % 2 else b"")
        out.append(w[:at] + piece + w[at:])
    return out


class BSCase:
    """A byte-scan launch: blocks cut on the card from a real plan's index
    and the plan's byte-scan tier (as the gate picks it, or forced)."""

    def __init__(self, sub, words, device, *, algo="md5", mx=15,
                 mode="default", stride=128, nb=256, tier=None, mn=0):
        spec = AttackSpec(mode=mode, algo=algo, min_substitute=mn,
                          max_substitute=mx)
        ct = compile_table(sub)
        plan = build_plan(spec, ct, pack_words(words))
        assert fe.opts_for_config(spec, plan, ct) is not None
        self.plan, self.tier = plan, tier or bs.bytescan_tier(plan)
        self.arrays = device_arrays(
            plan, None, build_digest_set([], algo),
            superstep_index(plan, stride), device=device, ct=ct,
            bytescan=self.tier)
        cut = {"scalar": "scalar", "windowed": "windowed"}.get(
            self.tier.decode, "digits")
        self.blocks = cut_blocks(self.arrays, 0, nb, stride, cut)[:3]
        self.hash_blocks = fe._hash_blocks_for(plan.out_width,
                                               2 if algo == "ntlm" else 1)
        self.key = self.tier.launch_key(algo)
        self.kw = dict(tier=self.tier, block_stride=stride,
                       min_substitute=spec.effective_min, max_substitute=mx,
                       algo=algo)

    def check(self):
        launches, plain = dict(bs.LAUNCHES), bs.PLAIN_CALLS
        state, emit = bs.bytescan_expand(
            *self.blocks, self.arrays, out_width=int(self.plan.out_width),
            **self.kw)
        assert bs.LAUNCHES[self.key] == launches[self.key] + 1
        assert bs.PLAIN_CALLS == plain
        want_state, want_emit = bs.bytescan_reference(
            *self.blocks, self.arrays, hash_blocks=self.hash_blocks,
            **self.kw)
        torch.cuda.synchronize()
        assert emit.any()
        assert torch.equal(emit, want_emit)
        assert torch.equal(state[emit], want_state[emit])


def long_keyed(n, lo, hi, seed, pieces, wide, filler):
    """Long lines of ``filler`` with each of ``pieces`` and ``wide`` x's."""
    out = []
    for w in keyed_words(n, lo, hi, seed, b"x", filler, wide):
        for i, piece in enumerate(pieces):
            at = (7 * i + seed) % (len(w) - len(piece))
            w = w[:at] + piece + w[at + len(piece):]
        out.append(w)
    return out


#: (tier label, hash) -> (table, words, mode, max_substitute, hash blocks,
#: (row, decode, variant)).
_BYTESCAN_CASES = {}
for _algo in ("md5", "md4", "sha1", "ntlm"):
    _BYTESCAN_CASES[("scalar-single", _algo)] = (
        SUB, letter_words(300, 3, 8, 41), "default", 15, 1,
        ("scalar", "scalar", "single"))
    _BYTESCAN_CASES[("scalar-single-win", _algo)] = (
        SUB, letter_words(300, 9, 11, 42), "default", 2, 1,
        ("scalar", "windowed", "single"))
    _BYTESCAN_CASES[("scalar-bitmask", _algo)] = (
        GERMAN, german_words(300, 3, 8, 43), "default", 15, 1,
        ("scalar", "scalar", "bitmask"))
    _BYTESCAN_CASES[("scalar-bitmask-r", _algo)] = (
        GERMAN, german_words(300, 3, 8, 44), "reverse", 15, 1,
        ("scalar", "scalar", "bitmask"))
    _BYTESCAN_CASES[("scalar-bitmask-win", _algo)] = (
        GERMAN, [w + b"sss" for w in keyed_words(300, 8, 9, 45, b"aou",
                                                 b"bcdfgh", 8)],
        "default", 2, 1, ("scalar", "windowed", "bitmask"))
    _BYTESCAN_CASES[("scalar-suball", _algo)] = (
        SUB, letter_words(300, 3, 8, 46), "suball", 15, 1,
        ("scalar", "scalar", "suball"))
    _BYTESCAN_CASES[("scalar-suball-win", _algo)] = (
        SUB, keyed_words(300, 11, 12, 47, b"qwertyuiopasdf", b"0123456789",
                         10), "suball", 2, 1, ("scalar", "windowed", "suball"))
    _BYTESCAN_CASES[("match-radix2", _algo)] = (
        COLLIDE, keyed_words(300, 3, 9, 48, b"s", b"abcde", 4), "default",
        15, 1, ("match", "radix2", ""))
    _BYTESCAN_CASES[("match-digits", _algo)] = (
        CZECH, letter_words(300, 3, 8, 49), "default", 15, 1,
        ("match", "digits", ""))
    _BYTESCAN_CASES[("match-win", _algo)] = (
        CZECH, czech_long_words(300, 10, 11, 9, 50), "default", 2, 1,
        ("match", "windowed", ""))
    _BYTESCAN_CASES[("suball-digits", _algo)] = (
        CZECH, letter_words(300, 3, 8, 51), "suball", 15, 1,
        ("suball", "digits", ""))
    _BYTESCAN_CASES[("suball-win", _algo)] = (
        CZECH, czech_long_words(300, 10, 11, 9, 52), "suball", 2, 1,
        ("suball", "windowed", ""))
    _BYTESCAN_CASES[("suball-closed", _algo)] = (
        AZERTY, [b"aq" + w for w in keyed_words(300, 2, 8, 53, b"aqzwAQm",
                                                AZ_FILL, 2)] + [b"AQq"],
        "suball", 15, 1, ("suball", "digits", ""))
    _BYTESCAN_CASES[("suball-closed-win", _algo)] = (
        AZERTY, [b"aq134567" + w for w in keyed_words(300, 1, 3, 54, b"zwm",
                                                      AZ_FILL, 1)],
        "suball", 2, 1, ("suball", "windowed", ""))
_BYTESCAN_CASES[("scalar-bitmask-2", "md5")] = (
    {**GERMAN, **WIDE}, long_keyed(100, 40, 48, 55, (b"sss", b"a"), 4,
                                   b"bcdefghijklnpr"), "default", 15, 2,
    ("scalar", "scalar", "bitmask"))
_BYTESCAN_CASES[("scalar-bitmask-3", "sha1")] = (
    {**GERMAN, **WIDE}, long_keyed(100, 52, 60, 56, (b"sss", b"a"), 19,
                                   b"bcdefghijklnpr"), "default", 15, 3,
    ("scalar", "scalar", "bitmask"))
_BYTESCAN_CASES[("match-digits-3", "ntlm")] = (
    {**CZECH, **WIDE}, long_keyed(100, 40, 44, 57, (b"ue", b"e"), 6,
                                  b"bfghjklmpqvw"), "default", 15, 3,
    ("match", "digits", ""))
_BYTESCAN_CASES[("suball-closed-2", "ntlm")] = (
    {**AZERTY, **WIDE}, long_keyed(100, 24, 28, 58, (b"aq", b"zw"), 0,
                                   b"bcdefghijklnpr"), "suball", 15, 2,
    ("suball", "digits", ""))


@pytest.mark.parametrize("label,algo", sorted(_BYTESCAN_CASES),
                         ids=[f"{t}-{a}" for t, a in sorted(_BYTESCAN_CASES)])
def test_every_bytescan_kernel_matches_plain_version(label, algo, cuda):
    sub, words, mode, mx, blocks, tier = _BYTESCAN_CASES[(label, algo)]
    c = BSCase(sub, words, cuda, algo=algo, mx=mx, mode=mode)
    assert (c.tier.row, c.tier.decode, c.tier.variant) == tier
    assert c.hash_blocks == blocks or (blocks == 1 and algo == "ntlm")
    c.check()


def test_forced_suball_radix2_kernel_matches_plain_version(cuda):
    c = BSCase(SUB, letter_words(300, 3, 8, 59), cuda, mode="suball",
               tier=bs.ByteScanTier("suball", "radix2"))
    c.check()


@pytest.mark.parametrize("table,mode,algo,env", [
    ("german", "default", "md5", ""),
    ("german", "reverse", "ntlm", ""),
    ("czech", "default", "ntlm", "bytescan"),
    ("qwerty-azerty", "suball", "md5", "bytescan"),
    ("qwerty-cyrillic", "suball-reverse", "sha1", "bytescan"),
])
def test_bytescan_sweeps_on_the_gpu_equal_the_cpu(table, mode, algo, env,
                                                  cuda, monkeypatch):
    monkeypatch.setenv("A5GEN_EMIT", env)
    sub = get_layout(table).to_substitution_map()
    words = (german_words(200, 3, 8, 60) if table == "german"
             else letter_words(200, 2, 8, 61))
    words[5:5] = [b"m,;", b"aqua", b"AQq", b"am,;q"]
    spec = AttackSpec(mode=mode, algo=algo)
    cfg = dict(lanes=4096, num_blocks=32)
    probe = Sweep(spec, sub, words, [], SweepConfig(device="cpu", **cfg))
    assert probe.pieces is None and probe.bytescan is not None
    digests = [HOST_DIGEST[algo](decode_variant(
        probe.plan, probe.ct, spec, row, probe.plan.n_variants[row] // 2))
        for row in range(0, len(words), 5)
        if probe.plan.n_variants[row] >= 2 and not probe.plan.fallback[row]]
    results = [Sweep(spec, sub, words, digests,
                     SweepConfig(device=dev, **cfg)).run_crack()
               for dev in ("cuda", "cpu")]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want
    assert results[0].n_emitted == results[1].n_emitted
    assert results[0].routing == results[1].routing
    assert results[0].kernels == results[1].kernels


# ---------------------------------------------------------------------------
# The XLA expand + hash route
# ---------------------------------------------------------------------------

#: Nine options on ``a`` (one 5 bytes): every bucket on the XLA route.
LEET9 = {b"a": [bytes([c]) for c in b"4@^&*!%#"] + [b"/-\\-/"],
         b"s": [b"$", b"5"], b"e": [b"9"]}


@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_windowed_cta_edges_match_plain_version(algo, cuda):
    """The windowed tier's CTAs at their edges: 16-20-letter words (more
    ranks than the stride, so full blocks), a launch whose block count
    ends a CTA part-way, and blocks cut to counts 0 and 1."""
    c = Case(SUB, letter_words(300, 16, 20, 11), cuda, algo=algo, mx=2,
             nb=61)
    assert c.decode == "windowed"
    word, count, base = (t.clone() for t in c.blocks)
    assert bool((count == 128).any())
    count[3], count[7] = 0, 1
    c.blocks = (word, count, base)
    c.check()


def cut_edges(c, ranks):
    """``c``'s blocks with the CTA edges: blocks 3 and 7 cut to counts 0
    and 1 and blocks 32-63 (whole CTAs) to count 0, beside blocks of
    their full ``ranks``."""
    word, count, base = (t.clone() for t in c.blocks)
    assert bool((count == ranks).any())
    count[3], count[7] = 0, 1
    count[32:64] = 0
    c.blocks = (word, count, base)


_TILE_EDGES = [(tier, algo) for tier in ("k1", "pair", "suball_k1")
               for algo in ("md5", "md4", "sha1", "ntlm")]


@pytest.mark.parametrize("tier,algo", _TILE_EDGES,
                         ids=[f"{t}-{a}" for t, a in _TILE_EDGES])
def test_tile_cta_edges_match_plain_version(tier, algo, cuda):
    """The scalar K=1 and pair tiers' CTAs at their edges: a launch whose
    block count ends a CTA part-way, blocks cut to counts 0 and 1, and
    a run of count-0 blocks (whole CTAs with no live lane), beside
    blocks of their full ranks."""
    c = Case(SUB, letter_words(300, 8, 10, 12), cuda, algo=algo,
             pair=tier == "pair", nb=101,
             mode="suball" if tier == "suball_k1" else "default")
    assert c.decode == "scalar" and c.key == f"piece_{tier}/{algo}"
    cut_edges(c, 256 if tier == "pair" else 128)
    c.check()


AZQ = get_layout("azerty-qwerty").to_substitution_map()
#: The digit decode at K=1 on the tile tier: (entry, table, words, mode).
_DIGIT_TILES = {
    "digits": (CZECH, letter_words(300, 5, 9, 13), "default"),
    "suball_digits": (CZECH, letter_words(300, 5, 9, 14), "suball"),
    "suball_closed": (AZERTY, [b"AQq" + w for w in letter_words(
        300, 8, 12, 15)], "suball"),
    "suball_closed:azq": (AZQ, [b"AQq" + w for w in letter_words(
        300, 8, 12, 16)], "suball"),
}
_DIGIT_EDGES = [(entry, algo) for entry in _DIGIT_TILES
                for algo in ("md5", "md4", "sha1", "ntlm")]


@pytest.mark.parametrize("entry,algo", _DIGIT_EDGES,
                         ids=[f"{e}-{a}" for e, a in _DIGIT_EDGES])
def test_digit_tile_cta_edges_match_plain_version(entry, algo, cuda):
    """The digit decode at K=1 (match, substitute-all, cascade-closed over
    qwerty-azerty and azerty-qwerty) on the tile tier: a launch whose
    block count ends a CTA part-way, counts 0 and 1, a run of count-0
    blocks; then the window cut -m 2 -x 9 and blocks of 4096 lanes cut
    into chunks."""
    sub, words, mode = _DIGIT_TILES[entry]
    name = entry.split(":")[0]
    c = Case(sub, words, cuda, algo=algo, nb=101, mode=mode)
    assert c.key == f"piece_{name}/{algo}"
    cut_edges(c, 128)
    c.check()
    for kw in (dict(mn=2, mx=9), dict(stride=4096, nb=8)):
        c = Case(sub, words, cuda, algo=algo, mode=mode, **kw)
        assert c.key == f"piece_{name}/{algo}"
        c.check()


#: A line at the route gate's limits: 64 bytes, 24 slots of a key with 8
#: options of 4 bytes (radix 9), MD5 in 3 hash blocks.
GATE_MAX = {b"q": [bytes([65 + k]) * 4 for k in range(8)]}


def test_gate_max_line_matches_plain_version(cuda):
    rng = np.random.default_rng(41)
    words = []
    for _ in range(4):
        w = np.frombuffer(b"bcdfghjklm", np.uint8)[rng.integers(
            0, 10, size=64)].copy()
        w[rng.choice(64, size=24, replace=False)] = ord("q")
        words.append(bytes(w))
    spec = AttackSpec()
    ct = compile_table(GATE_MAX)
    plan = build_plan(spec, ct, pack_words(words))
    pieces = piece_schema_for(plan, ct)
    assert fe.opts_for(spec, plan, ct) == 8 and int(plan.num_slots) == 24
    # Words of 9^24 rows take the per-launch pipeline: blocks cut on the
    # host.
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        host_blocks,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.blocks import make_blocks

    assert superstep_index(plan, 128) is None
    arrays = device_arrays(plan, pieces, build_digest_set([], "md5"), None,
                           device=cuda)
    batch, _w, _r = make_blocks(plan, max_variants=256 * 128,
                                max_blocks=256, fixed_stride=128)
    blocks = host_blocks(batch, 256, "digits",
                         fe.scalar_units_weight(plan), device=cuda)
    kw = dict(pieces=pieces, block_stride=128, min_substitute=1,
              max_substitute=15, pair=False, algo="md5", decode="digits",
              pack_cb=False, k_opts=fe.k_vals_for(plan))
    assert fe._hash_blocks_for(plan.out_width) == 3
    state, emit = fe.fused_expand_md5(*blocks, arrays,
                                      out_width=int(plan.out_width), **kw)
    want_state, want_emit = fe.piece_md5_reference(*blocks, arrays,
                                                   hash_blocks=3, **kw)
    torch.cuda.synchronize()
    assert emit.any() and torch.equal(emit, want_emit)
    assert torch.equal(state[emit], want_state[emit])


_BYTESCAN_EDGES = sorted(k for k in _BYTESCAN_CASES
                         if _BYTESCAN_CASES[k][4] == 1)


@pytest.mark.parametrize("label,algo", _BYTESCAN_EDGES,
                         ids=[f"{t}-{a}" for t, a in _BYTESCAN_EDGES])
def test_bytescan_cta_edges_match_plain_version(label, algo, cuda):
    """Every byte-scan tier's CTAs at their edges (16-lane blocks: a
    launch whose block count ends a CTA part-way, counts 0 and 1, a run
    of count-0 blocks); german's "sss" clash lanes among them."""
    sub, words, mode, mx, _blocks, tier = _BYTESCAN_CASES[(label, algo)]
    c = BSCase(sub, words, cuda, algo=algo, mx=mx, mode=mode, stride=16,
               nb=101)
    assert (c.tier.row, c.tier.decode, c.tier.variant) == tier
    cut_edges(c, 16)
    c.check()


@pytest.mark.parametrize("label", ["scalar-bitmask", "match-digits",
                                   "suball-closed"])
@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_bytescan_window_and_chunks_match_plain_version(label, algo, cuda):
    """One tier of each byte-scan row under the window cut -m 2 -x 9, and
    with blocks of 4096 lanes cut into chunks."""
    sub, words, mode, _mx, _blocks, tier = _BYTESCAN_CASES[(label, algo)]
    for kw in (dict(mn=2, mx=9), dict(stride=4096, nb=8)):
        c = BSCase(sub, words, cuda, algo=algo, mode=mode, **kw)
        assert (c.tier.row, c.tier.decode, c.tier.variant) == tier
        c.check()


@pytest.mark.parametrize("width,offset", [(55, 1), (376, 2), (56, 3),
                                          (2101, 1)])
@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_buffer_hash_unaligned_buffers(algo, width, offset, cuda):
    """Rows in a buffer that is not 4-byte aligned (a view into a larger
    allocation): funnel-shifted loads, byte loads where an aligned word
    would leave the buffer."""
    g = torch.Generator(device="cuda").manual_seed(width)
    n = 4099
    raw = torch.randint(0, 256, (n * width + offset,), dtype=torch.uint8,
                        device=cuda, generator=g)
    msg = raw[offset:].view(n, width)
    ln = torch.randint(0, width + 1, (n,), dtype=torch.int32, device=cuda,
                       generator=g)
    ln[-1] = width
    assert torch.equal(bh.buffer_hash(msg, ln, algo),
                       bh.HASH_FNS[algo](msg, ln))


def assert_buffer_hash_matches(algo, width, seed, cuda):
    """Every row of ``width`` bytes (lengths uniform in 0..W) equal to the
    plain version, tolerance 0; the call launches the kernel, never the
    plain version."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    msg = torch.randint(0, 256, (1 << 16, width), dtype=torch.uint8,
                        device=cuda, generator=g)
    ln = torch.randint(0, width + 1, (1 << 16,), dtype=torch.int32,
                       device=cuda, generator=g)
    key = f"buffer_hash/{algo}"
    launches, plain = bh.LAUNCHES[key], bh.PLAIN_CALLS
    got = bh.buffer_hash(msg, ln, algo)
    assert bh.LAUNCHES[key] == launches + 1 and bh.PLAIN_CALLS == plain
    assert torch.equal(got, bh.HASH_FNS[algo](msg, ln)), width
    if algo == "md5":
        m, n = msg[:64].cpu().numpy(), ln[:64].cpu().numpy()
        st = got[:64].cpu().numpy().view(np.uint32)
        assert all(st[i].astype("<u4").tobytes()
                   == hashlib.md5(m[i, :n[i]].tobytes()).digest()
                   for i in range(64))


@pytest.mark.parametrize("blocks", [1, 2, 3, 5])
@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_buffer_hash_matches_plain_version(algo, blocks, cuda):
    """The widest width ``blocks`` blocks hold (odd: funnel-shifted
    loads), one byte less, and three bytes less (a multiple of 4: aligned
    loads)."""
    width = (64 * blocks - 9) // (2 if algo == "ntlm" else 1)
    for w in (width, width - 1, width - 3):
        assert_buffer_hash_matches(algo, w, blocks, cuda)
    assert (width - 3) % 4 == 0


@pytest.mark.parametrize("algo", ["md5", "md4", "sha1", "ntlm"])
def test_buffer_hash_main_path_widths(algo, cuda):
    """The main path's own XLA-route widths: 376 (a long-line bucket, 7
    MD5 blocks) and 28 (the nine-option plan), both multiples of 4."""
    for w in (376, 28):
        assert_buffer_hash_matches(algo, w, w, cuda)


def xla_words(seed):
    rng = np.random.default_rng(seed)
    words = letter_words(150, 3, 9, seed)
    for _ in range(6):  # lines over 64 bytes: the XLA route
        w = rng.integers(ord("a"), ord("z") + 1, size=int(
            rng.integers(66, 120)), dtype=np.uint8)
        w[::5] = ord(" ")
        words.insert(int(rng.integers(0, len(words))), bytes(w))
    return words


@pytest.mark.parametrize("table,mode,algo,mx,env", [
    ("leet9", "default", "md5", 2, ""),
    ("leet9", "suball", "ntlm", 2, ""),
    ("qwerty-cyrillic", "default", "sha1", 2, ""),
    ("qwerty-cyrillic", "suball-reverse", "md4", 2, ""),
    ("czech", "default", "ntlm", 2, "off"),
    ("qwerty-azerty", "suball", "md5", 15, "off"),
])
def test_xla_route_sweeps_on_the_gpu_equal_the_cpu(table, mode, algo, mx,
                                                   env, cuda, monkeypatch):
    monkeypatch.setenv("A5GEN_PALLAS", env)
    sub = LEET9 if table == "leet9" else \
        get_layout(table).to_substitution_map()
    words = xla_words(62)
    words[5:5] = [b"m,;", b"aqua", b"AQq", b"am,;q"]
    spec = AttackSpec(mode=mode, algo=algo, max_substitute=mx)
    cfg = dict(lanes=4096, num_blocks=32)
    probe = Sweep(spec, sub, words, [], SweepConfig(device="cpu", **cfg))
    digests = [HOST_DIGEST[algo](decode_variant(
        probe.plan, probe.ct, spec, row, probe.plan.n_variants[row] // 2))
        for row in range(0, len(words), 5)
        if probe.plan.n_variants[row] >= 2 and not probe.plan.fallback[row]]
    results = [Sweep(spec, sub, words, digests,
                     SweepConfig(device=dev, **cfg)).run_crack()
               for dev in ("cuda", "cpu")]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want and got
    assert results[0].n_emitted == results[1].n_emitted
    assert results[0].kernels == results[1].kernels
    assert results[0].routes == results[1].routes == {"xla": 1}


@pytest.mark.parametrize("table,mode,mx", [
    ("qwerty-cyrillic", "default", 2), ("qwerty-azerty", "suball", 15),
    ("leet9", "reverse", 15),
])
def test_candidates_on_the_gpu_equal_the_cpu(table, mode, mx, cuda):
    sub = LEET9 if table == "leet9" else \
        get_layout(table).to_substitution_map()
    words = xla_words(63)
    words[5:5] = [b"m,;", b"aqua", b"AQq", b"am,;q"]
    spec = AttackSpec(mode=mode, max_substitute=mx)
    streams = []
    for dev in ("cuda", "cpu"):
        buf = io.BytesIO()
        res = Sweep(spec, sub, words, (),
                    SweepConfig(device=dev, lanes=4096, num_blocks=32)
                    ).run_candidates(CandidateWriter(buf))
        streams.append((buf.getvalue(), res.n_emitted))
    assert streams[0] == streams[1] and streams[0][1] > 0


@pytest.mark.parametrize("mode", ["default", "suball"])
def test_streamed_crack_on_the_gpu_equals_the_whole_path(mode, cuda,
                                                         monkeypatch):
    """A crack sweep streamed in chunks of 37 words on the GPU: the same
    hits and counts as its whole-path twin on the GPU and on the CPU, each
    chunk's arrays uploaded by the ring's worker on a side stream (the
    drive's stream waits on the chunk's event), every chunk released."""
    sub = AZERTY if mode == "suball" else SUB
    words = letter_words(300, 2, 9, 51)
    words[40:40] = [b"m,;", b"aqua", b"AQq", b"am,;q"]
    spec = AttackSpec(mode=mode)
    cfg = dict(lanes=4096, num_blocks=32)
    probe = Sweep(spec, sub, words, [], SweepConfig(device="cpu", **cfg))
    digests = [HOST_DIGEST["md5"](decode_variant(
        probe.plan, probe.ct, spec, row, probe.plan.n_variants[row] // 2))
        for row in range(0, len(words), 7)
        if probe.plan.n_variants[row] >= 2 and not probe.plan.fallback[row]]
    events, released = [], []
    compile_chunk, release = Sweep._compile_chunk, Sweep._release_chunk

    def watched(self, *a, **kw):
        chunk = compile_chunk(self, *a, **kw)
        setup = chunk.payload["setup"]
        if setup is not None:
            events.append(setup["ready"])
            assert all(v.is_cuda for v in setup["arrays"].values()
                       if torch.is_tensor(v))
        return chunk

    def counted(self, chunk):
        released.append(chunk.index)
        release(self, chunk)

    monkeypatch.setattr(Sweep, "_compile_chunk", watched)
    monkeypatch.setattr(Sweep, "_release_chunk", counted)
    results = [Sweep(spec, sub, words, digests,
                     SweepConfig(device=dev, stream_chunk_words=chunk,
                                 **cfg)).run_crack()
               for dev, chunk in (("cuda", 37), ("cuda", "off"),
                                  ("cpu", "off"))]
    got = [[(h.word_index, h.variant_rank, h.candidate) for h in r.hits]
           for r in results]
    assert got[0] == got[1] == got[2] and got[0]
    assert results[0].n_emitted == results[1].n_emitted == \
        results[2].n_emitted
    s = results[0].stream
    assert s["chunks_swept"] == s["chunks"] == 9 and not results[1].stream
    assert released == list(range(9))
    assert events and all(isinstance(e, torch.cuda.Event) for e in events)


@pytest.mark.parametrize("kind", ["crack", "candidates"])
def test_packed_layout_xla_launch_equals_plain_version(kind, cuda):
    """One per-launch step on the variable-offset layout (``--lanes
    1000``: 1024 blocks that do not divide it), the XLA route: its
    ``buffer_hash`` launch and expansion on the GPU equal the plain
    version of the same blocks on the CPU (counters and hit mask, or the
    emitted candidate rows)."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        host_blocks,
        make_candidates_step,
        make_crack_step,
        xla_arrays,
    )
    from hashcat_a5_table_generator_tpu_torch.ops.blocks import make_blocks

    words = letter_words(60, 3, 9, 52)
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words))
    pieces = piece_schema_for(plan, ct)
    batch, _w, _r = make_blocks(plan, start_word=3, start_rank=5,
                                max_variants=1000, max_blocks=1024)
    digests = build_digest_set(
        [hashlib.md5(decode_variant(plan, ct, spec, 3, 6)).digest()], "md5")
    kw = dict(num_lanes=1000, out_width=int(plan.out_width),
              block_stride=None, pieces=pieces)
    launches = bh.LAUNCHES["buffer_hash/md5"] if kind == "crack" \
        else None
    outs = []
    for dev in ("cuda", "cpu"):
        arrays = xla_arrays(plan, ct, pieces,
                            digests if kind == "crack" else None, None,
                            device=dev)
        if kind == "crack":
            step = make_crack_step(spec, xla=True, decode="digits", **kw)
        else:
            step = make_candidates_step(spec, **kw)
        blocks = host_blocks(batch, 1024, step.decode,
                             fe.scalar_units_weight(plan), device=dev,
                             packed=True)
        out = step(arrays, *blocks)
        outs.append([t.cpu() for t in (out.values() if kind == "crack"
                                       else out)])
    for g, w in zip(*outs):
        assert torch.equal(g, w)
    if kind == "crack":
        assert int(outs[0][0][0]) > 0 and bool(outs[0][1].any())
        assert bh.LAUNCHES["buffer_hash/md5"] > launches
    else:
        assert outs[0][0].shape[0] > 0


@pytest.mark.parametrize("superstep", [None, 0], ids=["superstep",
                                                      "per-launch"])
def test_two_stripes_on_one_gpu_equal_the_single_device_sweep(superstep,
                                                              cuda):
    """``devices=[cuda:0, cuda:0]``: two cursor stripes on one card, each
    on its own CUDA stream (the superstep drive), print the single
    device's hits and count its candidates."""
    words = words_for("k1", seed=3) + words_for("2-hash-blocks", seed=4)[:5]
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words))
    digests = [hashlib.md5(decode_variant(
        plan, ct, spec, row, plan.n_variants[row] // 2)).digest()
        for row in range(0, len(words), 3) if plan.n_variants[row] >= 2]
    results = [
        Sweep(spec, SUB, words, digests,
              SweepConfig(device="cuda", lanes=4096, num_blocks=32,
                          superstep=superstep, superstep_hit_cap=3,
                          devices=devices)).run_crack()
        for devices in (1, [cuda, cuda])
    ]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in reversed(results))
    assert got == want and len(got) >= len(digests)
    assert results[0].n_emitted == results[1].n_emitted


@pytest.mark.parametrize("pair", [None, "off"], ids=["pair-auto", "k1"])
def test_packed_group_on_the_gpu_equals_the_solo_runs(pair, cuda):
    """Two tenants (one dictionary shape, their own digest lists) fused
    into one packed group by the resident engine on the card: the group
    launches the piece kernel, and each job's hits and candidate count
    equal its solo sweep's on the card."""
    from hashcat_a5_table_generator_tpu_torch.runtime.engine import Engine

    words = words_for("k1", seed=5)
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words))
    jobs = []
    for j, ws in enumerate((words, words[7:] + words[:7])):
        digests = [hashlib.md5(decode_variant(
            plan, ct, spec, row, plan.n_variants[row] // (2 + j))).digest()
            for row in range(j, len(words), 4) if plan.n_variants[row] >= 3]
        jobs.append((ws, digests + [bytes([j]) * 16]))
    c = SweepConfig(device="cuda", lanes=4096, num_blocks=32, superstep=2,
                    pair=pair, superstep_hit_cap=8)
    want = [Sweep(spec, SUB, w, d, c).run_crack() for w, d in jobs]
    before = dict(fe.LAUNCHES)
    eng = Engine(c, auto=False)
    handles = [eng.submit(spec, SUB, w, d) for w, d in jobs]
    eng.run_until_idle()
    stats = eng.stats()
    got = [h.result(timeout=0) for h in handles]
    eng.close()
    assert stats["packed_dispatches"] > 0
    assert any(fe.LAUNCHES[k] > before.get(k, 0) for k in fe.LAUNCHES)
    for g, w in zip(got, want):
        assert [(h.word_index, h.variant_rank, h.candidate)
                for h in g.hits] == [(h.word_index, h.variant_rank,
                                      h.candidate) for h in w.hits]
        assert g.n_emitted == w.n_emitted and g.n_hits > 0
        assert g.superstep.get("packed") == 2


@pytest.mark.parametrize("table,env", [("german", ""), ("czech", "bytescan")])
def test_packed_bytescan_group_on_the_gpu_equals_the_solo_runs(
        table, env, cuda, monkeypatch):
    """Two byte-scan tenants (german's "sss" words: row 7; czech under
    ``A5GEN_EMIT=bytescan``: row 8) fused into one packed group on the
    card: the group's packed supersteps launch the byte-scan kernel only
    (overflow re-runs included: a hit cap of 8), and each job's hits and
    candidate count equal its solo sweep's on the card."""
    from hashcat_a5_table_generator_tpu_torch.runtime import fuse
    from hashcat_a5_table_generator_tpu_torch.runtime.engine import Engine

    monkeypatch.setenv("A5GEN_EMIT", env)
    monkeypatch.setattr(fuse, "GROUP_LAUNCHES", {})
    sub = get_layout(table).to_substitution_map()
    words = (german_words(200, 3, 8, 62) if table == "german"
             else letter_words(200, 2, 8, 63))
    spec = AttackSpec()
    c = SweepConfig(device="cuda", lanes=4096, num_blocks=32, superstep=2,
                    superstep_hit_cap=8)
    probe = Sweep(spec, sub, words, [], c)
    assert probe.route == "bytescan"
    jobs = []
    for j, ws in enumerate((words, words[7:] + words[:7])):
        digests = []
        for row in range(j, len(words), 4):
            try:
                digests.append(hashlib.md5(decode_variant(
                    probe.plan, probe.ct, spec, row,
                    probe.plan.n_variants[row] // (2 + j))).digest())
            except ValueError:  # a clash rank: not emitted
                pass
        jobs.append((ws, digests + [bytes([j]) * 16]))
    want = [Sweep(spec, sub, w, d, c).run_crack() for w, d in jobs]
    eng = Engine(c, auto=False)
    handles = [eng.submit(spec, sub, w, d) for w, d in jobs]
    eng.run_until_idle()
    stats = eng.stats()
    got = [h.result(timeout=0) for h in handles]
    eng.close()
    assert stats["packed_dispatches"] > 0
    assert set(fuse.GROUP_LAUNCHES) == {probe.bytescan.launch_key("md5")}
    assert fuse.GROUP_LAUNCHES[probe.bytescan.launch_key("md5")] >= \
        2 * stats["packed_dispatches"]
    for g, w in zip(got, want):
        assert [(h.word_index, h.variant_rank, h.candidate)
                for h in g.hits] == [(h.word_index, h.variant_rank,
                                      h.candidate) for h in w.hits]
        assert g.n_emitted == w.n_emitted and g.n_hits > 0
        assert g.superstep.get("packed") == 2
