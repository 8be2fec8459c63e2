"""The piece kernel of the PyTorch/CUDA package against the JAX reference.

On the CPU the wrapper runs the kernel's plain PyTorch version; it must
match the reference's fused Pallas kernel (interpret mode, a few tiny
cases) and its XLA twin (``expand_matches`` + ``HASH_FNS[algo]``) bit for
bit on every emitted lane, with equal emit masks: at K=1 and in the pair
tier, for static and dynamic pair deltas, for the scalar, digit and
windowed decodes, for MD5, MD4, SHA-1 and NTLM, and for 1-3 chained hash
blocks.  The CUDA source itself is compiled for the host with g++ (CUDA
keywords stubbed; the windowed, scalar K=1 and pair tiers' CTAs run
phase by phase, a warp's ballot the one thread's own vote) and must
equal the plain version on every lane of every instantiation (the
windowed tier writes no state for lanes past a block's count, the scalar
K=1 and pair tiers none for dead rows: their state is compared on the
rows they write), at edge CTA geometries too;
``tests/test_torch_cuda.py`` compares the real kernels on a GPU.
"""

import hashlib
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.ops.pallas_expand as pe
from hashcat_a5_table_generator_tpu.models.attack import (
    AttackSpec,
    block_arrays,
    build_plan,
    plan_arrays,
    table_arrays,
)
from hashcat_a5_table_generator_tpu.ops.blocks import make_blocks, pad_batch
from hashcat_a5_table_generator_tpu.ops.expand_matches import expand_matches
from hashcat_a5_table_generator_tpu.ops.expand_suball import expand_suball
from hashcat_a5_table_generator_tpu.ops.hashes import HASH_FNS
from hashcat_a5_table_generator_tpu.ops.packing import (
    pack_words,
    piece_schema_for,
)
from hashcat_a5_table_generator_tpu.tables.compile import compile_table
from hashcat_a5_table_generator_tpu_torch.models.attack import (
    piece_tables,
)
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

#: 1:1 option maps (radix 2 everywhere, pair-eligible), as in
#: tests/test_pair.py.  STATIC: every value 2 bytes (pair delta +1
#: always); DYN: 1- and 2-byte values (delta 0 or +1 per word).
SUB_STATIC = {b"a": [b"@@"], b"o": [b"00"], b"s": [b"$$"], b"e": [b"33"]}
SUB_DYN = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}
#: Three options per key (radix 4, even): the digit decode's pair tier.
SUB_LEET3 = {b"a": [b"4", b"@", b"^"], b"e": [b"3", b"&", b"EE"],
             b"s": [b"$", b"5", b"z"], b"o": [b"0", b"()", b"*"]}
WORDS = [b"ase", b"oo", b"z", b"seas", b"es", b"password", b"oases"]
CYR = get_layout("qwerty-cyrillic").to_substitution_map()
CZECH = get_layout("czech").to_substitution_map()
ALGOS = ("md5", "md4", "sha1", "ntlm")
CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "hashcat_a5_table_generator_tpu_torch" / "csrc" / "piece_hash.cu")


class Launch:
    """One launch's blocks, cut by the reference's host cutter from the
    reference's plan, and the same numpy arrays as the port's torch
    inputs.  ``mx`` < 9 may make the plan count-windowed; ``mode`` picks
    a match (default, reverse) or substitute-all plan."""

    def __init__(self, sub, words, *, pair, stride=128, nb=8, algo="md5",
                 mx=15, mode="default", mn=0, count_edits=None):
        self.spec = AttackSpec(mode=mode, algo=algo, min_substitute=mn,
                               max_substitute=mx)
        self.suball = mode.startswith("suball")
        self.algo = algo
        self.ct = compile_table(sub)
        self.plan = build_plan(self.spec, self.ct, pack_words(words))
        self.pieces = piece_schema_for(self.plan, self.ct)
        self.decode, self.pack_cb = fe.decode_for(self.plan)
        self.k_opts = fe.k_vals_for(self.plan)
        self.pair, self.stride, self.nb = pair, stride, nb
        #: {block: count} overrides of the cut's counts (lowering a count
        #: keeps every rank inside its word).
        self.count_edits = dict(count_edits or {})
        rank_stride = stride * (2 if pair else 1)
        batch, _, _ = make_blocks(self.plan, max_variants=nb * rank_stride,
                                  max_blocks=nb, fixed_stride=rank_stride)
        self.batch = pad_batch(batch, nb)
        self.hash_blocks = fe._hash_blocks_for(self.plan.out_width,
                                               fe._scale(algo))

    def _win_v(self):
        import jax.numpy as jnp

        return jnp.asarray(self.plan.win_v) if self.plan.windowed else None

    def _plan_inputs(self):
        """The plan's per-kind arrays, as the reference's wrappers take
        them (a closed plan's own value table replaces the table's)."""
        p, t = plan_arrays(self.plan), table_arrays(self.ct)
        if not self.suball:
            return (p["tokens"], p["lengths"], p["match_pos"],
                    p["match_len"], p["match_radix"], p["match_val_start"],
                    t["val_bytes"], t["val_len"]), {}
        return (p["tokens"], p["lengths"], p["pat_radix"],
                p["pat_val_start"], p["seg_orig_start"], p["seg_orig_len"],
                p["seg_pat"], p.get("cval_bytes", t["val_bytes"]),
                p.get("cval_len", t["val_len"])), dict(
                    close_next=p.get("close_next"),
                    close_mul=p.get("close_mul"))

    def reference_pallas(self):
        args, close = self._plan_inputs()
        b = block_arrays(self.batch, num_blocks=self.nb)
        fn = pe.fused_expand_suball_md5 if self.suball else pe.fused_expand_md5
        state, emit = fn(
            *args, b["word"], b["base"], b["count"],
            num_lanes=self.nb * self.stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute,
            block_stride=self.stride, k_opts=self.k_opts, interpret=True,
            scalar_units=pe.scalar_units_for(self.plan),
            pieces=self.pieces, pair=self.pair, algo=self.algo,
            win_v=self._win_v(), **close,
        )
        return np.asarray(state).view(np.int32), np.asarray(emit)

    def reference_xla(self):
        cand, clen, emit = self.reference_expand()
        state = np.asarray(HASH_FNS[self.algo](cand, clen)).view(np.int32)
        return state, np.asarray(emit)

    def reference_expand(self):
        """The XLA twin's candidate buffers (hash-independent)."""
        args, close = self._plan_inputs()
        b = block_arrays(self.batch, num_blocks=self.nb)
        fn = expand_suball if self.suball else expand_matches
        cand, clen, _w, emit = fn(
            *args, b["word"], b["base"], b["count"], b["offset"], **close,
            num_lanes=self.nb * self.stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute,
            block_stride=self.stride, radix2=self.k_opts == 1,
            pieces=self.pieces, win_v=self._win_v(),
            pair_k=2 if self.pair else None,
        )
        return cand, clen, emit

    def inputs(self):
        """(word, count, base, tables) as CPU torch tensors: the decode's
        block input and the piece tables plus ``radix`` / ``win_v``."""
        digits = self.batch.base_digits
        if self.decode == "scalar":
            weight = fe.scalar_units_weight(self.plan)
            base = (digits.astype(np.int64) * weight[self.batch.word]
                    ).sum(axis=1)
        elif self.decode == "windowed":
            base = digits[:, 0]  # windowed blocks start at scalar ranks
        else:
            base = digits
        tables = piece_tables(self.pieces, device="cpu")
        for name, arr in fe.selector_tables(self.plan, self.pieces).items():
            tables[name] = torch.from_numpy(arr)
        tables["radix"] = torch.from_numpy(
            np.ascontiguousarray(self.plan.pat_radix, np.int32))
        if self.plan.windowed:
            tables["win_v"] = torch.from_numpy(
                np.ascontiguousarray(self.plan.win_v, np.int32))
        count = self.batch.count.copy()
        for b, c in self.count_edits.items():
            assert c <= count[b]
            count[b] = c
        return (torch.from_numpy(self.batch.word.copy()),
                torch.from_numpy(count),
                torch.from_numpy(np.ascontiguousarray(base, np.int32)),
                tables)

    def kwargs(self):
        return dict(pieces=self.pieces, block_stride=self.stride,
                    out_width=int(self.plan.out_width),
                    min_substitute=self.spec.effective_min,
                    max_substitute=self.spec.max_substitute, pair=self.pair,
                    algo=self.algo, decode=self.decode,
                    pack_cb=self.pack_cb, k_opts=self.k_opts)

    def port(self):
        word, count, base, tables = self.inputs()
        state, emit = fe.fused_expand_md5(word, count, base, tables,
                                          **self.kwargs())
        return state.numpy(), emit.numpy()


def assert_same(got, want):
    (gs, ge), (ws, we) = got, want
    assert ge.shape == we.shape and (ge == we).all()
    assert we.any()
    bad = np.nonzero(we & (gs != ws).any(axis=1))[0]
    assert bad.size == 0, f"state mismatch at rows {bad[:8]}"


@pytest.mark.parametrize("pair", [False, True], ids=["k1", "pair"])
@pytest.mark.parametrize("sub", [SUB_STATIC, SUB_DYN],
                         ids=["static-delta", "dynamic-delta"])
def test_plain_matches_reference_kernel(sub, pair):
    launch = Launch(sub, WORDS, pair=pair)
    assert launch.pieces.pair_ok
    if sub is SUB_STATIC:
        assert launch.pieces.pair_dmin == launch.pieces.pair_dmax
    else:
        assert launch.pieces.pair_dmin != launch.pieces.pair_dmax
    assert_same(launch.port(), launch.reference_pallas())


def _long_words(n, lo, hi, seed, letters=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.integers(ord("0"), ord("9") + 1, size=int(rng.integers(
            lo, hi + 1)), dtype=np.uint8)
        pos = rng.choice(len(w), size=letters, replace=False)
        w[pos] = rng.integers(ord("a"), ord("z") + 1, size=letters,
                              dtype=np.uint8)
        out.append(bytes(w))
    return out


def _letter_words(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(ord("a"), ord("z") + 1,
                               size=int(rng.integers(lo, hi + 1)),
                               dtype=np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("blocks,lo,hi", [(2, 40, 64), (3, 100, 120)],
                         ids=["2-hash-blocks", "3-hash-blocks"])
def test_plain_matches_reference_multi_block(blocks, lo, hi):
    launch = Launch(CYR, _long_words(6, lo, hi, seed=blocks), pair=False,
                    stride=8, nb=24)
    assert fe._hash_blocks_for(launch.plan.out_width) == blocks
    assert_same(launch.port(), launch.reference_xla())


def test_emitted_states_are_md5_of_the_spliced_candidates():
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        decode_variant,
    )

    launch = Launch(SUB_DYN, WORDS, pair=True, stride=16, nb=8)
    state, emit = launch.port()
    rank_stride = 32
    for row in np.flatnonzero(emit):
        blk = row // rank_stride
        base = launch.batch.base_digits[blk]
        w = int(launch.batch.word[blk])
        rank0, scale = 0, 1
        for s, r in enumerate(launch.plan.match_radix[w]):
            rank0 += int(base[s]) * scale
            scale *= int(r)
        cand = decode_variant(launch.plan, launch.ct, launch.spec, w,
                              rank0 + int(row % rank_stride))
        assert state[row].astype("<i4").tobytes() == \
            hashlib.md5(cand).digest()


# ---------------------------------------------------------------------------
# The digit and windowed decodes and the other hashes
# ---------------------------------------------------------------------------

#: Decode tiers by workload: (table, words, max_substitute, pair).
TIERS = {
    "digits": (CZECH, _letter_words(12, 1, 6, seed=21), 15, False),
    "windowed-cb": (CYR, _letter_words(12, 6, 9, seed=22), 2, False),
    "windowed-digits": (CZECH, _letter_words(12, 9, 12, seed=23), 2, False),
    "pair-digits": (SUB_LEET3, WORDS + [b"assessee", b"lasso"], 15, True),
}
_TIER_DECODE = {"digits": ("digits", False), "windowed-cb": ("windowed", True),
                "windowed-digits": ("windowed", False),
                "pair-digits": ("digits", False)}


def tier_launch(tier, algo, **kw):
    sub, words, mx, pair = TIERS[tier]
    launch = Launch(sub, words, pair=pair, algo=algo, mx=mx, **kw)
    assert (launch.decode, launch.pack_cb) == _TIER_DECODE[tier]
    assert launch.plan.windowed == tier.startswith("windowed")
    return launch


_EXPANDED = {}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_plain_matches_reference_xla_twin(tier, algo):
    launch = tier_launch(tier, algo, stride=32, nb=8)
    assert launch.hash_blocks == 1
    # The candidate buffers do not depend on the hash: expand once a tier.
    if tier not in _EXPANDED:
        _EXPANDED[tier] = launch.reference_expand()
    cand, clen, emit = _EXPANDED[tier]
    want = np.asarray(HASH_FNS[algo](cand, clen)).view(np.int32)
    assert_same(launch.port(), (want, np.asarray(emit)))


@pytest.mark.parametrize("tier,algo", [("digits", "ntlm"),
                                       ("windowed-cb", "sha1"),
                                       ("pair-digits", "md5")])
def test_plain_matches_reference_kernel_decodes(tier, algo):
    """The reference's Pallas body itself (interpret mode), tiny shapes."""
    launch = tier_launch(tier, algo, stride=16, nb=8)
    assert_same(launch.port(), launch.reference_pallas())


#: Multi-block workloads per hash: NTLM's doubled width reaches 2 and 3
#: blocks at half the candidate length.
MULTI = {
    ("ntlm", 2): (CZECH, lambda: _letter_words(6, 18, 26, seed=31)),
    ("ntlm", 3): (CZECH, lambda: _long_words(6, 40, 60, seed=32,
                                             letters=12)),
    ("sha1", 2): (CYR, lambda: _long_words(6, 40, 64, seed=33)),
    ("sha1", 3): (CYR, lambda: _long_words(6, 100, 120, seed=34)),
    ("md4", 2): (CYR, lambda: _long_words(6, 40, 64, seed=35)),
}


@pytest.mark.parametrize(
    "algo,blocks", sorted(MULTI),
    ids=[f"{a}-{b}-hash-blocks" for a, b in sorted(MULTI)])
def test_plain_matches_reference_multi_block_hashes(algo, blocks):
    sub, words = MULTI[(algo, blocks)]
    launch = Launch(sub, words(), pair=False, stride=8, nb=24, algo=algo)
    assert launch.hash_blocks == blocks
    assert_same(launch.port(), launch.reference_xla())


@pytest.mark.parametrize("algo", ALGOS)
def test_emitted_states_are_host_digests_of_the_candidates(algo):
    """Emitted windowed states re-hash on the host: ``decode_variant``
    unranks windowed ranks, ``HOST_DIGEST`` hashes (SHA-1's state words
    serialize big-endian)."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        decode_variant,
    )

    launch = tier_launch("windowed-digits", algo, stride=16, nb=8)
    state, emit = launch.port()
    order = ">u4" if algo == "sha1" else "<u4"
    assert emit.sum() > 10
    for row in np.flatnonzero(emit):
        blk = row // launch.stride
        w = int(launch.batch.word[blk])
        rank = int(launch.batch.base_digits[blk, 0]) + int(
            row % launch.stride)
        cand = decode_variant(launch.plan, launch.ct, launch.spec, w, rank)
        assert state[row].view(np.uint32).astype(order).tobytes() == \
            HOST_DIGEST[algo](cand)


def test_wrapper_counts_plain_runs_and_refuses_other_tiers():
    launch = Launch(SUB_STATIC, WORDS, pair=False)
    word, count, pbase, tables = launch.inputs()
    kw = dict(pieces=launch.pieces, block_stride=launch.stride,
              out_width=int(launch.plan.out_width), min_substitute=1,
              max_substitute=15)
    before = fe.PLAIN_CALLS
    launches = dict(fe.LAUNCHES)
    fe.fused_expand_md5(word, count, pbase, tables, **kw)
    assert fe.PLAIN_CALLS == before + 1 and fe.LAUNCHES == launches
    general = Launch({b"a": [b"4", b"@", b"^"], b"s": [b"$"]}, WORDS,
                     pair=False)
    with pytest.raises(NotImplementedError, match="bit-field"):
        fe.fused_expand_md5(word, count, pbase, tables,
                            **dict(kw, pieces=general.pieces))
    with pytest.raises(NotImplementedError, match="hash blocks"):
        fe.fused_expand_md5(word, count, pbase, tables,
                            **dict(kw, out_width=190))
    with pytest.raises(NotImplementedError, match="hash blocks"):
        fe.fused_expand_md5(word, count, pbase, tables,
                            **dict(kw, out_width=100, algo="ntlm"))
    with pytest.raises(ValueError):
        fe.fused_expand_md5(word.long(), count, pbase, tables, **kw)
    with pytest.raises(ValueError, match="radix"):
        fe.fused_expand_md5(word, count, pbase, {
            k: v for k, v in tables.items() if k != "radix"
        }, **dict(kw, decode="digits"))
    with pytest.raises(ValueError, match="pair"):
        fe.fused_expand_md5(word, count, pbase, tables,
                            **dict(kw, decode="windowed", pair=True))


# ---------------------------------------------------------------------------
# The CUDA source, compiled for the host
# ---------------------------------------------------------------------------

_HARNESS_MAIN = r"""
template <class T> static std::vector<T> rd(const char* p, size_t n) {
  std::vector<T> v(n ? n : 1); FILE* f = fopen(p, "rb");
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(3);
  fclose(f); return v; }
// The tile tiers (scalar and digit decodes at K=1, the pair tier): every
// CTA's phases in order, each phase run by each of its `nt` threads
// before the next (the barriers; a warp's ballot is the one thread's own
// vote), shared memory filled with garbage first.
template <int A, int K, int D, int HB, bool P, bool C>
static void cta_tile(const LaunchArgs& a, const PieceTables& t, int gmax,
                     int nt, int lmax) {
  const TileGeom g = tile_geometry(a, t, K, D, C, P ? 2 : 1, HB, nt, gmax,
                                   lmax);
  std::vector<int32_t> smem(g.smem_bytes / 4 + 1);
  blockDim.x = nt;
  const long long grid = (long long)((a.nb + g.g - 1) / g.g) * g.c;
  for (long long cta = 0; cta < grid; ++cta) {
    blockIdx.x = (unsigned)cta;
    std::fill(smem.begin(), smem.end(), 0x5A5A5A5A);
    for (int p = 0; p < TILE_PHASES; ++p)
      for (int th = 0; th < nt; ++th) {
        threadIdx.x = th;
        tile_phase<A, K, D, HB, P, C>(p, a, t, g, smem.data());
      }
  }
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
}
template <int A, int K, int D, bool C>
static void tile_hb(const LaunchArgs& a, const PieceTables& t, int hb,
                    int gmax, int nt, int lmax) {
  if (hb == 1) cta_tile<A, K, D, 1, false, C>(a, t, gmax, nt, lmax);
  else if (hb == 2) cta_tile<A, K, D, 2, false, C>(a, t, gmax, nt, lmax);
  else cta_tile<A, K, D, 3, false, C>(a, t, gmax, nt, lmax);
}
template <int A, int K>
static void tile(const LaunchArgs& a, const PieceTables& t, int pair,
                 int decode, int hb, int closed, int gmax, int nt,
                 int lmax) {
  if (pair && decode == 0)
    cta_tile<A, K, 0, 1, true, false>(a, t, gmax, nt, lmax);
  else if (pair) cta_tile<A, K, 1, 1, true, false>(a, t, gmax, nt, lmax);
  else if (decode == 0) tile_hb<A, K, 0, false>(a, t, hb, gmax, nt, lmax);
  else if (!closed) tile_hb<A, K, 1, false>(a, t, hb, gmax, nt, lmax);
  else if (K) tile_hb<A, 1, 1, true>(a, t, hb, gmax, nt, lmax);
}
// The windowed tier: every CTA's phases in order, each phase run by each
// of its `nt` threads before the next (the barriers), shared memory
// filled with garbage first.
template <int A, int K, int HB, bool C, bool P>
static void cta_win(const LaunchArgs& a, const PieceTables& t, int gmax,
                    int nt) {
  const WinGeom g = win_geometry(a, t, K, C, P, HB, nt, gmax);
  std::vector<int32_t> smem(g.smem_bytes / 4 + 1);
  blockDim.x = nt;
  for (int cta = 0; cta * g.g < a.nb; ++cta) {
    blockIdx.x = cta;
    std::fill(smem.begin(), smem.end(), 0x5A5A5A5A);
    for (int p = 0; p < WIN_PHASES; ++p)
      for (int th = 0; th < nt; ++th) {
        threadIdx.x = th;
        win_phase<A, K, HB, C, P>(p, a, t, g, smem.data());
      }
  }
  blockDim.x = 1; threadIdx.x = 0;
}
template <int A, int K, bool C, bool P>
static void win_hb(const LaunchArgs& a, const PieceTables& t, int hb,
                   int gmax, int nt) {
  switch (hb) {
    case 1: cta_win<A, K, 1, C, P>(a, t, gmax, nt); break;
    case 2: cta_win<A, K, 2, C, P>(a, t, gmax, nt); break;
    default: cta_win<A, K, 3, C, P>(a, t, gmax, nt); break;
  }
}
template <int A, int K>
static void windowed(const LaunchArgs& a, const PieceTables& t, int hb,
                     int closed, int gmax, int nt) {
  if (closed) { if (K) win_hb<A, 1, true, false>(a, t, hb, gmax, nt); }
  else if (a.pack) win_hb<A, K, false, true>(a, t, hb, gmax, nt);
  else win_hb<A, K, false, false>(a, t, hb, gmax, nt);
}
int main(int argc, char** argv) {
  int v[28]; for (int i = 0; i < 28; ++i) v[i] = atoi(argv[i + 1]);
  int pair = v[1], decode = v[2], hb = v[3], nb = v[4],
      stride = v[5], m = v[6], k2 = v[7], k_opts = v[8], pack = v[9],
      ngw = v[10], ng16 = v[11], ngd = v[12], vm = v[13], nw = v[14],
      ng = v[15], mn = v[16], mx = v[17], B = v[18], nbase = v[19],
      words = v[20], kind = v[21], closed = v[22], ncols = v[23],
      close_s = v[24], gmax = v[25], nt = v[26], lmax = v[27];
  auto bw = rd<int32_t>("bw.bin", nb); auto bc = rd<int32_t>("bc.bin", nb);
  auto base = rd<int32_t>("base.bin", nbase);
  auto radix = rd<int32_t>("radix.bin", (size_t)B * m);
  auto winv = rd<int32_t>("winv.bin", (size_t)B * (m + 1) * k2);
  auto gw = rd<uint32_t>("pw.bin", (size_t)B * ngw * vm * nw);
  auto g16 = rd<int32_t>("pw16.bin", (size_t)B * ng16 * vm);
  auto gl = rd<int32_t>("pl.bin", (size_t)B * ngd * vm);
  auto desc = rd<int32_t>("desc.bin", (size_t)ng * DESC_WIDTH);
  auto sbit = rd<int32_t>("sel_bit.bin", kind ? (size_t)B * ncols : 0);
  auto sslot = rd<int32_t>("sel_slot.bin", kind ? (size_t)B * ncols : 0);
  auto bpos = rd<int32_t>("bitpos.bin", kind ? (size_t)B * m : 0);
  auto cnext = rd<int32_t>("close_next.bin",
                           closed ? (size_t)B * m * close_s : 0);
  auto cmul = rd<int32_t>("close_mul.bin",
                          closed ? (size_t)B * m * (close_s + 1) : 0);
  long long n = (long long)nb * stride * (pair ? 2 : 1);
  std::vector<int32_t> st(n * words); std::vector<uint8_t> em(n, 7);
  LaunchArgs a{bw.data(), bc.data(), base.data(), radix.data(), winv.data(),
               nb, stride, m, k2, k_opts, pack, desc.data(), ng, mn, mx,
               st.data(), em.data(),
               kind ? sbit.data() : nullptr, kind ? sslot.data() : nullptr,
               kind ? bpos.data() : nullptr,
               closed ? cnext.data() : nullptr,
               closed ? cmul.data() : nullptr, ncols, close_s};
  PieceTables t{gw.data(), g16.data(), gl.data(), ngw, ng16, ngd, vm, nw};
  if (decode == 2) {
    if (kind) windowed<HARNESS_ALGO, 1>(a, t, hb, closed, gmax, nt);
    else windowed<HARNESS_ALGO, 0>(a, t, hb, closed, gmax, nt);
  } else if (kind) {
    tile<HARNESS_ALGO, 1>(a, t, pair, decode, hb, closed, gmax, nt, lmax);
  } else {
    tile<HARNESS_ALGO, 0>(a, t, pair, decode, hb, closed, gmax, nt, lmax);
  }
  FILE* f = fopen("state.bin", "wb"); fwrite(st.data(), 4, n * words, f);
  fclose(f); f = fopen("emit.bin", "wb"); fwrite(em.data(), 1, n, f);
  fclose(f); return 0; }
"""

_HARNESS_STUB = r"""
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __global__
#define __restrict__
#define __shared__ static
#define __launch_bounds__(n)
struct Dim { unsigned x; };
static Dim threadIdx = {0}, blockIdx = {0}, blockDim = {1}, gridDim = {1};
static inline void __syncthreads() {}
// Dynamic shared memory: the host build runs a CTA's phases with a
// buffer of its own.
#define DYN_SMEM(name) uint8_t* name = nullptr
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  s &= 31; return s ? (hi << s) | (lo >> (32 - s)) : hi; }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, int s) {
  s &= 31; return s ? (lo >> s) | (hi << (32 - s)) : lo; }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
static inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32); }
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c,
                               uint32_t d) { return {a, b, c, d}; }
struct int4 { int x, y, z, w; };
// Warp votes as the host build runs them: one thread at a time, so a
// thread's ballot holds its own vote only and it leads its own "warp".
static inline unsigned __ballot_sync(unsigned, bool p) {
  return p ? 1u << (threadIdx.x & 31) : 0u; }
static inline int __shfl_sync(unsigned, int v, int) { return v; }
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
static inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
static inline int4 make_int4(int a, int b, int c, int d) {
  return {a, b, c, d}; }
using std::max;
using std::min;
"""


def cuda_source(path):
    """A CUDA source with its local headers (``#include "x.cuh"``) inlined:
    the host build compiles one file from a temporary directory."""
    out = []
    for line in path.read_text().splitlines(keepends=True):
        inc = re.match(r'#include "([^"]+)"', line)
        out.append(cuda_source(path.parent / inc.group(1)) if inc else line)
    return "".join(out)


def build_host_harness(out_dir):
    """The CUDA source's device code compiled for the host, one binary per
    hash (``harness_<algo>``, the four g++ started together): CUDA
    keywords and intrinsics stubbed, each launch a loop over lanes, every
    (kind, decode, hash-block, closure) instantiation of the hash in its
    binary.  Returns ``out_dir``."""
    src = cuda_source(CSRC)
    body = src[src.index("#define ALGO_MD5"):
               src.index("// ---- host launch wrappers ----")]
    (out_dir / "harness.cpp").write_text(_HARNESS_STUB + body + _HARNESS_MAIN)
    procs = [subprocess.Popen(
        ["g++", "-O1", "-std=c++17", f"-DHARNESS_ALGO={i}",
         "-o", f"harness_{algo}", "harness.cpp"], cwd=out_dir,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, algo in enumerate(ALGOS)]
    for proc in procs:
        out = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, out.decode()[-2000:]
    return out_dir


@pytest.fixture(scope="module")
def host_harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_host_harness(tmp_path_factory.mktemp("harness"))


def run_harness(harness, launch, tmp_path, gmax=32, threads=128,
                lanes=2048):
    """The host build of the CUDA source on ``launch``'s inputs: its
    state and emit on every lane.  The windowed, scalar K=1 and pair
    tiers run in CTAs of at most ``gmax`` blocks and ``threads`` threads;
    the scalar K=1 and pair tiers' CTAs take at most ``lanes`` lanes (a
    block wider than that is cut into chunks)."""
    word, count, base, tables = launch.inputs()
    for name, t in (("bw", word), ("bc", count), ("base", base),
                    ("radix", tables["radix"])):
        t.numpy().astype(np.int32).tofile(tmp_path / f"{name}.bin")
    for name, fname in (("pw", "pw"), ("pw16", "pw16"), ("pl", "pl"),
                        ("desc", "desc"), ("win_v", "winv"),
                        ("sel_bit", "sel_bit"), ("sel_slot", "sel_slot"),
                        ("bitpos", "bitpos"), ("close_next", "close_next"),
                        ("close_mul", "close_mul")):
        arr = tables[name].numpy() if name in tables else np.zeros(1)
        arr.astype(np.int32).tofile(tmp_path / f"{fname}.bin")
    ngw, ng16, ngd, vm, nw = fe._table_dims(tables)
    m = int(tables["radix"].shape[1])
    k2 = int(tables["win_v"].shape[2]) if "win_v" in tables else 0
    words = fe.DIGEST_WORDS[launch.algo]
    closed = bool(launch.pieces.closed)
    args = [fe.ALGOS.index(launch.algo), int(launch.pair),
            fe.DECODES.index(launch.decode), launch.hash_blocks, launch.nb,
            launch.stride, m, k2, launch.k_opts, int(launch.pack_cb), ngw,
            ng16, ngd, vm, nw, len(launch.pieces.groups),
            launch.spec.effective_min, launch.spec.max_substitute,
            launch.plan.batch, base.numel(), words,
            int(launch.pieces.kind == "suball"), int(closed),
            int(tables["sel_bit"].shape[1]) if "sel_bit" in tables else 0,
            int(tables["close_next"].shape[2]) if closed else 0, gmax,
            threads, lanes]
    subprocess.run([str(harness / f"harness_{launch.algo}")]
                   + [str(a) for a in args], cwd=tmp_path, check=True,
                   timeout=300)
    state = np.fromfile(tmp_path / "state.bin", np.int32).reshape(-1, words)
    emit = np.fromfile(tmp_path / "emit.bin", np.uint8).astype(bool)
    return state, emit


def live_rows(launch):
    """Rows whose rank is below their block's count: every row the
    windowed tier computes (it writes no state for padding lanes)."""
    _word, count, _base, _tables = launch.inputs()
    rank = np.arange(launch.nb * launch.stride) % launch.stride
    return rank < np.repeat(count.numpy(), launch.stride)


def state_rows(launch, want_emit):
    """The rows whose state the launch's tier writes: every live row
    (rank below its block's count) of the windowed tier; every emitted row
    of the tile tiers — the scalar and digit decodes at K=1 and the pair
    tier (they write no state for dead rows, as the reference's contract
    allows)."""
    if launch.decode == "windowed":
        return live_rows(launch)
    return want_emit


def assert_source_equals_plain(harness, launch, tmp_path, emits=True,
                               **geometry):
    """Emit on every lane; state on every row the tier writes
    (:func:`state_rows`).  ``emits``: the launch has emitted rows."""
    want_state, want_emit = launch.port()
    state, emit = run_harness(harness, launch, tmp_path, **geometry)
    assert bool(want_emit.any()) == emits
    assert (emit == want_emit).all()
    rows = state_rows(launch, want_emit)
    assert (state[rows] == want_state[rows]).all()


@pytest.mark.parametrize("case", ["k1", "pair", "2-hash-blocks",
                                  "3-hash-blocks"])
def test_cuda_source_logic_equals_plain_version(case, host_harness,
                                                tmp_path):
    """The kernel's source, built for the host, against the plain version
    on every lane (emit; state on every row the tier writes) — the
    arithmetic the card runs."""
    if case in ("k1", "pair"):
        launch = Launch(SUB_DYN, WORDS, pair=case == "pair", stride=16)
    else:
        blocks = int(case[0])
        launch = Launch(CYR, _long_words(5, *((40, 64) if blocks == 2
                                              else (100, 120)), seed=blocks),
                        pair=False, stride=8, nb=24)
    assert_source_equals_plain(host_harness, launch, tmp_path)


#: Word lengths per (hash scale, hash blocks) for words of 5 (12 when
#: count-windowed) substitutable letters among digits: the candidate
#: width lands in that many hash blocks.
_SOURCE_LENGTHS = {(1, 1): (20, 36), (1, 2): (48, 60), (1, 3): (112, 120),
                   (2, 1): (12, 12), (2, 2): (24, 32), (2, 3): (50, 60)}


def _source_launch(tier, algo, blocks, count_edits=None, mn=0, mx=None,
                   stride=8):
    """A launch of one instantiation: decode tier x hash x hash blocks
    (``count_edits``: block counts lowered, as :class:`Launch` takes
    them; ``mn``/``mx``: a substitution window, else the tier's own;
    ``suball``: the scalar K=1 tier over a substitute-all plan;
    ``merged`` / ``pair-merged``: the scalar K=1 / pair tier over words
    of letters only, whose neighbouring slot groups the kernel merges)."""
    if tier in ("merged", "pair-merged"):
        return Launch(CYR, _letter_words(6, 6, 10, seed=blocks),
                      pair=tier == "pair-merged", stride=stride, nb=24,
                      algo=algo, mn=mn, mx=mx or 15,
                      count_edits=count_edits)
    scale = 2 if algo == "ntlm" else 1
    lo, hi = _SOURCE_LENGTHS[(scale, blocks)]
    windowed = tier.startswith("windowed")
    letters = 12 if windowed else 5
    sub = CYR if tier in ("scalar", "pair", "windowed-cb", "suball") \
        else CZECH
    if tier == "pair-digits":
        sub = SUB_LEET3
    if tier in ("digits", "windowed-digits", "pair-digits"):
        # Only letters czech (or the leet table) maps become slots.
        words = [bytes(c if c < 97 else b"aeosiut"[c % 7] for c in w)
                 for w in _long_words(6, lo, hi, seed=blocks, letters=letters)]
    else:
        words = _long_words(6, lo, hi, seed=blocks, letters=letters)
    return Launch(sub, words, pair=tier.startswith("pair"), stride=stride,
                  nb=24, algo=algo, mn=mn, mx=mx or (2 if windowed else 15),
                  mode="suball" if tier == "suball" else "default",
                  count_edits=count_edits)


_SOURCE_CASES = [
    (tier, algo, hb) for algo in ALGOS
    for tier in ("scalar", "digits", "windowed-cb", "windowed-digits")
    for hb in (1, 2, 3)
] + [(tier, algo, 1) for algo in ALGOS for tier in ("pair", "pair-digits")]


@pytest.mark.parametrize("tier,algo,blocks", _SOURCE_CASES,
                         ids=[f"{t}-{a}-{b}" for t, a, b in _SOURCE_CASES])
def test_cuda_source_instantiations_equal_plain_version(
        tier, algo, blocks, host_harness, tmp_path):
    """Every (hash, decode, hash-block) instantiation of the source, built
    for the host, against the plain version on every lane (the windowed
    tier's state on every live lane)."""
    launch = _source_launch(tier, algo, blocks)
    assert launch.hash_blocks == blocks
    assert (launch.decode, launch.pack_cb) == {
        "scalar": ("scalar", False), "pair": ("scalar", False),
        "digits": ("digits", False), "pair-digits": ("digits", False),
        "windowed-cb": ("windowed", True),
        "windowed-digits": ("windowed", False)}[tier]
    assert_source_equals_plain(host_harness, launch, tmp_path)


_CTA_CASES = [(tier, algo, geom) for algo in ALGOS
              for tier in ("windowed-cb", "windowed-digits")
              for geom in ("counts", "ctas")]


@pytest.mark.parametrize("tier,algo,geom", _CTA_CASES,
                         ids=[f"{t}-{a}-{g}" for t, a, g in _CTA_CASES])
def test_cuda_source_windowed_ctas_equal_plain_version(
        tier, algo, geom, host_harness, tmp_path):
    """The windowed tier's CTA phases at edge geometries: blocks of count
    0, 1 and the full stride ("counts"), and CTAs of 7 blocks and 32
    threads, so CTAs span several words and the last CTA is partial
    ("ctas": 24 blocks, 4 CTAs)."""
    edits = {0: 0, 1: 1, 7: 0, 12: 1} if geom == "counts" else {}
    launch = _source_launch(tier, algo, 1, count_edits=edits)
    _word, count, _base, _t = launch.inputs()
    count = count.numpy()
    assert launch.decode == "windowed" and (count == launch.stride).any()
    assert (count == 0).any() and (count == 1).any() or geom == "ctas"
    g = 7 if geom == "ctas" else 24
    words = _word.numpy().tolist()
    assert any(len(set(words[i:i + g])) > 1 for i in range(0, 24, g))
    geometry = dict(gmax=7, threads=32) if geom == "ctas" else {}
    assert_source_equals_plain(host_harness, launch, tmp_path, **geometry)


#: Edge geometries of the scalar K=1 and pair tiers' CTAs: (count
#: edits, -m, -x, host geometry).  "counts": blocks of count 0, 1 and the
#: full stride; "ctas": CTAs of 7 blocks and 32 threads, so CTAs span
#: several words and the last one is partial; "dead": a CTA whose every
#: block has count 0; "chunks": CTAs of 4 lanes, so each block of 8 lanes
#: is cut in two; "odd": blocks of 6 lanes (not a power of two: a lane's
#: block found by search); "window": -m 2 -x 4 on a plan that stays fully
#: enumerated (less than the 2x saving the windowed tier needs; -x 9 for
#: the words of letters only, past the windowed tier's -x 8), so lanes
#: below the counts are dead too.
_TILE_GEOMS = {
    "counts": ({0: 0, 1: 1, 7: 0, 12: 1}, 0, None, {}),
    "ctas": ({}, 0, None, dict(gmax=7, threads=32)),
    "dead": ({b: 0 for b in range(7, 14)}, 0, None,
             dict(gmax=7, threads=32)),
    "chunks": ({}, 0, None, dict(lanes=4, threads=32)),
    "odd": ({}, 0, None, dict(gmax=5, threads=32)),
    "window": ({}, 2, 4, dict(gmax=5, threads=64)),
}
_TILE_CASES = [(tier, algo, geom) for algo in ALGOS
               for tier in ("scalar", "pair", "pair-digits", "suball",
                            "merged", "pair-merged")
               for geom in _TILE_GEOMS]


def bit_field_neighbours(pieces):
    """Neighbouring groups the scalar tiers merge: one word each, their
    selector columns consecutive bits of cb, the second's right after
    the first's."""
    live = [g for g in pieces.groups if g.len_fixed != 0]

    def bits(g):
        c = g.sel_cols
        return (g.n_words == 1 and len(c) >= 1
                and g.n_variants == 1 << len(c)
                and list(c) == list(range(c[0], c[0] + len(c))))

    return sum(bits(a) and bits(b) and b.sel_cols[0] == a.sel_cols[-1] + 1
               for a, b in zip(live, live[1:]))


@pytest.mark.parametrize("tier,algo,geom", _TILE_CASES,
                         ids=[f"{t}-{a}-{g}" for t, a, g in _TILE_CASES])
def test_cuda_source_tile_ctas_equal_plain_version(
        tier, algo, geom, host_harness, tmp_path):
    """The scalar K=1 tier (match and substitute-all plans) and the pair
    tier (scalar and digit decodes), with and without merged groups, at
    edge CTA geometries (``_TILE_GEOMS``), against the plain version:
    emit on every lane, state on every emitted row; a CTA of dead lanes
    writes emit 0."""
    edits, mn, mx, geometry = _TILE_GEOMS[geom]
    if mx and tier.endswith("merged"):
        mx = 9
    if tier.startswith("pair"):
        # Pair blocks span 16 ranks: the words fill blocks 0-11.
        edits = {b // 2: c for b, c in edits.items()}
    launch = _source_launch(tier, algo, 1, count_edits=edits, mn=mn, mx=mx,
                            stride=6 if geom == "odd" else 8)
    assert launch.decode == ("digits" if tier == "pair-digits" else "scalar")
    assert bit_field_neighbours(launch.pieces) > 0 or not tier.endswith(
        "merged")
    assert not launch.plan.windowed and launch.hash_blocks == 1
    word, count, _base, _t = launch.inputs()
    count = count.numpy()
    if geom == "counts":
        assert {0, 1, 2 * launch.stride if launch.pair else launch.stride} \
            <= set(count.tolist())
    if geom == "dead":
        assert (count[7 // (2 if launch.pair else 1):7] == 0).all()
    assert_source_equals_plain(host_harness, launch, tmp_path, **geometry)
    if geom == "window":
        _s, want_emit = launch.port()
        rank = np.arange(len(want_emit)) % (
            launch.stride * (2 if launch.pair else 1))
        below = rank < np.repeat(count, launch.stride * (
            2 if launch.pair else 1))
        assert (below & ~want_emit).any()


#: The digit decode at K=1 on the tile tier (match plans): its CTAs at
#: the edge geometries of ``_TILE_GEOMS`` (the window at -m 2 -x 9), and
#: 2 and 3 hash blocks with blocks of count 0 and 1 in CTAs of 7 blocks.
_DIGIT_GEOMS = list(_TILE_GEOMS) + ["hb2", "hb3"]
_DIGIT_CASES = [(algo, geom) for algo in ALGOS for geom in _DIGIT_GEOMS]


def digit_tile_edges(launch_for, geom):
    """``(launch, geometry)`` of one digit-decode edge case:
    ``launch_for(blocks, count_edits, mn, mx, stride)`` builds the
    launch."""
    if geom.startswith("hb"):
        return (launch_for(int(geom[2:]), {0: 0, 1: 1}, 0, None, 8),
                dict(gmax=7, threads=32))
    edits, mn, mx, geometry = _TILE_GEOMS[geom]
    return (launch_for(1, edits, mn, 9 if mx else None,
                       6 if geom == "odd" else 8), geometry)


def assert_digit_tile_edges(harness, launch, geom, geometry, tmp_path):
    """The digit-decode launch against the plain version at its edge
    geometry: emit on every lane, state on every emitted row; the window
    leaves rows below the counts dead."""
    assert launch.decode == "digits" and not launch.pair
    assert not launch.plan.windowed
    _w, count, _b, _t = launch.inputs()
    count = count.numpy()
    if geom == "counts":
        assert {0, 1, launch.stride} <= set(count.tolist())
    if geom.startswith("hb"):
        assert launch.hash_blocks == int(geom[2:])
    assert_source_equals_plain(harness, launch, tmp_path, **geometry)
    if geom == "window":
        _s, want_emit = launch.port()
        rank = np.arange(len(want_emit)) % launch.stride
        below = rank < np.repeat(count, launch.stride)
        assert (below & ~want_emit).any()


@pytest.mark.parametrize("algo,geom", _DIGIT_CASES,
                         ids=[f"digits-{a}-{g}" for a, g in _DIGIT_CASES])
def test_cuda_source_digit_tile_ctas_equal_plain_version(
        algo, geom, host_harness, tmp_path):
    """The digit decode at K=1 (match plans), now on the tile tier: live
    lanes only, the window decided before the splice."""
    launch, geometry = digit_tile_edges(
        lambda hb, edits, mn, mx, stride: _source_launch(
            "digits", algo, hb, count_edits=edits, mn=mn, mx=mx,
            stride=stride), geom)
    assert_digit_tile_edges(host_harness, launch, geom, geometry, tmp_path)


_GEOMETRY = r"""
int main(int argc, char** argv) {
  // Every tile-tier instantiation's CTA at the given table dimensions:
  // "kind decode closed pair hb rec g smem" a line.
  int v[11]; for (int i = 0; i < 11; ++i) v[i] = atoi(argv[i + 1]);
  LaunchArgs a{}; PieceTables t{};
  a.m = v[0]; a.ngroups = v[1]; a.ncols = v[2]; a.close_s = v[3];
  a.stride = v[4]; t.ngw = v[5]; t.ng16 = v[6]; t.ngd = v[7]; t.vm = v[8];
  t.nw = v[9]; const int lmax = v[10];
  for (int kind = 0; kind < 2; ++kind)
    for (int decode = 0; decode < 2; ++decode)
      for (int closed = 0; closed < 2; ++closed)
        for (int pair = 0; pair < 2; ++pair)
          for (int hb = 1; hb <= 3; ++hb) {
            if (closed && (kind == 0 || decode == 0 || pair)) continue;
            if (pair && hb > 1) continue;
            const TileGeom g = tile_geometry(
                a, t, kind, decode, closed, pair ? 2 : 1, hb,
                hb == 1 ? 256 : 128, TILE_MAX_G, lmax);
            printf("%d %d %d %d %d %d %d %d\n", kind, decode, closed, pair,
                   hb, g.rec, g.g, g.smem_bytes);
          }
  return 0; }
"""

#: The largest tables the piece kernels' launch checks admit: 256 groups
#: (MAX_GROUPS), all in the u32 table and all of dynamic length, 13
#: variants (a cascade-closed column's 12 joint rows + the span) of 4
#: words each (``packing._MAX_PIECE_WORDS``), 255 selector columns, 24
#: slots with 3 closure successors — beyond any schema the route gate
#: admits (a line of at most 64 bytes has at most ~65 groups).
_WORST_DIMS = dict(m=24, ngroups=256, ncols=255, close_s=3, ngw=256,
                   ng16=256, ngd=256, vm=13, nw=4)


@pytest.mark.parametrize("stride", [128, 4096])
def test_cuda_source_worst_case_record_fits_a_cta(stride, tmp_path):
    """Every tile-tier instantiation keeps the largest record its launch
    checks admit: its offsets fit the packed descriptors' 16 bits and its
    CTA (at least one block) fits the 227 KB of shared memory an H100
    block can have, so no plan a fused kernel takes is refused or fails
    to launch for its record."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = cuda_source(CSRC)
    body = src[src.index("#define ALGO_MD5"):
               src.index("// ---- host launch wrappers ----")]
    (tmp_path / "geom.cpp").write_text(_HARNESS_STUB + body + _GEOMETRY)
    subprocess.run(["g++", "-O1", "-std=c++17", "-DHARNESS_ALGO=0", "-o",
                    "geom", "geom.cpp"], cwd=tmp_path, check=True,
                   timeout=300)
    d = _WORST_DIMS
    args = [d["m"], d["ngroups"], d["ncols"], d["close_s"], stride,
            d["ngw"], d["ng16"], d["ngd"], d["vm"], d["nw"], 2048]
    out = subprocess.run([str(tmp_path / "geom")] + [str(x) for x in args],
                         check=True, timeout=60, capture_output=True,
                         text=True).stdout.split("\n")
    rows = [list(map(int, ln.split())) for ln in out if ln.strip()]
    # Per kind and decode: K=1 at 1-3 hash blocks and the pair tier;
    # substitute-all digits also closed at K=1.
    assert len(rows) == 4 * 4 + 3
    for kind, decode, closed, pair, hb, rec, g, smem in rows:
        assert rec <= 0xFFFF and g >= 1
        assert smem <= 232448, (kind, decode, closed, pair, hb, smem)
    # The record grew by the closure's rows and the decode's slot rows.
    digits_closed = [r for r in rows if r[1] == 1 and r[2] == 1]
    assert digits_closed and all(
        r[5] >= 4 * 24 + 24 * 3 + 24 * 4 + 256 * 13 * 6
        for r in digits_closed)


#: The route gate's largest digit-decode line: 64 bytes, 24 slots of a key
#: with 8 options of 4 bytes (radix 9: the multiply-high divide), MD5 in
#: 3 hash blocks.
GATE_MAX = {b"q": [bytes([65 + k]) * 4 for k in range(8)]}


def test_cuda_source_gate_max_line_equals_plain_version(host_harness,
                                                        tmp_path):
    """A line at the route gate's limits on the digit tier, built for the
    host, against the plain version (CTAs of one block: its record is the
    largest a real plan here has)."""
    rng = np.random.default_rng(41)
    words = []
    for _ in range(4):
        w = np.frombuffer(b"bcdfghjklm", np.uint8)[rng.integers(
            0, 10, size=64)].copy()
        w[rng.choice(64, size=24, replace=False)] = ord("q")
        words.append(bytes(w))
    launch = Launch(GATE_MAX, words, pair=False, stride=8, nb=24)
    assert launch.decode == "digits" and launch.hash_blocks == 3
    assert fe.opts_for(launch.spec, launch.plan, launch.ct) == 8
    assert int(launch.plan.num_slots) == 24
    assert fe.schema_refusal(launch.plan, launch.pieces) is None
    assert_source_equals_plain(host_harness, launch, tmp_path, gmax=1)


_RANK_DIV = r"""
int main() {
  // Every radix up to 4096 and a few large ones, against n / d for ranks
  // at the ends of [0, 2^31) and between.
  const uint32_t big[] = {65535u, 65536u, 1000003u, 0x7FFFFFFFu};
  for (uint32_t d = 1; d < 4096 + 4; ++d) {
    const uint32_t dd = d <= 4096 ? d : big[d - 4097];
    const int4 rr = radix_row((int)dd);
    uint64_t n = 0;
    for (int k = 0; k < 4000; ++k) {
      n = k < 64 ? (uint64_t)k : (k < 128 ? 0x7FFFFFFFull - (k - 64)
          : (n * 2862933555777941757ull + 3037000493ull));
      const int x = (int)(n & 0x7FFFFFFFu);
      if (rank_div(x, rr) != (int)((uint32_t)x / dd)) {
        printf("%u %d\n", dd, x); return 1; }
    }
  }
  return 0; }
"""


def test_cuda_source_rank_div_is_exact(tmp_path):
    """The digit decode's multiply-high divide (``radix_row`` /
    ``rank_div`` in ``hash_common.cuh``) equals the integer divide for
    every radix up to 4096 and ranks across [0, 2^31)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = cuda_source(CSRC)
    body = src[src.index("#define ALGO_MD5"):src.index("// Compressions")]
    body += src[src.index("// Decode\n"):src.index(
        "// The windowed rank `big_r` unranked")]
    (tmp_path / "div.cpp").write_text(_HARNESS_STUB + body + _RANK_DIV)
    subprocess.run(["g++", "-O1", "-std=c++17", "-o", "div", "div.cpp"],
                   cwd=tmp_path, check=True, timeout=120)
    subprocess.run([str(tmp_path / "div")], check=True, timeout=120)


def test_native_build_raises_without_nvcc(monkeypatch):
    from hashcat_a5_table_generator_tpu_torch.ops import _native_build

    monkeypatch.setattr(_native_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native_build.pathlib.Path, "exists",
                        lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native_build.nvcc_path()


def test_native_build_failure_raises_with_compiler_output(monkeypatch,
                                                          tmp_path):
    from hashcat_a5_table_generator_tpu_torch.ops import _native_build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'piece_hash.cu(1): error: boom'\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_native_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error: boom"):
        _native_build.build(["piece_hash_md5", "piece_hash_sha1"])
    assert not list((tmp_path / "build").glob("*.so"))
