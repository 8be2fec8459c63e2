"""The piece kernel of the PyTorch/CUDA package against the JAX reference.

On the CPU the wrapper runs the kernel's plain PyTorch version; it must
match the reference's fused Pallas kernel (interpret mode) bit for bit on
every emitted lane, with equal emit masks, at K=1 and in the pair tier,
for static and dynamic pair deltas.  Wider candidates (2 and 3 chained
MD5 blocks) are held against the reference's XLA twin (``expand_matches``
+ ``HASH_FNS["md5"]``).  The CUDA source itself is compiled for the host
with g++ (CUDA keywords stubbed) and must equal the plain version on every
lane; ``tests/test_torch_cuda.py`` compares the real kernels on a GPU.
"""

import hashlib
import pathlib
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

#: 1:1 option maps (radix 2 everywhere, pair-eligible), as in
#: tests/test_pair.py.  STATIC: every value 2 bytes (pair delta +1
#: always); DYN: 1- and 2-byte values (delta 0 or +1 per word).
SUB_STATIC = {b"a": [b"@@"], b"o": [b"00"], b"s": [b"$$"], b"e": [b"33"]}
SUB_DYN = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}
WORDS = [b"ase", b"oo", b"z", b"seas", b"es", b"password", b"oases"]
CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "hashcat_a5_table_generator_tpu_torch" / "csrc" / "piece_md5.cu")


class Launch:
    """One launch's blocks, cut by the reference's host cutter, and the
    same numpy arrays as the port's torch inputs."""

    def __init__(self, sub, words, *, pair, stride=128, nb=8):
        self.spec = AttackSpec()
        self.ct = compile_table(sub)
        self.plan = build_plan(self.spec, self.ct, pack_words(words))
        self.pieces = piece_schema_for(self.plan, self.ct)
        self.pair, self.stride, self.nb = pair, stride, nb
        rank_stride = stride * (2 if pair else 1)
        batch, _, _ = make_blocks(self.plan, max_variants=nb * rank_stride,
                                  max_blocks=nb, fixed_stride=rank_stride)
        self.batch = pad_batch(batch, nb)

    def reference_pallas(self):
        p, t = plan_arrays(self.plan), table_arrays(self.ct)
        b = block_arrays(self.batch, num_blocks=self.nb)
        state, emit = pe.fused_expand_md5(
            p["tokens"], p["lengths"], p["match_pos"], p["match_len"],
            p["match_radix"], p["match_val_start"],
            t["val_bytes"], t["val_len"], b["word"], b["base"], b["count"],
            num_lanes=self.nb * self.stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute,
            block_stride=self.stride, k_opts=1, interpret=True,
            scalar_units=pe.scalar_units_for(self.plan),
            pieces=self.pieces, pair=self.pair,
        )
        return np.asarray(state).view(np.int32), np.asarray(emit)

    def reference_xla(self):
        p, t = plan_arrays(self.plan), table_arrays(self.ct)
        b = block_arrays(self.batch, num_blocks=self.nb)
        cand, clen, _w, emit = expand_matches(
            p["tokens"], p["lengths"], p["match_pos"], p["match_len"],
            p["match_radix"], p["match_val_start"],
            t["val_bytes"], t["val_len"],
            b["word"], b["base"], b["count"], b["offset"],
            num_lanes=self.nb * self.stride,
            out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute,
            block_stride=self.stride, radix2=True, pieces=self.pieces,
        )
        state = np.asarray(HASH_FNS["md5"](cand, clen)).view(np.int32)
        return state, np.asarray(emit)

    def inputs(self):
        """(word, count, pbase, tables) as CPU torch tensors."""
        weight = fe.scalar_units_weight(self.plan)
        pbase = (self.batch.base_digits.astype(np.int64)
                 * weight[self.batch.word]).sum(axis=1).astype(np.int32)
        return (torch.from_numpy(self.batch.word.copy()),
                torch.from_numpy(self.batch.count.copy()),
                torch.from_numpy(pbase),
                piece_tables(self.pieces, device="cpu"))

    def port(self):
        word, count, pbase, tables = self.inputs()
        state, emit = fe.fused_expand_md5(
            word, count, pbase, tables, pieces=self.pieces,
            block_stride=self.stride, out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute, pair=self.pair,
        )
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


def _long_words(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        w = rng.integers(ord("0"), ord("9") + 1, size=int(rng.integers(
            lo, hi + 1)), dtype=np.uint8)
        pos = rng.choice(len(w), size=5, replace=False)
        w[pos] = rng.integers(ord("a"), ord("z") + 1, size=5, dtype=np.uint8)
        out.append(bytes(w))
    return out


@pytest.mark.parametrize("blocks,lo,hi", [(2, 40, 64), (3, 100, 120)],
                         ids=["2-hash-blocks", "3-hash-blocks"])
def test_plain_matches_reference_multi_block(blocks, lo, hi):
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    launch = Launch(sub, _long_words(6, lo, hi, seed=blocks), pair=False,
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
    with pytest.raises(ValueError):
        fe.fused_expand_md5(word.long(), count, pbase, tables, **kw)


@pytest.fixture(scope="module")
def host_harness(tmp_path_factory):
    """The CUDA source's device code compiled for the host: CUDA keywords
    and intrinsics stubbed, each launch a loop over lanes."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp_path = tmp_path_factory.mktemp("harness")
    src = CSRC.read_text()
    body = src[src.index("#define DESC_WIDTH"):
               src.index("static PieceTables make_tables")]
    stub = r"""
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
struct Dim { unsigned x; };
static Dim threadIdx = {0}, blockIdx = {0}, blockDim = {1};
static inline void __syncthreads() {}
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  s &= 31; return s ? (hi << s) | (lo >> (32 - s)) : hi; }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
struct int4 { int x, y, z, w; };
static inline int4 make_int4(int a, int b, int c, int d) {
  return {a, b, c, d}; }
using std::min;
"""
    main = r"""
template <class T> static std::vector<T> rd(const char* p, size_t n) {
  std::vector<T> v(n ? n : 1); FILE* f = fopen(p, "rb");
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(3);
  fclose(f); return v; }
int main(int argc, char** argv) {
  int a[13]; for (int i = 0; i < 13; ++i) a[i] = atoi(argv[i + 1]);
  int nb = a[0], stride = a[1], ngw = a[2], ng16 = a[3], ngd = a[4],
      vm = a[5], nw = a[6], ng = a[7], mn = a[8], mx = a[9], hb = a[10],
      pair = a[11], B = a[12];
  auto bw = rd<int32_t>("bw.bin", nb); auto bc = rd<int32_t>("bc.bin", nb);
  auto bp = rd<int32_t>("bp.bin", nb);
  auto gw = rd<uint32_t>("pw.bin", (size_t)B * ngw * vm * nw);
  auto g16 = rd<int32_t>("pw16.bin", (size_t)B * ng16 * vm);
  auto gl = rd<int32_t>("pl.bin", (size_t)B * ngd * vm);
  auto desc = rd<int32_t>("desc.bin", (size_t)ng * DESC_WIDTH);
  PieceTables t{gw.data(), g16.data(), gl.data(), ngw, ng16, ngd, vm, nw};
  long long n = (long long)nb * stride * (pair ? 2 : 1);
  std::vector<int32_t> st(n * 4); std::vector<uint8_t> em(n);
  for (long long lane = 0; lane < (long long)nb * stride; ++lane) {
    blockIdx.x = (unsigned)lane;
    if (pair) piece_md5_pair_kernel(bw.data(), bc.data(), bp.data(), nb,
        stride, t, desc.data(), ng, mn, mx, st.data(), em.data());
    else if (hb == 1) piece_md5_k1_kernel<1>(bw.data(), bc.data(),
        bp.data(), nb, stride, t, desc.data(), ng, mn, mx, st.data(),
        em.data());
    else if (hb == 2) piece_md5_k1_kernel<2>(bw.data(), bc.data(),
        bp.data(), nb, stride, t, desc.data(), ng, mn, mx, st.data(),
        em.data());
    else piece_md5_k1_kernel<3>(bw.data(), bc.data(), bp.data(), nb,
        stride, t, desc.data(), ng, mn, mx, st.data(), em.data());
  }
  FILE* f = fopen("state.bin", "wb"); fwrite(st.data(), 4, n * 4, f);
  fclose(f); f = fopen("emit.bin", "wb"); fwrite(em.data(), 1, n, f);
  fclose(f); return 0; }
"""
    (tmp_path / "harness.cpp").write_text(stub + body + main)
    subprocess.run(["g++", "-O1", "-std=c++17", "-o", "harness",
                    "harness.cpp"], cwd=tmp_path, check=True,
                   capture_output=True, timeout=300)
    return tmp_path / "harness"


@pytest.mark.parametrize("case", ["k1", "pair", "2-hash-blocks",
                                  "3-hash-blocks"])
def test_cuda_source_logic_equals_plain_version(case, host_harness,
                                                tmp_path):
    """The kernel's source, built for the host, against the plain version
    on every lane (emitted or not) — the arithmetic the card runs."""
    if case in ("k1", "pair"):
        launch = Launch(SUB_DYN, WORDS, pair=case == "pair", stride=16)
    else:
        blocks = int(case[0])
        launch = Launch(get_layout("qwerty-cyrillic").to_substitution_map(),
                        _long_words(5, *((40, 64) if blocks == 2
                                         else (100, 120)), seed=blocks),
                        pair=False, stride=8, nb=24)
    want_state, want_emit = launch.port()
    word, count, pbase, tables = launch.inputs()
    for name, t in (("bw", word), ("bc", count), ("bp", pbase)):
        t.numpy().tofile(tmp_path / f"{name}.bin")
    for name in ("pw", "pw16", "pl", "desc"):
        arr = tables[name].numpy() if name in tables else np.zeros(1)
        arr.astype(np.int32).tofile(tmp_path / f"{name}.bin")
    ngw, ng16, ngd, vm, nw = fe._table_dims(tables)
    hb = fe._hash_blocks_for(launch.plan.out_width)
    args = [launch.nb, launch.stride, ngw, ng16, ngd, vm, nw,
            len(launch.pieces.groups), 1, 15, hb, int(launch.pair),
            launch.plan.batch]
    subprocess.run([str(host_harness)] + [str(a) for a in args], cwd=tmp_path,
                   check=True, timeout=300)
    state = np.fromfile(tmp_path / "state.bin", np.int32).reshape(-1, 4)
    emit = np.fromfile(tmp_path / "emit.bin", np.uint8).astype(bool)
    assert (emit == want_emit).all()
    assert (state == want_state).all()


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
    fake.write_text("#!/bin/sh\necho 'piece_md5.cu(1): error: boom'\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_native_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error: boom"):
        _native_build.build(["piece_md5"])
    assert not list((tmp_path / "build").glob("*.so"))
