"""The byte-scan tiers of the PyTorch/CUDA package against the JAX
reference (TPU kernel rows 7-9: ``_make_scalar_kernel``, ``_make_kernel``,
``_make_suball_kernel``), on the CPU.

* Host arrays equal to the reference's: ``scalar_units_fields``, the
  substitute-all segment ownership ``slotat``/``startat``, the per-slot
  option words, the tier gate, and ``A5GEN_EMIT`` (``emit_scheme``, its
  one warning, ``piece_schema_for``'s opt-out).
* The plain version of every row and variant equal to the reference's
  Pallas kernels (``pieces=None``, interpret mode, a few tiny cases) and
  to its XLA twin (``expand_matches`` / ``expand_suball`` +
  ``HASH_FNS``) for MD5, MD4, SHA-1 and NTLM and 1-3 hash blocks: equal
  emit masks, equal states on emitted lanes.  Workloads: german's ``ss``
  on words with "sss", colliding starts ``{s=Z, ss=ß}``, czech, the
  qwerty-azerty cascade closure, count windows, and the other tiers
  ``A5GEN_EMIT=bytescan`` reaches.
* ``csrc/bytescan_hash.cu`` compiled for the host with g++ (CUDA keywords
  stubbed, as ``test_torch_fused_expand.py`` builds ``piece_hash.cu``)
  and held lane by lane against the plain version for every
  instantiation.

Tolerance: exact (integers).  ``tests/test_torch_cuda.py`` compares the
real kernels on a GPU.
"""

import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_expand import (
    _HARNESS_STUB,
    ALGOS,
    CYR,
    CZECH,
    Launch,
    assert_same,
    cuda_source,
)

import hashcat_a5_table_generator_tpu.models.attack as j_attack
import hashcat_a5_table_generator_tpu.ops.packing as j_packing
import hashcat_a5_table_generator_tpu.ops.pallas_expand as pe
import hashcat_a5_table_generator_tpu.runtime.env as j_env
import hashcat_a5_table_generator_tpu.tables.compile as j_compile
import hashcat_a5_table_generator_tpu_torch.models.attack as t_attack
import hashcat_a5_table_generator_tpu_torch.ops.packing as t_packing
import hashcat_a5_table_generator_tpu_torch.runtime.env as t_env
import hashcat_a5_table_generator_tpu_torch.tables.compile as t_compile
from hashcat_a5_table_generator_tpu_torch.ops import bytescan as bs
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

GERMAN = get_layout("german").to_substitution_map()
AZERTY = get_layout("qwerty-azerty").to_substitution_map()
#: Keys colliding at one start (SURVEY Q5): K=1, but two slots may start
#: at one byte, so the scalar tier's packed start field cannot hold them.
COLLIDE = {b"s": [b"Z"], b"ss": ["ß".encode()]}
#: A 4-byte value for a key no other table here has: 19 of them take a
#: line past two hash blocks.
WIDE = {b"x": ["\U0001F600".encode()]}
CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "hashcat_a5_table_generator_tpu_torch" / "csrc" / "bytescan_hash.cu")


def mixed_words(n, lo, hi, seed, *, letters=b"", k=0, pieces=(),
                wide=0, filler=b"0123456789"):
    """Seeded lines of ``lo``..``hi`` filler bytes with ``k`` letters of
    ``letters``, each of ``pieces`` (e.g. ``b"sss"``) and ``wide`` ``x``s
    (:data:`WIDE`'s key) written at random places."""
    rng = np.random.default_rng(seed)
    fill = np.frombuffer(filler, np.uint8)
    out = []
    for _ in range(n):
        w = fill[rng.integers(0, len(fill), size=int(rng.integers(
            lo, hi + 1)))].copy()
        free = list(rng.permutation(len(w)))
        for piece in pieces:
            at = int(rng.integers(0, len(w) - len(piece) + 1))
            w[at:at + len(piece)] = np.frombuffer(piece, np.uint8)
            free = [i for i in free if not at <= i < at + len(piece)]
        for i in free[:wide]:
            w[i] = ord("x")
        free = free[wide:]
        for i in free[:k]:
            w[i] = letters[int(rng.integers(0, len(letters)))]
        out.append(bytes(w))
    return out


GERMAN_WORDS = [b"schlosssee", b"strasse", b"mutter", b"flussstrand",
                b"sss", b"ss", b"fitnessstudio", b"passstrasse", b"bassssaite",
                b"ausgang", b"xyz"]
COLLIDE_WORDS = [b"sss", b"ss", b"s", b"sassy", b"mississippi", b"asks",
                 b"ssss"]
AZ_WORDS = [b"aqua", b"zwei", b"aqzw", b"quiz", b"wasz", b"bcd", b"qaqa",
            b"zwaq"]

#: Byte-scan workloads by tier label: (table, words, mode, max substitute,
#: the tier the reference's gate picks).  ``scalar-*`` is row 7, ``match-*``
#: row 8, ``suball-*`` row 9.
TIERS = {
    "scalar-single": (CYR, lambda: mixed_words(
        20, 6, 14, 1, letters=b"qwertyuiop", k=5), "default", 15,
        ("scalar", "scalar", "single")),
    "scalar-single-win": (CYR, lambda: mixed_words(
        12, 14, 16, 2, letters=b"asdfghjkl", k=12), "default", 2,
        ("scalar", "windowed", "single")),
    "scalar-bitmask": (GERMAN, lambda: GERMAN_WORDS, "default", 15,
                       ("scalar", "scalar", "bitmask")),
    "scalar-bitmask-r": (GERMAN, lambda: GERMAN_WORDS, "reverse", 15,
                         ("scalar", "scalar", "bitmask")),
    "scalar-bitmask-win": (GERMAN, lambda: mixed_words(
        12, 14, 16, 3, letters=b"aou", k=11, pieces=(b"sss",)), "default", 2,
        ("scalar", "windowed", "bitmask")),
    "scalar-suball": (CYR, lambda: mixed_words(
        20, 6, 14, 4, letters=b"qwertyuiop", k=5), "suball", 15,
        ("scalar", "scalar", "suball")),
    "scalar-suball-win": (CYR, lambda: mixed_words(
        12, 14, 16, 5, letters=b"asdfghjkl", k=12), "suball", 2,
        ("scalar", "windowed", "suball")),
    "match-radix2": (COLLIDE, lambda: COLLIDE_WORDS, "default", 15,
                     ("match", "radix2", "")),
    "match-digits": (CZECH, lambda: mixed_words(
        20, 6, 12, 6, letters=b"acdeinorstuyz", k=4), "default", 15,
        ("match", "digits", "")),
    "match-win": (CZECH, lambda: mixed_words(
        12, 12, 14, 7, letters=b"aeinorstuyz", k=11), "default", 2,
        ("match", "windowed", "")),
    "suball-digits": (CZECH, lambda: mixed_words(
        20, 6, 12, 8, letters=b"acdeinorstuyz", k=4), "suball", 15,
        ("suball", "digits", "")),
    "suball-win": (CZECH, lambda: mixed_words(
        12, 12, 14, 9, letters=b"aeinorstuyz", k=11), "suball", 2,
        ("suball", "windowed", "")),
    "suball-closed": (AZERTY, lambda: AZ_WORDS, "suball", 15,
                      ("suball", "digits", "")),
    "suball-closed-win": (AZERTY, lambda: [
        b"aq" + w for w in mixed_words(12, 12, 14, 10, letters=b"azwq", k=3)],
        "suball", 2, ("suball", "windowed", "")),
}


class BSLaunch(Launch):
    """One byte-scan launch: the reference's plan and blocks (the
    reference's ``Launch`` of ``test_torch_fused_expand``) without a piece
    schema, run through the port's byte-scan wrapper.  ``tier`` forces a
    tier the gate would not pick (the kernel's other instantiations)."""

    def __init__(self, sub, words, *, tier=None, **kw):
        super().__init__(sub, words, pair=False, **kw)
        self.pieces = None
        self.tier = tier or bs.bytescan_tier(self.plan)

    def inputs(self):
        word, count, base, tables = super().inputs()
        if self.tier.decode in ("radix2", "digits"):
            base = torch.from_numpy(np.ascontiguousarray(
                self.batch.base_digits, np.int32))
        for k, v in bs.bytescan_host_tables(self.plan, self.ct,
                                            self.tier).items():
            v = np.ascontiguousarray(v)
            tables[k] = torch.from_numpy(
                v if v.dtype == np.uint8 else v.view(np.int32)
                if v.dtype == np.uint32 else v.astype(np.int32))
        return word, count, base, tables

    def port(self):
        word, count, base, tables = self.inputs()
        state, emit = bs.bytescan_expand(
            word, count, base, tables, tier=self.tier,
            block_stride=self.stride, out_width=int(self.plan.out_width),
            min_substitute=self.spec.effective_min,
            max_substitute=self.spec.max_substitute, algo=self.algo)
        return state.numpy(), emit.numpy()

    def reference_pallas(self, scalar_units=None):
        if scalar_units is None:
            return super().reference_pallas()
        saved = pe.scalar_units_for
        pe.scalar_units_for = lambda plan: scalar_units
        try:
            return super().reference_pallas()
        finally:
            pe.scalar_units_for = saved


def tier_launch(label, algo="md5", **kw):
    sub, words, mode, mx, _want = TIERS[label]
    return BSLaunch(sub, words(), algo=algo, mode=mode,
                    **{"stride": 16, "nb": 24, "mx": mx, **kw})


def tier_tuple(tier):
    return (tier.row, tier.decode, tier.variant)


# ---------------------------------------------------------------------------
# Host arrays and gates
# ---------------------------------------------------------------------------


def both_plans(label):
    """The reference's and the port's plan of a tier workload."""
    sub, words, mode, mx, _want = TIERS[label]
    words = words()
    jct, tct = j_compile.compile_table(sub), t_compile.compile_table(sub)
    jspec = j_attack.AttackSpec(mode=mode, max_substitute=mx)
    tspec = t_attack.AttackSpec(mode=mode, max_substitute=mx)
    jplan = j_attack.build_plan(jspec, jct, j_packing.pack_words(words))
    tplan = t_attack.build_plan(tspec, tct, t_packing.pack_words(words))
    return jplan, tplan, jct, tct


@pytest.mark.parametrize("label", sorted(TIERS))
def test_tier_gate_and_host_fields_equal_reference(label):
    jplan, tplan, jct, tct = both_plans(label)
    tier = bs.bytescan_tier(tplan)
    assert tier_tuple(tier) == TIERS[label][4]
    # The reference's own choice: row 7 iff scalar units at K == 1, the
    # radix-2 decode at K == 1, the closure iff close_next.
    k = pe.k_vals_for(jplan)
    su = pe.scalar_units_for(jplan)
    assert tier.k_opts == k
    assert (tier.row == "scalar") == (bool(su) and k == 1)
    if tier.row == "scalar":
        assert (tier.variant == "single") == (su == "single")
    else:
        assert (tier.decode == "radix2") == (k == 1 and not jplan.windowed)
    assert tier.closed == (getattr(jplan, "close_next", None) is not None)
    assert tier.closed == label.startswith("suball-closed")
    want = pe.scalar_units_fields(jplan, jct)
    got = bs.scalar_units_fields(tplan, tct)
    assert (want is None) == (got is None)
    if want is not None:
        assert sorted(want) == sorted(got)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert np.array_equal(got[name], want[name]), name
        chunked = bs.scalar_units_fields(tplan, tct, _row_chunk=3)
        for name in want:
            assert np.array_equal(chunked[name], want[name]), name
    blk = jnp.arange(jplan.batch, dtype=jnp.int32)
    if tier.row != "scalar":
        # The per-slot option words: the reference's _pack_val_options
        # over every word.
        cval = getattr(jplan, "cval_bytes", None)
        vb = jct.val_bytes if cval is None else cval
        vl = jct.val_len if cval is None else jplan.cval_len
        vs = jplan.match_val_start if tier.row == "match" \
            else jplan.pat_val_start
        wv, wl = pe._pack_val_options(jnp.asarray(vb), jnp.asarray(vl),
                                      jnp.asarray(vs)[blk], k)
        gv, gl = bs.option_words(tplan, tct, k)
        assert np.array_equal(gv, np.asarray(wv))
        assert np.array_equal(gl, np.asarray(wl))
    if tier.row == "suball" or tier.variant == "suball":
        # slotat / startat: the reference's per-launch XLA precompute
        # (pallas_expand.py:2513-2526) over every word.
        sstart = jnp.asarray(jplan.seg_orig_start)
        slen = jnp.asarray(jplan.seg_orig_len)
        spat = jnp.asarray(jplan.seg_pat)
        jj = jnp.arange(jplan.tokens.shape[1], dtype=jnp.int32)[None, None]
        st3 = sstart[:, :, None]
        covered = (slen[:, :, None] > 0) & (jj >= st3) & (
            jj < st3 + slen[:, :, None])
        slotat, startat = bs.suball_ownership(tplan)
        assert np.array_equal(slotat, np.asarray(
            jnp.where(covered, spat[:, :, None], -1).max(axis=1)))
        assert np.array_equal(startat, np.asarray(
            jnp.where(covered, st3, 0).max(axis=1)))
        chunked = bs.suball_ownership(tplan, row_chunk=2)
        assert np.array_equal(chunked[0], slotat)
        assert np.array_equal(chunked[1], startat)


def test_german_sss_has_no_piece_schema_and_takes_row_7():
    """The reference sends german words with "sss" (two overlapping ``ss``
    matches) to its scalar byte-scan kernel with the coverage bitmask."""
    for mode in ("default", "reverse"):
        for algo in ("md5", "ntlm"):
            spec = t_attack.AttackSpec(mode=mode, algo=algo)
            jspec = j_attack.AttackSpec(mode=mode, algo=algo)
            words = [b"schlosssee", b"mutter", b"strasse"]
            tct = t_compile.compile_table(GERMAN)
            jct = j_compile.compile_table(GERMAN)
            tplan = t_attack.build_plan(spec, tct,
                                        t_packing.pack_words(words))
            jplan = j_attack.build_plan(jspec, jct,
                                        j_packing.pack_words(words))
            assert j_packing.piece_schema_for(jplan, jct) is None
            assert t_packing.piece_schema_for(tplan, tct) is None
            assert pe.opts_for_config(jspec, jplan, jct, block_stride=128,
                                      num_blocks=8, require_tpu=False) == 1
            assert pe.scalar_units_for(jplan) is True
            assert fe.opts_for(spec, tplan, tct) is not None
            assert tier_tuple(bs.bytescan_tier(tplan)) == (
                "scalar", "scalar", "bitmask")


def test_check_scalar_units_gate_raises_like_the_reference():
    tplan = both_plans("match-radix2")[1]
    with pytest.raises(ValueError, match="colliding match starts"):
        bs.check_scalar_units_gate(True, tplan.match_pos, tplan.match_len,
                                   tplan.match_radix)
    gplan = both_plans("scalar-bitmask")[1]
    with pytest.raises(ValueError, match="multi-byte match spans"):
        bs.check_scalar_units_gate("single", gplan.match_pos,
                                   gplan.match_len, gplan.match_radix)
    bs.check_scalar_units_gate(True, gplan.match_pos, gplan.match_len,
                               gplan.match_radix)


@pytest.mark.parametrize("value,want,warns", [
    (None, "perslot", False), ("", "perslot", False),
    ("perslot", "perslot", False), ("bytescan", "bytescan", False),
    ("bytescn", "perslot", True),
])
def test_emit_scheme_equals_reference(value, want, warns, monkeypatch,
                                      capsys):
    if value is None:
        monkeypatch.delenv("A5GEN_EMIT", raising=False)
    else:
        monkeypatch.setenv("A5GEN_EMIT", value)
    monkeypatch.setattr(t_env, "_WARNED", set())
    monkeypatch.setattr(j_env, "_WARNED", set())
    assert t_env.emit_scheme() == want == j_env.emit_scheme()
    err = capsys.readouterr().err
    assert err.count("A5GEN_EMIT") == (2 if warns else 0)
    assert t_env.emit_scheme() == want  # warned once per spelling
    assert capsys.readouterr().err == ""
    jplan, tplan, jct, tct = both_plans("match-digits")
    got = t_packing.piece_schema_for(tplan, tct)
    assert (got is None) == (want == "bytescan")
    assert (got is None) == (j_packing.piece_schema_for(jplan, jct) is None)


def test_emit_scheme_warning_text(monkeypatch, capsys):
    monkeypatch.setenv("A5GEN_EMIT", "Bytescan")
    monkeypatch.setattr(t_env, "_WARNED", set())
    assert t_env.emit_scheme() == "perslot"
    assert capsys.readouterr().err == (
        "a5gen: warning: unrecognized A5GEN_EMIT='Bytescan' (want "
        "perslot|bytescan); keeping the default (perslot)\n")
    with pytest.raises(ValueError):
        t_env.read_env("HOME")


# ---------------------------------------------------------------------------
# The plain version against the reference's kernels
# ---------------------------------------------------------------------------


_XLA_CASES = [(label, algo) for label in sorted(TIERS) for algo in ALGOS]


@pytest.mark.parametrize("label,algo", _XLA_CASES,
                         ids=[f"{t}-{a}" for t, a in _XLA_CASES])
def test_plain_matches_reference_xla_twin(label, algo):
    launch = tier_launch(label, algo)
    assert tier_tuple(launch.tier) == TIERS[label][4]
    assert_same(launch.port(), launch.reference_xla())


#: Multi-block workloads: (tier label, table, hash scale) -> words whose
#: candidates need 2 or 3 hash blocks at token width <= 64.
def _multi_launch(label, algo, blocks):
    scale = 2 if algo == "ntlm" else 1
    sub, _words, mode, _mx, _want = TIERS[label]
    lo, hi, wide = {(1, 2): (40, 48, 4), (1, 3): (52, 60, 19),
                    (2, 2): (24, 28, 0), (2, 3): (40, 44, 6)}[(scale, blocks)]
    pieces = {"scalar-bitmask": (b"sss", b"ss", b"a"),
              "match-radix2": (b"sss",),
              "match-digits": (b"ue", b"e"),
              "suball-closed": (b"aq", b"zw")}[label]
    words = mixed_words(10, lo, hi, 11 + blocks, pieces=pieces, wide=wide,
                        filler=b"bfghjklmpqvw" if label == "match-digits"
                        else b"bcdefghijklnpr")
    return BSLaunch({**sub, **WIDE}, words, algo=algo, mode=mode, stride=8,
                    nb=24)


_MULTI_CASES = [(label, algo, blocks)
                for label in ("scalar-bitmask", "match-radix2",
                              "match-digits", "suball-closed")
                for algo in ALGOS for blocks in (2, 3)]


@pytest.mark.parametrize("label,algo,blocks", _MULTI_CASES,
                         ids=[f"{t}-{a}-{b}" for t, a, b in _MULTI_CASES])
def test_plain_matches_reference_multi_block(label, algo, blocks):
    launch = _multi_launch(label, algo, blocks)
    assert launch.tier.row == TIERS[label][4][0]
    assert launch.hash_blocks == blocks
    assert_same(launch.port(), launch.reference_xla())


@pytest.mark.parametrize("label,algo", [
    ("scalar-bitmask", "md5"), ("scalar-bitmask-r", "ntlm"),
    ("match-radix2", "sha1"), ("match-digits", "md4"),
    ("suball-closed", "md5"), ("scalar-suball-win", "md5"),
])
def test_plain_matches_reference_pallas_kernel(label, algo):
    """The reference's byte-scan Pallas kernels themselves (interpret
    mode, ``pieces=None``) on tiny launches."""
    launch = tier_launch(label, algo, stride=8, nb=8)
    assert_same(launch.port(), launch.reference_pallas())


def test_forced_suball_radix2_matches_reference_pallas_kernel():
    """Row 9's radix-2 decode (K=1, off the scalar tier): the reference
    takes it for a K=1 substitute-all plan whose scalar-units verdict is
    withheld."""
    launch = tier_launch("scalar-suball", "md5", stride=8, nb=8,
                         tier=bs.ByteScanTier("suball", "radix2"))
    assert_same(launch.port(), launch.reference_pallas(scalar_units=False))


def test_german_emitted_lanes_hash_their_decoded_candidates():
    """Every emitted german lane is a rank ``decode_variant`` reproduces
    (no overlap clash is emitted), and its state is the MD5 of that
    candidate; the clash lanes are exactly the ranks it refuses."""
    import hashlib

    launch = tier_launch("scalar-bitmask", "md5", stride=64, nb=16)
    state, emit = launch.port()
    tplan = t_attack.build_plan(
        t_attack.AttackSpec(), t_compile.compile_table(GERMAN),
        t_packing.pack_words(GERMAN_WORDS))
    tct = t_compile.compile_table(GERMAN)
    spec = t_attack.AttackSpec()
    clashes = 0
    for blk in range(launch.nb):
        w = int(launch.batch.word[blk])
        count = int(launch.batch.count[blk])
        digits = launch.batch.base_digits[blk]
        rank0, place = 0, 1
        for s, r in enumerate(tplan.match_radix[w]):
            rank0 += int(digits[s]) * place
            place *= int(r)
        for r in range(count):
            row = blk * launch.stride + r
            try:
                cand = t_attack.decode_variant(tplan, tct, spec, w, rank0 + r)
            except ValueError:
                assert not emit[row]
                clashes += 1
                continue
            assert emit[row]
            assert state[row].astype("<i4").tobytes() == \
                hashlib.md5(cand).digest()
    assert clashes > 0


# ---------------------------------------------------------------------------
# The CUDA source, built for the host
# ---------------------------------------------------------------------------

_TABLES = ("blk_word", "blk_count", "base", "tokens", "lengths", "radix",
           "win_v", "bitpos", "aj", "bj", "svl", "svw", "mpos", "mlen",
           "slotat", "startat", "close_next", "close_mul", "vopt", "vlen")

_HARNESS_MAIN = r"""
static std::vector<char> slurp(const char* name) {
  std::vector<char> v; FILE* f = fopen(name, "rb"); if (!f) return v;
  fseek(f, 0, SEEK_END); long n = ftell(f); fseek(f, 0, SEEK_SET);
  v.resize(n); if (n) fread(v.data(), 1, n, f); fclose(f); return v; }
template <typename T> static const T* ptr(std::vector<char>& v) {
  return v.empty() ? nullptr : reinterpret_cast<const T*>(v.data()); }

static int gmax = 32, nthreads = 128, lmax = 2048;
// Every CTA's phases in order, each phase run by each of its threads
// before the next (the barriers; a warp's ballot is the one thread's own
// vote), shared memory filled with garbage first.
template <int ROW, int VAR, int DECODE, bool CLOSED, int HB>
static void cta(const ByteScanArgs& a) {
  const ScanGeom g = scan_geometry(a, ROW, VAR, DECODE, CLOSED, HB, nthreads,
                                   gmax, lmax);
  std::vector<int32_t> smem(g.smem_bytes / 4 + 1);
  blockDim.x = nthreads;
  const long long grid = (long long)((a.nb + g.g - 1) / g.g) * g.c;
  for (long long c = 0; c < grid; ++c) {
    blockIdx.x = (unsigned)c;
    std::fill(smem.begin(), smem.end(), 0x5A5A5A5A);
    for (int p = 0; p < SCAN_PHASES; ++p)
      for (int th = 0; th < nthreads; ++th) {
        threadIdx.x = th;
        scan_phase<HARNESS_ALGO, ROW, VAR, DECODE, CLOSED, HB>(p, a, g,
                                                              smem.data());
      }
  }
  blockDim.x = 1; threadIdx.x = 0; blockIdx.x = 0;
}
template <int ROW, int VAR, int DECODE, bool CLOSED>
static void run(const ByteScanArgs& a, int hb) {
  if (hb == 1) cta<ROW, VAR, DECODE, CLOSED, 1>(a);
  else if (hb == 2) cta<ROW, VAR, DECODE, CLOSED, 2>(a);
  else cta<ROW, VAR, DECODE, CLOSED, 3>(a);
}

int main(int argc, char** argv) {
  if (argc != 19) return 2;
  int v[18]; for (int i = 0; i < 18; ++i) v[i] = atoi(argv[i + 1]);
  const int nb = v[0], stride = v[1], L = v[2], m = v[3], k2 = v[4],
      k_opts = v[5], close_s = v[6], row = v[7], variant = v[8],
      decode = v[9], closed = v[10], mn = v[11], mx = v[12], hb = v[13],
      words = v[14];
  gmax = v[15]; nthreads = v[16]; lmax = v[17];
  std::vector<char> t[20];
  const char* names[20] = {"blk_word", "blk_count", "base", "tokens",
      "lengths", "radix", "win_v", "bitpos", "aj", "bj", "svl", "svw",
      "mpos", "mlen", "slotat", "startat", "close_next", "close_mul",
      "vopt", "vlen"};
  for (int i = 0; i < 20; ++i) {
    char fn[64]; snprintf(fn, sizeof fn, "%s.bin", names[i]);
    t[i] = slurp(fn); }
  const long long n = (long long)nb * stride;
  std::vector<int32_t> st(n * words, 0); std::vector<uint8_t> em(n, 7);
  ByteScanArgs a;
  a.blk_word = ptr<int32_t>(t[0]); a.blk_count = ptr<int32_t>(t[1]);
  a.blk_base = ptr<int32_t>(t[2]); a.nb = nb; a.stride = stride;
  a.tokens = ptr<uint8_t>(t[3]); a.lengths = ptr<int32_t>(t[4]); a.L = L;
  a.radix = ptr<int32_t>(t[5]); a.m = m; a.win_v = ptr<int32_t>(t[6]);
  a.k2 = k2; a.k_opts = k_opts; a.bitpos = ptr<int32_t>(t[7]);
  a.aj = ptr<int32_t>(t[8]); a.bj = ptr<uint8_t>(t[9]);
  a.svl = ptr<uint8_t>(t[10]); a.svw = ptr<int32_t>(t[11]);
  a.mpos = ptr<int32_t>(t[12]); a.mlen = ptr<int32_t>(t[13]);
  a.slotat = ptr<int32_t>(t[14]); a.startat = ptr<int32_t>(t[15]);
  a.cnext = ptr<int32_t>(t[16]); a.cmul = ptr<int32_t>(t[17]);
  a.close_s = close_s; a.vopt = ptr<int32_t>(t[18]);
  a.vlen = ptr<int32_t>(t[19]); a.min_sub = mn; a.max_sub = mx;
  a.state = st.data(); a.emit = em.data();
  const bool win = decode == DECODE_WINDOWED;
  if (row == ROW_SCALAR) {
    if (variant == VAR_SINGLE && !win) run<ROW_SCALAR, VAR_SINGLE, DECODE_SCALAR, false>(a, hb);
    if (variant == VAR_SINGLE && win) run<ROW_SCALAR, VAR_SINGLE, DECODE_WINDOWED, false>(a, hb);
    if (variant == VAR_BITMASK && !win) run<ROW_SCALAR, VAR_BITMASK, DECODE_SCALAR, false>(a, hb);
    if (variant == VAR_BITMASK && win) run<ROW_SCALAR, VAR_BITMASK, DECODE_WINDOWED, false>(a, hb);
    if (variant == VAR_SUBALL && !win) run<ROW_SCALAR, VAR_SUBALL, DECODE_SCALAR, false>(a, hb);
    if (variant == VAR_SUBALL && win) run<ROW_SCALAR, VAR_SUBALL, DECODE_WINDOWED, false>(a, hb);
  } else if (row == ROW_MATCH) {
    if (decode == DECODE_RADIX2) run<ROW_MATCH, 0, DECODE_RADIX2, false>(a, hb);
    if (decode == DECODE_DIGITS) run<ROW_MATCH, 0, DECODE_DIGITS, false>(a, hb);
    if (win) run<ROW_MATCH, 0, DECODE_WINDOWED, false>(a, hb);
  } else {
    if (decode == DECODE_RADIX2 && !closed) run<ROW_SUBALL, 0, DECODE_RADIX2, false>(a, hb);
    if (decode == DECODE_RADIX2 && closed) run<ROW_SUBALL, 0, DECODE_RADIX2, true>(a, hb);
    if (decode == DECODE_DIGITS && !closed) run<ROW_SUBALL, 0, DECODE_DIGITS, false>(a, hb);
    if (decode == DECODE_DIGITS && closed) run<ROW_SUBALL, 0, DECODE_DIGITS, true>(a, hb);
    if (win && !closed) run<ROW_SUBALL, 0, DECODE_WINDOWED, false>(a, hb);
    if (win && closed) run<ROW_SUBALL, 0, DECODE_WINDOWED, true>(a, hb);
  }
  FILE* f = fopen("state.bin", "wb"); fwrite(st.data(), 4, n * words, f);
  fclose(f); f = fopen("emit.bin", "wb"); fwrite(em.data(), 1, n, f);
  fclose(f); return 0; }
"""


@pytest.fixture(scope="module")
def bytescan_harness(tmp_path_factory):
    """``csrc/bytescan_hash.cu``'s device code compiled for the host, one
    binary per hash (the four g++ started together): CUDA keywords and
    intrinsics stubbed, each CTA a call over its block, every (row,
    variant, decode, closure, hash-block) instantiation in its binary."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out_dir = tmp_path_factory.mktemp("bytescan_harness")
    src = cuda_source(CSRC)
    body = src[src.index("#define ALGO_MD5"):
               src.index("// ---- host launch wrappers ----")]
    stub = _HARNESS_STUB + (
        "static inline int __clz(uint32_t x) {\n"
        "  return x ? __builtin_clz(x) : 32; }\n")
    (out_dir / "harness.cpp").write_text(stub + body + _HARNESS_MAIN)
    procs = [subprocess.Popen(
        ["g++", "-O1", "-std=c++17", f"-DHARNESS_ALGO={i}",
         "-o", f"harness_{algo}", "harness.cpp"], cwd=out_dir,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, algo in enumerate(ALGOS)]
    for proc in procs:
        out = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, out.decode()[-3000:]
    return out_dir


def run_harness(harness, launch, tmp_path, gmax=32, threads=128,
                lanes=2048):
    """The host build of the CUDA source on ``launch``'s inputs: its state
    and emit on every lane (state written on emitted rows only), in CTAs
    of at most ``gmax`` blocks, ``threads`` threads and ``lanes`` lanes (a
    block wider than that cut into chunks)."""
    word, count, base, tables = launch.inputs()
    tier = launch.tier
    arrays = {"blk_word": word, "blk_count": count, "base": base, **tables}
    used = set(bs.needed_tables(tier))
    for name in _TABLES:
        path = tmp_path / f"{name}.bin"
        if name in ("blk_word", "blk_count", "base") or name in used:
            arr = arrays[name].numpy()
            path.write_bytes(np.ascontiguousarray(arr).tobytes())
        elif path.exists():
            path.unlink()
    words = fe.DIGEST_WORDS[launch.algo]
    m = int(tables["radix"].shape[1]) if "radix" in used else 0
    k2 = int(tables["win_v"].shape[2]) if "win_v" in used else 0
    close_s = int(tables["close_next"].shape[2]) if tier.closed else 0
    args = [launch.nb, launch.stride, int(tables["tokens"].shape[1]), m, k2,
            tier.k_opts, close_s, bs.ROWS.index(tier.row),
            bs.VARIANTS.index(tier.variant) if tier.row == "scalar" else 0,
            bs.DECODE_ID[tier.decode], int(tier.closed),
            launch.spec.effective_min, launch.spec.max_substitute,
            launch.hash_blocks, words, gmax, threads, lanes]
    subprocess.run([str(harness / f"harness_{launch.algo}")]
                   + [str(a) for a in args], cwd=tmp_path, check=True,
                   timeout=300)
    state = np.fromfile(tmp_path / "state.bin", np.int32).reshape(-1, words)
    emit = np.fromfile(tmp_path / "emit.bin", np.uint8).astype(bool)
    return state, emit


_SOURCE_CASES = (
    [(label, algo, 1) for label in sorted(TIERS) for algo in ALGOS]
    + [(label, algo, b) for label, algo, b in _MULTI_CASES]
    + [("suball-radix2", algo, 1) for algo in ALGOS]
)


@pytest.mark.parametrize("label,algo,blocks", _SOURCE_CASES,
                         ids=[f"{t}-{a}-{b}" for t, a, b in _SOURCE_CASES])
def test_cuda_source_instantiations_equal_plain_version(
        label, algo, blocks, bytescan_harness, tmp_path):
    """Every (row, variant/decode, closure, hash, hash-block)
    instantiation of the source, built for the host, against the plain
    version: emit on every lane, state on every emitted row (dead rows
    get no state, as the reference's contract allows)."""
    if label == "suball-radix2":
        launch = tier_launch("scalar-suball", algo,
                             tier=bs.ByteScanTier("suball", "radix2"))
    elif blocks == 1:
        launch = tier_launch(label, algo)
    else:
        launch = _multi_launch(label, algo, blocks)
    # NTLM's doubled width puts the 16-byte windowed lines in 2 blocks.
    assert launch.hash_blocks == blocks or (blocks == 1 and algo == "ntlm")
    want_state, want_emit = launch.port()
    state, emit = run_harness(bytescan_harness, launch, tmp_path)
    assert want_emit.any()
    assert (emit == want_emit).all()
    assert (state[want_emit] == want_state[want_emit]).all()


#: Edge geometries of the byte-scan CTAs: (-m, -x, stride, host
#: geometry).  "counts": blocks cut to counts 0 and 1 beside blocks of the
#: full stride; "ctas": CTAs of 7 blocks and 32 threads, spanning words,
#: the last one partial; "dead": a whole CTA of count-0 blocks; "chunks":
#: CTAs of 4 lanes, each 16-lane block cut in four; "odd": blocks of 6
#: lanes (a lane's block found by search); "window": -m 2 -x 9, so rows
#: below the counts are dead too (not on the windowed tiers, whose window
#: is their own).
_SCAN_GEOMS = {
    "counts": (None, None, 16, dict(gmax=5, threads=64)),
    "ctas": (None, None, 16, dict(gmax=7, threads=32)),
    "dead": (None, None, 16, dict(gmax=7, threads=32)),
    "chunks": (None, None, 16, dict(lanes=4, threads=32)),
    "odd": (None, None, 6, dict(gmax=5, threads=32)),
    "window": (2, 9, 16, dict(gmax=5, threads=64)),
}
_EDGE_LABELS = sorted(TIERS) + ["suball-radix2"]
_EDGE_CASES = [(label, ALGOS[i % 4], geom)
               for i, (label, geom) in enumerate(
                   (lb, g) for lb in _EDGE_LABELS for g in _SCAN_GEOMS)
               if not (geom == "window" and label.endswith("win"))]


@pytest.mark.parametrize("label,algo,geom", _EDGE_CASES,
                         ids=[f"{t}-{a}-{g}" for t, a, g in _EDGE_CASES])
def test_cuda_source_cta_edges_equal_plain_version(
        label, algo, geom, bytescan_harness, tmp_path):
    """Every byte-scan tier's CTAs at their edge geometries
    (``_SCAN_GEOMS``), built for the host, against the plain version: emit
    on every lane (dead rows, clash lanes included, get emit 0 and no
    state), state on every emitted row."""
    mn, mx, stride, geometry = _SCAN_GEOMS[geom]
    kw = dict(stride=stride)
    if mn is not None:
        kw.update(mn=mn, mx=mx)
    if label == "suball-radix2":
        launch = tier_launch("scalar-suball", algo,
                             tier=bs.ByteScanTier("suball", "radix2"), **kw)
    else:
        launch = tier_launch(label, algo, **kw)
        assert tier_tuple(launch.tier) == TIERS[label][4]
    _w, count, _b, _t = launch.inputs()
    count = count.numpy()
    full = np.flatnonzero(count == stride)
    if geom == "counts":
        assert len(full) >= 2
        launch.count_edits = {int(full[0]): 0, int(full[1]): 1}
    elif geom == "dead":
        launch.count_edits = {b: 0 for b in range(7, 14)}
    want_state, want_emit = launch.port()
    state, emit = run_harness(bytescan_harness, launch, tmp_path, **geometry)
    assert want_emit.any()
    assert (emit == want_emit).all()
    assert (state[want_emit] == want_state[want_emit]).all()
    _w, count, _b, _t = launch.inputs()
    rank = np.arange(len(want_emit)) % stride
    below = rank < np.repeat(count.numpy(), stride)
    # Rows of a word's rank 0 (no substitution: outside the window of a
    # fully enumerated plan); every other masked row below the counts is
    # an overlap clash or outside -m / -x.
    first = (launch.batch.base_digits == 0).all(axis=1)[:launch.nb]
    rank0 = 0 if launch.plan.windowed else int(
        (below & (rank == 0) & np.repeat(first, stride)).sum())
    masked = int((below & ~want_emit).sum())
    if geom == "dead":
        assert not want_emit[7 * stride:14 * stride].any()
    if geom == "window" or label.startswith("scalar-bitmask") \
            or label == "match-radix2":
        assert masked > rank0
