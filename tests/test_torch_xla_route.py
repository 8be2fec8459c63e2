"""The XLA expand + hash route of the PyTorch/CUDA package against the JAX
reference, on the CPU, tolerance 0 (integer arithmetic throughout):

* the plain byte-level hashes (``ops.hashes.HASH_FNS``) equal the
  reference's ``HASH_FNS``, ``hashlib`` / the MD4 of ``utils/md4`` and, at
  one block, ``md5_pallas`` in interpret mode (TPU kernel row 10);
* the buffer-hash kernel's source (``csrc/buffer_hash.cu``), built for the
  host with g++, equals the plain version on every row;
* the torch expansions (``expand_matches``, ``expand_suball``) equal the
  reference's — ``cand[:len]``, ``len``, ``word_row`` and ``emit`` on
  every lane — for the piece splice, the schema-less splice (both of the
  reference's formulations), the pair tier, windowed plans, cascade-closed
  plans, a 30-slot plan and a 100-byte token width.
"""

import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.ops.hashes as j_hashes
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.models.attack import build_plan
from hashcat_a5_table_generator_tpu.ops import expand_matches as j_em
from hashcat_a5_table_generator_tpu.ops import expand_suball as j_es
from hashcat_a5_table_generator_tpu.ops.blocks import make_blocks, pad_batch
from hashcat_a5_table_generator_tpu.ops.packing import pack_words
from hashcat_a5_table_generator_tpu.ops.packing import piece_schema_for
from hashcat_a5_table_generator_tpu.ops.pallas_md5 import md5_pallas
from hashcat_a5_table_generator_tpu.tables.compile import compile_table
from hashcat_a5_table_generator_tpu_torch.ops import buffer_hash as bh
from hashcat_a5_table_generator_tpu_torch.ops import expand_matches as t_em
from hashcat_a5_table_generator_tpu_torch.ops import expand_suball as t_es
from hashcat_a5_table_generator_tpu_torch.ops import hashes as t_hashes
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_torch_fused_expand import _HARNESS_STUB, cuda_source  # noqa: E402

CSRC = (pathlib.Path(__file__).resolve().parent.parent
        / "hashcat_a5_table_generator_tpu_torch" / "csrc" / "buffer_hash.cu")
ALGOS = ("md5", "md4", "sha1", "ntlm")
BLOCKS = (1, 2, 3, 5)
CYR = get_layout("qwerty-cyrillic").to_substitution_map()
AZERTY = get_layout("qwerty-azerty").to_substitution_map()
GERMAN = get_layout("german").to_substitution_map()
SINGLE = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}
#: Nine options on one key and a 5-byte value: past the fused kernels'
#: 8 options and 4-byte values.
LEET9 = {b"a": [bytes([c]) for c in b"4@^&*123"] + [b"/-\\\\-"],
         b"s": [b"$"], b"e": [b"3"]}
#: Each word's lowest-sorted pattern occurs once and first (the
#: substitute-all pair tier's schema gate).
PAIR_WORDS = [b"ase", b"oz", b"abodes", b"apses", b"x", b"eosso", b"also"]
THIRTY = b"qwertyuiopasdfghjklzxcvbnmqwer"  # 30 letters: 30 slots
HUNDRED = (b"the quick brown fox jumps over the lazy dog " * 3)[:100]


def width_for(blocks, algo):
    """The widest row ``blocks`` hash blocks hold (NTLM doubles)."""
    return (64 * blocks - 9) // (2 if algo == "ntlm" else 1)


def rows_for(width, seed):
    """Random rows of ``width`` bytes with every length 0..width."""
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 256, (width + 1, width), dtype=np.uint8)
    return msg, np.arange(width + 1, dtype=np.int32)


def state_bytes(state, algo):
    order = ">u4" if algo == "sha1" else "<u4"
    return [row.view(np.uint32).astype(order).tobytes() for row in state]


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("algo", ALGOS)
def test_plain_hashes_equal_reference_and_hashlib(algo, blocks):
    """Every length 0..W of a ``blocks``-block width (55/56 included from
    two blocks on): the port's plain hash, the reference's ``HASH_FNS``
    and ``hashlib`` / ``utils/md4`` agree on every row."""
    width = width_for(blocks, algo)
    msg, ln = rows_for(width, seed=blocks)
    got = t_hashes.HASH_FNS[algo](torch.from_numpy(msg),
                                  torch.from_numpy(ln)).numpy()
    want = np.asarray(j_hashes.HASH_FNS[algo](jnp.asarray(msg),
                                              jnp.asarray(ln)))
    assert got.shape == (width + 1, t_hashes.DIGEST_WORDS[algo])
    assert np.array_equal(got.view(np.uint32), want)
    assert state_bytes(got, algo) == [
        HOST_DIGEST[algo](bytes(msg[i, :ln[i]])) for i in range(width + 1)]
    wide = (2 if algo == "ntlm" else 1) * width
    assert t_hashes._blocks_for_width(wide) == blocks
    if blocks > 1:
        assert {55, 56} <= set(ln.tolist())


def test_plain_md5_equals_md5_pallas_interpret():
    """TPU kernel row 10 in interpret mode (8192 rows, one block): the
    port's plain MD5 and ``md5_pallas`` give the same state words."""
    rng = np.random.default_rng(10)
    msg = rng.integers(0, 256, (8192, 52), dtype=np.uint8)
    ln = rng.integers(0, 53, 8192).astype(np.int32)
    want = np.asarray(md5_pallas(jnp.asarray(msg), jnp.asarray(ln),
                                 interpret=True))
    got = t_hashes.md5(torch.from_numpy(msg), torch.from_numpy(ln)).numpy()
    assert np.array_equal(got.view(np.uint32), want)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    msg, ln = rows_for(20, seed=3)
    launches, plain = dict(bh.LAUNCHES), bh.PLAIN_CALLS
    for algo in ALGOS:
        got = bh.buffer_hash(torch.from_numpy(msg), torch.from_numpy(ln),
                             algo)
        assert torch.equal(got, t_hashes.HASH_FNS[algo](
            torch.from_numpy(msg), torch.from_numpy(ln)))
    assert bh.PLAIN_CALLS == plain + 4 and bh.LAUNCHES == launches
    with pytest.raises(ValueError, match="algo"):
        bh.buffer_hash(torch.from_numpy(msg), torch.from_numpy(ln), "sha256")
    with pytest.raises(ValueError, match="uint8"):
        bh.buffer_hash(torch.from_numpy(msg).int(), torch.from_numpy(ln))
    with pytest.raises(ValueError, match="int32"):
        bh.buffer_hash(torch.from_numpy(msg), torch.from_numpy(ln).long())
    with pytest.raises(ValueError, match="contiguous"):
        bh.buffer_hash(torch.from_numpy(msg)[:, ::2], torch.from_numpy(ln))


_HARNESS_MAIN = r"""
int main(int argc, char** argv) {
  const long long n = atoll(argv[1]);
  const int width = atoi(argv[2]);
  const int offset = atoi(argv[3]);  // bytes between allocation and row 0
  // The rows at `offset` bytes past a 16-byte-aligned allocation, and
  // nothing after them: aligned words past the buffer are never loaded.
  std::vector<uint4> raw(((size_t)n * width + offset + 15) / 16 + 1);
  uint8_t* msg = reinterpret_cast<uint8_t*>(raw.data()) + offset;
  std::vector<int32_t> len(n);
  FILE* f = fopen("msg.bin", "rb");
  if (fread(msg, 1, (size_t)n * width, f) != (size_t)n * width) return 1;
  fclose(f);
  f = fopen("len.bin", "rb");
  if (fread(len.data(), 4, n, f) != (size_t)n) return 1;
  fclose(f);
  const int words = HARNESS_ALGO == ALGO_SHA1 ? 5 : 4;
  std::vector<int32_t> state((size_t)n * words);
  BhArgs a;
  a.msg = msg; a.len = len.data(); a.n = n; a.width = width;
  a.state = state.data();
  const bool aligned = width % 4 == 0 && offset % 4 == 0;
  blockDim.x = 1;
  threadIdx.x = 0;
  for (long long r = 0; r < n; ++r) {
    blockIdx.x = (unsigned)r;
    if (aligned) buffer_hash_kernel<HARNESS_ALGO, true>(a);
    else buffer_hash_kernel<HARNESS_ALGO, false>(a);
  }
  f = fopen("state.bin", "wb");
  fwrite(state.data(), 4, state.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_harness(tmp_path_factory):
    """``csrc/buffer_hash.cu`` compiled for the host, one binary per hash
    (the four g++ started together), CUDA keywords stubbed: each launch a
    loop over rows."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("buffer_hash")
    src = cuda_source(CSRC)
    body = src[src.index("#define ALGO_MD5"):
               src.index("// ---- host launch wrapper ----")]
    (out / "harness.cpp").write_text(_HARNESS_STUB + body + _HARNESS_MAIN)
    procs = [subprocess.Popen(
        ["g++", "-O1", "-std=c++17", f"-DHARNESS_ALGO={i}", "-o",
         f"harness_{algo}", "harness.cpp"], cwd=out,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, algo in enumerate(ALGOS)]
    for proc in procs:
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, log.decode()[-2000:]
    return out


def harness_state(harness, algo, msg, ln, tmp_path, *, offset=0):
    """The host build's state rows for ``msg`` / ``ln``, the buffer
    ``offset`` bytes past a 16-byte boundary."""
    (tmp_path / "msg.bin").write_bytes(msg.tobytes())
    (tmp_path / "len.bin").write_bytes(ln.tobytes())
    subprocess.run([str(harness / f"harness_{algo}"), str(len(ln)),
                    str(msg.shape[1]), str(offset)], cwd=tmp_path,
                   check=True, timeout=120)
    return np.fromfile(tmp_path / "state.bin", np.int32).reshape(len(ln), -1)


@pytest.mark.parametrize("algo", ALGOS)
def test_cuda_source_equals_plain_version(algo, host_harness, tmp_path):
    """The kernel's source against the plain version on every row, at 1,
    2, 3 and 5 hash blocks, rows at odd widths (funnel-shifted loads) and
    at multiples of 4 (aligned loads, or funnel-shifted in a buffer that
    is not 4-byte aligned), lengths 0..W and two rows outside them
    (negative, past W)."""
    for blocks in BLOCKS:
        for width in (width_for(blocks, algo), width_for(blocks, algo) - 3):
            msg, ln = rows_for(width, seed=width)
            ln = np.concatenate([ln, [-5, width + 70]]).astype(np.int32)
            msg = np.concatenate([msg, msg[:2]])
            want = t_hashes.HASH_FNS[algo](torch.from_numpy(msg),
                                           torch.from_numpy(ln)).numpy()
            for offset in (0, 2):
                got = harness_state(host_harness, algo, msg, ln, tmp_path,
                                    offset=offset)
                assert np.array_equal(got, want), (blocks, width, offset)


#: Widths at the edges: 0-3 bytes, the one-block MD5 width and the next (a
#: multiple of 4), 64 and 128 (whole aligned blocks), the main path's 376,
#: and rows wider than any the sweeps make.
EDGE_WIDTHS = (0, 1, 3, 48, 55, 56, 64, 128, 376, 2100, 2101)


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("algo", ALGOS)
def test_cuda_source_edge_widths_equal_plain_version(algo, width,
                                                     host_harness, tmp_path):
    """Edge widths against the plain version on every row, the buffer at
    a 16-byte boundary and one byte past it (the first and last rows'
    aligned words would reach outside it: byte loads there)."""
    rng = np.random.default_rng(width + 7)
    n = 300 + width % 7
    msg = rng.integers(0, 256, (n, width), dtype=np.uint8)
    ln = rng.integers(0, width + 1, n).astype(np.int32)
    ln[:3] = (0, width, max(width - 1, 0))
    ln[-1] = width
    want = t_hashes.HASH_FNS[algo](torch.from_numpy(msg),
                                   torch.from_numpy(ln)).numpy()
    for offset in (0, 1):
        got = harness_state(host_harness, algo, msg, ln, tmp_path,
                            offset=offset)
        assert np.array_equal(got, want), offset


# ---------------------------------------------------------------------------
# The expansions
# ---------------------------------------------------------------------------


def tensor(a):
    a = np.asarray(a)
    return torch.as_tensor(a if a.dtype == np.uint8 else a.astype(np.int32))


class Expansion:
    """One launch's blocks of a reference plan, expanded by both
    packages."""

    def __init__(self, sub, words, spec, *, pieces=True, pair=False,
                 lanes=1024, stride=16):
        self.ct = compile_table(sub)
        self.plan = build_plan(spec, self.ct, pack_words(words))
        self.pieces = piece_schema_for(self.plan, self.ct) if pieces \
            else None
        assert (self.pieces is not None) == pieces
        if pair:
            assert self.pieces.pair_ok
        k = 2 if pair else 1
        batch, _, _ = make_blocks(self.plan, max_variants=lanes * k,
                                  fixed_stride=stride * k,
                                  max_blocks=lanes // stride)
        self.batch = pad_batch(batch, lanes // stride)
        self.kw = dict(
            num_lanes=lanes, out_width=self.plan.out_width,
            min_substitute=spec.effective_min,
            max_substitute=spec.max_substitute, block_stride=stride,
            radix2=int(self.plan.pat_radix.max()) <= 2, pieces=self.pieces,
            pair_k=2 if pair else None)

    def args(self):
        p, b = self.plan, self.batch
        blocks = [b.word, b.base_digits, b.count, b.offset]
        if getattr(p, "match_pos", None) is not None:
            return [p.tokens, p.lengths, p.match_pos, p.match_len,
                    p.match_radix, p.match_val_start, self.ct.val_bytes,
                    self.ct.val_len] + blocks, {}
        vb = self.ct.val_bytes if p.cval_bytes is None else p.cval_bytes
        vl = self.ct.val_len if p.cval_len is None else p.cval_len
        extra = {} if p.close_next is None else dict(
            close_next=p.close_next, close_mul=p.close_mul)
        return [p.tokens, p.lengths, p.pat_radix, p.pat_val_start,
                p.seg_orig_start, p.seg_orig_len, p.seg_pat, vb, vl] \
            + blocks, extra

    def reference(self, splice_impl=None):
        args, extra = self.args()
        fn = j_em.expand_matches if len(args) == 12 else j_es.expand_suball
        kw = dict(self.kw)
        if fn is j_em.expand_matches:
            kw["splice_impl"] = splice_impl
        win = self.plan.win_v
        out = fn(*[jnp.asarray(a) for a in args],
                 win_v=None if win is None else jnp.asarray(win),
                 **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
        return [np.asarray(x) for x in out]

    def port(self):
        args, extra = self.args()
        fn = t_em.expand_matches if len(args) == 12 else t_es.expand_suball
        win = self.plan.win_v
        tabs = None if self.pieces is None else t_em.piece_device_tables(
            self.pieces, device="cpu")
        out = fn(*[tensor(a) for a in args],
                 win_v=None if win is None else tensor(win),
                 **{k: tensor(v) for k, v in extra.items()},
                 piece_tables=tabs, **self.kw)
        # The buffer hash takes contiguous rows and lengths only.
        assert all(x.is_contiguous() for x in out)
        return [x.numpy() for x in out]


def assert_expansions_equal(want, got):
    (wc, wl, ww, we), (gc, gl, gw, ge) = want, got
    assert we.any()
    assert np.array_equal(wl, gl) and np.array_equal(ww, gw)
    assert np.array_equal(we, ge)
    assert gc.dtype == np.uint8 and gc.shape == wc.shape
    for i in range(len(wl)):
        n = max(0, min(int(wl[i]), wc.shape[1]))
        assert np.array_equal(wc[i, :n], gc[i, :n]), i
        assert not gc[i, n:].any()


#: (table, words, spec keyword arguments, piece schema, pair)
MATCH_CASES = {
    "piece": (CYR, [b"password", b"abc", b"zz", b"hello"], {}, True, False),
    "schema-less-german-sss": (
        GERMAN, [b"schlosssee", b"messstation", b"strasse", b"fuss"], {},
        False, False),
    "pair": (CYR, [b"password", b"abc", b"zz"], {}, True, True),
    "windowed": (CYR, [b"password", b"qwertyasdf", b"zz"],
                 dict(max_substitute=2), True, False),
    "30-slots": (CYR, [b"password", THIRTY], dict(max_substitute=2), True,
                 False),
    "100-byte-tokens": (CYR, [b"sesame", HUNDRED], dict(max_substitute=1),
                        True, False),
    "leet9-reverse": (LEET9, [b"sassafras", b"seesaw"],
                      dict(mode="reverse"), True, False),
    "leet9": (LEET9, [b"sassafras", b"seesaw"], {}, True, False),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_expand_matches_equals_reference(case):
    sub, words, kw, pieces, pair = MATCH_CASES[case]
    exp = Expansion(sub, words, JSpec(**kw), pieces=pieces, pair=pair,
                    lanes=2048)
    got = exp.port()
    assert_expansions_equal(exp.reference("scatter"), got)
    if not pieces:
        assert_expansions_equal(exp.reference("compare"), got)
    # The schema-less splice of plans that have a schema too.
    if case in ("30-slots", "100-byte-tokens", "leet9"):
        bare = Expansion(sub, words, JSpec(**kw), pieces=False, lanes=2048)
        got = bare.port()
        assert_expansions_equal(bare.reference("scatter"), got)
        assert_expansions_equal(bare.reference("compare"), got)


#: Substitute-all: (table, words, spec keyword arguments, piece schema,
#: pair, closed)
SUBALL_CASES = {
    "piece": (CYR, [b"password", b"abc", b"zz"], {}, True, False, False),
    "schema-less-german-sss": (
        GERMAN, [b"strasse", b"schlosssee", b"messstation"], {}, False,
        False, False),
    "pair": (SINGLE, PAIR_WORDS, {}, True, True, False),
    "windowed": (CYR, [b"password", b"qwertyasdf"],
                 dict(max_substitute=2), True, False, False),
    "closed": (AZERTY, [b"aqzw", b"maqa", b"qaqa,", b"azerty"], {}, True,
               False, True),
    "closed-windowed": (AZERTY, [b"aqzw", b"maqa", b"qaqa,", b"azerty"],
                        dict(max_substitute=1), True, False, True),
    "30-slots": (CYR, [b"password", THIRTY], dict(max_substitute=2), True,
                 False, False),
    "100-byte-tokens": (CYR, [b"sesame", HUNDRED], dict(max_substitute=1),
                        True, False, False),
    "leet9-reverse": (LEET9, [b"sassafras", b"seesaw"],
                      dict(mode="suball-reverse"), True, False, False),
}


@pytest.mark.parametrize("case", sorted(SUBALL_CASES))
def test_expand_suball_equals_reference(case):
    sub, words, kw, pieces, pair, closed = SUBALL_CASES[case]
    kw = dict(kw)
    kw.setdefault("mode", "suball")
    exp = Expansion(sub, words, JSpec(**kw), pieces=pieces, pair=pair,
                    lanes=2048)
    assert (exp.plan.close_next is not None) == closed
    assert_expansions_equal(exp.reference(), exp.port())
    if pieces and not pair:
        bare = Expansion(sub, words, JSpec(**kw), pieces=False, lanes=2048)
        assert_expansions_equal(bare.reference(), bare.port())
