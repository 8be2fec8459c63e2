"""The PyTorch/CUDA package's native host libraries (its own copies of
``native/packer.cpp`` and ``native/oracle.cpp``, built with g++ into
``build/torch_native/``) against the port's numpy and Python versions and
the JAX reference's native libraries, on the CPU: the scanner/packer on
every line-structure edge, the anti-Q8 error and ``A5_NATIVE=0``; the
native oracle streams (engines A, C, D and the lazy iterator) byte for
byte, with a seeded fuzz; the one eligibility predicate equal to the
reference's on a grid; and the device sweep's fallback words through the
native engine, the CLI's stdout equal to ``A5_NATIVE=0``'s and the
reference CLI's."""

import io
import itertools
import pathlib
import random

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.cli as j_cli
from hashcat_a5_table_generator_tpu import native as j_native
from hashcat_a5_table_generator_tpu.native import oracle_engine as j_oe
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch import native
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.native import oracle_engine
from hashcat_a5_table_generator_tpu_torch.ops import packing
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    process_word,
    process_word_substitute_all,
    process_word_substitute_all_reverse,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)

REPO = pathlib.Path(__file__).resolve().parent.parent

CASES = [
    b"",
    b"\n",
    b"abc\n",
    b"abc",  # unterminated tail
    b"abc\r\n",  # CRLF
    b"abc\rx\n",  # interior CR kept
    b"one\ntwo\nthree\n",
    b"\n\nmid\n\n",  # empty lines
    b"word\r\nmixed\nendings\r\n",
    bytes(range(1, 10)) + b"\n" + b"\xf0\x9f\x94\x91\n",  # binary + UTF-8
    b"a" * 100 + b"\n" + b"b\n",
]


def test_native_libraries_build_under_build_torch_native():
    """Both libraries build here (g++ is present) from the port's own
    sources, into ``build/torch_native/`` at the checkout's root."""
    assert native.available() and oracle_engine.available()
    assert native.BUILD_DIR == REPO / "build" / "torch_native"
    built = sorted(p.name.split("-")[0]
                   for p in native.BUILD_DIR.glob("lib*.so"))
    assert "liba5native" in built and "liba5oracle" in built
    assert native._SRC.parent == REPO / (
        "hashcat_a5_table_generator_tpu_torch/native")
    assert oracle_engine._SRC.parent == native._SRC.parent
    for lib in (native._lib, oracle_engine._lib):
        assert str(native.BUILD_DIR) in lib._name


@pytest.mark.parametrize("data", CASES, ids=range(len(CASES)))
def test_scan_equals_numpy_and_reference(data, tmp_path):
    """Line structure: the native scan, the port's numpy scan and the
    reference's native scan agree, and rebuild the words the oracle
    backend's reader (``read_wordlist``) gives, as the reference's
    does."""
    _buf, off, lens = native.scan_wordlist_bytes(data)
    for other in (packing.read_wordlist_lines(data),
                  j_native.scan_wordlist_bytes(data)):
        np.testing.assert_array_equal(off, other[1])
        np.testing.assert_array_equal(lens, other[2])
    p = tmp_path / "w.txt"
    p.write_bytes(data)
    words = packing.read_wordlist(str(p))
    from hashcat_a5_table_generator_tpu.ops.packing import (
        read_wordlist as j_read_wordlist,
    )

    assert words == j_read_wordlist(str(p))
    assert [data[o:o + n] for o, n in zip(off, lens)] == words


def test_oversized_line_raises_on_every_path(monkeypatch, tmp_path):
    data = b"x" * 64 + b"\nok\n"
    with pytest.raises(ValueError, match="line 0 exceeds 10 bytes"):
        native.scan_wordlist_bytes(data, max_word_bytes=10)
    with pytest.raises(ValueError, match="Q8"):
        packing.read_wordlist_lines(data, max_word_bytes=10)
    (tmp_path / "w.txt").write_bytes(data)
    with pytest.raises(ValueError, match="Q8"):
        packing.read_wordlist(str(tmp_path / "w.txt"), max_word_bytes=10)
    monkeypatch.setenv("A5_NATIVE", "0")
    with pytest.raises(ValueError, match="line 0 exceeds 10 bytes"):
        native.scan_wordlist_bytes(data, max_word_bytes=10)


@pytest.mark.parametrize("engine", ["native", "A5_NATIVE=0"])
def test_read_packed_equals_pack_words_and_reference(engine, tmp_path,
                                                     monkeypatch):
    if engine != "native":
        monkeypatch.setenv("A5_NATIVE", "0")
        assert not native.available()
    words = [b"password", b"", b"x" * 31, b"\xd0\xb9ob", b"tail", b"q" * 70]
    p = tmp_path / "w.txt"
    p.write_bytes(b"\r\n".join(words))
    got = native.read_packed(str(p))
    for want in (packing.pack_words(words), j_native.read_packed(str(p))):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        np.testing.assert_array_equal(got.index, want.index)
    got = native.read_packed_buckets(str(p), buckets=(8, 32))
    for want in (packing.bucket_words(words, buckets=(8, 32)),
                 j_native.read_packed_buckets(str(p), buckets=(8, 32))):
        assert sorted(got) == sorted(want) == [8, 32, 128]
        for w in got:
            np.testing.assert_array_equal(got[w].tokens, want[w].tokens)
            np.testing.assert_array_equal(got[w].lengths, want[w].lengths)
            np.testing.assert_array_equal(got[w].index, want[w].index)


@pytest.mark.parametrize("engine", ["native", "A5_NATIVE=0"])
def test_selection_pack_and_width_overflow(engine, monkeypatch):
    if engine != "native":
        monkeypatch.setenv("A5_NATIVE", "0")
    buf, off, lens = native.scan_wordlist_bytes(b"aa\nbbbb\ncc\ndddddd\n")
    sel = np.asarray([1, 3], dtype=np.int64)
    got = native.pack_rows(buf, off, lens, sel, 8)
    want = packing.pack_words([b"bbbb", b"dddddd"], width=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.index, sel)
    index = np.asarray([40, 41], dtype=np.int64)
    np.testing.assert_array_equal(
        native.pack_rows(buf, off, lens, sel, 8, index=index).index, index)
    with pytest.raises(ValueError):
        native.pack_rows(buf, off, lens, None, 4)


def test_forced_fallback_reads_a5_native_at_each_call(monkeypatch):
    """``A5_NATIVE=0`` turns both libraries off for the calls made while
    it is set, and they come back after."""
    monkeypatch.setenv("A5_NATIVE", "0")
    assert not native.available() and not oracle_engine.available()
    with pytest.raises(RuntimeError, match="native oracle unavailable"):
        oracle_engine.NativeDefaultOracle({b"a": [b"4"]})
    monkeypatch.delenv("A5_NATIVE")
    assert native.available() and oracle_engine.available()


def test_failed_build_prints_the_notice_and_falls_back(monkeypatch,
                                                       tmp_path, capsys):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert native.build_library(native._SRC, "a5native", ("-O3",), "",
                                "numpy fallback") is None
    assert capsys.readouterr().err.startswith(
        "a5native: build failed (")
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# The native oracle engines
# ---------------------------------------------------------------------------

TABLES = [
    {b"a": [b"4", b"@"], b"s": [b"$", b"5"], b"e": [b"3"]},
    {b"ss": [b"\xc3\x9f"], b"s": [b"z"], b"a": [b"\xc3\xa4"]},
    {b"a": [b"4", b"4"]},  # duplicate options (Q7)
    {b"ab": [b"X"], b"b": [b"Y"], b"a": [b"Z"]},  # overlap, longest first
    {b"a": [b""], b"b": [b"bb"]},  # shrink + grow values
    {b"\x00": [b"\xff"], b"\xff\xfe": [b"\x00\x01"]},  # raw bytes
    {b"a": [b"ba"], b"b": [b"ab"]},  # values holding keys (Q4 cascade)
    {b"a": [b""], b"": [b"Q"]},  # an empty key
]
WORDS = [b"", b"x", b"glass", b"assassin", b"abab", b"aaaa",
         b"\x00\xff\xfe\x00", b"banana"]
WINDOWS = [(0, 15), (1, 1), (2, 3), (0, 0), (3, 2)]
ENGINES = {
    "A": ("stream_word", process_word, {}),
    "C": ("stream_word_suball", process_word_substitute_all,
          dict(substitute_all=True)),
    "D": ("stream_word_suball_reverse", process_word_substitute_all_reverse,
          dict(substitute_all=True, reverse=True)),
}


@pytest.mark.parametrize("path", ["eager", "thread"])
@pytest.mark.parametrize("ti,engine", [
    (ti, e) for ti in range(len(TABLES)) for e in sorted(ENGINES)
    if not (e == "A" and b"" in TABLES[ti])])  # A takes no empty key
def test_native_streams_equal_python_and_reference(ti, engine, path,
                                                   monkeypatch):
    """Every engine's stream byte for byte against the port's Python
    generator and the reference's native engine; ``iter_word`` gives the
    same candidates one by one, on the caller's thread (a small word) and
    on its producer thread (``_EAGER_BYTES`` 0: every word starts over
    there); the count returned is the lines'."""
    if path == "thread":
        monkeypatch.setattr(oracle_engine, "_EAGER_BYTES", 0)
    sub = TABLES[ti]
    method, python, iter_kw = ENGINES[engine]
    eng, j_eng = oracle_engine.NativeDefaultOracle(sub), j_oe.\
        NativeDefaultOracle(sub)
    for word, (lo, hi) in itertools.product(WORDS, WINDOWS):
        want = list(python(word, sub, lo, hi))
        got = io.BytesIO()
        n = getattr(eng, method)(word, lo, hi, got.write)
        blob = b"".join(c + b"\n" for c in want)
        assert got.getvalue() == blob, (word, lo, hi)
        assert n == len(want)
        ref = io.BytesIO()
        getattr(j_eng, method)(word, lo, hi, ref.write)
        assert ref.getvalue() == blob
        assert list(eng.iter_word(word, lo, hi, **iter_kw)) == want


def test_plain_reverse_has_no_native_engine():
    eng = oracle_engine.NativeDefaultOracle({b"a": [b"4"]})
    with pytest.raises(ValueError, match="plain reverse"):
        list(eng.iter_word(b"aa", 0, 15, reverse=True))


def test_sink_errors_stop_the_stream():
    """A sink that raises ends the C++ enumeration and the error comes
    back to the caller; a closed ``iter_word`` stops its producer."""
    eng = oracle_engine.NativeDefaultOracle({b"a": [b"4", b"@"]})

    def sink(_blob):
        raise BrokenPipeError

    with pytest.raises(BrokenPipeError):
        eng.stream_word(b"a" * 20, 0, 15, sink)
    # ~3^20 candidates: past the eager limit, so it starts over on the
    # producer thread, from the first candidate.
    it = eng.iter_word(b"a" * 20, 0, 15)
    assert next(it) == b"4" + b"a" * 19
    assert next(it) == b"44" + b"a" * 18
    it.close()


def test_native_engines_fuzz_parity():
    """Seeded random tables and words (binary bytes, multi-byte keys,
    empty and multi-byte values, duplicate options): the three native
    engines equal the port's Python generators and the reference's
    native engines on every sample."""
    rng = random.Random(1234)
    alpha = b"abcx\x00\xff"

    def rand_bytes(lo, hi):
        return bytes(rng.choice(alpha) for _ in range(rng.randint(lo, hi)))

    for trial in range(60):
        sub = {}
        for _ in range(rng.randint(1, 5)):
            sub[rand_bytes(1, 3)] = [rand_bytes(0, 3)
                                     for _ in range(rng.randint(1, 3))]
        eng = oracle_engine.NativeDefaultOracle(sub)
        j_eng = j_oe.NativeDefaultOracle(sub)
        for _ in range(4):
            word, lo, hi = rand_bytes(0, 7), rng.randint(0, 3), \
                rng.randint(0, 5)
            for method, python, _kw in ENGINES.values():
                want = b"".join(c + b"\n" for c in python(word, sub, lo, hi))
                got, ref = io.BytesIO(), io.BytesIO()
                getattr(eng, method)(word, lo, hi, got.write)
                getattr(j_eng, method)(word, lo, hi, ref.write)
                assert got.getvalue() == want == ref.getvalue(), (
                    trial, sub, word, lo, hi, method)


ELIGIBILITY_TABLES = {
    "plain": {b"a": [b"4"]},
    "newline": {b"a": [b"\n"]},
    "cr": {b"a": [b"x\r"]},
    "wide": {bytes([i % 256, i // 256]): [b"x"] for i in range(4097)},
}


@pytest.mark.parametrize("table", sorted(ELIGIBILITY_TABLES))
def test_eligibility_equals_reference_on_a_grid(table):
    """The one predicate (the CLI's shim over it too) against the
    reference's on every mode x crack x hex x window edge."""
    sub = ELIGIBILITY_TABLES[table]
    seen = set()
    for sa, rv, crack, hu, mx in itertools.product(
            (False, True), (False, True), (False, True), (False, True),
            (-1, 0, 15, 512, 513, 100000)):
        kw = dict(substitute_all=sa, reverse=rv, crack=crack,
                  hex_unsafe=hu, max_substitute=mx)
        got = oracle_engine.default_engine_eligible(sub, **kw)
        assert got == j_oe.default_engine_eligible(sub, **kw), kw
        mode = (("suball-reverse" if rv else "suball") if sa
                else ("reverse" if rv else "default"))
        assert t_cli.native_default_eligible(sub, mode, crack, hu, mx) \
            == j_cli.native_default_eligible(sub, mode, crack, hu, mx) \
            == got
        seen.add(got)
    assert seen == ({False} if table in ("newline", "cr")
                    else {True, False})


# ---------------------------------------------------------------------------
# The device sweep's fallback words
# ---------------------------------------------------------------------------

def azerty_lines(n=30, seed=31):
    """Short lines over ``aqzwAQZWm,;``: every other one carries ``m``,
    ``,`` and ``;``, which qwerty-azerty's closure cannot take, so those
    words go to the oracle under ``-s``."""
    rng = np.random.default_rng(seed)
    pool = np.frombuffer(b"aqzwAQZWm,;bcdefghijk", np.uint8)
    out = []
    for i in range(n):
        w = list(pool[rng.integers(0, len(pool),
                                   size=int(rng.integers(2, 5)))])
        if i % 2:
            for ch in b"m,;":
                w.insert(int(rng.integers(0, len(w) + 1)), ch)
        out.append(bytes(w))
    return out


@pytest.mark.parametrize("layout", ["qwerty-azerty", "azerty-qwerty"])
def test_sweep_fallback_words_take_the_native_engine(layout):
    """The sweep's fallback words (``-s``: ``-s -r`` routes none there)
    come from the native engine, cached once a sweep; the candidate
    stream equals the Python engines'."""
    sub = get_layout(layout).to_substitution_map()
    words = [b"password"] + azerty_lines()
    cfg = SweepConfig(device="cpu", lanes=256, num_blocks=16)

    def stream(native_on):
        sweep = Sweep(AttackSpec(mode="suball"), sub, words, (), cfg)
        assert len(sweep.fallback_rows) >= 10
        if not native_on:
            sweep._native_oracle_cache = None
        buf = io.BytesIO()
        with CandidateWriter(buf) as w:
            res = sweep.run_candidates(w)
        eng = sweep._native_oracle_cache
        assert (eng is not None) == native_on
        return buf.getvalue(), res.n_emitted

    assert stream(True) == stream(False)


@pytest.mark.parametrize("crack", [False, True], ids=["candidates",
                                                      "crack"])
@pytest.mark.parametrize("layout", ["qwerty-azerty", "azerty-qwerty"])
def test_azerty_s_cli_native_equals_python_and_reference(
        layout, crack, tmp_path, capsysbinary, monkeypatch):
    """The azerty-s cell's shape on the device backend: the CLI's stdout
    with the native fallback engine, with ``A5_NATIVE=0`` and the
    reference CLI's, byte for byte (crack: hits planted in fallback
    words)."""
    from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
        iter_candidates,
    )
    from hashcat_a5_table_generator_tpu_torch.utils.digests import (
        HOST_DIGEST,
    )

    sub = get_layout(layout).to_substitution_map()
    words = [b"password", b"zebra"] + azerty_lines(seed=32)
    (tmp_path / "w.txt").write_bytes(b"\n".join(words) + b"\n")
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "w.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--lanes", "256", "--blocks", "16", "-s"]
    if crack:
        digests = [HOST_DIGEST["md5"](b"decoy")]
        for w in words[1::4]:
            cands = list(iter_candidates(w, sub, 0, 15, substitute_all=True))
            digests.append(HOST_DIGEST["md5"](cands[len(cands) // 2]))
        (tmp_path / "left.txt").write_text(
            "".join(d.hex() + "\n" for d in digests))
        argv += ["--digests", str(tmp_path / "left.txt")]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert want and (not crack or len(want.splitlines()) >= 4)
    outs = []
    for engine in ("native", "0"):
        if engine == "0":
            monkeypatch.setenv("A5_NATIVE", "0")
        assert t_cli.main(argv + ["--device", "cpu"]) == 0
        got = capsysbinary.readouterr()
        assert b"oracle-fallback" in got.err
        assert b" 0 oracle-fallback" not in got.err
        outs.append(got.out)
    assert outs == [want, want]
