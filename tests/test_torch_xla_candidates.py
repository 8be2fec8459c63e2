"""Candidates mode of the PyTorch/CUDA package against the JAX reference,
on the CPU: the CLI without ``--digests`` streams every candidate through
the XLA expansion, byte-identical to the reference CLI's stdout in
default, ``-r``, ``-s`` and ``-s -r`` mode (oracle-fallback words
interleaved at their word position, ``--hex-unsafe`` wrapping), to stdout
(``--output`` is ``--emit-table``'s file only, as in the reference); per
word the stream is the oracle's multiset; and the
entry points refuse to run on the CPU unless asked to."""

import io

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.cli as j_cli
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime.bucketed import (
    BucketedSweep,
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

GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
LONG_LINE = b"0123456789" * 6 + b"passwords!"  # 70 bytes
THIRTY = b"qwertyuiopasdfghjklzxcvbnmqwer"  # 30 letters


def azerty_lines(n=24, seed=31):
    """Short lines over ``aqzwAQZWm,;`` and letters: cascade-closed words
    and (every other line carries ``m``, ``,`` and ``;``) words that go to
    the oracle under ``-s``."""
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


WORDS = [b"password", b"sesame", b"zebra", LONG_LINE, THIRTY] + \
    azerty_lines()
#: A value holding a newline: ``--hex-unsafe`` wraps the candidates that
#: carry it.
NEWLINE = b"z=$HEX[0a]\n"
#: (layout, flags) per mode: cyrillic with ``-x 2`` (the 30-letter line
#: has 30 slots), qwerty-azerty's hazards and oracle words under ``-s``.
MODES = {
    "default": ("qwerty-cyrillic", ["-x", "2"]),
    "reverse": ("qwerty-cyrillic", ["-r", "-x", "2"]),
    "suball": ("qwerty-azerty", ["-s"]),
    "suball-reverse": ("qwerty-azerty", ["-s", "-r"]),
}


def inputs(tmp_path, layout, words=WORDS):
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    (tmp_path / "nl.table").write_bytes(NEWLINE)
    return [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "-t", str(tmp_path / "nl.table"), "--backend", "device"]


def unwrap(stream: bytes) -> bytes:
    """A ``--hex-unsafe`` stream as the raw stream: each ``$HEX[..]`` line
    decoded (no plain candidate here starts with ``$HEX[``)."""
    return b"".join(
        (bytes.fromhex(ln[5:-1].decode()) if ln.startswith(b"$HEX[")
         else ln) + b"\n" for ln in stream.splitlines())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_candidates_cli_stdout_equals_reference(mode, tmp_path,
                                                capsysbinary):
    """The reference CLI's ``--hex-unsafe`` stream, and the raw stream it
    encodes: the port prints both byte for byte.  Candidates that carry
    the newline value (every mode but the reverse ones, whose first option
    for ``z`` is the layout's) come wrapped, and span two raw lines."""
    layout, flags = MODES[mode]
    argv = inputs(tmp_path, layout) + flags + GEOMETRY_ARGV
    assert j_cli.main(argv + ["--hex-unsafe"]) == 0
    want = capsysbinary.readouterr().out
    newline = not mode.endswith("reverse")
    assert (b"$HEX[" in want) == newline
    for hex_unsafe in (True, False):
        assert t_cli.main(argv + ["--device", "cpu"] + (
            ["--hex-unsafe"] if hex_unsafe else [])) == 0
        got = capsysbinary.readouterr()
        assert got.out == (want if hex_unsafe else unwrap(want))
        n = int(got.err.split(b" candidates written")[0].split(b"\n")[-1])
        assert n == len(want.splitlines())
        assert b"on the XLA expand + hash route" in got.err
    if mode == "suball":  # oracle words interleaved in the stream
        assert b"oracle-fallback" in got.err
        assert b" 0 oracle-fallback" not in got.err


def test_bucketed_candidates_equal_reference(tmp_path, capsysbinary):
    """``--buckets``: the stream goes bucket-major, as the reference's."""
    layout, flags = MODES["default"]
    argv = inputs(tmp_path, layout) + flags + GEOMETRY_ARGV + [
        "--buckets", "16,32,64"]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert b"notice: --buckets reorders" in got.err
    assert b"3 on the XLA expand + hash route" in got.err


def test_output_file_holds_the_stdout_stream(tmp_path, capsysbinary):
    """``--output`` is ``--emit-table``'s file only, as in the reference
    (F5): with it the candidate stream stays on stdout, byte-identical to
    the reference CLI's, and the file is not written."""
    layout, flags = MODES["suball"]
    out = tmp_path / "cands.txt"
    argv = inputs(tmp_path, layout) + flags + GEOMETRY_ARGV + [
        "--output", str(out)]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    assert capsysbinary.readouterr().out == want and want
    assert not out.exists()


def test_stream_is_the_oracles_multiset_per_word():
    """Word order, and per word the oracle's candidates (rank order on
    the device, DFS order in the oracle)."""
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    words = [b"password", b"abc", b"", b"zz9", LONG_LINE]
    buf = io.BytesIO()
    res = Sweep(AttackSpec(), sub, words, (),
                SweepConfig(device="cpu", lanes=512, num_blocks=8)
                ).run_candidates(CandidateWriter(buf))
    lines = buf.getvalue().splitlines()
    want = [sorted(iter_candidates(w, sub, 0, 15)) for w in words]
    assert res.n_emitted == len(lines) == sum(map(len, want))
    at = 0
    for cands in want:
        assert sorted(lines[at:at + len(cands)]) == cands
        at += len(cands)
    assert res.kernels["expand"] >= 1 and res.routes == {"xla": 1}


def test_bucketed_sweep_runs_candidates_bucket_major():
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        bucket_words,
    )

    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    words = [b"password", b"q" * 20 + b"x", b"abc"]
    cfg = SweepConfig(device="cpu", lanes=256, num_blocks=16)
    buckets = bucket_words(words)
    buf = io.BytesIO()
    res = BucketedSweep(AttackSpec(max_substitute=2), sub, buckets, (),
                        cfg).run_candidates(CandidateWriter(buf))
    lines = buf.getvalue().splitlines()
    order = [w for width in sorted(buckets) for w in
             [words[i] for i in buckets[width].index]]
    want = [c for w in order for c in sorted(iter_candidates(w, sub, 0, 2))]
    assert sorted(lines) == sorted(want) and len(lines) == res.n_emitted
    assert res.routes == {"xla": 2}


def test_candidates_entry_points_need_the_gpu_unless_told(tmp_path):
    """Without a GPU the candidates sweep and the CLI raise instead of
    running on the CPU; ``device="cpu"`` / ``--device cpu`` run."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    sub = {b"a": [b"4"]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sweep(AttackSpec(), sub, [b"abc"]).run_candidates(
            CandidateWriter(io.BytesIO()))
    argv = inputs(tmp_path, "qwerty-cyrillic")
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert "no CUDA device" in str(exc.value)
