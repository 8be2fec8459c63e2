"""The PyTorch/CUDA package's multi-process oracle (``--threads N``, its
copy of ``oracle/parallel.py``) against its sequential path and the JAX
reference's, on the CPU: the merged stream is byte-identical to the
``--threads 1`` order in every mode, hits come in word order, a worker's
error or death raises instead of hanging, and a run forked after
``import torch`` completes."""

import hashlib
import io
import os
import pathlib
import signal
import subprocess
import sys

import pytest

from hashcat_a5_table_generator_tpu.oracle import parallel as j_parallel
from hashcat_a5_table_generator_tpu.runtime.sinks import (
    CandidateWriter as JWriter,
)
from hashcat_a5_table_generator_tpu_torch.oracle import parallel
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.oracle.parallel import (
    OracleWorkerError,
    run_candidates_parallel,
    run_crack_parallel,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
LEET = {b"a": [b"4", b"@"], b"o": [b"0"], b"s": [b"$", b"5"], b"e": [b"3"]}
WORDS = [b"password", b"sesame", b"octopus", b"zzz", b"a", b"assess",
         b"oboe", b"xyzzy", b"sass", b"apollo", b"essence"]


def _sequential_blob(words, sub, hex_unsafe=False, **kw) -> bytes:
    buf = io.BytesIO()
    w = CandidateWriter(buf, hex_unsafe=hex_unsafe)
    for word in words:
        for cand in iter_candidates(word, sub, **kw):
            w.emit(cand)
    w.flush()
    return buf.getvalue()


@pytest.mark.parametrize("mode_kw", [
    dict(),
    dict(reverse=True),
    dict(substitute_all=True),
    dict(substitute_all=True, reverse=True),
    dict(min_substitute=1, max_substitute=2),
], ids=["default", "reverse", "suball", "suball-reverse", "window"])
@pytest.mark.parametrize("n_workers", [2, 3])
def test_candidates_byte_identical(mode_kw, n_workers):
    want = _sequential_blob(WORDS, LEET, **mode_kw)
    buf = io.BytesIO()
    writer = CandidateWriter(buf)
    n = run_candidates_parallel(
        WORDS, LEET, writer, n_workers=n_workers, **mode_kw
    )
    writer.flush()
    assert buf.getvalue() == want
    assert n == want.count(b"\n")
    ref = io.BytesIO()
    j_writer = JWriter(ref)
    j_parallel.run_candidates_parallel(WORDS, LEET, j_writer,
                                       n_workers=n_workers, **mode_kw)
    j_writer.flush()
    assert ref.getvalue() == want


def test_hex_unsafe_wrapping_matches():
    sub = {b"a": [b"\x0a"], b"b": [b"\r"]}  # values that corrupt lines
    words = [b"abba", b"baab", b"cab"]
    want = _sequential_blob(words, sub, hex_unsafe=True)
    assert b"$HEX[" in want  # the wrapping actually engages
    buf = io.BytesIO()
    writer = CandidateWriter(buf, hex_unsafe=True)
    run_candidates_parallel(words, sub, writer, n_workers=2,
                            hex_unsafe=True)
    writer.flush()
    assert buf.getvalue() == want


def test_more_workers_than_words():
    words = [b"sos", b"as"]
    want = _sequential_blob(words, LEET)
    buf = io.BytesIO()
    writer = CandidateWriter(buf)
    run_candidates_parallel(words, LEET, writer, n_workers=8)
    writer.flush()
    assert buf.getvalue() == want


@pytest.mark.parametrize("mode_kw", [dict(), dict(substitute_all=True)],
                         ids=["default", "suball"])
def test_crack_hits_in_word_order(mode_kw):
    oracle = []
    for w in WORDS:
        oracle.extend(iter_candidates(w, LEET, **mode_kw))
    planted = [oracle[3], oracle[len(oracle) // 2], oracle[-2]]
    digs = [hashlib.md5(c).digest() for c in planted]
    digs += [hashlib.md5(b"decoy%d" % i).digest() for i in range(30)]
    want = []
    lookup = set(digs)
    for w in WORDS:
        for cand in iter_candidates(w, LEET, **mode_kw):
            d = hashlib.md5(cand).digest()
            if d in lookup:
                want.append((d.hex(), cand))
    for run in (run_crack_parallel, j_parallel.run_crack_parallel):
        got = []
        n = run(WORDS, LEET, digs, "md5",
                lambda dh, c: got.append((dh, c)), n_workers=3, **mode_kw)
        assert got == want
        assert n == len(want) >= 3


def test_worker_error_propagates():
    with pytest.raises(OracleWorkerError, match="Traceback"):
        run_candidates_parallel(
            [b"ok", 12345, b"ok2"], {b"a": [b"4"]},
            CandidateWriter(io.BytesIO()), n_workers=2,
        )


class _Fatal(bytes):
    """A word whose length, asked in a worker process, kills that worker
    (SIGKILL: no traceback, as an OS kill leaves none)."""

    parent = os.getpid()

    def __len__(self):
        if os.getpid() != self.parent:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().__len__()


def test_a_killed_worker_raises_instead_of_hanging(monkeypatch):
    monkeypatch.setattr(parallel, "_POLL_S", 0.2)
    with pytest.raises(OracleWorkerError, match="died without a traceback"):
        run_candidates_parallel(
            [b"ok", _Fatal(b"boom"), b"ok2"], {b"a": [b"4"]},
            CandidateWriter(io.BytesIO()), n_workers=2, hex_unsafe=True,
        )


@pytest.mark.parametrize("crack", [False, True], ids=["candidates",
                                                      "crack"])
def test_threads_after_import_torch_complete(crack, tmp_path):
    """The CLI's ``--threads 3`` forks after ``import torch`` (crack mode
    imports it for ``HostDigestLookup``) and completes well inside its
    time limit; its stdout is ``--threads 1``'s."""
    (tmp_path / "w.txt").write_bytes(b"\n".join(WORDS * 20) + b"\n")
    (tmp_path / "t.table").write_bytes(
        b"".join(k + b"=" + v + b"\n" for k, vs in LEET.items()
                 for v in vs))
    (tmp_path / "left.txt").write_text(
        hashlib.md5(b"p4ssword").hexdigest() + "\n")
    argv = [str(tmp_path / "w.txt"), "-t", str(tmp_path / "t.table")]
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    code = ("import sys, torch\n"
            "from hashcat_a5_table_generator_tpu_torch.cli import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    outs = []
    for threads in ("3", "1"):
        r = subprocess.run([sys.executable, "-c", code, *argv, "--threads",
                            threads], cwd=REPO, capture_output=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert outs[0] == outs[1] and outs[0]
