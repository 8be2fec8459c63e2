"""The fallback prefetcher (the reference's ``_FallbackPrefetcher``) on
the CPU: oracle-fallback words are expanded on a producer thread while
the drive runs, and consumed in word order.

qwerty-azerty ``-s`` with fallback words, crack and candidates, on the
superstep drive and the per-launch pipeline: CLI stdout byte-identical
to the reference CLI's.  A producer's exception is raised again in the
drive; ``close()`` ends a producer blocked on a full queue; a sweep
killed between fallback rows resumes in the other package; an in-drive
retry starts a new producer at ``fallback_done``; no producer thread
outlives its run.
"""

import json
import threading
import time

import pytest
from test_torch_resume_cli import (  # noqa: F401
    _disarm,
    killed,
    run,
    write_inputs,
)

import hashcat_a5_table_generator_tpu_torch.runtime.sweep as t_sweep
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

GEOMETRY = ["--lanes", "256", "--blocks", "16"]
DRIVES = {"superstep": ["--superstep", "2"], "per-launch":
          ["--superstep", "off"]}
SUB = get_layout("qwerty-azerty").to_substitution_map()


def producers():
    return [t for t in threading.enumerate()
            if t.name == "a5-fallback-oracle" and t.is_alive()]


@pytest.fixture(autouse=True)
def _no_thread_left():
    yield
    assert producers() == []


_REF: dict = {}


@pytest.mark.parametrize("drive", sorted(DRIVES))
@pytest.mark.parametrize("stream", ["crack", "candidates"])
@pytest.mark.parametrize("mode", ["suball", "suball-reverse"])
def test_fallback_words_match_reference_cli(mode, stream, drive, tmp_path,
                                            capsysbinary):
    argv = write_inputs(tmp_path, mode) + GEOMETRY + DRIVES[drive]
    if stream == "crack":
        argv += ["--digests", str(tmp_path / "d.txt")]
    key = (mode, stream)
    if key not in _REF:
        rc, out, err = run("j", argv, capsysbinary)
        assert rc == 0 and out, err
        _REF[key] = out
    rc, got, err = run("t", argv, capsysbinary)
    assert rc == 0 and got == _REF[key], err
    assert "oracle-fallback" in err


def sweep(words, lanes=256, num_blocks=16, **kw):
    return Sweep(AttackSpec(mode="suball"), SUB, words, [b"\0" * 16],
                 config=SweepConfig(device="cpu", lanes=lanes,
                                    num_blocks=num_blocks, **kw))


WORDS = [b"aqua", b"password", b"m;", b"zwzw", b"m,;", b"qwerty",
         b"am,;q", b"mama,;", b"hello"]


def test_producer_exception_is_raised_in_the_drive(monkeypatch):
    s = sweep(WORDS)
    assert len(s.fallback_rows) >= 3
    real = s._oracle_candidates
    bad = s.fallback_rows[1]

    def oracle(row):
        if row == bad:
            raise KeyError("the oracle broke")
        return real(row)

    monkeypatch.setattr(s, "_oracle_candidates", oracle)
    with pytest.raises(KeyError, match="the oracle broke"):
        s.run_crack()
    with pytest.raises(KeyError, match="the oracle broke"):
        s.run_candidates(CandidateWriter(open("/dev/null", "wb")))


def test_close_ends_a_producer_on_a_full_queue():
    s = sweep([b"m;" * 3, b"m,;" * 2] * 40)
    pf = t_sweep._FallbackPrefetcher(s, 0)
    deadline = time.monotonic() + 30
    while not pf._queue.full() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pf._queue.full() and pf._thread.is_alive()
    t = time.monotonic()
    pf.close()
    assert not pf._thread.is_alive() and time.monotonic() - t < 5


def test_rows_come_in_order_with_the_oracle_stream():
    s = sweep(WORDS)
    pf = t_sweep._FallbackPrefetcher(s, 1)
    try:
        for row in s.fallback_rows[1:]:
            assert list(pf.iter_row()) == list(s._oracle_candidates(row))
    finally:
        pf.close()


@pytest.mark.parametrize("writer", ["t", "j"])
def test_a_kill_between_fallback_rows_resumes_in_the_other(
        writer, tmp_path, capsysbinary, monkeypatch):
    argv = write_inputs(tmp_path, "suball") + GEOMETRY + [
        "--digests", str(tmp_path / "d.txt")]
    rc, want, err = run("j", argv, capsysbinary)
    assert rc == 0, err
    ck = tmp_path / "ck.json"
    flags = ["--checkpoint", str(ck), "--checkpoint-every", "0",
             "--superstep", "1", "--buckets", "none", "--lanes", "64",
             "--blocks", "16"]
    killed(writer, argv + flags, "superstep.fetch:nth=3,error=OSError",
           capsysbinary, monkeypatch)
    doc = json.loads(ck.read_text())
    s = sweep((tmp_path / "w.txt").read_bytes().splitlines())
    # The kill fell between two fallback words: some were flushed, some
    # not yet.
    assert 0 < doc["fallback_done"] < len(s.fallback_rows)
    other = {"t": "j", "j": "t"}[writer]
    rc, got, err = run(other, argv + flags, capsysbinary)
    assert rc == 0 and got == want, err


@pytest.mark.parametrize("drive", [None, 0], ids=["superstep",
                                                  "per-launch"])
def test_a_retry_restarts_the_producer_at_fallback_done(drive, monkeypatch):
    words = WORDS * 6
    superstep = 1 if drive is None else drive
    geometry = dict(lanes=16, num_blocks=4, superstep=superstep)
    want = sweep(words, **geometry).run_crack()
    starts = []
    init = t_sweep._FallbackPrefetcher.__init__

    def spy(self, sw, start):
        starts.append(start)
        init(self, sw, start)

    monkeypatch.setattr(t_sweep._FallbackPrefetcher, "__init__", spy)
    monkeypatch.setenv("A5GEN_FAULTS", "superstep.fetch:nth=3")
    s = sweep(words, **geometry)
    got = s.run_crack()
    monkeypatch.delenv("A5GEN_FAULTS")
    assert got.superstep["retries"] == 1
    assert [(h.word_index, h.variant_rank) for h in got.hits] == \
        [(h.word_index, h.variant_rank) for h in want.hits]
    assert got.n_emitted == want.n_emitted
    # The first producer started at 0; the retry's at the fallback words
    # consumed before the failed fetch.
    assert starts[0] == 0 and len(starts) == 2
    assert 0 < starts[1] < len(s.fallback_rows)
