"""Streaming ingestion (``--stream-chunk-words``, ``A5GEN_STREAM``) against
the reference's, on the CPU.

A dictionary of more than one chunk is compiled in word chunks on a
worker thread while the previous chunk sweeps, after one prescan fixes the
decisions every chunk shares (``out_width``, the windowed scheme, the
oracle routing).  Streaming must not show: the windowed vote's terms and
gate equal the reference's and the prescan decides as the whole plan
does; CLI stdout is byte-identical across chunk sizes 1, 7 and ``off`` and
to the reference CLI's, in the four modes, crack and candidates, with
fallback words across chunk boundaries and a windowed plan; a checkpoint
taken mid-chunk by either package resumes in the other, streaming or not;
the ring holds at most ``prefetch`` chunks ahead and releases each one;
``chunk.compile`` fails once and recovers, twice and the run ends; and
``A5GEN_STREAM=off`` pins the whole path.  (The reference's own tests of
the same pipeline: ``tests/test_streaming.py``.)
"""

import hashlib
import io
import json

import numpy as np
import pytest
from test_torch_resume_cli import (
    OTHER,
    _disarm,  # noqa: F401 — the autouse fixture disarms faults
    killed,
    run,
    write_inputs,
)

import hashcat_a5_table_generator_tpu.ops.expand_matches as j_em
import hashcat_a5_table_generator_tpu.ops.packing as j_packing
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import expand_matches as t_em
from hashcat_a5_table_generator_tpu_torch.ops import packing as t_packing
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime import env as t_env
from hashcat_a5_table_generator_tpu_torch.runtime import faults as t_faults
from hashcat_a5_table_generator_tpu_torch.runtime import telemetry
from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
)
from hashcat_a5_table_generator_tpu_torch.runtime.progress import (
    ProgressReporter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

MODES = ["default", "reverse", "suball", "suball-reverse"]
GEOMETRY = ["--lanes", "256", "--blocks", "16"]
CHUNKS = {"chunk-1": ["--stream-chunk-words", "1"],
          "chunk-7": ["--stream-chunk-words", "7"],
          "off": ["--stream-chunk-words", "off"]}


def layout_sub(mode):
    layout = "qwerty-azerty" if mode.startswith("suball") else \
        "qwerty-cyrillic"
    return get_layout(layout).to_substitution_map()


def words_for(n=40, seed=31):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(ord("a"), ord("z") + 1,
                               size=int(rng.integers(2, 9)),
                               dtype=np.uint8)) for _ in range(n)]


# ---------------------------------------------------------------------------
# The windowed decision and the prescan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_windowed_terms_and_gate_match_reference(seed):
    rng = np.random.default_rng(seed)
    b, m = int(rng.integers(1, 12)), int(rng.integers(1, 10))
    radix = rng.integers(1, 5, size=(b, m)).astype(np.int32)
    n_var = [int(np.prod(r.astype(np.int64))) for r in radix]
    mn = int(rng.integers(0, 4))
    mx = mn + int(rng.integers(0, 8))
    zero = rng.random(b) < 0.2 if seed % 2 else None
    got = t_em.windowed_chunk_terms(radix, n_var, mn, mx, zero_mask=zero)
    want = j_em.windowed_chunk_terms(radix, n_var, mn, mx, zero_mask=zero)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])
    for sw, sf in ((got[3], got[4]), (5, 10), (6, 10), (0, 0)):
        assert t_em.windowed_gate(sw, sf) == j_em.windowed_gate(sw, sf)
    for force in (None, False, True):
        try:
            want = j_em.windowed_plan_fields(radix, n_var, mn, mx, zero,
                                             force=force)
        except ValueError:
            with pytest.raises(ValueError):
                t_em.windowed_plan_fields(radix, n_var, mn, mx, zero,
                                          force=force)
            continue
        got = t_em.windowed_plan_fields(radix, n_var, mn, mx, zero,
                                        force=force)
        assert got[0] == want[0] and list(got[2]) == list(want[2])


@pytest.mark.parametrize("window", [(0, 15), (1, 2), (2, 2)],
                         ids=["full", "x2", "m2x2"])
@pytest.mark.parametrize("mode", MODES)
def test_prescan_decides_as_the_whole_plan(mode, window):
    """The streamed sweep's prescan (chunks of 7) against this package's
    whole plan and the reference's own prescan: ``out_width``, the
    windowed scheme, the fallback rows and the closed-word count."""
    sub = layout_sub(mode)
    words = words_for() + [b"aqua", b"zwzw", b"mama,;", b"q,;mAQq"]
    words += [b"abcdefghijklmnop"]
    mn, mx = window
    whole = Sweep(AttackSpec(mode=mode, min_substitute=mn, max_substitute=mx),
                  sub, words, (), SweepConfig(device="cpu",
                                              stream_chunk_words="off"))
    streamed = Sweep(AttackSpec(mode=mode, min_substitute=mn,
                                max_substitute=mx), sub, words, (),
                     SweepConfig(device="cpu", stream_chunk_words=7))
    ref = JSweep(JSpec(mode=mode, min_substitute=mn, max_substitute=mx),
                 sub, words, (), JConfig(lanes=256, num_blocks=16,
                                         stream_chunk_words=7))
    st = streamed._stream
    assert whole._stream is None and st is not None
    assert st["out_width"] == whole.plan.out_width == ref._stream["out_width"]
    assert st["windowed"] == bool(whole.plan.windowed) \
        == ref._stream["windowed"]
    assert st["fallback_rows"] == whole.fallback_rows \
        == ref._stream["fallback_rows"]
    assert st["n_closed"] == whole.routing["device_closed"] \
        == ref._stream["n_closed"]
    assert streamed.routing == whole.routing
    assert streamed.fingerprint == whole.fingerprint == ref.fingerprint
    if mode == "default" and window == (1, 2):
        assert st["windowed"]


def test_chunking_helpers_match_reference():
    packed = t_packing.pack_words([b"alpha", b"b", b"gamma", b"delta", b"e"])
    part = t_packing.slice_packed(packed, 1, 4)
    assert part.batch == 3 and list(part.index) == [1, 2, 3]
    assert part.word(0) == b"b" and part.width == packed.width
    for width in (1, 4, 16, 64, 300, 5000):
        assert t_packing.auto_chunk_words(width) == \
            j_packing.auto_chunk_words(width)
    assert t_packing.auto_chunk_words(16) == 65536
    for n, cw in ((10, 3), (9, 3), (1, 7), (0, 4)):
        assert t_packing.chunk_bounds(n, cw) == j_packing.chunk_bounds(n, cw)
    with pytest.raises(ValueError):
        t_packing.chunk_bounds(4, 0)


# ---------------------------------------------------------------------------
# CLI stdout across chunk sizes and against the reference
# ---------------------------------------------------------------------------

_REF: dict = {}


def reference(key, argv, capsysbinary):
    """The reference CLI's stdout (its default: the whole path here)."""
    if key not in _REF:
        rc, out, err = run("j", argv, capsysbinary)
        assert rc == 0, err
        _REF[key] = out
    return _REF[key]


def stream_argv(tmp_path, mode, kind, extra=()):
    argv = write_inputs(tmp_path, mode) + GEOMETRY + list(extra)
    if kind == "crack":
        argv += ["--digests", str(tmp_path / "d.txt")]
    return argv


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("kind", ["crack", "candidates"])
@pytest.mark.parametrize("mode", MODES)
def test_cli_stdout_is_chunk_invariant(mode, kind, chunk, tmp_path,
                                       capsysbinary):
    """Chunks of 1 and 7 words (every word its own chunk; fallback words
    of qwerty-azerty under ``-s`` on either side of chunk boundaries, and
    chunks of fallback words alone) and the whole path print the
    reference CLI's stdout."""
    argv = stream_argv(tmp_path, mode, kind)
    want = reference((mode, kind), argv, capsysbinary)
    rc, got, err = run("t", argv + CHUNKS[chunk], capsysbinary)
    assert rc == 0, err
    assert got == want and want.count(b"\n") >= (5 if kind == "crack"
                                                   else 100)
    if chunk == "off":
        assert "a5gen: stream:" not in err
    else:
        n = 7 if chunk == "chunk-7" else 1
        assert f"chunks x {n} words" in err
    if mode == "suball" and chunk != "off":
        assert "oracle-fallback" in err


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("kind", ["crack", "candidates"])
def test_windowed_plan_is_chunk_invariant(kind, chunk, tmp_path,
                                          capsysbinary):
    """``-m 1 -x 2``: the count-windowed scheme, decided once over the
    whole dictionary and forced on every chunk plan."""
    argv = stream_argv(tmp_path, "default", kind, ["-m", "1", "-x", "2"])
    want = reference(("windowed", kind), argv, capsysbinary)
    rc, got, err = run("t", argv + CHUNKS[chunk], capsysbinary)
    assert rc == 0, err
    assert got == want and want


def test_streamed_sweep_matches_whole_sweep_in_the_library():
    """The library's result: the same hits and counts, the stream stats
    of a streamed run, none on the whole path."""
    sub = layout_sub("default")
    words = words_for()
    digests = [hashlib.md5(c).digest() for w in words[::4]
               for c in list(iter_candidates(w, sub, 1, 15))[:1]]
    res = {}
    for chunk in ("off", 7):
        res[chunk] = Sweep(AttackSpec(), sub, words, digests,
                           SweepConfig(device="cpu", lanes=256,
                                       num_blocks=16,
                                       stream_chunk_words=chunk)).run_crack()
    whole, streamed = res["off"], res[7]
    assert [(h.word_index, h.variant_rank, h.candidate)
            for h in streamed.hits] == [
        (h.word_index, h.variant_rank, h.candidate) for h in whole.hits]
    assert streamed.n_emitted == whole.n_emitted and whole.n_hits > 0
    assert whole.stream == {} and whole.ttfc_s > 0
    s = streamed.stream
    assert s["chunks"] == s["chunks_swept"] == 6 and s["chunk_words"] == 7
    assert 0 < s["ttfc_s"] == streamed.ttfc_s
    assert 0.0 <= s["overlap_ratio"] <= 1.0
    assert s["compile_wall_s"] > 0 and s["chunk_bytes_max"] > 0


# ---------------------------------------------------------------------------
# Resume across packages and paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resumed", ["streaming", "whole"])
@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-writes",
                                                    "torch-writes"])
def test_mid_chunk_checkpoint_resumes_in_the_other_package(
        writer, resumed, tmp_path, capsysbinary, monkeypatch):
    """A streamed crack sweep (chunks of 7, a superstep a launch) killed
    at its 4th consumed fetch, inside a chunk, resumes in the other
    package's CLI, streamed or whole, to the reference's uninterrupted
    stdout."""
    argv = stream_argv(tmp_path, "default", "crack", ["--superstep", "1"])
    want = reference(("default", "crack-ss1"), argv, capsysbinary)
    ck = tmp_path / "ck.json"
    ck_opts = ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    part = killed(writer, argv + CHUNKS["chunk-7"] + ck_opts,
                  "superstep.fetch:nth=4,error=OSError", capsysbinary,
                  monkeypatch)
    man = json.loads(ck.read_text())
    doc = json.loads((ck.parent / man["buckets"]["16"]["file"]).read_text())
    cur = doc["cursor"]
    assert cur["word"] % 7 or cur["rank"], "the kill fell on a chunk edge"
    assert len(part) < len(want)
    then = CHUNKS["chunk-7" if resumed == "streaming" else "off"]
    rc, got, err = run(OTHER[writer], argv + then + ck_opts, capsysbinary)
    assert rc == 0, err
    assert got == want


def test_library_checkpoint_carries_the_chunk_marker(tmp_path):
    """A streamed run's checkpoint holds the reference's ``stream`` marker
    and the global cursor; the progress lines report the chunk; a whole
    run resumes the file and drops the marker."""
    sub = layout_sub("default")
    words = words_for()
    path = str(tmp_path / "ck.json")
    buf = io.StringIO()
    cfg = SweepConfig(device="cpu", lanes=256, num_blocks=16,
                      stream_chunk_words=7, checkpoint_path=path,
                      checkpoint_every_s=0.0,
                      progress=ProgressReporter(len(words), every_s=0.0,
                                                stream=buf))
    sweep = Sweep(AttackSpec(), sub, words, [bytes(16)], cfg)
    res = sweep.run_crack()
    doc = load_checkpoint(path, sweep.fingerprint)
    assert doc.stream == {"chunk": 5, "chunk_words": 7}
    assert doc.cursor.word == len(words)
    markers = [json.loads(ln)["progress"].get("stream")
               for ln in buf.getvalue().splitlines()]
    assert {"chunk": 0, "chunk_words": 7} in markers
    assert res.stream["chunks_swept"] == 6
    whole = Sweep(AttackSpec(), sub, words, [bytes(16)],
                  SweepConfig(device="cpu", lanes=256, num_blocks=16,
                              stream_chunk_words="off",
                              checkpoint_path=path))
    assert whole.fingerprint == sweep.fingerprint
    assert whole._load_state(True).stream is None


# ---------------------------------------------------------------------------
# The ring: bounded, released, recovering once
# ---------------------------------------------------------------------------


def test_compiler_ring_caps_outstanding_chunks():
    live, peak = [0], [0]

    def compile_fn(ci, lo, hi):
        live[0] += 1
        peak[0] = max(peak[0], live[0])

        def releaser(chunk):
            live[0] -= 1

        return t_packing.PlanChunk(index=ci, lo=lo, hi=hi, releaser=releaser)

    bounds = t_packing.chunk_bounds(10, 2)
    compiler = t_packing.ChunkCompiler(compile_fn, bounds, prefetch=1)
    seen = []
    for chunk in compiler:
        seen.append((chunk.index, chunk.lo, chunk.hi))
        chunk.release()
        chunk.release()  # exactly once
    compiler.close()
    assert seen == [(i, lo, hi) for i, (lo, hi) in enumerate(bounds)]
    assert live[0] == 0 and peak[0] <= 3
    assert len(compiler.windows) == 5


def test_sweep_releases_every_chunk_and_bounds_resident_plan(monkeypatch):
    released = []
    real = Sweep._release_chunk

    def counting(self, chunk):
        released.append(chunk.index)
        real(self, chunk)

    monkeypatch.setattr(Sweep, "_release_chunk", counting)
    sub = layout_sub("default")
    res = Sweep(AttackSpec(), sub, words_for(), [bytes(16)],
                SweepConfig(device="cpu", lanes=256, num_blocks=16,
                            superstep=0, stream_chunk_words=3)).run_crack()
    s = res.stream
    assert released == list(range(s["chunks"])) and s["chunks"] == 14
    assert s["peak_resident_plan_bytes"] <= s["ring"] * s["chunk_bytes_max"]
    assert s["peak_resident_plan_bytes"] > 0


def test_compiler_propagates_worker_errors_after_one_restart():
    calls = []

    def compile_fn(ci, lo, hi):
        calls.append(ci)
        raise RuntimeError("schema exploded")

    compiler = t_packing.ChunkCompiler(compile_fn,
                                       t_packing.chunk_bounds(4, 2))
    with pytest.raises(RuntimeError, match="schema exploded"):
        next(iter(compiler))
    compiler.close()
    assert calls[:2] == [0, 0]


def test_chunk_compile_fault_recovers_once(tmp_path, capsysbinary,
                                           monkeypatch):
    """``chunk.compile`` fails once (the 3rd chunk): the ring restarts its
    worker and the stdout is the reference's; failing at every call, the
    run ends with the error after one restart — it never moves to the
    CPU or drops the chunk."""
    argv = stream_argv(tmp_path, "suball", "crack")
    want = reference(("suball", "crack"), argv, capsysbinary)
    before = telemetry.counter("faults.worker_restarts").value
    monkeypatch.setenv("A5GEN_FAULTS", "chunk.compile:nth=3")
    rc, got, err = run("t", argv + CHUNKS["chunk-7"], capsysbinary)
    t_faults.clear()
    assert rc == 0, err
    assert got == want
    assert telemetry.counter("faults.worker_restarts").value == before + 1
    monkeypatch.setenv("A5GEN_FAULTS", "chunk.compile:nth=2,persist")
    rc, got, err = run("t", argv + CHUNKS["chunk-7"], capsysbinary)
    for f in (t_faults, j_faults):
        f.clear()
    assert rc == 1 and "injected fault" in err
    assert telemetry.counter("faults.worker_restarts").value == before + 2


# ---------------------------------------------------------------------------
# The escape hatch
# ---------------------------------------------------------------------------


def test_env_off_pins_the_whole_path(monkeypatch):
    sub = layout_sub("default")
    cfg = SweepConfig(device="cpu", lanes=256, num_blocks=16,
                      stream_chunk_words=3)
    assert Sweep(AttackSpec(), sub, words_for(), (), cfg)._stream
    monkeypatch.setenv("A5GEN_STREAM", "off")
    sweep = Sweep(AttackSpec(), sub, words_for(), [bytes(16)], cfg)
    assert sweep._stream is None and sweep.plan is not None
    assert sweep.run_crack().stream == {}


def test_env_typo_warns_and_keeps_streaming(monkeypatch, capsys):
    monkeypatch.setenv("A5GEN_STREAM", "offf")
    assert t_env.stream_enabled()
    assert "A5GEN_STREAM" in capsys.readouterr().err


def test_auto_streams_past_one_auto_chunk(monkeypatch):
    """``auto``: a dictionary of more than ``auto_chunk_words`` words
    streams, one that fits keeps the whole path; bad values raise."""
    sub = layout_sub("default")
    words = words_for(12)
    cfg = SweepConfig(device="cpu")
    assert Sweep(AttackSpec(), sub, words, (), cfg)._stream is None
    import hashcat_a5_table_generator_tpu_torch.runtime.sweep as t_sweep

    monkeypatch.setattr(t_sweep, "auto_chunk_words", lambda width: 5)
    st = Sweep(AttackSpec(), sub, words, (), cfg)._stream
    assert st["chunk_words"] == 5 and len(st["bounds"]) == 3
    with pytest.raises(ValueError):
        Sweep(AttackSpec(), sub, words, (),
              SweepConfig(device="cpu", stream_chunk_words=0.5))


def test_candidates_library_stream_is_chunk_invariant():
    sub = layout_sub("suball")
    words = words_for() + [b"aqua", b"m;", b"zwzw", b"m,;"]
    outs = []
    for chunk in ("off", 1, 4):
        buf = io.BytesIO()
        with CandidateWriter(stream=buf) as writer:
            Sweep(AttackSpec(mode="suball"), sub, words, (),
                  SweepConfig(device="cpu", lanes=256, num_blocks=16,
                              stream_chunk_words=chunk)
                  ).run_candidates(writer)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2] and outs[0]
