"""The sweep's telemetry in the PyTorch/CUDA package against the JAX
reference's, on the CPU: the registry, histogram, ``delta`` and
``SpanTimeline`` arithmetic; ``--metrics-json`` with the reference's
document, counter names and span summaries, ``sweep.candidates`` equal to
the candidates hashed; ``--progress`` lines with the reference's keys;
``A5GEN_TELEMETRY=off`` honoured; and ``--profile``'s trace holding the
consumed supersteps' ranges."""

import json
import re

import pytest
from test_torch_resume_cli import GEOMETRY_ARGV, run, write_inputs

import hashcat_a5_table_generator_tpu.runtime.telemetry as j_tel
import hashcat_a5_table_generator_tpu_torch.runtime.telemetry as t_tel


class Clock:
    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def test_registry_and_delta_equal_reference(monkeypatch):
    monkeypatch.setenv("A5GEN_TELEMETRY", "on")
    snaps = []
    for tel in (t_tel, j_tel):
        reg = tel.MetricsRegistry()
        reg.counter("a").add(3)
        reg.counter("a").add(0.5)
        reg.gauge("g", "max").set(7)
        h = reg.histogram("h")
        for v in (1e-6, 1e-5, 3e-3, 0.5, 99.0):
            h.observe(v)
        before = reg.snapshot()
        reg.counter("a").add(2)
        reg.counter("b").add(1)
        h.observe(0.01)
        snaps.append((before, reg.snapshot(),
                      tel.delta(before, reg.snapshot())))
        with pytest.raises(TypeError):
            reg.gauge("a")
    assert snaps[0] == snaps[1]
    assert snaps[0][2]["a"] == {"type": "counter", "value": 2}


def test_span_timeline_equals_reference(monkeypatch):
    monkeypatch.setenv("A5GEN_TELEMETRY", "on")
    out = []
    for tel in (t_tel, j_tel):
        tl = tel.SpanTimeline(capacity=3,
                              clock=Clock([1.0, 1.5, 2.5, 2.75, 4.0]))
        for i, inflight in enumerate((1, 1, 0, 1, 0)):
            tl.record_fetch(kind="superstep", index=i, inflight=inflight,
                            launches=16, emitted=100, hits=i,
                            hit_occupancy=0.25 * i, replayed=i == 2)
        out.append((tl.summary(), tl.spans()))
    assert out[0] == out[1]
    summary = out[0][0]
    assert summary["spans"] == 5 and summary["dropped"] == 2
    assert summary["dead_share"] == round((1.0 + 1.25) / 3.0, 4)


def crack_run(pkg, tmp_path, capsysbinary, extra):
    """A crack run of ``pkg``: ``(stdout, stderr, metrics document)``,
    the document's metrics this run's share of the process registry
    (``delta``)."""
    tel = j_tel if pkg == "j" else t_tel
    before = tel.snapshot()
    argv = write_inputs(tmp_path, "default") + [
        "--digests", str(tmp_path / "d.txt"), *GEOMETRY_ARGV,
        "--superstep", "2", *extra]
    metrics = tmp_path / f"{pkg}-m.json"
    rc, out, err = run(pkg, argv + ["--metrics-json", str(metrics),
                                    "--checkpoint",
                                    str(tmp_path / f"{pkg}-ck.json"),
                                    "--checkpoint-every", "0"],
                       capsysbinary)
    assert rc == 0, err
    doc = json.loads(metrics.read_text())
    doc["metrics"] = tel.delta(before, doc["metrics"])
    return out, err, doc


COUNTERS = ("checkpoint.saves", "checkpoint.bytes_written",
            "sweep.launches", "sweep.candidates", "sweep.hits",
            "sweep.fetches.superstep", "sweep.host_gap_s",
            "sweep.dead_host_s")


def test_metrics_json_has_the_reference_document(tmp_path, capsysbinary,
                                                 monkeypatch):
    monkeypatch.delenv("A5GEN_TELEMETRY", raising=False)
    got = crack_run("t", tmp_path, capsysbinary, [])
    want = crack_run("j", tmp_path, capsysbinary, [])
    assert got[0] == want[0]
    doc, ref = got[2], want[2]
    assert set(doc) == set(ref) == {"metrics", "spans"}
    for name in COUNTERS:
        assert doc["metrics"][name]["type"] == ref["metrics"][name]["type"]
    assert doc["metrics"]["sweep.fetch_gap_s"]["type"] == "histogram"
    for name in ("sweep.candidates", "sweep.hits", "checkpoint.saves",
                 "sweep.fetches.superstep"):
        assert doc["metrics"][name]["value"] == \
            ref["metrics"][name]["value"], name
    emitted = int(re.search(r"(\d+) candidates hashed", got[1]).group(1))
    assert doc["metrics"]["sweep.candidates"]["value"] == emitted
    assert set(doc["spans"]) == set(ref["spans"]) == {"w16", "w32"}
    for width, summary in doc["spans"].items():
        assert set(summary) == set(ref["spans"][width])
        assert summary["spans"] == ref["spans"][width]["spans"]


def test_progress_lines_have_the_reference_keys(tmp_path, capsysbinary):
    # The progress fields read the process registries: start both empty,
    # so an earlier test's schema-cache or ring counters do not show.
    for tel in (t_tel, j_tel):
        tel.REGISTRY.reset()
    lines = {}
    for pkg in ("t", "j"):
        _out, err, _doc = crack_run(pkg, tmp_path, capsysbinary,
                                    ["--progress"])
        lines[pkg] = [json.loads(ln)["progress"] for ln in err.splitlines()
                      if ln.startswith('{"progress"')]
    assert lines["t"] and lines["j"]
    last_t, last_j = lines["t"][-1], lines["j"][-1]
    assert set(last_t) == set(last_j)
    for key in ("words", "candidates", "hits", "routing"):
        assert last_t[key] == last_j[key], key
    # The enrichment's fields appear only with signal: the port has no
    # compiled-step cache, so its step_cache_hit_rate never does.
    assert "dead_share" in last_t["telemetry"]
    assert set(last_t["telemetry"]) == set(last_j["telemetry"]) - {
        "step_cache_hit_rate"}


def test_telemetry_off_is_honoured(tmp_path, capsysbinary, monkeypatch):
    monkeypatch.setenv("A5GEN_TELEMETRY", "off")
    out, err, doc = crack_run("t", tmp_path, capsysbinary, ["--progress"])
    assert out
    assert all(v == {} for v in doc["spans"].values())
    # No hot-path instrument recorded; the document still lands.
    assert not [k for k in doc["metrics"]
                if k.startswith(("sweep.", "checkpoint."))]
    bodies = [json.loads(ln)["progress"] for ln in err.splitlines()
              if ln.startswith('{"progress"')]
    assert bodies and all("telemetry" not in b for b in bodies)


def test_profile_trace_holds_the_consumed_supersteps(tmp_path,
                                                     capsysbinary):
    crack_run("t", tmp_path, capsysbinary,
              ["--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("a5.superstep.consume") >= 2
