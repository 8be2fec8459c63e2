"""The resident engine (``runtime/engine.py``) and ``a5gen serve``, against
the reference, on the CPU.

Counterparts of the reference's ``tests/test_engine.py`` classes: a solo
job through the engine is byte-identical to ``run_crack`` /
``run_candidates`` (and to the reference's solo sweep) in 4 modes;
multiplexed jobs keep per-job attribution and warm jobs build no new
step closure; pause, resume and cancel ride the checkpoint state; the
JSONL service over stdin and a unix socket.  Then across packages: for
the same JSONL job documents, each job's ``hit`` / ``done`` / ``error``
events from the port's ``serve_stdio`` equal the reference's, per job id
(the interleaving across jobs is not compared), in 4 modes and a
byte-scan session (german's ``ss=ß`` on "sss" words) with packing on and
off; the byte-scan tenants' packing numbers (fused groups, packed
dispatches, fill) equal the reference engine's; a job paused in one
package's engine resumes in the other's from its ``paused`` checkpoint
to the solo stream; ``a5gen serve`` run as a subprocess of each package
gives the same per-job events; without a GPU, the port's ``a5gen serve``
exits non-zero instead of serving on the CPU.
"""

import hashlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import pytest
from test_torch_pack import (
    LEET,
    SPEC,
    WORDS,
    cfg,
    full_hits,
    planted_digests,
)

from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime.checkpoint import (
    state_from_doc as j_state_from_doc,
)
from hashcat_a5_table_generator_tpu.runtime.checkpoint import (
    state_to_doc as j_state_to_doc,
)
from hashcat_a5_table_generator_tpu.runtime.engine import Engine as JEngine
from hashcat_a5_table_generator_tpu.runtime.engine import (
    serve_stdio as j_serve_stdio,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
    CheckpointState,
    SweepCursor,
    state_from_doc,
    state_to_doc,
)
from hashcat_a5_table_generator_tpu_torch.runtime.engine import (
    Engine,
    JobFailed,
    serve_socket,
    serve_stdio,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import CandidateWriter
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import Sweep
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

REPO = pathlib.Path(__file__).resolve().parent.parent
LONG_WORDS = WORDS * 4
MODES = ("default", "reverse", "suball", "suball-reverse")
TABLE_MAP = {k.decode(): [v.decode() for v in vs] for k, vs in LEET.items()}
#: The byte-scan session: german's ``ss=ß`` on words with "sss" (no piece
#: schema: byte-scan row 7), default mode; the tenants are rotations of
#: one list, so whichever two of them fuse, the group's fill is the same.
GERMAN = get_layout("german").to_substitution_map()
GERMAN_MAP = {k.decode(): [v.decode() for v in vs]
              for k, vs in GERMAN.items()}
GERMAN_WORDS = [b"schlosssee", b"strasse", b"mutter", b"flussstrand",
                b"messstation", b"fitnessstudio", b"passstrasse", b"ausgang",
                b"grosssegel", b"zuckertuete"] * 2


def jcfg(**kw):
    return JConfig(lanes=64, num_blocks=16, **kw)


# ---------------------------------------------------------------------------
# The reference's tests/test_engine.py classes, on the port
# ---------------------------------------------------------------------------


class TestSoloParity:
    @pytest.mark.parametrize("mode", MODES)
    def test_crack_parity(self, mode):
        spec = AttackSpec(mode=mode)
        _p, digests = planted_digests(spec, WORDS, (0, 7, -1))
        want = Sweep(spec, LEET, WORDS, digests, config=cfg()).run_crack()
        ref = JSweep(JSpec(mode=mode), LEET, WORDS, digests,
                     jcfg()).run_crack()
        assert full_hits(want) == full_hits(ref)
        eng = Engine(cfg(), auto=False)
        job = eng.submit(spec, LEET, WORDS, digests)
        eng.run_until_idle()
        got = job.result(timeout=0)
        assert full_hits(got) == full_hits(want)
        assert got.n_emitted == want.n_emitted == ref.n_emitted
        assert got.routing == want.routing

    def test_streaming_crack_parity(self):
        _p, digests = planted_digests(SPEC, WORDS, (0, -1))
        c = cfg(stream_chunk_words=2)
        want = Sweep(SPEC, LEET, WORDS, digests, config=c).run_crack()
        assert want.stream["chunks_swept"] == 3
        eng = Engine(c, auto=False)
        job = eng.submit(SPEC, LEET, WORDS, digests)
        eng.run_until_idle()
        got = job.result(timeout=0)
        assert full_hits(got) == full_hits(want)
        assert got.n_emitted == want.n_emitted
        assert got.stream["chunks_swept"] == 3

    def test_candidates_byte_parity(self):
        want = io.BytesIO()
        with CandidateWriter(stream=want) as w:
            Sweep(SPEC, LEET, WORDS, config=cfg()).run_candidates(w)
        got = io.BytesIO()
        eng = Engine(cfg(), auto=False)
        job = eng.submit(SPEC, LEET, WORDS, kind="candidates",
                         writer=CandidateWriter(stream=got))
        eng.run_until_idle()
        res = job.result(timeout=0)
        job._submit_args["writer"].close()
        assert got.getvalue() == want.getvalue()
        assert res.n_emitted > 0

    def test_windowed_crack_parity(self):
        spec = AttackSpec(min_substitute=1, max_substitute=1)
        _p, digests = planted_digests(spec, WORDS, (0, -1))
        sweep = Sweep(spec, LEET, WORDS, digests, config=cfg())
        assert sweep.plan.windowed
        want = sweep.run_crack()
        eng = Engine(cfg(), auto=False)
        job = eng.submit(spec, LEET, WORDS, digests)
        eng.run_until_idle()
        assert full_hits(job.result(timeout=0)) == full_hits(want)


class TestMultiplexing:
    def test_two_jobs_interleave_at_superstep_boundaries(self):
        _p1, d1 = planted_digests(SPEC, LONG_WORDS, (0, 5))
        words2 = LONG_WORDS[::-1]
        _p2, d2 = planted_digests(SPEC, words2, (1, -1))
        c = cfg(superstep=1)
        want1 = Sweep(SPEC, LEET, LONG_WORDS, d1, config=c).run_crack()
        want2 = Sweep(SPEC, LEET, words2, d2, config=c).run_crack()
        eng = Engine(c, auto=False, pack=False)
        j1 = eng.submit(SPEC, LEET, LONG_WORDS, d1)
        j2 = eng.submit(SPEC, LEET, words2, d2)
        eng._admit()
        assert len(eng._active) == 2
        eng._serve_round()
        assert j1.state == "running" and j2.state == "running"
        assert len({s.group for s in eng._active}) == 1
        eng.run_until_idle()
        assert full_hits(j1.result(timeout=0)) == full_hits(want1)
        assert full_hits(j2.result(timeout=0)) == full_hits(want2)
        assert eng.stats()["supersteps_served"] > 2

    def test_warm_jobs_compile_no_new_programs(self):
        """After one job of a config has run, equal jobs build no new step
        closure and load no new library: they ride the step cache."""
        _p, digests = planted_digests(SPEC, WORDS, (0,))
        eng = Engine(cfg(), auto=False, pack=False)
        first = eng.submit(SPEC, LEET, WORDS, digests)
        eng.run_until_idle()
        first.result(timeout=0)
        compiled = eng.stats()["programs_compiled"]
        jobs = [eng.submit(SPEC, LEET, WORDS, digests) for _ in range(3)]
        eng.run_until_idle()
        for j in jobs:
            assert j.result(timeout=0).n_hits == first.result(0).n_hits
        stats = eng.stats()
        assert stats["programs_compiled"] == compiled
        assert stats["program_cache_hits"] >= 3
        assert stats["jobs_done"] == 4

    def test_async_hit_delivery(self):
        _p, digests = planted_digests(SPEC, WORDS, (0, 3, -1))
        eng = Engine(cfg())
        try:
            job = eng.submit(SPEC, LEET, WORDS, digests)
            got = list(job.iter_hits())
            res = job.result(timeout=30)
            assert [(h.word_index, h.variant_rank) for h in got] == \
                [(h.word_index, h.variant_rank) for h in res.hits]
            assert len(got) == res.n_hits > 0
        finally:
            eng.close()


class TestTenantOps:
    def test_pause_checkpoint_resume_on_second_engine(self):
        _p, digests = planted_digests(SPEC, LONG_WORDS, (0, 5, -1))
        c = cfg(superstep=1)
        want = Sweep(SPEC, LEET, LONG_WORDS, digests, config=c).run_crack()
        eng_a = Engine(c, auto=False)
        job = eng_a.submit(SPEC, LEET, LONG_WORDS, digests)
        eng_a._admit()
        eng_a._serve_round()
        eng_a._serve_round()
        job.request_pause()
        eng_a._serve_round()
        assert job.state == "paused"
        ck = job.checkpoint
        assert (ck.cursor.word, ck.cursor.rank) > (0, 0)
        assert ck.cursor.word < len(LONG_WORDS)
        eng_b = Engine(c, auto=False)
        job2 = eng_b.submit(SPEC, LEET, LONG_WORDS, digests,
                            resume_state=ck)
        eng_b.run_until_idle()
        got = job2.result(timeout=0)
        assert got.resumed
        assert full_hits(got) == full_hits(want)
        assert got.n_emitted == want.n_emitted

    def test_pause_round_trips_through_json(self):
        state = CheckpointState(
            fingerprint="fp", cursor=SweepCursor(3, 10 ** 25),
            n_emitted=7, n_hits=1, hits=[(2, 10 ** 24)], fallback_done=1,
            wall_s=0.5, stream={"chunk": 2, "chunk_words": 4})
        doc = json.loads(json.dumps(state_to_doc(state)))
        assert state_from_doc(doc) == state
        assert json.dumps(state_to_doc(state)) == json.dumps(
            j_state_to_doc(j_state_from_doc(doc)))

    def test_resume_same_engine(self):
        _p, digests = planted_digests(SPEC, LONG_WORDS, (0, -1))
        c = cfg(superstep=1)
        want = Sweep(SPEC, LEET, LONG_WORDS, digests, config=c).run_crack()
        eng = Engine(c, auto=False)
        job = eng.submit(SPEC, LEET, LONG_WORDS, digests)
        eng._admit()
        eng._serve_round()
        job.request_pause()
        eng._serve_round()
        assert job.state == "paused"
        job2 = eng.resume(job)
        assert job2.id == job.id
        eng.run_until_idle()
        assert full_hits(job2.result(timeout=0)) == full_hits(want)

    def test_cancel_mid_superstep_keeps_other_tenants(self):
        _p, digests = planted_digests(SPEC, LONG_WORDS, (0, -1))
        c = cfg(superstep=1)
        want_other = Sweep(SPEC, LEET, WORDS, digests, config=c).run_crack()
        eng = Engine(c, auto=False)
        victim = eng.submit(SPEC, LEET, LONG_WORDS, digests)
        other = eng.submit(SPEC, LEET, WORDS, digests)
        eng._admit()
        eng._serve_round()
        assert victim.state == "running"
        victim.cancel()
        eng.run_until_idle()
        assert victim.state == "cancelled"
        with pytest.raises(Exception):
            victim.result(timeout=0)
        assert full_hits(other.result(timeout=0)) == full_hits(want_other)
        assert eng.stats()["jobs_cancelled"] == 1

    def test_pause_before_first_tick_hands_back_origin_checkpoint(self):
        _p, digests = planted_digests(SPEC, WORDS, (0, -1))
        want = Sweep(SPEC, LEET, WORDS, digests, config=cfg()).run_crack()
        eng = Engine(cfg(), auto=False)
        job = eng.submit(SPEC, LEET, WORDS, digests)
        eng._admit()
        job.request_pause()
        eng._serve_round()
        assert job.state == "paused"
        ck = job.checkpoint
        assert (ck.cursor.word, ck.cursor.rank) == (0, 0) and ck.fingerprint
        json.dumps(state_to_doc(ck))
        eng2 = Engine(cfg(), auto=False)
        job2 = eng2.submit(SPEC, LEET, WORDS, digests, resume_state=ck)
        eng2.run_until_idle()
        assert full_hits(job2.result(timeout=0)) == full_hits(want)

    def test_resume_fingerprint_mismatch_fails_loudly(self):
        _p, digests = planted_digests(SPEC, WORDS, (0,))
        eng = Engine(cfg(), auto=False)
        bad = CheckpointState(fingerprint="not-this-sweep")
        job = eng.submit(SPEC, LEET, WORDS, digests, resume_state=bad)
        eng.run_until_idle()
        assert job.state == "failed"
        with pytest.raises(JobFailed) as exc:
            job.result(timeout=0)
        assert "different sweep" in str(exc.value.__cause__)


def _submit_doc(jid, words, digests, mode="default", **extra):
    return {"op": "submit", "id": jid, "words": [w.decode() for w in words],
            "table_map": TABLE_MAP, "algo": "md5", "mode": mode,
            "digest_list": [d.hex() for d in digests], **extra}


def _session(serve, engine, docs, n_settle, timeout=90):
    """Feed ``docs`` (then shutdown) through ``serve``; wait for
    ``n_settle`` settling events; the parsed event list."""
    reqs = io.StringIO("".join(json.dumps(d) + "\n" for d in docs)
                       + '{"op": "shutdown"}\n')
    out = io.StringIO()
    serve(engine, reqs, out)
    deadline = time.monotonic() + timeout
    settle = ('"done"', '"paused"', '"cancelled"', '"failed"')
    while time.monotonic() < deadline:
        if sum(out.getvalue().count(s) for s in settle) >= n_settle:
            break
        time.sleep(0.05)
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.strip()]


class TestJsonlService:
    def test_stdin_session_submit_hit_done(self):
        planted, digests = planted_digests(SPEC, WORDS, (3,), decoys=22)
        eng = Engine(cfg())
        try:
            events = _session(serve_stdio, eng, [
                _submit_doc("t1", WORDS, digests), {"op": "stats"},
                {"op": "metrics"}], 1)
        finally:
            eng.close()
        by = {}
        for e in events:
            by.setdefault(e["event"], []).append(e)
        assert by["accepted"][0] == {"id": "t1", "event": "accepted",
                                     "kind": "crack"}
        (hit,) = by["hit"]
        assert bytes.fromhex(hit["plain_hex"]) == planted[0]
        (done,) = by["done"]
        assert done["n_hits"] == 1 and done["n_emitted"] > 0
        assert "jobs_submitted" in by["stats"][0]
        assert "programs_compiled" in by["stats"][0]
        metrics = by["metrics"][0]
        assert "engine.jobs_submitted" in metrics["metrics"]
        assert "# TYPE a5gen_engine_jobs_submitted counter" in \
            metrics["prometheus"]
        assert by["bye"]

    def test_bad_job_and_router_ops_report_errors(self):
        """A bad submit, an unknown op and the router-only ops (split,
        drain, migrate) get the reference engine's own ``error`` events;
        the session keeps serving."""
        docs = [{"op": "submit", "id": "x"}, {"op": "nope", "id": "x"},
                {"op": "split", "id": "x"}, {"op": "drain", "engine": "e"},
                {"op": "migrate", "id": "x"}]
        outs = {}
        for name, mk, serve in (("t", Engine, serve_stdio),
                                ("j", JEngine, j_serve_stdio)):
            eng = mk(cfg() if name == "t" else jcfg())
            try:
                outs[name] = _session(serve, eng, docs, 0, timeout=0)
            finally:
                eng.close()
        assert outs["t"] == outs["j"]
        assert [e["event"] for e in outs["t"]] == ["error"] * 5 + ["bye"]

    def test_unix_socket_session(self, tmp_path):
        planted, _d = planted_digests(SPEC, [b"password"], (3,))
        dig = planted_digests(SPEC, [b"password"], (3,), decoys=0)[1][0]
        path = str(tmp_path / "a5.sock")
        eng = Engine(cfg())
        ready = threading.Event()
        th = threading.Thread(target=serve_socket, args=(eng, path),
                              kwargs={"ready": ready.set,
                                      "client_timeout": 30}, daemon=True)
        th.start()
        try:
            assert ready.wait(10)
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            probe.connect(path)
            probe.close()
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(path)
                fin = s.makefile("r", encoding="utf-8")
                fout = s.makefile("w", encoding="utf-8")
                fout.write(json.dumps(_submit_doc("s1", [b"password"],
                                                  [dig])) + "\n")
                fout.flush()
                got = [json.loads(fin.readline()) for _ in range(3)]
                assert [e["event"] for e in got] == ["accepted", "hit",
                                                     "done"]
                assert bytes.fromhex(got[1]["plain_hex"]) == planted[0]
                fout.write('{"op":"metrics"}\n{"op":"shutdown"}\n')
                fout.flush()
                m = json.loads(fin.readline())
                assert m["event"] == "metrics"
                assert json.loads(fin.readline()) == {"event": "bye"}
            th.join(10)
            assert not th.is_alive()
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------


def _per_job(events):
    """Each job's hit / done / error events, in order, without the wall
    time fields."""
    out = {}
    for e in events:
        if e["event"] in ("hit", "done", "error", "failed", "cancelled"):
            e = {k: v for k, v in e.items()
                 if k not in ("wall_s", "ttfc_s", "spans", "schema_cache")}
            out.setdefault(e.get("id"), []).append(e)
    return out


def _german_digests(words, i):
    """Every third word's middle candidate and a tenant decoy."""
    digests = []
    for w in words[i::3]:
        cands = list(iter_candidates(w, GERMAN, 1, 15))
        digests.append(hashlib.md5(cands[len(cands) // 2]).digest())
    return digests + [hashlib.md5(b"german-%d" % i).digest()]


def _jobs_for(mode):
    """Three tenants and a malformed submit; ``mode`` ``"german"`` is the
    byte-scan session (:data:`GERMAN_WORDS`)."""
    docs = []
    if mode == "german":
        for i in range(3):
            ws = GERMAN_WORDS[3 * i:] + GERMAN_WORDS[:3 * i]
            docs.append(_submit_doc(f"german-{i}", ws,
                                    _german_digests(ws, i),
                                    table_map=GERMAN_MAP))
    else:
        spec = AttackSpec(mode=mode)
        words = LONG_WORDS
        for i, ws in enumerate((words, words[::-1], words[2:] + words[:2])):
            _p, dig = planted_digests(spec, ws, (0, 3 + i, -1), decoys=3)
            docs.append(_submit_doc(f"{mode}-{i}", ws, dig, mode=mode))
    docs.append({"op": "submit", "id": f"{mode}-bad", "words": ["a"]})
    return docs


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("mode", MODES + ("german",))
def test_serve_stdio_events_equal_reference(mode, pack):
    docs = _jobs_for(mode)
    if mode == "german":
        assert Sweep(AttackSpec(), GERMAN, GERMAN_WORDS, [bytes(16)],
                     config=cfg(superstep=1)).route == "bytescan"
    got = {}
    for name, mk, c, serve in (("t", Engine, cfg(superstep=1), serve_stdio),
                               ("j", JEngine, jcfg(superstep=1),
                                j_serve_stdio)):
        eng = mk(c, pack=pack)
        try:
            got[name] = _per_job(_session(serve, eng, docs, 3))
        finally:
            eng.close()
    assert got["t"] == got["j"]
    assert len(got["t"]) == 4
    assert all(any(e["event"] == "hit" for e in got["t"][d["id"]])
               for d in docs[:3])


def test_bytescan_packing_stats_equal_reference():
    """Byte-scan tenants pack as the reference's do: the german session's
    three tenants admitted together into each package's engine give the
    same ``fused_groups`` (two of them fused: 16 blocks do not split in
    three), ``packed_dispatches`` and ``packed_fill``, and the same
    per-job streams."""
    docs = _jobs_for("german")[:3]
    stats, hits = {}, {}
    for name, mk, c, spec in (("t", Engine, cfg(superstep=1), AttackSpec()),
                              ("j", JEngine, jcfg(superstep=1), JSpec())):
        eng = mk(c, auto=False)
        handles = [eng.submit(spec, GERMAN, [w.encode() for w in
                                             d["words"]],
                              [bytes.fromhex(x) for x in d["digest_list"]])
                   for d in docs]
        eng._admit()
        fused = eng.stats()["fused_groups"]
        eng.run_until_idle()
        st = eng.stats()
        stats[name] = (fused, st["packed_dispatches"], st["packed_fill"])
        hits[name] = [full_hits(h.result(timeout=0)) for h in handles]
        eng.close()
    assert stats["t"] == stats["j"]
    assert stats["t"][0] == 1 and stats["t"][1] > 0
    assert hits["t"] == hits["j"]
    assert all(hits["t"])


@pytest.mark.parametrize("first", ["t", "j"])
def test_pause_in_one_package_resumes_in_the_other(first):
    """A job paused in one package's engine (its ``paused`` checkpoint
    document) is submitted with ``checkpoint`` to the other package's
    serve session: the hits before the pause plus those after are the
    solo stream."""
    _p, digests = planted_digests(SPEC, LONG_WORDS, (0, 5, 11, -1))
    want = Sweep(SPEC, LEET, LONG_WORDS, digests,
                 config=cfg(superstep=1)).run_crack()
    mk = {"t": (Engine, cfg(superstep=1), state_to_doc, serve_stdio),
          "j": (JEngine, jcfg(superstep=1), j_state_to_doc, j_serve_stdio)}
    eng_cls, c, to_doc, _serve = mk[first]
    eng = eng_cls(c, auto=False)
    job = eng.submit(SPEC if first == "t" else JSpec(), LEET, LONG_WORDS,
                     digests)
    eng._admit()
    for _ in range(3):
        eng._serve_round()
    job.request_pause()
    eng._serve_round()
    assert job.state == "paused"
    before = []
    while not job._hits.empty():
        h = job._hits.get_nowait()
        if hasattr(h, "word_index"):
            before.append((h.word_index, str(h.variant_rank)))
    doc = to_doc(job.checkpoint)
    eng.close()
    other = "j" if first == "t" else "t"
    eng_cls, c, _to_doc, serve = mk[other]
    eng2 = eng_cls(c)
    try:
        events = _session(serve, eng2, [_submit_doc(
            "m", LONG_WORDS, digests, checkpoint=json.loads(
                json.dumps(doc)), replay_mute=len(before))], 1)
    finally:
        eng2.close()
    after = [(e["word_index"], e["rank"]) for e in events
             if e["event"] == "hit"]
    (done,) = [e for e in events if e["event"] == "done"]
    assert done["resumed"] is True
    assert done["n_hits"] == want.n_hits
    assert done["n_emitted"] == want.n_emitted
    assert before + after == [(h.word_index, str(h.variant_rank))
                              for h in want.hits]


def _serve_subprocess(pkg, docs, n_settle, extra=(), timeout=120):
    """``a5gen serve`` of one package in a subprocess: ``docs`` on its
    stdin, which stays open until ``n_settle`` jobs settled (then EOF
    ends the session); ``(exit code, stderr, parsed stdout events)``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", A5GEN_TUNE_PROFILE="off",
               PYTHONPATH=str(REPO))
    env.pop("A5GEN_FAULTS", None)
    if pkg == "j":
        code = ("import sys, jax; jax.config.update('jax_platforms', 'cpu');"
                "from hashcat_a5_table_generator_tpu.cli import main;"
                "sys.exit(main(sys.argv[1:]))")
    else:
        code = ("import sys; from hashcat_a5_table_generator_tpu_torch.cli "
                "import main; sys.exit(main(sys.argv[1:]))")
    argv = [sys.executable, "-c", code, "serve", "--lanes", "64",
            "--blocks", "16", "--superstep", "1", *extra]
    if pkg == "t":
        argv += ["--device", "cpu"]
    proc = subprocess.Popen(argv, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=str(REPO), env=env)
    events = []
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        proc.stdin.write("".join(json.dumps(d) + "\n" for d in docs))
        proc.stdin.flush()
        settled = 0
        while settled < n_settle:
            line = proc.stdout.readline()
            if not line:
                break
            events.append(json.loads(line))
            settled += events[-1]["event"] in ("done", "paused",
                                               "cancelled", "failed")
        proc.stdin.close()
        rest, err = proc.stdout.read(), proc.stderr.read()
        proc.wait(timeout)
    finally:
        timer.cancel()
    events += [json.loads(ln) for ln in rest.splitlines() if ln.strip()]
    return proc.returncode, err, events


def test_a5gen_serve_subprocesses_give_equal_events():
    docs = _jobs_for("suball")
    rc_t, err_t, ev_t = _serve_subprocess("t", docs, 3)
    rc_j, err_j, ev_j = _serve_subprocess("j", docs, 3)
    assert rc_t == rc_j == 0, (err_t[-2000:], err_j[-2000:])
    assert _per_job(ev_t) == _per_job(ev_j)
    assert ev_t[-1] != {"event": "bye"}  # EOF ends the session, no bye
    assert "serving on stdin" in err_t
    assert sum(e["event"] == "done" for e in ev_t) == 3


def test_a5gen_serve_without_a_gpu_exits_nonzero():
    """No GPU and no ``--device cpu``: ``a5gen serve`` refuses to start
    instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
         "serve"], input='{"op": "stats"}\n', capture_output=True,
        text=True, timeout=120, cwd=str(REPO), env=env)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device is available" in r.stderr
