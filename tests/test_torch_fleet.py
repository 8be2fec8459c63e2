"""The fleet router (``runtime/fleet.py``, ``a5gen fleet``) over real
engines, against the reference, on the CPU.

Counterparts of the reference's ``tests/test_fleet.py`` in-process
classes: two engines of the port on ``serve_socket`` threads behind the
port's router (``device="cpu"``, 64 lanes x 16 blocks, one launch a
superstep), with a churn mix (plain / pause -> resume / migrate /
cancel), a torn-socket crash-replay, a drain, an auto scatter/merge
split and the explicit ``split`` op; every surviving job's hit events
equal its solo ``run_crack`` (which equals the reference's solo sweep).
Then across packages: the port's router in front of one port engine and
one reference engine, and the reference's router in front of the same
pair, each migrating a job from one package's engine to the other's in
both directions (the ``PROTOCOL.json`` 1.2 wire and the checkpoint wire
both ways), every stream equal to its solo run.  Then processes: two
spawned port engines, one SIGKILLed mid-sweep while it carries a solo
job and a split job's stripe (crash-replay and the stripe's reassignment
from its acked boundary), and ``a5gen fleet --engines 2 --device cpu``
over stdin as a subprocess.  Waits are on events, never on sleeps.
"""

import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import types

import pytest
from test_torch_pack import LEET, SPEC, WORDS, cfg, planted_digests

from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime import fleet as j_fleet
from hashcat_a5_table_generator_tpu.runtime.engine import Engine as JEngine
from hashcat_a5_table_generator_tpu.runtime.engine import (
    serve_socket as j_serve_socket,
)
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.runtime import fleet as t_fleet
from hashcat_a5_table_generator_tpu_torch.runtime import protocol
from hashcat_a5_table_generator_tpu_torch.runtime.engine import (
    Engine,
    serve_socket,
)
from hashcat_a5_table_generator_tpu_torch.runtime.fleet import (
    FleetError,
    FleetRouter,
    spawn_engines,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import Sweep

REPO = pathlib.Path(__file__).resolve().parent.parent
#: ~35 supersteps at 64 lanes: pause / migrate / split / a kill sent on
#: a job's first hit (its first superstep) land mid-sweep.
BIG_WORDS = WORDS * 12
TABLE_MAP = {k.decode(): [v.decode() for v in vs] for k, vs in LEET.items()}
GEOMETRY = {"lanes": 64, "blocks": 16, "superstep": 1}
#: Every wait's bound: nothing may hang the suite.
LIMIT = 120


def digests_for(words, picks, decoys):
    return planted_digests(SPEC, words, picks, decoys=decoys)[1]


def job_doc(jid, words, digests):
    return {"op": "submit", "id": jid,
            "words": [w.decode() for w in words], "table_map": TABLE_MAP,
            "digest_list": [d.hex() for d in digests],
            "config": dict(GEOMETRY)}


def event_hits(events):
    return [(e["word_index"], int(e["rank"]), e["plain_hex"], e["digest"])
            for e in events if e.get("event") == "hit"]


_SOLO: dict = {}


def solo(words, digests):
    """The solo run's hit tuples and done totals (the port's
    ``run_crack``, held equal to the reference's solo sweep)."""
    key = (tuple(words), tuple(digests))
    if key not in _SOLO:
        res = Sweep(SPEC, LEET, words, digests, cfg(superstep=1)).run_crack()
        ref = JSweep(JSpec(), LEET, words, digests, JConfig(
            lanes=64, num_blocks=16, superstep=1)).run_crack()
        hits = [(h.word_index, h.variant_rank, h.candidate.hex(),
                 h.digest_hex) for h in res.hits]
        assert hits == [(h.word_index, h.variant_rank, h.candidate.hex(),
                         h.digest_hex) for h in ref.hits]
        assert res.n_emitted == ref.n_emitted
        _SOLO[key] = (hits, res.n_hits, res.n_emitted)
    return _SOLO[key]


def assert_solo(col, words, digests):
    hits, n_hits, n_emitted = solo(words, digests)
    assert event_hits(col.events) == hits
    (done,) = [e for e in col.events if e.get("event") == "done"]
    assert (done["n_hits"], done["n_emitted"]) == (n_hits, n_emitted)


class Collector:
    """A job's event sink with a first-hit gate (the churn trigger)."""

    def __init__(self):
        self.events = []
        self.first_hit = threading.Event()

    def __call__(self, ev):
        self.events.append(ev)
        if ev.get("event") == "hit":
            self.first_hit.set()


class PacedJEngine(JEngine):
    """The reference engine, its serve rounds paced to about the port's
    CPU superstep: warm, the reference sweeps ``BIG_WORDS`` in ~30 ms on
    the CPU, so a migration sent on a job's first hit would race the
    job's end instead of finding it mid-sweep."""

    def _serve_round(self):
        threading.Event().wait(0.02)
        super()._serve_round()


def start_engine(path, pkg="port"):
    """An engine of either package serving ``path`` on a thread."""
    if pkg == "port":
        eng, serve = Engine(cfg(superstep=1)), serve_socket
    else:
        eng = PacedJEngine(JConfig(lanes=64, num_blocks=16, superstep=1))
        serve = j_serve_socket
    ready = threading.Event()
    threading.Thread(target=serve, args=(eng, path),
                     kwargs={"ready": ready.set}, daemon=True).start()
    assert ready.wait(30)
    return eng


def pool(tmp_path, pkgs, router):
    engines, links = [], []
    for i, pkg in enumerate(pkgs):
        path = str(tmp_path / f"e{i}.sock")
        engines.append(start_engine(path, pkg))
        links.append(router.attach(path, f"{pkg}{i}"))
    return engines, links


def close_pool(router, engines):
    # The shutdown op ends each engine's socket server; then the engines.
    router.close(shutdown_engines=True)
    for eng in engines:
        eng.close(cancel=True)


@pytest.fixture()
def fleet2(tmp_path):
    router = FleetRouter(poll_s=0.5, defaults=cfg(superstep=1))
    engines, links = pool(tmp_path, ("port", "port"), router)
    try:
        yield router, links
    finally:
        close_pool(router, engines)


@pytest.fixture()
def fleet2_split(tmp_path):
    """Two port engines behind a router that scatters every crack job."""
    router = FleetRouter(poll_s=0.5, defaults=cfg(superstep=1), split="on")
    engines, links = pool(tmp_path, ("port", "port"), router)
    try:
        yield router, links
    finally:
        close_pool(router, engines)


# ---------------------------------------------------------------------------
# Two in-process port engines behind the port's router
# ---------------------------------------------------------------------------


def test_churn_mix_byte_parity(fleet2):
    """2 engines x 4 tenants (plain / pause -> resume / migrate / cancel)
    through the router: every surviving job's hit stream equals its solo
    run, and the cancelled one settles cancelled."""
    router, links = fleet2
    docs = {"plain": (WORDS, digests_for(WORDS, (0, -1), 20)),
            "pr": (BIG_WORDS, digests_for(BIG_WORDS, (0, 5, -1), 21)),
            "mig": (BIG_WORDS, digests_for(BIG_WORDS, (1, 6, -1), 22)),
            "can": (BIG_WORDS, digests_for(BIG_WORDS, (2, -1), 23))}
    cols = {j: Collector() for j in docs}
    for jid, (words, digs) in docs.items():
        ack = router.submit(job_doc(jid, words, digs), emit=cols[jid])
        assert ack["engine"] in ("port0", "port1")
    assert cols["pr"].first_hit.wait(LIMIT)
    router.pause("pr")
    assert router.wait("pr", timeout=LIMIT)
    pr = router.job("pr")
    assert pr.state == "paused" and pr.checkpoint is not None
    assert cols["mig"].first_hit.wait(LIMIT)
    src = router.job("mig").link
    dst = next(l.engine_id for l in links if l is not src)
    ack = router.migrate("mig", dst)
    assert (ack["from"], ack["to"]) == (src.engine_id, dst)
    assert cols["can"].first_hit.wait(LIMIT)
    router.cancel("can")
    assert router.resume("pr")["resumed"] is True
    for jid in ("plain", "pr", "mig"):
        assert router.wait(jid, timeout=LIMIT), jid
        assert router.job(jid).state == "done", (jid, cols[jid].events[-2:])
        assert_solo(cols[jid], *docs[jid])
    assert router.wait("can", timeout=LIMIT)
    assert router.job("can").state == "cancelled"
    assert cols["can"].events[-1]["event"] == "cancelled"
    # The client saw the pause, never the migration's.
    assert [e["event"] for e in cols["pr"].events].count("paused") == 1
    assert not any(e["event"] == "paused" for e in cols["mig"].events)
    assert router.stats()["fleet"]["migrations"] == 1


def test_crash_replay_torn_socket_byte_parity(fleet2):
    """An engine's socket torn mid-sweep: the router requeues the job onto
    the survivor from its last router-held checkpoint (here none: from
    the start) with the hits already forwarded muted."""
    router, _links = fleet2
    digs = digests_for(BIG_WORDS, (0, 3, -1), 8)
    col = Collector()
    router.submit(job_doc("c1", BIG_WORDS, digs), emit=col)
    assert col.first_hit.wait(LIMIT)
    dead = router.job("c1").link
    dead.kill_socket()
    assert router.wait("c1", timeout=LIMIT)
    assert router.job("c1").state == "done", col.events[-2:]
    assert_solo(col, BIG_WORDS, digs)
    fleet = router.stats()["fleet"]
    assert fleet["engines_alive"] == 1 and fleet["engine_deaths"] == 1
    assert fleet["jobs_replayed"] >= 1
    assert not dead.alive


def test_drain_empties_engine_and_jobs_finish(fleet2):
    router, _links = fleet2
    digs = digests_for(BIG_WORDS, (0, -1), 24)
    col = Collector()
    router.submit(job_doc("dr", BIG_WORDS, digs), emit=col)
    assert col.first_hit.wait(LIMIT)
    src = router.job("dr").link
    ack = router.drain(src.engine_id)
    assert ack["event"] == "draining" and ack["jobs"] == 1 and src.draining
    assert router.wait("dr", timeout=LIMIT)
    assert router.job("dr").state == "done"
    assert_solo(col, BIG_WORDS, digs)
    assert src.routed == set()
    col2 = Collector()
    router.submit(job_doc("after", WORDS, digests_for(WORDS, (0,), 8)),
                  emit=col2)
    assert router.job("after").link is not src
    assert router.wait("after", timeout=LIMIT)


def test_unknown_op_passthrough_and_errors(fleet2):
    router, _links = fleet2
    for op in (router.pause, router.migrate, router.cancel, router.resume,
               router.split):
        with pytest.raises(FleetError):
            op("nope")
    with pytest.raises(FleetError):
        router.drain("no-such-engine")


def test_socket_front_end_serves_protocol(fleet2, tmp_path):
    """A serve client pointed at the router's socket works unmodified:
    submit -> accepted / hit / done, stats with the fleet section, an
    unknown op's error carries the id, shutdown -> bye."""
    router, _links = fleet2
    path = str(tmp_path / "router.sock")
    ready = threading.Event()
    threading.Thread(target=t_fleet.serve_fleet_socket, args=(router, path),
                     kwargs={"ready": ready.set}, daemon=True).start()
    assert ready.wait(10)
    digs = digests_for(WORDS, (0,), 8)
    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(LIMIT)
        s.connect(path)
        f = s.makefile("rw", encoding="utf-8")
        f.write(json.dumps(job_doc("sf1", WORDS, digs)) + "\n")
        f.write(json.dumps({"op": "stats"}) + "\n")
        f.write(json.dumps({"op": "frobnicate"}) + "\n")
        f.flush()
        events = []
        while not any(e.get("event") == "done" for e in events):
            events.append(json.loads(f.readline()))
        by = {}
        for e in events:
            by.setdefault(e["event"], []).append(e)
        assert by["accepted"][0]["engine"] in ("port0", "port1")
        assert event_hits(by["hit"]) == solo(WORDS, digs)[0]
        (st,) = by["stats"]
        assert st["fleet"]["engines_alive"] == 2
        (err,) = by["error"]
        assert "frobnicate" in err["error"]
        f.write('{"op":"shutdown"}\n')
        f.flush()
        while True:
            ev = json.loads(f.readline())
            if ev.get("event") == "bye":
                break


def test_router_session_ops_cover_the_engine_ops():
    """Every op the engine's session handles is handled by the router's
    session or declared passthrough (``ROUTER_PASSTHROUGH_OPS``), and the
    router-only ops of ``PROTOCOL.json`` are the router's."""
    calls = []

    class Recorder:
        def __getattr__(self, name):
            def call(*a, **k):
                calls.append(name)
                return {"kind": "crack"} if name != "stats" else {}
            return call

    session = t_fleet._RouterSession(Recorder(), None, io.StringIO())
    try:
        handled = set()
        for op, meta in protocol.WIRE_OPS.items():
            calls.clear()
            session._handle({"op": op, "id": "j", "engine": "e"})
            if calls != ["passthrough"]:
                handled.add(op)
            if "router" in meta["handlers"]:
                assert op in handled, op
        engine_ops = {op for op, meta in protocol.WIRE_OPS.items()
                      if "engine" in meta["handlers"]}
        assert engine_ops <= handled | t_fleet.ROUTER_PASSTHROUGH_OPS
        assert t_fleet.ROUTER_PASSTHROUGH_OPS == \
            j_fleet.ROUTER_PASSTHROUGH_OPS
    finally:
        session._out.put(None)


# ---------------------------------------------------------------------------
# Giant-job split: scatter + k-way merge
# ---------------------------------------------------------------------------


def test_auto_scatter_merge_byte_parity(fleet2_split):
    """One job scattered as two disjoint pod stripes, merged back into one
    (word, rank)-ordered exactly-once stream equal to its solo run, with
    shard_done events and the parent's churn ops refused while split; a
    stripe migrated mid-range rides the acked-boundary + mute discipline
    and tells the client (range_reassign)."""
    router, _links = fleet2_split
    digs = digests_for(BIG_WORDS, (0, 3, 7, -1), 8)
    col = Collector()
    ack = router.submit(job_doc("sp", BIG_WORDS, digs), emit=col)
    assert ack.get("shards") == 2
    assert {router.job(f"sp::s{i}").link.engine_id for i in (0, 1)} == \
        {"port0", "port1"}
    for op, jid in ((router.pause, "sp"), (router.migrate, "sp"),
                    (router.resume, "sp::s0"), (router.cancel, "sp::s1"),
                    (router.pause, "sp::s0"), (router.split, "sp")):
        with pytest.raises(FleetError):
            op(jid)
    assert col.first_hit.wait(LIMIT)
    router.migrate("sp::s1")
    assert router.wait("sp", timeout=LIMIT)
    assert router.job("sp").state == "done", col.events[-2:]
    assert_solo(col, BIG_WORDS, digs)
    shard_done = [e for e in col.events if e.get("event") == "shard_done"]
    assert sorted(e["shard"] for e in shard_done) == [0, 1]
    assert all(e["shards"] == 2 for e in shard_done)
    (reassign,) = [e for e in col.events
                   if e.get("event") == "range_reassign"]
    assert reassign["shard"] == 1 and reassign["shards"] == 2
    fleet = router.stats()["fleet"]
    assert fleet["jobs_split"] == 1 and fleet["shards_reassigned"] == 1


def test_explicit_split_op_solo_to_split(fleet2):
    """The explicit ``split`` op on a running unsplit job: it parks
    (pause -> checkpoint), its checkpoint seeds both stripes with the
    forwarded hits muted, and the client stream equals its solo run with
    the hits before the split a prefix of it."""
    router, _links = fleet2
    digs = digests_for(BIG_WORDS, (0, 4, -1), 25)
    col = Collector()
    router.submit(job_doc("xs", BIG_WORDS, digs), emit=col)
    assert col.first_hit.wait(LIMIT)
    prefix = event_hits(col.events)
    ack = router.split("xs")
    assert ack["shards"] == 2 and ack["event"] == "accepted"
    with pytest.raises(FleetError):
        router.split("xs")
    assert router.stats()["fleet"]["jobs_split"] == 1
    assert router.wait("xs", timeout=LIMIT)
    assert router.job("xs").state == "done", col.events[-2:]
    assert_solo(col, BIG_WORDS, digs)
    assert event_hits(col.events)[:len(prefix)] == prefix
    # The park was the router's: the client saw no paused event.
    assert not any(e["event"] == "paused" for e in col.events)


# ---------------------------------------------------------------------------
# Across packages: one port engine and one reference engine
# ---------------------------------------------------------------------------


def test_both_routers_give_each_job_the_same_events(tmp_path):
    """The same submit documents through the port's router over two port
    engines and through the reference's router over two reference
    engines: per job, the same hit events and ``done`` totals, equal to
    the solo run."""
    rev = BIG_WORDS[::-1]
    docs = {"r1": (WORDS, digests_for(WORDS, (0, -1), 50)),
            "r2": (BIG_WORDS, digests_for(BIG_WORDS, (2, 7, -1), 51)),
            "r3": (rev, digests_for(rev, (0, -1), 52))}
    got = {}
    for pkg, mod in (("port", t_fleet), ("reference", j_fleet)):
        (tmp_path / pkg).mkdir()
        router = mod.FleetRouter(poll_s=0.5, defaults=cfg(superstep=1))
        engines, _links = pool(tmp_path / pkg, (pkg, pkg), router)
        try:
            cols = {j: Collector() for j in docs}
            for jid, (words, digs) in docs.items():
                router.submit(job_doc(jid, words, digs), emit=cols[jid])
            for jid in docs:
                assert router.wait(jid, timeout=LIMIT), (pkg, jid)
            got[pkg] = {
                jid: (event_hits(col.events),
                      [(e["n_hits"], e["n_emitted"]) for e in col.events
                       if e["event"] == "done"])
                for jid, col in cols.items()}
        finally:
            close_pool(router, engines)
    assert got["port"] == got["reference"]
    for jid, (words, digs) in docs.items():
        hits, n_hits, n_emitted = solo(words, digs)
        assert got["port"][jid] == (hits, [(n_hits, n_emitted)])


@pytest.mark.parametrize("router_pkg", ["port", "reference"])
def test_migration_crosses_packages_both_ways(router_pkg, tmp_path):
    """A router of either package over a port engine and a reference
    engine: job A runs on the port engine and migrates to the reference
    engine mid-sweep, job B the other way; each stream equals its solo
    run (both packages' solo runs agree), so the serve wire and the
    checkpoint wire carry a job across packages in both directions."""
    mod = t_fleet if router_pkg == "port" else j_fleet
    router = mod.FleetRouter(poll_s=0.5, defaults=cfg(superstep=1))
    engines, (tl, jl) = pool(tmp_path, ("port", "reference"), router)
    try:
        jobs = {}
        for jid, src, dst, picks in (("a", tl, jl, (0, 5, -1)),
                                     ("b", jl, tl, (1, 6, -1))):
            # Pin the placement: the other engine drains for the submit.
            dst.draining = True
            digs = digests_for(BIG_WORDS, picks, 30)
            col = Collector()
            ack = router.submit(job_doc(jid, BIG_WORDS, digs), emit=col)
            dst.draining = False
            assert ack["engine"] == src.engine_id
            assert col.first_hit.wait(LIMIT)
            mig = router.migrate(jid, dst.engine_id)
            assert (mig["from"], mig["to"]) == (src.engine_id,
                                                dst.engine_id)
            jobs[jid] = (col, digs)
        for jid, (col, digs) in jobs.items():
            assert router.wait(jid, timeout=LIMIT), jid
            assert router.job(jid).state == "done", col.events[-2:]
            assert_solo(col, BIG_WORDS, digs)
        stats = router.stats()
        assert stats["fleet"]["migrations"] == 2
        # Each engine paused one job (the migration's source) and finished
        # one (the migration's target).
        for link in (tl, jl):
            assert link.scrape["jobs_paused"] == 1, link.engine_id
            assert link.scrape["jobs_done"] == 1, link.engine_id
    finally:
        close_pool(router, engines)


# ---------------------------------------------------------------------------
# Spawned engine processes
# ---------------------------------------------------------------------------


def spawn_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("A5GEN_FAULTS", None)
    # Two engine processes beside the suite's workers, each with torch's
    # default intra-op pool, oversubscribe the CPU's cores: their sweeps
    # (plain PyTorch on the CPU) then crawl.
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_kill_one_engine_replays_jobs_and_reassigns_a_stripe(tmp_path):
    """Two spawned port engines (``--device cpu``); a small job and a
    split job's stripes run on both.  The engine carrying the small job
    is SIGKILLed once it and the split job have streamed a hit: the small
    job crash-replays onto the survivor and the dead stripe reassigns
    from its acked boundary (range_reassign) — every client stream equals
    its solo run, no hit delivered twice."""
    specs = spawn_engines(
        2, str(tmp_path / "engines"),
        engine_args=["--device", "cpu", "--lanes", "64", "--blocks", "16",
                     "--superstep", "1", "--schema-cache",
                     str(tmp_path / "cache")],
        env=spawn_env(), stderr=open(tmp_path / "engines.err", "w"))
    for _sock, eid, proc in specs:
        assert proc.args[1:5] == ["-m", "hashcat_a5_table_generator_tpu_torch",
                                  "serve", "--socket"]
        assert proc.args[6:8] == ["--engine-id", eid]
    router = FleetRouter(poll_s=0.5, defaults=cfg(superstep=1),
                         split="auto", split_threshold=100)
    try:
        for sock_path, eid, proc in specs:
            router.attach(sock_path, eid, proc=proc, timeout=LIMIT)
        giant = WORDS * 24
        docs = {"j1": (BIG_WORDS, digests_for(BIG_WORDS, (0, 5, -1), 40)),
                "g1": (giant, digests_for(giant, (0, 5, 9, -1), 41))}
        cols = {j: Collector() for j in docs}
        acks = {j: router.submit(job_doc(j, *docs[j]), emit=cols[j])
                for j in docs}
        assert acks["g1"]["shards"] == 2 and "shards" not in acks["j1"]
        assert cols["j1"].first_hit.wait(LIMIT)
        assert cols["g1"].first_hit.wait(LIMIT)
        prefix = event_hits(cols["g1"].events)
        victim = router.job("j1").link
        os.kill(victim.proc.pid, signal.SIGKILL)
        for jid, (words, digs) in docs.items():
            assert router.wait(jid, timeout=LIMIT), jid
            assert router.job(jid).state == "done", cols[jid].events[-2:]
            assert_solo(cols[jid], words, digs)
        assert event_hits(cols["g1"].events)[:len(prefix)] == prefix
        reassigns = [e for e in cols["g1"].events
                     if e.get("event") == "range_reassign"]
        assert [e["from"] for e in reassigns] == [victim.engine_id]
        fleet = router.stats()["fleet"]
        assert fleet["engine_deaths"] == 1 and fleet["jobs_replayed"] >= 2
        assert fleet["jobs_split"] == 1 and fleet["shards_reassigned"] == 1
        assert victim.proc.wait(LIMIT) == -signal.SIGKILL
    finally:
        router.close(shutdown_engines=True)
        for _s, _e, proc in specs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(LIMIT)


#: ``a5gen fleet`` through the port's CLI, recording the commands it
#: spawns and whether the router process imported torch.
FLEET_PROBE = (
    "import json, subprocess, sys\n"
    "from hashcat_a5_table_generator_tpu_torch import cli\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime import fleet\n"
    "cmds = []\n"
    "class Popen(subprocess.Popen):\n"
    "    def __init__(self, args, **kw):\n"
    "        cmds.append(list(args))\n"
    "        super().__init__(args, **kw)\n"
    "fleet.subprocess = type(sys)('subprocess')\n"
    "fleet.subprocess.__dict__.update(subprocess.__dict__, Popen=Popen)\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(json.dumps({'cmds': cmds, 'torch': 'torch' in sys.modules}), "
    "file=sys.stderr)\n"
    "sys.exit(rc)\n")


def test_a5gen_fleet_over_stdin_spawns_port_engines(tmp_path):
    """``a5gen fleet --engines 2 --device cpu`` as a subprocess: the two
    engines it spawns are the port's ``serve`` on the CPU, two jobs over
    stdin stream their solo hits, ``stats`` shows the fleet section, and
    ``shutdown`` ends with ``bye`` and exit 0; the router imported no
    torch."""
    docs = {"s1": (WORDS, digests_for(WORDS, (0, -1), 8)),
            "s2": (BIG_WORDS, digests_for(BIG_WORDS, (1, -1), 9))}
    p = subprocess.Popen(
        [sys.executable, "-c", FLEET_PROBE, "fleet", "--engines", "2",
         "--device", "cpu", "--engine-dir", str(tmp_path / "eng"),
         "--lanes", "64", "--blocks", "16", "--superstep", "1",
         "--poll", "0.5"], cwd=REPO, env=spawn_env(), text=True,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    events = []
    lines = iter(p.stdout.readline, "")
    timer = threading.Timer(LIMIT, p.kill)
    timer.start()
    try:
        for jid, (words, digs) in docs.items():
            p.stdin.write(json.dumps(job_doc(jid, words, digs)) + "\n")
        p.stdin.flush()
        while sum(e.get("event") == "done" for e in events) < len(docs):
            events.append(json.loads(next(lines)))
        p.stdin.write('{"op": "stats"}\n{"op": "shutdown"}\n')
        p.stdin.flush()
        for line in lines:
            events.append(json.loads(line))
        out_err = p.stderr.read()
        assert p.wait(LIMIT) == 0, out_err
    finally:
        timer.cancel()
        if p.poll() is None:
            p.kill()
    probe = json.loads(out_err.strip().splitlines()[-1])
    assert probe["torch"] is False
    assert [c[1:4] for c in probe["cmds"]] == [
        ["-m", "hashcat_a5_table_generator_tpu_torch", "serve"]] * 2
    for cmd in probe["cmds"]:
        assert cmd[cmd.index("--device") + 1] == "cpu"
    for jid, (words, digs) in docs.items():
        col = types.SimpleNamespace(events=[e for e in events
                                            if e.get("id") == jid])
        assert_solo(col, words, digs)
    (stats,) = [e for e in events if e["event"] == "stats"]
    assert stats["fleet"]["engines_alive"] == 2
    assert stats["jobs_done"] == 2
    assert events[-1] == {"event": "bye"}


def test_attach_failure_exits_2(tmp_path, capsys):
    """An engine that never listens fails the command with exit 2."""
    missing = str(tmp_path / "nobody.sock")
    with pytest.MonkeyPatch.context() as mp:
        real = t_fleet.EngineLink.connect.__func__

        def quick(cls, endpoint, engine_id=None, *, timeout=180.0, **kw):
            return real(cls, endpoint, engine_id, timeout=0.5, **kw)

        mp.setattr(t_fleet.EngineLink, "connect", classmethod(quick))
        assert t_cli.main(["fleet", "--engines", missing]) == 2
    assert "not listening" in capsys.readouterr().err
