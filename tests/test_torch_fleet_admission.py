"""The fleet router's control plane (``runtime/fleet.py``) on stub engine
links, against the reference's router.

Counterparts of the reference's ``tests/test_fleet.py`` placement
classes and the non-autoscaler classes of ``tests/test_elastic.py``:
placement (affinity, round-robin, draining and dead engines), admission
control and backpressure (capacity, the bounded pending queue, the shed
policies, deadlines, the per-tenant cap, bounded memory, resume under
overload), the health ladder, capture-time checkpoint validation, the
``router.place`` / ``link.send`` fault seams, the health poller's
watchdog and the ``stats`` fleet section.  Each body runs on the port's
router and on the reference's (``pkg``), with scripted links: no engine,
no socket, no device.  Where a case needs an autoscaler bound
(quarantine is only reachable with a replacer), the package's own
``Autoscaler`` binds with manual ticks (``interval_s=0``); its scenarios
are ``tests/test_torch_autoscale.py``'s.
"""

import sys
import threading
import time
import types

import pytest

import hashcat_a5_table_generator_tpu.runtime.autoscale as j_autoscale
import hashcat_a5_table_generator_tpu.runtime.checkpoint as j_ck
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
import hashcat_a5_table_generator_tpu.runtime.fleet as j_fleet
import hashcat_a5_table_generator_tpu.runtime.fuse as j_fuse
import hashcat_a5_table_generator_tpu.runtime.telemetry as j_tel
import hashcat_a5_table_generator_tpu_torch.runtime.autoscale as t_autoscale
import hashcat_a5_table_generator_tpu_torch.runtime.checkpoint as t_ck
import hashcat_a5_table_generator_tpu_torch.runtime.faults as t_faults
import hashcat_a5_table_generator_tpu_torch.runtime.fleet as t_fleet
import hashcat_a5_table_generator_tpu_torch.runtime.fuse as t_fuse
import hashcat_a5_table_generator_tpu_torch.runtime.telemetry as t_tel

PKGS = {
    "port": types.SimpleNamespace(fleet=t_fleet, ck=t_ck, faults=t_faults,
                                  telemetry=t_tel, autoscale=t_autoscale),
    "reference": types.SimpleNamespace(fleet=j_fleet, ck=j_ck,
                                       faults=j_faults, telemetry=j_tel,
                                       autoscale=j_autoscale),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.005)


class FakeLink:
    """A scripted engine link: accepts every request at once and answers
    health scrapes from ``stats_reply``."""

    def __init__(self, engine_id, index, resident=(), load=0,
                 health="healthy"):
        self.engine_id = engine_id
        self.endpoint = f"fake://{engine_id}"
        self.index = index
        self.alive = True
        self.draining = False
        self.health = health
        self.strikes = 0
        self.clean = 0
        self.replay_fails = 0
        self.ladder_prev = {}
        self.next_poll = 0.0
        self.misses = 0
        self.scrape = {"resident_groups": list(resident),
                       "jobs_runnable": load}
        self.routed = set()
        self.requests = []
        self.sent = []
        self.stats_reply = {"event": "stats"}
        self.proc = None
        self.killed = threading.Event()
        self._closing = False

    def request(self, doc, timeout=None):
        self.requests.append(doc)
        return {"id": doc.get("id"), "event": "accepted", "kind": "crack"}

    def send(self, doc):
        self.sent.append(doc)

    def health_request(self, doc, timeout=None):
        return dict(self.stats_reply)

    def kill_socket(self):
        self.alive = False
        self.killed.set()

    def close(self):
        self.alive = False


def bind_scaler(pkg, router):
    """The package's real autoscaler bound to ``router`` (the ladder's
    replacer), ticked by hand: here it never ticks."""
    a = pkg.autoscale

    def spawner():
        raise AssertionError("no spawn expected")

    return a.Autoscaler(router, spawner, a.AutoscaleConfig(
        min_engines=1, max_engines=4, interval_s=0))


def make_router(pkg, n_links=1, **kw):
    kw.setdefault("poll_s", 0)
    router = pkg.fleet.FleetRouter(**kw)
    links = [FakeLink(f"e{i}", i) for i in range(n_links)]
    router._links = links
    return router, links


@pytest.fixture()
def routed(pkg):
    """``make_router`` whose routers close at teardown."""
    made = []

    def make(n_links=1, **kw):
        router, links = make_router(pkg, n_links, **kw)
        made.append(router)
        return router, links

    yield make
    for router in made:
        router.close(shutdown_engines=False)


def collector():
    events = []
    return events, events.append


def ckdoc(pkg, word=0, rank=4, emitted=3):
    return pkg.ck.state_to_doc(pkg.ck.CheckpointState(
        fingerprint="fp", cursor=pkg.ck.SweepCursor(word, rank),
        n_emitted=emitted, n_hits=0, hits=[], wall_s=0.1))


# ---------------------------------------------------------------------------
# Tokens and placement
# ---------------------------------------------------------------------------


def test_static_affinity_token_copy_equals_fuse_and_reference():
    """The router's copy of the token (it imports no torch) equals the
    engine's (``runtime.fuse``) and the reference's."""
    for fields in ({}, {"a": 1, "b": "x"},
                   {"mode": "default", "algo": "md5", "table_min": 0,
                    "table_max": 15, "lanes": 64, "num_blocks": 16,
                    "superstep": 1, "devices": 1, "pair": None}):
        want = j_fuse.static_affinity_token(**fields)
        assert t_fleet.static_affinity_token(**fields) == want
        assert t_fuse.static_affinity_token(**fields) == want


def test_router_doc_token_matches_engine_token():
    """The router's doc token equals the engine's resident token for the
    same static config, and the reference router's for the same doc."""
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        AttackSpec,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
        SweepConfig,
    )

    c = SweepConfig(device="cpu", lanes=64, num_blocks=16, superstep=1)
    doc = {"algo": "md5", "mode": "default",
           "config": {"lanes": 64, "blocks": 16, "superstep": 1}}
    router = t_fleet.FleetRouter(poll_s=0, defaults=c)
    jrouter = j_fleet.FleetRouter(poll_s=0, defaults=c)
    try:
        token = router._doc_token(doc)
        assert token == t_fuse.affinity_token(AttackSpec(), c)
        assert token == jrouter._doc_token(doc)
        # Scraped engine defaults fill the doc's gaps.
        router._links = [FakeLink("e0", 0)]
        router._links[0].scrape["config_defaults"] = {
            "lanes": 64, "blocks": 16, "superstep": 1, "devices": 1,
            "pair": None}
        assert router._doc_token({"algo": "md5"}) == token
    finally:
        router.close(shutdown_engines=False)
        jrouter.close(shutdown_engines=False)


def test_affinity_prefers_resident_token(routed):
    router, _ = routed(0)
    busy = FakeLink("busy", 0, resident=("tok",), load=9)
    idle = FakeLink("idle", 1, load=0)
    router._links = [busy, idle]
    assert router._pick("tok") is busy
    assert router._pick("other") is idle


def test_round_robin_alternates(routed):
    router, (a, b) = routed(2, place="round-robin")
    assert {router._pick("tok").engine_id for _ in range(2)} == {"e0", "e1"}


def test_draining_and_dead_excluded(pkg, routed):
    router, _ = routed(0)
    a, b = FakeLink("a", 0, resident=("tok",)), FakeLink("b", 1)
    a.draining = True
    router._links = [a, b]
    assert router._pick("tok") is b
    b.alive = False
    with pytest.raises(pkg.fleet.FleetError):
        router._pick("tok")


def test_submit_with_no_engines_fails_loudly(pkg, routed):
    router, _ = routed(0)
    with pytest.raises(pkg.fleet.FleetError):
        router.submit({"id": "j", "digest_list": []})
    assert "j" not in router._jobs


@pytest.mark.parametrize("bad", [
    dict(place="nearest"), dict(shed_policy="drop"), dict(split="maybe"),
], ids=lambda d: next(iter(d)))
def test_constructor_validates(pkg, bad):
    with pytest.raises(ValueError):
        pkg.fleet.FleetRouter(poll_s=0, **bad)


# ---------------------------------------------------------------------------
# Admission control and backpressure
# ---------------------------------------------------------------------------


def test_capacity_gates_then_queues_with_queued_ack(routed):
    router, (link,) = routed(engine_capacity=1)
    ack1 = router.submit({"id": "j1", "digest_list": []})
    assert ack1["engine"] == "e0" and "queued" not in ack1
    ack2 = router.submit({"id": "j2", "digest_list": []})
    assert ack2["queued"] is True and ack2["engine"] is None
    assert router.pending_depth() == 1
    assert link.routed == {"j1"}


def test_overload_rejects_typed_with_retry_after(pkg, routed):
    router, (link,) = routed(engine_capacity=1, max_pending=1)
    router.submit({"id": "j1", "digest_list": []})
    router.submit({"id": "j2", "digest_list": []})
    with pytest.raises(pkg.fleet.FleetOverloaded) as exc:
        router.submit({"id": "j3", "digest_list": []})
    assert exc.value.retry_after_s > 0
    ev = exc.value.event("j3")
    assert ev["error"] == "overloaded" and ev["id"] == "j3"
    assert ev["retry_after_s"] == exc.value.retry_after_s
    assert "j3" not in router._jobs
    assert router.stats()["fleet"]["jobs_rejected"] == 1


def test_pending_dispatches_as_capacity_frees(routed):
    router, (link,) = routed(engine_capacity=1)
    router.submit({"id": "j1", "digest_list": []})
    _events, emit = collector()
    router.submit({"id": "j2", "digest_list": []}, emit=emit)
    assert router.pending_depth() == 1
    router._on_job_event(link, {"id": "j1", "event": "done"})
    wait_for(lambda: "j2" in link.routed, what="j2 placed")
    assert router.pending_depth() == 0
    assert router.job("j2").state == "routed"


@pytest.mark.parametrize("case", ["oldest", "deadline-first"])
def test_shed_policy_oldest_evicts_to_admit(case, routed):
    """A full pending queue under ``oldest`` sheds a pending job typed to
    admit the newcomer: the oldest, or first any deadline carrier."""
    router, (link,) = routed(engine_capacity=1,
                             max_pending=1 if case == "oldest" else 2,
                             shed_policy="oldest")
    router.submit({"id": "j1", "digest_list": []})
    events, emit = collector()
    if case == "oldest":
        router.submit({"id": "old", "digest_list": []}, emit=emit)
        ack = router.submit({"id": "new", "digest_list": []})
        assert ack["queued"] is True
        victim, left = "old", ["new"]
    else:
        router.submit({"id": "nodl", "digest_list": []})
        router.submit({"id": "dl", "digest_list": [], "deadline_s": 60.0},
                      emit=emit)
        router.submit({"id": "spill", "digest_list": []})
        victim, left = "dl", ["nodl", "spill"]
    (failed,) = [e for e in events if e.get("event") == "failed"]
    assert failed["error"] == "overloaded" and failed["retry_after_s"] > 0
    assert router.job(victim).state == "failed"
    assert [j.id for j in router._pending] == left
    assert router.stats()["fleet"]["jobs_shed"] == 1


def test_expired_deadline_sheds_at_pump(routed):
    router, (link,) = routed(engine_capacity=1)
    router.submit({"id": "j1", "digest_list": []})
    events, emit = collector()
    router.submit({"id": "dl", "digest_list": [], "deadline_s": 0.0},
                  emit=emit)
    router._pump_pending()
    assert router.job("dl").state == "failed"
    (failed,) = [e for e in events if e.get("event") == "failed"]
    assert failed["error"] == "overloaded" and "deadline" in failed["reason"]


def test_queue_policy_is_the_unbounded_escape_hatch(routed):
    router, (link,) = routed(engine_capacity=1, max_pending=1,
                             shed_policy="queue")
    router.submit({"id": "j0", "digest_list": []})
    for i in range(5):
        assert router.submit({"id": f"q{i}", "digest_list": []})["queued"]
    assert router.pending_depth() == 5


def test_per_tenant_cap_rejects_typed(pkg, routed):
    router, (link,) = routed(per_tenant=1)
    router.submit({"id": "t1", "digest_list": [], "tenant": "alice"})
    with pytest.raises(pkg.fleet.FleetOverloaded) as exc:
        router.submit({"id": "t2", "digest_list": [], "tenant": "alice"})
    assert "alice" in str(exc.value)
    router.submit({"id": "t3", "digest_list": [], "tenant": "bob"})
    router.submit({"id": "t4", "digest_list": []})
    router._on_job_event(link, {"id": "t1", "event": "done"})
    router.submit({"id": "t5", "digest_list": [], "tenant": "alice"})


def test_router_memory_bounded_under_sustained_overload(pkg, routed):
    router, (link,) = routed(engine_capacity=1, max_pending=4)
    router.submit({"id": "j1", "digest_list": []})
    rejected = 0
    for i in range(100):
        try:
            router.submit({"id": f"burst{i}", "digest_list": []})
        except pkg.fleet.FleetOverloaded:
            rejected += 1
    assert rejected == 96
    assert router.pending_depth() == 4
    assert len(router._jobs) == 5


def test_resume_under_overload_keeps_paused_job(pkg, routed):
    router, (link,) = routed(engine_capacity=1, max_pending=0)
    doc = ckdoc(pkg)
    router.submit({"id": "p1", "digest_list": []})
    router._on_job_event(link, {"id": "p1", "event": "paused",
                                "checkpoint": doc})
    assert router.job("p1").state == "paused"
    router.submit({"id": "run", "digest_list": []})
    with pytest.raises(pkg.fleet.FleetOverloaded):
        router.resume("p1")
    job = router.job("p1")
    assert job.state == "paused" and job.checkpoint == doc
    router._on_job_event(link, {"id": "run", "event": "done"})
    assert router.resume("p1")["resumed"] is True
    # The resumed placement carries the router-held checkpoint.
    assert link.requests[-1]["checkpoint"] == doc


def test_resume_retry_while_queued_is_idempotent(pkg, routed):
    router, (link,) = routed(engine_capacity=1, max_pending=4)
    router.submit({"id": "p1", "digest_list": []})
    router._on_job_event(link, {"id": "p1", "event": "paused",
                                "checkpoint": ckdoc(pkg)})
    router.submit({"id": "run", "digest_list": []})
    ack1, ack2 = router.resume("p1"), router.resume("p1")
    assert ack1["queued"] is True and ack2["queued"] is True
    with router._lock:
        assert [j.id for j in router._pending].count("p1") == 1
    router._on_job_event(link, {"id": "run", "event": "done"})
    wait_for(lambda: "p1" in link.routed, what="p1 placed")


def test_dispatch_refuses_already_bound_job(pkg, routed):
    router, (link,) = routed()
    router.submit({"id": "j1", "digest_list": []})
    job = router.job("j1")
    with pytest.raises(pkg.fleet.FleetError) as exc:
        router._dispatch(job)
    assert "already bound" in str(exc.value)
    assert job.link is link


def test_bind_time_capacity_recheck_closes_toctou(routed):
    router, (link,) = routed(engine_capacity=1)
    router.submit({"id": "j1", "digest_list": []})
    router._pick = lambda token, exclude=(): link  # the race
    assert router.submit({"id": "j2", "digest_list": []})["queued"] is True
    assert link.routed == {"j1"}


def test_cancel_of_pending_job_settles_inline(routed):
    router, (link,) = routed(engine_capacity=1)
    router.submit({"id": "j1", "digest_list": []})
    events, emit = collector()
    router.submit({"id": "q", "digest_list": []}, emit=emit)
    router.cancel("q")
    assert router.job("q").state == "cancelled"
    assert router.pending_depth() == 0
    assert any(e.get("event") == "cancelled" for e in events)


def test_submit_strips_and_reinjects_checkpoint_and_mute(pkg, routed):
    """A migrate-in submit: the router holds the checkpoint and the mute
    and re-injects both on dispatch; a duplicate live id is refused."""
    router, (link,) = routed()
    doc = ckdoc(pkg)
    router.submit({"id": "m", "digest_list": [], "checkpoint": doc,
                   "replay_mute": 2})
    sent = link.requests[-1]
    assert sent["checkpoint"] == doc and sent["replay_mute"] == 2
    assert sent["op"] == "submit"
    assert "checkpoint" not in router.job("m").doc
    with pytest.raises(pkg.fleet.FleetError):
        router.submit({"id": "m", "digest_list": []})


# ---------------------------------------------------------------------------
# The health ladder
# ---------------------------------------------------------------------------


def ladder(routed, **kw):
    kw.setdefault("degrade_after", 1)
    kw.setdefault("quarantine_after", 3)
    kw.setdefault("recover_after", 2)
    return routed(2, **kw)


def test_rising_demotions_degrade_then_recover(routed):
    router, (a, b) = ladder(routed)
    a.stats_reply = {"event": "stats", "group_demotions": 0,
                     "job_restarts": 0}
    router._scrape(a, observe=True)  # the baseline
    assert a.health == "healthy"
    a.stats_reply["group_demotions"] = 1
    router._scrape(a, observe=True)
    assert a.health == "degraded"
    router.submit({"id": "j1", "digest_list": []})
    assert router.job("j1").link is b
    router._scrape(a, observe=True)
    assert a.health == "degraded"
    router._scrape(a, observe=True)
    assert a.health == "healthy"


@pytest.mark.parametrize("scaler", [True, False],
                         ids=["autoscaled", "fixed-pool"])
def test_sustained_strain_quarantines_and_excludes(scaler, pkg, routed):
    """With a replacer bound, sustained strain quarantines the engine:
    no placements land on it, and a pool of only quarantined engines
    queues (overload, not absence).  A fixed pool tops out at degraded
    and keeps the engine as the last resort."""
    router, (a, b) = ladder(routed, quarantine_after=2)
    if scaler:
        bind_scaler(pkg, router)
    a.stats_reply = {"event": "stats", "group_demotions": 0}
    router._scrape(a, observe=True)
    for i in (1, 2, 3, 4):
        a.stats_reply["group_demotions"] = i
        router._scrape(a, observe=True)
    if not scaler:
        assert a.health == "degraded"
        b.alive = False
        router.submit({"id": "last", "digest_list": []})
        assert router.job("last").link is a
        return
    assert a.health == "quarantined"
    assert router.stats()["fleet"]["engines_quarantined"] == 1
    for i in range(4):
        router.submit({"id": f"q{i}", "digest_list": []})
        assert router.job(f"q{i}").link is b
    b.alive = False
    assert router.submit({"id": "during", "digest_list": []})["queued"]


def test_repeated_crash_replays_quarantine(pkg, routed):
    router, (a, b) = ladder(routed, quarantine_replays=2, replay_budget=5)
    bind_scaler(pkg, router)
    doc = ckdoc(pkg, rank=10, emitted=5)
    for i in range(2):
        # Distinct static configs: affinity would follow r0 to its
        # replay engine; by load, both land on the same first engine.
        router.submit({"id": f"r{i}", "digest_list": [], "table_max": i})
        job = router.job(f"r{i}")
        link = job.link
        router._on_job_event(link, {"id": job.id, "event": "failed",
                                    "error": "boom", "checkpoint": doc})
        wait_for(lambda: job.link not in (None, link) or not job.unsettled,
                 what="replayed")
    assert a.replay_fails + b.replay_fails >= 2
    assert "quarantined" in (a.health, b.health)


def test_replay_fails_decay_on_clean_poll_tick(pkg, routed):
    router, (a, b) = ladder(routed, quarantine_replays=2, replay_budget=5)
    bind_scaler(pkg, router)
    router.submit({"id": "r0", "digest_list": []})
    link = router.job("r0").link
    router._on_job_event(link, {"id": "r0", "event": "failed",
                                "error": "boom",
                                "checkpoint": ckdoc(pkg, rank=2)})
    assert link.replay_fails == 1
    router._scrape(link, observe=True)  # a clean poll tick
    assert link.replay_fails == 0 and link.health != "quarantined"


def test_client_stats_scrapes_do_not_feed_ladder(routed):
    router, (a, b) = ladder(routed)
    a.stats_reply = {"event": "stats", "group_demotions": 0}
    router._scrape(a, observe=True)
    a.stats_reply["group_demotions"] = 5
    for _ in range(4):
        router.stats()
    assert a.health == "healthy"
    router._scrape(a, observe=True)
    assert a.health == "degraded"


def test_failed_scrape_strikes_ladder(pkg, routed):
    router, (a, b) = ladder(routed, quarantine_after=1)
    bind_scaler(pkg, router)

    def boom(doc, timeout=None):
        raise pkg.fleet.FleetError("scrape torn")

    a.health_request = boom
    with pytest.raises(pkg.fleet.FleetError):
        router._scrape(a)
    router._ladder_strike(a)
    assert a.health == "quarantined"


@pytest.mark.parametrize("how", ["wedged", "reaped"])
def test_poll_loop_watchdog_kills_a_dead_engine(how, pkg):
    """The health poller's watchdog: an engine that stops answering
    scrapes (each failure retried once in-poll) is killed after
    ``poll_misses`` failed polls; an engine whose process exited is
    killed at its next tick without a scrape."""
    router = pkg.fleet.FleetRouter(poll_s=0.02, poll_misses=2)
    link = FakeLink("w", 0)
    if how == "wedged":
        def wedged(doc, timeout=None):
            raise pkg.fleet.FleetError("no reply")

        link.health_request = wedged
    else:
        link.proc = types.SimpleNamespace(poll=lambda: 0)
    try:
        router._links = [link]
        assert link.killed.wait(30)
        if how == "wedged":
            assert link.misses >= 2 and link.health == "degraded"
            assert router.stats()["fleet"]["scrape_retries"] >= 2
    finally:
        router.close(shutdown_engines=False)


# ---------------------------------------------------------------------------
# Capture-time checkpoint validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["malformed", "wire-major"])
def test_malformed_migrate_in_fails_submit_typed(case, pkg, routed):
    router, _ = routed()
    if case == "malformed":
        doc, exc_type = {"fingerprint": "fp"}, pkg.ck.CheckpointCorrupt
    else:
        doc = ckdoc(pkg, rank=1, emitted=1)
        doc["wire_version"] = "9.0"
        exc_type = pkg.ck.CheckpointWireIncompatible
    with pytest.raises(exc_type) as exc:
        router.submit({"id": "m1", "digest_list": [], "checkpoint": doc})
    if case == "malformed":
        assert "missing required field" in str(exc.value)
    assert "m1" not in router._jobs


def test_malformed_pause_checkpoint_fails_typed_at_capture(routed):
    router, (link,) = routed()
    events, emit = collector()
    router.submit({"id": "p1", "digest_list": []}, emit=emit)
    router._on_job_event(link, {"id": "p1", "event": "paused",
                                "checkpoint": {"fingerprint": "fp"}})
    assert router.job("p1").state == "failed"
    (failed,) = [e for e in events if e.get("event") == "failed"]
    assert "CheckpointCorrupt" in failed["error"] and "pause" in \
        failed["error"]


def test_malformed_quarantine_token_not_replayed(routed):
    router, (link,) = routed(replay_budget=3)
    events, emit = collector()
    router.submit({"id": "f1", "digest_list": []}, emit=emit)
    router._on_job_event(link, {"id": "f1", "event": "failed",
                                "error": "boom",
                                "checkpoint": {"cursor": {}}})
    assert router.job("f1").state == "failed"
    (failed,) = [e for e in events if e.get("event") == "failed"]
    assert "checkpoint_invalid" in failed
    assert router.job("f1").replays == 0


# ---------------------------------------------------------------------------
# Fault seams
# ---------------------------------------------------------------------------


def test_router_place_fault_fails_submit_typed_and_retryable(pkg, routed):
    router, (link,) = routed()
    with pkg.faults.armed("router.place:nth=1"):
        with pytest.raises(pkg.faults.FaultInjected):
            router.submit({"id": "f1", "digest_list": []})
        assert "f1" not in router._jobs
        assert router.submit({"id": "f1", "digest_list": []})["engine"] \
            == "e0"


def test_router_place_fault_on_requeue_quarantines_job(pkg, routed):
    router, (link,) = routed(replay_budget=1)
    events, emit = collector()
    router.submit({"id": "r1", "digest_list": []}, emit=emit)
    doc = ckdoc(pkg, word=1, rank=5, emitted=9)
    with pkg.faults.armed("router.place:nth=1"):
        router._on_job_event(link, {"id": "r1", "event": "failed",
                                    "error": "boom", "checkpoint": doc})
        wait_for(lambda: router.job("r1").state == "failed",
                 what="quarantined")
    (failed,) = [e for e in events if e.get("event") == "failed"]
    assert failed["checkpoint"] == doc
    router.submit({"id": "after", "digest_list": []})
    assert router.job("after").link is link


@pytest.mark.parametrize("op", ["request", "health_request"])
def test_link_send_fault_fails_op_typed(op, pkg):
    """The ``link.send`` seam on a real link: an injected fault fails the
    op typed, on the op stream and on the health stream."""
    import socket

    a, b = socket.socketpair(socket.AF_UNIX)
    link = pkg.fleet.EngineLink(a, "pair://", "e0")
    try:
        with pkg.faults.armed("link.send:nth=1"):
            with pytest.raises(pkg.fleet.FleetError) as exc:
                getattr(link, op)({"op": "stats"}, timeout=5.0)
        assert ("send failed" if op == "request" else "health scrape "
                "failed") in str(exc.value)
    finally:
        link.close()
        b.close()


# ---------------------------------------------------------------------------
# The stats surface
# ---------------------------------------------------------------------------


def test_fleet_section_carries_elastic_signals(pkg, routed):
    router, (link,) = routed(engine_capacity=2, max_pending=8,
                             shed_policy="oldest")
    scaler = bind_scaler(pkg, router)
    link.stats_reply = {"event": "stats", "jobs_done": 3,
                        "packed_fill": 0.5, "groups": {"g": 2}}
    stats = router.stats()
    fleet = stats["fleet"]
    assert (fleet["jobs_pending"], fleet["max_pending"],
            fleet["engine_capacity"], fleet["shed_policy"]) == \
        (0, 8, 2, "oldest")
    assert fleet["engines"][0]["health"] == "healthy"
    assert fleet["engines"][0]["packed_fill"] == 0.5
    assert fleet["autoscale"] == scaler.describe()
    assert (fleet["autoscale"]["min"], fleet["autoscale"]["max"]) == (1, 4)
    for key in ("jobs_rejected", "jobs_shed", "scrape_retries",
                "engines_quarantined", "engines_detached", "jobs_split",
                "shards_reassigned", "engine_deaths", "jobs_replayed"):
        assert fleet[key] == 0
    # Counts sum over live engines; ratios stay per engine.
    assert stats["jobs_done"] == 3 and stats["groups"] == {"g": 2}
    assert "packed_fill" not in stats


def test_fleet_counters_are_deltas_since_this_router(pkg, routed):
    pkg.telemetry.counter("fleet.engine_deaths").add(5)
    router, _ = routed()
    assert router.stats()["fleet"]["engine_deaths"] == 0


def test_router_imports_no_torch(tmp_path):
    """The router process is JSON, sockets and tables: importing the
    fleet module and the knob registry, binding an autoscaler (whose tick
    spawns through a failing spawner) and the stats op import no torch,
    so the router cannot create a CUDA context."""
    import subprocess

    code = ("import sys\n"
            "from hashcat_a5_table_generator_tpu_torch.runtime import fleet\n"
            "from hashcat_a5_table_generator_tpu_torch.runtime import "
            "autoscale\n"
            "from hashcat_a5_table_generator_tpu_torch import cli\n"
            "from hashcat_a5_table_generator_tpu_torch.runtime import knobs\n"
            "assert knobs.KNOBS['device']['layers']['cli']['default'] "
            "== 'cuda'\n"
            "r = fleet.FleetRouter(poll_s=0)\n"
            "def spawner():\n"
            "    raise OSError('no engine here')\n"
            "a = autoscale.Autoscaler(r, spawner, autoscale.AutoscaleConfig("
            "interval_s=0, cooldown_s=0))\n"
            "a.tick()\n"
            "assert r.autoscaler is a\n"
            "assert r.stats()['fleet']['autoscale']['spawn_failures'] == 1\n"
            "r.close(shutdown_engines=False)\n"
            "cli._build_fleet_parser()\n"
            "print('torch' in sys.modules)\n")
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


def test_split_setting_matches_reference(monkeypatch, capsys):
    from hashcat_a5_table_generator_tpu.runtime import env as j_env
    from hashcat_a5_table_generator_tpu_torch.runtime import env as t_env

    for val in ("", "auto", "on", "1", "OFF", "0", "no", "maybe"):
        monkeypatch.setenv("A5GEN_SPLIT", val)
        assert t_env.split_setting() == j_env.split_setting()
    err = capsys.readouterr().err
    assert "A5GEN_SPLIT" in err
    monkeypatch.delenv("A5GEN_SPLIT")
    assert t_env.split_setting() == "auto"
