"""The fleet's autoscaler (``runtime/autoscale.py``, ``a5gen fleet
--autoscale``) against the reference's.

Every scenario of the reference's ``TestAutoscaler``
(``tests/test_elastic.py``) runs through both packages' ``Autoscaler``
on one scripted router (``StubRouter``, manual ticks: ``interval_s=0``);
each case asserts the scenario's own expectations on both and that the
two packages took the same ``attach`` / ``drain`` / ``detach`` sequence
and reported the same ``describe()`` after every tick.  Then the CLI's
``--autoscale`` refusals against the reference's messages, and one
spawned fleet: ``a5gen fleet --engines 1 --autoscale 1:2 --device cpu``
over stdin takes a burst of small jobs, scales up to two engines and
back down to one (the drained engine's process gone), every job's hits
equal to the solo CLI's stdout.
"""

import io
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import pytest
from test_torch_fleet import digests_for, job_doc
from test_torch_pack import LEET, WORDS

import hashcat_a5_table_generator_tpu.runtime.autoscale as j_autoscale
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
import hashcat_a5_table_generator_tpu.runtime.telemetry as j_tel
import hashcat_a5_table_generator_tpu_torch.runtime.autoscale as t_autoscale
import hashcat_a5_table_generator_tpu_torch.runtime.faults as t_faults
import hashcat_a5_table_generator_tpu_torch.runtime.telemetry as t_tel
from hashcat_a5_table_generator_tpu import cli as j_cli
from hashcat_a5_table_generator_tpu_torch import cli as t_cli

REPO = pathlib.Path(__file__).resolve().parent.parent

PKGS = {
    "port": types.SimpleNamespace(autoscale=t_autoscale, faults=t_faults,
                                  telemetry=t_tel),
    "reference": types.SimpleNamespace(autoscale=j_autoscale,
                                       faults=j_faults, telemetry=j_tel),
}


class FakeLink:
    """What the autoscaler reads of an engine link."""

    def __init__(self, engine_id, index):
        self.engine_id = engine_id
        self.index = index
        self.alive = True
        self.draining = False
        self.health = "healthy"
        self.routed = set()
        self.scrape = {}
        self.proc = None


class StubRouter:
    """The autoscaler-facing router surface, scripted; every action it
    takes goes to ``log`` in order."""

    def __init__(self, links=(), pending=0):
        self.links = list(links)
        self.pending = pending
        self.autoscaler = None
        self.log = []

    def pending_depth(self):
        return self.pending

    def engines(self):
        return list(self.links)

    def _resolve(self, eid):
        for link in self.links:
            if link.engine_id == eid:
                return link
        raise KeyError(f"unknown engine {eid!r}")

    def drain(self, eid):
        link = self._resolve(eid)
        link.draining = True
        self.log.append(("drain", eid))
        return {"event": "draining", "engine": eid}

    def detach(self, eid, *, shutdown=True, timeout=30.0):
        link = self._resolve(eid)
        if link.routed:
            raise RuntimeError("still routed")
        self.links.remove(link)
        self.log.append(("detach", eid))

    def attach(self, endpoint, engine_id, *, proc=None, timeout=180.0):
        link = FakeLink(engine_id, len(self.links))
        self.links.append(link)
        self.log.append(("attach", engine_id))
        return link

    def actions(self, what):
        return [eid for act, eid in self.log if act == what]


class Run:
    """One scenario on one package: the router, the scaler, and the
    ``describe()`` after every tick."""

    def __init__(self, pkg, router, scaler):
        self.pkg, self.router, self.scaler = pkg, router, scaler
        self.described = []

    def tick(self):
        self.scaler.tick()
        self.described.append(self.scaler.describe())


def make_run(pkg, router, spawner=None, **cfg_kw):
    cfg_kw.setdefault("interval_s", 0)  # manual ticks
    cfg_kw.setdefault("cooldown_s", 1000.0)
    if spawner is None:
        n = [0]

        def spawner():
            n[0] += 1
            return (f"fake://spawn{n[0]}", f"spawn{n[0]}", None)

    a = pkg.autoscale
    return Run(pkg, router, a.Autoscaler(router, spawner,
                                         a.AutoscaleConfig(**cfg_kw)))


def links(*specs):
    """``FakeLink``s from ``(routed, health)`` pairs, ids e0, e1, ..."""
    out = []
    for i, (routed, health) in enumerate(specs):
        link = FakeLink(f"e{i}", i)
        link.routed, link.health = set(routed), health
        out.append(link)
    return out


# Each scenario takes a package and returns its Run, asserting the
# reference test's expectations on the way.


def scale_up_needs_sustained_window(pkg):
    router = StubRouter(links(("abc", "healthy")), pending=2)
    run = make_run(pkg, router, min_engines=1, max_engines=3,
                   scale_up_at=2.0, up_window=2)
    run.tick()  # streak 1: no action yet (hysteresis)
    assert router.log == []
    run.tick()  # streak 2: spawn
    assert router.actions("attach") == ["spawn1"]
    run.tick()  # cooldown: sustained pressure cannot spawn again yet
    run.tick()
    assert router.actions("attach") == ["spawn1"]
    assert run.described[-1]["cooling_down"] is True
    return run


def dead_band_resets_streaks(pkg):
    router = StubRouter(links(("abc", "healthy")))
    run = make_run(pkg, router, min_engines=1, max_engines=3,
                   scale_up_at=2.0, scale_down_at=0.5, up_window=2)
    run.tick()  # over threshold: streak 1
    router.links[0].routed = {"a"}  # per = 1.0: the dead band
    run.tick()
    assert run.described[-1]["up_streak"] == 0
    router.links[0].routed = {"a", "b", "c"}
    run.tick()  # the streak restarts at 1: still no spawn
    assert router.log == []
    return run


def scale_down_drains_idlest_then_reaps(pkg):
    router = StubRouter(links(("j", "healthy"), ("", "healthy")))
    run = make_run(pkg, router, min_engines=1, max_engines=2,
                   scale_down_at=0.6, down_window=2, cooldown_s=0.0)
    run.tick()  # per = 0.5: streak 1
    assert router.log == []
    run.tick()  # streak 2: drain the idle newest engine
    assert router.log == [("drain", "e1")]
    assert run.described[-1]["reaping"] == ["e1"]
    run.tick()  # the reap lands once the drained engine is empty
    assert router.actions("detach") == ["e1"]
    assert run.described[-1]["reaping"] == []
    return run


def min_floor_respawns_immediately(pkg):
    router = StubRouter([])
    run = make_run(pkg, router, min_engines=1, max_engines=2,
                   cooldown_s=0.0)
    run.tick()  # below min: no window needed
    assert router.log == [("attach", "spawn1")]
    return run


def quarantined_engine_drained_and_replaced(pkg):
    router = StubRouter(links(("", "quarantined"), ("", "healthy")))
    run = make_run(pkg, router, min_engines=2, max_engines=3,
                   cooldown_s=0.0)
    run.tick()
    # The quarantine pass drains the broken engine; the min floor
    # respawns the lost capacity.
    assert router.log == [("drain", "e0"), ("attach", "spawn1")]
    run.tick()  # once empty it reaps
    assert "e0" in router.actions("detach")
    return run


def last_capacity_quarantine_spawns_before_drain(pkg):
    """Draining the last placeable engine would strand its migrating
    jobs: the replacement spawns first, the drain waits a tick."""
    router = StubRouter(links(("j", "quarantined")))
    run = make_run(pkg, router, min_engines=1, max_engines=2,
                   cooldown_s=0.0)
    run.tick()
    assert router.log == [("attach", "spawn1")]
    run.tick()  # somewhere to migrate now exists: drain
    assert router.actions("drain") == ["e0"]
    return run


def spawn_fault_backs_off_and_retries(pkg):
    router = StubRouter([])
    run = make_run(pkg, router, min_engines=1, max_engines=2,
                   cooldown_s=0.0)
    failures = pkg.telemetry.counter("fleet.spawn_failures")
    before = int(failures.value)
    with pkg.faults.armed("engine.spawn:nth=1"):
        run.tick()  # injected spawn failure
        assert router.log == []
        assert int(failures.value) == before + 1
        run.tick()  # cooldown 0: the retry succeeds
        assert router.log == [("attach", "spawn1")]
    assert run.described[-1]["spawn_failures"] == 1
    return run


def failed_attach_reaps_the_spawned_process(pkg):
    """A spawned-but-unattachable engine does not leak: the scale-up
    failure path terminates the process it started."""

    class FakeProc:
        def __init__(self):
            self.terminated = self.waited = False

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            self.waited = True

    proc = FakeProc()
    router = StubRouter([])

    def bad_attach(endpoint, engine_id, *, proc=None, timeout=180.0):
        router.log.append(("attach-failed", engine_id))
        raise OSError("engine never listened")

    router.attach = bad_attach
    run = make_run(pkg, router, spawner=lambda: ("fake://x", "x", proc),
                   min_engines=1, max_engines=2, cooldown_s=0.0)
    run.tick()  # the min floor tries to spawn; attach fails
    assert proc.terminated and proc.waited
    assert router.actions("attach") == []
    return run


def max_engines_is_a_ceiling(pkg):
    router = StubRouter(links(("abcd", "healthy")))
    run = make_run(pkg, router, min_engines=1, max_engines=1,
                   scale_up_at=2.0, up_window=1, cooldown_s=0.0)
    run.tick()
    run.tick()
    assert router.log == []
    return run


SCENARIOS = [
    scale_up_needs_sustained_window, dead_band_resets_streaks,
    scale_down_drains_idlest_then_reaps, min_floor_respawns_immediately,
    quarantined_engine_drained_and_replaced,
    last_capacity_quarantine_spawns_before_drain,
    spawn_fault_backs_off_and_retries,
    failed_attach_reaps_the_spawned_process, max_engines_is_a_ceiling,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_same_actions_and_describe(scenario):
    runs = {name: scenario(pkg) for name, pkg in PKGS.items()}
    port, ref = runs["port"], runs["reference"]
    assert port.router.log == ref.router.log
    assert port.described == ref.described
    assert port.router.autoscaler is port.scaler
    for run in runs.values():
        run.scaler.close()


BAD_CONFIGS = [dict(min_engines=2, max_engines=1),
               dict(scale_up_at=1.0, scale_down_at=1.0),
               dict(min_engines=0)]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=["max-below-min", "overlap", "min-zero"])
def test_config_validates_as_the_reference(kw):
    msgs = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as exc:
            pkg.autoscale.AutoscaleConfig(**kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_loop_thread_ticks_and_stops():
    """``interval_s > 0``: the scaler's own thread ticks (here: the min
    floor spawns) and ``close()`` joins it."""
    router = StubRouter([])
    scaler = t_autoscale.Autoscaler(
        router, lambda: ("fake://t", "t", None),
        t_autoscale.AutoscaleConfig(min_engines=1, max_engines=1,
                                    interval_s=0.01, cooldown_s=0.0))
    deadline = time.monotonic() + 10
    while not router.log and time.monotonic() < deadline:
        time.sleep(0.01)
    scaler.close()
    assert router.log[:1] == [("attach", "t")]
    assert not scaler._thread.is_alive()


# ---------------------------------------------------------------------------
# a5gen fleet --autoscale: the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--engines", "a.sock,b.sock", "--autoscale", "1:2"],
    ["--engines", "1", "--autoscale", "x:2"],
    ["--engines", "1", "--autoscale", "3:2"],
    ["--engines", "1", "--autoscale", "1:2", "--scale-up-at", "0.5",
     "--scale-down-at", "0.5"],
], ids=["attached-engines", "malformed", "max-below-min", "overlap"])
def test_autoscale_refusals_match_the_reference(argv):
    """Each refusal exits before any engine spawns, with the reference's
    exit and message."""
    codes = []
    for cli in (t_cli, j_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["fleet", *argv])
        codes.append(exc.value.code)
    assert codes[0] == codes[1]
    assert isinstance(codes[0], str) and "--autoscale" in codes[0]


def test_scale_flags_parse_as_the_reference():
    argv = ["--engines", "2", "--autoscale", "1:3", "--scale-up-at", "3",
            "--scale-down-at", "0.5", "--scale-window", "4",
            "--scale-cooldown", "1"]
    got = vars(t_cli._build_fleet_parser().parse_args(argv))
    want = vars(j_cli._build_fleet_parser().parse_args(argv))
    for key in ("autoscale", "scale_up_at", "scale_down_at",
                "scale_window", "scale_cooldown"):
        assert got[key] == want[key]


#: ``a5gen fleet`` through the CLI, each spawned engine's pid to a log
#: file (argv[1]) as it starts.
FLEET_PIDS = (
    "import json, subprocess, sys\n"
    "from hashcat_a5_table_generator_tpu_torch import cli\n"
    "from hashcat_a5_table_generator_tpu_torch.runtime import fleet\n"
    "log = sys.argv[1]\n"
    "class Popen(subprocess.Popen):\n"
    "    def __init__(self, args, **kw):\n"
    "        super().__init__(args, **kw)\n"
    "        eid = list(args)[list(args).index('--engine-id') + 1]\n"
    "        with open(log, 'a') as fh:\n"
    "            fh.write(json.dumps({'engine': eid, 'pid': self.pid}) "
    "+ '\\n')\n"
    "fleet.subprocess = type(sys)('subprocess')\n"
    "fleet.subprocess.__dict__.update(subprocess.__dict__, Popen=Popen)\n"
    "sys.exit(cli.main(sys.argv[2:]))\n")

#: The spawned test's bound: the fleet, both engines' start-ups, the
#: burst and the scale-down.
ELASTIC_LIMIT = 60


def solo_cli_lines(tmp_path, name, words, digests):
    """The port's CLI crack run on ``words`` x the test table: its stdout
    lines (``digest:plain``), sorted."""
    wl = tmp_path / f"{name}.txt"
    wl.write_bytes(b"\n".join(words) + b"\n")
    dg = tmp_path / f"{name}.digests"
    dg.write_text("".join(d.hex() + "\n" for d in digests))
    table = tmp_path / "leet.table"
    table.write_bytes(b"".join(k + b"=" + v + b"\n"
                               for k, vs in LEET.items() for v in vs))
    buf = io.BytesIO()
    real = sys.stdout
    sys.stdout = io.TextIOWrapper(buf, write_through=True)
    try:
        rc = t_cli.main([str(wl), "-t", str(table), "--backend", "device",
                         "--digests", str(dg), "--device", "cpu",
                         "--lanes", "64", "--blocks", "16"])
    finally:
        sys.stdout.detach()
        sys.stdout = real
    assert rc == 0
    return sorted(buf.getvalue().decode().splitlines())


def test_a5gen_fleet_autoscale_scales_up_then_down(tmp_path):
    """``a5gen fleet --engines 1 --autoscale 1:2 --device cpu`` over
    stdin: a burst of eight jobs past the one engine's capacity spawns a
    second engine (one scale-up); once the burst is done the idlest
    engine is drained and reaped (one scale-down, its process gone);
    every job's hits equal the solo CLI's stdout, and the ``stats`` op's
    ``fleet.autoscale`` counts one of each.  (That the spawned engine
    takes placements is ``chip_smoke.py`` phase 11's check, on the card:
    here it depends on the host's load.)"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("A5GEN_FAULTS", None)
    env["OMP_NUM_THREADS"] = "1"
    # Eight jobs of ~1 s each on one CPU engine: the burst outlasts the
    # second engine's start-up (~3 s).
    words = WORDS * 24
    docs = {f"b{i}": (words, digests_for(words, (i, -1), 10 + i))
            for i in range(8)}
    pids_log = tmp_path / "pids.jsonl"
    p = subprocess.Popen(
        [sys.executable, "-c", FLEET_PIDS, str(pids_log), "fleet",
         "--engines", "1", "--autoscale", "1:2", "--device", "cpu",
         "--engine-dir", str(tmp_path / "eng"), "--lanes", "64",
         "--blocks", "16", "--superstep", "1", "--poll", "0.5",
         "--engine-capacity", "1", "--scale-window", "1",
         "--scale-cooldown", "0.5", "--scale-up-at", "1.5",
         "--scale-down-at", "0.5"],
        cwd=REPO, env=env, text=True, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    events, lock = [], threading.Lock()

    def read():
        for line in p.stdout:
            with lock:
                events.append(json.loads(line))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + ELASTIC_LIMIT

    def wait_for(pred, what):
        while time.monotonic() < deadline:
            with lock:
                evs = list(events)
            if pred(evs):
                return evs
            assert p.poll() is None, p.stderr.read()
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}: {evs[-3:]}")

    def stats():
        n = sum(e["event"] == "stats" for e in events)
        p.stdin.write('{"op": "stats"}\n')
        p.stdin.flush()
        evs = wait_for(lambda e: sum(x["event"] == "stats" for x in e) > n,
                       "stats")
        return [e for e in evs if e["event"] == "stats"][-1]["fleet"]

    try:
        for jid, (ws, digs) in docs.items():
            p.stdin.write(json.dumps(job_doc(jid, ws, digs)) + "\n")
        p.stdin.flush()
        wait_for(lambda e: sum(x["event"] == "done" for x in e)
                 == len(docs), "the burst's done events")
        while True:
            fleet = stats()
            if fleet["autoscale"]["scale_downs"] == 1 and \
                    len(fleet["engines"]) == 1 and \
                    not fleet["autoscale"]["reaping"]:
                break
            assert time.monotonic() < deadline, fleet
            time.sleep(0.25)
        assert fleet["autoscale"]["scale_ups"] == 1
        assert fleet["autoscale"]["spawn_failures"] == 0
        assert fleet["engines_detached"] == 1
        spawned = {d["engine"]: d["pid"] for d in
                   map(json.loads, pids_log.read_text().splitlines())}
        assert sorted(spawned) == ["eng0", "eng1"]
        (kept,) = [m["engine"] for m in fleet["engines"]]
        (reaped,) = set(spawned) - {kept}
        with pytest.raises(ProcessLookupError):
            os.kill(spawned[reaped], 0)
        p.stdin.write('{"op": "shutdown"}\n')
        p.stdin.close()
        assert p.wait(ELASTIC_LIMIT) == 0
        reader.join(10)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    err = p.stderr.read()
    assert "elastic 1:2" in err and "scaled UP" in err \
        and "scaled DOWN" in err, err
    for jid, (ws, digs) in docs.items():
        got = sorted(
            f"{e['digest']}:{bytes.fromhex(e['plain_hex']).decode()}"
            for e in events if e.get("id") == jid and e["event"] == "hit")
        assert got == solo_cli_lines(tmp_path, jid, ws, digs), jid
