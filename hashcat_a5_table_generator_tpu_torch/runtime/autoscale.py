"""Fleet autoscaling: the router-owned elastic control loop (the
reference package's ``runtime/autoscale.py``).

The router (``runtime/fleet.py``) holds every elasticity signal: per-engine
routed counts, scraped ``jobs_building`` / ``jobs_staged`` /
``jobs_queued``, the admission pending queue, drain state, deaths and the
health ladder.  The :class:`Autoscaler` acts on them with three moves,
each through a hook the router already has:

* **Scale up**: sustained backlog per capacity engine above
  ``scale_up_at`` for ``up_window`` consecutive ticks spawns one engine
  through the caller's ``spawner`` (``a5gen fleet`` wires
  :func:`runtime.fleet.spawn_engines`, forwarding its ``--device``).  A
  new engine is just an ``attach``.
* **Scale down**: sustained backlog below ``scale_down_at`` for
  ``down_window`` ticks drains the idlest engine (its routed jobs migrate
  off with their checkpoints) and reaps it once empty
  (``FleetRouter.detach``).
* **Replace**: a quarantined engine (the health ladder's circuit
  breaker) is drained and reaped the same way, and the min floor
  respawns capacity.  When the quarantined engine is the last placeable
  one, the replacement spawns first and the drain waits for the next
  tick: draining with nowhere to migrate would fail the jobs a
  quarantine promises to preserve.

Hysteresis (the consecutive-tick windows) and ``cooldown_s`` after every
action keep churn from flapping.  A failed spawn (the ``engine.spawn``
fault point) is counted (``fleet.spawn_failures``), logged, and retried
after the cooldown; the control loop itself never dies, and an engine
that cannot start is never replaced by one on another device.

The scaler owns one thread (``interval_s > 0``) or is ticked manually
(``interval_s=0``).  Two locks, always taken in this order:
``_tick_lock`` serializes whole ticks, and the inner ``_lock`` guards the
mutable state (streaks, cooldown, reap list) in short critical sections
only; router I/O (attach's socket connect, drain's sends, detach's
shutdown and process reap) runs outside ``_lock``, so ``describe()``
(the ``stats`` op's ``fleet.autoscale``) never stalls behind a slow
engine shutdown.  Imports no torch: the router process stays JSON,
sockets and tables.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from . import faults as faults_mod
from . import telemetry


@dataclass(frozen=True)
class AutoscaleConfig:
    """Elastic policy knobs (``a5gen fleet --autoscale MIN:MAX``).

    ``scale_up_at`` / ``scale_down_at`` are BACKLOG PER CAPACITY
    ENGINE — routed + engine-internal (scraped) jobs plus the router's
    admission-pending depth, divided by the engines able to take
    placements.  The windows are consecutive ``tick()`` observations
    (hysteresis); ``cooldown_s`` spaces actions so churn cannot
    flap."""

    min_engines: int = 1
    max_engines: int = 4
    scale_up_at: float = 2.0
    scale_down_at: float = 0.25
    up_window: int = 2
    down_window: int = 4
    cooldown_s: float = 10.0
    #: control-loop cadence; 0 = no thread (manual ``tick()``).
    interval_s: float = 1.0

    def __post_init__(self) -> None:
        if self.min_engines < 1:
            raise ValueError("autoscale min_engines must be >= 1")
        if self.max_engines < self.min_engines:
            raise ValueError(
                f"autoscale max ({self.max_engines}) must be >= min "
                f"({self.min_engines})"
            )
        if self.scale_down_at >= self.scale_up_at:
            raise ValueError(
                "scale_down_at must sit below scale_up_at "
                f"(got {self.scale_down_at} >= {self.scale_up_at}) — "
                "overlapping thresholds flap"
            )


#: What the spawner returns: (endpoint, engine_id, subprocess-or-None).
SpawnResult = Tuple[str, str, Optional[object]]


class Autoscaler:
    """The router-owned elastic control loop."""

    def __init__(self, router, spawner: Callable[[], SpawnResult],
                 config: Optional[AutoscaleConfig] = None) -> None:
        self.cfg = config if config is not None else AutoscaleConfig()
        self._router = router
        self._spawner = spawner
        #: serializes whole ticks (outer; never held by describe()).
        self._tick_lock = threading.Lock()
        #: guards the mutable state below in SHORT sections (inner —
        #: only ever taken under ``_tick_lock`` or alone).
        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        #: engine ids THIS scaler drained (scale-down / quarantine
        #: replacement) — reaped once their routed set empties.
        self._reaping: List[str] = []
        self._counters0 = {
            name: int(telemetry.counter(f"fleet.{name}").value)
            for name in ("scale_ups", "scale_downs", "spawn_failures")
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        router.autoscaler = self
        if self.cfg.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="a5-fleet-autoscale",
                daemon=True,
            )
            self._thread.start()

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 — loop must live
                # The control loop NEVER dies with the fleet it
                # manages: log and keep ticking (a persistent error
                # shows up as counters that stop moving).
                print(
                    f"a5gen: fleet: autoscale tick failed "
                    f"({type(exc).__name__}: {exc}); continuing",
                    file=sys.stderr,
                )

    # -- observability ---------------------------------------------------

    def describe(self) -> dict:
        """The ``stats`` op's ``fleet.autoscale`` section.  Takes only
        the inner state lock — a tick blocked on a slow engine
        shutdown can never stall a stats client."""
        with self._lock:
            reaping = list(self._reaping)
            up, down = self._up_streak, self._down_streak
            cooling = time.monotonic() < self._cooldown_until
        return {
            "min": self.cfg.min_engines,
            "max": self.cfg.max_engines,
            "scale_up_at": self.cfg.scale_up_at,
            "scale_down_at": self.cfg.scale_down_at,
            "up_streak": up,
            "down_streak": down,
            "cooling_down": cooling,
            "reaping": reaping,
            **{
                name: int(
                    telemetry.counter(f"fleet.{name}").value
                ) - base
                for name, base in self._counters0.items()
            },
        }

    # -- the control loop ----------------------------------------------

    def tick(self) -> None:
        """One control observation: reap drained engines, handle
        quarantined ones (replacement-first when they are the last
        capacity), then apply the hysteresis-windowed scale up/down
        policy.  Serialized by ``_tick_lock`` so manual ticks and the
        loop thread coexist; router I/O runs with only that outer
        lock held."""
        with self._tick_lock:
            if self._stop.is_set():
                return
            now = time.monotonic()
            self._reap_pass()
            if self._quarantine_pass(now):
                return  # this tick's action budget went to replacement
            capacity, backlog = self._signals()
            pool = len(capacity)
            per = backlog / max(1, pool)
            with self._lock:
                cooling = now < self._cooldown_until
                action = None
                if pool < self.cfg.min_engines:
                    # Min floor is an invariant, not a trend: replace
                    # lost capacity immediately (cooldown still spaces
                    # retries so a failing spawner cannot storm).
                    if not cooling:
                        action = "up"
                elif per >= self.cfg.scale_up_at and pool < \
                        self.cfg.max_engines:
                    self._up_streak += 1
                    self._down_streak = 0
                    if self._up_streak >= self.cfg.up_window \
                            and not cooling:
                        action = "up"
                elif per <= self.cfg.scale_down_at and pool > \
                        self.cfg.min_engines:
                    self._down_streak += 1
                    self._up_streak = 0
                    if self._down_streak >= self.cfg.down_window \
                            and not cooling:
                        action = "down"
                else:
                    # Between thresholds: the hysteresis dead band —
                    # streaks reset so only SUSTAINED pressure moves
                    # the pool.
                    self._up_streak = 0
                    self._down_streak = 0
            if action == "up":
                self._scale_up(now)
            elif action == "down":
                self._scale_down(capacity, now)

    def _signals(self) -> Tuple[list, float]:
        """Capacity pool + total backlog.  Per-engine backlog is the
        LARGER of the router's live routed count and the engine's
        scraped internal load (runnable+staged+building+queued) — the
        two overlap for router-placed jobs, and max() counts
        attach-mode engines' external clients without double counting
        the fleet's own."""
        from .fleet import scraped_load

        pending = self._router.pending_depth()
        capacity = []
        backlog = float(pending)
        for link in self._router.engines():
            if not link.alive or link.draining or \
                    link.health == "quarantined":
                continue
            capacity.append(link)
            backlog += max(len(link.routed), scraped_load(link.scrape))
        return capacity, backlog

    def _quarantine_pass(self, now: float) -> bool:
        """Circuit-broken engines drain (their jobs migrate off with
        checkpoints) and join the reap list — UNLESS a quarantined
        engine is the last placeable capacity: draining it would
        strand its migrating jobs on 'no live engine' and fail them,
        so the replacement spawns FIRST and the drain waits for the
        next tick (the quarantined engine keeps serving, degraded,
        until somewhere to migrate exists).  Returns True when this
        tick's action went to a replacement spawn."""
        links = self._router.engines()
        placeable_others = {
            q.engine_id: [
                l for l in links
                if l is not q and l.alive and not l.draining
                and l.health != "quarantined"
            ]
            for q in links
            if q.alive and q.health == "quarantined" and not q.draining
        }
        for eid, others in placeable_others.items():
            if not others:
                with self._lock:
                    cooling = now < self._cooldown_until
                if not cooling:
                    self._scale_up(now)
                    return True
                continue  # cooling down: drain waits, jobs keep serving
            try:
                self._router.drain(eid)
            except Exception as exc:  # noqa: BLE001 — engine-scoped
                print(
                    f"a5gen: fleet: draining quarantined engine "
                    f"{eid} failed "
                    f"({type(exc).__name__}: {exc}); retrying "
                    "next tick",
                    file=sys.stderr,
                )
                continue
            with self._lock:
                if eid not in self._reaping:
                    self._reaping.append(eid)
        return False

    def _reap_pass(self) -> None:
        """Detach (shutdown + reap the process of) every drained
        engine whose routed set has emptied — migration is
        asynchronous, so reaping trails draining by however long the
        pause→checkpoint→resubmit round trips take."""
        with self._lock:
            reaping = list(self._reaping)
        for eid in reaping:
            try:
                link = self._router._resolve(eid)
            except Exception:  # noqa: BLE001 — already gone
                with self._lock:
                    if eid in self._reaping:
                        self._reaping.remove(eid)
                continue
            if link.routed and link.alive:
                continue  # still migrating off
            try:
                self._router.detach(eid, shutdown=True)
            except Exception as exc:  # noqa: BLE001 — engine-scoped
                print(
                    f"a5gen: fleet: reaping engine {eid} failed "
                    f"({type(exc).__name__}: {exc}); retrying next "
                    "tick",
                    file=sys.stderr,
                )
                continue
            with self._lock:
                if eid in self._reaping:
                    self._reaping.remove(eid)

    def _scale_up(self, now: float) -> None:
        """Spawn + attach one engine.  The ``engine.spawn`` fault point
        makes the failure path exercisable: a failed spawn is counted,
        logged, and retried after the cooldown — never raised out of the
        control loop.  The spawn + attach (seconds of torch import and a
        CUDA context) run outside the state lock."""
        with self._lock:
            self._up_streak = 0
            self._cooldown_until = now + self.cfg.cooldown_s
        proc = None
        try:
            if faults_mod.ACTIVE is not None:
                faults_mod.ACTIVE.fire("engine.spawn")
            endpoint, engine_id, proc = self._spawner()
            self._router.attach(endpoint, engine_id, proc=proc)
        except Exception as exc:  # noqa: BLE001 — spawn is retryable
            telemetry.counter("fleet.spawn_failures").add(1)
            # A spawned-but-unattachable engine must not leak: every
            # cooldown retry would otherwise strand one more live
            # process holding the device and its socket.
            if proc is not None and hasattr(proc, "terminate"):
                try:
                    proc.terminate()
                    proc.wait(timeout=10)
                except Exception:  # noqa: BLE001 — best-effort reap
                    try:
                        proc.kill()
                        proc.wait(timeout=5)
                    except Exception:  # noqa: BLE001
                        pass
            print(
                f"a5gen: fleet: engine spawn failed "
                f"({type(exc).__name__}: {exc}); retrying after "
                f"{self.cfg.cooldown_s:g}s cooldown",
                file=sys.stderr,
            )
            return
        telemetry.counter("fleet.scale_ups").add(1)
        print(
            f"a5gen: fleet: scaled UP — spawned engine {engine_id} "
            f"({len(self._router.engines())} attached)",
            file=sys.stderr,
        )

    def _scale_down(self, capacity: list, now: float) -> None:
        """Drain the idlest engine (fewest routed jobs; newest on
        ties, keeping the warm old engines) and queue it for reaping."""
        with self._lock:
            self._down_streak = 0
            self._cooldown_until = now + self.cfg.cooldown_s
        victim = min(
            capacity, key=lambda l: (len(l.routed), -l.index)
        )
        try:
            self._router.drain(victim.engine_id)
        except Exception as exc:  # noqa: BLE001 — engine-scoped
            print(
                f"a5gen: fleet: scale-down drain of "
                f"{victim.engine_id} failed "
                f"({type(exc).__name__}: {exc}); retrying next window",
                file=sys.stderr,
            )
            return
        with self._lock:
            if victim.engine_id not in self._reaping:
                self._reaping.append(victim.engine_id)
        telemetry.counter("fleet.scale_downs").add(1)
        print(
            f"a5gen: fleet: scaled DOWN — draining idle engine "
            f"{victim.engine_id} for reap",
            file=sys.stderr,
        )
