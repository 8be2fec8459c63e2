"""Deterministic, seeded fault injection at the sweep's real seams, and
the retry policy that recovers from them (the reference package's
``runtime/faults.py``, copied; standard library only).

A :class:`FaultPlan` arms named injection points with fire-on-nth-call
or fire-with-probability-under-a-fixed-seed rules, and the sweep asks
the plan to fire at each seam.  When nothing is armed a seam costs one
module-attribute ``None`` check::

    if faults.ACTIVE is not None:
        faults.ACTIVE.fire("superstep.dispatch")

Injection never changes what an unfaulted run emits.

Injection points this package fires (the grammar also takes the
reference's other points, so one ``A5GEN_FAULTS`` spec arms both
packages):

========================  ===================================================
``superstep.dispatch``    before each device dispatch (superstep drive, the
                          per-launch pipeline, candidates mode)
``superstep.fetch``       before each consumed counters fetch (superstep
                          drive, the per-launch pipeline's drain)
``checkpoint.write``      before a checkpoint write (crash-before-write)
``device.init``           before the sweep's tables go to the device
``chunk.compile``         before a streamed chunk's compile, on the ring's
                          worker (``ops.packing.ChunkCompiler``: restarted
                          once, then the error propagates)
========================  ===================================================

Arming: ``A5GEN_FAULTS=<spec>`` (read through ``runtime/env.py``) or
:func:`install` / :func:`armed`.  The spec grammar is
``point[:key=value,...][;point2:...]`` with keys

* ``nth=N``     fire on the Nth call to the point (1-based; default 1)
* ``p=X``       instead of ``nth``: fire each call with probability X
                under the plan's fixed ``seed`` (deterministic sequence)
* ``seed=N``    the plan-wide RNG seed (default 0)
* ``error=T``   exception type: ``FaultInjected`` (default, transient),
                ``FetchTimeout``, ``WorkerDeath`` (escapes ``except
                Exception``), ``OSError``
* ``persist``   keep firing on every triggering call (default one-shot)
* ``kill``      SIGKILL the process instead of raising
* ``delay=S``   sleep S seconds before acting (stall simulation)

Examples::

    A5GEN_FAULTS='superstep.dispatch:nth=2'
    A5GEN_FAULTS='superstep.fetch:error=FetchTimeout,p=0.2,seed=7'
    A5GEN_FAULTS='superstep.fetch:kill,nth=3'
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class FaultError(RuntimeError):
    """Base class of every injected (or watchdog-raised) fault."""


class FaultInjected(FaultError):
    """A deliberately injected transient device-style error: the retry
    supervisor answers it with a bounded re-dispatch from the last
    consumed boundary."""


class FetchTimeout(FaultError):
    """A consumed device-to-host fetch exceeded the configured watchdog
    (``SweepConfig.fetch_timeout_s``).  Typed so the supervisor treats a
    wedged fetch as transient (re-dispatch) instead of hanging the drive
    forever; also injectable by name."""


class WorkerDeath(BaseException):
    """An injected worker death: derives from ``BaseException`` so it
    escapes ``except Exception`` nets."""


#: ``error=`` vocabulary of the fault spec.
ERROR_TYPES: Dict[str, type] = {
    "FaultInjected": FaultInjected,
    "FetchTimeout": FetchTimeout,
    "WorkerDeath": WorkerDeath,
    "OSError": OSError,
}

#: The named injection points (the reference's set: a spec naming
#: anything else fails loudly at parse time — a typo must not silently
#: disarm a fault).
POINTS = frozenset({
    "superstep.dispatch",
    "superstep.fetch",
    "packed.pump",
    "admission.build",
    "chunk.compile",
    "checkpoint.write",
    "serve.client",
    "device.init",
    "router.place",
    "link.send",
    "engine.spawn",
})

def is_transient(exc: BaseException) -> bool:
    """Whether the retry supervisor may recover from ``exc`` by
    re-dispatching from the last consumed boundary: injected transients
    and wedged-fetch timeouts.  Anything else propagates at once: a
    ``ValueError`` from bad inputs or a failed host re-verification is a
    deterministic bug, and a real CUDA error (torch's ``AcceleratorError``:
    an illegal address, an Xid, an ECC fault) leaves the process's CUDA
    context unusable, so no retry in the same process can succeed.  A
    sweep survives such a fault in a fresh process that resumes its
    checkpoint."""
    return isinstance(exc, (FaultInjected, FetchTimeout))


def supervise_retry(exc: BaseException, attempts: int, *,
                    attempts_budget: int, backoff_s: float,
                    label: str) -> None:
    """The one retry policy: re-raise ``exc`` unless it is transient
    (:func:`is_transient`) with attempts remaining; otherwise count the
    retry, print the operator notice and sleep the exponential backoff so
    the caller re-dispatches from its last consumed boundary.  Called
    from an ``except`` block — the bare ``raise`` re-raises the active
    exception with its traceback."""
    if attempts >= int(attempts_budget) or not is_transient(exc):
        raise
    delay = float(backoff_s) * (2.0 ** attempts)
    from . import telemetry

    telemetry.counter("faults.retries").add(1)
    telemetry.counter("faults.backoff_s").add(delay)
    import sys
    import time

    print(
        f"a5gen: transient device error in {label} "
        f"({type(exc).__name__}: {exc}); retry "
        f"{attempts + 1}/{int(attempts_budget)} after {delay:.2f}s "
        "backoff from the last fetched boundary",
        file=sys.stderr,
    )
    time.sleep(delay)


def await_ready(event: object, timeout_s: "Optional[float]") -> None:
    """The fetch watchdog: when ``timeout_s`` is set, poll ``event``
    (a ``torch.cuda.Event`` recorded after the fetch's copies) with
    ``query()``, sleeping between polls, and raise a typed
    :class:`FetchTimeout` — transient to the supervisor — at the deadline,
    instead of letting a wedged device block the drive forever.  ``None``
    / 0 (the default) and ``event`` None (CPU tensors: nothing to wait
    for) return at once: the caller's plain wait stands."""
    if not timeout_s or event is None:
        return
    import time

    deadline = time.monotonic() + float(timeout_s)
    nap = min(0.001, float(timeout_s) / 20.0)
    while not event.query():
        if time.monotonic() >= deadline:
            from . import telemetry

            telemetry.counter("faults.fetch_timeouts").add(1)
            raise FetchTimeout(
                f"device fetch still pending after "
                f"{float(timeout_s):.2f}s (the fetch_timeout_s watchdog)"
            )
        time.sleep(nap)


class FaultRule:
    """One armed fault: a point, a trigger, and an action."""

    __slots__ = ("point", "nth", "p", "error", "persist", "kill",
                 "delay_s", "done")

    def __init__(self, point: str, *, nth: Optional[int] = None,
                 p: Optional[float] = None, error: str = "FaultInjected",
                 persist: bool = False, kill: bool = False,
                 delay_s: float = 0.0) -> None:
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} "
                f"(want one of {', '.join(sorted(POINTS))})"
            )
        if error not in ERROR_TYPES:
            raise ValueError(
                f"unknown fault error {error!r} "
                f"(want one of {', '.join(sorted(ERROR_TYPES))})"
            )
        if nth is not None and p is not None:
            raise ValueError("fault rule takes nth= OR p=, not both")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {p}")
        self.point = point
        self.nth = int(nth) if nth is not None else (1 if p is None else None)
        self.p = p
        self.error = error
        self.persist = bool(persist)
        self.kill = bool(kill)
        self.delay_s = float(delay_s)
        self.done = False


class FaultPlan:
    """An armed set of :class:`FaultRule` s with per-point call counters
    and one seeded RNG — the whole plan is deterministic: same rules,
    same seed, same call sequence, same firing pattern.  Thread-safe."""

    def __init__(self, rules: "List[FaultRule]", seed: int = 0) -> None:
        import random

        self.rules = list(rules)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: ``(point, call_number)`` log of every firing — tests assert
        #: against this, never against timing.
        self.fired: List[Tuple[str, int]] = []

    def calls(self, point: str) -> int:
        """How many times ``point`` was reached (fired or not)."""
        with self._lock:
            return self._calls.get(point, 0)

    def fire(self, point: str) -> None:
        """One arrival at ``point``: count it, and raise (or kill) if a
        rule triggers.  Call sites guard with ``faults.ACTIVE is not
        None``."""
        with self._lock:
            count = self._calls.get(point, 0) + 1
            self._calls[point] = count
            rule = None
            for r in self.rules:
                if r.point != point or r.done:
                    continue
                if r.nth is not None:
                    hit = count >= r.nth if r.persist else count == r.nth
                else:
                    hit = self._rng.random() < r.p
                if hit:
                    rule = r
                    if not r.persist:
                        r.done = True
                    break
            if rule is None:
                return
            self.fired.append((point, count))
        if rule.delay_s:
            import time

            time.sleep(rule.delay_s)
        if rule.kill:
            import os
            import signal

            os.kill(os.getpid(), signal.SIGKILL)
        raise ERROR_TYPES[rule.error](
            f"injected fault at {point} (call {count})"
        )


def parse_plan(spec: str) -> FaultPlan:
    """Parse the ``A5GEN_FAULTS`` grammar (module docstring) into a
    :class:`FaultPlan`.  Malformed specs raise ``ValueError``: a fault
    layer that silently disarms on a typo would certify recovery paths it
    never exercised."""
    rules: List[FaultRule] = []
    seed = 0
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, opts = part.partition(":")
        kw: Dict[str, object] = {}
        for opt in filter(None, (o.strip() for o in opts.split(","))):
            key, eq, val = opt.partition("=")
            if not eq:
                if key in ("persist", "kill"):
                    kw[key] = True
                    continue
                raise ValueError(
                    f"fault option {key!r} needs a value (or is not a "
                    "flag; flags: persist, kill)"
                )
            if key == "nth":
                kw["nth"] = int(val)
            elif key == "p":
                kw["p"] = float(val)
            elif key == "seed":
                seed = int(val)
            elif key == "error":
                kw["error"] = val
            elif key == "delay":
                kw["delay_s"] = float(val)
            else:
                raise ValueError(f"unknown fault option {key!r}")
        rules.append(FaultRule(point.strip(), **kw))  # type: ignore[arg-type]
    if not rules:
        raise ValueError(f"fault spec {spec!r} names no injection points")
    return FaultPlan(rules, seed=seed)


#: The process-wide armed plan; ``None`` (the production state) makes
#: every seam a single attribute load + ``is not None`` check.
ACTIVE: Optional[FaultPlan] = None

#: The spec string the current ``ACTIVE`` was installed from by
#: :func:`ensure_env` (None = not env-installed: explicit installs own
#: the slot and env changes leave them alone).
_ENV_SPEC: Optional[str] = None


def install(plan: "FaultPlan | str | None") -> Optional[FaultPlan]:
    """Arm ``plan`` process-wide (a spec string is parsed first); ``None``
    disarms.  Returns the installed plan.  Explicit installs take the
    slot from any env-armed plan."""
    global ACTIVE, _ENV_SPEC
    if isinstance(plan, str):
        plan = parse_plan(plan)
    ACTIVE = plan
    _ENV_SPEC = None
    return plan


def clear() -> None:
    """Disarm."""
    install(None)


def ensure_env() -> None:
    """Arm from ``A5GEN_FAULTS`` if set — called at ``Sweep``
    construction, never at import.  Re-reads the variable each call; an
    explicitly installed plan is never overridden, and clearing the
    variable disarms an env-armed plan."""
    global ACTIVE, _ENV_SPEC
    from .env import faults_spec

    spec = faults_spec()
    if spec == _ENV_SPEC:
        return
    if ACTIVE is not None and _ENV_SPEC is None:
        return  # explicit install wins over the environment
    ACTIVE = parse_plan(spec) if spec else None
    _ENV_SPEC = spec


class armed:
    """Context manager arming ``spec`` and restoring the previous plan on
    exit."""

    def __init__(self, spec: "FaultPlan | str | None") -> None:
        self._spec = spec
        self._prev: Optional[FaultPlan] = None
        self._prev_env: Optional[str] = None
        self.plan: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        global ACTIVE, _ENV_SPEC
        self._prev, self._prev_env = ACTIVE, _ENV_SPEC
        self.plan = install(self._spec)
        return self.plan

    def __exit__(self, *exc: object) -> None:
        global ACTIVE, _ENV_SPEC
        ACTIVE, _ENV_SPEC = self._prev, self._prev_env
