"""The fleet router: one front end over a pool of resident engines (the
reference's ``runtime/fleet.py``).

One ``a5gen serve`` process (``runtime/engine.py``) multiplexes many
tenants on one card; the fleet scales the SAME JSONL wire
(``runtime/protocol.py``, ``PROTOCOL.json``) across N engines.
:class:`FleetRouter` owns a pool of engine endpoints — spawned locally
(:func:`spawn_engines`: ``python -m hashcat_a5_table_generator_tpu_torch
serve``, on the GPU unless ``--device cpu`` is forwarded) or attached by
unix-socket path, engines of either package — and speaks the serve
protocol upstream, so serve clients work unmodified:
``submit``/``pause``/``resume``/``cancel``/``stats``/``metrics``/
``shutdown`` pass through, and the router adds ``drain``, ``migrate``
and ``split``.

* **Placement** is static-config affinity: a submit document's
  doc-level static config hashes (:func:`static_affinity_token`, a copy
  of ``runtime.fuse.static_affinity_token``) to the token the engine
  computes for its resident slots (``fuse.affinity_token``, reported by
  the ``stats`` op's ``resident_groups``), so jobs that could share a
  compiled step or fuse into one packed dispatch land on the engine
  already running their kind; ties break on load from the scraped
  placement signals.  ``place='round-robin'`` is the control arm.
* **Rebalance** (drain/migrate) is pause → checkpoint over the wire →
  resubmit with the checkpoint on the target engine: checkpoints are a
  fingerprint-checked JSON wire format shared by both packages, so
  migration is resubmission.  A draining engine takes no new placements.
* **Crash-replay**: an engine death (torn socket, a wedge the health
  poller's watchdog detects, a reaped process) requeues every routed job
  from its last router-held checkpoint onto the survivors, with
  ``replay_mute`` = hits already delivered downstream, which the
  engine's muted recorder withholds: per-job hit streams stay
  byte-identical to solo runs across engine deaths.
* **Admission control and backpressure**: placements are gated by
  ``engine_capacity``; jobs that cannot place ride a bounded pending
  queue (``max_pending``), and past it ``submit`` fails with the typed
  overload rejection (:class:`FleetOverloaded`, rendered
  ``{"error": "overloaded", "retry_after_s": ...}``); ``shed_policy``
  picks reject / oldest / queue, ``deadline_s`` carriers shed first and
  ``per_tenant`` caps one tenant's unsettled jobs.
* **The health ladder**: each engine walks healthy → degraded →
  quarantined on scrape strain (slow or failed scrapes, rising
  ``group_demotions`` / ``job_restarts``, repeated checkpoint-bearing
  job failures).  A degraded engine places last; a quarantined one
  takes no placements.  Quarantine needs an attached autoscaler (the
  replacer; ``autoscaler`` stays None until one binds), so a fixed pool
  tops out at degraded.
* **Giant-job split**: one oversized crack job is rewritten N ways with
  disjoint ``config.pod = [i, N]`` rank-stride stripes, each on its own
  engine; :class:`_SplitMerge`'s k-way merge releases the shards'
  (word, rank)-ordered streams as ONE exactly-once stream, and a dead
  engine's stripe reassigns from its acked boundary through the
  crash-replay path.

Candidates jobs migrate and crash-replay by restart (cancel + fresh
resubmission, output truncated): their output file is engine-local.

The router holds no device state and imports no torch: it is JSON,
sockets and tables, so it creates no CUDA context and never competes
with its engines for the card.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, \
    TextIO, Tuple

from . import faults as faults_mod
from . import protocol
from . import telemetry
from .checkpoint import validate_checkpoint_doc

#: Module path engines are spawned from (``python -m <this>``): this
#: package.
_PACKAGE = __name__.rsplit(".", 2)[0]


def static_affinity_token(**fields) -> str:
    """Stable 12-hex token over named static-config fields: a copy of
    ``runtime.fuse.static_affinity_token`` (which imports torch; the
    router does not), held equal to it by the tests."""
    import hashlib

    blob = "|".join(f"{k}={fields[k]!r}" for k in sorted(fields))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


class FleetError(RuntimeError):
    """A fleet-level operation failed (no live engine, an engine
    rejected a routed document, an ack timed out)."""


class FleetOverloaded(FleetError):
    """The typed overload rejection: the router's bounded
    admission surface is full (pending queue at ``max_pending``, or a
    tenant over its in-flight cap).  Carries ``retry_after_s`` — the
    router's backoff estimate — so clients back off instead of
    hammering; the JSONL front-end renders it as
    ``{"event": "error", "error": "overloaded", "retry_after_s": ...}``."""

    def __init__(self, reason: str, retry_after_s: float) -> None:
        super().__init__(reason)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)

    def event(self, jid: "Optional[str]" = None) -> dict:
        return protocol.ev_error_overloaded(
            self.reason, self.retry_after_s, jid=jid
        )


#: The health ladder's states, in degradation order.
HEALTH_STATES = ("healthy", "degraded", "quarantined")


class _NoCapacity(FleetError):
    """Internal: every placeable engine is at ``engine_capacity`` —
    the caller queues (admission control) instead of failing loudly."""


def scraped_load(scrape: dict) -> int:
    """An engine's internal load from its ``stats`` scrape — the ONE
    definition placement (:meth:`FleetRouter._load_score`) and the
    autoscaler's backlog signal share, so they can never disagree
    about what "loaded" means."""
    return (
        scrape.get("jobs_runnable", scrape.get("jobs_active", 0))
        + scrape.get("jobs_staged", 0)
        + scrape.get("jobs_building", 0)
        + scrape.get("jobs_queued", 0)
    )


# ---------------------------------------------------------------------------
# Engine endpoints
# ---------------------------------------------------------------------------


class EngineLink:
    """Router-side handle of ONE engine: the JSONL socket, a reader
    thread demuxing its event stream, and the routing bookkeeping the
    placement reads.

    Event demux: events carrying a job ``id`` flow to the router's
    job-event handler — EXCEPT the ``accepted`` ack a pending
    :meth:`request` is waiting for.  Id-less control replies
    (``stats``/``metrics``/``bye``/``error``) answer the pending
    request; the engine session handles ops sequentially per
    connection, so one in-flight request per link (serialized by
    ``_ctl_lock``) correlates exactly."""

    def __init__(self, sock: socket.socket, endpoint: str,
                 engine_id: str, *,
                 proc: "Optional[subprocess.Popen]" = None,
                 index: int = 0,
                 on_event: Optional[Callable] = None,
                 on_death: Optional[Callable] = None) -> None:
        self.endpoint = endpoint
        self.engine_id = engine_id
        self.proc = proc
        self.index = index
        self.alive = True
        self.draining = False
        #: last scraped ``stats`` event (placement signals).
        self.scrape: dict = {}
        #: consecutive failed health scrapes (watchdog input).
        self.misses = 0
        #: router-level job ids currently routed here.
        self.routed: set = set()
        #: health-ladder state: ``healthy`` places
        #: normally, ``degraded`` places last, ``quarantined`` never
        #: places (the autoscaler drains + replaces it).  All ladder
        #: fields are written by the ROUTER (scrape/event paths), never
        #: by the link's own threads.
        self.health = "healthy"
        #: consecutive strained scrapes (slow/failed scrape, rising
        #: recovery-ladder deltas) — degrade/quarantine input.
        self.strikes = 0
        #: consecutive clean scrapes while degraded — recovery input.
        self.clean = 0
        #: checkpoint-bearing job failures off this engine (quarantine
        #: resubmissions) — the repeated-crash-replay ladder input.
        self.replay_fails = 0
        #: last scrape's recovery-ladder counters (delta base).
        self.ladder_prev: dict = {}
        #: next scheduled poll tick (monotonic; per-engine jitter so N
        #: engines never stampede one scrape tick).
        self.next_poll = 0.0
        self._sock = sock
        self._fin = sock.makefile("r", encoding="utf-8")
        self._fout = sock.makefile("w", encoding="utf-8")
        self._wlock = threading.Lock()
        self._ctl_lock = threading.Lock()
        self._waiter: "Optional[Tuple[Optional[str], queue.Queue]]" = None
        #: id-less replies to drop: a timed-out stats/metrics/shutdown
        #: request leaves its reply in flight, and the engine answers
        #: per-connection in order — the NEXT id-less event is the
        #: stale reply, not the new request's (see :meth:`request`).
        self._skip_replies = 0
        self._skip_lock = threading.Lock()
        #: lazily-opened SECOND connection for health scrapes: the
        #: engine serves one session per connection, so stats replies
        #: here can never queue behind a blocking op (a pause parking
        #: at a superstep boundary) on the main op stream — a healthy
        #: engine mid-drain must not look dead to the watchdog, and a
        #: scrape timeout must not desync the main link's reply
        #: correlation.
        self._health_sock = None
        self._health_file = None
        self._health_lock = threading.Lock()
        self._closing = False
        self._on_event = on_event
        self._on_death = on_death
        self._reader_thread = threading.Thread(
            target=self._reader, name=f"a5-fleet-link-{engine_id}",
            daemon=True,
        )
        self._reader_thread.start()

    @classmethod
    def connect(cls, endpoint: str, engine_id: Optional[str] = None,
                *, timeout: float = 180.0, **kw: Any) -> "EngineLink":
        """Connect to an engine's unix socket, retrying until it is
        listening (a freshly spawned engine binds only after its torch
        import)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(endpoint)
                break
            except OSError:
                s.close()
                proc = kw.get("proc")
                if proc is not None and proc.poll() is not None:
                    raise FleetError(
                        f"engine process for {endpoint!r} exited with "
                        f"{proc.returncode} before listening"
                    )
                if time.monotonic() > deadline:
                    raise FleetError(
                        f"engine at {endpoint!r} not listening after "
                        f"{timeout:g}s"
                    )
                time.sleep(0.1)
        return cls(s, endpoint, engine_id or endpoint, **kw)

    # -- wire ----------------------------------------------------------

    def send(self, doc: dict) -> None:
        # The torn-engine-connection seam: an injected
        # error here fails the op exactly like a mid-write socket tear —
        # typed FleetError to the caller; the scrape path's failures
        # additionally feed the health ladder.
        if faults_mod.ACTIVE is not None:
            faults_mod.ACTIVE.fire("link.send")
        with self._wlock:
            self._fout.write(json.dumps(doc) + "\n")
            self._fout.flush()

    def request(self, doc: dict, *, timeout: float = 120.0) -> dict:
        """Send one op and wait for its correlated reply; raises
        :class:`FleetError` on an ``error`` reply, a timeout, or a
        connection lost mid-wait.

        Correlation survives timeouts: the engine answers ops in order
        per connection, so when an op expecting an ID-LESS reply
        (stats/metrics/shutdown) times out, the late reply is still
        ahead of any later request's — the reader skips exactly that
        many id-less events before answering the next waiter.  A
        timed-out SUBMIT needs no skip: its late ``accepted`` carries
        the job id and falls through to the event plane, which ignores
        it."""
        q: "queue.Queue" = queue.Queue()
        with self._ctl_lock:
            self._waiter = (doc.get("id"), q)
            try:
                self.send(doc)
                ev = q.get(timeout=timeout)
            except (OSError, ValueError, faults_mod.FaultError) as exc:
                raise FleetError(
                    f"engine {self.engine_id}: send failed ({exc})"
                ) from exc
            except queue.Empty:
                if protocol.doc_op(doc) in (
                    "stats", "metrics", "shutdown"
                ):
                    with self._skip_lock:
                        self._skip_replies += 1
                raise FleetError(
                    f"engine {self.engine_id}: no reply to "
                    f"{protocol.doc_op(doc)!r} in {timeout:g}s"
                ) from None
            finally:
                self._waiter = None
        if protocol.doc_event(ev) == "error":
            raise FleetError(
                f"engine {self.engine_id}: {ev.get('error')}"
            )
        return ev

    def health_request(self, doc: dict, *, timeout: float) -> dict:
        """One synchronous op on the dedicated health connection
        (opened lazily, re-opened after any failure — a timeout could
        leave a partial reply in flight, so the connection is never
        reused past an error)."""
        with self._health_lock:
            try:
                # The same torn-connection seam as :meth:`send`, on the
                # dedicated health stream: an injected failure here is a
                # failed scrape — retried once in-poll, then a watchdog
                # miss plus a health-ladder strike.
                if faults_mod.ACTIVE is not None:
                    faults_mod.ACTIVE.fire("link.send")
                if self._health_file is None:
                    s = socket.socket(socket.AF_UNIX,
                                      socket.SOCK_STREAM)
                    s.settimeout(timeout)
                    s.connect(self.endpoint)
                    self._health_sock = s
                    self._health_file = s.makefile(
                        "rw", encoding="utf-8"
                    )
                self._health_sock.settimeout(timeout)
                self._health_file.write(json.dumps(doc) + "\n")
                self._health_file.flush()
                line = self._health_file.readline()
                if not line:
                    raise OSError("health connection EOF")
                return json.loads(line)
            except (OSError, ValueError, faults_mod.FaultError) as exc:
                self._drop_health()
                raise FleetError(
                    f"engine {self.engine_id}: health scrape failed "
                    f"({exc})"
                ) from exc

    def _drop_health(self) -> None:
        if self._health_sock is not None:
            try:
                self._health_sock.close()
            except OSError:
                pass
        self._health_sock = None
        self._health_file = None

    # -- lifecycle -----------------------------------------------------

    def kill_socket(self) -> None:
        """Tear the connection (watchdog path): the reader unwinds
        through EOF and the router's death handler requeues the routed
        jobs."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._health_lock:
            self._drop_health()

    def close(self) -> None:
        """Intentional close (router shutdown): no death handling."""
        self._closing = True
        self.kill_socket()

    # -- reader --------------------------------------------------------

    def _reader(self) -> None:
        try:
            for line in self._fin:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn line mid-death: the EOF follows
                jid = ev.get("id")
                waiter = self._waiter
                if jid is not None and not (
                    waiter is not None
                    and protocol.doc_event(ev) in ("accepted", "error")
                    and jid == waiter[0]
                ):
                    if self._on_event is not None:
                        self._on_event(self, ev)
                    continue
                if jid is None:
                    # A timed-out id-less request's late reply is
                    # still ahead of the current request's in the
                    # per-connection order — drop it, don't answer
                    # the wrong waiter with it.
                    with self._skip_lock:
                        if self._skip_replies > 0:
                            self._skip_replies -= 1
                            continue
                if waiter is not None:
                    waiter[1].put(ev)
                # else: unsolicited control event (dropped)
        except (OSError, ValueError):
            pass  # torn connection: fall through to death handling
        finally:
            self.alive = False
            waiter = self._waiter
            if waiter is not None:
                waiter[1].put(
                    protocol.ev_error("engine connection lost")
                )
            if not self._closing and self._on_death is not None:
                self._on_death(self)


# ---------------------------------------------------------------------------
# Routed jobs
# ---------------------------------------------------------------------------


class RoutedJob:
    """Router-held state of one client job: the sanitized submit
    document (re-submittable verbatim), the affinity token, the engine
    currently running it, the count of hits already forwarded
    downstream (the exactly-once mute), and the last router-held
    checkpoint (the crash-replay origin)."""

    def __init__(self, job_id: str, kind: str, doc: dict, token: str,
                 emit: Optional[Callable]) -> None:
        self.id = job_id
        self.kind = kind  # 'crack' | 'candidates'
        self.doc = doc
        self.token = token
        self.emit = emit
        self.link: Optional[EngineLink] = None
        self.n_forwarded = 0
        #: admission-control identity: the submit doc's
        #: ``tenant`` field; jobs without one share the anonymous
        #: tenant and are exempt from the per-tenant cap.
        self.tenant: Optional[str] = None
        #: absolute shed deadline (monotonic) from the doc's
        #: ``deadline_s`` — deadline-carrying jobs are shed FIRST under
        #: overload, and an expired pending job sheds at the next pump.
        self.deadline: Optional[float] = None
        #: last router-held checkpoint DOC (submit-time migrate-in,
        #: pause events, quarantine events) — the crash-replay origin.
        self.checkpoint: Optional[dict] = None
        self.state = "queued"  # routed|paused|done|failed|cancelled
        self.replays = 0
        #: a drain/migrate is in flight: the next paused (crack) or
        #: cancelled (candidates) event re-places instead of
        #: forwarding downstream.
        self.migrating = False
        #: deferred telemetry counter name for a requeued job that
        #: parked on the pending queue before re-placing.
        self.requeue_counter: Optional[str] = None
        #: popped from the pending queue by the requeue worker, its
        #: dispatch in flight: cancel/resume must neither settle nor
        #: re-admit a job in this window (set/cleared under the
        #: router's lock).
        self.claimed = False
        self.target: Optional[str] = None
        #: the CURRENT placement's submit request has been acked by
        #: the engine.  False while a dispatch is in flight — that
        #: dispatching thread owns any failure, so the death handler
        #: must not also requeue the job (double ownership would run
        #: a ghost sweep under a table entry the dispatcher deletes).
        self.acked = False
        self.settled = threading.Event()
        #: split scatter: the k-way merge when this job
        #: IS scattered across engines (its hits arrive through the
        #: shards; ``link`` stays None).
        self.split: "Optional[_SplitMerge]" = None
        #: ``(index, count)`` when this job IS one scattered stripe of
        #: ``parent`` — its events route into the parent's merge, and
        #: crash-replay of its range counts as a reassignment.
        self.shard: Optional[Tuple[int, int]] = None
        self.parent: "Optional[RoutedJob]" = None
        #: the explicit ``split`` op's park handshake: set while the
        #: op waits for the running job's pause→checkpoint round trip
        #: (the paused event signals it instead of reaching the
        #: client).
        self.splitting: Optional[threading.Event] = None

    @property
    def unsettled(self) -> bool:
        return self.state in ("queued", "routed", "paused")


# ---------------------------------------------------------------------------
# Split-job hit-stream merging
# ---------------------------------------------------------------------------


class _SplitMerge:
    """Router-held merge state of ONE split job: N shards stream
    (word,rank)-ordered hits off disjoint rank-stride pod stripes;
    this k-way merge releases them downstream as one globally
    (word,rank)-ordered, exactly-once client stream.

    Release discipline: the global minimum across the shard buffers
    releases only while no LIVE shard with an empty buffer could still
    produce an earlier key — each shard's stream is (word,rank)-
    monotone (the pod lattice walks blocks in global order), so its
    last seen key (``_marks``) is a safe lower bound on everything it
    will produce next.  A shard that ended stops gating.  Nothing
    releases before :meth:`arm` — a scatter that fails mid-way must
    leave the client stream untouched for the solo fallback — and
    every release happens under the merge lock so the client sees one
    serialized ordered stream.

    Exactly-once across reassignment comes free from the
    crash-replay discipline: a dead shard resubmits from its last
    router-held checkpoint with ``replay_mute`` = hits it already fed
    THIS merge, so the replacement engine withholds exactly the
    deterministic prefix the buffers already hold."""

    def __init__(self, router: "FleetRouter", job: RoutedJob,
                 n: int) -> None:
        self.router = router
        self.job = job
        self.n = n
        self.shards: List[RoutedJob] = []
        self._bufs: List[deque] = [deque() for _ in range(n)]
        #: last merge key seen per shard (None = nothing yet).
        self._marks: List[Optional[Tuple[int, int]]] = [None] * n
        #: terminal state per shard (None = still streaming).
        self._ended: List[Optional[str]] = [None] * n
        #: the done event per shard (the parent's totals source).
        self._stats: List[Optional[dict]] = [None] * n
        self._armed = False
        self._finished = False
        self._failure: Optional[dict] = None
        self._lock = threading.Lock()
        ck = job.checkpoint or {}
        #: the scattered checkpoint's emitted counter: every shard
        #: resumes from the SAME doc, so each shard's done counters
        #: include this prefix once — the parent's total subtracts the
        #: duplicate n-1 copies.
        self._ck_emitted = int(ck.get("n_emitted", 0) or 0)
        self._resumed = job.checkpoint is not None

    def shard_emit(self, i: int) -> Callable:
        """The shard's ``RoutedJob.emit``: the router's ordinary event
        plane forwards shard events here instead of to a client."""
        def emit(ev: dict, _i: int = i) -> None:
            self.on_event(_i, ev)
        return emit

    def arm(self) -> None:
        """Open the client valve — called once, after every shard
        dispatched.  Hits that streamed during the scatter drain now;
        terminals that landed early finish now."""
        with self._lock:
            self._armed = True
            self._release_locked(self._drain_locked())
        self._maybe_finish()

    # -- event plane (shard emit callbacks, reader threads) ------------

    def on_event(self, i: int, ev: dict) -> None:
        event = protocol.doc_event(ev)
        if event == "hit":
            self._merge_round(i, ev)
            return
        if event == "done":
            shard = self.shards[i]
            engine = shard.link.engine_id if shard.link else None
            with self._lock:
                self._ended[i] = "done"
                self._stats[i] = ev
                self._release_locked(self._drain_locked())
                armed = self._armed
            if armed:
                self.router._forward(self.job, protocol.ev_shard_done(
                    self.job.id, shard=i, shards=self.n,
                    engine=engine, n_hits=ev.get("n_hits"),
                ))
        elif event == "failed":
            first = False
            with self._lock:
                self._ended[i] = "failed"
                if self._failure is None:
                    self._failure = ev
                    first = True
                armed = self._armed
            if first and armed:
                # One stripe is unrecoverable (replay budget spent):
                # the whole job fails — stop the siblings burning
                # device time on ranges nobody will merge.
                self._cancel_live(exclude=i)
        elif event == "cancelled":
            with self._lock:
                self._ended[i] = "cancelled"
        else:
            # Informational per-job events (refused, ...) pass through
            # re-labeled with the parent id.
            with self._lock:
                armed = self._armed
            if armed:
                ev2 = dict(ev)
                ev2["id"] = self.job.id
                self.router._forward(self.job, ev2)
            return
        self._maybe_finish()

    def _merge_round(self, i: int, ev: dict) -> None:
        """One shard hit through the merge (``audit_merge_loop`` pins
        this shape): the ONE unconditional host decode — the rank
        string parses exactly once, here, never per-shard in the drain
        bookkeeping — then lock-held bounded buffering: the shard's
        buffer takes the hit and the drain pops every releasable head
        before the lock drops, so a stalled sibling bounds the buffer
        at its stripe lag, never at the whole keyspace."""
        key = (ev["word_index"], int(ev["rank"]))
        with self._lock:
            self._bufs[i].append((key, ev))
            self._marks[i] = key
            self._release_locked(self._drain_locked())

    def _drain_locked(self) -> List[dict]:
        """Pop every releasable buffered hit, in global key order
        (caller holds ``_lock``)."""
        out: List[dict] = []
        if not self._armed:
            return out
        while True:
            best: Optional[Tuple[int, int]] = None
            src = -1
            for k in range(self.n):
                if self._bufs[k] and (
                    best is None or self._bufs[k][0][0] < best
                ):
                    best = self._bufs[k][0][0]
                    src = k
            if best is None:
                return out
            blocked = any(
                self._ended[k] is None and not self._bufs[k]
                and (self._marks[k] is None or self._marks[k] < best)
                for k in range(self.n)
            )
            if blocked:
                return out
            out.append(self._bufs[src].popleft()[1])

    def _release_locked(self, evs: List[dict]) -> None:
        """Forward merged hits downstream as the PARENT's hits (caller
        holds ``_lock`` — releases serialize).  Rebuilt through the
        typed constructor so key order matches a solo engine's stream
        byte for byte."""
        job = self.job
        for ev in evs:
            job.n_forwarded += 1
            self.router._forward(job, protocol.ev_hit(
                job.id,
                digest=ev["digest"],
                plain_hex=ev["plain_hex"],
                word_index=ev["word_index"],
                rank=ev["rank"],
            ))

    # -- completion ----------------------------------------------------

    def _maybe_finish(self) -> None:
        with self._lock:
            if (
                self._finished or not self._armed
                or any(e is None for e in self._ended)
            ):
                return
            self._finished = True
            ended = list(self._ended)
            stats = [s for s in self._stats if s is not None]
            if all(e == "done" for e in ended):
                # All stripes drained: nothing gates — flush.
                self._release_locked(self._drain_locked())
        job = self.job
        job.split = None
        if all(e == "done" for e in ended):
            n_emitted = sum(
                int(s.get("n_emitted", 0)) for s in stats
            ) - (self.n - 1) * self._ck_emitted
            wall = max(
                (float(s.get("wall_s", 0.0)) for s in stats),
                default=0.0,
            )
            self.router._forward(job, protocol.ev_done(
                job.id, n_hits=job.n_forwarded,
                n_emitted=n_emitted, wall_s=wall,
                resumed=self._resumed,
            ))
            self.router._settle(job, "done")
        elif self._failure is not None:
            ev = dict(self._failure)
            ev["id"] = job.id
            self.router._forward(job, ev)
            self.router._settle(job, "failed")
        else:
            self.router._forward(job, protocol.ev_cancelled(job.id))
            self.router._settle(job, "cancelled")

    # -- control -------------------------------------------------------

    def cancel(self) -> None:
        """Client cancel of the split parent: cancel every live
        shard; the merge finishes ``cancelled`` once they all park."""
        self._cancel_live(exclude=None)
        self._maybe_finish()

    def _cancel_live(self, exclude: Optional[int]) -> None:
        router = self.router
        for j, s in enumerate(self.shards):
            if j == exclude:
                continue
            with self._lock:
                if self._ended[j] is not None:
                    continue
            link = s.link
            if s.state == "routed" and link is not None:
                try:
                    link.send(protocol.op_cancel(s.id))
                except (OSError, FleetError,
                        faults_mod.FaultError):
                    pass  # dying link: crash-replay owns the shard
            else:
                # Reassignment parked it on the pending queue (or it
                # sits paused): settle it router-side.
                with router._lock:
                    pending = s in router._pending and not s.claimed
                    if pending:
                        router._pending.remove(s)
                if pending or (s.state == "paused" and not s.claimed):
                    router._settle(s, "cancelled")
                    with self._lock:
                        self._ended[j] = "cancelled"


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------


class FleetRouter:
    """Front-end router over a pool of engines.

    ``place``: ``'affinity'`` (default — co-locate equal-token jobs,
    tie-break by load) or ``'round-robin'`` (the A/B control arm).
    ``replay_budget``: checkpoint-bearing ``failed`` events (engine
    quarantine) are resubmitted to another engine this many times per
    job before the failure reaches the client.  ``poll_s``: health
    scrape cadence (0 disables the poller — tests drive scrapes
    manually); an engine missing ``poll_misses`` consecutive scrapes
    (or whose process exited) is declared dead and its jobs
    crash-replay.  ``defaults``: the SweepConfig the ENGINES were
    started with — used only to fill doc-level gaps when computing
    affinity tokens, so attach-mode routers should pass the engines'
    flags (a mismatch degrades placement, never correctness).

    Elastic knobs.  ``engine_capacity``: routed jobs one engine accepts
    before placements queue (0 = unbounded); ``max_pending``: the
    bounded router-side pending queue;
    ``per_tenant``: in-flight cap per submit-doc ``tenant`` (0 = off);
    ``shed_policy``: what a full pending queue does to a new submit —
    ``reject`` it typed (default), shed the ``oldest`` pending job to
    admit it, or ``queue`` unboundedly (the legacy escape hatch).  Health
    ladder: ``degrade_after`` consecutive strained scrapes mark an
    engine degraded (places last), ``quarantine_after`` mark it
    quarantined (never places; the autoscaler drains + replaces),
    ``recover_after`` clean scrapes walk degraded back to healthy, and
    ``quarantine_replays`` checkpoint-bearing job failures quarantine
    the engine outright.  ``poll_jitter``: per-engine fraction of
    ``poll_s`` each engine's scrape tick is deterministically offset
    by, so N engines never stampede one tick."""

    def __init__(self, *, place: str = "affinity",
                 replay_budget: int = 1, poll_s: float = 2.0,
                 poll_misses: int = 3, defaults: Optional[Any] = None,
                 control_timeout: float = 120.0,
                 engine_capacity: int = 0, max_pending: int = 256,
                 per_tenant: int = 0, shed_policy: str = "reject",
                 degrade_after: int = 1, quarantine_after: int = 3,
                 recover_after: int = 2, quarantine_replays: int = 2,
                 poll_jitter: float = 0.25,
                 split: Optional[str] = None,
                 split_threshold: int = 4096) -> None:
        if place not in ("affinity", "round-robin"):
            raise ValueError(
                f"place must be affinity|round-robin, got {place!r}"
            )
        if shed_policy not in ("reject", "queue", "oldest"):
            raise ValueError(
                f"shed_policy must be reject|queue|oldest, got "
                f"{shed_policy!r}"
            )
        if split not in (None, "auto", "on", "off"):
            raise ValueError(
                f"split must be auto|on|off, got {split!r}"
            )
        self._place = place
        self._replay_budget = int(replay_budget)
        self._poll_s = float(poll_s)
        self._poll_misses = int(poll_misses)
        self._defaults = defaults
        self._control_timeout = float(control_timeout)
        self._engine_capacity = int(engine_capacity)
        self._max_pending = int(max_pending)
        self._per_tenant = int(per_tenant)
        self._shed_policy = shed_policy
        self._degrade_after = max(1, int(degrade_after))
        self._quarantine_after = max(1, int(quarantine_after))
        self._recover_after = max(1, int(recover_after))
        self._quarantine_replays = max(1, int(quarantine_replays))
        self._poll_jitter = max(0.0, float(poll_jitter))
        #: giant-job striping: None = the A5GEN_SPLIT
        #: env hatch decides (``auto`` by default); the threshold is
        #: the ``auto`` mode's oversized floor in WORDS (a word expands
        #: to ≥1 lattice blocks, so it lower-bounds the block count).
        self._split = split
        self._split_threshold = int(split_threshold)
        self._links: List[EngineLink] = []
        self._jobs: Dict[str, RoutedJob] = {}
        #: admission-queued jobs (FIFO), bounded by ``max_pending``
        #: unless ``shed_policy='queue'``; mutated under ``_lock``.
        self._pending: List[RoutedJob] = []
        #: unsettled jobs per explicit tenant (the ``per_tenant``
        #: in-flight cap's ledger); mutated under ``_lock``.
        self._tenant_counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._rr = itertools.count()
        self._closed = False
        #: the attached Autoscaler (None = fixed pool); set once by
        #: ``Autoscaler.bind`` before any scaling runs.
        self.autoscaler = None
        #: fleet counters report as since-THIS-router deltas (the
        #: Engine.stats() convention): the registry is process-wide,
        #: and an embedder running several routers (tests)
        #: must not read its neighbors' deaths.
        self._counters0 = {
            name: int(telemetry.counter(f"fleet.{name}").value)
            for name in ("engine_deaths", "jobs_replayed",
                         "migrations", "jobs_rejected", "jobs_shed",
                         "jobs_queued", "scrape_retries",
                         "engines_quarantined", "engines_detached",
                         "jobs_split", "shards_reassigned")
        }
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        #: re-dispatch work (crash-replay, migrate's second half,
        #: quarantine resubmission) runs on THIS worker, never on a
        #: link's reader thread: a reader dispatching to its own link
        #: (the single-survivor fallback) would block the very loop
        #: that must deliver the ack.
        self._requeue: "queue.Queue" = queue.Queue()
        self._requeue_thread = threading.Thread(
            target=self._requeue_worker, name="a5-fleet-requeue",
            daemon=True,
        )
        self._requeue_thread.start()
        if self._poll_s > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="a5-fleet-health",
                daemon=True,
            )
            self._poll_thread.start()

    # -- pool management -----------------------------------------------

    def attach(self, endpoint: str, engine_id: Optional[str] = None,
               *, proc: "Optional[subprocess.Popen]" = None,
               timeout: float = 180.0) -> EngineLink:
        """Connect one engine endpoint into the pool (spawned or
        pre-existing) and scrape it once so placement has signals
        before the first poll tick."""
        with self._lock:
            index = len(self._links)
        link = EngineLink.connect(
            endpoint, engine_id, timeout=timeout, proc=proc,
            index=index, on_event=self._on_job_event,
            on_death=self._on_death,
        )
        link.next_poll = time.monotonic() + self._jitter_of(link)
        with self._lock:
            self._links.append(link)
        self._scrape(link)
        # Fresh capacity: admission-queued jobs can place now.
        self._schedule_pump()
        return link

    def detach(self, engine_id: str, *, shutdown: bool = True,
               timeout: float = 30.0) -> None:
        """Remove one engine from the pool — the autoscaler's reap
        half.  The engine must be EMPTY (drained, or
        dead): detaching with jobs still routed raises loudly — drain
        first.  ``shutdown`` sends the engine its shutdown op and
        reaps a spawned process."""
        link = self._resolve(engine_id)
        with self._lock:
            if link.routed:
                raise FleetError(
                    f"engine {engine_id!r} still runs "
                    f"{len(link.routed)} job(s) — drain it before "
                    "detaching"
                )
            self._links.remove(link)
        link._closing = True
        if shutdown and link.alive:
            try:
                link.request(protocol.op_shutdown(), timeout=timeout)
            except FleetError:
                pass
        link.close()
        if shutdown and link.proc is not None:
            try:
                link.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                link.proc.kill()
                link.proc.wait()
        telemetry.counter("fleet.engines_detached").add(1)

    def engines(self) -> List[EngineLink]:
        with self._lock:
            return list(self._links)

    def pending_depth(self) -> int:
        """Admission-queued jobs right now (the autoscaler's queue-
        depth signal)."""
        with self._lock:
            return len(self._pending)

    def _resolve(self, engine_id: str) -> EngineLink:
        with self._lock:
            for link in self._links:
                if link.engine_id == engine_id:
                    return link
        raise FleetError(f"unknown engine {engine_id!r}")

    # -- placement -----------------------------------------------------

    def _doc_token(self, doc: dict) -> str:
        """The submit document's affinity token — the same
        static-trace-config prefix ``runtime.fuse.affinity_token``
        hashes engine-side.  Config gaps fill from the ENGINES'
        resolved defaults (scraped ``config_defaults`` — serve
        resolves device-dependent lanes/blocks at start, and
        ``_job_from_doc`` merges docs into exactly those), falling
        back to the router's own ``defaults``; a heterogeneous pool
        degrades placement quality, never correctness."""
        cfg = doc.get("config") or {}
        scraped: dict = {}
        for link in self.engines():
            scraped = link.scrape.get("config_defaults") or {}
            if scraped:
                break
        d = self._defaults

        def field(key: str, attr: str, fallback: Any) -> Any:
            if key in cfg:
                return cfg[key]
            if key in scraped:
                return scraped[key]
            return getattr(d, attr, fallback) if d is not None \
                else fallback

        return static_affinity_token(
            mode=doc.get("mode", "default"),
            algo=doc.get("algo", "md5"),
            table_min=int(doc.get("table_min", 0)),
            table_max=int(doc.get("table_max", 15)),
            lanes=field("lanes", "lanes", None),
            num_blocks=field("blocks", "num_blocks", None),
            superstep=field("superstep", "superstep", None),
            devices=field("devices", "devices", 1),
            pair=field("pair", "pair", None),
        )

    def _resident_tokens(self, link: EngineLink) -> set:
        """The engine's resident affinity tokens as the router sees
        them: its own routing table (authoritative for jobs IT placed)
        unioned with the engine's last-scraped ``resident_groups`` (so
        an attach-mode router also respects jobs other clients run
        directly against the engine)."""
        toks = set(link.scrape.get("resident_groups") or ())
        with self._lock:
            for jid in link.routed:
                job = self._jobs.get(jid)
                if job is not None and job.token:
                    toks.add(job.token)
        return toks

    def _load_score(self, link: EngineLink) -> tuple:
        return (
            # Circuit half-open: a degraded engine places only when
            # every healthy one loses the tie.
            0 if link.health == "healthy" else 1,
            len(link.routed),
            scraped_load(link.scrape),
            link.index,
        )

    def _pick(self, token: str,
              exclude: Sequence[EngineLink] = ()) -> EngineLink:
        with self._lock:
            live = [
                l for l in self._links
                if l.alive and not l.draining
                and l.health != "quarantined"
            ]
            any_alive = any(l.alive for l in self._links)
        if not live:
            if any_alive:
                # Every alive engine is quarantined or draining:
                # capacity is being replaced (the autoscaler's
                # replacement-first discipline), so this is OVERLOAD,
                # not absence — queue bounded / reject typed, never
                # an untyped hard failure mid-degradation.
                raise _NoCapacity(
                    "every live engine is quarantined or draining "
                    "(replacement capacity is on the way)"
                )
            raise FleetError("no live engine to place the job on")
        pool = [l for l in live if l not in exclude] or live
        if self._engine_capacity > 0:
            with self._lock:
                fits = [
                    l for l in pool
                    if len(l.routed) < self._engine_capacity
                ]
            if not fits:
                raise _NoCapacity(
                    "every live engine is at engine_capacity "
                    f"({self._engine_capacity})"
                )
            pool = fits
        if self._place == "round-robin":
            return pool[next(self._rr) % len(pool)]
        matches = [
            l for l in pool if token and token in
            self._resident_tokens(l)
        ]
        return min(matches or pool, key=self._load_score)

    # -- client surface (the serve protocol, routed) -------------------

    def submit(self, doc: dict, emit: Optional[Callable] = None) -> dict:
        """Route one submit document; returns the ``accepted`` event to
        forward downstream.  The document passes through UNCHANGED to
        the placed engine (clients keep their serve contract), except
        the router strips and holds a migrate-in ``checkpoint`` as the
        job's replay origin and re-injects it on dispatch.

        Admission control: a submit that cannot place
        (every engine at ``engine_capacity``) queues on the bounded
        pending list and the ack carries ``"queued": true``; a FULL
        pending list rejects typed (:class:`FleetOverloaded`) — or, under
        ``shed_policy='oldest'``, sheds the oldest pending job (deadline
        carriers first) to admit this one.  A tenant over its
        ``per_tenant`` in-flight cap rejects typed without queueing."""
        if self._closed:
            raise FleetError("router is shut down")
        jid = doc.get("id") or f"fleet-{next(self._ids)}"
        kind = "crack" if (
            "digests" in doc or "digest_list" in doc
        ) else "candidates"
        ck = doc.get("checkpoint")
        if ck is not None:
            # Capture-time validation: a malformed
            # migrate-in checkpoint fails the SUBMIT typed, not the
            # eventual crash-replay resubmit.
            validate_checkpoint_doc(ck)
        sdoc = {k: v for k, v in doc.items()
                if k not in ("checkpoint", "replay_mute")}
        sdoc["id"] = jid
        protocol.op_submit(sdoc)
        job = RoutedJob(jid, kind, sdoc, self._doc_token(sdoc), emit)
        job.checkpoint = ck
        job.n_forwarded = int(doc.get("replay_mute", 0))
        tenant = doc.get("tenant")
        job.tenant = str(tenant) if tenant is not None else None
        if doc.get("deadline_s") is not None:
            job.deadline = time.monotonic() + float(doc["deadline_s"])
        with self._lock:
            prev = self._jobs.get(jid)
            if prev is not None and prev.unsettled:
                raise FleetError(f"job id {jid!r} is still active")
            if (
                self._per_tenant > 0 and job.tenant is not None
                and self._tenant_counts.get(job.tenant, 0)
                >= self._per_tenant
            ):
                telemetry.counter("fleet.jobs_rejected").add(1)
                raise FleetOverloaded(
                    f"tenant {job.tenant!r} has "
                    f"{self._tenant_counts[job.tenant]} jobs in "
                    f"flight (per_tenant cap {self._per_tenant})",
                    self._retry_after_locked(),
                )
            self._jobs[jid] = job
            if job.tenant is not None:
                self._tenant_counts[job.tenant] = \
                    self._tenant_counts.get(job.tenant, 0) + 1
        try:
            ack = None
            n_split = self._auto_split_width(job, doc)
            if n_split >= 2:
                # Oversized: scatter across engines.  A
                # part-failed scatter unwinds to None and the job
                # falls through to the ordinary solo dispatch.
                ack = self._split_scatter(job, n_split, strict=False)
            if ack is None:
                ack = dict(self._dispatch(job))
        except _NoCapacity:
            ack = self._enqueue_pending(job)
        except (FleetError, faults_mod.FaultError):
            # Never admitted anywhere (engine rejection, or an injected
            # router.place fault): drop the table entry so the client
            # can retry under the same id.
            self._forget(job)
            raise
        ack["engine"] = job.link.engine_id if job.link else None
        telemetry.counter("fleet.jobs_routed").add(1)
        return ack

    def _forget(self, job: RoutedJob) -> None:
        """Unregister a job that was never admitted anywhere (rejected
        or failed before placement) so the client can retry its id."""
        with self._lock:
            if self._jobs.get(job.id) is job:
                del self._jobs[job.id]
            self._tenant_release_locked(job)

    def _tenant_release_locked(self, job: RoutedJob) -> None:
        """Release ``job``'s per-tenant in-flight slot (caller holds
        ``_lock``) — the ONE decrement both the never-admitted and the
        terminal-settle paths share."""
        if job.tenant is not None and job.tenant in \
                self._tenant_counts:
            self._tenant_counts[job.tenant] -= 1
            if self._tenant_counts[job.tenant] <= 0:
                del self._tenant_counts[job.tenant]

    def _retry_after(self) -> float:
        """The overload rejection's backoff estimate: one poll cadence
        scaled by how deep the backlog stands per live engine — coarse,
        monotone in load, and cheap (no scrape)."""
        with self._lock:
            return self._retry_after_locked()

    def _enqueue_pending(self, job: RoutedJob, *,
                         forget_on_reject: bool = True) -> dict:
        """Queue one admitted-but-unplaceable job on the bounded
        pending list; returns the synthesized ``accepted`` ack.  A full
        list applies ``shed_policy``: ``oldest`` evicts a
        pending job (deadline carriers first) to admit the newcomer,
        ``reject`` refuses the newcomer typed, ``queue`` grows
        unboundedly (the legacy escape hatch).  ``forget_on_reject``:
        a rejected fresh SUBMIT drops its table entry (the id stays
        retryable); a rejected RESUME must keep the job — it is
        already admitted, paused, and holding its checkpoint."""
        victim: Optional[RoutedJob] = None
        overloaded: Optional[FleetOverloaded] = None
        with self._lock:
            if (
                len(self._pending) >= self._max_pending
                and self._shed_policy == "oldest"
            ):
                victim = self._shed_victim_locked()
            if (
                len(self._pending) >= self._max_pending
                and self._shed_policy != "queue"
            ):
                overloaded = FleetOverloaded(
                    f"router pending queue is full ({self._max_pending}"
                    " jobs; every engine at capacity)",
                    self._retry_after_locked(),
                )
            else:
                self._pending.append(job)
        if victim is not None:
            self._shed(victim, "pending queue full: oldest-policy "
                               "eviction for a newer arrival")
        if overloaded is not None:
            if forget_on_reject:
                self._forget(job)
            telemetry.counter("fleet.jobs_rejected").add(1)
            raise overloaded
        telemetry.counter("fleet.jobs_queued").add(1)
        return protocol.ev_accepted(job.id, job.kind, queued=True)

    def _retry_after_locked(self) -> float:
        depth = len(self._pending)
        alive = sum(
            1 for l in self._links
            if l.alive and not l.draining
            and l.health != "quarantined"
        )
        base = self._poll_s if self._poll_s > 0 else 1.0
        return round(max(0.5, base) * (1.0 + depth / max(1, alive)), 3)

    def _shed_victim_locked(self) -> Optional[RoutedJob]:
        """Pick (and remove) the pending job to shed: deadline
        carriers first — soonest deadline — then the oldest arrival
        (a job that declared a deadline already agreed
        staleness is failure; shedding it costs the least)."""
        if not self._pending:
            return None
        deadline_jobs = [
            j for j in self._pending if j.deadline is not None
        ]
        if deadline_jobs:
            victim = min(deadline_jobs, key=lambda j: j.deadline)
            self._pending.remove(victim)
            return victim
        return self._pending.pop(0)

    def _shed(self, job: RoutedJob, reason: str) -> None:
        """Fail one shed job downstream with the typed overload event
        (checkpoint attached when the router holds one — a shed
        migrate-in loses no progress)."""
        telemetry.counter("fleet.jobs_shed").add(1)
        self._forward(job, protocol.ev_failed(
            job.id, "overloaded",
            reason=reason,
            retry_after_s=self._retry_after(),
            checkpoint=job.checkpoint,
        ))
        self._settle(job, "failed")

    def pause(self, jid: str) -> None:
        job = self._job(jid)
        if job.split is not None:
            raise FleetError(
                f"job {jid!r} is split across engines — it has no "
                "single pause point; cancel it or let it finish"
            )
        if job.shard is not None:
            raise FleetError(
                f"job {jid!r} is a split shard — operate on its "
                f"parent {job.parent.id!r}"
            )
        if job.state != "routed" or job.link is None:
            raise FleetError(f"job {jid!r} is {job.state}, not running")
        job.link.send(protocol.op_pause(jid))

    def resume(self, jid: str) -> dict:
        """Re-place a paused job from its router-held checkpoint;
        returns the ``accepted`` event (``resumed`` flagged) to
        forward downstream.  Under admission control a resume with no
        free capacity queues like a submit would."""
        job = self._job(jid)
        if job.shard is not None:
            raise FleetError(
                f"job {jid!r} is a split shard — the router owns its "
                "lifecycle"
            )
        with self._lock:
            # ONE atomic read of the admission state: a state check
            # outside this lock could interleave with the pump
            # completing a queued resume's dispatch (queued→routed)
            # and let a retry double-dispatch the running id.
            queued = job in self._pending or job.claimed
            paused = job.state == "paused"
        if queued:
            # Already admission-queued by an earlier resume (or being
            # dispatched by the pump right now): the retry is
            # idempotent — never a second pending entry or a second
            # dispatch of a running id.
            return protocol.ev_accepted(
                jid, job.kind, queued=True, resumed=True
            )
        if not paused:
            raise FleetError(f"job {jid!r} is {job.state}, not paused")
        try:
            ack = dict(self._dispatch(job))
        except _NoCapacity:
            # An overloaded-too reject must NOT forget an already-
            # admitted job: it stays paused, checkpoint intact, and
            # the client retries the resume after retry_after_s.
            ack = self._enqueue_pending(job, forget_on_reject=False)
        ack["resumed"] = True
        return ack

    # -- giant-job striping ------------------------------

    def _placeable_width(self) -> int:
        """Engines a scatter could stripe across right now."""
        with self._lock:
            return sum(
                1 for l in self._links
                if l.alive and not l.draining
                and l.health != "quarantined"
            )

    def _auto_split_width(self, job: RoutedJob, doc: dict) -> int:
        """How many stripes a fresh submit should scatter across (0 =
        keep it solo).  Gates: the resolved split mode (ctor >
        A5GEN_SPLIT > ``auto``); crack jobs only (candidates output is
        engine-local); an explicit client ``config.pod`` wins (the
        client already striped it); ``superstep: 0`` has no block
        lattice to stripe; ``auto`` requires an oversized inline
        wordlist (``split_threshold`` words) so fleet-of-small-jobs
        traffic never pays scatter overhead; and at least two
        placeable engines must exist."""
        mode = self._split
        if mode is None:
            from .env import split_setting

            mode = split_setting()
        if mode == "off" or job.kind != "crack":
            return 0
        cfg = job.doc.get("config") or {}
        if cfg.get("pod") is not None:
            return 0
        superstep = cfg.get("superstep")
        if superstep is None:
            superstep = getattr(self._defaults, "superstep", None)
        if superstep == 0:
            return 0
        words = doc.get("words")
        if not isinstance(words, list):
            return 0
        if mode != "on" and len(words) < self._split_threshold:
            return 0
        n = self._placeable_width()
        return n if n >= 2 else 0

    def _split_scatter(self, job: RoutedJob, n: int, *,
                       strict: bool) -> Optional[dict]:
        """Scatter one admitted crack job across ``n`` engines as
        disjoint ``config.pod = [i, n]`` rank-stride stripes, each a
        full resubmittable job doc riding the job's checkpoint (pod
        cursors are GLOBAL, so every shard resumes from the SAME doc
        and walks only its stripe) with already-forwarded hits muted.
        On success the merge arms and the parent streams through it.
        On any placement failure the scatter unwinds completely —
        nothing reached the client — and either returns None
        (``strict=False``: submit falls back to solo dispatch) or
        raises typed (``strict=True``: the explicit op's job stays
        paused, checkpoint intact)."""
        merge = _SplitMerge(self, job, n)
        shards: List[RoutedJob] = []
        for i in range(n):
            sdoc = dict(job.doc)
            cfg = dict(sdoc.get("config") or {})
            cfg["pod"] = [i, n]
            sdoc["config"] = cfg
            sdoc["id"] = f"{job.id}::s{i}"
            protocol.op_submit(sdoc)
            shard = RoutedJob(sdoc["id"], "crack", sdoc, job.token,
                              merge.shard_emit(i))
            shard.shard = (i, n)
            shard.parent = job
            shard.checkpoint = job.checkpoint
            # Double duty, both correct: the mute each dispatch sends
            # (the checkpoint prefix is already client-forwarded) AND
            # the shard's forwarded counter (replayed hits never
            # re-enter the merge).
            shard.n_forwarded = job.n_forwarded
            shards.append(shard)
        merge.shards = shards
        with self._lock:
            for shard in shards:
                self._jobs[shard.id] = shard
            job.split = merge
            job.state = "routed"
        used: List[EngineLink] = []
        try:
            for shard in shards:
                # Affinity would co-locate equal-token stripes: spread
                # them instead — distinct engines are the whole win.
                self._dispatch(shard, tuple(used))
                if shard.link is not None and shard.link not in used:
                    used.append(shard.link)
        except (FleetError, faults_mod.FaultError) as exc:
            self._split_undo(job, shards)
            if strict:
                raise FleetError(
                    f"split of {job.id!r} failed mid-scatter: {exc} "
                    "(the job is intact — resume it solo or retry)"
                ) from exc
            return None
        merge.arm()
        telemetry.counter("fleet.jobs_split").add(1)
        return protocol.ev_accepted(job.id, job.kind, shards=n)

    def _split_undo(self, job: RoutedJob,
                    shards: List[RoutedJob]) -> None:
        """Unwind a part-placed scatter: the merge never armed, so no
        hit reached the client — cancel the placed stripes (their
        buffered hits die with the merge) and drop the unplaced shard
        entries; the job returns to its pre-scatter admission state."""
        for shard in shards:
            link = shard.link
            if link is not None:
                try:
                    link.send(protocol.op_cancel(shard.id))
                except (OSError, FleetError, faults_mod.FaultError):
                    pass  # dying link: its death path settles the id
        with self._lock:
            job.split = None
            job.state = "paused" if job.checkpoint is not None \
                else "queued"
            for shard in shards:
                if shard.link is None:
                    if self._jobs.get(shard.id) is shard:
                        del self._jobs[shard.id]
                    shard.state = "cancelled"
                    shard.settled.set()

    def split(self, jid: str, shards: Optional[int] = None) -> dict:
        """The explicit ``split`` op: scatter one
        admitted crack job across engines mid-flight.  A RUNNING job
        parks first (pause → checkpoint over the wire — the same
        discipline migrate rides; the paused event signals the park
        instead of reaching the client), then the checkpoint scatters
        as N disjoint pod stripes with already-forwarded hits muted; a
        PAUSED job scatters directly.  Returns the ``accepted`` ack
        with ``shards`` set."""
        job = self._job(jid)
        if job.kind != "crack":
            raise FleetError(
                f"job {jid!r} is {job.kind} — only crack jobs split "
                "(candidates output is engine-local)"
            )
        if job.split is not None or job.shard is not None:
            raise FleetError(f"job {jid!r} is already split")
        if (job.doc.get("config") or {}).get("pod") is not None:
            raise FleetError(
                f"job {jid!r} already carries a client pod stripe"
            )
        n_live = self._placeable_width()
        n = int(shards) if shards is not None else n_live
        n = min(n, max(n_live, 1))
        if n < 2:
            raise FleetError(
                "split needs at least 2 placeable engines (have "
                f"{n_live})"
            )
        if job.state == "routed" and job.link is not None:
            parked = threading.Event()
            job.splitting = parked
            job.link.send(protocol.op_pause(jid))
            if not parked.wait(self._control_timeout):
                job.splitting = None
                raise FleetError(
                    f"job {jid!r} did not park for split within "
                    f"{self._control_timeout:g}s"
                )
        if job.state != "paused":
            raise FleetError(
                f"job {jid!r} is {job.state}, not splittable"
            )
        return self._split_scatter(job, n, strict=True)

    def cancel(self, jid: str) -> None:
        job = self._job(jid)
        if job.split is not None:
            job.split.cancel()
            return
        if job.shard is not None:
            raise FleetError(
                f"job {jid!r} is a split shard — cancel its parent "
                f"{job.parent.id!r}"
            )
        if job.state == "routed" and job.link is not None:
            job.link.send(protocol.op_cancel(jid))
            return
        with self._lock:
            # Claim-by-removal: once this cancel takes the job OFF the
            # pending list, the pump can never pop it; conversely a
            # job the pump already claimed is dispatch-in-flight and
            # must be cancelled engine-side once it binds (retry).
            claimed = job.claimed
            queued = job in self._pending and not claimed
            if queued:
                self._pending.remove(job)
        if (job.state == "paused" and not claimed) or queued:
            # Nothing runs engine-side (paused, or still admission-
            # queued): settle here and tell the client ourselves.
            self._forward(job, protocol.ev_cancelled(jid))
            self._settle(job, "cancelled")
            return
        raise FleetError(f"job {jid!r} is {job.state}")

    def migrate(self, jid: str,
                engine_id: Optional[str] = None) -> dict:
        """Rebalance one running job: pause → checkpoint over the wire
        → resubmit on the target (or placement-chosen) engine, with
        already-delivered hits muted on redelivery.  Candidates jobs
        RESTART on the target instead (cancel + fresh resubmission —
        their output is engine-local).  Asynchronous: returns an ack;
        the job continues streaming on its same client session."""
        job = self._job(jid)
        if job.split is not None:
            raise FleetError(
                f"job {jid!r} is split across engines — its stripes "
                "rebalance individually (drain moves them; cancel "
                "the parent to stop them)"
            )
        if job.state != "routed" or job.link is None:
            raise FleetError(f"job {jid!r} is {job.state}, not running")
        if engine_id is not None:
            self._resolve(engine_id)  # fail loudly before pausing
            if engine_id == job.link.engine_id:
                return protocol.ev_migrating(
                    jid, frm=engine_id, to=engine_id, noop=True
                )
        job.target = engine_id
        job.migrating = True
        telemetry.counter("fleet.migrations").add(1)
        if job.kind == "crack":
            job.link.send(protocol.op_pause(jid))
        else:
            job.link.send(protocol.op_cancel(jid))
        return protocol.ev_migrating(
            jid, frm=job.link.engine_id,
            to=engine_id or "(placement)",
        )

    def drain(self, engine_id: str) -> dict:
        """Empty one engine for shutdown: no new placements land on
        it, and every job routed there migrates off (placement picks
        the targets).  Returns the count of jobs set migrating."""
        link = self._resolve(engine_id)
        link.draining = True
        with self._lock:
            jids = [
                jid for jid in link.routed
                if (j := self._jobs.get(jid)) is not None
                and j.state == "routed" and not j.migrating
            ]
        for jid in jids:
            self.migrate(jid)
        return protocol.ev_draining(engine_id, len(jids))

    def stats(self) -> dict:
        """The fleet's merged ``stats`` event: per-engine scrapes
        summed (so serve clients reading job counts keep working) plus
        a ``fleet`` section with per-engine detail and the router's
        own counters."""
        agg: dict = {}
        members = []
        for link in self.engines():
            s = dict(link.scrape)
            if link.alive:
                try:
                    s = self._scrape(link)
                except FleetError:
                    pass  # poller/watchdog owns the death call
            if link.alive:
                # Only LIVE engines sum into the fleet aggregate — a
                # dead member's stale last scrape would double-count
                # the jobs that crash-replayed onto the survivors
                # (its detail row below still shows the final state).
                for k, v in s.items():
                    # Ratios (fill instruments) are per-engine facts —
                    # summing them across members is meaningless; the
                    # detail rows below carry them instead.
                    if isinstance(v, bool) or k in (
                        "packed_fill", "packed_fill_last",
                        "packed_fill_min", "config_defaults"
                    ):
                        continue
                    if isinstance(v, (int, float)):
                        agg[k] = agg.get(k, 0) + v
                    elif isinstance(v, dict):
                        cur = agg.setdefault(k, {})
                        for gk, gv in v.items():
                            if isinstance(gv, (int, float)) \
                                    and not isinstance(gv, bool):
                                cur[gk] = cur.get(gk, 0) + gv
            members.append({
                "engine": link.engine_id,
                "endpoint": link.endpoint,
                "alive": link.alive,
                "draining": link.draining,
                "health": link.health,
                "jobs_routed": len(link.routed),
                "resident_groups": sorted(
                    self._resident_tokens(link)
                ),
                "packed_fill": s.get("packed_fill", 0.0),
                # Post-departure fill decay + re-fuse activity
                #: the router's view of how well each
                # member keeps its fused groups tight under churn.
                "packed_fill_min": s.get("packed_fill_min", 0.0),
                "refuse_total": s.get("refuse_total", 0),
            })
        with self._lock:
            unsettled = sum(
                1 for j in self._jobs.values() if j.unsettled
            )
            pending = len(self._pending)
        fleet = {
            "place": self._place,
            "engines": members,
            "engines_alive": sum(1 for m in members if m["alive"]),
            "jobs_tracked": unsettled,
            # The admission surface: queued depth and
            # the bounds the overload semantics enforce.
            "jobs_pending": pending,
            "max_pending": self._max_pending,
            "engine_capacity": self._engine_capacity,
            "shed_policy": self._shed_policy,
            **{
                name: int(
                    telemetry.counter(f"fleet.{name}").value
                ) - base
                for name, base in self._counters0.items()
            },
        }
        scaler = self.autoscaler
        if scaler is not None:
            fleet["autoscale"] = scaler.describe()
        return protocol.ev_stats(agg, fleet=fleet)

    def metrics(self) -> dict:
        """Merged registry scrape: every live engine's snapshot (each
        labeled with its engine identity) merged with the router's own
        — counters sum fleet-wide, per-engine gauges stay per-engine
        series (``telemetry.merge``) — plus the Prometheus text."""
        snaps = []
        for link in self.engines():
            if not link.alive:
                continue
            try:
                ev = link.request(protocol.op_metrics(),
                                  timeout=self._control_timeout)
            except FleetError:
                continue
            snaps.append(ev.get("metrics") or {})
        snaps.append(telemetry.snapshot())
        merged = telemetry.merge(snaps)
        return protocol.ev_metrics(
            merged, telemetry.to_prometheus(merged)
        )

    def passthrough(self, doc: dict) -> None:
        """Forward an op the router does not interpret to the engine
        running its job — new serve ops stay fleet-compatible without
        a router release."""
        job = self._job(doc.get("id"))
        if job.link is None:
            raise FleetError(f"job {job.id!r} is not on an engine")
        job.link.send(doc)

    def wait(self, jid: str, timeout: Optional[float] = None) -> bool:
        """Block until a job settles (done/failed/cancelled) or pauses
        — the embedder/test convenience."""
        return self._job(jid).settled.wait(timeout)

    def job(self, jid: str) -> RoutedJob:
        return self._job(jid)

    def close(self, *, shutdown_engines: bool = True,
              timeout: float = 30.0) -> None:
        """Stop routing.  ``shutdown_engines`` sends each engine the
        shutdown op (and reaps spawned processes); attach-mode callers
        pass False to leave the engines serving."""
        self._closed = True
        if self.autoscaler is not None:
            self.autoscaler.close()
        self._poll_stop.set()
        self._requeue.put(None)
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
        self._requeue_thread.join(timeout=5.0)
        for link in self.engines():
            link._closing = True
            if shutdown_engines and link.alive:
                try:
                    link.request(protocol.op_shutdown(),
                                 timeout=timeout)
                except FleetError:
                    pass
            link.close()
            if shutdown_engines and link.proc is not None:
                try:
                    link.proc.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    link.proc.kill()
                    link.proc.wait()

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()

    # -- internals -----------------------------------------------------

    def _job(self, jid: str) -> RoutedJob:
        with self._lock:
            job = self._jobs.get(jid)
        if job is None:
            raise FleetError(f"unknown job id {jid!r}")
        return job

    def _dispatch(self, job: RoutedJob,
                  exclude: Sequence[EngineLink] = ()) -> dict:
        """Place (or re-place) one job: pick an engine, ship the
        document — with the router-held checkpoint and the
        exactly-once mute for crack jobs — and bind the routing
        state.  Raises :class:`FleetError` when no engine accepts.

        The binding lands BEFORE the submit request goes out: the
        engine's pump can start streaming hits the instant it accepts,
        and the link reader must already resolve them to this job — a
        bind-after-ack would drop the first fetch's hits on the
        floor."""
        # The placement seam: an injected fault fails
        # THIS placement exactly like an engine rejection — submit
        # reports it typed to the client; a requeue-time fault fails
        # the job with its checkpoint attached (the quarantine token).
        if faults_mod.ACTIVE is not None:
            faults_mod.ACTIVE.fire("router.place")
        target = job.target
        job.target = None
        link = (
            self._resolve(target) if target is not None
            else self._pick(job.token, exclude)
        )
        doc = dict(job.doc)
        # The checkpoint rides for BOTH kinds (a client-provided
        # candidates resume must keep the engine's append-resume
        # contract — the router-initiated restart paths clear
        # ``job.checkpoint`` instead); the mute is crack-only (it
        # gates the hit-delivery queue).
        if job.checkpoint is not None:
            doc["checkpoint"] = job.checkpoint
        if job.kind == "crack" and job.n_forwarded:
            doc["replay_mute"] = job.n_forwarded
        prev_state = job.state
        with self._lock:
            if job.link is not None:
                # Two dispatchers raced (e.g. concurrent resumes of
                # one id): the first bound; a second binding would
                # orphan the running placement and double-run the
                # sweep.  Every legitimate dispatch path starts from
                # link=None (fresh submit, pause, requeue, pump).
                raise FleetError(
                    f"job {job.id!r} is already bound to engine "
                    f"{job.link.engine_id}"
                )
            if (
                self._engine_capacity > 0 and target is None
                and job.id not in link.routed
                and len(link.routed) >= self._engine_capacity
            ):
                # Close the check-then-act window: _pick's capacity
                # test ran under an earlier lock acquisition, and a
                # concurrent dispatch may have bound here since —
                # re-verify at bind time so the cap cannot overshoot
                # (explicit-target migrates stay operator-privileged).
                raise _NoCapacity(
                    f"engine {link.engine_id} reached "
                    f"engine_capacity ({self._engine_capacity}) "
                    "before this placement bound"
                )
            job.link = link
            job.state = "routed"
            job.acked = False
            link.routed.add(job.id)
            job.settled.clear()
        try:
            ack = link.request(doc, timeout=self._control_timeout)
        except FleetError:
            with self._lock:
                if job.link is link:
                    job.link = None
                    job.state = prev_state
                link.routed.discard(job.id)
            raise
        with self._lock:
            job.acked = True
        return ack

    def _settle(self, job: RoutedJob, state: str) -> None:
        freed = False
        with self._lock:
            job.state = state
            if job.link is not None:
                job.link.routed.discard(job.id)
                job.link = None
                freed = True
            job.migrating = False
            if job in self._pending:
                self._pending.remove(job)
            if state != "paused":
                # Terminal: release the heavy references — the full
                # submit document (a service-scale router must not
                # retain every tenant's wordlist forever; the table
                # entry itself stays as the id-reuse guard) and the
                # session callback (a dead client's entry must not pin
                # its outbound buffer).
                job.doc = {"id": job.id}
                job.emit = None
                self._tenant_release_locked(job)
        job.settled.set()
        if freed:
            # An engine slot opened: admission-queued jobs can place.
            self._schedule_pump()

    def _forward(self, job: RoutedJob, ev: dict) -> None:
        emit = job.emit
        if emit is None:
            return
        try:
            emit(ev)
        except (OSError, ValueError):
            # Client gone: stop forwarding, keep the job running —
            # the serve tier's dead-client discipline.
            job.emit = None

    def _remigrate(self, job: RoutedJob, old: EngineLink) -> None:
        """The second half of a drain/migrate: the job parked (crack:
        paused with checkpoint; candidates: cancelled, restart
        fresh) — re-place it, muted, without bothering the client.  A
        failed re-place must not strand the job silently: it settles
        failed downstream with the checkpoint attached."""
        job.migrating = False
        with self._lock:
            old.routed.discard(job.id)
            job.link = None
        # A migrating split stripe is a range reassignment too (the
        # drain rebalancer rides this path): same parent-side event
        # and counter as the crash path, same mute discipline.
        self._note_reassign(job, old)
        self._requeue.put((job, (old,), None))

    def _schedule_pump(self) -> None:
        """Ask the requeue worker to drain the pending queue — called
        from reader/event threads, which must never dispatch
        themselves."""
        if self._closed:
            return
        self._requeue.put(("pump",))

    def _pump_pending(self) -> None:
        """Dispatch admission-queued jobs while capacity lasts
        (requeue-worker only).  Jobs whose ``deadline_s`` lapsed while
        queued shed typed first — under overload the freed slot must
        not go to work nobody is waiting for."""
        while True:
            now = time.monotonic()
            with self._lock:
                expired = [
                    j for j in self._pending
                    if j.deadline is not None and j.deadline <= now
                ]
                for j in expired:
                    self._pending.remove(j)
            for j in expired:
                self._shed(j, "deadline_s lapsed while queued")
            with self._lock:
                job = self._pending.pop(0) if self._pending else None
                if job is not None:
                    # Claim: a concurrent cancel/resume must not treat
                    # the popped job as settled-able or re-admittable
                    # while its dispatch is in flight.
                    job.claimed = True
            if job is None:
                return
            try:
                self._dispatch(job)
            except _NoCapacity:
                # Still no room: back to the FRONT (it is the oldest)
                # until the next capacity-freed pump.
                with self._lock:
                    job.claimed = False
                    self._pending.insert(0, job)
                return
            except (FleetError, faults_mod.FaultError) as exc:
                with self._lock:
                    job.claimed = False
                self._fail_unplaceable(job, exc)
            else:
                with self._lock:
                    job.claimed = False
                if job.requeue_counter:
                    telemetry.counter(job.requeue_counter).add(1)
                    job.requeue_counter = None

    def _requeue_worker(self) -> None:
        while True:
            item = self._requeue.get()
            if item is None:
                return
            if item == ("pump",):
                self._pump_pending()
                continue
            job, exclude, counter = item
            if counter:
                job.requeue_counter = counter
            try:
                self._dispatch(job, exclude)
            except _NoCapacity:
                # A crash-replay/migrate job was already admitted once:
                # it queues AHEAD of new arrivals and re-places as
                # capacity frees.
                with self._lock:
                    self._pending.insert(0, job)
            except (FleetError, faults_mod.FaultError) as exc:
                self._fail_unplaceable(job, exc)
            else:
                if job.requeue_counter:
                    telemetry.counter(job.requeue_counter).add(1)
                    job.requeue_counter = None

    def _fail_unplaceable(self, job: RoutedJob,
                          exc: Exception) -> None:
        # Forward BEFORE settling (here and in the event plane): a
        # caller woken by ``wait()`` must find the terminal event
        # already delivered.
        self._forward(job, protocol.ev_failed(
            job.id, f"FleetError: {exc}", checkpoint=job.checkpoint,
        ))
        self._settle(job, "failed")

    # -- engine event plane (link reader threads) ----------------------

    def _on_job_event(self, link: EngineLink, ev: dict) -> None:
        with self._lock:
            job = self._jobs.get(ev.get("id"))
        if job is None or job.link is not link:
            return  # stale event from an engine the job left
        event = protocol.doc_event(ev)
        if event == "hit":
            job.n_forwarded += 1
            self._forward(job, ev)
        elif event == "done":
            self._forward(job, ev)
            self._settle(job, "done")
        elif event == "paused":
            ck = ev.get("checkpoint")
            if ck is not None:
                # Capture-time validation: a malformed
                # checkpoint fails the pause/drain TYPED here, not the
                # eventual crash-replay resubmit.
                try:
                    validate_checkpoint_doc(ck)
                except ValueError as exc:
                    self._forward(job, protocol.ev_failed(
                        job.id,
                        f"{type(exc).__name__}: {exc} "
                        "(checkpoint captured on pause "
                        "failed validation)",
                    ))
                    self._settle(job, "failed")
                    return
            job.checkpoint = ck
            parked = job.splitting
            if parked is not None:
                # The explicit split op's park: the
                # pause was ours — hand the checkpointed job back to
                # the waiting scatter instead of the client.
                job.splitting = None
                with self._lock:
                    job.state = "paused"
                    link.routed.discard(job.id)
                    job.link = None
                parked.set()
                return
            if job.migrating:
                self._remigrate(job, link)
                return
            with self._lock:
                job.state = "paused"
                link.routed.discard(job.id)
                job.link = None
            self._forward(job, ev)
            job.settled.set()
            self._schedule_pump()
        elif event == "cancelled":
            if job.migrating and job.kind == "candidates":
                # Restart-style migration: the cancel was ours.
                job.checkpoint = None
                self._remigrate(job, link)
                return
            self._forward(job, ev)
            self._settle(job, "cancelled")
        elif event == "failed":
            ck = ev.get("checkpoint")
            if ck is not None:
                try:
                    validate_checkpoint_doc(ck)
                except ValueError as exc:
                    # A quarantine token this build cannot resume is no
                    # replay origin: surface the failure typed instead
                    # of resubmitting a doc that would explode later.
                    ev = dict(ev)
                    ev["checkpoint_invalid"] = \
                        f"{type(exc).__name__}: {exc}"
                    ck = None
                else:
                    # Engine-side quarantine (the engine's recovery
                    # ladder exhausted) is the repeated-crash-replay
                    # strain signal: enough of them circuit-break the
                    # engine.
                    with self._lock:
                        link.replay_fails += 1
                        trip = (
                            link.replay_fails
                            >= self._quarantine_replays
                        )
                    if trip:
                        self._quarantine_link(
                            link,
                            f"{link.replay_fails} checkpoint-bearing "
                            "job failures",
                        )
            if ck is not None and job.replays < self._replay_budget:
                # Quarantine resubmission: the
                # failed event's checkpoint IS the migrate token.
                job.replays += 1
                job.checkpoint = ck
                with self._lock:
                    link.routed.discard(job.id)
                    job.link = None
                self._note_reassign(job, link)
                self._requeue.put((job, (link,),
                                   "fleet.jobs_replayed"))
                return
            if ck is not None:
                job.checkpoint = ck
            self._forward(job, ev)
            self._settle(job, "failed")
        elif event == "accepted":
            # A resumed/duplicate ack that missed the request window;
            # nothing to do.
            pass
        else:
            self._forward(job, ev)  # future per-job events pass through

    def _on_death(self, link: EngineLink) -> None:
        """Crash-replay (the fleet's whole point): every job routed to
        the dead engine requeues onto the survivors from its last
        router-held checkpoint, with already-forwarded hits muted so
        the client stream stays exactly-once and byte-identical."""
        if self._closed:
            return
        with self._lock:
            if link not in self._links:
                return
            link.alive = False
            # Only ACKED placements requeue here: a job whose dispatch
            # request is still in flight belongs to its dispatching
            # thread — that request is failing with "connection lost"
            # right now, and its caller handles the job exactly once.
            jobs = [
                self._jobs[jid] for jid in sorted(link.routed)
                if jid in self._jobs and self._jobs[jid].acked
            ]
            link.routed.clear()
        telemetry.counter("fleet.engine_deaths").add(1)
        if link.proc is not None and link.proc.poll() is None:
            # Torn socket but live process: a half-dead engine must
            # not keep burning the device for jobs we re-place.
            try:
                link.proc.terminate()
            except OSError:
                pass
        for job in jobs:
            job.link = None
            job.migrating = False
            job.target = None
            if not job.unsettled or job.state == "paused":
                continue
            if job.kind == "candidates":
                job.checkpoint = None  # restart: output truncates
            self._note_reassign(job, link)
            self._requeue.put((job, (), "fleet.jobs_replayed"))

    def _note_reassign(self, job: RoutedJob,
                       link: EngineLink) -> None:
        """A split shard's stripe is moving engines:
        count it and tell the parent's client — the stripe resumes
        from its last router-held checkpoint with ``acked`` already-
        merged hits muted, so the merged stream never replays."""
        if job.shard is None or job.parent is None:
            return
        telemetry.counter("fleet.shards_reassigned").add(1)
        self._forward(job.parent, protocol.ev_range_reassign(
            job.parent.id, shard=job.shard[0], shards=job.shard[1],
            frm=link.engine_id, acked=job.n_forwarded,
        ))

    # -- health --------------------------------------------------------

    def _scrape(self, link: EngineLink, *,
                observe: bool = False) -> dict:
        # The stats op answers from a session thread (counter reads,
        # no device work) on the link's DEDICATED health connection —
        # blocking ops on the main op stream (a pause parking at a
        # superstep boundary) can never make a healthy engine look
        # dead.  The short cadence-scaled timeout bounds how long the
        # watchdog takes to declare a wedged engine (poll_misses ×
        # this).
        timeout = max(2.0 * self._poll_s, 2.0)
        with telemetry.stopwatch(
            "fleet.scrape_s", edges=(0.01, 0.05, 0.25, 1.0, 5.0)
        ) as sw:
            ev = link.health_request(protocol.op_stats(),
                                     timeout=timeout)
        if protocol.doc_event(ev) == "error":
            raise FleetError(
                f"engine {link.engine_id}: {ev.get('error')}"
            )
        link.scrape = ev
        link.misses = 0
        if observe:
            # Latency budget: a reply slower than half
            # the scrape timeout is a strain signal even when it
            # arrives — a struggling engine degrades before it wedges.
            # ONLY the poll loop's cadenced scrapes feed the ladder:
            # client-driven stats scrapes would otherwise make
            # quarantine timing a function of how often clients poll
            # (fast polls could both rush strikes and mask strain by
            # resetting them between ticks).
            self._ladder_observe(link, ev, sw.elapsed_s > 0.5 * timeout)
        return ev

    # -- the health ladder -------------------------------

    def _ladder_observe(self, link: EngineLink, ev: dict,
                        slow: bool) -> None:
        """One successful scrape's ladder input: strain = a slow reply
        OR rising recovery-ladder deltas (``group_demotions``/
        ``job_restarts`` climbing between scrapes — the engine's
        recovery ladder is working, which means its device is failing)."""
        cur = {
            k: int(ev.get(k, 0))
            for k in ("group_demotions", "job_restarts")
        }
        with self._lock:
            prev = link.ladder_prev
            link.ladder_prev = cur
        # The FIRST scrape is the baseline: attaching to an engine
        # with recovery history must not instantly degrade it.
        rising = bool(prev) and any(
            cur[k] > prev.get(k, 0) for k in cur
        )
        if slow or rising:
            self._ladder_strike(link)
        else:
            self._ladder_clean(link)

    def _ladder_strike(self, link: EngineLink) -> None:
        quarantine = False
        with self._lock:
            link.strikes += 1
            link.clean = 0
            if link.health != "quarantined":
                if (
                    link.strikes >= self._quarantine_after
                    and self.autoscaler is not None
                ):
                    quarantine = True
                elif link.health == "healthy" and \
                        link.strikes >= self._degrade_after:
                    link.health = "degraded"
        if quarantine:
            self._quarantine_link(
                link, f"{link.strikes} consecutive strained scrapes"
            )

    def _ladder_clean(self, link: EngineLink) -> None:
        with self._lock:
            link.strikes = 0
            # A clean POLL tick also closes the repeated-crash-replay
            # window: ``quarantine_replays`` means failures bunched
            # within one health window, not accumulated over an
            # engine's whole lifetime (a long-lived engine with one
            # recovered transient per week must never circuit-break).
            link.replay_fails = 0
            if link.health == "degraded":
                link.clean += 1
                if link.clean >= self._recover_after:
                    link.health = "healthy"
                    link.clean = 0

    def _quarantine_link(self, link: EngineLink, reason: str) -> None:
        """Circuit-break one engine: no further placements land on it;
        the autoscaler drains + replaces it (its routed jobs migrate
        off with their checkpoints — nothing is lost).  One-way: a
        quarantined engine never un-quarantines (replacement is the
        recovery, mirroring the engine's job quarantine).  Only reachable
        when an autoscaler is attached — a fixed pool has no replacer,
        so its ladder tops out at ``degraded`` (place-last) and the
        poll watchdog stays the kill path for truly wedged engines:
        permanently losing live capacity would be strictly worse than
        degraded placements."""
        if self.autoscaler is None:
            return
        with self._lock:
            if link.health == "quarantined":
                return
            link.health = "quarantined"
        telemetry.counter("fleet.engines_quarantined").add(1)
        print(
            f"a5gen: fleet: engine {link.engine_id} QUARANTINED "
            f"({reason}); placements stop — the autoscaler drains "
            "and replaces it",
            file=sys.stderr,
        )

    def _jitter_of(self, link: EngineLink) -> float:
        """Deterministic per-engine scrape offset: a stable hash
        fraction of ``poll_s × poll_jitter``, so N engines spread over
        the scrape tick instead of stampeding it."""
        if self._poll_s <= 0:
            return 0.0
        frac = (
            zlib.crc32(link.engine_id.encode("utf-8")) % 997
        ) / 997.0
        return self._poll_s * self._poll_jitter * frac

    def _poll_loop(self) -> None:
        while True:
            now = time.monotonic()
            due = []
            wait = self._poll_s
            for link in self.engines():
                if not link.alive:
                    continue
                if link.next_poll <= now:
                    due.append(link)
                    link.next_poll = (
                        now + self._poll_s + self._jitter_of(link)
                    )
                else:
                    wait = min(wait, link.next_poll - now)
            for link in due:
                if link.proc is not None and link.proc.poll() is not None:
                    link.kill_socket()  # reaped: reader EOF replays
                    continue
                try:
                    self._scrape(link, observe=True)
                except FleetError:
                    # One immediate in-poll retry before the failure
                    # counts: a dropped health connection
                    # or one slow reply must not walk a healthy engine
                    # toward the watchdog.
                    telemetry.counter("fleet.scrape_retries").add(1)
                    try:
                        self._scrape(link, observe=True)
                    except FleetError:
                        link.misses += 1
                        self._ladder_strike(link)
                        if link.misses >= self._poll_misses:
                            # Wedged engine (socket up, serve loop
                            # gone): the watchdog declares it dead the
                            # same way a torn socket would.
                            link.kill_socket()
            with self._lock:
                backlog = bool(self._pending)
            if backlog:
                # Belt-and-braces: capacity can free without a settle
                # this router observes (quarantine recovery, operator
                # action engine-side) — the tick re-pumps.
                self._schedule_pump()
            if self._poll_stop.wait(max(0.05, min(wait, self._poll_s))):
                return


# ---------------------------------------------------------------------------
# Local engine spawning
# ---------------------------------------------------------------------------


def spawn_engines(n: int, directory: str, *,
                  engine_args: Sequence[str] = (),
                  engine_id_prefix: str = "eng",
                  start_index: int = 0,
                  env: Optional[dict] = None,
                  stderr: Any = subprocess.DEVNULL
                  ) -> List[Tuple[str, str, subprocess.Popen]]:
    """Spawn ``n`` local ``a5gen serve`` engine processes, each on its
    own unix socket under ``directory``, all sharing ``engine_args``
    (geometry flags, and — the fleet artifact store — one
    ``--schema-cache`` directory).  Returns ``(socket_path, engine_id,
    proc)`` triples; callers attach them to a :class:`FleetRouter`
    (which retries until each engine's post-import bind lands).
    ``start_index`` offsets the id/socket numbering — the autoscaler
    spawns incrementally and must never reuse a reaped engine's
    socket path."""
    os.makedirs(directory, exist_ok=True)
    out = []
    for i in range(int(start_index), int(start_index) + int(n)):
        sock = os.path.join(directory, f"{engine_id_prefix}{i}.sock")
        eid = f"{engine_id_prefix}{i}"
        cmd = [
            sys.executable, "-m", _PACKAGE, "serve",
            "--socket", sock, "--engine-id", eid, *engine_args,
        ]
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.DEVNULL, stderr=stderr,
        )
        out.append((sock, eid, proc))
    return out


# ---------------------------------------------------------------------------
# JSONL front-ends (``a5gen fleet``): the serve protocol, routed
# ---------------------------------------------------------------------------


#: Serve ops deliberately left to ``_RouterSession._handle``'s
#: unknown-op fallback (forwarded verbatim to the job's engine):
#: id-carrying and router-state-free by construction.  The engine
#: session's op table is exactly the router's handled set ∪ this
#: declaration (``tests/test_torch_fleet.py`` diffs them), so a new
#: serve op must be declared one or the other.
ROUTER_PASSTHROUGH_OPS: frozenset = frozenset()


class _RouterSession:
    """One upstream JSONL command stream against a shared
    :class:`FleetRouter` — the same protocol ``_JsonlSession`` speaks
    for one engine, so serve clients work unmodified.  Job events are
    forwarded by the router from the engine links onto the session
    that submitted the job; the job registry is router-global, so any
    session operates on any job by id (the serve tier's adoption
    semantics)."""

    #: outbound event buffer per session; a client further behind than
    #: this is dropped (see ``_emit``).
    OUT_DEPTH = 4096

    def __init__(self, router: FleetRouter, fin: TextIO,
                 fout: TextIO) -> None:
        self._router = router
        self._fin = fin
        self._fout = fout
        #: all writes ride ONE bounded queue drained by a dedicated
        #: writer thread: ``_emit`` is called from engine-link reader
        #: threads (event forwarding), and a client that stops
        #: draining its socket must never block a reader — that would
        #: stall every tenant on that engine and make it look dead to
        #: the watchdog.  A full queue means the client is
        #: irrecoverably behind: the session goes dead (the router's
        #: ``_forward`` then stops forwarding; jobs keep running — the
        #: serve tier's dead-client discipline).
        self._out: "queue.Queue" = queue.Queue(maxsize=self.OUT_DEPTH)
        self._dead = False
        self._writer = threading.Thread(
            target=self._write_loop, name="a5-fleet-session-out",
            daemon=True,
        )
        self._writer.start()

    def _write_loop(self) -> None:
        while True:
            obj = self._out.get()
            if obj is None:
                return
            if self._dead:
                continue  # drain and discard: producers never block
            try:
                self._fout.write(json.dumps(obj) + "\n")
                self._fout.flush()
            except (OSError, ValueError):
                self._dead = True

    def _emit(self, obj: dict) -> None:
        if self._dead:
            raise OSError("client connection is gone")
        try:
            self._out.put_nowait(obj)
        except queue.Full:
            self._dead = True
            raise OSError(
                "client outbound queue overflowed (slow consumer)"
            ) from None

    def _handle(self, doc: dict) -> bool:
        op = protocol.doc_op(doc)
        jid = doc.get("id")
        if op == "shutdown":
            self._emit(protocol.ev_bye())
            return False
        if op == "stats":
            self._emit(self._router.stats())
            return True
        if op == "metrics":
            self._emit(self._router.metrics())
            return True
        if op == "submit":
            ack = self._router.submit(doc, emit=self._emit)
            # Admission-queued: accepted, not yet
            # placed — the client's events flow once it dispatches.
            self._emit(protocol.ev_accepted(
                ack.get("id", jid), ack.get("kind"),
                engine=ack.get("engine"),
                queued=bool(ack.get("queued")),
                shards=ack.get("shards"),
            ))
            return True
        if op == "pause":
            self._router.pause(jid)
        elif op == "resume":
            ack = self._router.resume(jid)
            self._emit(protocol.ev_accepted(
                jid, ack.get("kind"),
                queued=bool(ack.get("queued")), resumed=True,
            ))
        elif op == "cancel":
            self._router.cancel(jid)
        elif op == "split":
            ack = self._router.split(jid, doc.get("shards"))
            self._emit(protocol.ev_accepted(
                jid, ack.get("kind"), shards=ack.get("shards"),
            ))
        elif op == "migrate":
            self._emit(self._router.migrate(jid, doc.get("engine")))
        elif op == "drain":
            self._emit(self._router.drain(doc.get("engine")))
        elif jid is not None:
            # Unknown op on a known job: pass through to its engine —
            # new serve ops must not need a router release.
            self._router.passthrough(doc)
        else:
            raise ValueError(f"unknown op {op!r}")
        return True

    def run(self) -> bool:
        """Process the stream; True when an explicit ``shutdown``
        ended it (EOF ends only this session).  Stops the writer
        thread on exit, flushing whatever the client still drains
        (the ``bye`` ack included)."""
        try:
            while True:
                try:
                    line = self._fin.readline()
                except (OSError, ValueError):
                    return False
                if not line:
                    return False
                line = line.strip()
                if not line:
                    continue
                doc = None
                try:
                    doc = json.loads(line)
                    keep_going = self._handle(doc)
                except OSError:
                    return False  # this session's client is gone
                except FleetOverloaded as exc:
                    # The typed overload rejection:
                    # machine-parseable error + retry_after_s, so
                    # clients back off instead of hammering.
                    try:
                        self._emit(exc.event(
                            doc.get("id") if isinstance(doc, dict)
                            else None
                        ))
                    except OSError:
                        return False
                    continue
                except Exception as exc:  # noqa: BLE001 — protocol
                    # Id-carrying like the engine session's errors —
                    # clients correlate failures to the op that caused
                    # them.
                    err = protocol.ev_error(
                        f"{type(exc).__name__}: {exc}",
                        jid=(doc.get("id")
                             if isinstance(doc, dict) else None),
                    )
                    try:
                        self._emit(err)
                    except OSError:
                        return False
                    continue
                if not keep_going:
                    return True
        finally:
            self._out.put(None)
            self._writer.join(timeout=5.0)
            # Late forwards for still-running jobs must raise into
            # the router's _forward (which then drops the callback),
            # not buffer into a queue nobody drains.
            self._dead = True


def serve_fleet_stdio(router: FleetRouter, fin: TextIO,
                      fout: TextIO) -> None:
    """Serve one JSONL command stream against the router."""
    _RouterSession(router, fin, fout).run()


def serve_fleet_socket(router: FleetRouter, path: str, *,
                       ready: Optional[Callable[[], None]] = None
                       ) -> None:
    """Serve JSONL sessions over a unix socket at ``path`` (one
    session per connection, all sharing the router and its job
    registry); returns when a session sends ``shutdown``."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    stop = threading.Event()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen()
        srv.settimeout(0.2)
        if ready is not None:
            ready()
        while not stop.is_set():
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                continue

            def _session(conn: socket.socket = conn) -> None:
                with conn:
                    fin = conn.makefile("r", encoding="utf-8")
                    fout = conn.makefile("w", encoding="utf-8")
                    if _RouterSession(router, fin, fout).run():
                        stop.set()

            threading.Thread(
                target=_session, name="a5-fleet-conn", daemon=True
            ).start()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
