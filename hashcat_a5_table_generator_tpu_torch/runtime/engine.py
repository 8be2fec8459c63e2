"""The resident engine: one process serving many tenants' sweeps (the
reference's ``runtime/engine.py``).

A cold CLI run pays its plans, schemas and kernel builds before its first
candidate.  :class:`Engine` keeps one process resident: it owns the
process's step-closure cache (``runtime.sweep._STEP_CACHE``), the on-disk
piece-schema cache and a job queue, and multiplexes many tenant sweeps
through one drive loop.

The substrate is the sweep's machine protocol
(``Sweep.crack_machine`` / ``Sweep.candidates_machine``): each sweep is a
resumable generator that yields at every consumed fetch boundary with its
:class:`CheckpointState` consistent.  The scheduler groups admitted jobs
by static config and round-robins ``next()`` across their machines, so
jobs interleave at superstep boundaries on one device without mixing
their ``(word, rank)`` cursors.  Compatible crack jobs admitted together
are fused into one packed dispatch (``runtime/fuse.py``): the group is
pumped once a round, before its members tick.

Hits are delivered per job through a bounded queue
(:meth:`EngineJob.iter_hits`).  Pause, resume and cancel ride the
checkpoint state: pausing closes the job's machine at its last consumed
boundary and hands back the state — a migrating job is that checkpoint
submitted to another engine (of either package).  A solo job through the
engine is byte-identical to ``run_crack`` / ``run_candidates``: the
engine runs the same generator those exhaust.

Front-ends: the Python API (``Engine.submit``), and ``a5gen serve``
speaking the JSONL wire of ``runtime/protocol.py`` over stdin/stdout or a
unix socket (:func:`serve_stdio` / :func:`serve_socket`).

The serve round advances each runnable job by exactly one boundary tick
and fetches nothing from the device itself: the machines (and the fused
groups' pumps) own every device→host round trip.
"""

from __future__ import annotations

import copy
import itertools
import json
import queue
import threading
import time
from dataclasses import replace
from typing import (
    TYPE_CHECKING,
    Callable,
    Dict,
    Generator,
    IO,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

from . import telemetry
from . import faults as faults_mod
from . import protocol
from .checkpoint import CheckpointState, state_from_doc, state_to_doc
from .sinks import CandidateWriter, HitRecord

if TYPE_CHECKING:
    import socket as _socket

    from ..models.attack import AttackSpec
    from .fuse import FusedGroup
    from .sweep import Sweep, SweepConfig, SweepResult


class JobCancelled(Exception):
    """Raised by :meth:`EngineJob.result` for a cancelled job."""


class JobFailed(Exception):
    """Raised by :meth:`EngineJob.result` for a failed job; ``__cause__``
    is the machine's exception."""


#: End-of-stream sentinel on a job's hit queue.
_HITS_END = object()


class _CtlEvent:
    """A control notification riding a job's async queue between hits
    (today: ``refused`` — the job's fused group was re-fused tighter
    after tenant departure).  Carries the event KIND plus
    the constructor kwargs; the serve pump builds the wire doc with the
    typed ``runtime.protocol`` constructor at the emit site, and the
    Python API's ``iter_hits`` filters these out — its
    contract stays hits-only."""

    __slots__ = ("kind", "fields")

    def __init__(self, kind: str, fields: dict) -> None:
        self.kind = kind
        self.fields = fields


class EngineJob:
    """One tenant sweep's handle: state, async hits, result, and the
    pause/resume/cancel controls.

    Lifecycle: ``queued`` → ``running`` → one of ``done`` / ``paused`` /
    ``cancelled`` / ``failed``.  All mutation happens on the engine's
    serve thread; the handle's events make the transitions waitable from
    tenant threads."""

    def __init__(self, job_id: str, kind: str, submit_args: dict,
                 hit_queue_depth: int) -> None:
        self.id = job_id
        self.kind = kind  # 'crack' | 'candidates'
        self.state = "queued"
        #: the pause/migrate handoff: a deep copy of the machine's
        #: CheckpointState, set when the job parks (and on done, for
        #: inspection).
        self.checkpoint: Optional[CheckpointState] = None
        self.result_value: "Optional[SweepResult]" = None
        self.error: Optional[BaseException] = None
        #: time-to-first-fetch relative to the machine's start (None
        #: until known) — the warm-vs-cold instrument.
        self.ttfc_s: Optional[float] = None
        #: the sweep's span-timeline digest, set when the
        #: job settles; the serve front-end attaches it to the
        #: ``done``/``paused`` event.
        self.span_summary: dict = {}
        self._submit_args = submit_args  # engine-side resume/migrate
        self._hits: "queue.Queue" = queue.Queue(maxsize=hit_queue_depth)
        self._settled = threading.Event()  # done/paused/cancelled/failed
        self._pause_req = threading.Event()
        self._cancel_req = threading.Event()

    # -- tenant surface ------------------------------------------------

    def iter_hits(self) -> "Iterator[HitRecord]":
        """Yield this job's :class:`HitRecord` s as they are fetched
        (bounded queue — a slow consumer backpressures the engine:
        while this job's queue is full, NO tenant advances, so crack
        jobs expecting more than ``hit_queue_depth`` hits must drain
        this iterator concurrently, or raise the depth).  Ends when the
        job settles; a paused job's stream ends too (the resumed job
        gets a fresh handle and re-plays checkpointed hits into it)."""
        for item in self._iter_records():
            if isinstance(item, _CtlEvent):
                continue
            yield item

    def _iter_records(self) -> "Iterator[Union[HitRecord, _CtlEvent]]":
        """``iter_hits`` plus the interleaved :class:`_CtlEvent`
        control notifications, in stream order — the serve front-end's
        pump consumes this to forward engine-side events (``refused``)
        to the wire; the Python API filters them out."""
        while True:
            try:
                item = self._hits.get(timeout=0.2)
            except queue.Empty:
                # Settled with an empty queue = end of stream (the
                # settle-side sentinel is best-effort only).
                if self._settled.is_set() and self._hits.empty():
                    return
                continue
            if item is _HITS_END:
                return
            yield item

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait until the job settles (done/paused/cancelled/failed)."""
        return self._settled.wait(timeout)

    def result(
        self, timeout: Optional[float] = None
    ) -> "Optional[SweepResult]":
        """Block for the job's :class:`SweepResult`.  Raises
        :class:`JobCancelled` / :class:`JobFailed` accordingly, and
        ``TimeoutError`` if the job has not settled in time (a PAUSED
        job never produces a result — resume it first)."""
        if not self._settled.wait(timeout):
            raise TimeoutError(f"job {self.id} still {self.state}")
        if self.state == "cancelled":
            raise JobCancelled(f"job {self.id} was cancelled")
        if self.state == "failed":
            raise JobFailed(f"job {self.id} failed") from self.error
        if self.state == "paused":
            raise JobFailed(
                f"job {self.id} is paused — resume it (Engine.resume or "
                "submit its checkpoint elsewhere) to get a result"
            )
        return self.result_value

    def request_pause(self) -> None:
        """Ask the engine to park this job at its next superstep
        boundary (non-blocking; see :meth:`pause`)."""
        self._pause_req.set()

    def pause(self, timeout: Optional[float] = None) -> CheckpointState:
        """Park the job at its next fetched boundary and return its
        CheckpointState — the migrate token another engine resumes
        from.  Pausing an already-settled job returns its final state's
        checkpoint if one exists."""
        self.request_pause()
        if not self._settled.wait(timeout):
            raise TimeoutError(f"job {self.id} did not park in time")
        if self.state == "paused":
            return self.checkpoint
        if self.state == "done":
            # Raced completion: the sweep finished before the park.
            return self.checkpoint
        raise JobFailed(
            f"job {self.id} settled as {self.state!r} before pausing"
        ) from self.error

    def cancel(self) -> None:
        """Ask the engine to drop this job at its next boundary
        (non-blocking; in-flight device work is abandoned — the
        machine's close runs the sweep's cleanup)."""
        self._cancel_req.set()

    # -- engine-side helpers (serve thread only) -----------------------

    def _push_hit(self, record: HitRecord) -> None:
        # Bounded backpressure, but never a deadlock the tenant cannot
        # break: a full queue blocks the serve thread (by contract)
        # UNTIL the consumer drains — or this job is cancelled/paused,
        # which drops further queue delivery (the hit already sits in
        # the machine's CheckpointState and the recorder's ordered
        # list, so cancel loses nothing the result reports and a
        # resumed job replays everything from its checkpoint).
        while not (self._cancel_req.is_set() or self._pause_req.is_set()):
            try:
                self._hits.put(record, timeout=0.2)
                return
            except queue.Full:
                continue

    def _push_ctl(self, kind: str, **fields: object) -> None:
        # Best-effort, never blocking: a control notification is
        # informational (stream correctness never depends on it), so a
        # full queue DROPS it rather than stalling the serve thread
        # outside the documented hit backpressure.
        try:
            self._hits.put_nowait(_CtlEvent(kind, fields))
        except queue.Full:
            pass

    def _settle(self, state: str) -> None:
        self.state = state
        self._settled.set()
        try:
            # Best-effort wakeup; iter_hits also terminates on the
            # settled flag, so a full queue cannot block settling.
            self._hits.put_nowait(_HITS_END)
        except queue.Full:
            pass


class _JobRecorder:
    """Hit recorder feeding a job's bounded async queue while keeping
    the ordered list the :class:`SweepResult` reports — the per-job
    delivery seam of the once-per-superstep fetch.

    ``mute``: how many leading emits to withhold from the ASYNC queue
    while still rebuilding the ordered list — a restarted/demoted
    machine replays its checkpointed hits first, and the
    tenant already received exactly those on the same handle."""

    def __init__(self, job: EngineJob, mute: int = 0) -> None:
        self.hits: List[HitRecord] = []
        self._job = job
        self._mute = int(mute)

    def emit(self, record: HitRecord) -> None:
        self.hits.append(record)
        if self._mute > 0:
            self._mute -= 1
            return
        self._job._push_hit(record)


class _Slot:
    """One admitted job on the scheduler: its Sweep, its machine, its
    group (static-trace-config) key, and its affinity token (the
    fleet router's placement signal, ``runtime.fuse.affinity_token``)."""

    def __init__(self, job: EngineJob, sweep: "Sweep",
                 machine: "Generator[None, None, SweepResult]",
                 group: str, seq: int, token: str = "") -> None:
        self.job = job
        self.sweep = sweep
        self.machine = machine
        self.group = group
        self.seq = seq
        self.token = token
        #: engine-level machine restarts consumed: a
        #: transiently-failing machine is rebuilt from its own last
        #: boundary up to ``Engine(job_retries=)`` times before the job
        #: is quarantined.
        self.restarts = 0


class Engine:
    """The resident multi-tenant sweep engine.

    ``defaults`` seeds every job's :class:`SweepConfig` (a job's
    ``config=`` overrides it wholesale); sharing one geometry across
    jobs is what lets the step cache serve them all from one compiled
    program.  ``auto=True`` (default) runs the serve loop on a daemon
    thread; ``auto=False`` is the embedder's mode — call
    :meth:`run_until_idle` (or :meth:`_admit` + :meth:`_serve_round`)
    yourself, which is also how the tests make pause/cancel timing
    deterministic."""

    def __init__(self, defaults: "Optional[SweepConfig]" = None, *,
                 hit_queue_depth: int = 4096,
                 auto: bool = True, pack: Optional[bool] = None,
                 admission_worker: bool = True,
                 faults: "Optional[object]" = None,
                 job_retries: int = 1,
                 refuse_below: "Optional[float]" = None,
                 refuse_scope: "Optional[str]" = None) -> None:
        from ..ops.packing import schema_cache_stats
        from .sweep import SweepConfig, step_cache_stats

        # Fault arming: an explicit plan/spec wins;
        # otherwise A5GEN_FAULTS decides (unset = nothing armed).
        if faults is not None:
            faults_mod.install(faults)
        else:
            faults_mod.ensure_env()
        #: machine restarts granted per job before quarantine
        #: (degradation ladder).
        self._job_retries = int(job_retries)
        self.defaults = defaults if defaults is not None else SweepConfig()
        self._hit_queue_depth = int(hit_queue_depth)
        self._pending: "queue.Queue" = queue.Queue()
        self._active: List[_Slot] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._counts = {
            "jobs_submitted": 0, "jobs_done": 0, "jobs_failed": 0,
            "jobs_cancelled": 0, "jobs_paused": 0, "supersteps_served": 0,
        }
        self._groups: Dict[str, int] = {}
        #: active slots per affinity token (runtime.fuse.affinity_token)
        #: — the resident-group surface the fleet router's placement
        #: reads through the stats op.
        self._resident: Dict[str, int] = {}
        #: cross-job physical packing: None = the
        #: A5GEN_PACK env hatch decides (on by default); False restores
        #: per-job dispatch for every job.
        self._pack = pack
        #: fused tenant groups currently dispatching (runtime.fuse).
        self._fused: List = []
        #: admission-time compile offload: plan/prescan/
        #: schema builds run on ONE bounded worker thread (generalizing
        #: ``ops.packing.ChunkCompiler``'s pattern) instead of stalling the serve
        #: round — warm-job admission under load stops paying the build
        #: on the multiplexing thread.  None = build synchronously in
        #: ``_admit``.
        self._admit_ex = None
        if admission_worker:
            from concurrent.futures import ThreadPoolExecutor

            self._admit_ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="a5-engine-admit"
            )
        #: completed builds: (job, slot | None, exc | None) — the worker
        #: (or the sync path) produces, the serve thread consumes.
        self._built: "queue.Queue" = queue.Queue()
        self._building = 0  # builds in flight (under _lock)
        self._in_build: set = set()  # their jobs, for close(cancel=True)
        #: same-scheduler-key jobs drained from one submission burst are
        #: staged until ALL their builds land, then fused together —
        #: packing needs the whole batch's plans to concatenate.
        #: Mutated under ``_lock`` (``close(cancel=True)`` snapshots it
        #: from the caller thread).
        self._staging: Dict[str, dict] = {}
        self._cancel_all = False  # close(cancel=True) raced activations
        #: dynamic re-fuse: the fill threshold below
        #: which a fused group that LOST tenants is re-fused into a
        #: tighter group.  None = the A5GEN_REFUSE env hatch decides
        #: (0.5 by default); 0/0.0 disables re-fuse for this engine.
        self._refuse_below = refuse_below
        #: re-fuse merge scope: "cross" (default) lets a
        #: thin-group retrace harvest survivors from OTHER thin
        #: compatible groups too (the pack_candidate key proves safety
        #: in _prepare_fuse's bucketing); "within" pins the
        #: one-group-only behavior.  None = A5GEN_REFUSE's within[:thr]
        #: spelling decides.
        if refuse_scope not in (None, "within", "cross"):
            raise ValueError(
                "refuse_scope must be None, 'within' or 'cross'"
            )
        self._refuse_scope_cfg = refuse_scope
        #: survivors detached from a thinned group, their re-fuse build
        #: in flight on the admission worker (under ``_lock``; counted
        #: in ``jobs_active`` — they are load, just not runnable yet).
        self._refusing: List[_Slot] = []
        #: packed-fill instruments (under ``_lock``): the last observed
        #: per-pump fill and the running minimum since engine start
        #: (sampling at fuse time only would hide masked-lane decay).
        self._fill_last: Optional[float] = None
        self._fill_min: Optional[float] = None
        self._step0 = step_cache_stats()
        self._schema0 = schema_cache_stats()
        self._packed0 = self._packed_counters()
        self._ladder0 = self._ladder_counters()
        self._thread: Optional[threading.Thread] = None
        if auto:
            self._thread = threading.Thread(
                target=self._serve_forever, name="a5-engine-serve",
                daemon=True,
            )
            self._thread.start()

    def _pack_on(self) -> bool:
        if self._pack is not None:
            return bool(self._pack)
        from .env import pack_enabled

        return pack_enabled()

    def _refuse_threshold(self) -> "Optional[float]":
        """The resolved re-fuse fill threshold: an
        explicit ``Engine(refuse_below=)`` wins (0/0.0 = disabled);
        otherwise the A5GEN_REFUSE env hatch decides."""
        if self._refuse_below is not None:
            return float(self._refuse_below) or None
        from .env import refuse_threshold

        return refuse_threshold()

    def _refuse_scope(self) -> str:
        """The resolved re-fuse merge scope: an explicit
        ``Engine(refuse_scope=)`` wins; otherwise A5GEN_REFUSE's
        ``within[:thr]`` spelling pins the within-group-only control
        and anything else means cross-group merging."""
        if self._refuse_scope_cfg is not None:
            return self._refuse_scope_cfg
        from .env import refuse_scope

        return refuse_scope()

    @staticmethod
    def _packed_counters() -> Dict[str, int]:
        return {
            k: int(telemetry.counter(f"engine.packed_{k}").value)
            for k in ("dispatches", "lanes_occupied", "lanes_total")
        }

    @staticmethod
    def _ladder_counters() -> Dict[str, int]:
        return {
            k: int(telemetry.counter(f"engine.{k}").value)
            for k in ("group_demotions", "job_restarts", "refuse_total",
                      "refuse_cross")
        }

    # -- tenant surface ------------------------------------------------

    def submit(
        self,
        spec: "AttackSpec",
        sub_map: Dict[bytes, List[bytes]],
        words: Sequence[bytes],
        digests: Sequence[bytes] = (),
        *,
        config: "Optional[SweepConfig]" = None,
        kind: str = "crack",
        writer: Optional[CandidateWriter] = None,
        resume_state: Optional[CheckpointState] = None,
        job_id: Optional[str] = None,
        mute: int = 0,
    ) -> EngineJob:
        """Queue one tenant sweep; returns its :class:`EngineJob`
        handle immediately.  ``kind='crack'`` needs ``digests`` and
        streams hits; ``kind='candidates'`` needs a ``writer``.
        ``resume_state`` is a paused job's CheckpointState (this
        engine's or another's) — the migrate handoff; its fingerprint
        must match the job's semantic inputs.  ``mute`` withholds the
        leading N hit emissions from the ASYNC delivery queue (the
        ``_JobRecorder(mute=)`` discipline): a
        resumed machine replays its checkpointed hits first, and a
        fleet router that already forwarded N hits downstream passes
        ``mute=N`` so redelivery stays exactly-once — the ordered
        result list still rebuilds in full either way."""
        if kind not in ("crack", "candidates"):
            raise ValueError(f"kind must be 'crack' or 'candidates', "
                             f"got {kind!r}")
        if kind == "candidates" and writer is None:
            raise ValueError("candidates jobs need a writer=")
        if self._shutdown:
            raise RuntimeError("engine is shut down")
        if mute and kind != "crack":
            raise ValueError("mute= only applies to crack jobs (the "
                             "async hit-delivery queue)")
        job = EngineJob(
            job_id if job_id is not None else f"job-{next(self._ids)}",
            kind,
            dict(spec=spec, sub_map=sub_map, words=words, digests=digests,
                 config=config, writer=writer),
            self._hit_queue_depth,
        )
        job._resume_state = resume_state
        job._mute = max(0, int(mute))
        with self._lock:
            self._counts["jobs_submitted"] += 1
        telemetry.counter("engine.jobs_submitted").add(1)
        self._pending.put(job)
        self._wake.set()
        return job

    def resume(self, job: EngineJob) -> EngineJob:
        """Re-admit a PAUSED job from its checkpoint (same engine; for
        cross-engine migration call ``other.submit(..., resume_state=
        job.checkpoint)`` with the same semantic inputs).  Returns a
        fresh handle under the same job id."""
        if job.state != "paused" or job.checkpoint is None:
            raise ValueError(f"job {job.id} is {job.state}, not paused")
        a = job._submit_args
        return self.submit(
            a["spec"], a["sub_map"], a["words"], a["digests"],
            config=a["config"], kind=job.kind, writer=a["writer"],
            resume_state=job.checkpoint, job_id=job.id,
        )

    def stats(self) -> dict:
        """Engine observability: job counts, static-config groups, and
        the compile-amortization counters — compiled-program builds vs
        cache hits (process step cache) and on-disk schema-cache
        activity, both as deltas since this engine started."""
        from ..ops.packing import schema_cache_stats
        from .sweep import _stats_delta, step_cache_stats

        with self._lock:
            counts = dict(self._counts)
            groups = dict(self._groups)
            # Re-fusing survivors are still this engine's
            # load — a router must not see a dip while a rebuild is in
            # flight — so both activity signals count them.
            active = len(self._active) + len(self._refusing)
            refusing = len(self._refusing)
            fill_last = self._fill_last
            fill_min = self._fill_min
            fused = len(self._fused)
            building = self._building
            staged = sum(
                len(stage["ready"]) for stage in self._staging.values()
            )
            resident = set(self._resident)
            for stage in self._staging.values():
                resident.update(
                    s.token for s in stage["ready"] if s.token
                )
        steps = _stats_delta(self._step0, step_cache_stats())
        packed = _stats_delta(self._packed0, self._packed_counters())
        ladder = _stats_delta(self._ladder0, self._ladder_counters())
        return {
            **counts,
            "jobs_active": active,
            # The fleet router's placement signals:
            # runnable (= active; the alias names the scheduling
            # state), staged (built, parked for burst peers), building
            # (admission worker), and the resident affinity tokens —
            # jobs whose token matches land here to maximize
            # fuse/compile reuse.
            "jobs_runnable": active,
            "jobs_staged": staged,
            "resident_groups": sorted(resident),
            # The engine's RESOLVED token-relevant defaults: a job doc
            # omitting a config field gets this value (``_job_from_doc``
            # replaces only supplied fields), so a router must fill
            # the same gaps with the same values or its doc tokens
            # never match the resident ones.
            "config_defaults": {
                "lanes": self.defaults.lanes,
                "blocks": self.defaults.num_blocks,
                "superstep": self.defaults.superstep,
                "devices": self.defaults.devices,
                "pair": self.defaults.pair,
            },
            "jobs_queued": self._pending.qsize(),
            "jobs_building": building,
            "groups": groups,
            "programs_compiled": steps.get("misses", 0),
            "program_cache_hits": steps.get("hits", 0),
            "schema_cache": _stats_delta(self._schema0,
                                         schema_cache_stats()),
            # The fleet health ladder's strain signals:
            # recovery-ladder activity since THIS engine started — a
            # router scraping rising deltas degrades (and eventually
            # quarantines) the engine instead of placing fresh tenants
            # onto failing hardware.
            "group_demotions": ladder.get("group_demotions", 0),
            "job_restarts": ladder.get("job_restarts", 0),
            # Cross-job packing: fused groups currently
            # dispatching, packed dispatches since engine start, and
            # the aggregate fill ratio (occupied / total lanes across
            # packed dispatches; 0 when none ran).
            "fused_groups": fused,
            "packed_dispatches": packed.get("dispatches", 0),
            "packed_fill": (
                packed.get("lanes_occupied", 0)
                / packed["lanes_total"]
                if packed.get("lanes_total") else 0.0
            ),
            # Dynamic re-fuse: retraces since engine
            # start, survivors mid-rebuild, and the per-pump fill
            # instruments — last observed and the running minimum —
            # which (unlike the aggregate above) expose POST-departure
            # masked-lane decay the moment it happens.
            "refuse_total": ladder.get("refuse_total", 0),
            # Cross-group merges: retraces that harvested
            # survivors from MORE than one thin group in one batch.
            "refuse_cross": ladder.get("refuse_cross", 0),
            "jobs_refusing": refusing,
            "packed_fill_last": (
                fill_last if fill_last is not None else 0.0
            ),
            "packed_fill_min": (
                fill_min if fill_min is not None else 0.0
            ),
        }

    def close(self, *, cancel: bool = False,
              timeout: Optional[float] = None) -> None:
        """Stop serving.  Default drains: queued and active jobs finish
        first; ``cancel=True`` drops them at the next boundary."""
        if cancel:
            with self._lock:
                # One snapshot closes the staging→active move gap: a
                # slot not yet in any list is caught by _cancel_all at
                # its activation.
                self._cancel_all = True
                # Re-fusing survivors cancel like active slots: they
                # reactivate when their rebuild lands and the flag then
                # retires them at their first round.
                slots = list(self._active) + list(self._refusing)
                building = list(self._in_build)
                # Staged-ready slots (built, parked for their burst
                # peers) must cancel too: they activate when their
                # batch releases, and the cancel flag then retires them
                # at their first round, before any machine tick.
                staged = [
                    s.job
                    for stage in self._staging.values()
                    for s in stage["ready"]
                ]
            for slot in slots:
                slot.job.cancel()
            for job in building + staged:
                # Builds in flight on the admission worker finish, then
                # settle cancelled at collection (the cancel-req check
                # in _finish_build).
                job.cancel()
            while True:
                try:
                    job = self._pending.get_nowait()
                except queue.Empty:
                    break
                # Never admitted: settle the handle here so waiters
                # unblock (the serve thread will not see this job).
                self._settle_counts(job, "cancelled")
        self._shutdown = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
        else:
            # Embedder mode has no serve thread to drain the jobs —
            # drain here so close() keeps its settle-everything
            # contract (cancelled slots retire on their next round).
            self.run_until_idle()
        # A submit that raced past the shutdown check may have enqueued
        # AFTER the serve loop exited; nothing will ever admit it —
        # settle the stragglers so no handle waits forever.
        while True:
            try:
                job = self._pending.get_nowait()
            except queue.Empty:
                break
            self._settle_counts(job, "cancelled")
        if self._admit_ex is not None:
            # The drain above consumed every completed build; stop the
            # worker (waits out any still-running build — its job was
            # settled through the cancel path or served by the drain).
            self._admit_ex.shutdown(wait=True)
            self._collect_builds()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close(cancel=exc[0] is not None)

    # -- scheduler (serve thread) --------------------------------------

    def _serve_forever(self) -> None:
        # The machines launch on this thread: the engine's card is made
        # current here once (ctypes launches need it).
        _make_current(self.defaults.device)
        while True:
            self._admit(wait=False)
            with self._lock:
                idle = not self._active
                building = self._building > 0
            if idle:
                if building:
                    self._wake.wait(0.05)
                    self._wake.clear()
                    continue
                if self._staging and self._flush_staging():
                    continue
                if self._shutdown and self._pending.empty():
                    return
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            self._serve_round()

    def run_until_idle(self) -> None:
        """Manual-mode drive: admit and serve until no job is active,
        building, or queued (embedders owning the loop; tests)."""
        while True:
            self._admit(wait=False)
            with self._lock:
                active = bool(self._active)
                building = self._building > 0
            if active:
                self._serve_round()
                continue
            if building:
                # Nothing to serve yet: block on the next completed
                # build instead of spinning (bounded wait — a worker
                # death would otherwise hang the embedder forever).
                try:
                    item = self._built.get(timeout=0.5)
                except queue.Empty:
                    continue
                self._consume_built(item)
                continue
            if not self._pending.empty():
                continue
            if self._staging and self._flush_staging():
                continue
            return

    def _flush_staging(self) -> bool:
        """Defensive drain: release any staged batches whose peers will
        never arrive (a failed bookkeeping path must degrade to solo
        admission, never to jobs stuck in staging)."""
        released = False
        with self._lock:
            stages = list(self._staging.values())
            self._staging.clear()
        for stage in stages:
            if stage["ready"]:
                self._fuse_and_activate(stage["ready"])
                released = True
        return released

    def _admit(self, wait: bool = True) -> None:
        """Drain the submission queue into scheduler slots.  Each job's
        Sweep build (plan + prescan + schema compile — host work) runs
        on the bounded admission worker so the serve
        round keeps multiplexing the already-running tenants; completed
        builds are collected here, grouped by static trace config (so
        same-config jobs ride one compiled program and run adjacently),
        and — when packing is on — same-burst compatible jobs are fused
        into one packed dispatch group (``runtime.fuse``).

        ``wait=True`` (the manual embedder API's contract: after
        ``_admit()`` every submitted job IS a scheduler slot) blocks
        until the in-flight builds land; the serve loops pass False and
        collect completed builds opportunistically each round."""
        while True:
            try:
                job = self._pending.get_nowait()
            except queue.Empty:
                break
            self._intake(job)
        # The admission-build window IS the packing window: while the
        # worker is still building this burst, peers arriving a few
        # milliseconds apart (one JSONL line at a time through ``a5gen
        # serve``) join the same staging batch — at zero added latency,
        # since admission cannot outrun the build anyway.  The window
        # closes when the worker drains OR at a hard deadline (a client
        # submitting faster than builds complete must not extend it
        # forever — jobs still have to activate and serve), and never
        # opens at all while tenants are RUNNABLE: the serve round must
        # keep multiplexing them during a build (the whole point of the
        # admission offload), so a busy engine collects this burst over
        # its ordinary rounds instead of lingering here.
        with self._lock:
            serving = bool(self._active)
        if self._admit_ex is not None and self._pack_on() and not serving:
            deadline = time.monotonic() + 0.25
            while (
                self._building - self._built.qsize() > 0
                and time.monotonic() < deadline
            ):
                try:
                    job = self._pending.get(timeout=0.002)
                except queue.Empty:
                    continue
                self._intake(job)
        self._collect_builds()
        while wait:
            with self._lock:
                building = self._building > 0
            if not building:
                if self._staging:
                    self._flush_staging()
                return
            try:
                item = self._built.get(timeout=0.5)
            except queue.Empty:
                continue
            self._consume_built(item)

    def _intake(self, job: EngineJob) -> None:
        """One drained submission: honor a pre-admission cancel, stage
        crack jobs for packing, and hand the build to the worker (or
        build inline in sync-admission mode)."""
        if job._cancel_req.is_set():
            self._settle_counts(job, "cancelled")
            return
        if self._pack_on() and job.kind == "crack":
            skey = self._staging_key(job)
            with self._lock:
                stage = self._staging.setdefault(
                    skey, {"need": 0, "ready": []}
                )
                stage["need"] += 1
            job._staging_key = skey
        else:
            job._staging_key = None
        if self._admit_ex is None:
            self._built.put(("job",) + self._safe_build(job))
        else:
            with self._lock:
                self._building += 1
                self._in_build.add(job)
            self._admit_ex.submit(self._worker_build, job)

    def _staging_key(self, job: EngineJob) -> str:
        a = job._submit_args
        cfg = a["config"] if a["config"] is not None else self.defaults
        return f"{job.kind}|{self._group_key(a['spec'], cfg)}"

    def _try_build(
        self, job: EngineJob
    ) -> "Tuple[EngineJob, Optional[_Slot], Optional[BaseException]]":
        try:
            return job, self._build_slot(job), None
        except Exception as exc:  # noqa: BLE001 — job-scoped failure
            return job, None, exc

    def _safe_build(
        self, job: EngineJob
    ) -> "Tuple[EngineJob, Optional[_Slot], Optional[BaseException]]":
        """``_try_build`` with a worker-death net: a
        ``BaseException`` escaping the job-scoped ``except Exception``
        (the fault layer's ``WorkerDeath``, a dying thread) must not
        strand the build — it ships across the queue like any failure,
        where ``_finish_build`` applies the restart-once recovery.
        KeyboardInterrupt/SystemExit re-raise: in sync-admission mode
        this runs on the CALLER's thread, and a Ctrl-C must stay a
        Ctrl-C, never become a failed job."""
        try:
            return self._try_build(job)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:  # noqa: BLE001 — worker death
            return job, None, exc

    def _worker_build(self, job: EngineJob) -> None:
        self._built.put(("job",) + self._safe_build(job))
        self._wake.set()

    def _consume_built(self, item: tuple) -> None:
        """One completed admission-worker product: a job build
        (``("job", job, slot, exc)``) or an off-thread fuse build
        (``("fuse", result)`` — activation-on-completion)."""
        if item[0] == "fuse":
            with self._lock:
                self._building -= 1
            return self._finish_fuse(item[1])
        if item[0] == "fuse_death":
            # Worker-death recovery for an off-thread fuse build
            # (mirrors _finish_build's non-Exception branch): restart
            # the executor once, re-run the SAME batch on the fresh
            # worker; a second death settles the batch failed (the
            # retried flag in _worker_fuse).  ``_building`` stays
            # incremented — the resubmitted build's completion
            # decrements it through the ordinary "fuse" path.
            _slots, _exc = item[1], item[2]
            telemetry.counter("faults.worker_restarts").add(1)
            if self._admit_ex is not None:
                from concurrent.futures import ThreadPoolExecutor

                self._admit_ex.shutdown(wait=False)
                # Exactly one thread collects builds (the serve thread
                # in auto mode, the embedder in manual mode), so the
                # executor restart has a single writer.
                self._admit_ex = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="a5-engine-admit"
                )
                self._admit_ex.submit(self._worker_fuse, _slots, True)
                return
            with self._lock:  # pragma: no cover - sync mode never queues
                self._building -= 1
            return self._finish_fuse({
                "groups": [], "solo": [], "failed": [(list(_slots),
                                                      _exc)],
            })
        if item[0] == "refuse":
            with self._lock:
                self._building -= 1
            return self._finish_refuse(item[1])
        if item[0] == "refuse_death":
            # Same restart-once recovery as "fuse_death"; a second
            # death degrades every survivor to a SOLO rebuild from its
            # carried checkpoint (in _worker_refuse) — a re-fuse must
            # never fail a job.
            _entries, _exc = item[1], item[2]
            telemetry.counter("faults.worker_restarts").add(1)
            if self._admit_ex is not None:
                from concurrent.futures import ThreadPoolExecutor

                self._admit_ex.shutdown(wait=False)
                # Exactly one thread collects builds (the serve thread
                # in auto mode, the embedder in manual mode), so the
                # executor restart has a single writer.
                self._admit_ex = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="a5-engine-admit"
                )
                self._admit_ex.submit(self._worker_refuse, _entries,
                                      True)
                return
            with self._lock:  # pragma: no cover - sync mode never queues
                self._building -= 1
            return self._finish_refuse({
                "groups": [],
                "solo": [s for s, _st in _entries],
                "failed": [],
                "states": {id(s): st for s, st in _entries},
            })
        return self._finish_build(*item[1:])

    def _collect_builds(self) -> None:
        while True:
            try:
                item = self._built.get_nowait()
            except queue.Empty:
                return
            self._consume_built(item)

    def _finish_build(self, job: EngineJob, slot: "Optional[_Slot]",
                      exc: "Optional[BaseException]") -> None:
        """One completed admission build: settle failures (the worker's
        error propagation seam), honor cancels that raced the build,
        and either activate the slot solo or stage it until its
        submission burst's peers are all built, then fuse."""
        if self._admit_ex is not None:
            with self._lock:
                self._building -= 1
                self._in_build.discard(job)
        if (
            exc is not None
            and not isinstance(exc, Exception)
            and not getattr(job, "_build_retried", False)
        ):
            # Worker-death recovery: a BaseException-class
            # failure is the WORKER dying, not the job's inputs being
            # bad — restart the executor once and re-run this build on
            # the fresh worker before propagating.  A second death
            # falls through to the ordinary failed settle below.
            job._build_retried = True
            telemetry.counter("faults.worker_restarts").add(1)
            if self._admit_ex is not None:
                from concurrent.futures import ThreadPoolExecutor

                self._admit_ex.shutdown(wait=False)
                # Exactly one thread collects builds (the serve thread
                # in auto mode, the embedder in manual mode), so the
                # executor restart has a single writer.
                self._admit_ex = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="a5-engine-admit"
                )
                with self._lock:
                    self._building += 1
                    self._in_build.add(job)
                self._admit_ex.submit(self._worker_build, job)
                return
            return self._finish_build(*self._safe_build(job))
        skey = getattr(job, "_staging_key", None)
        with self._lock:
            stage = self._staging.get(skey) if skey is not None else None
        if exc is not None or job._cancel_req.is_set():
            if exc is not None:
                job.error = exc
                self._settle_counts(job, "failed")
            else:
                self._settle_counts(job, "cancelled")
            if stage is not None:
                with self._lock:
                    stage["need"] -= 1
                self._maybe_release(skey, stage)
            return
        if stage is None:
            self._activate(slot)
            return
        with self._lock:
            stage["ready"].append(slot)
        self._maybe_release(skey, stage)

    def _maybe_release(self, skey: str, stage: dict) -> None:
        with self._lock:
            if len(stage["ready"]) < stage["need"]:
                return
            self._staging.pop(skey, None)
        self._queue_fuse(stage["ready"])

    def _queue_fuse(self, slots: List["_Slot"]) -> None:
        """Off-thread fuse build: the
        released batch's HEAVY half — ``pack_candidate`` probes, the
        packed digest re-sort, the plan-array concatenation and device
        upload inside ``build_fused_group`` — runs on the admission
        worker, with activation-on-completion via the built queue; the
        serve round keeps multiplexing running tenants instead of
        stalling behind a large digest list's group build.  Sync-
        admission mode (no worker) keeps the inline build."""
        if self._admit_ex is None:
            return self._fuse_and_activate(slots)
        with self._lock:
            self._building += 1
        telemetry.counter("engine.fuse_builds_offthread").add(1)
        self._admit_ex.submit(self._worker_fuse, slots)

    def _worker_fuse(self, slots: List["_Slot"],
                     retried: bool = False) -> None:
        try:
            res = self._prepare_fuse(slots)
        except (KeyboardInterrupt, SystemExit):  # pragma: no cover
            raise
        except BaseException as exc:  # noqa: BLE001 — worker death
            if isinstance(exc, Exception) or retried:
                # Batch-scoped failure (or a second death): settle the
                # members failed, exactly like a group-build error.
                res = {"groups": [], "solo": [],
                       "failed": [(list(slots), exc)]}
            else:
                # WorkerDeath-class: same restart-once +
                # re-run recovery the job-build path gets — ship the
                # death to the collector, which owns the executor.
                self._built.put(("fuse_death", slots, exc))
                self._wake.set()
                return
        self._built.put(("fuse", res))
        self._wake.set()

    def _queue_refuse(self, entries: "List[tuple]") -> None:
        """Off-thread re-fuse build: the survivors'
        ``pack_candidate`` probes and the tighter group's plan
        concatenation + device upload run on the admission worker —
        the ONE retrace a re-fuse pays stays off the serve thread (the
        admission discipline), which keeps multiplexing every other
        tenant meanwhile.  ``entries`` pairs each detached slot with
        the checkpoint captured at its detach boundary; sync-admission
        mode builds inline."""
        if self._admit_ex is None:
            slots = [s for s, _st in entries]
            states = {id(s): st for s, st in entries}
            return self._finish_refuse(
                self._prepare_fuse(slots, states=states)
            )
        with self._lock:
            self._building += 1
        telemetry.counter("engine.fuse_builds_offthread").add(1)
        self._admit_ex.submit(self._worker_refuse, entries)

    def _worker_refuse(self, entries: "List[tuple]",
                       retried: bool = False) -> None:
        slots = [s for s, _st in entries]
        states = {id(s): st for s, st in entries}
        try:
            res = self._prepare_fuse(slots, states=states)
        except (KeyboardInterrupt, SystemExit):  # pragma: no cover
            raise
        except BaseException as exc:  # noqa: BLE001 — worker death
            if isinstance(exc, Exception) or retried:
                # A re-fuse must never fail a job (packing is an
                # optimization): a batch-scoped error — or a second
                # worker death — degrades every survivor to a SOLO
                # rebuild from its carried checkpoint.
                res = {"groups": [], "solo": list(slots), "failed": [],
                       "states": states}
            else:
                self._built.put(("refuse_death", entries, exc))
                self._wake.set()
                return
        self._built.put(("refuse", res))
        self._wake.set()

    def _fuse_and_activate(self, slots: List["_Slot"]) -> None:
        self._finish_fuse(self._prepare_fuse(slots))

    def _prepare_fuse(self, slots: List["_Slot"],
                      states: "Optional[dict]" = None) -> dict:
        """Fuse a released staging batch (the heavy, thread-safe half —
        the slots are not yet active, so no other thread touches their
        sweeps): slots whose full packed keys match (and that are
        individually pack-eligible) form fused groups of the largest
        size ≥ 2 dividing the block count; the rest — unique keys,
        ineligible plans, leftover odd members — take the per-job
        dispatch path.  Packing is an optimization, so
        every failure here is contained: an eligibility-probe error
        demotes the job to solo dispatch, and a group-build error
        (schema I/O, device memory on the packed upload) fails ONLY the
        batch it was fusing — never the serve thread.

        ``states`` (a re-fuse build) overrides each slot's
        admission-time resume state with the checkpoint captured at its
        detach boundary — cursors are in rank-stride units, so they
        carry over into the tighter group unchanged; the dict rides the
        result so the collector rebuilds each machine from the SAME
        state the probe aligned on."""
        from .fuse import build_fused_group, pack_candidate

        out = {"groups": [], "solo": [], "failed": [],
               "states": dict(states) if states else {}}
        buckets: Dict[tuple, List[tuple]] = {}
        for slot in slots:
            resume = (
                states.get(id(slot)) if states is not None
                else slot.job._resume_state
            )
            try:
                cand = pack_candidate(slot.sweep, resume)
            except Exception:  # noqa: BLE001 — probe error = solo path
                cand = None
            if cand is None:
                out["solo"].append(slot)
            else:
                buckets.setdefault(cand["key"], []).append((slot, cand))
        for _key, members in buckets.items():
            while len(members) >= 2:
                # The resolved block count (equal across a key): the
                # config's may be None, the sweep's built-in geometry.
                nb = members[0][1]["nb"]
                take = len(members)
                while take >= 2 and nb % take:
                    take -= 1
                if take < 2:
                    break
                chosen, members = members[:take], members[take:]
                try:
                    group = build_fused_group([c for _s, c in chosen])
                except Exception as exc:  # noqa: BLE001 — batch-scoped
                    out["failed"].append(([s for s, _c in chosen], exc))
                    continue
                if group is None:
                    out["solo"].extend(s for s, _c in chosen)
                    continue
                out["groups"].append((group, [s for s, _c in chosen]))
            out["solo"].extend(s for s, _c in members)
        return out

    def _finish_fuse(self, res: dict) -> None:
        """Activation-on-completion: the light half of a fuse build,
        always on the collecting (serve/embedder) thread."""
        for group, slots in res["groups"]:
            for slot in slots:
                group.register(slot.sweep)
                self._activate(slot)
            with self._lock:
                self._fused.append(group)
        for slots, exc in res["failed"]:
            for slot in slots:
                slot.machine.close()
                slot.job.error = exc
                self._settle_counts(slot.job, "failed")
        for slot in res["solo"]:
            self._activate(slot)

    def _finish_refuse(self, res: dict) -> None:
        """Activation-on-completion for a re-fuse build (collector
        thread).  Survivors whose packed keys still match ride the new
        tighter group; the rest rebuild SOLO from their carried
        checkpoints — a re-fuse must never fail a job, so failed
        batches degrade to solo rebuilds too, and only a machine-
        rebuild error quarantines that one member."""
        states = res.get("states", {})
        solo = list(res["solo"])
        for slots, _exc in res["failed"]:
            solo.extend(slots)
        for group, slots in res["groups"]:
            fused_any = False
            for slot in slots:
                try:
                    self._machine_from_state(slot,
                                             states.get(id(slot)))
                except Exception as exc:  # noqa: BLE001 — member-scoped
                    # Park the member's segment in the NEW group (it
                    # was built expecting this sweep), then quarantine
                    # just this member.
                    group.leave(slot.sweep)
                    self._unrefuse(slot)
                    self._quarantine(slot, exc)
                    continue
                group.register(slot.sweep)
                self._reactivate(slot)
                fused_any = True
            if fused_any:
                with self._lock:
                    self._fused.append(group)
        for slot in solo:
            try:
                self._machine_from_state(slot, states.get(id(slot)))
            except Exception as exc:  # noqa: BLE001 — member-scoped
                self._unrefuse(slot)
                self._quarantine(slot, exc)
                continue
            self._reactivate(slot)

    def _reactivate(self, slot: "_Slot") -> None:
        """Return a re-fused survivor to the scheduler.  The slot never
        left the group/resident accounting (only ``_active``), so no
        counters move; a cancel/close that raced the rebuild retires it
        at its first round, before any machine tick."""
        if self._cancel_all:
            slot.job.cancel()
        with self._lock:
            if slot in self._refusing:
                self._refusing.remove(slot)
            self._active.append(slot)
            self._active.sort(key=lambda s: (s.group, s.seq))

    def _unrefuse(self, slot: "_Slot") -> None:
        with self._lock:
            if slot in self._refusing:
                self._refusing.remove(slot)

    def _activate(self, slot: "_Slot") -> None:
        if self._cancel_all:
            # close(cancel=True) raced this slot between its snapshots
            # and activation: honor the drop (the serve round retires
            # cancel-flagged slots before any machine tick).
            slot.job.cancel()
        slot.job.state = "running"
        with self._lock:
            self._active.append(slot)
            self._groups[slot.group] = self._groups.get(slot.group,
                                                        0) + 1
            if slot.token:
                self._resident[slot.token] = self._resident.get(
                    slot.token, 0
                ) + 1
            # Same-group jobs adjacent, groups in admission order:
            # warm programs serve their whole group back to back.
            self._active.sort(key=lambda s: (s.group, s.seq))

    def _build_slot(self, job: EngineJob) -> _Slot:
        from .sweep import Sweep

        # The admission-build seam: fires on the worker
        # thread (or inline in sync mode); an injected Exception is a
        # job-scoped build failure, an injected WorkerDeath exercises
        # the restart-the-executor-once recovery in _finish_build.
        if faults_mod.ACTIVE is not None:
            faults_mod.ACTIVE.fire("admission.build")
        from .fuse import affinity_token

        a = job._submit_args
        cfg = a["config"] if a["config"] is not None else self.defaults
        _make_current(cfg.device)
        sweep = Sweep(a["spec"], a["sub_map"], a["words"], a["digests"],
                      config=cfg)
        if job.kind == "crack":
            recorder = _JobRecorder(job, mute=getattr(job, "_mute", 0))
            machine = sweep.crack_machine(
                recorder, resume=False, state=job._resume_state
            )
        else:
            machine = sweep.candidates_machine(
                a["writer"], resume=False, state=job._resume_state
            )
        return _Slot(job, sweep, machine, self._group_key(a["spec"], cfg),
                     next(self._ids), affinity_token(a["spec"], cfg))

    def _group_key(self, spec: "AttackSpec", cfg: "SweepConfig") -> str:
        """Static-trace-config grouping key: jobs agreeing here trace
        the same program shapes (the step cache's own keys add the
        plan-derived statics; this is the scheduler-visible prefix)."""
        return (
            f"{spec.mode}|{spec.algo}|{spec.min_substitute}"
            f"|{spec.max_substitute}|{cfg.lanes}|{cfg.num_blocks}"
            f"|{cfg.devices}|{cfg.superstep}"
        )

    def _serve_round(self) -> None:
        """One multiplexing round: every runnable job
        advances by exactly ONE fetched-boundary tick per round (one
        ``next()``), so tenants interleave at superstep granularity and
        no job monopolizes the device; the machines own every
        device→host fetch and the one-fetch-per-superstep discipline
        — a fetch here would barrier every tenant behind
        one job's in-flight work.  Control (pause/cancel) is handled at
        the same boundaries, where each machine's CheckpointState is
        consistent by construction.

        Fused tenant groups are pumped FIRST — exactly one
        packed dispatch+fetch per group per round (``runtime.fuse``) —
        so every packed member's tick
        below finds its split result already host-side; the member ticks
        themselves stay one-per-job, packed or not."""
        self._pump_groups()
        for slot in self._round_slots():
            if slot.job._cancel_req.is_set():
                self._retire(slot, "cancelled")
                continue
            if slot.job._pause_req.is_set():
                self._park(slot)
                continue
            try:
                next(slot.machine)
            except StopIteration as done:
                self._finish(slot, done.value)
            except Exception as exc:  # noqa: BLE001 — job-scoped failure
                self._recover_job(slot, exc)
            else:
                with self._lock:
                    self._counts["supersteps_served"] += 1
                telemetry.counter("engine.supersteps_served").add(1)

    def _round_slots(self) -> List[_Slot]:
        with self._lock:
            return list(self._active)

    def _pump_groups(self) -> None:
        """One packed dispatch round per fused group; drained groups
        retire (their members already left via the machines' drive
        finallys).  A pump error — after the group's own transient
        retries — is GROUP-scoped and recoverable:
        packing is an optimization, so the members DEMOTE to solo
        machines resuming from their own last fetched boundaries
        instead of failing; every other tenant keeps serving
        untouched."""
        with self._lock:
            groups = list(self._fused)
        pumped = []
        for group in groups:
            try:
                group.pump()
            except Exception as exc:  # noqa: BLE001 — group-scoped
                self._demote_group(group, exc)
            else:
                pumped.append(group)
        # Fill notes run AFTER every group pumped: the cross-scope
        # re-fuse harvest reads the SIBLING groups' fills,
        # and a trigger firing mid-round would see a cohabitant's stale
        # pre-departure fill and skip a thin group it should merge.
        for group in pumped:
            self._note_fill(group)
        for group in groups:
            if group.done:
                with self._lock:
                    if group in self._fused:
                        self._fused.remove(group)

    def _note_fill(self, group: "FusedGroup") -> None:
        """Post-pump fill instrumentation + the dynamic re-fuse trigger.
        The gauges record on EVERY pump — not just at fuse time — so the
        fill report sees post-departure masked-lane decay; ``packed_fill_min`` carries the
        engine-tracked running minimum (``Gauge.set`` overwrites, so
        ``agg="min"`` only merges across engines).  The trigger: a
        group that lost tenants to DEPARTURE (cancel/pause — a member
        draining its range naturally is not churn, and retracing every
        group's tail would be a spurious rebuild) whose last dispatch
        fill dropped below the threshold re-fuses its survivors into a
        tighter group (one
        retrace; checkpoint cursors are in rank-stride units and carry
        over unchanged); a lone survivor rebuilds solo through the
        same path."""
        fill = group.last_fill
        if fill is None:
            return
        with self._lock:
            self._fill_last = fill
            if self._fill_min is None or fill < self._fill_min:
                self._fill_min = fill
            fill_min = self._fill_min
        telemetry.gauge("engine.packed_fill_last").set(fill)
        telemetry.gauge("engine.packed_fill_min",
                        agg="min").set(fill_min)
        thr = self._refuse_threshold()
        if (
            thr is not None
            and fill < thr
            and group.departures > 0
            and group.active_members > 0
            and group._work_remains()
        ):
            self._start_refuse(group, fill)

    def _start_refuse(self, group: "FusedGroup", fill: float) -> None:
        """Detach a thinned group's survivors at their last consumed
        boundaries (serve thread; each machine's close runs the packed
        drive's park finallys) and hand them to the admission worker
        to re-fuse into a tighter group.  Survivors sit in
        ``_refusing`` (not ``_active``) while the build runs — they
        keep their group/resident counts, so reactivation moves no
        counters.  Members with a pending pause/cancel stay behind:
        the round honors their request against the OLD group as
        usual.

        Cross-group scope: when the resolved scope is
        "cross", the batch also harvests survivors from OTHER thin
        post-churn groups (each gated by its own departure/fill
        trigger, so a healthy or naturally-tailing cohabitant group is
        never retraced).  Safety comes for free downstream:
        ``_prepare_fuse`` buckets the combined batch by its
        ``pack_candidate`` static key, so only provably-compatible
        survivors merge and the rest rebuild within their own
        buckets."""
        sources = [group]
        thr = self._refuse_threshold()
        if self._refuse_scope() == "cross" and thr is not None:
            with self._lock:
                others = [g for g in self._fused if g is not group]
            sources += [
                g for g in others
                if g.departures > 0
                and g.active_members > 0
                and g.last_fill is not None
                and g.last_fill < thr
                and g._work_remains()
            ]
        members = [
            slot for slot in self._round_slots()
            if getattr(slot.sweep, "_packed_source", None) in sources
            and not slot.job._cancel_req.is_set()
            and not slot.job._pause_req.is_set()
        ]
        if not members:
            return
        telemetry.counter("engine.refuse_total").add(1)
        if len(sources) > 1:
            telemetry.counter("engine.refuse_cross").add(1)
        entries = []
        for slot in members:
            sweep = slot.sweep
            # ttfc is a fact about the job's FIRST machine — capture
            # it before the rebuild resets the sweep's instrument (the
            # _rebuild_machine discipline).
            if slot.job.ttfc_s is None and sweep._ttfc is not None:
                slot.job.ttfc_s = sweep._ttfc - sweep._run_t0
            slot.machine.close()
            src = getattr(sweep, "_packed_source", None)
            if src is not None:
                src.leave(sweep)
                sweep._packed_source = None
            entries.append((slot, self._checkpoint_of(slot)))
        with self._lock:
            for slot, _state in entries:
                if slot in self._active:
                    self._active.remove(slot)
                self._refusing.append(slot)
        for slot, _state in entries:
            slot.job._push_ctl("refused", jobs=len(entries), fill=fill)
        self._queue_refuse(entries)

    def _demote_group(
        self, group: "FusedGroup", exc: BaseException
    ) -> None:
        """The degradation ladder's packed rung: a fused
        group whose pump failed parks every member's segment and
        rebuilds each member as a SOLO machine from its own last
        consumed boundary — streams stay byte-exact (the checkpoint
        discipline replays exactly the unconsumed blocks), the group
        retires, and the jobs keep running on the per-job dispatch
        path."""
        import sys

        telemetry.counter("engine.group_demotions").add(1)
        members = [
            slot for slot in self._round_slots()
            if getattr(slot.sweep, "_packed_source", None) is group
        ]
        print(
            f"a5gen: engine: packed dispatch failed "
            f"({type(exc).__name__}: {exc}); demoting {len(members)} "
            "tenant(s) to solo dispatch",
            file=sys.stderr,
        )
        for slot in members:
            # A failed rebuild must stay JOB-scoped: quarantine that
            # member (checkpoint attached) and keep demoting the rest —
            # the serve thread never dies here.
            try:
                self._rebuild_machine(slot)
            except Exception as rebuild_exc:  # noqa: BLE001
                self._quarantine(slot, rebuild_exc)

    def _rebuild_machine(self, slot: _Slot) -> None:
        """Fresh machine on the same sweep from its last consumed
        boundary — the shared mechanics of demotion and transient
        restart.  Closing the old machine runs the
        drive's cleanup finallys (a packed segment parks); the rebuilt
        machine resumes from a deep copy of the live state, solo.
        Replayed checkpointed hits are muted on the job's async queue
        (the tenant already received them on this handle) while still
        rebuilding the recorder's ordered result list."""
        slot.machine.close()
        sweep = slot.sweep
        # The rebuilt machine resets the sweep's ttfc instrument; the
        # JOB's time-to-first-fetch is a fact about its first machine —
        # capture it now so the done event doesn't report a bogus
        # post-restart value (surface must stay honest
        # across the recovery ladder).
        if slot.job.ttfc_s is None and sweep._ttfc is not None:
            slot.job.ttfc_s = sweep._ttfc - sweep._run_t0
        src = getattr(sweep, "_packed_source", None)
        if src is not None:
            src.leave(sweep)
            sweep._packed_source = None
        self._machine_from_state(slot, self._checkpoint_of(slot))

    def _machine_from_state(self, slot: _Slot,
                            state: "Optional[CheckpointState]") -> None:
        """Fresh machine on the slot's sweep from ``state`` — the
        shared tail of demotion, transient restart, and re-fuse
        rebuilds.  Replayed checkpointed hits are muted on the job's
        async queue (the tenant already received them on this handle)
        while still rebuilding the recorder's ordered result list."""
        sweep = slot.sweep
        if state is None:
            state = self._checkpoint_of(slot)
        if slot.job.kind == "crack":
            recorder = _JobRecorder(slot.job, mute=len(state.hits))
            slot.machine = sweep.crack_machine(
                recorder, resume=False, state=state
            )
        else:
            slot.machine = sweep.candidates_machine(
                slot.job._submit_args["writer"], resume=False,
                state=state
            )

    def _recover_job(self, slot: _Slot, exc: BaseException) -> None:
        """The engine half of the degradation ladder: a
        machine that raised past the sweep's own retry supervision is
        RESTARTED from its last consumed boundary (transient errors
        only, ``Engine(job_retries=)`` times); past that the job is
        QUARANTINED — settled ``failed`` with its last checkpoint
        attached to the handle (and the serve front-end's ``failed``
        event), so a client can resubmit it to another engine instead
        of losing the sweep's progress."""
        if faults_mod.is_transient(exc) and slot.restarts < \
                self._job_retries:
            slot.restarts += 1
            telemetry.counter("engine.job_restarts").add(1)
            try:
                self._rebuild_machine(slot)
                return
            except Exception as rebuild_exc:  # noqa: BLE001
                exc = rebuild_exc  # fall through to quarantine
        self._quarantine(slot, exc)

    def _quarantine(self, slot: _Slot, exc: BaseException) -> None:
        self._drop(slot)
        slot.job.error = exc
        slot.job.checkpoint = self._checkpoint_of(slot)
        slot.job.span_summary = slot.sweep.timeline.summary()
        self._settle_counts(slot.job, "failed")

    def _drop(self, slot: _Slot) -> None:
        # A packed member must park its segment even when its machine
        # never started (close() on an unstarted generator skips the
        # drive's own leave-in-finally); leave is idempotent.
        src = getattr(slot.sweep, "_packed_source", None)
        if src is not None:
            src.leave(slot.sweep)
        with self._lock:
            if slot in self._active:
                self._active.remove(slot)
            self._groups[slot.group] -= 1
            if not self._groups[slot.group]:
                del self._groups[slot.group]
            if slot.token and slot.token in self._resident:
                self._resident[slot.token] -= 1
                if not self._resident[slot.token]:
                    del self._resident[slot.token]

    def _settle_counts(self, job: EngineJob, state: str) -> None:
        with self._lock:
            self._counts[f"jobs_{state}"] += 1
        telemetry.counter(f"engine.jobs_{state}").add(1)
        job._settle(state)

    def _checkpoint_of(self, slot: _Slot) -> CheckpointState:
        """A stable copy of the machine's live CheckpointState (the
        machine keeps mutating its own on resume elsewhere).  A job
        parked before its machine ever ticked has no active state yet —
        its checkpoint IS the start of the sweep (resume replays from
        the origin cursor), never None: the pause/migrate contract
        always hands back a resumable state."""
        state = slot.sweep.active_state
        if state is None:
            state = CheckpointState(fingerprint=slot.sweep.fingerprint)
        state = copy.deepcopy(state)
        if not state.fingerprint:
            # A machine without a checkpoint file starts from an unsigned
            # state; the handoff carries the sweep's fingerprint.
            state.fingerprint = slot.sweep.fingerprint
        return state

    def _note_departure(self, slot: _Slot) -> None:
        # A tenant ACTION removed this member from its fused group —
        # the churn signal the re-fuse trigger requires (a member
        # finishing naturally never counts).
        src = getattr(slot.sweep, "_packed_source", None)
        if src is not None:
            src.departures += 1

    def _park(self, slot: _Slot) -> None:
        self._note_departure(slot)
        slot.machine.close()  # runs the sweep's cleanup finallys
        self._drop(slot)
        slot.job.checkpoint = self._checkpoint_of(slot)
        slot.job.span_summary = slot.sweep.timeline.summary()
        self._settle_counts(slot.job, "paused")

    def _retire(self, slot: _Slot, state: str) -> None:
        self._note_departure(slot)
        slot.machine.close()
        self._drop(slot)
        self._settle_counts(slot.job, state)

    def _finish(self, slot: _Slot, result: "SweepResult") -> None:
        self._drop(slot)
        job = slot.job
        job.result_value = result
        job.checkpoint = self._checkpoint_of(slot)
        # A restarted/demoted job's ttfc was captured at rebuild time
        # (the first machine's is the honest one); only fill it here
        # when no recovery pre-seeded it.
        if job.ttfc_s is None:
            ttfc = slot.sweep._ttfc
            job.ttfc_s = (
                ttfc - slot.sweep._run_t0 if ttfc is not None else None
            )
        job.span_summary = slot.sweep.timeline.summary()
        self._settle_counts(job, "done")


def _make_current(device) -> None:
    """Make a CUDA config's card the calling thread's current device (a
    no-op for the CPU)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dev if dev.index is not None else 0)


# ---------------------------------------------------------------------------
# JSONL service front-end (``a5gen serve``)
# ---------------------------------------------------------------------------
#
# One request per line on stdin (or a unix-socket connection), one event
# per line out.  Ops:
#
#   {"op": "submit", "id": "j1", <job fields>}     -> accepted, hit*, done
#   {"op": "pause",  "id": "j1"}                   -> paused {checkpoint}
#   {"op": "resume", "id": "j1"}                   -> accepted (same id)
#   {"op": "cancel", "id": "j1"}                   -> cancelled
#   {"op": "stats"}                                -> stats
#   {"op": "metrics"}                              -> metrics (registry
#                                   JSON snapshot + Prometheus text)
#   {"op": "shutdown"}  (or EOF)                   -> bye
#
# Job fields: "tables": [paths] or "table_map": {key: [subs...]} inline;
# "dict": wordlist path or "words": [inline strings]; "digests": left-list
# path or "digest_list": [hex strings] (crack mode — omit both for a
# candidates job, which then needs "output": path); "algo", "mode"
# ("default"/"reverse"/"suball"/"suball-reverse"), "table_min"/"table_max";
# "config": SweepConfig subset {lanes, blocks, superstep, devices,
# fetch_chunk, stream_chunk_words, schema_cache, schema_cache_max_mb,
# pod: [index, count] — one rank-stride stripe of a split giant job};
# "checkpoint": a previously returned pause checkpoint (migrate-in);
# "replay_mute": N — withhold the leading N hit emissions from event
# delivery (the fleet router's exactly-once redelivery discipline; the
# job's done counts still report the full stream).


#: SweepConfig fields a JSONL job may override ("blocks" aliases
#: num_blocks to match the CLI flag).
_JOB_CONFIG_FIELDS = {
    "lanes": "lanes", "blocks": "num_blocks", "superstep": "superstep",
    "pair": "pair",
    "devices": "devices", "fetch_chunk": "fetch_chunk",
    "stream_chunk_words": "stream_chunk_words",
    "schema_cache": "schema_cache",
    "schema_cache_max_mb": "schema_cache_max_mb",
    # Robustness knobs: an on-disk checkpoint makes a
    # served job survive ENGINE death — restart the engine, read the
    # checkpoint file, resubmit with "checkpoint": <its doc> (the crash
    # soak test's whole loop); the retry knobs tune the drive's
    # transient-error supervision per job.
    "checkpoint_path": "checkpoint_path",
    "checkpoint_every_s": "checkpoint_every_s",
    "retry_attempts": "retry_attempts",
    "retry_backoff_s": "retry_backoff_s",
    "fetch_timeout_s": "fetch_timeout_s",
    # Pod giant-job striping over the wire: the fleet
    # router's split scatter drives the SweepConfig.pod cursor
    # arithmetic per shard — "pod": [index, count] scans only that
    # rank-stride stripe of the superstep block lattice, and the
    # shards' hit-stream union is exactly the solo stream.
    "pod": "pod",
}


def _job_from_doc(
    doc: dict, defaults: "SweepConfig", max_word_bytes: int
) -> dict:
    """Parse one submit document into ``Engine.submit`` arguments."""
    from ..models.attack import AttackSpec
    from ..tables.parser import load_tables

    if "table_map" in doc:
        sub_map = {
            k.encode("utf-8"): [v.encode("utf-8") for v in vals]
            for k, vals in doc["table_map"].items()
        }
    elif doc.get("tables"):
        sub_map = load_tables(doc["tables"])
    else:
        raise ValueError("job needs 'tables' (paths) or 'table_map'")
    if "words" in doc:
        words = [w.encode("utf-8") for w in doc["words"]]
    elif doc.get("dict"):
        from ..ops.packing import read_wordlist

        words = read_wordlist(doc["dict"], max_word_bytes=max_word_bytes)
    else:
        raise ValueError("job needs 'dict' (path) or 'words'")
    algo = doc.get("algo", "md5")
    crack = "digests" in doc or "digest_list" in doc
    if "digest_list" in doc:
        digests = [bytes.fromhex(h) for h in doc["digest_list"]]
    elif doc.get("digests"):
        # The CLI's left-list parser (vectorized, hashcat-style lines);
        # a layering exception the front-end owns, not the Engine.
        from ..cli import _read_digests

        digests = _read_digests(doc["digests"], algo)
    else:
        digests = ()
    mode = doc.get("mode", "default")
    if mode not in ("default", "reverse", "suball", "suball-reverse"):
        raise ValueError(f"unknown mode {mode!r}")
    spec = AttackSpec(
        mode=mode, algo=algo,
        min_substitute=int(doc.get("table_min", 0)),
        max_substitute=int(doc.get("table_max", 15)),
    )
    cfg = defaults
    overrides = doc.get("config") or {}
    unknown = set(overrides) - set(_JOB_CONFIG_FIELDS)
    if unknown:
        raise ValueError(f"unknown config field(s): {sorted(unknown)}")
    if overrides.get("pod") is not None:
        # JSON has no tuples; SweepConfig.pod wants (index, count).
        overrides = dict(overrides, pod=tuple(
            int(x) for x in overrides["pod"]
        ))
    if overrides:
        cfg = replace(cfg, **{
            _JOB_CONFIG_FIELDS[k]: v for k, v in overrides.items()
        })
    resume_state = (
        state_from_doc(doc["checkpoint"]) if doc.get("checkpoint") else None
    )
    # The fleet router's exactly-once redelivery knob:
    # the first N hit emissions skip the async queue — the client
    # already received exactly those through the router before a
    # migrate/crash-replay resubmission.
    mute = int(doc.get("replay_mute", 0))
    if mute < 0:
        raise ValueError(f"replay_mute must be >= 0, got {mute}")
    kind = "crack" if crack else "candidates"
    writer = None
    if kind == "candidates":
        if not doc.get("output"):
            raise ValueError(
                "candidates jobs (no digests) need 'output': a path the "
                "candidate stream is written to"
            )
        # A migrated-in job resumes FROM its checkpoint cursor — the
        # candidates before it were already written; truncating the
        # output would silently drop them, so resume appends.
        mode = "ab" if resume_state is not None else "wb"
        writer = CandidateWriter(open(doc["output"], mode))
    return dict(spec=spec, sub_map=sub_map, words=words, digests=digests,
                config=cfg, kind=kind, writer=writer,
                resume_state=resume_state, mute=mute)


class _JsonlSession:
    """One JSONL command stream against a shared :class:`Engine`.

    ``jobs``: the job registry — per-session by default (stdin mode);
    the socket server passes ONE dict shared by every connection, so a
    client dropped by the idle watchdog (or a crash) can reconnect and
    pause/cancel/resume its still-running jobs by id.
    Ops on an ADOPTED job (registered by another session) emit their
    settling event on THIS session — the original session's pump is
    gone with its socket."""

    def __init__(self, engine: Engine, fin: "IO[str]",
                 fout: "IO[str]", *,
                 max_word_bytes: int = 64 * 1024,
                 jobs: "Optional[Dict[str, EngineJob]]" = None) -> None:
        self._engine = engine
        self._fin = fin
        self._fout = fout
        self._out_lock = threading.Lock()
        self._max_word_bytes = max_word_bytes
        self._jobs: Dict[str, EngineJob] = (
            jobs if jobs is not None else {}
        )
        #: job ids THIS session started a pump thread for (their events
        #: flow there; adopted jobs' op results are emitted inline).
        self._pumped: set = set()
        #: activity stamps (bare clock reads) the socket
        #: server's idle watchdog polls: a session is stale only when
        #: BOTH directions are — a client quietly waiting for hit/done
        #: events is not idle.
        self._last_read = time.monotonic()
        self._last_write = time.monotonic()

    def stale(self, timeout: float) -> bool:
        """No inbound line AND no outbound event for ``timeout``
        seconds — the idle watchdog's half-open test."""
        return (
            time.monotonic() - max(self._last_read, self._last_write)
            >= float(timeout)
        )

    def _emit(self, obj: dict) -> None:
        with self._out_lock:
            self._fout.write(json.dumps(obj) + "\n")
            self._fout.flush()
            # A completed write proves the peer is draining — the
            # watchdog must not drop a client that is merely waiting.
            self._last_write = time.monotonic()

    def _emit_settled(self, job: EngineJob) -> None:
        """The settling event for ``job``'s current terminal state."""
        if job.state == "done":
            res = job.result_value
            self._emit(protocol.ev_done(
                job.id,
                n_hits=res.n_hits, n_emitted=res.n_emitted,
                wall_s=res.wall_s, resumed=res.resumed,
                ttfc_s=job.ttfc_s,
                schema_cache=res.schema_cache,
                spans=job.span_summary,
            ))
        elif job.state == "paused":
            self._emit(protocol.ev_paused(
                job.id, state_to_doc(job.checkpoint),
                spans=job.span_summary,
            ))
        elif job.state == "cancelled":
            self._emit(protocol.ev_cancelled(job.id))
        else:
            # Quarantine: a failed job's last checkpoint
            # rides the event so the client can resubmit it to another
            # engine ("checkpoint" on a fresh submit) instead of losing
            # the sweep's progress.
            self._emit(protocol.ev_failed(
                job.id,
                f"{type(job.error).__name__}: {job.error}",
                checkpoint=(
                    state_to_doc(job.checkpoint)
                    if job.checkpoint is not None else None
                ),
            ))

    def _pump_job(self, job: EngineJob) -> None:
        """Per-job event pump (own thread): stream hits as they land,
        then the settling event.  A dead client (socket gone) must not
        wedge the ENGINE: the bounded hit queue backpressures the serve
        thread by contract, so once a write fails the pump keeps
        DRAINING the queue, discarding — the job runs on, adoptable by
        a reconnecting session."""
        client_gone = False
        try:
            for rec in job._iter_records():
                if isinstance(rec, _CtlEvent):
                    # Engine-side control notifications forwarded in
                    # stream order; the typed constructor at the emit
                    # site keeps the protocol registry authoritative.
                    if rec.kind == "refused":
                        self._emit(protocol.ev_refused(
                            job.id, **rec.fields
                        ))
                    continue
                self._emit(protocol.ev_hit(
                    job.id,
                    digest=rec.digest_hex,
                    plain_hex=rec.candidate.hex(),
                    word_index=rec.word_index,
                    rank=str(rec.variant_rank),
                ))
        except (OSError, ValueError):
            client_gone = True
            for _rec in job.iter_hits():
                pass
        # Terminal states release the candidates writer (flush + close);
        # a PAUSED job keeps it open — resume continues the stream.
        if job.state != "paused":
            writer = job._submit_args.get("writer")
            if writer is not None:
                writer.close()
        if not client_gone:
            try:
                self._emit_settled(job)
            except (OSError, ValueError):
                pass  # client vanished between the last hit and here

    def _handle(self, doc: dict) -> bool:
        """Dispatch one op; returns False on shutdown."""
        # The client-facing seam: an injected error here
        # is protocol-scoped — the session reports an ``error`` event
        # and keeps serving; the engine (and every other session) never
        # notices.
        if faults_mod.ACTIVE is not None:
            faults_mod.ACTIVE.fire("serve.client")
        op = protocol.doc_op(doc)
        jid = doc.get("id")
        if op == "shutdown":
            self._emit(protocol.ev_bye())
            return False
        if op == "stats":
            self._emit(protocol.ev_stats(self._engine.stats()))
            return True
        if op == "metrics":
            # The observability surface of a running engine: the
            # process-wide registry as a JSON snapshot plus
            # its Prometheus text exposition — a scrape adapter needs
            # only this op.
            snap = telemetry.snapshot()
            self._emit(protocol.ev_metrics(
                snap, telemetry.to_prometheus(snap)
            ))
            return True
        if op == "submit":
            kw = _job_from_doc(doc, self._engine.defaults,
                               self._max_word_bytes)
            try:
                job = self._engine.submit(job_id=jid, **kw)
            except BaseException:
                # No job (and no pump) exists to own the candidates
                # writer _job_from_doc opened — release it here.
                if kw.get("writer") is not None:
                    kw["writer"].close()
                raise
            self._jobs[job.id] = job
            self._pumped.add(job.id)
            self._emit(protocol.ev_accepted(job.id, job.kind))
            threading.Thread(
                target=self._pump_job, args=(job,),
                name=f"a5-serve-pump-{job.id}", daemon=True,
            ).start()
            return True
        job = self._jobs.get(jid)
        if job is None:
            raise ValueError(f"unknown job id {jid!r}")
        # An op on a job another (dropped) session submitted: that
        # session's pump died with its socket, so the settling event
        # must flow HERE.
        adopted = jid not in self._pumped
        if op == "pause":
            job.pause()  # blocks until parked (or raced done)
            if adopted:
                self._emit_settled(job)
        elif op == "resume":
            new = self._engine.resume(job)
            self._jobs[new.id] = new
            self._pumped.add(new.id)
            self._emit(protocol.ev_accepted(
                new.id, new.kind, resumed=True
            ))
            threading.Thread(
                target=self._pump_job, args=(new,),
                name=f"a5-serve-pump-{new.id}", daemon=True,
            ).start()
        elif op == "cancel":
            job.cancel()
            if adopted:
                job.wait()  # settles at the next boundary
                self._emit_settled(job)
        else:
            raise ValueError(f"unknown op {op!r}")
        return True

    def run(self) -> bool:
        """Process the stream; True when an explicit ``shutdown`` op
        ended it (a plain EOF — a disconnecting client — returns False,
        so a socket server keeps serving the other sessions).  A closed
        or torn connection — including the socket server's idle
        watchdog shutting down a stale one — likewise
        ends only THIS session: the client's jobs keep running, and in
        socket mode the shared job registry lets a reconnecting
        session pause/cancel/resume them by id."""
        while True:
            try:
                line = self._fin.readline()
            except (OSError, ValueError):
                # Watchdog-closed or torn connection mid-read.
                return False
            if not line:
                return False  # EOF: client disconnected
            self._last_read = time.monotonic()
            line = line.strip()
            if not line:
                continue
            doc = None
            try:
                doc = json.loads(line)
                keep_going = self._handle(doc)
            except Exception as exc:  # noqa: BLE001 — protocol-scoped
                # Carry the failing op's job id when it named one: a
                # routing layer demuxes events by id, so
                # an id-less error cannot be correlated to the op that
                # caused it.
                self._emit(protocol.ev_error(
                    f"{type(exc).__name__}: {exc}",
                    jid=doc.get("id") if isinstance(doc, dict)
                    else None,
                ))
                continue
            if not keep_going:
                return True


def serve_stdio(engine: Engine, fin: "IO[str]", fout: "IO[str]", *,
                max_word_bytes: int = 64 * 1024) -> None:
    """Serve one JSONL command stream (``a5gen serve`` over stdin)."""
    _JsonlSession(engine, fin, fout,
                  max_word_bytes=max_word_bytes).run()


def serve_socket(engine: Engine, path: str, *,
                 max_word_bytes: int = 64 * 1024,
                 client_timeout: Optional[float] = None,
                 ready: Optional[Callable[[], None]] = None) -> None:
    """Serve JSONL sessions over a unix socket at ``path`` (one session
    per connection, all sharing ``engine``); returns when a session
    sends an explicit ``shutdown`` op — a client that merely
    disconnects (EOF, a health probe) ends only its own session.

    ``client_timeout`` (``serve --client-timeout``, default off): a
    connection with no inbound line AND no outbound event for that
    many seconds is shut down by a per-connection watchdog thread — a
    half-open client cannot pin a server thread forever, while a
    client quietly waiting for results (events still flowing out) is
    never dropped, and no socket timeout ever lands mid-read or
    mid-write.  The dropped client's jobs keep running,
    and the job registry is shared across this server's sessions, so a
    reconnecting client pauses/cancels/resumes them by id via the
    existing ops."""
    import os
    import socket

    #: one registry for every connection — reconnection = adoption.
    shared_jobs: Dict[str, EngineJob] = {}

    def _watchdog(conn: "_socket.socket", session: "_JsonlSession",
                  done: threading.Event) -> None:
        interval = max(0.05, float(client_timeout) / 4.0)
        while not done.wait(interval):
            if session.stale(client_timeout):
                # Shutting the socket down unblocks the session's
                # readline (EOF/OSError) and fails any pump write —
                # the session winds down through its ordinary paths.
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return

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

            def _session(conn: "_socket.socket" = conn) -> None:
                with conn:
                    fin = conn.makefile("r", encoding="utf-8")
                    fout = conn.makefile("w", encoding="utf-8")
                    session = _JsonlSession(
                        engine, fin, fout,
                        max_word_bytes=max_word_bytes,
                        jobs=shared_jobs,
                    )
                    done = threading.Event()
                    if client_timeout:
                        threading.Thread(
                            target=_watchdog,
                            args=(conn, session, done),
                            name="a5-serve-watchdog", daemon=True,
                        ).start()
                    try:
                        shutdown = session.run()
                    finally:
                        done.set()
                if shutdown:
                    stop.set()

            threading.Thread(
                target=_session, name="a5-serve-conn", daemon=True
            ).start()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
