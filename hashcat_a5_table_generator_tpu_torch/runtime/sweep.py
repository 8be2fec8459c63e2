"""The crack and candidates sweeps: one wordlist × one merged table × one
attack spec, driven through the device superstep loop (crack mode) or a
launch loop that streams candidates (candidates mode).

Each sweep's plan takes one route, by the reference's own gate
(``ops.fused_expand.opts_for``, under ``A5GEN_PALLAS``): a fused kernel —
the per-slot piece kernel when ``packing.piece_schema_for`` gives a
schema, else the byte-scan tier of ``ops.bytescan.bytescan_tier`` (TPU
kernel rows 7-9) — or, for a plan the gate refuses (more than 24 slots,
tokens over 64 bytes, more than 8 options per key, values over 4 bytes,
more than 3 hash blocks, windows outside 2..10 DP columns), the XLA expand
+ hash route: the torch expansion of ``models.attack._expand`` and the
buffer hash of ``ops.buffer_hash`` (TPU kernel row 10).  That route sizes
its own launches from :data:`XLA_BUDGET_BYTES`, since its ``[N, L]`` and
``[N, W]`` intermediates grow with the bucket's width.
``SweepResult.kernels`` names the tier with its launch count,
``SweepResult.routes`` the route.  Candidates mode runs the XLA expansion
on every plan, as the reference's does.

The unit of work is a *variant block* — a contiguous rank range of one
word's mixed-radix space — so the whole sweep is one linear cursor over a
fixed-stride block index.  :meth:`Sweep.run_crack` ships the plan's tables
to the device once, then dispatches supersteps of ``steps`` fused launches
(``models.attack.make_superstep_body``) into two alternating hit-buffer
sets: superstep N+1 is queued before superstep N's counters are read, and
each superstep's counters come back through a non-blocking copy into
pinned memory, waited on through a CUDA event at that lagged boundary —
the only host sync per superstep.  A superstep whose hits overflow the
capped buffer is re-run with a buffer sized from its hit count, so no hit
is ever dropped.  Hits are re-derived on the host from their ``(word,
rank)`` cursor and their digest re-verified before they are recorded.
``A5GEN_PIPELINE=off`` waits for each superstep's fetch before the next
dispatch (the barriered drive).

A plan whose block index is not int32-safe — a word of 2^30 rows or more
(``ops.blocks.superstep_index`` is None), which the reference never
refuses — and every plan under ``--superstep off`` / ``A5GEN_SUPERSTEP=off``
take the per-launch pipeline instead, as in the reference: the host cuts
each launch's blocks with Python-int cursors (``ops.blocks.make_blocks``),
one step runs expand + hash + membership on them
(``models.attack.make_crack_step``, K=1), and the next launch is
dispatched before the previous one's counters are read; hit lanes map
back to ``(word, rank)`` through ``ops.blocks.lane_cursor``, ranks as
Python ints.  Candidates mode cuts on the host the same way.

Both modes checkpoint and resume as the reference does
(``runtime/checkpoint.py``: the same documents, so a checkpoint written by
either package resumes in the other).  The state is one ``(word, rank)``
cursor at the last *consumed* fetch — a superstep's lagged boundary, a
per-launch drain, a candidates launch — never a dispatched one, with the
hits, counts and fallback words up to it; ``SweepConfig.checkpoint_path``
names the file, written at most every ``checkpoint_every_s`` and once at
the end.  A resumed drive starts at the cursor: the superstep drive at
block ``cum[w] + rank // stride`` (a pair-misaligned but K=1-aligned
cursor runs the K=1 superstep tier, any other misalignment the per-launch
pipeline), the per-launch pipeline and candidates mode at the cursor
itself.  A transient device error at dispatch or fetch (``runtime/faults``:
injected faults and the ``fetch_timeout_s`` watchdog) drops the
in-flight work and re-dispatches from the last consumed boundary, at most
:data:`RETRY_ATTEMPTS` times in a row.  Every consumed fetch is a span of
:attr:`Sweep.timeline` (``runtime/telemetry``).

A geometry whose block count does not divide its lane count (or
``SweepConfig.packed_blocks``) runs the reference's variable-offset block
layout: blocks packed back to back, each lane finding its block by a
binary search over their offsets (``ops.expand_matches.lane_fields``).
The reference runs that layout on its XLA expand + hash route and the
per-launch pipeline only, and so does this package: the fused kernels
and the superstep drive take the fixed-stride layout.

A dictionary larger than one chunk (``SweepConfig.stream_chunk_words``:
``auto`` = ``ops.packing.auto_chunk_words`` of its width, 65,536 words at
width 16; ``A5GEN_STREAM=off`` or ``off`` compiles it whole) streams, as
the reference's does: one cheap prescan over the whole dictionary fixes
the decisions every chunk must share (``out_width``, the windowed
scheme, the oracle routing), then one worker thread
(``ops.packing.ChunkCompiler``) compiles chunk N+1 — its plan, piece
schema, route, launch decisions and device arrays, uploaded on a side
CUDA stream — while the device sweeps chunk N; each consumed chunk is
released.  The cursor, the hits and the checkpoints stay global, so the
streams and the checkpoints do not depend on the chunking, and a
checkpoint of either path resumes in the other.

A sweep runs on one or several cursor stripes (``SweepConfig.devices``,
``parallel.devices``): stripe ``d`` sweeps blocks ``b0 + d * NB`` of
every launch on its own device (or a device it shares) with the region's
arrays replicated there; the superstep drive dispatches every stripe on
its own CUDA stream and buffer sets and, at the consumed fetch, sums the
stripes' counters and merges their hits in ``(word, rank)`` order; the
per-launch pipeline cuts one launch a stripe per round on the host;
candidates mode concatenates the stripes' rows in stripe order.  A giant
job's shard (``SweepConfig.pod``) owns its stripes of a pod-wide lattice
(``parallel.multihost.run_crack_giant``).  The cursor and the streams are
one device's either way.  Piece schemas come from the on-disk cache
(``SweepConfig.schema_cache``, ``ops.packing.piece_schema_for``) when it
holds them.

Substitute-all plans route each word three ways, as the reference does:
device-clean words and cascade-closed words run on the device; words no
plan splices exactly (``plan.fallback``) take no blocks and are expanded on
the host by the oracle — the native C++ engine (``native.oracle_engine``)
where ``default_engine_eligible`` admits the table, else the Python
generators of ``oracle.engines``; the same candidates in the same order —
hashed with ``HOST_DIGEST`` and looked up in the digest list.  Their hits
carry the oracle's DFS index as rank and interleave in word order: a
fallback word is flushed before the first device hit of a later word, and
at each superstep boundary before the boundary's word.  A producer thread
(:class:`_FallbackPrefetcher`) expands them ahead, in row order, into a
bounded queue while the device runs; a row counts as flushed
(``fallback_done``) only once consumed.  Candidates mode interleaves
them the same way, at their word position in the stream.

Each sweep is also a resumable state machine, as in the reference
(:meth:`Sweep.crack_machine`, :meth:`Sweep.candidates_machine`): a
generator that yields once at every consumed fetch boundary — a
superstep, a per-launch chunk drain, a candidates launch — with its
:class:`CheckpointState` (``Sweep.active_state``) consistent there.
:meth:`Sweep.run_crack` and :meth:`Sweep.run_candidates` exhaust it
(:func:`_exhaust`); the resident engine (``runtime/engine.py``) ticks
many machines in turn, and closing one mid-sweep stops its chunk-compile
worker and fallback producer and leaves its state at the last consumed
boundary.  A sweep the engine fused into a packed group
(``runtime/fuse.py``) has its superstep drive replaced by
:meth:`Sweep._drive_packed`, which consumes the group's per-job results
through the same bookkeeping.
"""

from __future__ import annotations

import copy
import itertools
import sys
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field, replace
from typing import (Any, Callable, Dict, Generator, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from ..models.attack import (
    AttackSpec,
    _i32,
    build_plan,
    decode_variant,
    device_arrays,
    host_blocks,
    make_candidates_body,
    make_candidates_step,
    make_crack_step,
    make_superstep_body,
    superstep_buffers,
    xla_arrays,
)
from ..ops.blocks import (
    block_cursor,
    lane_cursor,
    make_blocks,
    superstep_index,
    word_ranges,
)
from ..ops.bytescan import bytescan_tier
from ..ops.fused_expand import (
    decode_for,
    k_opts_for,
    k_vals_for,
    launch_key,
    opts_for,
    pair_for,
    scalar_units_weight,
    schema_refusal,
)
from ..ops.expand_matches import (
    variant_totals,
    windowed_chunk_terms,
    windowed_gate,
)
from ..ops.membership import HostDigestLookup, build_digest_set
from ..ops.packing import (
    ChunkCompiler,
    PackedWords,
    PlanChunk,
    auto_chunk_words,
    chunk_bounds,
    pack_words,
    piece_schema_for,
    schema_cache_stats,
    slice_packed,
)
from ..oracle.engines import iter_candidates
from ..parallel.devices import Stripes, resolve_devices, resolve_stripes
from ..tables.compile import compile_table
from ..utils.digests import HOST_DIGEST
from . import faults, telemetry
from .checkpoint import (
    CheckpointState,
    SweepCursor,
    load_checkpoint,
    save_checkpoint,
    sweep_fingerprint,
)
from .env import (
    pipeline_enabled,
    schema_cache_dir,
    schema_cache_max_mb,
    stream_enabled,
    superstep_enabled,
)
from .progress import ProgressReporter
from .sinks import CandidateWriter, HitRecord, HitRecorder
from .tune import builtin_geometry, current_device_kind, resolve_config

#: The most consecutive recoveries from a transient device error inside one
#: drive (the count resets at every consumed fetch), and the base of the
#: exponential backoff between them (base * 2^attempt seconds).
RETRY_ATTEMPTS = 2
RETRY_BACKOFF_S = 0.05

#: Device memory the XLA route's per-launch intermediates may take, by
#: device type: the route cuts its lane count to fit (the kernel routes'
#: launches hold no per-candidate buffers and keep the configured lanes).
XLA_BUDGET_BYTES = {"cuda": 8 << 30, "cpu": 1 << 30}


#: The process's step closures (``make_superstep_body`` & co.), keyed by
#: every static input the closure depends on plus the kernel-selection
#: knobs read when it is built: repeat sweeps of one geometry (the
#: resident engine's warm jobs) reuse one closure.
_STEP_CACHE: Dict[tuple, Any] = {}
_STEP_CACHE_LOCK = threading.Lock()
_STEP_ENV_KNOBS = ("A5GEN_PALLAS", "A5GEN_EMIT", "A5GEN_PAIR",
                   "A5GEN_CASCADE_CLOSE")


def step_cache_stats() -> Dict[str, int]:
    """The process's step-cache counters, as the reference names them
    (``step_cache.hits`` / ``step_cache.misses``): a miss is a step
    closure built, or a kernel library loaded for the first time in the
    process (``ops._native_build.load``); a hit is a sweep riding an
    existing closure.  The engine's ``programs_compiled`` /
    ``program_cache_hits``."""
    return {k: int(telemetry.counter(f"step_cache.{k}").value)
            for k in ("hits", "misses")}


def _step_env_key() -> tuple:
    from .env import read_env

    return tuple(read_env(k) or "" for k in _STEP_ENV_KNOBS)


def _get_step(key: tuple, build: Callable[[], Any]):
    """The cached step closure for ``key`` (with the env knobs), built by
    ``build`` on a miss."""
    key = key + _step_env_key()
    with _STEP_CACHE_LOCK:
        step = _STEP_CACHE.get(key)
        if step is not None:
            telemetry.counter("step_cache.hits").add(1)
            return step
    step = build()
    with _STEP_CACHE_LOCK:
        if key in _STEP_CACHE:
            telemetry.counter("step_cache.hits").add(1)
            return _STEP_CACHE[key]
        _STEP_CACHE[key] = step
    telemetry.counter("step_cache.misses").add(1)
    return step


def _pieces_static(pieces) -> "Optional[tuple]":
    """The hashable static structure of a ``packing.PieceSchema`` (the
    reference's ``_pieces_static``): what a step closure bakes in; the
    data tables ride the arrays."""
    if pieces is None:
        return None
    return (
        pieces.kind, pieces.groups, pieces.closed, pieces.n_cols,
        pieces.max_out, pieces.gw is None, pieces.gw16 is None,
        pieces.gl is None, pieces.sel_bit is None,
        pieces.sel_slot is None, pieces.pair_ok, pieces.pair_g0,
        pieces.pair_dmin, pieces.pair_dmax,
    )


def _exhaust(machine: "Iterator") -> "SweepResult":
    """Run a sweep machine to its end and return its result — the solo
    drive ``run_crack`` / ``run_candidates`` wrap around the machine."""
    while True:
        try:
            next(machine)
        except StopIteration as done:
            return done.value


def xla_row_bytes(plan) -> int:
    """Estimated device bytes one candidate row of the XLA route holds at
    its peak: the schema-less splice's int32 ``[L]`` unit fields and
    ``[W]`` column fields (int64 gather indices among them), the per-slot
    decode and plan-field gathers, and the candidate buffer."""
    length_axis = int(plan.tokens.shape[1])
    segments = int(getattr(plan, "num_segments", 0) or 0)
    return (32 * length_axis + 48 * int(plan.out_width)
            + 40 * int(plan.num_slots) + 16 * segments + 256)


def xla_lanes(plan, lanes: int, stride: "int | None", cands_per_lane: int,
              budget: int) -> int:
    """The XLA route's lanes per launch: the configured ``lanes``, cut to
    a multiple of ``stride`` whose candidate rows fit ``budget`` bytes (at
    least one block; any count of at least one lane for the
    variable-offset layout, ``stride`` None).  Launch geometry never
    changes the stream."""
    fit = budget // (xla_row_bytes(plan) * cands_per_lane)
    if stride is None:
        return max(1, min(lanes, fit))
    return stride * max(1, min(lanes // stride, fit // stride))


def resolve_device(device) -> torch.device:
    """The sweep's device.  ``cuda`` (the default everywhere) requires a
    visible GPU: without one this raises instead of moving to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' (CLI: --device cpu) to run the plain "
            "PyTorch version on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@dataclass
class SweepConfig:
    """Launch geometry + runtime knobs (none of these affect WHAT is
    emitted — the checkpoint fingerprint excludes them, so a checkpoint
    taken at one geometry resumes at any other)."""

    device: str = "cuda"  # "cuda" or "cpu"; never chosen implicitly
    lanes: Optional[int] = None  # hash lanes per launch; None = the
    #   device's autotune profile, else 2^22 on cuda, 2^17 on cpu
    #   (runtime/tune.py; resolved once by the Sweep)
    num_blocks: Optional[int] = None  # blocks per launch; None = lanes/128,
    #   or 1024 when 128 does not divide the lanes (the reference's auto)
    superstep: Optional[int] = None  # launches per superstep; None =
    #   fetch_chunk; 0 selects the per-launch pipeline
    pair: "Optional[int | str]" = None  # pair-lane tier: None/'auto'
    #   engages when the schema allows; 0/'off' keeps K=1
    superstep_hit_cap: int = 4096  # device hit-buffer slots per superstep
    max_in_flight: int = 2  # supersteps in flight in the superstep
    #   drive while the pipeline is on (one buffer set each;
    #   ``Sweep._pipeline_depth``), and the most launches in flight in
    #   the per-launch pipeline
    pipeline: Optional[bool] = None  # None / True = the pipelined
    #   superstep drive (``max_in_flight`` supersteps in flight, the next
    #   dispatched before a fetch is waited on); False = the barriered
    #   drive, one superstep in flight (A5GEN_PIPELINE=off: the same).
    #   The streams are the same either way
    fetch_chunk: int = 16  # the superstep length when ``superstep`` is
    #   unset; in the per-launch pipeline, the most launches whose counts
    #   are fetched together (growing 1 -> fetch_chunk while a chunk
    #   takes under 1 s, shrinking past 4 s)
    checkpoint_path: Optional[str] = None  # resumable sweeps: the
    #   checkpoint file (None = no checkpoints)
    checkpoint_every_s: float = 30.0  # the least time between two
    #   checkpoint writes (0 = at every consumed fetch)
    progress: Optional[ProgressReporter] = None  # JSON progress lines
    fetch_timeout_s: Optional[float] = None  # watchdog on each consumed
    #   fetch: past it the drive raises a typed FetchTimeout, which the
    #   supervisor treats as transient (None = one plain wait)
    retry_attempts: Optional[int] = None  # consecutive recoveries from
    #   a transient device error in one drive (None = RETRY_ATTEMPTS)
    retry_backoff_s: Optional[float] = None  # base of the exponential
    #   backoff between them (None = RETRY_BACKOFF_S)
    faults: "Optional[object]" = None  # a fault plan (a runtime/faults.py
    #   spec string or FaultPlan) installed process-wide when the Sweep is
    #   built; None = A5GEN_FAULTS decides (unset = nothing armed)

    def retry_policy(self) -> "Tuple[int, float]":
        """``(attempts, backoff_s)`` of the drive's retry supervisor."""
        return (RETRY_ATTEMPTS if self.retry_attempts is None
                else int(self.retry_attempts),
                RETRY_BACKOFF_S if self.retry_backoff_s is None
                else float(self.retry_backoff_s))
    packed_blocks: Optional[bool] = None  # True = the variable-offset
    #   block layout (the XLA route, the per-launch pipeline); False =
    #   fixed-stride blocks of lanes // num_blocks lanes; None = packed
    #   exactly when num_blocks does not divide lanes.  The streams are
    #   the same either way
    stream_chunk_words: "Optional[int | str]" = None  # None / 'auto' =
    #   stream the dictionary in chunks of ops.packing.auto_chunk_words
    #   words when it holds more; 0 / 'off' = compile it whole; N = chunks
    #   of N words (A5GEN_STREAM=off: whole).  The streams are the same
    schema_cache: Optional[str] = None  # on-disk PieceSchema cache
    #   directory (None = A5GEN_SCHEMA_CACHE; unset = no cache): repeat
    #   sweeps of one wordlist x table load their schemas instead of
    #   building them (ops.packing: the reference's entries)
    schema_cache_max_mb: Optional[float] = None  # size cap on that
    #   directory (None = A5GEN_SCHEMA_CACHE_MAX_MB; unset = unbounded):
    #   after a write, the oldest-atime entries are evicted until it fits
    devices: "Optional[int | Sequence]" = 1  # cursor stripes of one
    #   sweep (parallel.devices): N = the first N CUDA devices on cuda,
    #   N stripes over the CPU on cpu; None = every visible CUDA device;
    #   or explicit torch devices (stripes may share one).  More CUDA
    #   devices than are visible raise.  The streams are the same
    pod: "Optional[Tuple[int, int]]" = None  # a giant job's shard
    #   (process index, process count): every process sweeps the whole
    #   dictionary and owns the global stripes index * D .. index * D +
    #   D - 1 of each launch (D = its devices), so the shards' hit
    #   streams are a disjoint union equal to one sweep's; the cursor
    #   stays global (a shard checkpoint resumes unsharded and the other
    #   way round).  Oracle-fallback words run on shard 0 only
    geometry_source: str = "explicit"  # where the launch geometry came
    #   from: "explicit" (the caller set the lanes), "profile" (an
    #   autotune profile) or "default" (the built-ins); stamped by the
    #   Sweep's resolution seam, never a cache key or fingerprint input

    def resolve(self, dev: torch.device) -> "tuple[int, int, int]":
        """``(lanes, num_blocks, steps)`` for a device: the built-in lanes
        (``tune.builtin_geometry``) when none are set, and the reference's
        auto block count."""
        lanes = self.lanes or builtin_geometry(dev.type)["lanes"]
        nb = self.num_blocks or (lanes // 128 if lanes % 128 == 0
                                 else 1024)
        return lanes, nb, int(self.superstep or self.fetch_chunk)

    def packed_layout(self, dev: torch.device) -> bool:
        """Whether the sweep runs the variable-offset block layout."""
        if self.packed_blocks is not None:
            return bool(self.packed_blocks)
        lanes, nb, _ = self.resolve(dev)
        return lanes % nb != 0

    def resolve_block_stride(self, dev: torch.device) -> Optional[int]:
        """Lanes per block of the fixed-stride layout; None = the
        variable-offset layout.  An explicit stride request
        (``packed_blocks=False``) with blocks that do not divide the lanes
        raises, as in the reference."""
        if self.packed_layout(dev):
            return None
        lanes, nb, _ = self.resolve(dev)
        if lanes % nb:
            raise ValueError(
                f"fixed-stride layout needs lanes ({lanes}) divisible "
                f"by blocks ({nb}); adjust the geometry or use the packed "
                "layout")
        return lanes // nb

    def superstep_on(self) -> bool:
        """False when the per-launch pipeline is asked for: ``superstep``
        0 or ``A5GEN_SUPERSTEP=off``."""
        if self.superstep is not None and int(self.superstep) <= 0:
            return False
        return superstep_enabled()


@dataclass
class SweepResult:
    n_emitted: int = 0  # the whole sweep's, a resumed run's included
    n_hits: int = 0
    hits: List[HitRecord] = field(default_factory=list)
    words_done: int = 0
    resumed: bool = False  # started from a checkpoint (file or state)
    wall_s: float = 0.0  # the whole run: schema, uploads, drive
    drive_s: float = 0.0  # the drive alone (superstep or per-launch; a
    #   streamed sweep's, from its first chunk's arrival to its end)
    ttfc_s: float = 0.0  # from the Sweep's construction (plans, prescan)
    #   to the first consumed device fetch; 0 when no launch ran
    #: supersteps / launches / replays (overflow re-runs) / retries
    #: (recoveries from transient device errors) / launches_per_fetch /
    #: pair (candidates per lane, 0 = K=1) / per_launch (launches of the
    #: per-launch pipeline)
    superstep: Dict[str, int] = field(default_factory=dict)
    #: word routing: device_clean / device_closed / oracle_fallback
    routing: Dict[str, int] = field(default_factory=dict)
    #: launches by kernel tier: ``piece_<entry>`` (``piece_k1``,
    #: ``piece_pair``, ``piece_suball_closed``, ...), ``bytescan_<row>``
    #: (``bytescan_scalar``, ``bytescan_match``, ``bytescan_suball``) or,
    #: on the XLA route, ``buffer_hash/<algo>`` (candidates mode: the
    #: expansion launches, ``expand``)
    kernels: Dict[str, int] = field(default_factory=dict)
    #: sweeps (buckets) by route: ``piece``, ``bytescan``, ``xla`` (a
    #: streamed sweep counts once on each route its chunks took)
    routes: Dict[str, int] = field(default_factory=dict)
    #: the XLA route's launch geometry: ``lanes`` per launch (the
    #: smallest over buckets), the ``budget_bytes`` it was cut to and the
    #: candidate ``rows`` its launches held
    xla: Dict[str, int] = field(default_factory=dict)
    #: a streamed sweep's stats (empty on the whole path): chunks /
    #: chunks_swept / chunk_words / prefetch / ring / resumed_chunk /
    #: compile_wall_s / first_chunk_compile_s / compile_overlap_s /
    #: overlap_ratio / steady_overlap_ratio / ttfc_s /
    #: peak_resident_plan_bytes / chunk_bytes_max
    stream: Dict[str, float] = field(default_factory=dict)
    #: a crack run's share of the process's on-disk schema-cache activity
    #: (``ops.packing.schema_cache_stats``: hits / misses / bytes_read /
    #: bytes_written / evictions, nonzero deltas only; empty without a
    #: cache), as the reference reports it
    schema_cache: Dict[str, int] = field(default_factory=dict)
    #: the launch geometry the run used (lanes / num_blocks /
    #: block_stride / superstep / pair / device_kind / pod), as its
    #: progress lines carry it; empty when no launch ran
    geometry: Dict[str, Any] = field(default_factory=dict)
    #: where that geometry came from: ``explicit`` (the caller set the
    #: lanes), ``profile`` (an autotune profile, ``runtime/tune.py``) or
    #: ``default`` (the built-in geometry)
    geometry_source: str = "explicit"


class _Fetch:
    """One buffer set's once-per-superstep fetch: non-blocking copies of
    the counters and the hit buffers into pinned host memory, completed by
    one CUDA event (plain copies on the CPU)."""

    def __init__(self, hit_cap: int, dev: torch.device) -> None:
        self.cuda = dev.type == "cuda"
        self.host = {
            "counters": torch.zeros(2, dtype=torch.int32,
                                    pin_memory=self.cuda),
            "hit_word": torch.zeros(hit_cap + 1, dtype=torch.int32,
                                    pin_memory=self.cuda),
            "hit_rank": torch.zeros(hit_cap + 1, dtype=torch.int32,
                                    pin_memory=self.cuda),
        }
        self.event = torch.cuda.Event() if self.cuda else None

    def start(self, out: dict) -> None:
        for k, v in self.host.items():
            v.copy_(out[k], non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def wait(self, timeout_s: Optional[float] = None) -> "tuple[int, int]":
        """Block until the superstep's copies landed; ``(emitted, hits)``.
        With ``timeout_s``, poll the event first and raise
        ``faults.FetchTimeout`` past it (``faults.await_ready``)."""
        if self.cuda:
            faults.await_ready(self.event, timeout_s)
            self.event.synchronize()
        ne, nh = self.host["counters"].tolist()
        return int(ne), int(nh)


@dataclass
class _Region:
    """One compiled plan region: the whole dictionary (``lo`` 0) or one
    streamed chunk, whose plan rows are dictionary rows ``lo ..
    lo + plan.batch``.  Cursors into it are plan-local; the sweep's state
    is global.  ``route`` is None when every word of the region is
    oracle-routed."""

    plan: Any
    lo: int = 0
    pieces: Any = None
    bytescan: Any = None
    route: Optional[str] = None
    schema_s: float = 0.0


class Sweep:
    """One wordlist × one merged table × one attack spec."""

    def __init__(
        self,
        spec: AttackSpec,
        sub_map: Dict[bytes, List[bytes]],
        words: "Sequence[bytes] | PackedWords",
        digests: Sequence[bytes] = (),
        config: Optional[SweepConfig] = None,
    ) -> None:
        self._t_init = time.monotonic()
        self.spec = spec
        self.sub_map = sub_map
        self.config = config or SweepConfig()
        # An explicit plan wins; else A5GEN_FAULTS (unset = nothing armed).
        if self.config.faults is not None:
            faults.install(self.config.faults)
        else:
            faults.ensure_env()
        self.device = resolve_device(self.config.device)
        # The geometry-resolution seam (``runtime/tune.py``): with the lanes
        # left to the runtime, the geometry resolves here, once, before
        # any reader (the route decision below reads the block layout),
        # from this device's autotune profile or the built-in geometry,
        # and is frozen into the config with its ``geometry_source``.
        # Reading the device's name creates no CUDA context.
        if self.config.lanes is None:
            resolved, source = resolve_config(
                self.config, current_device_kind(self.device))
            self.config = replace(resolved, geometry_source=source)
        #: the geometry stamp of the run's launches (SweepResult.geometry)
        self._geometry_stamp: Dict[str, Any] = {}
        self.digests = (
            digests if isinstance(digests, np.ndarray) else list(digests)
        )
        self._digest_lookup = HostDigestLookup(self.digests)
        self.ct = compile_table(sub_map)
        self.packed = (
            words if isinstance(words, PackedWords)
            else pack_words(list(words))
        )
        self.n_words = self.packed.batch
        #: one span per consumed fetch (``--metrics-json`` reads it)
        self.timeline = telemetry.SpanTimeline()
        self._fingerprint: Optional[str] = None
        #: per device: the table values and digest set every region reads
        self._shared: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._digest_set = None
        self._ttfc: Optional[float] = None
        self._run_t0 = self._t_init
        #: the running machine's CheckpointState (None before the first
        #: machine starts); consistent at every yield
        self.active_state: Optional[CheckpointState] = None
        #: the engine's ``runtime.fuse.FusedGroup`` this sweep rides, or
        #: None: its superstep drive is then the group's (_drive_packed)
        self._packed_source = None
        self._pair_warned = False
        self._stream_lock = threading.Lock()
        self._stream_resident = self._stream_peak = self._chunk_max = 0
        #: the streaming decision (chunk bounds and the prescan's global
        #: facts), or None: the whole dictionary's plan, compiled here
        self._stream = self._resolve_streaming()
        #: the whole path's one region (None when streaming)
        self._whole: Optional[_Region] = None
        if self._stream is None:
            self.plan = build_plan(spec, self.ct, self.packed)
            closed = getattr(self.plan, "closed", None)
            n_closed = int(closed.sum()) if closed is not None else 0
            self._windowed = bool(getattr(self.plan, "windowed", False))
            #: oracle-routed word rows, in word order
            self.fallback_rows: List[int] = [
                int(i) for i in np.nonzero(self.plan.fallback)[0]
            ]
        else:
            # Plans are per chunk: the decisions every chunk plan, the
            # fingerprint and the routing share come from the prescan.
            self.plan = None
            self._stream.update(self._stream_prescan())
            n_closed = self._stream["n_closed"]
            self._windowed = self._stream["windowed"]
            self.fallback_rows = self._stream["fallback_rows"]
        self.routing = {
            "device_clean": self.n_words - n_closed - len(self.fallback_rows),
            "device_closed": n_closed,
            "oracle_fallback": len(self.fallback_rows),
        }
        set_routing = getattr(self.config.progress, "set_routing", None)
        if set_routing is not None:
            set_routing(self.routing)
        self.device_words = self.n_words > len(self.fallback_rows)
        if self.config.pod is not None:
            pidx, pcnt = (int(x) for x in self.config.pod)
            if pcnt < 1 or not 0 <= pidx < pcnt:
                raise ValueError(
                    f"SweepConfig.pod must be (index, count) with "
                    f"0 <= index < count, got {self.config.pod!r}")
            self.config = replace(self.config, pod=(pidx, pcnt))
            # The oracle's whole-word host work is not repeated on every
            # shard: shard 0 expands the fallback words.  The routing
            # counts stay global; another shard's checkpoint leaves
            # fallback_done at 0, so an unsharded resume of it expands
            # them itself.
            if pidx != 0:
                self.fallback_rows = []
        #: the cursor stripes (parallel.devices), resolved at the first
        #: run: too many devices raise there, before any launch
        self._stripes: Optional[Stripes] = None
        # The whole path's route, found before any launch: a fused kernel
        # where the reference's gate takes the plan (the piece kernel with
        # a per-slot schema the kernel's descriptors hold, else the
        # byte-scan tier), else the XLA expand + hash route.  A bucket
        # whose block index would pass 2^31 blocks runs as sub-sweeps
        # over word ranges (word_ranges); one with a word of 2^30 rows or
        # more, the per-launch pipeline (per_launch).  A streamed sweep
        # decides all of this per chunk, in the chunk compile.
        self.pieces = self.bytescan = self.route = None
        self._schema_s = 0.0
        if self._stream is None:
            self._whole = self._region(self.plan, 0)
            self.pieces = self._whole.pieces
            self.bytescan = self._whole.bytescan
            self.route = self._whole.route
            # The schema is part of the run: SweepResult.wall_s counts it.
            self._schema_s = self._whole.schema_s

    # ------------------------------------------------------------------
    # Streaming decision, prescan, regions
    # ------------------------------------------------------------------

    def _resolve_streaming(self) -> Optional[dict]:
        """Chunk bounds when the sweep streams, else None: ``auto`` (the
        default) streams a dictionary of more than one
        ``auto_chunk_words`` chunk, ``N`` one of more than N words,
        ``off`` / ``A5GEN_STREAM=off`` never.  The ring compiles one chunk
        ahead of the one being swept."""
        requested = self.config.stream_chunk_words
        if requested in (0, "off") or not stream_enabled():
            return None
        if requested in (None, "auto"):
            cw = auto_chunk_words(self.packed.width)
        else:
            cw = int(requested)
            if cw < 1:
                raise ValueError(
                    "SweepConfig.stream_chunk_words must be >= 1, 'auto' "
                    f"or 'off'; got {requested!r}")
        if self.n_words <= cw:
            return None
        return {"chunk_words": cw, "bounds": chunk_bounds(self.n_words, cw),
                "prefetch": 1}

    def _stream_prescan(self) -> dict:
        """One pass over the dictionary, chunk by chunk (each chunk's plan
        built and dropped), for the facts every chunk plan must share:
        ``out_width`` (the widest chunk's), ``windowed`` (the count-window
        vote summed over the whole dictionary through the same
        ``windowed_chunk_terms`` / ``windowed_gate`` the whole-batch plan
        votes with, so ranks do not depend on the chunking), and the
        oracle routing (``fallback_rows``, ``n_closed``).  The piece
        schemas and device arrays, the dominant cost, stream per chunk."""
        spec = self.spec
        win_ok, sum_win, sum_full = True, 0, 0
        out_width, n_closed = 4, 0
        fallback_rows: List[int] = []
        for lo, hi in self._stream["bounds"]:
            plan = build_plan(spec, self.ct, slice_packed(self.packed, lo, hi),
                              force_windowed=False)
            out_width = max(out_width, int(plan.out_width))
            fb = np.asarray(plan.fallback, bool)
            fallback_rows.extend(lo + int(i) for i in np.nonzero(fb)[0])
            closed = getattr(plan, "closed", None)
            if closed is not None:
                n_closed += int(np.asarray(closed).sum())
            if win_ok:
                radix = np.asarray(plan.pat_radix)
                full = variant_totals(radix)
                n_var = [0 if fb[i] else t for i, t in enumerate(full)]
                ok, _v, _t, sw, sf = windowed_chunk_terms(
                    radix, n_var, spec.effective_min, spec.max_substitute,
                    zero_mask=fb)
                win_ok = ok
                sum_win += sw
                sum_full += sf
        return {"out_width": out_width,
                "windowed": bool(win_ok and windowed_gate(sum_win, sum_full)),
                "fallback_rows": fallback_rows, "n_closed": n_closed}

    def _region(self, plan, lo: int) -> _Region:
        """A plan region's piece schema and route: the XLA expand + hash
        route for the variable-offset layout, a plan the reference's gate
        refuses (``opts_for``) or a schema the piece kernel's descriptors
        cannot hold (``schema_refusal``: the XLA route splices any
        schema); else the piece kernel, or the byte-scan tier for a plan
        without a schema."""
        r = _Region(plan=plan, lo=lo)
        if np.asarray(plan.fallback, bool).all():
            return r
        t0 = time.monotonic()
        r.pieces = piece_schema_for(plan, self.ct,
                                    cache_dir=self._schema_cache_dir(),
                                    max_mb=self._schema_cache_max_mb())
        r.schema_s = time.monotonic() - t0
        if (self.config.packed_layout(self.device)
                or opts_for(self.spec, plan, self.ct) is None):
            r.route = "xla"
        elif r.pieces is None:
            r.route = "bytescan"
            r.bytescan = bytescan_tier(plan)
        elif schema_refusal(plan, r.pieces) is not None:
            r.route = "xla"
        else:
            r.route = "piece"
        return r

    def _schema_cache_dir(self) -> Optional[str]:
        return self.config.schema_cache or schema_cache_dir()

    def _schema_cache_max_mb(self) -> Optional[float]:
        if self.config.schema_cache_max_mb is not None:
            return self.config.schema_cache_max_mb
        return schema_cache_max_mb()

    def stripes(self) -> Stripes:
        """This run's cursor stripes (``SweepConfig.devices`` and
        ``pod``); a device count the machine does not have raises."""
        if self._stripes is None:
            devs = resolve_devices(self.config.devices, self.device)
            if devs[0] != self.device:
                self.device = devs[0]
            self._stripes = resolve_stripes(devs, self.config.pod)
        return self._stripes

    def per_launch(self, rank_stride: int, plan=None) -> bool:
        """Whether a plan (the sweep's whole plan by default) takes the
        per-launch pipeline at ``rank_stride``, as the reference does:
        when the superstep is off (``SweepConfig.superstep_on``), or when
        no int32-safe block index exists (``ops.blocks.superstep_index``
        None: a word of 2^30 rows or more, a huge word, an index past
        int64)."""
        plan = self.plan if plan is None else plan
        if not self.config.superstep_on():
            return True
        ranges = word_ranges(plan, rank_stride)
        return not ranges or superstep_index(plan, rank_stride,
                                             ranges[0]) is None

    def word_ranges(self, rank_stride: int, plan=None) -> "List[tuple]":
        """The sub-sweeps a plan (the sweep's whole plan by default) runs
        at ``rank_stride``: consecutive word ranges, each with an
        int32-safe block index (``ops.blocks.word_ranges``); one range
        unless its index passes ``ops.blocks.SPLIT_BLOCKS``."""
        return word_ranges(self.plan if plan is None else plan, rank_stride)

    def _index_range(self, arrs: List[dict], plan, rank_stride: int,
                     words: tuple):
        """Point each stripe's ``arrays`` at the block index of word range
        ``words`` (one sub-sweep); returns that index."""
        idx = superstep_index(plan, rank_stride, words)
        for a in _distinct(arrs):
            a["cum"] = torch.as_tensor(idx[0], device=a["totals"].device)
            a["total"] = idx[2]
        return idx

    # ------------------------------------------------------------------
    # Checkpoint state, resume, supervision
    # ------------------------------------------------------------------

    @property
    def fingerprint(self) -> str:
        """The checkpoint fingerprint of this sweep's semantic inputs, as
        the reference computes it (``checkpoint.sweep_fingerprint``; the
        mode token marks windowed and cascade-closed plans, whose cursors
        differ); computed once, on first use."""
        if self._fingerprint is None:
            spec = self.spec
            mode_token = spec.mode + (
                "+windowed" if self._windowed else ""
            ) + ("+closed" if self.routing["device_closed"] else "")
            self._fingerprint = sweep_fingerprint(
                mode_token, spec.algo, spec.min_substitute,
                spec.max_substitute, self.sub_map, self.packed,
                self.digests, digest_lookup=self._digest_lookup,
            )
        return self._fingerprint

    def _load_state(self, resume: bool,
                    state: Optional[CheckpointState] = None
                    ) -> CheckpointState:
        """The run's starting state (:attr:`_resumed` says whether it
        resumes a checkpoint): an injected
        ``state`` (the engine's pause / migrate handoff; a deep copy, so
        the caller's token stays as it was) wins over the checkpoint at
        ``SweepConfig.checkpoint_path`` (read when ``resume`` and the file
        exists); either must carry this sweep's fingerprint.  Else a
        fresh state."""
        path = self.config.checkpoint_path
        if state is not None:
            if state.fingerprint != self.fingerprint:
                raise ValueError(
                    "checkpoint state was written by a different sweep "
                    "(mode/window/table/wordlist/digests changed); it "
                    "cannot resume this one")
            state = copy.deepcopy(state)
        elif resume and path:
            state = load_checkpoint(path, self.fingerprint)
        self._resumed = state is not None
        if state is not None:
            if self._stream is None:
                # A streaming checkpoint's chunk marker means nothing to
                # a whole-dictionary sweep: the cursor is global.
                state.stream = None
            return state
        return CheckpointState(fingerprint=self.fingerprint if path
                               else "")

    def _start(self, state: CheckpointState, crack: bool) -> None:
        """Seed the progress windows with a resumed run's counts (they
        belong to an earlier process, not this one's first rates) and its
        chunk position."""
        self._ttfc = None
        progress = self.config.progress
        if progress is None:
            return
        progress.seed_emitted(state.n_emitted)
        seed_hits = getattr(progress, "seed_hits", None)
        if crack and seed_hits is not None:
            seed_hits(state.n_hits)
        self._report_stream_position(state)

    def _report_stream_position(self, state: CheckpointState) -> None:
        """A streamed sweep's chunk marker (``CheckpointState.stream``) in
        the progress lines; nothing on the whole path."""
        if self._stream is None or state.stream is None:
            return
        set_stream = getattr(self.config.progress, "set_stream", None)
        if set_stream is not None:
            set_stream(state.stream)

    def _set_geometry(self, lanes: int, nb: int,
                      stride: Optional[int]) -> None:
        """Stamp the launch geometry into the result and the progress
        lines (the reference's ``geometry`` key and its provenance,
        ``SweepConfig.geometry_source``)."""
        cfg = self.config
        self._geometry_stamp = {
            "lanes": lanes, "num_blocks": nb, "block_stride": stride,
            "superstep": cfg.superstep, "pair": cfg.pair,
            "device_kind": current_device_kind(self.device),
            "pod": list(cfg.pod) if cfg.pod is not None else None,
        }
        set_geometry = getattr(cfg.progress, "set_geometry", None)
        if set_geometry is not None:
            set_geometry(dict(self._geometry_stamp),
                         self.config.geometry_source)

    @staticmethod
    def _normalize(plan, cursor: "Tuple[int, int]") -> "Tuple[int, int]":
        """A plan-local cursor as the block cutter normalizes it: past
        fallback words and finished words."""
        w, rank = cursor
        while w < plan.batch and (plan.fallback[w]
                                  or rank >= plan.n_variants[w]):
            w, rank = w + 1, 0
        return w, rank

    @staticmethod
    def _start_block(plan, cum: np.ndarray, rank_stride: int,
                     w: int, rank: int) -> int:
        """The block a resumed drive starts at, ``cum[w] + rank //
        rank_stride``; it must decode back to the cursor."""
        b0 = int(cum[w]) + rank // rank_stride
        got = block_cursor(plan, rank_stride, cum, b0)
        if got != (w, rank):
            raise RuntimeError(
                f"resume cursor mismatch: block {b0} decodes to {got}, "
                f"checkpoint says ({w}, {rank}); the checkpoint does not "
                "match this plan/geometry"
            )
        return b0

    def _maybe_checkpoint(self, state: CheckpointState, last: List[float],
                          *, force: bool = False,
                          before_save: Optional[Callable[[], None]] = None
                          ) -> None:
        """Write ``state`` when ``checkpoint_every_s`` has passed since the
        last write (or ``force``).  A failed periodic write warns, counts
        ``faults.checkpoint_errors`` and keeps the last good file; the
        final forced write propagates."""
        cfg = self.config
        if cfg.checkpoint_path is None:
            return
        now = time.monotonic()
        if force or now - last[0] >= cfg.checkpoint_every_s:
            if before_save is not None:
                # Land everything the cursor claims was emitted before the
                # checkpoint asserts it.
                before_save()
            try:
                save_checkpoint(cfg.checkpoint_path, state)
            except Exception as exc:  # noqa: BLE001 — periodic-save fate
                if force:
                    raise
                telemetry.counter("faults.checkpoint_errors").add(1)
                print(
                    f"a5gen: warning: checkpoint write failed "
                    f"({type(exc).__name__}: {exc}); previous checkpoint "
                    "intact, retrying at the next interval",
                    file=sys.stderr,
                )
            last[0] = now

    def _retry_backoff(self, exc: BaseException, attempts: int) -> None:
        """Re-raise ``exc`` or count a retry and back off
        (``faults.supervise_retry``: ``SweepConfig.retry_policy``, by
        default :data:`RETRY_ATTEMPTS`, :data:`RETRY_BACKOFF_S`).  Called
        from an ``except`` block."""
        budget, backoff = self.config.retry_policy()
        faults.supervise_retry(
            exc, attempts, attempts_budget=budget,
            backoff_s=backoff, label="the sweep drive",
        )

    def _dispatch(self, launch: Callable[[], object]):
        """One candidates-mode launch under supervision: the
        ``superstep.dispatch`` seam, and a transient error retried in place
        (the launch is a pure function of its blocks; candidates mode has
        no outer re-cut loop)."""
        attempts = 0
        while True:
            try:
                if faults.ACTIVE is not None:
                    faults.ACTIVE.fire("superstep.dispatch")
                return launch()
            except Exception as exc:  # noqa: BLE001 — typed check inside
                self._retry_backoff(exc, attempts)
                attempts += 1

    def _word_plan(self, w_row: int):
        """A streamed sweep's one-word plan of dictionary row ``w_row``,
        with the prescan's ``out_width`` and windowed scheme: per-word
        plan fields do not depend on the batch, so it decodes a rank as
        the chunk plan that flagged it did, without that chunk."""
        cache = self.__dict__.setdefault("_word_plans", {})
        plan = cache.get(w_row)
        if plan is None:
            plan = cache[w_row] = build_plan(
                self.spec, self.ct,
                slice_packed(self.packed, w_row, w_row + 1),
                out_width=self._stream["out_width"],
                force_windowed=self._stream["windowed"])
        return plan

    def _rederive_hit(self, w_row: int, rank: int) -> bytes:
        """A checkpointed hit's candidate: decoded from its rank (through
        a one-word plan when the sweep streams), or, for a fallback word,
        the oracle's ``rank``-th candidate."""
        if self._stream is None:
            plan, row = self.plan, w_row
        else:
            plan, row = self._word_plan(w_row), 0
        if plan.fallback[row]:
            cands = self._oracle_candidates(w_row)
            try:
                return next(itertools.islice(cands, rank, None))
            finally:
                close = getattr(cands, "close", None)
                if close is not None:
                    close()
        return decode_variant(plan, self.ct, self.spec, row, rank)

    def _replay_hits(self, state: CheckpointState, recorder) -> None:
        """Replay a checkpoint's hits into ``recorder``, so a resumed run
        reports the hit list an uninterrupted one would."""
        digest = HOST_DIGEST[self.spec.algo]
        for w_row, rank in state.hits:
            cand = self._rederive_hit(w_row, rank)
            recorder.emit(HitRecord(
                word_index=int(self.packed.index[w_row]), variant_rank=rank,
                candidate=cand, digest_hex=digest(cand).hex()))

    def _note_fetch(self) -> None:
        """Time to the first consumed device fetch (``ttfc_s``)."""
        if self._ttfc is None:
            self._ttfc = time.monotonic()

    # ------------------------------------------------------------------
    # Launch set-up (the whole path's, or one chunk's on the worker)
    # ------------------------------------------------------------------

    def _shared_arrays(self, crack: bool, dev: torch.device
                       ) -> Dict[str, torch.Tensor]:
        """What a sweep uploads once for all its regions, on each device
        of its stripes: the table's values (``val_bytes``, ``val_len``)
        and, in crack mode, the digest set (``rows``, ``bitmap``); built
        on first use, on the caller's thread."""
        shared = self._shared.setdefault(dev, {})
        if not shared:
            shared["val_bytes"] = torch.as_tensor(
                np.ascontiguousarray(self.ct.val_bytes), device=dev)
            shared["val_len"] = torch.as_tensor(_i32(self.ct.val_len),
                                                device=dev)
        if crack and "rows" not in shared:
            if self._digest_set is None:
                self._digest_set = build_digest_set(self.digests,
                                                    self.spec.algo)
            ds = self._digest_set
            shared["rows"] = torch.as_tensor(_i32(ds.rows), device=dev)
            shared["bitmap"] = torch.as_tensor(_i32(ds.bitmap), device=dev)
        return shared

    def _pipeline_depth(self) -> int:
        """Supersteps in flight in the superstep drive, one buffer set
        each: ``max_in_flight`` (default 2: superstep N+1 dispatched
        before superstep N's fetch is waited on), or 1 — the barriered
        drive — when ``SweepConfig.pipeline`` is False or
        ``A5GEN_PIPELINE=off``.  The solo drive, its retry's rebuild of
        the buffer sets and a fused group (``runtime/fuse.py``) all read
        this one value."""
        cfg = self.config
        if not pipeline_enabled():
            return 1
        if not (cfg.pipeline is None or cfg.pipeline):
            return 1
        return max(1, int(cfg.max_in_flight))

    def _pair_k(self, plan, pieces, stride: int) -> Optional[int]:
        """The pair-lane decision for one plan: 2 when the config, the
        ``A5GEN_PAIR`` hatch and the schema's pair gate admit it, else
        None; an explicit ``--pair on`` that cannot be honoured warns
        once."""
        cfg_pair = str(self.config.pair).lower()
        if self.config.pair is not None and cfg_pair in ("0", "off", "no",
                                                         "false"):
            return None
        k = pair_for(self.spec, plan, pieces, block_stride=stride)
        if k is None and cfg_pair in ("on", "1", "2", "true") \
                and not self._pair_warned:
            self._pair_warned = True
            print("a5gen: warning: pair requested (--pair on) but this "
                  "plan/config is not pair-eligible (schema gate, windowed "
                  "decode, or hash-block count); running K=1",
                  file=sys.stderr)
        return k

    def _setup(self, r: _Region, kind: str, start: "Tuple[int, int]",
               *, upload: bool = False) -> dict:
        """Everything a region's drive needs from the normalized
        plan-local cursor ``start``: the geometry (``lanes``, ``nb``,
        ``stride`` — None for the variable-offset layout — ``steps``,
        ``pair_k``, ``rank_stride``), the drive (``per_launch``, the word
        ``ranges`` of the superstep drive), the device ``arrays``, the
        step keywords ``kw``, the launch ``tier`` and the XLA route's
        ``xla_geom``.  With ``upload`` (a chunk compiled on the worker
        thread, on CUDA) the region's own arrays go up from pinned memory
        on a side stream; ``ready`` is the event the drive's stream waits
        on before its first launch, and each tensor is recorded on the
        drive's stream, so its memory is not reused while a launch may
        still read it."""
        g = self._geometry(r, kind, start)
        plan, dev, crack = r.plan, self.device, kind == "crack"
        idx = (None if g["per_launch"] else
               superstep_index(plan, g["rank_stride"], g["ranges"][0]))
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("device.init")
        target = torch.device("cpu") if upload else dev
        if g["xla"]:
            arrays = xla_arrays(plan, self.ct, r.pieces, None, idx,
                                device=target)
        else:
            arrays = device_arrays(plan, r.pieces, None, idx, device=target,
                                   ct=self.ct, bytescan=r.bytescan)
        shared = self._shared_arrays(crack, dev)
        if getattr(plan, "cval_bytes", None) is None:
            for k in ("val_bytes", "val_len"):
                if k in arrays:
                    arrays[k] = shared[k]
        own = {k: v for k, v in arrays.items()
               if torch.is_tensor(v) and v is not shared.get(k)}
        # The stripes on other devices get their own copies (tensors as
        # built, before any upload below, and those devices' shared sets).
        devs = self.stripes().distinct()
        copies = {d: {k: v.to(d) for k, v in own.items()}
                  for d in devs[1:]}
        ready = None
        if upload and dev.type == "cuda":
            side = torch.cuda.Stream(device=dev)
            with torch.cuda.stream(side):
                for k, v in own.items():
                    own[k] = v.pin_memory().to(dev, non_blocking=True)
                    own[k].record_stream(self._drive_stream)
                ready = torch.cuda.Event()
                ready.record(side)
            arrays.update(own)
        if crack:
            arrays.update(rows=shared["rows"], bitmap=shared["bitmap"])
        per_dev = {dev: arrays}
        for d, own_d in copies.items():
            shared_d = self._shared_arrays(crack, d)
            per_dev[d] = {**arrays, **own_d, **{
                k: shared_d[k] for k, v in arrays.items()
                if torch.is_tensor(v) and v is shared.get(k)}}
        return dict(g, arrays=[per_dev[d] for d in self.stripes().devices],
                    ready=ready,
                    nbytes=len(per_dev) * sum(v.numel() * v.element_size()
                                              for v in own.values()))

    def _geometry(self, r: _Region, kind: str,
                  start: "Tuple[int, int]") -> dict:
        """A region's launch decisions from the normalized plan-local
        cursor ``start``, without touching the device: the geometry
        (``lanes``, ``nb``, ``stride`` — None for the variable-offset
        layout — ``steps``, ``pair_k``, ``rank_stride``; the XLA route's
        lanes cut to its budget, ``xla_geom``), the drive (``per_launch``,
        the superstep drive's word ``ranges``), the step keywords ``kw``
        and the launch ``tier``."""
        spec, cfg, dev, plan = self.spec, self.config, self.device, r.plan
        lanes, nb, steps = cfg.resolve(dev)
        stride = cfg.resolve_block_stride(dev)
        crack = kind == "crack"
        w, rank = start
        pair_k = rank_stride = None
        if stride is None:
            per_launch = True
        else:
            if crack:
                pair_k = self._pair_k(plan, r.pieces, stride)
            rank_stride = stride * (pair_k or 1)
            if pair_k is not None and self.per_launch(rank_stride, plan):
                # The per-launch step runs K=1, as the reference's does.
                pair_k, rank_stride = None, stride
            per_launch = self.per_launch(rank_stride, plan)
            # A resumed cursor must sit on a block boundary of the
            # superstep drive: a pair-misaligned but K=1-aligned one runs
            # the K=1 superstep tier, any other misalignment the
            # per-launch pipeline.
            if not per_launch and w < plan.batch and rank % rank_stride:
                per_launch = rank % stride != 0
                pair_k, rank_stride = None, stride
        ranges = [] if per_launch else word_ranges(plan, rank_stride)
        xla = not crack or r.route == "xla"
        xla_geom: Dict[str, int] = {}
        if xla:
            budget = XLA_BUDGET_BYTES[dev.type]
            lanes = xla_lanes(plan, lanes, stride, pair_k or 1, budget)
            if stride is not None:
                nb = lanes // stride
            xla_geom = {"lanes": lanes, "budget_bytes": budget}
        decode, pack_cb = decode_for(plan)
        kw = dict(num_lanes=lanes, out_width=int(plan.out_width),
                  block_stride=stride, pieces=r.pieces,
                  windowed=bool(getattr(plan, "windowed", False)),
                  radix2=k_opts_for(plan) == 1)
        if crack:
            kw.update(num_blocks=nb, pair_k=pair_k, decode=decode,
                      pack_cb=pack_cb, k_opts=k_vals_for(plan),
                      bytescan=r.bytescan, xla=xla)
            tier = (f"buffer_hash/{spec.algo}" if xla else
                    r.bytescan.name if r.bytescan is not None else
                    launch_key(spec.algo, r.pieces, decode,
                               pair_k is not None).split("/")[0])
        else:
            tier = "expand"
        return dict(lanes=lanes, nb=nb, stride=stride, steps=steps,
                    pair_k=pair_k, rank_stride=rank_stride,
                    per_launch=per_launch, ranges=ranges, xla=xla,
                    kw=kw, tier=tier, xla_geom=xla_geom)

    # ------------------------------------------------------------------
    # Crack mode
    # ------------------------------------------------------------------

    def run_crack(self, recorder: Optional[HitRecorder] = None, *,
                  resume: bool = True,
                  state: Optional[CheckpointState] = None) -> SweepResult:
        """Fused expand → hash → membership on the device; only hits
        return to the host.  With ``SweepConfig.checkpoint_path`` the
        sweep checkpoints and, given ``resume``, starts from the file's
        cursor, its hits replayed into ``recorder`` first; an injected
        ``state`` resumes the same way.  :meth:`crack_machine`,
        exhausted."""
        return _exhaust(self.crack_machine(recorder, resume=resume,
                                           state=state))

    def crack_machine(
        self, recorder: Optional[HitRecorder] = None, *,
        resume: bool = True, state: Optional[CheckpointState] = None,
    ) -> "Generator[None, None, SweepResult]":
        """The crack sweep as a resumable state machine: a generator that
        yields at every consumed fetch boundary (a superstep or a
        per-launch chunk drain) with its state — :attr:`active_state` —
        consistent at each yield.  ``next()`` advances one boundary;
        closing it abandons the sweep (the chunk-compile worker and the
        fallback producer stopped, the wall time added, the state at the
        last consumed boundary); exhausting it returns the
        :class:`SweepResult` as ``StopIteration.value``."""
        t0 = time.monotonic()
        self._run_t0 = t0
        cfg = self.config
        recorder = recorder if recorder is not None else HitRecorder()
        sc0 = schema_cache_stats()
        state = self._load_state(resume, state)
        resumed = self._resumed
        self.active_state = state
        self._start(state, crack=True)
        self._replay_hits(state, recorder)
        last_ckpt = [t0]
        flush = _FallbackFlush(self, state, self._crack_word(recorder, state))
        device: dict = {}

        def drive(setup, r, start):
            return self._crack_region(setup, r, recorder, flush, state,
                                      last_ckpt, start)

        try:
            if self.device_words:
                device = yield from self._run_device("crack", state, flush,
                                                     drive)
            flush.until(self.n_words)
        finally:
            flush.close()
            # In the finally, so an abandoned machine (the engine's pause
            # or cancel) still adds its run time to the state.
            state.wall_s += time.monotonic() - t0
        state.cursor = SweepCursor(word=self.n_words, rank=0)
        self._maybe_checkpoint(state, last_ckpt, force=True)
        if cfg.progress:
            cfg.progress.final(words_done=self.n_words,
                               emitted=state.n_emitted, hits=state.n_hits)
        return SweepResult(
            n_emitted=state.n_emitted,
            n_hits=state.n_hits,
            hits=recorder.hits,
            words_done=self.n_words,
            resumed=resumed,
            wall_s=time.monotonic() - t0 + self._schema_s,
            routing=dict(self.routing),
            schema_cache=_stats_delta(sc0, schema_cache_stats()),
            geometry=dict(self._geometry_stamp),
            geometry_source=self.config.geometry_source,
            **device,
        )

    def _run_device(self, kind: str, state: CheckpointState, flush,
                    drive: Callable[[dict, _Region, tuple], Iterator]
                    ) -> "Generator[None, None, dict]":
        """The device half of a run from the state's cursor: the whole
        path's one region, or the chunk ring; returns the result's drive
        fields (the regions' own merged by :func:`_merge_parts`).  A
        machine generator, as ``drive`` is."""
        self.config.resolve_block_stride(self.device)  # an explicit
        #   stride that does not divide raises before any launch, and so
        #   does a device count the machine does not have
        self.stripes()
        if self._stream is not None:
            return (yield from self._run_stream(kind, state, flush, drive))
        r = self._whole
        start = self._normalize(r.plan, (state.cursor.word,
                                         state.cursor.rank))
        # A packed member's arrays are its group's: nothing of its own
        # goes up to the device.
        setup = (None if self._packed_source is not None
                 else self._setup(r, kind, start))
        t_drive = time.monotonic()
        out = _merge_parts([(yield from drive(setup, r, start))])
        out["drive_s"] = time.monotonic() - t_drive
        out["ttfc_s"] = (self._ttfc - self._t_init
                         if self._ttfc is not None else 0.0)
        return out

    def _crack_region(self, s: Optional[dict], r: _Region, recorder, flush,
                      state: CheckpointState, last_ckpt: List[float],
                      start: "Tuple[int, int]"
                      ) -> "Generator[None, None, dict]":
        """One region's crack drive from its plan-local cursor ``start``
        with the launch set-up ``s`` (:meth:`_setup`; None for a packed
        member, whose group holds its arrays); returns its superstep
        stats, kernel launches, route and XLA geometry.  A machine
        generator: yields at every consumed fetch."""
        spec, plan = self.spec, r.plan
        src = self._packed_source
        if src is not None and r.lo == 0 and self._stream is None:
            if self.config.pod is not None:
                raise RuntimeError(
                    "pod giant-job mode cannot ride a cross-job packed "
                    "dispatch (the FusedGroup owns the block cursors); "
                    "run giant jobs solo")
            stats = yield from self._drive_packed(src, r, recorder, flush,
                                                  state, last_ckpt)
            return dict(superstep=stats, kernels={src.tier: stats[
                "launches"]}, routes={src.route: 1}, xla={})
        lanes, nb, pair_k = s["lanes"], s["nb"], s["pair_k"]
        rank_stride, arrs = s["rank_stride"], s["arrays"]
        self._set_geometry(lanes, nb, s["stride"])
        w, rank = start
        if s["per_launch"]:
            stats = yield from self._drive_per_launch(
                r, self._step("crack-step", s["kw"], lambda: make_crack_step(
                    spec, **s["kw"])), arrs, lanes, nb,
                s["stride"], recorder, flush, state, last_ckpt, start)
            steps = 1
        else:
            # The superstep's emitted counter is int32: cap steps so every
            # lane emitting cannot reach 2^31.
            steps = max(1, min(s["steps"], ((1 << 31) - 1)
                               // (lanes * (pair_k or 1))))
            # Each step of a stripe advances past every stripe's blocks.
            advance = nb * self.stripes().total
            body = self._step(
                ("superstep", advance), s["kw"],
                lambda: make_superstep_body(spec, step_advance=advance,
                                            **s["kw"]))
            stats = {"supersteps": 0, "launches": 0, "replays": 0,
                     "retries": 0}
            for lo, hi in s["ranges"]:
                # One sub-sweep per word range, in word order: its own
                # block index over the same resident tables; the ranges
                # before the cursor are done.
                if hi <= w:
                    continue
                cum = self._index_range(arrs, plan, rank_stride,
                                        (lo, hi))[0]
                b_start = (self._start_block(plan, cum, rank_stride, w, rank)
                           if lo <= w else 0)
                part = yield from self._drive(
                    r, body, arrs, nb, steps, recorder, flush, state,
                    last_ckpt, b_start,
                    lambda b, cum=cum, hi=hi: _clip(
                        block_cursor(plan, rank_stride, cum, b), hi))
                for k in stats:
                    stats[k] += part[k]
        stats["launches_per_fetch"] = steps
        stats["pair"] = pair_k or 0
        xla_geom = dict(s["xla_geom"])
        if xla_geom:
            xla_geom["rows"] = stats["launches"] * lanes * (pair_k or 1)
        return dict(superstep=stats, kernels={s["tier"]: stats["launches"]},
                    routes={r.route: 1}, xla=xla_geom)

    def _step(self, name, kw: dict, build: Callable[[], Any]):
        """The cached step closure of one drive (:func:`_get_step`), keyed
        by the spec and every static keyword the closure takes."""
        statics = tuple(sorted(
            (k, _pieces_static(v) if k == "pieces" else v)
            for k, v in kw.items()))
        return _get_step((name, self.spec, statics), build)

    # ------------------------------------------------------------------
    # Candidates mode
    # ------------------------------------------------------------------

    def run_candidates(self, writer: CandidateWriter, *,
                       resume: bool = True,
                       state: Optional[CheckpointState] = None
                       ) -> SweepResult:
        """Stream every candidate to ``writer`` in word order, rank order
        within a word (per-word multiset parity with the oracle): the XLA
        expansion on the device, one launch at a time, its emitted rows
        compacted on the device before the copy to the host; fallback
        words through the oracle at their word position.  Resume is
        at-least-once, as in the reference: the candidates written after
        the last checkpoint repeat.  :meth:`candidates_machine`,
        exhausted."""
        return _exhaust(self.candidates_machine(writer, resume=resume,
                                                state=state))

    def candidates_machine(
        self, writer: CandidateWriter, *, resume: bool = True,
        state: Optional[CheckpointState] = None,
    ) -> "Generator[None, None, SweepResult]":
        """Candidates mode as a resumable state machine, the crack
        machine's twin (:meth:`crack_machine`): yields at every consumed
        launch."""
        t0 = time.monotonic()
        self._run_t0 = t0
        cfg = self.config
        if cfg.pod is not None:
            raise ValueError("SweepConfig.pod (the giant job) shards crack "
                             "sweeps only")
        state = self._load_state(resume, state)
        resumed = self._resumed
        self.active_state = state
        self._start(state, crack=False)
        last_ckpt = [t0]

        def on_word(row: int, cands) -> None:
            n = 0
            for cand in cands:
                writer.emit(cand)
                n += 1
            state.n_emitted += n

        flush = _FallbackFlush(self, state, on_word)

        def drive(setup, r, start):
            return self._candidates_region(setup, r, writer, flush, state,
                                           last_ckpt, start)

        device: dict = {}
        try:
            if self.device_words:
                device = yield from self._run_device("candidates", state,
                                                     flush, drive)
            flush.until(self.n_words)
        finally:
            flush.close()
            state.wall_s += time.monotonic() - t0
        state.cursor = SweepCursor(word=self.n_words, rank=0)
        self._maybe_checkpoint(state, last_ckpt, force=True,
                               before_save=writer.flush)
        if cfg.progress:
            cfg.progress.final(words_done=self.n_words,
                               emitted=state.n_emitted, hits=0)
        return SweepResult(
            n_emitted=state.n_emitted,
            words_done=self.n_words,
            resumed=resumed,
            wall_s=time.monotonic() - t0 + self._schema_s,
            routing=dict(self.routing),
            geometry=dict(self._geometry_stamp),
            geometry_source=self.config.geometry_source,
            **device,
        )

    def _candidates_region(self, s: dict, r: _Region,
                           writer: CandidateWriter, flush,
                           state: CheckpointState, last_ckpt: List[float],
                           start: "Tuple[int, int]"
                           ) -> "Generator[None, None, dict]":
        """One region's candidates drive from its plan-local cursor
        ``start`` (:meth:`_setup`'s ``s``): each launch's emitted rows
        written in row order (several stripes: their rows concatenated in
        stripe order, which is cursor order), the fallback words inside
        its word range between the rows of the words around them.  A
        machine generator: yields after each consumed launch."""
        spec, cfg, plan = self.spec, self.config, r.plan
        lanes, nb, stride = s["lanes"], s["nb"], s["stride"]
        arrs, kw = s["arrays"], s["kw"]
        self._set_geometry(lanes, nb, stride)
        w, rank = start

        def launches():
            """Each launch's emitted rows, one ``(cand, cand_len,
            word_row)`` per stripe, and the plan-local cursor it leaves:
            blocks cut on the host (per-launch pipeline) or on the
            device, one word range after the other."""
            if s["per_launch"]:
                step = self._step("candidates-step", kw,
                                  lambda: make_candidates_step(spec, **kw))
                for parts, w2, r2 in self._host_rounds(
                        plan, lanes, nb, stride, step.decode, start):
                    yield self._dispatch(lambda: [
                        step(arrs[i], *blocks)
                        for i, _batch, blocks in parts]), (w2, r2)
                return
            body = self._step(("candidates", nb), kw,
                              lambda: make_candidates_body(
                                  spec, num_blocks=nb, **kw))
            n = len(arrs)
            for w_lo, w_hi in s["ranges"]:
                # One sub-sweep per word range, in word order.
                if w_hi <= w:
                    continue
                cum = self._index_range(arrs, plan, stride,
                                        (w_lo, w_hi))[0]
                total = arrs[0]["total"]
                b_start = (self._start_block(plan, cum, stride, w, rank)
                           if w_lo <= w else 0)
                for b0 in range(b_start, total, nb * n):
                    yield self._dispatch(lambda: [
                        body(arrs[i], b0 + i * nb) for i in range(n)
                        if b0 + i * nb < total]), _clip(
                        block_cursor(plan, stride, cum,
                                     min(b0 + nb * n, total)), w_hi)

        n_launches = 0
        rows = self.fallback_rows
        for outs, (w_end, r_end) in launches():
            cand, clen, wrow = (
                np.concatenate([o[j].cpu().numpy() for o in outs])
                for j in range(3))
            self._note_fetch()
            n_launches += len(outs)
            w_end += r.lo
            lo = 0
            # Fallback words inside this launch's word range go between
            # the rows of the words around them.
            while state.fallback_done < len(rows) and len(wrow) \
                    and rows[state.fallback_done] < r.lo + int(wrow[-1]):
                cut = int(np.searchsorted(
                    wrow, rows[state.fallback_done] - r.lo))
                state.n_emitted += _write_rows(writer, cand, clen, lo, cut)
                lo = cut
                flush.until(rows[state.fallback_done] + 1)
            state.n_emitted += _write_rows(writer, cand, clen, lo, len(clen))
            flush.until(w_end)
            state.cursor = SweepCursor(w_end, r_end)
            self.timeline.record_fetch(kind="launch", launches=len(outs))
            self._maybe_checkpoint(state, last_ckpt,
                                   before_save=writer.flush)
            if cfg.progress:
                cfg.progress.update(words_done=w_end,
                                    emitted=state.n_emitted, hits=0)
            yield
        return dict(kernels={"expand": n_launches}, routes={"xla": 1},
                    xla=dict(s["xla_geom"], rows=n_launches * lanes))

    # ------------------------------------------------------------------
    # Streaming: the chunk ring
    # ------------------------------------------------------------------

    def _compile_chunk(self, kind: str, ci: int, lo: int, hi: int,
                       resume: "Tuple[int, int]") -> PlanChunk:
        """One chunk's compile, on the ring's worker thread: its plan
        (the prescan's ``out_width`` and windowed scheme forced), piece
        schema and route (:meth:`_region`), and its launch set-up and
        device arrays (:meth:`_setup`, uploaded on a side stream) from
        the run's resume cursor ``resume`` when it falls in the chunk,
        else from the chunk's start."""
        plan = build_plan(self.spec, self.ct,
                          slice_packed(self.packed, lo, hi),
                          out_width=self._stream["out_width"],
                          force_windowed=self._stream["windowed"])
        r = self._region(plan, lo)
        w0, rank0 = resume
        start = self._normalize(
            plan, (w0 - lo, rank0) if lo <= w0 < hi else (0, 0))
        setup = (self._setup(r, kind, start, upload=True)
                 if r.route is not None else None)
        nbytes = setup["nbytes"] if setup is not None else 0
        with self._stream_lock:
            self._stream_resident += nbytes
            self._stream_peak = max(self._stream_peak, self._stream_resident)
            self._chunk_max = max(self._chunk_max, nbytes)
        return PlanChunk(index=ci, lo=lo, hi=hi, plan=plan, pieces=r.pieces,
                         payload={"region": r, "setup": setup,
                                  "start": start},
                         host_bytes=nbytes, releaser=self._release_chunk)

    def _release_chunk(self, chunk: PlanChunk) -> None:
        """Drop a consumed chunk's arrays (the shared digest set and table
        stay).  Its CUDA tensors were recorded on the drive's stream, so
        the allocator reuses their memory only once the launches that
        read them have run."""
        with self._stream_lock:
            self._stream_resident -= chunk.host_bytes

    def _run_stream(self, kind: str, state: CheckpointState, flush,
                    drive: Callable[[dict, _Region, tuple], Iterator]
                    ) -> "Generator[None, None, dict]":
        """The streamed drive: from the chunk holding the state's cursor
        (chunks before it are never compiled), the ring sweeps chunk N
        while its worker compiles chunk N+1; after each chunk its fallback
        words are flushed, the cursor moves to the next chunk's first word
        and the checkpoint state carries the chunk marker.  Returns the
        regions' merged drive fields with the stream stats.  A machine
        generator (``drive`` is one too): closing it stops the worker."""
        bounds = self._stream["bounds"]
        cw = self._stream["chunk_words"]
        w0, rank0 = state.cursor.word, state.cursor.rank
        start_ci = next((ci for ci, (_lo, hi) in enumerate(bounds)
                         if w0 < hi), len(bounds))
        stream: Dict[str, float] = {
            "chunks": len(bounds), "chunks_swept": 0, "chunk_words": cw,
            "prefetch": self._stream["prefetch"],
            # The chunk being swept, the prefetch window and one compile
            # the worker may start before the consumer releases.
            "ring": self._stream["prefetch"] + 2,
            "resumed_chunk": start_ci,
        }
        with self._stream_lock:
            self._stream_resident = self._stream_peak = self._chunk_max = 0
        if start_ci >= len(bounds):
            return {"stream": stream}
        for dev in self.stripes().distinct():  # once, on the drive's thread
            self._shared_arrays(kind == "crack", dev)
        self._drive_stream = (torch.cuda.current_stream(self.device)
                              if self.device.type == "cuda" else None)
        compiler = ChunkCompiler(
            lambda ci, lo, hi: self._compile_chunk(kind, ci, lo, hi,
                                                   (w0, rank0)),
            bounds, start=start_ci, prefetch=self._stream["prefetch"])
        parts: List[dict] = []
        t_drive0: Optional[float] = None
        try:
            for chunk in compiler:
                if t_drive0 is None:
                    t_drive0 = time.monotonic()
                pay = chunk.payload
                setup = pay["setup"]
                if setup is not None:
                    if setup["ready"] is not None:
                        self._drive_stream.wait_event(setup["ready"])
                    parts.append((yield from drive(setup, pay["region"],
                                                   pay["start"])))
                flush.until(chunk.hi)
                state.cursor = SweepCursor(chunk.hi, 0)
                state.stream = {"chunk": chunk.index, "chunk_words": cw}
                self._report_stream_position(state)
                stream["chunks_swept"] += 1
                chunk.release()
        finally:
            compiler.close()
        t_end = time.monotonic()
        if t_drive0 is None:
            t_drive0 = t_end
        overlap = sum(max(0.0, min(b, t_end) - max(a, t_drive0))
                      for a, b in compiler.windows)
        wall = compiler.compile_wall_s
        first = (compiler.windows[0][1] - compiler.windows[0][0]
                 if compiler.windows else 0.0)
        ttfc = self._ttfc - self._t_init if self._ttfc is not None else 0.0
        stream.update({
            "compile_wall_s": wall,
            "first_chunk_compile_s": first,
            "compile_overlap_s": overlap,
            # Chunk 0 compiles before anything can overlap it; the steady
            # ratio leaves it out.
            "overlap_ratio": overlap / wall if wall > 0 else 0.0,
            "steady_overlap_ratio": (overlap / (wall - first)
                                     if wall - first > 0 else 0.0),
            "ttfc_s": ttfc,
            "peak_resident_plan_bytes": self._stream_peak,
            "chunk_bytes_max": self._chunk_max,
        })
        out = _merge_parts(parts)
        out.update(drive_s=t_end - t_drive0, ttfc_s=ttfc, stream=stream)
        return out

    # ------------------------------------------------------------------
    # The drives
    # ------------------------------------------------------------------

    def _drive(self, r: _Region, body, arrs: List[dict], nb: int,
               steps: int, recorder, flush, state: CheckpointState,
               last_ckpt: List[float], b_start: int, cursor_at
               ) -> "Generator[None, None, dict]":
        """The pipelined superstep loop over region ``r`` from block
        ``b_start`` (:meth:`_pipeline_depth` supersteps in flight);
        returns its stats.  Each superstep runs every stripe of
        :meth:`stripes` (stripe ``i`` from block ``b0 + (offset + i) *
        nb``, on its own CUDA stream with its own buffer sets; one stripe
        runs on the current stream).  At each consumed (lagged) boundary:
        the stripes' counters summed, their hits (a stripe's re-run first
        when they overflowed its buffer) merged in ``(word, rank)``
        order, ``flush`` to the boundary's word, the state's cursor
        (``cursor_at(end block)``, plan-local) and counts, a span, the
        checkpoint and progress; then the machine yields.  A transient
        error at dispatch or fetch drops the in-flight supersteps,
        rebuilds the buffer sets and re-dispatches from the last consumed
        boundary."""
        cfg = self.config
        st = self.stripes()
        streams = st.streams()
        total = arrs[0]["total"]
        hit_cap = int(cfg.superstep_hit_cap)
        span = nb * st.total  # the blocks one step of every stripe covers
        # Supersteps in flight, one buffer set each (1: the barriered
        # drive, each fetch waited on before the next dispatch).
        depth = self._pipeline_depth()

        def buffer_sets() -> list:
            out = []
            for _ in range(depth):
                sets = []
                for dev, strm in zip(st.devices, streams):
                    with _on(strm):
                        sets.append((superstep_buffers(hit_cap, device=dev),
                                     _Fetch(hit_cap, dev)))
                out.append(sets)
            return out

        def stripe_b0(b0: int, i: int) -> int:
            return b0 + (st.offset + i) * nb

        _join_streams(streams, into_stripes=True)
        free = buffer_sets()
        inflight: deque = deque()
        stats = {"supersteps": 0, "launches": 0, "replays": 0, "retries": 0}
        b0 = consumed = b_start
        attempts = 0
        try:
            while b0 < total or inflight:
                try:
                    while b0 < total and len(inflight) < depth:
                        if faults.ACTIVE is not None:
                            faults.ACTIVE.fire("superstep.dispatch")
                        # The tail superstep runs only the steps it needs.
                        n_steps = min(steps, -(-(total - b0) // span))
                        sets = free.pop()
                        for i, ((bufs, fetch), strm) in enumerate(
                                zip(sets, streams)):
                            with _on(strm):
                                fetch.start(body(arrs[i], stripe_b0(b0, i),
                                                 n_steps, bufs))
                        inflight.append((b0, n_steps, sets,
                                         time.monotonic()))
                        b0 += n_steps * span
                    sb0, n_steps, sets, disp_t = inflight.popleft()
                    if faults.ACTIVE is not None:
                        faults.ACTIVE.fire("superstep.fetch")
                    counts = [fetch.wait(cfg.fetch_timeout_s)
                              for _bufs, fetch in sets]
                except Exception as exc:  # noqa: BLE001 — typed inside
                    self._retry_backoff(exc, attempts)
                    attempts += 1
                    stats["retries"] += 1
                    inflight.clear()
                    free = buffer_sets()
                    b0 = consumed
                    flush.restart()
                    continue
                attempts = 0
                self._note_fetch()
                end = min(sb0 + n_steps * span, total)
                consumed = end
                ne = sum(c[0] for c in counts)
                nh = sum(c[1] for c in counts)
                entries: List[Tuple[int, int]] = []
                replayed = False
                for i, ((_bufs, fetch), (_ne, nh_i)) in enumerate(
                        zip(sets, counts)):
                    src = fetch.host
                    if nh_i > hit_cap:
                        # Overflow: the capped buffer dropped entries.
                        # Re-run the stripe's blocks into a buffer that
                        # holds them all (a pure function of its cursor),
                        # before the boundary is checkpointed.
                        replayed = True
                        with _on(streams[i]):
                            big = superstep_buffers(nh_i,
                                                    device=st.devices[i])
                            src = {k: v.cpu() for k, v in body(
                                arrs[i], stripe_b0(sb0, i), n_steps,
                                big).items()}
                        if int(src["counters"][1]) != nh_i:
                            raise RuntimeError("superstep replay disagrees "
                                               "with its first run")
                    if nh_i:
                        entries.extend(zip(src["hit_word"][:nh_i].tolist(),
                                           src["hit_rank"][:nh_i].tolist()))
                stats["replays"] += int(replayed)
                # Stripes interleave by step: (word, rank) is cursor order.
                for w_row, rank in sorted(entries):
                    flush.until(r.lo + int(w_row))
                    self._device_hit(r, int(w_row), int(rank), recorder,
                                     state)
                w_end, r_end = cursor_at(end)
                w_end += r.lo
                flush.until(w_end)
                state.n_emitted += ne
                state.cursor = SweepCursor(w_end, r_end)
                stats["supersteps"] += 1
                stats["launches"] += n_steps * st.n
                free.append(sets)
                with telemetry.profiler_span("a5.superstep.consume"):
                    self.timeline.record_fetch(
                        kind="superstep", index=stats["supersteps"],
                        dispatched_at=disp_t, inflight=len(inflight),
                        launches=n_steps * st.n, emitted=ne, hits=nh,
                        hit_occupancy=max(min(c[1], hit_cap)
                                          for c in counts) / max(hit_cap, 1),
                        replayed=replayed,
                    )
                self._maybe_checkpoint(state, last_ckpt)
                if cfg.progress:
                    cfg.progress.update(words_done=w_end,
                                        emitted=state.n_emitted,
                                        hits=state.n_hits)
                yield
        finally:
            _join_streams(streams, into_stripes=False)
        return stats

    def _drive_packed(self, src, r: _Region, recorder, flush,
                      state: CheckpointState, last_ckpt: List[float]
                      ) -> "Generator[None, None, dict]":
        """The consume half of the cross-job packed drive (the reference's
        ``_drive_packed``).  ``src`` is the engine's
        ``runtime.fuse.FusedGroup``: it owns dispatch and the one counters
        fetch a round for every fused tenant; this machine pulls its own
        share each tick — its emitted and hit counts from the packed
        counter rows, its hits already mapped to job-local ``(word,
        rank)`` — and runs the consume sequence of :meth:`_drive`: the
        fallback words flushed in word order, each hit re-derived and
        re-verified on the host, the state, a span, the checkpoint and
        progress, then a yield.  A superstep whose hits overflowed the
        capped buffer was re-run by the group into a larger one
        (``overflow``).  Leaves the group in the finally, so completion,
        pause, cancel and failure all park the job's segment."""
        cfg, plan = self.config, r.plan
        stride, cum = src.stride, src.member_cum(self)
        stats = {"supersteps": 0, "launches": 0, "replays": 0,
                 "retries": 0, "launches_per_fetch": src.steps,
                 "pair": src.pair_k, "packed": src.n_seg}
        try:
            while True:
                res = src.next_result(self)
                if res is None:
                    break
                self._note_fetch()
                w_end, r_end = block_cursor(plan, stride, cum, res["b_hi"])
                stats["replays"] += int(res["overflow"])
                for w_row, rank in res["entries"]:
                    flush.until(r.lo + int(w_row))
                    self._device_hit(r, int(w_row), int(rank), recorder,
                                     state)
                flush.until(r.lo + w_end)
                state.n_emitted += res["ne"]
                state.cursor = SweepCursor(r.lo + w_end, r_end)
                stats["supersteps"] += 1
                stats["launches"] += src.launches_per_round
                with telemetry.profiler_span("a5.superstep.consume"):
                    self.timeline.record_fetch(
                        kind="superstep", index=stats["supersteps"],
                        dispatched_at=res["disp_t"],
                        inflight=res["inflight"],
                        launches=src.launches_per_round, emitted=res["ne"],
                        hits=res["nh"],
                        hit_occupancy=res["hit_occupancy"],
                        replayed=res["overflow"],
                    )
                self._maybe_checkpoint(state, last_ckpt)
                if cfg.progress:
                    cfg.progress.update(words_done=r.lo + w_end,
                                        emitted=state.n_emitted,
                                        hits=state.n_hits)
                yield
        finally:
            src.leave(self)
        return stats

    def _host_rounds(self, plan, lanes: int, nb: int, stride: Optional[int],
                     decode: str, start: "Tuple[int, int]"):
        """The per-launch pipeline's launch rounds over ``plan`` from its
        plan-local cursor ``start``, in cursor order: each round cuts one
        launch of blocks on the host for every global stripe
        (``ops.blocks.make_blocks``, Python-int cursors, consecutive
        ranges; ``stride`` None packs them back to back, the
        variable-offset layout) and yields ``(parts, next word, next
        rank)``, ``parts`` this process's non-empty stripes as ``(stripe,
        batch, (word, count, base[, offset]))``, the tensors on the
        stripe's device as ``decode`` takes them
        (``models.attack.host_blocks``)."""
        st = self.stripes()
        weight = scalar_units_weight(plan)
        w, rank = start
        while True:
            parts = []
            for g in range(st.total):
                batch, w, rank = make_blocks(
                    plan, start_word=w, start_rank=rank, max_variants=lanes,
                    max_blocks=nb, fixed_stride=stride)
                if batch.total == 0:
                    if g == 0:
                        return
                    break
                if st.owned(g):
                    i = g - st.offset
                    parts.append((i, batch, host_blocks(
                        batch, nb, decode, weight, device=st.devices[i],
                        packed=stride is None)))
            yield parts, w, rank

    def _launch_stream(self, plan, step, arrs: List[dict], lanes: int,
                       nb: int, stride: Optional[int],
                       start: "Tuple[int, int]"):
        """The per-launch pipeline's dispatched rounds from ``start``:
        ``(([(batch, out), ...], cursor after it), rounds still in
        flight)``, up to ``max_in_flight`` rounds dispatched before one
        is handed on."""
        pending: deque = deque()
        for parts, w2, r2 in self._host_rounds(plan, lanes, nb, stride,
                                               step.decode, start):
            # No retry here: the drive's re-cut loop is the only
            # supervisor of the per-launch pipeline.
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("superstep.dispatch")
            outs = [(batch, step(arrs[i], *blocks))
                    for i, batch, blocks in parts]
            pending.append((outs, (w2, r2)))
            if len(pending) >= self.config.max_in_flight:
                yield pending.popleft(), len(pending)
        while pending:
            yield pending.popleft(), len(pending)

    def _drive_per_launch(self, r: _Region, step, arrs: List[dict],
                          lanes: int, nb: int, stride: Optional[int],
                          recorder, flush, state: CheckpointState,
                          last_ckpt: List[float],
                          start: "Tuple[int, int]"
                          ) -> "Generator[None, None, dict]":
        """The per-launch pipeline's crack drive over region ``r`` from
        its plan-local cursor ``start``: each round of
        :meth:`_host_rounds` run by ``step``
        (``models.attack.make_crack_step``) on its stripes, the next
        dispatched before one is consumed.  Rounds are consumed in
        chunks (the reference's ``fetch_chunk``: 1 round, doubling while
        a chunk takes under 1 s, halving past 4 s): one fetch of the
        chunk's counters, then the hit lanes of the launches with hits,
        mapped to ``(word, rank)`` through ``ops.blocks.lane_cursor``.
        ``flush`` expands the fallback words due before each hit's word
        and, at the chunk's end, those before its cursor; then the state,
        a span, the checkpoint and progress, and the machine yields (not
        after the last chunk, as in the reference).  A transient error
        re-cuts from the last consumed cursor."""
        cfg, plan, dev = self.config, r.plan, self.device
        stats = {"supersteps": 0, "launches": 0, "replays": 0, "retries": 0}
        chunk_cap = max(1, min(int(cfg.fetch_chunk),
                               ((1 << 31) - 1) // lanes))
        chunk_len = 1
        last_drain = time.monotonic()

        def drain(chunk, inflight: int) -> "Tuple[int, int]":
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("superstep.fetch")
            launched = [item for outs, _c in chunk for item in outs]
            counts = (torch.stack([out["counters"].to(dev)
                                   for _b, out in launched])
                      if launched else None)
            if dev.type == "cuda" and cfg.fetch_timeout_s:
                ready = torch.cuda.Event()
                ready.record()
                faults.await_ready(ready, cfg.fetch_timeout_s)
            counts = counts.tolist() if counts is not None else []
            self._note_fetch()
            hit_lanes = [
                torch.nonzero(out["hit"]).flatten().tolist() if nh else []
                for (_b, out), (_ne, nh) in zip(launched, counts)
            ]
            # Everything is on the host: the state moves only now, so a
            # retry from the last consumed cursor counts nothing twice.
            for (batch, _out), lanes_hit in zip(launched, hit_lanes):
                for w_row, rank in lane_cursor(plan, batch, lanes_hit):
                    flush.until(r.lo + w_row)
                    self._device_hit(r, w_row, rank, recorder, state)
            w_end, r_end = chunk[-1][1]
            flush.until(r.lo + w_end)
            ne = sum(c[0] for c in counts)
            state.n_emitted += ne
            state.cursor = SweepCursor(r.lo + w_end, r_end)
            stats["launches"] += len(launched)
            self.timeline.record_fetch(
                kind="drain", launches=len(launched), emitted=ne,
                hits=sum(c[1] for c in counts), inflight=inflight)
            self._maybe_checkpoint(state, last_ckpt)
            if cfg.progress:
                cfg.progress.update(words_done=r.lo + w_end,
                                    emitted=state.n_emitted,
                                    hits=state.n_hits)
            return w_end, r_end

        cursor = start
        attempts = 0
        while True:
            chunk: list = []
            try:
                for item, inflight in self._launch_stream(
                        plan, step, arrs, lanes, nb, stride, cursor):
                    chunk.append(item)
                    if len(chunk) < chunk_len:
                        continue
                    cursor = drain(chunk, inflight)
                    chunk = []
                    attempts = 0
                    # Grow while chunks run fast (fewer fetches), shrink
                    # when they crawl (checkpoint and progress granularity).
                    now = time.monotonic()
                    if now - last_drain < 1.0:
                        chunk_len = min(chunk_len * 2, chunk_cap)
                    elif now - last_drain > 4.0:
                        chunk_len = max(1, chunk_len // 2)
                    last_drain = now
                    yield
                if chunk:
                    cursor = drain(chunk, 0)
                break
            except Exception as exc:  # noqa: BLE001 — typed check inside
                self._retry_backoff(exc, attempts)
                attempts += 1
                stats["retries"] += 1
                flush.restart()
        stats["per_launch"] = stats["launches"]
        return stats

    def _oracle_candidates(self, row: int):
        """A fallback word's candidates in the oracle's DFS order: from the
        native engine when eligible (the same stream, faster to generate),
        else from ``oracle.engines``."""
        word = self.packed.word(row)
        substitute_all = self.spec.mode.startswith("suball")
        reverse = self.spec.mode in ("reverse", "suball-reverse")
        eng = self._native_oracle(substitute_all=substitute_all,
                                  reverse=reverse)
        if eng is not None:
            return eng.iter_word(
                word, self.spec.min_substitute, self.spec.max_substitute,
                substitute_all=substitute_all, reverse=reverse,
            )
        return iter_candidates(
            word, self.sub_map, self.spec.min_substitute,
            self.spec.max_substitute, substitute_all=substitute_all,
            reverse=reverse,
        )

    def _native_oracle(self, *, substitute_all: bool, reverse: bool):
        """The sweep's cached ``NativeDefaultOracle`` for its fallback
        words, or None (ineligible, no toolchain or ``A5_NATIVE=0``: the
        Python engines run)."""
        cached = getattr(self, "_native_oracle_cache", ())
        if cached != ():
            return cached
        from ..native.oracle_engine import (
            NativeDefaultOracle,
            available,
            default_engine_eligible,
        )

        eng = None
        if default_engine_eligible(
            self.sub_map, substitute_all=substitute_all, reverse=reverse,
            crack=False, hex_unsafe=False,
            max_substitute=self.spec.max_substitute,
        ) and available():
            eng = NativeDefaultOracle(self.sub_map)
        self._native_oracle_cache = eng
        return eng

    def _crack_word(self, recorder, state: CheckpointState):
        """Crack mode's handling of a fallback word's oracle candidates:
        hash each with ``HOST_DIGEST`` and record the ones in the digest
        list (rank = the candidate's DFS index in the oracle's stream)."""
        digest = HOST_DIGEST[self.spec.algo]

        def on_word(row: int, cands) -> None:
            n = 0
            for i, cand in enumerate(cands):
                n += 1
                dig = digest(cand)
                if dig in self._digest_lookup:
                    state.n_hits += 1
                    state.hits.append((row, i))
                    recorder.emit(HitRecord(
                        word_index=int(self.packed.index[row]),
                        variant_rank=i, candidate=cand,
                        digest_hex=dig.hex(),
                    ))
            state.n_emitted += n

        return on_word

    def _device_hit(self, r: _Region, w_local: int, rank: int, recorder,
                    state: CheckpointState) -> None:
        """Re-derive a device-flagged hit's candidate from its region's
        plan, re-verify its digest on the host, record it under its
        dictionary row."""
        cand = decode_variant(r.plan, self.ct, self.spec, w_local, rank)
        dig = HOST_DIGEST[self.spec.algo](cand)
        w_row = r.lo + w_local
        if dig not in self._digest_lookup:
            raise RuntimeError(
                f"device hit failed host re-verification: word {w_row} "
                f"rank {rank} candidate {cand!r}"
            )
        state.n_hits += 1
        state.hits.append((w_row, rank))
        recorder.emit(
            HitRecord(
                word_index=int(self.packed.index[w_row]),
                variant_rank=rank,
                candidate=cand,
                digest_hex=dig.hex(),
            )
        )


def _merge_parts(parts: List[dict]) -> dict:
    """The result's drive fields over a sweep's regions: superstep stats
    by :data:`telemetry.SUPERSTEP_MERGE`, kernel launches summed, each
    route taken once, the XLA geometry's smallest lanes and summed
    rows."""
    out: dict = {"superstep": telemetry.SUPERSTEP_MERGE.merge(
        [p["superstep"] for p in parts if "superstep" in p]),
        "kernels": {}, "routes": {}, "xla": {}}
    for p in parts:
        for k, v in p["kernels"].items():
            out["kernels"][k] = out["kernels"].get(k, 0) + v
        out["routes"].update({k: 1 for k in p["routes"]})
        x = p["xla"]
        if x:
            prev = out["xla"]
            out["xla"] = {
                "lanes": min(prev.get("lanes", x["lanes"]), x["lanes"]),
                "budget_bytes": x["budget_bytes"],
                "rows": prev.get("rows", 0) + x["rows"]}
    return out


def _stats_delta(before: Dict[str, int], after: Dict[str, int]
                 ) -> Dict[str, int]:
    """Nonzero counter deltas between two stats snapshots (a run's share
    of the process-wide schema-cache activity)."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def _distinct(arrs: List[dict]) -> List[dict]:
    """The stripes' array dicts, each once (stripes on one device share
    theirs)."""
    out: List[dict] = []
    for a in arrs:
        if not any(a is b for b in out):
            out.append(a)
    return out


def _on(stream):
    """Run on a stripe's CUDA stream (None: the current stream)."""
    return nullcontext() if stream is None else torch.cuda.stream(stream)


def _join_streams(streams, *, into_stripes: bool) -> None:
    """Order the stripes' streams after the current streams of their
    devices (``into_stripes``: before a drive, so its launches see the
    arrays uploaded there), or the current streams after the stripes'
    (after it, so memory freed on the current streams is not reused while
    a stripe still reads it)."""
    for strm in streams:
        if strm is None:
            continue
        cur = torch.cuda.current_stream(strm.device)
        if into_stripes:
            strm.wait_stream(cur)
        else:
            cur.wait_stream(strm)


def _clip(cursor: "Tuple[int, int]", hi: int) -> "Tuple[int, int]":
    """A sub-sweep's cursor: past its last word (``block_cursor``'s end
    of the range) it is ``(hi, 0)``, the next range's first word."""
    return cursor if cursor[0] < hi else (hi, 0)


def _write_rows(writer: CandidateWriter, cand: np.ndarray,
                clen: np.ndarray, lo: int, hi: int) -> int:
    """Write rows ``lo .. hi`` of an emitted-row batch as ``candidate\n``
    lines with one vectorized ragged flatten (row by row under
    ``--hex-unsafe``); returns the number of lines."""
    n = hi - lo
    if n <= 0:
        return 0
    rows, lens = cand[lo:hi], clen[lo:hi].astype(np.int64)
    if writer.hex_unsafe:
        for i in range(n):
            writer.emit(bytes(rows[i, : lens[i]]))
        return n
    w = rows.shape[1]
    buf = np.empty((n, w + 1), dtype=np.uint8)
    buf[:, :w] = rows
    buf[np.arange(n), lens] = 0x0A  # newline at each row's length
    writer.write_block(buf[np.arange(w + 1)[None, :] <= lens[:, None]]
                       .tobytes(), n)
    return n


class _FallbackPrefetcher:
    """The oracle's expansion of the fallback words on a producer thread
    (the reference's ``_FallbackPrefetcher``): while the drive's thread
    waits on device fetches, one worker expands the fallback rows from
    ``fallback_rows[start]`` on, in row order, into a bounded queue —
    candidates in chunks of :attr:`CHUNK`, at most :attr:`MAXSIZE`
    candidates queued (backpressure), an end marker after each row.  An
    exception of the producer crosses the queue and is raised again in
    :meth:`iter_row`; :meth:`close` stops the producer even when it waits
    on a full queue."""

    MAXSIZE = 8192
    CHUNK = 256
    _END = object()

    def __init__(self, sweep: "Sweep", start: int) -> None:
        import queue

        self._queue: "queue.Queue" = queue.Queue(
            maxsize=self.MAXSIZE // self.CHUNK)
        self._sweep = sweep
        self._start = start
        self._stop = False
        self._thread = threading.Thread(
            target=self._produce, name="a5-fallback-oracle", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless :meth:`close` was called (False)."""
        import queue

        while not self._stop:
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        rows = self._sweep.fallback_rows
        try:
            for idx in range(self._start, len(rows)):
                cands = self._sweep._oracle_candidates(rows[idx])
                try:
                    while True:
                        chunk = list(itertools.islice(cands, self.CHUNK))
                        if chunk and not self._put(chunk):
                            return
                        if len(chunk) < self.CHUNK:
                            break
                finally:
                    close = getattr(cands, "close", None)
                    if close is not None:
                        close()
                if not self._put(self._END):
                    return
        except BaseException as e:  # noqa: BLE001 — raised in iter_row
            self._put(e)

    def iter_row(self):
        """The next fallback row's candidates, in the oracle's DFS order;
        called once per row, in row order.  Raises what the producer
        raised."""
        while True:
            item = self._queue.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield from item

    def close(self) -> None:
        """Stop the producer and wait for its thread to end."""
        self._stop = True
        self._thread.join()


class _FallbackFlush:
    """The oracle route of a sweep's fallback words, flushed in word order:
    :meth:`until` hands every not yet flushed fallback word below a row to
    ``on_word(row, candidates)`` (crack mode: hash and look up; candidates
    mode: write), which counts them into the state.  The candidates come
    from a :class:`_FallbackPrefetcher` started at ``state.fallback_done``
    (the port's oracle, ``Sweep._oracle_candidates``: native when
    eligible), which expands the next rows while the device runs;
    ``state.fallback_done`` moves only when a row is consumed, so
    checkpoints stay at consumed boundaries.  :meth:`restart` (a drive's
    retry) starts a new producer at ``fallback_done``; :meth:`close` ends
    the producer's thread."""

    def __init__(self, sweep: Sweep, state: CheckpointState,
                 on_word) -> None:
        self.sweep, self.state, self.on_word = sweep, state, on_word
        self._prefetch: Optional[_FallbackPrefetcher] = None

    def _rows(self) -> _FallbackPrefetcher:
        if self._prefetch is None:
            self._prefetch = _FallbackPrefetcher(self.sweep,
                                                 self.state.fallback_done)
        return self._prefetch

    def until(self, word_row: int) -> None:
        st, rows = self.state, self.sweep.fallback_rows
        while st.fallback_done < len(rows) and \
                rows[st.fallback_done] < word_row:
            self.on_word(rows[st.fallback_done], self._rows().iter_row())
            st.fallback_done += 1

    def restart(self) -> None:
        """Drop the producer and what it queued; the next :meth:`until`
        starts a new one at ``state.fallback_done``."""
        self.close()

    def close(self) -> None:
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
