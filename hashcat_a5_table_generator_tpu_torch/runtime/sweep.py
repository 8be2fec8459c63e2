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

Substitute-all plans route each word three ways, as the reference does:
device-clean words and cascade-closed words run on the device; words no
plan splices exactly (``plan.fallback``) take no blocks and are expanded on
the host by the oracle — the native C++ engine (``native.oracle_engine``)
where ``default_engine_eligible`` admits the table, else the Python
generators of ``oracle.engines``; the same candidates in the same order —
hashed with ``HOST_DIGEST`` and looked up in the digest list.  Their hits
carry the oracle's DFS index as rank and interleave in word order: a
fallback word is flushed before the first device hit of a later word, and
at each superstep boundary before the boundary's word.  Candidates mode interleaves them the same
way, at their word position in the stream.
"""

from __future__ import annotations

import itertools
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.attack import (
    AttackSpec,
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
from ..ops.membership import HostDigestLookup, build_digest_set
from ..ops.packing import PackedWords, pack_words, piece_schema_for
from ..oracle.engines import iter_candidates
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
from .env import pipeline_enabled, superstep_enabled
from .progress import ProgressReporter
from .sinks import CandidateWriter, HitRecord, HitRecorder

#: Supersteps in flight: two alternating buffer sets, so superstep N+1 is
#: queued before superstep N's fetch is waited on.
_DEPTH = 2

#: The most consecutive recoveries from a transient device error inside one
#: drive (the count resets at every consumed fetch), and the base of the
#: exponential backoff between them (base * 2^attempt seconds).
RETRY_ATTEMPTS = 2
RETRY_BACKOFF_S = 0.05

#: Device memory the XLA route's per-launch intermediates may take, by
#: device type: the route cuts its lane count to fit (the kernel routes'
#: launches hold no per-candidate buffers and keep the configured lanes).
XLA_BUDGET_BYTES = {"cuda": 8 << 30, "cpu": 1 << 30}


def xla_row_bytes(plan) -> int:
    """Estimated device bytes one candidate row of the XLA route holds at
    its peak: the schema-less splice's int32 ``[L]`` unit fields and
    ``[W]`` column fields (int64 gather indices among them), the per-slot
    decode and plan-field gathers, and the candidate buffer."""
    length_axis = int(plan.tokens.shape[1])
    segments = int(getattr(plan, "num_segments", 0) or 0)
    return (32 * length_axis + 48 * int(plan.out_width)
            + 40 * int(plan.num_slots) + 16 * segments + 256)


def xla_lanes(plan, lanes: int, stride: int, cands_per_lane: int,
              budget: int) -> int:
    """The XLA route's lanes per launch: the configured ``lanes``, cut to
    a multiple of ``stride`` whose candidate rows fit ``budget`` bytes (at
    least one block).  Launch geometry never changes the stream."""
    fit = budget // (xla_row_bytes(plan) * cands_per_lane)
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
    lanes: Optional[int] = None  # hash lanes per launch; None = 2^22 on
    #   cuda, 2^17 on cpu
    num_blocks: Optional[int] = None  # blocks per launch; None = lanes/128
    #   (fixed stride: every block owns lanes/num_blocks lanes)
    superstep: Optional[int] = None  # launches per superstep; None =
    #   fetch_chunk; 0 selects the per-launch pipeline
    pair: "Optional[int | str]" = None  # pair-lane tier: None/'auto'
    #   engages when the schema allows; 0/'off' keeps K=1
    superstep_hit_cap: int = 4096  # device hit-buffer slots per superstep
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

    def resolve(self, dev: torch.device) -> "tuple[int, int, int]":
        """``(lanes, num_blocks, steps)`` for a device."""
        lanes = self.lanes or (1 << 22 if dev.type == "cuda" else 1 << 17)
        nb = self.num_blocks or max(1, lanes // 128)
        if lanes % nb:
            raise ValueError(
                f"fixed-stride layout needs lanes ({lanes}) divisible by "
                f"blocks ({nb})"
            )
        return lanes, nb, int(self.superstep or self.fetch_chunk)

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
    wall_s: float = 0.0  # the whole run: schema, uploads, drive
    drive_s: float = 0.0  # the drive alone (superstep or per-launch)
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
    #: sweeps (buckets) by route: ``piece``, ``bytescan``, ``xla``
    routes: Dict[str, int] = field(default_factory=dict)
    #: the XLA route's launch geometry: ``lanes`` per launch (the
    #: smallest over buckets), the ``budget_bytes`` it was cut to and the
    #: candidate ``rows`` its launches held
    xla: Dict[str, int] = field(default_factory=dict)


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
        self.spec = spec
        self.sub_map = sub_map
        self.config = config or SweepConfig()
        faults.ensure_env()  # A5GEN_FAULTS (unset = nothing armed)
        self.device = resolve_device(self.config.device)
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
        self.plan = build_plan(spec, self.ct, self.packed)
        #: oracle-routed word rows, in word order
        self.fallback_rows: List[int] = [
            int(i) for i in np.nonzero(self.plan.fallback)[0]
        ]
        closed = getattr(self.plan, "closed", None)
        n_closed = int(closed.sum()) if closed is not None else 0
        self.routing = {
            "device_clean": self.n_words - n_closed - len(self.fallback_rows),
            "device_closed": n_closed,
            "oracle_fallback": len(self.fallback_rows),
        }
        set_routing = getattr(self.config.progress, "set_routing", None)
        if set_routing is not None:
            set_routing(self.routing)
        #: one span per consumed fetch (``--metrics-json`` reads it)
        self.timeline = telemetry.SpanTimeline()
        self._fingerprint: Optional[str] = None
        # The route: a fused kernel where the reference's gate takes the
        # plan (the piece kernel with a per-slot schema, else the
        # byte-scan tier), else the XLA expand + hash route, which also
        # splices with the schema when there is one.  The refusal left (a
        # schema the piece kernel's descriptors cannot hold) is found
        # here, before any launch, and raised by the run (BucketedSweep
        # checks every bucket first).  A bucket whose block index would
        # pass 2^31 blocks runs as sub-sweeps over word ranges
        # (word_ranges); one with a word of 2^30 rows or more, the
        # per-launch pipeline (per_launch).
        self.config.resolve(self.device)
        self.device_words = self.n_words > len(self.fallback_rows)
        self.pieces = None
        self.bytescan = None
        self.route = None
        #: why this package cannot run the sweep, by mode (None = it can)
        self.refusal: Dict[str, Optional[str]] = {
            "crack": None, "candidates": None}
        # The schema is part of the run: SweepResult.wall_s counts it.
        self._schema_s = 0.0
        if self.device_words:
            t0 = time.monotonic()
            self.pieces = piece_schema_for(self.plan, self.ct)
            self._schema_s = time.monotonic() - t0
            if opts_for(spec, self.plan, self.ct) is None:
                self.route = "xla"
            elif self.pieces is None:
                self.route = "bytescan"
                self.bytescan = bytescan_tier(self.plan)
            else:
                self.route = "piece"
                why = schema_refusal(self.plan, self.pieces)
                if why is not None:
                    self.refusal["crack"] = f"kernel not ported for: {why}"

    def per_launch(self, rank_stride: int) -> bool:
        """Whether the sweep takes the per-launch pipeline at
        ``rank_stride``, as the reference does: when the superstep is off
        (``SweepConfig.superstep_on``), or when no int32-safe block index
        exists (``ops.blocks.superstep_index`` None: a word of 2^30 rows
        or more, a huge word, an index past int64)."""
        if not self.config.superstep_on():
            return True
        ranges = self.word_ranges(rank_stride)
        return not ranges or superstep_index(self.plan, rank_stride,
                                             ranges[0]) is None

    def word_ranges(self, rank_stride: int) -> "List[tuple]":
        """The sub-sweeps this bucket runs at ``rank_stride``: consecutive
        word ranges, each with an int32-safe block index
        (``ops.blocks.word_ranges``); one range unless the bucket's index
        passes ``ops.blocks.SPLIT_BLOCKS``."""
        return word_ranges(self.plan, rank_stride)

    def _index_range(self, arrays: dict, rank_stride: int, words: tuple):
        """Point ``arrays`` at the block index of word range ``words``
        (one sub-sweep); returns that index."""
        idx = superstep_index(self.plan, rank_stride, words)
        arrays["cum"] = torch.as_tensor(idx[0], device=self.device)
        arrays["total"] = idx[2]
        return idx

    def check(self, mode: str = "crack") -> None:
        """Raise ``NotImplementedError`` when this package cannot run the
        sweep in ``mode`` (``crack`` or ``candidates``)."""
        if self.refusal[mode] is not None:
            raise NotImplementedError(self.refusal[mode])

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
                "+windowed" if getattr(self.plan, "windowed", False) else ""
            ) + ("+closed" if self.routing["device_closed"] else "")
            self._fingerprint = sweep_fingerprint(
                mode_token, spec.algo, spec.min_substitute,
                spec.max_substitute, self.sub_map, self.packed,
                self.digests, digest_lookup=self._digest_lookup,
            )
        return self._fingerprint

    def _load_state(self, resume: bool) -> CheckpointState:
        """The run's starting state: the checkpoint at
        ``SweepConfig.checkpoint_path`` when ``resume`` and the file exists
        (its fingerprint must be this sweep's), else a fresh state."""
        path = self.config.checkpoint_path
        if not path:
            return CheckpointState(fingerprint="")
        if resume:
            state = load_checkpoint(path, self.fingerprint)
            if state is not None:
                # A streaming checkpoint's chunk marker means nothing to a
                # whole-dictionary sweep: the cursor is global either way.
                state.stream = None
                return state
        return CheckpointState(fingerprint=self.fingerprint)

    def _start(self, state: CheckpointState, crack: bool) -> None:
        """Seed the progress windows with a resumed run's counts: they
        belong to an earlier process, not this one's first rates."""
        progress = self.config.progress
        if progress is None:
            return
        progress.seed_emitted(state.n_emitted)
        seed_hits = getattr(progress, "seed_hits", None)
        if crack and seed_hits is not None:
            seed_hits(state.n_hits)

    def _set_geometry(self, lanes: int, nb: int) -> None:
        """Stamp the resolved launch geometry into the progress lines (the
        reference's ``geometry`` key and its provenance: ``explicit``
        when the caller set the lanes, else ``default``)."""
        set_geometry = getattr(self.config.progress, "set_geometry", None)
        if set_geometry is None:
            return
        cfg, dev = self.config, self.device
        set_geometry({
            "lanes": lanes, "num_blocks": nb, "block_stride": lanes // nb,
            "superstep": cfg.superstep, "pair": cfg.pair,
            "device_kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "pod": None,
        }, "explicit" if cfg.lanes else "default")

    def _normalize(self, cursor: SweepCursor) -> "Tuple[int, int]":
        """The cursor as the block cutter normalizes it: past fallback
        words and finished words."""
        plan, (w, rank) = self.plan, (cursor.word, cursor.rank)
        while w < plan.batch and (plan.fallback[w]
                                  or rank >= plan.n_variants[w]):
            w, rank = w + 1, 0
        return w, rank

    def _start_block(self, cum: np.ndarray, rank_stride: int,
                     w: int, rank: int) -> int:
        """The block a resumed drive starts at, ``cum[w] + rank //
        rank_stride``; it must decode back to the cursor."""
        b0 = int(cum[w]) + rank // rank_stride
        got = block_cursor(self.plan, rank_stride, cum, b0)
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
        (``faults.supervise_retry``: :data:`RETRY_ATTEMPTS`,
        :data:`RETRY_BACKOFF_S`).  Called from an ``except`` block."""
        faults.supervise_retry(
            exc, attempts, attempts_budget=RETRY_ATTEMPTS,
            backoff_s=RETRY_BACKOFF_S, label="the sweep drive",
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

    def _rederive_hit(self, w_row: int, rank: int) -> bytes:
        """A checkpointed hit's candidate: decoded from its rank, or, for
        a fallback word, the oracle's ``rank``-th candidate."""
        if self.plan.fallback[w_row]:
            cands = self._oracle_candidates(w_row)
            try:
                return next(itertools.islice(cands, rank, None))
            finally:
                close = getattr(cands, "close", None)
                if close is not None:
                    close()
        return decode_variant(self.plan, self.ct, self.spec, w_row, rank)

    def _replay_hits(self, state: CheckpointState, recorder) -> None:
        """Replay a checkpoint's hits into ``recorder``, so a resumed run
        reports the hit list an uninterrupted one would."""
        digest = HOST_DIGEST[self.spec.algo]
        for w_row, rank in state.hits:
            cand = self._rederive_hit(w_row, rank)
            recorder.emit(HitRecord(
                word_index=int(self.packed.index[w_row]), variant_rank=rank,
                candidate=cand, digest_hex=digest(cand).hex()))

    # ------------------------------------------------------------------
    # Crack mode
    # ------------------------------------------------------------------

    def run_crack(self, recorder: Optional[HitRecorder] = None, *,
                  resume: bool = True) -> SweepResult:
        """Fused expand → hash → membership on the device; only hits
        return to the host.  With ``SweepConfig.checkpoint_path`` the
        sweep checkpoints and, given ``resume``, starts from the file's
        cursor, its hits replayed into ``recorder`` first."""
        self.check()
        t0 = time.monotonic()
        cfg = self.config
        recorder = recorder if recorder is not None else HitRecorder()
        state = self._load_state(resume)
        self._start(state, crack=True)
        self._replay_hits(state, recorder)
        last_ckpt = [t0]
        flush = _FallbackFlush(self, state, self._crack_word(recorder, state))
        device = {}
        try:
            if self.device_words:
                device = self._crack_device(recorder, flush, state,
                                            last_ckpt)
            flush.until(self.n_words)
        finally:
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
            wall_s=time.monotonic() - t0 + self._schema_s,
            routing=dict(self.routing),
            **device,
        )

    def _crack_device(self, recorder, flush, state: CheckpointState,
                      last_ckpt: List[float]) -> dict:
        """The device half of :meth:`run_crack`, from the state's cursor;
        returns the result's drive fields."""
        spec, plan, cfg, dev = self.spec, self.plan, self.config, self.device
        lanes, nb, steps = cfg.resolve(dev)
        stride = lanes // nb
        pieces = self.pieces
        pair_k = None
        if cfg.pair is None or str(cfg.pair).lower() not in (
            "0", "off", "no", "false"
        ):
            pair_k = pair_for(spec, plan, pieces, block_stride=stride)
        if pair_k is None and str(cfg.pair).lower() in ("on", "1", "2",
                                                        "true"):
            print("a5gen: warning: pair requested (--pair on) but this "
                  "plan/config is not pair-eligible (schema gate, windowed "
                  "decode, or hash-block count); running K=1",
                  file=sys.stderr)
        rank_stride = stride * (pair_k or 1)
        if pair_k is not None and self.per_launch(rank_stride):
            # The per-launch step runs K=1, as the reference's does.
            pair_k, rank_stride = None, stride
        per_launch = self.per_launch(rank_stride)
        # A resumed cursor must sit on a block boundary of the superstep
        # drive: a pair-misaligned but K=1-aligned one runs the K=1
        # superstep tier, any other misalignment the per-launch pipeline.
        w, rank = self._normalize(state.cursor)
        if not per_launch and w < plan.batch and rank % rank_stride:
            if pair_k is not None and rank % stride == 0:
                pair_k, rank_stride = None, stride
            else:
                per_launch = True
        ranges = [] if per_launch else self.word_ranges(rank_stride)
        idx = None if per_launch else superstep_index(plan, rank_stride,
                                                      ranges[0])
        digest_set = build_digest_set(self.digests, spec.algo)
        decode, pack_cb = decode_for(plan)
        self._set_geometry(lanes, nb)
        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("device.init")
        xla_geom: Dict[str, int] = {}
        if self.route == "xla":
            budget = XLA_BUDGET_BYTES[dev.type]
            lanes = xla_lanes(plan, lanes, stride, pair_k or 1, budget)
            nb = lanes // stride
            xla_geom = {"lanes": lanes, "budget_bytes": budget}
            arrays = xla_arrays(plan, self.ct, pieces, digest_set, idx,
                                device=dev)
            tier = f"buffer_hash/{spec.algo}"
        else:
            arrays = device_arrays(
                plan, pieces, digest_set, idx, device=dev, ct=self.ct,
                bytescan=self.bytescan,
            )
            tier = (self.bytescan.name if self.bytescan is not None else
                    launch_key(spec.algo, pieces, decode,
                               pair_k is not None).split("/")[0])
        kw = dict(
            num_lanes=lanes, out_width=int(plan.out_width),
            block_stride=stride, num_blocks=nb, pieces=pieces,
            pair_k=pair_k, decode=decode, pack_cb=pack_cb,
            k_opts=k_vals_for(plan), bytescan=self.bytescan,
            xla=self.route == "xla",
            windowed=bool(getattr(plan, "windowed", False)),
            radix2=k_opts_for(plan) == 1,
        )
        t_drive = time.monotonic()
        if per_launch:
            stats = self._drive_per_launch(
                make_crack_step(spec, **kw), arrays, lanes, nb, stride,
                recorder, flush, state, last_ckpt, (w, rank))
            steps = 1
        else:
            # The superstep's emitted counter is int32: cap steps so every
            # lane emitting cannot reach 2^31.
            steps = max(1, min(steps, ((1 << 31) - 1)
                               // (lanes * (pair_k or 1))))
            body = make_superstep_body(spec, **kw)
            stats = {"supersteps": 0, "launches": 0, "replays": 0,
                     "retries": 0}
            for lo, hi in ranges:
                # One sub-sweep per word range, in word order: its own
                # block index over the same resident tables; the ranges
                # before the cursor are done.
                if hi <= w:
                    continue
                cum = self._index_range(arrays, rank_stride, (lo, hi))[0]
                b_start = (self._start_block(cum, rank_stride, w, rank)
                           if lo <= w else 0)
                part = self._drive(
                    body, arrays, nb, steps, recorder, flush, state,
                    last_ckpt, b_start,
                    lambda b, cum=cum, hi=hi: _clip(
                        block_cursor(plan, rank_stride, cum, b), hi))
                for k in stats:
                    stats[k] += part[k]
        stats["launches_per_fetch"] = steps
        stats["pair"] = pair_k or 0
        if xla_geom:
            xla_geom["rows"] = stats["launches"] * lanes * (pair_k or 1)
        return dict(
            drive_s=time.monotonic() - t_drive,
            superstep=stats,
            kernels={tier: stats["launches"]},
            routes={self.route: 1},
            xla=xla_geom,
        )

    # ------------------------------------------------------------------
    # Candidates mode
    # ------------------------------------------------------------------

    def run_candidates(self, writer: CandidateWriter, *,
                       resume: bool = True) -> SweepResult:
        """Stream every candidate to ``writer`` in word order, rank order
        within a word (per-word multiset parity with the oracle): the XLA
        expansion on the device, one launch at a time, its emitted rows
        compacted on the device before the copy to the host; fallback
        words through the oracle at their word position.  Resume is
        at-least-once, as in the reference: the candidates written after
        the last checkpoint repeat."""
        self.check("candidates")
        t0 = time.monotonic()
        spec, plan, cfg, dev = self.spec, self.plan, self.config, self.device
        state = self._load_state(resume)
        self._start(state, crack=False)
        last_ckpt = [t0]

        def on_word(row: int, cands) -> None:
            n = 0
            for cand in cands:
                writer.emit(cand)
                n += 1
            state.n_emitted += n

        flush = _FallbackFlush(self, state, on_word)
        n_launches = 0
        drive_s = 0.0
        xla_geom: Dict[str, int] = {}
        try:
            if self.device_words:
                lanes, nb, _ = cfg.resolve(dev)
                stride = lanes // nb
                w, rank = self._normalize(state.cursor)
                per_launch = self.per_launch(stride) or (
                    w < plan.batch and rank % stride != 0)
                ranges = [] if per_launch else self.word_ranges(stride)
                idx = None if per_launch else superstep_index(
                    plan, stride, ranges[0])
                budget = XLA_BUDGET_BYTES[dev.type]
                lanes = xla_lanes(plan, lanes, stride, 1, budget)
                nb = lanes // stride
                self._set_geometry(lanes, nb)
                if faults.ACTIVE is not None:
                    faults.ACTIVE.fire("device.init")
                arrays = xla_arrays(plan, self.ct, self.pieces, None, idx,
                                    device=dev)
                kw = dict(num_lanes=lanes, out_width=int(plan.out_width),
                          block_stride=stride, pieces=self.pieces,
                          windowed=bool(getattr(plan, "windowed", False)),
                          radix2=k_opts_for(plan) == 1)

                def launches():
                    """Each launch's emitted rows and the cursor it
                    leaves: blocks cut on the host (per-launch pipeline)
                    or on the device, one word range after the other."""
                    if per_launch:
                        step = make_candidates_step(spec, **kw)
                        for _batch, blocks, w2, r2 in self._host_cuts(
                                lanes, nb, stride, step.decode, (w, rank)):
                            yield self._dispatch(
                                lambda: step(arrays, *blocks)), (w2, r2)
                        return
                    body = make_candidates_body(spec, num_blocks=nb, **kw)
                    for w_lo, w_hi in ranges:
                        # One sub-sweep per word range, in word order.
                        if w_hi <= w:
                            continue
                        cum = self._index_range(arrays, stride,
                                                (w_lo, w_hi))[0]
                        total = arrays["total"]
                        b_start = (self._start_block(cum, stride, w, rank)
                                   if w_lo <= w else 0)
                        for b0 in range(b_start, total, nb):
                            yield self._dispatch(
                                lambda: body(arrays, b0)), _clip(
                                block_cursor(plan, stride, cum,
                                             min(b0 + nb, total)), w_hi)

                t_drive = time.monotonic()
                for out, (w_end, r_end) in launches():
                    cand, clen, wrow = (t.cpu().numpy() for t in out)
                    n_launches += 1
                    lo = 0
                    rows = self.fallback_rows
                    # Fallback words inside this launch's word range go
                    # between the rows of the words around them.
                    while state.fallback_done < len(rows) and len(wrow) \
                            and rows[state.fallback_done] < int(wrow[-1]):
                        cut = int(np.searchsorted(
                            wrow, rows[state.fallback_done]))
                        state.n_emitted += _write_rows(writer, cand, clen,
                                                       lo, cut)
                        lo = cut
                        flush.until(rows[state.fallback_done] + 1)
                    state.n_emitted += _write_rows(writer, cand, clen, lo,
                                                   len(clen))
                    flush.until(w_end)
                    state.cursor = SweepCursor(w_end, r_end)
                    self.timeline.record_fetch(kind="launch", launches=1)
                    self._maybe_checkpoint(state, last_ckpt,
                                           before_save=writer.flush)
                    if cfg.progress:
                        cfg.progress.update(words_done=w_end,
                                            emitted=state.n_emitted, hits=0)
                drive_s = time.monotonic() - t_drive
                xla_geom = {"lanes": lanes, "budget_bytes": budget,
                            "rows": n_launches * lanes}
            flush.until(self.n_words)
        finally:
            state.wall_s += time.monotonic() - t0
        state.cursor = SweepCursor(word=self.n_words, rank=0)
        self._maybe_checkpoint(state, last_ckpt, force=True,
                               before_save=writer.flush)
        if cfg.progress:
            cfg.progress.final(words_done=self.n_words,
                               emitted=state.n_emitted, hits=0)
        if not self.device_words:
            return SweepResult(
                n_emitted=state.n_emitted, words_done=self.n_words,
                wall_s=time.monotonic() - t0,
                routing=dict(self.routing))
        return SweepResult(
            n_emitted=state.n_emitted,
            words_done=self.n_words,
            wall_s=time.monotonic() - t0 + self._schema_s,
            drive_s=drive_s,
            routing=dict(self.routing),
            kernels={"expand": n_launches},
            routes={"xla": 1},
            xla=xla_geom,
        )

    # ------------------------------------------------------------------
    # The drives
    # ------------------------------------------------------------------

    def _drive(self, body, arrays, nb: int, steps: int, recorder, flush,
               state: CheckpointState, last_ckpt: List[float],
               b_start: int, cursor_at) -> dict:
        """The double-buffered superstep loop from block ``b_start``;
        returns its stats.  At each consumed (lagged) boundary: the
        superstep's hits (re-run first when they overflowed the buffer),
        ``flush`` to the boundary's word, the state's cursor
        (``cursor_at(end block)``) and counts, a span, the checkpoint and
        progress.  A transient error at dispatch or fetch drops the
        in-flight supersteps, rebuilds the buffer sets and re-dispatches
        from the last consumed boundary."""
        cfg, dev = self.config, self.device
        total = arrays["total"]
        hit_cap = int(cfg.superstep_hit_cap)
        # A5GEN_PIPELINE=off: one superstep in flight, its fetch waited on
        # before the next dispatch.
        depth = _DEPTH if pipeline_enabled() else 1

        def buffer_sets() -> list:
            return [(superstep_buffers(hit_cap, device=dev),
                     _Fetch(hit_cap, dev)) for _ in range(depth)]

        free = buffer_sets()
        inflight: deque = deque()
        stats = {"supersteps": 0, "launches": 0, "replays": 0, "retries": 0}
        b0 = consumed = b_start
        attempts = 0
        while b0 < total or inflight:
            try:
                while b0 < total and len(inflight) < depth:
                    if faults.ACTIVE is not None:
                        faults.ACTIVE.fire("superstep.dispatch")
                    # The tail superstep runs only the launches it needs.
                    n_steps = min(steps, -(-(total - b0) // nb))
                    bufs, fetch = free.pop()
                    fetch.start(body(arrays, b0, n_steps, bufs))
                    inflight.append((b0, n_steps, bufs, fetch,
                                     time.monotonic()))
                    b0 += n_steps * nb
                sb0, n_steps, bufs, fetch, disp_t = inflight.popleft()
                if faults.ACTIVE is not None:
                    faults.ACTIVE.fire("superstep.fetch")
                ne, nh = fetch.wait(cfg.fetch_timeout_s)
            except Exception as exc:  # noqa: BLE001 — typed check inside
                self._retry_backoff(exc, attempts)
                attempts += 1
                stats["retries"] += 1
                inflight.clear()
                free = buffer_sets()
                b0 = consumed
                continue
            attempts = 0
            end = min(sb0 + n_steps * nb, total)
            consumed = end
            hits_src = fetch.host
            replayed = nh > hit_cap
            if replayed:
                # Overflow: the capped buffer dropped entries.  Re-run the
                # same blocks into a buffer that holds them all (the
                # superstep is a pure function of its cursor), before the
                # boundary is checkpointed.
                stats["replays"] += 1
                big = superstep_buffers(nh, device=dev)
                replay = body(arrays, sb0, n_steps, big)
                hits_src = {k: v.cpu() for k, v in replay.items()}
                if int(hits_src["counters"][1]) != nh:
                    raise RuntimeError("superstep replay disagrees with "
                                       "its first run")
            if nh:
                hw = hits_src["hit_word"][:nh].tolist()
                hr = hits_src["hit_rank"][:nh].tolist()
                for w_row, rank in sorted(zip(hw, hr)):
                    flush.until(int(w_row))
                    self._device_hit(int(w_row), int(rank), recorder, state)
            w_end, r_end = cursor_at(end)
            flush.until(w_end)
            state.n_emitted += ne
            state.cursor = SweepCursor(w_end, r_end)
            stats["supersteps"] += 1
            stats["launches"] += n_steps
            free.append((bufs, fetch))
            with telemetry.profiler_span("a5.superstep.consume"):
                self.timeline.record_fetch(
                    kind="superstep", index=stats["supersteps"],
                    dispatched_at=disp_t, inflight=len(inflight),
                    launches=n_steps, emitted=ne, hits=nh,
                    hit_occupancy=min(nh, hit_cap) / max(hit_cap, 1),
                    replayed=replayed,
                )
            self._maybe_checkpoint(state, last_ckpt)
            if cfg.progress:
                cfg.progress.update(words_done=w_end,
                                    emitted=state.n_emitted,
                                    hits=state.n_hits)
        return stats

    def _host_cuts(self, lanes: int, nb: int, stride: int, decode: str,
                   start: "Tuple[int, int]"):
        """The per-launch pipeline's launches from cursor ``start``, in
        cursor order: each launch's blocks cut on the host
        (``ops.blocks.make_blocks``, Python-int cursors) — ``(batch,
        (word, count, base), next word, next rank)``, the tensors on the
        sweep's device as ``decode`` takes them
        (``models.attack.host_blocks``)."""
        weight = scalar_units_weight(self.plan)
        w, rank = start
        while True:
            batch, w, rank = make_blocks(
                self.plan, start_word=w, start_rank=rank, max_variants=lanes,
                max_blocks=nb, fixed_stride=stride)
            if batch.total == 0:
                return
            yield batch, host_blocks(batch, nb, decode, weight,
                                     device=self.device), w, rank

    def _launch_stream(self, step, arrays, lanes: int, nb: int, stride: int,
                       start: "Tuple[int, int]"):
        """The per-launch pipeline's dispatched launches from ``start``:
        ``((batch, out, cursor after it), launches still in flight)``, the
        next launch dispatched before one is handed on."""
        pending: deque = deque()
        for batch, blocks, w2, r2 in self._host_cuts(lanes, nb, stride,
                                                    step.decode, start):
            # No retry here: the drive's re-cut loop is the only
            # supervisor of the per-launch pipeline.
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("superstep.dispatch")
            out = step(arrays, *blocks)
            pending.append((batch, out, (w2, r2)))
            if len(pending) >= _DEPTH:
                yield pending.popleft(), len(pending)
        while pending:
            yield pending.popleft(), len(pending)

    def _drive_per_launch(self, step, arrays, lanes: int, nb: int,
                          stride: int, recorder, flush,
                          state: CheckpointState, last_ckpt: List[float],
                          start: "Tuple[int, int]") -> dict:
        """The per-launch pipeline's crack drive from cursor ``start``:
        each launch of :meth:`_host_cuts` run by ``step``
        (``models.attack.make_crack_step``), the next dispatched before
        one is consumed.  Launches are consumed in chunks (the
        reference's ``fetch_chunk``: 1 launch, doubling while a chunk
        takes under 1 s, halving past 4 s): one fetch of the chunk's
        counters, then the hit lanes of the launches with hits, mapped to
        ``(word, rank)`` through ``ops.blocks.lane_cursor``.  ``flush``
        expands the fallback words due before each hit's word and, at the
        chunk's end, those before its cursor; then the state, a span, the
        checkpoint and progress.  A transient error re-cuts from the last
        consumed cursor."""
        cfg, plan = self.config, self.plan
        stats = {"supersteps": 0, "launches": 0, "replays": 0, "retries": 0}
        chunk_cap = max(1, min(int(cfg.fetch_chunk),
                               ((1 << 31) - 1) // lanes))
        chunk_len = 1
        last_drain = time.monotonic()

        def drain(chunk, inflight: int) -> "Tuple[int, int]":
            if faults.ACTIVE is not None:
                faults.ACTIVE.fire("superstep.fetch")
            counts = torch.stack([out["counters"] for _b, out, _c in chunk])
            if self.device.type == "cuda" and cfg.fetch_timeout_s:
                ready = torch.cuda.Event()
                ready.record()
                faults.await_ready(ready, cfg.fetch_timeout_s)
            counts = counts.tolist()
            hit_lanes = [
                torch.nonzero(out["hit"]).flatten().tolist() if nh else []
                for (_b, out, _c), (_ne, nh) in zip(chunk, counts)
            ]
            # Everything is on the host: the state moves only now, so a
            # retry from the last consumed cursor counts nothing twice.
            for (batch, _out, _c), lanes_hit in zip(chunk, hit_lanes):
                for w_row, rank in lane_cursor(plan, batch, lanes_hit):
                    flush.until(w_row)
                    self._device_hit(w_row, rank, recorder, state)
            w_end, r_end = chunk[-1][2]
            flush.until(w_end)
            ne = sum(c[0] for c in counts)
            state.n_emitted += ne
            state.cursor = SweepCursor(w_end, r_end)
            stats["launches"] += len(chunk)
            self.timeline.record_fetch(
                kind="drain", launches=len(chunk), emitted=ne,
                hits=sum(c[1] for c in counts), inflight=inflight)
            self._maybe_checkpoint(state, last_ckpt)
            if cfg.progress:
                cfg.progress.update(words_done=w_end,
                                    emitted=state.n_emitted,
                                    hits=state.n_hits)
            return w_end, r_end

        cursor = start
        attempts = 0
        while True:
            chunk: list = []
            try:
                for item, inflight in self._launch_stream(
                        step, arrays, lanes, nb, stride, cursor):
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
                if chunk:
                    cursor = drain(chunk, 0)
                break
            except Exception as exc:  # noqa: BLE001 — typed check inside
                self._retry_backoff(exc, attempts)
                attempts += 1
                stats["retries"] += 1
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

    def _device_hit(self, w_row: int, rank: int, recorder,
                    state: CheckpointState) -> None:
        """Re-derive a device-flagged hit's candidate, re-verify its
        digest on the host, record it."""
        cand = decode_variant(self.plan, self.ct, self.spec, w_row, rank)
        dig = HOST_DIGEST[self.spec.algo](cand)
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


class _FallbackFlush:
    """The oracle route of a sweep's fallback words, flushed in word order:
    :meth:`until` expands every not yet expanded fallback word below a row
    through the port's oracle (``Sweep._oracle_candidates``: native when
    eligible) and hands its candidates to ``on_word(row, candidates)``
    (crack mode: hash and look up; candidates mode: write), which counts
    them into the state; ``state.fallback_done`` is the words flushed."""

    def __init__(self, sweep: Sweep, state: CheckpointState,
                 on_word) -> None:
        self.sweep, self.state, self.on_word = sweep, state, on_word

    def until(self, word_row: int) -> None:
        sw, st, rows = self.sweep, self.state, self.sweep.fallback_rows
        while st.fallback_done < len(rows) and \
                rows[st.fallback_done] < word_row:
            row = rows[st.fallback_done]
            self.on_word(row, sw._oracle_candidates(row))
            st.fallback_done += 1
