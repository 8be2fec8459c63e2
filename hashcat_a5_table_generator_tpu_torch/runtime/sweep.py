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

import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

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
from .env import pipeline_enabled, superstep_enabled
from .sinks import CandidateWriter, HitRecord, HitRecorder

#: Supersteps in flight: two alternating buffer sets, so superstep N+1 is
#: queued before superstep N's fetch is waited on.
_DEPTH = 2

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
    emitted)."""

    device: str = "cuda"  # "cuda" or "cpu"; never chosen implicitly
    lanes: Optional[int] = None  # hash lanes per launch; None = 2^22 on
    #   cuda, 2^17 on cpu
    num_blocks: Optional[int] = None  # blocks per launch; None = lanes/128
    #   (fixed stride: every block owns lanes/num_blocks lanes)
    superstep: Optional[int] = None  # launches per superstep; None = 16;
    #   0 selects the per-launch pipeline
    pair: "Optional[int | str]" = None  # pair-lane tier: None/'auto'
    #   engages when the schema allows; 0/'off' keeps K=1
    superstep_hit_cap: int = 4096  # device hit-buffer slots per superstep

    def resolve(self, dev: torch.device) -> "tuple[int, int, int]":
        """``(lanes, num_blocks, steps)`` for a device."""
        lanes = self.lanes or (1 << 22 if dev.type == "cuda" else 1 << 17)
        nb = self.num_blocks or max(1, lanes // 128)
        if lanes % nb:
            raise ValueError(
                f"fixed-stride layout needs lanes ({lanes}) divisible by "
                f"blocks ({nb})"
            )
        return lanes, nb, int(self.superstep or 16)

    def superstep_on(self) -> bool:
        """False when the per-launch pipeline is asked for: ``superstep``
        0 or ``A5GEN_SUPERSTEP=off``."""
        if self.superstep is not None and int(self.superstep) <= 0:
            return False
        return superstep_enabled()


@dataclass
class SweepResult:
    n_emitted: int = 0
    n_hits: int = 0
    hits: List[HitRecord] = field(default_factory=list)
    words_done: int = 0
    wall_s: float = 0.0  # the whole run: schema, uploads, drive
    drive_s: float = 0.0  # the drive alone (superstep or per-launch)
    #: supersteps / launches / replays (overflow re-runs) /
    #: launches_per_fetch / pair (candidates per lane, 0 = K=1) /
    #: per_launch (launches of the per-launch pipeline)
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

    def wait(self) -> "tuple[int, int]":
        """Block until the superstep's copies landed; ``(emitted, hits)``."""
        if self.cuda:
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

    def run_crack(self, recorder: Optional[HitRecorder] = None
                  ) -> SweepResult:
        """Fused expand → hash → membership on the device; only hits
        return to the host."""
        self.check()
        t0 = time.monotonic()
        recorder = recorder if recorder is not None else HitRecorder()
        spec, plan, cfg, dev = self.spec, self.plan, self.config, self.device
        flush = _FallbackFlush(self, self._crack_word(recorder))
        if not self.device_words:  # no word takes the device
            flush.until(self.n_words)
            return SweepResult(
                n_emitted=flush.n_emitted, n_hits=flush.n_hits,
                hits=recorder.hits, words_done=self.n_words,
                wall_s=time.monotonic() - t0, routing=dict(self.routing))
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
        ranges = [] if per_launch else self.word_ranges(rank_stride)
        idx = None if per_launch else superstep_index(plan, rank_stride,
                                                      ranges[0])
        digest_set = build_digest_set(self.digests, spec.algo)
        decode, pack_cb = decode_for(plan)
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
            stats, n_emitted, n_hits = self._drive_per_launch(
                make_crack_step(spec, **kw), arrays, lanes, nb, stride,
                recorder, flush)
            steps = 1
        else:
            # The superstep's emitted counter is int32: cap steps so every
            # lane emitting cannot reach 2^31.
            steps = max(1, min(steps, ((1 << 31) - 1)
                               // (lanes * (pair_k or 1))))
            body = make_superstep_body(spec, **kw)
            stats = {"supersteps": 0, "launches": 0, "replays": 0}
            n_emitted = n_hits = 0
            for lo, hi in ranges:
                # One sub-sweep per word range, in word order: its own
                # block index over the same resident tables.
                idx = self._index_range(arrays, rank_stride, (lo, hi))
                part, ne, nh = self._drive(
                    body, arrays, nb, steps, recorder, flush,
                    lambda b, cum=idx[0], hi=hi: min(
                        block_cursor(plan, rank_stride, cum, b)[0], hi))
                for k in stats:
                    stats[k] += part[k]
                n_emitted += ne
                n_hits += nh
        stats["launches_per_fetch"] = steps
        stats["pair"] = pair_k or 0
        if xla_geom:
            xla_geom["rows"] = stats["launches"] * lanes * (pair_k or 1)
        drive_s = time.monotonic() - t_drive
        flush.until(self.n_words)
        return SweepResult(
            n_emitted=n_emitted + flush.n_emitted,
            n_hits=n_hits + flush.n_hits,
            hits=recorder.hits,
            words_done=self.n_words,
            wall_s=time.monotonic() - t0 + self._schema_s,
            drive_s=drive_s,
            superstep=stats,
            routing=dict(self.routing),
            kernels={tier: stats["launches"]},
            routes={self.route: 1},
            xla=xla_geom,
        )

    def run_candidates(self, writer: CandidateWriter) -> SweepResult:
        """Stream every candidate to ``writer`` in word order, rank order
        within a word (per-word multiset parity with the oracle): the XLA
        expansion on the device, one launch at a time, its emitted rows
        compacted on the device before the copy to the host; fallback
        words through the oracle at their word position."""
        self.check("candidates")
        t0 = time.monotonic()
        spec, plan, cfg, dev = self.spec, self.plan, self.config, self.device

        def on_word(row: int, cands) -> "tuple[int, int]":
            n = 0
            for cand in cands:
                writer.emit(cand)
                n += 1
            return n, 0

        flush = _FallbackFlush(self, on_word)
        if not self.device_words:
            flush.until(self.n_words)
            return SweepResult(
                n_emitted=flush.n_emitted, words_done=self.n_words,
                wall_s=time.monotonic() - t0, routing=dict(self.routing))
        lanes, nb, _ = cfg.resolve(dev)
        stride = lanes // nb
        per_launch = self.per_launch(stride)
        ranges = [] if per_launch else self.word_ranges(stride)
        idx = None if per_launch else superstep_index(plan, stride,
                                                      ranges[0])
        budget = XLA_BUDGET_BYTES[dev.type]
        lanes = xla_lanes(plan, lanes, stride, 1, budget)
        nb = lanes // stride
        arrays = xla_arrays(plan, self.ct, self.pieces, None, idx,
                            device=dev)
        kw = dict(num_lanes=lanes, out_width=int(plan.out_width),
                  block_stride=stride, pieces=self.pieces,
                  windowed=bool(getattr(plan, "windowed", False)),
                  radix2=k_opts_for(plan) == 1)

        def launches():
            """Each launch's emitted rows and the first word it leaves
            unfinished: blocks cut on the host (per-launch pipeline) or
            on the device, one word range after the other."""
            if per_launch:
                step = make_candidates_step(spec, **kw)
                for _batch, blocks, w_next in self._host_cuts(
                        lanes, nb, stride, step.decode):
                    yield step(arrays, *blocks), w_next
                return
            body = make_candidates_body(spec, num_blocks=nb, **kw)
            for w_lo, w_hi in ranges:
                # One sub-sweep per word range, in word order.
                cum = self._index_range(arrays, stride, (w_lo, w_hi))[0]
                total = arrays["total"]
                for b0 in range(0, total, nb):
                    yield body(arrays, b0), min(block_cursor(
                        plan, stride, cum, min(b0 + nb, total))[0], w_hi)

        n_emitted = n_launches = 0
        t_drive = time.monotonic()
        for out, w_end in launches():
            cand, clen, wrow = (t.cpu().numpy() for t in out)
            n_launches += 1
            lo = 0
            rows = self.fallback_rows
            # Fallback words inside this launch's word range go between
            # the rows of the words around them.
            while flush.done < len(rows) and len(wrow) and \
                    rows[flush.done] < int(wrow[-1]):
                cut = int(np.searchsorted(wrow, rows[flush.done]))
                n_emitted += _write_rows(writer, cand, clen, lo, cut)
                lo = cut
                flush.until(rows[flush.done] + 1)
            n_emitted += _write_rows(writer, cand, clen, lo, len(clen))
            flush.until(w_end)
        drive_s = time.monotonic() - t_drive
        flush.until(self.n_words)
        return SweepResult(
            n_emitted=n_emitted + flush.n_emitted,
            words_done=self.n_words,
            wall_s=time.monotonic() - t0 + self._schema_s,
            drive_s=drive_s,
            routing=dict(self.routing),
            kernels={"expand": n_launches},
            routes={"xla": 1},
            xla={"lanes": lanes, "budget_bytes": budget,
                 "rows": n_launches * lanes},
        )

    def _drive(self, body, arrays, nb: int, steps: int, recorder, flush,
               word_at) -> "tuple[dict, int, int]":
        """The double-buffered superstep loop; returns (stats, emitted,
        hits) of the device words.  ``flush`` expands the fallback words
        due before each device hit's word and, after each superstep, those
        before ``word_at(end block)``."""
        cfg, dev = self.config, self.device
        total = arrays["total"]
        hit_cap = int(cfg.superstep_hit_cap)
        # A5GEN_PIPELINE=off: one superstep in flight, its fetch waited on
        # before the next dispatch.
        depth = _DEPTH if pipeline_enabled() else 1
        free = [
            (superstep_buffers(hit_cap, device=dev), _Fetch(hit_cap, dev))
            for _ in range(depth)
        ]
        inflight: deque = deque()
        stats = {"supersteps": 0, "launches": 0, "replays": 0}
        n_emitted = n_hits = 0
        b0 = 0
        while b0 < total or inflight:
            while b0 < total and len(inflight) < depth:
                # The tail superstep runs only the launches it needs.
                n_steps = min(steps, -(-(total - b0) // nb))
                bufs, fetch = free.pop()
                fetch.start(body(arrays, b0, n_steps, bufs))
                inflight.append((b0, n_steps, bufs, fetch))
                b0 += n_steps * nb
            sb0, n_steps, bufs, fetch = inflight.popleft()
            ne, nh = fetch.wait()
            hits_src = fetch.host
            if nh > hit_cap:
                # Overflow: the capped buffer dropped entries.  Re-run the
                # same blocks into a buffer that holds them all (the
                # superstep is a pure function of its cursor).
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
                    self._device_hit(int(w_row), int(rank), recorder)
            flush.until(word_at(min(sb0 + n_steps * nb, total)))
            n_emitted += ne
            n_hits += nh
            stats["supersteps"] += 1
            stats["launches"] += n_steps
            free.append((bufs, fetch))
        return stats, n_emitted, n_hits

    def _host_cuts(self, lanes: int, nb: int, stride: int, decode: str):
        """The per-launch pipeline's launches, in cursor order: each
        launch's blocks cut on the host (``ops.blocks.make_blocks``,
        Python-int cursors) — ``(batch, (word, count, base), next word)``,
        the tensors on the sweep's device as ``decode`` takes them
        (``models.attack.host_blocks``)."""
        weight = scalar_units_weight(self.plan)
        w = rank = 0
        while True:
            batch, w, rank = make_blocks(
                self.plan, start_word=w, start_rank=rank, max_variants=lanes,
                max_blocks=nb, fixed_stride=stride)
            if batch.total == 0:
                return
            yield batch, host_blocks(batch, nb, decode, weight,
                                     device=self.device), w

    def _drive_per_launch(self, step, arrays, lanes: int, nb: int,
                          stride: int, recorder, flush
                          ) -> "tuple[dict, int, int]":
        """The per-launch pipeline's crack drive: each launch of
        :meth:`_host_cuts` run by ``step`` (``models.attack
        .make_crack_step``), the next launch dispatched before this one's
        counters are read; a hit-bearing launch's hit lanes come back and
        map to ``(word, rank)`` through ``ops.blocks.lane_cursor``.
        ``flush`` expands the fallback words due before each hit's word
        and, after each launch, those before the launch's end cursor.
        Returns (stats, emitted, hits) of the device words."""
        plan = self.plan
        pending: deque = deque()
        stats = {"supersteps": 0, "launches": 0, "replays": 0}
        totals = [0, 0]

        def consume(batch, out, w_next) -> None:
            ne, nh = (int(x) for x in out["counters"].tolist())
            if nh:
                hit = torch.nonzero(out["hit"]).flatten().tolist()
                for w_row, rank in lane_cursor(plan, batch, hit):
                    flush.until(w_row)
                    self._device_hit(w_row, rank, recorder)
            flush.until(w_next)
            totals[0] += ne
            totals[1] += nh

        for batch, blocks, w_next in self._host_cuts(lanes, nb, stride,
                                                     step.decode):
            pending.append((batch, step(arrays, *blocks), w_next))
            stats["launches"] += 1
            if len(pending) >= _DEPTH:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
        stats["per_launch"] = stats["launches"]
        return stats, totals[0], totals[1]

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

    def _crack_word(self, recorder):
        """Crack mode's handling of a fallback word's oracle candidates:
        hash each with ``HOST_DIGEST`` and record the ones in the digest
        list (rank = the candidate's DFS index in the oracle's stream)."""
        digest = HOST_DIGEST[self.spec.algo]

        def on_word(row: int, cands) -> "tuple[int, int]":
            n = hits = 0
            for i, cand in enumerate(cands):
                n += 1
                dig = digest(cand)
                if dig in self._digest_lookup:
                    hits += 1
                    recorder.emit(HitRecord(
                        word_index=int(self.packed.index[row]),
                        variant_rank=i, candidate=cand,
                        digest_hex=dig.hex(),
                    ))
            return n, hits

        return on_word

    def _device_hit(self, w_row: int, rank: int, recorder) -> None:
        """Re-derive a device-flagged hit's candidate, re-verify its
        digest on the host, record it."""
        cand = decode_variant(self.plan, self.ct, self.spec, w_row, rank)
        dig = HOST_DIGEST[self.spec.algo](cand)
        if dig not in self._digest_lookup:
            raise RuntimeError(
                f"device hit failed host re-verification: word {w_row} "
                f"rank {rank} candidate {cand!r}"
            )
        recorder.emit(
            HitRecord(
                word_index=int(self.packed.index[w_row]),
                variant_rank=rank,
                candidate=cand,
                digest_hex=dig.hex(),
            )
        )


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
    eligible) and hands its candidates to ``on_word(row, candidates) ->
    (candidates, hits)`` (crack mode: hash and look up; candidates mode:
    write)."""

    def __init__(self, sweep: Sweep, on_word) -> None:
        self.sweep, self.on_word = sweep, on_word
        self.done = 0
        self.n_emitted = self.n_hits = 0

    def until(self, word_row: int) -> None:
        sw, rows = self.sweep, self.sweep.fallback_rows
        while self.done < len(rows) and rows[self.done] < word_row:
            row = rows[self.done]
            n, hits = self.on_word(row, sw._oracle_candidates(row))
            self.n_emitted += n
            self.n_hits += hits
            self.done += 1
