"""The crack sweep: one wordlist × one merged table × one attack spec,
driven through the device superstep loop.

Each sweep's plan takes one kernel tier, by the reference's own gate: the
per-slot piece kernel when ``packing.piece_schema_for`` gives a schema,
else the byte-scan tier of ``ops.bytescan.bytescan_tier`` (TPU kernel rows
7-9).  ``SweepResult.kernels`` names it with its launch count.

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

Substitute-all plans route each word three ways, as the reference does:
device-clean words and cascade-closed words run on the device; words no
plan splices exactly (``plan.fallback``) take no blocks and are expanded on
the host by the oracle (``oracle.engines``), hashed with ``HOST_DIGEST``
and looked up in the digest list.  Their hits carry the oracle's DFS index
as rank and interleave in word order: a fallback word is flushed before
the first device hit of a later word, and at each superstep boundary
before the boundary's word.
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
    make_superstep_body,
    superstep_buffers,
)
from ..ops.blocks import block_cursor, superstep_index
from ..ops.bytescan import bytescan_tier
from ..ops.fused_expand import (
    decode_for,
    k_vals_for,
    kernel_refusal,
    launch_key,
    pair_for_config,
)
from ..ops.membership import HostDigestLookup, build_digest_set
from ..ops.packing import PackedWords, pack_words, piece_schema_for
from ..oracle.engines import iter_candidates
from ..tables.compile import compile_table
from ..utils.digests import HOST_DIGEST
from .sinks import HitRecord, HitRecorder

#: Supersteps in flight: two alternating buffer sets, so superstep N+1 is
#: queued before superstep N's fetch is waited on.
_DEPTH = 2


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
    superstep: Optional[int] = None  # launches per superstep; None = 16.
    #   0 would select the per-launch pipeline, which is not ported
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
        if self.superstep is not None and int(self.superstep) <= 0:
            raise NotImplementedError(
                "superstep off (the per-launch pipeline) is not ported"
            )
        return lanes, nb, int(self.superstep or 16)


@dataclass
class SweepResult:
    n_emitted: int = 0
    n_hits: int = 0
    hits: List[HitRecord] = field(default_factory=list)
    words_done: int = 0
    wall_s: float = 0.0  # the whole run: schema, uploads, drive
    drive_s: float = 0.0  # the superstep drive alone
    #: supersteps / launches / replays (overflow re-runs) /
    #: launches_per_fetch / pair (candidates per lane, 0 = K=1)
    superstep: Dict[str, int] = field(default_factory=dict)
    #: word routing: device_clean / device_closed / oracle_fallback
    routing: Dict[str, int] = field(default_factory=dict)
    #: launches by kernel tier: ``piece_<entry>`` (``piece_k1``,
    #: ``piece_pair``, ``piece_suball_closed``, ...) or ``bytescan_<row>``
    #: (``bytescan_scalar``, ``bytescan_match``, ``bytescan_suball``)
    kernels: Dict[str, int] = field(default_factory=dict)


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
        # Plans no kernel takes are refused here, so a caller holding
        # several sweeps (BucketedSweep) refuses before any of them
        # launches.  A plan without a piece schema takes the byte-scan
        # tier the reference's wrappers pick.
        self.config.resolve(self.device)
        self.device_words = self.n_words > len(self.fallback_rows)
        self.pieces = None
        self.bytescan = None
        # The schema is part of the run: SweepResult.wall_s counts it.
        self._schema_s = 0.0
        if self.device_words:
            t0 = time.monotonic()
            self.pieces = piece_schema_for(self.plan, self.ct)
            self._schema_s = time.monotonic() - t0
            why = kernel_refusal(spec, self.plan, self.ct, self.pieces)
            if why is not None:
                raise NotImplementedError(f"kernel not ported for: {why}")
            if self.pieces is None:
                self.bytescan = bytescan_tier(self.plan)

    def run_crack(self, recorder: Optional[HitRecorder] = None
                  ) -> SweepResult:
        """Fused expand → hash → membership on the device; only hits
        return to the host."""
        t0 = time.monotonic()
        recorder = recorder if recorder is not None else HitRecorder()
        spec, plan, cfg, dev = self.spec, self.plan, self.config, self.device
        flush = _FallbackFlush(self, recorder)
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
            pair_k = pair_for_config(spec, plan, pieces, block_stride=stride)
        if pair_k is None and str(cfg.pair).lower() in ("on", "1", "2",
                                                        "true"):
            print("a5gen: warning: pair requested (--pair on) but this "
                  "plan/config is not pair-eligible (schema gate, windowed "
                  "decode, or hash-block count); running K=1",
                  file=sys.stderr)
        rank_stride = stride * (pair_k or 1)
        idx = superstep_index(plan, rank_stride)
        if idx is None:
            raise NotImplementedError(
                "block index not int32-safe (a word with >= 2^30 variants)"
            )
        # The superstep's emitted counter is int32: cap steps so every
        # lane emitting cannot reach 2^31.
        steps = max(1, min(steps, ((1 << 31) - 1) // (lanes * (pair_k or 1))))
        arrays = device_arrays(
            plan, pieces, build_digest_set(self.digests, spec.algo), idx,
            device=dev, ct=self.ct, bytescan=self.bytescan,
        )
        decode, pack_cb = decode_for(plan)
        body = make_superstep_body(
            spec, num_lanes=lanes, out_width=int(plan.out_width),
            block_stride=stride, num_blocks=nb, pieces=pieces,
            pair_k=pair_k, decode=decode, pack_cb=pack_cb,
            k_opts=k_vals_for(plan), bytescan=self.bytescan,
        )
        tier = (self.bytescan.name if self.bytescan is not None else
                launch_key(spec.algo, pieces, decode,
                           pair_k is not None).split("/")[0])
        t_drive = time.monotonic()
        stats, n_emitted, n_hits = self._drive(
            body, arrays, nb, steps, recorder, flush,
            lambda b: block_cursor(plan, rank_stride, idx[0], b)[0])
        stats["pair"] = pair_k or 0
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
        free = [
            (superstep_buffers(hit_cap, device=dev), _Fetch(hit_cap, dev))
            for _ in range(_DEPTH)
        ]
        inflight: deque = deque()
        stats = {"supersteps": 0, "launches": 0, "replays": 0,
                 "launches_per_fetch": steps}
        n_emitted = n_hits = 0
        b0 = 0
        while b0 < total or inflight:
            while b0 < total and len(inflight) < _DEPTH:
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


class _FallbackFlush:
    """The oracle route of a sweep's fallback words, flushed in word order:
    :meth:`until` expands every not yet expanded fallback word below a row,
    hashes each candidate with ``HOST_DIGEST`` and records the ones in the
    digest list (rank = the candidate's DFS index in the oracle's stream)."""

    def __init__(self, sweep: Sweep, recorder) -> None:
        self.sweep, self.recorder = sweep, recorder
        self.done = 0
        self.n_emitted = self.n_hits = 0
        spec = sweep.spec
        self.substitute_all = spec.mode.startswith("suball")
        self.reverse = spec.mode in ("reverse", "suball-reverse")
        self.digest = HOST_DIGEST[spec.algo]

    def until(self, word_row: int) -> None:
        sw, rows = self.sweep, self.sweep.fallback_rows
        while self.done < len(rows) and rows[self.done] < word_row:
            row = rows[self.done]
            cands = iter_candidates(
                sw.packed.word(row), sw.sub_map, sw.spec.min_substitute,
                sw.spec.max_substitute, substitute_all=self.substitute_all,
                reverse=self.reverse,
            )
            for i, cand in enumerate(cands):
                self.n_emitted += 1
                dig = self.digest(cand)
                if dig in sw._digest_lookup:
                    self.n_hits += 1
                    self.recorder.emit(HitRecord(
                        word_index=int(sw.packed.index[row]),
                        variant_rank=i, candidate=cand,
                        digest_hex=dig.hex(),
                    ))
            self.done += 1
