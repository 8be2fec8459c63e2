"""Cross-job physical packing: fused superstep dispatch (the reference's
``runtime/fuse.py``).

The resident engine (``runtime/engine.py``) gives each job its own
superstep dispatches; N small jobs then pay N dispatch + fetch round trips
a round, each launch mostly masked lanes.  This module fuses compatible
runnable jobs' block ranges into one dispatch:

* the packed superstep body (``models.attack.make_superstep_body`` with
  ``n_seg``) splits every step's blocks into equal per-job segments, cuts
  each segment's blocks from its own job's region of the packed index
  (``ops.blocks.packed_block_index``) and sums per-job counter rows in the
  same pass that compacts the hits, so the one fetch a round returns each
  tenant's own emitted and hit counts;
* each lane's membership runs against its own job's digest set
  (``ops.membership.digest_member_seg``), never the union, so packed hit
  counts equal solo ones by construction;
* the members' per-word tables (plan fields, the piece tables, the decode
  tables, the byte-scan tables) are stacked row-wise and the packed
  launches run the same kernel tier the members' solo sweeps run — the
  piece kernel (``csrc/piece_hash.cu``), the byte-scan kernel of one
  ``ops.bytescan.ByteScanTier`` (``csrc/bytescan_hash.cu``; its option
  words are copied per word, so nothing needs shifting) or the XLA
  expand + hash route, whose value table pointers shift by each job's
  value-table base;
* hits land in one capped buffer tagged by packed plan row; the host maps
  rows back to jobs and hands each job the ``(word, rank)`` entries its
  solo sweep would have fetched.

The consume side stays in the job machines: :class:`FusedGroup` owns
dispatch and the one counters fetch a round (:meth:`FusedGroup.pump`),
and each member machine's ``Sweep._drive_packed`` pulls its own result
through the solo drive's bookkeeping, so per-job streams and checkpoints
are the solo ones.

Eligibility is strict (:func:`pack_candidate`): streaming jobs, closed
plans, pod jobs, a cursor off the stride and jobs the superstep drive
does not take keep per-job dispatch; a K=2 job whose doubled stride
overflows packs as K=1.  ``A5GEN_PACK=off`` (or
``Engine(pack=False)``) gives every job per-job dispatch.

Dynamic re-fuse: a departed tenant's segment parks as masked lanes, so
fill decays under churn; the group reports its per-round fill
(:attr:`FusedGroup.last_fill`) and the engine re-fuses survivors below its
threshold (``A5GEN_REFUSE``).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.attack import (
    device_arrays,
    make_superstep_body,
    packed_superstep_arrays,
    superstep_buffers,
    xla_arrays,
)
from ..ops.blocks import superstep_index
from ..ops.fused_expand import k_vals_for
from . import faults, telemetry
from .sweep import _get_step, _join_streams, _on, _pieces_static


#: Kernel launches made inside fused groups' packed supersteps (overflow
#: re-runs included), by the kernel wrappers' ``LAUNCHES`` keys: the part
#: of those process-wide counts that ran packed.
GROUP_LAUNCHES: Dict[str, int] = {}
#: Candidate lanes of fused groups' packed dispatches by the groups'
#: launch tier (``FusedGroup.tier``: ``piece_k1``, ``bytescan_scalar``,
#: ...): ``[occupied, total]``, the per-tier share of the engine's
#: ``packed_fill``.
GROUP_LANES: Dict[str, List[int]] = {}


def _launch_totals() -> Dict[str, int]:
    from ..ops import buffer_hash, bytescan, fused_expand

    return {**fused_expand.LAUNCHES, **bytescan.LAUNCHES,
            **buffer_hash.LAUNCHES}


def _count_group_launches(before: Dict[str, int]) -> None:
    for k, v in _launch_totals().items():
        if v != before.get(k, 0):
            GROUP_LAUNCHES[k] = GROUP_LAUNCHES.get(k, 0) + v - before[k]


def static_affinity_token(**fields) -> str:
    """Stable 12-hex token over named static-config fields (the
    reference's): field order is canonical (sorted by name) and values
    stringify, so any process computing it from the same facts gets the
    same string."""
    import hashlib

    blob = "|".join(f"{k}={fields[k]!r}" for k in sorted(fields))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def affinity_token(spec, cfg) -> str:
    """The static-config prefix of :func:`pack_candidate`'s compatibility
    key as a token, knowable without building the job's plan: equal
    tokens are necessary, not sufficient, for two jobs to fuse — a
    router's placement signal.  Equal to the reference's for the same
    spec and config fields."""
    return static_affinity_token(
        mode=spec.mode, algo=spec.algo,
        table_min=spec.min_substitute, table_max=spec.max_substitute,
        lanes=cfg.lanes, num_blocks=cfg.num_blocks,
        superstep=cfg.superstep, devices=cfg.devices, pair=cfg.pair,
    )


def pack_candidate(sweep, resume_state=None) -> "Optional[dict]":
    """One job's packed-dispatch eligibility probe: the fuse descriptor
    (plan, block index, aligned start block, host arrays and the
    compatibility key), or None when the job keeps per-job dispatch.

    The key is everything the packed step and the row-wise stacking of
    the members' arrays depend on: two jobs with equal keys share one
    packed step and their tables stack without padding (but the XLA
    route's value rows, zero-padded to the widest).  Every per-launch
    value the kernel takes from the schema is in it, through
    ``runtime.sweep._pieces_static``, the descriptor table and the
    trailing shapes of every stacked array; a byte-scan plan's whole
    ``ByteScanTier`` (row, decode, variant, option count) is in it, so
    two tiers never share a step."""
    cfg = sweep.config
    if sweep._stream is not None or sweep.plan is None:
        return None
    if cfg.pod is not None:
        # A pod stripe advances the block lattice per stripe; the group's
        # step has no stripe advance.
        return None
    plan = sweep.plan
    if getattr(plan, "close_next", None) is not None:
        # Closed plans carry their own value tables; merging them would
        # re-index the joint-closure rows.
        return None
    r = sweep._whole
    if r is None or r.route not in ("piece", "bytescan", "xla"):
        return None
    dev = sweep.device
    try:
        stride = cfg.resolve_block_stride(dev)
        stripes = sweep.stripes()
    except (ValueError, RuntimeError):
        return None
    if stride is None or not cfg.superstep_on():
        return None
    # Start cursor: normalized as the block cutter does, then aligned to
    # the stride (a resume from another geometry keeps the solo path).
    w, rank = 0, 0
    if resume_state is not None:
        w, rank = resume_state.cursor.word, resume_state.cursor.rank
    w, rank = sweep._normalize(plan, (w, rank))
    if w < plan.batch and rank % stride:
        return None
    # The solo drive's launch decisions: a K=2 job whose doubled stride
    # overflows int32, or whose cursor is aligned for K=1 only, runs (and
    # so packs) as K=1.
    g = sweep._geometry(r, "crack", (w, rank))
    if g["per_launch"] or len(g["ranges"]) != 1:
        return None
    pair_k, rank_stride = g["pair_k"], g["rank_stride"]
    idx = superstep_index(plan, rank_stride)
    cum, totals, total_blocks = idx
    lanes, nb = g["lanes"], g["nb"]
    # The superstep's counters are int32: every lane emitting cannot
    # reach 2^31 (the solo drive's cap).
    steps = max(1, min(g["steps"], ((1 << 31) - 1) // (lanes
                                                       * (pair_k or 1))))
    b0 = total_blocks if w >= plan.batch else int(cum[w]) + rank // rank_stride
    cpu = torch.device("cpu")
    if r.route == "xla":
        arrays = xla_arrays(plan, sweep.ct, r.pieces, None, idx, device=cpu)
    else:
        arrays = device_arrays(plan, r.pieces, None, idx, device=cpu,
                               ct=sweep.ct, bytescan=r.bytescan)
    for k in ("cum", "totals", "total"):
        arrays.pop(k, None)
    sig = tuple(
        (k, tuple(v.shape[1:]), str(v.dtype)) for k, v in
        sorted(arrays.items()) if k not in ("desc", "val_bytes"))
    desc = arrays.get("desc")
    kw = g["kw"]
    key = (
        r.route, g["tier"], r.bytescan, sweep.spec, lanes, nb, stride,
        steps, int(cfg.superstep_hit_cap), int(plan.out_width), kw["windowed"],
        tuple(stripes.devices), sweep._pipeline_depth(), sig,
        None if desc is None else desc.numpy().tobytes(),
        _pieces_static(r.pieces), kw["radix2"], pair_k, kw["decode"],
        kw["pack_cb"], k_vals_for(plan),
        # One retry policy and one fetch watchdog serve every member: a
        # fail-fast tenant must never inherit a cohabitant's budget.
        cfg.retry_policy(), cfg.fetch_timeout_s,
    )
    return {
        "sweep": sweep, "plan": plan, "idx": idx, "cum": cum,
        "totals": totals, "total_blocks": total_blocks, "b0": b0,
        "steps": steps,
        # Cursor math walks in rank-stride units (pair_k × the lane
        # stride); the kernel geometry keeps the lane stride.
        "stride": rank_stride, "lane_stride": stride, "pair_k": pair_k,
        "lanes": lanes, "nb": nb, "route": r.route, "tier": g["tier"],
        "kw": kw, "arrays": arrays, "key": key,
    }


def _packed_digest_arrays(members: Sequence[dict]) -> Dict[str, np.ndarray]:
    """The members' digest sets as the segmented membership tables:
    sorted row runs back to back, bitmaps stacked at one common width
    (the widest member's default sizing; the bitmap is a prefilter ANDed
    with the exact search, so its width never changes a verdict) and the
    per-segment row bounds (the reference's ``_packed_digest_arrays``)."""
    from ..ops.membership import auto_bitmap_bits, build_digest_set

    def _count(digests) -> int:
        if isinstance(digests, np.ndarray):
            return int(digests.shape[0])
        return len(digests)

    bits = max(auto_bitmap_bits(_count(m["sweep"].digests))
               for m in members)
    sets = [build_digest_set(m["sweep"].digests, m["sweep"].spec.algo,
                             bitmap_bits=bits) for m in members]
    rows = np.concatenate([ds.rows for ds in sets])
    bitmap = np.stack([ds.bitmap for ds in sets])
    bounds = np.zeros(len(sets) + 1, dtype=np.int64)
    for j, ds in enumerate(sets):
        bounds[j + 1] = bounds[j] + ds.rows.shape[0]
    return {"rows": rows, "bitmap": bitmap,
            "row_lo": bounds[:-1].astype(np.int32),
            "row_hi": bounds[1:].astype(np.int32)}


def _packed_plan_tree(members: Sequence[dict]) -> Dict[str, torch.Tensor]:
    """The members' per-word tables stacked row-wise (host tensors): every
    batch-leading array concatenates — the byte-scan tables too, whose
    option words are copied per word (``ops.bytescan.option_words``), so
    members with different tables stack as they are; the schema's
    descriptor table is one for the group (the compatibility key pins it
    equal).  On the XLA route the jobs' value tables concatenate too,
    each per-word value-row pointer (``match_val_start`` /
    ``pat_val_start``) shifted by its job's value-table base, narrow
    value rows zero-padded to the widest (rows are read under
    ``val_len``, so the padding is never read)."""
    trees = [dict(m["arrays"]) for m in members]
    out: Dict[str, torch.Tensor] = {}
    if "val_bytes" in trees[0]:
        vb = [t.pop("val_bytes") for t in trees]
        vw = max(int(b.shape[1]) for b in vb)
        vb = [torch.nn.functional.pad(b, (0, vw - int(b.shape[1])))
              for b in vb]
        off_key = ("match_val_start" if "match_val_start" in trees[0]
                   else "pat_val_start")
        base = 0
        for j, t in enumerate(trees):
            t[off_key] = t[off_key] + base
            base += int(vb[j].shape[0])
        out["val_bytes"] = torch.cat(vb)
    if "desc" in trees[0]:
        out["desc"] = trees[0]["desc"]
        for t in trees:
            t.pop("desc")
    for k in trees[0]:
        out[k] = torch.cat([t[k] for t in trees])
    return out


def build_fused_group(members: Sequence[dict]) -> "Optional[FusedGroup]":
    """One :class:`FusedGroup` of at least two :func:`pack_candidate`
    descriptors that share one key, or None when the block count does not
    split into ``len(members)`` segments or the packed index would pass
    int32 (the engine then keeps per-job dispatch)."""
    m0 = members[0]
    n_seg = len(members)
    if n_seg < 2 or m0["nb"] % n_seg:
        return None
    packed = packed_superstep_arrays([m["plan"] for m in members],
                                     [m["idx"] for m in members])
    if packed is None:
        return None
    ss_host, blk_base, row_base = packed
    n_dev = m0["sweep"].stripes().n
    # The tail dispatch's overshot per-segment cursors stay int32.
    if int(blk_base[-1]) + (m0["steps"] + 1) * m0["nb"] * n_dev >= (1 << 31):
        return None
    return FusedGroup(members, ss_host, blk_base, row_base)


class _PackedFetch:
    """One stripe's once-a-round fetch of a packed superstep: the
    ``[2, n_seg]`` counters and the hit buffers copied without blocking
    into pinned host memory, completed by one CUDA event (plain copies on
    the CPU)."""

    def __init__(self, n_seg: int, hit_cap: int, dev: torch.device) -> None:
        cuda = dev.type == "cuda"
        self.cuda = cuda
        self.host = {
            "counters": torch.zeros((2, n_seg), dtype=torch.int32,
                                    pin_memory=cuda),
            "hit_word": torch.zeros(hit_cap + 1, dtype=torch.int32,
                                    pin_memory=cuda),
            "hit_rank": torch.zeros(hit_cap + 1, dtype=torch.int32,
                                    pin_memory=cuda),
        }
        self.event = torch.cuda.Event() if cuda else None

    def start(self, out: dict) -> None:
        for k, v in self.host.items():
            v.copy_(out[k], non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def wait(self, timeout_s: Optional[float]) -> np.ndarray:
        if self.cuda:
            faults.await_ready(self.event, timeout_s)
            self.event.synchronize()
        return self.host["counters"].numpy().copy()


class FusedGroup:
    """One fused tenant group: the packed step, its device arrays, the
    per-segment block cursors and the dispatch / fetch / split loop the
    engine pumps once a serve round.

    :meth:`pump` dispatches at most ``depth`` packed supersteps ahead,
    waits on exactly one fetch a round (one event per stripe; the hit
    slice is read only when a segment hit) and never dispatches or
    fetches inside the per-member split, which is host bookkeeping over
    arrays already fetched.  A member that pauses, cancels, fails or
    finishes parks its segment at its end bound (its later blocks are
    masked zero-count blocks); cohabitants are untouched, and the group
    retires when every member has left.

    With several cursor stripes (``SweepConfig.devices``), stripe ``i``
    of a round starts every segment ``i * num_blocks / n_seg`` blocks on,
    and each step advances a segment past every stripe's share."""

    def __init__(self, members: Sequence[dict], ss_host, blk_base,
                 row_base) -> None:
        m0 = members[0]
        sweep0 = m0["sweep"]
        spec, cfg = sweep0.spec, sweep0.config
        st = sweep0.stripes()
        self.n_seg = len(members)
        self.steps = m0["steps"]
        self.stride = m0["stride"]  # the rank stride (pair_k × lanes)
        self.pair_k = m0["pair_k"] or 0
        self.route, self.tier = m0["route"], m0["tier"]
        self._hit_cap = int(cfg.superstep_hit_cap)
        self._devices = st.devices
        self._streams = st.streams()
        self._lanes, self._num_blocks = m0["lanes"], m0["nb"]
        self._nbs = self._num_blocks // self.n_seg
        self._blk_base = blk_base
        self._row_base = row_base
        self._members = list(members)
        self._by_sweep: Dict[int, int] = {
            id(m["sweep"]): j for j, m in enumerate(members)}
        self._active = [True] * self.n_seg
        self._pending: List[deque] = [deque() for _ in members]
        # Packed-global per-segment cursors; _consumed tracks each
        # segment's last fetched boundary.
        self._b0 = np.asarray([int(blk_base[j]) + m["b0"]
                               for j, m in enumerate(members)],
                              dtype=np.int64)
        self._seg_end = blk_base[1:].astype(np.int64).copy()
        self._consumed = self._b0.copy()
        n_dev = st.n
        self._adv = self.steps * self._nbs * n_dev
        #: launches one round dispatches (every stripe's steps)
        self.launches_per_round = self.steps * n_dev
        #: supersteps in flight: the members' one pipeline depth (the
        #: compatibility key holds it equal)
        self.depth = sweep0._pipeline_depth()
        self._inflight: deque = deque()
        self.dispatches = 0
        #: the last consumed round's fill: occupied candidate lanes over
        #: the dispatch's lanes (the engine's re-fuse trigger)
        self.last_fill: Optional[float] = None
        #: members that left by tenant action (cancel / pause); the
        #: re-fuse trigger requires one
        self.departures = 0

        plan_tree = _packed_plan_tree(members)
        dig = _packed_digest_arrays(members)
        kw = dict(m0["kw"])
        kw.update(num_blocks=self._num_blocks)
        skey = ("packed-superstep", spec, self.n_seg, n_dev,
                tuple(sorted((k, _pieces_static(v) if k == "pieces" else v)
                             for k, v in kw.items())))
        advance = self._num_blocks * n_dev
        self._body = _get_step(skey, lambda: make_superstep_body(
            spec, step_advance=advance, n_seg=self.n_seg, **kw))
        host = dict(plan_tree)
        host.update({k: torch.as_tensor(_as_i32(v))
                     for k, v in dig.items()})
        host.update({
            "cum": torch.as_tensor(ss_host["cum"]),
            "totals": torch.as_tensor(ss_host["totals"]),
            "seg_end": torch.as_tensor(ss_host["seg_end"].astype(np.int64)),
        })
        # The packed tables go up once per device of the stripes, each
        # upload with that card current (ctypes launches and allocations
        # on a worker thread need it).
        self._arrays: List[dict] = []
        per_dev: Dict[torch.device, dict] = {}
        for d in self._devices:
            if d not in per_dev:
                with _device_ctx(d):
                    per_dev[d] = {k: v.to(d) for k, v in host.items()}
            self._arrays.append(per_dev[d])
        _join_streams(self._streams, into_stripes=True)

        def make_bufs():
            sets = []
            for d, strm in zip(self._devices, self._streams):
                with _device_ctx(d), _on(strm):
                    sets.append((superstep_buffers(self._hit_cap, device=d),
                                 _PackedFetch(self.n_seg, self._hit_cap, d)))
            return sets

        self._make_bufs = make_bufs
        self._free = [make_bufs() for _ in range(self.depth)]
        #: the shared fault-supervision knobs (equal across members: they
        #: are in the compatibility key)
        self._retry_attempts, self._retry_backoff_s = cfg.retry_policy()
        self._fetch_timeout_s = cfg.fetch_timeout_s

    # -- engine surface ------------------------------------------------

    @property
    def done(self) -> bool:
        """Every member has left (finished, paused, cancelled, failed)."""
        return not any(self._active)

    @property
    def active_members(self) -> int:
        """Members still attached (segment not parked)."""
        return int(sum(self._active))

    def register(self, sweep) -> None:
        """Bind a member sweep to its segment (right after fusing)."""
        sweep._packed_source = self

    def member_cum(self, sweep) -> np.ndarray:
        """The member's own cumulative block index (job-local), which its
        machine's cursor arithmetic runs against."""
        return self._members[self._by_sweep[id(sweep)]]["cum"]

    def leave(self, sweep) -> None:
        """Detach a member: park its segment at its end bound and drop its
        undelivered results.  Idempotent; called from the machine's drive
        finally on completion, pause, cancel and failure alike."""
        j = self._by_sweep[id(sweep)]
        self._active[j] = False
        self._b0[j] = self._seg_end[j]
        self._pending[j].clear()

    def next_result(self, sweep) -> "Optional[dict]":
        """The member's next consumed-superstep result, or None once its
        block range is drained.  The engine pumps before ticking, so a
        runnable member always finds its result; a tick with none and work
        remaining is a scheduler fault and raises."""
        j = self._by_sweep[id(sweep)]
        if self._pending[j]:
            return self._pending[j].popleft()
        if self._consumed[j] < self._seg_end[j]:
            raise RuntimeError(
                "packed member ticked without a pumped result — the "
                "engine must pump the fused group once per round before "
                "ticking its members")
        return None

    # -- the packed drive ----------------------------------------------

    def _dispatch(self, snap: np.ndarray, sets) -> None:
        """Launch one packed superstep from cursor row ``snap`` on every
        stripe (stripe ``i`` from ``snap + i * nbs``) and start each
        stripe's fetch."""
        before = _launch_totals()
        for i, ((bufs, fetch), strm, d) in enumerate(
                zip(sets, self._streams, self._devices)):
            with _device_ctx(d), _on(strm):
                fetch.start(self._body(self._arrays[i],
                                       snap + i * self._nbs, self.steps,
                                       bufs))
        _count_group_launches(before)

    def pump(self) -> bool:
        """One packed round: dispatch ahead up to ``depth`` supersteps,
        wait on the due one's fetch (the one device→host round trip of the
        round), split per-member results into the pending queues.  Returns
        False when nothing was produced (the group drained).

        A transient device error in the dispatch or fetch is retried —
        in-flight dispatches dropped, buffer sets rebuilt, segment cursors
        reset to their last split boundary — within the shared retry
        budget; past it (or on another error) the exception propagates and
        the engine demotes the members to solo machines."""
        attempts = 0
        while True:
            try:
                while self._work_remains() and \
                        len(self._inflight) < self.depth:
                    if faults.ACTIVE is not None:
                        faults.ACTIVE.fire("packed.pump")
                    snap = self._b0.copy()
                    sets = self._free.pop()
                    self._dispatch(snap, sets)
                    self._inflight.append((snap, time.monotonic(), sets))
                    self._b0 = np.minimum(self._b0 + self._adv,
                                          self._seg_end)
                if not self._inflight:
                    return False
                if not any(self._active):
                    # Every member left: nobody consumes these results
                    # (their blocks are replayed from the members'
                    # checkpoints).
                    self._inflight.clear()
                    return False
                snap, disp_t, sets = self._inflight.popleft()
                counts = [fetch.wait(self._fetch_timeout_s)
                          for _bufs, fetch in sets]
            except Exception as exc:  # noqa: BLE001 — typed check inside
                self._recover_pump(exc, attempts)
                attempts += 1
                continue
            break
        entries: List[List[Tuple[int, int]]] = [[] for _ in
                                                range(self.n_seg)]
        hits = [int(c[1].sum()) for c in counts]
        overflow = any(h > self._hit_cap for h in hits)
        hit_occupancy = max(min(h, self._hit_cap) for h in hits) / max(
            self._hit_cap, 1)
        for i, ((_bufs, fetch), nh_i) in enumerate(zip(sets, hits)):
            if not nh_i:
                continue
            src = fetch.host
            if nh_i > self._hit_cap:
                # Overflow: re-run this stripe's superstep into a buffer
                # that holds every hit (a pure function of its cursors).
                d = self._devices[i]
                before = _launch_totals()
                with _device_ctx(d), _on(self._streams[i]):
                    out = self._body(
                        self._arrays[i], snap + i * self._nbs, self.steps,
                        superstep_buffers(nh_i, device=d))
                    src = {k: v.cpu() for k, v in out.items()}
                _count_group_launches(before)
                if int(src["counters"][1].sum()) != nh_i:
                    raise RuntimeError("packed superstep replay disagrees "
                                       "with its first run")
            rows = src["hit_word"][:nh_i].numpy().astype(np.int64)
            ranks = src["hit_rank"][:nh_i].numpy()
            segs = np.searchsorted(self._row_base, rows, side="right") - 1
            locs = rows - self._row_base[segs]
            for j, w_loc, rank in zip(segs.tolist(), locs.tolist(),
                                      ranks.tolist()):
                entries[j].append((w_loc, rank))
        self._free.append(sets)
        ne_rows = sum(c[0].astype(np.int64) for c in counts).tolist()
        nh_rows = sum(c[1].astype(np.int64) for c in counts).tolist()
        b_lo_rows = snap.tolist()
        b_hi_rows = np.minimum(snap + self._adv, self._seg_end).tolist()
        base_rows = self._blk_base[:-1].tolist()
        occupied = 0
        for j in range(self.n_seg):
            b_lo, b_hi = b_lo_rows[j], b_hi_rows[j]
            self._consumed[j] = b_hi
            occupied += self._occupied(j, b_lo, b_hi)
            if not self._active[j] or b_lo >= b_hi:
                # Parked, or drained in an earlier superstep: its next
                # tick sees None and finishes now.
                continue
            # Stripes interleave by step: (word, rank) is cursor order.
            entries[j].sort()
            self._pending[j].append({
                "ne": ne_rows[j], "nh": nh_rows[j], "entries": entries[j],
                "overflow": overflow and bool(nh_rows[j]),
                "b_lo": b_lo - base_rows[j], "b_hi": b_hi - base_rows[j],
                "disp_t": disp_t, "inflight": len(self._inflight),
                "hit_occupancy": hit_occupancy,
            })
        self.dispatches += 1
        # The stats counters record even under A5GEN_TELEMETRY=off: the
        # hatch changes what is instrumented, never what is reported.
        total = (self.steps * self._lanes * len(self._devices)
                 * max(1, self.pair_k))
        self.last_fill = occupied / max(1, total)
        tier_lanes = GROUP_LANES.setdefault(self.tier, [0, 0])
        tier_lanes[0] += occupied
        tier_lanes[1] += total
        telemetry.counter("engine.packed_dispatches").add(1)
        telemetry.counter("engine.packed_lanes_occupied").add(occupied)
        telemetry.counter("engine.packed_lanes_total").add(total)
        return True

    # -- host bookkeeping ----------------------------------------------

    def _recover_pump(self, exc: BaseException, attempts: int) -> None:
        """The packed round's transient recovery: the shared gate
        (``faults.supervise_retry``) re-raises or backs off; on retry, drop
        the in-flight dispatches, rebuild the buffer sets and reset every
        active segment's cursor to its last split boundary."""
        faults.supervise_retry(
            exc, attempts, attempts_budget=self._retry_attempts,
            backoff_s=self._retry_backoff_s, label="the packed round")
        self._inflight.clear()
        self._free = [self._make_bufs() for _ in range(self.depth)]
        self._b0 = np.where(np.asarray(self._active), self._consumed,
                            self._seg_end).astype(np.int64)

    def _work_remains(self) -> bool:
        return bool(np.any(np.asarray(self._active)
                           & (self._b0 < self._seg_end)))

    def _occupied(self, j: int, b_lo: int, b_hi: int) -> int:
        """Candidate lanes member ``j``'s packed-global block range
        ``[b_lo, b_hi)`` occupies (zero-count tail blocks excluded)."""
        if b_hi <= b_lo:
            return 0
        m = self._members[j]
        base = int(self._blk_base[j])
        blocks = np.arange(b_lo - base, b_hi - base, dtype=np.int64)
        cum = np.asarray(m["cum"], dtype=np.int64)
        totals = np.asarray(m["totals"], dtype=np.int64)
        blocks = blocks[blocks < cum[-1]]
        if not blocks.size:
            return 0
        w = np.searchsorted(cum, blocks, side="right") - 1
        rank0 = (blocks - cum[w]) * self.stride
        return int(np.clip(totals[w] - rank0, 0, self.stride).sum())


def _as_i32(a: np.ndarray) -> np.ndarray:
    """int32 host copy; uint32 words keep their bits."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _device_ctx(d: torch.device):
    """Make ``d`` the current card for the block (a no-op off CUDA)."""
    from contextlib import nullcontext

    return torch.cuda.device(d) if d.type == "cuda" else nullcontext()
