"""The crack pipeline: on-device block cutting -> piece or byte-scan kernel
(expand + hash), or the XLA expand + hash route -> digest membership -> hit
compaction; and the candidates pipeline: block cutting -> expansion.

The host compiles tables, plans (match plans for default and reverse mode,
substitute-all plans for ``-s`` and ``-s -r``), the piece schema (or, for
a plan without one, the byte-scan tier's per-word fields), the block index
and the digest set once per sweep (numpy); :func:`device_arrays` ships
them to the device as tensors.  :func:`make_superstep_body` then runs
``steps`` fused launches per call with nothing crossing back to the host:
each step cuts its blocks from the cumulative index, runs the piece kernel
(``ops.fused_expand.fused_expand_md5``) or the byte-scan kernel
(``ops.bytescan.bytescan_expand``), tests membership
(``ops.membership.digest_member``) and compacts hits into a capped
``(word, rank)`` buffer.  Only the stacked counters (and, on hit-bearing
supersteps, the hit slice) are fetched; the candidate bytes of a hit are
re-derived on the host by :func:`decode_variant`.  The per-launch
pipeline (:func:`make_crack_step`, :func:`make_candidates_step`; a plan
whose index is not int32-safe, or the superstep turned off) runs the same
expand + hash and membership on blocks the host cuts for each launch
(:func:`host_blocks` over ``ops.blocks.make_blocks``) and returns the
launch's hit mask, whose lanes the host maps back to ``(word, rank)``
with ``ops.blocks.lane_cursor``.

Plans the fused kernels do not take (the reference's ``opts_for`` gate)
run the XLA expand + hash route, as the reference does: :func:`_expand`
materializes each candidate's bytes (``ops.expand_matches`` /
``ops.expand_suball``, torch ops) and ``ops.buffer_hash`` hashes them
(TPU kernel row 10's counterpart); :func:`xla_arrays` ships that route's
per-word tables.  Candidates mode (:func:`make_candidates_body`) runs the
expansion alone, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import numpy as np
import torch

from ..ops.buffer_hash import buffer_hash
from ..ops.bytescan import ByteScanTier, bytescan_expand, bytescan_host_tables
from ..ops.expand_matches import (
    MatchPlan,
    build_match_plan,
    expand_matches,
    piece_device_tables,
    unrank_windowed,
)
from ..ops.expand_suball import SubAllPlan, build_suball_plan, expand_suball
from ..ops.fused_expand import (
    fused_expand_md5,
    group_descriptors,
    scalar_units_weight,
    selector_tables,
)
from ..ops.blocks import BlockBatch, pad_batch
from ..ops.membership import DigestSet, digest_member
from ..ops.packing import PackedWords
from ..tables.compile import CompiledTable

#: The reference's four generation modes (``main.go:80-92``).
MODES = ("default", "reverse", "suball", "suball-reverse")
ALGOS = ("md5", "sha1", "md4", "ntlm")

Tree = Dict[str, Any]


@dataclass(frozen=True)
class AttackSpec:
    """Static attack configuration (mode, hash, substitution window)."""

    mode: str = "default"
    algo: str = "md5"
    min_substitute: int = 0
    max_substitute: int = 15

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; one of {ALGOS}")

    @property
    def effective_min(self) -> int:
        """Default mode silently bumps ``min 0 -> 1`` (Q1, main.go:169-171);
        every other mode emits the original word at ``min == 0``."""
        if self.mode == "default":
            return max(1, self.min_substitute)
        return self.min_substitute


def build_plan(spec: AttackSpec, ct: CompiledTable, packed: PackedWords,
               **kwargs: Any) -> "MatchPlan | SubAllPlan":
    """Mode-dispatched host plan with the spec's EFFECTIVE window: match
    plans for default and reverse mode (reverse applies each key's first
    option only), substitute-all plans for ``suball`` and
    ``suball-reverse`` (first option only).  ``kwargs`` go to the plan
    (``out_width``, ``force_windowed``: a streaming sweep's chunk plans
    take the whole dictionary's)."""
    if spec.mode in ("default", "reverse"):
        return build_match_plan(
            ct, packed, first_option_only=spec.mode == "reverse",
            min_substitute=spec.effective_min,
            max_substitute=spec.max_substitute, **kwargs
        )
    return build_suball_plan(
        ct, packed, first_option_only=spec.mode == "suball-reverse",
        min_substitute=spec.effective_min,
        max_substitute=spec.max_substitute, **kwargs
    )


def piece_host_tables(pieces) -> Dict[str, np.ndarray]:
    """A ``PieceSchema``'s data tables as HOST arrays under their
    plan-dict names (``pp_*``), as the reference names them."""
    if pieces is None:
        return {}
    out = {}
    if pieces.gl is not None:
        out["pp_pl"] = pieces.gl
    if pieces.gw is not None:
        out["pp_pw"] = pieces.gw
    if pieces.gw16 is not None:
        out["pp_pw16"] = pieces.gw16
    return out


def _i32(a: np.ndarray) -> np.ndarray:
    """int32 host copy; uint32 words keep their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a.astype(np.int32)


def piece_tables(pieces, *, device) -> Tree:
    """A ``PieceSchema``'s data tables as the piece kernel reads them:
    int32 tensors ``pw`` ``[B, NGW, VM, NW]`` (u32 bits kept), ``pw16``
    ``[B, NG16, VM]`` and ``pl`` ``[B, NGD, VM]`` (widened from u16/u8),
    each absent when the schema has none, plus the group descriptors
    ``desc`` ``[NG, 16]``.  Empty without a schema."""
    if pieces is None:
        return {}
    host = {"desc": group_descriptors(pieces)}
    for name, key in (("pw", "gw"), ("pw16", "gw16"), ("pl", "gl")):
        if getattr(pieces, key) is not None:
            host[name] = getattr(pieces, key)
    return {k: torch.as_tensor(_i32(v), device=device)
            for k, v in host.items()}


def device_arrays(plan, pieces, digests: "DigestSet | None", idx: tuple, *,
                  device, ct: "CompiledTable | None" = None,
                  bytescan: "ByteScanTier | None" = None) -> Tree:
    """Everything a sweep keeps on the device, shipped once: the piece
    tables (:func:`piece_tables`) or, for a plan without a piece schema,
    the byte-scan tier ``bytescan``'s tables
    (``ops.bytescan.bytescan_host_tables`` of ``plan`` and ``ct``: tokens
    and per-byte fields uint8, the rest int32); the block index (``cum``
    ``[B+1]``,
    ``totals`` ``[B]``, ``radix``/``weight`` ``[B, P]`` int32 — plus the
    mixed-radix ``place`` values ``[B, P]`` for full enumeration, or the
    windowed suffix counts ``win_v`` ``[B, P+1, K2]`` — and the block
    count ``total``); a substitute-all plan's selector and closure tables
    (``ops.fused_expand.selector_tables``); and the digest set (``rows``
    ``[D, K]``, ``bitmap``, uint32 bits as int32; none when ``digests`` is
    None, for a sweep that ships its digest set once for all its chunks).  ``radix``, ``win_v``
    and the selector tables are the kernel's resident tables, read by
    word index.  ``idx`` is ``ops.blocks.superstep_index(plan, stride)``,
    or None for the per-launch pipeline, whose blocks are cut on the host
    (no index, place values or block count: ``total`` 0).

    Works from any objects with the reference's field names, so the JAX
    package's host arrays and this package's give the same tensors."""
    radix = np.asarray(plan.pat_radix, dtype=np.int64)
    host = {
        "radix": radix, "weight": scalar_units_weight(plan),
        **selector_tables(plan, pieces), **_index_arrays(plan, radix, idx),
    }
    if digests is not None:
        host.update(rows=digests.rows, bitmap=digests.bitmap)
    if getattr(plan, "windowed", False):
        host["win_v"] = plan.win_v
    out: Tree = {
        k: torch.as_tensor(_i32(v), device=device) for k, v in host.items()
    }
    out.update(piece_tables(pieces, device=device))
    if bytescan is not None:
        for k, v in bytescan_host_tables(plan, ct, bytescan).items():
            v = np.ascontiguousarray(v)
            out[k] = torch.as_tensor(v if v.dtype == np.uint8 else _i32(v),
                                     device=device)
    out["total"] = 0 if idx is None else int(idx[2])
    return out


def _index_arrays(plan, radix: np.ndarray, idx) -> Dict[str, np.ndarray]:
    """The device cutter's host arrays: the block index (``cum``,
    ``totals``) and, for a fully enumerated plan, the mixed-radix
    ``place`` values (slot 0 least significant: every prefix product
    divides a word's variant total, which the int32 index keeps below
    2^30; a windowed plan's full product may not fit, and its blocks start
    at scalar windowed ranks instead).  Empty for the per-launch pipeline
    (``idx`` None)."""
    if idx is None:
        return {}
    out = {"cum": idx[0], "totals": idx[1]}
    if not getattr(plan, "windowed", False):
        out["place"] = np.cumprod(np.concatenate(
            [np.ones((radix.shape[0], 1), np.int64), radix[:, :-1]], axis=1
        ), axis=1)
    return out


def plan_array_keys(plan) -> "tuple[str, ...]":
    """The plan fields the XLA route reads, by the reference's names."""
    if getattr(plan, "match_pos", None) is not None:
        keys = ("tokens", "lengths", "match_pos", "match_len",
                "match_radix", "match_val_start")
    else:
        keys = ("tokens", "lengths", "pat_radix", "pat_val_start",
                "seg_orig_start", "seg_orig_len", "seg_pat")
        if getattr(plan, "close_next", None) is not None:
            keys += ("close_next", "close_mul")
    return keys


def xla_arrays(plan, ct: CompiledTable, pieces, digests, idx: tuple, *,
               device) -> Tree:
    """What the XLA expand + hash route keeps on the device, shipped once:
    the plan's per-word arrays (:func:`plan_array_keys`; ``tokens``
    uint8, the rest int32), the value table ``val_bytes`` uint8 /
    ``val_len`` (a cascade-closed plan's own ``cval_*``), ``win_v`` for a
    windowed plan, the piece schema's tables under ``pp_*``
    (``ops.expand_matches.piece_device_tables``), ``radix``, the block
    index (``cum``, ``totals``, ``place`` and ``total``, as
    :func:`device_arrays` has them; none for the per-launch pipeline) and,
    in crack mode, the digest set (``rows``, ``bitmap``; ``digests`` None
    in candidates mode)."""
    radix = np.asarray(plan.pat_radix, dtype=np.int64)
    host = {k: np.asarray(getattr(plan, k)) for k in plan_array_keys(plan)}
    cval = getattr(plan, "cval_bytes", None)
    host["val_bytes"] = np.asarray(ct.val_bytes if cval is None else cval)
    host["val_len"] = np.asarray(ct.val_len if cval is None
                                 else plan.cval_len)
    host.update(radix=radix, **_index_arrays(plan, radix, idx))
    if getattr(plan, "windowed", False):
        host["win_v"] = plan.win_v
    if digests is not None:
        host.update(rows=digests.rows, bitmap=digests.bitmap)
    out: Tree = {
        k: torch.as_tensor(v if v.dtype == np.uint8 else _i32(v),
                           device=device)
        for k, v in ((k, np.ascontiguousarray(v)) for k, v in host.items())
    }
    if pieces is not None:
        out.update({f"pp_{k}": v for k, v in
                    piece_device_tables(pieces, device=device).items()})
    out["total"] = 0 if idx is None else int(idx[2])
    return out


def _expand(spec: AttackSpec, arrays: Tree, word, count, base, offset=None,
            *, num_lanes: int, out_width: int, block_stride: "int | None",
            radix2: bool = False, pieces=None, pair_k: "int | None" = None):
    """The XLA route's expansion of one launch's blocks (``word`` /
    ``count`` int32 ``[NB]``, ``base`` the base digits ``[NB, P]`` — slot 0
    the scalar windowed rank for a windowed plan; ``offset`` int32
    ``[NB]`` each block's first lane when ``block_stride`` is None, the
    variable-offset layout): ``(cand uint8[N, W],
    cand_len int32[N], word_row int32[N], emit bool[N])``, ``N`` =
    ``num_lanes`` (× ``pair_k``).  The twin of the reference's ``_expand``:
    match plans through ``expand_matches``, substitute-all plans through
    ``expand_suball``, the piece splice when ``pieces`` is given."""
    common = dict(
        num_lanes=num_lanes, out_width=out_width,
        min_substitute=spec.effective_min,
        max_substitute=spec.max_substitute, block_stride=block_stride,
        radix2=radix2, pieces=pieces, pair_k=pair_k,
        piece_tables={k[3:]: v for k, v in arrays.items()
                      if k.startswith("pp_")} if pieces is not None
        else None,
        win_v=arrays.get("win_v"),
    )
    a = arrays
    if spec.mode in ("default", "reverse"):
        return expand_matches(
            a["tokens"], a["lengths"], a["match_pos"], a["match_len"],
            a["match_radix"], a["match_val_start"], a["val_bytes"],
            a["val_len"], word, base, count, offset, **common)
    return expand_suball(
        a["tokens"], a["lengths"], a["pat_radix"], a["pat_val_start"],
        a["seg_orig_start"], a["seg_orig_len"], a["seg_pat"],
        a["val_bytes"], a["val_len"], word, base, count, offset,
        close_next=a.get("close_next"), close_mul=a.get("close_mul"),
        **common)


def _xla_base(arrays: Tree, base: torch.Tensor, windowed: bool
              ) -> torch.Tensor:
    """The XLA expansion's ``[NB, P]`` block base: the digits themselves,
    or a windowed block's scalar rank in slot 0 (zeros elsewhere)."""
    if not windowed:
        return base
    full = torch.zeros((base.shape[0], arrays["radix"].shape[1]),
                       dtype=torch.int32, device=base.device)
    full[:, 0] = base
    return full


def cut_blocks(arrays: Tree, b0: int, num_blocks: int, rank_stride: int,
               decode: str = "scalar"):
    """One launch's blocks from the device-resident index: global
    fixed-stride blocks ``b0 .. b0 + num_blocks``, each ``rank_stride``
    candidate ranks of one word.  Returns ``(word, count, base, rank0)``,
    int32 ``[NB]`` each except ``base``, the decode's block input: the
    packed chosen vector ``pbase`` ``[NB]`` (``decode="scalar"``), the
    base digits ``[NB, P]`` (``"digits"``), or the scalar windowed rank
    ``[NB]`` (``"windowed"``: ``rank0`` itself — ``totals`` are windowed
    totals there).  Blocks past the sweep's end keep count 0 (their lanes
    are masked)."""
    cum, totals = arrays["cum"], arrays["totals"]
    dev = cum.device
    b = b0 + torch.arange(num_blocks, dtype=torch.int64, device=dev)
    w = torch.searchsorted(cum, b.to(torch.int32), right=True).long() - 1
    w = torch.clamp(w, 0, max(int(totals.shape[0]) - 1, 0))
    valid = b < arrays["total"]
    rank0 = torch.where(valid, (b - cum[w]) * rank_stride, 0)
    count = torch.where(
        valid, torch.clamp(totals[w] - rank0, 0, rank_stride), 0
    )
    if decode == "windowed":
        base = rank0
    else:
        # Mixed-radix decompose of each block's first rank; the scalar
        # tier packs it to its chosen vector: pbase = sum(digit * weight).
        base = (rank0[:, None] // arrays["place"][w]) % arrays["radix"][w]
        if decode == "scalar":
            base = (base * arrays["weight"][w]).sum(dim=1)
    return (w.to(torch.int32), count.to(torch.int32),
            base.to(torch.int32).contiguous(), rank0.to(torch.int32))


def superstep_buffers(hit_cap: int, *, device) -> Tree:
    """One hit-buffer set (slot ``hit_cap`` is the trash slot).  The
    sweep cycles two; contents never need resetting — the host reads only
    the entries the superstep wrote."""
    return {
        "hit_word": torch.full((hit_cap + 1,), -1, dtype=torch.int32,
                               device=device),
        "hit_rank": torch.zeros((hit_cap + 1,), dtype=torch.int32,
                                device=device),
    }


def _launch_expand(
    spec: AttackSpec, *, num_lanes: int, out_width: int,
    block_stride: "int | None",
    pieces, pair_k: "int | None" = None, decode: str = "scalar",
    pack_cb: bool = False, k_opts: int = 1,
    bytescan: "ByteScanTier | None" = None, xla: bool = False,
    windowed: bool = False, radix2: bool = False,
) -> "tuple[Callable[..., Any], str]":
    """``(expand, decode)``: one launch's expand + hash,
    ``expand(word, count, base, arrays, offset=None) -> (state, emit)``
    over blocks whose ``base`` is the block input of the decode tier
    ``decode`` (see :func:`cut_blocks`) — the piece kernel, the byte-scan
    kernel of ``bytescan``, or, with ``xla``, the XLA route (see
    :func:`make_superstep_body`), the only one that takes the
    variable-offset layout (``block_stride`` None: ``offset`` each block's
    first lane), as in the reference."""
    if block_stride is None and not xla:
        raise ValueError("the fused kernels take the fixed-stride block "
                         "layout; the variable-offset layout runs the XLA "
                         "route")
    window = dict(block_stride=block_stride, out_width=out_width,
                  min_substitute=spec.effective_min,
                  max_substitute=spec.max_substitute, algo=spec.algo)
    if xla:
        def expand(word, count, base, arrays, offset=None):
            cand, clen, _, emit = _expand(
                spec, arrays, word, count,
                _xla_base(arrays, base, windowed), offset,
                num_lanes=num_lanes,
                out_width=out_width, block_stride=block_stride,
                radix2=radix2, pieces=pieces, pair_k=pair_k)
            return buffer_hash(cand, clen, spec.algo), emit
        return expand, "windowed" if windowed else "digits"
    if bytescan is not None:
        if pieces is not None or pair_k is not None:
            raise ValueError("the byte-scan tiers take plans without a "
                             "piece schema, at K=1")

        def expand(word, count, base, arrays, offset=None):
            return bytescan_expand(word, count, base, arrays, tier=bytescan,
                                   **window)
        return expand, ("scalar" if bytescan.decode == "scalar" else (
            "windowed" if bytescan.decode == "windowed" else "digits"))
    common = dict(pieces=pieces, pair=pair_k is not None, decode=decode,
                  pack_cb=pack_cb, k_opts=k_opts, **window)

    def expand(word, count, base, arrays, offset=None):
        return fused_expand_md5(word, count, base, arrays, **common)
    return expand, decode


def make_superstep_body(
    spec: AttackSpec, *, num_lanes: int, out_width: int, block_stride: int,
    num_blocks: int, pieces, pair_k: "int | None" = None,
    decode: str = "scalar", pack_cb: bool = False, k_opts: int = 1,
    bytescan: "ByteScanTier | None" = None, xla: bool = False,
    windowed: bool = False, radix2: bool = False,
    step_advance: "int | None" = None,
) -> Callable[..., Tree]:
    """The superstep executor: ``body(arrays, b0, steps, bufs) -> dict``
    runs ``steps`` fused launches starting at global block ``b0``, with no
    host sync inside.  Each step cuts ``num_blocks`` blocks (step ``s``
    from block ``b0 + s * step_advance``; ``step_advance`` defaults to
    ``num_blocks``, and a cursor stripe of ``parallel.devices`` passes
    ``num_blocks`` times the stripes), runs the
    piece kernel of ``spec.algo`` with the plan's decode tier (``decode``,
    ``pack_cb``, ``k_opts``: ``ops.fused_expand.decode_for`` and
    ``k_vals_for``) — K=1, or the pair tier with ``pair_k`` = 2: blocks
    then span ``2 * block_stride`` candidate ranks on ``block_stride``
    lanes — or, for a plan without a piece schema, the byte-scan kernel of
    the tier ``bytescan`` (``ops.bytescan.bytescan_tier``; ``pieces`` None),
    or, with ``xla``, the XLA expand + hash route (:func:`_expand` over
    :func:`xla_arrays`' tables, the piece splice when ``pieces`` is given,
    then ``ops.buffer_hash``; ``windowed`` / ``radix2`` the plan's decode),
    tests membership, and compacts hits in cursor order into ``bufs``
    (``hit_word``/``hit_rank`` int32 ``[hit_cap + 1]``).  Returns the
    buffers and ``counters`` int32 ``[2]`` = ``[n_emitted, n_hits]``
    (callers keep ``steps * num_lanes * pair_k`` below 2^31).  Hits past
    the cap are dropped into the trash slot; the host sees the overflow
    in ``n_hits`` and re-runs the superstep with a larger buffer."""
    rank_stride = block_stride * (pair_k or 1)
    num_cands = num_lanes * (pair_k or 1)
    advance = num_blocks if step_advance is None else int(step_advance)
    expand, decode = _launch_expand(
        spec, num_lanes=num_lanes, out_width=out_width,
        block_stride=block_stride, pieces=pieces, pair_k=pair_k,
        decode=decode, pack_cb=pack_cb, k_opts=k_opts, bytescan=bytescan,
        xla=xla, windowed=windowed, radix2=radix2)

    def body(arrays: Tree, b0: int, steps: int, bufs: Tree) -> Tree:
        hw, hr = bufs["hit_word"], bufs["hit_rank"]
        hit_cap = int(hw.shape[0]) - 1
        dev = hw.device
        lane = torch.arange(num_cands, dtype=torch.int32, device=dev)
        blk = (lane // rank_stride).long()
        lane_in = lane - blk.to(torch.int32) * rank_stride
        kk = torch.arange(hit_cap, dtype=torch.int32, device=dev)
        ne = torch.zeros((), dtype=torch.int32, device=dev)
        nh = torch.zeros((), dtype=torch.int32, device=dev)
        for s in range(steps):
            word, count, base, rank0 = cut_blocks(
                arrays, b0 + s * advance, num_blocks, rank_stride, decode
            )
            state, emit = expand(word, count, base, arrays)
            hit = digest_member(state, arrays["rows"], arrays["bitmap"])
            hit &= emit
            ne += emit.sum(dtype=torch.int32)
            csum = torch.cumsum(hit, dim=0, dtype=torch.int32)
            nh_step = csum[-1]
            # Compacting scatter without a host sync: the k-th hit of this
            # step is the first lane whose running count reaches k + 1;
            # slots past the cap (and k past this step's hits) land in the
            # trash slot.
            at = torch.clamp(torch.searchsorted(csum, kk + 1), max=num_cands - 1)
            slot = nh + kk
            dest = torch.where((kk < nh_step) & (slot < hit_cap), slot,
                               hit_cap).long()
            hw.scatter_(0, dest, word[blk[at]])
            hr.scatter_(0, dest, rank0[blk[at]] + lane_in[at])
            nh += nh_step
        return {"counters": torch.stack([ne, nh]), "hit_word": hw,
                "hit_rank": hr}

    return body


def host_blocks(batch: BlockBatch, num_blocks: int, decode: str,
                weight: np.ndarray, *, device, packed: bool = False
                ) -> "tuple[torch.Tensor, ...]":
    """One per-launch step's block inputs from a host-cut batch
    (``ops.blocks.make_blocks``), padded to ``num_blocks`` with zero-count
    blocks: ``(word, count, base)`` int32 tensors, ``base`` the decode
    tier's block input as :func:`cut_blocks` gives it — the packed chosen
    vector (``weight``: ``ops.fused_expand.scalar_units_weight`` of the
    plan), the base digits ``[NB, P]`` or the windowed rank — and, for the
    variable-offset layout (``packed``), each block's first lane
    ``offset``."""
    batch = pad_batch(batch, num_blocks)
    digits = batch.base_digits
    if decode == "scalar":
        base = (digits.astype(np.int64) * weight[batch.word]).sum(axis=1)
    elif decode == "windowed":
        base = digits[:, 0]  # windowed blocks start at scalar ranks
    else:
        base = digits
    fields = (batch.word, batch.count, base) + (
        (batch.offset,) if packed else ())
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                 device=device) for a in fields)


def make_crack_step(spec: AttackSpec, **kwargs: Any) -> Callable[..., Tree]:
    """The per-launch pipeline's crack step (the reference's
    ``make_crack_step``): ``step(arrays, word, count, base, offset=None)
    -> dict`` runs one launch's expand + hash (:func:`_launch_expand`, the
    keyword arguments of :func:`make_superstep_body`; never the pair tier;
    ``block_stride`` None, the variable-offset layout, on the XLA route
    only) and membership on blocks cut on the host (:func:`host_blocks`
    with ``step.decode``), and returns ``counters`` int32 ``[2]`` =
    ``[n_emitted, n_hits]`` and the launch's ``hit`` mask (bool, one row a
    lane), left on the device."""
    if kwargs.get("pair_k") is not None:
        raise ValueError("the per-launch pipeline runs K=1")
    kwargs.pop("num_blocks", None)
    expand, decode = _launch_expand(spec, **kwargs)

    def step(arrays: Tree, word, count, base, offset=None) -> Tree:
        state, emit = expand(word, count, base, arrays, offset)
        hit = digest_member(state, arrays["rows"], arrays["bitmap"]) & emit
        return {"counters": torch.stack([emit.sum(dtype=torch.int32),
                                         hit.sum(dtype=torch.int32)]),
                "hit": hit}

    step.decode = decode
    return step


def make_candidates_step(
    spec: AttackSpec, *, num_lanes: int, out_width: int,
    block_stride: "int | None", pieces=None, windowed: bool = False,
    radix2: bool = False,
) -> Callable[..., Any]:
    """Candidates mode, one launch over given blocks: ``step(arrays,
    word, count, base, offset=None) -> (cand, cand_len, word_row)`` of the
    EMITTED rows (:func:`xla_arrays` without digests; ``offset`` for the
    variable-offset layout, ``block_stride`` None), compacted on the
    device in row
    order — word order, and rank order within a word.  The expansion is
    the XLA route's (:func:`_expand`), as the reference's
    ``make_candidates_body``; no pair tier.  ``step.decode`` names the
    block input ``base`` takes (:func:`cut_blocks`)."""

    def step(arrays: Tree, word, count, base, offset=None):
        cand, clen, word_row, emit = _expand(
            spec, arrays, word, count, _xla_base(arrays, base, windowed),
            offset, num_lanes=num_lanes, out_width=out_width,
            block_stride=block_stride, radix2=radix2, pieces=pieces)
        keep = torch.nonzero(emit).flatten()
        return cand[keep], clen[keep], word_row[keep]

    step.decode = "windowed" if windowed else "digits"
    return step


def make_candidates_body(spec: AttackSpec, *, num_blocks: int,
                         **kwargs: Any) -> Callable[..., Any]:
    """Candidates mode, one launch cut on the device: ``body(arrays, b0)``
    runs :func:`make_candidates_step` (its keyword arguments) on blocks
    ``b0 .. b0 + num_blocks`` of the resident index."""
    step = make_candidates_step(spec, **kwargs)

    def body(arrays: Tree, b0: int):
        word, count, base, _ = cut_blocks(arrays, b0, num_blocks,
                                          kwargs["block_stride"], step.decode)
        return step(arrays, word, count, base)

    return body


# ---------------------------------------------------------------------------
# Host-side variant decode (hit reporting)
# ---------------------------------------------------------------------------


def decode_variant(
    plan: "MatchPlan | SubAllPlan", ct: CompiledTable, spec: AttackSpec,
    word_idx: int, rank: int,
) -> bytes:
    """Reconstruct the candidate bytes of one variant on the host, exactly
    as the device splices it; windowed plans unrank through ``win_v``
    (``ops.expand_matches.unrank_windowed``), cascade-closed plans read
    their own value table at the joint closure index.  Raises
    ``ValueError`` for ranks the device would not emit (overlap clashes or
    count-window misses)."""
    radices = [int(x) for x in plan.pat_radix[word_idx]]
    if getattr(plan, "windowed", False):
        digits = unrank_windowed(plan.win_v[word_idx], radices, rank)
    else:
        digits = []
        r = rank
        for radix in radices:
            digits.append(r % radix)
            r //= radix
        if r:
            raise ValueError(f"rank {rank} out of range for word {word_idx}")
    word = bytes(plan.tokens[word_idx, : plan.lengths[word_idx]])
    cval = getattr(plan, "cval_bytes", None)
    val_bytes = ct.val_bytes if cval is None else cval
    val_lens = ct.val_len if cval is None else plan.cval_len

    def val(vrow: int) -> bytes:
        return bytes(val_bytes[vrow, : val_lens[vrow]])

    if getattr(plan, "match_pos", None) is not None:
        chosen = [
            (int(plan.match_pos[word_idx, s]),
             int(plan.match_len[word_idx, s]),
             int(plan.match_val_start[word_idx, s]) + d - 1)
            for s, d in enumerate(digits)
            if d > 0
        ]
        if not (spec.effective_min <= len(chosen) <= spec.max_substitute):
            raise ValueError("variant outside the count window")
        out = []
        cursor = 0
        for pos, klen, vrow in sorted(chosen):
            if pos < cursor:
                raise ValueError("variant has overlapping matches")
            out.append(word[cursor:pos])
            out.append(val(vrow))
            cursor = pos + klen
        out.append(word[cursor:])
        return b"".join(out)

    # Substitute-all plans: walk the static segment list.
    count = sum(1 for s, d in enumerate(digits) if d > 0 and radices[s] > 1)
    if not (spec.effective_min <= count <= spec.max_substitute):
        raise ValueError("variant outside the count window")
    out = []
    close_next = getattr(plan, "close_next", None)
    for g in range(plan.num_segments):
        slot = int(plan.seg_pat[word_idx, g])
        start = int(plan.seg_orig_start[word_idx, g])
        length = int(plan.seg_orig_len[word_idx, g])
        if slot < 0 or digits[slot] == 0:
            out.append(word[start: start + length])
            continue
        jd = digits[slot] - 1
        if close_next is not None:
            # Joint closure index: the own digit scaled by the successor
            # radix product, plus each successor's digit at its place.
            mul = plan.close_mul[word_idx, slot]
            jd = (digits[slot] - 1) * int(mul[0])
            for s_i in range(close_next.shape[2]):
                nxt = int(close_next[word_idx, slot, s_i])
                if nxt >= 0:
                    jd += digits[nxt] * int(mul[1 + s_i])
        out.append(val(int(plan.pat_val_start[word_idx, slot]) + jd))
    return b"".join(out)
