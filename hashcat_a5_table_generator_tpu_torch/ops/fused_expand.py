"""The fused decode + splice + MD5 piece kernel: gates, wrapper, plain version.

Counterpart of the reference package's ``ops/pallas_expand.py`` for the one
tier this slice runs: the per-slot piece kernel (``_make_piece_kernel``) in
its match / scalar-units / full-enumeration tier, MD5, at K=1 (1-3 chained
hash blocks) and at K=2 (the pair tier, one hash block).

* The host gates (:func:`eligible`, :func:`k_opts_for`,
  :func:`scalar_units_for`, :func:`pair_for_config`,
  :func:`opts_for_config`, :func:`_hash_blocks_for`) decide on the host,
  from the plan and schema alone, whether a launch can take the kernel.
  :func:`kernel_refusal` names the first reason it cannot; the sweep raises
  ``NotImplementedError`` with it before any launch.
* :func:`fused_expand_md5` is the wrapper.  For CUDA tensors it launches
  the hand-written kernel of ``csrc/piece_md5.cu`` (or raises); for CPU
  tensors it runs :func:`piece_md5_reference`, the plain PyTorch version
  of the same function.  ``LAUNCHES`` counts kernel launches by kernel and
  ``PLAIN_CALLS`` counts runs of the plain version.

Contract (the reference's): for every EMITTED candidate the state equals
the MD5 of the candidate bytes the host would splice, and the emit mask is
exact; non-emitted rows may hold anything.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .hashes import lsr, md5_words

#: Piece-kernel bounds: packed chosen vectors must stay well inside int32
#: (``_MAX_SLOTS``), values pack into one u32 (<= 4 bytes), and up to
#: ``_MAX_HASH_BLOCKS`` chained hash blocks (candidates to 183 bytes).
_MAX_SLOTS = 24
_MAX_HASH_BLOCKS = 3

#: Group descriptor layout shared with ``csrc/piece_md5.cu`` (D_* there).
DESC_WIDTH = 16
MAX_GROUPS = 256
MAX_SEL = 4

#: Kernel launches by kernel name, and runs of the plain version — plain
#: integers the caller may reset; nothing else is global.
LAUNCHES = {"piece_md5_k1": 0, "piece_md5_pair": 0}
PLAIN_CALLS = 0


def eligible(
    *,
    mode: str,
    algo: str,
    windowed: bool,
    out_width: int,
    num_slots: int,
    max_val_len: int,
    max_options: int,
) -> bool:
    """Static eligibility of a launch configuration for the piece kernel
    (the reference's ``eligible`` without the TPU tiling rules: block
    strides and counts are free on the GPU)."""
    return (
        mode == "default"
        and algo == "md5"
        and not windowed
        and 0 < out_width
        and out_width + 9 <= 64 * _MAX_HASH_BLOCKS
        and 1 <= num_slots <= _MAX_SLOTS
        and 1 <= max_val_len <= 4
        and max_options == 1
    )


def k_opts_for(plan) -> int:
    """Static per-key option count K (Python int scalar) — the decode's
    radix bound, from the plan's ``pat_radix`` int32 ``[B, P]`` matrix."""
    return max(1, int(plan.pat_radix.max()) - 1)


def scalar_units_for(plan) -> "bool | str":
    """Host gate for the K=1 scalar tier.

    K=1 plans have all radices <= 2, so a lane's chosen-slot vector is
    exactly the binary digits of ``packed_base + rank``.  Match plans
    additionally need at most one match START per byte position.  Returns
    ``"single"`` when every active match span is one byte (all shipped 1:1
    layout maps), ``True`` for unique starts, ``False`` otherwise."""
    if k_opts_for(plan) != 1:
        return False
    mp = np.asarray(plan.match_pos)
    act = np.asarray(plan.match_radix) > 1
    if not np.where(act, np.asarray(plan.match_len) > 1, False).any():
        return "single"
    m = mp.shape[1]
    # Inactive (padding) slots sit at distinct negative positions so they
    # can never collide with real starts or each other.
    pos = np.where(act, mp, -1 - np.arange(m, dtype=mp.dtype)[None, :])
    srt = np.sort(pos, axis=1)
    return not bool((srt[:, 1:] == srt[:, :-1]).any())


def scalar_units_weight(plan) -> np.ndarray:
    """Per-slot bit weights int32 ``[B, P]``: ``1 << bitpos`` for active
    slots (``bitpos`` = active slots before it), 0 for padding.  A block's
    packed chosen vector is ``pbase = sum(base_digits * weight[word])``."""
    act = (np.asarray(plan.pat_radix) > 1).astype(np.int32)
    bitpos = np.cumsum(act, axis=1) - act
    return (act << bitpos).astype(np.int32)


def _hash_blocks_for(out_width: "int | None", scale: int = 1) -> int:
    """Static hash-block count for a launch: the longest emitted candidate
    (``out_width`` bytes) plus terminator and 8-byte length must fit
    ``64 * n`` bytes."""
    if out_width is None:
        return 1
    return max(1, -(-(int(out_width) * scale + 9) // 64))


def pair_for_config(spec, plan, pieces, *,
                    block_stride: "int | None") -> "int | None":
    """Pair-lane eligibility: 2 when this launch configuration can take
    the pair tier, else None — a pair-eligible
    schema, full enumeration, one hash block, and doubled in-block ranks
    that stay far inside int32."""
    if pieces is None or not getattr(pieces, "pair_ok", False):
        return None
    if getattr(plan, "windowed", False):
        return None
    if block_stride is None or 2 * block_stride > (1 << 24):
        return None
    if _hash_blocks_for(int(plan.out_width)) != 1:
        return None
    return 2


def opts_for_config(spec, plan, ct) -> "int | None":
    """The static option count K (1) when the plan can take the piece
    kernel's scalar tier, else None."""
    ok = eligible(
        mode=spec.mode,
        algo=spec.algo,
        windowed=bool(getattr(plan, "windowed", False)),
        out_width=int(plan.out_width),
        num_slots=int(plan.num_slots),
        max_val_len=int(ct.max_val_len),
        max_options=k_opts_for(plan),
    )
    return 1 if ok and scalar_units_for(plan) else None


def kernel_refusal(spec, plan, ct, pieces) -> "str | None":
    """Why the piece kernel cannot take this plan (None = it can).  The
    first failing condition, in the order a reader would check them."""
    if pieces is None:
        return "the plan has no per-slot piece schema (piece_schema_for)"
    k = k_opts_for(plan)
    if k > 1:
        return f"multi-option table (K={k}): the general tier"
    if getattr(plan, "windowed", False):
        return "count-windowed plan: the windowed tier"
    hb = _hash_blocks_for(int(plan.out_width))
    if hb > _MAX_HASH_BLOCKS:
        return f"{hb} hash blocks (out_width {plan.out_width})"
    if not scalar_units_for(plan):
        return "colliding match starts: the general tier"
    if opts_for_config(spec, plan, ct) is None:
        return (f"launch configuration outside the kernel's bounds "
                f"(slots {plan.num_slots} <= {_MAX_SLOTS}, values "
                f"<= 4 bytes)")
    return _schema_refusal(pieces)


def _schema_refusal(pieces) -> "str | None":
    """Why the kernels cannot read this schema (None = they can): the
    descriptor table's size, and groups whose variant index is not a bit
    field of the packed chosen vector (the general tier's schemas)."""
    if len(pieces.groups) > MAX_GROUPS:
        return f"{len(pieces.groups)} emission groups > {MAX_GROUPS}"
    for grp in pieces.groups:
        if grp.n_variants > 1 and (
            len(grp.sel_cols) > MAX_SEL
            or grp.n_variants != 1 << len(grp.sel_cols)
            or max(grp.sel_cols) >= 31
        ):
            return "a group outside the scalar tier's bit-field selects"
    return None


def group_descriptors(pieces) -> np.ndarray:
    """The schema's static group structure as int32 ``[NG, DESC_WIDTH]``
    rows for the kernel (field order: ``D_*`` in ``csrc/piece_md5.cu``)."""
    out = np.zeros((len(pieces.groups), DESC_WIDTH), np.int32)
    for gi, grp in enumerate(pieces.groups):
        sel = list(grp.sel_cols)[:MAX_SEL]
        out[gi, 0] = len(sel)
        out[gi, 1:1 + MAX_SEL] = sel + [-1] * (MAX_SEL - len(sel))
        out[gi, 5] = grp.n_variants
        out[gi, 6] = grp.n_words
        out[gi, 7] = grp.off_floor
        out[gi, 8] = grp.off_cap
        out[gi, 9] = -1 if grp.len_fixed is None else grp.len_fixed
        out[gi, 10] = int(grp.packed16)
        out[gi, 11] = grp.tab_idx
        out[gi, 12] = grp.gl_idx
        out[gi, 13] = int(grp.has_term)
    return out


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def fused_expand_md5(
    blk_word: torch.Tensor,  # int32 [NB] — plan row of each block
    blk_count: torch.Tensor,  # int32 [NB] — candidates in each block
    pbase: torch.Tensor,  # int32 [NB] — each block's packed chosen vector
    tables: dict,  # "pw"/"pw16"/"pl" piece tables (int32) + "desc"
    *,
    pieces,
    block_stride: int,
    out_width: int,
    min_substitute: int,
    max_substitute: int,
    pair: bool = False,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fused decode + splice + MD5 over ``NB`` blocks of ``block_stride``
    lanes.

    Returns ``(state int32[N, 4], emit bool[N])`` with ``N = NB *
    block_stride`` candidates, or ``2 * NB * block_stride`` under ``pair``
    (member ``p`` of lane ``r`` of block ``b`` at row ``b * 2 * stride +
    2r + p`` — candidate-rank order; blocks then span ``2 * stride``
    ranks and ``blk_count`` counts candidates).

    Schemas this package has no kernel for (the general tier's, more than
    3 hash blocks) raise ``NotImplementedError``; callers gate plans with
    :func:`kernel_refusal` first."""
    hb = _hash_blocks_for(out_width)
    if hb > _MAX_HASH_BLOCKS:
        raise NotImplementedError(f"piece kernel: {hb} hash blocks > 3")
    why = _schema_refusal(pieces)
    if why is not None:
        raise NotImplementedError(f"piece kernel: {why}")
    if pair and (not pieces.pair_ok or hb != 1):
        raise ValueError(
            "pair=True needs a pair-eligible PieceSchema and one hash "
            "block; gate via pair_for_config"
        )
    nb = int(blk_word.shape[0])
    for name, t in (("blk_word", blk_word), ("blk_count", blk_count),
                    ("pbase", pbase)):
        if t.dtype != torch.int32 or t.shape != (nb,):
            raise ValueError(f"{name} must be int32 [{nb}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    args = dict(pieces=pieces, block_stride=block_stride,
                hash_blocks=hb, min_substitute=min_substitute,
                max_substitute=max_substitute, pair=pair)
    if blk_word.device.type == "cpu":
        return piece_md5_reference(blk_word, blk_count, pbase, tables,
                                   **args)
    if blk_word.device.type != "cuda":
        raise ValueError(f"unsupported device {blk_word.device}")
    return _launch_cuda(blk_word, blk_count, pbase, tables, **args)


def _table_dims(tables: dict) -> "tuple[int, int, int, int, int]":
    """(ngw, ng16, ngd, vm, nw) of the piece tables (0 for absent ones)."""
    pw, pw16, pl = tables.get("pw"), tables.get("pw16"), tables.get("pl")
    vm = next(int(t.shape[2]) for t in (pw, pw16, pl) if t is not None)
    return (
        0 if pw is None else int(pw.shape[1]),
        0 if pw16 is None else int(pw16.shape[1]),
        0 if pl is None else int(pl.shape[1]),
        vm,
        0 if pw is None else int(pw.shape[3]),
    )


def _launch_cuda(blk_word, blk_count, pbase, tables, *, pieces,
                 block_stride, hash_blocks, min_substitute, max_substitute,
                 pair):
    from . import _native_build

    lib = _native_build.load("piece_md5")
    dev = blk_word.device
    desc = tables["desc"]
    for name in ("pw", "pw16", "pl", "desc"):
        t = tables.get(name)
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(
                f"piece table {name} must be a contiguous int32 tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    for t in (blk_word, blk_count, pbase):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("block fields must be contiguous, on one device")
    if int(desc.shape[0]) != len(pieces.groups):
        raise ValueError("group descriptors do not match the schema")
    nb = int(blk_word.shape[0])
    rows = nb * block_stride * (2 if pair else 1)
    state = torch.empty((rows, 4), dtype=torch.int32, device=dev)
    emit = torch.empty((rows,), dtype=torch.bool, device=dev)

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    ngw, ng16, ngd, vm, nw = _table_dims(tables)
    common = [
        ptr(blk_word), ptr(blk_count), ptr(pbase),
        ctypes.c_int(nb), ctypes.c_int(block_stride),
        ptr(tables.get("pw")), ptr(tables.get("pw16")), ptr(tables.get("pl")),
        ctypes.c_int(ngw), ctypes.c_int(ng16), ctypes.c_int(ngd),
        ctypes.c_int(vm), ctypes.c_int(nw),
        ptr(desc), ctypes.c_int(int(desc.shape[0])),
        ctypes.c_int(min_substitute), ctypes.c_int(max_substitute),
    ]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if pair:
        fn, name = lib.a5_piece_md5_pair, "piece_md5_pair"
        call = common + [ptr(state), ptr(emit), stream]
    else:
        fn, name = lib.a5_piece_md5_k1, "piece_md5_k1"
        call = common + [ctypes.c_int(hash_blocks), ptr(state), ptr(emit),
                         stream]
    fn.restype = ctypes.c_int
    err = fn(*call)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return state, emit


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 lanes."""
    x = x - (lsr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (lsr(x, 2) & 0x33333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F
    x = x + lsr(x, 8)
    return (x + lsr(x, 16)) & 0x3F


def _plain_message(cb, w, tables, pieces, hash_blocks):
    """The candidate message of each lane (int32 ``[N, 16*HB]``) and its
    length — the kernel's ``build_message`` + length words, in tensors."""
    n = cb.shape[0]
    dev = cb.device
    nw_data = 16 * hash_blocks - 2
    msg = [torch.zeros((n,), dtype=torch.int32, device=dev)
           for _ in range(16 * hash_blocks)]
    off = torch.zeros((n,), dtype=torch.int32, device=dev)
    for grp in pieces.groups:
        if grp.len_fixed == 0:
            continue
        idx = torch.zeros((n,), dtype=torch.int64, device=dev)
        if grp.n_variants > 1:
            for i, c in enumerate(grp.sel_cols):
                idx |= (lsr(cb, c) & 1).long() << i
            idx = torch.clamp(idx, max=grp.n_variants - 1)
        for wi in range(grp.n_words):
            if grp.packed16:
                wd = tables["pw16"][w, grp.tab_idx, idx]
            else:
                wd = tables["pw"][w, grp.tab_idx, idx, wi]
            o = off + 4 * wi
            q = o >> 2
            sh = (o & 3) * 8
            lo = wd << sh
            hi = torch.where(sh > 0, lsr(wd, (32 - sh) & 31), 0)
            for j in range(nw_data):
                msg[j] = msg[j] | torch.where(q == j, lo, 0) \
                    | torch.where(q + 1 == j, hi, 0)
        if grp.len_fixed is not None:
            off = off + grp.len_fixed
        else:
            off = off + tables["pl"][w, grp.gl_idx, idx]
    end = off - 1
    bits = end * 8
    for k in range(hash_blocks):
        fits = end <= 64 * (k + 1) - 9
        if k + 1 < hash_blocks:
            bits_k = torch.where(fits, bits, 0)
        else:
            bits_k = bits
        msg[16 * k + 14] = msg[16 * k + 14] | bits_k
    return torch.stack(msg, dim=1), end


def piece_md5_reference(blk_word, blk_count, pbase, tables, *, pieces,
                        block_stride, hash_blocks, min_substitute,
                        max_substitute, pair):
    """Plain PyTorch version of the piece kernel: the same function over
    int32 ``[N]`` lanes (wrapping adds, logical right shifts by masking),
    on whatever device the inputs live on.  Same outputs as
    :func:`fused_expand_md5`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    dev = blk_word.device
    nb = int(blk_word.shape[0])
    lane = torch.arange(nb * block_stride, dtype=torch.int64, device=dev)
    blk = lane // block_stride
    r = (lane - blk * block_stride).to(torch.int32)
    w = blk_word.long()[blk]
    count = blk_count[blk]
    base = pbase[blk]

    def window(cc):
        return (cc >= min_substitute) & (cc <= max_substitute)

    if not pair:
        cb = base + r
        msg, end = _plain_message(cb, w, tables, pieces, hash_blocks)
        emit = (r < count) & window(_popcount(cb))
        return md5_words(msg, end), emit
    cb = base + 2 * r
    cc = _popcount(cb)
    states, emits = [], []
    for p in (0, 1):
        msg, end = _plain_message(cb | p, w, tables, pieces, 1)
        states.append(md5_words(msg, end))
        emits.append((2 * r + p < count) & window(cc + p))
    state = torch.stack(states, dim=1).reshape(-1, 4)
    emit = torch.stack(emits, dim=1).reshape(-1)
    return state, emit
