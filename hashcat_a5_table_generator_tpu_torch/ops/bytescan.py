"""The byte-scan tiers: gates, host fields, wrapper, plain version.

Counterpart of the reference package's byte-scan kernels in
``ops/pallas_expand.py`` — the per-byte unit scan that runs a plan which
has no per-slot piece schema (``packing.piece_schema_for`` returns None:
overlapping static spans, such as german's ``ss`` on a word with "sss", or
``A5GEN_EMIT=bytescan``):

* row 7, ``_make_scalar_kernel`` — the K=1 scalar-units tier (``tier.row
  == "scalar"``): the chosen-slot vector ``cb = pbase + rank`` (or the
  windowed walk's chosen bits packed at ``bitpos``), per byte the match
  ``"single"`` variant (one-byte spans), the coverage ``"bitmask"`` variant
  with its clash test, or the ``"suball"`` owner bit + start flag;
* row 8, ``_make_kernel`` — match plans off the scalar tier: radix-2,
  mixed-radix or windowed digits, the K-way value select, the per-byte
  cover count and ``clash = cover > 1``;
* row 9, ``_make_suball_kernel`` — substitute-all plans off the scalar
  tier: per-byte slot ownership, the first byte of a chosen segment emits
  the value, and the joint closure index of a cascade-closed plan.

Host half: :func:`bytescan_tier` (the reference's tier choice),
:func:`scalar_units_fields` (row 7's per-word fields, equal to the
reference's), :func:`suball_ownership` (row 9's ``slotat``/``startat``,
once per word), :func:`option_words` (rows 8/9's per-slot option words),
:func:`check_scalar_units_gate`, and :func:`bytescan_host_tables` (what a
sweep ships to the device once).

:func:`bytescan_expand` is the wrapper: for CUDA tensors it launches the
hand-written kernels of ``csrc/bytescan_hash.cu`` (or raises); for CPU
tensors it runs :func:`bytescan_reference`, the plain PyTorch version of
the same function.  ``LAUNCHES`` counts kernel launches by
``bytescan_<row>/<algo>``, ``PLAIN_CALLS`` runs of the plain version.

Contract (the reference's): ``(state int32[N, DIGEST_WORDS[algo]], emit
bool[N])``; for every EMITTED candidate the state equals the hash of the
candidate bytes, and the emit mask is exact (overlap clashes masked).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ..audit import audited_entry
from . import _native_build
from .fused_expand import (
    ALGOS,
    _decode_digits,
    _decode_windowed,
    _hash_blocks_for,
    _MAX_HASH_BLOCKS,
    _MAX_OPTIONS,
    _MAX_SLOTS,
    _MAX_TOKENS,
    _MAX_WIN_K2,
    _popcount,
    _scale,
    k_vals_for,
    scalar_units_for,
    scalar_units_tier,
    scalar_units_weight,
)
from .hashes import DIGEST_WORDS, hash_words, length_word, lsr

#: The byte-scan kernels: TPU kernel rows 7 (``scalar``), 8 (``match``)
#: and 9 (``suball``).
ROWS = ("scalar", "match", "suball")
#: Row 7's per-byte variants.
VARIANTS = ("single", "bitmask", "suball")
#: Decode ids shared with ``csrc/bytescan_hash.cu`` (DECODE_* there).
DECODE_ID = {"scalar": 0, "digits": 1, "windowed": 2, "radix2": 3}
#: Successor slots of a cascade-closed slot (the kernel's MAX_SUCC; the
#: plans' ``expand_suball.MAX_CLOSE_SUCC``).
_MAX_SUCC = 3

#: Kernel launches by ``bytescan_<row>/<algo>`` and runs of the plain
#: version: plain integers the caller may reset; nothing else is global.
LAUNCHES = {f"bytescan_{row}/{algo}": 0 for algo in ALGOS for row in ROWS}
PLAIN_CALLS = 0


@dataclass(frozen=True)
class ByteScanTier:
    """The byte-scan kernel a plan takes, as the reference's wrappers pick
    it (:func:`bytescan_tier`)."""

    row: str  # "scalar" (TPU row 7), "match" (row 8), "suball" (row 9)
    decode: str  # row 7: "scalar" | "windowed"; rows 8/9: "radix2" |
    #              "digits" | "windowed"
    variant: str = ""  # row 7: "single" | "bitmask" | "suball"
    closed: bool = False  # row 9: the cascade closure
    k_opts: int = 1  # value-select width (``k_vals_for``)

    @property
    def name(self) -> str:
        """``bytescan_<row>``: the tier's name in sweep summaries."""
        return f"bytescan_{self.row}"

    def launch_key(self, algo: str) -> str:
        return f"bytescan_{self.row}/{algo}"


def bytescan_tier(plan) -> ByteScanTier:
    """The byte-scan tier of a plan without a piece schema, exactly as the
    reference's ``fused_expand_md5`` / ``fused_expand_suball_md5`` choose
    it: row 7 when ``scalar_units_for(plan)`` holds and the value-select
    width is 1 (``"single"`` for one-byte match spans, the coverage
    bitmask otherwise, the owner bit for substitute-all plans); else row 8
    (match plans) or row 9 (substitute-all plans, closed when the plan
    carries ``close_next``).  Windowed plans take the DP decode; rows 8/9
    take the radix-2 decode at K=1 and the mixed-radix decode otherwise."""
    k = k_vals_for(plan)
    match = getattr(plan, "match_pos", None) is not None
    windowed = bool(getattr(plan, "windowed", False))
    su = scalar_units_for(plan)
    if su and k == 1:
        variant = "suball" if not match else (
            "single" if su == "single" else "bitmask")
        return ByteScanTier("scalar", "windowed" if windowed else "scalar",
                            variant=variant, k_opts=1)
    decode = "windowed" if windowed else ("radix2" if k == 1 else "digits")
    if match:
        return ByteScanTier("match", decode, k_opts=k)
    return ByteScanTier("suball", decode, k_opts=k,
                        closed=getattr(plan, "close_next", None) is not None)


def check_scalar_units_gate(scalar_units, match_pos, match_len,
                            match_radix) -> None:
    """Re-validate a row 7 verdict on the host before a launch (the
    reference's ``_check_scalar_units_gate``): a truthy ``scalar_units``
    for a plan with colliding match starts would corrupt the packed start
    field, and ``"single"`` for a plan with multi-byte spans would drop
    its coverage bitmask."""
    tier = scalar_units_tier(match_pos, match_len, match_radix)
    if not tier:
        raise ValueError(
            "scalar_units was passed truthy but the plan has colliding "
            "match starts (scalar_units_for(plan) is False); the K=1 "
            "fast kernel would corrupt the packed start encode. Gate "
            "via scalar_units_for(plan)."
        )
    if scalar_units == "single" and tier != "single":
        raise ValueError(
            'scalar_units="single" was passed but the plan has active '
            "multi-byte match spans (scalar_units_for(plan) returns "
            'True, not "single"); the single-span kernel drops its '
            "coverage bitmask and would mis-splice overlapping spans. "
            "Gate via scalar_units_for(plan)."
        )


# ---------------------------------------------------------------------------
# Host fields (numpy, once per sweep)
# ---------------------------------------------------------------------------


def _value_table(plan, ct) -> "tuple[np.ndarray, np.ndarray]":
    """The value rows a plan's slots address: a cascade-closed plan's own
    ``cval_bytes``/``cval_len``, else the compiled table's."""
    cval = getattr(plan, "cval_bytes", None)
    if cval is not None:
        return np.asarray(cval), np.asarray(plan.cval_len)
    return np.asarray(ct.val_bytes), np.asarray(ct.val_len)


def _packed_values(val_bytes: np.ndarray) -> np.ndarray:
    """Each value row's bytes little-endian-packed into one uint32."""
    out = np.zeros(val_bytes.shape[0], np.uint32)
    for k in range(val_bytes.shape[1]):
        out |= val_bytes[:, k].astype(np.uint32) << np.uint32(8 * k)
    return out


def _ownership_chunk(st, sl, sp, length_axis: int):
    """``(slotat, startat)`` int32 ``[C, L]`` of a row chunk of segment
    fields ``[C, GS]``: the pattern slot owning byte j (-1 free) and its
    segment's span start (0 free) — segments are disjoint."""
    rows = st.shape[0]
    if not sp.shape[1]:
        return (np.full((rows, length_axis), -1, np.int32),
                np.zeros((rows, length_axis), np.int32))
    jj = np.arange(length_axis, dtype=np.int32)[None, None, :]
    st3 = st[:, :, None]
    covered = (sl[:, :, None] > 0) & (jj >= st3) & (jj < st3 + sl[:, :, None])
    slotat = np.where(covered, sp[:, :, None], -1).max(axis=1)
    startat = np.where(covered, st3, 0).max(axis=1)
    return slotat.astype(np.int32), startat.astype(np.int32)


def suball_ownership(plan, *, row_chunk: "int | None" = None
                     ) -> "tuple[np.ndarray, np.ndarray]":
    """Row 9's per-word segment ownership, computed once per word (the
    reference rebuilds it per launch from gathered segments,
    ``pallas_expand.py:2513-2526``): ``slotat`` int32 ``[B, L]``, the
    pattern slot owning byte j (-1 free), and ``startat`` int32 ``[B, L]``,
    its span start (0 free).  Row chunks bound the ``[C, GS, L]``
    intermediates."""
    st = np.asarray(plan.seg_orig_start)
    sl = np.asarray(plan.seg_orig_len)
    sp = np.asarray(plan.seg_pat)
    b, length_axis = np.asarray(plan.tokens).shape
    chunk = row_chunk or max(1, (64 << 20) // max(1, sp.shape[1] * length_axis))
    slotat = np.empty((b, length_axis), np.int32)
    startat = np.empty((b, length_axis), np.int32)
    for lo in range(0, b, chunk):
        r = slice(lo, min(lo + chunk, b))
        slotat[r], startat[r] = _ownership_chunk(st[r], sl[r], sp[r],
                                                 length_axis)
    return slotat, startat


def option_words(plan, ct, k_opts: int) -> "tuple[np.ndarray, np.ndarray]":
    """Rows 8/9's per-slot option words (the reference's
    ``_pack_val_options``, once per word): option k of slot s lives at
    value row ``vstart[w, s] + k`` (clipped to the table) — ``vopt``
    uint32 ``[B, M|P, K]`` (value bytes little-endian-packed) and ``vlen``
    int32 ``[B, M|P, K]``."""
    vb, vl = _value_table(plan, ct)
    match = getattr(plan, "match_pos", None) is not None
    vstart = np.asarray(plan.match_val_start if match else plan.pat_val_start)
    rows = np.clip(vstart[:, :, None].astype(np.int64)
                   + np.arange(k_opts)[None, None, :], 0, vb.shape[0] - 1)
    return _packed_values(vb)[rows], vl[rows].astype(np.int32)


def scalar_units_fields(plan, ct, *, _row_chunk=None) -> "dict | None":
    """Row 7's word-level fields, once per sweep (the reference's
    ``scalar_units_fields``): ``weight`` and ``bitpos`` int32 ``[B, M|P]``;
    match plans ``startp`` uint8 ``[B, L]`` (the bit position of the slot
    starting at byte j, 31 none), ``svl`` uint8 / ``svw`` uint32 (its
    value's length and packed word) and, off the ``"single"`` variant,
    ``ins_bits`` int32 (the weights of the slots covering byte j);
    substitute-all plans ``ownbit`` uint8 (the owning slot's bit position,
    31 free or inactive), ``isstart`` uint8, ``svl``, ``svw``.  None when
    the plan is not scalar-units.  Row chunks bound the intermediates;
    cached on the plan (keyed by the table's identity)."""
    tier = scalar_units_for(plan)
    if not tier:
        return None
    cache = getattr(plan, "_bytescan_fields_cache", None)
    if cache is not None and cache[0] is ct and _row_chunk is None:
        return cache[1]
    radix = np.asarray(plan.pat_radix)
    act = (radix > 1).astype(np.int32)
    bitpos = np.cumsum(act, axis=1) - act  # scalar_units_bitpos, widened
    weight = scalar_units_weight(plan)
    tokens = np.asarray(plan.tokens)
    b, length_axis = tokens.shape
    vw_packed = _packed_values(np.asarray(ct.val_bytes))
    val_len = np.asarray(ct.val_len)
    jj = np.arange(length_axis, dtype=np.int32)[None, None, :]
    is_match = getattr(plan, "match_pos", None) is not None
    out = {"weight": weight, "bitpos": bitpos}
    bl = (b, length_axis)
    out["svl"] = np.empty(bl, np.uint8)
    out["svw"] = np.empty(bl, np.uint32)
    if is_match:
        out["startp"] = np.empty(bl, np.uint8)
        if tier != "single":
            out["ins_bits"] = np.empty(bl, np.int32)
        vs = np.asarray(plan.match_val_start)
        mpos = np.asarray(plan.match_pos)
        mlen = np.asarray(plan.match_len)
        width = mpos.shape[1]
    else:
        out["ownbit"] = np.empty(bl, np.uint8)
        out["isstart"] = np.empty(bl, np.uint8)
        vs = np.asarray(plan.pat_val_start)
        st = np.asarray(plan.seg_orig_start)
        sl = np.asarray(plan.seg_orig_len)
        sp = np.asarray(plan.seg_pat)
        width = sp.shape[1]
    rows = np.clip(vs, 0, len(vw_packed) - 1)
    vw_slot = vw_packed[rows]  # [B, M|P] (K=1: option 0)
    vl_slot = val_len[rows].astype(np.int32)
    chunk = _row_chunk or max(1, (64 << 20) // max(1, width * length_axis))
    for lo in range(0, b, chunk):
        hi = min(lo + chunk, b)
        r = slice(lo, hi)
        if is_match:
            stt = (jj == mpos[r, :, None]) & (act[r, :, None] > 0)
            startp = (stt * (bitpos[r, :, None] + 1)).sum(1)
            out["startp"][r] = np.where(startp == 0, 31, startp - 1)
            out["svl"][r] = (stt * vl_slot[r, :, None]).sum(1)
            out["svw"][r] = (stt.astype(np.uint32)
                             * vw_slot[r, :, None]).sum(1, dtype=np.uint32)
            if tier != "single":
                ps = mpos[r, :, None]
                inside = (jj >= ps) & (jj < ps + mlen[r, :, None])
                out["ins_bits"][r] = (inside * weight[r, :, None]).sum(1)
        else:
            slotat, startat = _ownership_chunk(st[r], sl[r], sp[r],
                                               length_axis)
            owned = slotat >= 0
            sl_clip = np.clip(slotat, 0, radix.shape[1] - 1)
            rows_i = np.arange(lo, hi)[:, None]
            own_act = act[rows_i, sl_clip] > 0
            out["ownbit"][r] = np.where(
                owned & own_act, bitpos[rows_i, sl_clip], 31)
            out["isstart"][r] = (
                owned & (startat == np.arange(length_axis)[None, :]))
            out["svl"][r] = np.where(owned, vl_slot[rows_i, sl_clip], 0)
            out["svw"][r] = np.where(owned, vw_slot[rows_i, sl_clip],
                                     np.uint32(0))
    if _row_chunk is None:
        object.__setattr__(plan, "_bytescan_fields_cache", (ct, out))
    return out


def _i32(a: np.ndarray) -> np.ndarray:
    """int32 host copy; uint32 words keep their bits."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def bytescan_host_tables(plan, ct, tier: ByteScanTier
                         ) -> Dict[str, np.ndarray]:
    """What a byte-scan sweep ships to the device once, as HOST arrays
    under the names :func:`bytescan_expand` reads them by (``radix`` and
    ``win_v`` come with ``models.attack.device_arrays``): ``tokens`` uint8
    ``[B, L]``, ``lengths`` int32 ``[B]``; row 7: ``bj`` uint8 (``startp``
    / ``isstart``), ``svl`` uint8, ``svw`` and, off ``"single"``, ``aj``
    int32 (``ins_bits`` / ``ownbit``) ``[B, L]``, plus ``bitpos`` ``[B, M]``
    when windowed; row 8: ``mpos``/``mlen`` ``[B, M]``; row 9:
    ``slotat``/``startat`` ``[B, L]`` and, closed, ``close_next``/
    ``close_mul``; rows 8/9: ``vopt``/``vlen`` ``[B, M, K]``.  Runs the
    row 7 gate's host re-check."""
    out = {"tokens": np.ascontiguousarray(plan.tokens, np.uint8),
           "lengths": _i32(plan.lengths)}
    match = getattr(plan, "match_pos", None) is not None
    if tier.row == "scalar":
        if match:
            check_scalar_units_gate(
                tier.variant if tier.variant == "single" else True,
                plan.match_pos, plan.match_len, plan.match_radix)
        f = scalar_units_fields(plan, ct)
        out["bj"] = f["startp" if match else "isstart"]
        out["svl"] = f["svl"]
        out["svw"] = _i32(f["svw"])
        if tier.variant != "single":
            out["aj"] = _i32(f["ins_bits" if match else "ownbit"])
        if tier.decode == "windowed":
            out["bitpos"] = _i32(f["bitpos"])
        return out
    vopt, vlen = option_words(plan, ct, tier.k_opts)
    out["vopt"], out["vlen"] = _i32(vopt), vlen
    if tier.row == "match":
        out["mpos"] = _i32(plan.match_pos)
        out["mlen"] = _i32(plan.match_len)
    else:
        out["slotat"], out["startat"] = suball_ownership(plan)
        if tier.closed:
            out["close_next"] = _i32(plan.close_next)
            out["close_mul"] = _i32(plan.close_mul)
    return out


def needed_tables(tier: ByteScanTier) -> "tuple[str, ...]":
    """The names of ``tables`` a launch of ``tier`` reads."""
    names = ["tokens", "lengths"]
    if tier.decode == "windowed":
        names += ["radix", "win_v"]
    if tier.row == "scalar":
        names += ["bj", "svl", "svw"]
        if tier.variant != "single":
            names += ["aj"]
        if tier.decode == "windowed":
            names += ["bitpos"]
    else:
        names += ["radix", "vopt", "vlen"]
        names += ["mpos", "mlen"] if tier.row == "match" \
            else ["slotat", "startat"]
        if tier.closed:
            names += ["close_next", "close_mul"]
    return tuple(dict.fromkeys(names))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


@audited_entry("ops.bytescan_expand", kind="cuda_kernel",
               budget_keys=_native_build.instantiation_keys(
                   "bytescan_hash"))
def bytescan_expand(
    blk_word: torch.Tensor,  # int32 [NB] — plan row of each block
    blk_count: torch.Tensor,  # int32 [NB] — candidates in each block
    base: torch.Tensor,  # int32 [NB] (row 7, windowed) or [NB, M]
    tables: dict,  # bytescan_host_tables + radix / win_v, as tensors
    *,
    tier: ByteScanTier,
    block_stride: int,
    out_width: int,
    min_substitute: int,
    max_substitute: int,
    algo: str = "md5",
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fused decode + byte scan + hash over ``NB`` blocks of
    ``block_stride`` lanes: the counterpart of the byte-scan branches of
    the reference's ``fused_expand_md5`` (``:2117-2211``) and
    ``fused_expand_suball_md5`` (``:2502-2603``), ``tier`` from
    :func:`bytescan_tier`.

    ``base``: row 7's packed chosen vector ``pbase`` ``[NB]`` (full
    enumeration), each block's scalar windowed rank ``[NB]`` (windowed
    decodes), or its base digits ``[NB, M]`` (rows 8/9's radix-2 and
    digit decodes).  Lane ``r`` of block ``b`` is candidate rank ``r`` of
    the block, row ``b * block_stride + r``.

    Returns ``(state int32[N, DIGEST_WORDS[algo]], emit bool[N])``, ``N =
    NB * block_stride``.  CUDA tensors launch the kernel (or raise), CPU
    tensors run :func:`bytescan_reference`."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    if tier.row not in ROWS or tier.decode not in DECODE_ID:
        raise ValueError(f"unknown byte-scan tier {tier}")
    hb = _hash_blocks_for(out_width, _scale(algo))
    if hb > _MAX_HASH_BLOCKS:
        raise NotImplementedError(f"byte-scan kernel: {hb} hash blocks > 3")
    missing = [n for n in needed_tables(tier) if n not in tables]
    if missing:
        raise ValueError(f"byte-scan tier {tier} needs tables {missing}")
    nb = int(blk_word.shape[0])
    length_axis = int(tables["tokens"].shape[1])
    if length_axis > _MAX_TOKENS:
        raise NotImplementedError(
            f"byte-scan kernel: token width {length_axis} > {_MAX_TOKENS}")
    m = int(tables["radix"].shape[1]) if "radix" in tables else 0
    if m > _MAX_SLOTS:
        raise NotImplementedError(f"byte-scan kernel: {m} slots > {_MAX_SLOTS}")
    if tier.k_opts > _MAX_OPTIONS:
        raise NotImplementedError(
            f"byte-scan kernel: {tier.k_opts} options > {_MAX_OPTIONS}")
    if tier.closed and int(tables["close_next"].shape[2]) > _MAX_SUCC:
        raise NotImplementedError(
            f"byte-scan kernel: more than {_MAX_SUCC} successor slots")
    if "win_v" in tables and tier.decode == "windowed" and not (
            1 <= int(tables["win_v"].shape[2]) <= _MAX_WIN_K2):
        raise NotImplementedError("byte-scan kernel: windowed DP columns "
                                  f"outside 1..{_MAX_WIN_K2}")
    digits = tier.decode in ("radix2", "digits")
    base_shape = (nb, m) if digits else (nb,)
    for name, t, shape in (("blk_word", blk_word, (nb,)),
                           ("blk_count", blk_count, (nb,)),
                           ("base", base, base_shape)):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    args = dict(tier=tier, block_stride=block_stride, hash_blocks=hb,
                min_substitute=min_substitute,
                max_substitute=max_substitute, algo=algo)
    if blk_word.device.type == "cpu":
        return bytescan_reference(blk_word, blk_count, base, tables, **args)
    if blk_word.device.type != "cuda":
        raise ValueError(f"unsupported device {blk_word.device}")
    return _launch_cuda(blk_word, blk_count, base, tables, **args)


#: Device dtype of each table the kernel reads.
_DTYPES = {"tokens": torch.uint8, "bj": torch.uint8, "svl": torch.uint8}


def _launch_cuda(blk_word, blk_count, base, tables, *, tier, block_stride,
                 hash_blocks, min_substitute, max_substitute, algo):
    lib = _native_build.load(f"bytescan_hash_{algo}")
    dev = blk_word.device
    used = needed_tables(tier)
    for name in used:
        t = tables[name]
        want = _DTYPES.get(name, torch.int32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"table {name} must be a contiguous {want} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
    for t in (blk_word, blk_count, base):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("block fields must be contiguous, on one device")
    nb = int(blk_word.shape[0])
    rows = nb * block_stride
    state = torch.empty((rows, DIGEST_WORDS[algo]), dtype=torch.int32,
                        device=dev)
    emit = torch.empty((rows,), dtype=torch.bool, device=dev)

    def ptr(name):
        t = tables.get(name) if name in used else None
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    def dim(name, i):
        t = tables.get(name) if name in used else None
        return ctypes.c_int(0 if t is None else int(t.shape[i]))

    c_int = ctypes.c_int
    call = [
        ctypes.c_void_p(blk_word.data_ptr()),
        ctypes.c_void_p(blk_count.data_ptr()),
        ctypes.c_void_p(base.data_ptr()), c_int(nb), c_int(block_stride),
        ptr("tokens"), ptr("lengths"), dim("tokens", 1),
        ptr("radix"), dim("radix", 1), ptr("win_v"), dim("win_v", 2),
        c_int(tier.k_opts), ptr("bitpos"), ptr("aj"), ptr("bj"), ptr("svl"),
        ptr("svw"), ptr("mpos"), ptr("mlen"), ptr("slotat"), ptr("startat"),
        ptr("close_next"), ptr("close_mul"), dim("close_next", 2),
        ptr("vopt"), ptr("vlen"),
        c_int(VARIANTS.index(tier.variant) if tier.row == "scalar" else 0),
        c_int(DECODE_ID[tier.decode]), c_int(int(tier.closed)),
        c_int(min_substitute), c_int(max_substitute), c_int(hash_blocks),
        ctypes.c_void_p(state.data_ptr()), ctypes.c_void_p(emit.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    ]
    key = tier.launch_key(algo)
    fn = getattr(lib, f"a5_bytescan_{tier.row}")
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):  # the tensors' card: another stripe's
        err = fn(*call)
    if err != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return state, emit


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _decode_radix2(r, base_rows, radix_rows):
    """The kernel's ``decode_radix2``: active slots' digits are successive
    bits of ``r`` added to the base digits with a binary carry."""
    digits = []
    carry = torch.zeros_like(r)
    nbits = torch.zeros_like(r)
    for s in range(radix_rows.shape[1]):
        act = radix_rows[:, s] > 1
        t = base_rows[:, s] + (lsr(r, nbits) & 1) + carry
        digits.append(torch.where(act, t & 1, 0))
        carry = torch.where(act, t >> 1, carry)
        nbits = nbits + act.to(torch.int32)
    return digits


def _slot_value(tables, tier, w, q, d, dmat):
    """``(word, length)`` int32 ``[N]`` of slot ``q`` (long ``[N]``) with
    digit ``d``: the kernel's ``slot_value`` (option d - 1, the one option
    at K=1, or the closed slot's joint row; zero outside the options)."""
    k_opts = tier.k_opts
    if tier.closed:
        p = dmat.shape[1]
        mul = tables["close_mul"][w, q]  # [N, S+1]
        nxt = tables["close_next"][w, q]  # [N, S]
        k = (d - 1) * mul[:, 0]
        for i in range(nxt.shape[1]):
            nt = nxt[:, i]
            ok_nt = (nt > q) & (nt < p)
            got = dmat.gather(1, torch.clamp(nt, 0, p - 1).long()[:, None])
            k = k + torch.where(ok_nt, got[:, 0], 0) * mul[:, 1 + i]
        ok = (d > 0) & (k >= 0) & (k < k_opts)
    elif k_opts == 1:
        k = torch.zeros_like(d)
        ok = d > 0
    else:
        k = d - 1
        ok = (d >= 1) & (d <= k_opts)
    kk = torch.clamp(k, 0, k_opts - 1).long()
    wd = torch.where(ok, tables["vopt"][w, q, kk], 0)
    ln = torch.where(ok, tables["vlen"][w, q, kk], 0)
    return wd, ln


def bytescan_reference(blk_word, blk_count, base, tables, *, tier,
                       block_stride, hash_blocks, min_substitute,
                       max_substitute, algo="md5"):
    """Plain PyTorch version of the byte-scan kernels: the same function
    over int32 ``[N]`` lanes, on whatever device the inputs live on, lane
    for lane the kernel's arithmetic (every lane, emitted or not).  Same
    outputs as :func:`bytescan_expand`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    dev = blk_word.device
    nb = int(blk_word.shape[0])
    lane = torch.arange(nb * block_stride, dtype=torch.int64, device=dev)
    blk = lane // block_stride
    r = (lane - blk * block_stride).to(torch.int32)
    w = blk_word.long()[blk]
    count = blk_count[blk]
    wlen = tables["lengths"][w]
    scale = _scale(algo)
    windowed = tier.decode == "windowed"

    digits = None
    if tier.row == "scalar":
        if windowed:
            dg = _decode_windowed(base[blk] + r, tables["win_v"][w],
                                  tables["radix"][w], 1)
            bitpos = tables["bitpos"][w]
            cb = torch.zeros_like(r)
            for s, d in enumerate(dg):
                cb = cb | ((d > 0).to(torch.int32) << (bitpos[:, s] & 31))
        else:
            cb = base[blk] + r
        cc = _popcount(cb)
    else:
        radix_rows = tables["radix"][w]
        if windowed:
            digits = _decode_windowed(base[blk] + r, tables["win_v"][w],
                                      radix_rows, tier.k_opts)
        elif tier.decode == "radix2":
            digits = _decode_radix2(r, base[blk], radix_rows)
        else:
            digits = _decode_digits(r, base[blk], radix_rows)
        dmat = torch.stack(digits, dim=1)
        if tier.row == "match":
            cb = torch.zeros_like(r)
            for s, d in enumerate(digits):
                cb = cb | ((d > 0).to(torch.int32) << s)
            cc = _popcount(cb)
            mpos, mlen = tables["mpos"][w], tables["mlen"][w]
        else:
            cc = sum(((radix_rows[:, s] > 1) & (d > 0)).to(torch.int32)
                     for s, d in enumerate(digits))

    nbytes = 4 * (16 * hash_blocks - 2)  # the data area
    buf = torch.zeros((lane.shape[0], nbytes + 1), dtype=torch.uint8,
                      device=dev)  # column nbytes: dropped bytes
    clash = torch.zeros(r.shape, dtype=torch.bool, device=dev)
    off = torch.zeros_like(r)
    zero = torch.zeros_like(r)
    for j in range(int(tables["tokens"].shape[1])):
        in_word = j < wlen
        if tier.row == "scalar":
            bj = tables["bj"][w, j].to(torch.int32)
            if tier.variant == "suball":
                aj = tables["aj"][w, j]
                covered = (lsr(cb, aj & 31) & 1) == 1
                started = covered & (bj > 0)
            else:
                started = (lsr(cb, bj & 31) & 1) == 1
                covered = started
                if tier.variant == "bitmask":
                    ab = cb & tables["aj"][w, j]
                    covered = ab != 0
                    clash |= in_word & ((ab & (ab - 1)) != 0)
            wd = tables["svw"][w, j]
            ln = tables["svl"][w, j].to(torch.int32)
        elif tier.row == "match":
            start_m = zero.clone()
            cover_m = zero.clone()
            for s in range(mpos.shape[1]):
                p, ml = mpos[:, s], mlen[:, s]
                start_m |= (p == j).to(torch.int32) << s
                cover_m |= ((j >= p) & (j < p + ml)).to(torch.int32) << s
            st = start_m & cb
            cv = cover_m & cb
            clash |= in_word & ((cv & (cv - 1)) != 0)
            started = st != 0
            covered = cv != 0
            q = torch.zeros_like(r)
            for s in range(mpos.shape[1]):  # the last slot starting here
                q = torch.where((lsr(st, s) & 1) == 1, s, q)
            q = q.long()
            d = dmat.gather(1, q[:, None])[:, 0]
            wd, ln = _slot_value(tables, tier, w, q, d, dmat)
        else:
            sl = tables["slotat"][w, j]
            q = torch.clamp(sl, 0, dmat.shape[1] - 1).long()
            d = dmat.gather(1, q[:, None])[:, 0]
            covered = (sl >= 0) & (d > 0)
            started = covered & (tables["startat"][w, j] == j)
            wd, ln = _slot_value(tables, tier, w, q, d, dmat)
        started &= in_word
        emit_tok = in_word & ~started & ~covered
        ul = torch.where(started, ln, torch.where(emit_tok, 1, 0))
        uw = torch.where(started, wd, tables["tokens"][w, j].to(torch.int32))
        for k in range(4):
            pos = scale * (off + k)
            ok = (k < ul) & (pos < nbytes)
            byte = lsr(uw, 8 * k) & 0xFF
            buf.scatter_(1, torch.where(ok, pos, nbytes).long()[:, None],
                         torch.where(ok, byte, 0).to(torch.uint8)[:, None])
        off = off + ul
    end = off * scale
    term = torch.where(end < nbytes, end, nbytes).long()[:, None]
    buf.scatter_(1, term, torch.full_like(term, 0x80, dtype=torch.uint8))
    by = buf[:, :nbytes].reshape(-1, nbytes // 4, 4).to(torch.int32)
    data = by[:, :, 0] | (by[:, :, 1] << 8) | (by[:, :, 2] << 16) \
        | (by[:, :, 3] << 24)
    msg = torch.cat([data, torch.zeros((data.shape[0], 2), dtype=torch.int32,
                                       device=dev)], dim=1)
    lw, bits = length_word(end, algo)
    for k in range(hash_blocks):
        fits = end <= 64 * (k + 1) - 9
        bits_k = bits if k + 1 == hash_blocks else torch.where(fits, bits, 0)
        msg[:, 16 * k + lw] = msg[:, 16 * k + lw] | bits_k
    state = hash_words(msg, end, algo)
    emit = (r < count) & (cc >= min_substitute) & (cc <= max_substitute) \
        & ~clash
    return state, emit
