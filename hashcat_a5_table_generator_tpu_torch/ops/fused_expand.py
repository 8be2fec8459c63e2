"""The fused decode + splice + hash piece kernel: gates, wrapper, plain
version.

Counterpart of the reference package's ``ops/pallas_expand.py`` for the
per-slot piece kernel (``_make_piece_kernel``) over match plans
(``fused_expand_md5``: default and reverse mode) and substitute-all plans
(``fused_expand_suball_md5``: ``-s`` and ``-s -r``, with the cascade
closure), in each of its decode tiers — the scalar-units full enumeration,
the general mixed-radix digit decode and the count-windowed DP walk — for
MD5, MD4, SHA-1 and NTLM, at K=1 (1-3 chained hash blocks) and at K=2 (the
pair tier, one hash block).

* The host gates (:func:`eligible`, :func:`k_opts_for`, :func:`k_vals_for`,
  :func:`scalar_units_for`, :func:`opts_for_config`,
  :func:`pair_for_config` and :func:`pair_for` under ``A5GEN_PAIR``,
  :func:`_hash_blocks_for`) are the reference's,
  minus its TPU probe and tiling rules (block strides and counts are free
  on the GPU).  :func:`opts_for` is the route gate under ``A5GEN_PALLAS``
  (:func:`enabled_by_env`): None sends a plan to the XLA expand + hash
  route, as the reference's does.  :func:`decode_for` names the decode
  tier the reference's wrapper would pick and :func:`schema_refusal` why
  the piece kernel's descriptors cannot hold a schema the gate admits
  (port-only: such a plan takes the XLA expand + hash route, which
  splices any schema).  A fused kernel takes a plan iff :func:`opts_for`
  is not None and, for a plan with a schema, :func:`schema_refusal` is
  None (``runtime.sweep.Sweep`` routes on exactly that).
* :func:`fused_expand_md5` is the wrapper.  For CUDA tensors it launches
  the hand-written kernel of ``csrc/piece_hash.cu`` (or raises); for CPU
  tensors it runs :func:`piece_md5_reference`, the plain PyTorch version
  of the same function.  The schema's ``kind`` (match or suball) and
  ``closed`` flag pick the selectors.  ``LAUNCHES`` counts kernel
  launches by entry point and hash, ``PLAIN_CALLS`` runs of the plain
  version.

Contract (the reference's): for every EMITTED candidate the state equals
the hash of the candidate bytes the host would splice, and the emit mask
is exact; non-emitted rows may hold anything.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..audit import audited_entry
from ..runtime.env import env_warn_once, read_env
from . import _native_build
from .hashes import (
    DIGEST_WORDS,
    hash_words,
    length_word,
    lsr,
    utf16_code_units,
)

#: The reference's static bounds: packed chosen vectors stay well inside
#: int32 (``_MAX_SLOTS``), the byte-scan tiers' token axis (``_MAX_TOKENS``),
#: value-select widths (``_MAX_OPTIONS``; plain plans keep the per-key
#: ``_MAX_RAW_OPTIONS``), suball segments, the windowed DP's columns
#: (window <= 8, + 2), and up to ``_MAX_HASH_BLOCKS`` chained hash blocks
#: (candidates to 183 bytes, 91 under NTLM's UTF-16LE doubling).
_MAX_SLOTS = 24
_MAX_TOKENS = 64
_MAX_OPTIONS = 12
_MAX_RAW_OPTIONS = 8
_MAX_SEGMENTS = 64
_MAX_WIN_K2 = 10
_MAX_HASH_BLOCKS = 3

ALGOS = ("md5", "md4", "sha1", "ntlm")
DECODES = ("scalar", "digits", "windowed")
_DECODE_ID = {d: i for i, d in enumerate(DECODES)}
#: The K=1 entry point of each decode (``a5_piece_<entry>``).
_ENTRY = {"scalar": "k1", "digits": "digits", "windowed": "windowed"}

#: Group descriptor layout shared with ``csrc/piece_hash.cu`` (D_* there).
DESC_WIDTH = 16
MAX_GROUPS = 256
MAX_SEL = 4

#: Kernel entries: ``k1`` (scalar decode), ``digits``, ``windowed``,
#: ``pair`` (scalar decode) and ``pair_digits`` (the pair tier with the
#: digit decode) over match plans; the same five prefixed ``suball_`` over
#: substitute-all plans, and ``suball_closed`` / ``suball_closed_windowed``
#: for cascade-closed plans (digit / windowed decode).
ENTRIES = ("k1", "pair", "pair_digits", "digits", "windowed")
SUBALL_ENTRIES = tuple(f"suball_{e}" for e in ENTRIES) + (
    "suball_closed", "suball_closed_windowed")

#: Kernel launches by ``piece_<entry>/<algo>`` and runs of the plain
#: version: plain integers the caller may reset; nothing else is global.
LAUNCHES = {
    f"piece_{entry}/{algo}": 0
    for algo in ALGOS
    for entry in ENTRIES + SUBALL_ENTRIES
}
PLAIN_CALLS = 0


def eligible(
    *,
    mode: str,
    algo: str,
    windowed: bool,
    out_width: int,
    num_slots: int,
    token_width: int,
    max_val_len: int,
    max_options: int,
    num_segments: int = 0,
    win_k2: int = 0,
) -> bool:
    """Static eligibility of a launch configuration for the piece kernel:
    the reference's ``eligible`` without the TPU tiling rules.  ``win_k2``
    is the windowed plan's DP column count (0 when not windowed)."""
    return (
        mode in ("default", "reverse", "suball", "suball-reverse")
        and algo in ALGOS
        and (not windowed or 2 <= win_k2 <= _MAX_WIN_K2)
        and 0 < out_width
        and (out_width * (2 if algo == "ntlm" else 1) + 9
             <= 64 * _MAX_HASH_BLOCKS)
        and 1 <= num_slots <= _MAX_SLOTS
        and 1 <= token_width <= _MAX_TOKENS
        and 1 <= max_val_len <= 4
        and 1 <= max_options <= _MAX_OPTIONS
        and num_segments <= _MAX_SEGMENTS
    )


def k_opts_for(plan) -> int:
    """Static per-key option count K (Python int scalar) — the decode's
    radix bound, from the plan's ``pat_radix`` int32 ``[B, P]`` matrix."""
    return max(1, int(plan.pat_radix.max()) - 1)


def k_vals_for(plan) -> int:
    """Static value-select width: :func:`k_opts_for`, widened to the joint
    closure tables of a cascade-closed plan (``close_opts``)."""
    return max(k_opts_for(plan), int(getattr(plan, "close_opts", 0) or 0))


def scalar_units_for(plan) -> "bool | str":
    """Host gate for the K=1 scalar tier.

    K=1 plans have all radices <= 2, so a lane's chosen-slot vector is
    exactly the binary digits of ``packed_base + rank``.  Match plans
    additionally need at most one match START per byte position;
    substitute-all plans qualify unless cascade-closed (a closed span's
    value depends on other slots' digits).  Returns ``"single"`` when
    every active match span is one byte (all shipped 1:1 layout maps),
    ``True`` for unique starts (and substitute-all plans), ``False``
    otherwise."""
    if k_opts_for(plan) != 1:
        return False
    if getattr(plan, "close_next", None) is not None:
        return False
    if getattr(plan, "match_pos", None) is None:
        return True
    return scalar_units_tier(plan.match_pos, plan.match_len,
                             plan.match_radix)


def scalar_units_tier(match_pos, match_len, match_radix) -> "bool | str":
    """The unique-start verdict of :func:`scalar_units_for` from concrete
    match arrays ``[B, M]`` (shared with the byte-scan tier's host re-check,
    ``ops.bytescan.check_scalar_units_gate``)."""
    mp = np.asarray(match_pos)
    act = np.asarray(match_radix) > 1
    if not np.where(act, np.asarray(match_len) > 1, False).any():
        return "single"
    m = mp.shape[1]
    # Inactive (padding) slots sit at distinct negative positions so they
    # can never collide with real starts or each other.
    pos = np.where(act, mp, -1 - np.arange(m, dtype=mp.dtype)[None, :])
    srt = np.sort(pos, axis=1)
    return not bool((srt[:, 1:] == srt[:, :-1]).any())


def scalar_units_bitpos(plan) -> np.ndarray:
    """Per-slot chosen-bit positions int32 ``[B, P]``: the active slots
    before each slot (the reference's ``scalar_units_fields`` ``bitpos``)
    — where a substitute-all windowed walk packs slot s's chosen bit."""
    act = (np.asarray(plan.pat_radix) > 1).astype(np.int32)
    return (np.cumsum(act, axis=1) - act).astype(np.int32)


def scalar_units_weight(plan) -> np.ndarray:
    """Per-slot bit weights int32 ``[B, P]``: ``1 << bitpos`` for active
    slots, 0 for padding.  A block's packed chosen vector is
    ``pbase = sum(base_digits * weight[word])``."""
    act = (np.asarray(plan.pat_radix) > 1).astype(np.int32)
    return (act << scalar_units_bitpos(plan)).astype(np.int32)


def _hash_blocks_for(out_width: "int | None", scale: int = 1) -> int:
    """Static hash-block count for a launch: the longest emitted candidate
    (``out_width`` bytes, doubled under NTLM: ``scale`` 2) plus terminator
    and 8-byte length must fit ``64 * n`` bytes."""
    if out_width is None:
        return 1
    return max(1, -(-(int(out_width) * scale + 9) // 64))


def _scale(algo: str) -> int:
    return 2 if algo == "ntlm" else 1


def _win_k2(plan) -> int:
    win_v = getattr(plan, "win_v", None)
    return int(win_v.shape[2]) if win_v is not None else 0


def opts_for_config(spec, plan, ct) -> "int | None":
    """The static option count K when the launch configuration can take
    the piece kernel, else None (the reference's gate without its TPU
    probe)."""
    if k_opts_for(plan) > _MAX_RAW_OPTIONS:
        return None
    max_options = k_vals_for(plan)
    cval = getattr(plan, "cval_bytes", None)
    max_val_len = int(ct.max_val_len if cval is None else cval.shape[1])
    ok = eligible(
        mode=spec.mode,
        algo=spec.algo,
        windowed=bool(getattr(plan, "windowed", False)),
        out_width=int(plan.out_width),
        num_slots=int(plan.num_slots),
        token_width=int(plan.tokens.shape[1]),
        max_val_len=max_val_len,
        max_options=max_options,
        num_segments=int(getattr(plan, "num_segments", 0)),
        win_k2=_win_k2(plan),
    )
    return max_options if ok else None


def decode_for(plan) -> "tuple[str, bool]":
    """``(decode, pack_cb)``: the decode tier the reference's wrapper runs
    for this plan — ``"scalar"`` (packed base + rank) for scalar-units K=1
    full enumeration, ``"windowed"`` for count-windowed plans (``pack_cb``:
    its chosen bits packed for the scalar selectors when the plan is
    scalar-units K=1), ``"digits"`` otherwise."""
    scalar = bool(scalar_units_for(plan)) and k_vals_for(plan) == 1
    if getattr(plan, "windowed", False):
        return "windowed", scalar
    return ("scalar" if scalar else "digits"), False


def pair_for_config(spec, plan, pieces, *,
                    block_stride: "int | None") -> "int | None":
    """Pair-lane eligibility: 2 when this launch configuration can take
    the pair tier, else None — a pair-eligible schema, full enumeration,
    no cascade closure, one hash block (NTLM counts its doubled width), and
    doubled in-block ranks that stay far inside int32."""
    if pieces is None or not getattr(pieces, "pair_ok", False):
        return None
    if getattr(plan, "windowed", False):
        return None
    if getattr(plan, "close_next", None) is not None:
        return None
    if block_stride is None or 2 * block_stride > (1 << 24):
        return None
    if _hash_blocks_for(int(plan.out_width), _scale(spec.algo)) != 1:
        return None
    return 2


def pair_for(spec, plan, pieces, *,
             block_stride: "int | None") -> "int | None":
    """The production pair gate: :func:`pair_for_config` under the
    ``A5GEN_PAIR`` escape hatch (``runtime.env.pair_enabled``), as the
    reference's ``pair_for``."""
    from ..runtime.env import pair_enabled

    if not pair_enabled():
        return None
    return pair_for_config(spec, plan, pieces, block_stride=block_stride)


def enabled_by_env() -> bool:
    """The fused kernels are ON by default; ``A5GEN_PALLAS`` set to
    ``off``/``0``/``xla``/``none``/``1`` sends every plan to the XLA expand
    + hash route (``1`` selects the reference's hash-only kernel, whose
    counterpart here is the buffer hash of that route), ``expand`` (or
    unset/empty) keeps the kernels.  Unrecognized values warn once and
    keep the default: a typo must not silently change the route."""
    val = read_env("A5GEN_PALLAS")
    if val is None or val in ("", "expand"):
        return True
    if val in ("off", "0", "xla", "none", "1"):
        return False
    env_warn_once(
        "A5GEN_PALLAS", val,
        f"unrecognized A5GEN_PALLAS={val!r} "
        "(want expand|off|0|xla|none|1); keeping the default "
        "(fused kernels on for eligible plans)",
    )
    return True


def opts_for(spec, plan, ct) -> "int | None":
    """The route gate: :func:`opts_for_config` under the ``A5GEN_PALLAS``
    opt-out (:func:`enabled_by_env`).  The static option count K when a
    fused kernel (piece or byte-scan) takes the plan; None sends it to the
    XLA expand + hash route, as the reference's ``opts_for`` does."""
    if not enabled_by_env():
        return None
    return opts_for_config(spec, plan, ct)


def schema_refusal(plan, pieces) -> "str | None":
    """Why the piece kernel's descriptors cannot hold the schema of a plan
    the fused kernels take (None = they can; else the plan takes the XLA
    route)."""
    decode, pack = decode_for(plan)
    return _schema_refusal(pieces, bitfield=decode == "scalar" or pack)


def _schema_refusal(pieces, *, bitfield: bool) -> "str | None":
    """Why the kernels cannot read this schema (None = they can): the
    descriptor table's size, groups with more selector columns than a
    descriptor holds, and — for the scalar selectors (``bitfield``) —
    groups whose variant index is not a bit field of the packed chosen
    vector.  A match column c is bit c of that vector, so its column must
    stay below 31; a substitute-all column reads bit ``sel_bit[w, c]``
    (an active slot's bit position, below 24, or 31 on padding columns),
    so its column index (up to the plan's occurrence count) is no bound."""
    if len(pieces.groups) > MAX_GROUPS:
        return f"{len(pieces.groups)} emission groups > {MAX_GROUPS}"
    for grp in pieces.groups:
        if grp.n_variants <= 1:
            continue
        if len(grp.sel_cols) > MAX_SEL:
            return (f"a group with {len(grp.sel_cols)} selector columns > "
                    f"{MAX_SEL}")
        if bitfield and (grp.n_variants != 1 << len(grp.sel_cols)
                         or (pieces.kind == "match"
                             and max(grp.sel_cols) >= 31)):
            return "a group outside the scalar tier's bit-field selects"
    return None


def group_descriptors(pieces) -> np.ndarray:
    """The schema's static group structure as int32 ``[NG, DESC_WIDTH]``
    rows for the kernel (field order: ``D_*`` in ``csrc/piece_hash.cu``)."""
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


def launch_key(algo: str, pieces, decode: str, pair: bool) -> str:
    """The ``LAUNCHES`` key of the entry point a launch over ``pieces``
    (its plan kind and closure) runs."""
    if pair:
        entry = "pair" if decode == "scalar" else "pair_digits"
    else:
        entry = _ENTRY[decode]
    if pieces.kind == "suball":
        entry = f"suball_{entry}"
        if pieces.closed:
            entry = ("suball_closed" if decode == "digits"
                     else "suball_closed_windowed")
    return f"piece_{entry}/{algo}"


def selector_tables(plan, pieces) -> "Dict[str, np.ndarray]":
    """A substitute-all plan's selector and closure tables as HOST int32
    arrays under the names :func:`fused_expand_md5` reads them by:
    ``sel_bit``/``sel_slot`` ``[B, C]`` (the schema's selector columns),
    ``bitpos`` ``[B, P]`` (the windowed decode's cb packing) and, for a
    cascade-closed plan, ``close_next`` ``[B, P, S]`` / ``close_mul``
    ``[B, P, S+1]``.  Empty for match plans."""
    if pieces is None or pieces.kind != "suball":
        return {}
    out = {
        "sel_bit": np.asarray(pieces.sel_bit, np.int32),
        "sel_slot": np.asarray(pieces.sel_slot, np.int32),
        "bitpos": scalar_units_bitpos(plan),
    }
    if pieces.closed:
        out["close_next"] = np.asarray(plan.close_next, np.int32)
        out["close_mul"] = np.asarray(plan.close_mul, np.int32)
    return out


def _needed_tables(pieces, decode: str, pack_cb: bool) -> "tuple[str, ...]":
    """The names of ``tables`` a launch reads besides the piece tables."""
    names = () if decode == "scalar" else ("radix",)
    if decode == "windowed":
        names += ("win_v",)
    if pieces.kind == "suball":
        cb = decode == "scalar" or (decode == "windowed" and pack_cb)
        names += ("sel_bit",) if cb else ("sel_slot",)
        if cb and decode == "windowed":
            names += ("bitpos",)
        if pieces.closed:
            names += ("close_next", "close_mul")
    return names


@audited_entry("ops.fused_expand_md5", kind="cuda_kernel",
               budget_keys=_native_build.instantiation_keys(
                   "piece_hash", kind=0))
@audited_entry("ops.fused_expand_suball_md5", kind="cuda_kernel",
               budget_keys=_native_build.instantiation_keys(
                   "piece_hash", kind=1))
def fused_expand_md5(
    blk_word: torch.Tensor,  # int32 [NB] — plan row of each block
    blk_count: torch.Tensor,  # int32 [NB] — candidates in each block
    base: torch.Tensor,  # int32 [NB] (scalar, windowed) or [NB, M] (digits)
    tables: dict,  # "pw"/"pw16"/"pl" piece tables + "desc" (+ "radix",
    #                "win_v", the suball selector tables), int32
    *,
    pieces,
    block_stride: int,
    out_width: int,
    min_substitute: int,
    max_substitute: int,
    algo: str = "md5",
    decode: str = "scalar",
    pack_cb: bool = False,
    k_opts: int = 1,
    pair: bool = False,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fused decode + splice + hash over ``NB`` blocks of ``block_stride``
    lanes (named after the reference's wrapper; ``algo`` picks the hash,
    ``pieces.kind`` the match or substitute-all selectors).

    ``decode`` (gate via :func:`decode_for`): ``"scalar"`` — ``base`` is
    each block's packed chosen vector ``pbase``; ``"digits"`` — ``base``
    holds each block's base digits ``[NB, M]`` and ``tables["radix"]`` the
    plan's ``[B, M]`` radices; ``"windowed"`` — ``base`` is each block's
    scalar windowed rank, ``tables["win_v"]`` the plan's ``[B, M+1, K2]``
    suffix counts, ``k_opts`` the plan's value-select width, and
    ``pack_cb`` packs the walk's chosen bits for the scalar selectors.
    Substitute-all schemas also read :func:`selector_tables` (``sel_bit``
    for the scalar selectors, ``sel_slot`` for the digit selectors,
    ``bitpos`` for windowed cb packing, ``close_next``/``close_mul`` when
    the schema is ``closed``), each by word index.

    Returns ``(state int32[N, DIGEST_WORDS[algo]], emit bool[N])`` with
    ``N = NB * block_stride`` candidates, or ``2 * NB * block_stride``
    under ``pair`` (member ``p`` of lane ``r`` of block ``b`` at row
    ``b * 2 * stride + 2r + p`` — candidate-rank order; blocks then span
    ``2 * stride`` ranks and ``blk_count`` counts candidates).

    Schemas this package has no kernel for (more than 3 hash blocks; the
    scalar selectors over a group that is not a bit field) raise
    ``NotImplementedError``; callers gate plans with :func:`opts_for` and
    :func:`schema_refusal` first."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    if decode not in DECODES:
        raise ValueError(f"unknown decode {decode!r}; one of {DECODES}")
    hb = _hash_blocks_for(out_width, _scale(algo))
    if hb > _MAX_HASH_BLOCKS:
        raise NotImplementedError(f"piece kernel: {hb} hash blocks > 3")
    if pieces.closed and (decode == "scalar" or pack_cb):
        raise ValueError("a cascade-closed schema takes the digit "
                         "selectors; gate via decode_for")
    why = _schema_refusal(
        pieces, bitfield=decode == "scalar" or (decode == "windowed"
                                                and pack_cb))
    if why is not None:
        raise NotImplementedError(f"piece kernel: {why}")
    if pair and (not pieces.pair_ok or hb != 1 or decode == "windowed"):
        raise ValueError(
            "pair=True needs a pair-eligible PieceSchema, one hash block "
            "and full enumeration; gate via pair_for_config"
        )
    missing = [n for n in _needed_tables(pieces, decode, pack_cb)
               if n not in tables]
    if missing:
        raise ValueError(f"decode {decode!r} over a {pieces.kind} schema "
                         f"needs tables {missing}")
    nb = int(blk_word.shape[0])
    m = 0
    if decode != "scalar":
        m = int(tables["radix"].shape[1])
        if m > _MAX_SLOTS:
            raise NotImplementedError(
                f"piece kernel: {m} slots > {_MAX_SLOTS}")
    base_shape = (nb, m) if decode == "digits" else (nb,)
    for name, t, shape in (("blk_word", blk_word, (nb,)),
                           ("blk_count", blk_count, (nb,)),
                           ("base", base, base_shape)):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {list(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    args = dict(pieces=pieces, block_stride=block_stride,
                hash_blocks=hb, min_substitute=min_substitute,
                max_substitute=max_substitute, algo=algo, decode=decode,
                pack_cb=pack_cb, k_opts=k_opts, pair=pair)
    if blk_word.device.type == "cpu":
        return piece_md5_reference(blk_word, blk_count, base, tables, **args)
    if blk_word.device.type != "cuda":
        raise ValueError(f"unsupported device {blk_word.device}")
    return _launch_cuda(blk_word, blk_count, base, tables, **args)


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


def _launch_cuda(blk_word, blk_count, base, tables, *, pieces, block_stride,
                 hash_blocks, min_substitute, max_substitute, algo, decode,
                 pack_cb, k_opts, pair):
    lib = _native_build.load(f"piece_hash_{algo}")
    dev = blk_word.device
    desc = tables["desc"]
    used = ("pw", "pw16", "pl", "desc") + _needed_tables(pieces, decode,
                                                         pack_cb)
    for name in used:
        t = tables.get(name)
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise ValueError(
                f"table {name} must be a contiguous int32 tensor on "
                f"{dev}, got {t.dtype} on {t.device}"
            )
    for t in (blk_word, blk_count, base):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("block fields must be contiguous, on one device")
    if int(desc.shape[0]) != len(pieces.groups):
        raise ValueError("group descriptors do not match the schema")
    nb = int(blk_word.shape[0])
    rows = nb * block_stride * (2 if pair else 1)
    state = torch.empty((rows, DIGEST_WORDS[algo]), dtype=torch.int32,
                        device=dev)
    emit = torch.empty((rows,), dtype=torch.bool, device=dev)

    def tab(name):
        return tables[name] if name in used else None

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    def dim(t, i):
        return ctypes.c_int(0 if t is None else int(t.shape[i]))

    radix, win_v = tab("radix"), tab("win_v")
    sel_bit, sel_slot = tab("sel_bit"), tab("sel_slot")
    cnext = tab("close_next")
    sel = sel_bit if sel_bit is not None else sel_slot
    ngw, ng16, ngd, vm, nw = _table_dims(tables)
    call = [
        ptr(blk_word), ptr(blk_count), ptr(base), ptr(radix), ptr(win_v),
        ctypes.c_int(nb), ctypes.c_int(block_stride), dim(radix, 1),
        dim(win_v, 2), ctypes.c_int(k_opts), ctypes.c_int(int(pack_cb)),
        ctypes.c_int(_DECODE_ID[decode]),
        ptr(tables.get("pw")), ptr(tables.get("pw16")), ptr(tables.get("pl")),
        ctypes.c_int(ngw), ctypes.c_int(ng16), ctypes.c_int(ngd),
        ctypes.c_int(vm), ctypes.c_int(nw),
        ptr(desc), ctypes.c_int(int(desc.shape[0])),
        ctypes.c_int(min_substitute), ctypes.c_int(max_substitute),
        ctypes.c_int(hash_blocks), ptr(state), ptr(emit),
        ctypes.c_int(int(pieces.kind == "suball")),
        ctypes.c_int(int(bool(pieces.closed))), ptr(sel_bit), ptr(sel_slot),
        ptr(tab("bitpos")), ptr(cnext), ptr(tab("close_mul")), dim(sel, 1),
        dim(cnext, 2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    ]
    key = launch_key(algo, pieces, decode, pair)
    fn = getattr(lib, f"a5_piece_{'pair' if pair else _ENTRY[decode]}")
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


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 lanes."""
    x = x - (lsr(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (lsr(x, 2) & 0x33333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F
    x = x + lsr(x, 8)
    return (x + lsr(x, 16)) & 0x3F


def _decode_digits(r, base_rows, radix_rows):
    """The kernel's ``decode_digits``: per-slot int32 ``[N]`` digits of
    base digits + mixed-radix(``r``) with carry (exact integer division)."""
    digits = []
    carry = torch.zeros_like(r)
    for s in range(radix_rows.shape[1]):
        rs = radix_rows[:, s]
        q = torch.div(r, rs, rounding_mode="floor")
        t = base_rows[:, s] + (r - q * rs) + carry
        ge = (t >= rs).to(torch.int32)
        digits.append(t - ge * rs)
        carry = ge
        r = q
    return digits


def _decode_windowed(big_r, winv_rows, radix_rows, k_opts):
    """The kernel's ``decode_windowed``: the suffix-count DP walk of the
    windowed rank ``big_r`` through ``winv_rows`` ``[N, M+1, K2]``."""
    k2 = int(winv_rows.shape[2])
    jcnt = torch.zeros_like(big_r)
    digits = []
    for s in range(radix_rows.shape[1]):
        row = winv_rows[:, s + 1]
        vn0 = torch.zeros_like(big_r)
        vn1 = torch.zeros_like(big_r)
        for c in range(k2):
            vn0 = torch.where(jcnt == c, row[:, c], vn0)
            if c + 1 < k2:
                vn1 = torch.where(jcnt == c, row[:, c + 1], vn1)
        not_chosen = big_r < vn0
        rr = big_r - vn0
        safe = torch.clamp(vn1, min=1)
        q = torch.zeros_like(big_r)
        for _ in range(max(0, k_opts - 1)):
            ge = (rr >= safe).to(torch.int32)
            rr = rr - ge * safe
            q = q + ge
        d = torch.where(not_chosen, 0, 1 + q)
        big_r = torch.where(not_chosen, big_r, rr)
        digits.append(torch.minimum(torch.clamp(d, min=0),
                                    radix_rows[:, s] - 1))
        jcnt = jcnt + (~not_chosen).to(torch.int32)
    return digits


def _column_selectors(pieces, tables, w, cb, digits):
    """``(bit, variant)``: functions of a selector column ``c`` giving
    each lane's chosen bit (scalar selectors over ``cb``) or the column's
    variant (digit selectors over ``digits``) — the kernel's
    ``build_message`` / ``col_variant``.  Match column c is slot c;
    a substitute-all column reads bit ``sel_bit[w, c]`` or the digit of
    slot ``sel_slot[w, c]``, and, for a chosen slot of a closed plan,
    ``1 +`` its joint closure index over its successors' digits."""
    suball = pieces.kind == "suball"
    if cb is not None:
        if not suball:
            return (lambda c: lsr(cb, c) & 1), None
        sb = tables["sel_bit"][w]

        def bit(c):
            b = sb[:, c]
            return torch.where((b >= 0) & (b < 32),
                               lsr(cb, torch.clamp(b, 0, 31)) & 1, 0)
        return bit, None
    if not suball:
        return None, (lambda c: digits[c])
    dmat = torch.stack(digits, dim=1)
    p = dmat.shape[1]
    ss = tables["sel_slot"][w]

    def slot_digit(sl):
        ok = (sl >= 0) & (sl < p)
        got = dmat.gather(1, torch.clamp(sl, 0, p - 1).long()[:, None])
        return torch.where(ok, got[:, 0], 0)

    if not pieces.closed:
        return None, (lambda c: slot_digit(ss[:, c]))

    def variant(c):
        sl = ss[:, c]
        d = slot_digit(sl)
        slc = torch.clamp(sl, 0, p - 1).long()
        mul = tables["close_mul"][w, slc]  # [N, S+1]
        nxt = tables["close_next"][w, slc]  # [N, S]
        jc = (d - 1) * mul[:, 0]
        for i in range(nxt.shape[1]):
            nt = nxt[:, i]
            jc = jc + torch.where(nt > sl, slot_digit(nt), 0) * mul[:, 1 + i]
        return torch.where(d > 0, 1 + jc, 0)

    return None, variant


def _group_index(grp, bit, variant):
    """A group's variant index (int64 ``[N]``): bit-fields of ``cb``
    (``bit``), or from the column variants (one column: its variant;
    merged binary columns: their chosen bits), clamped to the group's
    rows."""
    if bit is not None:
        idx = 0
        for i, c in enumerate(grp.sel_cols):
            idx = idx | (bit(c).long() << i)
    elif len(grp.sel_cols) == 1:
        idx = variant(grp.sel_cols[0]).long()
    else:
        idx = 0
        for i, c in enumerate(grp.sel_cols):
            idx = idx | ((variant(c) > 0).long() << i)
    return torch.clamp(idx, 0, grp.n_variants - 1)


def _place(msg, nw_data, o, wd):
    """OR ``wd`` into the word list ``msg`` at byte offset ``o`` (int32
    ``[N]``): the kernel's ``place``, dropping words past the data area."""
    q = o >> 2
    sh = (o & 3) * 8
    lo = wd << sh
    hi = torch.where(sh > 0, lsr(wd, (32 - sh) & 31), 0)
    for j in range(nw_data):
        msg[j] = msg[j] | torch.where(q == j, lo, 0) \
            | torch.where(q + 1 == j, hi, 0)


def _plain_message(index, w, tables, pieces, hash_blocks, algo):
    """The candidate message of each lane (int32 ``[N, 16*HB]``, length
    words in place) and its message length in bytes — the kernel's
    ``build_message`` + ``hash_message`` length words, in tensors.
    ``index(grp)`` gives a group's variant index."""
    n = w.shape[0]
    dev = w.device
    nw_data = 16 * hash_blocks - 2
    msg = [torch.zeros((n,), dtype=torch.int32, device=dev)
           for _ in range(16 * hash_blocks)]
    off = torch.zeros((n,), dtype=torch.int32, device=dev)
    for grp in pieces.groups:
        if grp.len_fixed == 0:
            continue
        idx = (index(grp) if grp.n_variants > 1
               else torch.zeros((n,), dtype=torch.int64, device=dev))
        for wi in range(grp.n_words):
            if grp.packed16:
                wd = tables["pw16"][w, grp.tab_idx, idx]
            else:
                wd = tables["pw"][w, grp.tab_idx, idx, wi]
            o = off + 4 * wi
            if algo == "ntlm":
                lo16, hi16 = utf16_code_units(wd)
                _place(msg, nw_data, 2 * o, lo16)
                if not grp.packed16:
                    _place(msg, nw_data, 2 * o + 4, hi16)
            else:
                _place(msg, nw_data, o, wd)
        if grp.len_fixed is not None:
            off = off + grp.len_fixed
        else:
            off = off + tables["pl"][w, grp.gl_idx, idx]
    end = (off - 1) * _scale(algo)
    lw, bits = length_word(end, algo)
    for k in range(hash_blocks):
        fits = end <= 64 * (k + 1) - 9
        if k + 1 < hash_blocks:
            bits_k = torch.where(fits, bits, 0)
        else:
            bits_k = bits
        msg[16 * k + lw] = msg[16 * k + lw] | bits_k
    return torch.stack(msg, dim=1), end


def piece_md5_reference(blk_word, blk_count, base, tables, *, pieces,
                        block_stride, hash_blocks, min_substitute,
                        max_substitute, algo="md5", decode="scalar",
                        pack_cb=False, k_opts=1, pair=False):
    """Plain PyTorch version of the piece kernel: the same function over
    int32 ``[N]`` lanes (wrapping adds, logical right shifts by masking),
    on whatever device the inputs live on, lane for lane the kernel's
    arithmetic.  Same outputs as :func:`fused_expand_md5`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    dev = blk_word.device
    nb = int(blk_word.shape[0])
    lane = torch.arange(nb * block_stride, dtype=torch.int64, device=dev)
    blk = lane // block_stride
    r = (lane - blk * block_stride).to(torch.int32)
    w = blk_word.long()[blk]
    count = blk_count[blk]

    def window(cc):
        return (cc >= min_substitute) & (cc <= max_substitute)

    def hashed(cb, digits, hb):
        bit, variant = _column_selectors(pieces, tables, w, cb, digits)
        msg, end = _plain_message(lambda g: _group_index(g, bit, variant),
                                  w, tables, pieces, hb, algo)
        return hash_words(msg, end, algo)

    def chosen(digits):
        return sum((d > 0).to(torch.int32) for d in digits)

    if not pair:
        cb = digits = None
        if decode == "scalar":
            cb = base[blk] + r
        else:
            radix_rows = tables["radix"][w]
            if decode == "digits":
                digits = _decode_digits(r, base[blk], radix_rows)
            else:
                digits = _decode_windowed(base[blk] + r, tables["win_v"][w],
                                          radix_rows, k_opts)
                if pack_cb:
                    bitpos = (tables["bitpos"][w] if pieces.kind == "suball"
                              else None)
                    cb = torch.zeros_like(r)
                    for s, d in enumerate(digits):
                        at = s if bitpos is None else bitpos[:, s] & 31
                        cb = cb | ((d > 0).to(torch.int32) << at)
                    digits = None
        cc = _popcount(cb) if cb is not None else chosen(digits)
        emit = (r < count) & window(cc)
        return hashed(cb, digits, hash_blocks), emit
    states, emits = [], []
    if decode == "scalar":
        cb = base[blk] + 2 * r
        cc = _popcount(cb)
        for p in (0, 1):
            states.append(hashed(cb | p, None, 1))
            emits.append((2 * r + p < count) & window(cc + p))
    else:
        radix_rows = tables["radix"][w]
        digits = _decode_digits(2 * r, base[blk], radix_rows)
        cc = chosen(digits)
        d0 = digits[0]
        d0p = torch.minimum(d0 + 1, radix_rows[:, 0] - 1)
        cc1 = cc + (d0p > 0).to(torch.int32) - (d0 > 0).to(torch.int32)
        for p, cc_p in ((0, cc), (1, cc1)):
            dg = digits if p == 0 else [d0p] + digits[1:]
            states.append(hashed(None, dg, 1))
            emits.append((2 * r + p < count) & window(cc_p))
    state = torch.stack(states, dim=1).reshape(-1, DIGEST_WORDS[algo])
    emit = torch.stack(emits, dim=1).reshape(-1)
    return state, emit
