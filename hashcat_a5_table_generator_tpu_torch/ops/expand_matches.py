"""Default-mode match plans: the host half of the reference package's
``ops/expand_matches.py``.

The reference's default engine (``processWord``, ``main.go:168-205``) is a
recursive DFS: at each byte position it probes keys longest-first, splices a
replacement, and resumes *after* the inserted text (Q5/Q6).  It enumerates
**subsets of pairwise non-overlapping matches** of the table's keys against
the original word, one option chosen per match.  A plan lists each word's
matches as mixed-radix slots (digit 0 = skip); a candidate is a digit
vector, emitted when its chosen count lies in the substitution window
(default mode bumps ``min 0 -> 1`` — Q1).  Parity is per-word multiset
equality (Q9); enumeration order is rank order, not DFS order.

Splicing is exact for every word and every table (empty keys can never
match — the reference probes key lengths >= 1 only), so match plans have
no oracle-fallback words.

The device half (torch ops, on the CPU and on the card alike) is the twin
of the reference's XLA expansion, which its XLA expand + hash route and
candidates mode run: :func:`decode_digits` (full, radix-2 and windowed),
:func:`lane_fields` / :func:`pair_lane_fields` (fixed-stride blocks
only: the superstep path's layout), :func:`splice_pieces` (the per-slot
piece splice, placed by scatter into a trash column instead of the
reference's compare-selects: same bytes) and the schema-less
:func:`_splice_scatter`, under :func:`expand_matches`.  Every gather
index is in range by construction or clamped where JAX would clamp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..tables.compile import CompiledTable
from .packing import PackedWords


@dataclass(frozen=True)
class MatchPlan:
    """Device-ready per-word match list for default/reverse expansion.

    Axes: B words, M match slots in reference scan order (position ascending,
    key length descending — ``main.go:177``); slot 0 is the least-significant
    mixed-radix digit. Inactive slots have radix 1.

    ``windowed`` plans enumerate ONLY digit vectors whose chosen count lies
    in the substitution window, via the suffix-count DP table ``win_v``
    (VERDICT r3 #4: a tight ``-m 1 -x 1`` window over a 20-match word must
    not burn 2^20 lanes for 20 candidates). ``n_variants`` is then the
    windowed total and block base cursors are scalar ranks, not digit
    vectors.
    """

    tokens: np.ndarray  # uint8 [B, L]
    lengths: np.ndarray  # int32 [B]
    index: np.ndarray  # int64 [B] — wordlist ordinals (from PackedWords)
    match_pos: np.ndarray  # int32 [B, M]
    match_len: np.ndarray  # int32 [B, M] — key length, 0 on inactive slots
    match_radix: np.ndarray  # int32 [B, M] — options+1 (default) / 2 (reverse)
    match_val_start: np.ndarray  # int32 [B, M] — CSR row of the key's options
    n_variants: Tuple[int, ...]  # python bigints — Π radix per word, or the
    #                              windowed totals when ``windowed``
    fallback: np.ndarray  # bool [B] — always False; kept for the shared
    # block scheduler's plan interface
    out_width: int  # static candidate-buffer width (uint32-aligned)
    windowed: bool = False  # count-windowed enumeration active
    win_v: "np.ndarray | None" = None  # int32 [B, M+1, K+2] suffix counts:
    #   win_v[b, s, j] = number of digit assignments for slots s.. given j
    #   already chosen, with the final count inside the window

    # Shared-scheduler interface (ops.blocks.make_blocks) --------------------
    @property
    def batch(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def num_slots(self) -> int:
        return int(self.match_pos.shape[1])

    @property
    def pat_radix(self) -> np.ndarray:
        return self.match_radix



def _batch_find_matches(ct: CompiledTable, packed: PackedWords) -> np.ndarray:
    """Vectorized :func:`find_matches` over the whole packed batch.

    Returns ``ki int32[B, L, KL]`` — the matched key index (-1 = none) at
    every (word, position, key-length) site, with the KL axis in
    DESCENDING key-length order so a C-order flatten of ``(L, KL)`` yields
    exactly the reference scan order (position ascending, length
    descending, ``main.go:175-177``). Replaces the per-word Python scan
    that dominated plan construction (7.7 s for a 300k-word dictionary —
    longer than the whole device sweep after the launch-loop fixes).
    """
    tokens, lengths = packed.tokens, packed.lengths
    b, width = tokens.shape
    # Keys longer than the packed width can never match (fit would be
    # all-False anyway, and the shifted-compare slices below would go
    # negative for them).
    lens_desc = sorted(
        {int(l) for l in ct.key_len if 0 < l <= width}, reverse=True
    )
    kl = max(1, len(lens_desc))
    ki_mat = np.full((b, width, kl), -1, dtype=np.int32)
    j = np.arange(width)
    for li, klen in enumerate(lens_desc):
        fit = (j[None, :] + klen) <= lengths[:, None]  # [B, L]
        if klen == 1:
            ki_mat[:, :, li] = np.where(fit, ct.byte_to_key[tokens], -1)
        else:
            acc = np.full((b, width), -1, dtype=np.int32)
            for kidx in np.nonzero(ct.key_len == klen)[0]:
                key = ct.key_bytes[kidx]
                ok = fit.copy()
                for t in range(klen):
                    ok[:, : width - t] &= tokens[:, t:] == key[t]
                    if t:
                        ok[:, width - t :] = False
                acc = np.where(ok, np.int32(kidx), acc)
            ki_mat[:, :, li] = acc
    return ki_mat


#: Windowed-enumeration eligibility bounds: per-word windowed totals must
#: fit comfortably in int32 (block base cursors become scalar ranks) and the
#: window ceiling must keep the DP table narrow.
WINDOWED_MAX_TOTAL = 1 << 30
WINDOWED_MAX_SUBST = 8


def _windowed_tables(
    match_radix: np.ndarray,
    min_substitute: int,
    max_substitute: int,
) -> "Tuple[np.ndarray, List[int]] | Tuple[None, None]":
    """Suffix-count DP for count-windowed enumeration (numpy over words).

    ``v[b, s, j]`` = number of digit assignments for slots ``s..m-1`` given
    ``j`` slots already chosen, such that the final chosen count lands in
    ``[min_substitute, max_substitute]`` (overlap clashes are NOT modeled —
    they stay a device-side mask, exactly as in full enumeration; inactive
    slots have 0 options and contribute nothing).
    Returns ``(v, totals)`` or ``(None, None)`` when any word's windowed
    total overflows the int32 cursor budget.
    """
    mx = max_substitute
    b, m = match_radix.shape
    opts = (match_radix.astype(np.int64) - 1).clip(min=0)  # [B, M]
    v = np.zeros((b, m + 1, mx + 2), dtype=np.int64)
    v[:, m, min_substitute : mx + 1] = 1
    for s in range(m - 1, -1, -1):
        v[:, s, : mx + 1] = (
            v[:, s + 1, : mx + 1] + opts[:, s : s + 1] * v[:, s + 1, 1 : mx + 2]
        )
        if v[:, s].max() > WINDOWED_MAX_TOTAL:
            return None, None
    return v.astype(np.int32), [int(t) for t in v[:, 0, 0]]


def windowed_chunk_terms(
    radix_matrix: np.ndarray,
    n_variants: List[int],
    min_substitute: "int | None",
    max_substitute: "int | None",
    zero_mask: "np.ndarray | None" = None,
) -> "Tuple[bool, np.ndarray | None, List[int] | None, int, int]":
    """The batch-additive terms of the windowed-enumeration decision:
    ``(eligible, win_v, win_totals, sum_win, sum_full)``.  One
    implementation serves the whole-batch vote
    (:func:`windowed_plan_fields`) and the streaming prescan
    (``runtime.sweep.Sweep._stream_prescan``), which sums the terms chunk
    by chunk and votes over the totals with :func:`windowed_gate`: the
    two paths must number ranks the same way.  ``eligible`` is False on
    an out-of-bounds window or a word whose windowed total overflows the
    int32 cursor budget (per-word properties, so a conjunction over
    chunks equals the whole-batch test)."""
    if (
        min_substitute is None
        or max_substitute is None
        or not 0 <= min_substitute <= max_substitute <= WINDOWED_MAX_SUBST
        or radix_matrix.shape[0] == 0
    ):
        return False, None, None, 0, 0
    v, totals = _windowed_tables(radix_matrix, min_substitute, max_substitute)
    if v is None:
        return False, None, None, 0, 0
    if zero_mask is not None:
        totals = [0 if zero_mask[i] else t for i, t in enumerate(totals)]
    full = sum(min(t, 1 << 62) for t in n_variants)
    return True, v, totals, sum(totals), full


def windowed_gate(sum_win: int, sum_full: int) -> bool:
    """The 2x lane-saving vote: windowed enumeration engages only when it
    at least halves the lane count."""
    return sum_win * 2 <= sum_full


def windowed_plan_fields(
    radix_matrix: np.ndarray,
    n_variants: List[int],
    min_substitute: "int | None",
    max_substitute: "int | None",
    zero_mask: "np.ndarray | None" = None,
    force: "bool | None" = None,
) -> "Tuple[bool, np.ndarray | None, List[int]]":
    """Windowed-enumeration eligibility + table construction, through
    :func:`windowed_chunk_terms` and :func:`windowed_gate`.  ``zero_mask``
    marks words whose totals are forced to 0 (substitute-all plans'
    oracle-routed words).  Returns ``(windowed, win_v, n_variants)`` —
    unchanged inputs when ineligible.  ``force`` pins the decision (a
    streaming sweep's chunk plans take the prescan's whole-dictionary
    vote): False = full enumeration; True = windowed without the saving
    gate, raising when the bounds do not hold."""
    if force is False:
        return False, None, n_variants
    eligible, v, totals, sum_win, sum_full = windowed_chunk_terms(
        radix_matrix, n_variants, min_substitute, max_substitute,
        zero_mask=zero_mask)
    if not eligible:
        if force:
            raise ValueError(
                "force_windowed=True but this batch is not windowed-"
                f"eligible (window [{min_substitute}, {max_substitute}] "
                "out of bounds, or a word's windowed total overflows the "
                "int32 cursor budget)")
        return False, None, n_variants
    if force is None and not windowed_gate(sum_win, sum_full):
        return False, None, n_variants
    return True, v, totals


def unrank_windowed(
    v_row: np.ndarray, radices: Sequence[int], rank: int
) -> List[int]:
    """Host mirror of the device's windowed unranking: the digit vector of
    ``rank`` in a word's windowed enumeration.  ``v_row`` is
    ``win_v[word]`` (``[M+1, K+2]``).  Raises ``ValueError`` for ranks past
    the windowed total."""
    digits: List[int] = []
    j = 0
    r = int(rank)
    if r >= int(v_row[0, 0]):
        raise ValueError(f"windowed rank {rank} out of range")
    for s, _radix in enumerate(radices):
        vn0 = int(v_row[s + 1, j])
        if r < vn0:
            digits.append(0)
        else:
            r -= vn0
            vn1 = int(v_row[s + 1, j + 1])
            digits.append(r // vn1 + 1)
            r %= vn1
            j += 1
    return digits


def variant_totals(radix_matrix: np.ndarray) -> List[int]:
    """Per-row radix products as EXACT Python ints, shared by both plan
    constructors: rows whose log2 sum is comfortably inside int64 take the
    vectorized product; the (rare) rest recompute exactly."""
    radix64 = radix_matrix.astype(np.int64)
    logs = np.sum(np.log2(radix64.astype(np.float64)), axis=1)
    prods = np.prod(radix64, axis=1)
    out: List[int] = [int(x) for x in prods]
    for i in np.nonzero(logs >= 60)[0]:
        total = 1
        for r in radix_matrix[i]:
            total *= int(r)
        out[int(i)] = total
    return out


def rounded_out_width(width: int, max_delta: int) -> int:
    """Candidate-buffer width: packed width + worst growth, uint32-aligned."""
    return max(4, -(-(width + max_delta) // 4) * 4)


def key_deltas(ct: CompiledTable, *, limit_first_option: bool) -> np.ndarray:
    """Worst-case output growth per chosen key (``int64[K]``): the widest
    considered option minus the key length, floored at 0; optionless keys
    grow nothing. ``limit_first_option``: reverse modes apply ``subs[0]``
    only (Q2), so only the first option's width counts there."""
    k = ct.num_keys
    out = np.zeros(max(k, 1), dtype=np.int64)
    for kidx in range(k):
        c = int(ct.val_count[kidx])
        if c == 0:
            continue
        opts = 1 if limit_first_option else c
        widest = max(
            int(ct.val_len[ct.val_start[kidx] + o]) for o in range(opts)
        )
        out[kidx] = max(0, widest - int(ct.key_len[kidx]))
    return out


def build_match_plan(
    ct: CompiledTable,
    packed: PackedWords,
    *,
    first_option_only: bool = False,
    out_width: int | None = None,
    min_substitute: int | None = None,
    max_substitute: int | None = None,
    force_windowed: bool | None = None,
) -> MatchPlan:
    """Host-side plan construction for default (``first_option_only=False``)
    or reverse (``True``) mode.

    When the EFFECTIVE substitution window ``[min_substitute,
    max_substitute]`` is given and tight (``max_substitute <=
    WINDOWED_MAX_SUBST``, windowed totals < 2^30, and at least a 2x lane
    saving over full enumeration), the plan switches to count-windowed
    enumeration: ranks walk only in-window digit vectors via the ``win_v``
    DP instead of masking the full mixed-radix space (the piece kernel's
    windowed tier walks the same DP on the device).  ``force_windowed``
    pins that decision (a streaming sweep's chunk plans; see
    :func:`windowed_plan_fields`).
    """
    b, width = packed.tokens.shape

    # Vectorized batch scan (see _batch_find_matches) + dense packing:
    # per-site key indices flatten to reference scan order, per-row ranks
    # become slot columns.
    ki_mat = _batch_find_matches(ct, packed)
    flat = ki_mat.reshape(b, -1)
    valid = flat >= 0
    counts = valid.sum(axis=1)
    m = max(1, int(counts.max()) if b else 0)
    rank = np.cumsum(valid, axis=1) - 1
    rows, cols = np.nonzero(valid)
    slots = rank[rows, cols]
    ki = flat[rows, cols]
    kl_axis = ki_mat.shape[2]

    # Per-key static fields (K is tiny): radix and the worst-case output
    # growth each chosen key can contribute.
    vc = ct.val_count.astype(np.int64)
    if first_option_only:
        key_radix = np.where(vc == 0, 1, 2).astype(np.int32)
    else:
        key_radix = np.where(vc == 0, 1, vc + 1).astype(np.int32)
    delta_per_key = key_deltas(ct, limit_first_option=first_option_only)

    match_pos = np.zeros((b, m), dtype=np.int32)
    match_len = np.zeros((b, m), dtype=np.int32)
    match_radix = np.ones((b, m), dtype=np.int32)
    match_val_start = np.zeros((b, m), dtype=np.int32)
    match_pos[rows, slots] = (cols // kl_axis).astype(np.int32)
    match_len[rows, slots] = ct.key_len[ki]
    match_radix[rows, slots] = key_radix[ki]
    match_val_start[rows, slots] = ct.val_start[ki]

    word_delta = np.zeros(b, dtype=np.int64)
    np.add.at(word_delta, rows, delta_per_key[ki])
    max_delta = int(word_delta.max()) if b else 0

    n_variants = variant_totals(match_radix)

    if out_width is None:
        out_width = rounded_out_width(width, max_delta)

    windowed, win_v, n_variants = windowed_plan_fields(
        match_radix, n_variants, min_substitute, max_substitute,
        force=force_windowed,
    )

    return MatchPlan(
        tokens=packed.tokens,
        lengths=packed.lengths,
        index=packed.index,
        match_pos=match_pos,
        match_len=match_len,
        match_radix=match_radix,
        match_val_start=match_val_start,
        n_variants=tuple(n_variants),
        fallback=np.zeros((b,), dtype=bool),
        out_width=out_width,
        windowed=windowed,
        win_v=win_v,
    )


# ---------------------------------------------------------------------------
# Device half: the XLA expansion's torch twin
# ---------------------------------------------------------------------------


def _exact_div(r: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """Floor ``r // rs``.  The reference computes it as an f32 divide + a
    ±1 fixup (the TPU has no s32 divide); the GPU divides integers
    exactly, with the same quotients."""
    return torch.div(r, rs, rounding_mode="floor")


def _col(row: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``row[:, c]`` per lane, 0 where ``c`` is past the row (the
    reference's unrolled compare-sum column select)."""
    k2 = row.shape[1]
    got = row.gather(1, c.clamp(0, k2 - 1).long()[:, None])[:, 0]
    return torch.where(c < k2, got, 0)


def decode_digits(rank, base, radix, field, win_v, m, *,
                  max_rank: "int | None" = None, radix2: bool = False):
    """Per-lane digit vectors ``int32[N, M]``: full enumeration (``base +
    mixed-radix(rank)`` with carry, slot 0 least significant; the bit
    decode when ``radix2`` and ``m <= 31``, as the reference picks) or,
    with ``win_v``, the windowed walk of the scalar rank ``base[:, 0] +
    rank`` through the suffix-count DP (digits clipped to ``radix - 1``).
    ``field`` expands a per-word array to per-lane rows.  ``max_rank`` is
    accepted for the reference's signature (it picks the f32 divide
    there)."""
    del max_rank
    if win_v is not None:
        big_r = base[:, 0] + rank
        jcnt = torch.zeros_like(rank)
        digits = []
        for s in range(m):
            row = field(win_v[:, s + 1])  # [N, K2]
            vn0 = _col(row, jcnt)
            not_chosen = big_r < vn0
            r2 = big_r - vn0
            safe = torch.clamp(_col(row, jcnt + 1), min=1)
            d = torch.where(not_chosen, 0, 1 + _exact_div(r2, safe))
            big_r = torch.where(not_chosen, big_r,
                                torch.remainder(r2, safe))
            digits.append(torch.minimum(torch.clamp(d, min=0),
                                        radix[:, s] - 1))
            jcnt = jcnt + (~not_chosen).to(torch.int32)
        return torch.stack(digits, dim=1).to(torch.int32)
    if radix2 and m <= 31:
        digits = []
        carry = torch.zeros_like(rank)
        nbits = torch.zeros_like(rank)
        for s in range(m):
            active = radix[:, s] > 1
            bit = (rank >> nbits) & 1
            t = base[:, s] + torch.where(active, bit, 0) + carry
            digits.append(torch.where(active, t & 1, 0))
            carry = torch.where(active, t >> 1, carry)
            nbits = nbits + active.to(torch.int32)
        return torch.stack(digits, dim=1).to(torch.int32)
    digits = []
    carry = torch.zeros_like(rank)
    r = rank
    for s in range(m):
        rs = radix[:, s]
        q = _exact_div(r, rs)
        t = base[:, s] + (r - q * rs) + carry
        ge = (t >= rs).to(torch.int32)
        digits.append(t - ge * rs)
        carry = ge
        r = q
    return torch.stack(digits, dim=1).to(torch.int32)


def _lane_blocks(blk_word, num_lanes: int, block_stride: int):
    nb = num_lanes // block_stride
    if nb * block_stride != num_lanes or blk_word.shape[0] != nb:
        raise ValueError(
            f"block_stride {block_stride} needs num_lanes divisible and "
            f"exactly {num_lanes} // stride = {nb} blocks, got "
            f"{blk_word.shape[0]}")
    v = torch.arange(num_lanes, dtype=torch.int32, device=blk_word.device)
    blk = torch.div(v, block_stride, rounding_mode="floor")
    return v - blk * block_stride, blk.long()


def lane_fields(blk_word, blk_base, blk_count, blk_offset, *, num_lanes,
                block_stride):
    """Lane -> block resolution of a launch: ``(rank, lane_ok, w, base,
    field)`` — per-lane in-block rank, validity, word row, base digits and
    ``field(x)``, a per-word array ``x[B, ...]`` per lane ``[N, ...]``.
    With ``block_stride`` the fixed-stride layout (``blk_offset`` is
    implied); with None the variable-offset layout of
    ``ops.blocks.make_blocks(fixed_stride=None)``: each lane
    binary-searches ``blk_offset`` for its block, as in the reference."""
    if block_stride is None:
        lanes = torch.arange(num_lanes, dtype=torch.int32,
                             device=blk_offset.device)
        blk = torch.searchsorted(blk_offset, lanes, right=True) - 1
        blk = blk.clamp(0, max(int(blk_offset.shape[0]) - 1, 0))
        rank = lanes - blk_offset[blk]
    else:
        rank, blk = _lane_blocks(blk_word, num_lanes, block_stride)
    lane_ok = rank < blk_count[blk]
    w = blk_word[blk]
    w_idx = w.long()
    return rank, lane_ok, w, blk_base[blk], lambda x: x[w_idx]


def pair_lane_fields(blk_word, blk_base, blk_count, *, num_lanes,
                     block_stride):
    """Lane -> block resolution of the pair tier (K=2 candidates per
    lane, ranks ``2r`` and ``2r + 1``): ``(rank, ok0, ok1, w, base,
    field)``.  Fixed-stride only, as in the reference."""
    if block_stride is None:
        raise ValueError("the pair-lane tier requires a fixed-stride "
                         "block layout")
    rank, blk = _lane_blocks(blk_word, num_lanes, block_stride)
    count = blk_count[blk]
    w = blk_word[blk]
    w_idx = w.long()
    return (rank, rank * 2 < count, rank * 2 + 1 < count, w, blk_base[blk],
            lambda x: x[w_idx])


def interleave_pairs(*arrays):
    """``(a0[N, ...], a1[N, ...]) -> a[2N, ...]``, member ``p`` of lane
    ``r`` at row ``2r + p``."""
    stacked = torch.stack(arrays, dim=1)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def piece_device_tables(pieces, *, device) -> dict:
    """A ``PieceSchema``'s data tables for :func:`splice_pieces`, as
    tensors: ``pl`` ``[B, NGD, V]`` dynamic-group lengths, ``pw``
    ``[B, NG, V, NW]`` (uint32 bits as int32) and ``pw16`` ``[B, NG16,
    VM]`` variant words, and a substitute-all schema's selector slots
    ``sslot`` ``[B, C]``; each only when the schema has it."""
    tabs = {}
    for name, key in (("pl", "gl"), ("pw", "gw"), ("pw16", "gw16"),
                      ("sslot", "sel_slot")):
        arr = getattr(pieces, key)
        if arr is None:
            continue
        arr = np.ascontiguousarray(arr)
        arr = arr.view(np.int32) if arr.dtype == np.uint32 else \
            arr.astype(np.int32)
        tabs[name] = torch.as_tensor(arr, device=device)
    return tabs


def splice_pieces(schema, tables, field, col_variant, *, n, out_width,
                  device=None):
    """Per-slot piece materialization, the twin of the reference's
    ``splice_pieces``: the schema's groups in output order, each group's
    precomputed word(s) and length selected by its variant index
    (``col_variant(c) -> int32[N]``), its bytes placed at the lane's
    running prefix offset.  Bytes land by scatter into a trash column
    past ``out_width`` (the reference's compare-selects drop them); the
    terminator byte in the tail group is cut by the final ``o < out_len``
    zero-fill.  Returns ``(out uint8[N, W], out_len int32[N])`` on
    ``device``."""
    dev = device
    out = torch.zeros((n, out_width + 1), dtype=torch.uint8, device=dev)
    cum_static = 0
    cum = None  # dynamic offset once any group's length varies
    pl, pw, pw16 = tables.get("pl"), tables.get("pw"), tables.get("pw16")
    for grp in schema.groups:
        n_var, n_words = grp.n_variants, grp.n_words
        if grp.len_fixed == 0:
            continue
        idx = None
        if n_var > 1:
            sel = grp.sel_cols
            if len(sel) == 1:
                idx = col_variant(sel[0])
            else:
                idx = torch.zeros((n,), dtype=torch.int32, device=dev)
                for i, c in enumerate(sel):
                    idx = idx | ((col_variant(c) > 0).to(torch.int32) << i)
            idx = idx.clamp(0, n_var - 1).long()[:, None]

        def pick(rows):  # rows: per-word [B, n_var] -> per-lane [N]
            got = field(rows)
            if idx is None:
                return got[:, 0]
            return got.gather(1, idx)[:, 0]

        if grp.packed16:
            words = [pick(pw16[:, grp.tab_idx, :n_var])]
        else:
            words = [pick(pw[:, grp.tab_idx, :n_var, w])
                     for w in range(n_words)]
        ln = grp.len_fixed
        if ln is None:
            ln = pick(pl[:, grp.gl_idx, :n_var]).to(torch.int32)
        off = cum_static if cum is None else cum
        for bi in range(4 * n_words):
            if bi >= out_width or (isinstance(ln, int) and bi >= ln):
                break
            byte = ((words[bi // 4] >> (8 * (bi % 4))) & 0xFF).to(
                torch.uint8)
            if isinstance(off, int):
                if off + bi >= out_width:
                    break
                if isinstance(ln, int):
                    out[:, off + bi] = byte
                else:
                    out[:, off + bi] = torch.where(bi < ln, byte,
                                                   out[:, off + bi])
                continue
            col = off + bi
            ok = (col >= 0) & (col < out_width)
            if not isinstance(ln, int):
                ok &= bi < ln
            out.scatter_(1, torch.where(ok, col, out_width).long()[:, None],
                         byte[:, None])
        if isinstance(ln, int):
            if cum is None:
                cum_static += ln
            else:
                cum = cum + ln
        elif cum is not None:
            cum = cum + ln
        else:
            cum = ln if cum_static == 0 else ln + cum_static
    if cum is None:
        out_len = torch.full((n,), cum_static - 1, dtype=torch.int32,
                             device=dev)
    else:
        out_len = (cum - 1).to(torch.int32)
    o = torch.arange(out_width, dtype=torch.int32, device=dev)[None, :]
    out = out[:, :out_width] * (o < out_len[:, None])
    return out, out_len


def splice_pieces_pair(schema, tables, field, digits, d0_partner,
                       col_variant, *, n, out_width):
    """Both pair members' buffers: the partner's variant vector is the
    base's with column 0 replaced by ``d0_partner``.  Returns ``(out0,
    len0, out1, len1)``."""
    out0, len0 = splice_pieces(schema, tables, field, col_variant, n=n,
                               out_width=out_width, device=digits.device)
    out1, len1 = splice_pieces(
        schema, tables, field,
        lambda c: d0_partner if c == 0 else col_variant(c),
        n=n, out_width=out_width, device=digits.device)
    return out0, len0, out1, len1


def expand_matches(
    tokens, lengths, match_pos, match_len, match_radix, match_val_start,
    val_bytes, val_len, blk_word, blk_base, blk_count, blk_offset, *,
    num_lanes: int, out_width: int, min_substitute: int,
    max_substitute: int, block_stride: "int | None" = None,
    win_v=None, radix2: bool = False, pieces=None,
    piece_tables: "dict | None" = None, pair_k: "int | None" = None,
):
    """Decode + materialize ``num_lanes`` variants of a match plan (per-word
    arrays as tensors: ``tokens`` uint8 ``[B, L]``, the rest int32; the
    compiled table's ``val_bytes`` uint8 ``[V, VW]`` / ``val_len``), the
    twin of the reference's ``expand_matches``.  With ``pieces`` (and
    ``piece_tables``, :func:`piece_device_tables`) the per-slot piece
    splice, else the schema-less scatter splice; ``pair_k=2`` runs the
    pair tier (rows ``2r + p``).  Returns ``(cand uint8[N, out_width],
    cand_len int32[N], word_row int32[N], emit bool[N])``; bytes past
    ``cand_len`` are zero."""
    n = num_lanes
    m = match_pos.shape[1]
    if pair_k:
        if pair_k != 2:
            raise ValueError(f"pair_k must be 2 or None, got {pair_k}")
        if pieces is None or not pieces.pair_ok or win_v is not None:
            raise ValueError("the pair-lane tier needs a pair-eligible "
                             "PieceSchema and full enumeration")
        rank, ok0, ok1, w, base, field = pair_lane_fields(
            blk_word, blk_base, blk_count, num_lanes=n,
            block_stride=block_stride)
        radix = field(match_radix)
        digits = decode_digits(rank * 2, base, radix, field, None, m,
                               radix2=radix2)
        d0 = digits[:, 0]
        d0p = torch.minimum(d0 + 1, radix[:, 0] - 1)
        out0, len0, out1, len1 = splice_pieces_pair(
            pieces, piece_tables, field, digits, d0p,
            lambda c: digits[:, c], n=n, out_width=out_width)
        cc0 = (digits > 0).sum(dim=1, dtype=torch.int32)
        cc1 = cc0 + (d0p > 0).to(torch.int32) - (d0 > 0).to(torch.int32)

        def window(ok, cc):
            return ok & (cc >= min_substitute) & (cc <= max_substitute)

        return (interleave_pairs(out0, out1), interleave_pairs(len0, len1),
                interleave_pairs(w, w),
                interleave_pairs(window(ok0, cc0), window(ok1, cc1)))

    rank, lane_ok, w, base, field = lane_fields(
        blk_word, blk_base, blk_count, blk_offset, num_lanes=n,
        block_stride=block_stride)
    radix = field(match_radix)
    digits = decode_digits(rank, base, radix, field, win_v, m,
                           radix2=radix2)
    chosen = digits > 0
    chosen_count = chosen.sum(dim=1, dtype=torch.int32)
    window = (lane_ok & (chosen_count >= min_substitute)
              & (chosen_count <= max_substitute))
    if pieces is not None:
        out, out_len = splice_pieces(
            pieces, piece_tables, field, lambda c: digits[:, c], n=n,
            out_width=out_width, device=digits.device)
        return out, out_len, w, window
    opt_row = torch.where(chosen, field(match_val_start) + digits - 1, 0)
    vlen = torch.where(chosen, _take_rows(val_len, opt_row), 0)
    out, out_len, clash = _splice_scatter(
        chosen, vlen, opt_row, field(match_pos), field(match_len),
        field(tokens), field(lengths), val_bytes, n=n, m=m,
        length_axis=int(tokens.shape[1]), out_width=out_width)
    return out, out_len, w, window & ~clash


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the index clamped into range, as a JAX gather
    clamps."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def _scatter_add(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """``t[lane, idx] += val`` along dim 1; out-of-range updates are
    dropped, as a JAX scatter drops them."""
    ok = (idx >= 0) & (idx < t.shape[1])
    t.scatter_add_(1, torch.where(ok, idx, 0).long(),
                   torch.where(ok, val, 0).to(t.dtype))
    return t


def _splice_scatter(chosen, vlen, opt_row, pos_w, len_w, tokens_w,
                    lengths_w, val_bytes, *, n, m, length_axis, out_width):
    """The schema-less splice, the twin of the reference's
    ``_splice_scatter`` (and, by the reference's own equality, of its
    ``_splice_compare``): per-byte coverage and start fields by scatter-
    adds, each output column's source unit by ``searchsorted`` over the
    units' inclusive ends.  A chosen match's start emits its value, a
    covered byte nothing, any other byte of the word its token; ``clash``
    marks lanes whose chosen matches overlap.  Returns ``(out uint8[N,
    W], out_len int32[N], clash bool[N])``."""
    del m
    dev = chosen.device
    la = length_axis
    ch = chosen.to(torch.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    cov = torch.zeros((n, la + 1), **i32)
    _scatter_add(cov, pos_w, ch)
    _scatter_add(cov, pos_w + len_w, -ch)
    cover = torch.cumsum(cov[:, :la], dim=1, dtype=torch.int32)
    covered = cover > 0
    clash = (cover > 1).any(dim=1)
    start_col = torch.minimum(pos_w, torch.tensor(la - 1, device=dev))
    started = _scatter_add(torch.zeros((n, la), **i32), start_col, ch)
    start_vlen = _scatter_add(torch.zeros((n, la), **i32), start_col, vlen)
    start_vrow = _scatter_add(torch.zeros((n, la), **i32), start_col,
                              opt_row)
    j = torch.arange(la, **i32)[None, :]
    unit_len = torch.where(
        j < lengths_w[:, None],
        torch.where(started > 0, start_vlen,
                    torch.where(covered, 0, 1)), 0).to(torch.int32)
    cum = torch.cumsum(unit_len, dim=1, dtype=torch.int32)
    out_len = cum[:, -1].contiguous()
    o = torch.arange(out_width, **i32)
    j_of_o = torch.searchsorted(
        cum, o[None, :].expand(n, out_width).contiguous(), right=True,
        out_int32=True).clamp(0, la - 1).long()

    def take(a):
        return a.gather(1, j_of_o)

    rel = o[None, :] - (take(cum) - take(unit_len))
    vw = val_bytes.shape[1]
    vrow = take(start_vrow).clamp(0, val_bytes.shape[0] - 1).long()
    from_val = val_bytes[vrow, rel.clamp(0, vw - 1).long()]
    out = torch.where(take(started) > 0, from_val, take(tokens_w))
    out = out * (o[None, :] < out_len[:, None])
    return out, out_len, clash
