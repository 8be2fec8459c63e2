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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

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


def windowed_plan_fields(
    radix_matrix: np.ndarray,
    n_variants: List[int],
    min_substitute: "int | None",
    max_substitute: "int | None",
    zero_mask: "np.ndarray | None" = None,
) -> "Tuple[bool, np.ndarray | None, List[int]]":
    """Windowed-enumeration eligibility + table construction: bounds
    check, suffix-count DP, and the 2x lane-saving vote (windowed
    enumeration engages only when it at least halves the lane count).
    ``zero_mask`` marks words whose totals are forced to 0 (substitute-all
    plans' oracle-routed words).  Returns ``(windowed, win_v,
    n_variants)`` — unchanged inputs when ineligible."""
    if (
        min_substitute is None
        or max_substitute is None
        or not 0 <= min_substitute <= max_substitute <= WINDOWED_MAX_SUBST
        or radix_matrix.shape[0] == 0
    ):
        return False, None, n_variants
    v, totals = _windowed_tables(radix_matrix, min_substitute, max_substitute)
    if v is None:
        return False, None, n_variants
    if zero_mask is not None:
        totals = [0 if zero_mask[i] else t for i, t in enumerate(totals)]
    full = sum(min(t, 1 << 62) for t in n_variants)
    if sum(totals) * 2 > full:
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
) -> MatchPlan:
    """Host-side plan construction for default (``first_option_only=False``)
    or reverse (``True``) mode.

    When the EFFECTIVE substitution window ``[min_substitute,
    max_substitute]`` is given and tight (``max_substitute <=
    WINDOWED_MAX_SUBST``, windowed totals < 2^30, and at least a 2x lane
    saving over full enumeration), the plan switches to count-windowed
    enumeration: ranks walk only in-window digit vectors via the ``win_v``
    DP instead of masking the full mixed-radix space (the piece kernel's
    windowed tier walks the same DP on the device).
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
