"""Substitute-all (``-s``, ``-s -r``) plans: the host half of the reference
package's ``ops/expand_suball.py``.

The reference's transliteration engine (``processWordSubstituteAll``,
``main.go:308-365``) recursively assigns each unique pattern present in a
word one of its options *or skip*, then applies a ReplaceAll cascade at
every leaf.  That keyspace is a product space: with patterns ``p_1..p_P``
present and ``r_i = options(p_i) + 1``, every candidate is one digit
vector of the mixed-radix number ``prod r_i``.  A plan lists each word's
pattern slots (sorted-pattern order, slot 0 least significant) and its
SEGMENTS — alternating unclaimed gaps and pattern-occurrence spans; the
piece kernel splices a candidate from them.

Exactness conditions, checked per word at plan time:

* greedy leftmost occurrences of different patterns do not overlap;
* the table has no empty key;
* any cascade hazard among the word's present patterns
  (``CompiledTable.cascade_hazard``) is closable: every re-match lies
  wholly inside an inserted value, so the cascade's effect on a span is a
  statically known value rewrite.  Closable hazard slots get a joint value
  table (:func:`_close_pattern_set`): slot ``p`` with hazard successors
  ``q1 < q2 < ...`` stores one pre-cascaded value row per joint digit
  combination, addressed on the device through ``close_next`` /
  ``close_mul``.  Such words are ``closed``.

Words failing these checks get ``fallback=True`` and are expanded on the
host by the byte-exact oracle (``oracle.engines``).  Cascade closure is
on by default; ``A5GEN_CASCADE_CLOSE=off`` (:func:`close_enabled`) sends
every hazard word to the oracle, as in the reference.

:func:`expand_suball` is the device half (torch ops), the twin of the
reference's XLA expansion of substitute-all plans: the per-slot piece
splice or the schema-less segment splice, the pair tier, count windows
and the cascade closure's joint value index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tables.compile import CompiledTable, boundary_match_possible
from .expand_matches import (
    _take_rows,
    decode_digits,
    interleave_pairs,
    key_deltas,
    lane_fields,
    pair_lane_fields,
    rounded_out_width,
    variant_totals,
    splice_pieces,
    splice_pieces_pair,
    windowed_plan_fields,
)
from ..runtime.env import env_opt_out
from .packing import PackedWords

#: Cascade-closure caps. A hazard slot's joint value table covers its own
#: options × every successor's radix; past these bounds the word stays on
#: the oracle (the table would bloat the plan and the kernel's value
#: select). MAX_CLOSE_OPTS=12 covers every common qwerty-azerty hazard set
#: ({a,q}: 2 rows; {",",m}: 9; {A,Q,q} / {",",";"}: 12); only words
#: holding 3+ mutually-hazardous patterns (e.g. , ; m together) overflow.
MAX_CLOSE_SUCC = 3
MAX_CLOSE_OPTS = 12


def close_enabled() -> bool:
    """Cascade closure is ON by default; ``A5GEN_CASCADE_CLOSE`` set to
    ``off``/``0``/``no`` routes every hazard word through the host oracle
    (the reference's escape hatch)."""
    return not env_opt_out("A5GEN_CASCADE_CLOSE", "device cascade closure")


def _close_pattern_set(
    ct: CompiledTable, kis: Tuple[int, ...], first_option_only: bool
) -> "Optional[Tuple[List[List[int]], List[Optional[List[bytes]]]]]":
    """Try to close the ReplaceAll cascade for a word whose present patterns
    are ``kis`` (ascending key indices; caller guarantees no cross-pattern
    overlaps and no empty key — those words stay oracle-routed).

    Walks each slot's *reachable span texts* stage by stage through the
    later-sorted patterns: original span bytes are safe by the overlap
    invariant (any match touching an unreplaced span would be an
    occurrence-claim conflict in the original word), so only inserted /
    rewritten values are tracked. A later pattern that could match CROSSING
    a reachable text's boundary (``tables.compile.boundary_match_possible``
    — includes the empty-value splice join) makes the word genuinely
    pathological; a pattern matching INSIDE one becomes a hazard successor
    and forks the reachable set by its options. Multi-level rewrites
    (a successor's replacement re-matched by a later pattern) are handled
    by the same walk — the successor list simply grows.

    Returns ``(succ, rows)`` per local slot — ``succ[i]``: ascending local
    slot indices of slot i's hazard successors; ``rows[i]``: the closed
    value table (None when slot i needs no closure), one pre-cascaded row
    per joint digit combination in lexicographic ``(d_i, d_j1, d_j2, ...)``
    order with the LAST successor's digit varying fastest — or None when
    the word is pathological (boundary crossing or closure caps)."""
    keys = [ct.keys[ki] for ki in kis]
    vals: List[List[bytes]] = []
    for ki in kis:
        s0, c = int(ct.val_start[ki]), int(ct.val_count[ki])
        if first_option_only:
            c = min(1, c)
        vals.append([
            bytes(ct.val_bytes[s0 + o, : ct.val_len[s0 + o]])
            for o in range(c)
        ])
    n = len(kis)
    succ: List[List[int]] = []
    rows: List[Optional[List[bytes]]] = []
    for i in range(n):
        reach = list(dict.fromkeys(vals[i]))
        s_i: List[int] = []
        for j in range(i + 1, n):
            q = keys[j]
            if any(boundary_match_possible(t, q) for t in reach):
                return None  # splice/crossing rewrite: oracle only
            if any(q in t for t in reach):
                s_i.append(j)
                if len(s_i) > MAX_CLOSE_SUCC:
                    return None
                reach = list(dict.fromkeys(
                    reach
                    + [t.replace(q, u) for t in reach for u in vals[j]]
                ))
        if s_i:
            jopts = len(vals[i])
            for j in s_i:
                jopts *= len(vals[j]) + 1
            if jopts > MAX_CLOSE_OPTS:
                return None
            out: List[bytes] = []

            def build(t: bytes, idx: int) -> None:
                if idx == len(s_i):
                    out.append(t)
                    return
                j = s_i[idx]
                build(t, idx + 1)  # successor skipped (digit 0)
                for u in vals[j]:
                    # Sorted-pattern cascade order: successors ascend, so
                    # the replace chain IS the oracle's Q4 order.
                    build(t.replace(keys[j], u), idx + 1)

            for v in vals[i]:
                build(v, 0)
            rows.append(out)
        else:
            rows.append(None)
        succ.append(s_i)
    return succ, rows


#: Pattern-set closure record: the _close_pattern_set result (successor
#: lists + closed value rows per local slot), shared by every word whose
#: present-pattern set matches.
_SetClosure = Tuple[List[List[int]], List[Optional[List[bytes]]]]


def _closure_fields(
    ct: CompiledTable,
    closure_sets: Dict[Tuple[int, ...], _SetClosure],
    word_sets: Dict[Tuple[int, ...], List[int]],
    key_radix: np.ndarray,
    pat_val_start: np.ndarray,
    num_p: int,
    batch: int,
):
    """Materialize plan fields from pattern-SET closures (shared by both
    plan constructors; mutates ``pat_val_start`` rows of closed slots to
    point into the extended value table). All work is per distinct pattern set
    (azerty-class dictionaries have a handful), with the set's word rows
    assigned by one fancy index each — no per-word Python loop, matching
    the fast constructor's scaling contract.

    ``closure_sets`` maps a present-pattern key-index tuple to its
    ``(succ, rows)`` closure; ``word_sets`` maps the same keys to the
    ascending word rows holding that set; ``key_radix`` is the per-key
    ``options + 1`` (options already clamped for suball-reverse).

    Returns ``(close_next [B,P,S], close_mul [B,P,S+1], cval_bytes,
    cval_len, close_opts, wmax)`` — ``close_mul[..., 0]`` is the OWN
    digit's multiplier (1 on non-closed slots, so the uniform device
    address ``val_start + (d-1)*mul0 + Σ d_succ*mul_s`` degenerates to the
    classic ``val_start + d - 1``); ``wmax [B, num_p]`` holds each closed
    slot's widest pre-cascaded row (-1 elsewhere) for output-width sizing.
    Closed value rows are deduplicated by ``(key, successor-key tuple)``;
    insertion order is by each set's FIRST word row, so the fast and
    scalar constructors produce identical extended tables."""
    s_max = 1
    for succ, rows in closure_sets.values():
        for sl, r in enumerate(rows):
            if r is not None:
                s_max = max(s_max, len(succ[sl]))
    close_next = np.full((batch, num_p, s_max), -1, dtype=np.int32)
    close_mul = np.zeros((batch, num_p, s_max + 1), dtype=np.int32)
    close_mul[:, :, 0] = 1
    wmax = np.full((batch, num_p), -1, dtype=np.int64)
    v0 = int(ct.val_bytes.shape[0])
    ext_rows: List[bytes] = []
    ext_base: Dict[tuple, int] = {}
    close_opts = 0
    for kis in sorted(word_sets, key=lambda k: word_sets[k][0]):
        succ, rows = closure_sets[kis]
        rws = np.asarray(word_sets[kis], dtype=np.int64)
        for sl, r in enumerate(rows):
            if r is None:
                continue
            key = (kis[sl], tuple(kis[j] for j in succ[sl]))
            if key not in ext_base:
                ext_base[key] = v0 + len(ext_rows)
                ext_rows.extend(r)
            pat_val_start[rws, sl] = ext_base[key]
            mul = 1
            for s_i in range(len(succ[sl]) - 1, -1, -1):
                j = succ[sl][s_i]
                close_next[rws, sl, s_i] = j
                close_mul[rws, sl, 1 + s_i] = mul
                mul *= int(key_radix[kis[j]])
            close_mul[rws, sl, 0] = mul
            close_opts = max(close_opts, len(r))
            wmax[rws, sl] = max((len(x) for x in r), default=0)
    width = max(
        int(ct.val_bytes.shape[1]),
        max((len(x) for x in ext_rows), default=1),
        1,
    )
    e = len(ext_rows)
    cval_bytes = np.zeros((v0 + e, width), dtype=np.uint8)
    cval_bytes[:v0, : ct.val_bytes.shape[1]] = ct.val_bytes
    cval_len = np.zeros((v0 + e,), dtype=np.int32)
    cval_len[:v0] = ct.val_len
    for r_i, x in enumerate(ext_rows):
        if x:
            cval_bytes[v0 + r_i, : len(x)] = np.frombuffer(x, dtype=np.uint8)
        cval_len[v0 + r_i] = len(x)
    return close_next, close_mul, cval_bytes, cval_len, close_opts, wmax


@dataclass(frozen=True)
class SubAllPlan:
    """Device-ready per-word expansion plan for substitute-all mode.

    Axes: B words, P pattern slots (slot order = sorted-pattern order, slot 0
    is the least-significant mixed-radix digit), G segments (in word order).
    """

    tokens: np.ndarray  # uint8 [B, L]
    lengths: np.ndarray  # int32 [B]
    index: np.ndarray  # int64 [B] — wordlist ordinals (from PackedWords)
    pat_radix: np.ndarray  # int32 [B, P] — options+1, 1 on inactive slots
    pat_val_start: np.ndarray  # int32 [B, P] — CSR into table val rows
    seg_orig_start: np.ndarray  # int32 [B, G]
    seg_orig_len: np.ndarray  # int32 [B, G] — 0 on inactive segments
    seg_pat: np.ndarray  # int32 [B, G] — pattern slot, -1 for gaps
    n_variants: Tuple[int, ...]  # python bigints — Π radix per word, or the
    #                              windowed totals when ``windowed``
    fallback: np.ndarray  # bool [B] — word needs the CPU oracle
    out_width: int  # static candidate-buffer width (uint32-aligned)
    windowed: bool = False  # count-windowed enumeration active
    win_v: "np.ndarray | None" = None  # int32 [B, P+1, K+2] suffix counts
    #   (see expand_matches.MatchPlan.win_v — identical scheme over
    #   pattern slots)
    # --- cascade closure (all None/0 when no word needed closure) --------
    closed: "np.ndarray | None" = None  # bool [B] — device-closed words
    close_next: "np.ndarray | None" = None  # int32 [B, P, S] — successor
    #   slots of each pattern slot (-1 inactive)
    close_mul: "np.ndarray | None" = None  # int32 [B, P, S+1] — joint value
    #   index multipliers; column 0 multiplies the slot's OWN digit-1
    cval_bytes: "np.ndarray | None" = None  # uint8 [V+E, W] — plan value
    #   table: the compiled table's rows + closed-cascade rows (device
    #   kernels use this INSTEAD of table_arrays' val_bytes when present)
    cval_len: "np.ndarray | None" = None  # int32 [V+E]
    close_opts: int = 0  # widest closed joint table (rows per slot)

    @property
    def batch(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def num_slots(self) -> int:
        return int(self.pat_radix.shape[1])

    @property
    def num_segments(self) -> int:
        return int(self.seg_orig_start.shape[1])


def _build_suball_plan_fast(
    ct: CompiledTable,
    packed: PackedWords,
    *,
    first_option_only: bool,
    out_width: "int | None",
    min_substitute: "int | None",
    max_substitute: "int | None",
    force_windowed: "bool | None" = None,
) -> "SubAllPlan | None":
    """Vectorized plan construction for every table WITHOUT an empty key
    (the ``=x`` line routes all words to the oracle — rare and cheap, so
    it keeps the scalar path).

    The scan vectorizes per key: single-byte keys are one byte-LUT lookup;
    multi-byte keys use shifted compares plus an O(L) greedy pass that
    reproduces ``bytes.find``'s non-overlapping occurrence walk. The
    scalar path's word-level fallback flag is equivalent to "some pair of
    occurrences overlaps": if no claim conflict fires, every key's
    occurrence loop completes, so claimed spans ARE the independent
    occurrence sets and are disjoint; conversely any overlap between
    independent occurrences is detected when the later-sorted key claims.
    Cross-pattern cascade hazards reduce to a presence×hazard matmul.

    For fallback words the scalar path records the PARTIAL spans claimed
    before the conflict; those segment fields are dead (the block cutter
    skips fallback words, the oracle re-derives their candidates), so this
    path stores the independent spans instead and only guarantees segment
    equality on non-fallback rows; pattern-slot fields ARE equal
    everywhere because both paths neutralize fallback rows to radix 1
    before the windowed decision (tests pin exactly this contract; width
    sizing also considers only non-fallback rows). The per-word Python
    loop this replaces took ~30 s for a 300k-word dictionary — longer
    than the whole device sweep.
    """
    if ct.has_empty_key or ct.num_keys == 0:
        return None
    tokens, lengths = packed.tokens, packed.lengths
    b, width = tokens.shape
    if b == 0 or width == 0:
        return None  # degenerate shapes: keep the scalar reference path
    j = np.arange(width)
    in_word = j[None, :] < lengths[:, None]
    k = ct.num_keys

    # Occurrence scan: per-position key index / span length, coverage
    # deltas for the overlap test, presence and span counts per word.
    occ_key = np.full((b, width), -1, dtype=np.int32)
    occ_len = np.zeros((b, width), dtype=np.int32)
    cover_delta = np.zeros((b, width + 1), dtype=np.int32)
    present = np.zeros((b, k), dtype=bool)
    span_count = np.zeros(b, dtype=np.int64)

    if ct.max_key_len >= 1:
        ki1 = np.where(in_word, ct.byte_to_key[tokens], -1)  # [B, L]
        m1 = ki1 >= 0
        occ_key = np.where(m1, ki1, occ_key)
        occ_len = np.where(m1, 1, occ_len)
        cover_delta[:, :width] += m1
        cover_delta[:, 1:] -= m1
        r1, c1 = np.nonzero(m1)
        present[r1, ki1[r1, c1]] = True
        span_count += m1.sum(axis=1)

    for kidx in np.nonzero((ct.key_len >= 2) & (ct.key_len <= width))[0]:
        klen = int(ct.key_len[kidx])
        key = ct.key_bytes[kidx]
        match = (j[None, :] + klen) <= lengths[:, None]
        for t in range(klen):
            match[:, : width - t] &= tokens[:, t:] == key[t]
            if t:
                match[:, width - t:] = False
        # Greedy non-overlapping same-key occurrences (bytes.find walk).
        sel = np.zeros((b, width), dtype=bool)
        next_free = np.zeros(b, dtype=np.int32)
        for jj in range(width - klen + 1):
            take = match[:, jj] & (jj >= next_free)
            sel[:, jj] = take
            next_free = np.where(take, jj + klen, next_free)
        occ_key = np.where(sel, np.int32(kidx), occ_key)
        occ_len = np.where(sel, np.int32(klen), occ_len)
        cover_delta[:, :width] += sel
        cover_delta[:, klen:] -= sel[:, : width + 1 - klen]
        present[:, kidx] |= sel.any(axis=1)
        span_count += sel.sum(axis=1)

    coverage = np.cumsum(cover_delta[:, :width], axis=1)  # [B, L]
    overlap_mask = (coverage > 1).any(axis=1)
    hazard_mask = np.zeros(b, dtype=bool)
    if ct.cascade_hazard.any():
        hz = ct.cascade_hazard.astype(np.int32)
        m = present.astype(np.int32) @ hz  # hazardous-predecessor counts
        hazard_mask = ((m > 0) & present).any(axis=1)
    fallback_mask = overlap_mask | hazard_mask

    # Cascade closure: containment-only hazard words keep the device path
    # (their hazard slots get joint value tables — see the module
    # docstring). Closure analysis runs once per present-pattern SET:
    # azerty-class tables have a handful of distinct hazard sets across a
    # whole dictionary, and every downstream materialization stays
    # set-level too (one fancy index per set — no per-word Python loop).
    closed_mask = np.zeros(b, dtype=bool)
    closure_sets: Dict[Tuple[int, ...], _SetClosure] = {}
    word_sets: Dict[Tuple[int, ...], List[int]] = {}
    if close_enabled() and bool(hazard_mask.any()):
        set_cache: Dict[Tuple[int, ...], "Optional[_SetClosure]"] = {}
        for i in np.nonzero(hazard_mask & ~overlap_mask)[0]:
            kis = tuple(int(x) for x in np.nonzero(present[i])[0])
            if kis not in set_cache:
                set_cache[kis] = _close_pattern_set(
                    ct, kis, first_option_only
                )
            cl = set_cache[kis]
            if cl is not None:
                fallback_mask[i] = False
                if any(r is not None for r in cl[1]):
                    closure_sets[kis] = cl
                    word_sets.setdefault(kis, []).append(int(i))
                    closed_mask[i] = True
                # All-None rows: the (conservative) table-level hazard
                # never manifests under this mode's option set (e.g. the
                # hazard value is clamped away in suball-reverse) — the
                # plain span-splice path is exact, so the word is CLEAN,
                # not closed.

    # Slots: the word's present keys in ascending order. Fallback rows
    # are neutralized below (radix 1) in BOTH paths, so dead rows never
    # influence the windowed-enumeration decision and pat_* fields agree
    # everywhere.
    num_p = max(1, int(present.sum(axis=1).max()))
    krank = np.cumsum(present, axis=1) - 1  # [B, K]
    vc = ct.val_count.astype(np.int64)
    options = np.minimum(1, vc) if first_option_only else vc
    key_radix = (options + 1).astype(np.int32)
    pat_radix = np.ones((b, num_p), dtype=np.int32)
    pat_val_start = np.zeros((b, num_p), dtype=np.int32)
    pw, pk = np.nonzero(present)
    slot_of = krank[pw, pk]
    pat_radix[pw, slot_of] = key_radix[pk]
    pat_val_start[pw, slot_of] = ct.val_start[pk]
    # Closure fields before neutralization: closed words keep live radices
    # and get their hazard slots re-pointed into the extended value table.
    close_next = close_mul = cval_bytes = cval_len = wmax = None
    close_opts = 0
    if closure_sets:
        (close_next, close_mul, cval_bytes, cval_len, close_opts,
         wmax) = _closure_fields(
            ct, closure_sets, word_sets, key_radix, pat_val_start, num_p, b
        )
    pat_radix[fallback_mask] = 1
    pat_val_start[fallback_mask] = 0

    # Segments: spans start where an occurrence starts; gaps start at
    # word-open or right after covered text. (Fallback rows may hold
    # overlapping spans — their fields are dead, see docstring.)
    covered = coverage > 0
    prev_covered = np.zeros_like(covered)
    prev_covered[:, 1:] = covered[:, :-1]
    span_start = occ_len > 0
    seg_start_mask = in_word & (
        span_start | (~covered & ((j[None, :] == 0) | prev_covered))
    )
    num_g = 2 * max(1, int(span_count.max())) + 1
    seg_rank = np.cumsum(seg_start_mask, axis=1) - 1
    srows, scols = np.nonzero(seg_start_mask)
    gidx = seg_rank[srows, scols]
    if len(gidx) and int(gidx.max()) >= num_g:
        num_g = int(gidx.max()) + 1  # safety: never truncate segments
    # Segment end = next segment's start in the same row, else word end
    # (for spans that equals start + key length on non-fallback rows).
    nxt = np.empty_like(scols)
    if len(scols):
        nxt[:-1] = scols[1:]
        nxt[-1] = 0
    same_row = np.zeros(len(srows), dtype=bool)
    if len(srows):
        same_row[:-1] = srows[1:] == srows[:-1]
    seg_end = np.where(same_row, nxt, lengths[srows])
    seg_orig_start = np.zeros((b, num_g), dtype=np.int32)
    seg_orig_len = np.zeros((b, num_g), dtype=np.int32)
    seg_pat = np.full((b, num_g), -1, dtype=np.int32)
    seg_orig_start[srows, gidx] = scols
    is_span = span_start[srows, scols]
    seg_orig_len[srows, gidx] = np.where(
        is_span, occ_len[srows, scols], (seg_end - scols).astype(np.int32)
    )
    s_ki = np.clip(occ_key[srows, scols], 0, k - 1)
    seg_pat[srows, gidx] = np.where(
        is_span, krank[srows, s_ki], -1
    ).astype(np.int32)

    # Output growth per occurrence (non-fallback rows size the buffer —
    # fallback words never reach the device).
    delta_per_key = key_deltas(ct, limit_first_option=False)
    orows, ocols = np.nonzero(occ_len > 0)
    word_delta = np.zeros(b, dtype=np.int64)
    np.add.at(word_delta, orows, delta_per_key[occ_key[orows, ocols]])
    # Closed words: a rewritten row can outgrow the table's widest value
    # (v.replace can lengthen), so their growth re-sums over the closed
    # tables' widest rows — vectorized over the closed occurrences via
    # the wmax [B, P] matrix (same scatter scheme as the base delta).
    if wmax is not None:
        in_closed = closed_mask[orows]
        r2, c2 = orows[in_closed], ocols[in_closed]
        ki2 = occ_key[r2, c2]
        w2 = wmax[r2, krank[r2, ki2]]
        contrib = np.where(
            w2 >= 0,
            np.maximum(0, w2 - occ_len[r2, c2]),
            delta_per_key[ki2],
        )
        word_delta[closed_mask] = 0
        np.add.at(word_delta, r2, contrib)
    word_delta[fallback_mask] = 0
    max_delta = int(word_delta.max())
    if out_width is None:
        out_width = rounded_out_width(width, max_delta)

    n_variants = variant_totals(pat_radix)
    for i in np.nonzero(fallback_mask)[0]:
        n_variants[int(i)] = 0

    windowed, win_v, n_variants = windowed_plan_fields(
        pat_radix, n_variants, min_substitute, max_substitute,
        zero_mask=fallback_mask, force=force_windowed,
    )
    return SubAllPlan(
        tokens=packed.tokens,
        lengths=packed.lengths,
        index=packed.index,
        pat_radix=pat_radix,
        pat_val_start=pat_val_start,
        seg_orig_start=seg_orig_start,
        seg_orig_len=seg_orig_len,
        seg_pat=seg_pat,
        n_variants=tuple(n_variants),
        fallback=fallback_mask,
        out_width=out_width,
        windowed=windowed,
        win_v=win_v,
        closed=closed_mask if closure_sets else None,
        close_next=close_next,
        close_mul=close_mul,
        cval_bytes=cval_bytes,
        cval_len=cval_len,
        close_opts=close_opts,
    )


def build_suball_plan(
    ct: CompiledTable,
    packed: PackedWords,
    *,
    first_option_only: bool = False,
    out_width: int | None = None,
    min_substitute: int | None = None,
    max_substitute: int | None = None,
    force_windowed: bool | None = None,
) -> SubAllPlan:
    """Host-side plan construction (numpy + bytes.find).

    ``first_option_only=True`` builds the ``-s -r`` (substitute-all reverse)
    space: the reference enumerates every subset of present patterns with
    only ``subs[0]`` applied (Q2, ``main.go:393-398``), which is exactly this
    plan with every radix clamped to 2. Its per-word multiset equals the
    oracle's subset lattice (each subset emitted once, size windowed).
    ``force_windowed`` pins the count-windowed decision, as
    ``expand_matches.build_match_plan``'s does."""
    fast = _build_suball_plan_fast(
        ct, packed, first_option_only=first_option_only,
        out_width=out_width, min_substitute=min_substitute,
        max_substitute=max_substitute, force_windowed=force_windowed,
    )
    if fast is not None:
        return fast
    b, width = packed.tokens.shape
    hazard = ct.cascade_hazard

    per_word: List[dict] = []
    closure_sets: Dict[Tuple[int, ...], _SetClosure] = {}
    word_sets: Dict[Tuple[int, ...], List[int]] = {}
    set_cache: Dict[Tuple[int, ...], "Optional[_SetClosure]"] = {}
    max_p = 1
    max_s = 1
    for i in range(b):
        word = packed.word(i)
        slots: List[int] = []  # key indices, ascending = sorted patterns
        spans: List[Tuple[int, int, int]] = []  # (start, klen, slot)
        claimed = np.zeros(len(word), dtype=bool)
        overlap = ct.has_empty_key
        for ki, key in enumerate(ct.keys):
            if not key or overlap:
                continue
            pos = word.find(key)
            if pos < 0:
                continue
            slot = len(slots)
            slots.append(ki)
            while pos >= 0:
                end = pos + len(key)
                if claimed[pos:end].any():
                    overlap = True  # cross-pattern overlap: subset-dependent
                    break
                claimed[pos:end] = True
                spans.append((pos, len(key), slot))
                pos = word.find(key, end)
        hazardous = False
        if not overlap and len(slots) > 1:
            ks = np.asarray(slots)
            hazardous = bool(hazard[np.ix_(ks, ks)].any())
        fallback = overlap or hazardous
        closure = None
        if hazardous and not overlap and close_enabled():
            kis = tuple(slots)
            if kis not in set_cache:
                set_cache[kis] = _close_pattern_set(
                    ct, kis, first_option_only
                )
            cl = set_cache[kis]
            if cl is not None:
                fallback = False
                if any(r is not None for r in cl[1]):
                    closure = cl
                    closure_sets[kis] = cl
                    word_sets.setdefault(kis, []).append(i)
                # else: hazard never manifests under this option set —
                # clean, not closed (mirrors the fast path).
        spans.sort()
        per_word.append({"slots": slots, "spans": spans,
                         "fallback": fallback, "closure": closure})
        max_p = max(max_p, len(slots))
        max_s = max(max_s, len(spans))

    num_p, num_g = max_p, 2 * max_s + 1
    pat_radix = np.ones((b, num_p), dtype=np.int32)
    pat_val_start = np.zeros((b, num_p), dtype=np.int32)
    seg_orig_start = np.zeros((b, num_g), dtype=np.int32)
    seg_orig_len = np.zeros((b, num_g), dtype=np.int32)
    seg_pat = np.full((b, num_g), -1, dtype=np.int32)
    n_variants: List[int] = []
    fallback_mask = np.zeros((b,), dtype=bool)
    max_delta = 0

    for i, info in enumerate(per_word):
        fallback_mask[i] = info["fallback"]
        total = 1
        for slot, ki in enumerate(info["slots"]):
            options = min(1, int(ct.val_count[ki])) if first_option_only else int(ct.val_count[ki])
            pat_radix[i, slot] = options + 1
            pat_val_start[i, slot] = ct.val_start[ki]
            total *= options + 1
        n_variants.append(total if not info["fallback"] else 0)

        # Segments: gap before each span, the span, and a final gap to len.
        g = 0
        cursor = 0
        delta = 0
        for start, klen, slot in info["spans"]:
            if start > cursor:
                seg_orig_start[i, g] = cursor
                seg_orig_len[i, g] = start - cursor
                g += 1
            seg_orig_start[i, g] = start
            seg_orig_len[i, g] = klen
            seg_pat[i, g] = slot
            g += 1
            cursor = start + klen
            ki = info["slots"][slot]
            closure = info["closure"]
            if closure is not None and closure[1][slot] is not None:
                # Closed slot: growth is bounded by the joint table's
                # widest pre-cascaded row, not the raw value rows.
                widest = max(len(x) for x in closure[1][slot])
            else:
                vs, vc = int(ct.val_start[ki]), int(ct.val_count[ki])
                widest = max(
                    (int(ct.val_len[vs + o]) for o in range(vc)),
                    default=klen,
                )
            delta += max(0, widest - klen)
        word_len = int(packed.lengths[i])
        if cursor < word_len:
            seg_orig_start[i, g] = cursor
            seg_orig_len[i, g] = word_len - cursor
            g += 1
        max_delta = max(max_delta, delta)

    if out_width is None:
        out_width = max(4, -(-(width + max_delta) // 4) * 4)

    # Closure fields before neutralization (mirrors the fast path).
    close_next = close_mul = cval_bytes = cval_len = None
    close_opts = 0
    closed_mask = np.zeros((b,), dtype=bool)
    if closure_sets:
        for rws in word_sets.values():
            closed_mask[rws] = True
        vc_k = ct.val_count.astype(np.int64)
        opts_k = np.minimum(1, vc_k) if first_option_only else vc_k
        close_next, close_mul, cval_bytes, cval_len, close_opts, _ = (
            _closure_fields(
                ct, closure_sets, word_sets,
                (opts_k + 1).astype(np.int32),
                pat_val_start, num_p, b,
            )
        )

    # Neutralize fallback rows (mirrored in the fast path): their slots
    # are dead — the oracle re-derives those words — and must not sway
    # the global windowed-enumeration decision below.
    pat_radix[fallback_mask] = 1
    pat_val_start[fallback_mask] = 0

    # Count-windowed enumeration for tight -m/-x windows (same DP scheme
    # as match plans — the suball count is "distinct patterns chosen",
    # which is exactly "digits > 0 over slots with options"). Fallback
    # words keep the oracle route: totals forced to 0, matching the
    # full-enumeration convention above.
    windowed, win_v, n_variants = windowed_plan_fields(
        pat_radix, n_variants, min_substitute, max_substitute,
        zero_mask=fallback_mask, force=force_windowed,
    )

    return SubAllPlan(
        tokens=packed.tokens,
        lengths=packed.lengths,
        index=packed.index,
        pat_radix=pat_radix,
        pat_val_start=pat_val_start,
        seg_orig_start=seg_orig_start,
        seg_orig_len=seg_orig_len,
        seg_pat=seg_pat,
        n_variants=tuple(n_variants),
        fallback=fallback_mask,
        out_width=out_width,
        windowed=windowed,
        win_v=win_v,
        closed=closed_mask if closure_sets else None,
        close_next=close_next,
        close_mul=close_mul,
        cval_bytes=cval_bytes,
        cval_len=cval_len,
        close_opts=close_opts,
    )


def expand_suball(
    tokens, lengths, pat_radix, pat_val_start, seg_orig_start, seg_orig_len,
    seg_pat, val_bytes, val_len, blk_word, blk_base, blk_count, blk_offset,
    *, num_lanes: int, out_width: int, min_substitute: int,
    max_substitute: int, block_stride: "int | None" = None, win_v=None,
    radix2: bool = False, close_next=None, close_mul=None, pieces=None,
    piece_tables: "dict | None" = None, pair_k: "int | None" = None,
):
    """Decode + materialize ``num_lanes`` variants of a substitute-all
    plan (per-word arrays as tensors), the twin of the reference's
    ``expand_suball``.  ``close_next`` / ``close_mul``: a cascade-closed
    plan's joint value index (``val_bytes`` / ``val_len`` are then the
    plan's ``cval_*``).  With ``pieces`` (and ``piece_tables`` holding its
    ``sslot`` column slots) the per-slot piece splice, else the segment
    splice; ``pair_k=2`` runs the pair tier.  Returns ``(cand uint8[N,
    out_width], cand_len int32[N], word_row int32[N], emit bool[N])``;
    bytes past ``cand_len`` are zero."""
    n = num_lanes
    p = pat_radix.shape[1]
    g = seg_orig_start.shape[1]
    if pair_k:
        if pair_k != 2:
            raise ValueError(f"pair_k must be 2 or None, got {pair_k}")
        if (pieces is None or not pieces.pair_ok or win_v is not None
                or close_next is not None):
            raise ValueError("the pair-lane tier needs a pair-eligible "
                             "PieceSchema, full enumeration and no "
                             "cascade closure")
        rank, ok0, ok1, w, base, field = pair_lane_fields(
            blk_word, blk_base, blk_count, num_lanes=n,
            block_stride=block_stride)
        lane_ok, rank_c = ok0, rank * 2
    else:
        rank, lane_ok, w, base, field = lane_fields(
            blk_word, blk_base, blk_count, blk_offset, num_lanes=n,
            block_stride=block_stride)
        rank_c = rank
    radix = field(pat_radix)
    digits = decode_digits(rank_c, base, radix, field, win_v, p,
                           radix2=radix2)
    active = radix > 1
    chosen_count = ((digits > 0) & active).sum(dim=1, dtype=torch.int32)
    if close_next is not None:
        cn = field(close_next)  # [N, P, S]
        cm = field(close_mul)  # [N, P, S+1]
        s_ax = cn.shape[2]
        idx = cn.clamp(0, p - 1).reshape(-1, p * s_ax).long()
        dsucc = digits.gather(1, idx).reshape(-1, p, s_ax)
        jd = (digits - 1) * cm[:, :, 0] + torch.where(
            cn >= 0, dsucc * cm[:, :, 1:], 0).sum(dim=2, dtype=torch.int32)
    else:
        jd = digits - 1

    def window(ok, cc):
        return ok & (cc >= min_substitute) & (cc <= max_substitute)

    if pieces is not None:
        sslot_w = field(piece_tables["sslot"]).clamp(0, p - 1).long()
        col_d = digits.gather(1, sslot_w)
        if close_next is not None:
            col_var = torch.where(col_d > 0, 1 + jd.gather(1, sslot_w), 0)
        else:
            col_var = col_d
        if pair_k:
            d0 = digits[:, 0]
            d0p = torch.minimum(d0 + 1, radix[:, 0] - 1)
            col0p = torch.where(sslot_w[:, 0] == 0, d0p, col_var[:, 0])
            out0, len0, out1, len1 = splice_pieces_pair(
                pieces, piece_tables, field, digits, col0p,
                lambda c: col_var[:, c], n=n, out_width=out_width)
            act0 = active[:, 0]
            cc1 = (chosen_count + ((d0p > 0) & act0).to(torch.int32)
                   - ((d0 > 0) & act0).to(torch.int32))
            return (interleave_pairs(out0, out1),
                    interleave_pairs(len0, len1), interleave_pairs(w, w),
                    interleave_pairs(window(ok0, chosen_count),
                                     window(ok1, cc1)))
        out, out_len = splice_pieces(
            pieces, piece_tables, field, lambda c: col_var[:, c], n=n,
            out_width=out_width, device=digits.device)
        return out, out_len, w, window(lane_ok, chosen_count)

    # Per-segment output lengths and value rows for this variant.
    spat_w = field(seg_pat)
    is_span = spat_w >= 0
    safe_slot = torch.where(is_span, spat_w, 0).clamp(0, p - 1).long()
    seg_digit = torch.where(is_span, digits.gather(1, safe_slot), 0)
    chosen = seg_digit > 0
    vstart = field(pat_val_start).gather(1, safe_slot)
    opt_row = torch.where(chosen, vstart + jd.gather(1, safe_slot), 0)
    seg_len = torch.where(chosen, _take_rows(val_len, opt_row),
                          field(seg_orig_len)).to(torch.int32)
    seg_end = torch.cumsum(seg_len, dim=1, dtype=torch.int32)
    out_len = seg_end[:, -1].contiguous()
    seg_start_out = seg_end - seg_len
    # Each output column's segment: the first whose inclusive end exceeds
    # it (seg_end is non-decreasing, so a right-sided search counts the
    # ends at or below the column, as the reference's compare-sum does).
    j = torch.arange(out_width, dtype=torch.int32, device=digits.device)
    seg_of_j = torch.searchsorted(
        seg_end, j[None, :].expand(n, out_width).contiguous(), right=True,
        out_int32=True).clamp(0, g - 1).long()

    def take(a):
        return a.gather(1, seg_of_j)

    rel = j[None, :] - take(seg_start_out)
    vw = val_bytes.shape[1]
    src_row = take(opt_row).clamp(0, val_bytes.shape[0] - 1).long()
    from_val = val_bytes[src_row, rel.clamp(0, vw - 1).long()]
    src_orig = (take(field(seg_orig_start)) + rel).clamp(
        0, tokens.shape[1] - 1).long()
    from_word = field(tokens).gather(1, src_orig)
    out = torch.where(take(chosen.to(torch.int32)) > 0, from_val, from_word)
    out = out * (j[None, :] < out_len[:, None])
    return out, out_len, w, window(lane_ok, chosen_count)
