"""Fixed-stride block index over a plan's variant space, and the host
block cutter.

A *block* is ``(word, base_digits, count)``: a contiguous rank range of one
word's mixed-radix variant space.  The superstep body cuts its blocks on the
device from the int32 cumulative index built here (one ``searchsorted``
plus a mixed-radix decompose), and the host maps superstep boundaries back
to ``(word, rank)`` cursors with :func:`block_cursor` — the same index on
both sides, so they can never disagree.  A plan whose index is not
int32-safe (a word of :data:`MAX_BLOCK` rows or more) runs the per-launch
pipeline instead: :func:`make_blocks` cuts each launch's blocks on the
host with Python-int cursors, so a word's rank may pass 2^63 while every
block field stays int32 (the reference's ``ops/blocks.py``, copied).

Any plan can be indexed here as long as it exposes ``batch``,
``num_slots``, ``n_variants`` (per-word Python ints — these can exceed
2^63), ``fallback`` (words the device never sees) and ``pat_radix[B, P]``
(per-slot radices, 1 on inactive slots).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

#: Per-block variant-count cap: in-block ranks must fit int32.
MAX_BLOCK = 1 << 30

#: Most blocks one int32 block index holds: a bucket whose index would
#: pass it runs as several sub-sweeps over word ranges (:func:`word_ranges`),
#: each with its own index, so ``b0 + launch`` arithmetic on the device
#: stays far inside int32.
SPLIT_BLOCKS = 1 << 30

#: Words whose variant total reaches this occupy one index slot, make the
#: index int32-unsafe and are cut by the scalar path of :func:`make_blocks`
#: only: the vectorized cutter works in int64 block/rank arithmetic, which
#: a ~2^60-variant word would overflow.  (No shipped table comes anywhere
#: close; the cap exists for correctness, not tuning.)
_HUGE_WORD = 1 << 60


def _stride_index(plan, stride: int):
    """Per-(plan, stride) cumulative block index.

    ``cum[w]`` = global index of word ``w``'s first block when every
    non-fallback word is cut into ``ceil(total / stride)`` fixed-stride
    blocks; fallback and huge words occupy zero / one slot (``huge`` marks
    the latter). Cached on the plan object (plans are frozen;
    ``object.__setattr__`` is the sanctioned backdoor) so the O(batch) pass
    runs once per sweep.
    """
    cache = getattr(plan, "_stride_index_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(plan, "_stride_index_cache", cache)
    if stride in cache:
        return cache[stride]
    b = plan.batch
    widths = np.zeros(b + 1, dtype=np.int64)
    totals = np.zeros(b, dtype=np.int64)
    huge = np.zeros(b, dtype=bool)
    fallback = plan.fallback
    total_width = 0  # Python int: overflow-proof running sum of widths
    for i, t in enumerate(plan.n_variants):
        if fallback[i]:
            continue
        if t >= _HUGE_WORD:
            # Width 1, not ceil(t/stride): a single slot keeps the cumsum
            # small instead of adding ~2^53 per huge word (~1024 such words
            # would overflow the int64 cumsum).
            huge[i] = True
            totals[i] = _HUGE_WORD
            widths[i + 1] = 1
            total_width += 1
        else:
            totals[i] = t
            w_i = -(-t // stride)
            widths[i + 1] = w_i
            total_width += w_i
    if total_width >= (1 << 62):
        # Cumulative block index would overflow int64 (needs ~2^55 words
        # just below the huge cap).
        cache[stride] = None
        return None
    entry = (np.cumsum(widths), totals, huge)
    cache[stride] = entry
    return entry


def superstep_index(plan, stride: int, words: "Tuple[int, int] | None" = None):
    """int32 view of the fixed-stride block index for the DEVICE-side
    cutter (``models.attack.make_superstep_body``): each superstep cuts
    its blocks on device from these per-sweep arrays.  ``words = (lo,
    hi)`` indexes only words ``lo .. hi - 1`` (the others take no blocks):
    one sub-sweep of :func:`word_ranges`.

    Returns ``(cum int32[B+1], totals int32[B], total_blocks int)`` or
    ``None`` when the plan cannot be cut in pure int32 on device:

    * any huge word (``>= _HUGE_WORD``),
    * any per-word variant total at/above ``MAX_BLOCK`` (device ranks and
      hit cursors are int32),
    * a cumulative block index that overflows int32.
    """
    entry = _stride_index(plan, stride)
    if entry is None:
        return None
    cum, totals, huge = entry
    if huge.any():
        return None
    if len(totals) and int(totals.max()) >= MAX_BLOCK:
        return None
    if words is not None:
        lo, hi = words
        cum = np.clip(cum - cum[lo], 0, cum[hi] - cum[lo])
    total_blocks = int(cum[-1])
    if total_blocks >= (1 << 31):
        return None
    return cum.astype(np.int32), totals.astype(np.int32), total_blocks


def word_ranges(plan, stride: int) -> "list[Tuple[int, int]]":
    """Consecutive word ranges ``[(lo, hi), ...]`` covering the plan, in
    word order, each holding at most :data:`SPLIT_BLOCKS` blocks at
    ``stride`` — one range unless the bucket's index would pass it; a
    single word past the limit gets a range of its own.  ``[]`` when the
    plan has a huge word or its index overflows int64."""
    limit = SPLIT_BLOCKS
    entry = _stride_index(plan, stride)
    if entry is None or entry[2].any():
        return []
    cum = entry[0]
    out, lo, batch = [], 0, int(plan.batch)
    while lo < batch:
        hi = int(np.searchsorted(cum, cum[lo] + limit, side="right")) - 1
        hi = min(max(hi, lo + 1), batch)
        out.append((lo, hi))
        lo = hi
    return out


def packed_block_index(
    idxs: Sequence[Tuple[np.ndarray, np.ndarray, int]],
) -> "Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None":
    """Concatenate several plans' fixed-stride block indexes (each a
    :func:`superstep_index` result) into ONE packed int32 index for the
    cross-job packed superstep dispatch (``runtime/fuse.py``).

    Job ``j``'s blocks occupy the contiguous global range
    ``[blk_base[j], blk_base[j] + total_j)`` and its plan rows the range
    ``[row_base[j], row_base[j] + B_j)``; the packed cumulative index is
    each job's ``cum`` shifted by its block base, so the device cutter's
    ``searchsorted`` maps a packed block index straight to a packed plan
    row — zero-width rows (fallback/finished words) can never cover a
    block, exactly as in the solo index.

    Returns ``(cum int32[B_total+1], totals int32[B_total],
    blk_base int64[S+1], row_base int64[S+1], seg_end int32[S])`` or
    ``None`` when the packed cumulative index would overflow int32
    (callers then keep per-job dispatch).
    """
    blk_base = np.zeros(len(idxs) + 1, dtype=np.int64)
    row_base = np.zeros(len(idxs) + 1, dtype=np.int64)
    for j, (cum_j, totals_j, total_j) in enumerate(idxs):
        blk_base[j + 1] = blk_base[j] + total_j
        row_base[j + 1] = row_base[j] + totals_j.shape[0]
    if blk_base[-1] >= (1 << 31):
        return None
    cum = np.concatenate(
        [
            np.asarray(cum_j[:-1], dtype=np.int64) + blk_base[j]
            for j, (cum_j, _t, _n) in enumerate(idxs)
        ]
        + [blk_base[-1:]]
    ).astype(np.int32)
    totals = np.concatenate(
        [np.asarray(t, dtype=np.int32) for _c, t, _n in idxs]
    )
    seg_end = blk_base[1:].astype(np.int32)
    return cum, totals, blk_base, row_base, seg_end


def block_cursor(plan, stride: int, cum: np.ndarray, b: int
                 ) -> Tuple[int, int]:
    """Host (word, rank) cursor of global fixed-stride block index ``b``
    (``(plan.batch, 0)`` past the end) — the reference package's
    convention, so superstep boundaries map to the same cursors."""
    if b >= int(cum[-1]):
        return plan.batch, 0
    w = int(np.searchsorted(cum, b, side="right") - 1)
    return w, int(b - cum[w]) * stride


@dataclass(frozen=True)
class BlockBatch:
    """A launch's worth of blocks, cut on the host."""

    word: np.ndarray  # int32 [NB] — row into the plan's word batch
    base_digits: np.ndarray  # int32 [NB, P] — mixed-radix start digits
    count: np.ndarray  # int32 [NB] — variants in this block (< 2^31)
    offset: np.ndarray  # int32 [NB] — first lane of each block

    @property
    def total(self) -> int:
        return int(self.offset[-1] + self.count[-1]) if len(self.count) else 0


def digits_of(rank: int, radices: Sequence[int]) -> List[int]:
    """Mixed-radix digits of ``rank`` (slot 0 least significant), host
    Python ints."""
    out = []
    for r in radices:
        out.append(rank % r)
        rank //= r
    return out


def _make_blocks_stride_fast(
    plan, cum, totals, huge, start_word: int, start_rank: int,
    nb_cap: int, stride: int,
) -> "Tuple[BlockBatch, int, int] | None":
    """Vectorized fixed-stride cutter: one ``searchsorted`` over the
    cumulative block index plus a vectorized mixed-radix decompose.
    Returns None when the window touches a huge word (the scalar path
    cuts those exactly)."""
    p = plan.num_slots
    b0 = int(cum[start_word]) + start_rank // stride
    b1 = min(b0 + nb_cap, int(cum[-1]))
    nb = b1 - b0
    if nb <= 0:
        # 'Sweep complete' or 'no block budget': only the first reports
        # the end cursor.
        done = b0 >= int(cum[-1])
        return (
            BlockBatch(
                word=np.zeros(0, np.int32),
                base_digits=np.zeros((0, p), np.int32),
                count=np.zeros(0, np.int32),
                offset=np.zeros(0, np.int32),
            ),
            plan.batch if done else start_word,
            0 if done else start_rank,
        )
    blocks = np.arange(b0, b1, dtype=np.int64)
    w = (np.searchsorted(cum, blocks, side="right") - 1).astype(np.int64)
    if huge[w].any():
        return None
    rank0 = (blocks - cum[w]) * stride  # int64 [nb]
    count = np.minimum(stride, totals[w] - rank0).astype(np.int32)
    if getattr(plan, "windowed", False):
        bases = np.zeros((nb, p), dtype=np.int32)
        bases[:, 0] = rank0.astype(np.int32)  # int32 by plan eligibility
    else:
        radices = plan.pat_radix[w].astype(np.int64)  # [nb, p]
        bases = np.empty((nb, p), dtype=np.int64)
        t = rank0.copy()
        for s in range(p):
            r = radices[:, s]
            bases[:, s] = t % r
            t //= r
        bases = bases.astype(np.int32)
    if b1 == int(cum[-1]):
        w_next, rank_next = plan.batch, 0
    else:
        w_next = int(np.searchsorted(cum, b1, side="right") - 1)
        rank_next = int(b1 - cum[w_next]) * stride
    batch = BlockBatch(
        word=w.astype(np.int32),
        base_digits=bases,
        count=count,
        offset=np.arange(nb, dtype=np.int32) * np.int32(stride),
    )
    return batch, w_next, rank_next


def make_blocks(
    plan,
    *,
    start_word: int = 0,
    start_rank: int = 0,
    max_variants: int,
    max_block: int = MAX_BLOCK,
    max_blocks: "int | None" = None,
    fixed_stride: "int | None" = None,
) -> Tuple[BlockBatch, int, int]:
    """Cut up to ``max_variants`` of the plan's variant space into blocks,
    starting at ``(start_word, start_rank)``.  Returns ``(batch,
    next_word, next_rank)`` — the resume cursor.  Fallback words are
    skipped (the oracle takes them).  ``max_blocks`` caps the number of
    blocks cut (the budget may go unfilled).

    ``fixed_stride``: every block owns exactly ``stride`` consecutive
    lanes (``offset[b] == b * stride``) and at most ``stride`` variants; a
    word's final partial block leaves its tail lanes masked.
    ``max_variants`` then budgets lane span (``stride`` per block) and
    ``max_block`` is ignored."""
    p = plan.num_slots
    budget = max_variants
    w, rank = start_word, start_rank
    if fixed_stride is not None:
        # The scalar loop's cursor normalization (it advances past
        # finished and fallback words), then the vectorized cutter.
        while w < plan.batch and (
            plan.fallback[w] or rank >= plan.n_variants[w]
        ):
            w, rank = w + 1, 0
        if rank % fixed_stride == 0 and (
            w >= plan.batch or plan.n_variants[w] < _HUGE_WORD
        ):
            # A misaligned rank keeps the scalar path until the next word
            # boundary; so does a huge START word, which occupies one slot
            # in the cumulative index.
            entry = _stride_index(plan, fixed_stride)
            if entry is not None:
                cum, totals, huge = entry
                nb_cap = budget // fixed_stride
                if max_blocks is not None:
                    nb_cap = min(nb_cap, max_blocks)
                fast = _make_blocks_stride_fast(
                    plan, cum, totals, huge, w, rank, nb_cap, fixed_stride
                )
                if fast is not None:
                    return fast
    words: List[int] = []
    bases: List[List[int]] = []
    counts: List[int] = []
    while w < plan.batch and budget > 0:
        if max_blocks is not None and len(words) >= max_blocks:
            break
        if fixed_stride is not None and budget < fixed_stride:
            break
        total = plan.n_variants[w]
        if plan.fallback[w] or rank >= total:
            w, rank = w + 1, 0
            continue
        if fixed_stride is not None:
            take = min(fixed_stride, total - rank)
            spent = fixed_stride
        else:
            take = min(budget, total - rank, max_block)
            spent = take
        words.append(w)
        if getattr(plan, "windowed", False):
            # Windowed plans cursor by scalar rank (int32 by eligibility).
            bases.append([rank] + [0] * (p - 1))
        else:
            radices = [int(plan.pat_radix[w, s]) for s in range(p)]
            bases.append(digits_of(rank, radices))
        counts.append(take)
        budget -= spent
        rank += take
        if rank >= total:
            w, rank = w + 1, 0
    counts_arr = np.asarray(counts, dtype=np.int32)
    if fixed_stride is not None:
        offset = (
            np.arange(len(counts), dtype=np.int32) * np.int32(fixed_stride)
        )
    elif len(counts):
        offset = np.concatenate([[0], np.cumsum(counts_arr[:-1])]).astype(
            np.int32
        )
    else:
        offset = np.zeros((0,), dtype=np.int32)
    batch = BlockBatch(
        word=np.asarray(words, dtype=np.int32),
        base_digits=np.asarray(bases, dtype=np.int32).reshape(len(words), p),
        count=counts_arr,
        offset=offset,
    )
    return batch, w, rank


def pad_batch(batch: BlockBatch, num_blocks: int) -> BlockBatch:
    """Pad a batch to exactly ``num_blocks`` blocks with zero-count blocks
    (their lanes fail the ``rank < count`` test and are masked)."""
    k = len(batch.count)
    if k > num_blocks:
        raise ValueError(f"batch has {k} blocks > num_blocks {num_blocks}")
    if k == num_blocks:
        return batch
    pad = num_blocks - k
    total = batch.total
    return BlockBatch(
        word=np.pad(batch.word, (0, pad)).astype(np.int32),
        base_digits=np.pad(batch.base_digits, ((0, pad), (0, 0))).astype(
            np.int32),
        count=np.pad(batch.count, (0, pad)).astype(np.int32),
        offset=np.concatenate(
            [batch.offset, np.full(pad, total, np.int32)]).astype(np.int32),
    )


def lane_cursor(plan, batch: BlockBatch, lanes: Sequence[int]
                ) -> List[Tuple[int, int]]:
    """Map a launch's lane indices back to ``(word_row, variant rank)``,
    the rank a Python int: the block's base digits encode its first rank
    in the word's mixed-radix space (a windowed block's scalar rank sits
    in slot 0), plus the in-block rank."""
    offsets = batch.offset
    windowed = getattr(plan, "windowed", False)
    out = []
    for lane in lanes:
        blk = int(np.searchsorted(offsets, lane, side="right")) - 1
        rank_in_block = int(lane) - int(offsets[blk])
        w = int(batch.word[blk])
        if windowed:
            base_rank = int(batch.base_digits[blk, 0])
        else:
            base_rank = 0
            scale = 1
            for s in range(plan.num_slots):
                base_rank += int(batch.base_digits[blk, s]) * scale
                scale *= int(plan.pat_radix[w, s])
        out.append((w, base_rank + rank_in_block))
    return out
