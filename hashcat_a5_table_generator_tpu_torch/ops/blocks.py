"""Fixed-stride block index over a plan's variant space.

A *block* is ``(word, base_digits, count)``: a contiguous rank range of one
word's mixed-radix variant space.  The superstep body cuts its blocks on the
device from the int32 cumulative index built here (one ``searchsorted``
plus a mixed-radix decompose), and the host maps superstep boundaries back
to ``(word, rank)`` cursors with :func:`block_cursor` — the same index on
both sides, so they can never disagree.

Any plan can be indexed here as long as it exposes ``batch``,
``n_variants`` (per-word Python ints — these can exceed 2^63) and
``fallback`` (words the device never sees).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: Per-block variant-count cap: in-block ranks must fit int32.
MAX_BLOCK = 1 << 30

#: Most blocks one int32 block index holds: a bucket whose index would
#: pass it runs as several sub-sweeps over word ranges (:func:`word_ranges`),
#: each with its own index, so ``b0 + launch`` arithmetic on the device
#: stays far inside int32.
SPLIT_BLOCKS = 1 << 30

#: Words whose variant total reaches this occupy one index slot and make
#: the index int32-unsafe (no shipped table comes anywhere close; the cap
#: exists for correctness, not tuning).
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


def block_cursor(plan, stride: int, cum: np.ndarray, b: int
                 ) -> Tuple[int, int]:
    """Host (word, rank) cursor of global fixed-stride block index ``b``
    (``(plan.batch, 0)`` past the end) — the reference package's
    convention, so superstep boundaries map to the same cursors."""
    if b >= int(cum[-1]):
        return plan.batch, 0
    w = int(np.searchsorted(cum, b, side="right") - 1)
    return w, int(b - cum[w]) * stride
