"""Digest-set membership: bitmap prefilter + lexicographic binary search.

The target digest list lives on the device as a **row-sorted** matrix of
state words; candidates' digests are tested in bulk and only hits ever
reach the host.  Two stages, both branch-free and batch-vectorized:

1. **Bitmap prefilter** (hashcat-style): a bit array of ``2^bitmap_bits``
   bits indexed by the digest's low bits rejects most misses.
2. **Lexicographic binary search** over the sorted rows, comparing all K
   state words (no truncation, no false positives), a fixed
   ``ceil(log2 D) + 1`` steps with every candidate in lockstep.

The host half (:func:`build_digest_set`, :class:`HostDigestLookup`) is the
reference package's, array for array.  The device half runs as PyTorch ops
on int32 tensors (the uint32 state words reinterpreted): unsigned order is
restored by flipping the sign bit before each compare, so the search walks
the host's uint32 sort order exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from .hashes import BIG_ENDIAN_DIGEST, DIGEST_WORDS, digest_to_words


def _bulk_rows(digests, algo: str, k: int) -> "np.ndarray | None":
    """Vectorized digest->uint32-row conversion for the common case — a
    uniform list of raw ``bytes`` (or an ``[N, 4k] uint8`` matrix from the
    CLI's vectorized left-list parser).  Hashmob-scale lists (tens of
    millions of digests) make the per-item ``digest_to_words`` loop a
    minutes-long startup cost; one join + frombuffer is ~50x faster.
    Returns None when the input needs the per-item path."""
    order = ">u4" if BIG_ENDIAN_DIGEST[algo] else "<u4"
    if isinstance(digests, np.ndarray):
        if digests.ndim != 2 or digests.dtype != np.uint8 \
                or digests.shape[1] != 4 * k:
            return None
        return (
            np.ascontiguousarray(digests).reshape(-1).view(order)
            .astype(np.uint32).reshape(-1, k)
        )
    if not digests:
        return np.zeros((0, k), dtype=np.uint32)
    width = 4 * k
    if not all(type(d) is bytes and len(d) == width for d in digests):
        return None
    blob = b"".join(digests)
    return (
        np.frombuffer(blob, dtype=order).astype(np.uint32).reshape(-1, k)
    )


#: Default bitmap size: 2^24 bits = 2 MiB — cache-resident on the device and
#: <0.1% false-positive density for digest lists up to ~1e6 entries.
DEFAULT_BITMAP_BITS = 24


@dataclass(frozen=True)
class DigestSet:
    """A target digest list in device-ready, sorted, prefiltered form."""

    rows: np.ndarray  # uint32 [D, K] — row-sorted lexicographically
    bitmap: np.ndarray  # uint32 [2^bits / 32]
    bitmap_bits: int
    algo: str

    @property
    def size(self) -> int:
        return int(self.rows.shape[0])


def auto_bitmap_bits(n: int) -> int:
    """The default prefilter sizing for an ``n``-digest set:
    ``ceil(log2 n) + 10`` bits (≈0.1% false-positive density) clamped to
    [16, DEFAULT_BITMAP_BITS]."""
    import math

    return min(
        DEFAULT_BITMAP_BITS, max(16, math.ceil(math.log2(max(n, 2))) + 10)
    )


def build_digest_set(
    digests: Iterable,
    algo: str,
    *,
    bitmap_bits: int | None = None,
) -> DigestSet:
    """Compile raw/hex digests into a :class:`DigestSet`.

    Accepts raw ``bytes``, hex strings (hashcat left-list lines), or an
    ``[N, digest_bytes] uint8`` matrix (the CLI's vectorized parser).
    Duplicate digests are collapsed — membership is a set question,
    multiplicity lives on the candidate side (Q7).

    ``bitmap_bits=None`` sizes the prefilter to the digest count:
    ``ceil(log2 D) + 10`` bits (≈0.1% false-positive density), clamped to
    [16, DEFAULT_BITMAP_BITS]. Small digest lists — the common crack-mode
    case — then get a bitmap that stays cache-resident (2^16 bits =
    8 KiB, 2^20 = 128 KiB) instead of the fixed 2 MiB table.
    """
    if not isinstance(digests, np.ndarray):
        digests = list(digests)
    if bitmap_bits is None:
        bitmap_bits = auto_bitmap_bits(len(digests))
    if bitmap_bits < 5:
        raise ValueError("bitmap_bits must be >= 5 (one uint32 word)")
    k = DIGEST_WORDS[algo]
    rows = _bulk_rows(digests, algo, k)
    if rows is None:
        # Per-item path: hex strings, mixed representations, odd widths.
        parsed = [digest_to_words(d, algo) for d in digests]
        if not parsed:
            rows = np.zeros((0, k), dtype=np.uint32)
        else:
            rows = np.stack(parsed).astype(np.uint32)
    # np.unique(axis=0) returns rows in lexicographic order, first column
    # most significant — exactly the device search's comparison order.
    if rows.shape[0]:
        rows = np.unique(rows, axis=0)

    bitmap = np.zeros((max(1, (1 << bitmap_bits) // 32),), dtype=np.uint32)
    if rows.shape[0]:
        idx = rows[:, 0] & np.uint32((1 << bitmap_bits) - 1)
        np.bitwise_or.at(bitmap, idx >> 5, np.uint32(1) << (idx & 31))
    return DigestSet(rows=rows, bitmap=bitmap, bitmap_bits=bitmap_bits, algo=algo)


class HostDigestLookup:
    """Host-side digest membership (hit re-verification) over EITHER
    digest form — a list of raw ``bytes`` or an ``[N, W] uint8`` matrix
    (the CLI's vectorized left-list parser).  Matrix form keeps a sorted
    void view (binary search, no Python set of tens of millions of bytes
    objects); list form keeps the plain set.
    """

    def __init__(self, digests):
        if isinstance(digests, np.ndarray) and digests.ndim == 2:
            a = np.ascontiguousarray(digests)
            self._width = int(a.shape[1])
            self._rows = np.sort(a.view(f"V{self._width}")[:, 0])
            self._set = None
            self._sorted_list = None
        else:
            lst = list(digests)
            self._rows = None
            self._set = set(lst)
            self._sorted_list = sorted(lst)
            self._width = len(lst[0]) if lst else 0

    def __len__(self) -> int:
        return (
            int(self._rows.shape[0]) if self._rows is not None
            else len(self._sorted_list)
        )

    def __contains__(self, dig: bytes) -> bool:
        if self._set is not None:
            return dig in self._set
        rows = self._rows
        if not rows.shape[0] or len(dig) != self._width:
            return False
        probe = np.frombuffer(dig, dtype=rows.dtype)[0]
        i = int(np.searchsorted(rows, probe))
        return i < rows.shape[0] and bool(rows[i] == probe)

    def sorted_blob(self) -> bytes:
        """Digests concatenated in ascending byte order — the checkpoint
        fingerprint's stream; the void-row sort equals ``sorted`` of the
        list form, so both forms of one set give the same bytes."""
        if self._rows is not None:
            return self._rows.tobytes()
        return b"".join(self._sorted_list)


def _flip(x: torch.Tensor) -> torch.Tensor:
    """int32 view of uint32 words with unsigned order: sign bit flipped."""
    return x ^ -(1 << 31)


def _row_cmp_le(probe: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``row <= probe`` lexicographically as uint32 words; both
    ``int32[..., K]``."""
    k = probe.shape[-1]
    lt = torch.zeros(probe.shape[:-1], dtype=torch.bool, device=probe.device)
    eq = torch.ones_like(lt)
    for i in range(k):
        p, r = _flip(probe[..., i]), _flip(row[..., i])
        lt = lt | (eq & (r < p))
        eq = eq & (r == p)
    return lt | eq


def bitmap_probe(digest: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """Stage-1 test: ``int32[N, K] -> bool[N]`` (may have false positives).
    The bitmap's bit count is its length × 32, so the index mask is
    derived from the array itself."""
    bitmap_bits = int(np.log2(bitmap.shape[0])) + 5
    idx = digest[:, 0] & ((1 << bitmap_bits) - 1)
    word = bitmap[(idx >> 5).long()]
    return ((word >> (idx & 31)) & 1) != 0


def digest_member(
    digest: torch.Tensor,  # int32 [N, K] (uint32 state words)
    rows: torch.Tensor,  # int32 [D, K] row-sorted as uint32
    bitmap: torch.Tensor,  # int32 [2^bits/32]
) -> torch.Tensor:
    """Exact membership of each candidate digest: ``bool[N]``.

    Every candidate runs the bitmap probe and the fixed-length binary
    search (no host sync, no data-dependent launch count); the verdict
    ANDs both stages."""
    n = digest.shape[0]
    d = rows.shape[0]
    if d == 0:
        return torch.zeros((n,), dtype=torch.bool, device=digest.device)
    pre = bitmap_probe(digest, bitmap)
    steps = int(np.ceil(np.log2(max(d, 2)))) + 1
    # Invariant: rows[lo-1] <= probe < rows[hi] (virtual rows at -1/D);
    # once lo == hi further steps must not move it.
    lo = torch.zeros((n,), dtype=torch.int32, device=digest.device)
    hi = torch.full((n,), d, dtype=torch.int32, device=digest.device)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        # Converged lanes (lo == hi == D) probe a clamped row; the
        # (lo < hi) guard discards the result.
        row = rows[torch.clamp(mid, max=d - 1).long()]
        le = _row_cmp_le(digest, row) & (lo < hi)
        lo, hi = torch.where(le, mid + 1, lo), torch.where(le, hi, mid)
    found = torch.clamp(lo - 1, 0, d - 1)
    exact = (rows[found.long()] == digest).all(dim=-1) & (lo > 0)
    return pre & exact
