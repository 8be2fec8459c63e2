"""Exact keyspace arithmetic for the four generation modes: a copy of the
reference package's ``oracle/keyspace.py``.

The reference enumerates recursively and never counts (its only "planning" is
the ``-r`` mode's early return, ``main.go:227-229``). Here each word's
candidate count comes in closed form, without enumerating: what a run's
candidate count is held to (``chip_smoke.py``'s oracle phase).

Counting model (proved against the oracle in tests/test_torch_keyspace.py):

* default mode (``processWord``, ``main.go:168-205``): each emission
  corresponds to exactly one pair (S, c) where S is a set of pairwise
  non-overlapping match spans of the ORIGINAL word (matches never cross a
  replacement boundary because the scan resumes at ``i+len(sub)`` — Q6),
  |S| in [max(1, min), max] (Q1), and c assigns one option to each span.
  Count = sum over such S of the product of option counts.
* reverse mode (``processWordReverse``): same span family with a single
  option per span (Q2), |S| in [min, min(max, n_matches)], including the
  empty set when min == 0; early-return 0 when n_matches < min.
* substitute-all: choices over the sorted unique patterns present; count =
  sum_{k in [min, min(max, n)]} e_k(r_1..r_n) (elementary symmetric in the
  per-pattern option counts).
* substitute-all reverse: subsets of the pattern set, first option only:
  sum_{k in [min, min(max, n)]} C(n, k); 0 when n < min.
"""

from __future__ import annotations

from math import comb
from typing import List, Mapping, Sequence, Tuple

from .engines import find_match_positions, unique_patterns_in_word

SubstitutionMap = Mapping[bytes, Sequence[bytes]]

Span = Tuple[int, int, int]  # (start, key_length, n_options)


def find_spans(word: bytes, sub_map: SubstitutionMap) -> List[Span]:
    """All match spans of ``word`` with their option counts, in scan order."""
    return [(s, k, len(subs)) for s, k, subs in find_match_positions(word, sub_map)]


def unique_patterns(word: bytes, sub_map: SubstitutionMap) -> List[bytes]:
    """Sorted unique patterns present in ``word`` (substitute-all site list)."""
    return unique_patterns_in_word(word, sub_map)


def _span_subset_poly(
    spans: Sequence[Span], length: int, max_degree: int, *, weighted: bool
) -> List[int]:
    """Coefficients p[k] = number of non-overlapping span subsets of size k
    (weighted by the product of option counts when ``weighted``), truncated at
    ``max_degree``. DP over byte positions, O(length * n_spans_per_pos)."""
    starts: dict[int, List[Span]] = {}
    for sp in spans:
        starts.setdefault(sp[0], []).append(sp)

    # f[j] = poly for the suffix word[j:]; computed right-to-left.
    f = [0] * (max_degree + 1)
    f[0] = 1
    suffix = {length: f}
    for j in range(length - 1, -1, -1):
        poly = list(suffix[j + 1])
        for start, key_length, n_opts in starts.get(j, ()):
            tail = suffix[j + key_length]
            w = n_opts if weighted else 1
            for k in range(max_degree):
                if tail[k]:
                    poly[k + 1] += w * tail[k]
        suffix[j] = poly
    return suffix[0]


def count_default(
    word: bytes, sub_map: SubstitutionMap, min_substitute: int, max_substitute: int
) -> int:
    """Emissions of the default engine (Q1: min 0 is bumped to 1)."""
    lo = max(1, min_substitute)
    if lo > max_substitute:
        return 0
    # Non-overlapping span subsets never exceed len(word) members, so the DP
    # degree is clamped there regardless of how large -x is.
    hi = min(max_substitute, len(word))
    if lo > hi:
        return 0
    poly = _span_subset_poly(find_spans(word, sub_map), len(word), hi, weighted=True)
    return sum(poly[lo : hi + 1])


def count_reverse(
    word: bytes, sub_map: SubstitutionMap, min_substitute: int, max_substitute: int
) -> int:
    """Emissions of the reverse engine (first option only, empty set at min 0)."""
    spans = find_spans(word, sub_map)
    if len(spans) < min_substitute:
        return 0
    hi = min(max_substitute, len(spans))
    if min_substitute > hi:
        return 0
    poly = _span_subset_poly(spans, len(word), hi, weighted=False)
    return sum(poly[min_substitute : hi + 1])


def _truncated_elementary_symmetric(radii: Sequence[int], max_degree: int) -> List[int]:
    """Coefficients of prod_i (1 + r_i x), truncated at ``max_degree``."""
    poly = [0] * (max_degree + 1)
    poly[0] = 1
    for r in radii:
        for k in range(min(max_degree, len(radii)), 0, -1):
            poly[k] += r * poly[k - 1]
    return poly


def count_substitute_all(
    word: bytes, sub_map: SubstitutionMap, min_substitute: int, max_substitute: int
) -> int:
    """Emissions of the substitute-all engine: choice vectors over unique
    patterns with the number of chosen patterns in [min, max] (Q10)."""
    radii = [len(sub_map[p]) for p in unique_patterns_in_word(word, sub_map)]
    hi = min(max_substitute, len(radii))
    if min_substitute > hi:
        return 0
    poly = _truncated_elementary_symmetric(radii, hi)
    return sum(poly[min_substitute : hi + 1])


def count_substitute_all_reverse(
    word: bytes, sub_map: SubstitutionMap, min_substitute: int, max_substitute: int
) -> int:
    """Emissions of the substitute-all reverse engine: one per subset of the
    pattern set with size in [min, min(max, n)]; 0 when n < min."""
    n = len(unique_patterns_in_word(word, sub_map))
    if n < min_substitute:
        return 0
    return sum(comb(n, k) for k in range(min_substitute, min(max_substitute, n) + 1))


def count_candidates(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int = 0,
    max_substitute: int = 15,
    *,
    substitute_all: bool = False,
    reverse: bool = False,
) -> int:
    """Exact number of candidates the reference emits for ``word`` in a mode."""
    if substitute_all:
        fn = count_substitute_all_reverse if reverse else count_substitute_all
    else:
        fn = count_reverse if reverse else count_default
    return fn(word, sub_map, min_substitute, max_substitute)
