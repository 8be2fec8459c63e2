"""CPU oracle: byte-exact reimplementation of the reference's four generation
engines (layer L3, reference ``main.go:168-440``) — a copy of the JAX
package's ``oracle/engines.py``, which tests hold equal to it.

The crack sweep expands substitute-all words its plans cannot splice
exactly (``SubAllPlan.fallback``) through these generators. Candidates are
produced as a stream of ``bytes``; per-word order is the reference's
deterministic DFS order (Q9), so a single-threaded run over a wordlist
reproduces the Go binary at ``--threads 1`` byte-for-byte (modulo Q4,
below).

The verified behavioral contract it implements (SURVEY.md §2.4):

* **Q1** — default mode silently bumps ``min 0 -> 1`` (``main.go:169-171``):
  the original word is never emitted there, but ``-r``, ``-s`` and ``-s -r``
  all DO emit it when ``min == 0``.
* **Q2** — the reverse modes apply only ``subs[0]``, the first-listed option
  per key (``main.go:253``, ``main.go:396``).
* **Q3** — reverse mode applies combos in descending position order while
  accumulating a splice offset as if ascending (``main.go:249-257``); with
  length-changing substitutions this corrupts positions (verified: ``ab`` with
  ``a=XX, b=YY`` at exactly 2 subs emits ``aXXY``). Reproduced by default
  (``bug_compat=True``); ``bug_compat=False`` applies correct offsets.
  Inputs that would make the Go binary panic on an out-of-range splice raise
  :class:`ReferencePanic`.
* **Q4** — the substitute-all modes apply chosen replacements by sequential
  ReplaceAll in *Go map iteration order* (nondeterministic,
  ``main.go:338-341``). We canonicalize to **sorted pattern order** — the only
  deliberate divergence, and only observable when one replacement's output
  contains another chosen pattern.
* **Q5** — matching is byte-oriented; default mode probes longest key first at
  each position (``main.go:177``).
* **Q6** — replacement text is never re-matched (recursion resumes at
  ``i + len(sub)``, ``main.go:197``); original bytes after it still are.
* **Q7** — no dedupe anywhere: duplicate table options and convergent paths
  yield duplicate candidates; multiplicity is part of parity.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, Iterator, List, Mapping, Sequence, Tuple

SubstitutionMap = Mapping[bytes, Sequence[bytes]]


class ReferencePanic(RuntimeError):
    """The Go reference would panic (slice out of range) on this input.

    Only reachable in reverse mode with ``bug_compat=True`` and
    length-shrinking substitutions whose buggy offsets (Q3) push a splice
    start below zero or past the end of the intermediate string.
    """


def _max_key_len(sub_map: SubstitutionMap) -> int:
    return max((len(k) for k in sub_map), default=0)


def process_word(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int,
    max_substitute: int,
) -> Iterator[bytes]:
    """Default engine (reference ``processWord``, ``main.go:168-205``).

    Recursive DFS over byte positions; at each position keys are probed
    longest-first (Q5); after a substitution the scan resumes past the
    replacement text (Q6). ``min == 0`` is bumped to 1, so the unmodified word
    is never emitted (Q1).
    """
    if min_substitute == 0:
        min_substitute = 1
    # Probing every key length from the remaining length down to 1 as the
    # reference does (main.go:177) is O(n) dict probes per position; lengths
    # above the longest key can never match, so clamping to it is
    # semantics-preserving and keeps the oracle usable on long words.
    kmax = _max_key_len(sub_map)

    def generate(current: bytes, count: int, start: int) -> Iterator[bytes]:
        for i in range(start, len(current)):
            for key_length in range(min(len(current) - i, kmax), 0, -1):
                subs = sub_map.get(current[i : i + key_length])
                if subs is None:
                    continue
                for sub in subs:
                    new_word = current[:i] + sub + current[i + key_length :]
                    new_count = count + 1
                    if new_count > max_substitute:
                        continue
                    if new_count >= min_substitute:
                        yield new_word
                    yield from generate(new_word, new_count, i + len(sub))

    yield from generate(word, 0, 0)


def find_match_positions(
    word: bytes, sub_map: SubstitutionMap
) -> List[Tuple[int, int, Sequence[bytes]]]:
    """All ``(start, key_length, subs)`` matches, in the reference's scan order
    (ascending start, then ascending key length — ``main.go:215-225``)."""
    kmax = _max_key_len(sub_map)
    positions: List[Tuple[int, int, Sequence[bytes]]] = []
    for i in range(len(word)):
        for key_length in range(1, min(len(word) - i, kmax) + 1):
            subs = sub_map.get(word[i : i + key_length])
            if subs is not None:
                positions.append((i, key_length, subs))
    return positions


def _combinations_desc(n: int, k: int) -> Iterator[Tuple[int, ...]]:
    """Index combinations in the reference's order (``generateCombinations``,
    ``main.go:263-281``): each combo in descending index order, combos ordered
    by descending leading index (n=3,k=2 -> (2,1),(2,0),(1,0))."""
    # itertools.combinations over reversed(range(n)) yields exactly the
    # reference's recursive enumeration order.
    return combinations(range(n - 1, -1, -1), k)


def _valid_substitution_positions(
    combo: Sequence[int], positions: Sequence[Tuple[int, int, Sequence[bytes]]]
) -> bool:
    """Overlap filter (``validSubstitutionPositions``, ``main.go:283-305``)."""
    intervals = sorted(
        (positions[idx][0], positions[idx][0] + positions[idx][1] - 1)
        for idx in combo
    )
    for prev, cur in zip(intervals, intervals[1:]):
        if cur[0] <= prev[1]:
            return False
    return True


def process_word_reverse(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int,
    max_substitute: int,
    *,
    bug_compat: bool = True,
) -> Iterator[bytes]:
    """Reverse engine (``processWordReverse``, ``main.go:208-261``).

    Enumerates C(n, k) over all match positions from ``min(max, n)`` down to
    ``min`` (emitting the original word for the k=0 combo when ``min == 0`` —
    Q1), filters overlapping combos, and applies only ``subs[0]`` per position
    (Q2). ``bug_compat=True`` reproduces the Q3 offset bug exactly.
    """
    positions = find_match_positions(word, sub_map)
    total = len(positions)
    if total < min_substitute:
        return
    actual_max = min(max_substitute, total)

    for sub_count in range(actual_max, min_substitute - 1, -1):
        for combo in _combinations_desc(total, sub_count):
            if not _valid_substitution_positions(combo, positions):
                continue
            apply_order = combo if bug_compat else sorted(combo)
            result = word
            offset = 0
            for idx in apply_order:
                start, key_length, subs = positions[idx]
                sub = subs[0]
                actual_start = start + offset
                if actual_start < 0 or actual_start + key_length > len(result):
                    raise ReferencePanic(
                        f"slice bounds out of range applying combo {combo} to "
                        f"{word!r} (buggy offset {offset}, main.go:254-255)"
                    )
                result = result[:actual_start] + sub + result[actual_start + key_length :]
                offset += len(sub) - key_length
            yield result


def unique_patterns_in_word(word: bytes, sub_map: SubstitutionMap) -> List[bytes]:
    """Sorted unique table patterns occurring in ``word``
    (``main.go:313-326``). The scan checks every pattern at every byte offset,
    so an empty key (from a ``=x`` table line) matches any non-empty word —
    faithful to the Go code, where it triggers ReplaceAll-with-empty-pattern
    insertion behavior in the substitute-all modes."""
    found = {p for p in sub_map if (p in word if p else bool(word))}
    return sorted(found)


def _replace_all_cascade(
    word: bytes, chosen: Mapping[bytes, bytes]
) -> bytes:
    """Sequential ReplaceAll over the chosen patterns (``main.go:338-341``).

    Canonicalized to sorted-pattern order (Q4 — the reference uses Go's
    randomized map iteration order; sorted order is our documented choice).
    """
    result = word
    for pattern in sorted(chosen):
        result = result.replace(pattern, chosen[pattern])
    return result


def process_word_substitute_all(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int,
    max_substitute: int,
) -> Iterator[bytes]:
    """Substitute-all / transliteration engine (``processWordSubstituteAll``,
    ``main.go:308-365``) — the headline feature.

    For each unique pattern present in the word (sorted), the recursion either
    picks one of its options or skips it; at each leaf, if the number of
    *chosen distinct patterns* is within ``[min, max]``, every occurrence of
    each chosen pattern is replaced (ReplaceAll cascade). The original word is
    emitted for the empty choice when ``min == 0`` (Q1).
    """
    patterns = unique_patterns_in_word(word, sub_map)

    def generate(chosen: Dict[bytes, bytes], pos: int) -> Iterator[bytes]:
        if pos >= len(patterns):
            if min_substitute <= len(chosen) <= max_substitute:
                yield _replace_all_cascade(word, chosen)
            return
        pattern = patterns[pos]
        for sub in sub_map[pattern]:
            yield from generate({**chosen, pattern: sub}, pos + 1)
        yield from generate(chosen, pos + 1)

    yield from generate({}, 0)


def process_word_substitute_all_reverse(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int,
    max_substitute: int,
) -> Iterator[bytes]:
    """Substitute-all reverse engine (``processWordSubstituteAllReverse``,
    ``main.go:369-440``).

    Starts from ALL unique patterns substituted (first option only — Q2) and
    recursively removes patterns in index order, visiting every subset of the
    pattern set exactly once, from the full set down to ``min`` — emitting
    those whose size is within ``[min, max]``.
    """
    patterns = unique_patterns_in_word(word, sub_map)
    if len(patterns) < min_substitute:
        return
    all_subs = {p: sub_map[p][0] for p in patterns if sub_map[p]}

    def generate_subsets(chosen: Dict[bytes, bytes], pos: int) -> Iterator[bytes]:
        count = len(chosen)
        if count < min_substitute:
            return
        if count <= max_substitute:
            yield _replace_all_cascade(word, chosen)
        if count <= min_substitute:
            return
        for i in range(pos, len(patterns)):
            pattern = patterns[i]
            if pattern not in chosen:
                continue
            rest = {k: v for k, v in chosen.items() if k != pattern}
            yield from generate_subsets(rest, i + 1)

    yield from generate_subsets(all_subs, 0)


def iter_candidates(
    word: bytes,
    sub_map: SubstitutionMap,
    min_substitute: int = 0,
    max_substitute: int = 15,
    *,
    substitute_all: bool = False,
    reverse: bool = False,
    bug_compat: bool = True,
) -> Iterator[bytes]:
    """Mode dispatcher, mirroring the reference's ``main``
    (``main.go:80-92``)."""
    if substitute_all:
        if reverse:
            return process_word_substitute_all_reverse(
                word, sub_map, min_substitute, max_substitute
            )
        return process_word_substitute_all(
            word, sub_map, min_substitute, max_substitute
        )
    if reverse:
        return process_word_reverse(
            word, sub_map, min_substitute, max_substitute, bug_compat=bug_compat
        )
    return process_word(word, sub_map, min_substitute, max_substitute)
