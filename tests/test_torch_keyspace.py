"""The PyTorch/CUDA package's keyspace arithmetic (its copy of
``oracle/keyspace.py``) against its oracle and the JAX reference's counts,
on the CPU: ``count_candidates`` equals the exact number of emissions in
every mode, across overlapping spans, multi-option keys, min/max windows
and early returns, and the reference's count on the same inputs."""

from math import comb

import pytest

from hashcat_a5_table_generator_tpu.oracle import keyspace as j_keyspace
from hashcat_a5_table_generator_tpu_torch.oracle import (
    count_candidates,
    find_spans,
    iter_candidates,
    unique_patterns,
)
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    ReferencePanic,
)

TABLES = {
    "single": {b"h": [b"H"], b"e": [b"E"], b"l": [b"L"], b"o": [b"O"]},
    "multiopt": {b"a": [b"1", b"2"], b"b": [b"3"], b"c": [b"4", b"5", b"6"]},
    "overlap": {b"s": [b"Z"], b"ss": ["ß".encode()]},
    "lengthy": {b"a": [b"XX"], b"b": [b"YY"]},
    "dup": {b"a": [b"X", b"X"]},
}

WORDS = [b"hello", b"ss", b"sss", b"abc", b"aabbcc", b"a", b"", b"zz", b"abab"]
WINDOWS = [(0, 15), (0, 0), (1, 1), (2, 3), (0, 2), (3, 15), (2, 2)]
MODES = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("table_name", sorted(TABLES))
@pytest.mark.parametrize("lo,hi", WINDOWS)
@pytest.mark.parametrize("substitute_all,reverse", MODES)
def test_count_matches_oracle_and_reference(table_name, lo, hi,
                                            substitute_all, reverse):
    table = TABLES[table_name]
    for word in WORDS:
        kw = dict(substitute_all=substitute_all, reverse=reverse)
        try:
            n = len(list(iter_candidates(word, table, lo, hi, **kw)))
        except ReferencePanic:
            # The panic vector (plain reverse, Q3) is outside the counting
            # contract: emissions before a panic are undefined.
            assert reverse and not substitute_all
            continue
        got = count_candidates(word, table, lo, hi, **kw)
        assert got == n, (word, table_name, lo, hi, substitute_all, reverse)
        assert got == j_keyspace.count_candidates(word, table, lo, hi, **kw)


@pytest.mark.parametrize("table_name", sorted(TABLES))
def test_spans_and_patterns_equal_reference(table_name):
    table = TABLES[table_name]
    for word in WORDS:
        assert find_spans(word, table) == j_keyspace.find_spans(word, table)
        assert unique_patterns(word, table) == \
            j_keyspace.unique_patterns(word, table)


def test_q10_closed_forms():
    t = {b"h": [b"H"], b"e": [b"E"], b"l": [b"L"], b"o": [b"O"]}
    assert count_candidates(b"hello", t, 0, 15) == 31  # 2^5 - 1
    p = {c.encode(): [c.upper().encode()] for c in "paswordr"}
    assert count_candidates(b"password", p, 0, 15) == 255  # 2^8 - 1


def test_substitute_all_product_form():
    t = {b"a": [b"1", b"2"], b"b": [b"3"]}
    # prod(r_i + 1) = 3 * 2 over unique patterns
    assert count_candidates(b"ab", t, 0, 15, substitute_all=True) == 6


def test_huge_word_count_is_fast():
    t = {bytes([c]): [b"X"] for c in range(ord("a"), ord("z") + 1)}
    word = (b"abcdefghij" * 10)[:100]
    # 100 substitutable positions, window [1, 15]: sum_{k=1}^{15} C(100, k)
    expected = sum(comb(100, k) for k in range(1, 16))
    assert count_candidates(word, t, 0, 15) == expected
    assert j_keyspace.count_candidates(word, t, 0, 15) == expected
