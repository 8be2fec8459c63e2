"""Substitute-all (``-s``, ``-s -r``) and reverse (``-r``) in the PyTorch/
CUDA package against the JAX reference, on the CPU.

Host: the port's copied oracle equals the reference's on all four modes;
its substitute-all plans (closure tables, ``fallback``, ``closed``), piece
columns, piece schemas, block indexes and kernel gates equal the
reference's on every shipped layout x {suball, suball-reverse, reverse},
and on word sets that close (joint tables up to ``MAX_CLOSE_OPTS`` rows)
or fall back to the oracle.  Kernel: the piece kernel's plain version over
substitute-all schemas — scalar, digit, closed, windowed and pair
selectors — equals the reference's ``fused_expand_suball_md5`` (interpret
mode, tiny cases) and its XLA twin (``expand_suball`` + ``HASH_FNS``) on
every emitted lane with equal emit masks, for MD5, MD4, SHA-1 and NTLM;
and the CUDA source built for the host equals the plain version on every
lane of every substitute-all instantiation.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from test_torch_fused_expand import (
    ALGOS,
    CYR,
    CZECH,
    SUB_LEET3,
    Launch,
    assert_digit_tile_edges,
    assert_same,
    assert_source_equals_plain,
    build_host_harness,
    digit_tile_edges,
)
from test_torch_host import (
    LAYOUTS,
    assert_plans_equal,
    assert_schemas_equal,
    synth_words,
)

import hashcat_a5_table_generator_tpu.models.attack as j_attack
import hashcat_a5_table_generator_tpu.ops.blocks as j_blocks
import hashcat_a5_table_generator_tpu.ops.expand_suball as j_es
import hashcat_a5_table_generator_tpu.ops.packing as j_packing
import hashcat_a5_table_generator_tpu.ops.pallas_expand as j_pe
import hashcat_a5_table_generator_tpu.oracle.engines as j_oracle
import hashcat_a5_table_generator_tpu.tables.compile as j_compile
import hashcat_a5_table_generator_tpu_torch.models.attack as t_attack
import hashcat_a5_table_generator_tpu_torch.ops.blocks as t_blocks
import hashcat_a5_table_generator_tpu_torch.ops.expand_suball as t_es
import hashcat_a5_table_generator_tpu_torch.ops.fused_expand as t_fe
import hashcat_a5_table_generator_tpu_torch.ops.packing as t_packing
import hashcat_a5_table_generator_tpu_torch.oracle.engines as t_oracle
import hashcat_a5_table_generator_tpu_torch.tables.compile as t_compile
from hashcat_a5_table_generator_tpu.ops.hashes import HASH_FNS
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

AZERTY = get_layout("qwerty-azerty").to_substitution_map()
MODES = ("suball", "suball-reverse", "reverse")
#: qwerty-azerty words that close (``AQq``: a 12-row joint table) and
#: words whose 3+ mutually hazardous patterns overflow the closure caps.
CLOSING = [b"m;", b",m", b"AQq", b"aqua", b"zwzw"]
FALLING = [b"m,;", b"am,;q", b"mama,;", b"q,;mAQq", b"AQqa"]


def both(mode, sub, words, **spec_kw):
    """(reference plan, port plan, reference ct, port ct) of one batch."""
    jct, tct = j_compile.compile_table(sub), t_compile.compile_table(sub)
    jspec = j_attack.AttackSpec(mode=mode, **spec_kw)
    tspec = t_attack.AttackSpec(mode=mode, **spec_kw)
    jplan = j_attack.build_plan(jspec, jct, j_packing.pack_words(words))
    tplan = t_attack.build_plan(tspec, tct, t_packing.pack_words(words))
    return jspec, tspec, jplan, tplan, jct, tct


# ---------------------------------------------------------------------------
# The oracle copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["qwerty-azerty", "czech", "leet"])
def test_oracle_copy_equals_reference(layout):
    sub = (SUB_LEET3 if layout == "leet"
           else get_layout(layout).to_substitution_map())
    words = synth_words(sub, n=25, seed=3) + CLOSING + FALLING + [b"", b"ab"]
    for word, sa, rv, (mn, mx) in itertools.product(
            words, (False, True), (False, True), ((0, 15), (1, 2))):
        kw = dict(substitute_all=sa, reverse=rv)
        try:
            want = list(j_oracle.iter_candidates(word, sub, mn, mx, **kw))
        except j_oracle.ReferencePanic:
            with pytest.raises(t_oracle.ReferencePanic):
                list(t_oracle.iter_candidates(word, sub, mn, mx, **kw))
            continue
        assert list(t_oracle.iter_candidates(word, sub, mn, mx, **kw)) \
            == want
    assert t_oracle.unique_patterns_in_word(b"aqua", AZERTY) == \
        j_oracle.unique_patterns_in_word(b"aqua", AZERTY)


def test_oracle_reference_panic_vector():
    with pytest.raises(t_oracle.ReferencePanic):
        list(t_oracle.iter_candidates(b"abab", {b"ab": [b"X"]}, 2, 2,
                                      reverse=True))
    assert list(t_oracle.iter_candidates(
        b"abab", {b"ab": [b"X"]}, 2, 2, reverse=True, bug_compat=False)) \
        == list(j_oracle.iter_candidates(
            b"abab", {b"ab": [b"X"]}, 2, 2, reverse=True, bug_compat=False))


# ---------------------------------------------------------------------------
# Plans, closure tables, piece columns, schemas, gates
# ---------------------------------------------------------------------------


def assert_suball_host_equal(jspec, tspec, jplan, tplan, jct, tct):
    assert_plans_equal(jplan, tplan)
    if tspec.mode.startswith("suball"):
        jc = j_packing._suball_piece_cols(jplan)
        tc = t_packing._suball_piece_cols(tplan)
        for a, b in zip(jc, tc):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    js = j_packing.piece_schema_for(jplan, jct)
    ts = t_packing.piece_schema_for(tplan, tct)
    assert_schemas_equal(js, ts)
    assert t_fe.k_opts_for(tplan) == j_pe.k_opts_for(jplan)
    assert t_fe.k_vals_for(tplan) == j_pe.k_vals_for(jplan)
    assert t_fe.scalar_units_for(tplan) == j_pe.scalar_units_for(jplan)
    jk = j_pe.opts_for_config(jspec, jplan, jct, block_stride=128,
                              num_blocks=8, require_tpu=False)
    assert t_fe.opts_for_config(tspec, tplan, tct) == jk
    scalar = bool(j_pe.scalar_units_for(jplan)) and jk == 1
    want = ("windowed", scalar) if jplan.windowed else (
        "scalar" if scalar else "digits", False)
    if jk is not None:
        assert t_fe.decode_for(tplan) == want
    for stride in (4, 128):
        assert t_fe.pair_for_config(tspec, tplan, ts, block_stride=stride) \
            == j_pe.pair_for_config(jspec, jplan, js, block_stride=stride)
        ji = j_blocks.superstep_index(jplan, stride)
        ti = t_blocks.superstep_index(tplan, stride)
        assert np.array_equal(ji[0], ti[0]) and np.array_equal(ji[1], ti[1])
        for b in (0, ji[2] // 2, ji[2]):
            assert t_blocks.block_cursor(tplan, stride, ti[0], b) == \
                j_blocks.block_cursor(jplan, stride, ji[0], b)
    if js is not None and j_pe.scalar_units_for(jplan):
        fields = j_pe.scalar_units_fields(jplan, jct)
        assert np.array_equal(t_fe.scalar_units_weight(tplan),
                              fields["weight"])
        assert np.array_equal(t_fe.scalar_units_bitpos(tplan),
                              fields["bitpos"])
    # The reference runs its piece kernel exactly where the port does not
    # refuse (an all-fallback batch launches nothing in either).
    took = (js is not None and t_fe.opts_for(tspec, tplan, tct) is not None
            and t_fe.schema_refusal(tplan, ts) is None)
    assert took == (jk is not None and js is not None)
    return ts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plans_schemas_and_gates_equal(layout, mode):
    sub = get_layout(layout).to_substitution_map()
    words = synth_words(sub, seed=70 + LAYOUTS.index(layout))
    for mx in (15, 2):
        for jb, tb in zip(j_packing.bucket_words(words).values(),
                          t_packing.bucket_words(words).values()):
            jct = j_compile.compile_table(sub)
            tct = t_compile.compile_table(sub)
            jspec = j_attack.AttackSpec(mode=mode, max_substitute=mx)
            tspec = t_attack.AttackSpec(mode=mode, max_substitute=mx)
            assert tspec.effective_min == jspec.effective_min == 0
            assert_suball_host_equal(
                jspec, tspec, j_attack.build_plan(jspec, jct, jb),
                t_attack.build_plan(tspec, tct, tb), jct, tct)


@pytest.mark.parametrize("mode", ["suball", "suball-reverse"])
def test_closure_and_fallback_routing_equal(mode):
    words = CLOSING + FALLING + [b"hello", b"qq", b"m"]
    jspec, tspec, jplan, tplan, jct, tct = both(mode, AZERTY, words)
    assert_suball_host_equal(jspec, tspec, jplan, tplan, jct, tct)
    fallback = [w for w, f in zip(words, tplan.fallback) if f]
    closed = [w for w, c in zip(words, tplan.closed) if c]
    if mode == "suball":
        assert fallback == FALLING
        assert b"AQq" in closed and tplan.close_opts == t_es.MAX_CLOSE_OPTS
    else:
        assert not fallback
    assert t_es.MAX_CLOSE_OPTS == j_es.MAX_CLOSE_OPTS == 12
    assert t_es.MAX_CLOSE_SUCC == j_es.MAX_CLOSE_SUCC == 3
    # Fallback words take no blocks: zero-width index entries.
    cum, _totals, _n = t_blocks.superstep_index(tplan, 8)
    for row in np.flatnonzero(tplan.fallback):
        assert cum[row + 1] == cum[row]


def test_overlapping_keys_fall_back():
    sub = {b"ab": [b"X"], b"bc": [b"Y"], b"d": [b"D"]}
    words = [b"abc", b"abd", b"bcd", b"xyz"]
    jspec, tspec, jplan, tplan, jct, tct = both("suball", sub, words)
    assert list(tplan.fallback) == [True, False, False, False]
    assert_suball_host_equal(jspec, tspec, jplan, tplan, jct, tct)


def test_all_fallback_batch_has_no_schema():
    jspec, tspec, jplan, tplan, jct, tct = both("suball", AZERTY, FALLING)
    assert tplan.fallback.all()
    assert t_packing.piece_schema_for(tplan, tct) is None
    assert j_packing.piece_schema_for(jplan, jct) is None


@pytest.mark.parametrize("occurrences", [31, 32])
def test_schema_refusal_is_kind_aware(occurrences):
    """Substitute-all columns are pattern occurrences, not chosen bits: a
    64-byte word of up to 31 occurrences (several per slot, merged into
    two-column groups that read the same bit) takes the scalar tier in
    both packages; at 32 occurrences (65 segments) both gates send the
    plan to the XLA route."""
    sub = {b"a": [b"4"], b"b": [b"8"], b"c": [b"("]}
    word = (b"abca" * 16)[:occurrences] + b"x" * (64 - occurrences)
    words = [word, b"cab", b"xxabx" * 6]
    jspec, tspec, jplan, tplan, jct, tct = both("suball", sub, words)
    ts = assert_suball_host_equal(jspec, tspec, jplan, tplan, jct, tct)
    if occurrences == 31:
        assert t_fe.opts_for(tspec, tplan, tct) is not None
        assert t_fe.schema_refusal(tplan, ts) is None
        assert t_fe.decode_for(tplan) == ("scalar", False)
        merged = [g for g in ts.groups if len(g.sel_cols) > 1]
        assert merged and max(max(g.sel_cols) for g in ts.groups
                              if g.sel_cols) == 30
        assert any(len({int(ts.sel_bit[0, c]) for c in g.sel_cols}) == 1
                   for g in merged)
    else:
        assert t_fe.opts_for(tspec, tplan, tct) is None


# ---------------------------------------------------------------------------
# The kernel's plain version against the reference
# ---------------------------------------------------------------------------


def _keyed_words(n, lo, hi, seed, keys, filler, letters):
    """Words of ``lo``..``hi`` bytes of ``filler`` with ``letters`` bytes
    of ``keys`` at random positions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        w = np.frombuffer(filler, np.uint8)[
            rng.integers(0, len(filler), size=ln)].copy()
        pos = rng.choice(ln, size=min(letters, ln), replace=False)
        w[pos] = np.frombuffer(keys, np.uint8)[
            rng.integers(0, len(keys), size=len(pos))]
        out.append(bytes(w))
    return out


CYR_FILL, CZ_FILL = b"0123456789", b"bfghjklmpqvwx"
AZ_KEYS, AZ_FILL = b"aqzwAQmaq", b"bcdefghijklnoprstuvxy"
SINGLE = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}
#: Pair-tier words: each word's lowest-sorted pattern occurs once and
#: first (slot 0 drives column 0 and nothing else); later patterns may
#: repeat.
PAIR_WORDS = [b"ase", b"oz", b"abodes", b"apses", b"x", b"eosso", b"also"]
#: Substitute-all tiers: (table, words, max_substitute, pair, decode,
#: pack_cb, closed).
TIERS = {
    "k1": (CYR, _keyed_words(10, 4, 12, 1, b"qwertyasdf", CYR_FILL, 5),
           15, False, "scalar", False, False),
    "digits": (CZECH, _keyed_words(10, 3, 10, 2, b"aeiouy", CZ_FILL, 4),
               15, False, "digits", False, False),
    "closed": (AZERTY, CLOSING + _keyed_words(8, 3, 8, 3, AZ_KEYS, AZ_FILL,
                                              3), 15, False, "digits",
               False, True),
    "windowed-cb": (CYR, _keyed_words(10, 12, 16, 4, b"qwertyuiopasdf",
                                      CYR_FILL, 12), 2, False, "windowed",
                    True, False),
    "windowed-digits": (CZECH, _keyed_words(10, 12, 16, 5, b"acdeinorstuyz",
                                            CZ_FILL, 11), 2, False,
                        "windowed", False, False),
    "closed-windowed": (AZERTY, [b"aq134567" + w for w in _keyed_words(
        8, 2, 5, 6, AZ_KEYS, AZ_FILL, 2)], 2, False, "windowed", False,
        True),
    "pair": (SINGLE, PAIR_WORDS, 15, True, "scalar", False, False),
    "pair-digits": (SUB_LEET3, PAIR_WORDS, 15, True, "digits", False,
                    False),
}


def tier_launch(tier, algo, mode="suball", **kw):
    sub, words, mx, pair, decode, pack_cb, closed = TIERS[tier]
    launch = Launch(sub, words, pair=pair, algo=algo, mx=mx, mode=mode,
                    **kw)
    assert launch.pieces.kind == "suball"
    assert (launch.decode, launch.pack_cb) == (decode, pack_cb)
    assert bool(launch.pieces.closed) == closed
    if pair:
        assert launch.pieces.pair_ok
    return launch


_EXPANDED = {}


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_plain_matches_reference_xla_twin(tier, algo):
    launch = tier_launch(tier, algo, stride=32, nb=8)
    if tier not in _EXPANDED:
        _EXPANDED[tier] = launch.reference_expand()
    cand, clen, emit = _EXPANDED[tier]
    want = np.asarray(HASH_FNS[algo](cand, clen)).view(np.int32)
    assert_same(launch.port(), (want, np.asarray(emit)))


@pytest.mark.parametrize("tier,algo", [("closed", "md5"), ("k1", "sha1"),
                                       ("pair-digits", "ntlm"),
                                       ("windowed-cb", "md4")])
def test_plain_matches_reference_kernel(tier, algo):
    """The reference's ``fused_expand_suball_md5`` itself (interpret
    mode), tiny shapes."""
    launch = tier_launch(tier, algo, stride=16, nb=8)
    assert_same(launch.port(), launch.reference_pallas())


@pytest.mark.parametrize("mode", ["suball", "suball-reverse", "reverse"])
def test_emitted_states_are_host_digests_of_the_candidates(mode):
    """Emitted states re-hash on the host: ``decode_variant`` (joint
    closure index included) splices what the kernel hashed."""
    from hashcat_a5_table_generator_tpu_torch.utils.digests import (
        HOST_DIGEST,
    )

    launch = Launch(AZERTY if mode != "reverse" else CYR,
                    TIERS["closed"][1], pair=False, mode=mode, stride=16,
                    nb=16, algo="sha1")
    state, emit = launch.port()
    assert emit.sum() > 10
    tplan = t_attack.build_plan(
        t_attack.AttackSpec(mode=mode), t_compile.compile_table(
            AZERTY if mode != "reverse" else CYR),
        t_packing.pack_words(TIERS["closed"][1]))
    for row in np.flatnonzero(emit):
        blk = row // launch.stride
        w = int(launch.batch.word[blk])
        rank, scale = 0, 1
        for s, r in enumerate(launch.plan.pat_radix[w]):
            rank += int(launch.batch.base_digits[blk, s]) * scale
            scale *= int(r)
        cand = t_attack.decode_variant(tplan, launch.ct, launch.spec, w,
                                       rank + int(row % launch.stride))
        assert cand == j_attack.decode_variant(
            launch.plan, launch.ct, launch.spec, w,
            rank + int(row % launch.stride))
        assert state[row].view(np.uint32).astype(">u4").tobytes() == \
            HOST_DIGEST["sha1"](cand)


def test_wrapper_refuses_missing_selector_tables():
    launch = tier_launch("closed", "md5", stride=8)
    word, count, base, tables = launch.inputs()
    kw = launch.kwargs()
    for name in ("sel_slot", "close_next", "close_mul"):
        with pytest.raises(ValueError, match=name):
            t_fe.fused_expand_md5(word, count, base, {
                k: v for k, v in tables.items() if k != name}, **kw)
    with pytest.raises(ValueError, match="closed"):
        t_fe.fused_expand_md5(word, count, base.sum(1).contiguous(), tables,
                              **dict(kw, decode="scalar"))
    assert t_fe.launch_key("md5", launch.pieces, "digits", False) == \
        "piece_suball_closed/md5"
    assert t_fe.launch_key("ntlm", launch.pieces, "windowed", False) == \
        "piece_suball_closed_windowed/ntlm"
    k1 = tier_launch("k1", "md5", stride=8)
    assert t_fe.launch_key("sha1", k1.pieces, "scalar", True) == \
        "piece_suball_pair/sha1"


# ---------------------------------------------------------------------------
# The CUDA source, compiled for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_harness(tmp_path_factory):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_host_harness(tmp_path_factory.mktemp("harness"))


#: Word lengths per (hash scale, hash blocks), as in the match tiers.
_SOURCE_LENGTHS = {(1, 1): (20, 36), (1, 2): (48, 60), (1, 3): (112, 120),
                   (2, 1): (12, 12), (2, 2): (24, 32), (2, 3): (50, 60)}
#: (table, keys, filler, letters, max_substitute) per substitute-all tier.
_SOURCE_TIERS = {
    "k1": (CYR, b"qwertyasdf", CYR_FILL, 5, 15),
    "digits": (CZECH, b"aeiouy", CZ_FILL, 4, 15),
    "closed": (AZERTY, b"aqAQq", AZ_FILL, 4, 15),
    "windowed-cb": (CYR, b"qwertyuiopasdf", CYR_FILL, 12, 2),
    "windowed-digits": (CZECH, b"acdeinorstuyz", CZ_FILL, 12, 2),
    "closed-windowed": (AZERTY, b"aq134567", AZ_FILL, 12, 2),
}


def _source_launch(tier, algo, blocks):
    scale = 2 if algo == "ntlm" else 1
    lo, hi = _SOURCE_LENGTHS[(scale, blocks)]
    if tier in ("pair", "pair-digits"):
        return tier_launch(tier, algo, stride=8, nb=24)
    sub, keys, filler, letters, mx = _SOURCE_TIERS[tier]
    words = _keyed_words(6, max(lo, letters), hi, blocks, keys, filler,
                         letters)
    if tier.startswith("closed"):
        words = [b"aq" + w[2:] for w in words]  # a hazard in every word
    return Launch(sub, words, pair=False, stride=8, nb=24, algo=algo,
                  mx=mx, mode="suball")


_SOURCE_CASES = [
    (tier, algo, hb) for algo in ALGOS for tier in sorted(_SOURCE_TIERS)
    for hb in (1, 2, 3)
] + [(tier, algo, 1) for algo in ALGOS for tier in ("pair", "pair-digits")]


@pytest.mark.parametrize("tier,algo,blocks", _SOURCE_CASES,
                         ids=[f"{t}-{a}-{b}" for t, a, b in _SOURCE_CASES])
def test_cuda_source_suball_instantiations_equal_plain_version(
        tier, algo, blocks, host_harness, tmp_path):
    """Every substitute-all (decode, closure, hash-block) instantiation
    of the source, built for the host, against the plain version on every
    lane (the windowed tier's state on every live lane)."""
    launch = _source_launch(tier, algo, blocks)
    assert launch.hash_blocks == blocks
    assert launch.pieces.kind == "suball"
    assert bool(launch.pieces.closed) == tier.startswith("closed")
    want = {"k1": "scalar", "digits": "digits", "closed": "digits",
            "pair": "scalar", "pair-digits": "digits"}.get(tier, "windowed")
    assert launch.decode == want
    assert launch.pack_cb == (tier == "windowed-cb")
    assert_source_equals_plain(host_harness, launch, tmp_path)


AZQ = get_layout("azerty-qwerty").to_substitution_map()
#: The substitute-all digit decodes at K=1 on the tile tier: czech (open),
#: qwerty-azerty and azerty-qwerty (cascade-closed: joint tables of up
#: to 12 and 6 rows).
_DIGIT_TIERS = {"digits": _SOURCE_TIERS["digits"],
                "closed": _SOURCE_TIERS["closed"],
                "closed-azq": (AZQ, b"aqAQq", AZ_FILL, 4, 15)}
_DIGIT_CASES = [(tier, algo, geom) for tier in _DIGIT_TIERS
                for algo in ALGOS
                for geom in ("counts", "ctas", "dead", "chunks", "odd",
                             "window", "hb2", "hb3")]


def _digit_launch(tier, algo, blocks, edits, mn, mx, stride):
    sub, keys, filler, letters, mx0 = _DIGIT_TIERS[tier]
    scale = 2 if algo == "ntlm" else 1
    lo, hi = _SOURCE_LENGTHS[(scale, blocks)]
    words = _keyed_words(12, max(lo, letters), hi, blocks, keys, filler,
                         letters)
    if tier.startswith("closed"):
        words = [b"aq" + w[2:] for w in words]  # a hazard in every word
    return Launch(sub, words, pair=False, stride=stride, nb=24, algo=algo,
                  mn=mn, mx=mx or mx0, mode="suball", count_edits=edits)


@pytest.mark.parametrize("tier,algo,geom", _DIGIT_CASES,
                         ids=[f"{t}-{a}-{g}" for t, a, g in _DIGIT_CASES])
def test_cuda_source_suball_digit_tile_ctas_equal_plain_version(
        tier, algo, geom, host_harness, tmp_path):
    """The substitute-all digit decode at K=1, open and cascade-closed,
    on the tile tier: live lanes only, the closure's successor rows staged
    per word, at the CTA edge geometries (counts 0, 1 and the stride,
    CTAs spanning words, a dead CTA, chunks, an odd stride, -m 2 -x 9)
    and 2-3 hash blocks."""
    launch, geometry = digit_tile_edges(
        lambda hb, edits, mn, mx, stride: _digit_launch(
            tier, algo, hb, edits, mn, mx, stride), geom)
    assert launch.pieces.kind == "suball"
    assert bool(launch.pieces.closed) == tier.startswith("closed")
    # The closed plans' joint value tables: 8 and 6 rows wide here.
    assert launch.k_opts == {"closed": 8, "closed-azq": 6}.get(tier,
                                                              launch.k_opts)
    assert_digit_tile_edges(host_harness, launch, geom, geometry, tmp_path)


def test_selector_tables_follow_the_schema():
    launch = tier_launch("closed", "md5", stride=8)
    host = t_fe.selector_tables(launch.plan, launch.pieces)
    assert set(host) == {"sel_bit", "sel_slot", "bitpos", "close_next",
                         "close_mul"}
    assert all(a.dtype == np.int32 for a in host.values())
    assert host["sel_bit"].shape == host["sel_slot"].shape == (
        launch.plan.batch, launch.pieces.n_cols)
    assert host["close_mul"].shape[2] == host["close_next"].shape[2] + 1
    match = Launch(CYR, [b"abc"], pair=False)
    assert t_fe.selector_tables(match.plan, match.pieces) == {}
    arrays = t_attack.device_arrays(
        launch.plan, launch.pieces, t_attack_digests(), (
            np.zeros(launch.plan.batch + 1, np.int32),
            np.zeros(launch.plan.batch, np.int32), 0), device="cpu")
    for name, arr in host.items():
        assert torch.equal(arrays[name], torch.from_numpy(arr))


def t_attack_digests():
    from hashcat_a5_table_generator_tpu_torch.ops.membership import (
        build_digest_set,
    )

    return build_digest_set([bytes(16)], "md5")


def test_dataclass_fields_match_reference():
    """The port's plan type carries the reference's fields, in order."""
    assert [f.name for f in dataclasses.fields(t_es.SubAllPlan)] == [
        f.name for f in dataclasses.fields(j_es.SubAllPlan)]


def test_fallback_words_do_not_widen_windows_or_veto_packed16():
    """An oracle-routed word's blanked columns (its whole word becomes
    tail literals) neither stretch the placement windows nor keep
    narrow groups out of the u16 table — computed over launched words
    only, as in the reference — and the plain version still equals the
    reference's XLA twin on the launched words."""
    sub = {b"a": [b"c"], b"cb": [b"Z"], b"z": [b"qq"]}
    words = [b"za", b"acbacbacbacbacb", b"az"]
    jspec, tspec, jplan, tplan, jct, tct = both("suball", sub, words)
    ts = assert_suball_host_equal(jspec, tspec, jplan, tplan, jct, tct)
    assert tplan.fallback.any()
    launched_len = max(int(n) for n, fb in zip(tplan.lengths,
                                                tplan.fallback) if not fb)
    assert ts.max_out <= 2 * launched_len + 1
    assert ts.gw16 is not None and any(g.packed16 for g in ts.groups)
    launch = Launch(sub, words, pair=False, mode="suball", stride=8)
    cand, clen, emit = launch.reference_expand()
    want = np.asarray(HASH_FNS["md5"](cand, clen)).view(np.int32)
    assert_same(launch.port(), (want, np.asarray(emit)))
