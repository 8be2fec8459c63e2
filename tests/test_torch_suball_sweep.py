"""Substitute-all (``-s``, ``-s -r``) crack sweeps of the PyTorch/CUDA
package against the JAX reference, on the CPU: equal hit streams
``(word_index, rank, candidate)`` — oracle-fallback hits (rank = the
oracle's DFS index) interleaved in word order — equal emitted counts and
word routing, exact overflow re-runs, length buckets, and a batch of
fallback words only.  ``test_torch_suball_cli.py`` holds the CLI runs."""

import numpy as np
import pytest

from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.oracle.engines import iter_candidates
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.ops.packing import bucket_words
from hashcat_a5_table_generator_tpu_torch.runtime.bucketed import (
    BucketedSweep,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

GEOMETRY = dict(lanes=256, num_blocks=16)
#: qwerty-azerty lines that close on the device and lines the oracle
#: takes (3+ mutually hazardous patterns overflow the closure caps).
SPECIAL = [b"aqua", b"AQq", b"m;", b"zwzw", b"m,;", b"am,;q", b"mama,;",
           b"q,;mAQq"]


def make_words(n=48, seed=21, long_line=True):
    """Seeded 2-8 letter words with :data:`SPECIAL` spread among them,
    plus (``long_line``) one 20-byte line for the 32-wide bucket."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(ord("a"), ord("z") + 1,
                                size=int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(n)]
    for i, w in enumerate(SPECIAL):
        words.insert(5 * i + 3, w)
    if long_line:
        words.append(b"qazwsx" + b"-" * 14)
    return words


def planted(words, sub, mode, algo, mn=0, mx=15, every=3, seed=22):
    """Every ``every``-th word's middle oracle candidate (fallback words
    always), plus decoys."""
    rng = np.random.default_rng(seed)
    sa, rv = mode.startswith("suball"), mode in ("reverse", "suball-reverse")
    picks = []
    for i, w in enumerate(words):
        if i % every and w not in SPECIAL:
            continue
        # The device path applies reverse offsets correctly (the oracle
        # reproduces the reference binary's offset bug by default).
        cands = list(iter_candidates(w, sub, mn, mx, substitute_all=sa,
                                     reverse=rv, bug_compat=False))
        if cands:
            picks.append(cands[len(cands) // 2])
    width = 20 if algo == "sha1" else 16
    return [HOST_DIGEST[algo](c) for c in picks] + [
        rng.integers(0, 256, width, dtype=np.uint8).tobytes()
        for _ in range(30)]


def hit_tuples(res):
    return [(h.word_index, h.variant_rank, h.candidate) for h in res.hits]


@pytest.mark.parametrize("mode", ["suball", "suball-reverse"])
def test_azerty_hits_emitted_and_routing_match_reference(mode):
    sub = get_layout("qwerty-azerty").to_substitution_map()
    words = make_words()
    digests = planted(words, sub, mode, "md5")
    want = JSweep(JSpec(mode=mode), sub, words, digests,
                  config=JConfig(**GEOMETRY)).run_crack()
    got = Sweep(AttackSpec(mode=mode), sub, words, digests,
                SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted
    assert got.routing == want.routing
    assert got.routing["device_closed"] > 0
    assert (got.routing["oracle_fallback"] > 0) == (mode == "suball")
    fallback_rows = {words.index(w) for w in SPECIAL[4:]}
    if mode == "suball":
        assert {h.word_index for h in got.hits} & fallback_rows


def test_overflow_replay_keeps_fallback_order():
    """A one-slot hit buffer re-runs every hit-bearing superstep; the
    fallback hits still interleave exactly where the reference puts
    them."""
    sub = get_layout("qwerty-azerty").to_substitution_map()
    words = make_words(seed=23)
    digests = planted(words, sub, "suball", "md5", every=2)
    want = JSweep(JSpec(mode="suball"), sub, words, digests,
                  config=JConfig(**GEOMETRY)).run_crack()
    got = Sweep(AttackSpec(mode="suball"), sub, words, digests,
                SweepConfig(device="cpu", superstep_hit_cap=1, superstep=2,
                            **GEOMETRY)).run_crack()
    assert got.superstep["replays"] > 0
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted


def test_bucketed_routing_sums_buckets():
    sub = get_layout("qwerty-azerty").to_substitution_map()
    words = make_words()
    digests = planted(words, sub, "suball", "md5")
    buckets = bucket_words(words)
    assert len(buckets) == 2
    res = BucketedSweep(AttackSpec(mode="suball"), sub, buckets, digests,
                        SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    whole = Sweep(AttackSpec(mode="suball"), sub, words, digests,
                  SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    assert sorted(hit_tuples(res)) == sorted(hit_tuples(whole))
    assert res.n_emitted == whole.n_emitted
    assert res.routing == whole.routing


def test_all_fallback_bucket_runs_on_the_oracle_alone():
    sub = get_layout("qwerty-azerty").to_substitution_map()
    words = [b"m,;", b"am,;q"]
    digests = planted(words, sub, "suball", "md5", every=1)
    launches, plain = dict(fe.LAUNCHES), fe.PLAIN_CALLS
    got = Sweep(AttackSpec(mode="suball"), sub, words, digests,
                SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    assert fe.LAUNCHES == launches and fe.PLAIN_CALLS == plain
    want = JSweep(JSpec(mode="suball"), sub, words, digests,
                  config=JConfig(**GEOMETRY)).run_crack()
    assert hit_tuples(got) == hit_tuples(want) and len(got.hits) >= 2
    assert got.n_emitted == want.n_emitted
    assert got.routing == {"device_clean": 0, "device_closed": 0,
                           "oracle_fallback": 2}
