"""The crack sweep and CLI of the PyTorch/CUDA package against the JAX
reference on the CPU, for the digit and windowed decode tiers and the
MD4, SHA-1 and NTLM hashes: equal hit streams ``(word_index, rank,
candidate)`` and emitted counts with the pair tier on and off (czech x
NTLM, qwerty-azerty x MD5, greek-hebrew x SHA-1, ``-x 2`` windows, a
three-option table, MD4), and byte-identical CLI stdout for NTLM and
SHA-1."""

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.cli as j_cli
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import (
    AttackSpec,
    decode_variant,
)
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

SUB = get_layout("qwerty-cyrillic").to_substitution_map()
GEOMETRY = dict(lanes=256, num_blocks=16)
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]


def hit_tuples(res):
    return [(h.word_index, h.variant_rank, h.candidate) for h in res.hits]


def _letter_words(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(ord("a"), ord("z") + 1,
                               size=int(rng.integers(lo, hi + 1)),
                               dtype=np.uint8)) for _ in range(n)]


def greek_words(words):
    """Words mapped letter by letter through ``qwerty-greek`` (the
    greek-dictionary stand-in of the greek-hebrew configuration)."""
    qg = get_layout("qwerty-greek").to_substitution_map()
    return [b"".join(qg.get(bytes([c]), [bytes([c])])[0] for c in w)
            for w in words]


CZECH = get_layout("czech").to_substitution_map()
GREEK_HEBREW = get_layout("greek-hebrew").to_substitution_map()
LEET3 = {b"a": [b"4", b"@", b"^"], b"e": [b"3", b"&", b"EE"],
         b"s": [b"$", b"5", b"z"], b"o": [b"0", b"()", b"*"]}

#: name: (table, words, algo, max_substitute, pair, decode, pair K).
#: Word lists pack to width 16 — the CLI's first bucket — so the CLI
#: tests below reuse the reference's compiled programs.
_CZECH_WORDS = _letter_words(30, 1, 8, seed=51) + [b"abcdefghijklmnop"]
_GREEK_WORDS = greek_words(_letter_words(30, 2, 6, seed=53) + [b"abcdefgh"])
TIER_RUNS = {
    "czech-ntlm": (CZECH, _CZECH_WORDS, "ntlm", 15, None, "digits", 0),
    "azerty-md5": (get_layout("qwerty-azerty").to_substitution_map(),
                   _letter_words(30, 1, 8, seed=52) + [b"m,;.:"], "md5", 15,
                   None, "digits", 0),
    "greek-hebrew-sha1-pair-auto": (GREEK_HEBREW, _GREEK_WORDS, "sha1", 15,
                                    None, "scalar", 2),
    "greek-hebrew-sha1-pair-off": (GREEK_HEBREW, _GREEK_WORDS, "sha1", 15,
                                   "off", "scalar", 0),
    "cyrillic-md5-x2": (SUB, _letter_words(30, 5, 12, seed=54), "md5", 2,
                        None, "windowed", 0),
    "czech-ntlm-x2": (CZECH, _letter_words(30, 9, 14, seed=55), "ntlm", 2,
                      None, "windowed", 0),
    "leet3-md5-pair": (LEET3, _letter_words(30, 1, 8, seed=56) + [b"lasso"],
                       "md5", 15, None, "digits", 2),
    "cyrillic-md4": (SUB, _letter_words(30, 1, 8, seed=57), "md4", 15,
                     None, "scalar", 2),
}


def tier_digests(sweep, algo, every=3):
    """Every ``every``-th word's middle variant (decoded by the port) and
    a decoy, as ``algo`` digests."""
    plan, spec = sweep.plan, sweep.spec
    out = []
    for row in range(0, plan.batch, every):
        if plan.n_variants[row] >= 2:
            cand = decode_variant(plan, sweep.ct, spec, row,
                                  plan.n_variants[row] // 2)
            out.append(HOST_DIGEST[algo](cand))
    return out + [bytes(len(out[0]))]


@pytest.mark.parametrize("name", sorted(TIER_RUNS))
def test_tier_hits_and_emitted_match_reference(name):
    sub, words, algo, mx, pair, decode, pair_k = TIER_RUNS[name]
    spec = AttackSpec(algo=algo, max_substitute=mx)
    cfg = SweepConfig(device="cpu", pair=pair, **GEOMETRY)
    probe = Sweep(spec, sub, words, [], cfg)
    assert fe.decode_for(probe.plan)[0] == decode
    digests = tier_digests(probe, algo)
    got = Sweep(spec, sub, words, digests, cfg).run_crack()
    want = JSweep(JSpec(algo=algo, max_substitute=mx), sub, words, digests,
                  config=JConfig(pair=pair, **GEOMETRY)).run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert {HOST_DIGEST[algo](h.candidate) for h in got.hits} == \
        set(digests[:-1])
    assert got.n_emitted == want.n_emitted
    assert got.superstep["pair"] == pair_k


@pytest.mark.parametrize("run,layout", [
    ("czech-ntlm", "czech"), ("greek-hebrew-sha1-pair-auto", "greek-hebrew"),
    ("czech-ntlm-x2", "czech"),
])
def test_cli_stdout_matches_reference_cli_other_hashes(
        run, layout, tmp_path, capsysbinary):
    _sub, words, algo, mx, _pair, decode, _k = TIER_RUNS[run]
    sub = get_layout(layout).to_substitution_map()
    probe = Sweep(AttackSpec(algo=algo, max_substitute=mx), sub, words, [],
                  SweepConfig(device="cpu", **GEOMETRY))
    assert fe.decode_for(probe.plan)[0] == decode
    digests = tier_digests(probe, algo)
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--algo", algo, "--digests",
            str(tmp_path / "left.txt"), "-x", str(mx), *GEOMETRY_ARGV]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert {ln.split(b":")[0] for ln in want.splitlines()} == \
        {d.hex().encode() for d in digests[:-1]}
