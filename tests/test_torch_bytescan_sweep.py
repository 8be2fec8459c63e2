"""Crack sweeps and CLI runs of the PyTorch/CUDA package through the
byte-scan tiers, against the JAX reference on the CPU.

* german's ``ss=ß`` on words with "sss" (no piece schema: TPU kernel row
  7 with its coverage bitmask) in default and reverse mode: equal hit
  streams ``(word_index, rank, candidate)``, emitted counts and overflow
  re-runs against the reference's ``Sweep``; a bucketed run whose short
  bucket takes the byte-scan tier and whose long bucket keeps the piece
  kernel; the CLI byte-identical to the reference CLI (it exited 2 before
  the byte-scan tiers were ported).
* colliding starts ``{s=Z, ss=ß}`` (row 8, radix-2 decode) and, under
  ``A5GEN_EMIT=bytescan``, czech (row 8), qwerty-azerty ``-s`` with
  cascade-closed and oracle-fallback words (row 9, closed) against the
  reference's sweep under the same knob.
* ``A5GEN_EMIT=bytescan`` CLI runs of default, ``-r``, ``-s`` and ``-s -r``
  print the same stdout as the per-slot runs; ``A5GEN_EMIT=bogus`` warns
  once and runs per-slot.
"""

import numpy as np
import pytest

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu.runtime.env as j_env
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.oracle.engines import iter_candidates
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
import hashcat_a5_table_generator_tpu_torch.runtime.env as t_env
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import bytescan as bs
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.ops.packing import bucket_words
from hashcat_a5_table_generator_tpu_torch.runtime.bucketed import (
    BucketedSweep,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)
from hashcat_a5_table_generator_tpu_torch.utils.digests import HOST_DIGEST

GERMAN = get_layout("german").to_substitution_map()
GEOMETRY = dict(lanes=256, num_blocks=16)
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
MODE_ARGV = {"default": [], "reverse": ["-r"], "suball": ["-s"],
             "suball-reverse": ["-s", "-r"]}


def german_words(n=40, seed=61):
    """Seeded lowercase words with ``ss`` in some and ``sss`` in a few
    (German compounds: Schlosssee, Flussstrand, Fitnessstudio)."""
    rng = np.random.default_rng(seed)
    words = [b"schlosssee", b"flussstrand", b"fitnessstudio", b"mutter",
             b"strasse", b"messstation"]
    for i in range(n):
        w = bytearray(rng.integers(ord("a"), ord("z") + 1,
                                   size=int(rng.integers(4, 11)),
                                   dtype=np.uint8))
        if i % 4 == 0:
            at = int(rng.integers(0, len(w)))
            w[at:at] = b"sss" if i % 8 == 0 else b"ss"
        words.append(bytes(w))
    return list(dict.fromkeys(words))


def planted(words, sub, mode, algo, every=2, seed=62):
    """Every ``every``-th word's middle candidate, plus decoys."""
    rng = np.random.default_rng(seed)
    sa, rv = mode.startswith("suball"), mode in ("reverse", "suball-reverse")
    mn = 1 if mode == "default" else 0
    picks = []
    for i, w in enumerate(words):
        if i % every:
            continue
        cands = list(iter_candidates(w, sub, mn, 15, substitute_all=sa,
                                     reverse=rv, bug_compat=False))
        if cands:
            picks.append(cands[len(cands) // 2])
    width = 20 if algo == "sha1" else 16
    return [HOST_DIGEST[algo](c) for c in picks] + [
        rng.integers(0, 256, width, dtype=np.uint8).tobytes()
        for _ in range(20)]


def hit_tuples(res):
    return [(h.word_index, h.variant_rank, h.candidate) for h in res.hits]


def reference(mode, algo, sub, words, digests, **cfg):
    return JSweep(JSpec(mode=mode, algo=algo), sub, words, digests,
                  config=JConfig(**GEOMETRY, **cfg)).run_crack()


@pytest.mark.parametrize("mode,algo", [("default", "md5"),
                                       ("reverse", "ntlm")])
def test_german_sweep_matches_reference(mode, algo):
    words = german_words()
    digests = planted(words, GERMAN, mode, algo)
    want = reference(mode, algo, GERMAN, words, digests)
    plain = bs.PLAIN_CALLS
    sweep = Sweep(AttackSpec(mode=mode, algo=algo), GERMAN, words, digests,
                  config=SweepConfig(device="cpu", **GEOMETRY))
    assert sweep.pieces is None
    assert sweep.bytescan == bs.ByteScanTier("scalar", "scalar",
                                             variant="bitmask")
    got = sweep.run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted
    assert len(got.hits) >= len(digests) // 2 - 20
    assert got.kernels == {"bytescan_scalar": got.superstep["launches"]}
    assert bs.PLAIN_CALLS > plain


def test_german_overflow_replay_matches_reference():
    words = german_words(seed=63)
    digests = planted(words, GERMAN, "default", "md5", every=1)
    want = reference("default", "md5", GERMAN, words, digests)
    got = Sweep(AttackSpec(), GERMAN, words, digests,
                config=SweepConfig(device="cpu", superstep_hit_cap=2,
                                   **GEOMETRY)).run_crack()
    assert got.superstep["replays"] > 0
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted


def test_bucketed_german_takes_both_tiers():
    """The short bucket holds the "sss" words (byte scan); the long
    bucket's lines have none and keep the piece kernel."""
    words = german_words(seed=64) + [b"ab" + b"0" * 20 + b"ss",
                                     b"mutterschiff" + b"9" * 12]
    digests = planted(words, GERMAN, "default", "md5", every=1)
    want = reference("default", "md5", GERMAN, words, digests)
    sweep = BucketedSweep(AttackSpec(), GERMAN, bucket_words(words),
                          digests,
                          config=SweepConfig(device="cpu", **GEOMETRY))
    assert sorted(sweep.sweeps) == [16, 32]
    assert sweep.sweeps[16].bytescan is not None
    assert sweep.sweeps[32].pieces is not None
    got = sweep.run_crack()
    assert hit_tuples(got) == sorted(hit_tuples(want))
    assert got.n_emitted == want.n_emitted
    assert "bytescan_scalar" in got.kernels
    assert any(k.startswith("piece_") for k in got.kernels)
    assert sum(got.kernels.values()) == got.superstep["launches"]


def test_colliding_starts_sweep_matches_reference():
    sub = {b"s": [b"Z"], b"ss": ["ß".encode()], b"a": [b"4"]}
    words = [b"sss", b"ss", b"s", b"sassy", b"mississippi", b"asks",
             b"ssss", b"glass", b"abyss"]
    digests = planted(words, sub, "default", "md5", every=1)
    want = reference("default", "md5", sub, words, digests)
    sweep = Sweep(AttackSpec(), sub, words, digests,
                  config=SweepConfig(device="cpu", **GEOMETRY))
    assert sweep.bytescan == bs.ByteScanTier("match", "radix2")
    got = sweep.run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted


@pytest.mark.parametrize("layout,mode,algo,tier", [
    ("czech", "default", "ntlm", ("match", "digits")),
    ("qwerty-azerty", "suball", "md5", ("suball", "digits")),
    ("qwerty-cyrillic", "suball", "sha1", ("scalar", "scalar")),
])
def test_bytescan_env_sweep_matches_reference(layout, mode, algo, tier,
                                              monkeypatch):
    """Every plan takes the byte-scan tiers under ``A5GEN_EMIT=bytescan``,
    in both packages; qwerty-azerty ``-s`` keeps its word routing
    (closed words on the device, fallback words on the oracle)."""
    from test_torch_suball_sweep import make_words

    monkeypatch.setenv("A5GEN_EMIT", "bytescan")
    sub = get_layout(layout).to_substitution_map()
    words = (german_words(seed=65) if layout == "qwerty-cyrillic"
             else make_words(seed=65, long_line=False))
    digests = planted(words, sub, mode, algo)
    want = reference(mode, algo, sub, words, digests)
    sweep = Sweep(AttackSpec(mode=mode, algo=algo), sub, words, digests,
                  config=SweepConfig(device="cpu", **GEOMETRY))
    assert sweep.pieces is None
    assert (sweep.bytescan.row, sweep.bytescan.decode) == tier
    got = sweep.run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted
    if layout == "qwerty-azerty":
        assert sweep.bytescan.closed
        assert got.routing["device_closed"] > 0
        assert got.routing["oracle_fallback"] > 0


def _cli_files(tmp_path, layout, words, digests):
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text("".join(d.hex() + "\n"
                                               for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    return [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--digests", str(tmp_path / "left.txt"),
            *GEOMETRY_ARGV]


def test_german_cli_matches_reference_cli(tmp_path, capsysbinary):
    """``schlosssee`` in the wordlist: the CLI runs (exit 0) and prints
    the reference CLI's stdout byte for byte."""
    words = german_words(seed=66)
    digests = planted(words, GERMAN, "default", "md5")
    argv = _cli_files(tmp_path, "german", words, digests)
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out
    assert "schloßsee".encode() in got.out or len(got.out.splitlines()) > 5
    summary = [ln for ln in want.err.splitlines()
               if b"candidates hashed" in ln]
    assert summary and summary[0] in got.err
    assert b"kernels: bytescan_scalar" in got.err


_ENV_CASES = {
    "default": ("qwerty-cyrillic", "md5", []),
    "reverse": ("czech", "ntlm", []),
    "suball": ("qwerty-azerty", "md5", ["-m", "0"]),
    "suball-reverse": ("czech", "sha1", []),
}


@pytest.mark.parametrize("mode", sorted(_ENV_CASES))
def test_bytescan_env_cli_matches_perslot_cli(mode, tmp_path, monkeypatch,
                                              capsysbinary):
    from test_torch_suball_sweep import make_words

    layout, algo, extra = _ENV_CASES[mode]
    sub = get_layout(layout).to_substitution_map()
    words = make_words(seed=67 + sorted(_ENV_CASES).index(mode))
    digests = planted(words, sub, mode, algo)
    argv = _cli_files(tmp_path, layout, words, digests) + [
        "--algo", algo, "--device", "cpu", *MODE_ARGV[mode], *extra]
    monkeypatch.delenv("A5GEN_EMIT", raising=False)
    assert t_cli.main(argv) == 0
    perslot = capsysbinary.readouterr()
    monkeypatch.setenv("A5GEN_EMIT", "bytescan")
    launches = dict(fe.LAUNCHES)
    assert t_cli.main(argv) == 0
    got = capsysbinary.readouterr()
    assert got.out == perslot.out
    assert len(got.out.splitlines()) >= len(digests) - 20 - len(words) // 2
    for err in (perslot.err, got.err):
        summary = [ln for ln in err.splitlines()
                   if b"candidates hashed" in ln]
        assert summary
    assert summary[0] in perslot.err
    assert b"kernels: bytescan_" in got.err
    assert b"piece_" not in got.err and b"piece_" in perslot.err
    assert fe.LAUNCHES == launches  # the CPU runs the plain versions


def test_bogus_emit_warns_once_and_runs_perslot(tmp_path, monkeypatch,
                                                capsysbinary):
    words = german_words(seed=68)[:8] + [b"strasse", b"mutter"]
    words = [w for w in words if b"sss" not in w]
    digests = planted(words, GERMAN, "default", "md5")
    argv = _cli_files(tmp_path, "german", words, digests) + [
        "--device", "cpu"]
    monkeypatch.delenv("A5GEN_EMIT", raising=False)
    assert t_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    monkeypatch.setenv("A5GEN_EMIT", "bogus")
    monkeypatch.setattr(t_env, "_WARNED", set())
    monkeypatch.setattr(j_env, "_WARNED", set())
    assert t_cli.main(argv) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out
    assert got.err.count(b"A5GEN_EMIT") == 1
    assert b"kernels: piece_" in got.err
