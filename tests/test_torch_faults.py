"""Faults of the PyTorch/CUDA package against the JAX reference, on the
CPU.

* An int32-unsafe bucket (a block index past 2^31 blocks, though no word
  has 2^30 rows) runs as sub-sweeps over word ranges, each with an
  int32-safe index: the sweep accepts it up front, and with the split
  limit lowered the CLI's stdout — crack and candidates mode, default
  and substitute-all with oracle-fallback words — is byte-identical to
  the reference CLI's.  (A single word of 2^30 rows or more runs the
  per-launch pipeline: ``test_torch_perlaunch.py``.)
* The reference's opt-out knobs: ``A5GEN_PAIR=off`` pins K=1 with the
  same stdout, and ``A5GEN_CASCADE_CLOSE=off`` sends hazard words to the
  oracle with the reference's routing and stdout.  (``A5GEN_SUPERSTEP`` /
  ``A5GEN_PIPELINE``: ``test_torch_perlaunch.py``.)
"""

import hashlib

import numpy as np
import pytest
from test_torch_suball_sweep import make_words, planted

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import blocks
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)

GEOMETRY = dict(lanes=256, num_blocks=16)
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
CYR = get_layout("qwerty-cyrillic").to_substitution_map()
AZERTY = get_layout("qwerty-azerty").to_substitution_map()


def letter_lines(n, length, seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(ord("a"), ord("z") + 1, size=length,
                               dtype=np.uint8)) for _ in range(n)]


def write_inputs(tmp_path, words, digests, layout):
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text("".join(d.hex() + "\n"
                                               for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    return [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device"]


def test_word_ranges_cover_the_plan_in_order_under_the_limit(monkeypatch):
    """Ranges are consecutive, cover every word once, and each holds at
    most the limit's blocks (a word past it alone)."""
    plan = Sweep(AttackSpec(), CYR, make_words(seed=3, long_line=False),
                 config=SweepConfig(device="cpu", **GEOMETRY)).plan
    for stride, limit in ((16, 5), (16, 1), (32, 7), (16, 1 << 30)):
        monkeypatch.setattr(blocks, "SPLIT_BLOCKS", limit)
        ranges = blocks.word_ranges(plan, stride)
        assert ranges[0][0] == 0 and ranges[-1][1] == plan.batch
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        whole = blocks.superstep_index(plan, stride)
        total = 0
        for lo, hi in ranges:
            cum, _totals, n = blocks.superstep_index(plan, stride, (lo, hi))
            width = np.diff(whole[0])[lo:hi]
            assert n == int(width.sum()) and (n <= limit or hi == lo + 1)
            assert (np.diff(cum)[:lo] == 0).all()
            assert (np.diff(cum)[hi:] == 0).all()
            total += n
        assert total == whole[2]
        assert (len(ranges) > 1) == (limit < whole[2])


def test_int32_unsafe_bucket_is_accepted_with_int32_safe_sub_ranges():
    """Fault F1's bucket: 3 short words and 2000 random 29-letter lines
    under qwerty-cyrillic, default mode — 2^29 rows each, 8.4e9 blocks at
    stride 128.  No word has 2^30 rows, so nothing is refused;
    at the solo and the pair stride each sub-range's block index is
    int32-safe, and the ranges cover the bucket in word order."""
    words = [b"password", b"sesame", b"zebra"] + letter_lines(2000, 29, 7)
    sweep = Sweep(AttackSpec(), CYR, words, [bytes(16)],
                  SweepConfig(device="cpu"))
    assert sweep.route == "xla"  # 29 slots: past the fused kernels' 24
    for stride in (128, 256):
        ranges = sweep.word_ranges(stride)
        assert len(ranges) > 1
        assert ranges[0][0] == 0 and ranges[-1][1] == sweep.n_words
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert blocks.superstep_index(sweep.plan, stride) is None
        for r in ranges:
            idx = blocks.superstep_index(sweep.plan, stride, r)
            assert idx is not None and idx[2] <= blocks.SPLIT_BLOCKS


SPLIT_CASES = {
    "default-crack": ("qwerty-cyrillic", [], True),
    "default-candidates": ("qwerty-cyrillic", [], False),
    "suball-crack": ("qwerty-azerty", ["-s"], True),
    "suball-candidates": ("qwerty-azerty", ["-s"], False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_sub_sweeps_match_reference_cli(case, tmp_path, capsysbinary,
                                              monkeypatch):
    """With the split limit lowered to 3 blocks every bucket runs as many
    sub-sweeps; crack hits (with oracle-fallback words interleaved under
    ``-s``) and the candidate stream stay byte-identical to the
    reference CLI's."""
    layout, mode, crack = SPLIT_CASES[case]
    sub = get_layout(layout).to_substitution_map()
    words = make_words(seed=41, long_line=crack)
    spec_mode = "suball" if mode else "default"
    digests = planted(words, sub, spec_mode, "md5", mn=0 if mode else 1)
    argv = write_inputs(tmp_path, words, digests, layout) + \
        GEOMETRY_ARGV + mode
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    monkeypatch.setattr(blocks, "SPLIT_BLOCKS", 3)
    sweep = Sweep(AttackSpec(mode=spec_mode), sub, words,
                  config=SweepConfig(device="cpu", **GEOMETRY))
    assert len(sweep.word_ranges(16)) > 3
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out and got.out
    if mode:
        assert b"oracle-fallback" in got.err
        routing = [ln for ln in want.err.splitlines()
                   if b"word routing" in ln]
        assert routing and routing == [ln for ln in got.err.splitlines()
                                       if b"word routing" in ln]


def test_pair_off_knob_pins_k1_with_the_same_stdout(tmp_path, capsysbinary,
                                                    monkeypatch):
    """``A5GEN_PAIR=off`` runs no pair tier (a pair-eligible 1:1 table),
    and prints what the default (pair auto) run prints."""
    sub = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}
    words = make_words(seed=43, long_line=False)
    digests = [hashlib.md5(c).digest() for c in (b"p@@ssword", b"s33s@@m33")]
    cfg = SweepConfig(device="cpu", **GEOMETRY)
    auto = Sweep(AttackSpec(), sub, words + [b"password", b"sesame"],
                 digests, cfg).run_crack()
    assert auto.superstep["pair"] == 2 and "piece_pair" in auto.kernels
    monkeypatch.setenv("A5GEN_PAIR", "off")
    off = Sweep(AttackSpec(), sub, words + [b"password", b"sesame"],
                digests, cfg).run_crack()
    assert off.superstep["pair"] == 0
    assert not any("pair" in k for k in off.kernels)
    assert [(h.word_index, h.candidate) for h in off.hits] == \
        [(h.word_index, h.candidate) for h in auto.hits]
    argv = write_inputs(tmp_path, words + [b"password", b"sesame"], digests,
                        "qwerty-cyrillic") + [
        "--digests", str(tmp_path / "left.txt"), "--device", "cpu",
        *GEOMETRY_ARGV]
    (tmp_path / "t.table").write_bytes(b"".join(
        k + b"=" + v + b"\n" for k, vs in sub.items() for v in vs))
    assert t_cli.main(argv) == 0
    pinned = capsysbinary.readouterr()
    monkeypatch.delenv("A5GEN_PAIR")
    assert t_cli.main(argv) == 0
    default = capsysbinary.readouterr()
    assert pinned.out == default.out and default.out
    assert b"pair K=2" in default.err and b"pair K=2" not in pinned.err


@pytest.mark.parametrize("flags", [["-s"], ["-s", "-r"]], ids=["s", "s-r"])
def test_cascade_close_off_matches_reference(flags, tmp_path, capsysbinary,
                                             monkeypatch):
    """``A5GEN_CASCADE_CLOSE=off`` on qwerty-azerty: no word is closed,
    every hazard word goes to the oracle, and the routing line and stdout
    equal the reference CLI's under the same knob."""
    words = make_words(seed=44)
    digests = planted(words, AZERTY, "suball", "md5")
    argv = write_inputs(tmp_path, words, digests, "qwerty-azerty") + [
        "--digests", str(tmp_path / "left.txt"), *GEOMETRY_ARGV, *flags]
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    closing = capsysbinary.readouterr()
    monkeypatch.setenv("A5GEN_CASCADE_CLOSE", "off")
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want.out and got.out

    def routing(err):
        return [ln for ln in err.splitlines() if b"word routing" in ln]

    assert routing(got.err) == routing(want.err)
    assert b" 0 device-closed" in routing(got.err)[0]
    assert routing(closing.err) != routing(got.err)
