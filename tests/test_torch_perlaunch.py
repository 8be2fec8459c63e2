"""The per-launch pipeline of the PyTorch/CUDA package against the JAX
reference, on the CPU.

A plan whose block index is not int32-safe (a word of 2^30 rows or more)
and every plan under ``--superstep off`` / ``A5GEN_SUPERSTEP=off`` run
the per-launch pipeline, as in the reference: the host cuts each
launch's blocks (``ops.blocks.make_blocks``, a copy of the reference's
cutter, held equal to it here on random plans, huge words included) and
the hits map back to ``(word, rank)`` with Python-int ranks.

* The CLI's stdout is byte-identical to the reference CLI's under
  ``--superstep off`` — crack and candidates mode, default, ``-r`` and
  ``-s`` mode, MD5 and NTLM, and the windowed, XLA-route and pair-eligible
  plans — under ``A5GEN_SUPERSTEP=off`` and ``A5GEN_PIPELINE=off``, and
  with ``MAX_BLOCK`` lowered in both packages so a bucket holds words
  past it (both packages then take their per-launch pipelines).
* A real 30-letter qwerty-cyrillic line (2^30 rows in default mode) is no
  longer refused: the sweep takes the per-launch pipeline.
"""

import numpy as np
import pytest
from test_torch_suball_sweep import make_words, planted

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu.ops.blocks as j_blocks
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import blocks
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
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
THIRTY = b"qwertyuiopasdfghjklzxcvbnmqwer"  # 2^30 rows in default mode
#: A pair-eligible 1:1 table (the superstep drive runs its pair tier).
PAIR_TABLE = {b"a": [b"@@"], b"o": [b"0"], b"s": [b"$"], b"e": [b"33"]}


class FakePlan:
    """What the block cutter reads of a plan: ``batch``, ``num_slots``,
    ``n_variants`` (Python ints, past 2^63 for a huge word),
    ``fallback``, ``pat_radix`` and ``windowed``."""

    def __init__(self, n_variants, radix, fallback, windowed=False):
        self.n_variants = list(n_variants)
        self.batch = len(self.n_variants)
        self.pat_radix = np.asarray(radix, np.int32)
        self.num_slots = int(self.pat_radix.shape[1])
        self.fallback = np.asarray(fallback, bool)
        self.windowed = windowed


def random_plan(seed, huge=False, windowed=False):
    """A seeded plan of 24 words: each word's total the product of its
    radices (3-6 slots of radix 1-5; a few words of 13-24 slots of radix
    3-9, past 2^31 rows), some fallback words, and with ``huge`` one word
    of 2^60 rows or more; windowed totals stay below 2^30."""
    rng = np.random.default_rng(seed)
    p = 24
    radix = np.ones((24, p), np.int32)
    totals = []
    for w in range(24):
        wide = not windowed and w % 7 == 3
        slots = int(rng.integers(13, 25) if wide else rng.integers(3, 7))
        radix[w, :slots] = rng.integers(3 if wide else 1, 10 if wide else 6,
                                        size=slots)
        total = 1
        for r in radix[w]:
            total *= int(r)
        if windowed:
            total = int(rng.integers(1, 5000))
        totals.append(total)
    if huge:
        radix[11, :] = 9
        totals[11] = 9 ** 24  # > 2^60
        assert totals[11] >= blocks._HUGE_WORD
    fallback = rng.random(24) < 0.15
    fallback[11] &= not huge
    return FakePlan(totals, radix, fallback, windowed)


def cuts(mod, plan, stride, start, nb, launches=40, **kw):
    """Up to ``launches`` consecutive cuts of ``mod.make_blocks`` from
    cursor ``start``: the batches' fields and the cursors."""
    out, (w, rank) = [], start
    for _ in range(launches):
        batch, w, rank = mod.make_blocks(
            plan, start_word=w, start_rank=rank, max_variants=nb * stride,
            max_blocks=nb, fixed_stride=stride, **kw)
        out.append((batch.word.tolist(), batch.base_digits.tolist(),
                    batch.count.tolist(), batch.offset.tolist(), w, rank))
        if batch.total == 0:
            break
    return out


_CUT_CASES = [(seed, stride, huge, windowed)
              for seed, stride in ((1, 16), (2, 128), (3, 1000), (4, 7))
              for huge, windowed in ((False, False), (True, False),
                                     (False, True))]


@pytest.mark.parametrize("seed,stride,huge,windowed", _CUT_CASES,
                         ids=[f"seed{s}-stride{t}-{'huge' if h else 'big'}"
                              f"{'-windowed' if w else ''}"
                              for s, t, h, w in _CUT_CASES])
def test_make_blocks_equals_reference_cuts(seed, stride, huge, windowed):
    """The port's host cutter cuts what the reference's cuts — fields,
    int32 types and resume cursors — from the sweep's start and from
    start cursors inside words (stride-aligned or not), on plans with
    words past 2^31 rows and, with ``huge``, a word of 2^60 rows or more
    (the scalar path)."""
    plan = random_plan(seed, huge, windowed)
    twin = random_plan(seed, huge, windowed)  # its own index cache
    assert max(plan.n_variants) >= (1 << 31) or windowed
    rng = np.random.default_rng(seed + 100)
    starts = [(0, 0)] + [
        (int(w), int(rng.integers(0, max(1, plan.n_variants[w]))))
        for w in rng.integers(0, plan.batch, size=4)]
    starts.append((starts[1][0], (starts[1][1] // stride) * stride))
    for start in starts:
        for nb in (1, 5):
            got = cuts(blocks, plan, stride, start, nb)
            assert got == cuts(j_blocks, twin, stride, start, nb)
    got, want = (mod.make_blocks(pl, max_variants=3 * stride + 5)
                 for mod, pl in ((blocks, plan), (j_blocks, twin)))
    assert (got[0].count.tolist(), got[1:]) == (want[0].count.tolist(),
                                                want[1:])
    batch = blocks.make_blocks(plan, max_variants=4 * stride, max_blocks=4,
                               fixed_stride=stride)[0]
    padded = blocks.pad_batch(batch, 6)
    want = j_blocks.pad_batch(j_blocks.make_blocks(
        twin, max_variants=4 * stride, max_blocks=4,
        fixed_stride=stride)[0], 6)
    for f in ("word", "base_digits", "count", "offset"):
        assert getattr(padded, f).dtype == np.int32
        assert getattr(padded, f).tolist() == getattr(want, f).tolist()


def test_lane_cursor_ranks_pass_2_63_exactly():
    """A huge word's blocks map lanes back to Python-int ranks, exactly
    as the reference's ``lane_cursor`` does."""
    from hashcat_a5_table_generator_tpu.models.attack import (
        lane_cursor as j_lane_cursor,
    )

    plan = random_plan(5, huge=True)
    start = (11, 9 ** 24 - 40)
    batch, _w, _r = blocks.make_blocks(
        plan, start_word=start[0], start_rank=start[1], max_variants=64,
        max_blocks=8, fixed_stride=8)
    lanes = list(range(0, 64, 3))
    got = blocks.lane_cursor(plan, batch, lanes)
    assert got == j_lane_cursor(plan, batch, lanes)
    assert got[0] == start and got[13] == (11, 9 ** 24 - 1)
    assert got[14][0] > 11  # the lanes past the word's end: later words


def write_inputs(tmp_path, words, digests, layout):
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text("".join(d.hex() + "\n"
                                               for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    return [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", *GEOMETRY_ARGV]


def both_clis(argv, capsysbinary, monkeypatch=None, env=None):
    """stdout/stderr of the reference CLI and of this package's CLI (on
    the CPU), each with the ``A5GEN_*`` variables of ``env`` set."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr()
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    return want, capsysbinary.readouterr()


#: (table, mode flags, spec mode) per mode.
MODES = {
    "default": ("qwerty-cyrillic", [], "default"),
    "reverse": ("qwerty-cyrillic", ["-r"], "reverse"),
    "suball": ("qwerty-azerty", ["-s"], "suball"),
}
_CLI_CASES = [(mode, algo, crack) for mode in MODES
              for algo in ("md5", "ntlm") for crack in (True, False)]


@pytest.mark.parametrize("mode,algo,crack", _CLI_CASES,
                         ids=[f"{m}-{a}-{'crack' if c else 'candidates'}"
                              for m, a, c in _CLI_CASES])
def test_superstep_off_stdout_equals_reference(mode, algo, crack, tmp_path,
                                               capsysbinary):
    """``--superstep off``: this package's per-launch pipeline prints
    what the reference's does (oracle-fallback words interleaved under
    ``-s``), and says it ran the per-launch pipeline."""
    layout, flags, spec_mode = MODES[mode]
    sub = get_layout(layout).to_substitution_map()
    words = make_words(seed=51, long_line=crack)
    digests = planted(words, sub, spec_mode, algo,
                      mn=1 if mode == "default" else 0)
    argv = write_inputs(tmp_path, words, digests, layout) + flags + [
        "--superstep", "off", "--algo", algo]
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    want, got = both_clis(argv, capsysbinary)
    assert got.out == want.out and got.out
    if crack:
        assert b"per-launch pipeline" in got.err
        assert b"superstep:" not in got.err
        assert b"per-launch drive" in got.err


@pytest.mark.parametrize("case", ["windowed", "xla", "pair-table"])
def test_superstep_off_other_tiers_equal_reference(case, tmp_path,
                                                   capsysbinary,
                                                   monkeypatch):
    """``--superstep off`` on a count-windowed plan (``-x 2``), on the XLA
    route (``A5GEN_PALLAS=off``) and on a pair-eligible table (the
    per-launch pipeline runs K=1): stdout byte-identical to the
    reference's."""
    words = make_words(seed=52)
    env = {"A5GEN_PALLAS": "off"} if case == "xla" else {}
    mx = 2 if case == "windowed" else 15
    sub = PAIR_TABLE if case == "pair-table" else CYR
    digests = planted(words, sub, "default", "md5", mn=1, mx=mx)
    argv = write_inputs(tmp_path, words, digests, "qwerty-cyrillic") + [
        "--superstep", "off", "-x", str(mx),
        "--digests", str(tmp_path / "left.txt")]
    if case == "pair-table":
        (tmp_path / "t.table").write_bytes(b"".join(
            k + b"=" + v + b"\n" for k, vs in sub.items() for v in vs))
        argv += ["--pair", "on"]
    launches = dict(fe.LAUNCHES)
    want, got = both_clis(argv, capsysbinary, monkeypatch, env)
    assert got.out == want.out and got.out
    ran = {k for k, v in fe.LAUNCHES.items() if v != launches[k]}
    assert not any("pair" in k for k in ran)
    if case == "xla":
        assert b"buffer_hash/md5" in got.err


@pytest.mark.parametrize("knob,crack", [("A5GEN_SUPERSTEP", True),
                                        ("A5GEN_SUPERSTEP", False),
                                        ("A5GEN_PIPELINE", True)],
                         ids=["superstep-crack", "superstep-candidates",
                              "pipeline-crack"])
def test_env_knobs_equal_reference(knob, crack, tmp_path, capsysbinary,
                                   monkeypatch):
    """``A5GEN_SUPERSTEP=off`` (the per-launch pipeline) and
    ``A5GEN_PIPELINE=off`` (the barriered superstep drive) run and print
    what the reference prints under the same knob."""
    sub = get_layout("qwerty-azerty").to_substitution_map()
    words = make_words(seed=53, long_line=crack)
    digests = planted(words, sub, "suball", "md5")
    argv = write_inputs(tmp_path, words, digests, "qwerty-azerty") + ["-s"]
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    want, got = both_clis(argv, capsysbinary, monkeypatch, {knob: "off"})
    assert got.out == want.out and got.out
    if crack:
        per_launch = b"per-launch pipeline" in got.err
        assert per_launch == (knob == "A5GEN_SUPERSTEP")
        assert (b"superstep:" in got.err) == (knob == "A5GEN_PIPELINE")


_LOWERED = [(mode, crack) for mode in ("default", "suball")
            for crack in (True, False)]
#: The lowered limit per mode: under the longest word's rows.
_LIMIT = {"default": 200, "suball": 8}


@pytest.mark.parametrize("mode,crack", _LOWERED,
                         ids=[f"{m}-{'crack' if c else 'candidates'}"
                              for m, c in _LOWERED])
def test_words_past_a_lowered_max_block_run_per_launch(
        mode, crack, tmp_path, capsysbinary, monkeypatch):
    """With ``MAX_BLOCK`` lowered in both packages (``_LIMIT``), the
    buckets holding longer words' spaces have no int32-safe index: both
    packages take their per-launch pipelines, and the stdout — with
    oracle-fallback words interleaved under ``-s`` — is
    byte-identical."""
    layout = "qwerty-cyrillic" if mode == "default" else "qwerty-azerty"
    sub = get_layout(layout).to_substitution_map()
    words = make_words(seed=54, long_line=crack)
    digests = planted(words, sub, mode, "md5",
                      mn=1 if mode == "default" else 0)
    argv = write_inputs(tmp_path, words, digests, layout) + (
        ["-s"] if mode == "suball" else [])
    if crack:
        argv += ["--digests", str(tmp_path / "left.txt")]
    monkeypatch.setattr(j_blocks, "MAX_BLOCK", _LIMIT[mode])
    monkeypatch.setattr(blocks, "MAX_BLOCK", _LIMIT[mode])
    spec = AttackSpec(mode=mode)
    sweep = Sweep(spec, sub, words, config=SweepConfig(device="cpu",
                                                       **GEOMETRY))
    launched = ~np.asarray(sweep.plan.fallback, bool)
    assert max(t for t, on in zip(sweep.plan.n_variants, launched)
               if on) > _LIMIT[mode]
    assert sweep.per_launch(16)
    want, got = both_clis(argv, capsysbinary)
    assert got.out == want.out and got.out
    if crack:
        assert b"per-launch pipeline" in got.err


@pytest.mark.parametrize("mode", ["default", "suball"])
def test_thirty_letter_line_is_not_refused(mode):
    """A real 30-letter qwerty-cyrillic line (2^30 rows in default mode;
    in substitute-all mode, a word of 15 three-option patterns: 4^15 =
    2^30 rows) sets no refusal: the sweep takes the per-launch pipeline
    at every stride, and its shorter words' buckets keep the superstep."""
    if mode == "default":
        sub, words = CYR, [b"password", b"sesame", THIRTY]
    else:
        sub = {bytes([c]): [b"1", b"2", b"3"] for c in b"qwertyuiopasdfg"}
        words = [b"password", b"qwertyuiopasdfg"]
    sweep = Sweep(AttackSpec(mode=mode), sub, words, [bytes(16)],
                  SweepConfig(device="cpu"))
    assert max(sweep.plan.n_variants) == 1 << 30
    assert sweep.route == ("xla" if mode == "default" else "piece")
    assert sweep.per_launch(128) and sweep.per_launch(256)
    short = Sweep(AttackSpec(mode=mode), sub, words[:-1], [bytes(16)],
                  SweepConfig(device="cpu"))
    assert not short.per_launch(128)
    off = Sweep(AttackSpec(mode=mode), sub, words[:-1], [bytes(16)],
                SweepConfig(device="cpu", superstep=0))
    assert off.per_launch(128)


def test_per_launch_sweep_hits_equal_superstep_sweep():
    """The library's two drives over one plan: equal hit lists ``(word,
    rank, candidate)`` and emitted counts; the per-launch one launches
    K=1 tiers only and reports its launches."""
    words = make_words(seed=55)
    digests = planted(words, CYR, "default", "md5", mn=1)
    got = {}
    for ss in (None, 0):
        res = Sweep(AttackSpec(), CYR, words, digests,
                    SweepConfig(device="cpu", superstep=ss,
                                **GEOMETRY)).run_crack()
        got[ss] = res
    on, off = got[None], got[0]
    assert [(h.word_index, h.variant_rank, h.candidate) for h in off.hits] \
        == [(h.word_index, h.variant_rank, h.candidate) for h in on.hits]
    assert off.n_emitted == on.n_emitted and off.n_hits == on.n_hits > 0
    assert off.superstep["per_launch"] == off.superstep["launches"] > 0
    assert off.superstep["supersteps"] == 0
    assert on.superstep["supersteps"] > 0 and not on.superstep.get(
        "per_launch")
