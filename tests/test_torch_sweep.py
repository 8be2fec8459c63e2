"""The crack sweep and CLI of the PyTorch/CUDA package against the JAX
reference, on the CPU: equal hit streams ``(word_index, rank, candidate)``
and emitted counts with the pair tier on and off, for every decode tier
(scalar, digits, windowed) and every hash, exact overflow re-runs,
byte-identical CLI stdout (with queue items 6's and 7's flags too),
plans past the piece kernel's descriptor table on the XLA route, and
exit status 2 for the subcommands outside the ported slice (the
XLA expand + hash route's own tests: ``test_torch_xla_*.py``)."""

import hashlib
import os

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu.ops.pallas_expand as pe
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.oracle.engines import iter_candidates
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import expand_matches as t_em
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
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

SUB = get_layout("qwerty-cyrillic").to_substitution_map()
GEOMETRY = dict(lanes=256, num_blocks=16)
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]


def make_words(n=40, seed=11):
    rng = np.random.default_rng(seed)
    words = []
    for i in range(n):
        ln = int(rng.integers(1, 9))
        w = bytes(rng.integers(ord("a"), ord("z") + 1, size=ln,
                               dtype=np.uint8))
        words.append(w + b"19" * int(rng.integers(0, 2)))
    words.append(b"20" * 9 + b"ab")  # a 20-byte line: the 32-wide bucket
    return words


def planted_digests(words, every=4, seed=12):
    """Every ``every``-th word's middle oracle candidate, plus decoys."""
    rng = np.random.default_rng(seed)
    planted = []
    for w in words[::every]:
        cands = list(iter_candidates(w, SUB, 1, 15))
        if cands:
            planted.append(cands[len(cands) // 2])
    decoys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
              for _ in range(50)]
    return planted, [hashlib.md5(c).digest() for c in planted] + decoys


def hit_tuples(res):
    return [(h.word_index, h.variant_rank, h.candidate) for h in res.hits]


@pytest.fixture(scope="module")
def contract():
    words = make_words()
    planted, digests = planted_digests(words)
    return words, planted, digests


@pytest.mark.parametrize("pair", [None, "off"], ids=["pair-auto", "pair-off"])
def test_hits_and_emitted_match_reference(contract, pair):
    words, planted, digests = contract
    want = JSweep(JSpec(), SUB, words, digests,
                  config=JConfig(pair=pair, **GEOMETRY)).run_crack()
    got = Sweep(AttackSpec(), SUB, words, digests,
                SweepConfig(device="cpu", pair=pair, **GEOMETRY)
                ).run_crack()
    assert hit_tuples(got) == hit_tuples(want)
    assert got.n_emitted == want.n_emitted
    assert {h.candidate for h in got.hits} == set(planted)
    assert got.superstep["pair"] == (2 if pair is None else 0)
    assert want.superstep["pair"] == got.superstep["pair"]


def test_overflowing_hit_buffer_reruns_exactly(contract):
    words, _planted, digests = contract
    full = Sweep(AttackSpec(), SUB, words, digests,
                 SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    tiny = Sweep(AttackSpec(), SUB, words, digests,
                 SweepConfig(device="cpu", superstep_hit_cap=1,
                             superstep=64, **GEOMETRY)).run_crack()
    assert tiny.superstep["replays"] > 0
    assert hit_tuples(tiny) == hit_tuples(full)
    assert tiny.n_emitted == full.n_emitted


def test_bucketed_sweep_merges_in_word_order(contract):
    from hashcat_a5_table_generator_tpu_torch.ops.packing import (
        bucket_words,
    )

    words, _planted, digests = contract
    whole = Sweep(AttackSpec(), SUB, words, digests,
                  SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    buckets = bucket_words(words)
    assert len(buckets) == 2
    res = BucketedSweep(AttackSpec(), SUB, buckets, digests,
                        SweepConfig(device="cpu", **GEOMETRY)).run_crack()
    assert hit_tuples(res) == hit_tuples(whole)
    assert res.n_emitted == whole.n_emitted


def test_cli_stdout_matches_reference_cli(contract, tmp_path, capsysbinary):
    words, _planted, digests = contract
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests)
    )
    emit_table(get_layout("qwerty-cyrillic"), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--algo", "md5", "--digests",
            str(tmp_path / "left.txt"), *GEOMETRY_ARGV]
    assert j_cli.main(argv) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want
    assert len(want.splitlines()) == len(set(_planted))
    assert b"candidates hashed" in got.err


@pytest.mark.parametrize("extra", [
    ["--schema-cache-max-mb", "8"], ["--devices", "2"],
    ["--devices", "1"], ["--schema-cache", "cache"],
    ["--num-processes", "1"],
], ids=lambda a: a[0])
def test_item_6_and_7_flags_run_as_the_reference(extra, contract, tmp_path,
                                                 capsysbinary):
    """Queue items 6 (the schema cache) and 7 (multi-GPU) run on the
    device backend: with each flag a small CPU crack sweep prints the
    reference CLI's stdout under the same flag (``--devices 2``: two
    cursor stripes over the CPU here, the reference's two-device virtual
    mesh there; each package its own cache directory)."""
    words, _planted, digests = contract
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests))
    emit_table(get_layout("qwerty-cyrillic"), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--digests", str(tmp_path / "left.txt"),
            *GEOMETRY_ARGV]

    def flag(pkg):
        return ([extra[0], str(tmp_path / f"{pkg}-{extra[1]}")]
                if extra[0] == "--schema-cache" else extra)

    assert j_cli.main(argv + flag("j")) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + flag("t") + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want and want
    assert b"candidates hashed" in got.err
    if extra[0] == "--schema-cache":
        assert sorted(os.listdir(tmp_path / "t-cache")) == sorted(
            os.listdir(tmp_path / "j-cache"))


@pytest.mark.parametrize("sub", ["serve", "fleet", "tune"])
def test_flags_outside_the_slice_exit_2(sub, capsys):
    """The subcommands refuse the sweep's flags with their own parsers'
    usage errors, as the reference's do (``fleet`` first misses its
    required ``--engines``)."""
    argv = [sub, "--backend", "device", "--digests", "left.txt"]
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    with pytest.raises(SystemExit) as j_exc:
        j_cli.main(argv)
    assert j_exc.value.code == 2
    j_err = capsys.readouterr().err
    want = ("the following arguments are required: --engines"
            if sub == "fleet" else
            "unrecognized arguments: --backend device --digests left.txt")
    assert want in err and want in j_err
    assert "ROADMAP.md port queue item" not in err


@pytest.mark.parametrize("extra", [
    ["--retries", "1"], ["--checkpoint", "ck.json"], ["--fetch-chunk", "4"],
    ["--progress"], ["--metrics-json", "m.json"], ["--profile", "prof"],
    ["--block-layout", "stride"], ["--fetch-timeout", "30"],
    ["--block-layout", "packed"], ["--stream-chunk-words", "8"],
], ids=lambda a: a[0])
def test_item_6_flags_run_as_the_reference(extra, contract, tmp_path,
                                           capsysbinary):
    """The first half of queue item 6 runs on the device backend: with
    each flag a small CPU crack sweep prints the reference CLI's stdout
    under the same flag (each package writes its own files)."""
    words, _planted, digests = contract
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests))
    emit_table(get_layout("qwerty-cyrillic"), str(tmp_path / "t.table"))
    argv = [str(tmp_path / "words.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", "--digests", str(tmp_path / "left.txt"),
            *GEOMETRY_ARGV]

    def flag(pkg):
        return [extra[0]] + [str(tmp_path / f"{pkg}-{v}") for v in extra[1:]
                             ] if extra[0] in ("--checkpoint",
                                               "--metrics-json",
                                               "--profile") else extra

    assert j_cli.main(argv + flag("j")) == 0
    want = capsysbinary.readouterr().out
    assert t_cli.main(argv + flag("t") + ["--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want and want
    assert b"candidates hashed" in got.err
    if extra[0] in ("--checkpoint", "--metrics-json"):
        assert (tmp_path / f"t-{extra[1]}").is_file()
    if extra[0] == "--profile":
        assert (tmp_path / "t-prof" / "trace.json").is_file()
    if extra[0] == "--progress":
        assert b'{"progress": {' in got.err


@pytest.mark.parametrize("sub", ["serve", "fleet", "tune"])
def test_subcommands_exit_2(sub, capsys):
    """On a machine without a GPU the subcommands that would run on it
    refuse instead of running on the CPU (``--device cpu`` asks for the
    CPU): ``serve`` exits 2; ``tune`` fails (exit 1, the reference's
    ``tune failed`` line) naming the missing device; ``fleet`` exits 2
    without ``--engines``, and an autoscaled fleet whose engine cannot
    start on the GPU exits 2 with the engine's failure."""
    if sub == "fleet":
        with pytest.raises(SystemExit) as exc:
            t_cli.main([sub])
        assert exc.value.code == 2
        assert "the following arguments are required: --engines" in \
            capsys.readouterr().err
    if torch.cuda.is_available():
        return
    if sub == "serve":
        assert t_cli.main([sub]) == 2
        assert "no CUDA device is available" in capsys.readouterr().err
        return
    if sub == "fleet":
        assert t_cli.main([sub, "--engines", "1", "--autoscale", "1:2",
                           "--poll", "0"]) == 2
        assert "before listening" in capsys.readouterr().err
        return
    assert t_cli.main([sub, "--smoke", "--no-write"]) == 1
    err = capsys.readouterr().err
    assert "tune failed" in err and "no CUDA device is available" in err


def test_candidates_mode_exits_2(capsys):
    """Candidates mode runs on both backends, the oracle (the reference's
    default) included (``test_torch_oracle_cli.py``); it exits 2 only on
    a usage error, with the reference's message."""
    errs = []
    for cli in (j_cli, t_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["w.txt", "-t", "t.table", "-m", "3", "-x", "2"])
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]
    assert errs[1].endswith("--table-min 3 > --table-max 2")


@pytest.mark.parametrize("case,reason", [
    ("schema-groups", "emission groups"),
    ("schema-groups-suball", "emission groups"),
])
def test_unported_plans_raise_before_any_launch(case, reason, monkeypatch):
    """A piece schema the kernel's descriptor table cannot hold
    (``MAX_GROUPS`` lowered here), in default and substitute-all mode, is
    no longer refused: the sweep takes the XLA expand + hash route, which
    splices any schema, launches no piece kernel, and finds the hits the
    piece kernel finds on the same plan."""
    words = [b"password", b"sesame"]
    sub, spec, cfg = SUB, AttackSpec(), SweepConfig(device="cpu",
                                                    **GEOMETRY)
    if case.endswith("suball"):
        spec = AttackSpec(mode="suball")
    cands = list(iter_candidates(words[0], sub, 1, 15,
                                 substitute_all=case.endswith("suball")))
    digests = [hashlib.md5(cands[len(cands) // 2]).digest(), bytes(16)]
    want = Sweep(spec, sub, words, digests, cfg)
    assert want.route == "piece"
    want = want.run_crack()
    monkeypatch.setattr(fe, "MAX_GROUPS", 2)
    launches = dict(fe.LAUNCHES)
    sweep = Sweep(spec, sub, words, digests, cfg)
    assert reason in fe.schema_refusal(sweep.plan, sweep.pieces)
    assert sweep.route == "xla"
    got = sweep.run_crack()
    assert fe.LAUNCHES == launches
    assert hit_tuples(got) == hit_tuples(want) and got.n_hits == 1
    assert got.n_emitted == want.n_emitted
    assert got.kernels == {"buffer_hash/md5": got.kernels["buffer_hash/md5"]}


def cli_pair(argv, capsys):
    """The reference CLI's and this package's stdout on ``argv``."""
    outs = []
    for cli, extra in ((j_cli, []), (t_cli, ["--device", "cpu"])):
        rc = cli.main(argv + extra)
        assert rc == 0
        outs.append(capsys.readouterr())
    return outs


@pytest.mark.parametrize("case,reason", [
    ("schema-groups", "emission groups"),
])
def test_bucketed_cli_refuses_before_any_bucket_launches(
    case, reason, contract, tmp_path, capsys, monkeypatch
):
    """A wide bucket whose schema the piece kernel's descriptor table
    cannot hold (``MAX_GROUPS`` lowered) no longer refuses the run: that
    bucket takes the XLA expand + hash route and the CLI's stdout is the
    reference's, byte for byte.  (A 40-letter line, 2^40 variants, runs
    the per-launch pipeline: ``test_torch_perlaunch.py``.)"""
    words, _planted, digests = contract
    tables = ["-t", str(tmp_path / "t.table")]
    emit_table(get_layout("qwerty-cyrillic"), tables[1])
    # 17 bytes, the 32-wide bucket: 7 letters qwerty-cyrillic maps (one
    # option each) and 10 digits it does not, 128 variants, and a piece
    # schema of 11 emission groups, past the lowered limit of 10 (the
    # 16-wide bucket's schema has 5).
    long_line = b"qwertyu1234567890"
    monkeypatch.setattr(fe, "MAX_GROUPS", 10)
    (tmp_path / "words.txt").write_bytes(
        b"\n".join(words + [long_line]) + b"\n"
    )
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests)
    )
    ref, got = cli_pair([str(tmp_path / "words.txt"), *tables, "--backend",
                         "device", "--digests", str(tmp_path / "left.txt"),
                         *GEOMETRY_ARGV], capsys)
    assert got.out == ref.out and got.out
    assert "1 on the XLA expand + hash route" in got.err
    assert reason not in got.err


@pytest.mark.parametrize("case,reason", [
    ("schema-selectors", "selector columns"),
])
def test_cli_refuses_off_kernel_plans_before_any_launch(
        case, reason, contract, tmp_path, capsys, monkeypatch):
    """A piece schema with more selector columns per group than the
    kernel's descriptor holds (``MAX_SEL`` lowered to 0) no longer exits
    2: every bucket takes the XLA expand + hash route, no piece kernel
    launches, and the stdout is the reference CLI's."""
    words, _planted, digests = contract
    monkeypatch.setattr(fe, "MAX_SEL", 0)
    (tmp_path / "words.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "left.txt").write_text(
        "".join(d.hex() + "\n" for d in digests))
    emit_table(get_layout("qwerty-cyrillic"), str(tmp_path / "t.table"))
    launches = dict(fe.LAUNCHES)
    ref, got = cli_pair([str(tmp_path / "words.txt"), "-t",
                         str(tmp_path / "t.table"), "--backend", "device",
                         "--digests", str(tmp_path / "left.txt"),
                         *GEOMETRY_ARGV], capsys)
    assert got.out == ref.out and got.out
    assert fe.LAUNCHES == launches
    assert "piece kernel" not in got.err and reason not in got.err


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert SweepConfig().device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sweep(AttackSpec(), SUB, [b"abc"], [bytes(16)])
    assert SweepConfig().device == "cuda"
