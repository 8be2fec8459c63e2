"""Fault F6: the reference's variable-offset ("packed") block layout.

A geometry whose block count does not divide its lane count (``--lanes
1000``, which the auto block count meets with 1024 blocks; ``--lanes 1000
--blocks 7``; ``--lanes 4096 --blocks 3``) or ``--block-layout packed``
runs the reference's variable-offset layout: its XLA expand + hash route
on the per-launch pipeline, each lane binary-searching the block offsets.
The port ran none of them (exit 1, or exit 2 for ``packed``).  On the
CPU: both CLIs' stdout byte-identical at every such geometry in the four
modes, crack and candidates; an explicit ``stride`` that does not divide
exits 1 with the reference's message; ``lane_fields`` with no stride
equal to the reference's on the same block batches; and a checkpoint
taken at one layout resumes at the other, across packages.
"""

import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resume_cli import (
    OTHER,
    _disarm,  # noqa: F401 — the autouse fixture disarms faults
    killed,
    run,
    write_inputs,
)

from hashcat_a5_table_generator_tpu.ops import expand_matches as j_em
from hashcat_a5_table_generator_tpu_torch.models.attack import (
    AttackSpec,
    build_plan,
)
from hashcat_a5_table_generator_tpu_torch.ops import expand_matches as t_em
from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
    make_blocks,
    pad_batch,
)
from hashcat_a5_table_generator_tpu_torch.ops.packing import pack_words
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.compile import compile_table
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

#: The issue's four words (under qwerty-cyrillic, 344 candidates).
F6_WORDS = [b"password", b"hello", b"qwerty", b"abc"]

#: Geometries the reference runs on the variable-offset layout.
GEOMETRIES = {
    "lanes-1000": ["--lanes", "1000"],
    "lanes-1000-blocks-7": ["--lanes", "1000", "--blocks", "7"],
    "lanes-4096-blocks-3": ["--lanes", "4096", "--blocks", "3"],
    "packed": ["--block-layout", "packed", "--lanes", "256", "--blocks",
               "16"],
    "packed-auto-lanes": ["--block-layout", "packed"],
}
MODES = {"default": [], "reverse": ["-r"], "suball": ["-s"],
         "suball-reverse": ["-s", "-r"]}


def f6_inputs(tmp_path, mode):
    """The issue's words plus the seeded wordlist of the resume tests
    (qwerty-azerty's fallback words under ``-s``), and a left list."""
    argv = write_inputs(tmp_path, mode)
    words = F6_WORDS + (tmp_path / "w.txt").read_bytes().split(b"\n")[:-1]
    (tmp_path / "w.txt").write_bytes(b"\n".join(words) + b"\n")
    return argv


@pytest.mark.parametrize("kind", ["crack", "candidates"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_cli_stdout_matches_reference_on_the_packed_layout(
        geometry, mode, kind, tmp_path, capsysbinary):
    argv = f6_inputs(tmp_path, mode) + GEOMETRIES[geometry]
    if kind == "crack":
        argv += ["--digests", str(tmp_path / "d.txt")]
    rc, want, err = run("j", argv, capsysbinary)
    assert rc == 0, err
    rc, got, err = run("t", argv, capsysbinary)
    assert rc == 0, err
    assert got == want and want.count(b"\n") >= (5 if kind == "crack"
                                                   else 100)
    # The variable-offset layout runs the XLA expand + hash route on the
    # per-launch pipeline (TPU kernel row 10's buffer hash in crack mode).
    assert "XLA expand + hash route" in err
    assert "on the piece kernel" not in err
    if kind == "crack":
        assert "buffer_hash/md5" in err and "per-launch pipeline" in err


def test_issue_hit_is_printed_at_1000_lanes(tmp_path, capsysbinary):
    """The issue's crack case: ``--digests D --lanes 1000`` prints the
    reference's hit (``...:руддщ``) instead of exiting 1."""
    argv = write_inputs(tmp_path, "default", words=list(F6_WORDS))
    cand = "руддщ".encode()
    (tmp_path / "d.txt").write_text(hashlib.md5(cand).hexdigest() + "\n")
    argv += ["--digests", str(tmp_path / "d.txt"), "--lanes", "1000"]
    outs = {}
    for pkg in ("j", "t"):
        rc, outs[pkg], err = run(pkg, argv, capsysbinary)
        assert rc == 0, err
    assert outs["t"] == outs["j"] == (hashlib.md5(cand).hexdigest().encode()
                                      + b":" + cand + b"\n")


@pytest.mark.parametrize("kind", ["crack", "candidates"])
def test_explicit_stride_that_does_not_divide_exits_1(kind, tmp_path,
                                                      capsysbinary):
    argv = write_inputs(tmp_path, "default") + [
        "--lanes", "1000", "--blocks", "7", "--block-layout", "stride"]
    if kind == "crack":
        argv += ["--digests", str(tmp_path / "d.txt")]
    said = {}
    for pkg in ("j", "t"):
        rc, out, err = run(pkg, argv, capsysbinary)
        assert rc == 1 and out == b""
        said[pkg] = err.strip().splitlines()[-1]
    assert said["t"] == said["j"]
    assert said["t"].endswith(
        "fixed-stride layout needs lanes (1000) divisible by blocks (7); "
        "adjust the geometry or use the packed layout")


def test_sweep_config_resolves_the_reference_layouts():
    cpu = torch.device("cpu")
    for lanes, nb, packed, want in (
            (1000, None, None, None), (4096, None, None, 128),
            (4096, 3, None, None), (4096, 32, True, None),
            (4096, 32, False, 128), (1 << 17, None, None, 128)):
        cfg = SweepConfig(device="cpu", lanes=lanes, num_blocks=nb,
                          packed_blocks=packed)
        assert cfg.resolve_block_stride(cpu) == want
    assert SweepConfig(lanes=1000).resolve(cpu)[1] == 1024
    with pytest.raises(ValueError, match="use the packed layout"):
        SweepConfig(lanes=1000, num_blocks=7,
                    packed_blocks=False).resolve_block_stride(cpu)


@pytest.mark.parametrize("seed", range(6))
def test_lane_fields_without_stride_match_reference(seed):
    """Random plans cut into variable-size blocks at random cursors:
    the per-lane rank, validity, word row, base digits and gathered
    per-word field equal the reference's ``lane_fields`` with
    ``block_stride=None``, padding lanes and zero-count blocks
    included."""
    rng = np.random.default_rng(seed)
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    words = [bytes(rng.integers(ord("a"), ord("z") + 1,
                                size=int(rng.integers(1, 10)),
                                dtype=np.uint8)) for _ in range(30)]
    spec = AttackSpec(mode=["default", "suball"][seed % 2])
    plan = build_plan(spec, compile_table(sub), pack_words(words))
    lanes = int(rng.choice([100, 257, 1000, 4096]))
    nb = int(rng.integers(1, 40))
    w0 = int(rng.integers(0, 10))
    batch, _w, _r = make_blocks(plan, start_word=w0, start_rank=0,
                                max_variants=lanes, max_blocks=nb)
    batch = pad_batch(batch, nb)
    fields = (batch.word, batch.base_digits, batch.count, batch.offset)
    got = t_em.lane_fields(*(torch.as_tensor(a) for a in fields),
                           num_lanes=lanes, block_stride=None)
    want = j_em.lane_fields(*(jnp.asarray(a) for a in fields),
                            num_lanes=lanes, block_stride=None)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    radix = np.asarray(plan.pat_radix, np.int32)
    np.testing.assert_array_equal(got[4](torch.as_tensor(radix)).numpy(),
                                  np.asarray(want[4](jnp.asarray(radix))))
    assert bool(got[1].any())


def test_pair_lane_fields_stay_stride_only():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="fixed-stride"):
        t_em.pair_lane_fields(z, z[:, None], z, num_lanes=64,
                              block_stride=None)


def test_packed_sweep_takes_the_xla_route():
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    sweep = Sweep(AttackSpec(), sub, F6_WORDS, [bytes(16)],
                  SweepConfig(device="cpu", lanes=100))
    assert sweep.route == "xla"
    res = sweep.run_crack()
    assert res.superstep["per_launch"] == res.kernels["buffer_hash/md5"] > 1
    assert res.superstep["pair"] == 0


#: (what the killed run was given, what the resumed run is given)
LAYOUT_PAIRS = {
    "stride-to-packed": (["--lanes", "256", "--blocks", "16"],
                         ["--lanes", "250"]),
    "packed-to-stride": (["--lanes", "250"],
                         ["--lanes", "256", "--blocks", "16"]),
}


@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-writes",
                                                    "torch-writes"])
@pytest.mark.parametrize("pair", list(LAYOUT_PAIRS))
def test_checkpoint_resumes_across_layouts(pair, writer, tmp_path,
                                           capsysbinary, monkeypatch):
    """A crack sweep killed at one block layout (``--superstep 1``: the
    superstep drive at the stride, the per-launch pipeline when packed)
    resumes at the other, in the other package, to the reference's
    uninterrupted stdout: the checkpoint's cursor is geometry-free."""
    first, then = LAYOUT_PAIRS[pair]
    argv = write_inputs(tmp_path, "default") + [
        "--digests", str(tmp_path / "d.txt"), "--superstep", "1"]
    rc, want, err = run("j", argv + then, capsysbinary)
    assert rc == 0, err
    ck = tmp_path / "ck.json"
    ck_opts = ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    seam = ("superstep.fetch:nth=3,error=OSError" if first[-1] == "16" or
            writer == "t" else "superstep.dispatch:nth=3,error=OSError")
    part = killed(writer, argv + first + ck_opts, seam, capsysbinary,
                  monkeypatch)
    man = json.loads(ck.read_text())
    doc = json.loads((ck.parent / man["buckets"]["16"]["file"]).read_text())
    assert 0 < doc["cursor"]["word"] and len(part) < len(want)
    rc, got, err = run(OTHER[writer], argv + then + ck_opts, capsysbinary)
    assert rc == 0, err
    assert got == want
