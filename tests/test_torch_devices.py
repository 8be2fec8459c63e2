"""One sweep over several devices (``--devices``, ``SweepConfig.devices``,
``parallel.devices``) and a giant job's shards (``SweepConfig.pod``)
against the reference, on the CPU.

``--device cpu --devices N`` runs N cursor stripes over the one CPU
device; the reference's ``--devices N`` shards over its 8-device virtual
CPU mesh (``tests/conftest.py``).  Both streams (crack hits and
candidates) are byte-identical to the reference CLI's at N = 1, 2, 4,
on the superstep drive and the per-launch pipeline, fallback words
included; a checkpoint taken at 2 devices resumes at 1 in the other
package; a giant job's in-process shards are a disjoint union equal to
the single sweep, shard for shard equal to the reference's, and a shard
checkpoint resumes in the other package; the word stripes of a pod
(``_local_sweep``) and their ``PATH.p<id>`` documents equal the
reference's.  (The reference's own tests: ``test_runtime.py``
``TestMultiDeviceSweep``, ``test_pod_giant.py``.)
"""

import json

import numpy as np
import pytest
import torch
from test_torch_resume_cli import (  # noqa: F401
    CLI,
    _disarm,
    killed,
    run,
    write_inputs,
)

import hashcat_a5_table_generator_tpu.parallel.multihost as j_mh
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
import hashcat_a5_table_generator_tpu_torch.parallel.multihost as t_mh
import hashcat_a5_table_generator_tpu_torch.runtime.faults as t_faults
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.native import read_packed_buckets as jrpb
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.native import read_packed_buckets
from hashcat_a5_table_generator_tpu_torch.parallel import devices as t_dev
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

GEOMETRY = ["--lanes", "256", "--blocks", "16"]


def inputs(tmp_path, mode, crack):
    argv = write_inputs(tmp_path, mode) + GEOMETRY
    if crack:
        argv += ["--digests", str(tmp_path / "d.txt")]
    return argv


_REF: dict = {}


def reference(key, argv, capsysbinary):
    if key not in _REF:
        rc, out, err = run("j", argv, capsysbinary)
        assert rc == 0, err
        _REF[key] = out
    return _REF[key]


@pytest.mark.parametrize("devices", ["1", "2", "4"])
@pytest.mark.parametrize("stream", ["crack", "candidates"])
@pytest.mark.parametrize("mode", ["default", "suball"])
def test_cli_devices_match_reference(mode, stream, devices, tmp_path,
                                     capsysbinary):
    """Both packages at the same device count print the same stream (the
    substitute-all input holds qwerty-azerty's oracle-fallback words)."""
    argv = inputs(tmp_path, mode, stream == "crack") + [
        "--devices", devices]
    want = reference((mode, stream, devices), argv, capsysbinary)
    rc, got, err = run("t", argv, capsysbinary)
    assert rc == 0 and got == want and got, err
    if stream == "crack" and devices != "1":
        launches = int(err.split("superstep: ")[1].split(" x ")[1].split()[0])
        assert launches == 16  # one superstep = 16 launches of each stripe


@pytest.mark.parametrize("devices", ["2", "4"])
@pytest.mark.parametrize("mode", ["default", "suball"])
def test_cli_devices_per_launch_match_reference(mode, devices, tmp_path,
                                                capsysbinary):
    """``--superstep off``: each launch round cuts one batch a stripe on
    the host; stdout equals the reference's single-device run's."""
    argv = inputs(tmp_path, mode, True) + ["--superstep", "off"]
    want = reference((mode, "crack", "1"), inputs(tmp_path, mode, True)
                     + ["--devices", "1"], capsysbinary)
    rc, got, err = run("t", argv + ["--devices", devices], capsysbinary)
    assert rc == 0 and got == want, err
    assert "per-launch pipeline" in err


@pytest.mark.parametrize("writer", ["t", "j"])
def test_checkpoint_at_2_devices_resumes_at_1_in_the_other(
        writer, tmp_path, capsysbinary, monkeypatch):
    argv = inputs(tmp_path, "suball", True)
    want = reference(("suball", "crack", "1"), argv + ["--devices", "1"],
                     capsysbinary)
    ck = ["--checkpoint", str(tmp_path / "ck.json"), "--checkpoint-every",
          "0", "--superstep", "1"]
    killed(writer, argv + ck + ["--devices", "2"],
           "superstep.fetch:nth=3,error=OSError", capsysbinary, monkeypatch)
    other = {"t": "j", "j": "t"}[writer]
    rc, got, err = run(other, argv + ck + ["--devices", "1"], capsysbinary)
    assert rc == 0 and got == want, err


def test_garbage_devices_exit_2_in_both(tmp_path, capsys):
    argv = inputs(tmp_path, "default", True)
    for pkg in ("j", "t"):
        for bad in ("0", "many", "-2"):
            with pytest.raises(SystemExit) as exc:
                CLI[pkg].main(argv + ["--devices", bad])
            assert exc.value.code == 2
            assert "must be a positive integer or 'auto'" in \
                capsys.readouterr().err


def test_too_many_cuda_devices_raise(monkeypatch):
    """``--devices 2`` on a machine with one GPU raises the reference's
    message instead of running one stripe."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        t_dev.resolve_devices(2, "cuda")
    assert t_dev.resolve_devices(None, "cuda") == [torch.device("cuda")]
    assert t_dev.resolve_devices(1, "cuda") == [torch.device("cuda")]
    with pytest.raises(ValueError, match="requested device cuda:1"):
        t_dev.resolve_devices(["cuda:0", "cuda:1"], "cuda")
    assert t_dev.resolve_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert t_dev.resolve_devices(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        t_dev.resolve_devices(["cpu", "cuda:0"], "cpu")


def test_stripe_layout():
    st = t_dev.resolve_stripes([torch.device("cpu")] * 2, (1, 3))
    assert (st.n, st.offset, st.total) == (2, 2, 6)
    assert [g for g in range(6) if st.owned(g)] == [2, 3]
    assert st.streams() == [None, None]
    assert st.distinct() == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# The giant job's shards, in one process
# ---------------------------------------------------------------------------

SUB = get_layout("qwerty-azerty").to_substitution_map()


def shard_inputs():
    rng = np.random.default_rng(7)
    words = [bytes(rng.choice(list(b"aqzwAQZWm,;xy"),
                              size=int(rng.integers(2, 13))).astype(np.uint8))
             for _ in range(70)]
    from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
        iter_candidates,
    )
    import hashlib

    digests = []
    for w in words[::3]:
        c = list(iter_candidates(w, SUB, 0, 15, substitute_all=True))
        if c:
            digests.append(hashlib.md5(c[-1]).digest())
    return words, digests


def shard_run(pkg, words, digests, pod, superstep=None, ckpt=None,
              resume=True):
    kw = dict(lanes=256, num_blocks=16, superstep=superstep, pod=pod,
              checkpoint_path=ckpt, checkpoint_every_s=0)
    if pkg == "t":
        res = Sweep(AttackSpec(mode="suball"), SUB, words, digests,
                    config=SweepConfig(device="cpu", **kw)).run_crack(
            resume=resume)
    else:
        res = JSweep(JSpec(mode="suball"), SUB, words, digests,
                     config=JConfig(**kw)).run_crack(resume=resume)
    return res.n_emitted, [(h.word_index, h.variant_rank, h.candidate)
                           for h in res.hits]


def test_pod_shards_are_a_disjoint_union_equal_to_reference():
    words, digests = shard_inputs()
    n1, whole = shard_run("t", words, digests, None)
    shards = [shard_run("t", words, digests, (p, 3)) for p in range(3)]
    union = sorted(h for _n, hits in shards for h in hits)
    assert union == sorted(whole) and len(set(union)) == len(union)
    assert sum(n for n, _h in shards) == n1
    for p, got in enumerate(shards):
        assert got == shard_run("j", words, digests, (p, 3))
    # Only shard 0 expands the fallback words; the routing stays global.
    sweeps = [Sweep(AttackSpec(mode="suball"), SUB, words, digests,
                    config=SweepConfig(device="cpu", lanes=256,
                                       num_blocks=16, pod=(p, 3)))
              for p in range(3)]
    assert sweeps[0].fallback_rows and not sweeps[1].fallback_rows
    assert sweeps[1].routing == sweeps[0].routing


def test_pod_per_launch_shards_union_equals_single():
    """The per-launch pipeline takes a giant job's shards too (the
    reference refuses them: its pod needs the superstep executor)."""
    words, digests = shard_inputs()
    n1, whole = shard_run("t", words, digests, None, superstep=0)
    shards = [shard_run("t", words, digests, (p, 2), superstep=0)
              for p in range(2)]
    union = sorted(h for _n, hits in shards for h in hits)
    assert union == sorted(whole)
    assert sum(n for n, _h in shards) == n1


@pytest.mark.parametrize("writer", ["t", "j"])
def test_shard_checkpoint_crosses_packages(writer, tmp_path, monkeypatch):
    words, digests = shard_inputs()
    want = shard_run("j", words, digests, (0, 2))
    ck = str(tmp_path / "shard.json")
    monkeypatch.setenv("A5GEN_FAULTS", "superstep.fetch:nth=2,error=OSError")
    with pytest.raises(OSError):
        shard_run(writer, words, digests, (0, 2), superstep=1, ckpt=ck)
    monkeypatch.delenv("A5GEN_FAULTS")
    j_faults.clear()
    t_faults.clear()
    doc = json.loads(open(ck).read())
    assert 0 < doc["cursor"]["word"] < len(words)
    other = {"t": "j", "j": "t"}[writer]
    assert shard_run(other, words, digests, (0, 2), ckpt=ck) == want


@pytest.mark.parametrize("pid", [0, 1, 2])
def test_local_sweep_stripes_and_documents_equal_reference(pid, tmp_path):
    words, digests = shard_inputs()
    (tmp_path / "w.txt").write_bytes(b"\n".join(words) + b"\n")
    tb, jb = (read_packed_buckets(str(tmp_path / "w.txt"), buckets=(8, 16)),
              jrpb(str(tmp_path / "w.txt"), buckets=(8, 16)))
    for w in tb:
        assert t_mh.stripe_n_words(tb[w], 3, pid) == \
            j_mh.stripe_n_words(jb[w], 3, pid)
        assert t_mh.host_stripe(tb[w].batch, 3, pid) == \
            j_mh.host_stripe(jb[w].batch, 3, pid)
    ts = t_mh._local_sweep(
        AttackSpec(mode="suball"), SUB, tb, digests,
        SweepConfig(device="cpu", lanes=256, num_blocks=16,
                    checkpoint_path=str(tmp_path / "t.json")), pid, 3)
    js = j_mh._local_sweep(
        JSpec(mode="suball"), SUB, jb, digests,
        JConfig(lanes=256, num_blocks=16,
                checkpoint_path=str(tmp_path / "j.json")), pid, 3)
    tr, jr = ts.run_crack(), js.run_crack()
    assert [(h.word_index, h.variant_rank) for h in tr.hits] == \
        [(h.word_index, h.variant_rank) for h in jr.hits]
    assert tr.n_emitted == jr.n_emitted
    names = sorted(p.name[1:] for p in tmp_path.glob(f"t.json.p{pid}*"))
    assert names == sorted(p.name[1:] for p in tmp_path.glob(
        f"j.json.p{pid}*")) == [f".json.p{pid}", f".json.p{pid}.w16",
                                f".json.p{pid}.w8"]
    for suffix in ("", ".w8", ".w16"):
        tdoc = json.loads((tmp_path / f"t.json.p{pid}{suffix}").read_text())
        jdoc = json.loads((tmp_path / f"j.json.p{pid}{suffix}").read_text())
        for doc in (tdoc, jdoc):
            doc.pop("wall_s", None)
            for entry in doc.get("buckets", {}).values():
                entry.pop("file", None)
        assert tdoc == jdoc, suffix
