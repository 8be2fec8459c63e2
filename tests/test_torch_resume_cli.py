"""Checkpoints cross packages: a sweep killed in one package's CLI resumes
in the other's, on the CPU.

Under ``A5GEN_FAULTS`` (an ``OSError`` at a drive seam: not transient, so
the sweep dies) with ``--checkpoint-every 0``, each package's CLI writes
a checkpoint at every consumed fetch and dies; the *other* package's CLI
resumes it, and its stdout is byte-identical to the reference CLI's
uninterrupted stdout.  Both directions, for default, ``-r``, ``-s`` and
``-s -r`` (qwerty-azerty: oracle-fallback words), on the superstep drive
(``--superstep 2``: a checkpoint every two launches; the fetch seam) and
under ``--superstep off`` (the per-launch pipeline: the dispatch seam,
the one the reference's pipeline fires).  Crack runs are bucketed (a
20-byte line makes a second width), so they also carry the manifest.
Beyond those: a kill in the last bucket, a resume at another geometry
(``--pair``, ``--lanes`` / ``--blocks``), and candidates mode, whose
resumed stream repeats what followed the checkpoint.
"""

import hashlib
import json

import numpy as np
import pytest
from test_torch_suball_sweep import SPECIAL

import hashcat_a5_table_generator_tpu.cli as j_cli
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
import hashcat_a5_table_generator_tpu_torch.cli as t_cli
import hashcat_a5_table_generator_tpu_torch.runtime.faults as t_faults
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
    emit_table,
    get_layout,
)

CLI = {"j": j_cli, "t": t_cli}
OTHER = {"j": "t", "t": "j"}
GEOMETRY_ARGV = ["--lanes", "256", "--blocks", "16"]
MODES = {"default": [], "reverse": ["-r"], "suball": ["-s"],
         "suball-reverse": ["-s", "-r"]}
#: drive -> (its CLI flags, the seam a kill fires at)
DRIVES = {"superstep": (["--superstep", "2"],
                        "superstep.fetch:nth=2,error=OSError"),
          "per-launch": (["--superstep", "off"],
                         "superstep.dispatch:nth=3,error=OSError")}


def layout_for(mode):
    return "qwerty-azerty" if mode.startswith("suball") else \
        "qwerty-cyrillic"


def make_words(n=40, seed=31):
    """Seeded 3-8 letter words, the qwerty-azerty fallback words spread
    among them, and one 20-byte line (the 32-wide bucket)."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(ord("a"), ord("z") + 1,
                                size=int(rng.integers(3, 9)),
                                dtype=np.uint8)) for _ in range(n)]
    for i, w in enumerate(SPECIAL):
        words.insert(4 * i + 2, w)
    words.append(b"qazwsx" + b"-" * 14)
    return words


def write_inputs(tmp_path, mode, words=None, seed=32):
    """Wordlist, table and an MD5 left-list (every third word's middle
    oracle candidate, plus decoys) under ``tmp_path``."""
    words = words or make_words()
    layout = layout_for(mode)
    sub = get_layout(layout).to_substitution_map()
    sa, rv = mode.startswith("suball"), mode.endswith("reverse")
    picks = []
    for w in words[::3]:
        cands = list(iter_candidates(w, sub, 0, 15, substitute_all=sa,
                                     reverse=rv, bug_compat=False))
        if cands:
            picks.append(cands[len(cands) // 2])
    rng = np.random.default_rng(seed)
    digests = [hashlib.md5(c).digest() for c in picks] + [
        rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        for _ in range(20)]
    (tmp_path / "w.txt").write_bytes(b"\n".join(words) + b"\n")
    (tmp_path / "d.txt").write_text("".join(d.hex() + "\n" for d in digests))
    emit_table(get_layout(layout), str(tmp_path / "t.table"))
    return [str(tmp_path / "w.txt"), "-t", str(tmp_path / "t.table"),
            "--backend", "device", *MODES[mode]]


def run(pkg, argv, capsysbinary):
    """One in-process CLI run: ``(exit code, stdout, stderr)``."""
    argv = list(argv) + (["--device", "cpu"] if pkg == "t" else [])
    said = ""
    try:
        rc = CLI[pkg].main(argv)
    except SystemExit as e:  # a message exit prints its text, then 1
        rc, said = (e.code, "") if isinstance(e.code, int) else (1, e.code)
    out = capsysbinary.readouterr()
    return rc, out.out, out.err.decode() + said


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    monkeypatch.delenv("A5GEN_FAULTS", raising=False)
    yield
    for f in (j_faults, t_faults):
        f.clear()


def killed(pkg, argv, spec, capsysbinary, monkeypatch):
    """Run ``argv`` in ``pkg`` with ``spec`` armed: it must die."""
    monkeypatch.setenv("A5GEN_FAULTS", spec)
    rc, out, err = run(pkg, argv, capsysbinary)
    monkeypatch.delenv("A5GEN_FAULTS")
    for f in (j_faults, t_faults):
        f.clear()
    assert rc != 0, err
    assert "injected fault" in err
    return out


_FULL: dict = {}


def reference_stdout(key, argv, capsysbinary):
    """The reference CLI's uninterrupted stdout, once per input set."""
    if key not in _FULL:
        rc, out, err = run("j", argv, capsysbinary)
        assert rc == 0, err
        _FULL[key] = out
    return _FULL[key]


def bucket_docs(ck):
    """The per-bucket checkpoint documents of a manifest at ``ck``."""
    man = json.loads(ck.read_text())
    assert man["kind"] == "bucket-manifest"
    return {w: json.loads((ck.parent / e["file"]).read_text())
            for w, e in man["buckets"].items()
            if (ck.parent / e["file"]).exists()}


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-writes",
                                                    "torch-writes"])
def test_killed_crack_resumes_in_the_other_package(
        writer, mode, drive, tmp_path, capsysbinary, monkeypatch):
    argv = write_inputs(tmp_path, mode) + [
        "--digests", str(tmp_path / "d.txt"), *GEOMETRY_ARGV]
    flags, spec = DRIVES[drive]
    want = reference_stdout((mode, drive), argv + flags, capsysbinary)
    assert want.count(b"\n") >= 10
    ck = tmp_path / "ck.json"
    ck_argv = argv + flags + ["--checkpoint", str(ck),
                              "--checkpoint-every", "0"]
    part = killed(writer, ck_argv, spec, capsysbinary, monkeypatch)
    docs = bucket_docs(ck)
    first = docs[min(docs, key=int)]
    # The kill came mid-sweep: the checkpoint holds a boundary inside the
    # first bucket, and its hits were printed before the kill.
    assert 0 < first["cursor"]["word"] and first["n_emitted"] > 0
    assert part == want[:len(part)] and len(part) < len(want)
    rc, got, err = run(OTHER[writer], ck_argv, capsysbinary)
    assert rc == 0, err
    assert got == want
    if mode == "suball" and drive == "superstep":
        # The first bucket's checkpoint counted the fallback words the
        # oracle took before its cursor (four of qwerty-azerty's SPECIAL
        # words are fallback words under -s, none under -s -r).
        assert first["fallback_done"] > 0


@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-writes",
                                                    "torch-writes"])
def test_kill_in_the_last_bucket_resumes_through_the_manifest(
        writer, tmp_path, capsysbinary, monkeypatch):
    words = make_words() + [b"%02d--------qwertyui" % i for i in range(6)]
    argv = write_inputs(tmp_path, "default", words) + [
        "--digests", str(tmp_path / "d.txt"), *GEOMETRY_ARGV,
        "--superstep", "1"]
    want = reference_stdout(("last-bucket",), argv, capsysbinary)
    # The fetch count of the whole run, then a kill at its last fetch:
    # the first bucket is done, the second stops one superstep short.
    with t_faults.armed("superstep.fetch:nth=1000000") as plan:
        assert run("t", argv, capsysbinary)[0] == 0
        n = plan.calls("superstep.fetch")
    ck = tmp_path / "ck.json"
    ck_argv = argv + ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    killed(writer, ck_argv, f"superstep.fetch:nth={n},error=OSError",
           capsysbinary, monkeypatch)
    docs = bucket_docs(ck)
    assert set(docs) == {"16", "32"}
    # The first bucket's end: its cursor is past its last word.
    assert docs["16"]["cursor"]["word"] == len(words) - 7
    assert 0 < docs["32"]["cursor"]["word"] < 7
    rc, got, err = run(OTHER[writer], ck_argv, capsysbinary)
    assert rc == 0, err
    assert got == want


@pytest.mark.parametrize("writer,first,then", [
    ("j", [], ["--pair", "off"]),
    ("t", [], ["--pair", "off"]),
    ("t", ["--pair", "off"], []),
    ("j", [], ["--lanes", "512", "--blocks", "16"]),
    ("t", ["--lanes", "512", "--blocks", "64", "--pair", "off"], []),
], ids=["jax-pair-auto-to-off", "torch-pair-auto-to-off",
        "torch-pair-off-to-auto", "jax-stride16-to-32",
        "torch-stride8-to-16"])
def test_resume_at_another_geometry(writer, first, then, tmp_path,
                                    capsysbinary, monkeypatch):
    """The fingerprint leaves geometry out: a checkpoint taken with the
    pair tier resumes without it and the reverse (a pair-misaligned
    cursor runs the K=1 superstep tier), and one taken at one block
    stride resumes at another (a misaligned cursor runs the per-launch
    pipeline)."""
    argv = write_inputs(tmp_path, "default") + [
        "--digests", str(tmp_path / "d.txt"), *GEOMETRY_ARGV,
        "--superstep", "1"]
    want = reference_stdout(("default", "geometry"), argv, capsysbinary)
    ck = tmp_path / "ck.json"
    ck_opts = ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    killed(writer, argv + first + ck_opts,
           "superstep.fetch:nth=3,error=OSError", capsysbinary, monkeypatch)
    assert bucket_docs(ck)["16"]["cursor"]["word"] > 0
    rc, got, err = run(OTHER[writer], argv + then + ck_opts, capsysbinary)
    assert rc == 0, err
    assert got == want


@pytest.mark.parametrize("mode", ["default", "suball"])
@pytest.mark.parametrize("writer", ["j", "t"], ids=["jax-writes",
                                                    "torch-writes"])
def test_killed_candidates_stream_resumes_in_the_other_package(
        writer, mode, tmp_path, capsysbinary, monkeypatch):
    """Candidates mode resumes at-least-once, as in the reference: the
    resumed run writes the uninterrupted stream from the checkpoint's
    ``n_emitted`` on (the lines after it that the killed run printed
    repeat)."""
    argv = write_inputs(tmp_path, mode) + GEOMETRY_ARGV
    want = [line + b"\n" for line in reference_stdout(
        (mode, "candidates"), argv, capsysbinary).split(b"\n")[:-1]]
    ck = tmp_path / "ck.json"
    ck_argv = argv + ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    part = killed(writer, ck_argv, "superstep.dispatch:nth=3,error=OSError",
                  capsysbinary, monkeypatch)
    doc = json.loads(ck.read_text())
    k = doc["n_emitted"]
    assert 0 < k <= part.count(b"\n") < len(want)
    rc, got, err = run(OTHER[writer], ck_argv, capsysbinary)
    assert rc == 0, err
    assert got == b"".join(want[k:])
