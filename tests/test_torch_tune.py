"""The geometry tuner (``runtime/tune.py``, ``a5gen tune``) and the
sweep's profile-resolved geometry, against the reference, on the CPU.

The tables (the arm matrices, the tune wordlist, device slugs, the
built-in geometry) and ``A5GEN_TUNE_PROFILE`` equal the reference's; a
profile or a ``--state`` file written by either package resolves to the
same geometry in the other; torn, unknown-major and unknown-minor
profiles behave as in the reference; the precedence cases of the
reference's ``tests/test_tune.py``; a smoke matrix on the CPU emits and
hits what the reference's does; a parity failure raises and a resume
skips completed arms.  Then the sweep: explicit geometry is stamped
``explicit``, a profile loads by default (``profile``, the same stream
as the explicit run), a corrupt one falls back to ``default``, the
progress lines and the CLI carry the geometry, and ``a5gen serve``
reads a profile at startup.  Every test points ``A5GEN_TUNE_PROFILE``
at its own ``tmp_path``.
"""

import hashlib
import io
import json
import sys

import pytest
import torch

from hashcat_a5_table_generator_tpu.runtime import env as j_env
from hashcat_a5_table_generator_tpu.runtime import tune as j_tune
from hashcat_a5_table_generator_tpu.runtime.sweep import (
    SweepConfig as JConfig,
)
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime import env as t_env
from hashcat_a5_table_generator_tpu_torch.runtime import tune as t_tune
from hashcat_a5_table_generator_tpu_torch.runtime.progress import (
    ProgressReporter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)

LEET = {b"a": [b"4", b"@"], b"o": [b"0"], b"s": [b"$", b"5"], b"e": [b"3"]}
WORDS = [b"password", b"sesame", b"octopus", b"zzz", b"a"]
H100 = "NVIDIA H100 80GB HBM3"

#: Two arms of one warm + one timed sweep each (``seconds=0``).
TINY_MATRIX = [
    {"name": "lanes256-stride64", "lanes": 256, "num_blocks": 4,
     "stride": 64, "superstep": None, "pair": "auto", "emit": None},
    {"name": "lanes512-stride64", "lanes": 512, "num_blocks": 8,
     "stride": 64, "superstep": None, "pair": "auto", "emit": None},
]

#: Each package's tune module and a config with the geometry left to the
#: runtime as its CLI leaves it (no --lanes, no --blocks).
PKGS = {"port": (t_tune, lambda: SweepConfig(device="cpu", lanes=None,
                                             num_blocks=None)),
        "reference": (j_tune, lambda: JConfig(lanes=None, num_blocks=None))}


@pytest.fixture(autouse=True)
def profiles(tmp_path, monkeypatch):
    """``A5GEN_TUNE_PROFILE`` at this test's own directory."""
    d = tmp_path / "profiles"
    monkeypatch.setenv("A5GEN_TUNE_PROFILE", str(d))
    return d


def tiny_autotune(tune, tmp_path, **kw):
    kw.setdefault("words", 64)
    kw.setdefault("seconds", 0.0)
    kw.setdefault("matrix", [dict(a) for a in TINY_MATRIX])
    kw.setdefault("directory", str(tmp_path / "out"))
    if tune is t_tune:
        kw.setdefault("device", "cpu")
    return tune.run_autotune(**kw)


# ---------------------------------------------------------------------------
# The tables, the env knob, the built-in geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_default_matrix_equals_reference(smoke):
    got = t_tune.default_matrix(smoke=smoke)
    assert got == j_tune.default_matrix(smoke=smoke)
    assert len(got) == (4 if smoke else 36)
    assert len({a["name"] for a in got}) == len(got)


def test_contract_and_schema_equal_reference():
    for n in (0, 1, 16, 512, 20000):
        assert t_tune.tune_wordlist(n) == j_tune.tune_wordlist(n)
    assert t_tune._TUNE_SUB_MAP == j_tune._TUNE_SUB_MAP
    assert t_tune.TUNE_SCHEMA_VERSION == j_tune.TUNE_SCHEMA_VERSION
    assert t_tune.PROFILE_KNOBS == j_tune.PROFILE_KNOBS


@pytest.mark.parametrize("kind", ["cpu", "TPU v4", H100, "weird/kind (x)",
                                  "  ", "a--b"])
def test_device_slug_equals_reference(kind):
    assert t_tune.device_slug(kind) == j_tune.device_slug(kind)
    assert "/" not in t_tune.device_slug(kind)


@pytest.mark.parametrize("kind", ["cpu", H100])
def test_builtin_geometry_is_the_sweeps_default(kind):
    """The built-ins equal the reference's, and the geometry a sweep used
    before profiles existed (``SweepConfig.resolve``): no profile changes
    nothing."""
    got = t_tune.builtin_geometry(kind)
    assert got == j_tune.builtin_geometry(kind)
    dev = torch.device("cpu" if kind == "cpu" else "cuda")
    lanes, nb, _ = SweepConfig(device=dev.type).resolve(dev)
    assert got["lanes"] == lanes
    assert got["num_blocks"] in (None, nb)
    resolved, source = t_tune.resolve_config(SweepConfig(device=dev.type),
                                             kind)
    assert source == "default"
    assert resolved.resolve(dev)[:2] == (lanes, nb)


@pytest.mark.parametrize("val", ["", "off", "OFF", "0", "no", "/x/dir",
                                 "on"])
def test_tune_profile_setting_matches_reference(val, monkeypatch):
    monkeypatch.setenv("A5GEN_TUNE_PROFILE", val)
    assert t_env.tune_profile_setting() == j_env.tune_profile_setting()
    assert t_tune.profile_dir() == j_tune.profile_dir()


def test_tune_profile_unset_is_the_default_dir(monkeypatch):
    monkeypatch.delenv("A5GEN_TUNE_PROFILE")
    assert t_env.tune_profile_setting() == ""
    assert t_tune.profile_dir().endswith("/.cache/a5gen/tune")
    assert t_tune.profile_dir() == j_tune.profile_dir()


def test_current_device_kind():
    assert t_tune.current_device_kind("cpu") == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_tune.current_device_kind("cuda")


# ---------------------------------------------------------------------------
# Profiles across packages
# ---------------------------------------------------------------------------

GEOMETRIES = [
    {"lanes": 2048, "num_blocks": 16},
    {"lanes": 1 << 20, "num_blocks": 8192, "superstep": 16, "pair": "off"},
    {"lanes": 4096, "superstep": 8},
]


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["lanes-blocks",
                                                      "winner", "no-blocks"])
@pytest.mark.parametrize("kind", ["cpu", H100])
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_profile_crosses_packages(writer, kind, geometry, tmp_path):
    """A profile written by either package resolves to the same geometry
    in both."""
    d = str(tmp_path / "x")
    path = PKGS[writer][0].write_profile(kind, geometry, directory=d,
                                         bench={"hashes_per_s": 1.0})
    resolved = {}
    for name, (tune, config) in PKGS.items():
        assert tune.read_profile(path)["geometry"]["lanes"] == \
            geometry["lanes"]
        cfg, source = tune.resolve_config(config(), kind,
                                          directory=d)
        assert source == "profile"
        resolved[name] = {k: getattr(cfg, k) for k in tune.PROFILE_KNOBS}
    assert resolved["port"] == resolved["reference"]
    assert resolved["port"]["lanes"] == geometry["lanes"]


def test_write_then_read_preserves_geometry(tmp_path):
    d = str(tmp_path)
    geometry = {"lanes": 1 << 17, "num_blocks": 256, "superstep": 8,
                "pair": None, "packed_blocks": None}
    path = t_tune.write_profile(H100, geometry, directory=d,
                                bench={"hashes_per_s": 1.0})
    assert path == t_tune.profile_path(H100, d)
    assert path.endswith("nvidia-h100-80gb-hbm3.json")
    doc = t_tune.read_profile(path)
    assert doc["version"] == t_tune.TUNE_SCHEMA_VERSION
    assert doc["device_kind"] == H100
    for k, v in geometry.items():
        assert doc["geometry"][k] == v
    assert t_tune.load_profile(H100, d) == doc
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "nvidia-h100-80gb-hbm3.json"]


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_tune_state_resumes_across_packages(writer, tmp_path):
    """A ``--state`` file written by either package's matrix resumes in
    the other's: the completed arm is skipped, the next one measured."""
    reader = "reference" if writer == "port" else "port"
    sp = str(tmp_path / "state.json")
    first = tiny_autotune(PKGS[writer][0], tmp_path,
                          matrix=[dict(TINY_MATRIX[0])], state_path=sp,
                          write=False)
    seen = []
    second = tiny_autotune(PKGS[reader][0], tmp_path, matrix=[
        dict(TINY_MATRIX[0])], state_path=sp, write=True,
        on_arm=seen.append, device_kind="cpu")
    assert [r.get("resumed", False) for r in seen] == [True]
    assert second["emitted_per_sweep"] == first["emitted_per_sweep"]
    assert second["geometry"] == first["geometry"]
    # Its profile resolves the same in both packages.
    d = str(tmp_path / "out")
    got = [tune.resolve_config(config(), "cpu", directory=d)
           for tune, config in PKGS.values()]
    assert [(c.lanes, c.num_blocks, s) for c, s in got] == [
        (256, 4, "profile")] * 2


# ---------------------------------------------------------------------------
# Corrupt profiles, precedence
# ---------------------------------------------------------------------------


def _resolve(d):
    return t_tune.resolve_config(SweepConfig(device="cpu", lanes=None),
                                 "cpu", directory=d)


def test_torn_json_warns_once_and_falls_back(tmp_path, capsys):
    d = str(tmp_path)
    path = t_tune.profile_path("cpu", d)
    with open(path, "w") as fh:
        fh.write('{"version": "1.0", "geometry": {"lan')  # torn
    with pytest.raises(t_tune.TuneProfileCorrupt):
        t_tune.read_profile(path)
    resolved, source = _resolve(d)
    assert source == "default"
    assert resolved.lanes == t_tune.builtin_geometry("cpu")["lanes"]
    _resolve(d)  # no second warning (once per path + reason)
    assert capsys.readouterr().err.count("ignoring tune profile") == 1


def test_unknown_major_rejected(tmp_path):
    d = str(tmp_path)
    with open(t_tune.profile_path("cpu", d), "w") as fh:
        json.dump({"version": "99.0", "geometry": {"lanes": 64}}, fh)
    with pytest.raises(t_tune.TuneProfileCorrupt, match="schema major"):
        t_tune.read_profile(t_tune.profile_path("cpu", d))
    assert t_tune.load_profile("cpu", d) is None
    assert j_tune.load_profile("cpu", d) is None


def test_unknown_minor_is_additive(tmp_path):
    d = str(tmp_path)
    with open(t_tune.profile_path("cpu", d), "w") as fh:
        json.dump({"version": "1.9", "future_field": True,
                   "geometry": {"lanes": 4096}}, fh)
    resolved, source = _resolve(d)
    assert (source, resolved.lanes) == ("profile", 4096)


@pytest.mark.parametrize("geometry", [{"lanes": "huge"}, {"lanes": 0},
                                      {"superstep": -1}, "not a dict"])
def test_malformed_geometry_rejected(geometry, tmp_path):
    d = str(tmp_path)
    with open(t_tune.profile_path("cpu", d), "w") as fh:
        json.dump({"version": "1.0", "geometry": geometry}, fh)
    assert t_tune.load_profile("cpu", d) is None
    assert j_tune.load_profile("cpu", d) is None
    assert _resolve(d)[1] == "default"


def test_disabled_via_env(monkeypatch):
    monkeypatch.setenv("A5GEN_TUNE_PROFILE", "off")
    assert t_tune.profile_path("cpu") is None
    assert t_tune.load_profile("cpu") is None
    with pytest.raises(ValueError, match="disabled"):
        t_tune.write_profile("cpu", {"lanes": 64})


def test_env_overrides_directory(profiles):
    t_tune.write_profile("cpu", {"lanes": 512, "num_blocks": 8})
    assert (profiles / "cpu.json").is_file()
    resolved, source = t_tune.resolve_config(
        SweepConfig(device="cpu", lanes=None), "cpu")
    assert (source, resolved.lanes) == ("profile", 512)


def test_explicit_lanes_never_consults_profile(tmp_path):
    d = str(tmp_path)
    t_tune.write_profile("cpu", {"lanes": 2048, "num_blocks": 4},
                         directory=d)
    cfg = SweepConfig(device="cpu", lanes=1 << 12, num_blocks=8)
    resolved, source = t_tune.resolve_config(cfg, "cpu", directory=d)
    assert source == "explicit" and resolved is cfg


def test_profile_fills_unset_knobs(tmp_path):
    d = str(tmp_path)
    t_tune.write_profile("cpu", {"lanes": 2048, "num_blocks": 4,
                                 "superstep": 4}, directory=d)
    resolved, source = t_tune.resolve_config(
        SweepConfig(device="cpu", lanes=None, num_blocks=None), "cpu",
        directory=d)
    assert source == "profile"
    assert (resolved.lanes, resolved.num_blocks, resolved.superstep) == \
        (2048, 4, 4)


def test_explicit_knob_composes_with_profile(tmp_path):
    d = str(tmp_path)
    t_tune.write_profile("cpu", {"lanes": 2048, "num_blocks": 4},
                         directory=d)
    resolved, source = t_tune.resolve_config(
        SweepConfig(device="cpu", lanes=None, num_blocks=16), "cpu",
        directory=d)
    assert source == "profile"
    assert (resolved.lanes, resolved.num_blocks) == (2048, 16)


def test_no_profile_falls_back_to_builtins(tmp_path):
    resolved, source = t_tune.resolve_config(
        SweepConfig(device="cpu", lanes=None, num_blocks=None), "cpu",
        directory=str(tmp_path / "empty"))
    assert source == "default"
    builtin = t_tune.builtin_geometry("cpu")
    assert (resolved.lanes, resolved.num_blocks) == (builtin["lanes"],
                                                     builtin["num_blocks"])


def test_builtin_geometry_per_backend_class():
    assert t_tune.builtin_geometry("cpu")["lanes"] == 1 << 17
    assert t_tune.builtin_geometry(H100)["lanes"] == 1 << 22
    assert t_tune.builtin_geometry(H100)["num_blocks"] is None


# ---------------------------------------------------------------------------
# The arm matrix
# ---------------------------------------------------------------------------


def test_smoke_matrix_emits_what_the_reference_emits(tmp_path):
    """The smoke matrix on the CPU: every arm agrees, and the per-sweep
    emitted and hit counts equal the reference's on the same contract;
    the written profile resolves to the winner."""
    seen = []
    res = t_tune.run_autotune(words=64, seconds=0.0, smoke=True,
                              on_arm=seen.append, device="cpu",
                              directory=str(tmp_path / "out"))
    assert [r["arm"] for r in seen] == [
        a["name"] for a in t_tune.default_matrix(smoke=True)]
    assert len({r["emitted_per_sweep"] for r in seen}) == 1
    assert len({r["hits_per_sweep"] for r in seen}) == 1
    assert res["device_kind"] == "cpu"
    assert res["hashes_per_s"] == max(r["hashes_per_s"] for r in seen)
    ref = tiny_autotune(j_tune, tmp_path, matrix=[dict(TINY_MATRIX[0])],
                        write=False)
    assert (res["emitted_per_sweep"], seen[0]["hits_per_sweep"]) == (
        ref["emitted_per_sweep"], ref["arms"][0]["hits_per_sweep"])
    assert seen[0]["hits_per_sweep"] == 3
    resolved, source = t_tune.resolve_config(
        SweepConfig(device="cpu", lanes=None), "cpu",
        directory=str(tmp_path / "out"))
    assert source == "profile"
    assert resolved.lanes == res["geometry"]["lanes"]


def test_parity_failure_raises(tmp_path):
    bad = [dict(TINY_MATRIX[0]), dict(TINY_MATRIX[1])]
    state = {"completed": {bad[0]["name"]: {
        "arm": bad[0]["name"], "geometry": dict(bad[0]),
        "emitted_per_sweep": 1, "hits_per_sweep": 0, "sweeps": 1,
        "seconds": 0.0, "hashes_per_s": 1.0,
    }}}
    sp = tmp_path / "state.json"
    sp.write_text(json.dumps(state))
    with pytest.raises(RuntimeError, match="parity"):
        tiny_autotune(t_tune, tmp_path, matrix=bad, state_path=str(sp))


def test_partial_matrix_resume_skips_completed_arms(tmp_path):
    sp = str(tmp_path / "state.json")
    first = tiny_autotune(t_tune, tmp_path, matrix=[dict(TINY_MATRIX[0])],
                          state_path=sp, write=False)
    assert first["winner"] == TINY_MATRIX[0]["name"]
    seen = []
    second = tiny_autotune(t_tune, tmp_path, state_path=sp, write=False,
                           on_arm=seen.append)
    assert {r["arm"]: r.get("resumed", False) for r in seen} == {
        TINY_MATRIX[0]["name"]: True, TINY_MATRIX[1]["name"]: False}
    assert len(second["arms"]) == 2
    third = tiny_autotune(t_tune, tmp_path, state_path=sp, write=False)
    assert all(r.get("resumed") for r in third["arms"])


def test_corrupt_state_file_raises_typed(tmp_path):
    sp = tmp_path / "state.json"
    sp.write_text("{not json")
    with pytest.raises(t_tune.TuneProfileCorrupt, match="tune state"):
        tiny_autotune(t_tune, tmp_path, state_path=str(sp))


def test_emit_arm_restores_the_knob(tmp_path, monkeypatch):
    """``measure_arm`` flips ``A5GEN_EMIT`` for its arm and puts back
    exactly what was there, unset included; the byte-scan arm emits what
    the per-slot arm does."""
    arm = dict(TINY_MATRIX[0], name="bytescan-arm", emit="bytescan")
    monkeypatch.delenv("A5GEN_EMIT", raising=False)
    res = tiny_autotune(t_tune, tmp_path,
                        matrix=[dict(TINY_MATRIX[0]), arm], write=False)
    import os

    assert "A5GEN_EMIT" not in os.environ
    assert len({r["emitted_per_sweep"] for r in res["arms"]}) == 1
    monkeypatch.setenv("A5GEN_EMIT", "perslot")
    tiny_autotune(t_tune, tmp_path, matrix=[arm], write=False)
    assert os.environ["A5GEN_EMIT"] == "perslot"


# ---------------------------------------------------------------------------
# The sweep's resolution seam, the CLI, serve
# ---------------------------------------------------------------------------


def _crack(cfg):
    cand = next(iter(iter_candidates(WORDS[0], LEET, 0, 15)))
    digests = [hashlib.md5(cand).digest()]
    return Sweep(AttackSpec(mode="default", algo="md5"), LEET, WORDS,
                 digests, config=cfg).run_crack()


def test_explicit_geometry_stamped_explicit(profiles):
    t_tune.write_profile("cpu", {"lanes": 128, "num_blocks": 4})
    res = _crack(SweepConfig(device="cpu", lanes=64, num_blocks=16))
    assert res.geometry_source == "explicit"
    assert (res.geometry["lanes"], res.geometry["num_blocks"],
            res.geometry["device_kind"]) == (64, 16, "cpu")


def test_profile_geometry_loaded_by_default(profiles):
    t_tune.write_profile("cpu", {"lanes": 128, "num_blocks": 4})
    explicit = _crack(SweepConfig(device="cpu", lanes=64, num_blocks=16))
    res = _crack(SweepConfig(device="cpu"))
    assert res.geometry_source == "profile"
    assert (res.geometry["lanes"], res.geometry["num_blocks"]) == (128, 4)
    assert res.n_emitted == explicit.n_emitted
    assert res.n_hits == explicit.n_hits == 1
    assert [(h.word_index, h.variant_rank, h.candidate) for h in res.hits] \
        == [(h.word_index, h.variant_rank, h.candidate)
            for h in explicit.hits]


def test_no_profile_resolves_the_builtin_geometry():
    res = _crack(SweepConfig(device="cpu"))
    assert res.geometry_source == "default"
    assert (res.geometry["lanes"], res.geometry["num_blocks"]) == (
        1 << 17, 1024)


def test_corrupt_profile_falls_back_to_defaults(profiles):
    profiles.mkdir()
    (profiles / "cpu.json").write_text("{torn")
    res = _crack(SweepConfig(device="cpu"))
    assert res.geometry_source == "default"
    assert res.geometry["lanes"] == t_tune.builtin_geometry("cpu")["lanes"]


def test_disabled_profiles_resolve_default(profiles, monkeypatch):
    t_tune.write_profile("cpu", {"lanes": 128, "num_blocks": 4})
    monkeypatch.setenv("A5GEN_TUNE_PROFILE", "off")
    res = _crack(SweepConfig(device="cpu"))
    assert (res.geometry_source, res.geometry["lanes"]) == ("default",
                                                           1 << 17)


def test_progress_lines_carry_geometry(profiles):
    t_tune.write_profile("cpu", {"lanes": 128, "num_blocks": 4})
    buf = io.StringIO()
    progress = ProgressReporter(len(WORDS), every_s=0.0, stream=buf)
    _crack(SweepConfig(device="cpu", progress=progress))
    lines = [json.loads(line) for line in
             buf.getvalue().strip().splitlines()]
    geom = lines[-1]["progress"]["geometry"]
    assert (geom["source"], geom["lanes"], geom["num_blocks"]) == (
        "profile", 128, 4)


def _cli(argv, capsysbinary):
    rc = t_cli.main(argv)
    got = capsysbinary.readouterr()
    assert rc == 0, got.err
    return got.out, got.err.decode()


def test_cli_crack_from_profile_equals_explicit(profiles, tmp_path,
                                                capsysbinary):
    """The CLI without ``--lanes`` takes the profile's geometry (its
    stderr says so, as the reference's does) and prints the explicit
    run's stdout."""
    wl = tmp_path / "w.txt"
    wl.write_bytes(b"\n".join(WORDS) + b"\n")
    table = tmp_path / "t.table"
    table.write_bytes(b"".join(k + b"=" + v + b"\n"
                               for k, vs in LEET.items() for v in vs))
    cands = [c for w in WORDS for c in iter_candidates(w, LEET, 0, 15)]
    dg = tmp_path / "d.txt"
    dg.write_text("".join(hashlib.md5(c).hexdigest() + "\n"
                          for c in cands[::7]))
    base = [str(wl), "-t", str(table), "--backend", "device", "--digests",
            str(dg), "--device", "cpu", "--buckets", "none"]
    want, _ = _cli(base + ["--lanes", "64", "--blocks", "16"],
                   capsysbinary)
    default_out, err = _cli(base, capsysbinary)
    assert default_out == want
    assert ("geometry: lanes=131072 blocks=1024 superstep=None pair=None"
            " — from built-in defaults") in err
    t_tune.write_profile("cpu", {"lanes": 128, "num_blocks": 4,
                                 "superstep": 2})
    out, err = _cli(base, capsysbinary)
    assert out == want
    assert ("geometry: lanes=128 blocks=4 superstep=2 pair=None — from "
            "autotune profile (cpu)") in err


def test_a5gen_tune_cli_smoke_json(profiles, capsys):
    """``a5gen tune --device cpu --smoke --no-write --json``: exit 0, the
    four arms agree, nothing written."""
    assert t_cli.main(["tune", "--device", "cpu", "--smoke", "--no-write",
                       "--json", "--words", "64", "--seconds", "0"]) == 0
    got = capsys.readouterr()
    doc = json.loads(got.out)
    assert len(doc["arms"]) == 4 and doc["profile_path"] is None
    assert len({a["emitted_per_sweep"] for a in doc["arms"]}) == 1
    assert got.err.count("a5gen: tune: lanes") == 4
    assert not profiles.exists()


def test_a5gen_tune_cli_writes_and_resumes(profiles, tmp_path, capsys):
    sp = str(tmp_path / "state.json")
    argv = ["tune", "--device", "cpu", "--smoke", "--words", "64",
            "--seconds", "0", "--state", sp]
    assert t_cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "tune winner on cpu" in err and "profile written" in err
    assert (profiles / "cpu.json").is_file()
    assert t_cli.main(argv) == 0
    assert capsys.readouterr().err.count("(resumed)") == 4


def _serve_defaults(monkeypatch, argv):
    """``a5gen serve`` on an empty stdin: the engine defaults it built
    and its stderr."""
    from hashcat_a5_table_generator_tpu_torch.runtime import engine

    built = []
    real = engine.Engine

    class Probe(real):
        def __init__(self, defaults, **kw):
            built.append(defaults)
            super().__init__(defaults, **kw)

    monkeypatch.setattr(engine, "Engine", Probe)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    assert t_cli.main(["serve", "--device", "cpu", *argv]) == 0
    (defaults,) = built
    return defaults, err.getvalue()


@pytest.mark.parametrize("argv,want", [
    ([], (1 << 17, 1024)),
    (["--lanes", "256"], (256, 2)),
    (["--blocks", "512"], (1 << 17, 512)),
], ids=["bare", "lanes", "blocks"])
def test_serve_without_profile_keeps_the_builtin_geometry(argv, want,
                                                          monkeypatch):
    defaults, err = _serve_defaults(monkeypatch, argv)
    assert (defaults.lanes, defaults.num_blocks) == want
    assert "autotune profile" not in err


def test_serve_reads_a_profile_at_startup(profiles, monkeypatch):
    t_tune.write_profile("cpu", {"lanes": 4096, "num_blocks": 32})
    defaults, err = _serve_defaults(monkeypatch, [])
    assert (defaults.lanes, defaults.num_blocks) == (4096, 32)
    assert ("geometry defaults from autotune profile (cpu): lanes=4096 "
            "blocks=32") in err
    defaults, _ = _serve_defaults(monkeypatch, ["--blocks", "8"])
    assert (defaults.lanes, defaults.num_blocks) == (4096, 8)
    defaults, _ = _serve_defaults(monkeypatch, ["--lanes", "1024",
                                                "--blocks", "4"])
    assert (defaults.lanes, defaults.num_blocks) == (1024, 4)
