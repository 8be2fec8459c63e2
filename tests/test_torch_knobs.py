"""The port's knob registry (``runtime/knobs.py``) against the reference's
and against the port's own code, on the CPU:

* it is a pure literal (``ast.literal_eval`` and ``json`` round-trip it)
  and equals the reference's ``KNOBS`` knob by knob, field by field,
  except for the departures :data:`DEPARTURES` names one by one (an
  unlisted difference fails, and so does a listed one that is gone);
* ``tools.graftknob``'s GK001, GK003, GK004 and GK005 give no finding
  over the port's tree with the port's registry, with the extraction
  anchors found;
* the ``trace`` role by behaviour: two small sweeps differing only in a
  ``trace`` knob build differently keyed step closures, and each trace
  token is spelled in the port's step key;
* the four ``SweepConfig`` fields the registry showed missing
  (``pipeline``, ``max_in_flight``, ``faults``, ``geometry_source``): the
  reference's semantics, streams byte-identical to the reference's, and
  jobs differing only in the pipeline depth never fuse."""

import ast
import dataclasses
import hashlib
import io
import json
import pathlib

import pytest

import hashcat_a5_table_generator_tpu.runtime.knobs as ref_knobs
import hashcat_a5_table_generator_tpu_torch.runtime.knobs as port_knobs
import hashcat_a5_table_generator_tpu_torch.runtime.sweep as sweep_mod
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.oracle.engines import iter_candidates
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.runtime import faults
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import (
    CandidateWriter,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "hashcat_a5_table_generator_tpu_torch"
REGISTRY = PORT / "runtime" / "knobs.py"
SUB = get_layout("qwerty-cyrillic").to_substitution_map()
WORDS = [b"password", b"dragon", b"monkey", b"letmein", b"shadow",
         b"master", b"qwerty", b"abc", b"sunshine", b"trust"]
#: Enough candidates for several supersteps of 2 launches at 256 lanes.
MANY = WORDS + [w[::-1] + w[:2] for w in WORDS] + [w + b"xy" for w in WORDS]

#: Every difference between the port's registry and the reference's, as
#: the path of the differing leaf (a knob, or knob -> field -> ...), and
#: why.
DEPARTURES = {
    ("device",): "the port's own knob: --device on the four parsers and "
                 "SweepConfig.device (default cuda, never chosen "
                 "implicitly); its only key is the fuse key's stripe "
                 "devices",
    ("A5GEN_PALLAS_G",): "Pallas-only: the port has no Pallas grid (its "
                         "kernels size their CTAs at launch)",
    ("A5GEN_PALLAS_INTERPRET",): "Pallas-only: the port's CPU path is "
                                 "device='cpu' (the kernels' plain "
                                 "versions), not interpret mode",
    ("A5GEN_PALLAS", "note"): "the port's fused kernels are CUDA, not "
                              "Pallas",
    ("backend", "note"): "the port's device backend is the CUDA sweep",
    ("devices", "note"): "the port stripes one sweep's cursor over "
                         "devices, no shard_map",
    # The port's None defaults, resolved at use.
    ("lanes", "layers", "config", "default"):
        "None: the device's autotune profile, else tune.builtin_geometry "
        "(2^22 on cuda, 2^17 on cpu), resolved at Sweep construction",
    ("num_blocks", "layers", "config", "default"):
        "None: lanes/128, or 1024 when 128 does not divide the lanes",
    ("retry_attempts", "layers", "config", "default"):
        "None: sweep.RETRY_ATTEMPTS (2), through retry_policy()",
    ("retry_backoff_s", "layers", "config", "default"):
        "None: sweep.RETRY_BACKOFF_S (0.05), through retry_policy()",
    # The port's tokens at pack_candidate's compatibility key.
    ("num_blocks", "keys", "fuse-compat"): "the resolved count, nb",
    ("devices", "keys", "fuse-compat"): "tuple(stripes.devices)",
    ("retry_attempts", "keys", "fuse-compat"): "cfg.retry_policy()",
    ("retry_backoff_s", "keys", "fuse-compat"): "cfg.retry_policy()",
    # The kind of trace key: the port keys its step closures on (name,
    # spec, the closure's keywords) + _STEP_ENV_KNOBS, not on skey tuples.
    ("lanes", "keys", "trace"): "the closure keyword num_lanes",
    ("packed_blocks", "keys", "trace"): "the closure keyword block_stride",
    ("superstep", "keys", "trace"):
        "the key's name: 'superstep' (superstep body) or 'crack-step' "
        "(per-launch pipeline); the step count is an argument of the "
        "body, not baked into it",
    ("devices", "keys", "trace"): "the stripe advance in the key's name",
    ("pod", "keys", "trace"): "the stripe advance in the key's name",
    ("superstep_hit_cap", "roles"):
        "not trace: the hit buffers are arguments of the body (one "
        "closure serves every cap)",
    ("superstep_hit_cap", "keys", "trace"): "(role dropped)",
    ("fetch_chunk", "roles"):
        "not trace: it sets the superstep's step count, an argument of "
        "the body",
    ("fetch_chunk", "keys", "trace"): "(role dropped)",
}


def leaf_diffs(a, b, path=()):
    """Paths of the leaves where ``a`` and ``b`` differ; a key present on
    one side only is one path."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                yield path + (k,)
            else:
                yield from leaf_diffs(a[k], b[k], path + (k,))
    elif a != b:
        yield path


def port_registry():
    from tools.graftknob.registry import extract_registry

    return extract_registry(ast.parse(REGISTRY.read_text()), str(REGISTRY))


# ---------------------------------------------------------------------------
# The registry itself
# ---------------------------------------------------------------------------


def test_registry_is_a_pure_literal_that_round_trips():
    reg = port_registry()
    assert reg.knobs == port_knobs.KNOBS
    assert reg.version == port_knobs.KNOBS_VERSION
    assert json.loads(json.dumps(port_knobs.KNOBS)) == port_knobs.KNOBS
    assert port_knobs.LAYERS == ref_knobs.LAYERS
    assert port_knobs.ROLES == ref_knobs.ROLES
    # Nothing imported: the module's only import is __future__'s.
    tree = ast.parse(REGISTRY.read_text())
    imports = [n for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert [n.module for n in imports] == ["__future__"]


def test_registry_equals_the_reference_but_the_named_departures():
    got = set(leaf_diffs(ref_knobs.KNOBS, port_knobs.KNOBS))
    unlisted = sorted(got - set(DEPARTURES))
    gone = sorted(set(DEPARTURES) - got)
    assert not unlisted, f"differences no departure names: {unlisted}"
    assert not gone, f"departures that are no longer differences: {gone}"
    assert port_knobs.KNOBS_VERSION == ref_knobs.KNOBS_VERSION


def test_graftknob_finds_nothing_with_the_anchors_armed():
    from hashcat_a5_table_generator_tpu_torch.runtime.engine import (
        _JOB_CONFIG_FIELDS,
    )
    from hashcat_a5_table_generator_tpu_torch.runtime.tune import (
        PROFILE_KNOBS,
    )
    from tools.graftknob import analyze_paths

    findings, model = analyze_paths(
        [str(PORT)], select=["GK001", "GK003", "GK004", "GK005"],
        use_allowlist=False, registry=port_registry())
    assert findings == [], "\n".join(
        f"{f.code} {f.path}:{f.line} {f.message}" for f in findings)
    assert model.registry.path == str(REGISTRY)
    # A rename cannot silently disarm a check: every anchor was found.
    assert model.n_fuse_key_sites >= 1
    assert model.n_fuse_guards >= 3
    assert model.n_affinity_sites >= 1
    assert model.n_fingerprint_sites >= 1
    assert model.builders_found == 4
    assert model.n_step_env_knobs >= 3
    assert model.n_serve_fields == len(_JOB_CONFIG_FIELDS)
    assert model.n_profile_knobs == len(PROFILE_KNOBS)
    assert model.n_config_fields == len(dataclasses.fields(SweepConfig))
    assert model.n_cli_flags >= 40 and model.n_env_reads >= 15


# ---------------------------------------------------------------------------
# The trace role, by behaviour
# ---------------------------------------------------------------------------

#: Each trace knob: the sweep it changes, as two variants of the same
#: small crack sweep (SweepConfig fields, AttackSpec fields, env knobs).
TRACE_VARIANTS = {
    "lanes": ({"lanes": 256}, {"lanes": 512}),
    "num_blocks": ({"num_blocks": 16}, {"num_blocks": 8}),
    "packed_blocks": ({"packed_blocks": False}, {"packed_blocks": True}),
    "superstep": ({"superstep": None}, {"superstep": 0}),
    "devices": ({"devices": 1}, {"devices": 2}),
    "pair": ({"pair": None}, {"pair": "off"}),
    "pod": ({"pod": None}, {"pod": (0, 2)}),
    "mode": ({}, {"spec": {"mode": "suball"}}),
    "algo": ({}, {"spec": {"algo": "sha1"}}),
    "table_min": ({}, {"spec": {"min_substitute": 2}}),
    "table_max": ({}, {"spec": {"max_substitute": 2}}),
    "A5GEN_PALLAS": ({}, {"env": {"A5GEN_PALLAS": "off"}}),
    "A5GEN_EMIT": ({}, {"env": {"A5GEN_EMIT": "bytescan"}}),
    "A5GEN_CASCADE_CLOSE": ({}, {"env": {"A5GEN_CASCADE_CLOSE": "off"}}),
    "A5GEN_SUPERSTEP": ({}, {"env": {"A5GEN_SUPERSTEP": "off"}}),
    "A5GEN_PAIR": ({}, {"env": {"A5GEN_PAIR": "off"}}),
}


def step_keys(monkeypatch, variant) -> set:
    """The step-cache keys one small crack sweep asks for: each key
    ``_get_step`` receives with the env suffix it appends."""
    variant = dict(variant)
    spec = AttackSpec(**variant.pop("spec", {}))
    env = variant.pop("env", {})
    cfg = dict(device="cpu", lanes=256, num_blocks=16, superstep=2)
    cfg.update(variant)
    seen = []
    real = sweep_mod._get_step

    def record(key, build):
        seen.append(key + sweep_mod._step_env_key())
        return real(key, build)

    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        m.setattr(sweep_mod, "_get_step", record)
        Sweep(spec, SUB, WORDS, (), SweepConfig(**cfg)).run_crack()
    assert seen
    return set(seen)


def test_trace_variants_cover_the_trace_knobs():
    assert set(TRACE_VARIANTS) == set(port_registry().role_knobs("trace"))


@pytest.mark.parametrize("knob", sorted(TRACE_VARIANTS))
def test_a_trace_knob_changes_the_step_key(knob, monkeypatch):
    a, b = TRACE_VARIANTS[knob]
    assert step_keys(monkeypatch, a) != step_keys(monkeypatch, b)


@pytest.mark.parametrize("knob,a,b", [
    ("superstep", {"superstep": 2}, {"superstep": 5}),
    ("superstep_hit_cap", {"superstep_hit_cap": 64},
     {"superstep_hit_cap": 4096}),
    ("fetch_chunk", {"superstep": None, "fetch_chunk": 2},
     {"superstep": None, "fetch_chunk": 16}),
    ("max_in_flight", {"max_in_flight": 1}, {"max_in_flight": 3}),
    ("pipeline", {"pipeline": False}, {"pipeline": True}),
])
def test_runtime_arguments_share_one_closure(knob, a, b, monkeypatch):
    """The departures: a superstep's step count and hit buffers are
    arguments of the body, so these knobs leave the step key alone (they
    are fuse-compat, and the engine's fuse key carries them)."""
    assert step_keys(monkeypatch, a) == step_keys(monkeypatch, b)


def _step_key_tokens() -> set:
    """Every token the port's step key spells: the names
    ``Sweep._step`` / ``_get_step`` build it from (``spec``), the key
    names passed to ``Sweep._step``, the closure keywords of
    ``Sweep._geometry`` and the env knobs of ``_STEP_ENV_KNOBS``."""
    from tools.graftknob.extract import expr_tokens

    tree = ast.parse((PORT / "runtime" / "sweep.py").read_text())
    tokens = set(sweep_mod._STEP_ENV_KNOBS)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_step":
            tokens |= expr_tokens(node.body[-1].value)
        if isinstance(node, ast.FunctionDef) and node.name == "_geometry":
            for call in ast.walk(node):
                if (isinstance(call, ast.Call)
                        and getattr(call.func, "id", getattr(
                            call.func, "attr", None)) in ("dict", "update")):
                    tokens |= {kw.arg for kw in call.keywords if kw.arg}
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "_step"):
            tokens |= expr_tokens(node.args[0])
    return tokens


def test_trace_tokens_are_spelled_in_the_step_key():
    reg = port_registry()
    tokens = _step_key_tokens()
    assert {"spec", "num_lanes", "pair_k", "superstep", "advance"} <= tokens
    missing = {k: reg.role_token(k, "trace")
               for k in reg.role_knobs("trace")
               if reg.role_token(k, "trace") not in tokens}
    assert not missing


# ---------------------------------------------------------------------------
# The four SweepConfig fields
# ---------------------------------------------------------------------------


def test_the_four_fields_have_the_references_defaults():
    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    got = {f.name: f.default for f in dataclasses.fields(SweepConfig)}
    for name in ("pipeline", "max_in_flight", "faults", "geometry_source"):
        assert got[name] == want[name], name


@pytest.mark.parametrize("fields,depth", [
    ({}, 2), ({"max_in_flight": 1}, 1), ({"max_in_flight": 3}, 3),
    ({"pipeline": True, "max_in_flight": 3}, 3),
    ({"pipeline": False, "max_in_flight": 3}, 1),
])
def test_pipeline_depth_follows_the_reference(fields, depth, monkeypatch):
    monkeypatch.delenv("A5GEN_PIPELINE", raising=False)
    cfg = dict(device="cpu", lanes=256, num_blocks=16)
    sw = Sweep(AttackSpec(), SUB, WORDS, (), SweepConfig(**cfg, **fields))
    assert sw._pipeline_depth() == depth
    monkeypatch.setenv("A5GEN_PIPELINE", "off")
    assert sw._pipeline_depth() == 1


def _digests():
    planted = [list(iter_candidates(w, SUB, 1, 15)) for w in MANY[::3]]
    return [hashlib.md5(c[len(c) // 2]).digest() for c in planted if c]


def _hits(res):
    return [(h.word_index, h.variant_rank, h.candidate) for h in res.hits]


@pytest.fixture(scope="module")
def reference_streams():
    """The reference's crack hits and candidates bytes at each of the
    parametrized field sets (lanes 256, 16 blocks, 2 launches a
    superstep: several supersteps in flight)."""
    out = {}
    for fields in STREAM_FIELDS:
        cfg = JConfig(lanes=256, num_blocks=16, superstep=2, **fields)
        res = JSweep(JSpec(), SUB, MANY, _digests(), config=cfg
                     ).run_crack()
        buf = io.BytesIO()
        from hashcat_a5_table_generator_tpu.runtime.sinks import (
            CandidateWriter as JWriter,
        )

        w = JWriter(buf)
        JSweep(JSpec(), SUB, MANY, (), config=cfg).run_candidates(w)
        w.flush()
        out[tuple(sorted(fields.items()))] = (
            _hits(res), res.n_emitted, buf.getvalue())
    return out


STREAM_FIELDS = [{"max_in_flight": 1}, {"max_in_flight": 2},
                 {"max_in_flight": 3}, {"pipeline": False}]


@pytest.mark.parametrize("fields", STREAM_FIELDS,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_streams_equal_the_references_at_each_depth(fields,
                                                    reference_streams):
    want_hits, want_emitted, want_cands = reference_streams[
        tuple(sorted(fields.items()))]
    cfg = SweepConfig(device="cpu", lanes=256, num_blocks=16, superstep=2,
                      **fields)
    res = Sweep(AttackSpec(), SUB, MANY, _digests(), cfg).run_crack()
    assert res.superstep["supersteps"] >= 4
    assert (_hits(res), res.n_emitted) == (want_hits, want_emitted)
    assert want_hits
    buf = io.BytesIO()
    w = CandidateWriter(buf)
    Sweep(AttackSpec(), SUB, MANY, (), cfg).run_candidates(w)
    w.flush()
    assert buf.getvalue() == want_cands and want_cands


@pytest.mark.parametrize("max_in_flight", [1, 3])
def test_per_launch_pipeline_streams_at_each_bound(max_in_flight):
    """The per-launch pipeline's launches in flight follow
    ``max_in_flight``; the stream does not."""
    def run(k):
        return Sweep(AttackSpec(), SUB, MANY, _digests(), SweepConfig(
            device="cpu", lanes=256, num_blocks=16, superstep=0,
            max_in_flight=k)).run_crack()

    got, want = run(max_in_flight), run(2)
    assert got.superstep["per_launch"] > 2
    assert (_hits(got), got.n_emitted) == (_hits(want), want.n_emitted)


def test_faults_armed_through_the_config_fire_as_through_the_env(
        monkeypatch):
    spec = "superstep.fetch:nth=2"
    cfg = dict(device="cpu", lanes=256, num_blocks=16, superstep=2)
    monkeypatch.delenv("A5GEN_FAULTS", raising=False)
    try:
        by_cfg = Sweep(AttackSpec(), SUB, MANY, _digests(),
                       SweepConfig(faults=spec, **cfg))
        plan_cfg = faults.ACTIVE
        res_cfg = by_cfg.run_crack()
        faults.clear()
        monkeypatch.setenv("A5GEN_FAULTS", spec)
        by_env = Sweep(AttackSpec(), SUB, MANY, _digests(),
                       SweepConfig(**cfg))
        plan_env = faults.ACTIVE
        res_env = by_env.run_crack()
    finally:
        monkeypatch.delenv("A5GEN_FAULTS", raising=False)
        faults.clear()
    assert plan_cfg is not plan_env
    assert plan_cfg.fired == plan_env.fired == [("superstep.fetch", 2)]
    assert res_cfg.superstep["retries"] == res_env.superstep["retries"] == 1
    assert (_hits(res_cfg), res_cfg.n_emitted) == (_hits(res_env),
                                                   res_env.n_emitted)


def test_jobs_differing_only_in_depth_do_not_fuse(monkeypatch):
    from hashcat_a5_table_generator_tpu_torch.runtime.fuse import (
        pack_candidate,
    )

    monkeypatch.delenv("A5GEN_PIPELINE", raising=False)

    def key(**fields):
        sw = Sweep(AttackSpec(), SUB, MANY, _digests(), SweepConfig(
            device="cpu", lanes=256, num_blocks=16, superstep=2, **fields))
        return pack_candidate(sw)["key"]

    assert key(max_in_flight=2) == key(max_in_flight=2)
    assert key(max_in_flight=2) != key(max_in_flight=3)
    assert key(max_in_flight=3) != key(pipeline=False, max_in_flight=3)
    assert key(max_in_flight=1) == key(pipeline=False)


def test_geometry_source_is_stamped_into_the_config(tmp_path, monkeypatch):
    from hashcat_a5_table_generator_tpu_torch.runtime import tune

    def sweep(**cfg):
        return Sweep(AttackSpec(), SUB, MANY, _digests(),
                     SweepConfig(device="cpu", **cfg))

    builtin = sweep()  # the suite turns profiles off: the built-ins
    assert builtin.config.geometry_source == "default"
    assert builtin.config.lanes == tune.builtin_geometry("cpu")["lanes"]
    monkeypatch.setenv("A5GEN_TUNE_PROFILE", str(tmp_path))
    tune.write_profile("cpu", {"lanes": 256, "num_blocks": 16})
    explicit, profiled = sweep(lanes=512, num_blocks=16), sweep()
    assert explicit.config.geometry_source == "explicit"
    assert profiled.config.geometry_source == "profile"
    assert (profiled.config.lanes, profiled.config.num_blocks) == (256, 16)
    for sw in (explicit, profiled):
        assert sw.run_crack().geometry_source == sw.config.geometry_source
