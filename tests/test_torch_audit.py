"""The port's audit registry (``audit.py``) and its audit checks, on the
CPU — the counterparts of the reference's ``tools/graftaudit`` checks,
written with what torch offers:

* the registry keeps the reference's rules, and every reference entry
  maps to a port entry or a departure named here;
* integer purity (``purity.py``'s counterpart): every ``integer_stage``
  and the plain version of every ``cuda_kernel`` produce no
  floating-point tensor, recorded under a torch dispatch mode; a stage
  with a float cast is flagged;
* stages survive (``stages.py``'s counterpart): each ``fused_body`` calls
  its declared stages on every route and their output reaches the hits
  (knocked out, the planted hits vanish); a body that skips membership
  is flagged;
* no host transfer inside a body (``transfers.py``'s counterpart): a
  body call records no host-sync op (the card's check is
  ``chip_smoke.py`` phase 13, under ``torch.cuda.set_sync_debug_mode``);
* kernel resource pins (``KERNEL_BUDGETS.json``'s counterpart):
  ``csrc/kernel_budgets.json`` names exactly the instantiations the
  ``budget_keys`` and the CUDA sources declare."""

import hashlib
import json
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hashcat_a5_table_generator_tpu_torch.models.attack as attack
from hashcat_a5_table_generator_tpu_torch import audit, audit_harness
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.oracle.engines import iter_candidates
from hashcat_a5_table_generator_tpu_torch.ops import (
    _native_build,
    buffer_hash,
    bytescan,
    fused_expand,
    hashes,
    membership,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "hashcat_a5_table_generator_tpu_torch" / "csrc"
BUDGETS = CSRC / "kernel_budgets.json"
SUB = get_layout("qwerty-cyrillic").to_substitution_map()
WORDS = [b"password", b"dragon", b"monkey", b"letmein", b"shadow",
         b"master", b"qwerty", b"sunshine"]

#: The reference's entries, each with the port's entry of the same
#: computation (None: none) and, where the two differ, why.
REFERENCE_ENTRIES = {
    "ops.fused_expand_md5": ("ops.fused_expand_md5", None),
    "ops.fused_expand_suball_md5": (
        "ops.fused_expand_suball_md5",
        "one wrapper, ops/fused_expand.fused_expand_md5, takes both plan "
        "kinds (pieces.kind); registered under both names, each with its "
        "kind's piece-kernel instantiations"),
    "ops.md5_pallas": (
        "ops.buffer_hash",
        "renamed: ops/buffer_hash.buffer_hash, the buffer hash of every "
        "algo (csrc/buffer_hash.cu), not MD5 alone"),
    "ops.hashes.md5": ("ops.hashes.md5", None),
    "ops.hashes.md4": ("ops.hashes.md4", None),
    "ops.hashes.sha1": ("ops.hashes.sha1", None),
    "ops.hashes.ntlm": ("ops.hashes.ntlm", None),
    "ops.digest_member": ("ops.digest_member", None),
    "models.make_fused_body": (
        "models.make_fused_body",
        "registered on models/attack.make_crack_step, the per-launch body "
        "itself (the reference's make_crack_step jits make_fused_body)"),
    "models.make_superstep_body": ("models.make_superstep_body", None),
    "parallel.make_sharded_crack_step": (
        None,
        "no shard_map twin: a cursor stripe (parallel/devices.py) runs "
        "make_crack_step on its own device's blocks"),
    "parallel.make_sharded_superstep_step": (
        None,
        "no shard_map twin: a cursor stripe runs make_superstep_body with "
        "a stripe advance (test_stages_survive_on_stripes)"),
}
#: Port entries with no reference entry of their own.
PORT_ONLY = {
    "ops.bytescan_expand": "the byte-scan kernels (csrc/bytescan_hash.cu, "
                           "TPU rows 7-9) have a wrapper of their own; the "
                           "reference's fused wrappers hold their branches",
}
#: Reference kind -> port kind.
KINDS = {"pallas_kernel": "cuda_kernel", "integer_stage": "integer_stage",
         "fused_body": "fused_body", "sharded_body": "sharded_body"}


def port_entries():
    return audit.registered_entries()


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_registry_keeps_the_references_rules():
    def stage(x):
        return x

    before = dict(audit.AUDIT_REGISTRY)
    try:
        assert audit.audited_entry("test.stage", kind="integer_stage")(
            stage) is stage
        # Same module and qualname: an idempotent re-registration.
        audit.audited_entry("test.stage", kind="integer_stage")(stage)

        def other(x):
            return x

        other.__qualname__ = "other"
        with pytest.raises(ValueError, match="registered twice"):
            audit.audited_entry("test.stage", kind="integer_stage")(other)
        with pytest.raises(ValueError, match="unknown kind"):
            audit.audited_entry("test.k", kind="pallas_kernel")
        with pytest.raises(ValueError, match="unknown stage"):
            audit.audited_entry("test.s", kind="fused_body",
                                stages=("decode",))
    finally:
        audit.AUDIT_REGISTRY.clear()
        audit.AUDIT_REGISTRY.update(before)
    assert audit.ENTRY_KINDS == tuple(KINDS.values())


def test_every_reference_entry_maps_to_the_port_or_a_departure():
    import hashcat_a5_table_generator_tpu.audit as ref_audit
    import hashcat_a5_table_generator_tpu.models.attack  # noqa: F401
    import hashcat_a5_table_generator_tpu.ops.hashes  # noqa: F401
    import hashcat_a5_table_generator_tpu.ops.membership  # noqa: F401
    import hashcat_a5_table_generator_tpu.ops.pallas_expand  # noqa: F401
    import hashcat_a5_table_generator_tpu.ops.pallas_md5  # noqa: F401
    import hashcat_a5_table_generator_tpu.parallel.mesh  # noqa: F401

    ref = ref_audit.registered_entries()
    port = port_entries()
    assert set(ref) == set(REFERENCE_ENTRIES)
    mapped = {p for p, _why in REFERENCE_ENTRIES.values() if p}
    assert set(port) == mapped | set(PORT_ONLY)
    for name, (target, why) in REFERENCE_ENTRIES.items():
        if target is None:
            assert why
            continue
        r, p = ref[name], port[target]
        assert p.kind == KINDS[r.kind], name
        assert p.stages == r.stages, name
        renamed = target != name or p.qualname != r.qualname
        assert bool(why) == (renamed or name.endswith("suball_md5")), name
    assert port["ops.fused_expand_md5"].fn is fused_expand.fused_expand_md5
    assert port["ops.fused_expand_suball_md5"].fn is \
        fused_expand.fused_expand_md5
    assert port["models.make_fused_body"].fn is attack.make_crack_step


# ---------------------------------------------------------------------------
# The recording dispatch mode
# ---------------------------------------------------------------------------

#: Ops that wait for the device and copy to the host (a value read, a
#: data-dependent shape).
HOST_SYNC_OPS = {"aten._local_scalar_dense", "aten.item", "aten.nonzero",
                 "aten.is_nonzero", "aten.equal", "aten.masked_select",
                 "aten.unique", "aten._unique", "aten._unique2"}


class Recorder(TorchDispatchMode):
    """Every aten op run inside, with its output dtypes, under the label
    set while it ran."""

    def __init__(self):
        super().__init__()
        self.label = None
        self.ops = []  # (label, op name, output dtypes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        dtypes = tuple(o.dtype for o in outs if isinstance(o, torch.Tensor))
        self.ops.append((self.label, func.overloadpacket._qualified_op_name
                         .replace("::", "."), dtypes))
        return out

    def floats(self, label=None):
        return sorted({op for lb, op, dts in self.ops
                       if (label is None or lb == label)
                       and any(d.is_floating_point or d.is_complex
                               for d in dts)})

    def syncs(self):
        """Host-sync ops run outside a kernel wrapper's plain version
        (the card launches the kernel there)."""
        return sorted({op for lb, op, _d in self.ops
                       if op in HOST_SYNC_OPS and lb is None})


def label_kernels(rec, monkeypatch):
    """Wrap every ``cuda_kernel`` entry where ``models/attack.py`` calls
    it, so ``rec`` labels the ops of its plain version with the entry
    (the piece wrapper's two entries by the plan kind it is given)."""
    fns = {}
    for entry in port_entries().values():
        if entry.kind == "cuda_kernel":
            fns.setdefault(entry.fn, []).append(entry.name)
    for fn, names in fns.items():
        def labelled(*a, _fn=fn, _names=names, **kw):
            pieces = kw.get("pieces")
            rec.label = (_names[0] if len(_names) == 1 else
                         "ops.fused_expand_suball_md5"
                         if pieces.kind == "suball"
                         else "ops.fused_expand_md5")
            try:
                return _fn(*a, **kw)
            finally:
                rec.label = None
        monkeypatch.setattr(attack, fn.__name__, labelled)


def purity_findings(fn, *args):
    """The float-producing ops of one call (empty: integer-pure)."""
    with Recorder() as rec:
        fn(*args)
    return rec.floats()


# ---------------------------------------------------------------------------
# Fixtures: one small crack sweep per route, with planted hits
# ---------------------------------------------------------------------------

ROUTES = {
    # route -> (mode, env): the piece kernel, the byte-scan kernel
    # (A5GEN_EMIT=bytescan), the XLA expand + hash route (A5GEN_PALLAS=off)
    "piece": ("default", {}),
    "piece-suball": ("suball", {}),
    "bytescan": ("default", {"A5GEN_EMIT": "bytescan"}),
    "xla": ("default", {"A5GEN_PALLAS": "off"}),
}
#: The functions models/attack.py calls for each stage, by route.
STAGE_FNS = {
    "piece": {"expand": "fused_expand_md5", "hash": "fused_expand_md5",
              "membership": "digest_member"},
    "bytescan": {"expand": "bytescan_expand", "hash": "bytescan_expand",
                 "membership": "digest_member"},
    "xla": {"expand": "_expand", "hash": "buffer_hash",
            "membership": "digest_member"},
}


def planted(mode):
    """Three candidates of the first word (every body's first launch
    holds them) and a few others, as MD5 digests."""
    cands = list(iter_candidates(WORDS[0], SUB, 1, 15,
                                 substitute_all=mode == "suball"))
    picks = cands[:2] + cands[-1:]
    more = [c for w in WORDS[1:3] for c in
            list(iter_candidates(w, SUB, 1, 15))[:1]]
    return [hashlib.md5(c).digest() for c in picks + more]


def route_sweep(route, monkeypatch, **cfg):
    mode, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sw = Sweep(AttackSpec(mode=mode), SUB, WORDS, planted(mode),
               SweepConfig(device="cpu", lanes=256, num_blocks=16, **cfg))
    assert sw._whole.route == route.split("-")[0]
    return sw


def hits(out):
    return int(out["counters"][1].sum())


def emitted(out):
    return int(out["counters"][0].sum())


# ---------------------------------------------------------------------------
# Integer purity
# ---------------------------------------------------------------------------


def _messages(n=64, width=70, seed=3):
    rng = np.random.default_rng(seed)
    msg = torch.as_tensor(rng.integers(0, 256, (n, width), dtype=np.uint8))
    length = torch.as_tensor(rng.integers(0, width + 1, n, dtype=np.int32))
    return msg, length


@pytest.mark.parametrize("name", ["ops.hashes.md5", "ops.hashes.md4",
                                  "ops.hashes.sha1", "ops.hashes.ntlm"])
def test_hash_stages_are_integer_pure(name):
    entry = port_entries()[name]
    assert entry.kind == "integer_stage"
    assert purity_findings(entry.fn, *_messages()) == []


def test_membership_is_integer_pure():
    entry = port_entries()["ops.digest_member"]
    msg, length = _messages()
    state = hashes.md5(msg, length)
    ds = membership.build_digest_set(
        [hashlib.md5(bytes(m[:n])).digest() for m, n in
         zip(msg.numpy()[::5], length.numpy()[::5])], "md5")
    rows = torch.as_tensor(ds.rows.view(np.int32))
    bitmap = torch.as_tensor(ds.bitmap.view(np.int32))
    assert purity_findings(entry.fn, state, rows, bitmap) == []
    assert int(entry.fn(state, rows, bitmap).sum()) == len(msg[::5])


@pytest.mark.parametrize("route,entry", [
    ("piece", "ops.fused_expand_md5"),
    ("piece-suball", "ops.fused_expand_suball_md5"),
    ("bytescan", "ops.bytescan_expand"),
    ("xla", "ops.buffer_hash"),
])
def test_kernels_plain_versions_are_integer_pure(route, entry, monkeypatch):
    """Each kernel wrapper on CPU tensors (its plain version:
    ``piece_md5_reference``, ``bytescan_reference``, the buffer hash's
    ``HASH_FNS``), called by the bodies on its route."""
    rec = Recorder()
    sw = route_sweep(route, monkeypatch)
    label_kernels(rec, monkeypatch)
    with rec:
        for call in audit_harness.body_calls(sw).values():
            call()
    assert any(lb == entry for lb, _op, _d in rec.ops), entry
    assert rec.floats(entry) == []


def test_a_float_cast_is_flagged():
    def leaky(msg, length):
        return (hashes.md5(msg, length).to(torch.float32) * 1.0).to(
            torch.int32)

    assert purity_findings(leaky, *_messages()) == ["aten._to_copy",
                                                    "aten.mul"]


# ---------------------------------------------------------------------------
# Stages survive
# ---------------------------------------------------------------------------


def _knockout(route, stage, real):
    """``real`` with ``stage``'s contribution zeroed."""
    if stage == "membership":
        return lambda *a, **kw: torch.zeros_like(real(*a, **kw))
    if route == "xla" and stage == "expand":
        def f(*a, **kw):
            *rest, emit = real(*a, **kw)
            return (*rest, torch.zeros_like(emit))
        return f
    if route == "xla":
        return lambda *a, **kw: torch.zeros_like(real(*a, **kw))

    def g(*a, **kw):
        state, emit = real(*a, **kw)
        if stage == "hash":
            return torch.zeros_like(state), emit
        return state, torch.zeros_like(emit)
    return g


def stage_findings(call, stages, route, monkeypatch):
    """What breaks the stage contract of one body call: a declared stage
    whose function never ran, or whose output, knocked out, leaves the
    hit count as it was; a call with no hit at all."""
    fns = STAGE_FNS[route.split("-")[0]]
    counts = {}
    found = []
    with monkeypatch.context() as m:
        for name in set(fns.values()):
            real = getattr(attack, name)

            def counting(*a, _real=real, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a, **kw)
            m.setattr(attack, name, counting)
        base = hits(call())
    if base == 0:
        found.append("no planted hit reached the result")
    for stage in stages:
        name = fns[stage]
        if not counts.get(name):
            found.append(f"{stage}: {name} never called")
            continue
        with monkeypatch.context() as m:
            m.setattr(attack, name,
                      _knockout(route.split("-")[0], stage,
                                getattr(attack, name)))
            if hits(call()) == base:
                found.append(f"{stage}: {name}'s output does not reach "
                             "the hits")
    return found


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_stages_survive_in_every_body(route, monkeypatch):
    sw = route_sweep(route, monkeypatch)
    calls = audit_harness.body_calls(sw)
    bodies = {n for n, e in port_entries().items() if e.kind == "fused_body"}
    if route != "xla":  # the XLA route's superstep drive is present too
        assert set(calls) == bodies
    assert set(calls) <= bodies and "models.make_fused_body" in calls
    for name, call in calls.items():
        stages = port_entries()[name].stages
        assert stage_findings(call, stages, route, monkeypatch) == [], name


def test_stages_survive_on_stripes(monkeypatch):
    """A sweep over two cursor stripes builds its bodies with the stripe
    advance (the sharded twins' counterpart): no stage is lost."""
    sw = route_sweep("piece", monkeypatch, devices=2)
    assert sw.stripes().total == 2
    for name, call in audit_harness.body_calls(sw).items():
        stages = port_entries()[name].stages
        assert stage_findings(call, stages, "piece", monkeypatch) == [], name


def _body_without_membership(spec, **kwargs):
    """A per-launch body that reports every emitted lane as a hit: the
    broken body the stage check must flag."""
    kwargs.pop("num_blocks", None)
    expand, decode = attack._launch_expand(spec, **kwargs)

    def step(arrays, word, count, base, offset=None):
        _state, emit = expand(word, count, base, arrays, offset)
        n = emit.sum(dtype=torch.int32)
        return {"counters": torch.stack([n, n]), "hit": emit}

    step.decode = decode
    return step


def test_a_body_that_skips_membership_is_flagged(monkeypatch):
    sw = route_sweep("piece", monkeypatch, superstep=0)
    monkeypatch.setattr(attack, "make_crack_step", _body_without_membership)
    call = audit_harness.body_calls(sw)["models.make_fused_body"]
    found = stage_findings(call, ("expand", "hash", "membership"), "piece",
                           monkeypatch)
    assert found == ["hash: fused_expand_md5's output does not reach the "
                     "hits", "membership: digest_member never called"]


# ---------------------------------------------------------------------------
# No host transfer inside a body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_host_sync_inside_a_body(route, monkeypatch):
    sw = route_sweep(route, monkeypatch)
    rec = Recorder()
    label_kernels(rec, monkeypatch)
    for name, call in audit_harness.body_calls(sw).items():
        rec.ops.clear()
        with rec:
            out = call()
        assert rec.ops and rec.syncs() == [], name
        # The consumed fetch lies outside the body.
        assert hits(out) > 0


def test_a_host_sync_inside_a_body_is_flagged(monkeypatch):
    sw = route_sweep("piece", monkeypatch)
    real = attack.digest_member

    def fetching(state, rows, bitmap):
        hit = real(state, rows, bitmap)
        if int(hit.sum()) == 0:  # a value read inside the body
            return hit
        return hit

    monkeypatch.setattr(attack, "digest_member", fetching)
    for call in audit_harness.body_calls(sw).values():
        with Recorder() as rec:
            call()
        assert rec.syncs() == ["aten._local_scalar_dense"]


# ---------------------------------------------------------------------------
# Kernel resource pins
# ---------------------------------------------------------------------------


def _body_end(text, start):
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return j + 1
    raise ValueError("unbalanced braces")


def source_instantiations(stem):
    """The kernel instantiations a CUDA source's entry points launch, read
    from the source: each ``template <...> static int`` launcher is
    expanded from the ``extern "C"`` calls down (its template arguments
    resolved through the sources' ``#define`` constants), and each
    ``*_kernel<PIECE_ALGO, ...>`` it names is one instantiation, as the
    ptxas report names it."""
    text = (CSRC / f"{stem}.cu").read_text()
    consts = {"true": 1, "false": 0}
    for src in [text] + [h.read_text() for h in sorted(CSRC.glob("*.cuh"))]:
        consts.update((m.group(1), int(m.group(2))) for m in
                      re.finditer(r"#define (\w+) (\d+)\b", src))
    funcs, spans = {}, []
    for m in re.finditer(
            r"template\s*<([^>]*)>\s*static\s+int\s+(\w+)\s*\(", text):
        end = _body_end(text, m.end())
        params = [p.split()[-1] for p in m.group(1).split(",")]
        funcs[m.group(2)] = (params, text[m.end():end])
        spans.append((m.start(), end))
    cuts = [0] + [i for span in spans for i in span] + [len(text)]
    root = "".join(text[a:b] for a, b in zip(cuts[::2], cuts[1::2]))
    out = set()

    def value(arg, env):
        arg = arg.strip()
        return env[arg] if arg in env else consts[arg] if arg in consts \
            else int(arg)

    def walk(body, env):
        for m in re.finditer(r"(\w+_kernel)<PIECE_ALGO,\s*([^<>]*)>", body):
            args = ",".join(str(value(a, env)) for a in m.group(2).split(","))
            out.add(f"{m.group(1)}<{args}>")
        for m in re.finditer(r"\b(\w+)<([^<>;(){}]*)>\s*\(", body):
            if m.group(1) in funcs:
                params, fbody = funcs[m.group(1)]
                walk(fbody, dict(zip(params, (value(a, env) for a in
                                              m.group(2).split(",")))))

    walk(root, {})
    return out


@pytest.mark.parametrize("stem", sorted(_native_build.KERNELS))
def test_declared_instantiations_are_the_sources(stem):
    assert source_instantiations(stem) == set(_native_build.KERNELS[stem])


def test_budget_file_names_exactly_the_registered_instantiations():
    doc = json.loads(BUDGETS.read_text())
    assert doc["fields"] == ["registers", "stack_bytes", "spill_stores",
                             "spill_loads"]
    pins = doc["kernels"]
    registered = {k for e in port_entries().values()
                  if e.kind == "cuda_kernel" for k in e.budget_keys}
    declared = {f"{lib}:{k}" for lib, (stem, _f) in
                _native_build.LIBRARIES.items()
                for k in source_instantiations(stem)}
    assert set(pins) == registered == declared
    assert len(pins) == 4 * sum(map(len, _native_build.KERNELS.values()))
    for key, vals in pins.items():
        assert len(vals) == 4 and all(
            isinstance(v, int) and v >= 0 for v in vals), key
        assert 0 < vals[0] <= 255, key  # registers a thread
    # Every cuda_kernel entry pins what it launches, and no two entries
    # claim one instantiation.
    for e in port_entries().values():
        assert (e.kind == "cuda_kernel") == bool(e.budget_keys), e.name
    keys = [k for e in port_entries().values() for k in e.budget_keys]
    assert len(keys) == len(set(keys))


def test_budget_keys_follow_the_wrappers_libraries():
    """Each wrapper's keys name its own libraries: the piece kernels' by
    plan kind, the byte-scan and buffer-hash sources whole."""
    e = port_entries()
    kinds = {n: {k.split("<")[1].split(",")[0] for k in e[n].budget_keys}
             for n in ("ops.fused_expand_md5", "ops.fused_expand_suball_md5")}
    assert kinds == {"ops.fused_expand_md5": {"0"},
                     "ops.fused_expand_suball_md5": {"1"}}
    for name, stem in (("ops.bytescan_expand", "bytescan_hash"),
                       ("ops.buffer_hash", "buffer_hash")):
        assert {k.split(":")[0] for k in e[name].budget_keys} == {
            f"{stem}_{a}" for a in ("md5", "md4", "sha1", "ntlm")}
    assert e["ops.buffer_hash"].fn is buffer_hash.buffer_hash
    assert e["ops.bytescan_expand"].fn is bytescan.bytescan_expand
