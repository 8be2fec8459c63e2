"""The serve wire contract and the fleet half of telemetry, against the
reference, on the CPU.

The port's ``runtime/protocol.py`` registry equals the committed
``PROTOCOL.json`` (read, never written) and the reference's registry;
every ``op_*`` / ``ev_*`` constructor gives byte-equal JSON to the
reference's for the same arguments (key order is the wire order);
``validate_doc`` gives the reference's verdict on a corpus of good and
malformed documents; ``to_prometheus`` of one snapshot, and of an
engine-labelled ``merge``, is byte-equal; the ``A5GEN_PACK`` /
``A5GEN_REFUSE`` knobs parse as the reference's; the fuse layer's
affinity tokens equal the reference's; ``a5gen fleet`` and ``a5gen tune``
run (queue items 8 and 9).
"""

import ast
import json
import pathlib

import pytest

import hashcat_a5_table_generator_tpu.runtime.env as j_env
import hashcat_a5_table_generator_tpu.runtime.fuse as j_fuse
import hashcat_a5_table_generator_tpu.runtime.protocol as jp
import hashcat_a5_table_generator_tpu.runtime.telemetry as j_tel
import hashcat_a5_table_generator_tpu_torch.runtime.env as t_env
import hashcat_a5_table_generator_tpu_torch.runtime.fuse as t_fuse
import hashcat_a5_table_generator_tpu_torch.runtime.protocol as tp
import hashcat_a5_table_generator_tpu_torch.runtime.telemetry as t_tel
from hashcat_a5_table_generator_tpu import cli as j_cli
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu_torch import cli as t_cli
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import SweepConfig
from tools.graftwire.registry import extract_registry, registry_to_pin

REPO = pathlib.Path(__file__).resolve().parent.parent
T_SRC = REPO / "hashcat_a5_table_generator_tpu_torch" / "runtime" / "protocol.py"


def test_registry_equals_the_committed_pin():
    """The port's registry, extracted as the reference's wire audit
    extracts it (AST literals), equals ``PROTOCOL.json``."""
    tree = ast.parse(T_SRC.read_text(encoding="utf-8"))
    reg = extract_registry(tree, str(T_SRC))
    pin = json.loads((REPO / "PROTOCOL.json").read_text())
    assert registry_to_pin(reg) == pin
    assert tp.PROTOCOL_VERSION == pin["protocol_version"] == "1.2"


@pytest.mark.parametrize("name", ["WIRE_OPS", "WIRE_EVENTS",
                                  "CHECKPOINT_WIRE", "PROTOCOL_VERSION",
                                  "K_OP", "K_EVENT", "OP_DEFAULT",
                                  "__all__"])
def test_registry_objects_equal_reference(name):
    assert getattr(tp, name) == getattr(jp, name)


def _ckpt():
    return {"fingerprint": "f" * 64, "cursor": {"word": 3, "rank": "10"},
            "n_emitted": 7, "n_hits": 1, "hits": [[2, "4"]],
            "wall_s": 0.5}


#: (constructor, args, kwargs): every op_* / ev_* with its optional
#: fields absent, present and present-but-falsy.
CASES = [
    ("op_submit", ({"id": "j", "words": ["a"]},), {}),
    ("op_submit", ({"op": "x", "id": "j"},), {}),
    ("op_pause", ("j1",), {}),
    ("op_cancel", ("j1",), {}),
    ("op_split", ("j1",), {}),
    ("op_split", ("j1",), {"shards": 3}),
    ("op_stats", (), {}),
    ("op_metrics", (), {}),
    ("op_shutdown", (), {}),
    ("ev_accepted", ("j1", "crack"), {}),
    ("ev_accepted", ("j1", "crack"), {"engine": None, "queued": True}),
    ("ev_accepted", ("j1", "candidates"),
     {"engine": "e0", "resumed": True, "shards": 2}),
    ("ev_hit", ("j1",), {"digest": "ab" * 16, "plain_hex": "6869",
                         "word_index": 4, "rank": str(10 ** 20)}),
    ("ev_done", ("j1",), {"n_hits": 2, "n_emitted": 99, "wall_s": 1.5,
                          "resumed": False}),
    ("ev_done", ("j1",), {"n_hits": 2, "n_emitted": 99, "wall_s": 1.5,
                          "resumed": True, "ttfc_s": 0.25,
                          "schema_cache": {"hits": 1},
                          "spans": {"spans": 3}}),
    ("ev_done", ("j1",), {"n_hits": 0, "n_emitted": 0, "wall_s": 0.0,
                          "resumed": False, "ttfc_s": 0.0,
                          "schema_cache": {}, "spans": {}}),
    ("ev_paused", ("j1", _ckpt()), {}),
    ("ev_paused", ("j1", _ckpt()), {"spans": {"spans": 1}}),
    ("ev_cancelled", ("j1",), {}),
    ("ev_failed", ("j1", "RuntimeError: x"), {}),
    ("ev_failed", ("j1", "overloaded"),
     {"reason": "queue full", "retry_after_s": 2.0, "checkpoint": _ckpt()}),
    ("ev_refused", ("j1",), {}),
    ("ev_refused", ("j1",), {"jobs": 3, "fill": 0.375}),
    ("ev_shard_done", ("j1",), {"shard": 0, "shards": 2}),
    ("ev_shard_done", ("j1",), {"shard": 1, "shards": 2, "engine": "e",
                                "n_hits": 4}),
    ("ev_range_reassign", ("j1",), {"shard": 0, "shards": 2}),
    ("ev_range_reassign", ("j1",), {"shard": 0, "shards": 2, "frm": "a",
                                    "to": "b", "acked": 3}),
    ("ev_migrating", ("j1",), {"frm": "a", "to": "b"}),
    ("ev_migrating", ("j1",), {"frm": "a", "to": "b", "noop": True}),
    ("ev_draining", ("e0", 4), {}),
    ("ev_stats", ({"jobs_done": 1, "groups": {"g": 2}},), {}),
    ("ev_stats", ({"jobs_done": 1},), {"fleet": {"engines": 2}}),
    ("ev_metrics", ({"a": {"type": "counter", "value": 1}}, "x 1\n"), {}),
    ("ev_error", ("ValueError: bad",), {}),
    ("ev_error", ("ValueError: bad",), {"jid": "j1"}),
    ("ev_error_overloaded", ("busy", 1.5), {}),
    ("ev_error_overloaded", ("busy", 1.5), {"jid": "j1"}),
    ("ev_bye", (), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_constructors_give_the_reference_bytes(name, args, kw):
    def build(mod):
        a = tuple(dict(x) if isinstance(x, dict) else x for x in args)
        return json.dumps(getattr(mod, name)(*a, **kw))

    assert build(tp) == build(jp)


def test_every_constructor_is_covered():
    names = {n for n in jp.__all__ if n.startswith(("op_", "ev_"))}
    assert names == {c[0] for c in CASES}


#: Documents for ``validate_doc``: good ones, undeclared kinds, missing
#: required fields, the open stats event.
CORPUS = [
    {"op": "submit"}, {}, {"id": "x", "words": []},
    {"op": "pause"}, {"op": "pause", "id": "j"},
    {"op": "resume", "id": "j"}, {"op": "cancel"},
    {"op": "migrate", "id": "j"}, {"op": "drain"},
    {"op": "drain", "engine": "e"}, {"op": "split", "id": "j"},
    {"op": "stats"}, {"op": "metrics"}, {"op": "shutdown"},
    {"op": "nope"}, {"op": None},
    {"event": "hit", "id": "j"},
    {"event": "hit", "id": "j", "digest": "d", "plain_hex": "",
     "word_index": 0, "rank": "0"},
    {"event": "done", "id": "j", "n_hits": 0, "n_emitted": 0,
     "wall_s": 0, "resumed": False},
    {"event": "done", "id": "j"}, {"event": "stats"},
    {"event": "stats", "anything": 1}, {"event": "metrics"},
    {"event": "metrics", "metrics": {}, "prometheus": ""},
    {"event": "refused", "id": "j"}, {"event": "bogus"},
    {"event": None}, {"event": "error"}, {"event": "error", "error": "e"},
    {"event": "bye"}, {"event": "draining", "engine": "e"},
    {"event": "paused", "id": "j", "checkpoint": {}},
]


@pytest.mark.parametrize("doc", CORPUS, ids=[str(i) for i in
                                             range(len(CORPUS))])
def test_validate_doc_verdicts_equal_reference(doc):
    def verdict(mod):
        try:
            return ("ok", mod.validate_doc(dict(doc)))
        except ValueError as e:
            return ("error", str(e).split(" (")[0])

    assert verdict(tp) == verdict(jp)


def _snapshot(mod):
    reg = mod.MetricsRegistry()
    reg.counter("engine.jobs_done").add(3)
    reg.counter("sweep.fetches").add(1.5)
    reg.gauge("engine.packed_fill_last").set(0.625)
    reg.gauge("engine.packed_fill_min", agg="min").set(0.25)
    h = reg.histogram("superstep.fetch_s", (0.001, 0.01, 0.1))
    for v in (0.0005, 0.05, 0.2, 0.02):
        h.observe(v)
    return reg.snapshot()


def test_to_prometheus_is_byte_equal():
    for label in (None, "pid@host"):
        snaps = {}
        for name, mod in (("t", t_tel), ("j", j_tel)):
            snap = _snapshot(mod)
            if label is not None:
                for entry in snap.values():
                    entry["engine"] = label
            snaps[name] = snap
        assert snaps["t"] == snaps["j"]
        assert t_tel.to_prometheus(snaps["t"]) == \
            j_tel.to_prometheus(snaps["j"])
        assert t_tel.to_prometheus(snaps["t"], prefix="x") == \
            j_tel.to_prometheus(snaps["j"], prefix="x")


def test_engine_labelled_merge_and_exposition_equal_reference():
    """Two engines' snapshots: the merge keeps per-engine gauge series and
    the exposition renders them with their engine label."""
    def two(mod):
        out = []
        for eid, fill in (("e0", 0.5), ("e1", 0.75)):
            snap = _snapshot(mod)
            snap["engine.packed_fill_last"]["value"] = fill
            for entry in snap.values():
                entry["engine"] = eid
            out.append(snap)
        return out

    t_merged, j_merged = t_tel.merge(two(t_tel)), j_tel.merge(two(j_tel))
    assert t_merged == j_merged
    assert t_tel.to_prometheus(t_merged) == j_tel.to_prometheus(j_merged)
    assert t_tel.delta(two(t_tel)[0], two(t_tel)[1]) == \
        j_tel.delta(two(j_tel)[0], two(j_tel)[1])


def test_engine_id_labels_snapshots():
    try:
        for mod in (t_tel, j_tel):
            mod.set_engine_id("e9")
            assert mod.engine_id() == "e9"
            mod.counter("test.engine_label").add(1)
            assert mod.snapshot()["test.engine_label"]["engine"] == "e9"
            mod.set_engine_id(None)
            assert "engine" not in mod.snapshot()["test.engine_label"]
        assert t_tel.default_engine_id() == j_tel.default_engine_id()
    finally:
        t_tel.set_engine_id(None)
        j_tel.set_engine_id(None)


@pytest.mark.parametrize("value", [None, "", "off", "0", "no", "on", "1",
                                   "auto", "typo"])
def test_pack_knob_equals_reference(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("A5GEN_PACK", raising=False)
    else:
        monkeypatch.setenv("A5GEN_PACK", value)
    assert t_env.pack_enabled() == j_env.pack_enabled()


@pytest.mark.parametrize("value", [None, "", "off", "0", "no", "0.8", "1",
                                   "within", "within:0.3", "WITHIN:0.7",
                                   "1.5", "-1", "nonsense", "within:x"])
def test_refuse_knobs_equal_reference(value, monkeypatch, capsys):
    if value is None:
        monkeypatch.delenv("A5GEN_REFUSE", raising=False)
    else:
        monkeypatch.setenv("A5GEN_REFUSE", value)
    assert t_env.refuse_threshold() == j_env.refuse_threshold()
    assert t_env.refuse_scope() == j_env.refuse_scope()
    # The warn-once text for a bad value is the reference's.
    capsys.readouterr()
    t_env._WARNED.clear()
    j_env._WARNED.clear()
    t_env.refuse_threshold()
    t_err = capsys.readouterr().err
    j_env.refuse_threshold()
    assert t_err == capsys.readouterr().err


@pytest.mark.parametrize("kw", [
    {}, {"lanes": 4096, "num_blocks": 32}, {"superstep": 2, "pair": "off"},
    {"devices": 2, "lanes": 1 << 22},
])
@pytest.mark.parametrize("mode,algo", [("default", "md5"),
                                       ("suball-reverse", "ntlm")])
def test_affinity_tokens_equal_reference(kw, mode, algo):
    """Equal tokens for equal spec and config fields (the packages'
    SweepConfig defaults differ, so every token field is given)."""
    kw = {"lanes": 1 << 17, "num_blocks": 1024, "superstep": None,
          "devices": 1, "pair": None, **kw}
    t = t_fuse.affinity_token(AttackSpec(mode=mode, algo=algo),
                              SweepConfig(device="cpu", **kw))
    j = j_fuse.affinity_token(JSpec(mode=mode, algo=algo), JConfig(**kw))
    assert t == j
    assert t_fuse.static_affinity_token(a=1, b="x") == \
        j_fuse.static_affinity_token(a=1, b="x")


@pytest.mark.parametrize("sub,item", [("fleet", 8), ("tune", 9)])
def test_fleet_and_tune_still_exit_2_naming_their_items(sub, item, capsys):
    """Queue items 8 (``fleet --autoscale``) and 9 (``tune``) are ported:
    neither refuses naming its item any more.  ``tune --device cpu`` runs
    its smoke matrix; ``fleet --autoscale`` validates its whole elastic
    config before any engine spawns, with the reference's message."""
    if sub == "tune":
        assert t_cli.main([sub, "--device", "cpu", "--smoke", "--no-write",
                           "--words", "16", "--seconds", "0"]) == 0
        err = capsys.readouterr().err
        assert "tune winner on cpu" in err
    else:
        argv = [sub, "--engines", "1", "--autoscale", "1:2",
                "--scale-up-at", "1", "--scale-down-at", "1"]
        codes = []
        for cli in (t_cli, j_cli):
            with pytest.raises(SystemExit) as e:
                cli.main(argv)
            codes.append(e.value.code)
        assert codes[0] == codes[1]
        assert "overlapping thresholds flap" in codes[0]
        err = capsys.readouterr().err
    assert f"ROADMAP.md port queue item {item}" not in err
