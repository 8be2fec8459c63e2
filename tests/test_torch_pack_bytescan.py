"""Cross-job packed dispatch of byte-scan plans (``runtime/fuse.py``) on the
CPU.

A plan without a piece schema (german's ``ss=ß`` on words with "sss",
colliding starts, or any plan under ``A5GEN_EMIT=bytescan``) packs as the
reference's ``pack_candidate`` packs it: two tenants of one byte-scan
tier fuse into one group whose packed supersteps run the byte-scan
wrapper only (on the CPU its plain version; the launches are counted as
the CUDA wrapper counts them), and each tenant's hits and emitted count
equal its solo sweep's — for every tier the port routes (row 7
``single`` / ``bitmask`` / substitute-all, row 8 radix-2 / digits, row 9
open, a windowed plan); tenants with different tables fuse; a row-7 and
a row-8 tenant never share a key and a cascade-closed row-9 plan keeps
per-job dispatch; a churned group re-fuses byte-exact and a member paused
inside it resumes in the reference package; an overflowing superstep is
re-run on the byte-scan kernel; a launch error in a packed group demotes
its members as a piece group's does, and a group build error fails its
batch.

Geometry: 64 lanes x 16 blocks (stride 4), one launch a superstep;
tenants of one case are rotations of one word list, so their plans share
every shape.
"""

import hashlib
import json

import pytest
from test_torch_bytescan import GERMAN_WORDS, TIERS
from test_torch_pack import full_hits

import hashcat_a5_table_generator_tpu_torch.models.attack as t_attack
import hashcat_a5_table_generator_tpu_torch.runtime.fuse as t_fuse
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime.checkpoint import (
    state_from_doc as j_state_from_doc,
)
from hashcat_a5_table_generator_tpu.runtime.engine import Engine as JEngine
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.ops import bytescan as bs
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
    state_to_doc,
)
from hashcat_a5_table_generator_tpu_torch.runtime.engine import Engine
from hashcat_a5_table_generator_tpu_torch.runtime.fuse import pack_candidate
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

GERMAN = get_layout("german").to_substitution_map()
#: german with other values of the same byte lengths: a second table whose
#: tenants share every shape with german's.
GERMAN_B = {**GERMAN, b"a": ["à".encode()], b"ss": [b"sz"]}

#: Tenants per case label: (table, words, mode, max substitute, whether
#: the plan needs ``A5GEN_EMIT=bytescan`` to leave the piece kernel, the
#: ``ByteScanTier`` its sweep takes).  Workloads from
#: ``test_torch_bytescan.TIERS``.
CASES = {
    "scalar-single": ("scalar-single", True,
                      bs.ByteScanTier("scalar", "scalar", variant="single")),
    "scalar-bitmask": ("scalar-bitmask", False,
                       bs.ByteScanTier("scalar", "scalar",
                                       variant="bitmask")),
    "scalar-suball": ("scalar-suball", True,
                      bs.ByteScanTier("scalar", "scalar", variant="suball")),
    "match-radix2": ("match-radix2", False,
                     bs.ByteScanTier("match", "radix2")),
    "match-digits": ("match-digits", True,
                     bs.ByteScanTier("match", "digits", k_opts=2)),
    "suball-open": ("suball-digits", True,
                    bs.ByteScanTier("suball", "digits", k_opts=2)),
    "match-windowed": ("match-win", True,
                       bs.ByteScanTier("match", "windowed", k_opts=2)),
}


def cfg(**kw):
    return SweepConfig(**{"device": "cpu", "lanes": 64, "num_blocks": 16,
                          "superstep": 1, **kw})


def planted(spec, sub, words, every=3, tag=0):
    """Every ``every``-th word's middle candidate, plus a tenant decoy."""
    picks = []
    for w in words[::every]:
        cands = list(iter_candidates(
            w, sub, spec.effective_min, spec.max_substitute,
            substitute_all=spec.mode.startswith("suball"),
            reverse=spec.mode in ("reverse", "suball-reverse"),
            bug_compat=False))
        if cands:
            picks.append(cands[len(cands) // 2])
    return [hashlib.md5(c).digest() for c in picks] + [
        hashlib.md5(b"tenant-%d" % tag).digest()]


def tenants(words, n=2, shift=3):
    """``n`` rotations of one word list."""
    return [words[i * shift:] + words[:i * shift] for i in range(n)]


@pytest.fixture
def counted(monkeypatch):
    """The byte-scan wrapper counted as its CUDA path counts launches
    (``bs.LAUNCHES``), so the packed supersteps' share shows in
    ``fuse.GROUP_LAUNCHES``; fresh group counters."""
    real = t_attack.bytescan_expand

    def wrapper(*a, tier, algo="md5", **kw):
        bs.LAUNCHES[tier.launch_key(algo)] += 1
        return real(*a, tier=tier, algo=algo, **kw)

    monkeypatch.setattr(t_attack, "bytescan_expand", wrapper)
    monkeypatch.setattr(bs, "LAUNCHES", dict(bs.LAUNCHES))
    monkeypatch.setattr(t_fuse, "GROUP_LAUNCHES", {})
    monkeypatch.setattr(t_fuse, "GROUP_LANES", {})
    return bs.LAUNCHES


def run_engine(spec, jobs, c, **kw):
    """``jobs`` = ``[(table, words, digests)]`` through one engine; the
    results and the stats."""
    eng = Engine(c, auto=False, **kw)
    handles = [eng.submit(spec, t, w, d) for t, w, d in jobs]
    eng.run_until_idle()
    stats = eng.stats()
    got = [h.result(timeout=0) for h in handles]
    eng.close()
    return got, stats


@pytest.mark.parametrize("label", sorted(CASES))
def test_bytescan_tenants_fuse_byte_identical_to_solo(label, counted,
                                                      monkeypatch):
    workload, emit, tier = CASES[label]
    sub, words_of, mode, mx, _ = TIERS[workload]
    if emit:
        monkeypatch.setenv("A5GEN_EMIT", "bytescan")
    spec = AttackSpec(mode=mode, max_substitute=mx)
    jobs = [(sub, w, planted(spec, sub, w, tag=i))
            for i, w in enumerate(tenants(words_of()))]
    c = cfg()
    sweeps = [Sweep(spec, t, w, d, config=c) for t, w, d in jobs]
    assert [(s.route, s.bytescan) for s in sweeps] == [("bytescan", tier)] * 2
    cands = [pack_candidate(s) for s in sweeps]
    assert cands[0]["key"] == cands[1]["key"] and tier in cands[0]["key"]
    want = [s.run_crack(resume=False) for s in sweeps]
    assert t_fuse.GROUP_LAUNCHES == {}
    before = dict(counted)
    got, stats = run_engine(spec, jobs, c)
    assert stats["packed_dispatches"] > 0
    launched = {k: v - before[k] for k, v in counted.items()
                if v != before[k]}
    # Every launch of the engine's run was a packed superstep's, on the
    # tier's own kernel: one a step of each packed dispatch.
    assert t_fuse.GROUP_LAUNCHES == launched == {
        tier.launch_key("md5"): stats["packed_dispatches"]}
    occupied, total = t_fuse.GROUP_LANES[tier.name]
    assert occupied / total == stats["packed_fill"]
    for g, w in zip(got, want):
        assert full_hits(g) == full_hits(w)
        assert g.n_emitted == w.n_emitted
        assert g.superstep.get("packed") == 2
        assert g.kernels == {tier.name: g.superstep["launches"]}
    assert sum(len(g.hits) for g in got) >= 4


def test_bytescan_tenants_with_different_tables_fuse(counted):
    """german and a table with other values: the row-7 tables (each
    byte's value word, length and coverage bits) are per word, so the two
    stack as they are and each tenant gets its own table's candidates."""
    spec = AttackSpec()
    jobs = [(t, w, planted(spec, t, w, every=2, tag=i)) for i, (t, w) in
            enumerate(zip((GERMAN, GERMAN_B), tenants(GERMAN_WORDS)))]
    c = cfg()
    sweeps = [Sweep(spec, t, w, d, config=c) for t, w, d in jobs]
    cands = [pack_candidate(s) for s in sweeps]
    assert all(s.route == "bytescan" for s in sweeps)
    assert cands[0]["key"] == cands[1]["key"]
    assert not (cands[0]["arrays"]["svw"] == cands[1]["arrays"]["svw"]).all()
    want = [s.run_crack(resume=False) for s in sweeps]
    got, stats = run_engine(spec, jobs, c)
    assert stats["packed_dispatches"] > 0
    assert set(t_fuse.GROUP_LAUNCHES) == {"bytescan_scalar/md5"}
    for g, w in zip(got, want):
        assert full_hits(g) == full_hits(w)
        assert g.n_emitted == w.n_emitted
        assert g.superstep.get("packed") == 2
    assert any("à".encode() in h.candidate for h in got[1].hits)
    assert any("ß".encode() in h.candidate for h in got[0].hits)


def test_bytescan_tiers_never_share_a_key_and_closed_plans_run_per_job(
        counted, monkeypatch):
    """A row-7 (german) and a row-8 (colliding starts) tenant: different
    keys, per-job dispatch.  A cascade-closed row-9 plan
    (qwerty-azerty ``-s`` under ``A5GEN_EMIT=bytescan``) is no packing
    candidate: two of them run per job, each its solo stream."""
    spec = AttackSpec()
    c = cfg()
    mixed = []
    for workload in ("scalar-bitmask", "match-radix2"):
        sub, words_of, _mode, _mx, _ = TIERS[workload]
        mixed.append((sub, words_of(), planted(spec, sub, words_of())))
    sweeps = [Sweep(spec, t, w, d, config=c) for t, w, d in mixed]
    tiers = [s.bytescan for s in sweeps]
    assert [t.row for t in tiers] == ["scalar", "match"]
    keys = [pack_candidate(s)["key"] for s in sweeps]
    assert keys[0] != keys[1]
    assert tiers[0] in keys[0] and tiers[1] not in keys[0]
    monkeypatch.setenv("A5GEN_EMIT", "bytescan")
    sub, words_of, mode, mx, _ = TIERS["suball-closed"]
    sspec = AttackSpec(mode=mode, max_substitute=mx)
    closed = [(sub, w, planted(sspec, sub, w, tag=i))
              for i, w in enumerate(tenants(words_of()))]
    csweeps = [Sweep(sspec, t, w, d, config=c) for t, w, d in closed]
    assert all(s.bytescan.closed for s in csweeps)
    assert [pack_candidate(s) for s in csweeps] == [None, None]
    for sp, jobs, sws in ((spec, mixed, sweeps), (sspec, closed, csweeps)):
        want = [s.run_crack(resume=False) for s in sws]
        got, stats = run_engine(sp, jobs, c)
        assert stats["packed_dispatches"] == 0
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted
            assert g.superstep.get("packed") is None
    assert t_fuse.GROUP_LAUNCHES == {}


def test_churned_bytescan_group_refuses_and_pause_resumes_in_reference(
        counted):
    """Four german tenants in one group; two cancelled after two rounds:
    the survivors re-fuse (a byte-scan group again) and one of them,
    paused inside the new group, resumes in the reference package's
    engine from its checkpoint document to its solo stream; the other
    ends with its solo stream."""
    spec = AttackSpec()
    c = cfg()
    words = GERMAN_WORDS * 3
    jobs = [(GERMAN, w, planted(spec, GERMAN, w, tag=i))
            for i, w in enumerate(tenants(words, n=4))]
    want = [Sweep(spec, t, w, d, config=c).run_crack(resume=False)
            for t, w, d in jobs]
    eng = Engine(c, auto=False, refuse_below=0.9)
    handles = [eng.submit(spec, t, w, d) for t, w, d in jobs]
    eng._admit()
    assert eng.stats()["fused_groups"] == 1
    for _ in range(2):
        eng._serve_round()
    handles[0].cancel()
    handles[1].cancel()
    for _ in range(400):
        eng._serve_round()
        eng._admit(wait=True)
        st = eng.stats()
        if st["refuse_total"] and not st["jobs_refusing"]:
            break
    else:
        raise AssertionError("re-fuse never landed while work remained")
    eng._serve_round()
    handles[2].request_pause()
    eng.run_until_idle()
    assert handles[2].state == "paused"
    got3 = handles[3].result(timeout=5)
    doc = json.loads(json.dumps(state_to_doc(handles[2].checkpoint)))
    eng.close()
    assert set(t_fuse.GROUP_LAUNCHES) == {"bytescan_scalar/md5"}
    assert full_hits(got3) == full_hits(want[3])
    assert got3.n_emitted == want[3].n_emitted
    jeng = JEngine(JConfig(lanes=64, num_blocks=16, superstep=1),
                   auto=False)
    _t, w, d = jobs[2]
    resumed = jeng.submit(JSpec(), GERMAN, w, d,
                          resume_state=j_state_from_doc(doc))
    jeng.run_until_idle()
    got2 = resumed.result(timeout=5)
    jeng.close()
    assert full_hits(got2) == full_hits(want[2])
    assert got2.n_emitted == want[2].n_emitted


def test_bytescan_group_overflow_replays_per_job(counted):
    """A packed byte-scan superstep whose shared hit buffer overflows (a
    cap of 1 hit) is re-run by the group into a buffer that holds every
    hit, on the byte-scan kernel: no hit dropped, per job."""
    spec = AttackSpec()
    jobs = [(GERMAN, w, planted(spec, GERMAN, w, every=1, tag=i))
            for i, w in enumerate(tenants(GERMAN_WORDS))]
    c = cfg(superstep=4, superstep_hit_cap=1)
    want = [Sweep(spec, t, w, d, config=c).run_crack(resume=False)
            for t, w, d in jobs]
    got, stats = run_engine(spec, jobs, c)
    assert stats["packed_dispatches"] > 0
    assert any(g.superstep.get("replays", 0) > 0 for g in got)
    assert set(t_fuse.GROUP_LAUNCHES) == {"bytescan_scalar/md5"}
    assert t_fuse.GROUP_LAUNCHES["bytescan_scalar/md5"] > \
        4 * stats["packed_dispatches"]
    for g, w in zip(got, want):
        assert full_hits(g) == full_hits(w)
        assert g.n_emitted == w.n_emitted


def test_bytescan_group_faults_surface_as_the_piece_routes_do(
        counted, monkeypatch, capsys):
    """A launch error inside a packed byte-scan superstep takes the
    engine's demotion rung, as a piece group's does: counted in
    ``group_demotions``, announced on stderr, the members rebuilt solo
    from their last fetched boundaries to their solo streams.  A group
    build error fails the batch it was fusing, never a quiet solo run."""
    spec = AttackSpec()
    jobs = [(GERMAN, w, planted(spec, GERMAN, w, tag=i))
            for i, w in enumerate(tenants(GERMAN_WORDS * 2))]
    c = cfg()
    want = [Sweep(spec, t, w, d, config=c).run_crack(resume=False)
            for t, w, d in jobs]
    wrapped = t_attack.bytescan_expand
    solo_rows = len(jobs[0][1])

    def faulty(word, count, base, tables, **kw):
        if int(tables["tokens"].shape[0]) > solo_rows:
            raise ValueError("packed byte-scan launch fault")
        return wrapped(word, count, base, tables, **kw)

    monkeypatch.setattr(t_attack, "bytescan_expand", faulty)
    got, stats = run_engine(spec, jobs, c)
    assert stats["group_demotions"] == 1
    assert "packed byte-scan launch fault" in capsys.readouterr().err
    for g, w in zip(got, want):
        assert full_hits(g) == full_hits(w)
        assert g.n_emitted == w.n_emitted
    monkeypatch.setattr(t_attack, "bytescan_expand", wrapped)

    def broken(members):
        raise MemoryError("packed upload")

    monkeypatch.setattr(t_fuse, "_packed_plan_tree", broken)
    eng = Engine(c, auto=False)
    handles = [eng.submit(spec, t, w, d) for t, w, d in jobs]
    eng.run_until_idle()
    eng.close()
    assert [h.state for h in handles] == ["failed", "failed"]
    assert all(isinstance(h.error, MemoryError) for h in handles)
