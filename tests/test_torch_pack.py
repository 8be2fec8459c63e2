"""Cross-job packed dispatch (``runtime/fuse.py``) against the reference,
on the CPU.

The packed device path's host arrays and kernels equal the reference's:
``ops.blocks.packed_block_index``, ``models.attack.packed_superstep_arrays``
and ``ops.membership.digest_member_seg`` (empty segments and digest sets
of unequal size included), and a packed superstep's per-job counter rows
and hits equal the reference's packed program's.  Then the counterparts
of the reference's ``tests/test_pack.py`` classes: every tenant of a
fused group gets its solo stream (itself equal to the reference's solo
stream); pause and cancel leave cohabitants alone; ``A5GEN_PACK`` and
``Engine(pack=)``; the admission worker; re-fuse after churn with its
checkpoint carry-over and env parsing; the group rides the piece
kernel's plain version, not the XLA route; pod jobs never fuse.

Geometry: the reference suite's 64 lanes × 16 blocks; tenants share one
dictionary shape (rotations of one word list), as the reference's do.
"""

import hashlib

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu_torch.models.attack as t_attack
import hashcat_a5_table_generator_tpu_torch.ops.fused_expand as t_fused
import hashcat_a5_table_generator_tpu_torch.runtime.fuse as t_fuse
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.models.attack import (
    packed_superstep_arrays as j_packed_arrays,
)
from hashcat_a5_table_generator_tpu.ops.blocks import (
    packed_block_index as j_packed_index,
)
from hashcat_a5_table_generator_tpu.ops.blocks import (
    superstep_index as j_superstep_index,
)
from hashcat_a5_table_generator_tpu.ops.membership import (
    digest_member_seg as j_member_seg,
)
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime.fuse import (
    build_fused_group as j_build_group,
)
from hashcat_a5_table_generator_tpu.runtime.fuse import (
    pack_candidate as j_pack_candidate,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import (
    AttackSpec,
    packed_superstep_arrays,
    superstep_buffers,
)
from hashcat_a5_table_generator_tpu_torch.ops.blocks import (
    packed_block_index,
    superstep_index,
)
from hashcat_a5_table_generator_tpu_torch.ops.membership import (
    build_digest_set,
    digest_member_seg,
)
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime.engine import Engine
from hashcat_a5_table_generator_tpu_torch.runtime.fuse import (
    build_fused_group,
    pack_candidate,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)

LEET = {b"a": [b"4", b"@"], b"o": [b"0"], b"s": [b"$", b"5"], b"e": [b"3"]}
WORDS = [b"password", b"sesame", b"octopus", b"zzz", b"a"]
WORDLISTS = [WORDS, WORDS[::-1], WORDS[3:] + WORDS[:3], WORDS[1:] + WORDS[:1]]
SPEC = AttackSpec(mode="default", algo="md5")


def cfg(**kw):
    return SweepConfig(device="cpu", lanes=64, num_blocks=16, **kw)


def oracle_lines(spec, words):
    out = []
    for w in words:
        out.extend(iter_candidates(
            w, LEET, spec.min_substitute, spec.max_substitute,
            substitute_all=spec.mode.startswith("suball"),
            reverse=spec.mode in ("reverse", "suball-reverse")))
    return out


def planted_digests(spec, words, picks=(0, -1), decoys=8):
    oracle = oracle_lines(spec, words)
    planted = sorted({oracle[i] for i in picks})
    digests = [hashlib.md5(c).digest() for c in planted]
    digests += [hashlib.md5(b"decoy%d" % i).digest() for i in range(decoys)]
    return planted, digests


def _jobs(n, picks=(0, -1), decoys=8, reps=1):
    out = []
    for i in range(n):
        words = WORDLISTS[i % len(WORDLISTS)] * reps
        _p, digests = planted_digests(SPEC, words, picks, decoys=decoys)
        # Per-tenant decoys: no two jobs share a digest set.
        digests += [hashlib.md5(b"tenant-%d" % i).digest()]
        out.append((words, digests))
    return out


def _solo(jobs, config):
    return [Sweep(SPEC, LEET, w, d, config=config).run_crack(resume=False)
            for w, d in jobs]


def full_hits(res):
    return [(h.word_index, h.variant_rank, h.candidate, h.digest_hex)
            for h in res.hits]


# ---------------------------------------------------------------------------
# The packed device path against the reference's
# ---------------------------------------------------------------------------


def _plans(pkg, jobs, stride=4):
    mk = (lambda w, d: Sweep(SPEC, LEET, w, d, cfg())) if pkg == "t" \
        else (lambda w, d: JSweep(JSpec(), LEET, w, d, JConfig(
            lanes=64, num_blocks=16)))
    return [mk(w, d).plan for w, d in jobs]


def test_packed_block_index_equals_reference():
    jobs = _jobs(3) + [([b"zzz", b"q"], [bytes(16)])]  # a tiny member
    t_idx = [superstep_index(p, 4) for p in _plans("t", jobs)]
    j_idx = [j_superstep_index(p, 4) for p in _plans("j", jobs)]
    got, want = packed_block_index(t_idx), j_packed_index(j_idx)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_packed_superstep_arrays_equal_reference():
    jobs = _jobs(4)
    t_plans, j_plans = _plans("t", jobs), _plans("j", jobs)
    got = packed_superstep_arrays(t_plans,
                                  [superstep_index(p, 4) for p in t_plans])
    want = j_packed_arrays(j_plans, [j_superstep_index(p, 4)
                                     for p in j_plans])
    (ss, blk, row), (j_ss, j_blk, j_row) = got, want
    np.testing.assert_array_equal(blk, j_blk)
    np.testing.assert_array_equal(row, j_row)
    assert set(ss) == set(j_ss)
    for k in ss:
        np.testing.assert_array_equal(ss[k], np.asarray(j_ss[k]))


@pytest.mark.parametrize("sizes", [(5, 40, 0, 17), (0, 0, 3), (64, 1)])
def test_digest_member_seg_equals_reference(sizes):
    """Unequal digest sets, an empty segment, probes planted from every
    segment's own set and from the others' (never a cross-tenant hit)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(sum(sizes))
    sets = [build_digest_set([rng.bytes(16) for _ in range(n)], "md5",
                             bitmap_bits=16) for n in sizes]
    rows = np.concatenate([ds.rows for ds in sets])
    bitmap = np.stack([ds.bitmap for ds in sets])
    bounds = np.cumsum([0] + [ds.rows.shape[0] for ds in sets])
    n = 512
    seg = rng.integers(0, len(sizes), n).astype(np.int32)
    probe = rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint64).astype(
        np.uint32)
    if rows.shape[0]:
        pick = rng.integers(0, rows.shape[0], n)
        own = rng.random(n) < 0.5
        probe[own] = rows[pick[own]]
    lo, hi = bounds[:-1].astype(np.int32), bounds[1:].astype(np.int32)
    got = digest_member_seg(
        torch.as_tensor(probe.view(np.int32)),
        torch.as_tensor(rows.view(np.int32)),
        torch.as_tensor(bitmap.view(np.int32)),
        torch.as_tensor(lo), torch.as_tensor(hi), torch.as_tensor(seg))
    want = j_member_seg(jnp.asarray(probe), jnp.asarray(rows),
                        jnp.asarray(bitmap), jnp.asarray(lo),
                        jnp.asarray(hi), jnp.asarray(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for j, n_j in enumerate(sizes):
        if n_j == 0:
            assert not got.numpy()[seg == j].any()


def _groups(jobs, superstep=2):
    t = [pack_candidate(Sweep(SPEC, LEET, w, d, cfg(superstep=superstep)))
         for w, d in jobs]
    j = [j_pack_candidate(JSweep(JSpec(), LEET, w, d, JConfig(
        lanes=64, num_blocks=16, superstep=superstep))) for w, d in jobs]
    assert all(c is not None for c in t + j)
    return build_fused_group(t), j_build_group(j)


def test_packed_superstep_counters_and_hits_equal_reference():
    """One packed superstep at each round's cursors, the port's group
    body beside the reference's packed program: equal ``[2, n_seg]``
    counter rows and the same packed ``(row, rank)`` hits."""
    jobs = _jobs(4, picks=(0, 3, 9, -1), reps=3)
    tg, jg = _groups(jobs)
    np.testing.assert_array_equal(tg._row_base, jg._row_base)
    snap = tg._b0.copy()
    np.testing.assert_array_equal(snap, jg._b0)
    rounds = 0
    while (snap < tg._seg_end).any():
        out = tg._body(tg._arrays[0], snap, tg.steps,
                       superstep_buffers(4096, device=torch.device("cpu")))
        j_out = jg._call(snap, jg._make_bufs())
        np.testing.assert_array_equal(out["counters"].numpy(),
                                      np.asarray(j_out["counters"]))
        nh = int(out["counters"][1].sum())
        got = sorted(zip(out["hit_word"][:nh].tolist(),
                         out["hit_rank"][:nh].tolist()))
        want = sorted(zip(np.asarray(j_out["hit_word"])[:nh].tolist(),
                          np.asarray(j_out["hit_rank"])[:nh].tolist()))
        assert got == want
        snap = np.minimum(snap + tg._adv, tg._seg_end)
        rounds += 1
    assert rounds > 1


# ---------------------------------------------------------------------------
# The reference's tests/test_pack.py classes, on the port
# ---------------------------------------------------------------------------


class TestPackedParity:
    def test_four_job_packed_byte_parity(self):
        """Four tenants fuse into one group (16 blocks / 4 segments);
        each job's hits and emitted count equal its solo run's, which
        equal the reference's solo run's; a second equal batch rides the
        cached packed step."""
        jobs = _jobs(4, picks=(0, 4, -1))
        c = cfg(superstep=2)
        want = _solo(jobs, c)
        ref = [JSweep(JSpec(), LEET, w, d, JConfig(
            lanes=64, num_blocks=16, superstep=2)).run_crack(resume=False)
            for w, d in jobs]
        for w, r in zip(want, ref):
            assert full_hits(w) == full_hits(r)
            assert w.n_emitted == r.n_emitted
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["packed_dispatches"] > 0
        assert 0 < stats["packed_fill"] <= 1.0
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted
            assert g.superstep.get("packed") == 4
        eng2 = Engine(c, auto=False)
        base = eng2.stats()["programs_compiled"]
        handles = [eng2.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng2.run_until_idle()
        assert eng2.stats()["programs_compiled"] == base
        for h, w in zip(handles, want):
            assert full_hits(h.result(timeout=0)) == full_hits(w)
        eng2.close()

    def test_auto_block_count_fuses_with_reference_streams(self):
        """An engine whose defaults leave the block count on auto (the
        config's ``num_blocks`` is None; 2048 lanes resolve to 16
        blocks): four tenants still fuse, and each one's hits and count
        equal the reference's solo run."""
        jobs = _jobs(4, picks=(0, 4, -1))
        ref = [JSweep(JSpec(), LEET, w, d, JConfig(
            lanes=2048, num_blocks=16, superstep=2)).run_crack(resume=False)
            for w, d in jobs]
        c = SweepConfig(device="cpu", lanes=2048, superstep=2)
        assert c.num_blocks is None
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["fused_groups"] >= 1
        assert stats["packed_dispatches"] > 0
        for g, r in zip(got, ref):
            assert full_hits(g) == full_hits(r)
            assert g.n_emitted == r.n_emitted
            assert g.superstep.get("packed") == 4

    def test_windowed_and_streaming_members_keep_per_job_dispatch(self):
        """A mixed burst: two packable tenants, a windowed job (another
        static structure) and a streaming job (chunked plans never pack):
        the pair fuses, the others run per job, every stream is solo."""
        wspec = AttackSpec(mode="default", algo="md5", min_substitute=1,
                           max_substitute=1)
        jobs = _jobs(2)
        _pw, wdig = planted_digests(wspec, WORDS, (0, -1))
        c, cs = cfg(), cfg(stream_chunk_words=2)
        want = _solo(jobs, c)
        wsweep = Sweep(wspec, LEET, WORDS, wdig, config=c)
        assert wsweep.plan.windowed
        want_w = wsweep.run_crack(resume=False)
        want_s = Sweep(SPEC, LEET, jobs[0][0], jobs[0][1],
                       config=cs).run_crack(resume=False)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        hw = eng.submit(wspec, LEET, WORDS, wdig)
        hs = eng.submit(SPEC, LEET, jobs[0][0], jobs[0][1], config=cs)
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        for h, w in zip(handles, want):
            got = h.result(timeout=0)
            assert full_hits(got) == full_hits(w)
            assert got.superstep.get("packed") == 2
        assert full_hits(hw.result(timeout=0)) == full_hits(want_w)
        assert "packed" not in hw.result(0).superstep
        got_s = hs.result(timeout=0)
        assert full_hits(got_s) == full_hits(want_s)
        assert got_s.stream["chunks_swept"] == want_s.stream["chunks_swept"]
        eng.close()

    def test_overflow_replays_per_job(self):
        """A packed superstep whose shared hit buffer overflows is re-run
        by the group into a buffer that holds every hit: never a dropped
        hit, per job."""
        jobs = _jobs(2, picks=(0, 1, 2, 7, -1))
        c = cfg(superstep=4, superstep_hit_cap=1)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert any(g.superstep.get("replays", 0) > 0 for g in got)
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted

    def test_uneven_members_release_early(self):
        long_words = WORDS * 4
        _ps, dsmall = planted_digests(SPEC, WORDS, (0, -1))
        _pb, dbig = planted_digests(SPEC, long_words, (1, -1))
        c = cfg(superstep=1)
        want_s = Sweep(SPEC, LEET, WORDS, dsmall,
                       config=c).run_crack(resume=False)
        want_b = Sweep(SPEC, LEET, long_words, dbig,
                       config=c).run_crack(resume=False)
        eng = Engine(c, auto=False)
        hs = eng.submit(SPEC, LEET, WORDS, dsmall)
        hb = eng.submit(SPEC, LEET, long_words, dbig)
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        got_s, got_b = hs.result(timeout=0), hb.result(timeout=0)
        eng.close()
        assert full_hits(got_s) == full_hits(want_s)
        assert full_hits(got_b) == full_hits(want_b)
        assert got_s.superstep["packed"] == got_b.superstep["packed"] == 2
        assert got_s.superstep["supersteps"] < got_b.superstep["supersteps"]

    def test_two_stripes_packed_parity(self):
        """``--device cpu --devices 2``: the group dispatches both cursor
        stripes each round; every stream is the one-stripe solo one."""
        jobs = _jobs(2, picks=(0, -1), reps=2)
        want = _solo(jobs, cfg())
        eng = Engine(cfg(devices=2), auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["packed_dispatches"] > 0
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted


    def test_pair_job_resumed_off_its_pair_stride_packs_as_k1(self):
        """A pair-tier (K=2) job whose resume cursor is aligned for K=1
        only packs as K=1, as its solo drive runs; two such tenants fuse
        and each gets its solo resumed stream."""
        from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
            CheckpointState,
            SweepCursor,
        )
        from hashcat_a5_table_generator_tpu_torch.tables.layouts import (
            get_layout,
        )

        sub = get_layout("qwerty-cyrillic").to_substitution_map()
        words = [b"passwords", b"dragonfly", b"qwertyui", b"monkeys1"] * 3
        c = SweepConfig(device="cpu", lanes=256, num_blocks=16, superstep=2)
        jobs = []
        for i in range(2):
            ws = words[i:] + words[:i]
            digests = [hashlib.md5(x).digest() for x in oracle_lines(
                SPEC, ws[:1])[::97]] + [bytes([i]) * 16]
            jobs.append((ws, digests))
        probe = Sweep(SPEC, sub, jobs[0][0], jobs[0][1], config=c)
        fresh = pack_candidate(probe)
        assert fresh["pair_k"] == 2 and fresh["stride"] == 32
        states = []
        for ws, d in jobs:
            fp = Sweep(SPEC, sub, ws, d, config=c).fingerprint
            states.append(CheckpointState(fingerprint=fp,
                                          cursor=SweepCursor(2, 16)))
        cand = pack_candidate(probe, states[0])
        assert cand["pair_k"] is None and cand["stride"] == 16
        want = [Sweep(SPEC, sub, ws, d, config=c).run_crack(
            resume=False, state=st) for (ws, d), st in zip(jobs, states)]
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, sub, ws, d, resume_state=st)
                   for (ws, d), st in zip(jobs, states)]
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        for h, w in zip(handles, want):
            g = h.result(timeout=0)
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted
            assert g.superstep.get("packed") == 2
            assert g.superstep.get("pair") == 0
        eng.close()


class TestTenantControl:
    def test_pause_mid_fused_dispatch_leaves_cohabitants(self):
        jobs = _jobs(4, picks=(0, -1))
        c = cfg(superstep=1)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng._admit()
        assert eng.stats()["fused_groups"] == 1
        eng._serve_round()
        victim = handles[1]
        victim.request_pause()
        eng.run_until_idle()
        assert victim.state == "paused"
        ck = victim.checkpoint
        assert ck is not None and ck.fingerprint
        for i, h in enumerate(handles):
            if i != 1:
                got = h.result(timeout=0)
                assert full_hits(got) == full_hits(want[i])
                assert got.n_emitted == want[i].n_emitted
        eng2 = Engine(c, auto=False)
        w, d = jobs[1]
        resumed = eng2.submit(SPEC, LEET, w, d, resume_state=ck)
        eng2.run_until_idle()
        got = resumed.result(timeout=0)
        assert full_hits(got) == full_hits(want[1])
        assert got.n_emitted == want[1].n_emitted
        eng.close()
        eng2.close()

    def test_cancel_mid_fused_dispatch_keeps_cohabitants(self):
        jobs = _jobs(2, picks=(0, -1))
        c = cfg(superstep=1)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng._admit()
        eng._serve_round()
        handles[0].cancel()
        eng.run_until_idle()
        assert handles[0].state == "cancelled"
        got = handles[1].result(timeout=0)
        assert full_hits(got) == full_hits(want[1])
        assert got.n_emitted == want[1].n_emitted
        eng.close()

    def test_span_attribution_under_fused_dispatch(self):
        jobs = _jobs(2, picks=(0,))
        eng = Engine(cfg(superstep=2), auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        for h in handles:
            res = h.result(timeout=0)
            assert h.span_summary["spans"] == res.superstep["supersteps"] > 0
            assert h.span_summary["host_gap_s"] >= 0.0
        eng.close()


class TestPackKnobs:
    def test_pack_off_restores_per_job_dispatch(self, monkeypatch):
        monkeypatch.setenv("A5GEN_PACK", "off")
        jobs = _jobs(2, picks=(0, -1))
        c = cfg(superstep=2)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["packed_dispatches"] == 0
        assert stats["fused_groups"] == 0
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert "packed" not in g.superstep

    def test_engine_pack_false_overrides_env(self):
        eng = Engine(cfg(superstep=2), auto=False, pack=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in _jobs(2)]
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] == 0
        for h in handles:
            h.result(timeout=0)
        eng.close()

    def test_pack_on_wins_over_the_env_hatch(self, monkeypatch):
        """``--pack on`` (``Engine(pack=True)``) with ``A5GEN_PACK=off``
        packs, as in the reference (the explicit setting wins)."""
        monkeypatch.setenv("A5GEN_PACK", "off")
        eng = Engine(cfg(superstep=2), auto=False, pack=True)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in _jobs(2)]
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        for h in handles:
            h.result(timeout=0)
        eng.close()


class TestAdmissionWorker:
    def test_build_error_propagates_and_engine_survives(self):
        jobs = _jobs(2, picks=(0,))
        c = cfg(superstep=2)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        bad = eng.submit(SPEC, LEET, [b"ok", "not-bytes"], jobs[0][1])
        eng.run_until_idle()
        assert bad.state == "failed" and bad.error is not None
        with pytest.raises(Exception):
            bad.result(timeout=0)
        for h, w in zip(handles, want):
            assert full_hits(h.result(timeout=0)) == full_hits(w)
        eng.close()

    def test_builds_run_off_the_serve_thread(self):
        eng = Engine(cfg(), auto=False)
        assert eng._admit_ex is not None
        h = eng.submit(SPEC, LEET, *_jobs(1, picks=(0,))[0])
        eng._admit(wait=False)
        eng.run_until_idle()
        h.result(timeout=0)
        eng.close()

    def test_close_drains_pending_builds(self):
        eng = Engine(cfg(superstep=2), auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in _jobs(3)]
        eng.close()
        for h in handles:
            assert h.wait(timeout=30) and h.state == "done"

    def test_close_cancel_drops_building_jobs(self):
        eng = Engine(cfg(superstep=2), auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in _jobs(3)]
        eng.close(cancel=True)
        for h in handles:
            assert h.wait(timeout=30)
            assert h.state in ("cancelled", "done")

    def test_sync_admission_mode(self):
        jobs = _jobs(2, picks=(0, -1))
        c = cfg(superstep=2)
        want = _solo(jobs, c)
        eng = Engine(c, auto=False, admission_worker=False)
        assert eng._admit_ex is None
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        for h, w in zip(handles, want):
            assert full_hits(h.result(timeout=0)) == full_hits(w)
        eng.close()


_CHURN: dict = {}


def _churn_fixture(c, n=4, reps=4):
    key = (c.lanes, c.num_blocks, c.superstep, n, reps)
    if key not in _CHURN:
        jobs = _jobs(n, picks=(0, -1), decoys=4, reps=reps)
        _CHURN[key] = (jobs, _solo(jobs, c))
    return _CHURN[key]


def _drive_until_idle(eng, max_rounds=400):
    for _ in range(max_rounds):
        eng._serve_round()
        eng._admit(wait=True)  # collects the off-thread re-fuse builds
        if not eng.stats()["jobs_active"]:
            return
    raise AssertionError("engine did not drain")


class TestRefuse:
    def test_refuse_retraces_survivors_byte_exact(self):
        c = cfg(superstep=1)
        jobs, want = _churn_fixture(c)
        eng = Engine(c, auto=False, refuse_below=0.9)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng._admit()
        assert eng.stats()["fused_groups"] == 1
        for _ in range(2):
            eng._serve_round()
        handles[0].cancel()
        handles[1].cancel()
        _drive_until_idle(eng)
        st = eng.stats()
        got = [handles[i].result(timeout=5) for i in (2, 3)]
        eng.close()
        assert st["refuse_total"] >= 1
        assert 0.0 < st["packed_fill_min"] < 1.0
        assert st["packed_fill_last"] > 0.0
        assert handles[0].state == handles[1].state == "cancelled"
        for g, w in zip(got, (want[2], want[3])):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted

    def test_refuse_disabled_keeps_thinned_group(self):
        c = cfg(superstep=1)
        jobs, want = _churn_fixture(c)
        eng = Engine(c, auto=False, refuse_below=0)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng._admit()
        for _ in range(2):
            eng._serve_round()
        handles[0].cancel()
        handles[1].cancel()
        _drive_until_idle(eng)
        st = eng.stats()
        got = [handles[i].result(timeout=5) for i in (2, 3)]
        eng.close()
        assert st["refuse_total"] == 0
        assert 0.0 < st["packed_fill_min"] < 1.0
        for g, w in zip(got, (want[2], want[3])):
            assert full_hits(g) == full_hits(w)

    def test_refuse_checkpoint_carry_over(self):
        """A survivor paused after riding the re-fused group resumes on a
        second engine to its solo stream; the survivors got ``refused``
        notifications on their queues."""
        from hashcat_a5_table_generator_tpu_torch.runtime.engine import (
            _CtlEvent,
        )

        c = cfg(superstep=1)
        jobs, want = _churn_fixture(c)
        eng = Engine(c, auto=False, refuse_below=0.9)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng._admit()
        for _ in range(2):
            eng._serve_round()
        handles[0].cancel()
        handles[1].cancel()
        landed = False
        for _ in range(400):
            eng._serve_round()
            eng._admit(wait=True)
            st = eng.stats()
            if st["refuse_total"] and not st["jobs_refusing"]:
                landed = True
                break
        assert landed, "re-fuse never landed while work remained"
        eng._serve_round()
        handles[2].request_pause()
        eng.run_until_idle()
        assert handles[2].state == "paused"
        ck = handles[2].checkpoint
        got3 = handles[3].result(timeout=5)
        assert full_hits(got3) == full_hits(want[3])
        ctl = [r for r in handles[3]._iter_records()
               if isinstance(r, _CtlEvent)]
        assert ctl and ctl[0].kind == "refused"
        assert ctl[0].fields["jobs"] == 2
        eng.close()
        eng2 = Engine(c, auto=False)
        resumed = eng2.submit(SPEC, LEET, jobs[2][0], jobs[2][1],
                              resume_state=ck)
        eng2.run_until_idle()
        got2 = resumed.result(timeout=5)
        eng2.close()
        assert full_hits(got2) == full_hits(want[2])
        assert got2.n_emitted == want[2].n_emitted

    def test_refuse_threshold_env_parsing(self, monkeypatch):
        from hashcat_a5_table_generator_tpu_torch.runtime.env import (
            refuse_scope,
            refuse_threshold,
        )

        monkeypatch.delenv("A5GEN_REFUSE", raising=False)
        assert refuse_threshold() == 0.5 and refuse_scope() == "cross"
        for off in ("off", "0", "no"):
            monkeypatch.setenv("A5GEN_REFUSE", off)
            assert refuse_threshold() is None
        monkeypatch.setenv("A5GEN_REFUSE", "0.8")
        assert refuse_threshold() == 0.8
        monkeypatch.setenv("A5GEN_REFUSE", "within:0.3")
        assert refuse_threshold() == 0.3 and refuse_scope() == "within"
        for bad in ("1.5", "-1", "nonsense"):
            monkeypatch.setenv("A5GEN_REFUSE", bad)
            assert refuse_threshold() == 0.5


class TestPackedPallasFastPath:
    def test_packed_group_rides_the_piece_kernel(self, monkeypatch):
        """The counterpart of the reference's fused-kernel test: a packed
        group launches the piece kernel's wrapper (on the CPU its plain
        version), never the XLA expand + hash route."""
        calls = {"piece": 0, "xla": 0}
        real_piece, real_hash = t_attack.fused_expand_md5, t_attack.buffer_hash

        def piece(*a, **kw):
            # Counted as the CUDA wrapper counts its launches, so the
            # group's share of them (``fuse.GROUP_LAUNCHES``) shows here.
            calls["piece"] += 1
            t_fused.LAUNCHES["piece_k1/md5"] += 1
            return real_piece(*a, **kw)

        def xla(*a, **kw):
            calls["xla"] += 1
            return real_hash(*a, **kw)

        monkeypatch.setattr(t_attack, "fused_expand_md5", piece)
        monkeypatch.setattr(t_attack, "buffer_hash", xla)
        monkeypatch.setattr(t_fused, "LAUNCHES", dict(t_fused.LAUNCHES))
        monkeypatch.setattr(t_fuse, "GROUP_LAUNCHES", {})
        jobs = _jobs(2, picks=(0, -1))
        c = cfg(superstep=1)
        probe = Sweep(SPEC, LEET, jobs[0][0], jobs[0][1], config=c)
        assert probe.route == "piece"
        want = _solo(jobs, c)
        assert t_fuse.GROUP_LAUNCHES == {}
        calls["piece"] = 0
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["packed_dispatches"] > 0
        assert calls["piece"] > 0 and calls["xla"] == 0
        # Every launch of the engine's run was a packed superstep's: one
        # a step (superstep 1) of each packed dispatch.
        assert t_fuse.GROUP_LAUNCHES == {"piece_k1/md5": calls["piece"]}
        assert calls["piece"] == stats["packed_dispatches"]
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.superstep.get("packed") == 2
            assert set(g.kernels) == set(w.kernels)
            assert all(k.startswith("piece_") for k in g.kernels)

    def test_xla_route_members_fuse_with_shifted_value_tables(
            self, monkeypatch):
        """``A5GEN_PALLAS=off`` puts the plans on the XLA expand + hash
        route; two tenants with different tables fuse, each job's value-row
        pointers shifted by its value-table base in the packed table."""
        monkeypatch.setenv("A5GEN_PALLAS", "off")
        other = {**LEET, b"a": [b"4", b"&"], b"s": [b"z", b"5"]}
        words = WORDS
        c = cfg(superstep=1)
        jobs = [(words, planted_digests(SPEC, words, (0, -1))[1]),
                (words[::-1], [hashlib.md5(b"p&zzw0rd").digest(),
                               hashlib.md5(b"z3z&m3").digest()])]
        tables = [LEET, other]
        sweeps = [Sweep(SPEC, t, w, d, config=c)
                  for t, (w, d) in zip(tables, jobs)]
        assert all(s.route == "xla" for s in sweeps)
        cands = [pack_candidate(s) for s in sweeps]
        assert cands[0]["key"] == cands[1]["key"]
        want = [s.run_crack(resume=False) for s in
                (Sweep(SPEC, t, w, d, config=c)
                 for t, (w, d) in zip(tables, jobs))]
        eng = Engine(c, auto=False)
        handles = [eng.submit(SPEC, t, w, d)
                   for t, (w, d) in zip(tables, jobs)]
        eng.run_until_idle()
        assert eng.stats()["packed_dispatches"] > 0
        for h, w in zip(handles, want):
            g = h.result(timeout=0)
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted
            assert g.superstep.get("packed") == 2
        eng.close()


def test_packed_value_tables_pad_and_shift():
    """The XLA route's packed value table: narrow rows zero-padded to the
    widest member's width, each member's value-row pointers shifted by
    its base; the other per-word arrays stacked."""
    from hashcat_a5_table_generator_tpu_torch.runtime.fuse import (
        _packed_plan_tree,
    )

    def member(vb, starts):
        vb = torch.as_tensor(np.asarray(vb, np.uint8))
        return {"arrays": {
            "val_bytes": vb,
            "val_len": torch.full((vb.shape[0],), vb.shape[1],
                                  dtype=torch.int32),
            "match_val_start": torch.as_tensor(np.asarray(starts,
                                                          np.int32)),
            "radix": torch.ones((len(starts), 2), dtype=torch.int32)}}

    tree = _packed_plan_tree([member([[1], [2], [3]], [[0, 1], [2, 0]]),
                              member([[4, 5], [6, 7]], [[1, 0]])])
    assert tree["val_bytes"].tolist() == [[1, 0], [2, 0], [3, 0], [4, 5],
                                          [6, 7]]
    assert tree["val_len"].tolist() == [1, 1, 1, 2, 2]
    assert tree["match_val_start"].tolist() == [[0, 1], [2, 0], [4, 3]]
    assert tree["radix"].shape == (3, 2)


class TestPodNeverFuses:
    def test_pack_candidate_refuses_pod_sweeps(self):
        ((words, digests),) = _jobs(1)
        assert pack_candidate(Sweep(SPEC, LEET, words, digests,
                                    config=cfg(superstep=2))) is not None
        assert pack_candidate(Sweep(SPEC, LEET, words, digests,
                                    config=cfg(superstep=2,
                                               pod=(0, 2)))) is None

    def test_pod_jobs_demote_to_solo_byte_exact(self):
        jobs = _jobs(2)
        c = cfg(superstep=2, pod=(0, 2))
        want = _solo(jobs, c)
        eng = Engine(c, auto=False, pack=True)
        handles = [eng.submit(SPEC, LEET, w, d) for w, d in jobs]
        eng.run_until_idle()
        stats = eng.stats()
        got = [h.result(timeout=0) for h in handles]
        eng.close()
        assert stats["packed_dispatches"] == 0
        for g, w in zip(got, want):
            assert full_hits(g) == full_hits(w)
            assert g.n_emitted == w.n_emitted
            assert g.superstep.get("packed") is None
