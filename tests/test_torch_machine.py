"""The sweep machine protocol against the reference's, on the CPU: crack
mode.

``Sweep.crack_machine`` yields once at every consumed fetch boundary (a
superstep, a per-launch chunk drain, a streamed chunk's boundary).  In 4
modes × the superstep drive, the per-launch pipeline and streamed chunks
of 7 words, the port's machine and the reference's are closed at
boundary ``k``: the checkpoint documents (``state_to_doc``) are equal
but for the wall time; each package resumes the other's state to the
uninterrupted stream; closing stops every worker thread (the chunk
compiler and the fallback producer); ``run_crack`` is the machine
exhausted.  (Candidates mode: ``test_torch_machine_candidates.py``.)
"""

import hashlib
import threading

import pytest
from test_torch_resume_cli import layout_for, make_words

from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime.checkpoint import (
    state_from_doc as j_from_doc,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.oracle.engines import (
    iter_candidates,
)
from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
    state_from_doc,
    state_to_doc,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

MODES = ("default", "reverse", "suball", "suball-reverse")
#: drive -> SweepConfig fields (both packages).  The per-launch pipeline
#: drains one launch a boundary (``fetch_chunk`` 1): its chunk length
#: otherwise adapts to wall time, and the reference's first launch
#: compiles.
DRIVES = {"superstep": {"superstep": 2, "stream_chunk_words": "off"},
          "per-launch": {"superstep": 0, "stream_chunk_words": "off",
                         "fetch_chunk": 1},
          "streamed": {"superstep": 2, "stream_chunk_words": 7}}
GEOMETRY = {"lanes": 256, "num_blocks": 16}
#: the boundary each machine is closed at
K = 2


def inputs(mode):
    """Words (the qwerty-azerty fallback words among them), the table and
    an MD5 digest list planted from every third word."""
    words = make_words()[:-1]
    sub = get_layout(layout_for(mode)).to_substitution_map()
    sa, rv = mode.startswith("suball"), mode.endswith("reverse")
    digests = []
    for w in words[::3]:
        cands = list(iter_candidates(w, sub, 0, 15, substitute_all=sa,
                                     reverse=rv, bug_compat=False))
        if cands:
            digests.append(hashlib.md5(cands[len(cands) // 2]).digest())
    digests += [hashlib.md5(b"decoy%d" % i).digest() for i in range(8)]
    return words, sub, digests


def sweeps(mode, drive):
    words, sub, digests = inputs(mode)
    kw = dict(GEOMETRY, **DRIVES[drive])
    return (Sweep(AttackSpec(mode=mode), sub, words, digests,
                  SweepConfig(device="cpu", **kw)),
            JSweep(JSpec(mode=mode), sub, words, digests, JConfig(**kw)))


def hits(res):
    return [(h.word_index, h.variant_rank, h.candidate, h.digest_hex)
            for h in res.hits]


def close_at(sweep, k):
    """Advance ``sweep``'s crack machine ``k`` boundaries and close it;
    its state's document."""
    m = sweep.crack_machine(resume=False)
    for _ in range(k):
        next(m)
    m.close()
    return state_to_doc(sweep.active_state)


def _comparable(doc, fingerprint):
    doc = dict(doc, fingerprint=doc["fingerprint"] or fingerprint)
    doc.pop("wall_s")
    return doc


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("mode", MODES)
def test_machines_closed_at_k_leave_equal_states(mode, drive):
    base = set(threading.enumerate())
    t, j = sweeps(mode, drive)
    t_doc, j_doc = close_at(t, K), close_at(j, K)
    assert j_doc["wall_s"] > 0 and t_doc["wall_s"] > 0
    assert _comparable(t_doc, t.fingerprint) == _comparable(j_doc, "")
    assert t_doc["cursor"] != {"word": 0, "rank": "0"}
    # Closing stopped the chunk compiler and the fallback producer.
    assert not [th for th in set(threading.enumerate()) - base
                if th.is_alive() and th.name.startswith("a5-")]

    # Each package resumes the other's state to the whole stream.
    t_doc["fingerprint"] = t.fingerprint
    full_t, full_j = sweeps(mode, drive)
    want = hits(full_j.run_crack(resume=False))
    assert hits(full_t.run_crack(resume=False)) == want
    t2, j2 = sweeps(mode, drive)
    assert hits(t2.run_crack(resume=False,
                             state=state_from_doc(j_doc))) == want
    res = j2.run_crack(resume=False, state=j_from_doc(t_doc))
    assert hits(res) == want and res.resumed


@pytest.mark.parametrize("drive", list(DRIVES))
def test_machine_yields_at_every_consumed_boundary(drive):
    """The machine's boundary count is the reference's, and the state at
    every yield is the reference's (the last boundary and the end
    included)."""
    t, j = sweeps("default", drive)
    tm, jm = t.crack_machine(resume=False), j.crack_machine(resume=False)
    n = 0
    while True:
        try:
            next(jm)
        except StopIteration as done:
            j_res = done.value
            with pytest.raises(StopIteration) as t_done:
                next(tm)
            break
        next(tm)
        n += 1
        assert _comparable(state_to_doc(t.active_state), t.fingerprint) \
            == _comparable(state_to_doc(j.active_state), "")
    assert n > K
    assert hits(t_done.value.value) == hits(j_res)
    assert t_done.value.value.n_emitted == j_res.n_emitted
