"""The sweep machine protocol against the reference's, on the CPU:
candidates mode.

``Sweep.candidates_machine`` yields once at every consumed launch.  In 4
modes × the superstep drive, the per-launch pipeline and streamed chunks
of 7 words, the port's machine and the reference's are closed at
boundary ``k``: the checkpoint documents are equal but for the wall
time, the bytes written so far are equal, and each package resumes the
other's state to the rest of the stream (what was written before the
close plus what the resumed machine writes is the uninterrupted stream);
closing stops every worker thread.
"""

import io
import threading

import pytest
from test_torch_machine import DRIVES, GEOMETRY, MODES, K, _comparable
from test_torch_resume_cli import layout_for, make_words

from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime import CandidateWriter as JWriter
from hashcat_a5_table_generator_tpu.runtime import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime import SweepConfig as JConfig
from hashcat_a5_table_generator_tpu.runtime.checkpoint import (
    state_from_doc as j_from_doc,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.runtime.checkpoint import (
    state_from_doc,
    state_to_doc,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sinks import CandidateWriter
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout


def sweeps(mode, drive):
    words = make_words()[:-1]
    sub = get_layout(layout_for(mode)).to_substitution_map()
    kw = dict(GEOMETRY, **DRIVES[drive])
    return (Sweep(AttackSpec(mode=mode), sub, words, (),
                  SweepConfig(device="cpu", **kw)),
            JSweep(JSpec(mode=mode), sub, words, (), JConfig(**kw)))


def stream(sweep, writer_cls, state=None):
    buf = io.BytesIO()
    with writer_cls(stream=buf) as w:
        sweep.run_candidates(w, resume=False, state=state)
    return buf.getvalue()


def close_at(sweep, writer_cls, k):
    buf = io.BytesIO()
    w = writer_cls(stream=buf)
    m = sweep.candidates_machine(w, resume=False)
    for _ in range(k):
        next(m)
    m.close()
    w.close()
    return state_to_doc(sweep.active_state), buf.getvalue()


@pytest.mark.parametrize("drive", list(DRIVES))
@pytest.mark.parametrize("mode", MODES)
def test_candidates_machines_closed_at_k_leave_equal_states(mode, drive):
    base = set(threading.enumerate())
    t, j = sweeps(mode, drive)
    t_doc, t_out = close_at(t, CandidateWriter, K)
    j_doc, j_out = close_at(j, JWriter, K)
    assert _comparable(t_doc, t.fingerprint) == _comparable(j_doc, "")
    assert t_out == j_out and t_out
    assert not [th for th in set(threading.enumerate()) - base
                if th.is_alive() and th.name.startswith("a5-")]

    t_doc["fingerprint"] = t.fingerprint
    want = stream(sweeps(mode, drive)[1], JWriter)
    t2, j2 = sweeps(mode, drive)
    assert t_out + stream(t2, CandidateWriter,
                          state_from_doc(j_doc)) == want
    assert j_out + stream(j2, JWriter, j_from_doc(t_doc)) == want
