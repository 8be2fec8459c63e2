"""The fault seams, retries and the fetch watchdog of the PyTorch/CUDA
package, on the CPU.  (``test_torch_faults.py`` holds the port's faults
F1-F5 against the reference.)

* The ``A5GEN_FAULTS`` grammar parses as the reference's does, rejects
  what it rejects, and a seeded plan fires on the same calls in both.
* Killed at the same boundary with the same geometry, both packages
  leave equal checkpoint documents (``wall_s`` aside), in every mode.
* A transient fault at ``superstep.dispatch`` or ``superstep.fetch``
  (``FaultInjected``, ``FetchTimeout``) is retried inside the drive —
  superstep, per-launch and candidates — with stdout byte-identical to
  the reference's; a non-transient error is not retried; a persistent
  fault runs out of the drive's attempts and then of ``--retries``.
* The watchdog raises the typed ``FetchTimeout``; ``device.init`` and
  ``checkpoint.write`` faults take the reference's recovery.
* One CLI run in a subprocess is SIGKILLed at a boundary; its checkpoint
  reads back in both packages and resumes to the uninterrupted stdout.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
from test_torch_resume_cli import (
    GEOMETRY_ARGV,
    make_words,
    reference_stdout,
    run,
    write_inputs,
)

import hashcat_a5_table_generator_tpu.runtime.checkpoint as j_ck
import hashcat_a5_table_generator_tpu.runtime.faults as j_faults
import hashcat_a5_table_generator_tpu_torch.runtime.checkpoint as t_ck
import hashcat_a5_table_generator_tpu_torch.runtime.faults as t_faults
from hashcat_a5_table_generator_tpu.models.attack import AttackSpec as JSpec
from hashcat_a5_table_generator_tpu.runtime.sweep import Sweep as JSweep
from hashcat_a5_table_generator_tpu.runtime.sweep import (
    SweepConfig as JConfig,
)
from hashcat_a5_table_generator_tpu_torch.models.attack import AttackSpec
from hashcat_a5_table_generator_tpu_torch.runtime import telemetry
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    monkeypatch.delenv("A5GEN_FAULTS", raising=False)
    yield
    for f in (j_faults, t_faults):
        f.clear()


def crack_argv(tmp_path, mode="default", extra=()):
    return write_inputs(tmp_path, mode) + [
        "--digests", str(tmp_path / "d.txt"), *GEOMETRY_ARGV, *extra]


# ---------------------------------------------------------------------------
# The grammar and its determinism
# ---------------------------------------------------------------------------

RULE_FIELDS = ("point", "nth", "p", "error", "persist", "kill", "delay_s")


@pytest.mark.parametrize("spec", [
    "superstep.dispatch:nth=2",
    "superstep.fetch:error=FetchTimeout,p=0.2,seed=7",
    "superstep.fetch:kill,nth=3",
    "checkpoint.write:persist;device.init:nth=1,delay=0.5",
    "superstep.dispatch:error=OSError,nth=4; superstep.fetch:p=1",
])
def test_grammar_parses_as_the_reference(spec):
    got, want = t_faults.parse_plan(spec), j_faults.parse_plan(spec)
    assert got.seed == want.seed
    assert [[getattr(r, f) for f in RULE_FIELDS] for r in got.rules] == \
        [[getattr(r, f) for f in RULE_FIELDS] for r in want.rules]


@pytest.mark.parametrize("spec", [
    "", "superstep.fetchh", "superstep.fetch:error=Nope",
    "superstep.fetch:bogus=1", "superstep.fetch:nth=1,p=0.5",
    "superstep.fetch:p=2", "superstep.fetch:nth",
])
def test_grammar_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError):
        j_faults.parse_plan(spec)
    with pytest.raises(ValueError):
        t_faults.parse_plan(spec)


def test_seeded_plans_fire_on_the_same_calls():
    spec = ("superstep.fetch:p=0.3,seed=11;superstep.dispatch:nth=5,persist;"
            "checkpoint.write:nth=2")
    fired = []
    for mod in (t_faults, t_faults, j_faults):
        plan = mod.parse_plan(spec)
        for i in range(300):
            point = ("superstep.fetch", "superstep.dispatch",
                     "checkpoint.write")[i % 3]
            try:
                plan.fire(point)
            except mod.FaultError:
                pass
        fired.append(plan.fired)
    assert fired[0] == fired[1] == fired[2]
    assert ("checkpoint.write", 2) in fired[0] and len(fired[0]) > 50


def test_transient_errors_and_the_watchdog_are_typed():
    class Event:
        def __init__(self, ready):
            self.ready, self.polls = ready, 0

        def query(self):
            self.polls += 1
            return self.ready

    before = telemetry.counter("faults.fetch_timeouts").value
    stuck = Event(False)
    with pytest.raises(t_faults.FetchTimeout, match="fetch_timeout_s"):
        t_faults.await_ready(stuck, 0.02)
    assert stuck.polls > 1
    assert telemetry.counter("faults.fetch_timeouts").value == before + 1
    t_faults.await_ready(Event(True), 0.02)
    idle = Event(False)
    t_faults.await_ready(idle, None)  # no watchdog: one plain wait
    t_faults.await_ready(None, 0.02)  # CPU tensors: nothing to wait for
    assert idle.polls == 0
    assert t_faults.is_transient(t_faults.FetchTimeout("x"))
    # A real CUDA error poisons the process's context: not retried here.
    assert not t_faults.is_transient(type("AcceleratorError", (Exception,),
                                          {})("x"))
    assert not t_faults.is_transient(OSError("x"))
    assert issubclass(t_faults.WorkerDeath, BaseException) and not \
        issubclass(t_faults.WorkerDeath, Exception)


# ---------------------------------------------------------------------------
# Equal documents at the same boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["default", "reverse", "suball",
                                  "suball-reverse"])
def test_both_packages_stop_with_equal_documents(mode, tmp_path):
    sub = get_layout("qwerty-azerty" if mode.startswith("suball")
                     else "qwerty-cyrillic").to_substitution_map()
    words = make_words()[:-1]  # one width
    digests = [bytes(range(16))]
    docs = []
    for pkg, (sweep_cls, cfg_cls, spec_cls, faults) in {
        "j": (JSweep, JConfig, JSpec, j_faults),
        "t": (Sweep, SweepConfig, AttackSpec, t_faults),
    }.items():
        path = str(tmp_path / f"{pkg}.json")
        cfg = cfg_cls(lanes=256, num_blocks=16, superstep=1,
                      checkpoint_path=path, checkpoint_every_s=0.0,
                      **({"device": "cpu"} if pkg == "t" else {}))
        with faults.armed("superstep.fetch:nth=2,error=OSError"):
            with pytest.raises(OSError):
                sweep_cls(spec_cls(mode=mode), sub, words, digests,
                          config=cfg).run_crack()
        doc = json.load(open(path))
        doc.pop("wall_s")  # this run's time: written at the end only
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["cursor"]["word"] > 0


# ---------------------------------------------------------------------------
# Retries inside the drive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drive,spec", [
    ("superstep", "superstep.dispatch:nth=3"),
    ("superstep", "superstep.fetch:error=FetchTimeout,nth=2"),
    ("per-launch", "superstep.dispatch:nth=4"),
    ("per-launch", "superstep.fetch:error=FetchTimeout,nth=2"),
])
def test_transient_fault_is_retried_inside_the_drive(drive, spec, tmp_path,
                                                     capsysbinary,
                                                     monkeypatch):
    extra = ["--superstep", "2" if drive == "superstep" else "off"]
    argv = crack_argv(tmp_path, extra=extra)
    want = reference_stdout(("default", drive), argv, capsysbinary)
    before = telemetry.counter("faults.retries").value
    monkeypatch.setenv("A5GEN_FAULTS", spec)
    rc, got, err = run("t", argv, capsysbinary)
    assert rc == 0, err
    assert got == want
    assert "transient device error in the sweep drive" in err
    assert "retry 1/2" in err
    assert telemetry.counter("faults.retries").value == before + 1


def test_candidates_dispatch_fault_is_retried(tmp_path, capsysbinary,
                                              monkeypatch):
    argv = write_inputs(tmp_path, "suball") + GEOMETRY_ARGV
    want = reference_stdout(("suball", "candidates"), argv, capsysbinary)
    monkeypatch.setenv("A5GEN_FAULTS", "superstep.dispatch:nth=2")
    rc, got, err = run("t", argv, capsysbinary)
    assert rc == 0, err
    assert got == want and "retry 1/2" in err


def test_superstep_retries_rebuild_buffers_with_parity(tmp_path):
    """A retried superstep re-dispatches from the last consumed boundary
    into fresh buffer sets: hits, counts and stats as without faults."""
    sub = get_layout("qwerty-cyrillic").to_substitution_map()
    words = make_words()[:-1]
    write_inputs(tmp_path, "default")
    digests = [bytes.fromhex(d) for d in
               (tmp_path / "d.txt").read_text().split()]
    cfg = dict(device="cpu", lanes=256, num_blocks=16, superstep=1)
    want = Sweep(AttackSpec(), sub, words, digests,
                 SweepConfig(**cfg)).run_crack()
    with t_faults.armed("superstep.fetch:nth=2;superstep.dispatch:nth=6"
                        ) as plan:
        got = Sweep(AttackSpec(), sub, words, digests,
                    SweepConfig(**cfg)).run_crack()
    assert len(plan.fired) == 2
    assert [(h.word_index, h.variant_rank, h.candidate) for h in got.hits] \
        == [(h.word_index, h.variant_rank, h.candidate) for h in want.hits]
    assert got.n_emitted == want.n_emitted and got.n_hits == want.n_hits
    assert got.superstep["retries"] == 2
    assert got.superstep["supersteps"] == want.superstep["supersteps"]


def test_non_transient_error_is_not_retried(tmp_path, capsysbinary,
                                            monkeypatch):
    before = telemetry.counter("faults.retries").value
    monkeypatch.setenv("A5GEN_FAULTS", "superstep.fetch:error=OSError,nth=1")
    rc, _out, err = run("t", crack_argv(tmp_path), capsysbinary)
    assert rc == 1 and "injected fault" in err
    assert telemetry.counter("faults.retries").value == before


@pytest.mark.parametrize("drive", ["superstep", "per-launch"])
def test_persistent_fault_runs_out_of_retries(drive, tmp_path, capsysbinary,
                                              monkeypatch):
    argv = crack_argv(tmp_path, extra=[
        "--retries", "1", "--checkpoint", str(tmp_path / "ck.json"),
        "--superstep", "2" if drive == "superstep" else "off"])
    monkeypatch.setenv("A5GEN_FAULTS", "superstep.dispatch:persist")
    rc, _out, err = run("t", argv, capsysbinary)
    assert rc == 1
    # Two in-drive recoveries per attempt, then --retries' one attempt:
    # one retry layer per drive, so the budgets do not multiply.
    assert err.count("transient device error") == 4
    assert "crack sweep attempt failed (FaultInjected" in err
    assert "retry 1/1 from last checkpoint" in err


def test_candidates_retries_need_a_checkpoint(tmp_path, capsysbinary):
    argv = write_inputs(tmp_path, "default") + ["--retries", "1"]
    rc, _out, err = run("t", argv, capsysbinary)
    assert rc == 2 and "requires --checkpoint" in err


def test_device_init_fault_is_survived_by_retries(tmp_path, capsysbinary,
                                                  monkeypatch):
    argv = crack_argv(tmp_path)
    want = reference_stdout(("default", "plain"), argv, capsysbinary)
    monkeypatch.setenv("A5GEN_FAULTS", "device.init:nth=1")
    rc, got, err = run("t", argv + ["--retries", "1"], capsysbinary)
    assert rc == 0, err
    assert got == want
    assert "crack sweep attempt failed (FaultInjected" in err


def test_failed_checkpoint_write_keeps_the_last_good_file(
        tmp_path, capsysbinary, monkeypatch):
    argv = crack_argv(tmp_path, extra=["--superstep", "2"])
    want = reference_stdout(("default", "superstep"), argv, capsysbinary)
    ck = tmp_path / "ck.json"
    before = telemetry.counter("faults.checkpoint_errors").value
    monkeypatch.setenv("A5GEN_FAULTS", "checkpoint.write:nth=3")
    rc, got, err = run("t", argv + ["--checkpoint", str(ck),
                                    "--checkpoint-every", "0"],
                       capsysbinary)
    assert rc == 0, err
    assert got == want
    assert "checkpoint write failed (FaultInjected" in err
    assert telemetry.counter("faults.checkpoint_errors").value == before + 1
    doc = json.loads((tmp_path / "ck.json.w16").read_text())
    assert doc["cursor"]["rank"] == "0"  # the final write landed


# ---------------------------------------------------------------------------
# A real kill
# ---------------------------------------------------------------------------


def test_sigkilled_run_leaves_a_readable_checkpoint(tmp_path, capsysbinary):
    argv = crack_argv(tmp_path, extra=["--superstep", "1"])
    want = reference_stdout(("default", "sigkill"), argv, capsysbinary)
    ck = tmp_path / "ck.json"
    ck_argv = argv + ["--checkpoint", str(ck), "--checkpoint-every", "0"]
    env = dict(os.environ, A5GEN_FAULTS="superstep.fetch:kill,nth=4",
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
         *ck_argv, "--device", "cpu"],
        env=env, cwd=str(tmp_path), capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert want.startswith(proc.stdout) and proc.stdout != want
    docs = {}
    for name, ck_mod in (("t", t_ck), ("j", j_ck)):
        man = json.loads(ck.read_text())
        fp = man["buckets"]["16"]["fingerprint"]
        state = ck_mod.load_checkpoint(str(tmp_path / "ck.json.w16"), fp)
        assert state is not None and 0 < state.cursor.word
        docs[name] = ck_mod.state_to_doc(state)
    assert docs["t"] == docs["j"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    rc, got, err = run("t", ck_argv, capsysbinary)
    assert rc == 0, err
    assert got == want
