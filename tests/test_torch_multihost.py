"""The pod (``--coordinator``, ``--num-processes``, ``--process-id``,
``--pod-hits``, ``--giant-job``; ``parallel.multihost``) on the CPU: two
processes of the port's CLI over ``torch.distributed``'s gloo backend on
127.0.0.1, each a subprocess with a time limit of its own.

The reference's own two-process tests skip on this CPU backend
(``tests/conftest.py``: its collectives are not implemented there), so
the pod is held against the reference CLI's *single-process* stdout:
process 0's gathered stdout equals it byte for byte (crack, and the
giant job), the union of the ``--pod-hits local`` stdouts equals it,
and in candidates mode the processes' stdouts concatenated in process
order equal it.  A process killed mid-sweep makes the survivor exit 3
with the ``PeerLossError`` text instead of hanging, and relaunching the
pod resumes every stripe from its checkpoint.  ``initialize`` with no
cluster flags is one process.  The stripe arithmetic equals the
reference's.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
from test_torch_resume_cli import _disarm, run, write_inputs  # noqa: F401

import hashcat_a5_table_generator_tpu.parallel.multihost as j_mh
import hashcat_a5_table_generator_tpu_torch.parallel.multihost as t_mh
from hashcat_a5_table_generator_tpu.ops.packing import pack_words as jpack
from hashcat_a5_table_generator_tpu_torch.ops.packing import pack_words

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOMETRY = ["--lanes", "64", "--blocks", "16"]
#: Each pod process's time limit: nothing may hang the suite.
LIMIT = 110


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env(**extra):
    out = dict(os.environ)
    out["PYTHONPATH"] = str(REPO) + os.pathsep + out.get("PYTHONPATH", "")
    out.pop("A5GEN_FAULTS", None)
    out.update(extra)
    return out


def pod(argv, n=2, envs=None, extra=()):
    """``argv`` in ``n`` port processes of one pod; ``[(rc, stdout,
    stderr)]`` in process order."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hashcat_a5_table_generator_tpu_torch",
         *argv, "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n), "--process-id", str(p), *extra],
        cwd=REPO, env=(envs or {}).get(p, env()), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for p in range(n)]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=LIMIT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, o, e.decode(errors="replace")))
    return out


def hit_lines(out):
    return [ln for ln in out.splitlines() if b":" in ln]


_REF: dict = {}


def reference(key, argv, capsysbinary):
    if key not in _REF:
        rc, out, err = run("j", argv, capsysbinary)
        assert rc == 0 and out, err
        _REF[key] = out
    return _REF[key]


def crack_argv(tmp_path, mode="suball"):
    return write_inputs(tmp_path, mode) + GEOMETRY + [
        "--digests", str(tmp_path / "d.txt")]


@pytest.mark.parametrize("mode", ["default", "suball"])
def test_gathered_stdout_of_process_0_equals_single_process(
        mode, tmp_path, capsysbinary):
    argv = crack_argv(tmp_path, mode)
    want = reference(("crack", mode), argv, capsysbinary)
    (rc0, out0, err0), (rc1, out1, err1) = pod(argv)
    assert rc0 == 0 and rc1 == 0, err0 + err1
    assert out0 == want and hit_lines(out1) == []
    assert "distributed process 0/2" in err0
    n = len(want.splitlines())
    assert f"{n} hits" in err0


#: The port's CLI in a process that reports, after ``main`` returns, the
#: pod threads still alive, how many times ``destroy_process_group`` ran
#: and whether a process group is still up (fault F8: a gathered pod's
#: process 0 once aborted at interpreter exit, rc -6).
EXIT_PROBE = (
    "import json, sys, threading\n"
    "import torch.distributed as dist\n"
    "calls = []\n"
    "_destroy = dist.destroy_process_group\n"
    "def destroy(*a, **k):\n"
    "    calls.append(1)\n"
    "    return _destroy(*a, **k)\n"
    "dist.destroy_process_group = destroy\n"
    "from hashcat_a5_table_generator_tpu_torch.cli import main\n"
    "rc = main(sys.argv[1:])\n"
    "print(json.dumps({'threads': sorted(t.name for t in "
    "threading.enumerate() if t.name.startswith('a5gen-')), "
    "'destroyed': len(calls), 'initialized': dist.is_initialized()}), "
    "file=sys.stderr)\n"
    "sys.exit(rc)\n")


def test_a_gathered_pod_ends_with_its_threads_and_group_gone(
        tmp_path, capsysbinary):
    """F8: both processes of a gathered pod exit 0; when ``main``
    returns, the heartbeat and all-gather threads have stopped and the
    gloo process group was destroyed once."""
    argv = crack_argv(tmp_path, "default")
    want = reference(("crack", "default"), argv, capsysbinary)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", EXIT_PROBE, *argv, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(p)], cwd=REPO, env=env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for p in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=LIMIT))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, (_o, e) in zip(procs, outs):
        err = e.decode(errors="replace")
        assert p.returncode == 0, err
        probe = json.loads(err.strip().splitlines()[-1])
        assert probe == {"threads": [], "destroyed": 1,
                         "initialized": False}, err
    assert outs[0][0] == want and hit_lines(outs[1][0]) == []


def test_local_hits_union_equals_single_process(tmp_path, capsysbinary):
    argv = crack_argv(tmp_path)
    want = reference(("crack", "suball"), argv, capsysbinary)
    res = pod(argv, extra=["--pod-hits", "local"])
    assert all(rc == 0 for rc, _o, _e in res), res
    lines = [ln for _rc, out, _e in res for ln in hit_lines(out)]
    # The same multiset of lines: no hit missing, none printed twice
    # (two words of qwerty-azerty may print one plaintext each).
    assert sorted(lines) == sorted(want.splitlines())
    assert all(hit_lines(out) for _rc, out, _e in res)  # both stripes hit
    assert "process 0/2 stripe:" in res[0][2]


@pytest.mark.parametrize("mode", ["default", "suball"])
def test_candidates_concatenate_to_the_single_process_stream(
        mode, tmp_path, capsysbinary):
    argv = write_inputs(tmp_path, mode) + GEOMETRY
    want = reference(("candidates", mode), argv, capsysbinary)
    res = pod(argv)
    assert all(rc == 0 for rc, _o, _e in res), res
    assert res[0][1] + res[1][1] == want
    assert res[0][1] and res[1][1]


@pytest.mark.parametrize("drive", [[], ["--superstep", "off"]],
                         ids=["superstep", "per-launch"])
def test_giant_job_gathered_equals_single_process(drive, tmp_path,
                                                  capsysbinary):
    argv = crack_argv(tmp_path)
    want = reference(("crack", "suball"), argv, capsysbinary)
    (rc0, out0, err0), (rc1, out1, err1) = pod(
        argv + drive, extra=["--giant-job"])
    assert rc0 == 0 and rc1 == 0, err0 + err1
    assert out0 == want and hit_lines(out1) == []


def test_peer_loss_then_a_relaunch_resumes(tmp_path, capsysbinary):
    """Process 1 dies by SIGKILL at its third fetch; process 0 finishes
    its stripe, waits in the hit gather and exits 3, loudly; the pod
    relaunched with the same checkpoint prints the whole stream."""
    argv = crack_argv(tmp_path)
    want = reference(("crack", "suball"), argv, capsysbinary)
    flags = ["--checkpoint", str(tmp_path / "ck.json"),
             "--checkpoint-every", "0", "--superstep", "1", "--lanes", "16",
             "--blocks", "4"]
    envs = {0: env(A5GEN_DCN_TIMEOUT="5"),
            1: env(A5GEN_DCN_TIMEOUT="5",
                   A5GEN_FAULTS="superstep.fetch:kill,nth=3")}
    (rc0, out0, err0), (rc1, _o1, err1) = pod(argv + flags, envs=envs)
    assert rc1 == -9, err1
    assert rc0 == 3, err0
    assert "FATAL" in err0 and "relaunch the pod" in err0
    assert "died or stalled" in err0
    assert hit_lines(out0) == []
    assert (tmp_path / "ck.json.p0").exists()
    assert (tmp_path / "ck.json.p1").exists()
    res = pod(argv + flags, envs={0: env(A5GEN_DCN_TIMEOUT="5"),
                                  1: env(A5GEN_DCN_TIMEOUT="5")})
    assert all(rc == 0 for rc, _o, _e in res), res
    assert res[0][1] == want


def test_a_straggler_that_beats_does_not_trip_the_detector(
        tmp_path, capsysbinary):
    """Process 1 joins the pod, then sleeps well past the detection
    threshold before its sweep: its heartbeat goes on, so process 0
    waits in the gather instead of declaring it dead."""
    argv = crack_argv(tmp_path)
    want = reference(("crack", "suball"), argv, capsysbinary)
    port = free_port()
    driver = (
        "import sys, time\n"
        "from hashcat_a5_table_generator_tpu_torch.parallel import "
        "multihost\n"
        "from hashcat_a5_table_generator_tpu_torch.cli import main\n"
        "pid = int(sys.argv[1])\n"
        "if pid == 1:\n"
        f"    multihost.initialize('127.0.0.1:{port}', 2, 1)\n"
        "    time.sleep(14)\n"
        "sys.exit(main(sys.argv[2:]))\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", driver, str(p), *argv, "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(p)], cwd=REPO, env=env(A5GEN_DCN_TIMEOUT="8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for p in range(2)]
    outs = [p.communicate(timeout=LIMIT) for p in procs]
    for p, (_o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode(errors="replace")
    assert outs[0][0] == want


def test_initialize_without_cluster_flags_is_one_process(tmp_path):
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "from hashcat_a5_table_generator_tpu_torch.parallel import "
            "multihost as m\n"
            "assert m.initialize() == (0, 1)\n"
            "assert m.initialize(num_processes=1) == (0, 1)\n"
            "assert m.initialize(process_id=0) == (0, 1)\n"
            "assert m._Pod.store is None\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=env(), capture_output=True, text=True,
                       timeout=LIMIT)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_a_rendezvous_that_fails_raises(tmp_path):
    """No peer ever comes: the process fails loudly instead of running
    alone."""
    code = ("import sys\n"
            "from hashcat_a5_table_generator_tpu_torch.parallel import "
            "multihost as m\n"
            f"m.initialize('127.0.0.1:{free_port()}', 2, 1)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=env(A5GEN_DCN_TIMEOUT="3"), capture_output=True,
                       text=True, timeout=LIMIT)
    assert r.returncode != 0
    assert "could not join the pod" in r.stderr


@pytest.mark.parametrize("n", [0, 1, 7, 9, 100])
def test_stripes_equal_reference(n):
    rng = np.random.default_rng(n)
    words = [bytes(rng.integers(97, 123, size=int(rng.integers(1, 9)),
                                dtype=np.uint8)) for _ in range(n)]
    for procs in (1, 2, 3, 8):
        for p in range(procs):
            lo, hi = t_mh.host_stripe(n, procs, p)
            assert (lo, hi) == j_mh.host_stripe(n, procs, p)
            part = t_mh.stripe_packed(pack_words(words), lo, hi)
            jpart = j_mh.stripe_packed(jpack(words), lo, hi)
            assert part.words() == jpart.words() == words[lo:hi]
            assert list(part.index) == list(jpart.index)
            assert t_mh.stripe_n_words(pack_words(words), procs, p) == \
                hi - lo
    with pytest.raises(ValueError):
        t_mh.host_stripe(10, 2, 2)
