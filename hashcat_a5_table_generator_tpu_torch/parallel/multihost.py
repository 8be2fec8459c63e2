"""Several processes, one sweep: the reference's multi-host runtime
(``parallel/multihost.py``) over ``torch.distributed``.

Two pods, as in the reference:

* **word stripes** (:func:`run_crack_multihost`,
  :func:`run_candidates_multihost`): the dictionary is cut into
  contiguous stripes, one per process (each length bucket on its own,
  :func:`host_stripe`); each process sweeps its stripe on its own
  devices and checkpoints its own cursor at ``PATH.p<id>``;
* **the giant job** (:func:`run_crack_giant`): every process sweeps the
  whole dictionary and owns its cursor stripes of every launch
  (``SweepConfig.pod``, ``parallel.devices``); the cursor stays the
  global one.

Only hit records, counters and telemetry snapshots cross between the
processes, at the end of a sweep, as host all-gathers; candidates never
do.  They ride the **gloo** backend of ``torch.distributed``: the
collectives are host objects, not device tensors, so NCCL would buy
nothing, and gloo lets two processes share one GPU and the tests run on
the CPU.  ``--pod-hits gathered`` (``gather=True``) gathers the hits and
process 0 prints them in the single-process stream's order;
``--pod-hits local`` (``gather=False``) has each process print its own
stripe's hits and runs no collective at all.

Liveness: the rendezvous's ``TCPStore`` (hosted by process 0) also
carries a heartbeat counter per process, published every
:data:`_HB_INTERVAL` seconds by a daemon thread.  A process waiting in a
collective polls its peers' counters; one frozen for longer than
``A5GEN_DCN_TIMEOUT`` seconds (default 600, ``0`` disables) — or a
collective that fails because a peer's connection closed — raises
:class:`PeerLossError` with the reference's recovery text.  A straggler
still sweeping keeps beating and never trips it.  Recovery is a
relaunch: each stripe resumes from its own checkpoint.

Leaving: a pod that ends normally calls :func:`shutdown`, which marks
the process done in the store, has process 0 (the store's host) wait for
its peers' marks, stops the heartbeat thread and destroys the process
group, so no pod thread or gloo context is left for the interpreter's
exit to tear down.  ``--pod-hits local`` leaves through
:func:`pod_local_done_exit` (``os._exit(0)``) and a lost peer through
``os._exit(3)``: neither waits on a peer that may be dead.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import replace
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.packing import PackedWords
from ..runtime.env import env_warn_once, read_env

__all__ = [
    "PeerLossError",
    "pod_local_done_exit",
    "initialize",
    "shutdown",
    "host_stripe",
    "stripe_packed",
    "stripe_n_words",
    "gather_hits",
    "allgather_sum",
    "allgather_max",
    "allgather_metrics",
    "run_crack_multihost",
    "run_crack_giant",
    "run_candidates_multihost",
]

#: Seconds without a heartbeat change from a peer before a process
#: waiting in a collective gives up (``A5GEN_DCN_TIMEOUT``; ``0``
#: disables the guard).
_DEFAULT_DCN_TIMEOUT = 600.0

#: Seconds between heartbeat publications.
_HB_INTERVAL = 5.0

_HB_PREFIX = "a5gen/hb/"
_DONE_PREFIX = "a5gen/done/"

#: How long a collective may wait on the gloo side: a straggler's stripe
#: may take this long; the heartbeat detects a dead peer long before.
_COLLECTIVE_TIMEOUT = timedelta(days=7)

_RECOVERY = (
    "This host's stripe cursor is checkpointed independently "
    "(--checkpoint PATH.p<id>); relaunch the pod with the same flags "
    "to resume all stripes from their last checkpoints — "
    "already-reported hits are deduped on resume. A5GEN_DCN_TIMEOUT "
    "adjusts the detection threshold (0 disables)."
)


class PeerLossError(RuntimeError):
    """A peer process died or stalled while this one waited in a
    collective: its heartbeat froze for longer than ``A5GEN_DCN_TIMEOUT``
    or its connection closed.  Recovery is a relaunch of the pod with the
    same flags; every stripe resumes from its own checkpoint and hits
    already reported are deduped."""


class _Pod:
    """This process's view of the pod: its rank, the pod's size and the
    rendezvous's address (the heartbeat store lives there)."""

    pid = 0
    nprocs = 1
    host: Optional[str] = None
    port: Optional[int] = None
    store = None  # the rendezvous TCPStore (process 0 hosts it)
    hb_thread: Optional[threading.Thread] = None
    hb_stop: Optional[threading.Event] = None
    #: the last all-gather's collective thread (joined by :func:`shutdown`)
    gather_thread: Optional[threading.Thread] = None


def _client():
    """A TCPStore client of its own for the calling thread's heartbeat or
    liveness reads (None outside a pod)."""
    if _Pod.host is None:
        return None
    from torch.distributed import TCPStore

    return TCPStore(_Pod.host, _Pod.port, is_master=False,
                    wait_for_workers=False, timeout=timedelta(seconds=30))


def _try_get(store, key: str) -> Optional[bytes]:
    try:
        return store.get(key) if store.check([key]) else None
    except Exception:  # noqa: BLE001 — the store's host is gone
        return None


def _start_heartbeat() -> None:
    """Publish this process's liveness counter until :func:`shutdown`
    stops it (a daemon thread: a frozen counter is a dead process)."""
    if _Pod.hb_thread is not None and _Pod.hb_thread.is_alive():
        return
    key = f"{_HB_PREFIX}{_Pod.pid}"
    stop = threading.Event()

    def _beat() -> None:
        try:
            store = _client()
        except Exception:  # noqa: BLE001 — the pod is already gone
            return
        n = 0
        while not stop.is_set():
            try:
                store.set(key, str(n))
            except Exception:  # noqa: BLE001 — the store's host exited
                return
            n += 1
            stop.wait(_HB_INTERVAL)

    _Pod.hb_stop = stop
    _Pod.hb_thread = threading.Thread(target=_beat, daemon=True,
                                      name="a5gen-heartbeat")
    _Pod.hb_thread.start()


def _dcn_timeout() -> float:
    """``A5GEN_DCN_TIMEOUT`` in seconds; a malformed value warns (at
    :func:`initialize`, not at the first collective) and keeps the
    default."""
    raw = read_env("A5GEN_DCN_TIMEOUT")
    if raw is None or raw == "":
        return _DEFAULT_DCN_TIMEOUT
    try:
        return float(raw)
    except ValueError:
        env_warn_once(
            "A5GEN_DCN_TIMEOUT", raw,
            f"invalid A5GEN_DCN_TIMEOUT={raw!r} "
            f"(want seconds); using {_DEFAULT_DCN_TIMEOUT:.0f}",
        )
        return _DEFAULT_DCN_TIMEOUT


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the pod: a gloo process group whose rendezvous is a
    ``TCPStore`` at ``coordinator_address`` (``HOST:PORT``; process 0
    hosts it).  Returns ``(process_id, num_processes)``.

    With no argument, or an explicit single-process topology
    (``num_processes`` 1, no coordinator), it is one process: ``(0, 1)``,
    as in the reference when no cluster is found.  A rendezvous that
    fails raises: it never carries on as one process.  Safe to call
    again (returns the live topology)."""
    _dcn_timeout()  # validate the knob at start-up
    if _Pod.nprocs > 1:
        return _Pod.pid, _Pod.nprocs
    if coordinator_address is None and (num_processes or 1) <= 1:
        return 0, 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a pod needs --coordinator HOST:PORT, --num-processes N and "
            "--process-id I together")
    n, pid = int(num_processes), int(process_id)
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range for {n}")
    if n == 1:
        return 0, 1
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator must be HOST:PORT, got "
                         f"{coordinator_address!r}")
    import torch.distributed as dist

    wait = _dcn_timeout()
    try:
        store = dist.TCPStore(
            host, int(port), n, is_master=pid == 0,
            timeout=timedelta(seconds=wait if wait > 0 else 600),
            wait_for_workers=True)
        dist.init_process_group("gloo", store=store, rank=pid,
                                world_size=n, timeout=_COLLECTIVE_TIMEOUT)
    except Exception as e:  # noqa: BLE001 — reported with the topology
        raise RuntimeError(
            f"process {pid} of {n} could not join the pod at "
            f"{coordinator_address}: {type(e).__name__}: {e}") from e
    _Pod.pid, _Pod.nprocs = pid, n
    _Pod.host, _Pod.port, _Pod.store = host, int(port), store
    _start_heartbeat()
    return pid, n


def _mark_done() -> None:
    """This process's done mark in the store (a write, not a barrier)."""
    if _Pod.store is not None:
        try:
            _Pod.store.set(f"{_DONE_PREFIX}{_Pod.pid}", "1")
        except Exception:  # noqa: BLE001 — the store's host is gone
            pass


def _await_peers() -> None:
    """Process 0, which hosts the store, stays until every peer has
    marked itself done or is dead (heartbeat frozen past
    ``A5GEN_DCN_TIMEOUT``; ``0`` waits on done marks only).  Other
    processes return at once."""
    pid, nprocs, store = _Pod.pid, _Pod.nprocs, _Pod.store
    if pid != 0 or nprocs <= 1 or store is None:
        return
    threshold = _dcn_timeout()
    seen: dict = {}
    pending = set(range(1, nprocs))
    notified = False
    while pending:
        for p in list(pending):
            if _try_get(store, f"{_DONE_PREFIX}{p}") is not None:
                pending.discard(p)
        if not pending:
            break
        if threshold > 0:
            dead = _stale_peer(store, seen, nprocs, pid, threshold,
                               only=pending)
            if dead is not None:
                pending.discard(dead)
                print(f"a5gen: process 0: peer {dead} died mid-sweep; "
                      "its stripe needs a relaunch (resumes from its "
                      "own --checkpoint)", file=sys.stderr)
                continue
        if not notified:
            notified = True
            print(f"a5gen: process 0: stripe done; staying up as "
                  f"coordination host for {len(pending)} working "
                  "peer(s)", file=sys.stderr)
        time.sleep(0.2)


def pod_local_done_exit() -> None:
    """``--pod-hits local``'s exit: a dead peer must never block a
    survivor, so no closing barrier runs.  Every process marks itself
    done in the store (a write, not a barrier); process 0, which hosts
    the store, stays until every peer is done or dead
    (:func:`_await_peers`), then every process leaves through
    ``os._exit(0)``."""
    _mark_done()
    _await_peers()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def shutdown(wait_peers: bool = True) -> None:
    """Leave the pod at the end of a run: mark this process done, let
    process 0 (the store's host) wait for its peers' marks
    (``wait_peers``; a run that failed does not wait), stop the
    heartbeat thread, join the last all-gather's thread and destroy the
    gloo process group.  Afterwards the process is a single process
    again.  A no-op outside a pod."""
    if _Pod.nprocs <= 1:
        return
    import torch.distributed as dist

    _mark_done()
    if wait_peers:
        _await_peers()
    if _Pod.hb_stop is not None:
        _Pod.hb_stop.set()
    for th in (_Pod.hb_thread, _Pod.gather_thread):
        # The heartbeat wakes at once; a store write in flight ends
        # within the client's 30 s timeout.
        if th is not None:
            th.join(35.0)
    if dist.is_initialized():
        dist.destroy_process_group()
    _Pod.pid, _Pod.nprocs = 0, 1
    _Pod.host = _Pod.port = _Pod.store = None
    _Pod.hb_thread = _Pod.hb_stop = _Pod.gather_thread = None


def _stale_peer(store, seen: dict, nprocs: int, self_pid: int,
                threshold: float,
                only: "Optional[set]" = None) -> Optional[int]:
    """A peer whose heartbeat has not changed for ``threshold`` seconds,
    or None.  ``seen`` carries ``(value, time of the last change)``
    between polls: values, not clocks, so skew does not matter; a peer
    whose key never appears is stale from the first poll."""
    now = time.monotonic()
    for p in (sorted(only) if only is not None else range(nprocs)):
        if p == self_pid:
            continue
        v = _try_get(store, f"{_HB_PREFIX}{p}")
        rec = seen.get(p)
        if rec is None or rec[0] != v:
            seen[p] = (v, now)
        elif now - rec[1] > threshold:
            return p
    return None


def host_stripe(n_words: int, num_processes: int, process_id: int
                ) -> Tuple[int, int]:
    """Contiguous balanced stripe ``[lo, hi)`` of ``n_words`` for one
    process: the first ``n_words % num_processes`` get one word more."""
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process_id {process_id} out of range for {num_processes}")
    base, rem = divmod(n_words, num_processes)
    lo = process_id * base + min(process_id, rem)
    hi = lo + base + (1 if process_id < rem else 0)
    return lo, hi


def stripe_packed(packed: PackedWords, lo: int, hi: int) -> PackedWords:
    """One process's slice of a packed batch; ``index`` keeps the global
    dictionary positions, so hits report against the whole wordlist."""
    return PackedWords(tokens=packed.tokens[lo:hi],
                       lengths=packed.lengths[lo:hi],
                       index=packed.index[lo:hi])


def stripe_n_words(packed, num_processes: int, process_id: int) -> int:
    """Word count of one process's stripe (each bucket striped on its
    own, as :func:`_local_sweep` sweeps them)."""
    if isinstance(packed, dict):
        return sum(stripe_n_words(p, num_processes, process_id)
                   for p in packed.values())
    lo, hi = host_stripe(packed.batch, num_processes, process_id)
    return hi - lo


def _allgather(x: np.ndarray, timeout: Optional[float] = None
               ) -> np.ndarray:
    """All-gather ``x`` (equal shape and dtype on every process) into
    ``[nprocs, *x.shape]``, under the liveness guard: the collective runs
    on a daemon thread while this one polls the peers' heartbeats; a
    frozen one past ``timeout`` (``A5GEN_DCN_TIMEOUT``; ``<= 0``
    disables the guard) or a collective that fails raises
    :class:`PeerLossError`.  A stuck collective thread cannot be
    cancelled: a caller that gives up leaves through ``os._exit`` (the
    CLI does)."""
    import torch
    import torch.distributed as dist

    if timeout is None:
        timeout = _dcn_timeout()
    nprocs, pid = _Pod.nprocs, _Pod.pid
    src = torch.from_numpy(np.ascontiguousarray(x))
    outs = [torch.empty_like(src) for _ in range(nprocs)]
    error: list = []

    def _run() -> None:
        try:
            dist.all_gather(outs, src)
        except Exception as e:  # noqa: BLE001 — reported below
            error.append(e)

    th = threading.Thread(target=_run, daemon=True, name="a5gen-allgather")
    _Pod.gather_thread = th
    th.start()
    if timeout > 0:
        store = _client()
        seen: dict = {}
        while th.is_alive():
            th.join(min(_HB_INTERVAL, timeout))
            if not th.is_alive():
                break
            dead = _stale_peer(store, seen, nprocs, pid, timeout)
            if dead is not None:
                raise PeerLossError(
                    f"peer process {dead} has not heartbeat for "
                    f"{timeout:.0f}s while process {pid} of {nprocs} "
                    f"waits in a cross-host all-gather: the peer has died "
                    f"or stalled mid-sweep. " + _RECOVERY)
    th.join()
    if error:
        raise PeerLossError(
            f"the cross-host all-gather of process {pid} of {nprocs} "
            f"failed ({type(error[0]).__name__}: {error[0]}): a peer "
            f"process has died or stalled mid-sweep. " + _RECOVERY
        ) from error[0]
    return torch.stack(outs).numpy()


def _allgather_bytes(payload: bytes) -> List[bytes]:
    """Every process's ``payload``, in process order: the lengths, then
    the payloads padded to the longest."""
    n = len(payload)
    lens = _allgather(np.asarray([n], dtype=np.int64))[:, 0]
    buf = np.zeros(max(1, int(lens.max())), dtype=np.uint8)
    buf[:n] = np.frombuffer(payload, dtype=np.uint8)
    bufs = _allgather(buf)
    return [bytes(bufs[p, :int(lens[p])]) for p in range(bufs.shape[0])]


def allgather_sum(value: int) -> int:
    """The sum of a process-local int over the pod."""
    return int(_allgather(np.asarray([value], dtype=np.int64)).sum())


def allgather_max(value: float) -> float:
    """The max of a process-local float over the pod."""
    return float(_allgather(np.asarray([value], dtype=np.float64)).max())


def gather_hits(hits: Sequence) -> List:
    """Every process's hit records, combined and sorted by
    ``(word_index, variant_rank)``, the same on every process (JSON on
    the wire: ranks are Python ints that may pass int64)."""
    from ..runtime.sinks import HitRecord

    payload = json.dumps([
        {"w": int(h.word_index), "r": int(h.variant_rank),
         "c": h.candidate.hex(), "d": h.digest_hex}
        for h in hits
    ]).encode()
    combined = [
        HitRecord(word_index=rec["w"], variant_rank=rec["r"],
                  candidate=bytes.fromhex(rec["c"]), digest_hex=rec["d"])
        for raw in _allgather_bytes(payload) if raw
        for rec in json.loads(raw)
    ]
    combined.sort(key=lambda h: (h.word_index, h.variant_rank))
    return combined


def _reduce_superstep(stats: Dict[str, int]) -> Dict[str, int]:
    """Pod-wide superstep stats (``telemetry.SUPERSTEP_MERGE``'s keys and
    the per-launch pipeline's launches, in a fixed order, so every
    process runs the same collectives whichever drive its stripe ran):
    counters sum, the per-config ratios max; {} when nothing ran."""
    from ..runtime.telemetry import SUPERSTEP_MERGE

    out = {k: allgather_sum(int(stats.get(k, 0)))
           for k in SUPERSTEP_MERGE.sum_keys + ("per_launch",)}
    for k in SUPERSTEP_MERGE.max_keys:
        out[k] = int(allgather_max(float(stats.get(k, 0))))
    return out if any(out.values()) else {}


def allgather_metrics(snap: "Optional[Dict]" = None) -> Dict:
    """Pod-wide telemetry: every process's registry snapshot gathered as
    JSON (one exchange whatever the key sets) and reduced through
    ``telemetry.merge``; the same on every process."""
    from ..runtime import telemetry

    if snap is None:
        snap = telemetry.snapshot()
    if _Pod.nprocs == 1:
        return telemetry.merge([snap])
    return telemetry.merge(
        [json.loads(raw) if raw else {}
         for raw in _allgather_bytes(json.dumps(snap).encode())])


def _reduce_port_fields(res) -> dict:
    """The result fields the reference's pod does not have: the drive's
    times max over the pod; the kernel launches, routes, XLA geometry,
    stream and schema-cache stats stay the process's own (its stderr
    summary says what its stripe ran), and so do the launch geometry and
    its source, as in the reference."""
    return dict(drive_s=allgather_max(res.drive_s),
                ttfc_s=allgather_max(res.ttfc_s),
                kernels=dict(res.kernels), routes=dict(res.routes),
                xla=dict(res.xla), stream=dict(res.stream),
                schema_cache=dict(res.schema_cache),
                geometry=dict(res.geometry),
                geometry_source=res.geometry_source)


def _host_config(config, process_id: int):
    """A process's copy of a SweepConfig: its checkpoint path gets the
    suffix ``.p<id>`` (each process checkpoints its own cursor)."""
    if config is None or config.checkpoint_path is None:
        return config
    return replace(config,
                   checkpoint_path=f"{config.checkpoint_path}.p{process_id}")


def _local_sweep(spec, sub_map, packed, digests, config, pid: int,
                 nprocs: int):
    """This process's sweep over its word stripe (``packed`` flat, or a
    ``{width: PackedWords}`` bucket dict striped bucket by bucket)."""
    cfg = _host_config(config, pid)
    if isinstance(packed, dict):
        from ..runtime.bucketed import BucketedSweep

        local = {width: stripe_packed(p, *host_stripe(p.batch, nprocs, pid))
                 for width, p in packed.items()}
        return BucketedSweep(spec, sub_map, local, digests, config=cfg)
    from ..runtime.sweep import Sweep

    lo, hi = host_stripe(packed.batch, nprocs, pid)
    return Sweep(spec, sub_map, stripe_packed(packed, lo, hi), digests,
                 config=cfg)


def stream_order(packed):
    """The sort key of the single-process hit stream over ``packed``:
    ``(word_index, rank)`` for a flat batch, bucket-major (ascending
    width, then ``(word_index, rank)``) for a bucket dict — the order
    gathered hits print in, so process 0's stdout is the single-process
    stdout."""
    if not isinstance(packed, dict):
        return lambda h: (h.word_index, h.variant_rank)
    index = [np.sort(np.asarray(packed[w].index)) for w in sorted(packed)]

    def bucket(i: int) -> int:
        for b, idx in enumerate(index):
            j = int(np.searchsorted(idx, i))
            if j < len(idx) and int(idx[j]) == i:
                return b
        return len(index)

    return lambda h: (bucket(h.word_index), h.word_index, h.variant_rank)


def _emit_gathered(recorder, hits, packed) -> None:
    if recorder is not None:
        for h in sorted(hits, key=stream_order(packed)):
            recorder.emit(h)


def run_crack_multihost(spec, sub_map: Dict[bytes, List[bytes]], packed,
                        digests: Sequence[bytes], config=None, *,
                        recorder=None, resume: bool = True,
                        gather: bool = True):
    """The crack sweep over word stripes: every process passes the same
    whole wordlist and sweeps its own stripe.

    ``gather=True``: the processes exchange their hits and every one
    returns the same combined SweepResult; ``recorder`` (process 0's,
    as a rule) gets the combined hits in the single-process stream's
    order (:func:`stream_order`).  ``gather=False``: each process
    streams its own stripe's hits to its recorder as found and returns
    its own result, with no collective at all, so a dead peer cannot
    block the others; the union of the streams is the gathered one."""
    from ..runtime.sweep import SweepResult

    pid, nprocs = _Pod.pid, _Pod.nprocs
    sweep = _local_sweep(spec, sub_map, packed, digests, config, pid, nprocs)
    if not gather:
        return sweep.run_crack(recorder, resume=resume)
    res = sweep.run_crack(resume=resume)
    all_hits = gather_hits(res.hits)
    _emit_gathered(recorder, all_hits, packed)
    return SweepResult(
        n_emitted=allgather_sum(res.n_emitted),
        n_hits=len(all_hits),
        hits=all_hits,
        words_done=allgather_sum(res.words_done),
        wall_s=allgather_max(res.wall_s),
        routing={k: allgather_sum(int(v))
                 for k, v in sorted(res.routing.items())},
        superstep=_reduce_superstep(res.superstep),
        **_reduce_port_fields(res),
    )


def run_crack_giant(spec, sub_map: Dict[bytes, List[bytes]], packed,
                    digests: Sequence[bytes], config=None, *,
                    recorder=None, resume: bool = True,
                    gather: bool = True):
    """One crack job split over the pod's stripes: every process sweeps
    the whole wordlist with ``SweepConfig.pod = (index, count)``, owning
    its cursor stripes of every launch, so the shards' hit streams are a
    disjoint union equal to one sweep's.  Each process checkpoints at
    ``PATH.p<id>``; the cursor is the global one.  ``gather`` as in
    :func:`run_crack_multihost`; ``words_done`` and the routing describe
    the whole dictionary on every shard, so they merge by max and pass
    through."""
    from ..runtime.bucketed import BucketedSweep
    from ..runtime.sweep import Sweep, SweepConfig, SweepResult

    pid, nprocs = _Pod.pid, _Pod.nprocs
    cfg = _host_config(config, pid)
    cfg = replace(cfg if cfg is not None else SweepConfig(),
                  pod=(pid, nprocs))
    sweep = (BucketedSweep if isinstance(packed, dict) else Sweep)(
        spec, sub_map, packed, digests, config=cfg)
    if not gather:
        return sweep.run_crack(recorder, resume=resume)
    res = sweep.run_crack(resume=resume)
    all_hits = gather_hits(res.hits)
    _emit_gathered(recorder, all_hits, packed)
    return SweepResult(
        n_emitted=allgather_sum(res.n_emitted),
        n_hits=len(all_hits),
        hits=all_hits,
        words_done=int(allgather_max(float(res.words_done))),
        wall_s=allgather_max(res.wall_s),
        routing=dict(res.routing),
        superstep=_reduce_superstep(res.superstep),
        **_reduce_port_fields(res),
    )


def run_candidates_multihost(spec, sub_map: Dict[bytes, List[bytes]],
                             packed, writer, config=None, *,
                             resume: bool = True, gather: bool = True):
    """Candidates mode over word stripes: each process writes its own
    stripe to its own writer, so for a flat batch the processes' outputs
    concatenated in process order are the single-process stream (a
    bucket dict: each process's stream is bucket-major over its own
    stripe).  ``gather=True`` returns pod-wide counts; ``gather=False``
    the process's own, with no collective."""
    from ..runtime.sweep import SweepResult

    pid, nprocs = _Pod.pid, _Pod.nprocs
    sweep = _local_sweep(spec, sub_map, packed, (), config, pid, nprocs)
    res = sweep.run_candidates(writer, resume=resume)
    if not gather:
        return res
    return SweepResult(
        n_emitted=allgather_sum(res.n_emitted),
        words_done=allgather_sum(res.words_done),
        wall_s=allgather_max(res.wall_s),
        routing={k: allgather_sum(int(v))
                 for k, v in sorted(res.routing.items())},
        **_reduce_port_fields(res),
    )
