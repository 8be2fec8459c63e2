"""Multi-process oracle: a real ``--threads N`` for the byte-exact engines.

The reference bounds per-word goroutines with ``--threads``
(``main.go:36-38``, ``main.go:70-94``) at the cost of nondeterministic
cross-word interleave on the shared output channel.  Here N worker
*processes* expand words round-robin (worker ``w`` owns words
``w, w+N, ...``) and the parent drains their per-word output **in word
order**, so the stream is byte-identical to ``--threads 1`` — the
reference's single-thread order — at any N.  A strictly stronger
contract than the reference's, at the same parallelism.

Workers run the same :func:`oracle.engines.iter_candidates` generators
and the same :class:`runtime.sinks.CandidateWriter` encoding (``$HEX[]``
wrapping included) into in-memory chunks, so the merged stream cannot
drift from the sequential path.  Crack mode ships only (digest, plain)
hits — candidates never cross the process boundary.

Linux ``fork`` start method: workers inherit the word list and table by
copy-on-write; nothing is pickled per word.  Nothing on this path
initializes CUDA or runs a torch op before the fork (``HostDigestLookup``
is numpy; importing its module imports torch, which is safe), so the
children never inherit a CUDA context or a busy torch thread pool.

A copy of the reference package's ``oracle/parallel.py``.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import traceback
from typing import (
    TYPE_CHECKING,
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

if TYPE_CHECKING:  # runtime import cycle + optional toolchain
    # multiprocessing.Queue is a typeshed *function*; the class generic
    # usable in annotations lives in multiprocessing.queues.
    from multiprocessing.queues import Queue as MpQueue

    from ..native.oracle_engine import NativeDefaultOracle
    from ..ops.membership import HostDigestLookup
    from ..runtime.sinks import CandidateWriter

#: Flush worker output to the parent at this granularity: large enough to
#: amortize queue overhead, small enough to bound memory at
#: N workers x queue depth x chunk.
_CHUNK_BYTES = 1 << 18

#: Per-worker queue depth (backpressure: a fast worker blocks instead of
#: buffering unboundedly ahead of the in-order writer).
_QUEUE_DEPTH = 8

_ERROR = -1  # sentinel word index carrying a worker traceback

#: Seconds the in-order merge waits on a worker's queue before it checks
#: that the worker is still alive.
_POLL_S = 30.0


def _maybe_native(
    sub_map: Dict[bytes, List[bytes]], kw: Dict[str, Any], *,
    hex_unsafe: bool,
) -> "Optional[NativeDefaultOracle]":
    """A NativeDefaultOracle when the ONE shared predicate admits this
    mode/config, else None — the single engine-selection point for both
    worker kinds (candidates pass their writer's hex_unsafe; crack passes
    False, since potfile hit lines never $HEX[]-wrap candidates)."""
    try:
        from ..native.oracle_engine import (
            NativeDefaultOracle,
            available,
            default_engine_eligible,
        )

        if default_engine_eligible(
            sub_map,
            substitute_all=bool(kw.get("substitute_all")),
            reverse=bool(kw.get("reverse")),
            crack=False,
            hex_unsafe=hex_unsafe,
            max_substitute=int(kw.get("max_substitute", 15)),
        ) and available():
            return NativeDefaultOracle(sub_map)
    except Exception:  # pragma: no cover - toolchain-dependent
        pass
    return None



def _worker_candidates(
    wid: int,
    n_workers: int,
    words: Sequence[bytes],
    sub_map: Dict[bytes, List[bytes]],
    kw: Dict[str, Any],
    hex_unsafe: bool,
    out_q: "MpQueue[Tuple[int, Any, bool]]",
) -> None:
    """Expand words ``wid, wid+N, ...``; emit per-word encoded chunks
    ``(word_idx, (blob, n_candidates), last)`` in word order.

    Default and substitute-all non-``$HEX[]`` runs use the native C++
    engines when the toolchain provides them — same byte stream, faster
    (the ONE shared predicate:
    ``native.oracle_engine.default_engine_eligible``)."""
    from ..runtime.sinks import CandidateWriter
    from .engines import iter_candidates

    native = _maybe_native(sub_map, kw, hex_unsafe=hex_unsafe)

    try:
        for i in range(wid, len(words), n_workers):
            if native is not None:
                # Stream chunks straight to the queue (bounded memory for
                # huge words); an empty final marker closes the word.
                if kw.get("substitute_all") and kw.get("reverse"):
                    stream = native.stream_word_suball_reverse
                elif kw.get("substitute_all"):
                    stream = native.stream_word_suball
                else:
                    stream = native.stream_word
                stream(
                    words[i], kw.get("min_substitute", 0),
                    kw.get("max_substitute", 15),
                    lambda blob: out_q.put(
                        (i, (blob, blob.count(b"\n")), False)
                    ),
                )
                out_q.put((i, (b"", 0), True))
                continue
            buf = io.BytesIO()
            writer = CandidateWriter(buf, hex_unsafe=hex_unsafe)
            sent = 0
            for cand in iter_candidates(words[i], sub_map, **kw):
                writer.emit(cand)
                if buf.tell() >= _CHUNK_BYTES:
                    out_q.put(
                        (i, (buf.getvalue(), writer.n_written - sent),
                         False)
                    )
                    sent = writer.n_written
                    buf.seek(0)
                    buf.truncate()
            out_q.put((i, (buf.getvalue(), writer.n_written - sent), True))
    except BaseException:
        out_q.put((_ERROR, traceback.format_exc().encode(), True))


def _worker_crack(
    wid: int,
    n_workers: int,
    words: Sequence[bytes],
    sub_map: Dict[bytes, List[bytes]],
    kw: Dict[str, Any],
    algo: str,
    digests: "HostDigestLookup",
    out_q: "MpQueue[Tuple[int, Any, bool]]",
) -> None:
    """Hash every candidate of this worker's words; emit per-word hit
    lists ``(word_idx, [(digest_hex, cand)], True)``.  Generation feeds
    from the native engines when the mode fits (hashing stays Python —
    hashlib's C MD5 — but generation dominated the loop)."""
    from ..utils.digests import HOST_DIGEST
    from .engines import iter_candidates

    native = _maybe_native(sub_map, kw, hex_unsafe=False)

    def word_iter(word: bytes) -> "Any":
        if native is not None:
            return native.iter_word(
                word, kw.get("min_substitute", 0),
                kw.get("max_substitute", 15),
                substitute_all=bool(kw.get("substitute_all")),
                reverse=bool(kw.get("reverse")),
            )
        return iter_candidates(word, sub_map, **kw)

    try:
        lookup = digests  # a HostDigestLookup, built once pre-fork (COW)
        host_digest = HOST_DIGEST[algo]
        for i in range(wid, len(words), n_workers):
            hits: List[Tuple[str, bytes]] = []
            for cand in word_iter(words[i]):
                dig = host_digest(cand)
                if dig in lookup:
                    hits.append((dig.hex(), cand))
            out_q.put((i, hits, True))
    except BaseException:
        out_q.put((_ERROR, traceback.format_exc().encode(), True))


class OracleWorkerError(RuntimeError):
    """A worker process raised; carries its traceback text."""


def _fork_ctx() -> mp.context.BaseContext:
    """The fork start context (workers inherit words/tables by
    copy-on-write; args are never pickled) — with a clear error where
    fork does not exist (Windows) instead of a raw ValueError."""
    if "fork" not in mp.get_all_start_methods():
        raise OracleWorkerError(
            "--threads N needs the fork start method (Linux); "
            "use --threads 1 on this platform"
        )
    return mp.get_context("fork")


def _drain_in_order(
    queues: "Sequence[MpQueue[Tuple[int, Any, bool]]]",
    procs: Sequence[mp.Process],
    n_words: int,
    n_workers: int,
    consume: Callable[[int, Any], None],
) -> None:
    """Pull each word's items from its owner's queue, in global word
    order (each worker produces ITS words in increasing order, so
    per-queue arrival order matches).  A worker that dies WITHOUT its
    error sentinel (OOM kill, segfault) is detected by liveness checks
    on queue timeouts instead of hanging the parent forever."""
    import queue as queue_mod

    for i in range(n_words):
        q = queues[i % n_workers]
        while True:
            try:
                idx, payload, last = q.get(timeout=_POLL_S)
            except queue_mod.Empty:
                p = procs[i % n_workers]
                if not p.is_alive() and q.empty():
                    raise OracleWorkerError(
                        f"oracle worker {i % n_workers} died without a "
                        f"traceback (exitcode {p.exitcode}) — killed by "
                        "the OS? (out of memory?)"
                    )
                continue
            if idx == _ERROR:
                raise OracleWorkerError(payload.decode())
            assert idx == i, f"worker stream out of order: {idx} != {i}"
            consume(i, payload)
            if last:
                break


def run_candidates_parallel(
    words: Sequence[bytes],
    sub_map: Dict[bytes, List[bytes]],
    writer: "CandidateWriter",
    *,
    n_workers: int,
    hex_unsafe: bool = False,
    **iter_kw: Any,
) -> int:
    """Stream every word's candidates to ``writer`` in reference
    (``--threads 1``) order using ``n_workers`` processes.  Returns the
    number of candidate lines written."""
    words = list(words)
    n_workers = max(1, min(n_workers, len(words) or 1))
    ctx = _fork_ctx()
    # Warm the native oracle build/load ONCE pre-fork: children inherit
    # the loaded library instead of racing N cold g++ builds.
    try:
        from ..native.oracle_engine import available as _native_available

        _native_available()
    except Exception:  # pragma: no cover - toolchain-dependent
        pass
    queues = [ctx.Queue(maxsize=_QUEUE_DEPTH) for _ in range(n_workers)]
    procs = [
        ctx.Process(
            target=_worker_candidates,
            args=(w, n_workers, words, sub_map, iter_kw, hex_unsafe,
                  queues[w]),
            daemon=True,
        )
        for w in range(n_workers)
    ]
    for p in procs:
        p.start()
    wrote = [0]

    def consume(i: int, payload: Tuple[bytes, int]) -> None:
        blob, n = payload
        if blob:
            writer.write_block(blob, n)
            wrote[0] += n

    try:
        _drain_in_order(queues, procs, len(words), n_workers, consume)
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=10)
    return wrote[0]


def run_crack_parallel(
    words: Sequence[bytes],
    sub_map: Dict[bytes, List[bytes]],
    digests: "Any",
    algo: str,
    on_hit: Callable[[str, bytes], None],
    *,
    n_workers: int,
    **iter_kw: Any,
) -> int:
    """Oracle crack across ``n_workers`` processes; ``on_hit(digest_hex,
    cand)`` fires in reference word order.  Returns the hit count."""
    from ..ops.membership import HostDigestLookup

    words = list(words)
    n_workers = max(1, min(n_workers, len(words) or 1))
    ctx = _fork_ctx()
    # Warm the native oracle build/load ONCE pre-fork (see
    # run_candidates_parallel): crack workers use the engine too.
    try:
        from ..native.oracle_engine import available as _native_available

        _native_available()
    except Exception:  # pragma: no cover - toolchain-dependent
        pass
    # Build the sorted lookup ONCE pre-fork: workers inherit it by
    # copy-on-write instead of each re-sorting a hashmob-scale matrix.
    lookup = (digests if isinstance(digests, HostDigestLookup)
              else HostDigestLookup(digests))
    queues = [ctx.Queue(maxsize=_QUEUE_DEPTH) for _ in range(n_workers)]
    procs = [
        ctx.Process(
            target=_worker_crack,
            args=(w, n_workers, words, sub_map, iter_kw, algo, lookup,
                  queues[w]),
            daemon=True,
        )
        for w in range(n_workers)
    ]
    for p in procs:
        p.start()
    n_hits = [0]

    def consume(i: int, hits: List[Tuple[str, bytes]]) -> None:
        for dig_hex, cand in hits:
            on_hit(dig_hex, cand)
            n_hits[0] += 1

    try:
        _drain_in_order(queues, procs, len(words), n_workers, consume)
    finally:
        for p in procs:
            p.terminate()
            p.join(timeout=10)
    return n_hits[0]
