"""ctypes binding for the native oracle engines (``oracle.cpp``).

A copy of the reference package's ``native/oracle_engine.py``.  The
Python generators of ``oracle.engines`` are the parity anchor but cost
~4e5 candidates/s a core; this binding streams the identical byte stream
from C++ for the default (engine A), substitute-all (C) and
substitute-all reverse (D) engines, and the callers fall back to the
Python engine whenever the toolchain, the build or the mode does not fit
(``A5_NATIVE=0`` forces the fallback, the same switch as the packer's).
Plain reverse (engine B) stays Python: it models the reference's Q3
offset bug and its panic.  The library builds with g++ at first use into
``build/torch_native/``, like the packer's.

tests/test_torch_native.py pins every stream byte for byte against the
port's ``oracle.engines`` and the reference package's native engine.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys
from typing import Callable, Dict, List, Optional, Sequence

from . import build_library, forced_off

_SRC = pathlib.Path(__file__).with_name("oracle.cpp")
_ABI = 4
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False

_SINK_FN = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ctypes.c_void_p
)

#: Chunk granularity for the candidate stream callback.
_CHUNK_BYTES = 1 << 18

#: ``iter_word`` enumerates a word on the caller's thread while its
#: stream fits this many bytes (four chunks), else on a producer thread.
_EAGER_BYTES = 4 * _CHUNK_BYTES


def load() -> Optional[ctypes.CDLL]:
    """The native oracle library, building on first use; None => Python."""
    global _lib, _lib_tried
    if forced_off():
        return None
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    # c++20: heterogeneous unordered_map lookup (string_view probes
    # without a per-probe std::string allocation).
    path = build_library(_SRC, "a5oracle", ("-O3", "-std=c++20"),
                         "oracle ", "the Python engine")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        print(f"a5native: oracle load failed ({e}); using the Python engine",
              file=sys.stderr)
        return None
    if lib.a5_oracle_abi() != _ABI:
        print("a5native: oracle ABI mismatch; using the Python engine",
              file=sys.stderr)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.a5_oracle_table_new.argtypes = [
        u8p, i32p, ctypes.c_int32, u8p, i32p, i32p,
    ]
    lib.a5_oracle_table_new.restype = ctypes.c_void_p
    lib.a5_oracle_table_free.argtypes = [ctypes.c_void_p]
    lib.a5_oracle_table_free.restype = None
    lib.a5_oracle_process_word.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, _SINK_FN, ctypes.c_void_p,
    ]
    lib.a5_oracle_process_word.restype = ctypes.c_int64
    lib.a5_oracle_suball_word.argtypes = lib.a5_oracle_process_word.argtypes
    lib.a5_oracle_suball_word.restype = ctypes.c_int64
    lib.a5_oracle_suball_reverse_word.argtypes = (
        lib.a5_oracle_process_word.argtypes
    )
    lib.a5_oracle_suball_reverse_word.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


#: Recursion in the C++ default engine is one frame per substitution;
#: cap the window so a pathological --table-max cannot blow the native
#: stack (the Python engine handles larger windows, failing with a clean
#: RecursionError where applicable).
MAX_NATIVE_SUBST = 512

#: The suball engine recurses once per PRESENT pattern — bound the table
#: size so pathological key counts keep the Python engine.
MAX_NATIVE_SUBALL_PATTERNS = 4096


def default_engine_eligible(
    sub_map: Dict[bytes, Sequence[bytes]],
    *,
    substitute_all: bool,
    reverse: bool,
    crack: bool,
    hex_unsafe: bool,
    max_substitute: int,
) -> bool:
    """The ONE eligibility predicate for the native candidate stream,
    shared by the CLI, the --threads workers and the device sweep's
    fallback words (they must never drift: every path must pick the same
    engine for the same input).  Default,
    substitute-all, or substitute-all-reverse mode (plain reverse —
    engine B — keeps Python: Q3 offset-bug modeling and panic
    semantics), candidates output, no $HEX[] wrapping
    (per-candidate inspection stays Python), bounded window (native
    stack: per-substitution frames in engine A, per-present-pattern
    frames in engines C/D), and no table value embedding line terminators
    (the stream counts candidates by newline).  Plain reverse (engine B)
    stays Python — it models the reference's Q3 offset bug and panic
    semantics, which belong in the anchor; suball-reverse (engine D) has
    no such bugs and is native."""
    return (
        not crack
        and not hex_unsafe
        and (not reverse or substitute_all)
        and 0 <= max_substitute <= MAX_NATIVE_SUBST
        and (not (substitute_all or reverse)
             or len(sub_map) <= MAX_NATIVE_SUBALL_PATTERNS)
        and all(
            b"\n" not in v and b"\r" not in v
            for vals in sub_map.values() for v in vals
        )
    )


class NativeDefaultOracle:
    """One compiled table, reusable across words (default engine only).

    ``stream_word(word, min_sub, max_sub, sink)`` calls ``sink(chunk)``
    with newline-terminated candidate chunks in exact engine-A order and
    returns the candidate count.
    """

    def __init__(self, sub_map: Dict[bytes, Sequence[bytes]]) -> None:
        lib = load()
        if lib is None:
            raise RuntimeError("native oracle unavailable")
        self._lib = lib
        keys = list(sub_map.keys())
        keys_blob = b"".join(keys)
        key_lens = (ctypes.c_int32 * len(keys))(*[len(k) for k in keys])
        vals: List[bytes] = []
        val_start = [0]
        for k in keys:
            vals.extend(sub_map[k])
            val_start.append(len(vals))
        vals_blob = b"".join(vals)
        val_lens = (ctypes.c_int32 * max(1, len(vals)))(
            *([len(v) for v in vals] or [0])
        )
        starts = (ctypes.c_int32 * (len(keys) + 1))(*val_start)
        kb = (ctypes.c_uint8 * max(1, len(keys_blob))).from_buffer_copy(
            keys_blob or b"\0"
        )
        vb = (ctypes.c_uint8 * max(1, len(vals_blob))).from_buffer_copy(
            vals_blob or b"\0"
        )
        self._table = lib.a5_oracle_table_new(
            kb, key_lens, len(keys), vb, val_lens, starts
        )
        if not self._table:
            raise RuntimeError("native oracle table construction failed")

    def _stream(self, c_fn, word: bytes, min_sub: int, max_sub: int,
                sink: Callable[[bytes], None]) -> int:
        """Shared ctypes plumbing for both engines.

        ctypes callbacks cannot raise through the C frame: capture the
        sink's exception, tell the C++ loop to ABORT (nonzero return),
        and re-raise here — a BrokenPipeError/ENOSPC/interrupt must not
        silently truncate the stream while reporting success."""
        err: list = []

        def _cb(data, length, _ctx):
            try:
                sink(ctypes.string_at(data, length))
                return 0
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
                return 1

        cb = _SINK_FN(_cb)  # keep alive for the call's duration
        wb = (ctypes.c_uint8 * max(1, len(word))).from_buffer_copy(
            word or b"\0"
        )
        n = int(c_fn(
            self._table, wb, len(word), min_sub, max_sub,
            _CHUNK_BYTES, cb, None,
        ))
        if err:
            raise err[0]
        return n

    def stream_word(
        self,
        word: bytes,
        min_sub: int,
        max_sub: int,
        sink: Callable[[bytes], None],
    ) -> int:
        return self._stream(self._lib.a5_oracle_process_word, word,
                            min_sub, max_sub, sink)

    def stream_word_suball(
        self,
        word: bytes,
        min_sub: int,
        max_sub: int,
        sink: Callable[[bytes], None],
    ) -> int:
        """Engine C (substitute-all) stream — same contract as
        :meth:`stream_word`, mirroring
        ``engines.process_word_substitute_all`` byte-for-byte."""
        return self._stream(self._lib.a5_oracle_suball_word, word,
                            min_sub, max_sub, sink)

    def stream_word_suball_reverse(
        self,
        word: bytes,
        min_sub: int,
        max_sub: int,
        sink: Callable[[bytes], None],
    ) -> int:
        """Engine D (substitute-all reverse) stream, mirroring
        ``engines.process_word_substitute_all_reverse`` byte-for-byte
        (first option per pattern — Q2; subsets from the full set down)."""
        return self._stream(self._lib.a5_oracle_suball_reverse_word, word,
                            min_sub, max_sub, sink)

    def iter_word(self, word: bytes, min_sub: int, max_sub: int,
                  *, substitute_all: bool = False, reverse: bool = False):
        """LAZY per-candidate iterator over the native stream (the
        sweep's oracle-fallback path and oracle crack mode consume
        candidates one by one).

        A word whose stream fits :data:`_EAGER_BYTES` is enumerated in
        one call on this thread and yielded from its chunks: most words
        are small, and a thread a word costs more than their enumeration
        where thread starts and futex wake-ups are slow (PERF.md §6).  A
        larger word starts over on a producer thread pushing chunks into a
        small bounded queue (ctypes releases the GIL during the C call, so
        producer and consumer genuinely overlap); closing the generator
        aborts the enumeration through the sink protocol — a huge hazard
        word neither buffers unboundedly nor outlives its consumer.
        Either way the stream is the same."""
        import queue as queue_mod
        import threading

        if substitute_all and reverse:
            stream = self.stream_word_suball_reverse
        elif substitute_all:
            stream = self.stream_word_suball
        elif reverse:
            raise ValueError("plain reverse has no native engine")
        else:
            stream = self.stream_word

        class _Full(BaseException):
            pass

        chunks: List[bytes] = []

        def collect(blob: bytes) -> None:
            chunks.append(blob)
            if len(chunks) * _CHUNK_BYTES > _EAGER_BYTES:
                raise _Full()

        try:
            stream(word, min_sub, max_sub, collect)
        except _Full:
            chunks.clear()
        else:
            for blob in chunks:
                yield from blob.split(b"\n")[:-1]
            return

        q: "queue_mod.Queue" = queue_mod.Queue(maxsize=4)
        stop = threading.Event()
        DONE = object()

        class _Abort(BaseException):
            pass

        def sink(blob: bytes) -> None:
            while True:
                if stop.is_set():
                    raise _Abort()
                try:
                    q.put(blob, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        def produce() -> None:
            try:
                stream(word, min_sub, max_sub, sink)
            except _Abort:
                pass
            except BaseException as e:  # noqa: BLE001 — re-raised below
                try:
                    q.put(e, timeout=5.0)
                except queue_mod.Full:
                    pass
            while True:  # DONE must land even against a full queue
                if stop.is_set():
                    return
                try:
                    q.put(DONE, timeout=0.1)
                    return
                except queue_mod.Full:
                    continue

        th = threading.Thread(target=produce, daemon=True,
                              name="a5-native-oracle")
        th.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield from item.split(b"\n")[:-1]
        finally:
            stop.set()
            while th.is_alive():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    pass
                th.join(timeout=0.05)

    def close(self) -> None:
        if getattr(self, "_table", None):
            self._lib.a5_oracle_table_free(self._table)
            self._table = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
