"""ctypes bindings for the native wordlist scanner/packer (``packer.cpp``).

A copy of the reference package's ``native/__init__.py`` with its own
build directory.  Build on first use: ``g++ -O3 -shared -fPIC`` into
``build/torch_native/`` at the root of the checkout, one library per
source hash, written to a temporary file and renamed into place, so
processes that build at once never load a half-written library (the C
ABI + ctypes: no PyTorch headers, no pybind11).  Every entry point
degrades to the numpy versions in ``ops.packing`` when the toolchain or
the build is unavailable (the failed build says so on stderr), and
``A5_NATIVE=0`` forces them.

The contract, byte-identical outputs to ``ops.packing``, is held by
tests/test_torch_native.py across CRLF, unterminated tails, empty lines
and the anti-Q8 oversized-line error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops import packing as _np_packing
from ..ops.packing import (  # noqa: F401  (bucket_widths: re-exported)
    DEFAULT_BUCKETS,
    DEFAULT_MAX_WORD_BYTES,
    PackedWords,
    aligned_width,
    bucket_widths,
)
from ..runtime.env import read_env

#: Where the native libraries land: ``build/torch_native/`` at the root of
#: the checkout (``build/`` is git-ignored).
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_native"

_SRC = pathlib.Path(__file__).with_name("packer.cpp")
_ABI = 1
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def forced_off() -> bool:
    """``A5_NATIVE=0``: every native entry point takes its numpy or
    Python version.  Read at each call."""
    return read_env("A5_NATIVE", "1") == "0"


def build_library(src: pathlib.Path, stem: str, flags: Sequence[str],
                  what: str, fallback: str) -> Optional[pathlib.Path]:
    """``g++`` ``src`` into ``BUILD_DIR/lib<stem>-<source hash>.so``
    unless it is there; None (after a notice on stderr) when the build
    fails."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}-{tag}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    # No -march=native: the key is the source hash only, and a portable
    # -O3 binary cannot SIGILL on another machine sharing the directory.
    cmd = ["g++", *flags, "-shared", "-fPIC", "-o", str(tmp), str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        print(f"a5native: {what}build failed ({e}); using {fallback}",
              file=sys.stderr)
        return None
    os.replace(tmp, out)
    return out


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None => use fallback."""
    global _lib, _lib_tried
    if forced_off():
        return None
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = build_library(_SRC, "a5native", ("-O3",), "", "numpy fallback")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        print(f"a5native: load failed ({e}); using numpy fallback",
              file=sys.stderr)
        return None
    if lib.a5_native_abi() != _ABI:
        print("a5native: ABI mismatch; using numpy fallback", file=sys.stderr)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.a5_count_lines.argtypes = [u8p, ctypes.c_int64]
    lib.a5_count_lines.restype = ctypes.c_int64
    lib.a5_scan_lines.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                  i64p, i32p, i64p]
    lib.a5_scan_lines.restype = ctypes.c_int32
    lib.a5_pack.argtypes = [u8p, i64p, i32p, i64p, ctypes.c_int64,
                            ctypes.c_int32, u8p, i32p]
    lib.a5_pack.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def scan_wordlist_bytes(
    data: bytes, *, max_word_bytes: int = DEFAULT_MAX_WORD_BYTES
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Line structure of a wordlist buffer: (buffer, offsets, lengths).

    Matches ``ops.packing.read_wordlist`` semantics exactly (ScanLines +
    anti-Q8 error). Raises ValueError on an oversized line."""
    lib = load()
    if lib is None:
        return _np_packing.read_wordlist_lines(
            data, max_word_bytes=max_word_bytes)
    buf = np.frombuffer(data, dtype=np.uint8)
    n = np.int64(len(data))
    count = lib.a5_count_lines(_u8(buf), n) if len(data) else 0
    offsets = np.zeros(max(1, count), dtype=np.int64)
    lengths = np.zeros(max(1, count), dtype=np.int32)
    bad = np.zeros(1, dtype=np.int64)
    rc = lib.a5_scan_lines(
        _u8(buf), n, np.int64(max_word_bytes), _i64(offsets), _i32(lengths),
        _i64(bad),
    )
    if rc == -2:
        raise ValueError(
            f"line {int(bad[0])} exceeds {max_word_bytes} bytes (Q8)"
        )
    return buf, offsets[:count], lengths[:count]


def pack_rows(
    buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    sel: Optional[np.ndarray],
    width: int,
    *,
    index: Optional[np.ndarray] = None,
) -> PackedWords:
    """Pack selected rows into a PackedWords batch of ``width``."""
    lib = load()
    if lib is None:
        packed = _np_packing.pack_rows(buf, offsets, lengths, sel, width)
        if index is not None:
            packed = PackedWords(tokens=packed.tokens,
                                 lengths=packed.lengths, index=index)
        return packed
    m = len(sel) if sel is not None else len(offsets)
    tokens = np.zeros((m, width), dtype=np.uint8)
    out_len = np.zeros(m, dtype=np.int32)
    if index is None:
        index = (
            sel.astype(np.int64) if sel is not None
            else np.arange(m, dtype=np.int64)
        )
    sel64 = None if sel is None else np.ascontiguousarray(sel, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    rc = lib.a5_pack(
        _u8(buf), _i64(offsets), _i32(lengths),
        _i64(sel64) if sel64 is not None else None,
        np.int64(m), np.int32(width), _u8(tokens), _i32(out_len),
    )
    if rc != 0:
        raise ValueError(f"a5_pack failed with {rc} (row longer than width?)")
    return PackedWords(tokens=tokens, lengths=out_len, index=index)


def read_packed(
    path: str,
    *,
    width: Optional[int] = None,
    max_word_bytes: int = DEFAULT_MAX_WORD_BYTES,
) -> PackedWords:
    """File → one PackedWords batch (the native fast path for the sweep
    runtime; equivalent to ``pack_words(read_wordlist(path))``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    buf, offsets, lengths = scan_wordlist_bytes(
        data, max_word_bytes=max_word_bytes
    )
    if width is None:
        width = aligned_width(int(lengths.max()) if len(lengths) else 0)
    return pack_rows(buf, offsets, lengths, None, width)


def read_packed_buckets(
    path: str,
    *,
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
    max_word_bytes: int = DEFAULT_MAX_WORD_BYTES,
) -> "dict[int, PackedWords]":
    """File → ``{bucket_width: PackedWords}`` (native fast path for the
    bucketed sweep; equivalent to ``bucket_words(read_wordlist(path))``).

    Each batch keeps its words' original dictionary positions in ``index``,
    so hits and per-word reporting stay global."""
    with open(path, "rb") as fh:
        data = fh.read()
    buf, offsets, lengths = scan_wordlist_bytes(
        data, max_word_bytes=max_word_bytes
    )
    if len(lengths) == 0:
        return {}
    widths = bucket_widths(lengths, buckets)
    out: "dict[int, PackedWords]" = {}
    for width in sorted(int(w) for w in np.unique(widths)):
        sel = np.nonzero(widths == width)[0].astype(np.int64)
        out[width] = pack_rows(buf, offsets, lengths, sel, width)
    return out
