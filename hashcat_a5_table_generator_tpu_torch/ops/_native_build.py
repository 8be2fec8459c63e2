"""Build-on-first-use for the CUDA kernels of ``csrc/``.

Each library compiles with one ``nvcc`` from one ``csrc/*.cu`` source
into a shared library with a plain ``extern "C"`` interface, loaded
through ``ctypes``: no PyTorch headers, so a build takes seconds.  One
source may give several libraries (:data:`LIBRARIES`: the piece, byte-scan
and buffer-hash kernels build once per hash, ``-DPIECE_ALGO=n``), and
:func:`build` starts their compilers together; the first :func:`load`
builds every library of :data:`LIBRARIES` not built yet, in parallel.  Libraries land in
``build/torch_kernels/`` at the root of the checkout, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads straight
away.
``nvcc``'s ``-Xptxas -v`` report (registers, stack frame, spills, shared
memory per kernel) is kept beside each library.

A missing ``nvcc`` or a failed build raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Library name -> (source stem in ``csrc/``, extra nvcc flags).  A name
#: not listed builds ``csrc/<name>.cu`` with no extra flags.
LIBRARIES: Dict[str, "tuple[str, tuple[str, ...]]"] = {
    f"{stem}_{algo}": (stem, (f"-DPIECE_ALGO={i}",))
    for stem in ("piece_hash", "bytescan_hash", "buffer_hash")
    for i, algo in enumerate(("md5", "md4", "sha1", "ntlm"))
}

_HB = (1, 2, 3)  # hash blocks: each entry point's switch over 1-3

#: The kernel instantiations each source's entry points launch, named as
#: ``nvcc``'s ``-Xptxas -v`` report names them: the kernel and its
#: template arguments after the hash (piece_tile_kernel: KIND, DECODE, HB,
#: PAIR, CLOSED; piece_windowed_kernel: KIND, HB, CLOSED, PACK;
#: bytescan_kernel: ROW, VAR, DECODE, CLOSED, HB; buffer_hash_kernel:
#: ALIGNED).  Every library of a source (one per hash) builds them all.
#: ``tests/test_torch_audit.py`` holds this equal to the sources'
#: dispatch and to ``csrc/kernel_budgets.json``'s pins.
KERNELS: Dict[str, "tuple[str, ...]"] = {
    "piece_hash": tuple(
        # a5_piece_k1: scalar decode, match / substitute-all
        [f"piece_tile_kernel<{k},0,{hb},0,0>" for k in (0, 1) for hb in _HB]
        # a5_piece_digits: digit decode, substitute-all closed or open
        + [f"piece_tile_kernel<{k},1,{hb},0,{c}>"
           for k, c in ((0, 0), (1, 1), (1, 0)) for hb in _HB]
        # a5_piece_pair: one hash block, scalar or digit decode
        + [f"piece_tile_kernel<{k},{d},1,1,0>" for k in (0, 1) for d in (0, 1)]
        # a5_piece_windowed: cb packing or not, substitute-all closed
        + [f"piece_windowed_kernel<{k},{hb},{c},{pk}>"
           for k, c, pk in ((0, 0, 1), (0, 0, 0), (1, 1, 0), (1, 0, 1),
                            (1, 0, 0)) for hb in _HB]),
    "bytescan_hash": tuple(
        # a5_bytescan_scalar: three variants x full / windowed enumeration
        [f"bytescan_kernel<0,{v},{d},0,{hb}>"
         for v in (0, 1, 2) for d in (0, 2) for hb in _HB]
        # a5_bytescan_match: radix-2, digit and windowed decodes
        + [f"bytescan_kernel<1,0,{d},0,{hb}>" for d in (3, 1, 2) for hb in _HB]
        # a5_bytescan_suball: the same decodes, closed or open
        + [f"bytescan_kernel<2,0,{d},{c},{hb}>"
           for d in (1, 2, 3) for c in (0, 1) for hb in _HB]),
    "buffer_hash": ("buffer_hash_kernel<1>", "buffer_hash_kernel<0>"),
}


def instantiation_keys(stem: str, kind: "int | None" = None
                       ) -> "tuple[str, ...]":
    """``library:kernel<...>`` of every instantiation of source ``stem``
    (:data:`KERNELS`) in each of its libraries (:data:`LIBRARIES`);
    ``kind`` keeps the piece kernels of one plan kind (their first
    template argument: 0 match, 1 substitute-all)."""
    return tuple(
        f"{lib}:{k}" for lib, (src, _flags) in LIBRARIES.items()
        if src == stem for k in KERNELS[stem]
        if kind is None or k.split("<")[1].split(",")[0] == str(kind))


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "this package are built from csrc/ at first use"
    )


def _flags(name: str) -> "tuple[str, ...]":
    return NVCC_FLAGS + LIBRARIES.get(name, (name, ()))[1]


def _target(name: str) -> "tuple[pathlib.Path, pathlib.Path, pathlib.Path]":
    src = CSRC / f"{LIBRARIES.get(name, (name, ()))[0]}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(
        src.read_bytes() + headers + " ".join(_flags(name)).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.ptxas.txt"


def _compile(name: str) -> "subprocess.Popen | None":
    """Start one ``nvcc`` for library ``name`` unless it is built;
    returns the running process (or None)."""
    src, lib, log = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    return subprocess.Popen(
        [nvcc_path(), *_flags(name), "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named libraries, one ``nvcc`` per library, all started
    together.  Returns ``{name: ptxas report}``; raises ``RuntimeError``
    with the compiler output when a build fails (after every compiler
    started here has exited)."""
    names = list(names)
    with _LOCK:
        procs = {n: _compile(n) for n in names}
        outs = {n: p.communicate()[0] for n, p in procs.items()
                if p is not None}
        failed = None
        for name, out in outs.items():
            src, lib, log = _target(name)
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            if procs[name].returncode != 0:
                tmp.unlink(missing_ok=True)
                failed = failed or (
                    f"nvcc failed for {name} ({src.name}) "
                    f"(exit {procs[name].returncode}):\n{out}"
                )
                continue
            log.write_text(out)
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError(failed)
    return {n: _target(n)[2].read_text() for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first when needed —
    together with every other library of :data:`LIBRARIES` not built yet,
    all compilers started at once."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name] + [n for n in LIBRARIES
                    if n != name and not _target(n)[1].exists()])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
            # A library's first load in the process is a program build
            # for the engine's stats (``runtime.sweep.step_cache_stats``).
            from ..runtime import telemetry

            telemetry.counter("step_cache.misses").add(1)
        return _LIBS[name]
