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
        return _LIBS[name]
