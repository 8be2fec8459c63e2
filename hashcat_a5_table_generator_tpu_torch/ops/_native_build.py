"""Build-on-first-use for the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain ``extern "C"`` interface, loaded through ``ctypes``:
no PyTorch headers, so a build takes seconds.  Libraries land in
``build/torch_kernels/`` at the root of the checkout, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads straight away.  ``nvcc``'s ``-Xptxas -v`` report (registers, stack
frame, spills, shared memory per kernel) is kept beside each library.

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


def _target(name: str) -> "tuple[pathlib.Path, pathlib.Path, pathlib.Path]":
    src = CSRC / f"{name}.cu"
    tag = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.ptxas.txt"


def _compile(name: str) -> "subprocess.Popen | None":
    """Start one ``nvcc`` for ``csrc/<name>.cu`` unless its library is
    built; returns the running process (or None)."""
    src, lib, log = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named kernels' libraries, one ``nvcc`` per source, all
    started together.  Returns ``{name: ptxas report}``; raises
    ``RuntimeError`` with the compiler output when a build fails."""
    names = list(names)
    with _LOCK:
        procs = {n: _compile(n) for n in names}
        for name, proc in procs.items():
            if proc is None:
                continue
            out, _ = proc.communicate()
            _src, lib, log = _target(name)
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{out}"
                )
            log.write_text(out)
            os.replace(tmp, lib)
    return {n: _target(n)[2].read_text() for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first when
    needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
        return _LIBS[name]
