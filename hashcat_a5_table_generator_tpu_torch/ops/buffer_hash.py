"""The buffer hash: MD5, MD4, SHA-1 or NTLM of candidate byte rows —
wrapper and plain version.

Counterpart of TPU kernel row 10 of the reference package,
``ops/pallas_md5.py`` ``_md5_kernel`` (one-block MD5, taken under
``A5GEN_PALLAS=1``), and of the byte-level hashes its XLA expand + hash
route runs at every width and hash (``ops/hashes.py`` ``HASH_FNS``).

:func:`buffer_hash` launches the hand-written kernel of
``csrc/buffer_hash.cu`` (one library per hash, ``buffer_hash_<algo>``)
for CUDA tensors, or raises; for CPU tensors it runs the plain PyTorch
version, ``ops.hashes.HASH_FNS[algo]``.  ``LAUNCHES`` counts kernel
launches by ``buffer_hash/<algo>`` (``WIDTH_LAUNCHES`` the same launches
by ``(key, row width)``), ``PLAIN_CALLS`` runs of the plain version.

Contract (the reference's): ``msg uint8[N, W]`` and ``length int32[N]``
(each in ``0..W``) in, the raw state words ``int32[N, 4]`` (``[N, 5]``
for SHA-1; uint32 bits) out.
"""

from __future__ import annotations

import ctypes

import torch

from ..audit import audited_entry
from . import _native_build
from .hashes import DIGEST_WORDS, HASH_FNS

ALGOS = ("md5", "md4", "sha1", "ntlm")

#: Kernel launches by ``buffer_hash/<algo>`` and runs of the plain
#: version: plain integers the caller may reset.
LAUNCHES = {f"buffer_hash/{algo}": 0 for algo in ALGOS}
WIDTH_LAUNCHES: "dict[tuple[str, int], int]" = {}
PLAIN_CALLS = 0


@audited_entry("ops.buffer_hash", kind="cuda_kernel",
               budget_keys=_native_build.instantiation_keys(
                   "buffer_hash"))
def buffer_hash(msg: torch.Tensor, length: torch.Tensor,
                algo: str = "md5") -> torch.Tensor:
    """``algo``'s state words of each row's first ``length`` bytes."""
    global PLAIN_CALLS
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    if msg.dtype != torch.uint8 or msg.dim() != 2:
        raise ValueError(f"msg must be uint8 [N, W], got {msg.dtype} "
                         f"{tuple(msg.shape)}")
    n = int(msg.shape[0])
    if length.dtype != torch.int32 or tuple(length.shape) != (n,):
        raise ValueError(f"length must be int32 [{n}], got {length.dtype} "
                         f"{tuple(length.shape)}")
    if length.device != msg.device:
        raise ValueError("msg and length must be on one device")
    if not (msg.is_contiguous() and length.is_contiguous()):
        raise ValueError("msg and length must be contiguous")
    if msg.device.type == "cpu":
        PLAIN_CALLS += 1
        return HASH_FNS[algo](msg, length)
    if msg.device.type != "cuda":
        raise ValueError(f"unsupported device {msg.device}")
    return _launch_cuda(msg, length, algo)


def _launch_cuda(msg: torch.Tensor, length: torch.Tensor, algo: str
                 ) -> torch.Tensor:
    lib = _native_build.load(f"buffer_hash_{algo}")
    n, width = (int(x) for x in msg.shape)
    state = torch.empty((n, DIGEST_WORDS[algo]), dtype=torch.int32,
                        device=msg.device)
    fn = lib.a5_buffer_hash
    fn.restype = ctypes.c_int
    with torch.cuda.device(msg.device):  # the rows' card
        err = fn(ctypes.c_void_p(msg.data_ptr()),
                 ctypes.c_void_p(length.data_ptr()), ctypes.c_longlong(n),
                 ctypes.c_int(width), ctypes.c_void_p(state.data_ptr()),
                 ctypes.c_void_p(torch.cuda.current_stream(msg.device)
                                 .cuda_stream))
    if err != 0:
        raise RuntimeError(f"buffer_hash/{algo} launch failed: CUDA error "
                           f"{err}")
    key = f"buffer_hash/{algo}"
    LAUNCHES[key] += 1
    WIDTH_LAUNCHES[(key, width)] = WIDTH_LAUNCHES.get((key, width), 0) + 1
    return state
