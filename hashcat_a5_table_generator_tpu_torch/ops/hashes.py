"""MD5 constants and a plain PyTorch MD5 over pre-built message words.

The device state layout is the reference package's: a digest is its raw
state words, ``int32[N, 4]`` here (the uint32 words reinterpreted — torch
on the CPU has no uint32 arithmetic), little-endian for MD5/MD4 and
big-endian for SHA-1 when serialized to bytes.

:func:`md5_words` is the plain version of the piece kernel's compression
(``csrc/piece_md5.cu``): it runs in int32 with wrapping adds, makes right
shifts logical by masking, and selects each lane's state after its own
padding block.
"""

from __future__ import annotations

import numpy as np
import torch

_MD5_S = (
    [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4
    + [6, 10, 15, 21] * 4
)
_MD5_K = [int(abs(np.sin(i + 1)) * 2**32) & 0xFFFFFFFF for i in range(64)]
_MD5_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)

DIGEST_WORDS = {"md5": 4, "sha1": 5, "md4": 4, "ntlm": 4}
#: Canonical byte serialization: MD4/MD5 little-endian words, SHA-1 big-endian.
BIG_ENDIAN_DIGEST = {"md5": False, "sha1": True, "md4": False, "ntlm": False}


def digest_to_words(digest, algo: str) -> np.ndarray:
    """Parse a canonical digest (raw bytes or hex str) back to uint32 words."""
    if isinstance(digest, str):
        digest = bytes.fromhex(digest)
    order = ">u4" if BIG_ENDIAN_DIGEST[algo] else "<u4"
    return np.frombuffer(digest, dtype=order).astype(np.uint32)


def i32(value: int) -> int:
    """A uint32 constant as the int32 with the same bits."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


def lsr(x: torch.Tensor, n):
    """Logical right shift of int32 ``x`` by ``n`` (a Python int or an
    int32 tensor of amounts in 0..31): the arithmetic shift, with the
    sign-extended high bits masked off."""
    if isinstance(n, int):
        return x if n == 0 else (x >> n) & ((1 << (32 - n)) - 1)
    mask = torch.where(n == 0, -1, (1 << (32 - n)) - 1)
    return (x >> n) & mask


def rotl(x: torch.Tensor, s: int) -> torch.Tensor:
    return (x << s) | lsr(x, 32 - s)


def md5_compress(state, m):
    """One MD5 compression of int32 ``[N]`` words: ``state`` is four
    tensors (a, b, c, d), ``m`` sixteen message-word tensors."""
    a, b, c, d = state
    for i in range(64):
        if i < 16:
            f = d ^ (b & (c ^ d))
            g = i
        elif i < 32:
            f = c ^ (d & (b ^ c))
            g = (5 * i + 1) % 16
        elif i < 48:
            f = b ^ c ^ d
            g = (3 * i + 5) % 16
        else:
            f = c ^ (b | ~d)
            g = (7 * i) % 16
        rot = a + f + i32(_MD5_K[i]) + m[g]
        a, d, c, b = d, c, b, b + rotl(rot, _MD5_S[i])
    return tuple(x + y for x, y in zip((a, b, c, d), state))


def md5_words(msg: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """MD5 state of each lane's padded message.

    ``msg`` int32 ``[N, 16 * HB]`` holds the message words (data, the 0x80
    terminator and the bit length already in place); ``end`` int32 ``[N]``
    is each lane's candidate length.  Lane n's digest is the state after
    its own padding block — block k holds the terminator and length iff
    ``end <= 64 * (k + 1) - 9`` — so later blocks never change it.
    Returns int32 ``[N, 4]``."""
    n, words = msg.shape
    state = tuple(
        torch.full((n,), i32(v), dtype=torch.int32, device=msg.device)
        for v in _MD5_INIT
    )
    final = state
    for k in range(words // 16):
        state = md5_compress(
            state, [msg[:, 16 * k + j] for j in range(16)]
        )
        live = end > 64 * k - 9  # the lane's padding block is >= k
        final = tuple(
            torch.where(live, s, f) for s, f in zip(state, final)
        )
    return torch.stack(final, dim=1)
