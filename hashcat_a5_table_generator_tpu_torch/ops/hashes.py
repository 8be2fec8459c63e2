"""Hash constants and plain PyTorch MD5, MD4 and SHA-1 over pre-built
message words.

The device state layout is the reference package's: a digest is its raw
state words, ``int32[N, 4]`` (``int32[N, 5]`` for SHA-1) here — the uint32
words reinterpreted, since torch on the CPU has no uint32 arithmetic —
little-endian for MD5/MD4/NTLM and big-endian for SHA-1 when serialized
to bytes.

:func:`hash_words` is the plain version of the piece kernel's compression
chain (``csrc/piece_hash.cu``): it runs in int32 with wrapping adds, makes
right shifts logical by masking, and selects each lane's state after its
own padding block.  The compressions mirror the reference's ``_md5_block``,
``_md4_block`` and ``_sha1_block`` (SHA-1 byte-swaps the shared
little-endian message words into its big-endian schedule).  NTLM is MD4
over the byte-wise UTF-16LE expansion (every byte followed by ``00``, the
reference's ``utf16le_expand``): :func:`utf16_code_units` is that
expansion for one message word.
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
_MD4_INIT = _MD5_INIT
_MD4_G = [0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15]
_MD4_H = [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]
_SHA1_INIT = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_SHA1_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)

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


def md4_compress(state, m):
    """One MD4 compression (RFC 1320, the NTLM core): ``state`` is four
    int32 ``[N]`` tensors, ``m`` sixteen message-word tensors."""
    a, b, c, d = state
    rounds = (
        (lambda b, c, d: d ^ (b & (c ^ d)), 0, (3, 7, 11, 19), range(16)),
        (lambda b, c, d: (b & (c | d)) | (c & d), 0x5A827999, (3, 5, 9, 13),
         _MD4_G),
        (lambda b, c, d: b ^ c ^ d, 0x6ED9EBA1, (3, 9, 11, 15), _MD4_H),
    )
    for f, add, shifts, order in rounds:
        for j, k in enumerate(order):
            t = rotl(a + f(b, c, d) + m[k] + add, shifts[j % 4])
            a, b, c, d = d, t, b, c
    return tuple(x + y for x, y in zip((a, b, c, d), state))


def bswap(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of int32 words."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | (lsr(x, 8) & 0xFF00) | lsr(x, 24))


def sha1_compress(state, m):
    """One SHA-1 compression (RFC 3174) over the little-endian message
    words ``m``, byte-swapped into the big-endian schedule: ``state`` is
    five int32 ``[N]`` tensors."""
    w = [bswap(x) for x in m]
    for t in range(16, 80):
        w.append(rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
    a, b, c, d, e = state
    for t in range(80):
        if t < 20:
            f = d ^ (b & (c ^ d))
        elif t < 40:
            f = b ^ c ^ d
        elif t < 60:
            f = (b & (c | d)) | (c & d)
        else:
            f = b ^ c ^ d
        tmp = rotl(a, 5) + f + e + i32(_SHA1_K[t // 20]) + w[t]
        a, b, c, d, e = tmp, a, rotl(b, 30), c, d
    return tuple(x + y for x, y in zip((a, b, c, d, e), state))


_COMPRESS = {"md5": (md5_compress, _MD5_INIT),
             "md4": (md4_compress, _MD4_INIT),
             "ntlm": (md4_compress, _MD4_INIT),
             "sha1": (sha1_compress, _SHA1_INIT)}


def utf16_code_units(wd: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """The byte-wise UTF-16LE expansion of one little-endian message word
    (bytes b0..b3): the code-unit words ``b0 | b1 << 16`` and
    ``b2 | b3 << 16`` — every byte followed by a zero byte."""
    lo = (wd & 0xFF) | ((wd & 0xFF00) << 8)
    hi = (lsr(wd, 16) & 0xFF) | (lsr(wd, 24) << 16)
    return lo, hi


def length_word(end: torch.Tensor, algo: str) -> "tuple[int, torch.Tensor]":
    """The padding block's 64-bit bit length, low half: ``(word index in
    the block, value)`` — word 14 little-endian, or for SHA-1 word 15
    byte-swapped (its big-endian high half, word 14, stays zero for
    messages below 2^29 bytes).  ``end`` is the message length in bytes."""
    bits = end * 8
    if algo == "sha1":
        return 15, bswap(bits)
    return 14, bits


def hash_words(msg: torch.Tensor, end: torch.Tensor, algo: str
               ) -> torch.Tensor:
    """``algo``'s state of each lane's padded message.

    ``msg`` int32 ``[N, 16 * HB]`` holds the message words (data, the 0x80
    terminator and the bit length already in place); ``end`` int32 ``[N]``
    is each lane's message length in bytes.  Lane n's digest is the state
    after its own padding block — block k holds the terminator and length
    iff ``end <= 64 * (k + 1) - 9`` — so later blocks never change it.
    Returns int32 ``[N, DIGEST_WORDS[algo]]``."""
    compress, init = _COMPRESS[algo]
    n, words = msg.shape
    state = tuple(
        torch.full((n,), i32(v), dtype=torch.int32, device=msg.device)
        for v in init
    )
    final = state
    for k in range(words // 16):
        state = compress(
            state, [msg[:, 16 * k + j] for j in range(16)]
        )
        live = end > 64 * k - 9  # the lane's padding block is >= k
        final = tuple(
            torch.where(live, s, f) for s, f in zip(state, final)
        )
    return torch.stack(final, dim=1)

