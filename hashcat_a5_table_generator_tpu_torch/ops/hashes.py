"""Hash constants and plain PyTorch MD5, MD4, SHA-1 and NTLM: over
pre-built message words (the piece and byte-scan kernels' plain
versions) and over candidate byte buffers (the reference's ``HASH_FNS``).

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

:data:`HASH_FNS` (``md5``, ``md4``, ``sha1``, ``ntlm``) are the twins of the
reference's byte-level hashes (``ops/hashes.py``), which its XLA expand +
hash route runs: ``uint8[N, W]`` candidate rows and ``int32[N]`` lengths
in, ``int32[N, DIGEST_WORDS[algo]]`` state words out, through the same
Merkle-Damgard layout (:func:`pad_message`: the 0x80 terminator at byte
``length``, the 64-bit bit length little-endian at the end of the row's
own last block, big-endian for SHA-1) and the same per-row block masking
(:func:`_run_blocks`).  They are the plain version of the buffer-hash
kernel (``ops.buffer_hash``).
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



# ---------------------------------------------------------------------------
# Byte-level hashes of candidate buffers (the reference's HASH_FNS)
# ---------------------------------------------------------------------------


def _blocks_for_width(width: int) -> int:
    """Static number of 64-byte blocks the padded layout needs."""
    return -(-(width + 9) // 64)


def pad_message(msg: torch.Tensor, length: torch.Tensor, *,
                big_endian_length: bool
                ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Merkle-Damgard padding for a batch: ``(words int32[N, NB*16],
    n_blocks int32[N])``, ``NB = _blocks_for_width(W)``.  Bytes at and
    past ``length`` are zeroed, 0x80 lands at byte ``length`` and the
    64-bit bit length in the last 8 bytes of the row's own last block
    (little-endian, or big-endian for SHA-1, whose compression byte-swaps
    the little-endian words later); a row whose blocks exceed ``NB`` gets
    no length field, as in the reference."""
    n, width = msg.shape
    nb = _blocks_for_width(width)
    total = nb * 64
    dev = msg.device
    length = length.to(torch.int32)
    buf = torch.zeros((n, total), dtype=torch.uint8, device=dev)
    buf[:, :width] = msg
    pos = torch.arange(total, dtype=torch.int32, device=dev)[None, :]
    buf *= pos < length[:, None]
    buf.masked_fill_(pos == length[:, None], 0x80)
    # Little-endian words: the byte view reinterpreted (every torch device
    # this package runs on is little-endian).
    words = buf.view(torch.int32).clone()
    n_blocks = torch.div(length + 72, 64, rounding_mode="floor")
    # The 64-bit bit length of the uint32 length: low and high words.
    bits = length.long() & 0xFFFFFFFF
    lo = (bits * 8) & 0xFFFFFFFF
    lo = torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)
    hi = (bits >> 29).to(torch.int32)
    if big_endian_length:
        lo, hi = bswap(hi), bswap(lo)
    rows = torch.nonzero((n_blocks >= 1) & (n_blocks <= nb)).flatten()
    end = n_blocks[rows].long() * 16
    words[rows, end - 2] = lo[rows]
    words[rows, end - 1] = hi[rows]
    return words, n_blocks


def _run_blocks(algo: str, words: torch.Tensor, n_blocks: torch.Tensor
                ) -> torch.Tensor:
    """Every static block's compression, the state kept where a row's own
    blocks have ended; ``int32[N, DIGEST_WORDS[algo]]``."""
    compress, init = _COMPRESS[algo]
    n = words.shape[0]
    state = tuple(
        torch.full((n,), i32(v), dtype=torch.int32, device=words.device)
        for v in init
    )
    for blk in range(words.shape[1] // 16):
        new = compress(state, [words[:, 16 * blk + j] for j in range(16)])
        live = blk < n_blocks
        state = tuple(torch.where(live, a, b) for a, b in zip(new, state))
    return torch.stack(state, dim=1)


def md5(msg: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """MD5 of each row: ``uint8[N, W], int32[N] -> int32[N, 4]``."""
    words, n_blocks = pad_message(msg, length, big_endian_length=False)
    return _run_blocks("md5", words, n_blocks)


def md4(msg: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """MD4 of each row: ``uint8[N, W], int32[N] -> int32[N, 4]``."""
    words, n_blocks = pad_message(msg, length, big_endian_length=False)
    return _run_blocks("md4", words, n_blocks)


def sha1(msg: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """SHA-1 of each row: ``uint8[N, W], int32[N] -> int32[N, 5]``."""
    words, n_blocks = pad_message(msg, length, big_endian_length=True)
    return _run_blocks("sha1", words, n_blocks)


def utf16le_expand(msg: torch.Tensor, length: torch.Tensor
                   ) -> "tuple[torch.Tensor, torch.Tensor]":
    """Bytes to UTF-16LE code units the way hashcat's NTLM kernel does:
    ``uint8[N, W] -> uint8[N, 2W]``, a zero byte after every byte."""
    n, width = msg.shape
    out = torch.zeros((n, 2 * width), dtype=torch.uint8, device=msg.device)
    out[:, 0::2] = msg
    return out, length.to(torch.int32) * 2


def ntlm(msg: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """NTLM: MD4 over the UTF-16LE expansion; ``int32[N, 4]``."""
    wide, wide_len = utf16le_expand(msg, length)
    return md4(wide, wide_len)


HASH_FNS = {"md5": md5, "sha1": sha1, "md4": md4, "ntlm": ntlm}
