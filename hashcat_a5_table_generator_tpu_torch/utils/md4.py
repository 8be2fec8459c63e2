"""Pure-Python MD4 (RFC 1320) for host-side NTLM work.

OpenSSL 3 removed ``md4`` from ``hashlib`` on most builds, but the sweep
runtime needs host MD4 for oracle-fallback words in NTLM mode (the device
path has its own uint32-lane MD4 in ``ops.hashes``; the two are
cross-checked in tests). NTLM(password) = MD4(UTF-16LE(password)).
"""

from __future__ import annotations

import struct

_R2 = (0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15)
_R3 = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)
_MASK = 0xFFFFFFFF


def _rotl(x: int, s: int) -> int:
    return ((x << s) | (x >> (32 - s))) & _MASK


def md4(data: bytes) -> bytes:
    """MD4 digest of ``data`` (16 bytes)."""
    ml = (len(data) * 8) & 0xFFFFFFFFFFFFFFFF
    data = data + b"\x80"
    data = data + b"\x00" * ((56 - len(data)) % 64)
    data = data + struct.pack("<Q", ml)

    a, b, c, d = 0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476
    for off in range(0, len(data), 64):
        x = struct.unpack("<16I", data[off : off + 64])
        aa, bb, cc, dd = a, b, c, d
        # Round 1: F(b,c,d) = (b & c) | (~b & d)
        for i in range(16):
            s = (3, 7, 11, 19)[i % 4]
            if i % 4 == 0:
                a = _rotl((a + ((b & c) | (~b & d)) + x[i]) & _MASK, s)
            elif i % 4 == 1:
                d = _rotl((d + ((a & b) | (~a & c)) + x[i]) & _MASK, s)
            elif i % 4 == 2:
                c = _rotl((c + ((d & a) | (~d & b)) + x[i]) & _MASK, s)
            else:
                b = _rotl((b + ((c & d) | (~c & a)) + x[i]) & _MASK, s)
        # Round 2: G(b,c,d) = (b & c) | (b & d) | (c & d), +0x5A827999
        for i in range(16):
            k = _R2[i]
            s = (3, 5, 9, 13)[i % 4]
            if i % 4 == 0:
                a = _rotl((a + ((b & c) | (b & d) | (c & d)) + x[k] + 0x5A827999) & _MASK, s)
            elif i % 4 == 1:
                d = _rotl((d + ((a & b) | (a & c) | (b & c)) + x[k] + 0x5A827999) & _MASK, s)
            elif i % 4 == 2:
                c = _rotl((c + ((d & a) | (d & b) | (a & b)) + x[k] + 0x5A827999) & _MASK, s)
            else:
                b = _rotl((b + ((c & d) | (c & a) | (d & a)) + x[k] + 0x5A827999) & _MASK, s)
        # Round 3: H(b,c,d) = b ^ c ^ d, +0x6ED9EBA1
        for i in range(16):
            k = _R3[i]
            s = (3, 9, 11, 15)[i % 4]
            if i % 4 == 0:
                a = _rotl((a + (b ^ c ^ d) + x[k] + 0x6ED9EBA1) & _MASK, s)
            elif i % 4 == 1:
                d = _rotl((d + (a ^ b ^ c) + x[k] + 0x6ED9EBA1) & _MASK, s)
            elif i % 4 == 2:
                c = _rotl((c + (d ^ a ^ b) + x[k] + 0x6ED9EBA1) & _MASK, s)
            else:
                b = _rotl((b + (c ^ d ^ a) + x[k] + 0x6ED9EBA1) & _MASK, s)
        a = (a + aa) & _MASK
        b = (b + bb) & _MASK
        c = (c + cc) & _MASK
        d = (d + dd) & _MASK

    return struct.pack("<4I", a, b, c, d)


def ntlm(password: bytes) -> bytes:
    """NTLM digest: MD4 over the byte-wise UTF-16LE expansion (each input
    byte followed by 0x00 — matching the device kernel's byte-level
    expansion in ``ops.hashes.utf16le_expand``, not Python ``str`` codecs:
    candidates are raw byte strings, not unicode text)."""
    return md4(bytes(b for ch in password for b in (ch, 0)))
