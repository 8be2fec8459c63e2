"""hashcat ``$HEX[...]`` output encoding.

The reference streams raw candidate bytes to stdout (``main.go:65-67``);
hashcat's convention for plains containing unprintable bytes or line breaks
is ``$HEX[..]``. The sweep runtime's candidate sink emits raw bytes by
default (reference-compatible) and can opt into ``$HEX[]`` wrapping for
candidates that would corrupt line-oriented output.
"""

from __future__ import annotations


def hex_notation_encode(data: bytes) -> bytes:
    """Wrap ``data`` as ``$HEX[...]`` (lowercase hex, hashcat style)."""
    return b"$HEX[" + data.hex().encode("ascii") + b"]"


def needs_hex_notation(data: bytes) -> bool:
    """True when raw emission would corrupt line-oriented output: embedded
    newline / carriage return, or a literal ``$HEX[`` prefix that a consumer
    would mis-decode."""
    return b"\n" in data or b"\r" in data or data.startswith(b"$HEX[")
