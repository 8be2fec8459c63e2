"""Crack-mode output sinks: structured hit records and ``digest:plain``
potfile lines (the reference package's ``runtime/sinks.py``, crack half)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import BinaryIO, List, Optional

from ..utils.hexenc import hex_notation_encode, needs_hex_notation


@dataclass(frozen=True)
class HitRecord:
    """One cracked digest: where it came from and what it was."""

    word_index: int  # wordlist ordinal
    variant_rank: int  # rank in the word's variant space
    candidate: bytes
    digest_hex: str


def potfile_line(digest_hex: str, candidate: bytes) -> bytes:
    """One ``digest:plain`` potfile line; a plain that would corrupt the
    line format — embedded newline, or a ``:`` that colon-splitting potfile
    consumers would mis-parse — is ``$HEX[]``-wrapped.  Only the plain,
    never the digest prefix, matching hashcat's potfile convention."""
    if needs_hex_notation(candidate) or b":" in candidate:
        candidate = hex_notation_encode(candidate)
    return digest_hex.encode("ascii") + b":" + candidate + b"\n"


class HitRecorder:
    """Collects crack-mode hits; optionally tees potfile lines to a binary
    stream as they arrive."""

    def __init__(self, stream: Optional[BinaryIO] = None) -> None:
        self.hits: List[HitRecord] = []
        self._stream = stream

    def emit(self, record: HitRecord) -> None:
        self.hits.append(record)
        if self._stream is not None:
            self._stream.write(
                potfile_line(record.digest_hex, record.candidate)
            )
            self._stream.flush()
