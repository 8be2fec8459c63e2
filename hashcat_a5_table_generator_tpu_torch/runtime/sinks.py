"""Output sinks (the reference package's ``runtime/sinks.py``):
``CandidateWriter`` streams candidate lines through one buffered binary
stream (candidates mode); ``HitRecorder`` collects crack-mode hits as
structured records and optionally tees ``digest:plain`` potfile lines."""

from __future__ import annotations

import io
import sys
from dataclasses import dataclass
from typing import BinaryIO, List, Optional

from ..utils.hexenc import hex_notation_encode, needs_hex_notation


class CandidateWriter:
    """Buffered line writer for candidate bytes: raw ``candidate\n``
    lines, or with ``hex_unsafe`` a candidate that would corrupt the line
    format ``$HEX[]``-wrapped."""

    def __init__(self, stream: Optional[BinaryIO] = None, *,
                 hex_unsafe: bool = False, buffer_size: int = 1 << 20
                 ) -> None:
        raw = stream if stream is not None else sys.stdout.buffer
        self._stream = (
            raw if isinstance(raw, io.BufferedWriter)
            else io.BufferedWriter(_NonClosingRaw(raw),
                                   buffer_size=buffer_size)
            if isinstance(raw, io.RawIOBase) else raw
        )
        self._own = self._stream is not raw
        self.hex_unsafe = hex_unsafe
        self.n_written = 0

    def emit(self, candidate: bytes) -> None:
        if self.hex_unsafe and needs_hex_notation(candidate):
            candidate = hex_notation_encode(candidate)
        self._stream.write(candidate)
        self._stream.write(b"\n")
        self.n_written += 1

    def write_block(self, data: bytes, n_candidates: int) -> None:
        """``n_candidates`` pre-assembled newline-terminated lines."""
        self._stream.write(data)
        self.n_written += n_candidates

    def flush(self) -> None:
        self._stream.flush()

    def close(self) -> None:
        self._stream.flush()
        if self._own:
            self._stream.close()

    def __enter__(self) -> "CandidateWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _NonClosingRaw(io.RawIOBase):
    """Raw wrapper that writes through but never closes the stream under
    it (closing ``sys.stdout.buffer`` would end the process's stdout)."""

    def __init__(self, raw: BinaryIO) -> None:
        self._raw = raw

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        return self._raw.write(b)


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
