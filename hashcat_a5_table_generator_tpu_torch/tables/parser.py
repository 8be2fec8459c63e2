"""Substitution-table parser (layer L2 of SURVEY.md §1).

Byte-exact reimplementation of the reference's table ingestion
(``readSubstitutionTable`` + ``decodeHexNotation``, reference ``main.go:108-162``),
with the parity-critical behaviors preserved:

* line format ``key=value``, split at the FIRST ``=`` only
  (``main.go:123``): the key may not contain a literal ``=`` (use ``$HEX[3d]``),
  the value may; a line ``=x`` (or ``==x``) yields an *empty key* entry, which is
  inert in default/reverse modes (match length >= 1) but live in the
  substitute-all modes (SURVEY.md §2.1).
* blank lines and ``#`` comments skipped (``main.go:118-121``); lines without
  ``=`` silently skipped (``main.go:124-126``).
* ``$HEX[...]`` decoding on both sides; embedded spaces stripped;
  case-insensitive hex; a malformed hex side causes the LINE to be logged and
  skipped, not a fatal error (``main.go:129-139``).
* keys and values are arbitrary **byte strings** — multi-char keys
  (``ss=ß``) and multi-byte UTF-8 both work; values are appended per key, so
  duplicate lines produce duplicate candidates downstream (no dedupe — Q7).
* merging multiple table files appends values per key in file order
  (``main.go:40-50``).

Known, documented divergences from the Go binary (degenerate inputs only):

* Go trims lines with the Unicode-aware ``strings.TrimSpace``. We trim
  Unicode whitespace when the line is valid UTF-8 and ASCII whitespace
  otherwise; ASCII control chars 0x1c-0x1f are stripped by Python's
  ``str.strip`` but not by Go's ``unicode.IsSpace``.
* Go's ``bufio.Scanner`` aborts the whole file on a line longer than 64 KiB
  (the caller then ``log.Fatal``'s). We raise :class:`TableLineError` for the
  same condition (configurable via ``max_line_bytes``).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, List, Mapping

logger = logging.getLogger("tpu_a5.tables")

SubstitutionMap = Dict[bytes, List[bytes]]

#: Go bufio.Scanner's default MaxScanTokenSize (reference main.go:117; Q8).
GO_SCANNER_LIMIT = 64 * 1024


class HexDecodeError(ValueError):
    """A ``$HEX[...]`` payload failed to decode (odd length / non-hex chars).

    Mirrors the error from Go's ``hex.DecodeString`` (``main.go:157-159``); at
    the file level the offending line is logged and skipped, matching
    ``main.go:129-139``.
    """


class TableLineError(ValueError):
    """A table line exceeded the scanner limit (Go would abort the file)."""


def _trim_space(line: bytes) -> bytes:
    """Approximate Go ``strings.TrimSpace`` on raw bytes (see module docstring)."""
    try:
        return line.decode("utf-8").strip().encode("utf-8")
    except UnicodeDecodeError:
        return line.strip(b" \t\n\v\f\r")


def decode_hex_notation(value: bytes) -> bytes:
    """Decode hashcat ``$HEX[...]`` notation to raw bytes (``main.go:147-162``).

    Pass-through (returned as-is) when the value is not wrapped in
    ``$HEX[``...``]`` or is shorter than 7 bytes — so the 6-byte literal
    ``$HEX[]`` is returned verbatim, exactly as in the reference
    (``main.go:149``). Embedded spaces are stripped (space-delimited hex is
    accepted, reference ``README.MD:172-176``); hex digits are
    case-insensitive. Raises :class:`HexDecodeError` on a malformed payload.
    """
    if len(value) < 7 or not value.startswith(b"$HEX[") or not value.endswith(b"]"):
        return value
    hex_str = value[5:-1].replace(b" ", b"")
    try:
        return bytes.fromhex(hex_str.decode("ascii"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise HexDecodeError(f"invalid hex string {hex_str!r}: {exc}") from None


def parse_substitution_table(
    data: bytes,
    *,
    source: str = "<bytes>",
    max_line_bytes: int = GO_SCANNER_LIMIT,
    on_skip: Callable[[str], None] | None = None,
) -> SubstitutionMap:
    """Parse table bytes into ``{key: [value, ...]}`` (``main.go:108-144``).

    ``on_skip`` is invoked with a message for each line skipped due to a bad
    ``$HEX[]`` payload (default: logged to stderr, as the reference does with
    ``log.Printf``). Lines with no ``=`` are skipped *silently*, matching the
    reference (``main.go:124-126``).
    """
    report = on_skip if on_skip is not None else logger.warning
    substitutions: SubstitutionMap = {}
    for raw in data.split(b"\n"):
        if raw.endswith(b"\r"):  # bufio.ScanLines drops a trailing \r
            raw = raw[:-1]
        if len(raw) > max_line_bytes:
            raise TableLineError(
                f"{source}: line longer than {max_line_bytes} bytes "
                "(Go bufio.Scanner would abort here — Q8)"
            )
        line = _trim_space(raw)
        if not line or line.startswith(b"#"):
            continue
        parts = line.split(b"=", 1)
        if len(parts) != 2:
            continue  # silently skipped, main.go:124-126
        key_part, value_part = parts
        try:
            key = decode_hex_notation(key_part)
        except HexDecodeError as exc:
            report(f"Error decoding hex notation in key: {line!r} - {exc}")
            continue
        try:
            value = decode_hex_notation(value_part)
        except HexDecodeError as exc:
            report(f"Error decoding hex notation in value: {line!r} - {exc}")
            continue
        substitutions.setdefault(key, []).append(value)
    return substitutions


def read_substitution_table(
    path: str,
    *,
    max_line_bytes: int = GO_SCANNER_LIMIT,
    on_skip: Callable[[str], None] | None = None,
) -> SubstitutionMap:
    """Read and parse one table file (reference ``readSubstitutionTable``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    return parse_substitution_table(
        data, source=path, max_line_bytes=max_line_bytes, on_skip=on_skip
    )


def merge_substitution_tables(
    tables: Iterable[Mapping[bytes, List[bytes]]],
) -> SubstitutionMap:
    """Merge parsed tables in order, APPENDING values per key (``main.go:40-50``).

    Later tables add *alternative* substitutions for existing keys; there is no
    dedupe, so the same mapping in two files yields duplicate candidates (Q7).
    """
    merged: SubstitutionMap = {}
    for table in tables:
        for key, values in table.items():
            merged.setdefault(key, []).extend(values)
    return merged


def load_tables(paths: Iterable[str], **kwargs: Any) -> SubstitutionMap:
    """Read + merge several table files, as the reference CLI does."""
    return merge_substitution_tables(
        read_substitution_table(p, **kwargs) for p in paths
    )
