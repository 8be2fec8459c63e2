"""Substitution-table subsystem: parsing, merging, $HEX codec, layout emitters,
and compilation of merged tables into dense arrays for the device backend."""

from .parser import (  # noqa: F401
    HexDecodeError,
    TableLineError,
    decode_hex_notation,
    merge_substitution_tables,
    parse_substitution_table,
    read_substitution_table,
)
