"""Shared host-side helpers (hash reference impls, encoding)."""

from .md4 import md4  # noqa: F401
from .hexenc import hex_notation_encode  # noqa: F401
