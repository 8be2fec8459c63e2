"""Byte-exact CPU generation engines: the oracle route of the crack sweep's
fallback words."""

from .engines import (  # noqa: F401
    ReferencePanic,
    iter_candidates,
    process_word,
    process_word_reverse,
    process_word_substitute_all,
    process_word_substitute_all_reverse,
)
