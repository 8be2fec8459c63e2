"""Byte-exact CPU generation engines: the oracle backend (the CLI's
default), its ``--threads N`` merge (``oracle.parallel``), the exact
keyspace counts (``oracle.keyspace``), and the oracle route of the crack
sweep's fallback words."""

from .engines import (  # noqa: F401
    ReferencePanic,
    iter_candidates,
    process_word,
    process_word_reverse,
    process_word_substitute_all,
    process_word_substitute_all_reverse,
)
from .keyspace import (  # noqa: F401
    count_candidates,
    find_spans,
    unique_patterns,
)
