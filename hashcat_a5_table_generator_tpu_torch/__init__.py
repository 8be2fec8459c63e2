"""tpu-a5 on PyTorch and CUDA: the substitution-attack crack engine for an
NVIDIA Hopper GPU.

The PyTorch/CUDA port of ``hashcat_a5_table_generator_tpu`` (the JAX/TPU
package, which stays the reference).  It imports ``torch`` and numpy only.
It covers the single-GPU crack sweep in default, reverse (``-r``),
substitute-all (``-s``) and substitute-all reverse mode for MD5, MD4, SHA-1
and NTLM: tables are compiled on the host, the per-slot piece schema and
block index are shipped to the device once per sweep, and every superstep
cuts its blocks, expands + hashes each candidate in the hand-written piece
kernel (``csrc/piece_hash.cu``: scalar, digit and count-windowed decodes,
match and substitute-all selectors, the cascade closure, one or two
candidates per thread), tests digest membership and compacts hits on the
device; only the counters and the hit slice come back.  Substitute-all
words no plan can splice exactly go through the host oracle.  The CLI's
default backend is that oracle (``--backend oracle``: the byte-exact
engines in the reference's DFS order, native C++ where eligible,
``--threads N`` over worker processes).

Layer map (same names as the reference package):
  tables/    — table parsing, merging, $HEX codec, layouts, compilation
  oracle/    — the byte-exact CPU generation engines (the oracle backend,
               fallback words), keyspace counts, the --threads merge
  native/    — C++ host hot paths (wordlist scan/pack, the oracle
               engines), built with g++ at first use, ctypes bindings
  ops/       — packing, piece schema, block index, match and substitute-all
               plans, hashes, membership, the piece-kernel wrapper and its
               plain PyTorch version
  csrc/      — the CUDA C++ kernels (built with nvcc at first use)
  models/    — the attack spec, host plans, device arrays, the superstep body
  runtime/   — the crack sweep loop, length buckets, hit sinks
  utils/     — host digests, $HEX encoding

Every entry point of the device path takes an explicit device
(``SweepConfig.device``, CLI ``--device``) and defaults to ``cuda``; it
never moves to the CPU on its own.  The oracle backend never touches
CUDA.
"""

__version__ = "0.1.0"

from .tables.parser import (  # noqa: F401
    HexDecodeError,
    decode_hex_notation,
    merge_substitution_tables,
    parse_substitution_table,
    read_substitution_table,
)
from .oracle.engines import (  # noqa: F401
    ReferencePanic,
    iter_candidates,
    process_word,
    process_word_reverse,
    process_word_substitute_all,
    process_word_substitute_all_reverse,
)
