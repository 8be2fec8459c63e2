"""The ``A5GEN_*`` environment knobs this package reads: one read point.

A copy of the reference package's ``runtime/env.py`` reduced to what the
port honours: :func:`read_env` (the ``A5GEN_*`` accessor, which also
reads ``A5_NATIVE``, the native libraries' switch),
:func:`env_warn_once` (one diagnostic per knob spelling per process),
:func:`emit_scheme` (``A5GEN_EMIT``: per-slot piece emission or the
byte-scan tiers), :func:`env_opt_out` (the on-by-default escape hatches)
and the hatches themselves: :func:`pair_enabled` (``A5GEN_PAIR``),
:func:`superstep_enabled` (``A5GEN_SUPERSTEP``),
:func:`pipeline_enabled` (``A5GEN_PIPELINE``),
:func:`stream_enabled` (``A5GEN_STREAM``) and
:func:`telemetry_enabled` (``A5GEN_TELEMETRY``); :func:`faults_spec`
(``A5GEN_FAULTS``, parsed by ``runtime/faults.py``); and the on-disk
piece-schema cache's :func:`schema_cache_dir` (``A5GEN_SCHEMA_CACHE``)
and :func:`schema_cache_max_mb` (``A5GEN_SCHEMA_CACHE_MAX_MB``).
``A5GEN_DCN_TIMEOUT`` is read by ``parallel/multihost.py``.  ``A5GEN_PALLAS``
keeps its own vocabulary at its call site, as in the reference
(``ops.fused_expand.enabled_by_env``), and ``A5GEN_CASCADE_CLOSE`` is read
by ``ops.expand_suball.close_enabled``.  Standard library only.
"""

from __future__ import annotations

import os
import sys
from typing import Optional


#: The engine's one pre-``A5GEN_`` knob, kept by name: ``A5_NATIVE=0``
#: forces the numpy / Python versions of the native host libraries.
_LEGACY_KNOBS = frozenset({"A5_NATIVE"})


def read_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """``os.environ.get`` restricted to the engine's knob namespace
    (``A5GEN_*`` plus ``A5_NATIVE``)."""
    if not name.startswith("A5GEN_") and name not in _LEGACY_KNOBS:
        raise ValueError(
            f"read_env is the A5GEN_* accessor; got {name!r} "
            "(read other variables with os.environ directly)"
        )
    return os.environ.get(name, default)


#: (name, value) pairs already warned about: accessors run per plan, and
#: one typo must produce one diagnostic, not one per call.
_WARNED: set = set()


def env_warn_once(name: str, value: str, message: str) -> None:
    """One knob diagnostic per (name, spelling) process-wide, on stderr."""
    if (name, value) in _WARNED:
        return
    _WARNED.add((name, value))
    print(f"a5gen: warning: {message}", file=sys.stderr)


def emit_scheme() -> str:
    """Message-emission scheme knob: ``A5GEN_EMIT`` selects the per-slot
    piece emission (``perslot``, the default) or the per-byte unit scan
    (``bytescan``, the A/B arm and escape hatch).  Unrecognized values
    warn once and keep the default: a typo must not silently change the
    kernels a sweep runs."""
    val = read_env("A5GEN_EMIT")
    if val is None or val in ("", "perslot"):
        return "perslot"
    if val == "bytescan":
        return "bytescan"
    env_warn_once(
        "A5GEN_EMIT", val,
        f"unrecognized A5GEN_EMIT={val!r} (want perslot|bytescan); "
        "keeping the default (perslot)",
    )
    return "perslot"


def env_opt_out(name: str, default_desc: str) -> bool:
    """Shared parse for the on-by-default escape hatches: True when the
    hatch is pulled (``off``/``0``/``no``).  Any other value outside the
    on-spellings (empty/``auto``/``on``/``1``) warns once and keeps the
    default — a typo must not silently change behavior."""
    val = read_env(name) or ""
    if val.lower() in ("off", "0", "no"):
        return True
    if val.lower() not in ("", "auto", "on", "1"):
        env_warn_once(
            name, val,
            f"unrecognized {name}={val!r} (want off|0|no or on|1|auto); "
            f"keeping the default ({default_desc})",
        )
    return False


def pair_enabled() -> bool:
    """``A5GEN_PAIR`` set to ``off``/``0``/``no`` pins K=1 (one candidate
    per hash lane) instead of the pair tier where the schema allows.  The
    candidate and hit streams are the same either way."""
    return not env_opt_out(
        "A5GEN_PAIR", "pair-lane (K=2) tier on for eligible schemas")


def superstep_enabled() -> bool:
    """``A5GEN_SUPERSTEP`` set to ``off``/``0``/``no`` runs every sweep on
    the per-launch pipeline (``runtime.sweep``), as ``--superstep off``
    does.  The candidate and hit streams are the same either way."""
    return not env_opt_out(
        "A5GEN_SUPERSTEP", "superstep on for eligible crack sweeps")


def pipeline_enabled() -> bool:
    """``A5GEN_PIPELINE`` set to ``off``/``0``/``no`` runs the barriered
    superstep drive: each superstep's fetch is waited on before the next
    dispatch.  The candidate and hit streams are the same either way."""
    return not env_opt_out("A5GEN_PIPELINE", "pipelined superstep drive")


def stream_enabled() -> bool:
    """``A5GEN_STREAM`` set to ``off``/``0``/``no`` compiles the whole
    dictionary's plan up front instead of streaming it in word chunks
    (``runtime.sweep``), as ``--stream-chunk-words off`` does.  The
    candidate and hit streams are the same either way."""
    return not env_opt_out(
        "A5GEN_STREAM", "streaming plan pipeline for chunked dictionaries")


def telemetry_enabled() -> bool:
    """``A5GEN_TELEMETRY`` set to ``off``/``0``/``no`` disables the
    hot-path instrumentation: span-timeline appends, per-fetch registry
    updates, progress enrichment.  The hatch changes observability, never
    results."""
    return not env_opt_out(
        "A5GEN_TELEMETRY", "telemetry registry + span timeline on")


def faults_spec() -> "Optional[str]":
    """Deterministic fault-injection arming: ``A5GEN_FAULTS`` holds a
    fault-plan spec (grammar in ``runtime/faults.py``, e.g.
    ``superstep.dispatch:nth=2``); empty/unset = nothing armed.  Parsed
    at ``Sweep`` construction, never at import; a malformed spec fails
    loudly there."""
    return read_env("A5GEN_FAULTS") or None


def schema_cache_dir() -> "Optional[str]":
    """On-disk PieceSchema cache directory (``A5GEN_SCHEMA_CACHE``;
    empty/unset = no persistent cache).  ``SweepConfig.schema_cache`` /
    ``--schema-cache`` override this per run."""
    return read_env("A5GEN_SCHEMA_CACHE") or None


def schema_cache_max_mb() -> "Optional[float]":
    """LRU size cap (MB) on the on-disk PieceSchema cache
    (``A5GEN_SCHEMA_CACHE_MAX_MB``; empty/unset = unbounded).
    ``SweepConfig.schema_cache_max_mb`` / ``--schema-cache-max-mb``
    override this per run; an unparseable value warns once and keeps
    the cache unbounded — a typo must not start evicting."""
    val = read_env("A5GEN_SCHEMA_CACHE_MAX_MB")
    if val in (None, ""):
        return None
    try:
        mb = float(val)
        if mb <= 0:
            raise ValueError
    except ValueError:
        env_warn_once(
            "A5GEN_SCHEMA_CACHE_MAX_MB", val,
            f"unrecognized A5GEN_SCHEMA_CACHE_MAX_MB={val!r} (want a "
            "positive number of megabytes); keeping the cache "
            "unbounded",
        )
        return None
    return mb
