"""The ``@audited_entry`` registry: the port's semantic-audit surface.

The reference's ``audit.py``: kernels, integer stages and step builders
declare themselves with :func:`audited_entry`, so the port's audit checks
have a mechanical answer to "which callables must uphold which
invariants?".  The checks are the port's counterparts of
``tools/graftaudit``'s, written with what torch and the card offer:

* ``tests/test_torch_audit.py`` (CPU): integer purity under a torch
  dispatch mode, the declared stages of each fused body called and
  reaching its hits, no host-sync op inside a body step, and the kernel
  resource pins (``csrc/kernel_budgets.json``) naming exactly the
  instantiations the ``budget_keys`` and the CUDA sources declare;
* ``chip_smoke.py`` phase 13 (the card): every instantiation's ptxas
  registers, stack and spills within its pin, and each fused body run
  once at full width under ``torch.cuda.set_sync_debug_mode("error")``.

Stdlib-only on purpose: importing this module pulls in neither torch nor
anything of ``tools/``; registration is metadata, so the registry is safe
to populate at import time from ``ops/`` and ``models/``.

Entry kinds (what the audit does with the entry):

* ``"cuda_kernel"``    — a hand-written CUDA kernel's wrapper (the
  reference's ``"pallas_kernel"``); its plain PyTorch version is checked
  for integer purity, and ``budget_keys`` names the kernel
  instantiations it launches (``library:kernel<template arguments after
  the hash>``), each pinned in ``csrc/kernel_budgets.json``.
* ``"integer_stage"``  — a hash/membership primitive that must produce
  no floating-point tensor.
* ``"fused_body"``     — an end-to-end expand→hash→membership body; its
  declared stages must run and reach the hits, with no host sync inside.
* ``"sharded_body"``   — kept from the reference's vocabulary; the port
  registers none (a cursor stripe runs the ``fused_body`` entries with a
  stripe advance, no ``shard_map`` twin).

``stages``: the pipeline stages that must survive into the body (any of
``"expand"``, ``"hash"``, ``"membership"``) — only meaningful for the
body kinds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple, TypeVar

#: Decoration preserves the wrapped callable's exact type (the strict-
#: typed ``models``/``ops`` surfaces must not erase to bare Callable).
_F = TypeVar("_F", bound=Callable)

#: Valid ``kind`` values, in the order the audit reports them.
ENTRY_KINDS = (
    "cuda_kernel",
    "integer_stage",
    "fused_body",
    "sharded_body",
)

#: Valid ``stages`` members.
PIPELINE_STAGES = ("expand", "hash", "membership")


@dataclass(frozen=True)
class AuditedEntry:
    """One registered audit target (metadata only — no example inputs)."""

    name: str
    fn: Callable
    kind: str
    #: Pipeline stages that must run and reach the result (body kinds).
    stages: Tuple[str, ...] = ()
    #: The kernel instantiations the entry launches, each a key of
    #: ``csrc/kernel_budgets.json`` (cuda kernels).
    budget_keys: Tuple[str, ...] = ()
    module: str = ""
    qualname: str = ""


#: name -> entry; populated by decoration at module import.
AUDIT_REGISTRY: Dict[str, AuditedEntry] = {}


def audited_entry(
    name: str,
    *,
    kind: str,
    stages: Tuple[str, ...] = (),
    budget_keys: Tuple[str, ...] = (),
) -> Callable[[_F], _F]:
    """Register the decorated callable as a semantic-audit entry point.

    Pure bookkeeping: the callable is returned unchanged (zero runtime
    overhead on the hot path), and duplicate names raise at import time
    so two kernels can never silently shadow one audit slot.
    """
    if kind not in ENTRY_KINDS:
        raise ValueError(
            f"audited_entry {name!r}: unknown kind {kind!r}; "
            f"one of {ENTRY_KINDS}"
        )
    for stage in stages:
        if stage not in PIPELINE_STAGES:
            raise ValueError(
                f"audited_entry {name!r}: unknown stage {stage!r}; "
                f"members must be in {PIPELINE_STAGES}"
            )

    def deco(fn: _F) -> _F:
        existing = AUDIT_REGISTRY.get(name)
        if existing is not None and (
            existing.module != fn.__module__
            or existing.qualname != fn.__qualname__
        ):
            raise ValueError(
                f"audited_entry {name!r} registered twice "
                f"({existing.module}.{existing.qualname} and "
                f"{fn.__module__}.{fn.__qualname__})"
            )
        # Same module+qualname: idempotent re-registration, so
        # importlib.reload of an audited module (a pattern the test
        # suite uses) refreshes the entry instead of raising.
        AUDIT_REGISTRY[name] = AuditedEntry(
            name=name,
            fn=fn,
            kind=kind,
            stages=tuple(stages),
            budget_keys=tuple(budget_keys),
            module=fn.__module__,
            qualname=fn.__qualname__,
        )
        return fn

    return deco


def registered_entries() -> Dict[str, AuditedEntry]:
    """Snapshot of the registry (import the audited modules first:
    ``ops.fused_expand``, ``ops.bytescan``, ``ops.buffer_hash``,
    ``ops.hashes``, ``ops.membership`` and ``models.attack``)."""
    return dict(AUDIT_REGISTRY)
