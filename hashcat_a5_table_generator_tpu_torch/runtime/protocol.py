"""The serve wire contract, declared once: the reference package's
``runtime/protocol.py``, copied.

The JSONL protocol that the engine session (``runtime/engine.py``) and
every client speak is the system's compatibility boundary, so it is
enumerable here rather than scattered across string-literal dicts:

* :data:`WIRE_OPS` / :data:`WIRE_EVENTS` — every op and event, their
  required and optional fields, which role handles or emits each, and
  the declared asymmetries (router-built events the engine never emits
  carry ``route: "synthesized"`` with a note).
* :data:`CHECKPOINT_WIRE` — the checkpoint wire doc's version and
  required fields, mirrored from ``runtime/checkpoint.py`` (an
  import-time assert keeps the two from drifting).
* Constructors (``ev_*`` / ``op_*``) — the one place each doc shape is
  built.  Key insertion order is the wire order: JSONL byte parity with
  the reference depends on it.
* ``doc_op`` / ``doc_event`` — the dispatch-side reads.

``PROTOCOL.json`` at the repository root pins the registry (version
:data:`PROTOCOL_VERSION`); this module's registry equals it.  The
registry literals are pure, so ``json`` round-trips them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, MutableMapping, Optional

from .checkpoint import _WIRE_REQUIRED, WIRE_VERSION

__all__ = [
    "PROTOCOL_VERSION",
    "K_OP",
    "K_EVENT",
    "OP_DEFAULT",
    "WIRE_OPS",
    "WIRE_EVENTS",
    "CHECKPOINT_WIRE",
    "doc_op",
    "doc_event",
    "op_submit",
    "op_pause",
    "op_cancel",
    "op_split",
    "op_stats",
    "op_metrics",
    "op_shutdown",
    "ev_accepted",
    "ev_hit",
    "ev_done",
    "ev_paused",
    "ev_cancelled",
    "ev_failed",
    "ev_refused",
    "ev_shard_done",
    "ev_range_reassign",
    "ev_migrating",
    "ev_draining",
    "ev_stats",
    "ev_metrics",
    "ev_error",
    "ev_error_overloaded",
    "ev_bye",
    "validate_doc",
]

#: The wire contract's own version (MAJOR.MINOR), independent of the
#: checkpoint doc's ``wire_version``: field/op/event ADDITIONS bump the
#: minor (old readers ignore unknown fields), removals/renames bump the
#: major.  ``--update-protocol`` refuses a re-pin that violates this.
PROTOCOL_VERSION = "1.2"

#: The two envelope keys.  Outside this module they are banned as raw
#: string literals in the reference (its wire lint) —
#: dispatch reads go through :func:`doc_op` / :func:`doc_event`,
#: emissions through the constructors below.
K_OP = "op"
K_EVENT = "event"

#: A document with no ``op`` is a submit (the serve tier's historical
#: default — bare job docs piped into ``a5gen serve`` just work).
OP_DEFAULT = "submit"

#: Every op a session dispatches.  ``handlers`` names the roles whose
#: session MUST decide the op (the reference's wire audit diffs this
#: against its sessions' ``_handle`` tables):
#: ``engine`` = ``_JsonlSession``, ``router`` = ``_RouterSession``.
#: The router additionally forwards unknown id-carrying ops verbatim
#: (``ROUTER_PASSTHROUGH_OPS`` + the fallback branch), so engine-only
#: ops stay fleet-compatible without a router release.
WIRE_OPS: Dict[str, Dict[str, Any]] = {
    "submit": {
        "required": [],
        "optional": [
            "id", "tables", "table_map", "dict", "words",
            "digests", "digest_list", "algo", "mode",
            "table_min", "table_max", "config", "checkpoint",
            "replay_mute", "output", "tenant", "deadline_s",
        ],
        "handlers": ["engine", "router"],
        "default": True,
        "note": (
            "tenant/deadline_s are router-side admission fields; the "
            "router strips checkpoint/replay_mute into its own replay "
            "origin and re-injects them on dispatch"
        ),
    },
    "pause": {
        "required": ["id"],
        "optional": [],
        "handlers": ["engine", "router"],
    },
    "resume": {
        "required": ["id"],
        "optional": [],
        "handlers": ["engine", "router"],
    },
    "cancel": {
        "required": ["id"],
        "optional": [],
        "handlers": ["engine", "router"],
    },
    "migrate": {
        "required": ["id"],
        "optional": ["engine"],
        "handlers": ["router"],
        "note": (
            "router-only: rebalance one running job (pause -> "
            "checkpoint over the wire -> resubmit); the engine never "
            "sees it"
        ),
    },
    "drain": {
        "required": ["engine"],
        "optional": [],
        "handlers": ["router"],
        "note": (
            "router-only: stop placements on one engine and migrate "
            "every routed job off it (the autoscaler's reap half)"
        ),
    },
    "split": {
        "required": ["id"],
        "optional": ["shards"],
        "handlers": ["router"],
        "note": (
            "router-only: scatter one running crack job's superstep "
            "block lattice across shards engines as disjoint "
            "rank-stride pod ranges (pause -> checkpoint -> N shard "
            "resubmits); the merged client stream stays (word,rank)-"
            "ordered and exactly-once, and each shard checkpoint "
            "stays interchangeable with a solo resume"
        ),
    },
    "stats": {
        "required": [],
        "optional": [],
        "handlers": ["engine", "router"],
    },
    "metrics": {
        "required": [],
        "optional": [],
        "handlers": ["engine", "router"],
    },
    "shutdown": {
        "required": [],
        "optional": [],
        "handlers": ["engine", "router"],
    },
}

#: Every event a session emits.  ``emitters`` names who builds it;
#: ``route`` declares the router's event-plane decision for it
#: (the reference's wire audit checks ``dispatch`` events against the
#: ``_on_job_event`` chain):
#:
#: * ``dispatch`` — engine-emitted per-job event the router handles
#:   explicitly (mute/settle/validate logic).
#: * ``passthrough`` — per-job event the router's fallback forwards
#:   verbatim (future engine events stay fleet-compatible).
#: * ``control`` — request-plane reply consumed by
#:   ``EngineLink.request``/``health_request`` (id-less, or correlated
#:   to the op that asked); never enters the event plane.
#: * ``synthesized`` — router-built and client-facing only: a DECLARED
#:   sender/handler asymmetry (the engine never emits it), with the
#:   justification in ``note``.
WIRE_EVENTS: Dict[str, Dict[str, Any]] = {
    "accepted": {
        "required": ["id", "kind"],
        "optional": ["engine", "queued", "resumed", "shards"],
        "emitters": ["engine", "router"],
        "route": "control",
        "note": (
            "the engine's ack answers the router's dispatch request "
            "plane; the router synthesizes its own client-facing ack "
            "with the engine/queued additions (which engine the job "
            "placed on — null while admission-queued — and whether it "
            "waits in the pending queue); shards appends only on a "
            "split scatter's ack (how many rank-stride shard ranges "
            "the job fanned out over)"
        ),
    },
    "hit": {
        "required": ["id", "digest", "plain_hex", "word_index", "rank"],
        "optional": [],
        "emitters": ["engine"],
        "route": "dispatch",
        "note": (
            "rank is a decimal string: variant spaces exceed JSON's "
            "safe ints"
        ),
    },
    "done": {
        "required": ["id", "n_hits", "n_emitted", "wall_s", "resumed"],
        "optional": ["ttfc_s", "schema_cache", "spans"],
        "emitters": ["engine"],
        "route": "dispatch",
    },
    "paused": {
        "required": ["id", "checkpoint"],
        "optional": ["spans"],
        "emitters": ["engine"],
        "route": "dispatch",
        "note": "checkpoint is the CHECKPOINT_WIRE doc (a paused job "
                "IS its checkpoint)",
    },
    "cancelled": {
        "required": ["id"],
        "optional": [],
        "emitters": ["engine", "router"],
        "route": "dispatch",
        "note": (
            "router-emitted for jobs nothing runs engine-side "
            "(paused or admission-queued cancels)"
        ),
    },
    "failed": {
        "required": ["id", "error"],
        "optional": [
            "reason", "retry_after_s", "checkpoint",
            "checkpoint_invalid",
        ],
        "emitters": ["engine", "router"],
        "route": "dispatch",
        "note": (
            "checkpoint is the quarantine token (resubmittable replay "
            "origin); checkpoint_invalid replaces it when capture-time "
            "validation rejected the doc; error=overloaded sheds "
            "carry reason + retry_after_s"
        ),
    },
    "refused": {
        "required": ["id"],
        "optional": ["jobs", "fill"],
        "emitters": ["engine"],
        "route": "passthrough",
        "note": (
            "dynamic re-fuse notification (PERF.md 28): the job's "
            "fused group dropped below the fill threshold after a "
            "tenant departed and its survivors were re-fused into a "
            "tighter group; jobs = survivor count, fill = the "
            "triggering fill ratio.  Informational — streams, "
            "checkpoints and results are unchanged — so the router's "
            "fallback forwards it verbatim"
        ),
    },
    "shard_done": {
        "required": ["id", "shard", "shards"],
        "optional": ["engine", "n_hits"],
        "emitters": ["router"],
        "route": "synthesized",
        "note": (
            "router-synthesized split-job progress: shard (0-based "
            "stripe index) of shards finished its disjoint block "
            "range on engine with n_hits forwarded into the merge; "
            "the engine only ever sees ordinary pod-striped crack "
            "jobs, so it never emits this"
        ),
    },
    "range_reassign": {
        "required": ["id", "shard", "shards"],
        "optional": ["from", "to", "acked"],
        "emitters": ["router"],
        "route": "synthesized",
        "note": (
            "router-synthesized split-job recovery: shard's block "
            "range moved engines (from -> to) after a death or "
            "rebalance, resuming from its last acked checkpoint "
            "boundary with acked hits muted — never replayed into "
            "the client"
        ),
    },
    "migrating": {
        "required": ["id", "from", "to"],
        "optional": ["noop"],
        "emitters": ["router"],
        "route": "synthesized",
        "note": (
            "router-synthesized migrate ack (to='(placement)' when "
            "the target is placement-chosen); the engine has no "
            "migrate op to answer"
        ),
    },
    "draining": {
        "required": ["engine", "jobs"],
        "optional": [],
        "emitters": ["router"],
        "route": "synthesized",
        "note": (
            "router-synthesized drain ack (jobs = count set "
            "migrating); drain never reaches an engine"
        ),
    },
    "stats": {
        "required": [],
        "optional": [],
        "open": True,
        "emitters": ["engine", "router"],
        "route": "control",
        "note": (
            "open doc: the engine's counter scrape spread flat (the "
            "router sums live engines and adds a fleet section), so "
            "the field set is the stats surface, not a fixed schema"
        ),
    },
    "metrics": {
        "required": ["metrics", "prometheus"],
        "optional": [],
        "emitters": ["engine", "router"],
        "route": "control",
    },
    "error": {
        "required": ["error"],
        "optional": ["id", "reason", "retry_after_s"],
        "emitters": ["engine", "router"],
        "route": "passthrough",
        "note": (
            "correlated replies answer the request plane; an "
            "id-carrying error with no waiter rides the event plane's "
            "fallback to the client.  error=overloaded (typed "
            "admission rejection) carries reason + retry_after_s"
        ),
    },
    "bye": {
        "required": [],
        "optional": [],
        "emitters": ["engine", "router"],
        "route": "control",
    },
}

#: The checkpoint wire doc (the pause/migrate handoff payload and the
#: replicated-ledger handoff guarantee): mirrored from
#: ``runtime/checkpoint.py`` so the pin covers it; the assert below
#: fails the import if the two modules ever disagree.
CHECKPOINT_WIRE: Dict[str, Any] = {
    "version": "1.0",
    "required": [
        "fingerprint", "cursor", "n_emitted", "n_hits", "hits",
        "wall_s",
    ],
    "note": (
        "minor-newer docs may carry unknown extra fields; "
        "state_from_doc -> state_to_doc round-trips them verbatim"
    ),
}

assert CHECKPOINT_WIRE["version"] == WIRE_VERSION, (
    "protocol.CHECKPOINT_WIRE drifted from checkpoint.WIRE_VERSION"
)
assert CHECKPOINT_WIRE["required"] == list(_WIRE_REQUIRED), (
    "protocol.CHECKPOINT_WIRE drifted from checkpoint._WIRE_REQUIRED"
)

#: Sentinel distinguishing "key absent" from "key present with None"
#: (the router's accepted ack carries ``engine: null`` while a job is
#: admission-queued).
_UNSET: Any = object()


# ---------------------------------------------------------------------------
# Dispatch-side reads
# ---------------------------------------------------------------------------


def doc_op(doc: Mapping[str, Any]) -> Any:
    """The op a command doc names (:data:`OP_DEFAULT` when absent)."""
    return doc.get(K_OP, OP_DEFAULT)


def doc_event(ev: Mapping[str, Any]) -> Any:
    """The event kind of a reply/event doc (None when absent)."""
    return ev.get(K_EVENT)


# ---------------------------------------------------------------------------
# Op constructors (what the router sends its engines)
# ---------------------------------------------------------------------------


def op_submit(sdoc: MutableMapping[str, Any]) -> MutableMapping[str, Any]:
    """Stamp the submit op onto a sanitized job doc IN PLACE (the
    client's fields keep their wire order; ``op`` lands where the
    client put it, or appends) and return it — the router's
    re-submittable replay origin."""
    sdoc[K_OP] = "submit"
    return sdoc


def op_pause(jid: str) -> Dict[str, Any]:
    return {K_OP: "pause", "id": jid}


def op_cancel(jid: str) -> Dict[str, Any]:
    return {K_OP: "cancel", "id": jid}


def op_split(jid: str, *, shards: Optional[int] = None
             ) -> Dict[str, Any]:
    """The router-only split op: scatter one running crack job across
    ``shards`` engines (placement-chosen when omitted)."""
    doc: Dict[str, Any] = {K_OP: "split", "id": jid}
    if shards is not None:
        doc["shards"] = shards
    return doc


def op_stats() -> Dict[str, Any]:
    return {K_OP: "stats"}


def op_metrics() -> Dict[str, Any]:
    return {K_OP: "metrics"}


def op_shutdown() -> Dict[str, Any]:
    return {K_OP: "shutdown"}


# ---------------------------------------------------------------------------
# Event constructors (one per declared event; key order is the wire
# order the fleet byte-parity suites pin)
# ---------------------------------------------------------------------------


def ev_accepted(
    jid: Any,
    kind: Any,
    *,
    engine: Any = _UNSET,
    queued: bool = False,
    resumed: bool = False,
    shards: Optional[int] = None,
) -> Dict[str, Any]:
    """The admission ack.  ``engine`` is router-only (pass even when
    None — a queued job's ack carries ``engine: null``); ``queued`` /
    ``resumed`` append only when set, matching the historical docs;
    ``shards`` appends only on a split scatter's ack."""
    ev: Dict[str, Any] = {"id": jid, K_EVENT: "accepted", "kind": kind}
    if engine is not _UNSET:
        ev["engine"] = engine
    if queued:
        ev["queued"] = True
    if resumed:
        ev["resumed"] = True
    if shards is not None:
        ev["shards"] = int(shards)
    return ev


def ev_hit(
    jid: Any,
    *,
    digest: str,
    plain_hex: str,
    word_index: int,
    rank: str,
) -> Dict[str, Any]:
    return {
        "id": jid, K_EVENT: "hit",
        "digest": digest,
        "plain_hex": plain_hex,
        "word_index": word_index,
        "rank": rank,
    }


def ev_done(
    jid: Any,
    *,
    n_hits: int,
    n_emitted: int,
    wall_s: float,
    resumed: bool,
    ttfc_s: Optional[float] = None,
    schema_cache: Any = None,
    spans: Any = None,
) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "id": jid, K_EVENT: "done",
        "n_hits": n_hits, "n_emitted": n_emitted,
        "wall_s": wall_s, "resumed": resumed,
    }
    if ttfc_s is not None:
        ev["ttfc_s"] = ttfc_s
    if schema_cache:
        ev["schema_cache"] = schema_cache
    if spans:
        ev["spans"] = spans
    return ev


def ev_paused(
    jid: Any, checkpoint: Dict[str, Any], *, spans: Any = None
) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "id": jid, K_EVENT: "paused",
        "checkpoint": checkpoint,
    }
    if spans:
        ev["spans"] = spans
    return ev


def ev_cancelled(jid: Any) -> Dict[str, Any]:
    return {"id": jid, K_EVENT: "cancelled"}


def ev_failed(
    jid: Any,
    error: str,
    *,
    reason: Optional[str] = None,
    retry_after_s: Optional[float] = None,
    checkpoint: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The failure event.  ``reason``/``retry_after_s`` are the typed
    overload shed's fields; ``checkpoint`` is the quarantine token
    — appended last, matching the historical docs."""
    ev: Dict[str, Any] = {"id": jid, K_EVENT: "failed", "error": error}
    if reason is not None:
        ev["reason"] = reason
    if retry_after_s is not None:
        ev["retry_after_s"] = retry_after_s
    if checkpoint is not None:
        ev["checkpoint"] = checkpoint
    return ev


def ev_refused(
    jid: Any,
    *,
    jobs: Optional[int] = None,
    fill: Optional[float] = None,
) -> Dict[str, Any]:
    """The dynamic re-fuse notification: this job's
    fused group fell below the fill threshold and its survivors were
    re-fused into a tighter group.  Informational — the job's stream,
    checkpoints and results are unchanged."""
    ev: Dict[str, Any] = {"id": jid, K_EVENT: "refused"}
    if jobs is not None:
        ev["jobs"] = jobs
    if fill is not None:
        ev["fill"] = fill
    return ev


def ev_shard_done(
    jid: Any,
    *,
    shard: int,
    shards: int,
    engine: Optional[str] = None,
    n_hits: Optional[int] = None,
) -> Dict[str, Any]:
    """Router-synthesized split-job progress: one shard's disjoint
    block range finished; the merged client stream keeps flowing from
    the other shards."""
    ev: Dict[str, Any] = {
        "id": jid, K_EVENT: "shard_done",
        "shard": shard, "shards": shards,
    }
    if engine is not None:
        ev["engine"] = engine
    if n_hits is not None:
        ev["n_hits"] = n_hits
    return ev


def ev_range_reassign(
    jid: Any,
    *,
    shard: int,
    shards: int,
    frm: Optional[str] = None,
    to: Optional[str] = None,
    acked: Optional[int] = None,
) -> Dict[str, Any]:
    """Router-synthesized split-job recovery: one shard's block range
    moved engines, resuming from its last acked checkpoint boundary
    with ``acked`` already-forwarded hits muted."""
    ev: Dict[str, Any] = {
        "id": jid, K_EVENT: "range_reassign",
        "shard": shard, "shards": shards,
    }
    if frm is not None:
        ev["from"] = frm
    if to is not None:
        ev["to"] = to
    if acked is not None:
        ev["acked"] = acked
    return ev


def ev_migrating(
    jid: Any, *, frm: str, to: str, noop: bool = False
) -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "id": jid, K_EVENT: "migrating", "from": frm, "to": to,
    }
    if noop:
        ev["noop"] = True
    return ev


def ev_draining(engine_id: str, jobs: int) -> Dict[str, Any]:
    return {K_EVENT: "draining", "engine": engine_id, "jobs": jobs}


def ev_stats(
    payload: Mapping[str, Any], *, fleet: Any = _UNSET
) -> Dict[str, Any]:
    """The stats reply: ``payload`` (the counter scrape) spreads flat
    after the event key; the router's merged form appends its
    ``fleet`` section last."""
    ev: Dict[str, Any] = {K_EVENT: "stats"}
    ev.update(payload)
    if fleet is not _UNSET:
        ev["fleet"] = fleet
    return ev


def ev_metrics(
    metrics: Mapping[str, Any], prometheus: str
) -> Dict[str, Any]:
    return {
        K_EVENT: "metrics",
        "metrics": metrics,
        "prometheus": prometheus,
    }


def ev_error(error: str, *, jid: Any = None) -> Dict[str, Any]:
    """The protocol-scoped error reply; ``id`` appends when the
    failing op named one (routing layers demux events by id)."""
    ev: Dict[str, Any] = {K_EVENT: "error", "error": error}
    if jid is not None:
        ev["id"] = jid
    return ev


def ev_error_overloaded(
    reason: str, retry_after_s: float, *, jid: Any = None
) -> Dict[str, Any]:
    """The typed admission rejection: machine-parseable
    ``error: overloaded`` plus the router's backoff estimate."""
    ev: Dict[str, Any] = {
        K_EVENT: "error", "error": "overloaded",
        "reason": reason,
        "retry_after_s": retry_after_s,
    }
    if jid is not None:
        ev["id"] = jid
    return ev


def ev_bye() -> Dict[str, Any]:
    return {K_EVENT: "bye"}


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def validate_doc(doc: Mapping[str, Any]) -> Mapping[str, Any]:
    """Cheap structural validation against the registry: the doc's
    op/event is declared and every required field is present (open
    docs skip the field check).  Returns the doc; raises
    :class:`ValueError` otherwise.  This is the dynamic twin of
    the reference's static wire audit — tests and future front doors
    (ROADMAP item 4) share one definition of well-formed."""
    if K_EVENT in doc:
        kind, spec = doc[K_EVENT], WIRE_EVENTS.get(doc[K_EVENT])
        family = "event"
    else:
        kind, spec = doc_op(doc), WIRE_OPS.get(doc_op(doc))
        family = "op"
    if spec is None:
        raise ValueError(
            f"undeclared {family} {kind!r} (runtime/protocol.py is "
            "the registry; new ops/events are declared there and "
            "re-pinned via --update-protocol)"
        )
    if not spec.get("open"):
        missing: List[str] = [
            f for f in spec["required"] if f not in doc
        ]
        if missing:
            raise ValueError(
                f"{family} {kind!r} doc is missing required "
                f"field(s): {', '.join(missing)}"
            )
    return doc
