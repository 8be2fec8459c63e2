"""Sweep cursors and crash-safe checkpoint/resume (the reference
package's ``runtime/checkpoint.py``, copied: the same documents, byte for
byte, so a checkpoint written by either package resumes in the other).

A sweep's position is one small cursor, ``(word index, variant rank)``,
because the variant space is indexable; recovery is exact replay from the
cursor.  The checkpoint also carries a fingerprint of every semantic
input (mode, window, table, wordlist, digest set), so a stale file never
silently resumes the wrong sweep.  The fingerprint is independent of
launch geometry (lanes, blocks, pair tier, superstep length), so a
resumed run may change those freely.

Writes are atomic and durable (:func:`atomic_write_text`: tmp file +
fsync + rename + directory fsync), so a crash mid-checkpoint leaves the
previous checkpoint intact.  Corrupt or truncated files fail loudly as
the typed :class:`CheckpointCorrupt`, never as a raw ``JSONDecodeError``
and never as a silent fresh start.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults


class CheckpointCorrupt(ValueError):
    """A checkpoint/manifest file exists but cannot be parsed (torn
    write, disk corruption, hand edit).  Carries the path and the
    parse failure; the CLI adds a one-line remediation hint."""


class CheckpointWireIncompatible(ValueError):
    """A checkpoint document's ``wire_version`` major does not match
    this build's.  Raised by :func:`state_from_doc` so a handoff between
    incompatible builds fails loudly instead of garbling cursors."""


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Crash- and power-loss-safe replace of ``path`` with ``blob``:
    write a same-directory tmp file, flush + fsync the DATA, rename
    over the target, then fsync the DIRECTORY so the rename itself is
    durable.  tmp+rename alone is atomic against a crash between
    syscalls but NOT against power-loss torn writes — without the data
    fsync the rename can land while the blocks behind it never do.
    Checkpoints, bucket manifests and ``--metrics-json`` all write
    through here.  A failed write cleans its tmp file before
    propagating."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        dirfd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return  # exotic mount: the data fsync above still stands
    try:
        os.fsync(dirfd)
    except OSError:
        pass  # some filesystems refuse directory fsync
    finally:
        os.close(dirfd)


def atomic_write_text(path: str, blob: str) -> None:
    """:func:`atomic_write_bytes` for text payloads (UTF-8)."""
    atomic_write_bytes(path, blob.encode("utf-8"))


#: v2: canonical word encoding is (int64 length vector, concatenated
#: content) so packed batches hash buffer-at-a-time instead of per-word.
FORMAT_VERSION = 2

#: Wire format of the checkpoint DOCUMENT (``state_to_doc`` /
#: ``state_from_doc``), distinct from FORMAT_VERSION (the cursor
#: encoding): the wire version gates cross-build handoffs.
#: Major bumps are breaking (``state_from_doc`` rejects unknown majors
#: with :class:`CheckpointWireIncompatible`); minors are additive and
#: ignored by older readers.
WIRE_VERSION = "1.0"

_WIRE_MAJOR = int(WIRE_VERSION.split(".", 1)[0])

#: ``kind`` marker distinguishing a bucketed sweep's top-level manifest
#: from a single sweep's cursor checkpoint (both live at the user's
#: ``--checkpoint FILE`` path depending on ``--buckets``).
MANIFEST_KIND = "bucket-manifest"


@dataclass(frozen=True)
class SweepCursor:
    """Position in the sweep: next word row, next variant rank within it.

    ``rank`` is a Python int (variant spaces can exceed 2^63; blocks cut
    int32-sized pieces of it, ``ops.blocks.MAX_BLOCK``)."""

    word: int = 0
    rank: int = 0


@dataclass
class CheckpointState:
    """Everything needed to resume a sweep exactly where it stopped."""

    fingerprint: str
    cursor: SweepCursor = field(default_factory=SweepCursor)
    n_emitted: int = 0  # candidates emitted (device + oracle fallback)
    n_hits: int = 0
    hits: List[Tuple[int, int]] = field(default_factory=list)  # (word, rank)
    fallback_done: int = 0  # fallback words fully re-expanded so far
    wall_s: float = 0.0
    #: streaming-ingestion extension: the active
    #: ``{"chunk": i, "chunk_words": N}`` when a streaming sweep wrote
    #: the checkpoint.  Purely informational — the (word, rank) cursor
    #: is GLOBAL either way, so a streaming checkpoint resumes under the
    #: whole-dictionary path (which ignores this) and vice versa, and a
    #: resume under a different chunk size just re-derives the chunk
    #: from the cursor.
    stream: Optional[Dict] = None
    version: int = FORMAT_VERSION
    #: forward-compatibility carry: unknown fields of a minor-newer
    #: wire document, preserved verbatim so a ``state_from_doc ->
    #: state_to_doc`` round trip through this build never strips what
    #: a newer writer wrote.  Majors still reject
    #: (:func:`check_wire_version`).
    extra: Dict = field(default_factory=dict)


def sweep_fingerprint(
    mode: str,
    algo: str,
    min_substitute: int,
    max_substitute: int,
    sub_map: Dict[bytes, List[bytes]],
    words: Sequence[bytes],
    digests: Sequence[bytes] = (),
    *,
    digest_lookup: Optional[Any] = None,
) -> str:
    """SHA-256 over a canonical serialization of the sweep's semantic inputs.

    Table entries hash in key order with value-list order preserved (order
    and multiplicity are semantic — Q2 first-option, Q7 duplicates).

    ``words`` may be a ``PackedWords`` batch — hashed buffer-at-a-time
    (little-endian int64 length vector, then the concatenated unpadded
    content bytes), identical to the per-word path for the same word
    sequence but without a Python loop over a rockyou-scale dictionary.
    The fingerprint stays independent of packing width and launch geometry.
    """
    h = hashlib.sha256()
    h.update(f"{mode}|{algo}|{min_substitute}|{max_substitute}|".encode())
    for key in sorted(sub_map):
        h.update(b"K%d:" % len(key) + key)
        for val in sub_map[key]:
            h.update(b"V%d:" % len(val) + val)
    if hasattr(words, "tokens"):  # PackedWords fast path
        lengths = np.ascontiguousarray(words.lengths, dtype="<i8")
        h.update(b"|W%d|" % len(lengths))
        h.update(lengths.tobytes())
        tokens = np.asarray(words.tokens)
        mask = (
            np.arange(tokens.shape[1])[None, :]
            < np.asarray(words.lengths)[:, None]
        )
        h.update(np.ascontiguousarray(tokens[mask]).tobytes())
    else:
        h.update(b"|W%d|" % len(words))
        h.update(
            np.asarray([len(w) for w in words], dtype="<i8").tobytes()
        )
        for w in words:
            h.update(w)
    # The lookup's sorted_blob is the digests in ascending byte order —
    # identical for matrix and list forms of the same set, so checkpoints
    # stay portable across parser paths (and a Sweep-provided lookup
    # reuses its one sort instead of re-sorting here).
    if digest_lookup is None:
        from ..ops.membership import HostDigestLookup

        digest_lookup = HostDigestLookup(digests)
    h.update(b"|D%d|" % len(digest_lookup))
    h.update(digest_lookup.sorted_blob())
    return h.hexdigest()


def state_to_doc(state: CheckpointState) -> Dict:
    """``state`` as a JSON-serializable document — the on-disk
    checkpoint format (ranks stringify because variant spaces exceed
    JSON's safe ints)."""
    doc = asdict(state)
    extra = doc.pop("extra")
    doc["wire_version"] = WIRE_VERSION
    doc["cursor"] = {"word": state.cursor.word, "rank": str(state.cursor.rank)}
    doc["hits"] = [[w, str(r)] for w, r in state.hits]
    # Re-append the unknown fields a minor-newer doc carried; known
    # keys never lose to a stale carry (setdefault, not overwrite).
    for k, v in extra.items():
        doc.setdefault(k, v)
    return doc


def check_wire_version(doc: Dict) -> None:
    """Reject a checkpoint document whose ``wire_version`` major is not
    this build's (:class:`CheckpointWireIncompatible`).  A document
    with NO wire_version predates the field — it is a major-1 doc by
    definition (the wire format has not changed since) and is
    accepted; unparseable values are rejected like unknown majors."""
    wv = doc.get("wire_version")
    if wv is None:
        return
    try:
        major = int(str(wv).split(".", 1)[0])
    except ValueError:
        raise CheckpointWireIncompatible(
            f"checkpoint wire_version {wv!r} is not a MAJOR.MINOR "
            "version string — refusing to migrate a document this "
            "build cannot interpret"
        ) from None
    if major != _WIRE_MAJOR:
        raise CheckpointWireIncompatible(
            f"checkpoint wire_version {wv!r} has major {major}, but "
            f"this build speaks {WIRE_VERSION} — cross-engine "
            "migration across incompatible builds must fail loudly; "
            "finish or restart the job on an engine of the writing "
            "build"
        )


#: Fields a checkpoint wire document must carry to be resumable.
_WIRE_REQUIRED = ("fingerprint", "cursor", "n_emitted", "n_hits",
                  "hits", "wall_s")


def validate_checkpoint_doc(doc: object) -> Dict:
    """Structural validation of a checkpoint wire document without
    materializing it: the wire-version major is this build's
    (:func:`check_wire_version`) and every resumable field is present
    (fingerprint, a word/rank cursor, the counters, the hit list).
    Returns the doc; raises :class:`CheckpointCorrupt` /
    :class:`CheckpointWireIncompatible` on anything a later
    ``state_from_doc`` would choke on."""
    if not isinstance(doc, dict):
        raise CheckpointCorrupt(
            f"checkpoint document must be a JSON object, got "
            f"{type(doc).__name__}"
        )
    check_wire_version(doc)
    missing = [k for k in _WIRE_REQUIRED if k not in doc]
    if missing:
        raise CheckpointCorrupt(
            f"checkpoint document is missing required field(s) "
            f"{', '.join(missing)} — refusing to hold an unresumable "
            "replay origin"
        )
    cursor = doc["cursor"]
    if not (isinstance(cursor, dict) and "word" in cursor
            and "rank" in cursor):
        raise CheckpointCorrupt(
            "checkpoint cursor must be an object with 'word' and "
            f"'rank', got {cursor!r}"
        )
    return doc


def state_from_doc(doc: Dict) -> CheckpointState:
    """Inverse of :func:`state_to_doc` (no fingerprint validation here —
    :func:`load_checkpoint` owns that;
    the wire-version major IS validated — see
    :func:`check_wire_version`)."""
    check_wire_version(doc)
    known = {f.name for f in fields(CheckpointState)} | {"wire_version"}
    return CheckpointState(
        fingerprint=doc["fingerprint"],
        cursor=SweepCursor(
            word=int(doc["cursor"]["word"]), rank=int(doc["cursor"]["rank"])
        ),
        n_emitted=int(doc["n_emitted"]),
        n_hits=int(doc["n_hits"]),
        hits=[(int(w), int(r)) for w, r in doc["hits"]],
        fallback_done=int(doc.get("fallback_done", 0)),
        wall_s=float(doc["wall_s"]),
        stream=doc.get("stream"),
        extra={k: v for k, v in doc.items() if k not in known},
    )


def save_checkpoint(path: str, state: CheckpointState) -> None:
    """Durably write ``state`` as JSON (:func:`atomic_write_text`).
    The ``checkpoint.write`` injection point fires before any byte
    lands, so an injected crash here leaves the previous checkpoint
    intact."""
    if faults.ACTIVE is not None:
        faults.ACTIVE.fire("checkpoint.write")
    doc = state_to_doc(state)
    blob = json.dumps(doc)
    atomic_write_text(path, blob)
    from . import telemetry

    if telemetry.enabled():
        telemetry.counter("checkpoint.saves").add(1)
        telemetry.counter("checkpoint.bytes_written").add(len(blob))


def load_checkpoint(path: str, fingerprint: str) -> Optional[CheckpointState]:
    """Load and validate a checkpoint; None when absent.

    Raises ``ValueError`` on version or fingerprint mismatch (a checkpoint
    for a *different* sweep is an operator error worth surfacing, not a
    silent fresh start) and :class:`CheckpointCorrupt` on a file that
    exists but cannot be parsed — naming the path and the failure."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        doc = _parse_doc(fh.read(), path)
    if doc.get("kind") == MANIFEST_KIND:
        raise ValueError(
            f"checkpoint {path!r} is a bucket manifest written by a "
            "bucketed sweep; resume with the same --buckets, or delete it "
            "to start over"
        )
    if doc.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has version {doc.get('version')}, "
            f"expected {FORMAT_VERSION}"
        )
    if doc.get("fingerprint") != fingerprint:
        raise ValueError(
            f"checkpoint {path!r} was written by a different sweep "
            "(mode/window/table/wordlist/digests changed); delete it to "
            "start over"
        )
    try:
        return state_from_doc(doc)
    except CheckpointWireIncompatible:
        # A different-build checkpoint is an operator error with its
        # own remediation (run it on the writing build), not file
        # corruption — keep the typed error.
        raise
    except (KeyError, TypeError, ValueError) as exc:
        # Valid JSON, broken schema (hand edit, partial restore): same
        # typed error as a torn file — the caller's remediation is
        # identical either way.
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is corrupt: field parse failed "
            f"({type(exc).__name__}: {exc})"
        ) from exc


def _parse_doc(raw: str, path: str) -> Dict:
    try:
        return json.loads(raw)
    except json.JSONDecodeError as exc:
        raise CheckpointCorrupt(
            f"checkpoint {path!r} is corrupt or truncated: not valid "
            f"JSON ({exc})"
        ) from exc


def save_bucket_manifest(path: str, fingerprints: Dict[int, str]) -> None:
    """Atomically write the bucketed sweep's top-level checkpoint at the
    user's ``--checkpoint FILE`` path: a manifest mapping each bucket width
    to its per-bucket checkpoint file (``{path}.w{width}``) and that
    bucket's semantic fingerprint.  FILE therefore always exists for a
    bucketed run, and a resume under different ``--buckets`` (or a legacy
    single-file checkpoint) fails loudly instead of silently restarting."""
    doc = {
        "version": FORMAT_VERSION,
        "kind": MANIFEST_KIND,
        "buckets": {
            str(width): {
                "file": os.path.basename(f"{path}.w{width}"),
                "fingerprint": fp,
            }
            for width, fp in sorted(fingerprints.items())
        },
    }
    atomic_write_text(path, json.dumps(doc))


def check_bucket_manifest(path: str, fingerprints: Dict[int, str]) -> bool:
    """Validate an existing manifest at ``path`` against this run's bucket
    fingerprints; returns False when absent.

    Raises ``ValueError`` when the file is a legacy single-sweep checkpoint
    (the pre-manifest layout — resuming it under bucketing would silently
    restart from zero) or when the bucket set / any fingerprint differs
    (``--buckets`` or sweep inputs changed)."""
    if not os.path.exists(path):
        return False
    with open(path) as fh:
        doc = _parse_doc(fh.read(), path)
    if doc.get("kind") != MANIFEST_KIND:
        raise ValueError(
            f"checkpoint {path!r} is a single-sweep checkpoint, not a "
            "bucket manifest; it would be ignored by a bucketed sweep — "
            "rerun with --buckets none to resume it, or delete it to "
            "start over"
        )
    if doc.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint manifest {path!r} has version "
            f"{doc.get('version')}, expected {FORMAT_VERSION}"
        )
    want = {
        str(width): fp for width, fp in fingerprints.items()
    }
    got = {
        w: entry.get("fingerprint")
        for w, entry in doc.get("buckets", {}).items()
    }
    if got != want:
        raise ValueError(
            f"checkpoint manifest {path!r} was written with different "
            "buckets or sweep inputs (--buckets/mode/window/table/wordlist/"
            "digests changed); delete it and its .w* files to start over"
        )
    return True
