"""Table compiler: substitution map -> dense, fixed-shape device arrays.

The reference keeps its merged table as a Go ``map[string][]string`` and probes
it per byte position inside the generation recursion (``main.go:182-185``). A
device enumerates variants by index arithmetic over fixed-shape tensors, so the
map is compiled once, host-side, into:

* a **key matrix** ``key_bytes[K, key_width] / key_len[K]`` with keys in
  canonical sorted-bytes order (the same order the oracle's substitute-all
  engines use for pattern enumeration — Q4 canonicalization), and a CSR-style
  value table ``val_bytes[V, val_width] / val_len[V]`` with per-key slices
  ``val_start[K] / val_count[K]`` preserving merge/append order and duplicate
  multiplicity (Q7);
* a **single-byte LUT** ``byte_to_key[256]`` (-1 = no single-byte key) for the
  dominant transliteration-table case;
* fast-path predicates: ``cascade_hazard[K, K]`` — ``hazard[p, q]`` is True
  when pattern ``q`` sorts AFTER ``p`` and the canonical sorted-order
  ReplaceAll cascade (oracle Q4 semantics) could match ``q`` against text
  *touching* a value ``v`` inserted by ``p`` — and ``has_empty_key``
  (a ``=x`` table line; live only in substitute-all modes). A value inserted
  by ``p`` can only ever be re-matched by patterns applied after it, i.e.
  patterns sorting strictly after ``p``; earlier-sorted patterns have already
  run. A ``q`` match touching ``v`` either (a) lies inside ``v``, (b) crosses
  ``v``'s left boundary (so ``q`` ends with a nonempty prefix of ``v``),
  (c) crosses its right boundary (``q`` starts with a nonempty suffix of
  ``v``), or (d) spans all of ``v`` plus context on both sides (``v`` a
  proper substring of ``q`` — including ``v == b""``, where the splice joins
  previously separated context). These conditions are word-independent and
  conservative: they flag every word where the span-splice fast path could
  diverge from the ReplaceAll cascade, at the cost of some exact-but-flagged
  words. ``cascade_free`` (no hazard at all) holds for monodirectional
  transliteration tables (qwerty-cyrillic, greek-hebrew, czech, german,
  qwerty-greek); bidirectional tables like qwerty-azerty have hazards.

  The hazard cases split further: ``cascade_crossing[K, K]`` flags the
  BOUNDARY cases (b)-(d) only. A hazard pair that is containment-only
  (``cascade_hazard & ~cascade_crossing`` — every possible ``q`` match
  against an inserted ``v`` lies wholly inside ``v``) is a pure value
  REWRITE: the effect of the later ReplaceAll on the span is exactly
  ``v.replace(q, chosen_u)``, computable at plan-build time. The
  substitute-all planner (``ops.expand_suball``) closes such cascades on
  device — each affected pattern slot gets a joint value table over its
  own digit and its hazard-successors' digits — so containment-hazard
  words (the 10.2% fallback share of qwerty-azerty) stay on
  the device path; only crossing cases (and cap overflows) remain
  oracle-routed.

Everything here is host-side numpy; the arrays are uploaded to device once per
sweep and shared by every batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Sequence

import numpy as np

SubstitutionMap = Mapping[bytes, Sequence[bytes]]


@dataclass(frozen=True)
class CompiledTable:
    """A substitution map in dense device-ready form.

    Keys are sorted bytewise (canonical pattern order); values keep their
    merged append order and multiplicity. All arrays are numpy (host); callers
    move them to device with ``torch.as_tensor(..., device=...)``.
    """

    keys: tuple  # tuple[bytes] in sorted order (host-side convenience)
    key_bytes: np.ndarray  # uint8 [K, key_width]
    key_len: np.ndarray  # int32 [K]
    val_start: np.ndarray  # int32 [K] — CSR offset into value table
    val_count: np.ndarray  # int32 [K]
    val_bytes: np.ndarray  # uint8 [V, val_width]
    val_len: np.ndarray  # int32 [V]
    byte_to_key: np.ndarray  # int32 [256] — key index of single-byte key, or -1
    max_key_len: int
    max_val_len: int
    cascade_hazard: np.ndarray  # bool [K, K] — see module docstring
    cascade_crossing: np.ndarray  # bool [K, K] — boundary cases (b)-(d) only
    has_empty_key: bool  # a b"" key exists (inert outside substitute-all)

    @property
    def cascade_free(self) -> bool:
        """True when NO sorted-order ReplaceAll cascade can re-match inserted
        text, so the all-or-none span-splice fast path is exact for every
        word and every chosen-pattern subset."""
        return not bool(self.cascade_hazard.any())

    @property
    def num_keys(self) -> int:
        return int(self.key_bytes.shape[0])

    @property
    def num_values(self) -> int:
        # Not val_bytes.shape[0]: a zero-pair table pads one value row so
        # device gathers stay in-bounds, but it holds zero actual values.
        return int(self.val_count.sum())

    @property
    def all_keys_single_byte(self) -> bool:
        return self.max_key_len <= 1 and not self.has_empty_key

    def key_index(self, key: bytes) -> int:
        """Index of ``key`` in canonical order (host-side; -1 if absent)."""
        try:
            return self.keys.index(key)
        except ValueError:
            return -1

    def values_of(self, key_idx: int) -> List[bytes]:
        """Host-side value list of a key, in merged order (for oracles/tests)."""
        s = int(self.val_start[key_idx])
        c = int(self.val_count[key_idx])
        return [
            bytes(self.val_bytes[i, : self.val_len[i]]) for i in range(s, s + c)
        ]


def boundary_match_possible(v: bytes, q: bytes) -> bool:
    """Could a ReplaceAll of pattern ``q`` match text CROSSING a boundary of
    inserted text ``v`` — the module docstring's cases (b)-(d)?
    Word-independent over-approximation over arbitrary surrounding context.
    Containment (case (a)) is deliberately NOT flagged: a fully-contained
    re-match is a pure value rewrite, which the cascade-closure plans apply
    statically (``ops.expand_suball``)."""
    if len(v) < len(q) and v in q:  # (d) spans v plus context on both sides
        return True
    for n in range(1, min(len(q), len(v) + 1)):
        if q[-n:] == v[:n]:  # (b) crosses v's left boundary
            return True
        if q[:n] == v[-n:]:  # (c) crosses v's right boundary
            return True
    return False


def _touching_match_possible(v: bytes, q: bytes) -> bool:
    """Could a ReplaceAll of pattern ``q`` match text touching an inserted
    value ``v``? Word-independent over-approximation — see the module
    docstring's (a)-(d). Every real cascade divergence satisfies one of
    these: a match intersecting ``v`` covers a prefix, suffix, or all of
    ``v``, with any overhang coming from surrounding context."""
    # (a) contained in the inserted text, else a boundary crossing.
    return q in v or boundary_match_possible(v, q)


def compile_table(sub_map: SubstitutionMap) -> CompiledTable:
    """Compile a parsed/merged substitution map into dense arrays.

    Zero-key edge cases produce shape-(0, 1) key matrices so downstream
    jnp code never sees a zero-width axis; the VALUE arrays additionally
    keep at least one (zero) row because device kernels gather value rows
    by index (``num_values`` still reports the true count).
    """
    keys = sorted(sub_map.keys())
    k = len(keys)
    max_key_len = max((len(key) for key in keys), default=0)
    key_width = max(max_key_len, 1)

    key_bytes = np.zeros((k, key_width), dtype=np.uint8)
    key_len = np.zeros((k,), dtype=np.int32)
    val_start = np.zeros((k,), dtype=np.int32)
    val_count = np.zeros((k,), dtype=np.int32)

    flat_values: List[bytes] = []
    for i, key in enumerate(keys):
        key_bytes[i, : len(key)] = np.frombuffer(key, dtype=np.uint8)
        key_len[i] = len(key)
        vals = list(sub_map[key])
        val_start[i] = len(flat_values)
        val_count[i] = len(vals)
        flat_values.extend(bytes(v) for v in vals)

    v = len(flat_values)
    max_val_len = max((len(x) for x in flat_values), default=0)
    val_width = max(max_val_len, 1)
    # A zero-PAIR table (every input line skipped) keeps one zero row: the
    # device kernels gather value rows by clamped index, and a 0-row axis
    # makes even the never-selected gather out of bounds (val_count is all
    # zero, so no lane ever chooses the padding row).
    val_bytes = np.zeros((max(v, 1), val_width), dtype=np.uint8)
    val_len = np.zeros((max(v, 1),), dtype=np.int32)
    for i, value in enumerate(flat_values):
        val_bytes[i, : len(value)] = np.frombuffer(value, dtype=np.uint8)
        val_len[i] = len(value)

    byte_to_key = np.full((256,), -1, dtype=np.int32)
    for i, key in enumerate(keys):
        if len(key) == 1:
            byte_to_key[key[0]] = i

    cascade_hazard = np.zeros((k, k), dtype=bool)
    cascade_crossing = np.zeros((k, k), dtype=bool)
    for p in range(k):
        for q in range(p + 1, k):  # only later-sorted patterns can re-match
            # keys[q] is never empty here: b"" sorts first, so it cannot be a
            # later-sorted pattern (tables with an empty key are excluded from
            # the fast path via has_empty_key regardless).
            key_q = keys[q]
            cascade_hazard[p, q] = any(
                _touching_match_possible(
                    flat_values[val_start[p] + j], key_q
                )
                for j in range(val_count[p])
            )
            cascade_crossing[p, q] = any(
                boundary_match_possible(
                    flat_values[val_start[p] + j], key_q
                )
                for j in range(val_count[p])
            )

    return CompiledTable(
        keys=tuple(keys),
        key_bytes=key_bytes,
        key_len=key_len,
        val_start=val_start,
        val_count=val_count,
        val_bytes=val_bytes,
        val_len=val_len,
        byte_to_key=byte_to_key,
        max_key_len=max_key_len,
        max_val_len=max_val_len,
        cascade_hazard=cascade_hazard,
        cascade_crossing=cascade_crossing,
        has_empty_key=b"" in sub_map,
    )
