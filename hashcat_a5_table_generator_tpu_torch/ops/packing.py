"""Wordlist packing: variable-length byte strings -> padded device tensors.

The reference streams the dictionary line by line through ``bufio.Scanner``
(``main.go:72-94``) and hands each word to a goroutine. The device path
instead packs words into fixed-shape batches ``uint8[B, width]`` +
``int32[B]`` lengths up front; length bucketing (16/32/64...) keeps padding
waste low across rockyou-class dictionaries.

Everything here is host-side numpy, shared with the reference package's
``ops/packing.py`` (same outputs, array for array).  The line scan
(:func:`read_wordlist_lines`), the bucket assignment
(:func:`bucket_widths`) and the gather (:func:`pack_rows`) are
vectorized numpy: the versions the native scanner/packer
(``native.read_packed_buckets``, which the CLI's device backend reads
through) falls back to.  :func:`read_wordlist` is the oracle backend's
reader.

The second half is the per-slot piece schema (:class:`PieceSchema`) that
drives the piece kernel (``ops/fused_expand.py``), with its on-disk cache
(:func:`piece_schema_for`'s ``cache_dir``: the reference's entries and
keys); the last part, the
streaming sweep's chunking (:func:`slice_packed`, :func:`auto_chunk_words`,
:func:`chunk_bounds`) and its compile ring (:class:`ChunkCompiler`).

Faithfulness notes (Q8): the reference's scanner silently ends input on a line
longer than 64 KiB and never checks ``scanner.Err()``. We do NOT copy that
hole: oversized lines raise unless ``max_word_bytes`` is explicitly lifted,
and I/O errors propagate.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime.env import emit_scheme

#: Go bufio.Scanner default token limit (reference main.go Q8).
DEFAULT_MAX_WORD_BYTES = 64 * 1024

#: Default length-bucket boundaries (words longer than the last bucket get a
#: bucket of exactly their padded power-of-two width).
DEFAULT_BUCKETS = (16, 32, 64)


@dataclass(frozen=True)
class PackedWords:
    """A batch of words as device-ready padded arrays.

    ``tokens[i, :lengths[i]]`` are the word's bytes; the rest is zero padding.
    ``index[i]`` is the word's ordinal in the source wordlist — packing may
    bucket/reorder, and every downstream hit is reported against this index so
    results are always expressed in dictionary order.
    """

    tokens: np.ndarray  # uint8 [B, width]
    lengths: np.ndarray  # int32 [B]
    index: np.ndarray  # int64 [B] — position in the original wordlist

    @property
    def batch(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def width(self) -> int:
        return int(self.tokens.shape[1])

    def word(self, i: int) -> bytes:
        return bytes(self.tokens[i, : self.lengths[i]])

    def words(self) -> List[bytes]:
        return [self.word(i) for i in range(self.batch)]


def aligned_width(longest: int) -> int:
    """The packing width for a longest-word length: smallest multiple of 4
    covering it (uint32 lane alignment for the hash kernels), minimum 4.
    Single source of truth for every packer."""
    return max(4, -(-longest // 4) * 4)


def pack_words(
    words: Sequence[bytes],
    *,
    width: int | None = None,
    start_index: int = 0,
) -> PackedWords:
    """Pack ``words`` into one padded batch of a single width.

    ``width`` defaults to :func:`aligned_width` of the longest word.
    """
    if width is None:
        width = aligned_width(max((len(w) for w in words), default=0))
    tokens = np.zeros((len(words), width), dtype=np.uint8)
    lengths = np.zeros((len(words),), dtype=np.int32)
    for i, w in enumerate(words):
        if len(w) > width:
            raise ValueError(f"word {i} is {len(w)} bytes > width {width}")
        tokens[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
        lengths[i] = len(w)
    index = np.arange(start_index, start_index + len(words), dtype=np.int64)
    return PackedWords(tokens=tokens, lengths=lengths, index=index)


def validate_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Require strictly-ascending positive bucket boundaries.

    Shared by the list (`bucket_words`, first-match in caller order) and
    file (`bucket_widths`, searchsorted) assignment paths so an unsorted
    tuple cannot make them assign different widths.
    An empty tuple is allowed: every word gets its own power-of-two width.
    """
    if list(buckets) != sorted(set(buckets)) or any(b < 1 for b in buckets):
        raise ValueError(
            f"buckets must be strictly ascending positive widths, got "
            f"{tuple(buckets)}"
        )
    return tuple(buckets)


def bucket_words(
    words: Sequence[bytes],
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    max_word_bytes: int = DEFAULT_MAX_WORD_BYTES,
    start_index: int = 0,
) -> Dict[int, PackedWords]:
    """Split ``words`` into length buckets, each packed at its bucket width.

    Returns ``{width: PackedWords}``; original wordlist positions are carried
    in each batch's ``index``. Words longer than the last bucket boundary get
    a power-of-two width of their own; words over ``max_word_bytes`` raise
    (the anti-Q8 guarantee).
    """
    validate_buckets(buckets)
    by_width: Dict[int, List[int]] = {}
    for i, w in enumerate(words):
        if len(w) > max_word_bytes:
            raise ValueError(
                f"word {start_index + i} is {len(w)} bytes > limit "
                f"{max_word_bytes} (Go would silently truncate here — Q8)"
            )
        width = next((b for b in buckets if len(w) <= b), None)
        if width is None:
            width = 4
            while width < len(w):
                width *= 2
        by_width.setdefault(width, []).append(i)

    out: Dict[int, PackedWords] = {}
    for width, idxs in sorted(by_width.items()):
        packed = pack_words([words[i] for i in idxs], width=width)
        out[width] = PackedWords(
            tokens=packed.tokens,
            lengths=packed.lengths,
            index=np.asarray([start_index + i for i in idxs], dtype=np.int64),
        )
    return out


def read_wordlist_lines(
    data: bytes,
    *,
    max_word_bytes: int = DEFAULT_MAX_WORD_BYTES,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Line structure of a wordlist buffer: (buffer, offsets, lengths),
    ``bufio.ScanLines`` semantics: splits on ``\\n``, drops one trailing
    ``\\r`` per line, and a final line without a newline still counts.
    Unlike the reference, an oversized line is an error, not a silent end
    of input (Q8)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(data) == 0:
        empty64 = np.zeros(0, dtype=np.int64)
        return buf, empty64, np.zeros(0, dtype=np.int32)
    nl = np.nonzero(buf == 0x0A)[0]
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(data)]])
    if starts[-1] >= len(data) and data.endswith(b"\n"):
        starts, ends = starts[:-1], ends[:-1]
    lengths = ends - starts
    # Drop one trailing '\r' per line.
    has_cr = lengths > 0
    cr_pos = np.where(has_cr, starts + lengths - 1, 0)
    lengths = lengths - (has_cr & (buf[cr_pos] == 0x0D))
    if len(lengths) and int(lengths.max()) > max_word_bytes:
        bad = int(np.argmax(lengths > max_word_bytes))
        raise ValueError(f"line {bad} exceeds {max_word_bytes} bytes (Q8)")
    return buf, starts.astype(np.int64), lengths.astype(np.int32)


def read_wordlist(
    path: str,
    *,
    max_word_bytes: int = DEFAULT_MAX_WORD_BYTES,
) -> List[bytes]:
    """Read a dictionary file into a list of words (one per line): the
    oracle backend's reader.

    Mirrors ``bufio.ScanLines``: splits on ``\\n``, drops one trailing ``\\r``
    per line, and a final line without a newline still counts. Unlike the
    reference, an oversized line is an error, not a silent end of input (Q8).
    """
    with open(path, "rb") as fh:
        data = fh.read()
    words: List[bytes] = []
    if not data:
        return words
    for line in data.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        if len(line) > max_word_bytes:
            raise ValueError(
                f"{path}: line {len(words)} exceeds {max_word_bytes} bytes (Q8)"
            )
        words.append(line)
    if data.endswith(b"\n"):
        words.pop()  # split() produced a trailing empty element, not a word
    return words


# ---------------------------------------------------------------------------
# Per-slot piece emission: precomputed piece tables
# ---------------------------------------------------------------------------
#
# The fused kernels' "unit scheme" resolved output bytes per ORIGINAL byte
# position — O(L) per-lane selects even though only the <= S substitution
# slots vary per lane.  The per-slot scheme
# re-expresses a candidate as a short sequence of PIECES in output order:
# one piece per substitution site (its literal gap from the previous site
# folded in as a block-uniform prefix) plus one literal tail piece (with
# the 0x80 terminator folded into its precomputed bytes).  Everything
# block-uniform — gap bytes, skip bytes, value bytes, their lengths — is
# packed here, on the host, into per-word VARIANT tables: a piece's
# possible byte strings, one row per choice of its slot's digit.  Adjacent
# pieces whose combined worst-case length fits one u32 are merged into one
# GROUP whose variant table enumerates the combined choices, so the kernel
# selects a whole 4-byte group word with ONE N-way select and places it
# with ONE (lo, hi) word-pair scatter; lane-local work per group is the
# variant index, two selects (word + length), and a prefix-sum add.


@dataclass(frozen=True)
class PieceGroup:
    """Static shape of one emission group (see :class:`PieceSchema`).

    ``sel_cols``: the selector column ids (into the schema's column axis)
    whose digits index this group's variant table — low bit / least
    significant factor first; empty for the literal tail group.
    ``n_variants``/``n_words``: live extent inside the padded ``gw``/``gl``
    tables.  ``off_cap``: static upper bound on the group's output byte
    offset (sum of prior groups' data-max placed lengths over launched
    words × reachable variants).  ``off_floor``: the matching static
    LOWER bound.  Together they are the group's reachable byte window —
    the hierarchical-placement lever: the kernels place a
    group's words only inside ``[off_floor//4, off_cap//4 (+spill)]``
    instead of scanning from word 0, and a degenerate window
    (``off_floor == off_cap``) collapses the whole dynamic scatter to a
    static shift-OR.  ``len_fixed``: the group's placed length when it is
    the same for every launched word and reachable variant (None =
    varies) — a run of fixed groups keeps the running offset static.
    ``has_term``: the 0x80 terminator byte is folded into this group's
    variant bytes (always the last group), so its table lengths are
    placed-length = candidate bytes + 1.
    ``packed16``/``tab_idx``: where the group's variant words live —
    row ``tab_idx`` of the u16 ``gw16`` table (single-word groups whose
    every variant fits 2 bytes; halves their table footprint) or of the
    u32 ``gw`` table (everything else).
    ``gl_idx``: the group's row in the sliced ``gl`` length table —
    meaningful only for dynamic-length groups (``len_fixed is None``);
    fixed-length groups never read a length row, so the table ships only
    the dynamic rows (the gw/gw16 split applied to lengths).
    """

    sel_cols: Tuple[int, ...]
    n_variants: int
    n_words: int
    off_cap: int
    has_term: bool = False
    off_floor: int = 0
    len_fixed: Optional[int] = None
    packed16: bool = False
    tab_idx: int = 0
    gl_idx: int = 0


@dataclass(frozen=True)
class PieceSchema:
    """Host-precomputed per-slot emission plan for one (plan, table) pair.

    Data tables (numpy; gathered per block by the wrappers):
      ``gw`` uint32 [B, NGW, VM, NW] — wide groups' variant words
      (little-endian packed bytes; ``None`` when every group packs to
      u16), ``gw16`` uint16 [B, NG16, VM] — narrow single-word groups
      whose every variant fits 2 bytes (``None`` when no group
      qualifies; the per-group ``packed16`` gate),
      ``gl`` uint8 [B, NGD, VM] — placed byte lengths of the
      DYNAMIC-length groups only, in emission order (fixed-length
      groups fold their length into the static prefix offset and never
      read a row; ``None`` when every group is fixed — all-fixed
      schemas ship no length table at all).
      ``sel_bit`` uint8 [B, C] — the chosen-bit position of each selector
      column's slot in the packed chosen vector (suball plans; match
      plans' column c IS slot/bit c, so ``None``).
      ``sel_slot`` int32 [B, C] — the decode slot driving each column
      (suball plans; ``None`` = identity).

    ``groups`` is the static emission order; ``closed`` marks cascade-
    closed suball plans (variant index = 1 + joint value index instead of
    the raw digit).  ``max_out`` bounds every lane's placed bytes
    (including the terminator) — the static placement budget.

    Pair-lane tier: ``pair_ok`` marks schemas whose
    geometry admits K=2 candidates per hash lane — consecutive
    combination ranks ``2r`` / ``2r+1`` share one index decompose
    (every launched word's innermost slot has EVEN radix, so the
    partner's digit vector is the base's with slot 0's digit + 1) and
    differ only in the variant of ONE static emission group
    (``pair_g0``, the group whose selector columns start with column
    0).  ``pair_dmin``/``pair_dmax`` statically bound the partner-
    minus-base placed-length delta of that group over launched rows ×
    reachable pairs — the kernels widen the suffix groups' placement
    windows by exactly this range (a 0/0 bound collapses the partner
    to a pure patch of the innermost group's words).
    """

    kind: str  # "match" | "suball"
    groups: Tuple[PieceGroup, ...]
    gw: Optional[np.ndarray]
    gl: Optional[np.ndarray]
    gw16: Optional[np.ndarray] = None
    sel_bit: Optional[np.ndarray] = None
    sel_slot: Optional[np.ndarray] = None
    closed: bool = False
    max_out: int = 0
    n_cols: int = 0
    pair_ok: bool = False
    pair_g0: int = 0
    pair_dmin: int = 0
    pair_dmax: int = 0

    @property
    def num_groups(self) -> int:
        return len(self.groups)


#: Grouping caps: a merged group's worst-case bytes must fit one u32, its
#: variant table at most ``_MAX_GROUP_VARIANTS`` rows (memory: tables are
#: per word), and a standalone piece at most ``_MAX_PIECE_WORDS`` u32s
#: (beyond that the per-byte scan is the better formulation anyway).
_MAX_GROUP_BYTES = 4
_MAX_GROUP_VARIANTS = 4
_MAX_PIECE_WORDS = 4
#: Widest single-column variant table (cascade closure's joint tables
#: reach 12 rows + skip).
_MAX_COL_VARIANTS = 13


def _col_val_len(col_opts, col_vstart, val_len, vmax):
    """Per-(word, column, option) value lengths ``[B, C, vmax]`` (0 past a
    column's own option count)."""
    b, c = col_opts.shape
    out = np.zeros((b, c, max(vmax, 1)), np.int32)
    nrows = val_len.shape[0]
    for v in range(vmax):
        row = np.clip(col_vstart + v, 0, max(nrows - 1, 0))
        out[:, :, v] = np.where(col_opts > v, val_len[row], 0)
    return out


def build_piece_schema(
    tokens: np.ndarray,  # uint8 [B, L]
    lengths: np.ndarray,  # int32 [B]
    col_pos: np.ndarray,  # int32 [B, C] — span start (output order)
    col_len: np.ndarray,  # int32 [B, C] — span length, 0 = no span
    col_opts: np.ndarray,  # int32 [B, C] — selectable options (0 = literal)
    col_vstart: np.ndarray,  # int32 [B, C] — value row of option 1
    val_bytes: np.ndarray,  # uint8 [V, W]
    val_len: np.ndarray,  # int32 [V]
    *,
    kind: str,
    sel_slot: "np.ndarray | None" = None,  # int32 [B, C]
    sel_bit: "np.ndarray | None" = None,  # int32 [B, C]
    closed: bool = False,
    launched: "np.ndarray | None" = None,  # bool [B] — device-launched rows
) -> "PieceSchema | None":
    """Build the per-slot piece tables, or None when the plan's geometry
    cannot take the scheme (static spans unsorted/overlapping, a piece
    past the word cap, or a variant table past the row cap).

    Columns are substitution sites in OUTPUT order; each column's piece is
    the literal gap since the previous site (block-uniform bytes) plus the
    site's span — original bytes when skipped (variant 0), the chosen
    option's value bytes otherwise.  A final tail column carries the
    trailing literals plus the 0x80 terminator (for NTLM's UTF-16LE
    expansion the terminator pseudo-byte expands to exactly the padded
    message's ``80 00`` pair, so no kernel terminator scan remains).

    ``launched`` masks the rows the device will actually launch (suball
    plans route hazard words to the oracle): the per-group placement
    windows ``off_floor``/``off_cap`` — and the ``len_fixed`` static-run
    detection — are computed over launched rows × reachable variants
    only, so an oracle-routed word's degenerate columns cannot widen the
    hierarchical-placement windows for everyone else.
    """
    b, length_axis = tokens.shape
    c_axis = col_pos.shape[1]
    if b == 0:
        return None
    launched_rows = (
        np.ones(b, bool) if launched is None else np.asarray(launched, bool)
    )
    if not launched_rows.any():
        return None  # every word oracle-routed; the schema would be unused
    lengths = lengths.astype(np.int64)
    has_span = col_len > 0
    # Effective span starts: spanless columns sit at the running cursor so
    # gap arithmetic stays monotone.
    prev_end = np.zeros(b, np.int64)
    gap_start = np.zeros((b, c_axis), np.int64)
    gap_len = np.zeros((b, c_axis), np.int64)
    for c in range(c_axis):
        pos_c = np.where(has_span[:, c], col_pos[:, c].astype(np.int64),
                         prev_end)
        g = pos_c - prev_end
        if (g < 0).any():
            return None  # overlapping or unsorted static spans
        gap_start[:, c] = prev_end
        gap_len[:, c] = g
        end_c = pos_c + np.where(has_span[:, c], col_len[:, c], 0)
        if (end_c > lengths).any():
            return None
        prev_end = end_c
    tail_start = prev_end
    tail_len = lengths - tail_start
    if (tail_len < 0).any():
        return None

    opts_max = [int(col_opts[:, c].max(initial=0)) for c in range(c_axis)]
    if any(o + 1 > _MAX_COL_VARIANTS for o in opts_max):
        return None
    vl3 = _col_val_len(col_opts, col_vstart, val_len, max(opts_max or [0]))

    # --- emission columns: the output-order byte stream ------------------
    # Literal runs (gaps between sites, and the trailing tail + 0x80
    # terminator) are SPLIT into <=4-byte chunks, each a variant-free
    # column — a matchless 16-byte bucket word must not veto the whole
    # plan by demanding one 17-byte piece.  Selector columns carry only
    # their own span (skip) / value variants.
    ecols: List[dict] = []

    def add_lit(start, run_len, *, term):
        total = run_len + (1 if term else 0)  # +1: terminator byte
        for k in range(0, int(total.max(initial=0)), 4):
            ecols.append({
                "kind": "lit", "start": start, "src_len": run_len,
                "off": k, "term": term,
                "max": int(np.clip(total - k, 0, 4).max(initial=0)),
            })

    for c in range(c_axis):
        add_lit(gap_start[:, c], gap_len[:, c], term=False)
        widest = np.maximum(
            np.where(has_span[:, c], col_len[:, c], 0),
            vl3[:, c, : max(opts_max[c], 1)].max(axis=1)
            if opts_max[c] else 0,
        )
        mx = int(widest.max(initial=0))
        if mx == 0 and opts_max[c] == 0:
            continue  # padding column in every word
        ecols.append({"kind": "sel", "c": c, "max": mx})
    add_lit(tail_start, tail_len, term=True)

    # --- static grouping: greedy adjacent packing -----------------------
    # A group merges consecutive emission columns while (a) worst-case
    # bytes fit one u32, (b) the variant product stays small, (c) every
    # merged selector column is binary (the kernel indexes merged groups
    # by packed chosen bits).  A column too wide to merge stands alone
    # with ceil(maxlen/4) words.
    specs: List[List[dict]] = []
    cur: "List[dict] | None" = None

    def col_variants(e):
        return opts_max[e["c"]] + 1 if e["kind"] == "sel" else 1

    def cur_bytes(spec):
        return sum(e["max"] for e in spec)

    def cur_variants(spec):
        v = 1
        for e in spec:
            v *= col_variants(e)
        return v

    for e in ecols:
        v_c = col_variants(e)
        sel_after = (
            [] if cur is None
            else [x for x in cur if col_variants(x) > 1]
        ) + ([e] if v_c > 1 else [])
        can_merge = (
            cur is not None
            and cur_bytes(cur) + e["max"] <= _MAX_GROUP_BYTES
            and cur_variants(cur) * v_c <= _MAX_GROUP_VARIANTS
            and (len(sel_after) <= 1
                 or all(col_variants(x) == 2 for x in sel_after))
        )
        if can_merge:
            cur.append(e)
        else:
            if cur is not None:
                specs.append(cur)
            cur = [e]
    if cur is not None:
        specs.append(cur)
    if not specs:
        return None

    ng = len(specs)
    vmax = max(cur_variants(s) for s in specs)
    nwmax = max(-(-max(cur_bytes(s), 1) // 4) for s in specs)
    if nwmax > _MAX_PIECE_WORDS or vmax > max(
        _MAX_GROUP_VARIANTS, _MAX_COL_VARIANTS
    ):
        return None

    gb = np.zeros((b, ng, vmax, nwmax * 4), np.uint8)
    gl = np.zeros((b, ng, vmax), np.int64)
    #: variant (gi, vi) is reachable for word b — the kernels can select
    #: it on an EMITTED lane (a selector digit d needs col_opts >= d).
    #: Bounds the placement windows; unreachable variants only ever feed
    #: masked garbage lanes.
    reach = np.zeros((b, ng, vmax), bool)
    nrows = val_bytes.shape[0]
    vw = val_bytes.shape[1]
    rows_iota = np.arange(b)

    def emit_bytes(gi, vi, at_len, data, dlen):
        """OR bytes ([B, K] u8 + [B] length) into group (gi, vi) at the
        running per-word offset ``at_len``; returns the new offset."""
        for j in range(data.shape[1]):
            live = j < dlen
            pos = np.clip(at_len + j, 0, nwmax * 4 - 1)
            old = gb[rows_iota, gi, vi, pos]
            gb[rows_iota, gi, vi, pos] = np.where(live, data[:, j], old)
        return at_len + dlen

    def gather_tok(start, width):
        if width == 0:
            return np.zeros((b, 0), np.uint8)
        idx = np.clip(
            start[:, None] + np.arange(width)[None, :], 0, length_axis - 1
        )
        return np.take_along_axis(tokens, idx.astype(np.int64), axis=1)

    def lit_chunk(e):
        """One <=4-byte literal chunk: bytes [off, off+4) of the run
        (plus the 0x80 terminator at the run's own end for the tail)."""
        rel = e["src_len"] - e["off"]  # bytes of the run in/after chunk
        width = e["max"]
        data = gather_tok(e["start"] + e["off"], width)
        for j in range(width):
            dead = rel <= j
            data[:, j] = np.where(dead, 0, data[:, j])
            if e["term"]:
                data[:, j] = np.where(rel == j, 0x80, data[:, j])
        ln = np.clip(rel + (1 if e["term"] else 0), 0, 4)
        return data, ln

    for gi, spec in enumerate(specs):
        sel = [e["c"] for e in spec if col_variants(e) > 1]
        n_var = cur_variants(spec)
        for vi in range(n_var):
            # Decompose the variant index into per-selector digits,
            # low column first (the kernel packs bits the same way).
            digits = {}
            rem = vi
            rch = np.ones(b, bool)
            for c in sel:
                digits[c] = rem % (opts_max[c] + 1)
                rem //= opts_max[c] + 1
                if digits[c] > 0:
                    rch &= col_opts[:, c] >= digits[c]
            reach[:, gi, vi] = rch
            at = np.zeros(b, np.int64)
            for e in spec:
                if e["kind"] == "lit":
                    data, ln = lit_chunk(e)
                    at = emit_bytes(gi, vi, at, data, ln)
                    continue
                c = e["c"]
                d = digits.get(c, 0)
                if d == 0:
                    ln = np.where(has_span[:, c], col_len[:, c], 0
                                  ).astype(np.int64)
                    data = gather_tok(gap_start[:, c] + gap_len[:, c],
                                      int(col_len[:, c].max(initial=0)))
                else:
                    row = np.clip(col_vstart[:, c] + d - 1, 0,
                                  max(nrows - 1, 0))
                    ln = np.where(
                        col_opts[:, c] >= d, vl3[:, c, d - 1], 0
                    ).astype(np.int64)
                    data = val_bytes[row][:, :vw]
                at = emit_bytes(gi, vi, at, data, ln)
            gl[:, gi, vi] = at

    gw = np.zeros((b, ng, vmax, nwmax), np.uint32)
    for w in range(nwmax):
        for k in range(4):
            gw[:, :, :, w] |= gb[:, :, :, 4 * w + k].astype(
                np.uint32
            ) << np.uint32(8 * k)

    # Per-group placed-length extrema over launched rows × reachable
    # variants — the hierarchical-placement windows.
    big = 1 << 30
    live = reach[launched_rows]
    glv = gl[launched_rows]
    gwv = gw[launched_rows]
    g_min = np.where(live, glv, big).min(axis=(0, 2))
    g_max = np.where(live, glv, -1).max(axis=(0, 2))

    groups = []
    floor_off = cap_off = 0
    n16 = nwide = n_dyn = 0
    for gi, spec in enumerate(specs):
        sel = tuple(e["c"] for e in spec if col_variants(e) > 1)
        nbytes = cur_bytes(spec)
        n_words = -(-max(nbytes, 1) // 4)
        mn, mx = int(g_min[gi]), int(g_max[gi])
        # 16-bit table gate: single-word groups whose every variant word
        # fits 2 bytes move to the u16 ``gw16`` table (halved table
        # loads).  Like the placement windows above, the gate maxes over
        # launched rows × reachable variants only — a fallback word's or
        # unreachable variant's wide entry must not keep everyone else
        # in the u32 table (each row is read only by its own word, so
        # the u16 cast truncating a masked-out entry is unobservable).
        p16 = n_words == 1 and int(
            np.where(live[:, gi], gwv[:, gi, :, 0], 0).max(initial=0)
        ) < (1 << 16)
        groups.append(
            PieceGroup(
                sel_cols=sel,
                n_variants=cur_variants(spec),
                n_words=n_words,
                off_cap=cap_off,
                has_term=any(e["kind"] == "lit" and e["term"]
                             for e in spec),
                off_floor=floor_off,
                len_fixed=mn if mn == mx else None,
                packed16=p16,
                tab_idx=n16 if p16 else nwide,
                gl_idx=n_dyn if mn != mx else 0,
            )
        )
        if p16:
            n16 += 1
        else:
            nwide += 1
        if mn != mx:
            n_dyn += 1
        floor_off += mn
        cap_off += mx

    # --- pair-lane gate --------------------------------
    # K=2 candidates per hash lane need consecutive ranks 2r / 2r+1 to
    # share one index decompose and differ in ONE static group's
    # variant: (a) every launched word's innermost slot (column 0) has
    # EVEN radix (odd ``col_opts``) — or the word has no variants at
    # all, so its lone partner lane is masked; (b) column 0 is the
    # LOWEST selector factor of its group (construction order
    # guarantees ascending ``sel_cols``, so this is "first"); (c) for
    # suball schemas, slot 0 drives column 0 and ONLY column 0 on
    # every launched row (a pattern occurring twice would patch two
    # groups); closed schemas keep K=1 (the joint index couples
    # columns).  ``pair_dmin/dmax`` bound the partner-minus-base
    # placed-length delta of the pair group over launched rows ×
    # reachable (even, odd) variant pairs.
    pair_ok, pair_g0, pair_dmin, pair_dmax = _pair_gate(
        groups, col_opts, launched_rows, gl, reach,
        kind=kind, closed=closed, sel_slot=sel_slot, sel_bit=sel_bit,
    )

    wide_idx = [gi for gi, grp in enumerate(groups) if not grp.packed16]
    p16_idx = [gi for gi, grp in enumerate(groups) if grp.packed16]
    gw_wide = gw[:, wide_idx] if wide_idx else None
    gw16 = (
        # (index then slice — a list at axis 1 combined with the basic
        # integer 0 at axis 3 would hoist the advanced axes to the front)
        gw[:, p16_idx][..., 0].astype(np.uint16) if p16_idx else None
    )
    # Length-table slicing: fixed-length groups fold their
    # length into the static prefix and never read a row, so the shipped
    # ``gl`` keeps only the dynamic groups' rows (the gw/gw16 split
    # applied to lengths); an all-fixed schema ships no table at all.
    dyn_idx = [gi for gi, grp in enumerate(groups)
               if grp.len_fixed is None]
    gl_dyn = gl[:, dyn_idx].astype(np.uint8) if dyn_idx else None

    return PieceSchema(
        kind=kind,
        groups=tuple(groups),
        gw=gw_wide,
        gl=gl_dyn,
        gw16=gw16,
        sel_bit=None if sel_bit is None else sel_bit.astype(np.uint8),
        sel_slot=None if sel_slot is None else sel_slot.astype(np.int32),
        closed=closed,
        max_out=cap_off,
        n_cols=c_axis,
        pair_ok=pair_ok,
        pair_g0=pair_g0,
        pair_dmin=pair_dmin,
        pair_dmax=pair_dmax,
    )


def _pair_gate(groups, col_opts, launched_rows, gl, reach, *,
               kind, closed, sel_slot, sel_bit):
    """The schema-level half of the pair-lane eligibility (see
    :class:`PieceSchema`): returns ``(pair_ok, g0, dmin, dmax)``.
    Wrapper-level facts (hash-block count, windowed decode) are checked
    by ``fused_expand.pair_for_config``."""
    if closed:
        return False, 0, 0, 0
    g0 = next(
        (gi for gi, grp in enumerate(groups) if 0 in grp.sel_cols), None
    )
    if g0 is None:
        return False, 0, 0, 0
    if groups[g0].sel_cols[0] != 0:
        return False, 0, 0, 0
    rows = launched_rows
    opts0 = np.asarray(col_opts)[:, 0]
    inert = (np.asarray(col_opts) == 0).all(axis=1)
    row_ok = (opts0 % 2 == 1) | inert
    if kind == "suball":
        # Column 0 must be driven by slot 0 (bit 0 of the packed
        # chosen vector) and slot 0 by NO other column.
        c_axis = col_opts.shape[1]
        slot0_cols = (np.asarray(sel_slot) == 0) & (
            np.asarray(col_opts) > 0
        )
        drives_only_c0 = slot0_cols[:, 1:].sum(axis=1) == 0 \
            if c_axis > 1 else np.ones(len(opts0), bool)
        col0_is_slot0 = (
            (np.asarray(sel_slot)[:, 0] == 0)
            & (np.asarray(sel_bit)[:, 0] == 0)
        ) | (opts0 == 0)
        row_ok = row_ok & col0_is_slot0 & drives_only_c0
    if not row_ok[rows].all():
        return False, 0, 0, 0
    # Partner-minus-base length delta of the pair group over launched
    # rows × reachable (even, odd) variant pairs.  Column 0 is the
    # lowest factor, so pairs are consecutive variant indices (2i,
    # 2i+1).
    grp = groups[g0]
    if grp.len_fixed is not None:
        return True, g0, 0, 0
    n_var = grp.n_variants
    glv = gl[rows][:, g0, :]
    rch = reach[rows][:, g0, :]
    dmin, dmax = 0, 0
    found = False
    for v in range(0, n_var - 1, 2):
        both = rch[:, v] & rch[:, v + 1]
        if not both.any():
            continue
        d = (glv[:, v + 1] - glv[:, v])[both]
        dmin = int(d.min()) if not found else min(dmin, int(d.min()))
        dmax = int(d.max()) if not found else max(dmax, int(d.max()))
        found = True
    return True, g0, dmin, dmax



def _suball_piece_cols(plan) -> tuple:
    """Per-column arrays for a substitute-all plan: one column per PATTERN
    segment (occurrence), in word order, with gap segments folded into the
    following column's literal prefix by interval arithmetic.  Returns
    ``(pos, ln, opts, vstart, sel_slot, sel_bit, closed)``: padding
    columns alias slot 0 with ``sel_bit`` 31 (a bit no packed chosen
    vector sets)."""
    seg_pat = np.asarray(plan.seg_pat)
    seg_start = np.asarray(plan.seg_orig_start)
    seg_len = np.asarray(plan.seg_orig_len)
    radix = np.asarray(plan.pat_radix)
    pvs = np.asarray(plan.pat_val_start)
    b, _ = seg_pat.shape
    p = radix.shape[1]
    is_pat = seg_pat >= 0
    fb = np.asarray(plan.fallback)
    if fb.any():
        # Oracle-routed words never reach the device; blank their columns
        # so their (possibly degenerate) segment data can't veto the
        # schema for everyone else.
        is_pat = is_pat & ~fb[:, None]
    c_axis = max(1, int(is_pat.sum(axis=1).max(initial=0)))
    cols = np.cumsum(is_pat, axis=1) - 1
    rows, segs = np.nonzero(is_pat)
    cc = cols[rows, segs]
    pos = np.zeros((b, c_axis), np.int32)
    ln = np.zeros((b, c_axis), np.int32)
    slot = np.zeros((b, c_axis), np.int32)
    pos[rows, cc] = seg_start[rows, segs]
    ln[rows, cc] = seg_len[rows, segs]
    slot[rows, cc] = seg_pat[rows, segs]
    # Joint-closure plans: a slot's value row is indexed by the JOINT
    # digit (own + successors), so the column's variant count is the
    # joint table's row count, not radix - 1.
    closed = getattr(plan, "close_next", None) is not None
    if closed:
        cn = np.asarray(plan.close_next)
        cm = np.asarray(plan.close_mul)
        succ_r = np.where(
            cn >= 0,
            np.take_along_axis(
                radix, np.clip(cn, 0, p - 1).reshape(b, -1), axis=1
            ).reshape(cn.shape),
            1,
        )
        # Own digit d is in [1, radix-1] when the slot is chosen, so the
        # kernel's (d-1)*mul0 term peaks at (radix-2)*mul0.
        jmax = (radix - 2).clip(min=0) * cm[:, :, 0] + (
            (succ_r - 1) * cm[:, :, 1:]
        ).sum(axis=2)
        slot_opts = np.where(radix > 1, jmax + 1, 0)
    else:
        slot_opts = (radix - 1).clip(min=0)
    act = (radix > 1).astype(np.int32)
    bitpos = np.cumsum(act, axis=1) - act
    take = lambda a: np.take_along_axis(a, slot, axis=1)  # noqa: E731
    opts = np.where(ln > 0, take(slot_opts), 0)
    vstart = take(pvs)
    sel_bit = np.where(ln > 0, take(bitpos), 31)
    return pos, ln, opts, vstart, slot, sel_bit, closed


def piece_schema_for(plan, ct, cache_dir: "str | None" = None,
                     max_mb: "float | None" = None
                     ) -> "PieceSchema | None":
    """The per-slot emission gate: a :class:`PieceSchema` when the plan's
    static geometry supports piece emission (and ``A5GEN_EMIT`` does not
    opt out: ``runtime.env.emit_scheme``), else None — the plan then takes
    the byte-scan tiers (``ops.bytescan``).

    The schema's tables are ``gw uint32 [B, NG, VM, NW]`` group variant
    words, ``gw16 uint16 [B, NG16, VM]`` narrow groups and ``gl uint8
    [B, NGD, VM]`` placed lengths (plus a substitute-all plan's
    ``sel_slot int32 [B, C]`` / ``sel_bit uint8 [B, C]`` selector
    columns; a cascade-closed plan's value rows come from its own
    ``cval_bytes``/``cval_len``).  Cached on the plan object (plans are
    frozen, keyed by table identity).

    ``cache_dir`` (or ``A5GEN_SCHEMA_CACHE``) also keeps the compiled
    schema on disk, as the reference does: keyed by a digest of the exact
    build inputs and the format version (:func:`_schema_cache_key`), so
    repeat sweeps of one wordlist × table skip the build, and one cache
    directory serves both packages.  ``max_mb`` caps the directory:
    after a write the oldest-atime entries are evicted until it fits
    (:func:`enforce_schema_cache_cap`)."""
    from ..runtime.env import schema_cache_dir

    if emit_scheme() != "perslot":
        return None
    cache = getattr(plan, "_piece_schema_cache", None)
    if cache is not None and cache[0] is ct:
        return cache[1]
    tokens = np.asarray(plan.tokens)
    lengths = np.asarray(plan.lengths)
    launched = ~np.asarray(plan.fallback, bool)
    if getattr(plan, "match_pos", None) is not None:
        radix = np.asarray(plan.match_radix)
        build_kw = dict(
            tokens=tokens, lengths=lengths,
            col_pos=np.asarray(plan.match_pos),
            col_len=np.asarray(plan.match_len),
            col_opts=(radix - 1).clip(min=0),
            col_vstart=np.asarray(plan.match_val_start),
            val_bytes=np.asarray(ct.val_bytes),
            val_len=np.asarray(ct.val_len),
            kind="match", launched=launched,
        )
    else:
        pos, ln, opts, vstart, slot, sel_bit, closed = \
            _suball_piece_cols(plan)
        vb = getattr(plan, "cval_bytes", None)
        vl = getattr(plan, "cval_len", None)
        if vb is None:
            vb, vl = np.asarray(ct.val_bytes), np.asarray(ct.val_len)
        build_kw = dict(
            tokens=tokens, lengths=lengths,
            col_pos=pos, col_len=ln, col_opts=opts, col_vstart=vstart,
            val_bytes=np.asarray(vb), val_len=np.asarray(vl),
            kind="suball", sel_slot=slot, sel_bit=sel_bit,
            closed=closed, launched=launched,
        )
    if cache_dir is None:
        cache_dir = schema_cache_dir()
    if cache_dir:
        key = _schema_cache_key(build_kw)
        hit, schema = load_piece_schema(cache_dir, key)
        if not hit:
            schema = build_piece_schema(**build_kw)
            save_piece_schema(cache_dir, key, schema)
            if max_mb is not None:
                enforce_schema_cache_cap(cache_dir, max_mb)
    else:
        schema = build_piece_schema(**build_kw)
    object.__setattr__(plan, "_piece_schema_cache", (ct, schema))
    return schema


# ---------------------------------------------------------------------------
# On-disk PieceSchema cache (the reference's format: one cache directory
# serves both packages)
# ---------------------------------------------------------------------------

#: Part of every cache key: bumped on any change to the PieceSchema layout
#: or the grouping rules, so stale entries are never looked up again.
#: v2: the pair-lane gate fields.
SCHEMA_CACHE_VERSION = 2

#: The ``schema_cache.*`` telemetry counters: hits / misses / bytes read /
#: bytes written / evictions, process-wide.
_SCHEMA_CACHE_KEYS = (
    "hits", "misses", "bytes_read", "bytes_written", "evictions",
)

#: PieceGroup fields serialized into a cache entry's JSON header, in
#: constructor order.
_GROUP_FIELDS = ("sel_cols", "n_variants", "n_words", "off_cap", "has_term",
                 "off_floor", "len_fixed", "packed16", "tab_idx", "gl_idx")

_SCHEMA_ARRAYS = ("gw", "gl", "gw16", "sel_bit", "sel_slot")


def schema_cache_stats() -> dict:
    """The process's schema-cache counters, one int each (the
    ``schema_cache.*`` telemetry counters): hits / misses / bytes read /
    bytes written / evictions."""
    from ..runtime.telemetry import counter

    return {k: int(counter(f"schema_cache.{k}").value)
            for k in _SCHEMA_CACHE_KEYS}


def _count_cache(**deltas: int) -> None:
    from ..runtime.telemetry import counter

    for key, d in deltas.items():
        counter(f"schema_cache.{key}").add(int(d))


def enforce_schema_cache_cap(cache_dir: str, max_mb: float) -> int:
    """Evict the oldest-atime ``*.npz`` entries of ``cache_dir`` until
    their bytes fit ``max_mb`` (a read touches an entry's atime, so
    recently hit entries stay); returns the entries evicted.  An entry
    another process removed meanwhile is skipped."""
    import os

    cap = int(max_mb * (1 << 20))
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return 0
    entries = []
    for name in names:
        if not name.endswith(".npz"):
            continue
        path = os.path.join(cache_dir, name)
        try:
            st = os.stat(path)
        except OSError:  # evicted by another process
            continue
        entries.append((st.st_atime, st.st_size, path))
    total = sum(size for _, size, _ in entries)
    if total <= cap:
        return 0
    evicted = 0
    for _atime, size, path in sorted(entries):
        if total <= cap:
            break
        try:
            os.unlink(path)
        except OSError:  # evicted by another process
            continue
        total -= size
        evicted += 1
    if evicted:
        _count_cache(evictions=evicted)
    return evicted


def _schema_cache_key(build_kw: dict) -> str:
    """SHA-256 of the exact :func:`build_piece_schema` inputs and the
    format version: dtype, shape and bytes of every array, the kind and
    closed flags, and the grouping caps — the reference's key, byte for
    byte, so the packages share cache entries."""
    import hashlib

    h = hashlib.sha256()
    h.update(
        f"a5gen-piece-schema|v{SCHEMA_CACHE_VERSION}"
        f"|{build_kw['kind']}|{int(bool(build_kw.get('closed')))}"
        f"|{_MAX_GROUP_BYTES},{_MAX_GROUP_VARIANTS}"
        f",{_MAX_PIECE_WORDS},{_MAX_COL_VARIANTS}|".encode()
    )
    for name in ("tokens", "lengths", "col_pos", "col_len", "col_opts",
                 "col_vstart", "val_bytes", "val_len", "sel_slot",
                 "sel_bit", "launched"):
        arr = build_kw.get(name)
        if arr is None:
            h.update(b"|-|")
            continue
        arr = np.ascontiguousarray(arr)
        h.update(f"|{name}:{arr.dtype}:{arr.shape}|".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def save_piece_schema(cache_dir: str, key: str,
                      schema: "PieceSchema | None") -> None:
    """Write one cache entry through ``checkpoint.atomic_write_bytes``
    (temporary file, fsync, rename, directory fsync: a reader sees a
    whole entry or none): the schema's arrays as npz members and a JSON
    header with its static group structure.  ``None`` (the plan's
    geometry refuses piece emission) is cached too.  A failed write only
    means the next run rebuilds."""
    import io
    import json
    import os

    from ..runtime.checkpoint import atomic_write_bytes

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{key}.npz")
    if schema is None:
        header = {"version": SCHEMA_CACHE_VERSION, "schema": None}
        arrays = {}
    else:
        header = {
            "version": SCHEMA_CACHE_VERSION,
            "schema": {
                "kind": schema.kind,
                "closed": bool(schema.closed),
                "max_out": int(schema.max_out),
                "n_cols": int(schema.n_cols),
                "pair_ok": bool(schema.pair_ok),
                "pair_g0": int(schema.pair_g0),
                "pair_dmin": int(schema.pair_dmin),
                "pair_dmax": int(schema.pair_dmax),
                "groups": [{f: getattr(g, f) for f in _GROUP_FIELDS}
                           for g in schema.groups],
            },
        }
        arrays = {name: getattr(schema, name) for name in _SCHEMA_ARRAYS
                  if getattr(schema, name) is not None}
    buf = io.BytesIO()
    np.savez(buf, header=np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8), **arrays)
    blob = buf.getvalue()
    try:
        atomic_write_bytes(path, blob)
        _count_cache(bytes_written=len(blob))
    except OSError:  # a full disk or a racing writer: rebuild next time
        pass


def load_piece_schema(cache_dir: str, key: str
                      ) -> "Tuple[bool, PieceSchema | None]":
    """One cache entry: ``(hit, schema)``.  A missing, corrupt or
    version-mismatched entry is a miss (the caller rebuilds and
    overwrites it), never an error — a truncated file included, which
    the reference's reader raises on (``zipfile.BadZipFile``)."""
    import json
    import os
    import zipfile

    path = os.path.join(cache_dir, f"{key}.npz")
    if not os.path.exists(path):
        _count_cache(misses=1)
        return False, None
    try:
        nbytes = os.stat(path).st_size
        with np.load(path, allow_pickle=False) as data:
            header = json.loads(bytes(data["header"]).decode())
            if header.get("version") != SCHEMA_CACHE_VERSION:
                _count_cache(misses=1)
                return False, None
            meta = header["schema"]
            if meta is None:
                _count_cache(hits=1, bytes_read=nbytes)
                return True, None
            groups = tuple(PieceGroup(**{**g, "sel_cols": tuple(
                g["sel_cols"])}) for g in meta["groups"])
            arrays = {name: (np.asarray(data[name]) if name in data
                             else None) for name in _SCHEMA_ARRAYS}
            _count_cache(hits=1, bytes_read=nbytes)
            return True, PieceSchema(
                kind=meta["kind"], groups=groups,
                closed=bool(meta["closed"]), max_out=int(meta["max_out"]),
                n_cols=int(meta["n_cols"]), pair_ok=bool(meta["pair_ok"]),
                pair_g0=int(meta["pair_g0"]),
                pair_dmin=int(meta["pair_dmin"]),
                pair_dmax=int(meta["pair_dmax"]), **arrays)
    except (OSError, KeyError, ValueError, TypeError,
            zipfile.BadZipFile):
        _count_cache(misses=1)
        return False, None


# ---------------------------------------------------------------------------
# File -> packed batches (vectorized numpy)
# ---------------------------------------------------------------------------


def bucket_widths(
    lengths: np.ndarray, buckets: Tuple[int, ...] = DEFAULT_BUCKETS
) -> np.ndarray:
    """Vectorized bucket-width assignment, matching :func:`bucket_words`:
    the smallest bucket boundary covering the word, else the word's own
    power-of-two width (min 4)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    b = np.asarray(validate_buckets(buckets), dtype=np.int64)
    idx = np.searchsorted(b, lengths, side="left")
    over = idx >= len(b)
    widths = (
        np.where(over, 0, b[np.minimum(idx, len(b) - 1)])
        if len(b)
        else np.zeros(len(lengths), dtype=np.int64)
    )
    if over.any():
        pow2 = np.maximum(
            4, 2 ** np.ceil(np.log2(np.maximum(lengths, 1))).astype(np.int64)
        )
        widths = np.where(over, pow2, widths)
    return widths.astype(np.int64)


def pack_rows(
    buf: np.ndarray,
    offsets: np.ndarray,
    lengths: np.ndarray,
    sel: Optional[np.ndarray],
    width: int,
) -> PackedWords:
    """Pack the selected lines (all when ``sel`` is None) of a scanned
    buffer into one ``uint8[m, width]`` batch with one vectorized gather;
    ``index`` holds the lines' dictionary positions."""
    rows = (
        np.arange(len(offsets), dtype=np.int64) if sel is None
        else np.asarray(sel, dtype=np.int64)
    )
    lens = np.asarray(lengths)[rows].astype(np.int32)
    if len(lens) and int(lens.max()) > width:
        raise ValueError(f"row longer than width {width}")
    tokens = np.zeros((len(rows), width), dtype=np.uint8)
    if len(rows) and len(buf):
        col = np.arange(width, dtype=np.int64)[None, :]
        live = col < lens[:, None]
        pos = np.minimum(np.asarray(offsets)[rows][:, None] + col,
                         len(buf) - 1)
        tokens = np.where(live, buf[pos], np.uint8(0)).astype(np.uint8)
    return PackedWords(tokens=tokens, lengths=lens, index=rows)


# ---------------------------------------------------------------------------
# Streaming ingestion: chunked plan compilation
# ---------------------------------------------------------------------------
#
# A dictionary larger than one chunk is not compiled whole: the sweep
# (``runtime.sweep``) splits the packed batch into word chunks and one
# worker thread compiles chunk N+1's plan, piece schema and device arrays
# while the device sweeps chunk N; consumed chunks are freed, so resident
# plan state is O(ring x chunk) at any dictionary size.  This module owns
# the generic pieces; the sweep injects the compile function.


def slice_packed(packed: PackedWords, lo: int, hi: int) -> PackedWords:
    """Word rows ``[lo, hi)`` as a view batch: the slice keeps the
    parent's width and dictionary indices, so a chunk's hits report the
    positions the whole-batch plan would."""
    return PackedWords(
        tokens=packed.tokens[lo:hi],
        lengths=packed.lengths[lo:hi],
        index=packed.index[lo:hi],
    )


#: Streaming chunk sizing target: ~64 MB of compiled plan per chunk.
DEFAULT_CHUNK_TARGET_BYTES = 64 << 20

#: Conservative compiled-plan bytes per word per packed byte (plan
#: fields, piece tables and their device copies).
_EST_PLAN_BYTES_PER_TOKEN = 64


def auto_chunk_words(width: int,
                     target_bytes: int = DEFAULT_CHUNK_TARGET_BYTES) -> int:
    """Words per chunk targeting ``target_bytes`` of compiled plan for a
    ``uint8[B, width]`` batch (65,536 words at width 16); at least 1024,
    since tiny chunks drown in per-chunk overhead."""
    est = _EST_PLAN_BYTES_PER_TOKEN * max(4, int(width))
    return max(1024, int(target_bytes) // est)


def chunk_bounds(n_words: int, chunk_words: int) -> List[Tuple[int, int]]:
    """Uniform ``[lo, hi)`` word ranges of ``chunk_words`` (the last one
    ragged), so a resumed global cursor finds its chunk by arithmetic."""
    cw = int(chunk_words)
    if cw < 1:
        raise ValueError(f"chunk_words must be >= 1, got {chunk_words}")
    return [(lo, min(lo + cw, n_words)) for lo in range(0, n_words, cw)]


@dataclass
class PlanChunk:
    """One compiled dictionary chunk, produced by the worker thread:
    ``payload`` holds what the compile function attached (the sweep's
    route, arrays and launch settings), ``host_bytes`` the chunk's
    resident plan-array bytes.  :meth:`release` frees it exactly once,
    through the compile function's ``releaser``."""

    index: int
    lo: int
    hi: int
    plan: object = None
    pieces: object = None
    payload: Optional[dict] = None
    host_bytes: int = 0
    compile_s: float = 0.0
    t_start: float = 0.0
    t_end: float = 0.0
    releaser: Optional[Callable[["PlanChunk"], None]] = None

    def release(self) -> None:
        rel, self.releaser = self.releaser, None
        if rel is not None:
            rel(self)
        self.plan = self.pieces = self.payload = None


class ChunkCompiler:
    """The bounded chunk-compile ring: one worker thread compiles chunks in
    word order through ``compile_fn(index, lo, hi) -> PlanChunk``, at most
    ``prefetch`` of them ahead of the chunk being swept; iteration yields
    them in order.  A chunk whose compile raised restarts the worker once
    (the failed chunk and those queued behind it resubmitted) before the
    error propagates at the consuming ``next()``; a second failure
    propagates.  The ``chunk.compile`` fault seam fires before each
    compile.  ``windows`` and ``compile_wall_s`` time the compiles."""

    def __init__(self, compile_fn: Callable[[int, int, int], PlanChunk],
                 bounds: Sequence[Tuple[int, int]], *, start: int = 0,
                 prefetch: int = 1) -> None:
        self._fn = compile_fn
        self._bounds = list(bounds)
        self._next = start
        self._prefetch = max(1, int(prefetch))
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="a5-chunk-compile")
        self._futs: deque = deque()  # (chunk index, Future), in order
        self._restarted = False
        #: per-chunk compile windows ``(t_start, t_end)`` (monotonic)
        self.windows: List[Tuple[float, float]] = []
        self.compile_wall_s = 0.0
        self._fill()

    def _fill(self) -> None:
        # The chunk being swept was already popped: the outstanding
        # futures are the prefetch window.
        while (self._next < len(self._bounds)
               and len(self._futs) < self._prefetch):
            ci = self._next
            lo, hi = self._bounds[ci]
            self._futs.append((ci, self._ex.submit(self._timed, ci, lo, hi)))
            self._next += 1

    def _timed(self, ci: int, lo: int, hi: int) -> PlanChunk:
        from ..runtime import faults

        if faults.ACTIVE is not None:
            faults.ACTIVE.fire("chunk.compile")
        t0 = time.monotonic()
        chunk = self._fn(ci, lo, hi)
        chunk.t_start = t0
        chunk.t_end = time.monotonic()
        chunk.compile_s = chunk.t_end - t0
        return chunk

    def _restart_worker(self, failed_ci: int) -> PlanChunk:
        """Restart-once recovery: a fresh worker re-runs the failed chunk
        (a second failure propagates); a compile already running finishes
        and is kept, chunks not started are resubmitted."""
        from ..runtime import telemetry

        telemetry.counter("faults.worker_restarts").add(1)
        self._ex.shutdown(wait=True, cancel_futures=True)
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="a5-chunk-compile")
        pending = [(failed_ci, None)] + [
            (ci, None if fut.cancelled() else fut) for ci, fut in self._futs]
        self._futs.clear()
        for ci, fut in pending:
            if fut is None:
                lo, hi = self._bounds[ci]
                fut = self._ex.submit(self._timed, ci, lo, hi)
            self._futs.append((ci, fut))
        _ci, fut = self._futs.popleft()
        return fut.result()

    def __iter__(self) -> Iterator[PlanChunk]:
        from ..runtime import telemetry

        while self._futs:
            ci, fut = self._futs.popleft()
            try:
                chunk = fut.result()
            except BaseException as exc:  # noqa: BLE001 — worker death
                if self._restarted or isinstance(
                        exc, (KeyboardInterrupt, SystemExit)):
                    raise
                self._restarted = True
                chunk = self._restart_worker(ci)
            self.windows.append((chunk.t_start, chunk.t_end))
            self.compile_wall_s += chunk.compile_s
            self._fill()
            if telemetry.enabled():
                telemetry.counter("stream.chunks_compiled").add(1)
                telemetry.counter("stream.compile_wall_s").add(
                    chunk.compile_s)
                telemetry.histogram("stream.chunk_compile_s").observe(
                    chunk.compile_s)
                telemetry.gauge("stream.ring_occupancy").set(len(self._futs))
            yield chunk

    def close(self) -> None:
        """Stop compiling; safe after an aborted sweep.  Chunks already
        handed out are the caller's to release."""
        for _ci, fut in self._futs:
            fut.cancel()
        self._ex.shutdown(wait=True)
        self._futs.clear()
