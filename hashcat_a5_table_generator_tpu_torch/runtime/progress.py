"""Rate-limited structured progress to stderr (the reference package's
``runtime/progress.py``, copied: the same JSON lines and keys).

Candidates and hits own stdout, so progress keeps to stderr.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


class ProgressReporter:
    """Emits one JSON progress line to ``stream`` at most every
    ``every_s`` seconds (and unconditionally on ``final()``)."""

    def __init__(
        self,
        total_words: int,
        *,
        every_s: float = 5.0,
        stream: Optional[TextIO] = None,
        clock=time.monotonic,
    ) -> None:
        self.total_words = total_words
        self.every_s = every_s
        self.stream = stream if stream is not None else sys.stderr
        self._clock = clock
        self._t0 = clock()
        self._last = float("-inf")
        self._last_emitted = 0
        self._last_hits = 0
        self._last_t = self._t0
        self._routing: "dict | None" = None
        self._stream: "dict | None" = None
        self._geometry: "dict | None" = None

    def set_routing(self, routing: dict) -> None:
        """Attach the sweep's word-routing counts (device_clean /
        device_closed / oracle_fallback — a plan-time fact, constant over
        the run); included in every progress line once known."""
        self._routing = dict(routing)

    def set_stream(self, stream: dict) -> None:
        """Attach a streaming sweep's chunk position
        (``CheckpointState.stream``: the active ``{"chunk", "chunk_words"}``
        marker — updated per chunk, seeded immediately on a resumed
        streaming sweep); included in every progress line once known."""
        self._stream = dict(stream)

    def set_geometry(self, geometry: dict, source: str) -> None:
        """Attach the resolved launch geometry and its provenance
        (``explicit``/``profile``/``default``, constant over the run);
        included in every progress line once known."""
        self._geometry = dict(geometry, source=source)

    def seed_emitted(self, emitted: int) -> None:
        """Base the first rate window on a resumed sweep's prior count, so
        candidates emitted by an earlier process are not attributed to this
        one's first few seconds."""
        self._last_emitted = emitted

    def seed_hits(self, hits: int) -> None:
        """``seed_emitted``'s twin for the hit-rate window: a resumed
        crack sweep re-reports its checkpointed hits up front, and they
        must not inflate this process's first ``hits_per_sec``."""
        self._last_hits = hits

    def update(
        self, *, words_done: int, emitted: int, hits: int, force: bool = False
    ) -> None:
        now = self._clock()
        if not force and now - self._last < self.every_s:
            return
        window = max(now - self._last_t, 1e-9)
        rate = (emitted - self._last_emitted) / window
        hit_rate = (hits - self._last_hits) / window
        self._last, self._last_t = now, now
        self._last_emitted = emitted
        self._last_hits = hits
        body = {
            "words": [words_done, self.total_words],
            "candidates": emitted,
            "cand_per_sec": round(rate, 1),
            "hits": hits,
            "hits_per_sec": round(hit_rate, 3),
            "elapsed_s": round(now - self._t0, 2),
        }
        if self._routing is not None:
            body["routing"] = self._routing
        if self._stream is not None:
            body["stream"] = self._stream
        if self._geometry is not None:
            body["geometry"] = self._geometry
        # Registry-derived enrichment: the pipeline's dead-time share,
        # chunk-ring occupancy, cache hit rates — silent when
        # A5GEN_TELEMETRY=off or nothing recorded.
        from .telemetry import progress_fields

        extra = progress_fields()
        if extra:
            body["telemetry"] = extra
        print(
            json.dumps({"progress": body}),
            file=self.stream,
            flush=True,
        )

    def final(self, *, words_done: int, emitted: int, hits: int) -> None:
        self.update(
            words_done=words_done, emitted=emitted, hits=hits, force=True
        )
