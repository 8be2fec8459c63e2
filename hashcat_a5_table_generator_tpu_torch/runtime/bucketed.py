"""Length-bucketed sweeps: one :class:`~.sweep.Sweep` per bucket width.

A word's bucket width sets the launch's candidate ``out_width`` and hash
block count, so one long line must not inflate every lane: the wordlist is
partitioned by length bucket (``native.read_packed_buckets``, crack
mode's default 16/32/64) and each bucket runs as an ordinary sweep.
Bucketing permutes words, never candidates within a word; hits stream to
the recorder bucket-major as found, and the merged result's hit list is
sorted by global ``(word_index, rank)``; candidates stream bucket-major,
dictionary order within each bucket.  Each bucket picks its own route
(piece kernel, byte-scan kernels or the XLA expand + hash route); a
refusal in any bucket stops the run before the first bucket launches.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..ops.packing import PackedWords
from .sweep import Sweep, SweepConfig, SweepResult


class _ForwardRecorder:
    """Per-bucket recorder that streams every hit straight through to the
    user's recorder while keeping a bucket-local list."""

    def __init__(self, sink) -> None:
        self.hits: list = []
        self.sink = sink

    def emit(self, record) -> None:
        self.hits.append(record)
        if self.sink is not None:
            self.sink.emit(record)


class BucketedSweep:
    """One wordlist × one table × one spec, split across length buckets.

    ``buckets`` is ``{width: PackedWords}``; widths run in ascending
    order."""

    def __init__(
        self,
        spec,
        sub_map: Dict[bytes, List[bytes]],
        buckets: Dict[int, PackedWords],
        digests: Sequence[bytes] = (),
        config: Optional[SweepConfig] = None,
    ) -> None:
        self.config = config or SweepConfig()
        self.sweeps: Dict[int, Sweep] = {
            width: Sweep(spec, sub_map, buckets[width], digests,
                         config=self.config)
            for width in sorted(buckets)
            if buckets[width].batch
        }

    @property
    def n_words(self) -> int:
        return sum(s.n_words for s in self.sweeps.values())

    def run_crack(self, recorder=None) -> SweepResult:
        """Crack every bucket in ascending width order."""
        t0 = time.monotonic()
        for sweep in self.sweeps.values():
            sweep.check("crack")
        results = [
            sweep.run_crack(_ForwardRecorder(recorder))
            for sweep in self.sweeps.values()
        ]
        merged = self._merge(results, t0)
        merged.hits.sort(key=lambda h: (h.word_index, h.variant_rank))
        return merged

    def run_candidates(self, writer) -> SweepResult:
        """Stream every bucket's candidates (ascending width, dictionary
        order within each bucket)."""
        t0 = time.monotonic()
        for sweep in self.sweeps.values():
            sweep.check("candidates")
        return self._merge(
            [sweep.run_candidates(writer) for sweep in self.sweeps.values()],
            t0)

    def _merge(self, results, t0: float) -> SweepResult:
        routing: Dict[str, int] = {}
        kernels: Dict[str, int] = {}
        routes: Dict[str, int] = {}
        superstep: Dict[str, int] = {}
        xla: Dict[str, int] = {}
        for r in results:
            for total, part in ((routing, r.routing), (kernels, r.kernels),
                                (routes, r.routes)):
                for k, v in part.items():
                    total[k] = total.get(k, 0) + v
            for k, v in r.superstep.items():
                summed = k in ("supersteps", "launches", "replays",
                               "per_launch")
                superstep[k] = superstep.get(k, 0) + v if summed \
                    else max(superstep.get(k, 0), v)
            if r.xla:
                xla = {"lanes": min(xla.get("lanes", r.xla["lanes"]),
                                    r.xla["lanes"]),
                       "budget_bytes": r.xla["budget_bytes"],
                       "rows": xla.get("rows", 0) + r.xla["rows"]}
        return SweepResult(
            n_emitted=sum(r.n_emitted for r in results),
            n_hits=sum(r.n_hits for r in results),
            hits=[h for r in results for h in r.hits],
            words_done=sum(r.words_done for r in results),
            wall_s=time.monotonic() - t0 + sum(
                s._schema_s for s in self.sweeps.values()
            ),
            drive_s=sum(r.drive_s for r in results),
            superstep=superstep,
            routing=routing,
            kernels=kernels,
            routes=routes,
            xla=xla,
        )
