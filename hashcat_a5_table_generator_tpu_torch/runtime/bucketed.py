"""Length-bucketed sweeps: one :class:`~.sweep.Sweep` per bucket width.

A word's bucket width sets the launch's candidate ``out_width`` and hash
block count, so one long line must not inflate every lane: the wordlist is
partitioned by length bucket (``native.read_packed_buckets``, crack
mode's default 16/32/64) and each bucket runs as an ordinary sweep.
Bucketing permutes words, never candidates within a word; hits stream to
the recorder bucket-major as found, and the merged result's hit list is
sorted by global ``(word_index, rank)``; candidates stream bucket-major,
dictionary order within each bucket.  Each bucket picks its own route
(piece kernel, byte-scan kernels or the XLA expand + hash route), and
streams its words in chunks or compiles them whole on its own size.

Checkpoints, as in the reference: the user's ``--checkpoint FILE`` holds
a top-level *manifest* (bucket widths → per-bucket checkpoint files and
fingerprints, ``checkpoint.save_bucket_manifest``), written before any
bucket runs and checked on resume; each bucket's cursor state lives in
``{FILE}.w{width}`` and resumes on its own.  A single-sweep checkpoint at
FILE, or a manifest written under other ``--buckets``, fails loudly
instead of silently restarting.
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

from ..ops.packing import PackedWords
from . import telemetry
from .checkpoint import check_bucket_manifest, save_bucket_manifest
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


class _BucketProgress:
    """Adapter making per-bucket progress cumulative across buckets."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.word_base = 0
        self.emit_base = 0
        self.hit_base = 0
        self._routing: dict = {}

    def advance(self, words: int, emitted: int, hits: int) -> None:
        self.word_base += words
        self.emit_base += emitted
        self.hit_base += hits

    def set_routing(self, routing: dict) -> None:
        # Per-bucket routing accumulates into whole-dictionary counts.
        for k, v in routing.items():
            self._routing[k] = self._routing.get(k, 0) + int(v)
        inner_set = getattr(self.inner, "set_routing", None)
        if inner_set is not None:
            inner_set(self._routing)

    def set_geometry(self, geometry: dict, source: str) -> None:
        # Buckets share one SweepConfig: the last bucket's stamp stands.
        inner_set = getattr(self.inner, "set_geometry", None)
        if inner_set is not None:
            inner_set(geometry, source)

    def seed_emitted(self, emitted: int) -> None:
        self.inner.seed_emitted(self.emit_base + emitted)

    def seed_hits(self, hits: int) -> None:
        inner_seed = getattr(self.inner, "seed_hits", None)
        if inner_seed is not None:
            inner_seed(self.hit_base + hits)

    def update(self, *, words_done: int, emitted: int, hits: int,
               force: bool = False) -> None:
        self.inner.update(
            words_done=self.word_base + words_done,
            emitted=self.emit_base + emitted,
            hits=self.hit_base + hits,
            force=force,
        )

    def final(self, *, words_done: int, emitted: int, hits: int) -> None:
        # A bucket's "final" is a forced update; the run's final line is
        # printed once, after the last bucket.
        self.update(words_done=words_done, emitted=emitted, hits=hits,
                    force=True)


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
        self.config = cfg = config or SweepConfig()
        self.progress = (_BucketProgress(cfg.progress)
                         if cfg.progress is not None else None)
        self.sweeps: Dict[int, Sweep] = {}
        for width in sorted(buckets):
            if not buckets[width].batch:
                continue
            bucket_cfg = replace(
                cfg,
                checkpoint_path=(f"{cfg.checkpoint_path}.w{width}"
                                 if cfg.checkpoint_path else None),
                progress=self.progress,
            )
            self.sweeps[width] = Sweep(spec, sub_map, buckets[width],
                                       digests, config=bucket_cfg)

    @property
    def n_words(self) -> int:
        return sum(s.n_words for s in self.sweeps.values())

    def _sync_manifest(self, resume: bool) -> None:
        """Check (when resuming) and write the top-level manifest at the
        user's checkpoint path, before any bucket runs, so FILE exists
        even if the run dies inside the first bucket."""
        path = self.config.checkpoint_path
        if not path:
            return
        fps = {w: s.fingerprint for w, s in self.sweeps.items()}
        if resume:
            check_bucket_manifest(path, fps)
        save_bucket_manifest(path, fps)

    def run_crack(self, recorder=None, *, resume: bool = True
                  ) -> SweepResult:
        """Crack every bucket in ascending width order."""
        t0 = time.monotonic()
        self._sync_manifest(resume)
        results = []
        for sweep in self.sweeps.values():
            res = sweep.run_crack(_ForwardRecorder(recorder), resume=resume)
            results.append(res)
            if self.progress is not None:
                self.progress.advance(res.words_done, res.n_emitted,
                                      res.n_hits)
        merged = self._merge(results, t0)
        merged.hits.sort(key=lambda h: (h.word_index, h.variant_rank))
        if self.config.progress is not None:
            self.config.progress.final(words_done=merged.words_done,
                                       emitted=merged.n_emitted,
                                       hits=merged.n_hits)
        return merged

    def run_candidates(self, writer, *, resume: bool = True) -> SweepResult:
        """Stream every bucket's candidates (ascending width, dictionary
        order within each bucket)."""
        t0 = time.monotonic()
        self._sync_manifest(resume)
        results = []
        for sweep in self.sweeps.values():
            res = sweep.run_candidates(writer, resume=resume)
            results.append(res)
            if self.progress is not None:
                self.progress.advance(res.words_done, res.n_emitted, 0)
        merged = self._merge(results, t0)
        if self.config.progress is not None:
            self.config.progress.final(words_done=merged.words_done,
                                       emitted=merged.n_emitted, hits=0)
        return merged

    def _merge(self, results, t0: float) -> SweepResult:
        """One result over the buckets: counters sum; superstep, stream
        and schema-cache stats merge by their ``telemetry`` specs (the stream's sweep-local
        scalars, such as ``ttfc_s``, are the first bucket's, and its
        overlap ratios are recomputed from the summed terms)."""
        routing: Dict[str, int] = {}
        kernels: Dict[str, int] = {}
        routes: Dict[str, int] = {}
        xla: Dict[str, int] = {}
        for r in results:
            for total, part in ((routing, r.routing), (kernels, r.kernels),
                                (routes, r.routes)):
                for k, v in part.items():
                    total[k] = total.get(k, 0) + v
            if r.xla:
                xla = {"lanes": min(xla.get("lanes", r.xla["lanes"]),
                                    r.xla["lanes"]),
                       "budget_bytes": r.xla["budget_bytes"],
                       "rows": xla.get("rows", 0) + r.xla["rows"]}
        superstep = telemetry.SUPERSTEP_MERGE.merge(
            [r.superstep for r in results])
        stream = telemetry.STREAM_MERGE.merge(
            [r.stream for r in results if r.stream])
        schema_cache = telemetry.SCHEMA_CACHE_MERGE.merge(
            [r.schema_cache for r in results])
        if stream.get("compile_wall_s", 0) > 0:
            wall = stream["compile_wall_s"]
            over = stream.get("compile_overlap_s", 0.0)
            first = stream.get("first_chunk_compile_s", 0.0)
            stream["overlap_ratio"] = over / wall
            stream["steady_overlap_ratio"] = (
                over / (wall - first) if wall - first > 0 else 0.0)
        # Every bucket's sweep resolves the same geometry from the same
        # config and profile; a bucket that launched nothing stamps none.
        geometry = next((dict(r.geometry) for r in results if r.geometry),
                        {})
        return SweepResult(
            n_emitted=sum(r.n_emitted for r in results),
            n_hits=sum(r.n_hits for r in results),
            hits=[h for r in results for h in r.hits],
            words_done=sum(r.words_done for r in results),
            wall_s=time.monotonic() - t0 + sum(
                s._schema_s for s in self.sweeps.values()
            ),
            drive_s=sum(r.drive_s for r in results),
            ttfc_s=next((r.ttfc_s for r in results if r.ttfc_s), 0.0),
            superstep=superstep,
            routing=routing,
            kernels=kernels,
            routes=routes,
            xla=xla,
            stream=stream,
            schema_cache=schema_cache,
            geometry=geometry,
            geometry_source=(results[0].geometry_source if results
                             else "explicit"),
        )
