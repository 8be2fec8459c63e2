"""Process-wide telemetry: one metrics registry and the sweep's span
timeline (the parts of the reference package's ``runtime/telemetry.py``
a sweep uses; standard library only, but for the profiler hooks, which
import ``torch.profiler`` when called).

* :class:`MetricsRegistry` — thread-safe counters, gauges and
  fixed-bucket histograms with plain-dict ``snapshot()`` / :func:`delta`,
  and :func:`merge`, which a pod's gathered ``--metrics-json`` reduces
  its processes' snapshots through.
* :class:`SpanTimeline` — a bounded per-sweep ring of span records,
  appended only at consumed fetch boundaries (the drive's lagged counters
  barrier), never inside the in-flight window.  Its summary carries the
  drive's host-gap total and the share of it with no superstep in flight
  (``dead_share``).
* :class:`MergeSpec` — what each key of a per-sweep stat dict means when
  length buckets' results merge (:data:`SUPERSTEP_MERGE`,
  :data:`STREAM_MERGE`, :data:`SCHEMA_CACHE_MERGE`).
* The fleet half: :func:`set_engine_id` labels every snapshot with the
  serving engine's identity (``a5gen serve --engine-id``), and
  :func:`to_prometheus` renders a snapshot as Prometheus text, as the
  reference does (the serve ``metrics`` op).
* :func:`profiler_span` / :func:`profiler_trace` —
  ``torch.profiler.record_function`` and a ``torch.profiler.profile``
  whose Chrome trace lands in ``--profile DIR``.

``A5GEN_TELEMETRY=off`` (``runtime/env.telemetry_enabled``) disables the
hot-path instrumentation — span appends, per-fetch registry updates,
progress enrichment.  Counters the result surfaces read always record:
the hatch never changes what a sweep reports, only what it instruments.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import (Any, Callable, ContextManager, Dict, Iterable, List,
                    Optional, Sequence, Tuple, Type, TypeVar)


def enabled() -> bool:
    """Whether hot-path telemetry records (``A5GEN_TELEMETRY`` hatch).
    Re-read per call, but only ever consulted at host-side fetch
    boundaries, never per candidate."""
    from .env import telemetry_enabled

    return telemetry_enabled()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

#: Default histogram bucket edges for wall-clock seconds.
DEFAULT_TIME_EDGES: Tuple[float, ...] = (
    1e-5, 2.5e-5, 1e-4, 2.5e-4, 1e-3, 2.5e-3, 1e-2, 2.5e-2,
    0.1, 0.25, 1.0, 2.5, 10.0,
)


class Counter:
    """Monotonic counter (int or float adds).  Always records."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value: float = 0
        self._lock = threading.Lock()

    def add(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snap(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value with a declared aggregation
    (``max``/``min``/``sum``/``last``) carried in its snapshot."""

    __slots__ = ("name", "agg", "_value", "_lock")

    def __init__(self, name: str, agg: str = "last") -> None:
        if agg not in ("max", "min", "sum", "last"):
            raise ValueError(
                f"gauge agg must be max|min|sum|last, got {agg!r}"
            )
        self.name = name
        self.agg = agg
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _snap(self) -> dict:
        return {"type": "gauge", "value": self.value, "agg": self.agg}


class Histogram:
    """Fixed-bucket histogram.  ``edges`` are upper bounds (bucket ``i``
    counts observations ``<= edges[i]``), with one overflow bucket past
    the last edge; the edges are part of the snapshot."""

    __slots__ = ("name", "edges", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str,
                 edges: Sequence[float] = DEFAULT_TIME_EDGES) -> None:
        edges = tuple(float(e) for e in edges)
        if not edges or any(a >= b for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram edges must be strictly ascending, got {edges}"
            )
        self.name = name
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def _snap(self) -> dict:
        with self._lock:
            return {
                "type": "histogram",
                "edges": list(self.edges),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


_M = TypeVar("_M")


class MetricsRegistry:
    """Name → metric, with get-or-create accessors and a plain-dict
    snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls: Type[_M], *args: Any, **kw: Any) -> _M:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args, **kw)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str, agg: str = "last") -> Gauge:
        return self._get(name, Gauge, agg)

    def histogram(self, name: str,
                  edges: Sequence[float] = DEFAULT_TIME_EDGES) -> Histogram:
        return self._get(name, Histogram, edges)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able ``{name: {"type", "value"/...}}`` in sorted name
        order."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: m._snap() for name, m in metrics}

    def reset(self) -> None:
        """Drop every metric (tests only; deltas scope counters to a
        run)."""
        with self._lock:
            self._metrics.clear()


#: The process-wide registry every subsystem publishes into.
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str, agg: str = "last") -> Gauge:
    return REGISTRY.gauge(name, agg)


def histogram(name: str,
              edges: Sequence[float] = DEFAULT_TIME_EDGES) -> Histogram:
    return REGISTRY.histogram(name, edges)


class Stopwatch:
    """Context manager timing one section into a registry histogram;
    ``elapsed_s`` is readable after exit.  Recording honours the
    ``A5GEN_TELEMETRY`` hatch, the reading does not."""

    __slots__ = ("elapsed_s", "_hist", "_t0")

    def __init__(self, hist: Optional[Histogram]) -> None:
        self.elapsed_s = 0.0
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self) -> "Stopwatch":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc: object) -> None:
        self.elapsed_s = time.monotonic() - self._t0
        if self._hist is not None and enabled():
            self._hist.observe(self.elapsed_s)


def stopwatch(name: str,
              edges: Sequence[float] = DEFAULT_TIME_EDGES) -> Stopwatch:
    """Time a ``with`` block into ``histogram(name, edges)``."""
    return Stopwatch(REGISTRY.histogram(name, edges))


#: Engine identity label: set by ``a5gen serve --engine-id`` (default
#: ``pid@host`` in serve mode), None outside service mode — standalone
#: runs keep unlabeled series.
_ENGINE_ID: Optional[str] = None


def set_engine_id(engine_id: Optional[str]) -> None:
    """Label every subsequent :func:`snapshot` with this engine's
    identity, so a merged scrape of several engines keeps them apart.
    ``None`` clears the label."""
    global _ENGINE_ID
    _ENGINE_ID = engine_id


def default_engine_id() -> str:
    """``pid@host`` — the ``--engine-id`` default: unique per process
    on one host, stable for the process lifetime."""
    import os
    import socket as socket_mod

    return f"{os.getpid()}@{socket_mod.gethostname()}"


def engine_id() -> Optional[str]:
    return _ENGINE_ID


def snapshot() -> Dict[str, dict]:
    snap = REGISTRY.snapshot()
    if _ENGINE_ID is not None:
        for entry in snap.values():
            entry["engine"] = _ENGINE_ID
    return snap


def delta(before: Dict[str, dict], after: Dict[str, dict]
          ) -> Dict[str, dict]:
    """One run's share of the process counters: counters and histograms
    subtract (metrics absent from ``before`` count from zero); gauges
    pass through ``after`` when they moved.  Only nonzero entries
    survive."""
    out: Dict[str, dict] = {}
    for name, snap in after.items():
        prev = before.get(name)
        label = {"engine": snap["engine"]} if "engine" in snap else {}
        if snap["type"] == "counter":
            d = snap["value"] - (prev["value"] if prev else 0)
            if d:
                out[name] = {"type": "counter", "value": d, **label}
        elif snap["type"] == "histogram":
            if prev and prev.get("edges") != snap["edges"]:
                prev = None  # re-created with new edges: delta from zero
            counts = [
                c - (prev["counts"][i] if prev else 0)
                for i, c in enumerate(snap["counts"])
            ]
            count = snap["count"] - (prev["count"] if prev else 0)
            if count:
                out[name] = {
                    "type": "histogram", "edges": list(snap["edges"]),
                    "counts": counts,
                    "sum": snap["sum"] - (prev["sum"] if prev else 0.0),
                    "count": count, **label,
                }
        elif prev is None or snap["value"] != prev["value"]:
            out[name] = dict(snap)
    return out


def _series_key(name: str, engine_id: Optional[str]) -> str:
    """Merged-output key of a per-engine series (the Prometheus label
    spelling)."""
    return f'{name}{{engine="{engine_id or ""}"}}'


def merge(snapshots: Iterable[Dict[str, dict]]) -> Dict[str, dict]:
    """Combine snapshots from several sources (a pod's processes), as the
    reference's ``merge``: counters and histogram buckets sum (histogram
    edge layouts must match), gauges follow their declared ``agg`` among
    entries of one engine (gauges of conflicting ``engine`` labels are
    kept as per-engine series).  Keys go in sorted order, so every
    process of a pod reduces the same sequence."""
    out: Dict[str, dict] = {}
    split: set = set()  # gauge names kept per engine
    for snap in snapshots:
        for name in sorted(snap):
            entry = snap[name]
            key = name
            if entry["type"] == "gauge":
                if name in split:
                    key = _series_key(name, entry.get("engine"))
                else:
                    cur = out.get(name)
                    if cur is not None and \
                            cur.get("engine") != entry.get("engine"):
                        out[_series_key(name, cur.get("engine"))] = \
                            out.pop(name)
                        split.add(name)
                        key = _series_key(name, entry.get("engine"))
            cur = out.get(key)
            if cur is None:
                out[key] = json.loads(json.dumps(entry))  # deep copy
                continue
            if cur["type"] != entry["type"]:
                raise ValueError(f"metric {name!r} merges a {cur['type']} "
                                 f"with a {entry['type']}")
            if cur.get("engine") != entry.get("engine"):
                cur.pop("engine", None)
            if entry["type"] == "counter":
                cur["value"] += entry["value"]
            elif entry["type"] == "histogram":
                if cur["edges"] != entry["edges"]:
                    raise ValueError(
                        f"histogram {name!r} edge layouts differ: "
                        f"{cur['edges']} vs {entry['edges']}")
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], entry["counts"])]
                cur["sum"] += entry["sum"]
                cur["count"] += entry["count"]
            else:
                agg = cur.get("agg", "last")
                if agg == "sum":
                    cur["value"] += entry["value"]
                elif agg == "max":
                    cur["value"] = max(cur["value"], entry["value"])
                elif agg == "min":
                    cur["value"] = min(cur["value"], entry["value"])
                else:
                    cur["value"] = entry["value"]
    return out


def _prom_name(name: str, prefix: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"{prefix}_{out}"


def _prom_labels(entry: dict, extra: str = "") -> str:
    """Label block for one series: the optional ``le`` bucket label plus
    the ``engine`` identity label when the snapshot carries one."""
    parts = [extra] if extra else []
    if "engine" in entry:
        parts.append(f'engine="{entry["engine"]}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(snap: Dict[str, dict], prefix: str = "a5gen") -> str:
    """Prometheus text exposition (v0.0.4) of a snapshot, as the
    reference renders it: counters, gauges, and cumulative
    ``le``-bucketed histograms with ``+Inf``, ``_sum`` and ``_count``
    series; an engine identity renders as an ``engine="..."`` label, and
    :func:`merge`'s per-engine series render under their base name."""
    lines: List[str] = []
    typed: set = set()  # one # TYPE line per metric name
    for name in sorted(snap):
        entry = snap[name]
        base = name.split("{", 1)[0]
        pname = _prom_name(base, prefix)
        label = _prom_labels(entry)
        if entry["type"] == "histogram":
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, c in zip(entry["edges"], entry["counts"]):
                cum += c
                le = 'le="%g"' % edge
                lines.append(
                    f"{pname}_bucket{_prom_labels(entry, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(f'{pname}_bucket{_prom_labels(entry, inf)} '
                         f'{entry["count"]}')
            lines.append(f"{pname}_sum{label} {entry['sum']:g}")
            lines.append(f"{pname}_count{label} {entry['count']}")
        else:
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {entry['type']}")
            v = entry["value"]
            lines.append(f"{pname}{label} {v:g}" if isinstance(v, float)
                         else f"{pname}{label} {v}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Superstep span timeline
# ---------------------------------------------------------------------------


class SpanTimeline:
    """Bounded per-sweep ring of fetch-boundary span records.

    One record per consumed fetch (a superstep's counters, a per-launch
    drain, a candidates launch), appended at the already-host-side
    boundary, so the timeline never adds a device round trip; the ring
    bound (``capacity``) keeps memory flat.  Each record carries the
    fetch's wall clock, the host gap since the previous consumed fetch,
    the in-flight depth at the fetch (0 = the gap was dead device time),
    hit-buffer occupancy and overflow-replay markers.  It also publishes
    the registry aggregates (``sweep.fetch_gap_s`` histogram,
    ``sweep.host_gap_s`` / ``sweep.dead_host_s``, per-kind fetch counters,
    ``sweep.launches`` / ``sweep.candidates`` / ``sweep.hits``)."""

    def __init__(self, capacity: int = 512,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._clock = clock
        self._lock = threading.Lock()
        self._n = 0
        self._last_fetch: Optional[float] = None
        self._gap_s = 0.0
        self._dead_s = 0.0
        self._max_inflight = 0

    def record_fetch(self, *, kind: str = "superstep", index: int = 0,
                     dispatched_at: Optional[float] = None,
                     inflight: int = 0, launches: int = 0,
                     emitted: int = 0, hits: int = 0,
                     hit_occupancy: float = 0.0, replayed: bool = False,
                     chunk: Optional[int] = None) -> None:
        """Append one span at a consumed fetch boundary and publish the
        aggregates.  No-op under ``A5GEN_TELEMETRY=off``."""
        if not enabled():
            return
        now = self._clock()
        rec = {
            "t": now, "kind": kind, "index": int(index),
            "inflight": int(inflight), "emitted": int(emitted),
            "hits": int(hits),
        }
        if dispatched_at is not None:
            rec["queued_s"] = now - dispatched_at
        if hit_occupancy:
            rec["hit_occupancy"] = float(hit_occupancy)
        if replayed:
            rec["replayed"] = True
        if chunk is not None:
            rec["chunk"] = int(chunk)
        gap = None
        with self._lock:
            if self._last_fetch is not None:
                gap = now - self._last_fetch
                rec["gap_s"] = gap
                self._gap_s += gap
                if inflight == 0:
                    self._dead_s += gap
            self._last_fetch = now
            self._n += 1
            self._max_inflight = max(self._max_inflight, int(inflight))
            self._ring.append(rec)
        counter(f"sweep.fetches.{kind}").add(1)
        if launches:
            counter("sweep.launches").add(int(launches))
        if emitted:
            counter("sweep.candidates").add(int(emitted))
        if hits:
            counter("sweep.hits").add(int(hits))
        if replayed:
            counter("sweep.overflow_replays").add(1)
        if gap is not None:
            histogram("sweep.fetch_gap_s").observe(gap)
            counter("sweep.host_gap_s").add(gap)
            if inflight == 0:
                counter("sweep.dead_host_s").add(gap)

    def spans(self) -> List[dict]:
        """The retained span records, oldest first."""
        with self._lock:
            return list(self._ring)

    def summary(self) -> dict:
        """Per-sweep span digest for ``--metrics-json``: span/drop counts,
        host-gap totals, the dead (no superstep in flight) share of the
        gap and the peak in-flight depth.  Empty when nothing recorded."""
        with self._lock:
            n = self._n
            if not n:
                return {}
            retained = len(self._ring)
            gap_s, dead_s = self._gap_s, self._dead_s
            max_inflight = self._max_inflight
            last = self._ring[-1]
        out = {
            "spans": n,
            "dropped": n - retained,
            "host_gap_s": round(gap_s, 6),
            "dead_host_s": round(dead_s, 6),
            "max_inflight": max_inflight,
            "last_kind": last["kind"],
        }
        if gap_s > 0:
            out["dead_share"] = round(dead_s / gap_s, 4)
        return out


# ---------------------------------------------------------------------------
# Stat-dict merge semantics
# ---------------------------------------------------------------------------


class MergeSpec:
    """Key semantics of one per-sweep stat dict: which keys sum (the
    default for anything undeclared), which take the max, which belong to
    the first contributor only (sweep-local scalars such as ``ttfc_s``),
    and which are derived ratios the merger recomputes."""

    def __init__(self, *, sum_keys: Sequence[str] = (),
                 max_keys: Sequence[str] = (),
                 first_keys: Sequence[str] = (),
                 derived_keys: Sequence[str] = ()) -> None:
        self.sum_keys = tuple(sum_keys)
        self.max_keys = tuple(max_keys)
        self.first_keys = tuple(first_keys)
        self.derived_keys = tuple(derived_keys)

    def merge(self, dicts: Sequence[Dict]) -> Dict:
        out: Dict = {}
        for i, d in enumerate(dicts):
            for k, v in d.items():
                if k in self.derived_keys:
                    continue
                if k in self.max_keys:
                    out[k] = max(out.get(k, 0), v)
                elif k in self.first_keys:
                    if i == 0:
                        out[k] = v
                else:
                    out[k] = out.get(k, 0) + v
        return out


#: ``SweepResult.superstep``: counters sum; the steps-per-fetch ratio and
#: the pair flag describe one shared config, so they max.
SUPERSTEP_MERGE = MergeSpec(
    sum_keys=("supersteps", "launches", "replays", "retries"),
    max_keys=("launches_per_fetch", "pipelined", "pair"),
)

#: ``SweepResult.stream``: walls and counters sum, peaks and bounds max,
#: sweep-local scalars belong to the first streaming contributor, the
#: overlap ratios are derived from the summed terms.
STREAM_MERGE = MergeSpec(
    sum_keys=("chunks", "chunks_swept", "compile_wall_s",
              "compile_overlap_s"),
    max_keys=("peak_resident_plan_bytes", "chunk_bytes_max",
              "chunk_words", "prefetch", "ring"),
    first_keys=("ttfc_s", "resumed_chunk", "first_chunk_compile_s"),
    derived_keys=("overlap_ratio", "steady_overlap_ratio"),
)


#: ``SweepResult.schema_cache``: every counter sums.
SCHEMA_CACHE_MERGE = MergeSpec()


# ---------------------------------------------------------------------------
# Progress enrichment + profiler hooks
# ---------------------------------------------------------------------------


def progress_fields() -> dict:
    """Registry-derived fields for the progress JSON line: the pipeline's
    dead-time share, chunk-ring occupancy and cache hit rates — only the
    fields with signal; {} when telemetry is off or nothing recorded."""
    if not enabled():
        return {}
    out: dict = {}
    gap = counter("sweep.host_gap_s").value
    if gap > 0:
        out["dead_share"] = round(
            counter("sweep.dead_host_s").value / gap, 4
        )
    ring = gauge("stream.ring_occupancy").value
    if ring:
        out["ring_occupancy"] = int(ring)
    for label, prefix in (("schema_cache_hit_rate", "schema_cache"),
                          ("step_cache_hit_rate", "step_cache")):
        hits = counter(f"{prefix}.hits").value
        misses = counter(f"{prefix}.misses").value
        if hits + misses:
            out[label] = round(hits / (hits + misses), 4)
    return out


def profiler_span(name: str) -> ContextManager[Any]:
    """A ``torch.profiler.record_function`` span: a named range on the
    host timeline of a ``--profile`` trace (cheap when no profiler is
    running)."""
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def profiler_trace(path: Optional[str]):
    """Profile the block under ``torch.profiler.profile`` (CPU, and CUDA
    when a GPU is visible) and write its Chrome trace to
    ``path/trace.json``; a null context when ``path`` is falsy."""
    if not path:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
