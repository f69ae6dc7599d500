"""Process-wide metrics registry of the training child and the serving replica.

Own copy of the subset of ``tony_tpu/obs/metrics.py`` the port records
into: named counters, gauges and fixed-bucket histograms (with an SLO
bucket edge and worst-value exemplars) in one ``REGISTRY``, and
``snapshot()`` in the JSON shape the JAX registry gives. The training loop
and the serving replica drop that snapshot at ``<train-metrics-file>.obs``; the
executor merges it into its metrics push, so the instruments reach the
AM's ``get_metrics``, ``tony top``, ``tony goodput`` and the portal's
``/metrics``. ``set_enabled(False)`` (``tony.metrics.enabled=false``)
turns every recording call into an early return.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Mapping, Sequence

#: latency buckets (seconds): sub-ms up to multi-second checkpoint work
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)

_enabled = True


def set_enabled(on: bool) -> None:
    """Gate all recording (tony.metrics.enabled); registration still works."""
    global _enabled
    _enabled = bool(on)


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}

    def _key(self, labels: Mapping[str, Any]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != declared {sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _samples(self) -> list[dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                    for k, v in self._children.items()]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if not _enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        if not _enabled:
            return
        key = self._key(labels)
        with self._lock:
            self._children[key] = float(value)


#: worst-offender exemplars kept per histogram child (highest values)
EXEMPLAR_K = 5


class Histogram(_Metric):
    """Fixed-bucket histogram: per-bucket counts plus an overflow bucket."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs or any(not math.isfinite(b) for b in bs):
            raise ValueError(f"{name}: buckets must be finite and non-empty")
        self.buckets = tuple(bs)

    def ensure_bucket(self, bound: float) -> None:
        """Insert a bucket edge (idempotent), e.g. the SLO's TTFT threshold,
        so good/bad counts are exact. Call at startup: values observed
        before stay in their coarser bucket."""
        b = float(bound)
        if not math.isfinite(b) or b <= 0:
            raise ValueError(f"{self.name}: SLO bucket bound must be finite and > 0")
        with self._lock:
            if b in self.buckets:
                return
            merged = sorted(self.buckets + (b,))
            idx = merged.index(b)
            self.buckets = tuple(merged)
            for child in self._children.values():
                child["counts"].insert(idx, 0)

    def observe(self, value: float, exemplar: Any = None, **labels: Any) -> None:
        """Count ``value``; an ``exemplar`` (a request id) joins the
        child's worst-``EXEMPLAR_K`` list by value."""
        if not _enabled:
            return
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = {"counts": [0] * (len(self.buckets) + 1),
                                               "sum": 0.0, "count": 0, "exemplars": []}
            i = next((i for i, ub in enumerate(self.buckets) if value <= ub), len(self.buckets))
            child["counts"][i] += 1
            child["sum"] += value
            child["count"] += 1
            if exemplar is not None:
                ex = child["exemplars"]
                ex.append((float(value), str(exemplar)))
                ex.sort(key=lambda t: -t[0])
                del ex[EXEMPLAR_K:]

    def _snapshot(self) -> tuple[list[float], list[dict[str, Any]]]:
        # buckets and counts under one lock: ensure_bucket resizes counts
        with self._lock:
            return list(self.buckets), [
                {"labels": dict(zip(self.labelnames, k)), "counts": list(v["counts"]),
                 "sum": v["sum"], "count": v["count"], "exemplars": [list(e) for e in v["exemplars"]]}
                for k, v in self._children.items()]


class MetricsRegistry:
    """Name → metric; registering a name again returns the metric it has."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name: str, help_: str, labelnames: Sequence[str], **kwargs: Any) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, labelnames, **kwargs)
            elif not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} re-registered with a different shape")
            return m

    def snapshot(self) -> list[dict[str, Any]]:
        """Every metric as JSON: ``{"name", "type", "help", "labelnames",
        "samples"}`` plus ``"buckets"`` for a histogram."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = []
        for m in metrics:
            entry: dict[str, Any] = {"name": m.name, "type": m.kind, "help": m.help,
                                     "labelnames": list(m.labelnames)}
            if isinstance(m, Histogram):
                entry["buckets"], entry["samples"] = m._snapshot()
            else:
                entry["samples"] = m._samples()
            out.append(entry)
        return out


#: the process-wide registry every instrument of the port records into
REGISTRY = MetricsRegistry()


def counter(name: str, help_: str = "", labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY._register(Counter, name, help_, labelnames)


def gauge(name: str, help_: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY._register(Gauge, name, help_, labelnames)


def histogram(name: str, help_: str = "", labelnames: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY._register(Histogram, name, help_, labelnames, buckets=buckets)
