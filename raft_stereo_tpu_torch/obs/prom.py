"""Dependency-free Prometheus text-format (0.0.4) metrics registry: a
copy of `raft_stereo_tpu/obs/prom.py` without its training sidecar
(`serve_registry`; the port's trainer exports no metrics).

The serving tier grows no dependency for a text format this small, so
this module implements exactly the subset the exposition format requires:
counters, gauges, and explicit-bucket histograms, rendered as

    # HELP name help text
    # TYPE name counter
    name{label="value"} 123

Counter semantics: values only move up. `Counter.set_total` exists to
mirror an EXISTING monotonic counter (ServingMetrics keeps its own
atomic totals; re-counting them here would double the bookkeeping on the
hot path) — it asserts monotonicity rather than trusting the caller.

Thread safety: one lock per metric, taken only on write/render. The
serving hot path touches histograms once per response — far off the
per-chunk critical path.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PROM_CONTENT_TYPE = "text/plain; version=0.0.4"

# Default latency buckets (milliseconds): spans sub-ms host gaps through
# multi-second hung-chunk territory.
DEFAULT_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(key)
    if extra is not None:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self._lock = threading.Lock()

    def sample_lines(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        lines.extend(self.sample_lines())
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {amount})")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, total: float, **labels: str) -> None:
        """Mirror an external monotonic counter. Refuses to go backwards —
        a regressing source is a bug this should surface, not hide."""
        key = _label_key(labels)
        with self._lock:
            prev = self._values.get(key, 0.0)
            if total < prev:
                raise ValueError(
                    f"counter {self.name}{dict(key)} would regress: {prev} -> {total}"
                )
            self._values[key] = float(total)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def sample_lines(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_text: str):
        super().__init__(name, help_text)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def sample_lines(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}" for k, v in items]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str, buckets: Sequence[float]):
        super().__init__(name, help_text)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {self.name} needs at least one bucket bound")
        if bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.buckets: Tuple[float, ...] = tuple(bounds)
        # per labelset: (per-bucket non-cumulative counts, sum, count)
        self._series: Dict[_LabelKey, Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels: str) -> None:
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            counts, total, n = self._series.get(
                key, ([0] * len(self.buckets), 0.0, 0)
            )
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    break
            self._series[key] = (counts, total + v, n + 1)

    def count(self, **labels: str) -> int:
        with self._lock:
            series = self._series.get(_label_key(labels))
        return series[2] if series else 0

    def sample_lines(self) -> List[str]:
        with self._lock:
            items = sorted(
                (k, (list(c), s, n)) for k, (c, s, n) in self._series.items()
            )
        lines: List[str] = []
        for key, (counts, total, n) in items:
            cumulative = 0
            for bound, c in zip(self.buckets, counts):
                cumulative += c
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(key, ('le', _fmt_value(bound)))}"
                    f" {cumulative}"
                )
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {n}")
        return lines


class Registry:
    """Named metric registry with 0.0.4 text exposition. Re-registering a
    name returns the existing metric when the kind matches (idempotent —
    the serving fleet and its replicas share one registry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_text: str, *args) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}"
                    )
                return existing
            metric = cls(name, help_text, *args)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(
        self, name: str, help_text: str = "", buckets: Iterable[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, tuple(buckets))

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def render(self) -> str:
        lines: List[str] = []
        for metric in self.metrics():
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"
