"""Structured tracing + bounded flight recorder: a copy of
`raft_stereo_tpu/obs/trace.py` (jax-free there too; the port imports
nothing of the JAX package, so it keeps its own).

A `Tracer` stamps host-side spans (name, trace ID, start/end on the
monotonic clock) and point events into a ring-buffer `FlightRecorder`
capped at N records — O(1) memory forever, and the last N records are
exactly the "what was the system doing in the seconds before" evidence
the fault machinery lacked. Dump sites in the port: the
serving watchdog's hang handler, every breaker transition and the
service's close — each writes `flight_recorder.json` through the same
atomic-rename discipline as run_report.json.

Span taxonomy:
  serving request: admission -> queue -> stage -> prelude -> chunk* -> finalize -> respond

Hot-path cost: one `deque.append` (O(1), GIL-atomic) plus two
`perf_counter` reads per span. No locks are held across user code and no
device work is ever dispatched: spans time host events only.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

FLIGHT_RECORDER_VERSION = 1


class FlightRecorder:
    """Bounded ring of span/event records with lifetime counters.

    capacity <= 0 disables recording entirely (append is a cheap no-op);
    the counters still exist so the `observability` report block stays
    fully populated either way."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: Optional[deque] = (
            deque(maxlen=self.capacity) if self.capacity > 0 else None
        )
        self._lock = threading.Lock()
        self.spans_total = 0
        self.events_total = 0
        self.dropped_total = 0
        self.dumps_total = 0

    @property
    def enabled(self) -> bool:
        return self._ring is not None

    def append(self, record: Dict[str, Any]) -> None:
        ring = self._ring
        with self._lock:
            if record.get("kind") == "event":
                self.events_total += 1
            else:
                self.spans_total += 1
            if ring is None:
                self.dropped_total += 1
                return
            if len(ring) == self.capacity:
                self.dropped_total += 1
            ring.append(record)

    def records(self) -> List[Dict[str, Any]]:
        ring = self._ring
        if ring is None:
            return []
        with self._lock:
            return list(ring)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "spans_total": self.spans_total,
                "events_total": self.events_total,
                "dropped_total": self.dropped_total,
                "dumps_total": self.dumps_total,
            }


class Tracer:
    """Span/event producer over one FlightRecorder.

    Trace IDs are process-local monotonically increasing ints
    (`itertools.count` — allocation is a single GIL-atomic `next`). A
    request's ID is minted at admission and rides every later record of
    its lifecycle; batch-level records (stage, chunk, finalize) carry the
    full ID list of the requests they cover under `traces`."""

    def __init__(self, capacity: int = 256, dump_path: Optional[str] = None):
        self.recorder = FlightRecorder(capacity)
        self._ids = itertools.count(1)
        self._traces_lock = threading.Lock()
        self.traces_total = 0
        # Default flight_recorder.json location; None = dumps are skipped
        # (counted as requested-but-unwritten is unnecessary — disabled
        # recorders simply never dump).
        self.dump_path = dump_path

    @property
    def enabled(self) -> bool:
        return self.recorder.enabled

    def start_trace(self) -> int:
        with self._traces_lock:
            self.traces_total += 1
        return next(self._ids)

    def span(
        self,
        name: str,
        trace: Optional[int] = None,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
        **attrs: Any,
    ) -> None:
        if not self.recorder.enabled:
            # Still count (cheap) so the report block reflects intent.
            self.recorder.append({"kind": "span"})
            return
        now = time.perf_counter()
        t0 = now if t0 is None else t0
        t1 = now if t1 is None else t1
        record: Dict[str, Any] = {
            "kind": "span",
            "name": name,
            "t0": t0,
            "t1": t1,
            "ms": (t1 - t0) * 1e3,
        }
        if trace is not None:
            record["trace"] = trace
        if attrs:
            record["attrs"] = attrs
        self.recorder.append(record)

    @contextmanager
    def timed(self, name: str, trace: Optional[int] = None, **attrs: Any):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.span(name, trace=trace, t0=t0, t1=time.perf_counter(), **attrs)

    def event(self, name: str, trace: Optional[int] = None, **attrs: Any) -> None:
        if not self.recorder.enabled:
            self.recorder.append({"kind": "event"})
            return
        record: Dict[str, Any] = {
            "kind": "event",
            "name": name,
            "t": time.perf_counter(),
        }
        if trace is not None:
            record["trace"] = trace
        if attrs:
            record["attrs"] = attrs
        self.recorder.append(record)

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the last-N records as flight_recorder.json (atomic
        rename, same discipline as run_report.json). Returns the path
        written, or None when no path is configured / recording is off.
        Never raises: dump sites are failure handlers — a failing dump
        must not mask the failure being recorded."""
        path = path if path is not None else self.dump_path
        if path is None or not self.recorder.enabled:
            return None
        payload = {
            "flight_recorder_version": FLIGHT_RECORDER_VERSION,
            "reason": str(reason),
            "dumped_at_unix": time.time(),
            "counters": self.recorder.counters(),
            "traces_total": int(self.traces_total),
            "records": self.recorder.records(),
        }
        try:
            from raft_stereo_tpu_torch.utils.run_report import atomic_write_json

            atomic_write_json(path, payload)
        except Exception:  # noqa: BLE001 - see docstring
            import logging

            logging.getLogger(__name__).warning(
                "could not write flight recorder dump to %s", path, exc_info=True
            )
            return None
        with self.recorder._lock:
            self.recorder.dumps_total += 1
        return path


def observability_block(tracer: Optional[Tracer]) -> Dict[str, Any]:
    """The additive `observability` block for run_report.json (schema v2
    discipline: absent means "not measured"; present means complete and
    typed — scripts/check_run_report.py validates it)."""
    if tracer is None:
        return {
            "enabled": False,
            "capacity": 0,
            "traces_total": 0,
            "spans_total": 0,
            "events_total": 0,
            "dropped_total": 0,
            "dumps_total": 0,
        }
    counters = tracer.recorder.counters()
    return {
        "enabled": bool(tracer.enabled),
        "capacity": int(tracer.recorder.capacity if tracer.enabled else 0),
        "traces_total": int(tracer.traces_total),
        "spans_total": int(counters["spans_total"]),
        "events_total": int(counters["events_total"]),
        "dropped_total": int(counters["dropped_total"]),
        "dumps_total": int(counters["dumps_total"]),
    }


def load_flight_recorder(path: str) -> Dict[str, Any]:
    """Parse a flight_recorder.json dump (test/tooling helper)."""
    with open(path, "r") as f:
        payload = json.load(f)
    if payload.get("flight_recorder_version") != FLIGHT_RECORDER_VERSION:
        raise ValueError(
            f"unsupported flight recorder version in {path!r}: "
            f"{payload.get('flight_recorder_version')!r}"
        )
    return payload
