"""Profiling hooks: the port's counterpart of the JAX package's
`raft_stereo_tpu/utils/profiling.py`.

- `trace(logdir)`: a context manager around `torch.profiler` (CPU and CUDA
  activities) that writes a Chrome trace, `<logdir>/trace.json`, of the
  block and logs its `trace_summary`; the trainer's `profile_steps` window
  uses it.
- `StepTimer`: wall-clock step statistics (steps/s, p50, p95) without a
  trace viewer; a device synchronize happens only at report time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str = "runs/profile") -> Iterator[None]:
    """Capture a torch.profiler trace of everything inside the block."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    logger.info("profiler trace summary: %s", json.dumps(trace_summary(path)))


def trace_summary(path: str, top: int = 8) -> dict:
    """A Chrome trace's totals in ms: the host window (first to last host
    event), device kernel and copy time, the device's busy share (kernel
    time over the window), and the `top` user annotations by host time
    (collectives, as `gloo:all_gather`; FSDP2's `FSDP::...`; the optimizer)
    as [ms, count]. Nested annotations each count in full."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    totals = collections.Counter()
    notes = collections.Counter()
    counts = collections.Counter()
    start, end = float("inf"), float("-inf")
    for e in events:
        cat, dur = e.get("cat", ""), float(e.get("dur", 0.0)) / 1e3
        totals[cat] += dur
        if cat in ("cpu_op", "user_annotation", "cuda_runtime"):
            start, end = min(start, float(e["ts"]) / 1e3), max(end, float(e["ts"]) / 1e3 + dur)
        if cat == "user_annotation":
            notes[e["name"]] += dur
            counts[e["name"]] += 1
    window = max(end - start, 0.0)
    return {"window_ms": round(window, 3), "kernel_ms": round(totals["kernel"], 3),
            "memcpy_ms": round(totals["gpu_memcpy"], 3),
            "busy": round(totals["kernel"] / window, 4) if window else 0.0,
            "annotations": {name: [round(ms, 3), counts[name]] for name, ms in notes.most_common(top)}}


class StepTimer:
    """Rolling wall-clock step statistics. `tick()` marks a step boundary
    and returns the seconds since the previous one (None on the first);
    `report(device)` synchronizes `device` first when it is a card, so the
    last step's device work counts, and returns {steps_per_sec,
    step_ms_p50, step_ms_p95} over the window."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        delta: Optional[float] = None
        if self._last is not None:
            delta = now - self._last
            self._times.append(delta)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return delta

    def report(self, device=None) -> dict:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
            self.tick()
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps_per_sec": 1.0 / float(arr.mean()),
            "step_ms_p50": float(np.percentile(arr, 50) * 1e3),
            "step_ms_p95": float(np.percentile(arr, 95) * 1e3),
        }
