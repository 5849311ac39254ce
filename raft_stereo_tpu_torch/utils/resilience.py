"""Hang diagnostics for the serving engine: `dump_all_stacks` (a copy of
the one in `raft_stereo_tpu/utils/resilience.py`) and `HangWatchdog`, the
serving counterpart of that module's training `StepWatchdog`. The rest of
the JAX module (preemption, non-finite guards, sample quarantine) belongs
to training resilience and is not ported.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


def dump_all_stacks() -> str:
    """Format the current stack of EVERY thread (the hang diagnostics the
    watchdog writes into /healthz and stderr). Thread names come from
    threading's registry; frames from sys._current_frames — no signal
    delivery needed, so this works from a monitor thread while another
    thread is stuck in a device synchronize."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sorted(sys._current_frames().items()):
        name = names.get(ident, "unknown")
        stack = "".join(traceback.format_stack(frame))
        parts.append(f"--- thread {name} (ident {ident}) ---\n{stack}")
    return "\n".join(parts)


class HangWatchdog:
    """One monitor thread for a serving engine's lifetime. While a batch
    runs (inside `watch()`), a gap of more than `timeout_s` since the batch
    began or last `beat()` dumps every thread's stack to stderr and hands
    {"elapsed_s", "traces"} to `on_hang`, once per stall. The process stays
    up: a service with a hung chunk goes on answering /healthz."""

    def __init__(self, timeout_s: float, on_hang: Callable[[Dict[str, Any]], None]):
        self.timeout_s = float(timeout_s)
        self.on_hang = on_hang
        self.fired = 0
        # Monotonic time of the running batch's last heartbeat; None while
        # no batch runs (waiting for work is not a hang) or after a fire.
        self._beat_t: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="hang-watchdog", daemon=True)
        self._thread.start()

    def beat(self) -> None:
        with self._lock:
            self._beat_t = time.monotonic()

    @contextlib.contextmanager
    def watch(self):
        """Watch one batch: armed on entry, disarmed on exit."""
        self.beat()
        try:
            yield
        finally:
            with self._lock:
                self._beat_t = None

    def _run(self) -> None:
        while not self._stop.wait(max(0.05, self.timeout_s / 8.0)):
            with self._lock:
                if self._beat_t is None or time.monotonic() - self._beat_t <= self.timeout_s:
                    continue
                elapsed = time.monotonic() - self._beat_t
                self._beat_t = None
            self.fired += 1
            traces = dump_all_stacks()
            sys.stderr.write(f"\n*** HangWatchdog: no chunk heartbeat for {elapsed:.1f}s (> {self.timeout_s:.1f}s)"
                             f" — dumping all stacks ***\n{traces}\n")
            sys.stderr.flush()
            try:
                self.on_hang({"elapsed_s": elapsed, "traces": traces})
            except Exception:
                logger.exception("hang watchdog handler failed")

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
