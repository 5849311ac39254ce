"""Runtime hygiene of the step loop: the compile monitor and the sync guard.
The port's counterpart of `raft_stereo_tpu/utils/jit_hygiene.py`
(`RecompileError`, `RecompileMonitor`, `JitHygiene`), with the same
semantics and report block.

- **late builds**: JAX counts backend compiles; the port's only compiles
  are the `nvcc` builds of its kernel libraries (ops/_build.py), which fire
  one compile event each. A library first needed late (a path that only
  some steps take) costs seconds of `nvcc` in the middle of a run. The
  `RecompileMonitor` counts the events against a step-indexed grace
  window and, under strict mode, fails the run on any build after the
  first `recompile_grace` steps outside a whitelisted window (validation
  and checkpoint builds are legitimate and labelled).
- **silent host syncs**: `.item()`, `.tolist()`, `float(t)`, `bool(t)` on a
  card tensor, a blocking copy to or from the card, boolean indexing: each
  blocks the host until the card has caught up and ends the overlap of
  host and device work. Under strict mode on a card the loop runs under
  `torch.cuda.set_sync_debug_mode("error")`, the counterpart of
  `jax.transfer_guard("disallow")`: such a sync raises at the line that
  made it. The sanctioned fetches (the non-finite drain, the metrics
  flush, the checkpoint snapshot, validation) run inside
  `transfer_window(label)` or `whitelist(label)`, which reopen the mode
  for their block and restore it after, and are counted per label.

PyTorch's sync mode is process-wide, not per thread as JAX's guard is:
while a window is open every thread may sync, and while the guard is on a
background thread may not either. The port's background threads (the
device prefetcher, the serving stager) copy from pinned memory with
`non_blocking=True`, which never syncs. On the CPU there is no
device-to-host boundary, so the guard is off there and the report says
so (`transfer_guard: "off"`).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Dict, Iterator, List, Optional

from raft_stereo_tpu_torch.ops import _build

logger = logging.getLogger(__name__)


class RecompileError(RuntimeError):
    """A kernel library was built after the grace window in strict mode: a
    path first taken in the middle of the run. The message carries the
    step and window label context."""


class RecompileMonitor:
    """Counts kernel-build events against a step-indexed grace window.

    Usage::

        with RecompileMonitor(grace_steps=2) as mon:
            for step in ...:
                train_step(...)
                mon.advance(step)        # raises RecompileError post-grace
                with mon.allow("validation"):
                    validate()           # builds here are excused

    `advance(step)` marks a step boundary: once the boundary of step
    `grace_steps` has passed (`steps_seen >= grace_steps`; grace 0 excuses
    nothing), any build outside an `allow()` window is a violation; with
    `hard_fail` (strict mode) the next `advance` raises. With `hard_fail`
    off the monitor only counts: the trainer always runs one, so
    run_report.json carries build counts without strict mode too.

    The listener is process-wide (ops/_build.py); enter/exit (or
    start/stop) register and unregister it, and each instance keeps its
    own counts."""

    def __init__(self, grace_steps: int = 2, hard_fail: bool = False, label: str = "run"):
        self.grace_steps = int(grace_steps)
        self.hard_fail = bool(hard_fail)
        self.label = label
        self.compiles_total = 0
        self.compiles_post_grace = 0
        self.compiles_whitelisted = 0
        self.steps_seen = 0
        self._post_grace = self.grace_steps <= 0
        self._allow_depth = 0
        self._violations: List[str] = []
        self._lock = threading.Lock()
        self._registered = False
        # Called as (duration_s, whitelisted, post_grace) for every build,
        # outside self._lock: the flight recorder turns each into an event.
        self.on_compile = None

    # -- listener plumbing -------------------------------------------------
    def _on_event(self, name: str, duration: float) -> None:
        with self._lock:
            self.compiles_total += 1
            whitelisted = self._allow_depth > 0
            post_grace = not whitelisted and self._post_grace
            if whitelisted:
                self.compiles_whitelisted += 1
            elif post_grace:
                self.compiles_post_grace += 1
                self._violations.append(
                    f"build of {name} after step {self.steps_seen} (grace={self.grace_steps}, label={self.label})")
        hook = self.on_compile
        if hook is not None:
            try:
                hook(float(duration), whitelisted, post_grace)
            except Exception:  # noqa: BLE001 - observability is best-effort
                pass

    def start(self) -> "RecompileMonitor":
        if not self._registered:
            _build.add_compile_listener(self._on_event)
            self._registered = True
        return self

    def stop(self) -> None:
        if self._registered:
            _build.remove_compile_listener(self._on_event)
            self._registered = False

    def __enter__(self) -> "RecompileMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- step protocol -----------------------------------------------------
    def advance(self, step: Optional[int] = None) -> None:
        """Mark a step boundary. Raises RecompileError (hard_fail only) if a
        build outside a whitelist landed after the grace window: the
        first `grace_steps` steps."""
        self.steps_seen += 1
        if self.steps_seen >= self.grace_steps:
            self._post_grace = True
        if self.hard_fail and self._violations:
            detail = "; ".join(self._violations[:3])
            raise RecompileError(
                f"steady-state recompile detected at step {step if step is not None else self.steps_seen}: "
                f"{detail} — a kernel first needed this late builds in the middle of the run (build it "
                "before the loop, or raise recompile_grace if late builds are expected)")

    @contextlib.contextmanager
    def allow(self, label: str = "whitelisted") -> Iterator[None]:
        """Excuse builds inside the block."""
        with self._lock:
            self._allow_depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._allow_depth -= 1

    @property
    def violations(self) -> List[str]:
        with self._lock:
            return list(self._violations)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "compiles_post_grace": self.compiles_post_grace,
                "compiles_whitelisted": self.compiles_whitelisted,
                "steps_seen": self.steps_seen,
            }

    def snapshot(self) -> Dict[str, object]:
        """Counters and violations under one lock, so that
        compiles_post_grace == len(violations) holds in every report."""
        with self._lock:
            return {
                "compiles_total": self.compiles_total,
                "compiles_post_grace": self.compiles_post_grace,
                "compiles_whitelisted": self.compiles_whitelisted,
                "steps_seen": self.steps_seen,
                "violations": list(self._violations),
            }


class JitHygiene:
    """The trainer-facing bundle: the sync guard, the compile monitor and
    the per-label window counts, reported as run_report.json's
    `jit_hygiene` block.

    `guard()` wraps the whole loop; `whitelist(label)` opens a sanctioned
    sync and build window inside it, `transfer_window(label)` a sync-only
    one. `device` is the loop's device: the guard acts on a card only.
    Without strict mode the monitor counts and nothing is guarded or
    failed."""

    def __init__(self, strict: bool = False, recompile_grace: int = 2, device=None):
        import torch

        self.strict = bool(strict)
        self.recompile_grace = int(recompile_grace)
        self.guards_syncs = self.strict and device is not None and torch.device(device).type == "cuda"
        self.monitor = RecompileMonitor(grace_steps=recompile_grace, hard_fail=self.strict, label="train")
        self.whitelisted_windows: Dict[str, int] = {}
        self._mode_lock = threading.Lock()
        self._guarding = False
        self._open_windows = 0

    def _set_mode(self, mode: str) -> None:
        import torch

        torch.cuda.set_sync_debug_mode(mode)

    @contextlib.contextmanager
    def guard(self) -> Iterator[None]:
        """Loop-wide context: the monitor always; under strict mode on a
        card, `set_sync_debug_mode("error")` until the block ends (the
        previous mode is restored)."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.monitor)
            if self.guards_syncs:
                import torch

                previous = torch.cuda.get_sync_debug_mode()
                with self._mode_lock:
                    self._guarding = True
                    if not self._open_windows:
                        self._set_mode("error")
                stack.callback(self._end_guard, previous)
                logger.info("strict jit-hygiene: sync_debug_mode=error, hard-fail on kernel builds after %d steps",
                            self.recompile_grace)
            yield

    def _end_guard(self, previous: int) -> None:
        with self._mode_lock:
            self._guarding = False
            self._set_mode(previous)

    @contextlib.contextmanager
    def _open(self) -> Iterator[None]:
        """Syncs allowed inside the block, whatever thread makes them; the
        guard closes again when the last open window ends."""
        if not self.guards_syncs:
            yield
            return
        with self._mode_lock:
            self._open_windows += 1
            if self._guarding:
                self._set_mode("default")
        try:
            yield
        finally:
            with self._mode_lock:
                self._open_windows -= 1
                if self._guarding and not self._open_windows:
                    self._set_mode("error")

    def _count(self, label: str) -> None:
        with self._mode_lock:
            self.whitelisted_windows[label] = self.whitelisted_windows.get(label, 0) + 1

    @contextlib.contextmanager
    def whitelist(self, label: str) -> Iterator[None]:
        """A sanctioned sync and build window (checkpoint save, validation,
        rollback restore, warm-up), counted per label."""
        self._count(label)
        with self.monitor.allow(label), self._open():
            yield

    @contextlib.contextmanager
    def transfer_window(self, label: str) -> Iterator[None]:
        """A labelled sync-only window (the non-finite drain, the metrics
        flush, the pod sync's fetch): counted in `whitelisted_windows` like
        any other, without excusing builds."""
        self._count(label)
        with self._open():
            yield

    def step(self, step: Optional[int] = None) -> None:
        """Per-iteration boundary: raises RecompileError under strict mode
        when a build outside a whitelist happened after the grace window."""
        self.monitor.advance(step)

    def report(self) -> Dict[str, object]:
        """The `jit_hygiene` run-report block (utils/run_report.py)."""
        with self._mode_lock:
            windows = dict(self.whitelisted_windows)
        return {
            "strict_mode": self.strict,
            "recompile_grace": self.recompile_grace,
            "transfer_guard": "disallow" if self.guards_syncs else "off",
            **self.monitor.snapshot(),
            "whitelisted_windows": windows,
        }


__all__ = ["JitHygiene", "RecompileError", "RecompileMonitor"]
