"""Resilience primitives for long training runs and the serving engine:
the port's copy of `raft_stereo_tpu/utils/resilience.py`, plus
`HangWatchdog`, the serving counterpart of its `StepWatchdog`.

- `PreemptionGuard`: SIGTERM/SIGINT request a stop at the next step
  boundary; the trainer then writes a final checkpoint and exits 13. A
  second signal raises KeyboardInterrupt at once.
- `NonFiniteGuard`: maps NaN/Inf loss or gradient-norm observations onto
  `nan_policy`: raise, skip (the trainer drops the update), or rollback
  (after K consecutive bad steps, restore the last good checkpoint and
  re-seed the data stream).
- `SampleQuarantine`: the loader's per-sample failure budget: failing
  indices are quarantined and substituted; crossing the budget raises
  `FailureBudgetExceeded`.
- `StepWatchdog`: a monitor thread that turns a hung step into stack dumps,
  run_report.json and exit 16.
- `HangWatchdog`: one monitor thread per serving engine; a stalled chunk
  dumps every stack and fails the service, the process stays up.

Everything here is host-side and deterministic.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterable, Optional, Set

logger = logging.getLogger(__name__)

from raft_stereo_tpu_torch.config import NAN_POLICIES, SAMPLE_POLICIES  # noqa: E402,F401


class NonFiniteLossError(RuntimeError):
    """Training produced NaN/Inf loss or gradients and the configured
    nan_policy could not (or was told not to) absorb it."""


class FailureBudgetExceeded(RuntimeError):
    """The loader dropped more than the configured fraction of samples."""


class PreemptionGuard:
    """Context manager translating SIGTERM/SIGINT into a step-boundary stop
    request.

    Installs handlers on entry and restores the previous ones on exit.
    Signal handlers can only be installed from the main thread; elsewhere
    (e.g. a trainer driven from a worker thread in tests) the guard
    degrades to an inert flag — `stop_requested` simply stays False.

    First signal: set the flag, log, return — the training loop checks
    `stop_requested` once per step and shuts down cleanly. Second signal:
    raise KeyboardInterrupt immediately, because a stuck step should not be
    able to hold the process hostage against an insistent operator.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: Dict[int, object] = {}
        self._stop = threading.Event()
        self.signame: Optional[str] = None
        self.active = False

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def _handle(self, signum, frame):
        if self._stop.is_set():
            raise KeyboardInterrupt(f"second {signal.Signals(signum).name}: forcing exit")
        self.signame = signal.Signals(signum).name
        self._stop.set()
        logger.warning(
            "%s received: finishing the current step, then checkpointing and "
            "exiting (send again to force-quit)",
            self.signame,
        )

    def __enter__(self) -> "PreemptionGuard":
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
            self.active = True
        except ValueError:  # not the main thread: stay inert
            for s, prev in self._previous.items():
                signal.signal(s, prev)  # pragma: no cover (same-thread undo)
            self._previous.clear()
            self.active = False
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._previous.clear()


class NonFiniteGuard:
    """Host-side NaN/Inf policy and streak bookkeeping.

    `observe(bad)` consumes one step's non-finite verdict (the step's
    `nonfinite` flag: `~isfinite(loss) | ~isfinite(grad_norm)`) and returns
    the action the loop should take:

    - "ok"        — finite step, nothing to do.
    - "skip"      — the poisoned update was skipped; keep going.
    - "rollback"  — K consecutive bad steps under nan_policy="rollback":
                    restore the last good checkpoint and re-seed the data
                    stream (the trainer performs both).

    nan_policy="raise" raises NonFiniteLossError on the first bad step.
    nan_policy="skip" escalates to NonFiniteLossError after K consecutive
    bad steps — silently spinning through the remainder of a 100k-step run
    with every update skipped would be worse than dying loudly.
    nan_policy="rollback" escalates after `max_rollbacks` restores: if the
    last good state keeps walking back into NaN, the problem is not
    transient and no amount of rollback will fix it.
    """

    def __init__(self, policy: str, patience: int = 10, max_rollbacks: int = 3):
        if policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy {policy!r} not in {NAN_POLICIES}")
        if patience < 1:
            raise ValueError(f"nan_patience must be >= 1, got {patience}")
        self.policy = policy
        self.patience = patience
        self.max_rollbacks = max_rollbacks
        self.bad_streak = 0
        self.skipped_total = 0
        self.rollbacks = 0

    def observe(self, bad: bool, step: int) -> str:
        if not bad:
            self.bad_streak = 0
            return "ok"
        if self.policy == "raise":
            raise NonFiniteLossError(
                f"non-finite loss/grad_norm at step {step} (nan_policy=raise)"
            )
        self.bad_streak += 1
        self.skipped_total += 1
        logger.warning(
            "non-finite loss/grad_norm at step %d: update skipped (%d consecutive)",
            step,
            self.bad_streak,
        )
        if self.bad_streak < self.patience:
            return "skip"
        if self.policy == "skip":
            raise NonFiniteLossError(
                f"{self.bad_streak} consecutive non-finite steps at step {step} "
                f"(nan_policy=skip, nan_patience={self.patience})"
            )
        # rollback
        self.bad_streak = 0
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise NonFiniteLossError(
                f"non-finite loss persisted through {self.max_rollbacks} "
                f"rollbacks (last at step {step}) — not a transient"
            )
        return "rollback"

    def stats(self) -> Dict[str, float]:
        """Merged into the per-step metrics stream by the trainer."""
        return {
            "resilience/skipped_steps": float(self.skipped_total),
            "resilience/rollbacks": float(self.rollbacks),
        }

    # --- crash-consistent resume (utils/checkpoints.py run_state bundle) --
    def state_dict(self) -> Dict[str, int]:
        """Counters that must survive a preemption: a resumed run that
        resets skipped/rollback accounting would silently re-grant the full
        NaN budget after every crash."""
        return {
            "skipped_total": int(self.skipped_total),
            "rollbacks": int(self.rollbacks),
            "bad_streak": int(self.bad_streak),
        }

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.skipped_total = int(state.get("skipped_total", 0))
        self.rollbacks = int(state.get("rollbacks", 0))
        self.bad_streak = int(state.get("bad_streak", 0))


class SampleQuarantine:
    """Bookkeeping for the loader's per-sample failure policy.

    A sample that keeps failing decode is quarantined: excluded from future
    epochs and substituted in the current batch. `record_served` /
    `quarantine` maintain the dropped fraction; crossing `budget` raises
    FailureBudgetExceeded — past that point the run is no longer training
    on the distribution it was asked to.

    Multi-rank: with `enforce=False` the local ratio check is off (the
    counters keep accumulating); the trainer reduces dropped/served across
    the ranks at each coordination boundary (parallel/coordination.py) and
    calls `check_global` on the pod's fraction, so every rank raises at
    the same step boundary.
    """

    def __init__(self, budget: float, enforce: bool = True):
        if not 0.0 <= budget <= 1.0:
            raise ValueError(f"failure_budget must be in [0, 1], got {budget}")
        self.budget = budget
        self.enforce = enforce
        self.indices: Set[int] = set()
        self.dropped = 0
        self.served = 0
        # Mutations come from the loader's producer thread while the
        # trainer's checkpoint path snapshots state_dict() from the
        # consumer thread — iterating the live set there would race
        # ("set changed size during iteration").
        self._lock = threading.Lock()

    def over_budget(self, dropped: int, attempted: int) -> bool:
        """The budget rule: the ratio only counts after a grace window of
        ceil(1/budget) attempts (below that a single drop always reads as
        over budget, see quarantine()); budget=0 keeps strict
        fail-on-first-drop semantics."""
        import math

        grace = math.ceil(1.0 / self.budget) if self.budget > 0 else 1
        return attempted >= grace and dropped > 0 and dropped / attempted > self.budget

    def check_global(self, dropped: int, attempted: int) -> None:
        """Enforce the budget on pod-global counts (after a coordination
        all-reduce): raises identically on every rank."""
        if self.over_budget(dropped, attempted):
            raise FailureBudgetExceeded(
                f"{dropped}/{attempted} samples dropped across the pod ({dropped / attempted:.1%}) exceeds the "
                f"failure budget of {self.budget:.1%}")

    def __contains__(self, index: int) -> bool:
        return int(index) in self.indices

    def record_served(self, n: int = 1) -> None:
        with self._lock:
            self.served += n

    def quarantine(self, index: int) -> None:
        """Quarantine `index`; raises once the dropped fraction crosses the
        budget. Re-quarantining an already-known index still counts a drop
        (each failed serve is a loss, even from a repeat offender).

        The ratio is only enforced after a grace window of ceil(1/budget)
        attempts: below that, a SINGLE drop always reads as "over budget"
        (1/N > budget for N < 1/budget), so a corrupt frame early in the
        run would abort instantly — the exact behavior quarantine exists to
        prevent. budget=0 keeps strict fail-on-first-drop semantics."""
        with self._lock:
            self.indices.add(int(index))
            self.dropped += 1
            # Snapshot the counters while still holding the lock: the
            # consumer thread bumps `served` concurrently (record_served),
            # so reading it after release could pair this drop with a
            # served count from a different instant and mis-rate the
            # budget right at the threshold.
            dropped = self.dropped
            served = self.served
            quarantined = len(self.indices)
        logger.warning(
            "sample %d quarantined after repeated decode failures "
            "(%d dropped, %d quarantined total)",
            index,
            dropped,
            quarantined,
        )
        attempted = dropped + served
        if self.enforce and self.over_budget(dropped, attempted):
            raise FailureBudgetExceeded(
                f"{dropped}/{attempted} samples dropped "
                f"({dropped / attempted:.1%}) exceeds the "
                f"failure budget of {self.budget:.1%}"
            )

    def stats(self) -> Dict[str, float]:
        return {
            "loader/dropped_samples": float(self.dropped),
            "loader/quarantined": float(len(self.indices)),
        }

    # --- crash-consistent resume (utils/checkpoints.py run_state bundle) --
    def state_dict(self) -> Dict[str, Any]:
        """Quarantine set + budget counters: a resumed run that forgot
        these would re-serve known-corrupt samples and re-grant the full
        failure budget after every preemption. Snapshot under the lock —
        the producer thread may be quarantining while the trainer
        checkpoints."""
        with self._lock:
            return {
                "indices": sorted(self.indices),
                "dropped": int(self.dropped),
                "served": int(self.served),
            }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        with self._lock:
            self.indices = {int(i) for i in state.get("indices", ())}
            self.dropped = int(state.get("dropped", 0))
            self.served = int(state.get("served", 0))


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


class StepWatchdog:
    """Monitor thread converting a hung step/collective into diagnostics +
    a clean non-zero exit instead of an indefinite pod hang.

    The SPMD failure mode this exists for: one host dies or wedges inside a
    collective (step, checkpoint save, coordination sync) and every OTHER
    host blocks forever in the same collective — no exception, no log line,
    no exit. A blocked main thread cannot rescue itself, so a daemon thread
    watches the gap since the last `beat()`; past `timeout_s` it dumps every
    thread's stack (stderr + the `on_timeout` callback, which the trainer
    uses to write run_report.json with stop_cause="watchdog"), then calls
    `exit_fn` (default os._exit — sys.exit would just raise in this thread
    while the main thread stays wedged; no finally/atexit can be trusted to
    run when the process is already hung in native code).

    The FIRST interval gets `first_grace_s` extra: step 1 includes the
    kernels' builds and cuDNN's algorithm search, which would otherwise need
    `timeout_s` sized for them instead of for steady-state steps.

    `beat(step)` must be called at every step boundary (and after any other
    long collective, e.g. the final synchronous save). Use as a context
    manager; inert when timeout_s <= 0.

    `_run` returns after `exit_fn`, so a test stub that returns works.
    """

    def __init__(
        self,
        timeout_s: float,
        on_timeout: Optional[Callable[[Dict[str, Any]], None]] = None,
        exit_fn: Callable[[int], None] = os._exit,
        exit_code: int = 16,  # run_report.EXIT_WATCHDOG (no import cycle)
        first_grace_s: float = 300.0,
        poll_s: Optional[float] = None,
    ):
        self.timeout_s = float(timeout_s)
        self.on_timeout = on_timeout
        self.exit_fn = exit_fn
        self.exit_code = int(exit_code)
        self.first_grace_s = float(first_grace_s)
        self._poll_s = poll_s if poll_s is not None else max(0.05, self.timeout_s / 8.0)
        self.enabled = self.timeout_s > 0
        self.fired = False
        self.last_beat_step: Optional[int] = None
        # What step-boundary work is in flight ("validation", "save", ...):
        # carried into the timeout diagnostics and run_report.json so a hang
        # report says WHERE the run wedged, not just when.
        self.phase_label: Optional[str] = None
        self._beats = 0
        self._grant_s = 0.0
        self._last_beat_t = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # Observability hook: called as ({"elapsed_s", "step", "phase"})
        # right after the timeout is detected and BEFORE on_timeout/exit_fn,
        # so a flight recorder can log the fire and dump its ring even when
        # exit_fn is os._exit. Must never raise (guarded); best-effort only.
        self.on_fire: Optional[Callable[[Dict[str, Any]], None]] = None

    def beat(self, step: Optional[int] = None) -> None:
        """Mark liveness at a step boundary (cheap: one clock read; no-op
        when the watchdog is disabled, keeping the hot loop lock-free)."""
        if not self.enabled:
            return
        with self._lock:
            self._last_beat_t = time.monotonic()
            self._beats += 1
            self._grant_s = 0.0
            if step is not None:
                self.last_beat_step = int(step)

    def grant(self, extra_s: float) -> None:
        """One-shot extra allowance on the CURRENT interval, cleared by the
        next beat — for known-long step-boundary work (an in-training
        validation pass, which can legitimately dwarf a steady-state step).
        A genuine hang in that work is still caught, just later."""
        if not self.enabled:
            return
        with self._lock:
            self._grant_s = max(self._grant_s, float(extra_s))

    def mark_phase(self, label: Optional[str]) -> None:
        """Label the step-boundary work now in flight (None = the train
        step itself). Cheap and safe when disabled; the label rides the
        timeout diagnostics and state() so a watchdog report distinguishes
        'hung validating' from 'hung in the step collective'."""
        with self._lock:
            self.phase_label = label

    def state(self) -> Dict[str, Any]:
        """Machine-readable snapshot for run_report.json."""
        return {
            "enabled": self.enabled,
            "fired": self.fired,
            "timeout_s": self.timeout_s,
            "last_beat_step": self.last_beat_step,
            "phase": self.phase_label,
        }

    def _deadline(self) -> float:
        # The first interval (arm -> first completed step) absorbs compile;
        # `grant` adds a one-shot allowance for declared-long work.
        grace = self.first_grace_s if self._beats <= 1 else 0.0
        return self.timeout_s + grace + self._grant_s

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                elapsed = time.monotonic() - self._last_beat_t
                deadline = self._deadline()
            if elapsed <= deadline:
                continue
            self.fired = True
            if self.on_fire is not None:
                try:
                    self.on_fire(
                        {
                            "elapsed_s": elapsed,
                            "step": self.last_beat_step,
                            "phase": self.phase_label,
                        }
                    )
                except Exception:
                    logger.exception("watchdog on_fire hook failed")
            traces = dump_all_stacks()
            phase = f" during {self.phase_label}" if self.phase_label else ""
            sys.stderr.write(
                f"\n*** StepWatchdog: no step-boundary heartbeat for "
                f"{elapsed:.1f}s (> {deadline:.1f}s){phase}; last beat at step "
                f"{self.last_beat_step} — dumping all stacks and exiting "
                f"{self.exit_code} ***\n{traces}\n"
            )
            sys.stderr.flush()
            logger.error(
                "watchdog timeout: step stalled for %.1fs (last beat step %s)",
                elapsed,
                self.last_beat_step,
            )
            if self.on_timeout is not None:
                try:
                    self.on_timeout({"elapsed_s": elapsed, "traces": traces})
                except Exception:
                    logger.exception("watchdog on_timeout callback failed")
            self.exit_fn(self.exit_code)
            return  # exit_fn may be a test stub that returns

    def start(self) -> "StepWatchdog":
        if self.enabled and self._thread is None:
            self.beat()
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="step-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StepWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


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
