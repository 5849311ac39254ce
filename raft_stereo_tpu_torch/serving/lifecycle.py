"""Serving fault lifecycle: health state machine, breaker, shed exceptions.
A copy of `raft_stereo_tpu/serving/lifecycle.py`: host-side bookkeeping,
the same states, thresholds, snapshots and error taxonomy. One
`ServingLifecycle` object is shared by the engine, the batcher and the
service front, and owns the health verdict every admission decision reads:

    healthy --(breaker_degrade_after consecutive batch failures)--> degraded
    degraded --(breaker_probation consecutive successes)----------> healthy
    degraded/healthy --(breaker_fail_after consecutive failures)--> failed
    any --(drain())----------------------------------------------> draining

`healthy` and `degraded` both ADMIT traffic — a degraded service is exactly
one that is earning its way back through probation; shedding it would make
recovery impossible. `failed` and `draining` REJECT at submit time with
`ServiceUnavailableError` (HTTP 503 — distinct from the 413 a bucket
overflow earns, because the client did nothing wrong). `failed` is sticky:
the breaker trips OPEN and stays open, so a persistently failing device
fails each queued batch exactly once and then stops burning device time on
doomed retries. The operator repair actions are a checkpoint hot-swap
(`engine.swap_variables` calls `note_swap`, which re-enters probation) or a
restart.

A hung chunk is a hard fault, not a countable failure: the engine's
per-batch watchdog (utils/resilience.StepWatchdog with a non-exiting
`exit_fn` — the service must report `failed`, not kill the process that is
still serving /healthz) calls `record_hang` with every thread's stack, and
the state goes straight to `failed` with the traces kept for the /healthz
post-mortem.

Everything here is host-side bookkeeping under one lock; nothing touches
the device.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional, Tuple

HEALTH_STATES = ("healthy", "degraded", "failed", "draining")


class ServiceUnavailableError(RuntimeError):
    """Request shed at admission: draining, failed, or deadline-infeasible
    (HTTP 503 — the service state, not the request, is at fault)."""


class DeadlineInfeasibleError(ServiceUnavailableError):
    """Queued work alone already blows the request's deadline (HTTP 503):
    running it would burn device time to produce a guaranteed miss."""


class CheckpointMismatchError(ValueError):
    """Hot-swap candidate differs from the served model's state dict in
    keys, shapes or dtypes, or cannot be read by the port (HTTP 409). The
    swap is refused before anything is touched and the old weights keep
    serving."""


class ServingLifecycle:
    """Thread-safe health state machine + consecutive-failure breaker.

    `degrade_after`/`fail_after` are CONSECUTIVE batch-failure thresholds
    (any success resets the run); `probation` is the consecutive-success
    count a degraded service needs to be healthy again.
    """

    def __init__(
        self,
        degrade_after: int = 2,
        fail_after: int = 5,
        probation: int = 2,
        name: str = "service",
    ):
        if not 1 <= int(degrade_after) <= int(fail_after):
            raise ValueError(
                f"need 1 <= degrade_after ({degrade_after}) <= fail_after "
                f"({fail_after})"
            )
        if int(probation) < 1:
            raise ValueError(f"probation must be >= 1, got {probation}")
        self.degrade_after = int(degrade_after)
        self.fail_after = int(fail_after)
        self.probation = int(probation)
        # Label for multi-breaker deployments (a fleet runs one lifecycle
        # per replica); surfaced in snapshot() so /healthz attributes each
        # breaker verdict to its fault domain.
        self.name = str(name)
        self._lock = threading.Lock()
        self._breaker_state = "healthy"  # healthy | degraded | failed
        self._draining = False
        self.consecutive_failures = 0
        self.probation_successes = 0
        self.batch_failures_total = 0
        self.batch_successes_total = 0
        self.hangs_total = 0
        self.swaps_total = 0
        self.last_failure: Optional[str] = None
        self.last_hang_traces: Optional[str] = None
        self.last_hang_elapsed_s: Optional[float] = None
        # Bounded audit trail of (from, to, reason) transitions for /healthz.
        self.transitions: collections.deque = collections.deque(maxlen=32)
        # Observability hook (obs/trace.py): called as (frm, to, reason) for
        # every transition — the flight recorder records and dumps on each
        # breaker move. Set post-construction; fired OUTSIDE self._lock (the
        # hook may dump JSON), so callbacks must tolerate slight reordering
        # under contention.
        self.on_transition: Optional[Callable[[str, str, str], None]] = None

    def _notify(self, pending: List[Tuple[str, str, str]]) -> None:
        """Fire the on_transition hook for transitions collected under the
        lock. Never raises — telemetry must not break the state machine."""
        hook = self.on_transition
        if hook is None or not pending:
            return
        for frm, to, reason in pending:
            try:
                hook(frm, to, reason)
            except Exception:  # noqa: BLE001 - observability is best-effort
                pass

    # -- verdicts ----------------------------------------------------------
    @property
    def state(self) -> str:
        """The reported health state. `draining` masks healthy/degraded
        (admission is closed either way) but never masks `failed` — an
        operator draining a broken replica still needs to see it is broken."""
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._draining and self._breaker_state != "failed":
            return "draining"
        return self._breaker_state

    def admissible(self) -> bool:
        """True when new requests may be admitted (healthy or degraded —
        probation traffic is the recovery path)."""
        with self._lock:
            return not self._draining and self._breaker_state != "failed"

    # -- events ------------------------------------------------------------
    def _transition(self, to: str, reason: str) -> Tuple[str, str, str]:
        frm = self._state_locked()
        self._breaker_state = to
        record = (frm, self._state_locked(), reason)
        self.transitions.append(record)
        return record

    def record_batch_success(self) -> None:
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            self.batch_successes_total += 1
            self.consecutive_failures = 0
            if self._breaker_state == "degraded":
                self.probation_successes += 1
                if self.probation_successes >= self.probation:
                    self.probation_successes = 0
                    pending.append(self._transition("healthy", "probation passed"))
        self._notify(pending)

    def record_batch_failure(self, exc: Optional[BaseException] = None) -> str:
        """One whole batch failed (every request in it got the exception).
        Returns the resulting state."""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            self.batch_failures_total += 1
            self.consecutive_failures += 1
            self.probation_successes = 0
            if exc is not None:
                self.last_failure = repr(exc)
            if self._breaker_state != "failed":
                if self.consecutive_failures >= self.fail_after:
                    pending.append(
                        self._transition(
                            "failed",
                            f"{self.consecutive_failures} consecutive batch failures",
                        )
                    )
                elif (
                    self._breaker_state == "healthy"
                    and self.consecutive_failures >= self.degrade_after
                ):
                    pending.append(
                        self._transition(
                            "degraded",
                            f"{self.consecutive_failures} consecutive batch failures",
                        )
                    )
            state = self._state_locked()
        self._notify(pending)
        return state

    def record_hang(self, elapsed_s: float, traces: str) -> None:
        """A chunk blew the watchdog budget: hard fault, straight to
        `failed`, stacks kept for the post-mortem."""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            self.hangs_total += 1
            self.last_hang_elapsed_s = float(elapsed_s)
            self.last_hang_traces = traces
            self.last_failure = f"hung chunk ({elapsed_s:.1f}s past heartbeat)"
            if self._breaker_state != "failed":
                pending.append(
                    self._transition(
                        "failed", f"watchdog: chunk hung {elapsed_s:.1f}s"
                    )
                )
        self._notify(pending)

    def note_swap(self, generation: int) -> None:
        """A checkpoint hot-swap landed — the operator repair action. A
        failed/degraded breaker re-enters probation as `degraded` (traffic
        must PROVE the new tree before the replica reads healthy); a healthy
        one stays healthy."""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            self.swaps_total += 1
            self.consecutive_failures = 0
            self.probation_successes = 0
            if self._breaker_state != "healthy":
                pending.append(
                    self._transition("degraded", f"checkpoint swap #{generation}")
                )
        self._notify(pending)

    def enter_probation(self, reason: str) -> None:
        """Force the breaker into probation (`degraded`, counters reset) —
        the entry state for a RESPAWNED replica: a freshly booted engine is
        presumed-working but unproven, so it must earn `healthy` through
        `probation` consecutive real-traffic successes, exactly like a
        breaker recovering from a checkpoint swap. (note_swap can't be
        reused here: it leaves an already-healthy breaker healthy, and a
        replacement must never skip probation.)"""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            self.consecutive_failures = 0
            self.probation_successes = 0
            if self._breaker_state != "degraded":
                pending.append(self._transition("degraded", reason))
        self._notify(pending)

    def start_drain(self) -> None:
        """Close admission permanently; queued work still completes."""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            if not self._draining:
                frm = self._state_locked()
                self._draining = True
                record = (frm, self._state_locked(), "drain")
                self.transitions.append(record)
                pending.append(record)
        self._notify(pending)

    def stop_drain(self, reason: str = "resume") -> None:
        """Reopen admission after `start_drain()`. A service draining to
        shutdown never calls this; the rollout orchestrator does — its
        quiesce IS a drain (reuse the exact admission gate every submit
        already checks) that must be reversible, both when a swapped
        backend re-enters rotation and when an aborted roll restores the
        fleet. The breaker state underneath is untouched: a backend that
        was degraded before the quiesce is still degraded after."""
        pending: List[Tuple[str, str, str]] = []
        with self._lock:
            if self._draining:
                frm = self._state_locked()
                self._draining = False
                record = (frm, self._state_locked(), reason)
                self.transitions.append(record)
                pending.append(record)
        self._notify(pending)

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "name": self.name,
                "state": self._state_locked(),
                "draining": self._draining,
                "breaker": {
                    "consecutive_failures": self.consecutive_failures,
                    "probation_successes": self.probation_successes,
                    "degrade_after": self.degrade_after,
                    "fail_after": self.fail_after,
                    "probation": self.probation,
                },
                "batch_failures_total": self.batch_failures_total,
                "batch_successes_total": self.batch_successes_total,
                "hangs_total": self.hangs_total,
                "swaps_total": self.swaps_total,
                "last_failure": self.last_failure,
                "transitions": [list(t) for t in self.transitions],
            }


__all__ = [
    "HEALTH_STATES",
    "CheckpointMismatchError",
    "DeadlineInfeasibleError",
    "ServiceUnavailableError",
    "ServingLifecycle",
]
