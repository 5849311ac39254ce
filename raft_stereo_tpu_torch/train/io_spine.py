"""Async checkpoint commit, the training I/O spine's write half: the port's
counterpart of `raft_stereo_tpu/train/io_spine.py`.

A save has two halves. The snapshot (the model's and the optimizer's state
copied to host memory, gathered across ranks under fsdp, a collective) runs
on the step thread on every rank at the same step. The commit (rank 0
writes `model.pth` and `optimizer.pt`, every rank its run state, a barrier
across ranks, then rank 0's integrity manifest, written last) can run on a
background thread: `AsyncCheckpointCommitter` does that under
`--async_checkpoint`, with the same invariants as a synchronous save:

- at most one commit is in flight: `barrier()` joins the previous commit
  before the next save, before a rollback restore and on every exit path;
- a background failure is re-raised at the next `barrier()` on the
  calling thread, so I/O errors reach the trainer's retry and abort paths;
- a kill at any byte before the manifest's rename leaves a torn step that
  auto-resume walks past;
- a wedged commit blocks the next barrier under the phase label
  `async-commit-barrier`, which the step watchdog turns into stack dumps
  and exit 16, with the allowance a synchronous save gets.

The read half is data/prefetch.py (`DevicePrefetcher`); both report through
`build_io_spine_block`, the `io_spine` block of run_report.json.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

# Watchdog phase label for a main thread blocked joining an in-flight commit.
BARRIER_PHASE = "async-commit-barrier"


class AsyncCheckpointCommitter:
    """Runs the commit half of a checkpoint save on a background thread,
    one commit at a time.

    Usage (train/trainer.py `save`)::

        committer.barrier()                    # join (and error-check) the previous commit
        snapshot = ...                         # host copies, calling thread
        committer.submit(commit_fn, step=step)  # files, barrier, manifest: background
    """

    def __init__(self, watchdog: Optional[Any] = None, barrier_grace_s: float = 300.0):
        self._watchdog = watchdog
        self._barrier_grace_s = float(barrier_grace_s)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.async_commits = 0
        self.max_commit_latency_s = 0.0

    def attach_watchdog(self, watchdog: Optional[Any], barrier_grace_s: Optional[float] = None) -> None:
        """Bind the live StepWatchdog (created inside fit(), after the
        committer) so barrier joins are labelled and granted the checkpoint
        allowance."""
        self._watchdog = watchdog
        if barrier_grace_s is not None:
            self._barrier_grace_s = float(barrier_grace_s)

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def barrier(self) -> None:
        """Join the in-flight commit, if any, and re-raise its error on the
        calling thread. Idempotent; cheap when nothing is in flight."""
        t = self._thread
        if t is not None:
            if t.is_alive() and self._watchdog is not None:
                self._watchdog.grant(self._barrier_grace_s)
                self._watchdog.mark_phase(BARRIER_PHASE)
                try:
                    t.join()
                finally:
                    self._watchdog.mark_phase(None)
            else:
                t.join()
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def submit(self, commit_fn: Callable[[], None], step: int) -> None:
        """Start `commit_fn` on a background thread. Refused while a commit
        is in flight: two commits could interleave manifest writes."""
        if self.in_flight:
            raise RuntimeError("async checkpoint commit already in flight — barrier() before submit()")

        def run() -> None:
            t0 = time.monotonic()
            try:
                commit_fn()
            except BaseException as e:  # surfaces at the next barrier()
                with self._lock:
                    self._error = e
                logger.error("async checkpoint commit for step %d failed: %r", step, e)
            finally:
                latency = time.monotonic() - t0
                with self._lock:
                    self.async_commits += 1
                    self.max_commit_latency_s = max(self.max_commit_latency_s, latency)

        self._thread = threading.Thread(target=run, name=f"async-ckpt-commit-{step}", daemon=True)
        self._thread.start()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"async_commits": int(self.async_commits), "max_commit_latency_s": float(self.max_commit_latency_s)}


def build_io_spine_block(async_checkpoint: bool, device_prefetch: bool,
                         committer: Optional[AsyncCheckpointCommitter] = None,
                         prefetcher: Optional[Any] = None) -> Dict[str, Any]:
    """The `io_spine` block of run_report.json: checkpoint-commit and
    device-prefetch health in one record."""
    commit_stats = committer.stats() if committer is not None else {"async_commits": 0, "max_commit_latency_s": 0.0}
    prefetch_stats = (prefetcher.stats() if prefetcher is not None
                      else {"prefetch_depth_watermark": 0, "device_put_overlap_fraction": 0.0})
    return {"async_checkpoint": bool(async_checkpoint), "device_prefetch": bool(device_prefetch), **commit_stats,
            **prefetch_stats}
