"""Pod-wide agreement on the resilience signals: the port's counterpart of
`raft_stereo_tpu/parallel/coordination.py`.

Every resilience primitive decides per process: a SIGTERM lands on one
rank, a corrupt frame is dropped by one rank's loader. The training step,
the checkpoint gather and DDP's gradient all-reduce are collectives, so a
rank that stops while its peers enter the next step wedges them all.
`HostCoordinator` turns the per-rank signals into one decision per step
boundary: each rank packs its flags into a small float32 vector and one
`all_reduce` (a sum) gives every rank the same totals:

- booleans (stop requested, non-finite fatal, rollback wanted) reduce as
  "any rank": sum > 0;
- counters (dropped / served samples) travel as deltas since the last
  sync and accumulate into Python ints, so the failure budget is enforced
  on the pod's dropped fraction, exactly past 2^24.

The reduction runs on a gloo group of its own: it never waits on the card
and never interleaves with the training step's collectives. `submit`
dispatches it (`async_op=True`), `complete` waits for it. With one process
the coordinator dispatches no collective and mirrors the local signals.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Optional

import numpy as np

from raft_stereo_tpu_torch.parallel.distributed import process_topology

logger = logging.getLogger(__name__)

FLAG_STOP = 0
FLAG_NONFINITE = 1
FLAG_ROLLBACK = 2
FLAG_DROPPED = 3
FLAG_SERVED = 4
N_FLAGS = 5


@dataclasses.dataclass(frozen=True)
class PodDecision:
    """The branch every rank takes at this step boundary: identical on all
    ranks by construction (one collective, one result)."""

    stop: bool
    nonfinite: bool
    rollback: bool
    dropped: int
    served: int

    @property
    def dropped_fraction(self) -> float:
        attempted = self.dropped + self.served
        return self.dropped / attempted if attempted else 0.0


class _Pending:
    """An all-reduce in flight: `result()` waits for it and returns the
    summed flags."""

    def __init__(self, tensor, work):
        self._tensor = tensor
        self._work = work

    def result(self) -> np.ndarray:
        self._work.wait()
        return self._tensor.numpy()


def _make_reduce_fn(group=None) -> Callable[[np.ndarray], object]:
    """Build the (this rank's flags) -> pending sum collective on `group`,
    a gloo group over every rank (default: a new one; creating a group is
    itself collective, and every rank reaches the first multi-process
    `submit` at the same boundary)."""
    import torch
    import torch.distributed as dist

    if group is None:
        group = dist.new_group(backend="gloo")

    def reduce_fn(flags: np.ndarray):
        t = torch.from_numpy(np.asarray(flags, np.float32).copy())
        return _Pending(t, dist.all_reduce(t, group=group, async_op=True))

    return reduce_fn


class HostCoordinator:
    """Reduces per-rank resilience flags to one pod-wide decision.

    `sync()` (or `submit` then `complete`) must be called at identical step
    boundaries on every rank. `collectives_dispatched` counts real
    reductions; the single-process fast path keeps it at 0. `group` is the
    gloo group to reduce on (the trainer passes the one its main thread
    owns); None makes one at the first reduction."""

    def __init__(self, group=None):
        self.process_index, self.process_count = process_topology()
        self.collectives_dispatched = 0
        self._group = group
        self._reduce: Optional[Callable[[np.ndarray], object]] = None
        # Counters travel as deltas since the last sync, accumulated into
        # exact Python ints here: a cumulative count in float32 would stop
        # incrementing at 2^24.
        self._sent_dropped = 0
        self._sent_served = 0
        self._pod_dropped = 0
        self._pod_served = 0
        self._last_submitted_stop = False

    @property
    def active(self) -> bool:
        return self.process_count > 1

    def submit(self, stop: bool = False, nonfinite: bool = False, rollback: bool = False, dropped: int = 0,
               served: int = 0):
        """Dispatch this rank's flag reduction and return its handle for
        `complete`. One process: a host tuple mirroring the inputs."""
        if not self.active:
            return ("local", bool(stop), bool(nonfinite), bool(rollback), int(dropped), int(served))
        flags = np.zeros(N_FLAGS, np.float32)
        flags[FLAG_STOP] = 1.0 if stop else 0.0
        flags[FLAG_NONFINITE] = 1.0 if nonfinite else 0.0
        flags[FLAG_ROLLBACK] = 1.0 if rollback else 0.0
        flags[FLAG_DROPPED] = float(int(dropped) - self._sent_dropped)
        flags[FLAG_SERVED] = float(int(served) - self._sent_served)
        if self._reduce is None:
            self._reduce = _make_reduce_fn(self._group)
        handle = self._reduce(flags)
        self.collectives_dispatched += 1
        self._sent_dropped = int(dropped)
        self._sent_served = int(served)
        self._last_submitted_stop = bool(stop)
        return handle

    def complete(self, handle) -> PodDecision:
        """Wait for a submitted reduction (or take a single-process mirror)
        and turn it into the pod decision."""
        if isinstance(handle, tuple) and handle and handle[0] == "local":
            _, stop, nonfinite, rollback, dropped, served = handle
            return PodDecision(stop=stop, nonfinite=nonfinite, rollback=rollback, dropped=dropped, served=served)
        total = handle.result() if hasattr(handle, "result") else np.asarray(handle)
        self._pod_dropped += int(round(float(total[FLAG_DROPPED])))
        self._pod_served += int(round(float(total[FLAG_SERVED])))
        decision = PodDecision(stop=bool(total[FLAG_STOP] > 0), nonfinite=bool(total[FLAG_NONFINITE] > 0),
                               rollback=bool(total[FLAG_ROLLBACK] > 0), dropped=self._pod_dropped,
                               served=self._pod_served)
        if decision.stop and not self._last_submitted_stop:
            logger.warning("pod coordination: a peer rank requested a stop; this rank (process %d) stops at the "
                           "same step boundary", self.process_index)
        return decision

    def sync(self, stop: bool = False, nonfinite: bool = False, rollback: bool = False, dropped: int = 0,
             served: int = 0) -> PodDecision:
        """Reduce this rank's signals across the pod. `dropped`/`served`
        are this rank's cumulative counters; the decision carries exact
        pod-cumulative totals."""
        return self.complete(self.submit(stop=stop, nonfinite=nonfinite, rollback=rollback, dropped=dropped,
                                         served=served))

    # --- crash-consistent resume (checkpoint run_state bundle) -----------
    def state_dict(self) -> dict:
        """Pod-cumulative budget counters as of the last sync, for the
        checkpoint's run state."""
        return {"pod_dropped": int(self._pod_dropped), "pod_served": int(self._pod_served),
                "process_count": int(self.process_count)}

    def load_state_dict(self, state: dict, local_dropped: int = 0, local_served: int = 0) -> None:
        """Adopt checkpointed pod totals as the baseline, with this rank's
        restored local counters as its delta baseline, so the next sync
        contributes a zero delta whatever the pod's size was at the save."""
        self._pod_dropped = int(state.get("pod_dropped", 0))
        self._pod_served = int(state.get("pod_served", 0))
        self._sent_dropped = int(local_dropped)
        self._sent_served = int(local_served)
