"""Pod coordination and the loader's per-rank input sharding, against the
JAX package, in one process.

- `HostCoordinator`: one process dispatches no collective (its reduction
  is never built) and mirrors the local signals; with the rank layout and
  the all-reduce mocked as two processes (the peer's flags added, as
  JAX's tests/test_coordination.py mocks it), the pod decisions equal the
  JAX coordinator's for the same signals, booleans as any-rank and
  counters as exact sums past 2^24.
- The DataLoader's per-rank order (host_id, num_hosts) equals the JAX
  DataLoader's for the same seed at (0, 2), (1, 2) and (2, 3), quarantine
  substitution included, and so does the per-rank length; two ranks'
  first batches are, row for row, the samples of one rank's batch of their
  total size, augmented the same way.
- The failure budget's pod-global mode: the local ratio stops raising and
  `check_global` raises where JAX's does.
"""

import numpy as np
import pytest

from raft_stereo_tpu.data.loader import DataLoader as JaxDataLoader
from raft_stereo_tpu.parallel import coordination as jax_coordination
from raft_stereo_tpu.utils.resilience import SampleQuarantine as JaxSampleQuarantine
from raft_stereo_tpu_torch.config import AugmentConfig, TrainConfig
from raft_stereo_tpu_torch.data import trees
from raft_stereo_tpu_torch.data.datasets import build_training_dataset
from raft_stereo_tpu_torch.data.loader import DataLoader
from raft_stereo_tpu_torch.parallel import coordination
from raft_stereo_tpu_torch.parallel.coordination import (
    FLAG_DROPPED,
    FLAG_NONFINITE,
    FLAG_ROLLBACK,
    FLAG_SERVED,
    FLAG_STOP,
    N_FLAGS,
    HostCoordinator,
    PodDecision,
)
from raft_stereo_tpu_torch.parallel.distributed import host_shard_args
from raft_stereo_tpu_torch.utils.resilience import FailureBudgetExceeded, SampleQuarantine
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)


def test_single_process_dispatches_nothing(monkeypatch):
    def bomb(*_):
        raise AssertionError("a single process must not build or dispatch a collective")

    monkeypatch.setattr(coordination, "_make_reduce_fn", bomb)
    coord = HostCoordinator()
    assert not coord.active and coord.process_count == 1
    d = coord.sync(stop=True, nonfinite=False, rollback=True, dropped=3, served=17)
    assert d == PodDecision(stop=True, nonfinite=False, rollback=True, dropped=3, served=17)
    assert coord.sync() == PodDecision(False, False, False, 0, 0)
    assert coord.collectives_dispatched == 0
    assert host_shard_args() == {"host_id": 0, "num_hosts": 1}


def two_process_coordinators(monkeypatch, peer):
    """The port's and JAX's coordinators as process 0 of 2, each reduction
    replaced by local + peer flags (what the sum over the two computes)."""
    for module in (coordination, jax_coordination):
        monkeypatch.setattr(module, "process_topology", lambda: (0, 2))
    monkeypatch.setattr(coordination, "_make_reduce_fn", lambda group=None: (lambda flags: flags + peer))
    monkeypatch.setattr(jax_coordination, "_make_reduce_fn", lambda: (lambda flags: flags + peer))
    return HostCoordinator(), jax_coordination.HostCoordinator()


def same(ours: PodDecision, theirs) -> bool:
    return (ours.stop, ours.nonfinite, ours.rollback, ours.dropped, ours.served, ours.dropped_fraction) == (
        theirs.stop, theirs.nonfinite, theirs.rollback, theirs.dropped, theirs.served, theirs.dropped_fraction)


def test_pod_decisions_match_jax(monkeypatch):
    peer = np.zeros(N_FLAGS, np.float32)
    ours, theirs = two_process_coordinators(monkeypatch, peer)
    assert ours.active and theirs.active
    peer[FLAG_STOP], peer[FLAG_DROPPED], peer[FLAG_SERVED] = 1.0, 2.0, 10.0  # the peer was preempted
    local = dict(stop=False, nonfinite=False, rollback=False, dropped=1, served=10)
    d = ours.sync(**local)
    assert same(d, theirs.sync(**local))
    assert d.stop and not d.nonfinite and (d.dropped, d.served) == (3, 20)
    peer[FLAG_STOP], peer[FLAG_NONFINITE], peer[FLAG_ROLLBACK] = 0.0, 1.0, 1.0
    peer[FLAG_DROPPED], peer[FLAG_SERVED] = 0.0, 5.0
    # Cumulative local counters: only the delta (1, 15) travels.
    d = ours.sync(dropped=2, served=25)
    assert same(d, theirs.sync(dropped=2, served=25))
    assert d.nonfinite and d.rollback and (d.dropped, d.served) == (4, 40)
    assert ours.collectives_dispatched == theirs.collectives_dispatched == 2
    assert ours.state_dict() == theirs.state_dict()


def test_pod_counters_exact_past_float32(monkeypatch):
    ours, theirs = two_process_coordinators(monkeypatch, np.zeros(N_FLAGS, np.float32))
    big = 2**24 + 3  # rounds to 2**24 in float32
    served = 0
    for _ in range(4):
        served += big // 4
        assert same(ours.sync(served=served), theirs.sync(served=served))
    d = ours.sync(served=served + 1)
    assert same(d, theirs.sync(served=served + 1)) and d.served == served + 1


def test_resumed_pod_counters_match_jax(monkeypatch):
    """A restored pod adopts the checkpoint's totals with this rank's
    restored counters as the delta baseline: the next sync adds nothing
    that was counted before the save."""
    ours, theirs = two_process_coordinators(monkeypatch, np.zeros(N_FLAGS, np.float32))
    state = {"pod_dropped": 7, "pod_served": 900, "process_count": 2}
    ours.load_state_dict(state, local_dropped=3, local_served=400)
    theirs.load_state_dict(state, local_dropped=3, local_served=400)
    d = ours.sync(dropped=4, served=450)
    assert same(d, theirs.sync(dropped=4, served=450)) and (d.dropped, d.served) == (8, 950)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("host,hosts", [(0, 2), (1, 2), (2, 3)])
def test_per_rank_order_matches_jax(host, hosts):
    ours = DataLoader(_Sized(23), 2, seed=5, host_id=host, num_hosts=hosts)
    theirs = JaxDataLoader(_Sized(23), 2, seed=5, host_id=host, num_hosts=hosts)
    assert len(ours) == len(theirs) == (23 // hosts) // 2
    for epoch in (0, 1):
        np.testing.assert_array_equal(ours._epoch_indices(epoch), theirs._epoch_indices(epoch))
    for loader in (ours, theirs):
        loader.quarantine.indices.update({3, 11, 17})
    np.testing.assert_array_equal(ours._epoch_indices(2), theirs._epoch_indices(2))
    with pytest.raises(ValueError, match="host_id"):
        DataLoader(_Sized(4), 1, host_id=2, num_hosts=2)


def test_two_ranks_batches_are_one_ranks_batch(tmp_path):
    """Rank r of 2 (batch 2) serves rows r, r + 2 of one rank's batch of 4:
    the same samples, augmented the same way, since every draw is keyed on
    (seed, epoch, sample index)."""
    trees.write_sceneflow(str(tmp_path), np.random.default_rng(4), 4, 1, h=60, w=88, max_disp=8.0)
    cfg = TrainConfig(augment=AugmentConfig(crop_size=(48, 64), min_scale=-0.2, max_scale=0.4,
                                            saturation_range=(0.0, 1.4)), root_dataset=str(tmp_path))
    dataset = build_training_dataset(cfg)
    loaders = [DataLoader(dataset, 4, seed=9, num_workers=1)] + [
        DataLoader(dataset, 2, seed=9, num_workers=1, host_id=r, num_hosts=2) for r in range(2)]
    try:
        one, *ranks = [next(iter(loader)) for loader in loaders]
    finally:
        for loader in loaders:
            loader.close()
    for r, got in enumerate(ranks):
        for key in ("image1", "image2", "flow", "valid"):
            np.testing.assert_array_equal(got[key], one[key][r::2], err_msg=f"rank {r} {key}")


def test_global_budget_mode_matches_jax():
    """In the pod-global mode a rank's own ratio never raises; the budget
    holds on the reduced counts, where JAX's check raises too."""
    loader = DataLoader(_Sized(8), 2, failure_budget=0.1)
    loader.set_global_budget_mode()
    assert not loader.quarantine.enforce
    for i in range(5):  # 5 of 5 attempts dropped: far past 10%, and no raise
        loader.quarantine.quarantine(i)
    ours, theirs = SampleQuarantine(0.1), JaxSampleQuarantine(0.1)
    for dropped, attempted in ((0, 0), (1, 5), (1, 10), (2, 10), (1, 9), (11, 100), (10, 100)):
        outcomes = []
        for q in (ours, theirs):
            try:
                q.check_global(dropped, attempted)
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 - compared by type below
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1], (dropped, attempted, outcomes)
    with pytest.raises(FailureBudgetExceeded, match="across the pod"):
        ours.check_global(2, 10)
