"""The slice as a whole: the port's training entry point against the JAX
package's.

- Two steps of `cli.run_training` over the port's DataLoader on a KITTI
  tree the test writes, from seeded JAX weights loaded into the port,
  against the JAX `Trainer` over the JAX loader from the same weights.
  KITTI's sparse augmentation at unit scale runs no resize, so the batches
  are bit for bit the same and only the step is compared: per-step loss
  within 1e-5 relative and gradient norm within 1e-4, the tolerances of
  tests/test_torch_train.py::test_train_step_matches_jax.
- On the card (gpu-marked): a mixed step on a batch the DevicePrefetcher
  staged equals the step on the plainly copied batch, bit for bit.

The command line itself (train, evaluate, demo, the default device) is
tested in tests/test_torch_demo.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raft_stereo_tpu import cli as jax_cli
from raft_stereo_tpu.config import AugmentConfig as JaxAugmentConfig
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.data.datasets import build_training_dataset as jax_build_training_dataset
from raft_stereo_tpu.data.loader import DataLoader as JaxDataLoader
from raft_stereo_tpu.train.trainer import Trainer as JaxTrainer
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import AugmentConfig, RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data import trees
from raft_stereo_tpu_torch.data.datasets import build_training_dataset
from raft_stereo_tpu_torch.data.loader import DataLoader
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import halve_kernels, numpy_tree, torch_single_thread  # noqa: F401 (autouse fixture)

H, W, B, ITERS = 48, 64, 2, 2
# The shared-backbone architecture with one GRU level: the smallest graph the
# JAX trainer compiles (its init and step compiles are most of this file's
# time).
MODEL = dict(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2, corr_implementation="reg",
             shared_backbone=True, n_gru_layers=1)


class Capture:
    """A metrics logger that keeps every step's metrics."""

    def __init__(self):
        self.steps = {}

    def push(self, metrics, step):
        self.steps[step] = {k: float(np.asarray(v)) for k, v in metrics.items()}

    def write(self, values, step):
        pass


def test_two_steps_match_jax(tmp_path, monkeypatch):
    trees.write_kitti(str(tmp_path / "datasets" / "KITTI"), np.random.default_rng(2), 6, h=56, w=80, max_disp=8.0)
    monkeypatch.chdir(tmp_path)
    common = dict(batch_size=B, train_iters=ITERS, num_steps=2, train_datasets=("kitti",), seed=5, num_workers=1)
    jcfg = JaxTrainConfig(model=JaxConfig(encoder_s2d=False, **MODEL), augment=JaxAugmentConfig(crop_size=(H, W)),
                          checkpoint_dir=str(tmp_path / "jax_ckpt"), log_dir=str(tmp_path / "jax_runs"), **common)
    pcfg = TrainConfig(model=RAFTStereoConfig(**MODEL), augment=AugmentConfig(crop_size=(H, W)),
                       checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "runs"), **common)
    # The JAX trainer's own seeded weights, kernels halved (mild weights, as
    # in tests/test_torch_model.py), in both trainers.
    jt = JaxTrainer(jcfg, (H, W, 3))
    weights = {"params": halve_kernels(numpy_tree(jt.state.params)), "batch_stats": numpy_tree(jt.state.batch_stats)}
    jt.state = jt.state.replace(params=jt.sharding.place_state(jax.tree.map(jnp.asarray, weights["params"])))
    jloader = JaxDataLoader(jax_build_training_dataset(jcfg), B, seed=jcfg.seed, num_workers=1)
    want = Capture()
    with jax.default_matmul_precision("highest"):
        assert jax_cli.run_training(jt, jloader, metrics_logger=want) == 0
    jloader.close()

    pt = Trainer(pcfg, (H, W, 3), device="cpu")
    load_jax_variables(pt.model, weights)
    ploader = DataLoader(build_training_dataset(pcfg), B, seed=pcfg.seed, num_workers=1)
    got = Capture()
    try:
        assert cli.run_training(pt, ploader, metrics_logger=got) == 0
    finally:
        ploader.close()
    assert sorted(got.steps) == sorted(want.steps) == [1, 2]
    for step in (1, 2):
        g, w = got.steps[step], want.steps[step]
        np.testing.assert_allclose(g["live_loss"], w["live_loss"], rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4, err_msg=f"step {step}")
        for k in ("epe", "1px", "3px", "5px"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"{k} step {step}")
        assert g["learning_rate"] == w["learning_rate"] and g["nonfinite"] == w["nonfinite"] == 0.0
        print(f"step {step}: loss {g['live_loss']:.9g} vs {w['live_loss']:.9g}, "
              f"norm {g['grad_norm']:.9g} vs {w['grad_norm']:.9g}")
    # The loaders walked the same stream.
    assert ploader.state_dict() == jloader.state_dict()


@pytest.mark.gpu
def test_prefetched_mixed_step_equals_plain_copy(tmp_path, monkeypatch):
    """On the card: one mixed-precision training step on a batch the
    DevicePrefetcher staged (side stream, pinned memory) equals, bit for
    bit, the same step on the batch copied plainly, from the same weights."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetcher's side stream and the kernels run on the card")
    from raft_stereo_tpu_torch.data.prefetch import DevicePrefetcher

    trees.write_kitti(str(tmp_path / "datasets" / "KITTI"), np.random.default_rng(2), 4, h=56, w=80, max_disp=8.0)
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(model=RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2,
                                             corr_implementation="pallas", mixed_precision=True,
                                             corr_dtype="bfloat16"),
                      augment=AugmentConfig(crop_size=(H, W)), batch_size=B, train_iters=ITERS,
                      train_datasets=("kitti",), num_steps=4)
    loader = DataLoader(build_training_dataset(cfg), B, seed=1, num_workers=1)
    try:
        host = next(iter(loader))
        staged = next(iter(DevicePrefetcher(loader, "cuda")))
    finally:
        loader.close()
    a, b = Trainer(cfg, (H, W, 3), device="cuda"), Trainer(cfg, (H, W, 3), device="cuda")
    ma, mb = a.train_step(host), b.train_step(staged)
    assert ma == mb
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))


def test_profile_trace_summary(tmp_path):
    """`trace_summary` (logged after `train --profile_steps`'s trace) on a
    written Chrome trace: the host window from the first to the last host
    event, kernel and copy totals, the busy share, and the annotations by
    host time with their counts."""
    import json

    from raft_stereo_tpu_torch.utils.profiling import trace_summary

    def event(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [event("cpu_op", "aten::mm", 1000.0, 500.0),
              event("user_annotation", "gloo:all_gather", 1200.0, 300.0),
              event("user_annotation", "gloo:all_gather", 1600.0, 100.0),
              event("cuda_runtime", "cudaMemcpy", 2800.0, 200.0),
              event("kernel", "gemm", 1100.0, 400.0),
              event("gpu_memcpy", "Memcpy HtoD", 2900.0, 50.0),
              {"ph": "i", "cat": "cpu_op", "name": "mark", "ts": 0.0}]  # an instant: not a span
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_summary(str(path)) == {"window_ms": 2.0, "kernel_ms": 0.4, "memcpy_ms": 0.05, "busy": 0.2,
                                        "annotations": {"gloo:all_gather": [0.4, 2]}}
