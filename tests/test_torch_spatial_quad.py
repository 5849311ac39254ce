"""`dp+spatial` on a (2, 2) mesh: four gloo ranks on the CPU
(tests/torch_spatial_worker.py `quad`), two data groups of two row bands,
one training step against the port's unsharded step on the whole batch.

The batch is 2 pairs at 48x64 (each data group one pair, each rank 24 rows
of it), "pallas" fp32, 2 iterations, seeded weights with every conv kernel
halved (tests/test_torch_model.py says why). The loss and metrics are the
global batch's on every rank (rtol 1e-5, the norm 1e-4), every rank holds
the same parameters after the step, and the clipped gradients and updates
are held as tests/test_torch_spatial.py holds the two-rank step's
(`torch_parity.assert_updates_match_one_process`, with
tests/test_torch_train.py's GRAD_TOL and FNET_TOL).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.train.trainer import Trainer
from torch_parity import assert_updates_match_one_process, free_port, rank_env
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, B, TRAIN_ITERS = 48, 64, 2, 2
MODEL = {"hidden_dims": (32, 32, 32)}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (B, H, W + 6, 3)).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, H, W, 1)).astype(np.float32)
    flow[0, :3, :5] = -800.0  # past max_flow: masked out
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32)
    return {"image1": left[:, :, 6:], "image2": left[:, :, :W], "flow": flow, "valid": valid}


@pytest.fixture(scope="module")
def quad(batch, tmp_path_factory):
    """The four ranks' step (one launch) and the unsharded step, computed
    while they run."""
    import torch

    workdir = tmp_path_factory.mktemp("quad")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": batch, "model": MODEL, "train_iters": TRAIN_ITERS, "num_steps": 1000,
                     "train_hw": (H, W)}, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_spatial_worker.py"), str(workdir), "quad"],
                              env=rank_env(r, 4, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        cfg = TrainConfig(model=RAFTStereoConfig(**MODEL, corr_implementation="pallas"), batch_size=B,
                          train_iters=TRAIN_ITERS, num_steps=1000)
        trainer = Trainer(cfg, (H, W, 3), device="cpu")
        with torch.no_grad():
            for p in trainer.model.parameters():
                if p.dim() == 4:
                    p.mul_(0.5)
        before = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
        metrics = trainer.train_step(batch)
        want = {"metrics": metrics, "before": before,
                "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
                "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    got = []
    for r in range(4):
        with open(workdir / f"quad{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want


def test_dp_spatial_step_on_four_ranks_matches_unsharded(quad):
    got, want = quad
    for r in range(4):
        assert got[r]["rank_batch"] == 1
        assert got[r]["metrics"] == got[0]["metrics"]
        for k in ("epe", "1px", "3px", "5px", "live_loss"):
            np.testing.assert_allclose(got[r]["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[r]["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4)
        for name, value in got[r]["params"].items():
            assert np.array_equal(value, got[0]["params"][name]), (r, name)


def test_dp_spatial_gradients_and_updates_match_unsharded(quad):
    got, want = quad
    assert_updates_match_one_process(got[0]["params"], got[0]["grads"], want)
