"""`fsdp` on a (2, 2) mesh: FSDP2 over the data axis, row bands over the
spatial axis. Four gloo ranks on the CPU (tests/torch_spatial_worker.py
`fsdp`), two data groups of two bands, one training step from JAX weights
(perturbed, every conv kernel halved) on a batch of 2 at 48x64, "pallas"
fp32, 2 iterations, held

- against JAX's fsdp steps, jitted as the JAX Trainer jits them
  (`torch_parity.jax_sharded_step`, tests/test_torch_distributed.py's
  tolerances) on meshes of the conftest's host devices: the metrics
  against its step on (2, 2), the gradient norm and the updates against
  its step on (1, 2). On the CPU backend JAX's steps on a (2, 2) mesh
  return wrong gradients: under fsdp twice the true ones on nearly every
  leaf (norm 456.4 against 217.56 at these inputs), under dp twice on
  `mask_conv1`'s kernel; on (1, 1), (2, 1) and (1, 2) they agree with each
  other and with the port. And against the port's one-process step on the
  whole batch (tests/test_torch_spatial_quad.py's tolerances);
- per rank: half the rows of each conv weight whose C_out divides 2, and
  of both its moments, the rest whole, and the two ranks of a spatial
  group holding the same pieces bit for bit;
- through its checkpoint: restored bit for bit into a one-process dp
  `Trainer`, and, written again under `dp+spatial` on (2, 2), resumed under
  fsdp there to the same pieces;
- in validation: the banded validation model (a whole copy gathered on
  every rank, on the bands of data group 0) against that copy's whole
  test-mode forward.

Plus `serve --sharding_rules fsdp`: the plain engine on one device, the
banded engine with two cards, exit 2 with two replicas.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import band_devices
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils import checkpoints as ck
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (assert_step_matches_jax, assert_updates_match_one_process, free_port, halve_kernels, jax_init,
                          jax_sharded_step, rank_env)
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, B, TRAIN_ITERS, VALID_ITERS = 48, 64, 2, 2, 2
HID = (32, 32, 32)
MODEL = {"hidden_dims": HID}


@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (B, H, W + 6, 3)).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, H, W, 1)).astype(np.float32)
    flow[0, :3, :5] = -800.0  # past max_flow: masked out
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32)
    return {"image1": left[:, :, 6:], "image2": left[:, :, :W], "flow": flow, "valid": valid}


def one_process_trainer(**extra) -> Trainer:
    cfg = TrainConfig(model=RAFTStereoConfig(**MODEL, corr_implementation="pallas"), batch_size=B,
                      train_iters=TRAIN_ITERS, num_steps=1000, **extra)
    return Trainer(cfg, (H, W, 3), device="cpu")


@pytest.fixture(scope="module")
def runs(weights, batch, tmp_path_factory):
    """The four ranks (one launch); JAX's steps and the port's one-process
    step, computed while they run."""
    workdir = tmp_path_factory.mktemp("fsdp_bands")
    rng = np.random.default_rng(5)
    pair = rng.uniform(0, 255, (2, 1, H, W, 3)).astype(np.float32)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": batch, "model": MODEL, "train_iters": TRAIN_ITERS, "num_steps": 1000,
                     "train_hw": (H, W), "weights": weights, "valid_pair": tuple(pair),
                     "valid_iters": VALID_ITERS}, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_spatial_worker.py"), str(workdir), "fsdp"],
                              env=rank_env(r, 4, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        jax_want = {mesh: jax_sharded_step(weights, batch, "fsdp", mesh, HID, TRAIN_ITERS)
                    for mesh in ((2, 2), (1, 2))}
        trainer = one_process_trainer()
        with torch.no_grad():
            load_jax_variables(trainer.model, weights)
        before = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
        metrics = trainer.train_step(batch)
        port_want = {"metrics": metrics, "before": before,
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
        with open(workdir / f"fsdp{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return workdir, got, jax_want, port_want


def test_fsdp_step_on_bands_matches_jax(weights, runs):
    """Every rank reports the global batch's metrics; they match JAX's fsdp
    step on a (2, 2) mesh, and the step (metrics, gradient norm, updated
    parameters) JAX's fsdp step on (1, 2)."""
    _, got, jax_want, _ = runs
    for r in range(4):
        assert got[r]["banded"] and got[r]["rank_batch"] == 1
        assert got[r]["metrics"] == got[0]["metrics"]
    quad_metrics, _ = jax_want[(2, 2)]
    for k in ("epe", "1px", "3px", "5px", "live_loss"):
        np.testing.assert_allclose(got[0]["metrics"][k], quad_metrics[k], rtol=1e-5, err_msg=k)
    assert_step_matches_jax(RAFTStereo(RAFTStereoConfig(**MODEL)), weights, got[0]["metrics"], got[0]["params"],
                            got[0]["grads"], jax_want[(1, 2)])


def test_fsdp_step_on_bands_matches_one_process(runs):
    """The same step against the port's unsharded step on the whole batch:
    metrics, gradients and updates, as the dp+spatial step is held."""
    _, got, _, want = runs
    mine = got[0]
    for k in ("epe", "1px", "3px", "5px", "live_loss"):
        np.testing.assert_allclose(mine["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(mine["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4)
    assert_updates_match_one_process(mine["params"], mine["grads"], want)


def test_fsdp_ranks_on_bands_hold_half_of_each_dividing_weight(runs):
    """Rank r holds rows [d * C_out / 2, (d + 1) * C_out / 2) of each conv
    weight whose C_out is even, and of both its moments (d = r // 2, its
    data coordinate), and the rest whole; the two ranks of a spatial group
    hold the same pieces bit for bit."""
    _, got, _, _ = runs
    sharded = 0
    for name, p in RAFTStereo(RAFTStereoConfig(**MODEL)).named_parameters():
        full = tuple(p.shape)
        split = p.dim() == 4 and full[0] % 2 == 0
        sharded += split
        whole = [got[0]["params"][name], got[0]["moments"][name]["mu"], got[0]["moments"][name]["nu"]]
        for r in range(4):
            rows = slice((r // 2) * full[0] // 2, (r // 2 + 1) * full[0] // 2) if split else slice(None)
            for piece, value in zip(got[r]["local"][name], whole):
                assert piece.shape == value[rows].shape, (name, r)
                assert np.array_equal(piece, value[rows]), (name, r)
            for piece, peer in zip(got[r]["local"][name], got[r ^ 1]["local"][name]):
                assert np.array_equal(piece, peer), (name, r)
    assert sharded > 50
    assert got[3]["local"]["update_block.flow_head.conv2.weight"][0].shape == (1, 256, 3, 3)


def test_fsdp_on_bands_checkpoint_restores_into_one_process_dp_and_back(runs):
    """The (2, 2) fsdp step's checkpoint (committed, every rank's run state
    beside it) restores into a one-process dp Trainer bit for bit; written
    again under dp+spatial (2, 2), it resumes under fsdp (2, 2) to the
    step's pieces on every rank."""
    workdir, got, _, _ = runs
    step_dir = workdir / "ck" / "fsdp" / "1"
    assert ck.validate_checkpoint(str(step_dir)) == []
    assert {f"run_state.p{r}.json" for r in (1, 2, 3)} <= set(os.listdir(step_dir))
    trainer = one_process_trainer()
    assert trainer.restore(path=str(workdir / "ck" / "fsdp")) == 1
    assert trainer.optimizer.count == 1
    for name, p in trainer.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), got[0]["params"][name]), name
        for k in ("mu", "nu"):
            assert np.array_equal(trainer.optimizer.state[p][k].numpy(), got[0]["moments"][name][k]), name
    assert ck.validate_checkpoint(str(workdir / "ck" / "dpsp" / "1")) == []
    for r in range(4):
        assert got[r]["resumed_step"] == 1 and got[r]["resumed_count"] == 1
        for name, pieces in got[r]["local"].items():
            for a, b in zip(pieces, got[r]["resumed_local"][name]):
                assert np.array_equal(a, b), (name, r)


def test_fsdp_on_bands_validation_matches_the_whole_model(runs):
    """The ranks of data group 0 validate on bands of a whole copy and get
    its whole test-mode flow; data group 1 waits."""
    _, got, _, _ = runs
    assert all("valid_banded" in got[r] for r in (0, 1)) and not any("valid_banded" in got[r] for r in (2, 3))
    want = got[0]["valid_whole"]
    assert want.shape == (1, H, W, 1) and np.isfinite(want).all()
    for r in (0, 1):
        np.testing.assert_allclose(got[r]["valid_banded"], want, rtol=1e-4, atol=1e-4)


def test_serve_fsdp_on_one_device_and_banded_on_two(capsys, monkeypatch):
    """`serve --sharding_rules fsdp` boots the plain engine on one visible
    device and says so; with two visible cards the banded engine serves
    them (as under spatial, JAX's (1, n) mesh); with two replicas it exits
    2 before anything is built, as JAX's `--replicas` requires dp."""
    argv = ["serve", "--device", "cpu", "--warmup_only", "--buckets", "64x96", "--max_batch", "1",
            "--chunk_iters", "1", "--max_iters", "1", "--hidden_dims", "16", "16", "16", "--sharding_rules", "fsdp"]
    assert cli.main(argv) == 0
    assert '"sharding": "fsdp requested; one visible device: dp (single-program)"' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli._spatial_serving_problem("fsdp", 1) is None
    assert band_devices(ServeConfig(sharding_rules="fsdp"), "cuda") == [torch.device("cuda:0"),
                                                                        torch.device("cuda:1")]
    assert cli.main(["serve", "--device", "cuda", "--sharding_rules", "fsdp", "--replicas", "2"]) == 2
    assert "replicas require --sharding_rules dp" in capsys.readouterr().err
