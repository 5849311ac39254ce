"""The port's training across two ranks against the JAX package's sharded
step.

Two gloo ranks on the CPU (tests/torch_dist_worker.py, started with
torchrun's environment) take one dp step and one fsdp step from shared
weights (JAX-initialized, perturbed, kernels halved, as in
tests/test_torch_train.py), each rank on its own row of a batch of 2 at
48x64 and 3 iterations. The JAX reference is `make_train_step` jitted with
the JAX `ShardingEngine`'s shardings over a (2, 1) mesh of the conftest's
host devices, under the same preset, fp32 at "highest" matmul precision.

- Each step's metrics, gradient norm and updated parameters against JAX's,
  with `test_torch_train.py::test_train_step_matches_jax`'s tolerances.
- Under fsdp each rank holds half the rows of every conv weight whose
  C_out divides 2, and of its AdamW moments; the other parameters whole.
- The fsdp run's checkpoint restores into a one-process dp `Trainer` bit
  for bit (parameters, moments, count, step), and `evaluate` reads its
  model.pth.

`train` itself across two ranks is tests/test_torch_distributed_cli.py.
"""

import os
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils import checkpoints as ck
from torch_parity import assert_step_matches_jax, free_port, halve_kernels, jax_init, jax_sharded_step, rank_env
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, ITERS, B = 48, 64, 3, 2
HID = (32, 32, 32)
MODEL = {"hidden_dims": HID, "corr_implementation": "pallas"}
PRESETS = ("dp", "fsdp")


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


@pytest.fixture(scope="module")
def runs(weights, batch, tmp_path_factory):
    """The two ranks' dp and fsdp steps (one launch), the JAX steps computed
    while they run."""
    workdir = tmp_path_factory.mktemp("dist")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"batch": batch, "h": H, "w": W, "model": MODEL, "iters": ITERS, "num_steps": 1000,
                     "weights": weights}, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(workdir),
                               ",".join(PRESETS)], env=rank_env(r, 2, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        want = {preset: jax_sharded_step(weights, batch, preset, (2, 1), HID, ITERS) for preset in PRESETS}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    got = {}
    for preset in PRESETS:
        with open(workdir / f"{preset}.pkl", "rb") as f:
            got[preset] = pickle.load(f)
        got[preset]["local"] = []
        for r in range(2):
            with open(workdir / f"{preset}.p{r}.pkl", "rb") as f:
                got[preset]["local"].append(pickle.load(f))
    return workdir, got, want


@pytest.mark.parametrize("preset", PRESETS)
def test_two_rank_step_matches_jax(weights, runs, preset):
    """One step over two ranks against JAX's step on a (2, 1) mesh under the
    same preset: the metrics, the gradient norm before clipping (each rank
    clips by it) and the updated parameters."""
    _, got, want = runs
    mine = got[preset]["metrics"]
    for r in range(2):  # every rank reports the global batch's values
        assert got[preset]["local"][r]["metrics"] == mine
    assert_step_matches_jax(RAFTStereo(RAFTStereoConfig(**MODEL)), weights, mine, got[preset]["params"],
                            got[preset]["grads"], want[preset])


def test_fsdp_ranks_hold_half_of_each_dividing_weight_and_its_moments(runs):
    """Under fsdp each rank's parameter and both moments are the rows
    [rank * C_out / 2, (rank + 1) * C_out / 2) of a conv weight whose C_out
    is even, and whole for the rest (norms, biases, the C_out=1 flow head);
    under dp everything is whole."""
    _, got, _ = runs
    model = RAFTStereo(RAFTStereoConfig(**MODEL))
    sharded = 0
    for name, p in model.named_parameters():
        full = tuple(p.shape)
        split = p.dim() == 4 and full[0] % 2 == 0
        want = ((full[0] // 2, *full[1:]) if split else full,) * 3
        sharded += split
        for r in range(2):
            assert got["fsdp"]["local"][r]["local"][name] == want, (name, r)
            assert got["dp"]["local"][r]["local"][name] == (full,) * 3, (name, r)
    assert sharded > 50
    assert got["fsdp"]["local"][1]["local"]["update_block.flow_head.conv2.weight"][0] == (1, 256, 3, 3)


def test_fsdp_checkpoint_restores_into_one_process_dp(runs, tmp_path, monkeypatch, capsys):
    """The world-2 fsdp step's checkpoint (committed: its manifest verifies,
    each rank's run state beside it) restores into a one-process dp Trainer
    bit for bit; `evaluate` reads its model.pth."""
    workdir, got, _ = runs
    step_dir = workdir / "ck" / "fsdp" / "1"
    assert ck.validate_checkpoint(str(step_dir)) == []
    assert {"run_state.json", "run_state.p1.json", "model.pth", "optimizer.pt"} <= set(os.listdir(step_dir))
    cfg = TrainConfig(model=RAFTStereoConfig(**MODEL), batch_size=B, train_iters=ITERS, num_steps=1000)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    assert trainer.restore(path=str(workdir / "ck" / "fsdp")) == 1
    assert trainer.optimizer.count == 1
    for name, p in trainer.model.named_parameters():
        assert np.array_equal(p.detach().numpy(), got["fsdp"]["params"][name]), name
        for k in ("mu", "nu"):
            assert np.array_equal(trainer.optimizer.state[p][k].numpy(), got["fsdp"]["moments"][name][k]), name
    monkeypatch.chdir(tmp_path)
    argv = ["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", "--valid_iters", "2",
            "--restore_ckpt", str(step_dir / "model.pth"), "--hidden_dims", *map(str, HID)]
    assert cli.main(argv) == 0
    assert "Validation ETH3D: EPE" in capsys.readouterr().out
