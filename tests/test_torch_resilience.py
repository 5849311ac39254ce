"""The port's training resilience, through `cli.run_training` (the exit
codes a user sees) on the CPU:

- `nan_policy` raise (exit 14 at the first bad step), skip (updates
  dropped, exit 14 once `nan_patience` bad steps run back to back) and
  rollback (the last good checkpoint restored and the data re-iterated;
  exit 14 once rollbacks keep walking back into NaN);
- SIGTERM: exit 13 with a committed checkpoint at the step it stopped;
- a stalled step: the watchdog dumps every stack, writes run_report.json
  with stop_cause "watchdog" and exits 16 (tests/torch_train_worker.py);
- the loader's failure budget: exit 15;
- a configuration that fails validation: a run report and exit 1;
- every flag whose value the port does not run yet: exit 2.
"""

import copy
import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import AugmentConfig, RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data import trees
from raft_stereo_tpu_torch.data.datasets import build_training_dataset
from raft_stereo_tpu_torch.data.loader import DataLoader
from raft_stereo_tpu_torch.train.optimizer import make_optimizer
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils import checkpoints as ck
from raft_stereo_tpu_torch.utils.run_report import validate_run_report
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, B = 32, 48, 2
SMALL = RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2, corr_implementation="pallas")


@pytest.fixture(scope="module")
def base():
    return Trainer(TrainConfig(model=SMALL, batch_size=B, train_iters=1, num_steps=6, seed=3), (H, W, 3), device="cpu")


def trainer_for(base, tmp_path, **kw):
    t = copy.copy(base)
    t.model = copy.deepcopy(base.model)
    t.config = cfg = dataclasses.replace(base.config, checkpoint_dir=str(tmp_path / "checkpoints"),
                                         log_dir=str(tmp_path / "runs"), **kw)
    t.optimizer, t.schedule = make_optimizer(list(t.model.parameters()), cfg.lr, cfg.num_steps, cfg.wdecay,
                                             cfg.grad_clip_norm)
    return t


def _batch(seed, bad=False):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W + 4, 3)).astype(np.float32)
    b = {"image1": left[:, :, 4:], "image2": left[:, :, :W],
         "flow": -rng.uniform(0, 4, (B, H, W, 1)).astype(np.float32), "valid": np.ones((B, H, W), np.float32)}
    if bad:
        b["image1"] = np.full_like(b["image1"], np.nan)
    return b


class Stream:
    """A re-iterable stream of batches; `bad(pass, i)` marks the NaN ones
    (pass counts iterations of the stream, i the batch in it)."""

    def __init__(self, n=4, bad=lambda p, i: False, on_batch=None):
        self.n, self.bad, self.on_batch, self.passes = n, bad, on_batch, 0

    def __iter__(self):
        p = self.passes
        self.passes += 1
        for i in range(self.n):
            if self.on_batch is not None:
                self.on_batch(p, i)
            yield _batch(10 * p + i, self.bad(p, i))


def report(tmp_path):
    with open(tmp_path / "runs" / "run_report.json") as f:
        r = json.load(f)
    assert validate_run_report(r) == []
    return r


def test_nan_policy_raise(base, tmp_path):
    """JAX's contract: "raise" has no device guard, the bad step is taken
    (the step count reads 2) and the host raises when it reads the flag."""
    t = trainer_for(base, tmp_path, nan_policy="raise")
    assert cli.run_training(t, Stream(bad=lambda p, i: i == 1)) == 14
    r = report(tmp_path)
    assert r["stop_cause"] == "nonfinite" and r["final_step"] == 2 and "NonFiniteLossError" in r["error"]
    assert "at step 2" in r["error"]


def test_nan_policy_skip(base, tmp_path):
    """One bad step is skipped (weights untouched); two back to back
    exhaust nan_patience=2: exit 14."""
    t = trainer_for(base, tmp_path, nan_policy="skip", nan_patience=2, num_steps=4)
    assert cli.run_training(t, Stream(bad=lambda p, i: i == 1)) == 0
    r = report(tmp_path)
    assert r["skipped_steps"] == 1 and r["final_step"] == 4 and t.optimizer.count == 3
    t = trainer_for(base, tmp_path, nan_policy="skip", nan_patience=2)
    assert cli.run_training(t, Stream(bad=lambda p, i: i >= 1)) == 14
    r = report(tmp_path)
    assert r["stop_cause"] == "nonfinite" and r["skipped_steps"] == 2


def test_nan_policy_rollback(base, tmp_path):
    """A bad window in the stream's first pass rolls back to the last good
    checkpoint (step 2) and re-iterates the stream, whose next pass is
    clean: the run completes with one rollback. A stream that is always bad
    after step 2 exhausts the rollbacks: exit 14."""
    t = trainer_for(base, tmp_path, nan_policy="rollback", nan_patience=2, checkpoint_every=2, num_steps=6)
    assert cli.run_training(t, Stream(bad=lambda p, i: p == 0 and i >= 2)) == 0
    r = report(tmp_path)
    assert r["rollbacks"] == 1 and r["skipped_steps"] == 2 and r["final_step"] == 6
    assert ck.list_checkpoint_steps(t.checkpoint_path())[-1] == 6
    assert all(torch.isfinite(p).all() for p in t.model.parameters())
    t = trainer_for(base, tmp_path / "always", nan_policy="rollback", nan_patience=1, checkpoint_every=2)
    assert cli.run_training(t, Stream(bad=lambda p, i: p > 0 or i >= 2)) == 14
    r = report(tmp_path / "always")
    # Three restores; the guard counts the fourth, which it refuses.
    assert r["stop_cause"] == "nonfinite" and r["rollbacks"] == 4 and r["last_good_step"] == 2


def test_sigterm_exits_13_with_a_checkpoint(base, tmp_path):
    """SIGTERM while step 3's batch is handed over: the step finishes, the
    run saves step 3 and exits 13 (the guard's handler, in this process)."""
    t = trainer_for(base, tmp_path, num_steps=10, checkpoint_every=100)

    def on_batch(p, i):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    assert cli.run_training(t, Stream(n=8, on_batch=on_batch)) == 13
    r = report(tmp_path)
    assert r["stop_cause"] == "preempted" and r["preempt_signal"] == "SIGTERM" and r["last_good_step"] == 3
    assert ck.validate_checkpoint(os.path.join(t.checkpoint_path(), "3")) == []
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL  # the guard restored the handler


def test_stalled_step_exits_16(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(HERE, "torch_train_worker.py"), str(tmp_path), "stall:3"],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True, text=True, timeout=240)
    assert out.returncode == 16, out.stderr[-3000:]
    assert "StepWatchdog: no step-boundary heartbeat" in out.stderr and "--- thread" in out.stderr
    r = report(tmp_path)
    assert r["stop_cause"] == "watchdog" and r["exit_code"] == 16 and r["watchdog"]["fired"]
    assert r["watchdog"]["last_beat_step"] == 2 and "--- thread" in r["traces"]
    assert os.path.exists(tmp_path / "runs" / "flight_recorder.json")


def test_failure_budget_exits_15(base, tmp_path, monkeypatch):
    kitti = tmp_path / "datasets" / "KITTI"
    trees.write_kitti(str(kitti), np.random.default_rng(1), 8, h=40, w=56, max_disp=8.0)
    for name in sorted(os.listdir(kitti / "training" / "image_2"))[:5]:
        (kitti / "training" / "image_2" / name).write_bytes(b"not a png")
    monkeypatch.chdir(tmp_path)
    t = trainer_for(base, tmp_path, failure_budget=0.25, sample_retries=0, num_steps=8)
    cfg = dataclasses.replace(t.config, augment=AugmentConfig(crop_size=(H, W)), train_datasets=("kitti",))
    loader = DataLoader(build_training_dataset(cfg), B, seed=1, num_workers=1, sample_policy="quarantine",
                        sample_retries=0, failure_budget=0.25)
    try:
        assert cli.run_training(t, loader) == 15
    finally:
        loader.close()
    r = report(tmp_path)
    assert r["stop_cause"] == "failure_budget" and r["dropped_samples"] >= 1 and r["quarantined"] >= 1


def test_bad_config_writes_a_report_and_exits_1(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "--nan_patience", "0", "--device", "cpu"]) == 1
    r = report(tmp_path)
    assert r["stop_cause"] == "error" and r["final_step"] == -1 and "nan_patience" in r["error"]


UNPORTED_OR_UNFIT = [
    # A spatial axis runs row bands; a mesh that does not fit the world
    # (one process here) is a usage error.
    (["--mesh_shape", "1", "2"], "mesh 1x2 covers 2 rank(s) but the world has 1"),
    (["--sharding_rules", "spatial", "--mesh_shape", "-1", "2"], "1 ranks not divisible by spatial=2"),
    (["--sharding_rules", "fsdp", "--mesh_shape", "-1", "2"], "1 ranks not divisible by spatial=2"),
]


@pytest.mark.parametrize("flags,message", UNPORTED_OR_UNFIT,
                         ids=["mesh_shape", "sharding_rules", "fsdp_sharding_rules"])
def test_unported_train_flags_exit_2(flags, message, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", "--device", "cpu", *flags]) == 2
    assert message in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "runs")  # refused before anything ran


@pytest.mark.parametrize("flags,field,value", [
    (["--mesh_shape", "2", "1"], "mesh_shape", (2, 1)), (["--sharding_rules", "fsdp"], "sharding_rules", "fsdp"),
    (["--coord_interval", "5"], "coord_interval", 5), (["--async_checkpoint"], "async_checkpoint", True),
    (["--metrics_port", "9100"], "metrics_port", 9100), (["--mesh_shape", "1", "2"], "mesh_shape", (1, 2)),
    (["--sharding_rules", "dp+spatial", "--mesh_shape", "-1", "2"], "sharding_rules", "dp+spatial"),
    (["--strict_mode"], "strict_mode", True), (["--recompile_grace", "3"], "recompile_grace", 3),
    (["--compilation_cache_dir", "cache"], "compilation_cache_dir", "cache"),
], ids=["mesh_shape", "sharding_rules", "coord_interval", "async_checkpoint", "metrics_port", "spatial_mesh_shape",
        "spatial_sharding_rules", "strict_mode", "recompile_grace", "compilation_cache_dir"])
def test_formerly_unported_train_flags_are_taken(flags, field, value):
    """The flags once refused reach the config, and `train` no longer
    refuses them: `--explain_sharding` is a dry run
    (tests/test_torch_parallel.py), and the jit hygiene's flags are driven
    in tests/test_torch_jit_hygiene.py."""
    args = cli._train_parser().parse_args(flags)
    assert getattr(cli._train_config_from_args(args), field) == value
