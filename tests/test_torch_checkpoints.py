"""The port's checkpoints: the JAX package's integrity manifest around the
port's step format (model.pth, optimizer.pt, run_state.json, MANIFEST.json).

- The manifest: the port's `validate_checkpoint` and `find_latest_valid_step`
  give the JAX package's verdicts, message for message, on step
  directories either side committed, whole, torn or corrupted.
- A save restores exactly: weights, AdamW moments and count, step; the
  next step equals the uninterrupted one bit for bit.
- Retention: `max_to_keep` and `keep_period` prune as orbax's manager does.
- Auto-resume quarantines a torn newest step and walks past it; invalid
  steps with nothing valid beside them raise.
- A SIGKILL inside a checkpoint commit, then the same command again
  (auto-resume), ends bit for bit equal to an uninterrupted run, with the
  same loader cursor (tests/torch_train_worker.py).
"""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu.utils import checkpoints as jax_ck
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.train.optimizer import make_optimizer
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils import checkpoints as ck
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
H, W, B = 32, 48, 2
SMALL = RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2, corr_implementation="pallas")


@pytest.fixture(scope="module")
def base():
    cfg = TrainConfig(model=SMALL, batch_size=B, train_iters=1, num_steps=20, seed=3)
    return Trainer(cfg, (H, W, 3), device="cpu")


def small_trainer(base, tmp_path, noise=None, **kw):
    """A copy of the module's trainer writing under `tmp_path`; `noise`
    seeds a perturbation of its weights (another starting point)."""
    t = copy.copy(base)
    t.model = copy.deepcopy(base.model)
    t.config = cfg = dataclasses.replace(base.config, checkpoint_dir=str(tmp_path / "checkpoints"),
                                         log_dir=str(tmp_path / "runs"), **kw)
    t.optimizer, t.schedule = make_optimizer(list(t.model.parameters()), cfg.lr, cfg.num_steps, cfg.wdecay,
                                             cfg.grad_clip_norm)
    if noise is not None:
        g = torch.Generator().manual_seed(noise)
        with torch.no_grad():
            for p in t.model.parameters():
                p.add_(torch.randn(p.shape, generator=g) * 1e-2)
    return t


def batch(seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W + 4, 3)).astype(np.float32)
    return {"image1": left[:, :, 4:], "image2": left[:, :, :W],
            "flow": -rng.uniform(0, 4, (B, H, W, 1)).astype(np.float32), "valid": np.ones((B, H, W), np.float32)}


def state_of(trainer):
    sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = {(i, k): v.clone() for i, s in enumerate(trainer.optimizer.state.values()) for k, v in s.items()}
    return sd, opt, trainer.optimizer.count, trainer.step


def test_save_restore_is_exact(base, tmp_path):
    a = small_trainer(base, tmp_path)
    a.train_step(batch(0))
    step_dir = a.save()
    assert sorted(os.listdir(step_dir)) == ["MANIFEST.json", "model.pth", "optimizer.pt", "run_state.json"]
    assert ck.validate_checkpoint(step_dir) == [] and jax_ck.validate_checkpoint(step_dir) == []
    b = small_trainer(base, tmp_path, noise=99)  # other weights until restored
    assert b.restore() == 1 and b.resumed_from_step == 1 and b.resume_count == 1
    sa, oa, ca, pa = state_of(a)
    sb, ob, cb, pb = state_of(b)
    assert (ca, pa) == (cb, pb) == (1, 1) and sa.keys() == sb.keys() and oa.keys() == ob.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa) and all(torch.equal(oa[k], ob[k]) for k in oa)
    ma, mb = a.train_step(batch(1)), b.train_step(batch(1))
    assert ma == mb
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
    # The step's model.pth is a reference .pth: a warm start reads it.
    c = small_trainer(base, tmp_path, noise=5)
    c.restore_torch(os.path.join(step_dir, "model.pth"))
    assert all(torch.equal(x, y) for x, y in zip(c.model.state_dict().values(), sa.values()))
    assert c.step == 0 and c.optimizer.count == 0


def _corrupt(step_dir, how):
    if how == "torn":
        os.remove(os.path.join(step_dir, "MANIFEST.json"))
    elif how == "truncated":
        path = next(full for _, full in ck._manifest_files(step_dir) if not full.endswith("run_state.json"))
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif how == "bitflip":
        path = os.path.join(step_dir, "run_state.json")
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 1
        open(path, "wb").write(bytes(data))
    elif how == "missing":
        os.remove(os.path.join(step_dir, "run_state.json"))
    elif how == "garbage_manifest":
        open(os.path.join(step_dir, "MANIFEST.json"), "w").write("{not json")
    elif how == "version":
        m = json.load(open(os.path.join(step_dir, "MANIFEST.json")))
        m["manifest_version"] = 99
        json.dump(m, open(os.path.join(step_dir, "MANIFEST.json"), "w"))


@pytest.mark.parametrize("how", ["whole", "torn", "truncated", "bitflip", "missing", "garbage_manifest", "version"])
def test_manifest_verdicts_match_jax(base, tmp_path, how):
    """Both validators on a step the port committed and on one committed by
    the JAX package's `commit_step_sidecars` (over stand-in payload files),
    then corrupted the same way: the same problems, word for word."""
    trainer = small_trainer(base, tmp_path)
    port_dir = trainer.save(run_state={"run_state_version": 1, "step": 0, "loader": {"epoch": 0}})
    jax_dir = str(tmp_path / "jax" / "0")
    os.makedirs(os.path.join(jax_dir, "default"))
    open(os.path.join(jax_dir, "default", "a.bin"), "wb").write(os.urandom(4096))
    jax_ck.commit_step_sidecars(jax_dir, 0, {"run_state_version": 1, "step": 0})
    for d in (port_dir, jax_dir):
        _corrupt(d, how)
        got, want = ck.validate_checkpoint(d), jax_ck.validate_checkpoint(d)
        assert got == want and (got == []) == (how == "whole"), (d, got, want)
        root = os.path.dirname(d)
        assert ck.find_latest_valid_step(root) == jax_ck.find_latest_valid_step(root)


def test_retention_prunes_as_orbax(base, tmp_path):
    trainer = small_trainer(base, tmp_path, max_to_keep=2, keep_period=3)
    for step in range(1, 8):
        trainer.step = step
        trainer.save()
    assert ck.list_checkpoint_steps(trainer.checkpoint_path()) == [3, 6, 7]
    assert ck.steps_to_prune(range(1, 8), 2) == [1, 2, 3, 4, 5]
    assert ck.steps_to_prune(range(1, 8), 2, 3) == [1, 2, 4, 5]
    with pytest.raises(FileExistsError):
        trainer.save()


def test_auto_resume_walks_past_torn_steps(base, tmp_path):
    trainer = small_trainer(base, tmp_path)
    for step in (2, 4, 6):
        trainer.step = step
        trainer.save()
    root = trainer.checkpoint_path()
    _corrupt(os.path.join(root, "6"), "torn")
    _corrupt(os.path.join(root, "4"), "bitflip")
    fresh = small_trainer(base, tmp_path)
    assert fresh.auto_resume() == 2
    assert fresh.fallback_steps_skipped == 2 and fresh.resumed_from_step == 2
    assert sorted(os.listdir(root)) == ["2", "4.corrupt-invalid", "6.corrupt-invalid"]
    # Nothing valid beside invalid steps: refuse, and rename nothing.
    shutil.rmtree(os.path.join(root, "2"))
    trainer.step = 8
    trainer.save()
    _corrupt(os.path.join(root, "8"), "torn")
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        small_trainer(base, tmp_path).auto_resume()
    assert "8" in os.listdir(root)
    # No checkpoint root at all: a fresh start.
    assert small_trainer(base, tmp_path / "elsewhere").auto_resume() is None


def _worker(workdir, spec):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, os.path.join(HERE, "torch_train_worker.py"), str(workdir), spec],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_sigkill_mid_save_then_auto_resume_is_exact(tmp_path):
    """Control (6 steps, saves at 2, 4, 6) and a leg that SIGKILLs itself
    inside step 4's commit run side by side; rerunning the killed leg
    quarantines the torn step 4, resumes at 2 and ends equal to the
    control: model.pth and optimizer.pt byte for byte equal in content, and
    the same loader cursor."""
    control, crash = tmp_path / "control", tmp_path / "crash"
    procs = [_worker(control, "none"), _worker(crash, "mid_save:4")]
    outs = [p.communicate(timeout=240) for p in procs]
    assert procs[0].returncode == 0, outs[0][1][-3000:]
    assert procs[1].returncode == -9, outs[1][1][-3000:]
    root = crash / "checkpoints" / "raft-stereo"
    assert ck.validate_checkpoint(str(root / "4")) != [] and ck.validate_checkpoint(str(root / "2")) == []
    again = _worker(crash, "none")
    out, err = again.communicate(timeout=240)
    assert again.returncode == 0, err[-3000:]
    report = json.load(open(crash / "runs" / "run_report.json"))
    assert report["resumed_from_step"] == 2 and report["fallback_steps_skipped"] == 1 and report["final_step"] == 6
    want_dir, got_dir = control / "checkpoints" / "raft-stereo" / "6", root / "6"
    want = torch.load(want_dir / "model.pth", weights_only=True)
    got = torch.load(got_dir / "model.pth", weights_only=True)
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    wo, go = ck.read_optimizer_state(str(want_dir)), ck.read_optimizer_state(str(got_dir))
    assert (wo["count"], wo["step"]) == (go["count"], go["step"]) == (6, 6)
    for k, s in wo["optimizer"]["state"].items():
        assert all(torch.equal(s[n], go["optimizer"]["state"][k][n]) for n in s)
    cursors = [json.load(open(d / "run_state.json"))["loader"] for d in (want_dir, got_dir)]
    assert cursors[0] == cursors[1]
