"""Subprocess worker of the port's crash, resume and watchdog tests
(tests/test_torch_checkpoints.py, tests/test_torch_resilience.py).

Runs one tiny training leg through the port's production entry path
(`cli.maybe_resume` + `cli.run_training`) over the port's DataLoader on a
KITTI tree under <dir>, with `auto_resume=True`, so rerunning the worker
with the same arguments is the documented recovery. The leg's spec:

    none        run to completion
    mid_save:N  SIGKILL itself inside the step-N checkpoint commit, after
                model.pth, optimizer.pt and run_state.json are written and
                before the manifest: the torn-save window
    stall:N     hang before the batch of step N (the step watchdog, armed
                with a 2 s timeout, ends the process with exit 16)

The process exit code is run_training's. Usage:
    torch_train_worker.py <dir> <spec>
"""

import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from raft_stereo_tpu_torch import cli  # noqa: E402
from raft_stereo_tpu_torch.config import AugmentConfig, RAFTStereoConfig, TrainConfig  # noqa: E402
from raft_stereo_tpu_torch.data import trees  # noqa: E402
from raft_stereo_tpu_torch.data.datasets import build_training_dataset  # noqa: E402
from raft_stereo_tpu_torch.data.loader import DataLoader  # noqa: E402
from raft_stereo_tpu_torch.train.trainer import Trainer  # noqa: E402
from raft_stereo_tpu_torch.utils import checkpoints as ck  # noqa: E402

H, W = 32, 48
NUM_STEPS = 6
CKPT_EVERY = 2


def config(workdir: str, **kw) -> TrainConfig:
    return TrainConfig(
        model=RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2, corr_implementation="pallas"),
        augment=AugmentConfig(crop_size=(H, W)), train_datasets=("kitti",), batch_size=2, train_iters=2,
        num_steps=NUM_STEPS, checkpoint_every=CKPT_EVERY, auto_resume=True, num_workers=1, seed=7,
        checkpoint_dir=os.path.join(workdir, "checkpoints"), log_dir=os.path.join(workdir, "runs"), **kw)


def main(workdir: str, spec: str) -> int:
    kind, _, at = spec.partition(":")
    at = int(at) if at else -1
    kitti = os.path.join(workdir, "datasets", "KITTI")
    if not os.path.isdir(kitti):
        trees.write_kitti(kitti, np.random.default_rng(0), 6, h=40, w=56, max_disp=8.0)
    os.chdir(workdir)  # KITTI reads datasets/KITTI, as in the reference
    extra = {"step_timeout_s": 2.0, "watchdog_grace_s": 30.0} if kind == "stall" else {}
    cfg = config(workdir, **extra)
    loader = DataLoader(build_training_dataset(cfg), cfg.batch_size, seed=cfg.seed, num_workers=1,
                        sample_policy=cfg.sample_policy)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    cli.maybe_resume(trainer, cfg)
    data = loader
    if kind == "mid_save":
        commit = ck.commit_step_sidecars

        def torn(step_dir, step, run_state=None):
            if step == at:
                ck.write_run_state(step_dir, run_state)
                os.kill(os.getpid(), signal.SIGKILL)
            return commit(step_dir, step, run_state)

        ck.commit_step_sidecars = torn
    elif kind == "stall":
        class Stalling:
            def __getattr__(self, name):
                return getattr(loader, name)

            def __iter__(self):
                for i, batch in enumerate(loader):
                    if trainer.step + 1 == at:
                        time.sleep(600)
                    yield batch

        data = Stalling()
    try:
        return cli.run_training(trainer, data)
    finally:
        loader.close()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
