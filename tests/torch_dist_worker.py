"""One rank of the port's two-rank training tests (tests/test_torch_distributed.py).

Started once per rank with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT); joins the process
group over gloo on the CPU and, for each preset in <presets>, builds a
`Trainer` over the two ranks from the weights in <dir>/inputs.pkl, takes one
step on this rank's row of the global batch there, and writes what the
test compares:

    <dir>/<preset>.pkl      rank 0: the step's metrics, every parameter,
                            its clipped gradient and its AdamW moments
                            gathered whole
    <dir>/<preset>.p<k>.pkl every rank: its local shapes of each parameter
                            and moment
    <dir>/ck/<preset>/1/    rank 0 (and every rank's run state): the step's
                            checkpoint

Usage: torch_dist_worker.py <dir> <preset>[,<preset>...]
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig  # noqa: E402
from raft_stereo_tpu_torch.parallel import init_multihost  # noqa: E402
from raft_stereo_tpu_torch.parallel.sharding import full_tensor, local_tensor  # noqa: E402
from raft_stereo_tpu_torch.train.trainer import Trainer  # noqa: E402
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables  # noqa: E402


def main(workdir: str, presets: str) -> int:
    info = init_multihost(device="cpu")
    rank, world = info["process_index"], info["process_count"]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    batch, h, w = inputs["batch"], inputs["h"], inputs["w"]
    rows = len(batch["image1"]) // world
    mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    for preset in presets.split(","):
        cfg = TrainConfig(model=RAFTStereoConfig(**inputs["model"]), batch_size=len(batch["image1"]),
                          train_iters=inputs["iters"], num_steps=inputs["num_steps"], mesh_shape=(-1, 1),
                          sharding_rules=preset, checkpoint_dir=os.path.join(workdir, "ck"), name=preset)
        trainer = Trainer(cfg, (h, w, 3), device="cpu")
        with torch.no_grad():
            load_jax_variables(trainer.model, inputs["weights"])
        metrics = trainer.train_step(mine)
        params = {n: full_tensor(p.detach()).numpy().copy() for n, p in trainer.model.named_parameters()}
        grads = {n: full_tensor(p.grad).numpy().copy() for n, p in trainer.model.named_parameters()}
        opt = trainer.optimizer
        moments = {n: {k: full_tensor(opt.state[p][k]).numpy().copy() for k in ("mu", "nu")}
                   for n, p in trainer.model.named_parameters()}
        local = {n: (tuple(local_tensor(p).shape), tuple(local_tensor(opt.state[p]["mu"]).shape),
                     tuple(local_tensor(opt.state[p]["nu"]).shape)) for n, p in trainer.model.named_parameters()}
        trainer.save()
        with open(os.path.join(workdir, f"{preset}.p{rank}.pkl"), "wb") as f:
            pickle.dump({"local": local, "metrics": metrics}, f)
        if rank == 0:
            with open(os.path.join(workdir, f"{preset}.pkl"), "wb") as f:
                pickle.dump({"metrics": metrics, "params": params, "grads": grads, "moments": moments}, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
