"""One rank of the port's row-band tests (tests/test_torch_spatial.py).

Started once per rank with torchrun's environment (RANK, WORLD_SIZE, ...);
joins the process group over gloo on the CPU, lays the ranks on a
(1, world) mesh and, from the weights and inputs in <dir>/inputs.pkl:

- for each forward case (corr implementation, height), the test-mode
  forward on this rank's band of the images through `BandedModel`, with
  the band scope's exchanges counted inside `corr_state` and
  `corr_sample` (the correlation chain) and over the whole forward;
  `forward_whole` on the first case's whole images;
- one `Trainer.train_step` under `spatial` on the (1, world) mesh, and one
  under `dp` on the same mesh (row bands too), each on the whole batch
  (the trainer keeps this rank's rows).

Writes <dir>/rank<k>.pkl with what the test compares.

With `quad` (four ranks, tests/test_torch_spatial_quad.py): one step under
`dp+spatial` on a (2, 2) mesh, each rank given its data group's row of the
batch, from the seeded weights of <dir>/inputs.pkl's config with every
conv kernel halved; writes <dir>/quad<k>.pkl.

Usage: torch_spatial_worker.py <dir> [quad]
"""

import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig  # noqa: E402
from raft_stereo_tpu_torch.models import raft_stereo as rs  # noqa: E402
from raft_stereo_tpu_torch.parallel import init_multihost, spatial  # noqa: E402
from raft_stereo_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from raft_stereo_tpu_torch.train.trainer import Trainer  # noqa: E402
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables  # noqa: E402


def count_corr_exchanges(record):
    """Wrap the model module's correlation entry points so that each call's
    exchanges on the band scope in force land in `record`."""
    def counted(fn):
        def wrapped(*args, **kwargs):
            scope = spatial.active()
            before = scope.exchanges
            out = fn(*args, **kwargs)
            record.append(scope.exchanges - before)
            return out
        return wrapped

    rs.corr_state = counted(rs.corr_state)
    rs.corr_sample = counted(rs.corr_sample)


def halve_convs(model) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                p.mul_(0.5)


def quad(workdir: str, rank: int, inputs: dict) -> None:
    batch, (h, w) = inputs["batch"], inputs["train_hw"]
    cfg = TrainConfig(model=RAFTStereoConfig(**inputs["model"], corr_implementation="pallas"),
                      batch_size=len(batch["image1"]), train_iters=inputs["train_iters"],
                      num_steps=inputs["num_steps"], mesh_shape=(2, 2), sharding_rules="dp+spatial")
    trainer = Trainer(cfg, (h, w, 3), device="cpu")
    halve_convs(trainer.model)
    mine = {k: v[rank // 2:rank // 2 + 1] for k, v in batch.items()}
    metrics = trainer.train_step(mine)
    with open(os.path.join(workdir, f"quad{rank}.pkl"), "wb") as f:
        pickle.dump({"metrics": metrics, "rank_batch": trainer.rank_batch,
                     "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
                     "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}}, f)


def main(workdir: str, mode: str = "pair") -> int:
    info = init_multihost(device="cpu")
    rank, world = info["process_index"], info["process_count"]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if mode == "quad":
        quad(workdir, rank, inputs)
        torch.distributed.destroy_process_group()
        return 0
    mesh = make_mesh((1, world), device_type="cpu")
    scope = spatial.band_scope_for(mesh)
    corr_record = []
    count_corr_exchanges(corr_record)
    out = {"forward": {}, "train": {}}
    for impl, h in inputs["cases"]:
        i1, i2 = (torch.from_numpy(x) for x in inputs["images"][h])
        model = rs.RAFTStereo(RAFTStereoConfig(**inputs["model"], corr_implementation=impl))
        model = load_jax_variables(model, inputs["weights"]).eval()
        banded = spatial.BandedModel(model, scope)
        corr_record.clear()
        before = scope.exchanges
        with torch.inference_mode():
            lo, up = banded(scope.take_band(i1, 1), scope.take_band(i2, 1), iters=inputs["iters"], test_mode=True)
            whole = None
            if (impl, h) == inputs["cases"][0]:
                whole = banded.forward_whole(i1, i2, iters=inputs["iters"])[1].numpy()
        out["forward"][(impl, h)] = {"lo": lo.numpy(), "up": up.numpy(), "whole": whole,
                                     "exchanges": scope.exchanges - before, "corr_exchanges": list(corr_record)}

    batch, (h, w) = inputs["batch"], inputs["train_hw"]
    for preset in ("spatial", "dp"):
        cfg = TrainConfig(model=RAFTStereoConfig(**inputs["model"], corr_implementation="pallas"),
                          batch_size=len(batch["image1"]), train_iters=inputs["train_iters"],
                          num_steps=inputs["num_steps"], mesh_shape=(1, world), sharding_rules=preset)
        trainer = Trainer(cfg, (h, w, 3), device="cpu")
        load_jax_variables(trainer.model, inputs["weights"])
        train_scope = trainer.net.band_scope
        corr_record.clear()
        metrics = trainer.train_step(batch)
        out["train"][preset] = {
            "banded": isinstance(trainer.net, spatial.BandedModel),
            "metrics": metrics,
            "corr_exchanges": list(corr_record),
            "exchanges": train_scope.exchanges,
            "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
            "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()},
        }
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
