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

With `fsdp` (four ranks, tests/test_torch_fsdp_spatial.py): one step under
`fsdp` on a (2, 2) mesh from the JAX weights of <dir>/inputs.pkl, each
rank given its data group's row of the batch; the step's checkpoint; the
validation model on the validation pair (banded on data group 0, and on
rank 0 whole); then the checkpoint restored under `dp+spatial` on the same
mesh and saved again, and that run resumed under `fsdp`. Writes
<dir>/fsdp<k>.pkl: every rank its metrics and its local pieces of each
parameter and moment (and the resumed run's), rank 0 the step's
parameters, gradients and moments gathered whole.

Usage: torch_spatial_worker.py <dir> [quad|fsdp]
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
from raft_stereo_tpu_torch.parallel.sharding import full_tensor, local_tensor  # noqa: E402
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


def local_pieces(trainer) -> dict:
    """{name: (this rank's piece of the parameter, of mu, of nu)} as numpy."""
    opt = trainer.optimizer
    return {n: tuple(local_tensor(t).detach().numpy().copy() for t in (p, opt.state[p]["mu"], opt.state[p]["nu"]))
            for n, p in trainer.model.named_parameters()}


def fsdp(workdir: str, rank: int, inputs: dict) -> None:
    batch, (h, w) = inputs["batch"], inputs["train_hw"]

    def trainer_for(preset: str, name: str) -> Trainer:
        cfg = TrainConfig(model=RAFTStereoConfig(**inputs["model"], corr_implementation="pallas"),
                          batch_size=len(batch["image1"]), train_iters=inputs["train_iters"],
                          num_steps=inputs["num_steps"], mesh_shape=(2, 2), sharding_rules=preset,
                          checkpoint_dir=os.path.join(workdir, "ck"), name=name)
        return Trainer(cfg, (h, w, 3), device="cpu")

    trainer = trainer_for("fsdp", "fsdp")
    with torch.no_grad():
        load_jax_variables(trainer.model, inputs["weights"])
    metrics = trainer.train_step({k: v[rank // 2:rank // 2 + 1] for k, v in batch.items()})
    out = {"metrics": metrics, "rank_batch": trainer.rank_batch, "local": local_pieces(trainer),
           "banded": isinstance(trainer.net, spatial.BandedModel)}
    named = list(trainer.model.named_parameters())
    # Gathered on every rank (collective); rank 0 keeps them.
    whole = {"params": {n: full_tensor(p.detach()).numpy() for n, p in named},
             "grads": {n: full_tensor(p.grad).numpy() for n, p in named},
             "moments": {n: {k: full_tensor(trainer.optimizer.state[p][k]).numpy() for k in ("mu", "nu")}
                         for n, p in named}}
    trainer.save()
    model = trainer._validation_model()
    if model is not None:
        i1, i2 = (torch.from_numpy(x) for x in inputs["valid_pair"])
        with torch.inference_mode():
            out["valid_banded"] = model.forward_whole(i1, i2, iters=inputs["valid_iters"])[1].numpy()
            if rank == 0:
                out["valid_whole"] = model.model(i1, i2, iters=inputs["valid_iters"], test_mode=True)[1].numpy()
    torch.distributed.barrier()
    # fsdp -> dp+spatial -> fsdp through the checkpoint files.
    banded = trainer_for("dp+spatial", "dpsp")
    banded.restore(path=os.path.join(workdir, "ck", "fsdp"))
    banded.save()
    resumed = trainer_for("fsdp", "dpsp")
    out["resumed_step"] = resumed.auto_resume()
    out["resumed_count"] = resumed.optimizer.count
    out["resumed_local"] = local_pieces(resumed)
    if rank == 0:
        out.update(whole)
    with open(os.path.join(workdir, f"fsdp{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def main(workdir: str, mode: str = "pair") -> int:
    info = init_multihost(device="cpu")
    rank, world = info["process_index"], info["process_count"]
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    if mode in ("quad", "fsdp"):
        (quad if mode == "quad" else fsdp)(workdir, rank, inputs)
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
