"""Training: the step, checkpoints and resume, and the resilient loop. The
port's counterpart of `raft_stereo_tpu/train/trainer.py` (`Trainer`,
`make_train_step`, `fit`), one process on one device.

The step has the JAX step's contract: `Trainer.dispatch_step` takes one
optimizer step on a batch and reads nothing back from the device. It
returns the step's values (epe, 1px, 3px, 5px, live_loss, grad_norm,
nonfinite) as one device tensor, a `StepResult`, that the host fetches
later, several steps in one copy (`fetch_steps`). Under `nan_policy`
"skip" or "rollback" the update is applied on the device where the loss
and the gradient norm are finite only (the optimizer's guarded apply):
a non-finite step leaves the parameters and the optimizer's state
(moments and count) untouched while the trainer's step count advances,
as the JAX step keeps its old params and opt_state; `learning_rate` is
the schedule at the trainer's step, as in JAX. Under "raise" there is no
device guard, as in JAX: the host raises `NonFiniteLossError` when it
reads the flag. `Trainer.train_step` is "dispatch, fetch, policy" for
one step and returns the metrics as floats. Frozen batch norm is
structural as in the JAX package: `FrozenBatchNorm` never consumes batch
statistics, so only its scale and bias train.

Mixed precision trains as in JAX (`RAFTStereoConfig(corr_implementation=
"pallas", mixed_precision=True, corr_dtype="bfloat16")`): bf16 compute and
pyramid, with parameters, gradients, clipping, the AdamW state and the
loss in fp32, and no loss scaling.

Checkpoints (utils/checkpoints.py): `save` writes a step directory
`<checkpoint_dir>/<name>/<step>/` (`model.pth` in the reference's layout,
`optimizer.pt`, `run_state.json`) and commits it with the JAX package's
integrity manifest, written last by an atomic rename; `max_to_keep` and
`keep_period` prune as orbax's manager does. `restore`, `auto_resume`
(walking past torn steps), `rollback` and `restore_torch` (weights from a
reference `.pth`) bring a run back; the run state (loader cursor and
quarantine set, non-finite counters, the numpy and torch RNG states) is
applied by the next `fit`.

`fit` keeps the JAX loop's contract: the validation hook,
`NonFiniteGuard` under all three policies, `PreemptionGuard` (SIGTERM:
final checkpoint, exit 13), `StepWatchdog` (exit 16), the device
prefetcher, the loader's failure budget, the flight recorder, the async
checkpoint committer (train/io_spine.py), the `/metrics` sidecar,
run_report.json on every exit path, and the jit hygiene
(utils/jit_hygiene.py): the kernel-build monitor always, and under
`strict_mode` on a card the whole loop under the sync guard. The steps'
values wait on the device in `pending_flags` and reach the host in one
fetch inside a named window: the non-finite drain (every
`nan_check_every` steps, where each fetched step's line is logged and
its metrics pushed), the pod sync, the end of the run. Validation,
checkpoint saves (the snapshot is taken on the loop's thread; the async
commit thread touches host copies only), rollback, the pod sync and the
profiler's stop run in `whitelist` windows, as in JAX's fit, and so does
DDP's one rebuild of its gradient buckets, moved from the second step's
forward to just after the first step.

Across ranks (a process group, parallel/): the model is wrapped by the
sharding preset (dp: DistributedDataParallel; fsdp: FSDP2 over the data
axis; a spatial axis above 1: the band scope, parallel/spatial.py, around
either the whole model or, under fsdp, the sharded one), each rank steps
on its own part of the global batch (its data group's rows; on a spatial
axis above 1 its band of their image rows), and a step's loss, metrics
and gradients are those of the global batch: every rank divides by the
global batch's valid-pixel count and the ranks' shares are summed over
every rank. Pod coordination (`HostCoordinator`) makes every stop, abort
and rollback branch the same on every rank at the same step; validation,
metrics and the sidecar run on rank 0 while the others wait (validation
on bands on every rank of the first data group, under fsdp on a whole
copy that every rank gathers). A checkpoint is written by rank 0 in the
single-card layout (whole tensors, gathered on every rank under fsdp)
with every rank's run state beside it, so it restores into any world
size and preset.
"""

from __future__ import annotations

import base64
import contextlib
import logging
import os
import shutil
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed

from raft_stereo_tpu_torch.config import TrainConfig, finalize_train_config
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.parallel.distributed import topology
from raft_stereo_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, shard_batch
from raft_stereo_tpu_torch.parallel.sharding import ShardingEngine, full_tensor
from raft_stereo_tpu_torch.train.io_spine import AsyncCheckpointCommitter, build_io_spine_block
from raft_stereo_tpu_torch.train.loss import sequence_loss, valid_count
from raft_stereo_tpu_torch.train.optimizer import make_optimizer
from raft_stereo_tpu_torch.utils.resilience import NonFiniteLossError  # noqa: F401 (re-export)

logger = logging.getLogger(__name__)


def _capture_host_rng(device: torch.device) -> Dict[str, Any]:
    """JSON-able snapshot of the host's global RNGs for the run state: the
    legacy numpy generator, torch's CPU generator and, on a card, its
    generators. The loader's streams are stateless (keyed on (seed, epoch,
    index)); anything else that samples resumes exactly with these."""
    name, keys, pos, has_gauss, cached = np.random.get_state()
    snap: Dict[str, Any] = {
        "np_legacy": [name, np.asarray(keys).tolist(), int(pos), int(has_gauss), float(cached)],
        "torch_cpu": base64.b64encode(torch.get_rng_state().numpy().tobytes()).decode(),
    }
    if device.type == "cuda" and torch.cuda.is_initialized():
        snap["torch_cuda"] = [base64.b64encode(s.numpy().tobytes()).decode() for s in torch.cuda.get_rng_state_all()]
    return snap


def _restore_host_rng(snapshot: Dict[str, Any]) -> None:
    """Best-effort by contract: a malformed snapshot degrades to a warning,
    never aborts the resume it rides in on."""
    snapshot = snapshot or {}
    try:
        legacy = snapshot.get("np_legacy")
        if legacy:
            name, keys, pos, has_gauss, cached = legacy
            np.random.set_state((name, np.asarray(keys, np.uint32), int(pos), int(has_gauss), float(cached)))
        if snapshot.get("torch_cpu"):
            torch.set_rng_state(torch.frombuffer(bytearray(base64.b64decode(snapshot["torch_cpu"])), dtype=torch.uint8))
        if snapshot.get("torch_cuda") and torch.cuda.is_available():
            states = [torch.frombuffer(bytearray(base64.b64decode(s)), dtype=torch.uint8)
                      for s in snapshot["torch_cuda"]]
            torch.cuda.set_rng_state_all(states[:torch.cuda.device_count()])
    except (ValueError, TypeError, RuntimeError):
        logger.warning("could not restore host RNG state from checkpoint", exc_info=True)


def _until_stopped(data: Iterable, pguard) -> Iterable:
    """Iterate `data`; once a stop signal has arrived, a failure of the data
    stream ends the epoch instead of the run: a signal sent to the process
    group stops the loader's worker processes too, and the preempted run
    still owes its final checkpoint."""
    it = iter(data)
    while True:
        try:
            batch = next(it)
        except StopIteration:
            return
        except Exception:
            if not pguard.stop_requested:
                raise
            logger.warning("data stream ended after the stop signal", exc_info=True)
            return
        yield batch


class StepResult:
    """One dispatched step, its values still on the device: `values`, a
    1-dim fp32 tensor in the order of `names`, with the host's `step` (the
    step count after it) and `learning_rate` (the schedule at it), and
    the host clock's `t0` when its batch arrived."""

    __slots__ = ("names", "values", "step", "learning_rate", "t0")

    def __init__(self, names: Sequence[str], values: torch.Tensor, step: int, learning_rate: float,
                 t0: Optional[float] = None):
        self.names = tuple(names)
        self.values = values
        self.step = step
        self.learning_rate = learning_rate
        self.t0 = t0


def fetch_steps(results: Sequence[StepResult]) -> List[Dict[str, float]]:
    """The dispatched steps' metrics as floats, in one device-to-host copy
    (under the sync guard: inside a window)."""
    if not results:
        return []
    rows = torch.stack([r.values for r in results]).tolist()
    return [dict(zip(r.names, row), learning_rate=r.learning_rate) for r, row in zip(results, rows)]


def rank_file(name: str, process_index: int) -> str:
    """`name` for rank 0, `<stem>.p<k><ext>` for rank k: every rank's file
    beside rank 0's in one directory (as utils/checkpoints.py names the
    ranks' run-state bundles)."""
    if process_index == 0:
        return name
    stem, ext = os.path.splitext(name)
    return f"{stem}.p{process_index}{ext}"


def rank_batch_size(batch_size: int, local_world_size: int, spatial: int = 1) -> int:
    """The batch rows each rank steps on: `batch_size` is one host's batch
    (as JAX's is one process's, and a JAX process is a whole host), split
    over the host's ranks, where the `spatial` ranks of a spatial group
    share their rows (each keeps its band of their image rows)."""
    if (batch_size * spatial) % local_world_size:
        raise ValueError(f"batch_size {batch_size} (one host's batch) does not split over its "
                         f"{local_world_size} rank(s) in spatial groups of {spatial}")
    return batch_size * spatial // local_world_size


class Trainer:
    """Owns the model, the optimizer and schedule, the step count and the
    checkpoints.

    `sample_shape` is (H, W, C) of one training image; every batch must
    have it. The model's weights are drawn from `config.seed`
    (`models/init.build_model`). Inside a process group the trainer is one
    rank: `config.mesh_shape` must cover the world (-1 infers the data
    axis), `config.sharding_rules` picks the preset, and each batch holds
    this rank's `rank_batch` rows."""

    def __init__(self, config: TrainConfig, sample_shape: Tuple[int, int, int], device="cuda"):
        config = finalize_train_config(config)
        if sample_shape[2] != config.model.in_channels:
            raise ValueError(f"sample_shape {tuple(sample_shape)} has {sample_shape[2]} channels; "
                             f"the model takes {config.model.in_channels}")
        self.config = config
        self.sample_shape = tuple(sample_shape)
        self.device = torch.device(device)
        self.topology = topology()
        self.process_index = self.topology["process_index"]
        joined = self.topology["process_count"] > 1 or self.topology["backend"] is not None
        self.mesh = make_mesh(config.mesh_shape, device_type=self.device.type if joined else None)
        self.rank_batch = rank_batch_size(config.batch_size, self.topology["local_world_size"], self.mesh.spatial)
        self.sharding = ShardingEngine(self.mesh, config.sharding_rules)
        self.model = build_model(config.model, seed=config.seed, device=self.device)
        # The module the step calls inside a process group (DDP around the
        # model, or the model itself, sharded in place by FSDP2).
        self._wrapped = self.sharding.wrap(self.model) if self.sharding.distributed else None
        self.optimizer, self.schedule = make_optimizer(
            list(self.model.parameters()), config.lr, config.num_steps, config.wdecay, config.grad_clip_norm
        )
        # gloo groups of the host side, one per thread that uses it (two
        # threads' collectives on one group could interleave differently
        # on different ranks): the main thread's (pod coordination, the
        # barriers around validation and resume) and the commit thread's.
        self._host_group = self._commit_group = None
        if self.sharding.distributed:
            import torch.distributed as dist

            self._host_group = dist.new_group(backend="gloo")
            self._commit_group = dist.new_group(backend="gloo")
        self._eval_model = None
        self._committer = AsyncCheckpointCommitter()
        self.step = 0
        # Step of the newest save issued through this trainer: the final
        # fit() save skips a step the periodic cadence already wrote.
        self._last_saved_step: Optional[int] = None
        # What the last fit() absorbed (run_report.json's payload).
        self.last_run_report: Dict[str, Any] = {}
        # Resume provenance (run_report.json schema v2).
        self.resumed_from_step: Optional[int] = None
        self.resume_count = 0
        self.fallback_steps_skipped = 0
        # Run state read from a restored checkpoint, applied by the next fit().
        self._pending_run_state: Optional[Dict[str, Any]] = None

    @property
    def net(self) -> torch.nn.Module:
        """The module the step calls: the preset's wrapper of the model, or
        the model itself in one process."""
        return self._wrapped if self._wrapped is not None else self.model

    # --- the step ---------------------------------------------------------
    def _device_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's part as float32 tensors on the device (on a spatial
        axis above 1 its band of the image rows), after a shape check of
        its data group's rows. A batch already on the device (the
        prefetcher's) passes through without a copy."""
        b = self.rank_batch
        h, w, c = self.sample_shape
        want = {"image1": (b, h, w, c), "image2": (b, h, w, c), "flow": (b, h, w, 1), "valid": (b, h, w)}
        for key, shape in want.items():
            got = tuple(np.shape(batch[key]))
            if got != shape:
                raise ValueError(f"batch[{key!r}] has shape {got}, expected {shape}")
        return shard_batch(self.mesh, batch, self.device)

    def train_step(self, batch: Mapping[str, Any]) -> Dict[str, float]:
        """One optimizer step: image1/image2 (B, H, W, C) in [0, 255], flow
        (B, H, W, 1), valid (B, H, W), as numpy arrays or tensors (B: this
        rank's rows). Returns epe, 1px, 3px, 5px, live_loss, grad_norm
        (before clipping), nonfinite (1.0 when the loss or the norm was
        NaN/Inf) and learning_rate (the schedule at this step), all of the
        global batch and equal on every rank. `dispatch_step`, then one
        fetch, then the policy: under "raise" a non-finite step raises."""
        (out,) = fetch_steps([self.dispatch_step(batch)])
        if out["nonfinite"] > 0.0 and self.config.nan_policy == "raise":
            raise NonFiniteLossError(f"non-finite loss/grad_norm at step {self.step - 1} (nan_policy=raise)")
        return out

    def dispatch_step(self, batch: Mapping[str, Any], t0: Optional[float] = None) -> StepResult:
        """One optimizer step, as `train_step`, with nothing read back from
        the device: the values wait in the returned StepResult."""
        cfg = self.config
        b = self._device_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        count = None
        distributed = self.sharding.distributed
        if distributed:
            count = valid_count(b["flow"], b["valid"], cfg.max_flow)
            torch.distributed.all_reduce(count)
        flows = self.net(b["image1"], b["image2"], iters=cfg.train_iters)
        loss, metrics = sequence_loss(flows, b["flow"], b["valid"], cfg.loss_gamma, cfg.max_flow, count=count)
        # This rank's share of the global loss; DDP and FSDP2 average the
        # ranks' gradients, so scaling by the data axis makes them the sum
        # (on bands the engine sums them itself).
        scale = self.sharding.loss_scale
        (loss * scale if scale > 1 else loss).backward()
        self.sharding.reduce_replicated_grads(self.model)
        grad_norm = self.optimizer.clip_grads_()
        shares = torch.stack([*metrics.values(), loss.detach()])
        if distributed:
            torch.distributed.all_reduce(shares)
        finite = torch.isfinite(shares[-1]) & torch.isfinite(grad_norm)
        # skip and rollback: JAX's jnp.where(finite, new, old) on the device.
        self.optimizer.step(finite=finite if cfg.nan_policy in ("skip", "rollback") else None)
        values = torch.cat([shares, grad_norm.reshape(1), (~finite).to(shares.dtype).reshape(1)])
        result = StepResult((*metrics, "live_loss", "grad_norm", "nonfinite"), values, self.step + 1,
                            self.schedule(self.step), t0)
        self.step += 1
        return result

    # --- checkpoints --------------------------------------------------------
    def checkpoint_path(self) -> str:
        """This run's checkpoint root (the --restore_ckpt value that resumes it)."""
        return os.path.abspath(os.path.join(self.config.checkpoint_dir, self.config.name))

    def _retry_io(self, fn, label: str):
        """Transient-I/O retry for checkpoint operations (utils/retry.py)."""
        from raft_stereo_tpu_torch.utils.retry import is_transient_io, retry_call

        return retry_call(fn, attempts=self.config.io_retries, base_delay=self.config.io_backoff,
                          classify=is_transient_io, label=label)

    def _host_state(self) -> Dict[str, torch.Tensor]:
        """The model's state dict as whole host copies (gathered across the
        ranks under fsdp: collective)."""
        return {k: full_tensor(v).detach().to("cpu", copy=True) for k, v in self.model.state_dict().items()}

    def _barrier(self, group) -> None:
        if group is not None:
            torch.distributed.barrier(group=group)

    def explain_sharding(self) -> str:
        """Every parameter -> placement decision for this run's preset and
        mesh (the `train --explain_sharding` payload)."""
        return self.sharding.explain(self.model)

    def save(self, run_state: Optional[Dict[str, Any]] = None, wait: bool = True) -> str:
        """Write this step's directory and commit it: rank 0 writes
        `model.pth` and `optimizer.pt` (whole tensors, the single-card
        layout), every other rank its `run_state.p<k>.json`, then, after a
        barrier, rank 0 writes `run_state.json` and the integrity manifest,
        whose atomic rename is the commit point (a kill at any byte before
        it leaves a step that `validate_checkpoint` rejects and auto-resume
        walks past). Then rank 0 prunes to `max_to_keep` / `keep_period`.
        Every rank calls this at the same step.

        The snapshot (host copies; the fsdp gather) runs here. The commit
        runs here too, or, with `config.async_checkpoint` and not `wait`,
        on the committer's thread; at most one commit is in flight: the
        barrier below joins the previous one first. Returns the step
        directory."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        self._committer.barrier()
        step = int(self.step)
        root = self.checkpoint_path()
        step_dir = os.path.join(root, str(step))
        rank = self.process_index
        if rank == 0 and os.path.exists(step_dir):
            raise FileExistsError(f"checkpoint step {step} already exists at {step_dir!r}")
        rs = run_state if run_state is not None else self._minimal_run_state(step)
        model_state = ck.export_reference_state_dict(self.model, self._host_state())
        opt_state = {"optimizer": self.optimizer.full_state_dict(), "count": int(self.optimizer.count),
                     "step": step}

        def commit() -> None:
            # `ck` resolved at call time, so a test can intercept the
            # sequence between the payload and the manifest.
            if rank == 0:
                self._retry_io(lambda: ck.write_step_files(step_dir, model_state, opt_state),
                               label=f"checkpoint save (step {step})")
            if self._commit_group is not None:
                self._barrier(self._commit_group)  # rank 0 made the directory
                if rank:
                    try:
                        ck.write_run_state(step_dir, rs, process_index=rank)
                    except OSError:
                        # Best effort, as in JAX: restore falls back to
                        # rank 0's bundle.
                        logger.warning("could not write rank %d's run state for step %d", rank, step,
                                       exc_info=True)
                self._barrier(self._commit_group)  # every rank's files are down
            if rank == 0:
                self._retry_io(lambda: ck.commit_step_sidecars(step_dir, step, rs),
                               label=f"checkpoint manifest commit (step {step})")
                for old in ck.steps_to_prune(ck.list_checkpoint_steps(root), self.config.max_to_keep,
                                             self.config.keep_period):
                    shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)

        if wait or not self.config.async_checkpoint:
            commit()
        else:
            self._committer.submit(commit, step=step)
        self._last_saved_step = step
        return step_dir

    def _minimal_run_state(self, step: int) -> Dict[str, Any]:
        """run_state for saves issued outside fit(): enough for resume
        provenance to stay consistent."""
        return {"run_state_version": 1, "step": int(step), "resume_count": int(self.resume_count)}

    def _load_step(self, step_dir: str) -> None:
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        with torch.no_grad():
            ck.load_reference_checkpoint(self.model, os.path.join(step_dir, ck.MODEL_NAME))
        state = ck.read_optimizer_state(step_dir)
        self.optimizer.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["count"])
        self.step = int(state["step"])

    def restore(self, step: Optional[int] = None, path: Optional[str] = None,
                load_run_state: Optional[bool] = None) -> int:
        """Restore the full train state (weights, AdamW moments and count,
        step). With `path`, from any checkpoint root or step directory;
        else from this run's own root (the newest step, or `step`). The
        files hold whole tensors, so any world size and preset restores
        them: each rank reads them and keeps its own piece.

        `load_run_state` decides whether the step's run state is staged for
        the next fit() with resume provenance recorded. None resolves it by
        intent, as in JAX: True for this run's own checkpoints (a resume),
        False for another run's (a warm start must not adopt a donor's
        loader cursor, quarantine set or spent budget). Rollback passes
        False: it rewinds the weights, not the failure accounting."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        root = self.checkpoint_path()
        if path is not None:
            if load_run_state is None:
                try:
                    load_run_state = os.path.commonpath([os.path.abspath(path), root]) == root
                except ValueError:
                    load_run_state = False
            step_dir = ck.resolve_step_dir(path, step)
        else:
            if load_run_state is None:
                load_run_state = True
            steps = ck.list_checkpoint_steps(root)
            step = (steps[-1] if steps else None) if step is None else step
            if step is None:
                raise FileNotFoundError("no checkpoint to restore")
            step_dir = os.path.join(root, str(step))
        self._retry_io(lambda: self._load_step(step_dir), label=f"checkpoint restore ({step_dir})")
        if path is None:
            self._last_saved_step = int(self.step)
        restored_step = int(self.step)
        if load_run_state:
            run_state = ck.read_run_state(step_dir, process_index=self.process_index)
            self._pending_run_state = run_state
            self.resumed_from_step = restored_step
            prior = int(run_state.get("resume_count", 0)) if run_state else self.resume_count
            self.resume_count = prior + 1
            if run_state is None:
                logger.info("checkpoint at step %d carries no run_state bundle: weights and optimizer "
                            "restored; data-stream position and failure counters start fresh", restored_step)
        return restored_step

    def auto_resume(self) -> Optional[int]:
        """Crash-consistent resume: restore the newest step of this run
        whose manifest verifies, quarantining every newer torn step
        (renamed `<step>.corrupt-*`). None starts fresh (no root or no
        steps). When invalid steps exist but none validates, raises: nothing
        proves those dirs dead, and a fresh run would collide with them at
        its first save."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        root = self.checkpoint_path()
        # Every rank walks (and agrees on) the anchor; rank 0 alone
        # quarantines torn steps, and the others walk after it has.
        if self.process_index == 0 and os.path.isdir(root):
            step, skipped = ck.find_latest_valid_step(root, quarantine=True)
        self._barrier(self._host_group)
        if not os.path.isdir(root):
            logger.info("auto-resume: no checkpoint root at %s; starting fresh", root)
            return None
        if self.process_index:
            step, skipped = ck.find_latest_valid_step(root, quarantine=False)
        self.fallback_steps_skipped = len(skipped)
        if step is None:
            if skipped:
                raise FileNotFoundError(
                    f"auto-resume: no valid checkpoint under {root!r} but {len(skipped)} invalid step dir(s) "
                    f"{[s for s, _ in skipped]} are present (torn saves). Inspect them (python -m "
                    f"raft_stereo_tpu_torch fsck {root}), then either quarantine them to start this run fresh "
                    f"(the same command with --quarantine), or point --restore_ckpt at a step you trust.")
            logger.info("auto-resume: no checkpoints under %s; starting fresh", root)
            return None
        if skipped:
            logger.warning("auto-resume: fell back past %d invalid step(s) %s to step %d",
                           len(skipped), [s for s, _ in skipped], step)
        restored = self.restore(step=step)
        logger.info("auto-resume: restored step %d from %s (resume #%d%s)", restored, root, self.resume_count,
                    f", {len(skipped)} corrupt step(s) quarantined" if skipped else "")
        return restored

    def rollback(self) -> int:
        """Restore the newest checkpoint of this run, the last good state
        under nan_policy="rollback" (non-finite updates never land, so every
        saved state is finite)."""
        from raft_stereo_tpu_torch.utils import checkpoints as ck

        # An async commit may still own the newest step: join it first.
        self._committer.barrier()
        steps = ck.list_checkpoint_steps(self.checkpoint_path())
        if not steps:
            raise FileNotFoundError(f"rollback requested but no checkpoint exists in {self.checkpoint_path()!r}")
        return self.restore(step=steps[-1], load_run_state=False)

    def restore_torch(self, path: str) -> None:
        """Load a reference `.pth` (weights only; the optimizer restarts, as
        the reference's does)."""
        from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

        with torch.no_grad():
            load_reference_checkpoint(self.model, path)

    # --- the loop -----------------------------------------------------------
    def _validation_model(self):
        """The model validation runs on: on rank 0 the model itself, or
        under fsdp a whole copy (gathered on every rank: collective); on a
        spatial axis above 1 the banded model (under fsdp around the whole
        copy) on every rank of the first data group (they validate
        together, band by band), None on the others."""
        sharding = self.sharding
        if not sharding.distributed:
            return self.model
        first = self.mesh.coordinate(DATA_AXIS) == 0 if sharding.banded else self.process_index == 0
        if not sharding.fsdp:
            return (self._wrapped if first else None) if sharding.banded else self.model
        state = {k: full_tensor(v).detach() for k, v in self.model.state_dict().items()}
        if not first:
            return None
        if self._eval_model is None:
            self._eval_model = build_model(self.config.model, seed=self.config.seed, device=self.device)
        self._eval_model.load_state_dict(state)
        if sharding.banded:
            from raft_stereo_tpu_torch.parallel.spatial import BandedModel

            return BandedModel(self._eval_model, self._wrapped.band_scope)
        return self._eval_model

    def fit(self, data: Iterable[Mapping[str, Any]], metrics_logger=None, validate_fn=None):
        """Run up to config.num_steps steps over `data`, an iterable of host
        batches re-iterated when exhausted (the reference's epoch-wrapping
        loop). `validate_fn(model) -> {metric: value}` runs every
        `validate_every` steps and logs through `metrics_logger`.

        SIGTERM/SIGINT stop the run at the next step boundary with a final
        checkpoint; non-finite steps follow `nan_policy` (rollback restores
        the last good checkpoint after `nan_patience` bad steps and
        re-iterates `data`, a fresh shuffle); checkpoints retry transient
        I/O; a stalled step boundary trips the watchdog. A staged run state
        (restore/auto_resume) is applied first, so a resumed run continues
        the data stream and failure accounting where the checkpoint
        stopped. On every exit path `self.last_run_report` holds the
        run-health report, also written to <log_dir>/run_report.json
        (run_report.p<k>.json on rank k > 0); the command line maps it onto
        exit codes. Returns the last step's metrics (the JAX `fit` returns
        its state; the port's model is `self.model`).

        Across ranks every per-rank signal (a stop, a non-finite abort, a
        rollback wish, the loader's drops) is reduced every
        `coord_interval` steps and at every checkpoint, so every rank takes
        the same branch at the same step boundary and the failure budget
        holds for the pod's dropped fraction. Validation, the metrics
        stream and the `/metrics` sidecar run on rank 0 (validation on
        bands on every rank of the first data group); the other ranks
        wait at a barrier."""
        from raft_stereo_tpu_torch.obs.memory import set_memory_gauges
        from raft_stereo_tpu_torch.obs.prom import Registry, serve_registry
        from raft_stereo_tpu_torch.obs.trace import Tracer, observability_block
        from raft_stereo_tpu_torch.parallel.coordination import HostCoordinator
        from raft_stereo_tpu_torch.utils import run_report as rr
        from raft_stereo_tpu_torch.utils.checkpoints import list_checkpoint_steps
        from raft_stereo_tpu_torch.utils.jit_hygiene import JitHygiene
        from raft_stereo_tpu_torch.utils.profiling import StepTimer, trace
        from raft_stereo_tpu_torch.utils.resilience import (
            FailureBudgetExceeded,
            NonFiniteGuard,
            PreemptionGuard,
            StepWatchdog,
        )

        self.config = cfg = finalize_train_config(self.config)
        rank = self.process_index
        primary = rank == 0
        step = self.step
        start_step = step
        timer = StepTimer()
        profile_window = range(start_step + 2, start_step + 2 + cfg.profile_steps) if cfg.profile_steps else range(0)
        profile_ctx = None
        guard = NonFiniteGuard(cfg.nan_policy, patience=cfg.nan_patience)
        pguard = PreemptionGuard()
        coord = HostCoordinator(self._host_group)
        # The kernel-build monitor always counts (the report's jit_hygiene
        # block carries it either way); strict mode adds the sync guard on
        # a card and fails on builds after the grace window.
        hygiene = JitHygiene(strict=cfg.strict_mode, recompile_grace=cfg.recompile_grace, device=self.device)
        if cfg.log_dir:
            os.makedirs(cfg.log_dir, exist_ok=True)
        tracer = Tracer(capacity=cfg.flight_recorder_events,
                        dump_path=os.path.join(cfg.log_dir, rank_file("flight_recorder.json", rank))
                        if cfg.log_dir else None)
        registry = Registry()
        step_hist = registry.histogram("raft_train_step_ms", "Wall-clock per-step cadence (tick-to-tick)")
        data_wait_hist = registry.histogram("raft_train_data_wait_ms", "Host wait for the loader between steps")
        steps_counter = registry.counter("raft_train_steps_total", "Optimizer steps taken this run")
        metrics_server = serve_registry(registry, cfg.metrics_port) if cfg.metrics_port and primary else None
        hygiene.monitor.on_compile = lambda duration_s, whitelisted, post_grace: tracer.event(
            "compile", duration_s=duration_s, whitelisted=whitelisted, post_grace=post_grace)
        prefetcher = None
        if cfg.device_prefetch:
            from raft_stereo_tpu_torch.data.prefetch import DevicePrefetcher

            data = prefetcher = DevicePrefetcher(data, self.device)
        quarantine = getattr(data, "quarantine", None)
        if coord.active and hasattr(data, "set_global_budget_mode"):
            data.set_global_budget_mode()
        pod = {"peer_stop": False}

        pending = self._pending_run_state
        self._pending_run_state = None
        if pending:
            if pending.get("guard"):
                guard.load_state_dict(pending["guard"])
            if pending.get("loader") and hasattr(data, "load_state_dict"):
                data.load_state_dict(pending["loader"])
            if pending.get("host_rng"):
                _restore_host_rng(pending["host_rng"])
            if coord.active and pending.get("pod"):
                coord.load_state_dict(pending["pod"], local_dropped=quarantine.dropped if quarantine else 0,
                                      local_served=quarantine.served if quarantine else 0)
            logger.info(
                "resumed run state at step %d: loader %s, %d skipped steps, %d rollbacks, "
                "%d quarantined samples (resume #%d)", step,
                {k: pending["loader"][k] for k in ("epoch", "batch_cursor")} if pending.get("loader") else "n/a",
                guard.skipped_total, guard.rollbacks, len(quarantine.indices) if quarantine else 0,
                self.resume_count)

        def make_run_state() -> Dict[str, Any]:
            rs: Dict[str, Any] = {
                "run_state_version": 1,
                "step": self.step,
                "resume_count": int(self.resume_count),
                "guard": guard.state_dict(),
                "host_rng": _capture_host_rng(self.device),
            }
            if hasattr(data, "state_dict"):
                rs["loader"] = data.state_dict()
            if coord.active:
                rs["pod"] = coord.state_dict()
            return rs

        def make_report(stop_cause, error=None, traces=None, final_step=None):
            return rr.build_run_report(
                stop_cause=stop_cause,
                final_step=self.step if final_step is None else final_step,
                last_good_step=self._last_saved_step if self._last_saved_step is not None else -1,
                checkpoint_path=self.checkpoint_path() if self._last_saved_step is not None else None,
                preempted=pguard.stop_requested or pod["peer_stop"],
                preempt_signal=pguard.signame or ("peer" if pod["peer_stop"] else None),
                skipped_steps=guard.skipped_total,
                rollbacks=guard.rollbacks,
                dropped_samples=int(quarantine.dropped) if quarantine else 0,
                quarantined=len(quarantine.indices) if quarantine else 0,
                resumed_from_step=self.resumed_from_step if self.resumed_from_step is not None else -1,
                resume_count=self.resume_count,
                fallback_steps_skipped=self.fallback_steps_skipped,
                process_index=coord.process_index,
                process_count=coord.process_count,
                coord_syncs=coord.collectives_dispatched,
                watchdog=watchdog.state(),
                io_spine=build_io_spine_block(cfg.async_checkpoint, cfg.device_prefetch, committer=self._committer,
                                              prefetcher=prefetcher),
                jit_hygiene=hygiene.report(),
                observability=observability_block(tracer),
                error=error,
                traces=traces,
            )

        report_name = rank_file(rr.RUN_REPORT_NAME, rank)

        def on_watchdog_timeout(diag):
            # Runs on the monitor thread while the main thread is wedged:
            # persist the verdict before the hard exit, from host state only.
            beat_step = watchdog.last_beat_step
            self.last_run_report = make_report("watchdog", traces=diag["traces"],
                                               final_step=beat_step if beat_step is not None else -1)
            rr.write_run_report(self.last_run_report, cfg.log_dir, report_name)
            tracer.dump("watchdog")

        watchdog = StepWatchdog(cfg.step_timeout_s, on_timeout=on_watchdog_timeout, exit_code=rr.EXIT_WATCHDOG,
                                first_grace_s=cfg.watchdog_grace_s)
        watchdog.on_fire = lambda diag: tracer.event("watchdog_fire", elapsed_s=float(diag["elapsed_s"]),
                                                     step=diag.get("step"), phase=diag.get("phase"))
        # A wedged background commit blocks the next save's barrier on this
        # thread; the watchdog labels that join and grants it the
        # checkpoint allowance.
        self._committer.attach_watchdog(watchdog, cfg.watchdog_grace_s)
        if validate_fn is not None and getattr(validate_fn, "set_heartbeat", None) is not None:
            def _validation_heartbeat():
                watchdog.beat()
                watchdog.grant(cfg.watchdog_grace_s)

            validate_fn.set_heartbeat(_validation_heartbeat)

        # Dispatched steps whose values still wait on the device.
        pending_flags: List[StepResult] = []
        # A fatal non-finite verdict held until the pod has heard it: a rank
        # must not raise while its peers enter the next collective step.
        fatal: list = []
        last: Dict[str, Any] = {"metrics": {}}

        def drain_flags(window: Optional[str] = "nonfinite_drain") -> str:
            """Fetch the pending steps' values in one copy (inside the
            `window` transfer window; None when the caller opened one),
            log each step's line and push its metrics, and feed its
            non-finite flag to the guard. A rollback verdict stops the
            observation: the rest of the window belongs to the timeline
            the rollback discards."""
            if not pending_flags:
                return "ok"
            window_steps = list(pending_flags)
            pending_flags.clear()
            with hygiene.transfer_window(window) if window else contextlib.nullcontext():
                fetched = fetch_steps(window_steps)
            t_fetched = time.perf_counter()
            for r, m in zip(window_steps, fetched):
                last["metrics"] = m
                logger.info("step %d: live_loss %.9g, grad_norm %.9g, epe %.6g, %.3f s", r.step, m["live_loss"],
                            m["grad_norm"], m["epe"], t_fetched - r.t0)
                bad = m["nonfinite"] > 0.0
                if bad:
                    tracer.event("nonfinite", step=r.step)
                verdict = guard.observe(bad, r.step)
                if metrics_logger is not None and primary:
                    extra = guard.stats()
                    loader_stats = getattr(data, "resilience_stats", None)
                    if loader_stats is not None:
                        extra.update(loader_stats())
                    metrics_logger.push(dict(m, **extra), r.step)
                if verdict == "rollback":
                    tracer.dump("nonfinite-rollback")
                    return "rollback"
            return "ok"

        def checked_drain(window: Optional[str] = "nonfinite_drain") -> str:
            """drain_flags, but under coordination a fatal verdict is parked
            for the pod instead of raised."""
            try:
                return drain_flags(window)
            except NonFiniteLossError as e:
                if not coord.active:
                    raise
                fatal.append(e)
                return "fatal"

        def pod_sync() -> bool:
            """One pod-agreement boundary: reduce the ranks' flags, adopt the
            pod verdict, enforce the global budget. Returns whether the pod
            agreed to stop."""
            nonlocal local_rollback, pod_rollback, fatal_synced
            t_sync0 = time.perf_counter()
            with hygiene.whitelist("coord_sync"):
                if checked_drain(window=None) == "rollback":
                    local_rollback = True
                decision = coord.sync(stop=pguard.stop_requested, nonfinite=bool(fatal), rollback=local_rollback,
                                      dropped=int(quarantine.dropped) if quarantine else 0,
                                      served=int(quarantine.served) if quarantine else 0)
            if fatal:
                fatal_synced = True
            tracer.span("coord-sync", t0=t_sync0, t1=time.perf_counter(), step=step)
            watchdog.beat(step)
            if decision.stop and not pguard.stop_requested:
                pod["peer_stop"] = True
            if decision.nonfinite and not fatal:
                fatal.append(NonFiniteLossError(f"non-finite divergence on a peer rank (pod-coordinated abort at "
                                                f"step {step})"))
                fatal_synced = True
            if decision.rollback:
                pod_rollback = True
            if quarantine is not None:
                quarantine.check_global(decision.dropped, decision.dropped + decision.served)
            return decision.stop

        def save_now(final: bool = False) -> None:
            watchdog.grant(cfg.watchdog_grace_s)
            watchdog.mark_phase("final-save" if final else "checkpoint-save")
            t_save0 = time.perf_counter()
            # The snapshot (device to host) is taken here, on the loop's
            # thread, inside the window; an async commit touches host copies.
            with hygiene.whitelist("checkpoint_save"):
                self.save(run_state=make_run_state(), wait=final)
            tracer.span("checkpoint-save", t0=t_save0, t1=time.perf_counter(), step=self.step, final=final)
            set_memory_gauges(registry)
            watchdog.mark_phase(None)

        if coord.active and not watchdog.enabled:
            logger.warning("multi-rank run with step_timeout_s=0: a rank that dies mid-collective will hang its "
                           "peers; set --step_timeout_s so the watchdog can end them")
        stop_cause = "completed"
        error_repr = None
        try:
            stopping = False
            local_rollback = False  # this rank's rollback wish, not yet pod-agreed
            pod_rollback = False    # pod-agreed rollback awaiting execution
            fatal_synced = False    # the pod has heard this rank's parked fatal
            pending_reseed = False  # a rollback is waiting on a fresh data epoch
            # DDP rebuilds its gradient buckets once, at its second forward,
            # and reads the new bucket order back from the device (a sync).
            # Done after the first step, in a window of its own, it leaves
            # every step sync-free; the second forward finds them built.
            ddp_buckets = isinstance(self._wrapped, torch.nn.parallel.DistributedDataParallel)
            with pguard if cfg.handle_signals else contextlib.nullcontext(), watchdog, hygiene.guard():
                if cfg.nan_policy == "rollback" and not list_checkpoint_steps(self.checkpoint_path()):
                    # Rollback needs a last good anchor before the first
                    # periodic save: the initial (or restored) state.
                    with hygiene.whitelist("checkpoint_save"):
                        self.save(run_state=make_run_state())
                    watchdog.beat(step)
                    watchdog.grant(cfg.watchdog_grace_s)
                while step < cfg.num_steps and not stopping:
                    epoch_batches = 0
                    boundary_t = time.perf_counter()
                    for batch in _until_stopped(data, pguard):
                        epoch_batches += 1
                        t_batch = time.perf_counter()
                        data_wait_hist.observe((t_batch - boundary_t) * 1e3)
                        tracer.span("data-wait", t0=boundary_t, t1=t_batch, step=step + 1)
                        pending_reseed = False
                        if profile_window and step == profile_window.start:
                            profile_ctx = trace(os.path.join(cfg.log_dir, rank_file("profile", rank)))
                            profile_ctx.__enter__()
                        pending_flags.append(self.dispatch_step(batch, t0=t_batch))
                        step = self.step
                        if ddp_buckets:
                            with hygiene.whitelist("ddp_buckets"):
                                self._wrapped.reducer._rebuild_buckets()
                            ddp_buckets = False
                        # Step boundary for the build monitor: raises
                        # RecompileError (strict mode) when a kernel was
                        # built outside a whitelist after the grace window.
                        hygiene.step(step)
                        if profile_ctx is not None and step >= profile_window.stop:
                            with hygiene.transfer_window("profile"):
                                profile_ctx.__exit__(None, None, None)
                            profile_ctx = None
                        sync_due = coord.active and (step % cfg.coord_interval == 0
                                                     or step % cfg.checkpoint_every == 0)
                        if len(pending_flags) >= cfg.nan_check_every and not sync_due:
                            if checked_drain() == "rollback":
                                local_rollback = True
                        # The step span ends after its drain when one fell
                        # on it (so it covers the device's work); otherwise
                        # at the dispatch, as JAX's does.
                        tick = timer.tick()
                        tracer.span("step", t0=t_batch, t1=time.perf_counter(), step=step)
                        steps_counter.inc()
                        if tick is not None:
                            step_hist.observe(tick * 1e3)
                        if step % cfg.checkpoint_every == 0:
                            if coord.active and pod_sync():
                                stopping = True
                            # Never checkpoint an unchecked non-finite window.
                            if not (local_rollback or pod_rollback or fatal) and checked_drain() == "rollback":
                                local_rollback = True
                            if not (local_rollback or pod_rollback or fatal):
                                save_now()
                                watchdog.beat(step)
                        if validate_fn is not None and step % cfg.validate_every == 0:
                            watchdog.grant(cfg.watchdog_grace_s)
                            watchdog.mark_phase("validation")
                            try:
                                # Validation builds kernels, fetches maps and
                                # syncs: legitimate here, never in the step.
                                with hygiene.whitelist("validation"):
                                    model = self._validation_model()
                                    if model is not None and (primary or self.sharding.banded):
                                        results = validate_fn(model)
                                        if primary:
                                            logger.info("validation (%d): %s", step, results)
                                            if metrics_logger is not None:
                                                metrics_logger.write(results, step)
                                    self._barrier(self._host_group)
                            finally:
                                watchdog.mark_phase(None)
                            watchdog.beat(step)
                        if pguard.stop_requested and not coord.active:
                            stopping = True
                        synced = False
                        if coord.active and step % cfg.coord_interval == 0:
                            if pod_sync():
                                stopping = True
                            synced = True
                        # A parked fatal raises once the pod has heard it.
                        if fatal and (fatal_synced or not coord.active):
                            raise fatal[0]
                        want_rollback = pod_rollback if coord.active else local_rollback
                        if want_rollback and (synced or not coord.active):
                            pod_rollback = local_rollback = False
                            if profile_ctx is not None:
                                with hygiene.transfer_window("profile"):
                                    profile_ctx.__exit__(None, None, None)
                                profile_ctx = None
                            profile_window = range(0)
                            with hygiene.whitelist("rollback"):
                                step = self.rollback()
                            watchdog.beat(step)
                            pending_reseed = True
                            logger.warning("rolled back to step %d after %d consecutive non-finite steps; "
                                           "re-seeding the data stream", step, cfg.nan_patience)
                            # A fresh iter(data): a loader derives its shuffle
                            # from the epoch counter.
                            break
                        watchdog.beat(step)
                        boundary_t = time.perf_counter()
                        if stopping or step >= cfg.num_steps:
                            break
                    if pguard.stop_requested and not coord.active:
                        break
                    if epoch_batches == 0:
                        if pending_reseed:
                            raise NonFiniteLossError(
                                "rollback could not re-seed the data stream (one-shot iterable exhausted); use a "
                                "re-iterable loader with nan_policy=rollback")
                        if step > start_step:
                            break  # a one-shot iterator ran out after progress
                        raise ValueError("data iterable yielded no batches (dataset smaller than one batch, or an "
                                         "exhausted generator was passed)")
                if profile_ctx is not None:
                    with hygiene.transfer_window("profile"):
                        profile_ctx.__exit__(None, None, None)
                # One final pod sync: every rank reaches this point at the
                # same pod-agreed boundary, and it settles what happened
                # after the last in-loop sync (a stop on one rank in the
                # final window still gives one verdict on every rank).
                if coord.active:
                    pod_sync()
                if fatal:
                    raise fatal[0]
                if local_rollback or pod_rollback:
                    raise NonFiniteLossError("non-finite streak triggered a rollback in the final coordination "
                                             "window; the run ended before it could execute — resume from the "
                                             "last good checkpoint")
                drain_flags()
                with hygiene.transfer_window("step_timing"):
                    stats = timer.report(self.device)
                if stats:
                    logger.info("step timing: %s", stats)
                if self.device.type == "cuda":
                    logger.info("peak device memory: %d bytes allocated, %d bytes reserved",
                                torch.cuda.max_memory_allocated(self.device),
                                torch.cuda.max_memory_reserved(self.device))
                if self._last_saved_step != self.step:
                    save_now(final=True)
                else:
                    # The cadence saved this step already: its (possibly
                    # async) commit must have landed, and cleanly.
                    watchdog.grant(cfg.watchdog_grace_s)
                    watchdog.mark_phase("final-save")
                    try:
                        self._committer.barrier()
                    finally:
                        watchdog.mark_phase(None)
                watchdog.beat(self.step)
            if pguard.stop_requested or pod["peer_stop"]:
                stop_cause = "preempted"
                logger.warning("training stopped by %s at step %d with a committed checkpoint; resume by rerunning "
                               "with --auto_resume (or --restore_ckpt %s)",
                               pguard.signame or "a peer rank's stop signal", self.step, self.checkpoint_path())
        except BaseException as e:
            if isinstance(e, NonFiniteLossError):
                stop_cause = "nonfinite"
            elif isinstance(e, FailureBudgetExceeded):
                stop_cause = "failure_budget"
            elif isinstance(e, KeyboardInterrupt):
                stop_cause = "preempted"
            else:
                stop_cause = "error"
            error_repr = repr(e)
            raise
        finally:
            try:
                # No commit outlives fit(). On the paths that return, the
                # final save joined it already; here an error is already
                # on its way out, and a failed commit is only logged.
                self._committer.barrier()
            except Exception:  # noqa: BLE001 - secondary to the error being raised
                logger.exception("async checkpoint commit failed")
            if not watchdog.fired:
                self.last_run_report = make_report(stop_cause, error=error_repr)
                rr.write_run_report(self.last_run_report, cfg.log_dir, report_name)
                tracer.dump(f"fit-exit:{stop_cause}")
            if metrics_server is not None:
                metrics_server.shutdown()
                metrics_server.server_close()
                metrics_server._serve_thread.join(timeout=5.0)
        return last["metrics"]
