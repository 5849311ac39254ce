"""Command-line entry point of the port: counterpart of `raft_stereo_tpu/cli.py`.

    python -m raft_stereo_tpu_torch train --train_datasets sceneflow --root_dataset datasets --auto_resume
    torchrun --standalone --nproc_per_node 8 -m raft_stereo_tpu_torch train --sharding_rules fsdp --batch_size 16
    python -m raft_stereo_tpu_torch evaluate --dataset middlebury_F --restore_ckpt raftstereo.pth
    python -m raft_stereo_tpu_torch evaluate --dataset eth3d --dry_run --device cpu
    python -m raft_stereo_tpu_torch demo --restore_ckpt checkpoints/raft-stereo/12/model.pth --root_dataset gated
    python -m raft_stereo_tpu_torch serve --corr_implementation pallas --fused_gru_tail --port 8080
    python -m raft_stereo_tpu_torch serve --reload_ckpt new.pth --port 8080
    python -m raft_stereo_tpu_torch serve --replicas 0 --auto_respawn --hang_timeout_s 30 --port 8080
    python -m raft_stereo_tpu_torch frontier --backends 127.0.0.1:8080 127.0.0.1:8090 --port 8081
    python -m raft_stereo_tpu_torch frontier --rollout new.pth --port 8081
    torchrun --standalone --nproc_per_node 2 -m raft_stereo_tpu_torch train --sharding_rules spatial --mesh_shape 1 2
    torchrun --standalone --nproc_per_node 4 -m raft_stereo_tpu_torch train --sharding_rules fsdp --mesh_shape 2 2
    python -m raft_stereo_tpu_torch fsck checkpoints/raft-stereo --quarantine
    python -m raft_stereo_tpu_torch check-report runs/run_report.json

Every subcommand takes the JAX CLI's flags, names and defaults, plus
`--device` (default "cuda"; "cpu" runs the kernels' plain versions, and only
when asked: nothing moves to the CPU when no card is found). As in the JAX
CLI, `--corr_dtype` defaults to bfloat16 only for `reg_cuda` with
`--mixed_precision`, and to float32 otherwise. `--corr_implementation alt`
(and `alt_cuda`, its alias) is the on-the-fly correlation in plain ops.

`train` reads a dataset in one of the reference's layouts
(`--train_datasets`, `--root_dataset`), trains with checkpoints under
checkpoints/<name>/<step>/ and writes metrics.jsonl, run_report.json and
flight_recorder.json under runs/, and exits 0 completed, 1 error, 2 usage,
13 preempted, 14 non-finite, 15 failure budget, 16 watchdog
(utils/run_report.py). Launched by `torchrun` (or `python -m
torch.distributed.run`), each process is one rank of a process group
(parallel/distributed.py: NCCL on the cards, gloo on the CPU),
`--mesh_shape D S` lays them on a (data, spatial) mesh that must cover
them all (else exit 2), and `--sharding_rules` picks how they share the
model: dp (DDP), fsdp (FSDP2 over the data axis), and on a spatial axis
above 1 (under every preset) row bands of each image (parallel/spatial.py;
the crop height must divide by S x 2**n_downsample), with fsdp's shards
the same on every rank of a spatial group. `--batch_size` is one host's
batch, split over the host's data groups; each data group reads its own stride of the
data, and the S ranks of a spatial group read the same samples and each
keeps its band of rows. Rank k > 0 writes run_report.p<k>.json and
flight_recorder.p<k>.json beside rank 0's files. `torchrun` turns any
non-zero exit of a rank into its own failure code: read each rank's run
report (or exit code, when the ranks are started directly) for `train`'s.
`--explain_sharding` prints every parameter's placement and exits without
training. The JAX flags of what the port does not run yet exit 2:
`--strict_mode`, `--recompile_grace` other than 2 and
`--compilation_cache_dir`.

`serve` boots a `StereoService`, warms every (bucket, batch) and serves the
HTTP front until SIGTERM or Ctrl-C, which drain the backlog and exit 0;
`--warmup_only` boots, warms, prints the boot block and exits 0;
`--reload_ckpt PATH` is the client of a running server's POST /reload.
`--replicas N` serves a fleet of N engines, one per card (0: every card;
more than the cards, or any fleet off the card, exits 2), and
`--auto_respawn` replaces a replica whose breaker sticks failed (it needs
two replicas or more). `--sharding_rules spatial|dp+spatial|fsdp` serves
row bands across every visible card from one process (serving/engine.py,
JAX's (1, n) mesh), and on the plain engine with one visible card (or `--device
cpu`), as JAX's engine does on one device; /healthz's `sharding` says
which. With `--replicas` other than 1 it exits 2 (JAX's `--replicas`
requires dp). The AOT-cache and audit
flags (`--aot_cache_dir`, `--require_cache_hit`, `--audit`) are not
ported yet and exit 2.

`fsck ROOT [--quarantine]` and `check-report PATH [--selftest]` are the
JAX package's `scripts/fsck_checkpoints.py` and
`scripts/check_run_report.py` (utils/fsck.py, utils/check_report.py): the
same JSON verdicts and exit codes (0 valid, 1 invalid, 2 usage or I/O).

`frontier` routes POST /v1/predict across `serve` backends
(serving/frontier.py; it imports no torch); `frontier --rollout CKPT` is
the client of a running frontier's POST /rollout, with the admin exit
codes below. `train`, `evaluate` and `demo` log the kernels' launch counts
of the process when they finish.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional

from raft_stereo_tpu_torch.config import (
    MODALITIES,
    SHARDING_PRESETS,
    UNPORTED_TRAIN_DEFAULTS,
    AugmentConfig,
    RAFTStereoConfig,
    TrainConfig,
)

SUBCOMMANDS = ("train", "evaluate", "demo", "serve", "frontier", "fsck", "check-report")


def _add_model_args(p: argparse.ArgumentParser):
    """Architecture flags (the reference's flag table)."""
    p.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    p.add_argument(
        "--corr_implementation",
        choices=["reg", "alt", "pallas", "reg_cuda", "alt_cuda"],
        default="reg",
        help="'pallas' is the hand-written CUDA lookup (the reference's reg_cuda role; "
        "reg_cuda is accepted as its alias); 'alt' samples features on the fly with plain ops "
        "(alt_cuda is its alias)",
    )
    p.add_argument("--corr_levels", type=int, default=4)
    p.add_argument("--corr_radius", type=int, default=4)
    p.add_argument("--n_downsample", type=int, default=2)
    p.add_argument("--n_gru_layers", type=int, default=3)
    p.add_argument("--slow_fast_gru", action="store_true")
    p.add_argument("--shared_backbone", action="store_true",
                   help="one trunk for the context and feature encoders (the realtime model)")
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute in the encoders and the update block (test-mode forwards)")
    p.add_argument(
        "--corr_dtype", choices=["float32", "bfloat16"], default=None,
        help="storage dtype of the correlation pyramid (default: bfloat16 for reg_cuda with "
        "--mixed_precision, else float32)",
    )
    p.add_argument("--data_modality", choices=list(MODALITIES), default="RGB")
    p.add_argument(
        "--fused_encoder", action="store_true",
        help="fused encoder prelude kernels (pyramid build, layer1 conv, join) for "
        "test-mode forwards",
    )
    p.add_argument(
        "--prefetch_lookup", action="store_true",
        help="windowed correlation lookup kernel for test-mode forwards ('pallas' only; "
        "bit-identical to the dense one)",
    )
    p.add_argument(
        "--fused_gru_tail", action="store_true",
        help="fused ConvGRU gate-tail and motion-concat kernels for test-mode forwards",
    )


# The reference's CUDA corr implementations map onto the port's: reg_cuda ->
# pallas (the hand-written lookup kernel); alt_cuda -> alt (plain ops, as
# the JAX package maps it).
_CORR_ALIASES = {"reg_cuda": "pallas", "alt_cuda": "alt"}

# Dataset-specific subdir under a parent --root_dataset dir, mirroring the
# validators' own defaults ("datasets/ETH3D" etc., evaluate.py) so train and
# evaluate share one --root_dataset meaning.
_DATASET_SUBDIR = {
    "eth3d": "ETH3D",
    "kitti": "KITTI",
    "things": "",
    "middlebury_F": "Middlebury",
    "middlebury_H": "Middlebury",
    "middlebury_Q": "Middlebury",
}


def _dataset_root(parent: str, dataset: str) -> str:
    return os.path.join(parent, _DATASET_SUBDIR.get(dataset, ""))


def _cuda_flags(device: str) -> None:
    """Process-wide numerics on the card, set once: no TF32."""
    if device.startswith("cuda"):
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from raft_stereo_tpu_torch.ops import corr_cuda, encoder_cuda, gates, gru_tail

    return {**corr_cuda.LAUNCHES, **gru_tail.LAUNCHES, **encoder_cuda.LAUNCHES, **gates.LAUNCHES}


def _log_launches(command: str) -> None:
    logging.getLogger(__name__).info("%s kernel launches: %s", command, json.dumps(launch_counts(), sort_keys=True))


def _model_config(args) -> RAFTStereoConfig:
    """The port's config from the model flags."""
    corr = _CORR_ALIASES.get(args.corr_implementation, args.corr_implementation)
    corr_dtype = args.corr_dtype
    if corr_dtype is None:
        # The JAX CLI's rule: reg_cuda's role is the reference's fp16 volume
        # under AMP, so a bf16 pyramid only for reg_cuda with mixed precision.
        corr_dtype = "bfloat16" if args.corr_implementation == "reg_cuda" and args.mixed_precision else "float32"
    return RAFTStereoConfig(
        hidden_dims=tuple(args.hidden_dims),
        corr_implementation=corr,
        mixed_precision=args.mixed_precision,
        corr_dtype=corr_dtype,
        corr_levels=args.corr_levels,
        corr_radius=args.corr_radius,
        n_downsample=args.n_downsample,
        n_gru_layers=args.n_gru_layers,
        slow_fast_gru=args.slow_fast_gru,
        shared_backbone=args.shared_backbone,
        data_modality=args.data_modality,
        fused_encoder=args.fused_encoder,
        prefetch_lookup=args.prefetch_lookup,
        fused_gru_tail=args.fused_gru_tail,
    )


def cmd_evaluate(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="evaluate")
    p.add_argument("--restore_ckpt", default=None, help="the reference's .pth state dict")
    p.add_argument(
        "--dataset",
        required=True,
        choices=["eth3d", "kitti", "things"] + [f"middlebury_{s}" for s in "FHQ"],
    )
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument(
        "--root_dataset", default=None,
        help="parent datasets directory (same semantics as train: the dataset-specific subdir, e.g. "
        "ETH3D/, is appended)",
    )
    p.add_argument(
        "--pad_bucket", type=int, default=0,
        help="round padded eval shapes up to a multiple of this (0 = exact reference "
        "padding to a multiple of 32)",
    )
    p.add_argument(
        "--dry_run", action="store_true",
        help="run the full evaluate path (checkpoint load, validator loop, padding, "
        "forward, metric math) on a tiny synthetic dataset instead of downloaded data",
    )
    p.add_argument("--device", default="cuda", help="torch device of the model (default: the card)")
    _add_model_args(p)
    args = p.parse_args(argv)
    config = _model_config(args)

    from raft_stereo_tpu_torch.evaluate import VALIDATORS, Evaluator, SyntheticEvalDataset
    from raft_stereo_tpu_torch.models.init import build_model
    from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

    _cuda_flags(args.device)
    model = build_model(config, seed=0, device="cpu")
    if args.restore_ckpt is not None:
        load_reference_checkpoint(model, args.restore_ckpt)
    model = model.to(args.device)
    n_params = sum(p_.numel() for p_ in model.parameters())
    print(f"The model has {n_params/1e6:.2f}M learnable parameters.")

    evaluator = Evaluator(model, iters=args.valid_iters, pad_bucket=args.pad_bucket)
    kwargs = {}
    if args.dry_run:
        kwargs["dataset"] = SyntheticEvalDataset(channels=config.in_channels)
    elif args.root_dataset:
        kwargs["root"] = _dataset_root(args.root_dataset, args.dataset)
    VALIDATORS[args.dataset](evaluator, **kwargs)
    _log_launches("evaluate")
    return 0


# --- train ---------------------------------------------------------------------

def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="train")
    p.add_argument("--name", default="raft-stereo")
    p.add_argument("--restore_ckpt", default=None,
                   help="warm start: a reference .pth (weights only), or a checkpoint root or step directory")
    p.add_argument("--auto_resume", action="store_true",
                   help="at startup, restore the newest checkpoint of this run (checkpoints/<name>) whose "
                   "integrity manifest verifies, walking past and quarantining torn steps, with the full run "
                   "state; with no checkpoints the run starts fresh, so rerunning the same command is always "
                   "the recovery")
    p.add_argument("--checkpoint_every", type=int, default=500,
                   help="checkpoint cadence in steps (the reference saves every 500)")
    p.add_argument("--max_to_keep", type=int, default=5, help="checkpoint retention: keep the newest N steps")
    p.add_argument("--keep_period", type=int, default=None,
                   help="additionally keep every checkpoint whose step is divisible by this")
    p.add_argument("--batch_size", type=int, default=6,
                   help="one host's batch, as in the JAX CLI (a JAX process is a whole host): split over the "
                   "host's ranks (LOCAL_WORLD_SIZE), so the global batch is this times the number of hosts")
    p.add_argument("--train_datasets", nargs="+", default=["sceneflow"])
    p.add_argument("--root_dataset", default=None)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--num_steps", type=int, default=100_000)
    p.add_argument("--image_size", type=int, nargs="+", default=[320, 720])
    p.add_argument("--train_iters", type=int, default=16)
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--valid_datasets", nargs="+", default=[],
                   choices=["eth3d", "kitti", "things", "middlebury_F", "middlebury_H", "middlebury_Q"],
                   help="run these validators every --validate_every steps during training")
    p.add_argument("--validate_every", type=int, default=500, help="in-training validation cadence")
    p.add_argument("--valid_pad_bucket", type=int, default=64,
                   help="shape-bucket padding for in-training validation (multiple of 32; 0 = exact "
                   "reference padding)")
    p.add_argument("--wdecay", type=float, default=1e-5)
    p.add_argument("--mesh_shape", type=int, nargs=2, default=[-1, 1],
                   help="(data, spatial) mesh over the ranks; -1 infers the data axis from the world size. The "
                   "mesh must cover every rank (else exit 2); a spatial axis above 1 splits image rows into bands "
                   "(the crop height must divide by spatial x 2**n_downsample)")
    p.add_argument("--sharding_rules", choices=list(SHARDING_PRESETS), default="dp",
                   help="dp: DistributedDataParallel; fsdp: FSDP2, conv weights and their AdamW moments sharded "
                   "over the data axis; on a spatial axis above 1 every preset runs row bands over it, halos and "
                   "cross-band norm sums exchanged (parameters whole, or under fsdp sharded over data as above)")
    p.add_argument("--explain_sharding", action="store_true",
                   help="print every parameter's placement decision under the preset and mesh, then exit "
                   "without training")
    p.add_argument("--num_workers", type=int, default=int(os.environ.get("SLURM_CPUS_PER_TASK", 6)) - 2)
    p.add_argument("--worker_type", choices=["thread", "process"], default="thread",
                   help="'process' scales augmentation past the GIL on many-core hosts")
    # augmentation (reference train_stereo.py:267-271)
    p.add_argument("--img_gamma", type=float, nargs="+", default=None)
    p.add_argument("--saturation_range", type=float, nargs="+", default=None)
    p.add_argument("--do_flip", default=None, choices=["h", "hf", "v"])
    p.add_argument("--spatial_scale", type=float, nargs="+", default=[0, 0])
    p.add_argument("--noyjitter", action="store_true")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler Chrome trace of N steps after warm-up to runs/profile")
    # resilience (utils/resilience.py)
    p.add_argument("--nan_policy", choices=["raise", "skip", "rollback"], default="raise",
                   help="non-finite loss/grad policy: fail fast, skip the poisoned update, or roll back to the "
                   "last good checkpoint after --nan_patience consecutive bad steps")
    p.add_argument("--nan_patience", type=int, default=10,
                   help="consecutive non-finite steps before skip escalates / rollback restores")
    p.add_argument("--nan_check_every", type=int, default=None,
                   help="host-side non-finite detection cadence in steps (default 1)")
    p.add_argument("--coord_interval", type=int, default=None,
                   help="steps between the ranks' agreements on stop, abort, rollback and the failure budget "
                   "(default: --nan_check_every)")
    p.add_argument("--step_timeout_s", type=float, default=0.0,
                   help="step watchdog: a step boundary stalled this long dumps all stacks, writes "
                   "run_report.json and exits 16 (0 disables)")
    p.add_argument("--watchdog_grace_s", type=float, default=300.0,
                   help="extra watchdog allowance for the first step (kernel builds)")
    p.add_argument("--io_retries", type=int, default=3,
                   help="retry attempts for transient checkpoint/dataset I/O failures")
    p.add_argument("--sample_policy", choices=["raise", "quarantine"], default="quarantine",
                   help="loader reaction to a sample that keeps failing decode")
    p.add_argument("--sample_retries", type=int, default=2, help="decode retries per sample before quarantine")
    p.add_argument("--failure_budget", type=float, default=0.05,
                   help="hard-fail once this fraction of attempted samples has been dropped")
    p.add_argument("--no_signal_handlers", action="store_true",
                   help="disable graceful SIGTERM/SIGINT preemption handling")
    p.add_argument("--strict_mode", action="store_true", help="not ported yet (exits 2)")
    p.add_argument("--recompile_grace", type=int, default=2, help="not ported yet: values other than 2 exit 2")
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write and commit checkpoints on a background thread (the snapshot stays on the step; "
                   "one commit in flight)")
    p.add_argument("--device_prefetch", action="store_true",
                   help="copy batch N+1 to the card on a side stream while step N runs")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="serve Prometheus /metrics of the training loop on this port (rank 0; 0 disables)")
    p.add_argument("--flight_recorder_events", type=int, default=256,
                   help="flight-recorder ring capacity (runs/flight_recorder.json on every exit; 0 disables)")
    p.add_argument("--compilation_cache_dir", default=None, metavar="DIR", help="not ported yet (exits 2)")
    p.add_argument("--device", default="cuda", help="torch device of the model (default: the card)")
    _add_model_args(p)
    return p


def maybe_resume(trainer, config) -> Optional[int]:
    """Startup restore policy: `--auto_resume` first (this run's own newest
    valid checkpoint), then `--restore_ckpt` (a warm start: a reference
    `.pth` gives weights only; a checkpoint path gives the full train state,
    with the run state only when it lies in this run's own root). A fresh
    auto-resume falls through to restore_ckpt. Returns the restored step,
    or None when starting from scratch."""
    if config.auto_resume:
        step = trainer.auto_resume()
        if step is not None:
            return step
    if config.restore_ckpt:
        if config.restore_ckpt.endswith(".pth"):
            trainer.restore_torch(config.restore_ckpt)
            return None  # weights only; the step counter starts at 0
        return trainer.restore(path=config.restore_ckpt)
    return None


def run_training(trainer, loader, metrics_logger=None, validate_fn=None) -> int:
    """Drive trainer.fit and translate its outcome into the documented exit
    code (utils/run_report.py EXIT_CODES). The trainer writes
    run_report.json on every exit path before this mapping runs; a
    watchdog timeout never reaches here (the monitor thread exits 16)."""
    import traceback

    from raft_stereo_tpu_torch.utils import run_report as rr
    from raft_stereo_tpu_torch.utils.resilience import FailureBudgetExceeded, NonFiniteLossError

    try:
        trainer.fit(loader, metrics_logger=metrics_logger, validate_fn=validate_fn)
    except (NonFiniteLossError, FailureBudgetExceeded, KeyboardInterrupt) as e:
        logging.getLogger(__name__).error("training aborted: %r\n%s", e, traceback.format_exc())
        report = getattr(trainer, "last_run_report", None) or {}
        return int(report.get("exit_code", rr.EXIT_ERROR))
    report = trainer.last_run_report
    return rr.EXIT_PREEMPTED if report.get("preempted") else rr.EXIT_OK


def _unported_train_flags(args) -> List[str]:
    given = {"strict_mode": args.strict_mode, "recompile_grace": args.recompile_grace,
             "compilation_cache_dir": args.compilation_cache_dir}
    return [f"--{k} {v}" for k, v in given.items() if v != UNPORTED_TRAIN_DEFAULTS[k]]


def cmd_train(argv: List[str]) -> int:
    args = _train_parser().parse_args(argv)

    from raft_stereo_tpu_torch.utils import run_report as rr

    unported = _unported_train_flags(args)
    if unported:
        print(f"train: not ported yet: {', '.join(unported)}", file=sys.stderr)
        return rr.EXIT_USAGE
    try:
        config = _train_config_from_args(args)
    except Exception as e:
        # A config that fails validation still leaves a run_report.json, in
        # the default log dir (the config never materialized).
        logging.getLogger(__name__).exception("invalid training configuration")
        default_log_dir = TrainConfig.__dataclass_fields__["log_dir"].default
        rr.write_run_report(rr.build_run_report(stop_cause="error", final_step=-1, error=repr(e)), default_log_dir)
        return rr.EXIT_ERROR
    from raft_stereo_tpu_torch.parallel import distributed

    import torch

    distributed.init_multihost(device=torch.device(args.device).type)
    try:
        from raft_stereo_tpu_torch.parallel.mesh import make_mesh

        try:
            make_mesh(config.mesh_shape)
        except ValueError as e:
            print(f"train: {e}", file=sys.stderr)
            return rr.EXIT_USAGE
        if args.explain_sharding:
            # Dry run: build the trainer and print every parameter's
            # placement, touching no dataset and no checkpoint.
            from raft_stereo_tpu_torch.train.trainer import Trainer

            h, w = config.augment.crop_size
            print(Trainer(config, sample_shape=(h, w, config.model.in_channels), device=args.device)
                  .explain_sharding())
            return 0
        code = _run_train(args, config)
        _log_launches("train")
        return code
    finally:
        distributed.shutdown()


def _train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        model=_model_config(args),
        augment=AugmentConfig(
            crop_size=tuple(args.image_size),
            min_scale=args.spatial_scale[0],
            max_scale=args.spatial_scale[1],
            do_flip=args.do_flip,
            yjitter=not args.noyjitter,
            saturation_range=tuple(args.saturation_range) if args.saturation_range else None,
            img_gamma=tuple(args.img_gamma) if args.img_gamma else None,
        ),
        name=args.name,
        batch_size=args.batch_size,
        train_datasets=tuple(args.train_datasets),
        lr=args.lr,
        num_steps=args.num_steps,
        train_iters=args.train_iters,
        valid_iters=args.valid_iters,
        wdecay=args.wdecay,
        restore_ckpt=args.restore_ckpt,
        auto_resume=args.auto_resume,
        checkpoint_every=args.checkpoint_every,
        max_to_keep=args.max_to_keep,
        keep_period=args.keep_period,
        root_dataset=args.root_dataset,
        mesh_shape=tuple(args.mesh_shape),
        sharding_rules=args.sharding_rules,
        num_workers=args.num_workers,
        worker_type=args.worker_type,
        profile_steps=args.profile_steps,
        validate_every=args.validate_every,
        nan_policy=args.nan_policy,
        nan_patience=args.nan_patience,
        nan_check_every=args.nan_check_every,
        coord_interval=args.coord_interval,
        step_timeout_s=args.step_timeout_s,
        watchdog_grace_s=args.watchdog_grace_s,
        io_retries=args.io_retries,
        sample_policy=args.sample_policy,
        sample_retries=args.sample_retries,
        failure_budget=args.failure_budget,
        handle_signals=not args.no_signal_handlers,
        strict_mode=args.strict_mode,
        recompile_grace=args.recompile_grace,
        async_checkpoint=args.async_checkpoint,
        device_prefetch=args.device_prefetch,
        metrics_port=args.metrics_port,
        flight_recorder_events=args.flight_recorder_events,
        compilation_cache_dir=args.compilation_cache_dir,
    )


def _run_train(args, config: TrainConfig) -> int:
    from raft_stereo_tpu_torch.utils import run_report as rr

    log = logging.getLogger(__name__)
    try:
        from raft_stereo_tpu_torch.data import native_io
        from raft_stereo_tpu_torch.data.datasets import build_training_dataset
        from raft_stereo_tpu_torch.data.loader import DataLoader
        from raft_stereo_tpu_torch.parallel.distributed import host_shard_args, topology
        from raft_stereo_tpu_torch.parallel.mesh import make_mesh
        from raft_stereo_tpu_torch.train.trainer import Trainer, rank_batch_size
        from raft_stereo_tpu_torch.utils.metrics import MetricsLogger

        _cuda_flags(args.device)
        log.info("PNG decoder: %s", "native" if native_io.available()
                 else f"stdlib codec (native IO core unavailable: {native_io.unavailable_reason})")
        dataset = build_training_dataset(config, config.model.data_modality)
        loader = DataLoader(
            dataset,
            rank_batch_size(config.batch_size, topology()["local_world_size"],
                            make_mesh(config.mesh_shape).spatial),
            **host_shard_args(config.mesh_shape),
            seed=config.seed,
            num_workers=config.num_workers,
            worker_type=config.worker_type,
            sample_policy=config.sample_policy,
            sample_retries=config.sample_retries,
            failure_budget=config.failure_budget,
        )
        h, w = config.augment.crop_size
        trainer = Trainer(config, sample_shape=(h, w, config.model.in_channels), device=args.device)
        maybe_resume(trainer, config)
        validate_fn = None
        if args.valid_datasets:
            from raft_stereo_tpu_torch.evaluate import make_validation_fn

            vkw = ({name: {"root": _dataset_root(args.root_dataset, name)} for name in args.valid_datasets}
                   if args.root_dataset else None)
            validate_fn = make_validation_fn(config.model, args.valid_datasets, iters=config.valid_iters,
                                             validator_kwargs=vkw, pad_bucket=args.valid_pad_bucket)
    except Exception as e:
        # A failure before the trainer exists (bad dataset path, checkpoint
        # mismatch) still leaves a run report for the orchestrator.
        log.exception("training setup failed")
        from raft_stereo_tpu_torch.parallel.distributed import process_topology
        from raft_stereo_tpu_torch.train.trainer import rank_file

        rank, count = process_topology()
        rr.write_run_report(rr.build_run_report(stop_cause="error", final_step=-1, error=repr(e),
                                                process_index=rank, process_count=count),
                            config.log_dir, rank_file(rr.RUN_REPORT_NAME, rank))
        return rr.EXIT_ERROR
    try:
        return run_training(trainer, loader,
                            metrics_logger=MetricsLogger(log_every=config.log_every, log_dir=config.log_dir),
                            validate_fn=validate_fn)
    except Exception:
        log.exception("training failed")
        return rr.EXIT_ERROR
    finally:
        loader.close()


# --- demo ----------------------------------------------------------------------

def cmd_demo(argv: List[str]) -> int:
    from raft_stereo_tpu_torch.demo import add_demo_args, run_demo

    p = argparse.ArgumentParser(prog="demo")
    add_demo_args(p)
    _add_model_args(p)
    args = p.parse_args(argv)
    config = _model_config(args)

    from raft_stereo_tpu_torch.models.init import build_model
    from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

    _cuda_flags(args.device)
    model = build_model(config, seed=0, device="cpu")
    load_reference_checkpoint(model, args.restore_ckpt)
    code = run_demo(args, model.to(args.device))
    _log_launches("demo")
    return code


# Exit codes of the admin clients (`serve --reload_ckpt`, `frontier
# --rollout`), as in the JAX CLI: 0 done; 1 the server answered an error;
# 3 refused (409: checkpoint mismatch, a rollout already running, a mixed
# fleet); 4 unreachable; 5 no response within the timeout; 6 not JSON.
EXIT_ADMIN_HTTP_ERROR = 1
EXIT_ADMIN_REFUSED = 3
EXIT_ADMIN_UNREACHABLE = 4
EXIT_ADMIN_TIMEOUT = 5
EXIT_ADMIN_BAD_BODY = 6


def _admin_post_client(url: str, payload: dict, what: str, timeout_s: float) -> int:
    """POST to a running server's admin endpoint and report the outcome:
    every failure mode has its own exit code and a one-line message."""
    from raft_stereo_tpu_torch.utils.http import request_json

    try:
        resp = request_json(url, method="POST", payload=payload, timeout_s=timeout_s)
    except TimeoutError as exc:
        # Before ConnectionError/OSError: TimeoutError subclasses OSError.
        print(f"{what}: no response from {url} within {timeout_s:.0f}s ({exc}) — the server may still be "
              "applying it; check /healthz before retrying", file=sys.stderr)
        return EXIT_ADMIN_TIMEOUT
    except (ConnectionError, OSError) as exc:
        print(f"{what}: cannot reach {url} ({exc}) — is the server running?", file=sys.stderr)
        return EXIT_ADMIN_UNREACHABLE
    try:
        body = resp.json()
        if not isinstance(body, dict):
            raise ValueError("response is not a JSON object")
    except Exception as exc:  # noqa: BLE001 - any decode failure
        print(f"{what}: {url} answered status {resp.status} with a non-JSON body ({exc}): "
              f"{resp.body[:200]!r}", file=sys.stderr)
        return EXIT_ADMIN_BAD_BODY
    rendered = json.dumps(body, indent=2, sort_keys=True)
    if resp.ok:
        print(rendered)
        return 0
    print(f"{what}: {url} answered {resp.status}", file=sys.stderr)
    print(rendered, file=sys.stderr)
    return EXIT_ADMIN_REFUSED if resp.status == 409 else EXIT_ADMIN_HTTP_ERROR


def _reload_checkpoint_client(host: str, port: int, ckpt: str, timeout_s: float = 600.0) -> int:
    """`serve --reload_ckpt PATH`: ask a running server to hot-swap its
    weights through POST /reload (the path is read by the server)."""
    return _admin_post_client(f"http://{host}:{port}/reload", {"checkpoint": ckpt}, "reload", timeout_s)


def _resolve_replicas(replicas: int, device: str):
    """(replicas, None), or (replicas, the reason to exit 2): 0 means every
    card; a fleet (more than one replica) needs that many cards and runs
    only on them."""
    if replicas < 0:
        return replicas, f"--replicas must be >= 0, got {replicas}"
    if replicas == 1:
        return 1, None
    if not device.startswith("cuda"):
        return replicas, f"--replicas {replicas} counts cards; a fleet does not run on --device {device}"
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if replicas == 0:
        return cards, None if cards else "--replicas 0 found no card"
    if replicas > cards:
        return replicas, f"--replicas {replicas} exceeds the {cards} visible card(s): a replica is one card"
    return replicas, None


def _spatial_serving_problem(rules: str, replicas: int) -> Optional[str]:
    """None when a preset other than dp (spatial, dp+spatial or fsdp) can
    be served: JAX maps each to a (1, n) row-band mesh over the n visible
    devices (the banded engine, serving/engine.py) and serves unsharded on
    one. As in JAX, `--replicas` requires dp."""
    if replicas != 1:
        return (f"--sharding_rules {rules} with --replicas {replicas}: replicas require --sharding_rules dp "
                "(a spatial preset serves one engine whose row bands span the visible cards)")
    return None


def _rollout_client(host: str, port: int, ckpt: str, rollback_ckpt: Optional[str], force: bool,
                    timeout_s: float = 3600.0) -> int:
    """`frontier --rollout PATH`: drive a running frontier's POST /rollout
    and report the rollout record. The call returns when the whole walk
    (or its rollback) ends, hence the long timeout."""
    payload: dict = {"checkpoint": ckpt}
    if rollback_ckpt is not None:
        payload["rollback_checkpoint"] = rollback_ckpt
    if force:
        payload["force"] = True
    return _admin_post_client(f"http://{host}:{port}/rollout", payload, "rollout", timeout_s)


def cmd_serve(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--restore_ckpt", default=None, help="the reference's .pth state dict")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--buckets", nargs="+", default=["384x512", "512x768"],
                   help="padded HxW shape buckets (each dim a multiple of 32); requests are admitted into "
                   "the smallest bucket that fits, larger inputs are rejected with 413")
    p.add_argument("--max_batch", type=int, default=4,
                   help="micro-batch ceiling; batch sizes 1,2,...,max_batch (powers of two) are warmed per bucket")
    p.add_argument("--chunk_iters", type=int, default=4,
                   help="GRU iterations per chunk — the deadline-check granularity")
    p.add_argument("--max_iters", type=int, default=32,
                   help="refinement budget when no deadline intervenes (rounded up to whole chunks)")
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="default per-request deadline (0 disables; requests can override per call)")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="how long a partial batch waits for company before dispatching")
    p.add_argument("--device", default="cuda", help="torch device of the model (default: the card)")
    p.add_argument("--warmup_only", action="store_true",
                   help="warm every (bucket, batch), print the boot summary, and exit")
    p.add_argument("--stream", action="store_true",
                   help="enable video stream sessions: POST bodies with a \"stream_id\" carry the previous "
                   "frame's disparity and warm-start refinement")
    p.add_argument("--stream_warm_iters", type=int, default=8,
                   help="refinement budget for warm-started stream frames (cold frames use --max_iters)")
    p.add_argument("--stream_reset_ratio", type=float, default=2.5,
                   help="scene-cut gate: reset when the carried flow's warp error on the new frame exceeds "
                   "this ratio x the error it reached on its own frame")
    p.add_argument("--stream_reset_floor", type=float, default=4.0,
                   help="absolute warp-error floor (mean |I1-warp(I2)| in [0,255] units) below which the "
                   "gate never resets")
    p.add_argument("--max_streams", type=int, default=1024,
                   help="live stream-session ceiling (LRU eviction beyond it)")
    p.add_argument("--breaker_degrade_after", type=int, default=2,
                   help="consecutive batch failures before the state drops to 'degraded' (still admitting)")
    p.add_argument("--breaker_fail_after", type=int, default=5,
                   help="consecutive batch failures that trip the breaker to 'failed': submits shed with 503 "
                   "until a checkpoint swap or restart")
    p.add_argument("--breaker_probation", type=int, default=2,
                   help="consecutive successes a degraded service needs to read 'healthy' again")
    p.add_argument("--hang_timeout_s", type=float, default=0.0,
                   help="per-batch hang watchdog: a chunk with no heartbeat for this long dumps all stacks and "
                   "marks the service 'failed' (0 disables)")
    p.add_argument("--drain_timeout_s", type=float, default=30.0,
                   help="graceful-shutdown budget: how long drain waits for queued and running requests")
    p.add_argument("--log_dir", default=None,
                   help="directory of <log_dir>/flight_recorder.json, dumped on breaker moves, watchdog fires "
                   "and shutdown (unset = no dumps)")
    p.add_argument("--flight_recorder_events", type=int, default=512,
                   help="flight-recorder ring capacity (0 disables recording)")
    p.add_argument("--reload_ckpt", default=None, metavar="PATH",
                   help="client mode: POST {\"checkpoint\": PATH} to http://HOST:PORT/reload on a running "
                   "server, print the response, and exit — no service is booted")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas, one per card: each holds its own weights, breaker and watchdog (a "
                   "failed or hung replica's batch is requeued onto another, and POST /reload rolls the replicas "
                   "one at a time); 0 = every card; 1 keeps the single engine")
    p.add_argument("--auto_respawn", action="store_true",
                   help="fleet self-healing: replace a replica whose breaker sticks 'failed' with a fresh engine "
                   "on the same card, validated and in probation (requires --replicas >= 2)")
    p.add_argument("--sharding_rules", choices=list(SHARDING_PRESETS), default="dp",
                   help="every preset but dp splits image rows over the visible cards (JAX's (1, n) mesh): one engine, "
                   "a band of rows per card, halos and norm sums exchanged card to card; with one visible card "
                   "(or --device cpu) the plain engine serves; /healthz's sharding says which. --replicas "
                   "requires dp")
    # The JAX CLI's flags the port does not have yet: refused, never ignored.
    p.add_argument("--aot_cache_dir", default=None, help="not ported yet (exits 2)")
    p.add_argument("--require_cache_hit", action="store_true", help="not ported yet (exits 2)")
    p.add_argument("--audit", action="store_true", help="not ported yet (exits 2)")
    _add_model_args(p)
    args = p.parse_args(argv)

    unported = [flag for flag, given in (
        ("--aot_cache_dir", args.aot_cache_dir is not None),
        ("--require_cache_hit", args.require_cache_hit),
        ("--audit", args.audit),
    ) if given]
    if unported:
        print(f"serve: not ported yet: {', '.join(unported)}", file=sys.stderr)
        return 2
    if args.reload_ckpt is not None:
        return _reload_checkpoint_client(args.host, args.port, args.reload_ckpt)
    try:
        buckets = tuple(tuple(int(d) for d in b.lower().split("x")) for b in args.buckets)
    except ValueError:
        print(f"--buckets must look like 384x512, got {args.buckets}", file=sys.stderr)
        return 2
    replicas, problem = _resolve_replicas(args.replicas, args.device)
    if args.sharding_rules != "dp":
        problem = _spatial_serving_problem(args.sharding_rules, args.replicas) or problem
    if problem is None and args.auto_respawn and replicas < 2:
        problem = "--auto_respawn requires replicas >= 2 (it replaces one replica while the others serve)"
    if problem is not None:
        print(f"serve: {problem}", file=sys.stderr)
        return 2

    from raft_stereo_tpu_torch.config import ServeConfig, VideoConfig
    from raft_stereo_tpu_torch.serving.service import StereoService, serve_http

    video = None
    if args.stream:
        video = VideoConfig(
            chunk_iters=args.chunk_iters,
            cold_iters=args.max_iters,
            warm_iters=min(args.stream_warm_iters, args.max_iters),
            reset_error_ratio=args.stream_reset_ratio,
            reset_error_floor=args.stream_reset_floor,
        )
    config = ServeConfig(
        model=_model_config(args),
        buckets=buckets,
        max_batch=args.max_batch,
        chunk_iters=args.chunk_iters,
        max_iters=args.max_iters,
        deadline_ms=args.deadline_ms,
        batch_window_ms=args.batch_window_ms,
        host=args.host,
        port=args.port,
        restore_ckpt=args.restore_ckpt,
        video=video,
        max_streams=args.max_streams,
        breaker_degrade_after=args.breaker_degrade_after,
        breaker_fail_after=args.breaker_fail_after,
        breaker_probation=args.breaker_probation,
        hang_timeout_s=args.hang_timeout_s,
        replicas=replicas,
        sharding_rules=args.sharding_rules,
        auto_respawn=args.auto_respawn,
        drain_timeout_s=args.drain_timeout_s,
        log_dir=args.log_dir,
        flight_recorder_events=args.flight_recorder_events,
    )
    _cuda_flags(args.device)  # process-wide, set once at boot, never per request
    service = StereoService(config, device=args.device).start()
    print(json.dumps({"warmup": service.warm_summary, "boot": service.boot_block(),
                      "device": str(service.engine.device)}, default=str), flush=True)
    if args.warmup_only:
        service.close()
        return 0
    serve_http(service, config.host, config.port)
    return 0


def cmd_frontier(argv: List[str]) -> int:
    """The front tier (serving/frontier.py): route /v1/predict across N
    backend `serve` hosts with health-checked breakers, retry and hedging,
    stream affinity and overload brownout. It holds no model and imports
    no torch. The JAX CLI's flags and defaults."""
    p = argparse.ArgumentParser(prog="frontier")
    p.add_argument("--backends", nargs="+", default=None, metavar="HOST:PORT",
                   help="backend serve addresses; routing prefers healthy backends with the fewest in-flight "
                   "forwards (required in server mode; unused with --rollout)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--health_interval_s", type=float, default=2.0,
                   help="active /healthz probe interval; probe failures feed the per-backend breaker, and a probe "
                   "success is the only way a sticky-failed backend re-enters (probation)")
    p.add_argument("--health_timeout_s", type=float, default=5.0)
    p.add_argument("--request_timeout_s", type=float, default=600.0,
                   help="per-forward read timeout (bounds a wedged connection; deadline_ms stays the latency "
                   "authority)")
    p.add_argument("--retry_attempts", type=int, default=3,
                   help="total tries per plain request; retries prefer a DIFFERENT backend, with jittered "
                   "exponential backoff")
    p.add_argument("--retry_budget_percent", type=float, default=20.0,
                   help="retries allowed while retries_total < retry_budget_min + this%% of requests_total")
    p.add_argument("--retry_budget_min", type=int, default=10)
    p.add_argument("--hedge", action="store_true",
                   help="duplicate a pending plain request onto a second backend after max(live queue-wait p95, "
                   "--hedge_floor_ms) and take the first answer")
    p.add_argument("--hedge_floor_ms", type=float, default=50.0)
    p.add_argument("--brownout_queue_p95_ms", type=float, default=0.0,
                   help="overload brownout threshold on the worst backend queue-wait p95 (0 disables): above it "
                   "forwarded deadlines and iterations tighten so the engines exit early")
    p.add_argument("--brownout_deadline_ms", type=float, default=0.0, help="deadline_ms clamp while browned out")
    p.add_argument("--brownout_max_iters", type=int, default=0, help="max_iters cap while browned out")
    p.add_argument("--brownout_recover_ratio", type=float, default=0.5,
                   help="hysteresis: disengage only below threshold x this")
    p.add_argument("--breaker_degrade_after", type=int, default=1)
    p.add_argument("--breaker_fail_after", type=int, default=3)
    p.add_argument("--breaker_probation", type=int, default=2)
    p.add_argument("--drain_timeout_s", type=float, default=30.0)
    p.add_argument("--max_sessions", type=int, default=4096, help="stream-session pinning table ceiling (LRU)")
    p.add_argument("--log_dir", default=None,
                   help="flight-recorder dumps land here as frontier_flight_recorder.json")
    p.add_argument("--flight_recorder_events", type=int, default=512)
    p.add_argument("--rollout", default=None, metavar="CKPT",
                   help="client mode: POST {\"checkpoint\": CKPT} to http://HOST:PORT/rollout on a running "
                   "frontier (a rolling reload of every backend with canary checks and rollback on abort), print "
                   "the rollout record and exit")
    p.add_argument("--rollback_ckpt", default=None, metavar="CKPT",
                   help="with --rollout: rollback target for backends that never reported a prior checkpoint")
    p.add_argument("--force", action="store_true",
                   help="with --rollout: roll even when the backends' swap generations already differ")
    p.add_argument("--rollout_stream_policy", choices=("migrate", "hold"), default="migrate",
                   help="pinned streams on a quiesced backend: 'migrate' cold-restarts them elsewhere; 'hold' "
                   "parks their frames until the host is back (bounded by --rollout_hold_timeout_s)")
    p.add_argument("--rollout_probation", type=int, default=2,
                   help="consecutive successful probes a swapped backend must pass before the roll proceeds")
    p.add_argument("--rollout_drain_timeout_s", type=float, default=30.0,
                   help="per-backend budget for in-flight forwards to drain before its reload")
    p.add_argument("--rollout_verify_timeout_s", type=float, default=30.0,
                   help="per-backend budget for the /healthz swap_generation advance to show")
    p.add_argument("--rollout_hold_timeout_s", type=float, default=60.0,
                   help="how long requests park when the rollout leaves no admissible backend, before shedding")
    args = p.parse_args(argv)

    if args.rollout is not None:
        return _rollout_client(args.host, args.port, args.rollout, args.rollback_ckpt, args.force)
    if not args.backends:
        p.error("--backends is required (except with --rollout)")

    from raft_stereo_tpu_torch.config import FrontierConfig
    from raft_stereo_tpu_torch.serving.frontier import Frontier, serve_frontier_http

    config = FrontierConfig(
        backends=tuple(args.backends),
        host=args.host,
        port=args.port,
        health_interval_s=args.health_interval_s,
        health_timeout_s=args.health_timeout_s,
        request_timeout_s=args.request_timeout_s,
        retry_attempts=args.retry_attempts,
        retry_budget_percent=args.retry_budget_percent,
        retry_budget_min=args.retry_budget_min,
        hedge=args.hedge,
        hedge_floor_ms=args.hedge_floor_ms,
        brownout_queue_p95_ms=args.brownout_queue_p95_ms,
        brownout_deadline_ms=args.brownout_deadline_ms,
        brownout_max_iters=args.brownout_max_iters,
        brownout_recover_ratio=args.brownout_recover_ratio,
        breaker_degrade_after=args.breaker_degrade_after,
        breaker_fail_after=args.breaker_fail_after,
        breaker_probation=args.breaker_probation,
        drain_timeout_s=args.drain_timeout_s,
        max_sessions=args.max_sessions,
        rollout_stream_policy=args.rollout_stream_policy,
        rollout_probation=args.rollout_probation,
        rollout_drain_timeout_s=args.rollout_drain_timeout_s,
        rollout_verify_timeout_s=args.rollout_verify_timeout_s,
        rollout_hold_timeout_s=args.rollout_hold_timeout_s,
        log_dir=args.log_dir,
        flight_recorder_events=args.flight_recorder_events,
    )
    frontier = Frontier(config).start()
    serve_frontier_http(frontier, config.host, config.port)
    return 0


def cmd_fsck(argv: List[str]) -> int:
    from raft_stereo_tpu_torch.utils import fsck

    return fsck.main(argv)


def cmd_check_report(argv: List[str]) -> int:
    from raft_stereo_tpu_torch.utils import check_report

    return check_report.main(argv)


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SUBCOMMANDS:
        print(f"usage: python -m raft_stereo_tpu_torch {{{','.join(SUBCOMMANDS)}}} [args]", file=sys.stderr)
        return 2
    commands = {"train": cmd_train, "evaluate": cmd_evaluate, "demo": cmd_demo, "serve": cmd_serve,
                "frontier": cmd_frontier, "fsck": cmd_fsck, "check-report": cmd_check_report}
    return commands[argv[0]](argv[1:])
