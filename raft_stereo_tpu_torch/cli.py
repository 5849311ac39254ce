"""Command-line entry point of the port: counterpart of `raft_stereo_tpu/cli.py`.

    python -m raft_stereo_tpu_torch evaluate --dataset middlebury_F --restore_ckpt raftstereo.pth
    python -m raft_stereo_tpu_torch evaluate --dataset eth3d --dry_run --device cpu

`evaluate` takes the JAX CLI's flags, names and defaults, plus `--device`
(default "cuda"; "cpu" runs the kernels' plain versions). As in the JAX
CLI, `--corr_dtype` defaults to bfloat16 only for `reg_cuda` with
`--mixed_precision` (the reference's fp16 reg_cuda volume under AMP), and to
float32 otherwise. The model flags that the port does not have yet raise
instead of being ignored: `--corr_implementation alt`/`alt_cuda`. The
reference's realtime model runs as `evaluate --dataset kitti --dry_run
--shared_backbone --n_downsample 3 --n_gru_layers 2 --slow_fast_gru
--valid_iters 7 --corr_implementation reg_cuda --mixed_precision
--fused_encoder --fused_gru_tail` (a bf16 pyramid by the rule above).

The other subcommands (`train`, `demo`, `serve`, `frontier`) are not ported
yet and exit with code 2.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from raft_stereo_tpu_torch.config import MODALITIES, RAFTStereoConfig

SUBCOMMANDS = ("train", "evaluate", "demo", "serve", "frontier")


def _add_model_args(p: argparse.ArgumentParser):
    """Architecture flags (the reference's flag table)."""
    p.add_argument("--hidden_dims", nargs="+", type=int, default=[128] * 3)
    p.add_argument(
        "--corr_implementation",
        choices=["reg", "alt", "pallas", "reg_cuda", "alt_cuda"],
        default="reg",
        help="'pallas' is the hand-written CUDA lookup (the reference's reg_cuda role; "
        "reg_cuda is accepted as its alias); 'alt' is not ported",
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
# pallas (the hand-written lookup kernel); alt_cuda -> alt (not ported).
_CORR_ALIASES = {"reg_cuda": "pallas", "alt_cuda": "alt"}


def _model_config(args) -> RAFTStereoConfig:
    """The port's config from the model flags; raises on flags the port
    does not have yet."""
    corr = _CORR_ALIASES.get(args.corr_implementation, args.corr_implementation)
    corr_dtype = args.corr_dtype
    if corr_dtype is None:
        # The JAX CLI's rule: reg_cuda's role is the reference's fp16 volume
        # under AMP, so a bf16 pyramid only for reg_cuda with mixed precision.
        corr_dtype = "bfloat16" if args.corr_implementation == "reg_cuda" and args.mixed_precision else "float32"
    if corr == "alt":
        raise ValueError(f"not ported yet: --corr_implementation {args.corr_implementation}")
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
        help="parent datasets directory; the dataset readers are not ported yet, so only "
        "--dry_run evaluates",
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

    import torch

    from raft_stereo_tpu_torch.evaluate import VALIDATORS, Evaluator, SyntheticEvalDataset
    from raft_stereo_tpu_torch.models.init import build_model
    from raft_stereo_tpu_torch.utils.checkpoints import load_reference_checkpoint

    if args.device.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
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
    VALIDATORS[args.dataset](evaluator, **kwargs)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in SUBCOMMANDS:
        print(f"usage: python -m raft_stereo_tpu_torch {{{','.join(SUBCOMMANDS)}}} [args]", file=sys.stderr)
        return 2
    if argv[0] != "evaluate":
        print(f"raft_stereo_tpu_torch: {argv[0]} is not yet ported (evaluate is)", file=sys.stderr)
        return 2
    return cmd_evaluate(argv[1:])
