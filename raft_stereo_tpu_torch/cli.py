"""Command-line entry point of the port: counterpart of `raft_stereo_tpu/cli.py`.

    python -m raft_stereo_tpu_torch evaluate --dataset middlebury_F --restore_ckpt raftstereo.pth
    python -m raft_stereo_tpu_torch evaluate --dataset eth3d --dry_run --device cpu
    python -m raft_stereo_tpu_torch serve --corr_implementation pallas --fused_gru_tail --port 8080
    python -m raft_stereo_tpu_torch serve --reload_ckpt new.pth --port 8080

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

`serve` takes the JAX CLI's flags and defaults, plus `--device` (default
"cuda"): it boots a `StereoService`, warms every (bucket, batch) and serves
the HTTP front until SIGTERM or Ctrl-C, which drain the backlog and exit 0.
`--warmup_only` boots, warms, prints the boot block and exits 0;
`--reload_ckpt PATH` is the client of a running server's POST /reload.
The JAX CLI's fleet, sharding, AOT-cache and audit flags (`--replicas`
other than 1, `--sharding_rules` other than dp, `--aot_cache_dir`,
`--require_cache_hit`, `--audit`, `--auto_respawn`) are not ported yet and
exit 2.

The other subcommands (`train`, `demo`, `frontier`) are not ported yet and
exit with code 2.
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


# Exit codes of the admin client (`serve --reload_ckpt`), as in the JAX CLI.
EXIT_ADMIN_HTTP_ERROR = 1
EXIT_ADMIN_REFUSED = 3
EXIT_ADMIN_UNREACHABLE = 4
EXIT_ADMIN_TIMEOUT = 5
EXIT_ADMIN_BAD_BODY = 6


def _admin_post_client(url: str, payload: dict, what: str, timeout_s: float) -> int:
    """POST to a running server's admin endpoint and report the outcome:
    every failure mode has its own exit code and a one-line message."""
    import json

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
    # The JAX CLI's flags the port does not have yet: refused, never ignored.
    p.add_argument("--replicas", type=int, default=1, help="not ported yet: values other than 1 exit 2")
    p.add_argument("--sharding_rules", choices=["dp", "spatial", "dp+spatial"], default="dp",
                   help="not ported yet: values other than dp exit 2")
    p.add_argument("--aot_cache_dir", default=None, help="not ported yet (exits 2)")
    p.add_argument("--require_cache_hit", action="store_true", help="not ported yet (exits 2)")
    p.add_argument("--audit", action="store_true", help="not ported yet (exits 2)")
    p.add_argument("--auto_respawn", action="store_true", help="not ported yet (exits 2)")
    _add_model_args(p)
    args = p.parse_args(argv)

    unported = [flag for flag, given in (
        (f"--replicas {args.replicas}", args.replicas != 1),
        (f"--sharding_rules {args.sharding_rules}", args.sharding_rules != "dp"),
        ("--aot_cache_dir", args.aot_cache_dir is not None),
        ("--require_cache_hit", args.require_cache_hit),
        ("--audit", args.audit),
        ("--auto_respawn", args.auto_respawn),
    ) if given]
    if unported:
        print(f"serve: not ported yet: {', '.join(unported)}", file=sys.stderr)
        return 2
    if args.reload_ckpt is not None:
        return _admin_post_client(f"http://{args.host}:{args.port}/reload", {"checkpoint": args.reload_ckpt},
                                  "reload", 600.0)
    try:
        buckets = tuple(tuple(int(d) for d in b.lower().split("x")) for b in args.buckets)
    except ValueError:
        print(f"--buckets must look like 384x512, got {args.buckets}", file=sys.stderr)
        return 2

    import json

    import torch

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
        drain_timeout_s=args.drain_timeout_s,
        log_dir=args.log_dir,
        flight_recorder_events=args.flight_recorder_events,
    )
    if args.device.startswith("cuda"):
        # Process-wide flags, set once at boot, never per request.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    service = StereoService(config, device=args.device).start()
    print(json.dumps({"warmup": service.warm_summary, "boot": service.boot_block(),
                      "device": str(service.engine.device)}, default=str), flush=True)
    if args.warmup_only:
        service.close()
        return 0
    serve_http(service, config.host, config.port)
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
    if argv[0] == "evaluate":
        return cmd_evaluate(argv[1:])
    if argv[0] == "serve":
        return cmd_serve(argv[1:])
    print(f"raft_stereo_tpu_torch: {argv[0]} is not yet ported (evaluate and serve are)", file=sys.stderr)
    return 2
