"""GPU smoke test of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch version, serves requests through the anytime
serving path at the default model's full width — in the kernel
configuration and in the fused-encoder one — checks both end to end (the
kernel configuration against the plain one, the fused one against the
kernel one), compares their stage times, evaluates the default model on a
synthetic Middlebury-F-sized set through the evaluate entry point (the
windowed lookup, and the gate pair in its own configuration) and checks it
against the dense and the plain configurations, runs the evaluate command
line on its dry-run set, trains the default model for a few steps
at the training recipe's size (the lookup's backward as the scatter kernel)
and checks one step against plain autograd, runs the JAX bench's
mixed-precision configuration (bf16 compute, a bf16 pyramid, the fused
encoder): its four bf16 kernel variants against their plain versions, the
512x768 bucket served, the iteration path and the prelude against plain
code, the bf16 pyramid's accuracy budget, a Middlebury-F image through the
evaluate entry point and its command line, trains in the JAX package's
shipping numerics (bf16 compute and pyramid, the lookup's backward as the
bf16 scatter kernel) at the JAX bench's training setup, checks one such
step against plain autograd and runs the JAX package's shipping-numerics
convergence test with the kernels, serves the reference's realtime model
(shared backbone, 1/8 resolution, two GRU levels, slow-fast GRU, 7
iterations, mixed precision with the fused encoder and the fused GRU tail)
at the default buckets, checks it against its plain twins and its fp32
architecture against plain code, evaluates it on KITTI-shaped pairs and
through its command line, runs the JAX bench's mixed configuration with
each test-mode lever (the windowed lookup, the fused GRU tail, the gate
pair) at Middlebury-F size with their bf16 kernels held against their plain
versions, serves the kernel configuration behind the HTTP front to eight
client threads (every response held bit for bit against its batch replayed
through the engine, each batch against its pairs' batch-1 forwards, the
kernels launched once per batch, a stream's warm starts and reset, a hot
swap refused and then accepted), boots the `serve` command line in the
kernel and the mixed configurations as a process and stops it with
SIGTERM, runs the training command line at the JAX bench's setup on a
FlyingThings3D tree written from the seed (a control run, a run stopped by
SIGTERM and resumed, the resumed loader cursor and losses against the
control's, `evaluate` and `demo` on the trained model.pth, the device
prefetcher's batches and step against plain copies), runs the model
options of the fourteenth slice (the "alt" correlation against "reg" and
"pallas"; the JAX bench's model with the sequential encoder and
`sequential_batch_forward`), a fleet of two replicas on the one card (a
burst, an injected raise, a host-side hang, auto-respawn, a rolling swap
and its rollback, drain) and the front tier (two `serve` processes and a
`frontier` process: routing, a backend killed and restarted, a rollout,
SIGTERM), and times every kernel (the scatter also alone on the device).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Needs no JAX. Exits non-zero on any failure, and before printing anything
when no CUDA device is available. Prints the card's name and power limit,
then one JSON line describing the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import glob
import io
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

if __name__ == "__main__" and not os.environ.get("PYTHONPYCACHEPREFIX"):
    # One bytecode cache for the script and every process it starts: where
    # the installed packages hold no compiled bytecode and cannot be written
    # to, each process would compile torch's sources again (about 10 s of an
    # H100 host's CPU per process, and the script starts dozens).
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = tempfile.mkdtemp(prefix="chip-smoke-bytecode-")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    atexit.register(shutil.rmtree, sys.pycache_prefix, True)

import numpy as np
import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch import cli, evaluate
from raft_stereo_tpu_torch.profile_stages import LEVERS
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, TrainConfig, VideoConfig
from raft_stereo_tpu_torch.evaluate import Evaluator, SyntheticEvalDataset, validate_kitti, validate_middlebury
from raft_stereo_tpu_torch.models import anytime, layers
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo, sequential_batch_forward
from raft_stereo_tpu_torch.ops import _build, corr, corr_cuda, encoder_cuda, gates, gru_tail
from raft_stereo_tpu_torch.serving.service import StereoService, make_http_server
from raft_stereo_tpu_torch.train import synthetic
from raft_stereo_tpu_torch.train.trainer import Trainer, rank_file
from raft_stereo_tpu_torch.utils.checkpoints import export_reference_state_dict, load_reference_checkpoint
from raft_stereo_tpu_torch.utils.fsck import fsck_root
from raft_stereo_tpu_torch.utils.http import request, request_json
from raft_stereo_tpu_torch.utils.run_report import validate_run_report
from serve_compare import FRONT_BURST, FRONT_CLIENTS

# The slice's model: the default architecture with the CUDA lookup and the
# fused GRU tails, fp32 throughout.
KERNEL_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True)
PLAIN_CONFIG = RAFTStereoConfig(corr_implementation="reg", fused_gru_tail=False)
# The second slice's model: the kernel configuration with the fused encoder
# prelude (pyramid build, layer1 convs and joins as kernels).
FUSED_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, fused_encoder=True)
# The third slice's: the training step at the train CLI's recipe (batch 6,
# 320x720 crops, 16 iterations) with TrainConfig's optimizer and loss
# defaults, remat on with the taps saved, fp32. The test-mode-only flags
# are set so that the run shows their kernels never launch in training.
TRAIN_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, fused_encoder=True)
TRAIN_PLAIN_CONFIG = RAFTStereoConfig(corr_implementation="reg")
TRAIN_BATCH = 6
TRAIN_HW = (320, 720)
TRAIN_ITERS = 16
TRAIN_TIMED_STEPS = 1
# The kernels-against-plain-autograd step takes the first rows of the batch
# (cuDNN's fp32 FFT makes a recipe step about 30 s on the card).
TRAIN_E2E_BATCH = 2
# The fourth slice's: the evaluate entry point's configuration, the kernel
# one with the windowed lookup, at 32 iterations on a synthetic set of one
# Middlebury-F-sized pair (1980x2870 pads to 1984x2880: the padding and
# the crop run on the card); and the gates configuration, which needs the
# fused tail off (it takes precedence over the gates, as in JAX), run with
# the gates' environment variable set against its twin without it.
EVAL_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, prefetch_lookup=True)
GATES_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=False, prefetch_lookup=True)
EVAL_SHAPE = (1980, 2870)
# The windowed lookup's checks: the 512x768 bucket's 1/4 resolution and
# Middlebury-F's, (label, (query rows, W1 = W2)).
PREFETCH_CASES = (("512x768", (128, 192)), ("1984x2880", (496, 720)))
# The fifth slice redesigned the pyramid build and the scatter. The
# pyramid's checks, (label, (rows, W1 = W2, layout, levels)), each at the
# plan's own choice: both buckets' 1/4 resolution and Middlebury-F's in the
# model's layout (permuted NCHW views, 16-byte copies along W), the
# contiguous (B, H, W, D) layout (4-byte copies along D), widths no tile
# divides (odd: 4-byte copies), 128 rows at W 190 (the 96 x 192 tile with
# the shared-memory epilogue), and 1, 5, 6 and 7 levels at W 192 (the
# register epilogue up to 6 levels) and at W 150 (the shared-memory one).
PYRAMID_CASES = (
    ("384x512", (96, 128, "nchw", 4)),
    ("512x768", (128, 192, "nchw", 4)),
    ("1984x2880", (496, 720, "nchw", 4)),
    ("512x768 contiguous (B, H, W, D)", (128, 192, "bhwd", 4)),
    ("W 150", (3, 150, "nchw", 4)),
    ("W 150 contiguous (B, H, W, D)", (3, 150, "bhwd", 4)),
    ("W 37", (3, 37, "nchw", 4)),
    ("W 190", (128, 190, "nchw", 4)),
    *((f"W 192, {lv} levels", (128, 192, "nchw", lv)) for lv in (1, 5, 6, 7)),
    *((f"W 150, {lv} levels", (3, 150, "nchw", lv)) for lv in (1, 5, 6, 7)),
)
# The scatter's, beside the recipe: tests/test_torch_corr.py SCATTER_CASES,
# (B, H, W1, W2, levels, radius): odd widths, a level of width 1, query
# counts that are not a multiple of the queries per block.
SCATTER_CASES = {
    "r4_l4_multi_tile": (2, 3, 40, 150, 4, 4),
    "r2_l2_two_w1_blocks": (1, 2, 800, 37, 2, 2),
    "r1_l3_width_one": (1, 1, 9, 5, 3, 1),
    "r3_l1": (2, 2, 16, 16, 1, 3),
}
EVAL_ITERS = 32
# Iterations of the evaluate path's end-to-end checks against plain code
# and the gates' twin.
E2E_ITERS = 4
# The sixth slice's: the JAX bench's configuration (bench.py), "pallas" with
# bf16 compute, a bf16 pyramid and the fused encoder, served at the 512x768
# bucket and evaluated on one Middlebury-F-sized image; and its twins for
# the checks: without the fused encoder (direct convs, the plain pyramid)
# and with the plain lookup ("reg").
MIXED_CONFIG = RAFTStereoConfig(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16",
                                fused_encoder=True)
MIXED_UNFUSED_CONFIG = RAFTStereoConfig(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16")
MIXED_REG_CONFIG = RAFTStereoConfig(corr_implementation="reg", mixed_precision=True, corr_dtype="bfloat16",
                                    fused_encoder=True)
MIXED_BUCKET = (512, 768)
MIXED_REQUESTS = [
    ("512x768 bucket", (512, 768), None),
    ("padded 500x700", (500, 700), None),
    ("tight deadline", (512, 768), 1.0),
]
# The bf16 pyramid's checks, as PYRAMID_CASES, one or more per plan branch
# (ops/corr_cuda.py `pyramid_plan`): the wgmma kernel at every instantiated
# W2 width (the buckets' and Middlebury-F's 1/4: 192, 128 and 240 with a ring
# of 3 slots; the realtime buckets' 1/8: 64 and 96; W 160 and 256) and the
# mma.sync kernel for what its tensor maps do not take: the realtime KITTI
# bucket's 1/8 (W 156) and W 150 and 37 (rows not 16-byte aligned: element
# by element copies), the contiguous (B, H, W, D) layout, 7 levels.
PYRAMID_BF16_CASES = (
    ("512x768", (128, 192, "nchw", 4)),
    ("384x512", (96, 128, "nchw", 4)),
    ("realtime 384x512 1/8", (48, 64, "nchw", 4)),
    ("realtime 384x1248 1/8", (48, 156, "nchw", 4)),
    ("realtime 512x768 1/8", (64, 96, "nchw", 4)),
    ("1984x2880", (496, 720, "nchw", 4)),
    ("W 160", (3, 160, "nchw", 4)),
    ("W 256", (3, 256, "nchw", 4)),
    ("W 150", (3, 150, "nchw", 4)),
    ("512x768 contiguous (B, H, W, D)", (128, 192, "bhwd", 4)),
    ("W 37", (3, 37, "nchw", 4)),
    ("W 192, 7 levels", (128, 192, "nchw", 7)),
)
# The bf16 conv's and join's shapes: full resolution of the 512x768 bucket
# (every skip form of the join there) and of Middlebury-F, 13x70, where
# tiles end inside the image and rows are not 16-byte aligned (the conv's
# element-by-element path: no TMA raw tile, element stores), and the
# realtime model's layer1 at half resolution (its stem has stride 2) of
# the 384x512 and 512x768 buckets and of the KITTI bucket 384x1248.
BF16_CONV_SHAPES = ((512, 768), (1984, 2880), (13, 70), (192, 256), (256, 384), (192, 624))
# The trunks that run the bf16 conv and join, as (batch, conv forms, trunk
# norm, statistics emitted): the default model's feature trunk (2 images,
# instance norm) and context trunk (1 image, frozen BN), and the realtime
# model's shared context trunk (2 images, frozen BN; as fused_layer1 runs
# it: block 1's convs of the stem's and its own BN, block 2's first conv of
# a plain operand, no statistics). The join takes the trunk's norm.
BF16_CONV_TRUNKS = ((2, ("none", "in"), "in", True), (1, ("bn",), "bn", True), (2, ("bn", "none"), "bn", False))
# The seventh slice's: the training step in the JAX package's shipping
# numerics at the JAX bench's `train_step_s` setup (bench.py
# `_train_step_seconds`: batch 4, 320x720 crops, 22 iterations, "pallas",
# bf16 compute, a bf16 pyramid; remat with the taps saved, TrainConfig's
# defaults otherwise), its plain twin ("reg": autograd through the bf16
# gather), and the JAX package's shipping-numerics convergence test
# (tests/test_train.py `test_long_horizon_shipping_numerics_convergence`:
# 600 steps of batch 4 at 48x64, 5 iterations, lr 2e-4, a fresh synthetic
# batch from default_rng((7, step)) each step; the mean loss of the last
# 100 steps below 0.25 of the first 100's, and the held-out EPE over 8
# samples at 12 iterations below 1 px).
MIXED_TRAIN_CONFIG = RAFTStereoConfig(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16")
# The eighth slice's: the reference's realtime model (its "fastest model":
# shared backbone, 1/8 resolution, two GRU levels, slow-fast GRU, 7
# iterations, reg_cuda under mixed precision, which the CLI maps onto
# "pallas" with a bf16 pyramid) with the fused encoder and the fused GRU
# tail, served at the default buckets in one 7-iteration chunk
# (chunk_iters = max_iters = 7: the engine rounds a budget up to whole
# chunks); its fp32 architecture twins; and the JAX bench's mixed
# configuration with each test-mode lever in turn.
REALTIME_ARCH = dict(shared_backbone=True, n_downsample=3, n_gru_layers=2, slow_fast_gru=True)
REALTIME_CONFIG = RAFTStereoConfig(**REALTIME_ARCH, corr_implementation="pallas", mixed_precision=True,
                                   corr_dtype="bfloat16", fused_encoder=True, fused_gru_tail=True)
REALTIME_ITERS = 7
REALTIME_REQUESTS = [
    ("384x512 bucket", (384, 512)),
    ("512x768 bucket", (512, 768)),
    ("padded 375x500", (375, 500)),
]
REALTIME_E2E_HW = (384, 512)
# The KITTI pair's shape (`--dataset kitti`; padded to 384x1248) and the
# images `[realtime-evaluate]` times: one warm, then the median of the rest.
KITTI_SHAPE = (375, 1242)
KITTI_IMAGES = 5
# Per request of 7 iterations: one bf16 pyramid, a bf16 lookup, three bf16
# GRU tails (gru16 twice under slow_fast_gru, gru08 once) and a bf16 motion
# tail per iteration, and the context trunk's fused layer1 (the only trunk
# under shared_backbone): 4 bf16 convs (2 blocks x 2) and 2 bf16 joins.
REALTIME_PER_REQUEST = dict(corr_pyramid_bf16=1, corr_lookup_bf16=REALTIME_ITERS, gru_tail_bf16=3 * REALTIME_ITERS,
                            motion_tail_bf16=REALTIME_ITERS, encoder_conv_bf16=4, encoder_join_bf16=2)
# The levers' bf16 kernels against their plain versions: the 512x768
# bucket's three GRU scales, Middlebury-F's, the realtime model's at the
# KITTI bucket (1/8 and 1/16), an odd shape (the scalar loop only), and a
# view 2 bytes past a 16-byte boundary (the scalar loop on every pointer).
LEVER_GRU_SHAPES = [(128, 512 // d, 768 // d) for d in (4, 8, 16)] + [
    (128, 1984 // d, 2880 // d) for d in (4, 8, 16)] + [(128, 48, 156), (128, 24, 78), (3, 5, 7)]
LEVER_PREFETCH_CASES = PREFETCH_CASES + (("384x1248 1/8", (48, 156)),)
# The windowed lookup's plan branches on the card (`[prefetch-paths]`):
# label -> (batch, rows, W1, W2, levels, radius, levels as views 2 or 4
# bytes past a 16-byte boundary). W2 37 with 63 queries leaves each level's
# last 16-byte chunk partial.
PREFETCH_PATH_CASES = (
    ("512x768 1/4, batch 2", (2, 128, 192, 192, 4, 4, False)),
    ("realtime 1/8", (1, 48, 156, 156, 4, 4, False)),
    ("63 queries, W2 37", (1, 7, 9, 37, 4, 4, False)),
    ("radius 2, 2 levels", (1, 128, 192, 192, 2, 2, False)),
    ("radius 2, 2 levels, batch 2, W2 37", (2, 7, 9, 37, 2, 2, False)),
    ("offset views", (1, 128, 192, 192, 4, 4, True)),
    ("offset views, radius 2, 2 levels, batch 2", (2, 48, 156, 156, 2, 2, True)),
)
# The fp32 conv's shapes on the card (`[kernels]`): ((H, W), input as a view
# 4 bytes past a 16-byte boundary). Both buckets' full resolution, ragged
# tiles (H % 8 != 0, W % 64 != 0), rows that no TMA box takes (W % 4 != 0)
# and an unaligned input take the plan's two branches.
# The dense lookup's plan branches on the card (`[kernels]`,
# `[bf16-kernels]`, `[bf16-lever-kernels]`): the windowed kernel's cases,
# since both entry points launch the one kernel of csrc/corr_window.cuh,
# and the bf16 training step's 1/4 (4 x 80 x 180, W2 180).
DENSE_PATH_CASES = PREFETCH_PATH_CASES + (("bf16 training step 1/4, batch 4", (4, 80, 180, 180, 4, 4, False)),)
COORD_FAMILIES = ("smooth", "edge", "special", "uniform")
FP32_CONV_SHAPES = (((384, 512), False), ((512, 768), False), ((13, 70), False), ((192, 624), False),
                    ((20, 68), False), ((20, 66), False), ((64, 128), True))
FP32_CONV_BRANCHES = {True: "TMA raw box, 16-byte stores", False: "element by element"}
# The seventeenth slice's halo form of the conv (a row band's layer1 conv
# with its neighbour bands' rows, parallel/spatial.py): (label, batch,
# output rows, W, (rows above, rows below)). A Middlebury-F band's layer1
# shapes (the feature trunk's two images, 992 of 1984 rows at full
# resolution, 2880 wide: the top band of two takes a row from below, the
# bottom band one from above) and the 512x768 bucket with a row on each
# side (a middle band). Held against the plain twin on the same operand,
# TF32 off: fp32 bit for bit (both sum each output's 576 products in one
# order, which cuDNN was measured to take at these shapes), bf16 by
# `conv_bf16_check`'s allowance; the statistics to STATS_REL_TOL.
HALO_CONV_CASES = (("Middlebury-F top band", 2, 992, 2880, (0, 1)),
                   ("Middlebury-F bottom band", 2, 992, 2880, (1, 0)),
                   ("512x768 middle band", 2, 512, 768, (1, 1)))
MIXED_TRAIN_PLAIN_CONFIG = RAFTStereoConfig(corr_implementation="reg", mixed_precision=True, corr_dtype="bfloat16")
MIXED_TRAIN_BATCH = 4
MIXED_TRAIN_ITERS = 22
MIXED_TRAIN_TIMED_STEPS = 3
CONVERGE_STEPS, CONVERGE_BATCH, CONVERGE_HW, CONVERGE_ITERS, CONVERGE_LR = 600, 4, (48, 64), 5, 2e-4
CONVERGE_LOSS_RATIO, CONVERGE_EPE_PX = 0.25, 1.0
# The bf16 scatter's checks beyond SCATTER_CASES, (B, H, W1, W2, levels,
# radius): the fp32 row's shape and the bench's (64-query runs: every span
# of a level starts 16-byte aligned in bf16 too), and a window so wide that
# a block owns one query (run 1), so that with odd widths the spans start at
# every 2-byte offset and the element-by-element head and tail stores run.
SCATTER_BF16_CASES = {
    "6x80x180": (6, 80, 180, 180, 4, 4),
    "4x80x180 (bench)": (4, 80, 180, 180, 4, 4),
    "run 1, W2 1001 and 500, radius 4000": (1, 1, 61, 1001, 2, 4000),
}
BF16 = torch.bfloat16
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense

# Tolerances. The kernels are compiled with -fmad=false and round where the
# plain versions round, so the lookups and the motion tail agree exactly
# (the lookups by value: a zero tap out of range is +0 in the kernel and
# may be -0 in the plain version; the motion tail bit for bit); the GRU
# tail may differ in the last ulp of expf/tanhf.
# The join is built the same way and must agree exactly. The conv and the
# pyramid build need not sum in cuDNN's and cuBLAS's order (they may pick
# other algorithms on another card or version), so their tolerances are
# stated for unit-scale inputs (weights scaled by 1/sqrt(9*64), so y is
# unit-scale too; the volume's dot products are divided by sqrt(D)).
# The conv statistics are held relative to sum|y| and sum y^2 per channel.
TOL = {"corr_lookup": 0.0, "gru_tail": 1e-6, "motion_tail": 0.0,
       "corr_pyramid": 2e-5, "encoder_conv": 1e-4, "encoder_join": 0.0, "corr_scatter": 0.0,
       "corr_prefetch_lookup": 0.0, "gates_rh": 1e-6, "gates_combine": 1e-6}
STATS_REL_TOL = 1e-5
E2E_TOL_PX = 1e-3
# Fused against kernel configuration: the prelude state to 1e-4 of its
# largest magnitude; flow_up after 4 iterations to the JAX package's own
# fused-against-XLA bound, |diff| <= 2e-2 px + 2e-2 |flow| per pixel
# (tests/test_encoder_pallas.py, assert_allclose rtol = atol = 2e-2), since
# random weights make the GRU amplify the encoder's rounding.
FUSED_STATE_REL_TOL = 1e-4
FUSED_FLOW_TOL_PX = 2e-2
FUSED_FLOW_RTOL = 2e-2
# The scatter kernel is built with -fmad=false and rounds where its plain
# version does: exact (TOL["corr_scatter"] = 0). CorrLookup's d(pyramid)
# against autograd of the plain lookup: the backward's one shared fraction
# x - floor(x) differs from the forward's per-tap t - floor(t) by at most
# half an ulp of t < W2 + 1, two such terms per sample plus the products'
# rounding: 2**-23 (W2 + 3) max|g|.
# A training step of the kernel configuration against the plain one
# ("reg", autograd through the gather lookup) on the same weights and
# batch: the forwards are equal, so the loss may differ only by the sum
# order of the loss reduction (1e-6 relative); the gradients differ where
# the shared fraction rounds and by autograd's atomic sum order in the
# gather's backward, which the backward carries to every parameter: the
# global norm to 1e-4 relative, each parameter's gradient to 1e-3 of its
# own largest value — except the feature encoder trunk's, whose fp32
# gradient passes an instance norm in every block and is ill-conditioned
# for the cotangent the correlation hands back (tests/test_torch_train.py
# measured two fp32 evaluations 4e-2 apart on the CPU): 1e-1, and its conv
# biases, whose true gradient is zero (the norm removes any per-channel
# constant): both sides' values within 1e-6 of the largest gradient.
# The bf16 variants against their plain versions on the same inputs: the
# lookup and the join round where their plain versions round, so exactly.
# The pyramid and the conv sum their bf16 products on the tensor cores, in
# another order than cuBLAS and cuDNN, so a sum near a rounding boundary
# may round one bf16 ulp the other way: each level-0 entry within 1 bf16
# ulp of the larger magnitude of the pair, plus 2**-15 of the level's
# largest magnitude for sums that cancel to near zero (the fp32 reordering
# error of 256-576 products); each pooled level within the mean of its two
# inputs' allowances plus its own ulp (a 1-ulp flip of an input carries into
# the pooled value); each conv output as `conv_bf16_check` says (the bias is
# added after the sum's rounding). The share of elements that differ is
# printed.
BF16_SUM_FLOOR = 2.0**-15
# The mixed configuration against its twins on the same weights and input
# (the 512x768 bucket): the iteration path with the lookup kernel against
# the plain lookup ("reg"), from one prelude state, bit for bit; the fused
# prelude against the unfused one: the correlation levels and the context
# within 4 bf16 ulps of the tensor's largest magnitude (the layer1 convs
# and instance statistics sum in another order, and a 1-ulp difference
# passes through layers 2-3; measured at most 1.5 ulps on the CPU at
# 128x192), the hidden state printed (tanh of the head: a steep tanh maps
# an ulp of a large pre-activation onto a large difference).
MIXED_STATE_ULPS = 4
TRAIN_LOSS_RTOL = 1e-6
TRAIN_NORM_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_FNET_GRAD_TOL = 1e-1
# A mixed training step of the kernel configuration against the plain one
# ("reg", autograd through the bf16 gather) on the same seeded weights and
# batch, cuDNN deterministic in both: the forwards are bit for bit equal
# (as `[mixed-e2e]` shows for the iteration path), so the loss may differ
# only by the loss reduction's order; the gradients differ because the plain backward
# rounds every tap's contribution to d(pyramid) to bf16 and sums them in
# bf16, where the scatter rounds their fp32 sum once, and the difference
# passes back through the bf16 volume into the feature encoder and on to
# every parameter. Measured on an H100 80GB HBM3 at 700 W (PERF.md section
# 2): loss and norm equal; the worst gradient 5.6e-3 of its largest value
# (fnet.conv2.bias), the feature-encoder trunk's 1.24e-2, its zero-gradient
# conv biases (see TRAIN_FNET_GRAD_TOL) 2.7e-3 of the model's largest
# gradient. The bounds: the fp32 step's for the loss and the norm, 4 times
# the measured values for the gradients.
MIXED_TRAIN_LOSS_RTOL = 1e-6
MIXED_TRAIN_NORM_RTOL = 1e-4
MIXED_TRAIN_GRAD_TOL = 2.5e-2
MIXED_TRAIN_FNET_GRAD_TOL = 5e-2
MIXED_TRAIN_ZERO_GRAD_TOL = 1.1e-2

KERNELS = {
    "corr_lookup": ("raft_stereo_tpu_torch/csrc/corr_lookup.cu", "raft_stereo_tpu/ops/corr_pallas.py:90"),
    "gru_tail": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:48"),
    "motion_tail": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:55"),
    "corr_pyramid": ("raft_stereo_tpu_torch/csrc/corr_pyramid.cu", "raft_stereo_tpu/ops/corr_pallas.py:617"),
    "encoder_conv": ("raft_stereo_tpu_torch/csrc/encoder_conv.cu", "raft_stereo_tpu/ops/encoder_pallas.py:109"),
    "encoder_join": ("raft_stereo_tpu_torch/csrc/encoder_join.cu", "raft_stereo_tpu/ops/encoder_pallas.py:275"),
    "corr_scatter": ("raft_stereo_tpu_torch/csrc/corr_scatter.cu", "raft_stereo_tpu/ops/corr_pallas.py:156"),
    "corr_prefetch_lookup": ("raft_stereo_tpu_torch/csrc/corr_prefetch.cu",
                             "raft_stereo_tpu/ops/corr_pallas.py:463"),
    "gates_rh": ("raft_stereo_tpu_torch/csrc/gates.cu", "raft_stereo_tpu/ops/gates_pallas.py:54"),
    "gates_combine": ("raft_stereo_tpu_torch/csrc/gates.cu", "raft_stereo_tpu/ops/gates_pallas.py:59"),
    "corr_lookup_bf16": ("raft_stereo_tpu_torch/csrc/corr_lookup.cu", "raft_stereo_tpu/ops/corr_pallas.py:90"),
    "corr_pyramid_bf16": ("raft_stereo_tpu_torch/csrc/corr_pyramid.cu", "raft_stereo_tpu/ops/corr_pallas.py:617"),
    "encoder_conv_bf16": ("raft_stereo_tpu_torch/csrc/encoder_conv.cu", "raft_stereo_tpu/ops/encoder_pallas.py:109"),
    "encoder_join_bf16": ("raft_stereo_tpu_torch/csrc/encoder_join.cu", "raft_stereo_tpu/ops/encoder_pallas.py:275"),
    "corr_scatter_bf16": ("raft_stereo_tpu_torch/csrc/corr_scatter.cu", "raft_stereo_tpu/ops/corr_pallas.py:156"),
    "gru_tail_bf16": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:48"),
    "motion_tail_bf16": ("raft_stereo_tpu_torch/csrc/gru_tail.cu", "raft_stereo_tpu/ops/gru_tail_pallas.py:55"),
    "gates_rh_bf16": ("raft_stereo_tpu_torch/csrc/gates.cu", "raft_stereo_tpu/ops/gates_pallas.py:54"),
    "gates_combine_bf16": ("raft_stereo_tpu_torch/csrc/gates.cu", "raft_stereo_tpu/ops/gates_pallas.py:59"),
    "corr_prefetch_lookup_bf16": ("raft_stereo_tpu_torch/csrc/corr_prefetch.cu",
                                  "raft_stereo_tpu/ops/corr_pallas.py:463"),
}
SOURCES = ("corr_lookup", "gru_tail", "corr_pyramid", "encoder_conv", "encoder_join", "corr_scatter",
           "corr_prefetch", "gates")
# Requests each serving phase answers: (label, (H, W), deadline ms or None).
REQUESTS = [
    ("384x512 bucket", (384, 512), None),
    ("512x768 bucket", (512, 768), None),
    ("padded 300x500", (300, 500), None),
    ("tight deadline", (512, 768), 1.0),
]


# Seconds between log lines, summed under the phase tag of the line that
# ends each interval (the work before a phase's line is that phase's):
# printed at the end, so the script's time limit can be kept phase by phase.
PHASE_SECONDS: dict = {}
_LAST_LOG = [time.perf_counter()]


def log(msg: str) -> None:
    now = time.perf_counter()
    tag = re.match(r"\[([a-z0-9-]+)", msg)
    if tag is not None:
        PHASE_SECONDS[tag.group(1)] = PHASE_SECONDS.get(tag.group(1), 0.0) + now - _LAST_LOG[0]
    _LAST_LOG[0] = now
    print(msg, flush=True)


def reset_launches() -> None:
    for counts in (corr_cuda.LAUNCHES, gru_tail.LAUNCHES, encoder_cuda.LAUNCHES, gates.LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    return {**corr_cuda.LAUNCHES, **gru_tail.LAUNCHES, **encoder_cuda.LAUNCHES, **gates.LAUNCHES}


def expect(**counts) -> dict:
    """The launch counts a run should show: `counts`, every other kernel 0."""
    return {**{k: 0 for k in launches()}, **counts}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


# -- the processes the script starts --------------------------------------------

# prctl(2): make this process the child subreaper of its descendants.
PR_SET_CHILD_SUBREAPER = 36
# Seconds a leftover process gets between SIGTERM and SIGKILL.
STOP_GRACE_S = 10.0


def adopt_orphans() -> None:
    """Make this process the subreaper of everything it starts: a process
    whose parent ends first (torchrun's ranks, which sit in sessions of
    their own; a serve process's children) is re-parented here, not to
    init, so `stop_descendants` still finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants() -> dict:
    """{pid: (state, command line)} of every process below this one, read
    from /proc (its own process groups and sessions included)."""
    parent, info = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                argv = f.read()
        except OSError:
            continue
        fields = stat[stat.rfind(")") + 2:].split()  # the state and the parent follow the name
        parent[int(entry)] = int(fields[1])
        info[int(entry)] = (fields[0], argv.replace(b"\0", b" ").decode(errors="replace").strip())
    me, found = os.getpid(), {}
    for pid in parent:
        up = parent[pid]
        while up in parent and up not in (me, 0, 1):
            up = parent[up]
        if up == me:
            found[pid] = info[pid]
    return found


def stop_descendants(grace_s: float = STOP_GRACE_S) -> list:
    """Stop every process still running below this one (SIGTERM, SIGKILL
    after `grace_s`) and reap this process's ended children. Returns the
    command lines that were still running."""
    running = {pid: cmd for pid, (state, cmd) in descendants().items() if state != "Z"}
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in running:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, sig)
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(state != "Z" for state, _ in descendants().values()):
            time.sleep(0.1)
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            break
    return sorted(f"{pid} {cmd[:200]}" for pid, cmd in running.items())


def remove_bytecode_cache() -> None:
    """Remove the bytecode cache that the script made for its processes."""
    prefix = sys.pycache_prefix
    if prefix and os.path.basename(prefix).startswith("chip-smoke-bytecode-"):
        shutil.rmtree(prefix, ignore_errors=True)


def stop_on_signal(signum, frame) -> None:
    """SIGTERM or SIGINT: stop every process the script started, then exit."""
    left = stop_descendants(grace_s=2.0)
    remove_bytecode_cache()
    print(f"chip_smoke: signal {signum}: stopped {len(left)} process(es) it had started: {left}", file=sys.stderr,
          flush=True)
    os._exit(128 + signum)


# -- inputs at main-path shapes ------------------------------------------------

def lookup_inputs(gen, b, h, w1, w2, levels=4, radius=4):
    """Random pyramid levels and coordinates: mostly in range, with a share
    far below 0 and past W2 (those must give zero taps)."""
    pyramid = []
    w = w2
    for _ in range(levels):
        pyramid.append(torch.randn((b, h, w1, w), generator=gen, device=DEVICE))
        w //= 2
    base = torch.arange(w1, dtype=torch.float32, device=DEVICE).expand(b, h, w1)
    disp = torch.rand((b, h, w1), generator=gen, device=DEVICE) * (w2 / 4)
    coords = base - disp
    wild = torch.rand((b, h, w1), generator=gen, device=DEVICE)
    far = (torch.rand((b, h, w1), generator=gen, device=DEVICE) - 0.5) * 4 * (w2 + 2 * radius + 8)
    coords = torch.where(wild < 0.1, far, coords).contiguous()
    return tuple(pyramid), coords


def lookup_bytes(pyramid, coords, radius, out_bytes=4) -> int:
    """Bytes the lookup must move on these inputs: coordinates and outputs
    (of `out_bytes` each) once, plus each in-range pyramid sample a query's
    window touches."""
    n_q = coords.numel()
    k = 2 * radius + 1
    total = 4 * n_q + out_bytes * n_q * len(pyramid) * k
    for lvl, vol in enumerate(pyramid):
        w2 = vol.shape[-1]
        lo = torch.floor(coords / (2**lvl) - radius)
        hi = lo + 2 * radius + 1
        touched = (torch.minimum(hi, torch.tensor(w2 - 1.0, device=coords.device))
                   - torch.maximum(lo, torch.zeros((), device=coords.device)) + 1).clamp(min=0)
        total += vol.element_size() * int(touched.sum().item())
    return total


def lookup_sector_bytes(pyramid, coords, radius, out_bytes=4) -> int:
    """The same bytes at 32-byte-sector granularity: the distinct sectors
    that the in-range samples of the windows occupy in each level (counted
    from the level's address), plus the coordinates and outputs rounded up
    to whole sectors. A window of 2r+2 samples spans 2 or 3 sectors even
    where it needs 40 bytes, so no kernel reaches the counted bound."""
    n_q = coords.numel()
    k = 2 * radius + 1
    total = 32 * -(-4 * n_q // 32) + 32 * -(-out_bytes * n_q * len(pyramid) * k // 32)
    rows = torch.arange(n_q, device=coords.device, dtype=torch.int64)
    for lvl, vol in enumerate(pyramid):
        w2, eb = vol.shape[-1], vol.element_size()
        lo = torch.floor(coords.reshape(-1) / (2**lvl) - radius)
        lo_c = torch.clamp(lo, min=0.0)
        hi_c = torch.clamp(lo + 2 * radius + 1, max=w2 - 1.0)
        ok = torch.isfinite(lo) & (hi_c >= lo_c)
        base = vol.data_ptr() % 32
        first = (base + (rows[ok] * w2 + lo_c[ok].long()) * eb) // 32
        last = (base + (rows[ok] * w2 + hi_c[ok].long() + 1) * eb - 1) // 32
        seen = torch.zeros((base + vol.numel() * eb) // 32 + 1, dtype=torch.bool, device=coords.device)
        for d in range(int((last - first).max().item()) + 1 if first.numel() else 0):
            seen[(first + d)[first + d <= last]] = True
        total += 32 * int(seen.sum().item())
    return total


def lookup_bounds(pyramid, coords, radius, out_bytes=4, alone=None) -> str:
    """The lookup's counted bound and its bound at sector granularity, as
    `[timing]` prints them beside a lookup's time; with `alone` (a kernel's
    device time, ms), that time's share of each."""
    counted = lookup_bytes(pyramid, coords, radius, out_bytes)
    sectors = lookup_sector_bytes(pyramid, coords, radius, out_bytes)
    t_counted, t_sectors = counted / HBM_BYTES_PER_S * 1e3, sectors / HBM_BYTES_PER_S * 1e3
    shares = "" if alone is None else f"; alone at {t_counted / alone:.0%} and {t_sectors / alone:.0%} of them"
    return (f"bound {t_counted:.4f} ms ({counted} B counted), at 32-byte sectors {t_sectors:.4f} ms ({sectors} B)"
            f"{shares}")


def grid_sample_lookup_inputs(pyramid, coords, radius):
    """The same lookup as one F.grid_sample call: levels zero-padded to W2
    and stacked on the batch axis, one height-1 row per query."""
    n_q = coords.numel()
    w2 = pyramid[0].shape[-1]
    rows = torch.zeros((len(pyramid), n_q, w2), device=coords.device)
    for lvl, vol in enumerate(pyramid):
        rows[lvl, :, : vol.shape[-1]] = vol.reshape(n_q, -1)
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    t = torch.stack([coords.reshape(n_q, 1) / (2**lvl) + offsets for lvl in range(len(pyramid))])
    grid = torch.stack([2.0 * t / (w2 - 1) - 1.0, torch.zeros_like(t)], dim=-1)
    return rows.reshape(-1, 1, 1, w2), grid.reshape(-1, 1, 2 * radius + 1, 2)


def tail_inputs(gen, c, h, w):
    return tuple(torch.randn((1, c, h, w), generator=gen, device=DEVICE) * 2 for _ in range(5))


def motion_inputs(gen, h, w):
    return (torch.randn((1, 126, h, w), generator=gen, device=DEVICE),
            torch.randn((1, 1, h, w), generator=gen, device=DEVICE))


def max_err(a, b) -> float:
    return float((a - b).abs().max().item())


def bitwise_equal(a, b) -> bool:
    """Equal bit for bit (the sign of zero included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def affine_rows(gen, b, form):
    """(B, 2, 64) pending-norm rows: instance [mean, inv] or batch [inv, shift]."""
    if form == "none":
        return None
    u = torch.rand((b, 64), generator=gen, device=DEVICE) * 1.5 + 0.5
    n = torch.randn((b, 64), generator=gen, device=DEVICE) * 0.3
    return torch.stack([n, u] if form == "in" else [u, n], dim=1).contiguous()


def conv_inputs(gen, b, h, w, form):
    """Unit-scale operand, 3x3 64->64 weights scaled by 1/sqrt(9*64), bias,
    and the form's affine rows."""
    x = torch.randn((b, 64, h, w), generator=gen, device=DEVICE)
    weight = torch.randn((64, 64, 3, 3), generator=gen, device=DEVICE) / (9 * 64) ** 0.5
    bias = torch.randn((64,), generator=gen, device=DEVICE) * 0.1
    return x, weight, bias, affine_rows(gen, b, form)


def fmap_inputs(gen, b, h, w, d=256, layout="nchw"):
    """Feature maps as the model hands them to the pyramid build: (B, H, W, D)
    views of NCHW tensors; with layout "bhwd", contiguous (B, H, W, D)."""
    if layout == "bhwd":
        return tuple(torch.randn((b, h, w, d), generator=gen, device=DEVICE) for _ in range(2))
    return tuple(torch.randn((b, d, h, w), generator=gen, device=DEVICE).permute(0, 2, 3, 1)
                 for _ in range(2))



def stats_rel_err(got, y) -> float:
    """Conv statistics error, relative per channel to sum|y| and sum y^2."""
    y = y.double()
    scale = torch.stack([y.abs().sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))], dim=1)
    want = encoder_cuda.channel_stats(y.float()).double()
    return float(((got.double() - want).abs() / scale).max().item())


# -- timing --------------------------------------------------------------------

def time_ms(fn, reps=30, flush=None) -> float:
    """Median device time of one call, by CUDA events around each call.
    `flush` (a large buffer) is rewritten before every call so the call
    finds the L2 cache cold, as it does between the model's other layers."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_ms(fn, names, flush, reps=20, tries=3):
    """Mean device time of the kernels whose name contains one of `names`
    in one call of `fn`, by torch.profiler (L2 flushed before each call):
    the wrapper's kernels alone, without the host's launch gaps that
    `time_ms` also sees. A trace can come back without them (seen once on
    the card late in a long run): it is taken again, up to `tries` times,
    and None means not measured."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        total = sum(e.device_time_total for e in events if any(n in e.key for n in names))
        if total > 0:
            return total / 1e3 / reps
    log(f"[timing] no device time for {names} in {tries} traces; they held {[e.key[:60] for e in events][:6]}")
    return None


def alone_text(t) -> str:
    """A `kernel_ms` time as printed: ms, or "not measured"."""
    return "not measured" if t is None else f"{t:.4f}"


def share_text(bound, t) -> str:
    """`bound` over a `kernel_ms` time, as a percentage, or "not measured"."""
    return "not measured" if t is None else f"{bound / t:.0%}"


# -- phases --------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(SOURCES)
    log(f"[build] nvcc sm_90a, parallel: {built} ({time.perf_counter() - t0:.2f} s wall)")
    for name in SOURCES:
        log(f"[build] {name}: flags {' '.join(_build.SOURCE_FLAGS[name])}")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(gen) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    errs = {}
    cases = [(384, 512), (512, 768), (1984, 2880)]
    for hh, ww in cases:
        pyramid, coords = lookup_inputs(gen, 1, hh // 4, ww // 4, ww // 4)
        got = corr_cuda.corr_lookup(pyramid, coords, 4)
        torch.cuda.synchronize()
        want = corr.corr_lookup(pyramid, coords, 4)
        err = max_err(got, want)
        log(f"[kernels] corr_lookup {hh}x{ww} (queries {hh // 4}x{ww // 4}, W2 {ww // 4}): "
            f"max abs diff {err:.3e} (tol {TOL['corr_lookup']:g})")
        if not taps_exact(got, want):
            raise AssertionError(f"corr_lookup disagrees with its plain version at {hh}x{ww}: {err}")
        errs["corr_lookup"] = max(errs.get("corr_lookup", 0.0), err)
    errs["corr_lookup"] = max(errs["corr_lookup"],
                              dense_lookup_paths(gen, "kernels", ((torch.float32, torch.float32),))["corr_lookup"])
    # The tails at the GRU's three scales of the 512x768 bucket and of
    # Middlebury-F (where each thread of the capped grid strides ~11 times).
    for hh, ww in cases[1:]:
        for div in (4, 8, 16):
            h, w = hh // div, ww // div
            ops = tail_inputs(gen, 128, h, w)
            got = gru_tail.fused_gru_tail(*ops)
            torch.cuda.synchronize()
            err = max_err(got, gru_tail.plain_gru_tail(*ops))
            log(f"[kernels] gru_tail 128x{h}x{w}: max abs diff {err:.3e} (tol {TOL['gru_tail']:g})")
            if not err <= TOL["gru_tail"]:
                raise AssertionError(f"gru_tail disagrees with its plain version at {hh}x{ww} 1/{div}: {err}")
            errs["gru_tail"] = max(errs.get("gru_tail", 0.0), err)
            del ops, got
    for hh, ww in cases:
        pre, flow = motion_inputs(gen, hh // 4, ww // 4)
        got = gru_tail.fused_motion_tail(pre, flow)
        torch.cuda.synchronize()
        want = gru_tail.plain_motion_tail(pre, flow)
        err = max_err(got, want)
        bitwise = bitwise_equal(got, want)
        log(f"[kernels] motion_tail 126x{hh // 4}x{ww // 4}: max abs diff {err:.3e} "
            f"(tol {TOL['motion_tail']:g}), bitwise {bitwise}")
        if not err <= TOL["motion_tail"] or not bitwise:
            raise AssertionError(f"motion_tail disagrees with its plain version at {hh}x{ww}: {err}")
        errs["motion_tail"] = max(errs.get("motion_tail", 0.0), err)
    # The plane grid's scalar path (odd H*W) and a batch of 2.
    for b, h, w in ((2, 7, 9), (2, 48, 156), (2, 63, 1)):
        pre = torch.randn((b, 126, h, w), generator=gen, device=DEVICE)
        flow = torch.randn((b, 1, h, w), generator=gen, device=DEVICE)
        got = gru_tail.fused_motion_tail(pre, flow)
        torch.cuda.synchronize()
        plan = gru_tail.motion_tail_plan(b, 126, h * w, 4, _build.multiprocessors(0), (h * w) % 4 == 0)
        bitwise = bitwise_equal(got, gru_tail.plain_motion_tail(pre, flow))
        log(f"[kernels] motion_tail b{b} 126x{h}x{w} (plan: {plan.unit}-element units, {plan.per_thread} per "
            f"thread, grid {plan.grid}): bitwise {bitwise}")
        if not bitwise:
            raise AssertionError(f"motion_tail disagrees with its plain version at b{b} {h}x{w}")
    return errs


def halo_conv_checks(gen, dtype, tag: str) -> float:
    """The conv's halo form at every HALO_CONV_CASES entry and form, with
    statistics, against its plain twin; returns the max abs diff."""
    name = "encoder_conv_bf16" if dtype == BF16 else "encoder_conv"
    err_max = 0.0
    for label, b, hh, ww, halo in HALO_CONV_CASES:
        for form in ("none", "in", "bn"):
            x, weight, bias, aff = conv_inputs(gen, b, hh + sum(halo), ww, form)
            x = x.to(dtype)
            y, stats = encoder_cuda.fused_conv(x, weight, bias, aff, form, emit_stats=True, halo=halo)
            torch.cuda.synchronize()
            want, _ = encoder_cuda.plain_conv(x, weight, bias, aff, form, False, halo)
            err = max_err(y.float(), want.float())
            rel = stats_rel_err(stats, y)
            if dtype == BF16:
                worst, share = conv_bf16_check(y, want, bias)
                ok = worst <= 1.0
                verdict = f"worst element at {worst:.3f} of its allowance (tol 1), share differing {share:.2e}"
            else:
                ok = bitwise_equal(y, want)
                verdict = f"bit for bit {ok} (tol: bitwise)"
            log(f"{tag} {name} halo form, {label}: x b{b} x 64 x {hh + sum(halo)} x {ww}, {halo[0]} row(s) above "
                f"and {halo[1]} below, y {hh} rows, form {form}: max abs diff {err:.3e}, {verdict}; statistics rel "
                f"diff {rel:.3e} (tol {STATS_REL_TOL:g})")
            if not (ok and rel <= STATS_REL_TOL and tuple(y.shape) == (b, 64, hh, ww)):
                raise AssertionError(f"{name} halo form disagrees with its twin at {label} form {form}: {err}, {rel}")
            err_max = max(err_max, err)
            del x, y, want, stats
    torch.cuda.empty_cache()
    return err_max


def phase_fused_kernels(gen) -> dict:
    """The fused encoder's three kernels against their plain versions at the
    main path's shapes: the conv at every FP32_CONV_SHAPES entry (full
    resolution of both buckets: batch 1 is the context trunk, batch 2 the
    feature trunk; ragged tiles; rows that no TMA box takes; an input 4
    bytes past a 16-byte boundary), every form, with statistics, logging
    the plan branch each shape took and failing unless both branches ran
    in every form; the join over every form pair; the pyramid (D = 256) at
    every PYRAMID_CASES entry."""
    errs = {}

    def check(name, err, label, extra=""):
        log(f"[kernels] {name} {label}: max abs diff {err:.3e} (tol {TOL[name]:g}){extra}")
        if not err <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version at {label}: {err}")
        errs[name] = max(errs.get(name, 0.0), err)

    branches = set()
    for (hh, ww), offset in FP32_CONV_SHAPES:
        for b in (1, 2):
            for form in ("none", "in", "bn"):
                x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
                if offset:
                    x = offset_view(gen, x.shape, torch.float32)
                y, stats = encoder_cuda.fused_conv(x, weight, bias, aff, form, emit_stats=True)
                torch.cuda.synchronize()
                plan = encoder_cuda.conv_plan_for(x, y)
                path = FP32_CONV_BRANCHES[plan.vec]
                branches.add((path, form))
                want_y, _ = encoder_cuda.plain_conv(x, weight, bias, aff, form, False)
                rel = stats_rel_err(stats, want_y)
                check("encoder_conv", max_err(y, want_y),
                      f"b{b} {hh}x{ww}{' (input 4 bytes past a 16-byte boundary)' if offset else ''} form {form} "
                      f"(plan branch {path}, {plan.blocks} persistent blocks)",
                      f"; stats rel diff {rel:.3e} (tol {STATS_REL_TOL:g})")
                if not rel <= STATS_REL_TOL:
                    raise AssertionError(f"encoder_conv statistics disagree at b{b} {hh}x{ww} {form}: {rel}")
                del x, y, want_y
    need = {(path, form) for path in FP32_CONV_BRANCHES.values() for form in encoder_cuda.FORMS}
    if not need <= branches:
        raise AssertionError(f"[kernels] encoder_conv plan branches never exercised: {sorted(need - branches)}")
    errs["encoder_conv"] = max(errs["encoder_conv"], halo_conv_checks(gen, torch.float32, "[kernels]"))
    hh, ww = 512, 768
    for y_form in ("in", "bn"):
        for skip_form in ("none", "in", "bn"):
            skip = torch.randn((2, 64, hh, ww), generator=gen, device=DEVICE)
            y = torch.randn((2, 64, hh, ww), generator=gen, device=DEVICE)
            aff_y, aff_s = affine_rows(gen, 2, y_form), affine_rows(gen, 2, skip_form)
            got = encoder_cuda.fused_join(skip, y, aff_y, y_form, aff_s, skip_form)
            torch.cuda.synchronize()
            want = encoder_cuda.plain_join(skip, y, aff_y, y_form, aff_s, skip_form)
            check("encoder_join", max_err(got, want), f"b2 {hh}x{ww} y {y_form} skip {skip_form}")
    for label, (h, w, layout, levels) in PYRAMID_CASES:
        f1, f2 = fmap_inputs(gen, 1, h, w, layout=layout)
        want = corr_cuda.corr_state(f1, f2, levels)
        p = corr_cuda.pyramid_plan_for(f1, f2, levels)
        got = corr_cuda.fused_pyramid_state(f1, f2, levels)
        torch.cuda.synchronize()
        if len(got) != levels:
            raise AssertionError(f"corr_pyramid returned {len(got)} levels at {label}, not {levels}")
        epilogue = "registers" if w % 4 == 0 and levels <= 6 else "shared memory"
        check("corr_pyramid", max(max_err(g, w_) for g, w_ in zip(got, want)),
              f"{label} (rows {h}, W1 = W2 = {w}, D 256, {levels} levels; tile {p.tile[0]}x{p.tile[1]}, "
              f"{4 * p.vec}-byte copies, {epilogue} epilogue, {p.blocks} blocks)")
        del f1, f2, want, got
    return errs


def phase_prefetch_paths(gen) -> dict:
    """Every plan branch of the windowed lookup (ops/corr_cuda.py
    `prefetch_plan`: the compile-time r = 4, 4-level instantiation, the
    generic one, the element path for unaligned levels) bit for bit against
    the dense kernel and exactly (NaN in the same places) against the plain
    version, at every PREFETCH_PATH_CASES entry, every coordinate family
    and all four (level, tap) dtype pairs; the last query's coordinate is
    W2 - 1.5, so its window reaches the end of the level's allocation.
    Logs the branch each case took and fails unless every branch ran with
    fp32 and with bf16 levels. Returns the max abs diff of the fp32 pair
    and of the pairs with a bf16 side."""
    errs = {"corr_prefetch_lookup": 0.0, "corr_prefetch_lookup_bf16": 0.0}
    branches = set()
    for label, (b, h, w1, w2, levels, radius, offset) in PREFETCH_PATH_CASES:
        base = tuple(torch.randn((b, h, w1, w2 >> l), generator=gen, device=DEVICE) for l in range(levels))
        for family in ("smooth", "edge", "special", "uniform"):
            coords = prefetch_coords(gen, family, b, h, w1, w2)
            coords.view(-1)[-1] = w2 - 1.5
            for level_dtype in (torch.float32, BF16):
                lvls = tuple((offset_view(gen, lvl.shape, level_dtype) if offset else lvl.to(level_dtype))
                             for lvl in base)
                for out_dtype in (torch.float32, BF16):
                    plan = corr_cuda.prefetch_plan_for(lvls, coords, radius, out_dtype)
                    got = corr_cuda.prefetch_corr_lookup(lvls, coords, radius, out_dtype)
                    dense = corr_cuda.corr_lookup(lvls, coords, radius, out_dtype)
                    torch.cuda.synchronize()
                    bitwise = bf16_bitwise(got, dense)
                    e = exact_err(got.float(), corr.corr_lookup(lvls, coords, radius).to(out_dtype).float())
                    key = "corr_prefetch_lookup_bf16" if BF16 in (level_dtype, out_dtype) else "corr_prefetch_lookup"
                    errs[key] = max(errs[key], e)
                    branches.add((plan.path, str(level_dtype)[6:]))
                    if not bitwise or not e <= TOL["corr_prefetch_lookup"]:
                        raise AssertionError(f"the windowed lookup disagrees at {label} {family} ({level_dtype}, "
                                             f"{out_dtype}; plan {plan}): bitwise {bitwise}, {e}")
        log(f"[prefetch-paths] {label} (batch {b}, {h}x{w1} queries, W2 {w2}, {levels} levels, radius {radius}; "
            f"plan branch {plan.path}, runs of {plan.run}, {plan.stages} stages, {plan.blocks} blocks): every "
            f"coordinate family, levels and taps fp32/bf16 (four pairs), bitwise equal to the dense kernel and exact "
            f"against the plain version (tol {TOL['corr_prefetch_lookup']:g})")
        del base
    need = {(path, dt) for path in corr_cuda.PREFETCH_PATHS for dt in ("float32", "bfloat16")}
    if not need <= branches:
        raise AssertionError(f"[prefetch-paths] plan branches never exercised: {sorted(need - branches)}")
    return errs


def scatter_inputs(gen, b, h, w1, w2, levels=4, radius=4):
    """The lookup's coordinates at the recipe's 1/4 resolution (mostly in
    range, 10% far outside on both sides) with the adversarial values in
    the first row (negative, 0, integral, W2_l - 1, W2, +-1e6, NaN, inf),
    and a unit-scale tap cotangent."""
    _, coords = lookup_inputs(gen, b, h, w1, w2, levels, radius)
    special = [-1.0, -3.5, 0.0, 3.0, float(w2), 1e6, -1e6, float("nan"), float("inf"), float("-inf")]
    special += [float(((w2 >> l) - 1) << l) for l in range(levels)]
    n = min(len(special), coords.numel())
    coords.view(-1)[:n] = torch.tensor(special[:n], device=DEVICE)
    grad = torch.randn((b, h, w1, levels * (2 * radius + 1)), generator=gen, device=DEVICE)
    return coords, grad, [w2 >> l for l in range(levels)]


def phase_scatter_kernels(gen) -> dict:
    """The scatter kernel against its plain version at the recipe's shape
    (bitwise reproducible: no atomics), and CorrLookup's d(pyramid) against
    autograd of the plain lookup."""
    b, h, w = TRAIN_BATCH, TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
    coords, grad, widths = scatter_inputs(gen, b, h, w, w)
    got = corr_cuda.corr_scatter(coords, grad, widths, 4)
    again = corr_cuda.corr_scatter(coords, grad, widths, 4)
    torch.cuda.synchronize()
    want = corr_cuda.plain_corr_scatter(coords, grad, widths, 4)
    err = max(max_err(g, w_) for g, w_ in zip(got, want))
    exact = all(bitwise_equal(g, w_) for g, w_ in zip(got, want))
    same = all(bitwise_equal(g, a) for g, a in zip(got, again))
    plan = corr_cuda.scatter_plan(coords.numel(), widths, 4)
    log(f"[kernels] corr_scatter b{b} {h}x{w} (W2 {w}, widths {widths}, adversarial coords; {plan.run} queries "
        f"per block, {plan.blocks} blocks): max abs diff {err:.3e} (tol {TOL['corr_scatter']:g}), bitwise plain "
        f"{exact}; two launches bitwise equal: {same}")
    if not err <= TOL["corr_scatter"] or not exact or not same:
        raise AssertionError(f"corr_scatter disagrees with its plain version ({err}) or is not reproducible")
    del got, again, want
    # The test cases' shapes: bitwise the plain version and across launches.
    for name, (cb, ch, cw1, cw2, levels, radius) in SCATTER_CASES.items():
        c_coords, c_grad, c_widths = scatter_inputs(gen, cb, ch, cw1, cw2, levels, radius)
        plan = corr_cuda.scatter_plan(c_coords.numel(), c_widths, radius)
        got = corr_cuda.corr_scatter(c_coords, c_grad, c_widths, radius)
        again = corr_cuda.corr_scatter(c_coords, c_grad, c_widths, radius)
        torch.cuda.synchronize()
        want = corr_cuda.plain_corr_scatter(c_coords, c_grad, c_widths, radius)
        exact = all(bitwise_equal(g, w_) for g, w_ in zip(got, want))
        same = all(bitwise_equal(g, a) for g, a in zip(got, again))
        log(f"[kernels] corr_scatter {name} ({c_coords.numel()} queries, widths {c_widths}, radius {radius}; "
            f"{plan.run} per block, {plan.blocks} blocks): bitwise plain {exact}; two launches bitwise equal: {same}")
        if not exact or not same:
            raise AssertionError(f"corr_scatter disagrees with its plain version or is not reproducible at {name}")
    finite = torch.isfinite(coords)
    coords = torch.where(finite, coords, torch.zeros_like(coords))
    levels = [torch.randn((b, h, w, wl), generator=gen, device=DEVICE).requires_grad_() for wl in widths]
    plain = [lvl.detach().clone().requires_grad_() for lvl in levels]
    corr_cuda.corr_lookup(levels, coords, 4).backward(grad)
    corr.corr_lookup(plain, coords, 4).backward(grad)
    torch.cuda.synchronize()
    err_ag = max(max_err(a.grad, p_.grad) for a, p_ in zip(levels, plain))
    tol = 2.0**-23 * (w + 3) * float(grad.abs().max().item())
    log(f"[kernels] CorrLookup d(pyramid) vs autograd of the plain lookup: max abs diff {err_ag:.3e} "
        f"(tol 2**-23 (W2 + 3) max|g| = {tol:.3e})")
    if not err_ag <= tol:
        raise AssertionError(f"CorrLookup's gradient disagrees with autograd of the plain lookup: {err_ag}")
    return {"corr_scatter": err}


def train_batch(rng, b, h, w, max_disp=48.0):
    """A synthetic training batch: a textured right image, a smooth
    per-pixel disparity d (a slanted plane plus ripples, 2..max_disp px),
    the left image sampled from the right at x - d (linear), flow = -d; a
    pixel is invalid where x - d leaves the image, and 5% more at random."""
    right = np.empty((b, h, w, 3), np.float32)
    left = np.empty_like(right)
    flow = np.empty((b, h, w, 1), np.float32)
    valid = np.empty((b, h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(b):
        # Texture: white noise blurred along x, at several scales.
        tex = rng.uniform(0, 255, (h, w + 4, 3)).astype(np.float32)
        tex = (tex[:, :-4] + tex[:, 1:-3] + tex[:, 2:-2] + tex[:, 3:-1] + tex[:, 4:]) / 5.0
        right[i] = tex
        a, bx, by = rng.uniform(0.3, 0.7), rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02)
        d = max_disp * (a + bx * (xs - w / 2) / 10 + by * (ys - h / 2) / 10
                        + 0.1 * np.sin(xs / rng.uniform(20, 60)) * np.cos(ys / rng.uniform(20, 60)))
        d = np.clip(d, 2.0, max_disp).astype(np.float32)
        src = xs - d
        x0 = np.floor(src).astype(np.int64)
        f = (src - x0)[..., None]
        x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
        row = np.arange(h)[:, None]
        left[i] = tex[row, x0c] * (1 - f) + tex[row, x1c] * f
        flow[i, ..., 0] = -d
        valid[i] = ((src >= 0) & (rng.uniform(0, 1, (h, w)) >= 0.05)).astype(np.float32)
    return {"image1": left, "image2": right, "flow": flow, "valid": valid}


def phase_train(rng) -> tuple:
    """The training step at the recipe: TRAIN_TIMED_STEPS timed steps, each
    with its launch counts, the first included (no warm step: at this
    shape a first step took 35.543 s against the next one's 35.065, cuDNN
    choosing its algorithms by heuristics, not by benchmark, and the script
    needs the minute). Returns (trainer, launch counts over the timed
    steps, a batch for the e2e check)."""
    h, w = TRAIN_HW
    cfg = TrainConfig(model=TRAIN_CONFIG, batch_size=TRAIN_BATCH, train_iters=TRAIN_ITERS, seed=SEED)
    t0 = time.perf_counter()
    batches = [train_batch(rng, TRAIN_BATCH, h, w) for _ in range(3)]
    log(f"[train] {len(batches)} synthetic batches of {TRAIN_BATCH}x{h}x{w} from seed {SEED}: "
        f"{time.perf_counter() - t0:.2f} s; valid share {np.mean([b_['valid'].mean() for b_ in batches]):.3f}")
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    per_step = expect(corr_lookup=TRAIN_ITERS, corr_scatter=TRAIN_ITERS)
    reset_launches()
    secs = []
    for i in range(TRAIN_TIMED_STEPS):
        before_counts = launches()
        t = time.perf_counter()
        m = trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        delta = {k: v - before_counts[k] for k, v in launches().items()}
        log(f"[train] step {trainer.step}: loss {m['live_loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"lr {m['learning_rate']:.6e}, epe {m['epe']:.4f}, {secs[-1]:.3f} s, launches {delta}")
        if not (np.isfinite(m["live_loss"]) and np.isfinite(m["grad_norm"]) and m["nonfinite"] == 0.0):
            raise AssertionError(f"training step {trainer.step} is not finite: {m}")
        if delta != per_step:
            raise AssertionError(f"training step {trainer.step}: kernel launches {delta} != expected {per_step}")
    totals = launches()
    changed = sum(not torch.equal(a, p_) for a, p_ in zip(before, trainer.model.parameters()))
    log(f"[train] median {statistics.median(secs):.3f} s/step over {TRAIN_TIMED_STEPS} steps "
        f"(all: {', '.join(f'{x:.3f}' for x in secs)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({torch.cuda.max_memory_allocated()} B); "
        f"{changed} of {len(before)} parameter tensors changed; launches over the timed steps {totals}")
    if changed == 0:
        raise AssertionError("training did not change the parameters")
    return trainer, totals, batches[0]


def step_grads(model_cfg, batch, batch_size=TRAIN_BATCH, iters=TRAIN_ITERS) -> tuple:
    """One Trainer step from the seed's weights: (metrics, {name: the
    step's clipped gradient})."""
    h, w = TRAIN_HW
    cfg = TrainConfig(model=model_cfg, batch_size=batch_size, train_iters=iters, seed=SEED)
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
    del trainer
    torch.cuda.empty_cache()
    return metrics, grads


def compare_steps(mk, gk, mp, gp) -> dict:
    """A step's metrics and gradients (kernel side `mk`, `gk`) against the
    plain side's: the loss's and the global norm's relative differences,
    and as (value, name) the worst parameter gradient's largest difference
    over its own largest value, outside and inside the feature-encoder
    trunk, and the larger side's largest value of the trunk's conv biases
    (true gradient zero: the instance norm after them removes any
    per-channel constant) over the model's largest gradient."""
    largest = float(max(g.abs().max().item() for g in gp.values()))
    out = {"loss": abs(mk["live_loss"] - mp["live_loss"]) / abs(mp["live_loss"]),
           "norm": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"],
           "grad": (0.0, ""), "fnet": (0.0, ""), "zero": (0.0, "")}
    for name, g in gp.items():
        a = gk[name]
        fnet_trunk = name.startswith("fnet.trunk.")
        if fnet_trunk and name.endswith(".bias") and "norm" not in name:
            noise = max(float(a.abs().max().item()), float(g.abs().max().item())) / largest
            out["zero"] = max(out["zero"], (noise, name))
            continue
        rel = max_err(a, g) / max(float(g.abs().max().item()), 1e-30)
        key = "fnet" if fnet_trunk else "grad"
        out[key] = max(out[key], (rel, name))
    return out


def report_steps(tag, mk, mp, d, tols) -> None:
    """Log `compare_steps`'s result `d` against `tols` (loss, norm, grad,
    fnet, zero) and raise where a bound is passed."""
    log(f"[{tag}] loss {mk['live_loss']:.7f} vs {mp['live_loss']:.7f} (rel {d['loss']:.3e}, tol {tols['loss']:g}); "
        f"grad_norm {mk['grad_norm']:.6f} vs {mp['grad_norm']:.6f} (rel {d['norm']:.3e}, tol {tols['norm']:g}); "
        f"worst parameter gradient {d['grad'][0]:.3e} of its max ({d['grad'][1]}, tol {tols['grad']:g}); "
        f"feature-encoder trunk worst {d['fnet'][0]:.3e} ({d['fnet'][1]}, tol {tols['fnet']:g}); its "
        f"zero-gradient biases at most {d['zero'][0]:.3e} of the largest gradient ({d['zero'][1]}, tol "
        f"{tols['zero']:g})")
    worst = {k: v if isinstance(v, float) else v[0] for k, v in d.items()}
    failed = [k for k in tols if not worst[k] <= tols[k]]
    if failed:
        raise AssertionError(f"[{tag}] the kernel configuration's training step disagrees with the plain one: "
                             f"{failed}")


def phase_train_e2e(batch) -> None:
    """One step of the kernel configuration against the plain one (the
    "reg" lookup, autograd through its gather) from the same seeded weights
    and batch: loss, global gradient norm, each parameter's gradient."""
    batch = {k: v[:TRAIN_E2E_BATCH] for k, v in batch.items()}
    mk, gk = step_grads(TRAIN_CONFIG, batch, batch_size=TRAIN_E2E_BATCH)
    mp, gp = step_grads(TRAIN_PLAIN_CONFIG, batch, batch_size=TRAIN_E2E_BATCH)
    log(f"[train-e2e] b{TRAIN_E2E_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_ITERS} iters, kernels vs plain "
        f"autograd")
    report_steps("train-e2e", mk, mp, compare_steps(mk, gk, mp, gp),
                 {"loss": TRAIN_LOSS_RTOL, "norm": TRAIN_NORM_RTOL, "grad": TRAIN_GRAD_TOL,
                  "fnet": TRAIN_FNET_GRAD_TOL, "zero": 1e-6})


def phase_bf16_scatter_kernels(gen) -> dict:
    """The bf16 scatter against its plain version, bit for bit and across
    launches, at SCATTER_BF16_CASES and SCATTER_CASES with the adversarial
    coordinates of `scatter_inputs` (far out, infinite, NaN), for a bf16 or
    fp32 cotangent into bf16 levels and a bf16 cotangent into fp32 levels
    (mixed compute over an fp32 pyramid); then CorrLookup's bf16 d(pyramid)
    against autograd of the plain bf16 lookup. Returns the max abs diff."""
    err = 0.0
    for name, (b, h, w1, w2, levels, radius) in {**SCATTER_BF16_CASES, **SCATTER_CASES}.items():
        coords, grad32, widths = scatter_inputs(gen, b, h, w1, w2, levels, radius)
        for grad_dtype, level_dtype in ((BF16, BF16), (torch.float32, BF16), (BF16, torch.float32)):
            grad = grad32.to(grad_dtype)
            dtypes = [level_dtype] * levels
            plan = corr_cuda.scatter_plan(coords.numel(), widths, radius, torch.finfo(level_dtype).bits // 8)
            got = corr_cuda.corr_scatter(coords, grad, widths, radius, dtypes)
            again = corr_cuda.corr_scatter(coords, grad, widths, radius, dtypes)
            torch.cuda.synchronize()
            want = corr_cuda.plain_corr_scatter(coords, grad, widths, radius, dtypes)
            bits = torch.int16 if level_dtype == BF16 else torch.int32
            exact = all(g.dtype == level_dtype and torch.equal(g.view(bits), w_.view(bits))
                        for g, w_ in zip(got, want))
            same = all(torch.equal(g.view(bits), a.view(bits)) for g, a in zip(got, again))
            e = max(max_err(g.float(), w_.float()) for g, w_ in zip(got, want))
            log(f"[bf16-kernels] corr_scatter_bf16 {name} ({coords.numel()} queries, widths {widths}, radius "
                f"{radius}; {plan.run} per block, {plan.blocks} blocks, {plan.vec} per vector store), cotangent "
                f"{str(grad_dtype)[6:]}, levels {str(level_dtype)[6:]}: bitwise plain {exact}, max abs diff {e:.3e} "
                f"(tol 0); two launches bitwise equal: {same}")
            if not exact or not same:
                raise AssertionError(f"corr_scatter_bf16 disagrees with its plain version or is not reproducible "
                                     f"at {name} ({grad_dtype}, {level_dtype})")
            err = max(err, e)
            del got, again, want
    # CorrLookup's bf16 d(pyramid) against autograd of the plain bf16
    # lookup at the bench's shape. The plain backward rounds each tap's
    # product to bf16 and adds a sample's two contributions in bf16; the
    # scatter rounds their fp32 sum once. Allowance per element: 1 bf16 ulp
    # of the contributions' summed magnitudes (the plain scatter of |g|),
    # 1 of the value, and the fp32 fraction term of the fp32 check.
    b, h, w = MIXED_TRAIN_BATCH, TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
    coords, grad32, widths = scatter_inputs(gen, b, h, w, w)
    coords = torch.where(torch.isfinite(coords), coords, torch.zeros_like(coords))
    grad = grad32.to(BF16)
    levels = [torch.randn((b, h, w, wl), generator=gen, device=DEVICE).to(BF16).requires_grad_() for wl in widths]
    plain = [lvl.detach().clone().requires_grad_() for lvl in levels]
    before = launches()["corr_scatter_bf16"]
    corr_cuda.corr_lookup(levels, coords, 4, BF16).backward(grad)
    corr.corr_lookup(plain, coords, 4).to(BF16).backward(grad)
    torch.cuda.synchronize()
    magnitude = corr_cuda.plain_corr_scatter(coords, grad.float().abs(), widths, 4)
    worst, shares = 0.0, []
    for a, p_, m in zip(levels, plain, magnitude):
        if a.grad.dtype != BF16 or p_.grad.dtype != BF16:
            raise AssertionError(f"bf16 levels' gradients are {a.grad.dtype} and {p_.grad.dtype}, not bf16")
        diff = (a.grad.float() - p_.grad.float()).abs()
        allow = (bf16_ulp(m) + bf16_ulp(torch.maximum(a.grad.float().abs(), p_.grad.float().abs()))
                 + 2.0**-23 * (w + 3) * float(grad.float().abs().max().item()))
        worst = max(worst, float((diff / allow).max().item()))
        shares.append(float((diff > 0).float().mean().item()))
    log(f"[bf16-kernels] CorrLookup bf16 d(pyramid) b{b} {h}x{w} vs autograd of the plain bf16 lookup: worst "
        f"element at {worst:.3f} of its allowance (1 bf16 ulp of the summed contributions + 1 of the value; tol 1), "
        f"share of elements that differ per level {', '.join(f'{x:.2e}' for x in shares)}; scatter launches "
        f"{launches()['corr_scatter_bf16'] - before}")
    if not worst <= 1.0 or launches()["corr_scatter_bf16"] != before + 1:
        raise AssertionError(f"CorrLookup's bf16 gradient disagrees with autograd of the plain lookup: {worst}")
    return {"corr_scatter_bf16": err}


def phase_mixed_train(rng) -> tuple:
    """The training step in the shipping numerics at the JAX bench's setup:
    one warm step, then timed steps with their launch counts, fp32
    parameter gradients and finite metrics. Returns (launch counts over the
    timed steps, a batch for the e2e check)."""
    h, w = TRAIN_HW
    b = MIXED_TRAIN_BATCH
    cfg = TrainConfig(model=MIXED_TRAIN_CONFIG, batch_size=b, train_iters=MIXED_TRAIN_ITERS, seed=SEED)
    batches = [train_batch(rng, b, h, w) for _ in range(3)]
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    m = trainer.train_step(batches[0])
    torch.cuda.synchronize()
    log(f"[mixed-train] b{b} {h}x{w}, {MIXED_TRAIN_ITERS} iters, bf16 compute and pyramid: warm step loss "
        f"{m['live_loss']:.6f}, grad_norm {m['grad_norm']:.6f}, {time.perf_counter() - t:.3f} s")
    per_step = expect(corr_lookup_bf16=MIXED_TRAIN_ITERS, corr_scatter_bf16=MIXED_TRAIN_ITERS)
    reset_launches()
    secs = []
    for i in range(MIXED_TRAIN_TIMED_STEPS):
        before_counts = launches()
        t = time.perf_counter()
        m = trainer.train_step(batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        delta = {k: v - before_counts[k] for k, v in launches().items()}
        log(f"[mixed-train] step {trainer.step}: loss {m['live_loss']:.6f}, grad_norm {m['grad_norm']:.6f}, "
            f"epe {m['epe']:.4f}, {secs[-1]:.3f} s, launches {delta}")
        if not (np.isfinite(m["live_loss"]) and np.isfinite(m["grad_norm"]) and m["nonfinite"] == 0.0):
            raise AssertionError(f"mixed training step {trainer.step} is not finite: {m}")
        if delta != per_step:
            raise AssertionError(f"mixed training step {trainer.step}: kernel launches {delta} != expected {per_step}")
    totals = launches()
    params = list(trainer.model.parameters())
    grad_dtypes = {str(p.grad.dtype) for p in params if p.grad is not None}
    changed = sum(not torch.equal(a, p_) for a, p_ in zip(before, params))
    log(f"[mixed-train] median {statistics.median(secs):.3f} s/step over {MIXED_TRAIN_TIMED_STEPS} steps "
        f"(all: {', '.join(f'{x:.3f}' for x in secs)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({torch.cuda.max_memory_allocated()} B); "
        f"{changed} of {len(before)} parameter tensors changed; parameter and gradient dtypes "
        f"{sorted({str(p.dtype) for p in params})} / {sorted(grad_dtypes)}; launches over the timed steps {totals}")
    if changed == 0:
        raise AssertionError("mixed training did not change the parameters")
    if grad_dtypes != {"torch.float32"} or any(p.grad is None or p.dtype != torch.float32 for p in params):
        raise AssertionError(f"mixed training: parameters or gradients not all fp32 ({grad_dtypes})")
    return totals, batches[0]


def phase_mixed_train_e2e(batch) -> None:
    """One mixed step of the kernel configuration against the plain one
    ("reg", autograd through the bf16 gather) from the same seeded weights
    and batch, cuDNN deterministic in both: loss, global norm, each
    parameter's gradient, by the MIXED_TRAIN_* bounds."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        mk, gk = step_grads(MIXED_TRAIN_CONFIG, batch, MIXED_TRAIN_BATCH, MIXED_TRAIN_ITERS)
        mp, gp = step_grads(MIXED_TRAIN_PLAIN_CONFIG, batch, MIXED_TRAIN_BATCH, MIXED_TRAIN_ITERS)
    log(f"[mixed-train-e2e] b{MIXED_TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, {MIXED_TRAIN_ITERS} iters, bf16, "
        f"kernels vs plain autograd, cuDNN deterministic")
    report_steps("mixed-train-e2e", mk, mp, compare_steps(mk, gk, mp, gp),
                 {"loss": MIXED_TRAIN_LOSS_RTOL, "norm": MIXED_TRAIN_NORM_RTOL, "grad": MIXED_TRAIN_GRAD_TOL,
                  "fnet": MIXED_TRAIN_FNET_GRAD_TOL, "zero": MIXED_TRAIN_ZERO_GRAD_TOL})


def phase_mixed_converge() -> None:
    """The JAX package's shipping-numerics convergence test, run by the
    port with the kernels: CONVERGE_STEPS fresh synthetic batches
    (`train/synthetic.py`, the port's copy of the test's generator), then
    the held-out EPE by `synthetic.validate_epe`. `main` runs it on a
    thread beside [spatial] (ii)-(iv) (`phase_train_cli(beside=...)`): a
    step is 0.23-0.29 s of host-bound dispatch on a card those ranks leave
    about 98% idle, and run alone it took a ninth of the script's limit.
    No other phase of this process launches a kernel meanwhile, so its
    launch counts stay its own."""
    h, w = CONVERGE_HW
    cfg = TrainConfig(model=MIXED_TRAIN_CONFIG, batch_size=CONVERGE_BATCH, num_steps=CONVERGE_STEPS,
                      train_iters=CONVERGE_ITERS, lr=CONVERGE_LR)
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    reset_launches()
    losses = []
    t = time.perf_counter()
    for step in range(CONVERGE_STEPS):
        m = trainer.train_step(synthetic.make_batch(np.random.default_rng((7, step)), CONVERGE_BATCH, h, w))
        losses.append(m["live_loss"])
        if step % 100 == 99:
            log(f"[mixed-converge] step {step + 1}: loss {m['live_loss']:.4f}, epe {m['epe']:.4f}, "
                f"grad_norm {m['grad_norm']:.4f}, {time.perf_counter() - t:.1f} s")
    train_s = time.perf_counter() - t
    counts = launches()
    t = time.perf_counter()
    epe = synthetic.validate_epe(trainer.model, h, w, n=8, iters=12)
    first, last = float(np.mean(losses[:100])), float(np.mean(losses[-100:]))
    log(f"[mixed-converge] {CONVERGE_STEPS} steps of b{CONVERGE_BATCH} {h}x{w}, {CONVERGE_ITERS} iters, lr "
        f"{CONVERGE_LR:g}: {train_s:.1f} s ({train_s / CONVERGE_STEPS * 1e3:.1f} ms/step), launches {counts}; mean "
        f"loss first 100 {first:.4f}, last 100 {last:.4f} (ratio {last / first:.4f}, criterion < "
        f"{CONVERGE_LOSS_RATIO}); held-out EPE {epe:.4f} px over 8 samples at 12 iters (criterion < "
        f"{CONVERGE_EPE_PX}; the JAX package's TPU calibration 0.734), {time.perf_counter() - t:.1f} s")
    want = expect(corr_lookup_bf16=CONVERGE_STEPS * CONVERGE_ITERS, corr_scatter_bf16=CONVERGE_STEPS * CONVERGE_ITERS)
    if counts != want:
        raise AssertionError(f"mixed convergence: kernel launches {counts} != expected {want}")
    if not (np.all(np.isfinite(losses)) and last < CONVERGE_LOSS_RATIO * first and epe < CONVERGE_EPE_PX):
        raise AssertionError(f"mixed convergence failed: loss {first} -> {last}, EPE {epe}")


def stereo_pair(rng, h, w, shift=12):
    """A textured pair whose right image is the left shifted by `shift` px."""
    left = rng.uniform(0, 255, (h, w + shift, 3)).astype(np.float32)
    return left[:, shift:], left[:, :w]


def phase_serving(rng) -> tuple:
    cfg = ServeConfig(model=KERNEL_CONFIG)
    t0 = time.perf_counter()
    service = StereoService(cfg, device="cuda", seed=SEED).start()
    warm = service.warm_summary
    log(f"[serving] boot + warm of {warm['combos']} (bucket, batch) combos: {time.perf_counter() - t0:.2f} s")
    for key in warm["prelude_ms"]:
        log(f"[serving] {key}: prelude {warm['prelude_ms'][key]:.3f} ms, "
            f"chunk of {cfg.chunk_iters} iters {warm['chunk_est_ms'][key]:.3f} ms")
    requests = REQUESTS
    reset_launches()
    iters_total = 0
    responses = []
    for label, (h, w), deadline_ms in requests:
        i1, i2 = stereo_pair(rng, h, w)
        res = service.submit(i1, i2, deadline_ms=deadline_ms).result()
        log(f"[serving] {label}: bucket {res['bucket']}, iters_completed {res['iters_completed']}, "
            f"early_exit {res['early_exit']}, latency {res['latency_ms']:.3f} ms")
        disp = res["disparity"]
        if disp.shape != (h, w) or not np.isfinite(disp).all():
            raise AssertionError(f"{label}: disparity shape {disp.shape} or non-finite values")
        iters_total += res["iters_completed"]
        responses.append((label, res))
    # The runner thread launches the kernels: let the batcher go idle.
    drain_service(service, "[serving]")
    counts = launches()
    log(f"[serving] launches over {len(requests)} requests ({iters_total} iterations): {counts}")
    if responses[-1][1]["iters_completed"] != cfg.chunk_iters or not responses[-1][1]["early_exit"]:
        raise AssertionError("the tight-deadline request did not exit after one chunk")
    if any(r["iters_completed"] != cfg.max_iters for _, r in responses[:-1]):
        raise AssertionError("a request without a deadline stopped short of max_iters")
    want = expect(corr_lookup=iters_total, gru_tail=3 * iters_total, motion_tail=iters_total)
    if counts != want:
        raise AssertionError(f"kernel launches {counts} != expected {want}")
    return service, counts


def drain_service(service, tag: str) -> None:
    """Wait until the batcher is idle (every admitted request answered:
    the runner thread has made its launches) and close the service, whose
    threads would otherwise keep its model alive."""
    if not service.drain(timeout_s=120):
        raise AssertionError(f"{tag}: the service did not drain within 120 s")


def phase_stage_times(service) -> None:
    """Steady-state prelude and chunk wall times per (bucket, batch), after
    warm-up: median of three synchronized calls each."""
    engine, cfg = service.engine, service.config
    with torch.inference_mode():
        for hw in cfg.buckets:
            for batch in cfg.batch_sizes:
                img = torch.zeros((batch, *hw, 3), device=DEVICE)
                pre, chk = [], []
                for _ in range(3):
                    t = time.perf_counter()
                    state = anytime.prelude(engine.model, img, img)
                    torch.cuda.synchronize()
                    pre.append(time.perf_counter() - t)
                for _ in range(3):
                    t = time.perf_counter()
                    state = anytime.chunk(engine.model, state, cfg.chunk_iters)
                    torch.cuda.synchronize()
                    chk.append(time.perf_counter() - t)
                log(f"[stages] {hw[0]}x{hw[1]}/b{batch}: prelude {statistics.median(pre) * 1e3:.3f} ms, "
                    f"chunk of {cfg.chunk_iters} iters {statistics.median(chk) * 1e3:.3f} ms "
                    f"(all chunks: {', '.join(f'{c * 1e3:.3f}' for c in chk)} ms)")


def phase_end_to_end(service, rng) -> None:
    """The kernel configuration against the plain one on the same weights."""
    kernel_model = service.engine.model
    with torch.device("meta"):
        plain_model = RAFTStereo(PLAIN_CONFIG)
    plain_model = plain_model.to_empty(device=DEVICE).eval()
    plain_model.load_state_dict(kernel_model.state_dict())
    i1, i2 = stereo_pair(rng, 384, 512)
    i1 = torch.from_numpy(i1[None]).cuda()
    i2 = torch.from_numpy(i2[None]).cuda()
    with torch.inference_mode():
        lo_k, up_k = kernel_model(i1, i2, iters=4, test_mode=True)
        lo_p, up_p = plain_model(i1, i2, iters=4, test_mode=True)
    torch.cuda.synchronize()
    err_up, err_lo = max_err(up_k, up_p), max_err(lo_k, lo_p)
    log(f"[e2e] 384x512, 4 iters, kernels vs plain: flow_up max abs diff {err_up:.3e} px, "
        f"flow_lowres {err_lo:.3e} px (tol {E2E_TOL_PX:g} px); |flow_up| max {up_k.abs().max().item():.3f}")
    if not (torch.isfinite(up_k).all() and err_up <= E2E_TOL_PX and err_lo <= E2E_TOL_PX):
        raise AssertionError("kernel configuration disagrees with the plain configuration")


def phase_serving_fused(rng, weights) -> tuple:
    """The fused-encoder configuration served like the kernel one, on the
    same weights; the launch counts are checked request by request."""
    cfg = ServeConfig(model=FUSED_CONFIG)
    t0 = time.perf_counter()
    service = StereoService(cfg, device="cuda", seed=SEED)
    service.engine.model.load_state_dict(weights)
    service.start()
    warm = service.warm_summary
    log(f"[fused] boot + warm of {warm['combos']} (bucket, batch) combos: {time.perf_counter() - t0:.2f} s")
    for key in warm["prelude_ms"]:
        log(f"[fused] {key}: prelude {warm['prelude_ms'][key]:.3f} ms, "
            f"chunk of {cfg.chunk_iters} iters {warm['chunk_est_ms'][key]:.3f} ms")
    reset_launches()
    totals = {k: 0 for k in launches()}
    for label, (h, w), deadline_ms in REQUESTS:
        before = launches()
        i1, i2 = stereo_pair(rng, h, w)
        res = service.submit(i1, i2, deadline_ms=deadline_ms).result()
        delta = {k: v - before[k] for k, v in launches().items()}
        it = res["iters_completed"]
        want = expect(corr_lookup=it, gru_tail=3 * it, motion_tail=it, corr_pyramid=1, encoder_conv=8,
                      encoder_join=4)
        log(f"[fused] {label}: bucket {res['bucket']}, iters_completed {it}, early_exit {res['early_exit']}, "
            f"latency {res['latency_ms']:.3f} ms, launches {delta}")
        disp = res["disparity"]
        if disp.shape != (h, w) or not np.isfinite(disp).all():
            raise AssertionError(f"fused {label}: disparity shape {disp.shape} or non-finite values")
        if delta != want:
            raise AssertionError(f"fused {label}: kernel launches {delta} != expected {want}")
        if deadline_ms is not None and (it != cfg.chunk_iters or not res["early_exit"]):
            raise AssertionError("fused: the tight-deadline request did not exit after one chunk")
        if deadline_ms is None and it != cfg.max_iters:
            raise AssertionError("fused: a request without a deadline stopped short of max_iters")
    drain_service(service, "[fused]")
    counts = launches()
    log(f"[fused] launches over {len(REQUESTS)} requests: {counts}")
    if any(counts[k] == 0 for k in ("corr_lookup", "gru_tail", "motion_tail", "corr_pyramid", "encoder_conv",
                                    "encoder_join")):
        raise AssertionError(f"a kernel of the fused path was never launched: {counts}")
    return service, counts


def phase_fused_end_to_end(kernel_service, fused_service, rng) -> None:
    """The fused configuration against the kernel one, same weights, one
    384x512 input: (a) the prelude state, (b) flow_up after 4 iterations."""
    km, fm = kernel_service.engine.model, fused_service.engine.model
    i1, i2 = stereo_pair(rng, 384, 512)
    i1 = torch.from_numpy(i1[None]).cuda()
    i2 = torch.from_numpy(i2[None]).cuda()
    with torch.inference_mode():
        sk = anytime.prelude(km, i1, i2)
        sf = anytime.prelude(fm, i1, i2)
        parts = {f"corr level {l}": (a, b) for l, (a, b) in enumerate(zip(sk["corr"], sf["corr"]))}
        parts.update({f"net {i}": (a, b) for i, (a, b) in enumerate(zip(sk["net"], sf["net"]))})
        parts.update({f"context {i}.{j}": (a, b) for i, (ck, cf) in enumerate(zip(sk["context"], sf["context"]))
                      for j, (a, b) in enumerate(zip(ck, cf))})
        worst = 0.0
        for name, (a, b) in parts.items():
            rel = max_err(a, b) / max(float(a.abs().max().item()), 1e-30)
            worst = max(worst, rel)
            log(f"[fused-e2e] prelude {name} {tuple(a.shape)}: max abs diff {max_err(a, b):.3e}, "
                f"relative to max |value| {rel:.3e}")
        _, up_k = anytime.finalize(km, anytime.chunk(km, sk, 4))
        _, up_f = anytime.finalize(fm, anytime.chunk(fm, sf, 4))
    torch.cuda.synchronize()
    err = max_err(up_k, up_f)
    # The worst pixel's share of its allowance: at most 1 to pass.
    share = float(((up_f - up_k).abs() / (FUSED_FLOW_TOL_PX + FUSED_FLOW_RTOL * up_k.abs())).max().item())
    log(f"[fused-e2e] prelude state worst relative diff {worst:.3e} (tol {FUSED_STATE_REL_TOL:g}); "
        f"flow_up after 4 iters max abs diff {err:.3e} px, worst pixel at {share:.3f} of "
        f"{FUSED_FLOW_TOL_PX:g} px + {FUSED_FLOW_RTOL:g} |flow| (tol 1); |flow_up| max {up_k.abs().max().item():.3f}")
    if not worst <= FUSED_STATE_REL_TOL:
        raise AssertionError(f"fused prelude state disagrees with the kernel configuration: {worst}")
    if not (torch.isfinite(up_f).all() and share <= 1.0):
        raise AssertionError(f"fused flow_up disagrees with the kernel configuration: {err} px, share {share}")


def phase_stage_compare(kernel_service, fused_service, reps=5) -> None:
    """Prelude and 4-iteration chunk per bucket at batch 1 for both
    configurations, taken in turns (kernel, fused, fused, kernel, ...):
    median synchronized wall time of `reps` calls each."""
    models = {"kernel": kernel_service.engine.model, "fused": fused_service.engine.model}
    with torch.inference_mode():
        for hw in kernel_service.config.buckets:
            img = torch.zeros((1, *hw, 3), device=DEVICE)
            times = {(name, stage): [] for name in models for stage in ("prelude", "chunk")}
            order = ["kernel", "fused", "fused", "kernel"] * ((reps + 1) // 2)
            for name in order[: 2 * reps]:
                model = models[name]
                t = time.perf_counter()
                state = anytime.prelude(model, img, img)
                torch.cuda.synchronize()
                times[(name, "prelude")].append(time.perf_counter() - t)
                t = time.perf_counter()
                anytime.chunk(model, state, 4)
                torch.cuda.synchronize()
                times[(name, "chunk")].append(time.perf_counter() - t)
            med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
            log(f"[stages-compare] {hw[0]}x{hw[1]}/b1: prelude kernel {med[('kernel', 'prelude')]:.3f} ms, "
                f"fused {med[('fused', 'prelude')]:.3f} ms (difference "
                f"{med[('kernel', 'prelude')] - med[('fused', 'prelude')]:.3f} ms); chunk of 4 kernel "
                f"{med[('kernel', 'chunk')]:.3f} ms, fused {med[('fused', 'chunk')]:.3f} ms")


# -- the fourth slice: windowed lookup, gate pair, evaluate --------------------

def exact_err(a, b) -> float:
    """Max abs difference, NaN in the same places required (inf otherwise)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    return max_err(a.masked_fill(nan_a, 0.0), b.masked_fill(nan_b, 0.0))


def taps_exact(got, want) -> bool:
    """The lookup's check against its plain version: the same dtype and
    shape, NaN in the same places and equal values elsewhere."""
    return got.dtype == want.dtype and got.shape == want.shape and exact_err(got.float(), want.float()) == 0.0


def dense_lookup_paths(gen, tag, pairs) -> dict:
    """The dense lookup (`corr_cuda.corr_lookup`, csrc/corr_lookup.cu) on
    every plan branch of `prefetch_plan` (usual, generic, element) at every
    DENSE_PATH_CASES entry and coordinate family, in the (level, tap) dtype
    `pairs`: exact against the plain version followed by one cast (NaN in
    the same places); the last query's coordinate is W2 - 1.5, so its
    window reaches the end of the level's allocation. Logs each case's
    branch under `tag` and fails unless every branch ran. Returns the max
    abs diff of the fp32 pair and of the pairs with a bf16 side."""
    errs = {"corr_lookup": 0.0, "corr_lookup_bf16": 0.0}
    branches = set()
    for label, (b, h, w1, w2, levels, radius, offset) in DENSE_PATH_CASES:
        base = tuple(torch.randn((b, h, w1, w2 >> l), generator=gen, device=DEVICE) for l in range(levels))
        for family in COORD_FAMILIES:
            coords = prefetch_coords(gen, family, b, h, w1, w2)
            coords.view(-1)[-1] = w2 - 1.5
            for level_dtype, out_dtype in pairs:
                lvls = tuple((offset_view(gen, lvl.shape, level_dtype) if offset else lvl.to(level_dtype))
                             for lvl in base)
                plan = corr_cuda.prefetch_plan_for(lvls, coords, radius, out_dtype)
                got = corr_cuda.corr_lookup(lvls, coords, radius, out_dtype)
                torch.cuda.synchronize()
                want = corr.corr_lookup(lvls, coords, radius).to(out_dtype)
                e = exact_err(got.float(), want.float())
                key = "corr_lookup_bf16" if BF16 in (level_dtype, out_dtype) else "corr_lookup"
                errs[key] = max(errs[key], e)
                branches.add(plan.path)
                if not taps_exact(got, want):
                    raise AssertionError(f"the dense lookup disagrees with its plain version at {label} {family} "
                                         f"({level_dtype}, {out_dtype}; plan {plan}): {e}")
        log(f"[{tag}] corr_lookup {label} (batch {b}, {h}x{w1} queries, W2 {w2}, {levels} levels, radius {radius}; "
            f"plan branch {plan.path}, runs of {plan.run}, {plan.stages} stages, {plan.blocks} blocks): every "
            f"coordinate family, (levels, taps) {', '.join(f'{str(a)[6:]}/{str(o)[6:]}' for a, o in pairs)}, exact "
            f"against the plain version (tol {TOL['corr_lookup']:g})")
        del base
    missing = set(corr_cuda.PREFETCH_PATHS) - branches
    if missing:
        raise AssertionError(f"[{tag}] dense lookup plan branches never exercised: {sorted(missing)}")
    return errs


def prefetch_coords(gen, family, b, h, w1, w2):
    """Lookup coordinates of one family: "smooth" (the model's regime: the
    grid minus a smooth disparity of up to W2 / 4), "edge" (a ramp past
    both ends of the row), "uniform" (uniform over the row and 6 past it:
    the input that defeats the TPU kernel's window plan), "special" (10%
    far outside, then in the first rows the float just below every
    integer, the integers, and NaN, +-inf, +-1e6, -1, W2 - 1, W2)."""
    base = torch.arange(w1, dtype=torch.float32, device=DEVICE).expand(b, h, w1)
    if family == "smooth":
        phase = torch.rand((b, h, 1), generator=gen, device=DEVICE) * 6.0
        disp = (w2 / 8) * (1.0 + torch.sin(torch.linspace(0, 3.0, w1, device=DEVICE) + phase))
        return (base - disp).contiguous()
    if family == "edge":
        return torch.linspace(-5.0, w2 + 5.0, w1, device=DEVICE).expand(b, h, w1).contiguous()
    if family == "uniform":
        return (torch.rand((b, h, w1), generator=gen, device=DEVICE) * (w2 + 12) - 6).contiguous()
    coords = base - torch.rand((b, h, w1), generator=gen, device=DEVICE) * (w2 / 4)
    far = (torch.rand((b, h, w1), generator=gen, device=DEVICE) - 0.5) * 4 * (w2 + 16)
    coords = torch.where(torch.rand((b, h, w1), generator=gen, device=DEVICE) < 0.1, far, coords).contiguous()
    flat = coords.view(-1)
    ints = torch.arange(w1, dtype=torch.float32, device=DEVICE)
    flat[:w1] = torch.nextafter(ints, torch.full_like(ints, -float("inf")))
    flat[w1:2 * w1] = ints
    special = [float("nan"), float("inf"), -float("inf"), 1e6, -1e6, -1.0, w2 - 1.0, float(w2)]
    flat[2 * w1:2 * w1 + len(special)] = torch.tensor(special, device=DEVICE)
    return coords


def phase_prefetch_kernels(gen) -> dict:
    """The windowed lookup against the dense kernel (bit for bit) and the
    plain version (exact, NaN where it has NaN) at the 512x768 bucket's 1/4
    resolution and at Middlebury-F's, every coordinate family."""
    err = 0.0
    for label, (h, w) in PREFETCH_CASES:
        pyramid = tuple(torch.randn((1, h, w, w >> l), generator=gen, device=DEVICE) for l in range(4))
        for family in ("smooth", "edge", "special", "uniform"):
            coords = prefetch_coords(gen, family, 1, h, w, w)
            got = corr_cuda.prefetch_corr_lookup(pyramid, coords, 4)
            dense = corr_cuda.corr_lookup(pyramid, coords, 4)
            torch.cuda.synchronize()
            bitwise = torch.equal(got.view(torch.int32), dense.view(torch.int32))
            e = exact_err(got, corr.corr_lookup(pyramid, coords, 4))
            log(f"[prefetch-kernels] {label} (queries {h}x{w}, W2 {w}) {family} coords: bitwise equal to the "
                f"dense kernel: {bitwise}; max abs diff to plain {e:.3e} (tol {TOL['corr_prefetch_lookup']:g})")
            if not bitwise or not e <= TOL["corr_prefetch_lookup"]:
                raise AssertionError(f"the windowed lookup disagrees at {label} {family}: bitwise {bitwise}, {e}")
            err = max(err, e)
        del pyramid
    return {"corr_prefetch_lookup": err}


def phase_gates_kernels(gen) -> dict:
    """rh and combine against their plain versions at the GRU's three
    scales of the 512x768 bucket and of Middlebury-F (and one size with a
    scalar tail only);
    combine against the fused GRU tail kernel, bit for bit."""
    errs = {"gates_rh": 0.0, "gates_combine": 0.0}
    cases = [(f"128x{hh // d}x{ww // d}", (1, 128, hh // d, ww // d))
             for hh, ww in ((512, 768), (1984, 2880)) for d in (4, 8, 16)]
    for label, shape in cases + [("scalar tail 3x5x7", (1, 3, 5, 7))]:
        zx, cz, qx, cq, h = (torch.randn(shape, generator=gen, device=DEVICE) * 2 for _ in range(5))
        rh = gates.fused_rh(zx, cz, h)
        combined = gates.fused_combine(zx, cz, qx, cq, h)
        tail = gru_tail.fused_gru_tail(zx, cz, qx, cq, h)
        torch.cuda.synchronize()
        e_rh = max_err(rh, gates.plain_rh(zx, cz, h))
        e_c = max_err(combined, gates.plain_combine(zx, cz, qx, cq, h))
        same = torch.equal(combined, tail)
        log(f"[gates-kernels] {label}: rh max abs diff {e_rh:.3e} (tol {TOL['gates_rh']:g}), combine "
            f"{e_c:.3e} (tol {TOL['gates_combine']:g}); combine bitwise equal to the gru_tail kernel: {same}")
        if not (e_rh <= TOL["gates_rh"] and e_c <= TOL["gates_combine"] and same):
            raise AssertionError(f"the gate kernels disagree at {label}: rh {e_rh}, combine {e_c}, tail {same}")
        errs = {"gates_rh": max(errs["gates_rh"], e_rh), "gates_combine": max(errs["gates_combine"], e_c)}
    return errs


def phase_evaluate() -> tuple:
    """The evaluate entry point at Middlebury-F size: `validate_middlebury`
    over one synthetic 1980x2870 pair in the evaluate configuration, 32
    iterations, with each image's forward seconds and launches; at 4
    iterations the evaluate configuration against the plain one, and the
    kernel configuration (the dense lookup) equal to it bit for bit; the
    gates configuration at 4 iterations (seconds, launches, and against its
    twin without the variable; a 32-iteration gates forward is left out to
    keep the script inside its time limit). Returns the launch counts of
    the evaluate run and of the gates forward, and the first image's
    flow."""
    dataset = SyntheticEvalDataset(n=1, shape=EVAL_SHAPE)
    model = build_model(EVAL_CONFIG, seed=SEED, device=DEVICE)
    evaluator = Evaluator(model, iters=EVAL_ITERS)
    record = []

    def timed(image1, image2):
        before = launches()
        flow, seconds = evaluator(image1, image2)
        record.append((flow, seconds, {k: v - before[k] for k, v in launches().items() if v != before[k]}))
        return flow, seconds

    os.environ.pop(gates.ENV_VAR, None)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    result = validate_middlebury(timed, dataset=dataset)
    wall = time.perf_counter() - t0
    eval_counts = launches()
    peak = torch.cuda.max_memory_allocated()
    per_image = expect(corr_prefetch_lookup=EVAL_ITERS, gru_tail=3 * EVAL_ITERS, motion_tail=EVAL_ITERS)
    for i, (flow, seconds, delta) in enumerate(record):
        log(f"[evaluate] image {i + 1}/{len(dataset)}, {EVAL_SHAPE[0]}x{EVAL_SHAPE[1]} padded to "
            f"{-(-EVAL_SHAPE[0] // 32) * 32}x{-(-EVAL_SHAPE[1] // 32) * 32}, "
            f"{EVAL_ITERS} iters: forward {seconds:.3f} s, launches {delta}")
        if expect(**delta) != per_image:
            raise AssertionError(f"evaluate image {i + 1}: launches {delta} != expected {per_image}")
        if flow.shape != EVAL_SHAPE or not np.isfinite(flow).all():
            raise AssertionError(f"evaluate image {i + 1}: flow shape {flow.shape} or non-finite values")
    log(f"[evaluate] metrics {result}; validate_middlebury {wall:.3f} s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} B); launches {eval_counts}")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError(f"evaluate metrics are not finite: {result}")

    item = dataset.get_item(0, None)
    pair = (item["image1"], item["image2"])
    # The evaluate configuration against the plain one ("reg", no fused
    # tail: every kernel's plain version) at a few iterations: the windowed
    # lookup and both tails held against plain code at Middlebury-F's shapes.
    plain = build_model(PLAIN_CONFIG, seed=SEED, device=DEVICE)
    plain.load_state_dict(model.state_dict())
    reset_launches()
    flow_plain, _ = Evaluator(plain, iters=E2E_ITERS)(*pair)
    plain_counts = launches()
    reset_launches()
    flow_eval, _ = Evaluator(model, iters=E2E_ITERS)(*pair)
    short_counts = launches()

    # The kernel configuration (the dense lookup) at the same iterations:
    # both lookups agree bit for bit in every call, so E2E_ITERS iterations
    # show it as 32 would.
    dense = build_model(KERNEL_CONFIG, seed=SEED, device=DEVICE)
    dense.load_state_dict(model.state_dict())
    dense_flow, _ = Evaluator(dense, iters=E2E_ITERS)(*pair)
    equal = np.array_equal(dense_flow, flow_eval)
    log(f"[evaluate] first image, {E2E_ITERS} iters, kernel configuration (dense lookup) vs evaluate "
        f"configuration (windowed lookup): flow_up bitwise equal {equal}, max abs diff "
        f"{np.abs(dense_flow - flow_eval).max():.3e}")
    if not equal:
        raise AssertionError("the evaluate configuration's flow differs from the dense kernel configuration's")
    del dense
    err = float(np.abs(flow_eval - flow_plain).max())
    log(f"[evaluate] first image, {E2E_ITERS} iters, evaluate configuration vs plain configuration: flow_up max "
        f"abs diff {err:.3e} px (tol {E2E_TOL_PX:g} px); |flow_up| max {np.abs(flow_plain).max():.3f}; launches "
        f"{short_counts}, plain {plain_counts}")
    it = E2E_ITERS
    if short_counts != expect(corr_prefetch_lookup=it, gru_tail=3 * it, motion_tail=it):
        raise AssertionError(f"evaluate configuration at {it} iters: launches {short_counts}")
    if plain_counts != expect():
        raise AssertionError(f"plain configuration launched kernels: {plain_counts}")
    if not (np.isfinite(flow_eval).all() and err <= E2E_TOL_PX):
        raise AssertionError(f"the evaluate configuration disagrees with the plain configuration: {err} px")
    del plain

    gated = build_model(GATES_CONFIG, seed=SEED, device=DEVICE)
    gated.load_state_dict(model.state_dict())
    ev = Evaluator(gated, iters=E2E_ITERS)
    os.environ[gates.ENV_VAR] = "1"
    try:
        reset_launches()
        flow_gates, seconds = ev(*pair)
        gates_counts = launches()
    finally:
        os.environ.pop(gates.ENV_VAR)
    reset_launches()
    flow_twin, _ = ev(*pair)
    twin_counts = launches()
    err = float(np.abs(flow_gates - flow_twin).max())
    log(f"[evaluate] gates configuration, first image, {E2E_ITERS} iters: forward {seconds:.3f} s, launches "
        f"{gates_counts}; against its twin without {gates.ENV_VAR}: flow_up max abs diff {err:.3e} px (tol "
        f"{E2E_TOL_PX:g} px); twin launches {twin_counts}")
    it = E2E_ITERS
    want = expect(corr_prefetch_lookup=it, gates_rh=3 * it, gates_combine=3 * it)
    if gates_counts != want:
        raise AssertionError(f"gates configuration: launches {gates_counts} != expected {want}")
    if twin_counts != expect(corr_prefetch_lookup=it):
        raise AssertionError(f"gates twin: launches {twin_counts} != expected only the windowed lookup")
    if not (np.isfinite(flow_gates).all() and err <= E2E_TOL_PX):
        raise AssertionError(f"the gates configuration disagrees with its twin: {err} px")
    return eval_counts, gates_counts, record[0][0]


def phase_evaluate_cli() -> None:
    """The evaluate entry point as a user runs it (`python -m
    raft_stereo_tpu_torch evaluate`) on its dry-run set, with the evaluate
    configuration's flags and no --device: the launch counts show that the
    default device is the card and that the CLI's model (drawn on the CPU,
    then moved) runs the kernels; its metrics against validate_middlebury
    on a model built on the card from the same seed."""
    argv = ["evaluate", "--dataset", "middlebury_F", "--dry_run", "--corr_implementation", "reg_cuda",
            "--fused_gru_tail", "--prefetch_lookup"]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launches()
    for line in out.getvalue().splitlines():
        log(f"[evaluate-cli] {line}")
    n = len(SyntheticEvalDataset())
    want = expect(corr_prefetch_lookup=n * EVAL_ITERS, gru_tail=3 * n * EVAL_ITERS, motion_tail=n * EVAL_ITERS)
    log(f"[evaluate-cli] {' '.join(argv)}: exit {rc}, {wall:.3f} s, launches {counts}")
    if rc != 0 or counts != want:
        raise AssertionError(f"evaluate CLI: exit {rc}, launches {counts} != expected {want}")
    found = re.search(r"Validation MiddleburyF: EPE (\S+), D1 (\S+)", out.getvalue())
    if found is None:
        raise AssertionError("evaluate CLI printed no validator line")
    got = [float(v) for v in found.groups()]
    evaluator = Evaluator(build_model(EVAL_CONFIG, seed=SEED, device=DEVICE), iters=EVAL_ITERS)
    with contextlib.redirect_stdout(io.StringIO()):
        want_metrics = list(validate_middlebury(evaluator, dataset=SyntheticEvalDataset()).values())
    # The CLI prints six decimals.
    ok = all(np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w) + 1e-6 for g, w in zip(got, want_metrics))
    log(f"[evaluate-cli] EPE, D1 {got} vs validate_middlebury on the card {want_metrics} (tol 1e-4 relative)")
    if not ok:
        raise AssertionError(f"evaluate CLI metrics {got} differ from validate_middlebury's {want_metrics}")


# -- the sixth slice: mixed precision --------------------------------------------

def bf16_ulp(x):
    """One bf16 ulp at |x| (bf16 values): 2**(e - 8) for |x| = m 2**e,
    m in [0.5, 1); 0 at 0."""
    _, e = torch.frexp(x.float())
    one = torch.ones_like(e, dtype=torch.float32)
    return torch.where(x == 0, torch.zeros_like(one), torch.ldexp(one, e - 8))


def conv_bf16_check(y, want, bias):
    """(worst share of the allowance used, share of elements that differ) of
    a bf16 conv output `y` against its plain version `want`: the conv's sum
    is rounded to bf16 before the bf16 bias is added, so a sum that rounds
    the other way moves the output by an ulp of the sum, whatever the
    output's own size: 1 bf16 ulp of the pre-bias sum (|y - bias|, widened by
    an ulp of y), plus 1 ulp of the output, plus BF16_SUM_FLOOR of the
    largest |output|."""
    b = bias.to(BF16).float()[None, :, None, None]
    g, w = y.float(), want.float()
    pre = torch.maximum((g - b).abs() + bf16_ulp(g), (w - b).abs() + bf16_ulp(w))
    allow = bf16_ulp(pre) + bf16_ulp(torch.maximum(g.abs(), w.abs())) + BF16_SUM_FLOOR * float(w.abs().max().item())
    diff = (g - w).abs()
    return float((diff / allow).max().item()), float((diff > 0).float().mean().item())


def pyramid_bf16_check(got, want):
    """Every level of a bf16 pyramid against its plain version, by the
    allowance of BF16_SUM_FLOOR: returns (worst share of the allowance used
    over the levels, max abs diff, share of elements that differ per level)."""
    allow, worst, shares = None, 0.0, []
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        own = bf16_ulp(torch.maximum(g.float().abs(), w.float().abs()))
        if allow is None:
            allow = own + BF16_SUM_FLOOR * float(w.float().abs().max().item())
        else:
            n = g.shape[-1]
            allow = (allow[..., 0:2 * n:2] + allow[..., 1:2 * n:2]) * 0.5 + own
        worst = max(worst, float((diff / allow).max().item()))
        err = max(err, float(diff.max().item()))
        shares.append(float((diff > 0).float().mean().item()))
    return worst, err, shares


def phase_bf16_kernels(gen) -> dict:
    """The four bf16 variants against their plain versions at the 512x768
    bucket's and Middlebury-F's shapes: the lookup at its four (level, tap)
    dtype pairs and the join exactly, the pyramid (every PYRAMID_BF16_CASES
    entry) and the conv (every form, with statistics) by BF16_SUM_FLOOR's
    allowance. Logs the plan branch each pyramid and conv shape took and
    the worst share of the allowance per kernel and branch, and fails
    unless every branch the plans can take ran: both pyramid kernels, every
    wgmma width, both conv input paths. Returns each variant's max abs
    diff."""
    errs = {"corr_lookup_bf16": 0.0, "corr_pyramid_bf16": 0.0, "encoder_conv_bf16": 0.0, "encoder_join_bf16": 0.0}
    worst_by_branch = {}
    for label, (h, w, layout, levels) in PYRAMID_BF16_CASES:
        f1, f2 = (f.to(BF16) for f in fmap_inputs(gen, 1, h, w, layout=layout))
        plan = corr_cuda.pyramid_plan_for(f1, f2, levels)
        got = corr_cuda.fused_pyramid_state(f1, f2, levels, BF16)
        torch.cuda.synchronize()
        want = corr_cuda.corr_state(f1, f2, levels, BF16)
        worst, err, shares = pyramid_bf16_check(got, want)
        branch = (f"wgmma {plan.tile[0]}x{plan.tile[1]}, {plan.stages} ring slots, {plan.blocks} persistent blocks"
                  if plan.path == "wgmma" else
                  f"mma.sync {plan.tile[0]}x{plan.tile[1]}, {2 * plan.vec}-byte copies, {plan.blocks} blocks")
        key = ("corr_pyramid_bf16", plan.path if plan.path == "mma" else f"wgmma N={plan.tile[1]}")
        worst_by_branch[key] = max(worst_by_branch.get(key, 0.0), worst)
        log(f"[bf16-kernels] corr_pyramid_bf16 {label} (rows {h}, W {w}, D 256, {levels} levels; plan branch "
            f"{branch}): max abs diff {err:.3e}, worst element at {worst:.3f} of its allowance (tol 1); share of "
            f"elements that differ per level {', '.join(f'{x:.2e}' for x in shares)}")
        if not (len(got) == levels and all(g.dtype == BF16 for g in got) and worst <= 1.0):
            raise AssertionError(f"corr_pyramid_bf16 disagrees with its plain version at {label}: {worst}")
        errs["corr_pyramid_bf16"] = max(errs["corr_pyramid_bf16"], err)
        del f1, f2, got, want
    for label, (h, w) in PREFETCH_CASES:
        pyramid, coords = lookup_inputs(gen, 1, h, w, w)
        for level_dtype in (torch.float32, BF16):
            levels = tuple(lvl.to(level_dtype) for lvl in pyramid)
            for out_dtype in (torch.float32, BF16):
                got = corr_cuda.corr_lookup(levels, coords, 4, out_dtype)
                torch.cuda.synchronize()
                want = corr.corr_lookup(levels, coords, 4).to(out_dtype)
                exact = taps_exact(got, want)
                err = max_err(got.float(), want.float())
                log(f"[bf16-kernels] corr_lookup {label} (queries {h}x{w}), levels {str(level_dtype)[6:]}, taps "
                    f"{str(out_dtype)[6:]}: exact {exact}, max abs diff {err:.3e} (tol 0)")
                if not exact:
                    raise AssertionError(f"corr_lookup disagrees with its plain version at {label} "
                                         f"({level_dtype}, {out_dtype})")
                if torch.bfloat16 in (level_dtype, out_dtype):
                    errs["corr_lookup_bf16"] = max(errs["corr_lookup_bf16"], err)
        del pyramid, coords
    errs["corr_lookup_bf16"] = max(errs["corr_lookup_bf16"], dense_lookup_paths(
        gen, "bf16-kernels", ((BF16, BF16), (BF16, torch.float32), (torch.float32, BF16)))["corr_lookup_bf16"])
    # The conv and the join at every BF16_CONV_SHAPES entry, in every
    # BF16_CONV_TRUNKS trunk.
    for hh, ww in BF16_CONV_SHAPES:
        for b, forms, y_form, emit in BF16_CONV_TRUNKS:
            for form in forms:
                x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
                x = x.to(BF16)
                y, stats = encoder_cuda.fused_conv(x, weight, bias, aff, form, emit_stats=emit)
                torch.cuda.synchronize()
                plan = encoder_cuda.conv_plan(b, hh, ww, _build.multiprocessors(0), _build.aligned((x, y)))
                path = "TMA raw tile, 16-byte stores" if plan.vec else "element by element"
                want, _ = encoder_cuda.plain_conv(x, weight, bias, aff, form, False)
                worst, share = conv_bf16_check(y, want, bias)
                key = ("encoder_conv_bf16", f"{path}, form {form}")
                worst_by_branch[key] = max(worst_by_branch.get(key, 0.0), worst)
                rel = stats_rel_err(stats, y) if emit else 0.0
                err = max_err(y.float(), want.float())
                log(f"[bf16-kernels] encoder_conv_bf16 b{b} {hh}x{ww} form {form} ({y_form} trunk; plan branch {path}, "
                    f"{plan.blocks} persistent blocks): max abs diff "
                    f"{err:.3e}, worst element at {worst:.3f} of its allowance (tol 1), share differing "
                    f"{share:.2e}; " + (f"statistics against the stored bf16 outputs rel diff {rel:.3e} (tol "
                                        f"{STATS_REL_TOL:g})" if emit else "no statistics"))
                if not (y.dtype == BF16 and worst <= 1.0 and rel <= STATS_REL_TOL and (stats is None) != emit):
                    raise AssertionError(f"encoder_conv_bf16 disagrees at b{b} {hh}x{ww} {form}: {worst}, {rel}")
                errs["encoder_conv_bf16"] = max(errs["encoder_conv_bf16"], err)
                del want, stats
                aff_y = affine_rows(gen, b, y_form)
                for skip_form in (("none", "in", "bn") if (hh, ww) == BF16_CONV_SHAPES[0] else (form,)):
                    aff_s = affine_rows(gen, b, skip_form)
                    got = encoder_cuda.fused_join(x, y, aff_y, y_form, aff_s, skip_form)
                    torch.cuda.synchronize()
                    exact = torch.equal(got, encoder_cuda.plain_join(x, y, aff_y, y_form, aff_s, skip_form))
                    log(f"[bf16-kernels] encoder_join_bf16 b{b} {hh}x{ww} y {y_form} skip {skip_form}: exact {exact} "
                        f"(tol 0)")
                    if not exact:
                        raise AssertionError(f"encoder_join_bf16 disagrees at b{b} {hh}x{ww} {y_form}/{skip_form}")
                    del got
                del x, y
    errs["encoder_conv_bf16"] = max(errs["encoder_conv_bf16"], halo_conv_checks(gen, BF16, "[bf16-kernels]"))
    for (name, branch), worst in sorted(worst_by_branch.items()):
        log(f"[bf16-kernels] {name} plan branch {branch}: worst element at {worst:.3f} of its allowance (tol 1)")
    branches = set(worst_by_branch)
    need = {("corr_pyramid_bf16", "mma")} | {("corr_pyramid_bf16", f"wgmma N={n}")
                                              for n in corr_cuda.PYRAMID_WGMMA_WIDTHS}
    need |= {("encoder_conv_bf16", f"{p}, form {f}") for p in ("TMA raw tile, 16-byte stores", "element by element")
             for f in encoder_cuda.FORMS}
    if not need <= branches:
        raise AssertionError(f"[bf16-kernels] plan branches never exercised: {sorted(need - branches)}")
    return errs


def mixed_service(weights) -> StereoService:
    cfg = ServeConfig(model=MIXED_CONFIG, buckets=(MIXED_BUCKET,))
    service = StereoService(cfg, device="cuda", seed=SEED)
    service.engine.model.load_state_dict(weights)
    return service.start()


def phase_mixed_serving(rng, weights) -> tuple:
    """The bench configuration served at the 512x768 bucket (every batch
    size warmed), on the kernel services' weights; the launch counts request
    by request: the bf16 pyramid once, 8 bf16 convs, 4 bf16 joins, one bf16
    lookup per iteration, nothing else."""
    t0 = time.perf_counter()
    service = mixed_service(weights)
    cfg, warm = service.config, service.warm_summary
    log(f"[mixed] boot + warm of {warm['combos']} (bucket, batch) combos: {time.perf_counter() - t0:.2f} s")
    for key in warm["prelude_ms"]:
        log(f"[mixed] {key}: prelude {warm['prelude_ms'][key]:.3f} ms, "
            f"chunk of {cfg.chunk_iters} iters {warm['chunk_est_ms'][key]:.3f} ms")
    reset_launches()
    for label, (h, w), deadline_ms in MIXED_REQUESTS:
        before = launches()
        i1, i2 = stereo_pair(rng, h, w)
        res = service.submit(i1, i2, deadline_ms=deadline_ms).result()
        delta = {k: v - before[k] for k, v in launches().items()}
        it = res["iters_completed"]
        want = expect(corr_lookup_bf16=it, corr_pyramid_bf16=1, encoder_conv_bf16=8, encoder_join_bf16=4)
        log(f"[mixed] {label}: bucket {res['bucket']}, iters_completed {it}, early_exit {res['early_exit']}, "
            f"latency {res['latency_ms']:.3f} ms, launches {delta}")
        disp = res["disparity"]
        if disp.shape != (h, w) or not np.isfinite(disp).all():
            raise AssertionError(f"mixed {label}: disparity shape {disp.shape} or non-finite values")
        if delta != want:
            raise AssertionError(f"mixed {label}: kernel launches {delta} != expected {want}")
        if deadline_ms is not None and (it != cfg.chunk_iters or not res["early_exit"]):
            raise AssertionError("mixed: the tight-deadline request did not exit after one chunk")
        if deadline_ms is None and it != cfg.max_iters:
            raise AssertionError("mixed: a request without a deadline stopped short of max_iters")
    drain_service(service, "[mixed]")
    counts = launches()
    log(f"[mixed] launches over {len(MIXED_REQUESTS)} requests: {counts}")
    return service, counts


def phase_mixed_e2e(service, rng) -> None:
    """The bench configuration against its twins on the same weights, at the
    512x768 bucket: (a) from one prelude state, 4 iterations with the bf16
    lookup kernel against the plain lookup ("reg"): bit for bit; (b) the
    fused prelude against the unfused one (direct convs, plain pyramid) by
    MIXED_STATE_ULPS; (c) the dtypes at the boundaries."""
    model = service.engine.model
    weights = model.state_dict()
    twins = {}
    for name, cfg in (("reg", MIXED_REG_CONFIG), ("unfused", MIXED_UNFUSED_CONFIG)):
        twin = build_model(cfg, seed=SEED, device=DEVICE)
        twin.load_state_dict(weights)
        twins[name] = twin
    i1, i2 = (torch.from_numpy(x[None]).to(DEVICE) for x in stereo_pair(rng, *MIXED_BUCKET))
    with torch.inference_mode():
        state = anytime.prelude(model, i1, i2)
        dtypes = {"net": state["net"][0].dtype, "context": state["context"][0][0].dtype,
                  "corr": state["corr"][0].dtype, "coords": state["coords1"].dtype}
        reset_launches()
        out_k = anytime.finalize(model, anytime.chunk(model, state, 4))
        k_counts = launches()
        reset_launches()
        out_p = anytime.finalize(twins["reg"], anytime.chunk(twins["reg"], state, 4))
        p_counts = launches()
        unfused = anytime.prelude(twins["unfused"], i1, i2)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    names = ", ".join(f"{k} {str(v)[6:]}" for k, v in dtypes.items())
    log(f"[mixed-e2e] {MIXED_BUCKET[0]}x{MIXED_BUCKET[1]}, dtypes {names}; 4 iterations "
        f"from one prelude state, the bf16 lookup kernel vs the plain lookup: flow bitwise equal {same} "
        f"(|flow_up| max {out_k[1].abs().max().item():.3f}); launches {k_counts}, plain {p_counts}")
    if dtypes != {"net": BF16, "context": BF16, "corr": BF16, "coords": torch.float32}:
        raise AssertionError(f"mixed state dtypes {dtypes}")
    if not same or out_k[1].dtype != torch.float32 or not torch.isfinite(out_k[1]).all():
        raise AssertionError("the mixed iteration path disagrees with its plain twin")
    if k_counts != expect(corr_lookup_bf16=4) or p_counts != expect():
        raise AssertionError(f"mixed e2e launches {k_counts}, plain {p_counts}")
    check_bf16_prelude("[mixed-e2e]", state, unfused)


def prelude_parts(fused, unfused) -> dict:
    """{name: (fused, unfused)} of two prelude states: the correlation
    levels, the context, and the hidden state (printed only, "(printed)")."""
    parts = {f"corr level {l}": (a, b) for l, (a, b) in enumerate(zip(fused["corr"], unfused["corr"]))}
    parts.update({f"context {i}.{j}": (a, b) for i, (cf, cu) in enumerate(zip(fused["context"], unfused["context"]))
                  for j, (a, b) in enumerate(zip(cf, cu))})
    parts.update({f"net {i} (printed)": (a, b) for i, (a, b) in enumerate(zip(fused["net"], unfused["net"]))})
    return parts


def check_bf16_prelude(tag, fused, unfused) -> None:
    """The fused bf16 prelude state against the unfused one, by
    MIXED_STATE_ULPS of each tensor's largest magnitude."""
    for name, (a, b) in prelude_parts(fused, unfused).items():
        scale = float(b.float().abs().max().item())
        ulps = max_err(a.float(), b.float()) / float(bf16_ulp(torch.tensor(scale)).item())
        share = float((a != b).float().mean().item())
        log(f"{tag} fused vs unfused prelude {name} {tuple(a.shape)}: max abs diff "
            f"{max_err(a.float(), b.float()):.3e} = {ulps:.2f} bf16 ulps of the largest |value| {scale:.3f} "
            f"(tol {MIXED_STATE_ULPS}), share differing {share:.3f}")
        if "printed" not in name and not ulps <= MIXED_STATE_ULPS:
            raise AssertionError(f"{tag} the fused prelude disagrees with the unfused one at {name}: {ulps} ulps")


def phase_mixed_budget() -> None:
    """The bf16 pyramid's accuracy budget on the card (`evaluate.corr_precision`:
    fp32 compute, the fused encoder and the lookup kernel, the bf16 pyramid
    kernel against the fp32 one, 2 iterations on the JAX package's synthetic
    plane pair at 128x192): the EPE delta within BF16_CORR_EPE_BUDGET_PX;
    and the same pair's EPE with the bench configuration (bf16 compute too)."""
    reset_launches()
    got = evaluate.corr_precision(RAFTStereoConfig(corr_implementation="pallas", fused_encoder=True), seed=SEED)
    counts = launches()
    mixed = evaluate.corr_precision(MIXED_CONFIG, seed=SEED)
    log(f"[mixed-budget] 128x192, 2 iters, fp32 compute: EPE fp32 pyramid {got['epe_fp32_px']:.6f} px, bf16 "
        f"pyramid {got['epe_bf16_px']:.6f} px, delta {got['delta_px']:.6f} px (budget {got['budget_px']} px); "
        f"launches {counts}; with bf16 compute (the bench configuration) EPE {mixed['epe_bf16_px']:.6f} px")
    if counts != expect(corr_pyramid=1, corr_pyramid_bf16=1, encoder_conv=16, encoder_join=8, corr_lookup=2,
                        corr_lookup_bf16=2):
        raise AssertionError(f"corr_precision launches {counts}")
    if not got["delta_px"] <= got["budget_px"]:
        raise AssertionError(f"the bf16 pyramid's EPE delta {got['delta_px']} exceeds the budget")


def phase_mixed_evaluate(fp32_flow) -> dict:
    """The evaluate entry point in the bench configuration: one synthetic
    Middlebury-F-sized pair (1980x2870, padded to 1984x2880 on the card), 32
    iterations, batch 1: seconds, peak memory, launches, and the flow
    against the fp32 evaluate configuration's on the same weights and image
    (`fp32_flow`, printed: over 32 iterations of an untrained GRU the gap
    is chaotic, see the budget check for the bounded regime)."""
    dataset = SyntheticEvalDataset(n=1, shape=EVAL_SHAPE)
    model = build_model(MIXED_CONFIG, seed=SEED, device=DEVICE)
    evaluator = Evaluator(model, iters=EVAL_ITERS)
    item = dataset.get_item(0, None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    flow, seconds = evaluator(item["image1"], item["image2"])
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    flow2, seconds2 = evaluator(item["image1"], item["image2"])
    want = expect(corr_lookup_bf16=EVAL_ITERS, corr_pyramid_bf16=1, encoder_conv_bf16=8, encoder_join_bf16=4)
    gap = np.abs(flow - fp32_flow)
    log(f"[mixed-evaluate] {EVAL_SHAPE[0]}x{EVAL_SHAPE[1]} padded to {-(-EVAL_SHAPE[0] // 32) * 32}x"
        f"{-(-EVAL_SHAPE[1] // 32) * 32}, {EVAL_ITERS} iters, batch 1: "
        f"forward {seconds:.3f} s, again {seconds2:.3f} s; peak memory {peak / 2**30:.2f} GiB ({peak} B); "
        f"launches {counts}; flow bitwise equal across the two runs {np.array_equal(flow, flow2)}; against the fp32 "
        f"evaluate configuration: mean |diff| {gap.mean():.4f} px, max {gap.max():.4f} px, |flow| mean "
        f"{np.abs(fp32_flow).mean():.4f} px")
    if counts != want:
        raise AssertionError(f"mixed evaluate: launches {counts} != expected {want}")
    if flow.shape != EVAL_SHAPE or not np.isfinite(flow).all():
        raise AssertionError(f"mixed evaluate: flow shape {flow.shape} or non-finite values")
    return counts


def phase_mixed_cli() -> None:
    """`evaluate --mixed_precision --corr_implementation reg_cuda
    --fused_encoder --dry_run`, as a user runs it (the bf16 pyramid by the
    JAX CLI's rule): exit 0, the bf16 kernels' launches per image, and the
    metrics of validate_middlebury on the bench configuration built on the
    card from the same seed."""
    argv = ["evaluate", "--dataset", "middlebury_F", "--dry_run", "--mixed_precision", "--corr_implementation",
            "reg_cuda", "--fused_encoder"]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launches()
    for line in out.getvalue().splitlines():
        log(f"[mixed-cli] {line}")
    n = len(SyntheticEvalDataset())
    want = expect(corr_lookup_bf16=n * EVAL_ITERS, corr_pyramid_bf16=n, encoder_conv_bf16=8 * n,
                  encoder_join_bf16=4 * n)
    log(f"[mixed-cli] {' '.join(argv)}: exit {rc}, {wall:.3f} s, launches {counts}")
    if rc != 0 or counts != want:
        raise AssertionError(f"mixed evaluate CLI: exit {rc}, launches {counts} != expected {want}")
    found = re.search(r"Validation MiddleburyF: EPE (\S+), D1 (\S+)", out.getvalue())
    if found is None:
        raise AssertionError("mixed evaluate CLI printed no validator line")
    got = [float(v) for v in found.groups()]
    evaluator = Evaluator(build_model(MIXED_CONFIG, seed=SEED, device=DEVICE), iters=EVAL_ITERS)
    with contextlib.redirect_stdout(io.StringIO()):
        want_metrics = list(validate_middlebury(evaluator, dataset=SyntheticEvalDataset()).values())
    ok = all(np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w) + 1e-6 for g, w in zip(got, want_metrics))
    log(f"[mixed-cli] EPE, D1 {got} vs validate_middlebury on the card {want_metrics} (tol 1e-4 relative)")
    if not ok:
        raise AssertionError(f"mixed evaluate CLI metrics {got} differ from validate_middlebury's {want_metrics}")


# -- the twelfth slice: the serving front ------------------------------------------

# [serving-front]: the kernel configuration at the default buckets, max
# batch 4, chunk 4, 32 iterations, streams on, the hang watchdog armed,
# behind the HTTP front. FRONT_CLIENTS client threads send FRONT_HTTP_BURST
# (each image new, so every response maps back to its batch row by its
# padded pixels); then one tight-deadline request alone (a queue would
# shed it).
FRONT_TIGHT_MS = 1.0
# serve_compare.py's FRONT_BURST with each count halved (rounded up): 18
# requests of its 31 and the same mix of buckets, padding and an oversize
# pair. The host's JSON work made the whole burst 45 s of the script's
# 1200 s limit, and each answer is replayed and forwarded again below.
FRONT_HTTP_BURST = tuple((label, hw, -(-n // 2)) for label, hw, n in FRONT_BURST)
# Iterations at which each batch is replayed against its pairs' batch-1
# direct forwards, where the serving bound is held (as in [e2e]).
FRONT_DRIFT_ITERS = (E2E_ITERS,)
FRONT_WARM_ITERS = 8
FRONT_HANG_S = 60.0
FRONT_STREAM_HW = (300, 400)
FRONT_WAIT_S = 300
# [serve-cli]: `python -m raft_stereo_tpu_torch serve` as a user starts it
# (no --device: the card), in the kernel configuration and in the JAX
# bench's mixed one.
SERVE_CLI_CONFIGS = (
    ("kernel", ["--corr_implementation", "pallas", "--fused_gru_tail"]),
    ("mixed", ["--corr_implementation", "reg_cuda", "--mixed_precision", "--fused_encoder", "--fused_gru_tail"]),
)
SERVE_CLI_REQUESTS = ((384, 512), (512, 768), (300, 500))
SERVE_CLI_BOOT_S = 300


def int_pair(rng, h, w, shift=12):
    """A stereo pair of integer intensities: a JSON body carries them
    exactly, and they encode faster than floats."""
    return tuple(np.floor(x) for x in stereo_pair(rng, h, w, shift))


def json_image(x: np.ndarray) -> list:
    return x.astype(np.int32).tolist()


class StagedRecorder:
    """Keeps every batch the runner ran (its padded host images and its
    results) by wrapping the engine's `run_staged`; launches nothing."""

    def __init__(self, engine):
        self.engine, self.batches = engine, []
        self._run = engine.run_staged
        engine.run_staged = self.run

    def run(self, staged):
        results = self._run(staged)
        self.batches.append((staged.bucket, staged.i1_host, staged.i2_host, results))
        return results

    def close(self) -> None:
        self.engine.run_staged = self._run


def wait_idle(service, timeout_s: float = 120.0) -> None:
    """Until every admitted request is answered; the service stays open."""
    deadline = time.monotonic() + timeout_s
    while True:
        with service.batcher._cond:
            if service.batcher._pending == 0:
                return
        if time.monotonic() > deadline:
            raise AssertionError("the batcher did not go idle")
        time.sleep(0.01)


def post_predict(url, a, b, **extra):
    resp = request_json(f"{url}/v1/predict", method="POST", timeout_s=FRONT_WAIT_S,
                        payload={"image1": json_image(a), "image2": json_image(b), **extra})
    return resp.status, resp.json()


def low_contrast(x):
    """The stream's scene: 10% contrast, so the untrained model's flow warps
    each frame about as well as the one before (the reset gate's ratio near
    1), while a cut to full-contrast noise raises the warp error tenfold."""
    return np.floor(120.0 + 0.1 * (x - 127.5))


def mild_model(config: RAFTStereoConfig) -> RAFTStereo:
    """The seed's weights with every conv kernel halved, as the CPU parity
    tests' models (tests/test_torch_model.py `weights`): at the full
    fan-out He scale the untrained GRU amplifies fp32 rounding chaotically,
    so over 32 iterations two correct fp32 runs that round differently
    (a batch of 4 against a batch of 1) drift apart by far more than the
    serving bound; halved kernels keep that drift near rounding while the
    flows still move by pixels."""
    model = build_model(config, seed=SEED, device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
    return model.to(DEVICE)


@contextlib.contextmanager
def batch_invariant(norm_per_image: bool = True):
    """Pin the two reductions whose order depends on the batch: cuDNN off
    (PyTorch's own convolution runs one image at a time) and, with
    `norm_per_image`, the instance norm's sums over H x W taken one image
    at a time (PyTorch's reduction splits them by the number of rows). On
    an H100 the two together make a batched row equal its batch-1 forward
    bit for bit; cuDNN off alone does not."""
    forward = layers.InstanceNorm.forward

    def per_image(self, x):
        return torch.cat([forward(self, x[k:k + 1]) for k in range(x.shape[0])])

    with torch.backends.cudnn.flags(enabled=False):
        if not norm_per_image:
            yield
            return
        with swapped(layers.InstanceNorm, forward=per_image):
            yield


def phase_serving_front(rng, card: str) -> None:
    video = VideoConfig(chunk_iters=4, cold_iters=32, warm_iters=FRONT_WARM_ITERS)
    cfg = ServeConfig(model=KERNEL_CONFIG, video=video, hang_timeout_s=FRONT_HANG_S)
    t0 = time.perf_counter()
    service = StereoService(cfg, mild_model(KERNEL_CONFIG), device=DEVICE).start()
    log(f"[serving-front] boot + warm of {service.warm_summary['combos']} (bucket, batch) combos with the "
        f"flow_init prelude: {time.perf_counter() - t0:.2f} s")
    server = make_http_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, name="http-front", daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    recorder = StagedRecorder(service.engine)
    try:
        front_traffic(service, url, recorder, rng, card)
        front_streams(service, url, rng)
        front_reload(service, url, rng)
    finally:
        recorder.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        drain_service(service, "[serving-front]")


def front_traffic(service, url, recorder, rng, card) -> None:
    engine, cfg = service.engine, service.config
    jobs = [(label, *int_pair(rng, h, w)) for label, (h, w), n in FRONT_HTTP_BURST for _ in range(n)]
    jobs = [jobs[i] for i in rng.permutation(len(jobs))]
    answers = [None] * len(jobs)
    errors = []

    def client(k):
        try:
            for i in range(k, len(jobs), FRONT_CLIENTS):
                t = time.perf_counter()
                status, body = post_predict(url, jobs[i][1], jobs[i][2])
                answers[i] = (status, body, (time.perf_counter() - t) * 1e3)
        except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
            errors.append(repr(exc))

    reset_launches()
    before_log = len(service.batcher.metrics.batch_log)
    t_burst = time.perf_counter()
    clients = [threading.Thread(target=client, args=(k,), name=f"client-{k}") for k in range(FRONT_CLIENTS)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=FRONT_WAIT_S)
    burst_s = time.perf_counter() - t_burst
    if errors or any(c.is_alive() for c in clients) or any(a is None for a in answers):
        raise AssertionError(f"[serving-front] clients failed: {errors}")
    tight = int_pair(rng, *cfg.buckets[-1])
    status, tight_body = post_predict(url, *tight, deadline_ms=FRONT_TIGHT_MS)
    jobs.append(("tight deadline", *tight))
    answers.append((status, tight_body, tight_body.get("latency_ms", 0.0)))
    wait_idle(service)
    counts = launches()
    batches = list(recorder.batches)
    log_entries = list(service.batcher.metrics.batch_log)[before_log:]

    # Status codes, shapes, finite values.
    for (label, a, _), (status, body, _) in zip(jobs, answers):
        want = 413 if label.startswith("oversize") else 200
        if status != want:
            raise AssertionError(f"[serving-front] {label}: HTTP {status} != {want}: {str(body)[:300]}")
        if status == 200:
            d = np.asarray(body["disparity"], np.float32)
            if d.shape != a.shape[:2] or not np.isfinite(d).all():
                raise AssertionError(f"[serving-front] {label}: disparity {d.shape} or non-finite values")
    if not (tight_body["early_exit"] and tight_body["iters_completed"] == cfg.chunk_iters):
        raise AssertionError(f"[serving-front] the tight-deadline request did not exit after one chunk: "
                             f"{tight_body['iters_completed']}")

    # Batches: no bucket mixed, at least one coalesced, launches per batch.
    if not any(real > 1 for _, real, _ in log_entries):
        raise AssertionError(f"[serving-front] no batch held more than one request: {log_entries}")
    if [(tuple(b), len(res), i1.shape[0]) for b, i1, _, res in batches] != [
            (tuple(b), real, padded) for b, real, padded in log_entries]:
        raise AssertionError("[serving-front] the recorded batches disagree with the batch log")
    if any(tuple(i1.shape[1:3]) != tuple(b) for b, i1, _, _ in batches):
        raise AssertionError("[serving-front] a batch mixed shapes")
    batch_iters = sum(max(r.iters_completed for r in res) for _, _, _, res in batches)
    request_iters = sum(body["iters_completed"] for (_, body, _) in answers if "iters_completed" in body)
    want = expect(corr_lookup=batch_iters, gru_tail=3 * batch_iters, motion_tail=batch_iters)
    log(f"[serving-front] {len(jobs)} requests over HTTP from {FRONT_CLIENTS} clients in {len(batches)} batches "
        f"(bucket, real, padded): {[(f'{b[0]}x{b[1]}', r, p) for b, r, p in log_entries]}")
    log(f"[serving-front] launches {counts}: {batch_iters} iterations summed over batches, {request_iters} over "
        f"requests")
    if counts != want:
        raise AssertionError(f"[serving-front] launches {counts} != per-batch expectation {want}")
    if not batch_iters < request_iters:
        raise AssertionError("[serving-front] the kernels ran once per request, not once per batch")

    # Each response: bit for bit the engine's own batch replayed; and the
    # batch, replayed at E2E_ITERS iterations, within the serving bound of
    # each pair's batch-1 direct forward, as [e2e] holds it. As served (32
    # iterations) a coalesced row drifts from its batch-1 forward past the
    # bound: the untrained GRU amplifies the rounding by which two correct
    # fp32 runs differ. The witness for the cause: every coalesced batch
    # replayed as served and each of its pairs' batch-1 forwards, both
    # under `batch_invariant` (below), are held to the bound at the served
    # iterations; the drift with cuDNN off alone and as served is printed.
    rows = {}
    for bi, (bucket, i1, _, _) in enumerate(batches):
        for r in range(len(batches[bi][3])):
            rows.setdefault((tuple(bucket), i1[r, :4, :4].tobytes()), []).append((bi, r))
    replays = {}

    def replay(bi, iters):
        """Batch `bi` through engine.run_batch, each row to its own
        iteration count (an int: all rows alike)."""
        bucket, i1, i2, res = batches[bi]
        iters = tuple(iters) if isinstance(iters, list) else (iters,) * len(res)
        if (bi, iters) not in replays:
            replays[(bi, iters)] = engine.run_batch(
                tuple(bucket), torch.from_numpy(i1).to(DEVICE), torch.from_numpy(i2).to(DEVICE),
                deadlines_s=[None] * len(res), max_iters=list(iters))
        return replays[(bi, iters)]

    ladder = [k for k in FRONT_DRIFT_ITERS if k <= cfg.max_iters]
    drift = {k: 0.0 for k in (*ladder, "served", "coalesced", "cudnn off", "pinned")}
    pinned_s = 0.0
    with torch.inference_mode():
        for bi, (_, _, _, res) in enumerate(batches):
            again = replay(bi, [r.iters_completed for r in res])
            if not all(np.array_equal(x.flow_up, y.flow_up) for x, y in zip(res, again)):
                raise AssertionError(f"[serving-front] batch {bi} replayed through engine.run_batch differs")
        for (label, a, b), (status, body, _) in zip(jobs, answers):
            if status != 200:
                continue
            bucket, padder, p1, p2 = service._admit(a, b)
            hits = [(bi, r) for bi, r in rows.get((tuple(bucket), p1[:4, :4].tobytes()), [])
                    if np.array_equal(batches[bi][1][r], p1) and np.array_equal(batches[bi][2][r], p2)]
            if len(hits) != 1:
                raise AssertionError(f"[serving-front] {label}: {len(hits)} batch rows hold its padded pair")
            bi, r = hits[0]
            got = np.asarray(body["disparity"], np.float32)
            served = [x.iters_completed for x in batches[bi][3]]
            if not np.array_equal(got, padder.unpad(replay(bi, served)[r].flow_up[None])[0, :, :, 0]):
                raise AssertionError(f"[serving-front] {label}: the response differs from its batch's replay")
            x1, x2 = (torch.from_numpy(p[None]).to(DEVICE) for p in (p1, p2))
            for k in (*ladder, "served"):
                iters = body["iters_completed"] if k == "served" else k
                _, up = engine.model(x1, x2, iters=iters, test_mode=True)
                direct = padder.unpad(up.float().cpu().numpy())[0, :, :, 0]
                row = got if k == "served" else padder.unpad(replay(bi, k)[r].flow_up[None])[0, :, :, 0]
                drift[k] = max(drift[k], float(np.abs(row - direct).max()))
                if k == "served" and len(batches[bi][3]) > 1:
                    drift["coalesced"] = max(drift["coalesced"], drift[k])
            if len(batches[bi][3]) < 2:
                continue
            for setting, norm_per_image in (("cudnn off", False), ("pinned", True)):
                t = time.perf_counter()
                with batch_invariant(norm_per_image):
                    _, up = engine.model(x1, x2, iters=body["iters_completed"], test_mode=True)
                    if (bi, setting) not in replays:
                        bucket_, i1, i2, res = batches[bi]
                        replays[(bi, setting)] = engine.run_batch(
                            tuple(bucket_), torch.from_numpy(i1).to(DEVICE), torch.from_numpy(i2).to(DEVICE),
                            deadlines_s=[None] * len(res), max_iters=served)
                pinned_s += time.perf_counter() - t
                row = padder.unpad(replays[(bi, setting)][r].flow_up[None])[0, :, :, 0]
                direct = padder.unpad(up.float().cpu().numpy())[0, :, :, 0]
                drift[setting] = max(drift[setting], float(np.abs(row - direct).max()))
    log(f"[serving-front] every response equals its batch replayed through engine.run_batch bit for bit; "
        f"batched against the batch-1 direct forward of the same padded pair, worst "
        + ", ".join(f"{drift[k]:.3e} px at {k} iterations" for k in ladder)
        + f", {drift['served']:.3e} px as served ({drift['coalesced']:.3e} over coalesced batches); the coalesced "
        f"batches as served {drift['cudnn off']:.3e} px with cuDNN off, {drift['pinned']:.3e} px with cuDNN off "
        f"and the instance norm one image at a time ({pinned_s:.1f} s) (tol {E2E_TOL_PX:g} px at {E2E_ITERS} "
        f"iterations, and at the served iterations in the last setting)")
    if not drift[E2E_ITERS] <= E2E_TOL_PX:
        raise AssertionError(f"[serving-front] a batch is {drift[E2E_ITERS]} px from its pairs' batch-1 forwards")
    if not drift["pinned"] <= E2E_TOL_PX:
        raise AssertionError(f"[serving-front] with the batch-dependent reductions pinned a coalesced batch as "
                             f"served is {drift['pinned']} px from its pairs' batch-1 forwards")

    # Health, metrics, and the numbers of this run.
    health = request_json(f"{url}/healthz").json()
    problems = validate_run_report(health)
    prom = request(f"{url}/metrics?format=prom")
    if problems or health["serving"]["state"] != "healthy" or not health["serving"]["memory"]["available"]:
        raise AssertionError(f"[serving-front] /healthz: {problems}, {health['serving']['state']}")
    if prom.headers.get("Content-Type") != "text/plain; version=0.0.4" or \
            "raft_serving_batches_total" not in prom.body.decode():
        raise AssertionError("[serving-front] /metrics?format=prom")
    snap = service.metrics()
    attr = service.batcher.metrics.attribution_summary()
    burst_answers = answers[:-1]
    log(card)
    log(f"[serving-front] burst of {len(burst_answers)} requests in {burst_s:.3f} s: "
        f"{len(burst_answers) / burst_s:.3f} requests/s; service latency p50 {snap['latency_p50_ms']:.3f} ms, "
        f"p99 {snap['latency_p99_ms']:.3f} ms; client round trip p50 "
        f"{statistics.median(t for _, _, t in burst_answers):.3f} ms; batch fill mean {snap['batch_fill_mean']:.4f}; "
        f"queue wait p50 {attr['queue_wait_ms']['p50']:.3f} ms, device p50 {attr['device_ms']['p50']:.3f} ms, "
        f"host gap p50 {attr['host_gap_ms']['p50']:.3f} ms; rejected {snap['rejected_total']}, shed "
        f"{snap['shed_total']}; device memory in use {health['serving']['memory']['bytes_in_use']} B")


def front_streams(service, url, rng) -> None:
    """Six frames of one stream over HTTP: five of a slowly panning
    low-contrast scene (frame 0 cold, then warm starts), then a cut."""
    h, w = FRONT_STREAM_HW
    base = rng.uniform(0, 255, (h, w + 24, 3)).astype(np.float32)
    frames = [(low_contrast(base[:, 12 + t: 12 + t + w]), low_contrast(base[:, t: t + w])) for t in range(5)]
    frames.append(tuple(np.floor(rng.uniform(0, 255, (h, w, 3))) for _ in range(2)))
    out = []
    for a, b in frames:
        status, body = post_predict(url, a, b, stream_id="cam0")
        if status != 200:
            raise AssertionError(f"[serving-front] stream frame: HTTP {status}: {str(body)[:300]}")
        out.append(body)
    seen = [(o["stream_frame"], o["warm_started"], o["reset"], o["iters_completed"]) for o in out]
    cold = service.config.max_iters
    want = [(0, False, False, cold)] + [(t, True, False, FRONT_WARM_ITERS) for t in range(1, 5)] + [(0, False, True, cold)]
    log(f"[serving-front] stream of {len(frames)} frames (frame, warm_started, reset, iters): {seen}")
    if seen != want:
        raise AssertionError(f"[serving-front] stream {seen} != {want}")


def front_reload(service, url, rng) -> None:
    """POST /reload: a .pth of another width answers 409 and serving goes
    on unchanged; a good one swaps in and changes the outputs to those of a
    model built fresh from it."""
    a, b = int_pair(rng, *service.config.buckets[0])
    _, before = post_predict(url, a, b)
    with tempfile.TemporaryDirectory() as tmp:
        wrong = os.path.join(tmp, "wrong.pth")
        torch.save(export_reference_state_dict(build_model(RAFTStereoConfig(hidden_dims=(96, 96, 96)), seed=SEED,
                                                           device="cpu")), wrong)
        resp = request_json(f"{url}/reload", method="POST", payload={"checkpoint": wrong}, timeout_s=FRONT_WAIT_S)
        _, still = post_predict(url, a, b)
        if resp.status != 409 or still["swap_generation"] != 0 or still["disparity"] != before["disparity"]:
            raise AssertionError(f"[serving-front] mismatched reload: HTTP {resp.status}, generation "
                                 f"{still['swap_generation']}")
        good = os.path.join(tmp, "good.pth")
        torch.save(export_reference_state_dict(build_model(KERNEL_CONFIG, seed=SEED + 1, device="cpu")), good)
        resp = request_json(f"{url}/reload", method="POST", payload={"checkpoint": good}, timeout_s=FRONT_WAIT_S)
        _, after = post_predict(url, a, b)
        fresh = load_reference_checkpoint(build_model(KERNEL_CONFIG, seed=SEED + 2, device="cpu"), good).to(DEVICE)
    _, padder, p1, p2 = service._admit(a, b)
    with torch.inference_mode():
        _, up = fresh(torch.from_numpy(p1[None]).to(DEVICE), torch.from_numpy(p2[None]).to(DEVICE),
                      iters=after["iters_completed"], test_mode=True)
    direct = padder.unpad(up.float().cpu().numpy())[0, :, :, 0]
    err = float(np.abs(np.asarray(after["disparity"], np.float32) - direct).max())
    log(f"[serving-front] reload: another width answered 409 and serving went on unchanged; a good .pth "
        f"swapped in (generation {after['swap_generation']}), outputs changed, {err:.3e} px from a fresh model's "
        f"forward (tol {E2E_TOL_PX:g})")
    if resp.status != 200 or after["swap_generation"] != 1 or after["disparity"] == before["disparity"]:
        raise AssertionError(f"[serving-front] good reload: HTTP {resp.status}: {resp.body[:300]!r}")
    if not err <= E2E_TOL_PX:
        raise AssertionError(f"[serving-front] the swapped service is {err} px from a fresh model")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_serve_cli(rng) -> None:
    """`python -m raft_stereo_tpu_torch serve` as a process in each of
    SERVE_CLI_CONFIGS, the processes side by side on the card: /healthz
    turns healthy within SERVE_CLI_BOOT_S, both buckets answer, /metrics
    answers in JSON and Prometheus text, SIGTERM drains and exits 0. Any
    failure kills the process."""
    errors = []

    def run(gen, name, flags):
        try:
            serve_cli(gen, name, flags)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(gen, name, flags))
               for gen, (name, flags) in zip(rng.spawn(len(SERVE_CLI_CONFIGS)), SERVE_CLI_CONFIGS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def serve_cli(rng, name: str, flags) -> None:
    tag = f"[serve-cli] {name}"
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch", "serve", "--port", str(port), *flags]
    with tempfile.TemporaryDirectory() as tmp:
        out_path, err_path = os.path.join(tmp, "stdout"), os.path.join(tmp, "stderr")
        with open(out_path, "w") as out, open(err_path, "w") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True)
        try:
            state = None
            while time.perf_counter() - t0 < SERVE_CLI_BOOT_S and proc.poll() is None:
                try:
                    state = request_json(f"{url}/healthz", timeout_s=10).json()["serving"]["state"]
                    break
                except OSError:
                    time.sleep(0.5)
            boot_s = time.perf_counter() - t0
            if state != "healthy":
                raise AssertionError(f"{tag}: not healthy after {boot_s:.1f} s (exit {proc.poll()})")
            for h, w in SERVE_CLI_REQUESTS:
                a, b = int_pair(rng, h, w)
                t = time.perf_counter()
                status, body = post_predict(url, a, b)
                ms = (time.perf_counter() - t) * 1e3
                d = np.asarray(body.get("disparity", []), np.float32)
                log(f"{tag} {h}x{w}: HTTP {status}, bucket {body.get('bucket')}, iters "
                    f"{body.get('iters_completed')}, round trip {ms:.3f} ms")
                if status != 200 or d.shape != (h, w) or not np.isfinite(d).all():
                    raise AssertionError(f"{tag} {h}x{w}: HTTP {status}, disparity {d.shape}")
            health = request_json(f"{url}/healthz").json()
            metrics = request_json(f"{url}/metrics").json()
            prom = request(f"{url}/metrics?format=prom")
            if validate_run_report(health) or health["serving"]["device"] != DEVICE or \
                    metrics["responses_total"] != len(SERVE_CLI_REQUESTS) or \
                    f"raft_serving_responses_total {len(SERVE_CLI_REQUESTS)}" not in prom.body.decode():
                raise AssertionError(f"{tag}: /healthz {health['serving']}, /metrics {metrics}")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        stdout, stderr = open(out_path).read(), open(err_path).read()
    boot_line = next((ln for ln in stdout.splitlines() if ln.startswith("{")), "{}")
    log(f"{tag}: {' '.join(cmd[1:])}: healthy after {boot_s:.2f} s (warm-up "
        f"{json.loads(boot_line).get('boot', {}).get('warmup_seconds')} s); SIGTERM -> exit {code}")
    if code != 0 or "backlog drained" not in stderr:
        raise AssertionError(f"{tag}: exit {code} after SIGTERM: {stderr[-2000:]}")


# -- the eighth slice: the realtime model and the bf16 levers --------------------

@contextlib.contextmanager
def swapped(module, **fns):
    """Replace attributes of `module` (a kernel wrapper by its plain twin)
    inside the block only; the package itself has no such switch."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def plain_twins(lever):
    """This slice's wrappers of `lever` swapped for their plain twins:
    "fused_gru_tail" (the tail and the motion tail) or "gates" (rh and
    combine)."""
    if lever == "fused_gru_tail":
        return swapped(gru_tail, fused_gru_tail=gru_tail.plain_fused_gru_tail,
                       fused_motion_tail=gru_tail.plain_motion_tail)
    return swapped(gates, fused_rh=gates.plain_rh, fused_combine=gates.plain_combine)


def bf16_bitwise(a, b) -> bool:
    """Equal bit for bit (bf16 or fp32)."""
    view = torch.int16 if a.dtype == BF16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def offset_view(gen, shape, dtype):
    """A contiguous tensor of `shape` whose data starts one element (2
    bytes in bf16, 4 in fp32) past a 16-byte boundary (the kernels then
    take their scalar loops)."""
    n = int(np.prod(shape))
    base = (torch.randn((n + 8,), generator=gen, device=DEVICE) * 2).to(dtype)
    return base[1:n + 1].view(shape)


def phase_bf16_lever_kernels(gen) -> dict:
    """The five bf16 kernels of the levers against their plain versions:
    the GRU tail, rh and combine bit for bit (the plain versions compute
    the same fp32 formulas, which the fp32 kernels match bit for bit, and
    round once to nearest even, as the kernels' store does), the motion
    tail exactly, at LEVER_GRU_SHAPES and on 2-byte-offset views; the
    windowed lookup bit for bit against the dense kernel and exactly (NaN
    in the same places) against its plain version, at LEVER_PREFETCH_CASES,
    every coordinate family, all four (level, tap) dtype pairs; the dense
    lookup with bf16 levels and taps (the mixed path's) on every plan
    branch (`dense_lookup_paths`)."""
    errs = {k: 0.0 for k in ("gru_tail_bf16", "motion_tail_bf16", "gates_rh_bf16", "gates_combine_bf16",
                             "corr_prefetch_lookup_bf16")}
    for c, h, w in LEVER_GRU_SHAPES:
        for offset in (False, True):
            if offset:
                zx, cz, qx, cq, hh = (offset_view(gen, (1, c, h, w), BF16) for _ in range(5))
            else:
                zx, cz, qx, cq, hh = ((torch.randn((1, c, h, w), generator=gen, device=DEVICE) * 2).to(BF16)
                                      for _ in range(5))
            got = {"gru_tail_bf16": gru_tail.fused_gru_tail(zx, cz, qx, cq, hh),
                   "gates_rh_bf16": gates.fused_rh(zx, cz, hh),
                   "gates_combine_bf16": gates.fused_combine(zx, cz, qx, cq, hh)}
            torch.cuda.synchronize()
            want = {"gru_tail_bf16": gru_tail.plain_fused_gru_tail(zx, cz, qx, cq, hh),
                    "gates_rh_bf16": gates.plain_rh(zx, cz, hh),
                    "gates_combine_bf16": gates.plain_combine(zx, cz, qx, cq, hh)}
            label = f"{c}x{h}x{w}{' 2-byte offset' if offset else ''}"
            for name in got:
                same = bf16_bitwise(got[name], want[name])
                err = max_err(got[name].float(), want[name].float())
                errs[name] = max(errs[name], err)
                if not same:
                    raise AssertionError(f"{name} disagrees with its plain version at {label}: {err}")
            same_as_tail = bf16_bitwise(got["gates_combine_bf16"], got["gru_tail_bf16"])
            log(f"[bf16-lever-kernels] gru_tail, rh, combine bf16 {label}: bitwise equal to their plain versions "
                f"(tol 0); combine bitwise equal to the tail: {same_as_tail}")
            del zx, cz, qx, cq, hh, got, want
    for h, w in ((128, 192), (496, 720), (48, 156), (7, 9)):
        for offset in (False, True):
            if offset:
                pre, flow = offset_view(gen, (1, 126, h, w), BF16), offset_view(gen, (1, 1, h, w), BF16)
            else:
                pre = torch.randn((1, 126, h, w), generator=gen, device=DEVICE).to(BF16)
                flow = torch.randn((1, 1, h, w), generator=gen, device=DEVICE).to(BF16)
            got = gru_tail.fused_motion_tail(pre, flow)
            torch.cuda.synchronize()
            want = gru_tail.plain_motion_tail(pre, flow)
            exact = got.dtype == BF16 and torch.equal(got, want)
            log(f"[bf16-lever-kernels] motion_tail bf16 126x{h}x{w}{' 2-byte offset' if offset else ''}: "
                f"exact {exact} (tol 0)")
            if not exact:
                raise AssertionError(f"motion_tail_bf16 disagrees with its plain version at {h}x{w}")
            del pre, flow, got, want
    for label, (h, w) in LEVER_PREFETCH_CASES:
        pyramid = tuple(torch.randn((1, h, w, w >> l), generator=gen, device=DEVICE) for l in range(4))
        for family in ("smooth", "edge", "special", "uniform"):
            coords = prefetch_coords(gen, family, 1, h, w, w)
            for level_dtype in (torch.float32, BF16):
                levels = tuple(lvl.to(level_dtype) for lvl in pyramid)
                for out_dtype in (torch.float32, BF16):
                    got = corr_cuda.prefetch_corr_lookup(levels, coords, 4, out_dtype)
                    dense = corr_cuda.corr_lookup(levels, coords, 4, out_dtype)
                    torch.cuda.synchronize()
                    bitwise = bf16_bitwise(got, dense)
                    e = exact_err(got.float(), corr.corr_lookup(levels, coords, 4).to(out_dtype).float())
                    if torch.bfloat16 in (level_dtype, out_dtype):
                        errs["corr_prefetch_lookup_bf16"] = max(errs["corr_prefetch_lookup_bf16"], e)
                    if not bitwise or not e <= 0.0:
                        raise AssertionError(f"the windowed lookup disagrees at {label} {family} "
                                             f"({level_dtype}, {out_dtype}): bitwise {bitwise}, {e}")
            log(f"[bf16-lever-kernels] corr_prefetch_lookup {label} (queries {h}x{w}) {family} coords, levels and "
                f"taps fp32/bf16 (four pairs): bitwise equal to the dense kernel and exact against the plain "
                f"version (tol 0)")
        del pyramid
    errs["corr_lookup_bf16"] = dense_lookup_paths(gen, "bf16-lever-kernels", ((BF16, BF16),))["corr_lookup_bf16"]
    return errs


def realtime_expect(requests=1, **extra) -> dict:
    return expect(**{k: v * requests for k, v in REALTIME_PER_REQUEST.items()}, **extra)


def phase_realtime(rng) -> dict:
    """The realtime configuration served through StereoService and
    AnytimeEngine at the default buckets, batch 1, one 7-iteration chunk:
    boot and warm-up time, each request's latency, bucket and
    iters_completed, and its launches: REALTIME_PER_REQUEST, nothing else
    (no fp32 form of any kernel)."""
    cfg = ServeConfig(model=REALTIME_CONFIG, max_batch=1, chunk_iters=REALTIME_ITERS, max_iters=REALTIME_ITERS)
    t0 = time.perf_counter()
    service = StereoService(cfg, device=DEVICE, seed=SEED).start()
    warm = service.warm_summary
    log(f"[realtime] buckets {list(cfg.buckets)}, batch 1, chunk_iters = max_iters = {REALTIME_ITERS}: boot + warm "
        f"of {warm['combos']} combos {time.perf_counter() - t0:.2f} s")
    for key in warm["prelude_ms"]:
        log(f"[realtime] {key}: prelude {warm['prelude_ms'][key]:.3f} ms, chunk of {REALTIME_ITERS} iters "
            f"{warm['chunk_est_ms'][key]:.3f} ms")
    reset_launches()
    for label, (h, w) in REALTIME_REQUESTS:
        before = launches()
        i1, i2 = stereo_pair(rng, h, w)
        res = service.submit(i1, i2).result()
        delta = {k: v - before[k] for k, v in launches().items()}
        log(f"[realtime] {label}: bucket {res['bucket']}, iters_completed {res['iters_completed']}, early_exit "
            f"{res['early_exit']}, latency {res['latency_ms']:.3f} ms, launches {delta}")
        disp = res["disparity"]
        if disp.shape != (h, w) or not np.isfinite(disp).all():
            raise AssertionError(f"realtime {label}: disparity shape {disp.shape} or non-finite values")
        if res["iters_completed"] != REALTIME_ITERS or delta != realtime_expect():
            raise AssertionError(f"realtime {label}: iters {res['iters_completed']}, launches {delta} != "
                                 f"expected {realtime_expect()}")
    drain_service(service, "[realtime]")
    counts = launches()
    log(f"[realtime] launches over {len(REALTIME_REQUESTS)} requests: {counts}")
    return counts


def phase_realtime_e2e(rng) -> None:
    """At 384x512 and 7 iterations: (a) the realtime configuration against
    itself with this slice's wrappers (the bf16 GRU tail and motion tail)
    swapped for their plain twins: flows bit for bit; (b) the realtime
    architecture at fp32, kernels ("pallas", the fused tails) against "reg"
    without them, within E2E_TOL_PX; (c) the fused encoder's prelude (the
    shared context trunk's layer1 in frozen BN over [image1, image2]) against
    the unfused one on the same weights: in the realtime configuration by
    MIXED_STATE_ULPS, as `[mixed-e2e]`, and in its fp32 architecture by
    FUSED_STATE_REL_TOL, as `[fused-e2e]`; printed: the fused against the
    unfused bf16 GRU (`fused_gru_tail` off), which round at different points."""
    i1, i2 = (torch.from_numpy(x[None]).to(DEVICE) for x in stereo_pair(rng, *REALTIME_E2E_HW))
    model = build_model(REALTIME_CONFIG, seed=SEED, device=DEVICE)
    runs = {}
    with torch.inference_mode():
        preludes = {}
        fp32_fused = RAFTStereoConfig(**REALTIME_ARCH, corr_implementation="pallas", fused_encoder=True)
        for name, cfg in (("bf16", REALTIME_CONFIG), ("fp32", fp32_fused)):
            fused = build_model(cfg, seed=SEED, device=DEVICE)
            unfused = build_model(dataclasses.replace(cfg, fused_encoder=False), seed=SEED, device=DEVICE)
            unfused.load_state_dict(fused.state_dict())
            reset_launches()
            state = anytime.prelude(fused, i1, i2)
            counts = launches()
            preludes[name] = (state, anytime.prelude(unfused, i1, i2), counts)
            del fused, unfused
        reset_launches()
        runs["kernels"] = (model(i1, i2, iters=REALTIME_ITERS, test_mode=True), launches())
        reset_launches()
        with plain_twins("fused_gru_tail"):
            runs["twins"] = (model(i1, i2, iters=REALTIME_ITERS, test_mode=True), launches())
        unfused = build_model(dataclasses.replace(REALTIME_CONFIG, fused_gru_tail=False), seed=SEED, device=DEVICE)
        runs["unfused"] = (unfused(i1, i2, iters=REALTIME_ITERS, test_mode=True), None)
        del unfused
        fp32 = {}
        for name, cfg in (("kernels", RAFTStereoConfig(**REALTIME_ARCH, corr_implementation="pallas",
                                                       fused_gru_tail=True)),
                          ("plain", RAFTStereoConfig(**REALTIME_ARCH, corr_implementation="reg"))):
            m = build_model(cfg, seed=SEED, device=DEVICE)
            reset_launches()
            fp32[name] = (m(i1, i2, iters=REALTIME_ITERS, test_mode=True), launches())
            del m
    torch.cuda.synchronize()
    (k_out, k_counts), (t_out, t_counts) = runs["kernels"], runs["twins"]
    same = all(torch.equal(a, b) for a, b in zip(k_out, t_out))
    gap = max_err(k_out[1], runs["unfused"][0][1])
    log(f"[realtime-e2e] {REALTIME_E2E_HW[0]}x{REALTIME_E2E_HW[1]}, {REALTIME_ITERS} iters, the realtime "
        f"configuration vs its bf16 GRU and motion tails swapped for their plain twins: flows bitwise equal {same} "
        f"(|flow_up| max {k_out[1].abs().max().item():.3f}); launches {k_counts}, twins {t_counts}; printed, the "
        f"fused vs the unfused bf16 GRU (fused_gru_tail off): flow_up max abs diff {gap:.4f} px")
    if not same or not torch.isfinite(k_out[1]).all():
        raise AssertionError("the realtime configuration disagrees with its plain twins")
    if k_counts != realtime_expect() or t_counts != expect(
            **{k: v for k, v in REALTIME_PER_REQUEST.items() if k not in ("gru_tail_bf16", "motion_tail_bf16")}):
        raise AssertionError(f"realtime e2e launches {k_counts}, twins {t_counts}")
    (fk, fk_counts), (fp, fp_counts) = fp32["kernels"], fp32["plain"]
    err_up, err_lo = max_err(fk[1], fp[1]), max_err(fk[0], fp[0])
    log(f"[realtime-e2e] the realtime architecture at fp32, {REALTIME_ITERS} iters, kernels vs plain (\"reg\", no "
        f"fused tail): flow_up max abs diff {err_up:.3e} px, flow_lowres {err_lo:.3e} px (tol {E2E_TOL_PX:g} px); "
        f"|flow_up| max {fp[1].abs().max().item():.3f}; launches {fk_counts}, plain {fp_counts}")
    it = REALTIME_ITERS
    if fk_counts != expect(corr_lookup=it, gru_tail=3 * it, motion_tail=it) or fp_counts != expect():
        raise AssertionError(f"realtime fp32 launches {fk_counts}, plain {fp_counts}")
    if not (torch.isfinite(fk[1]).all() and err_up <= E2E_TOL_PX and err_lo <= E2E_TOL_PX):
        raise AssertionError(f"the fp32 realtime architecture disagrees with plain: {err_up} px")
    fused, unfused, counts = preludes["bf16"]
    log(f"[realtime-e2e] the realtime configuration's prelude, launches {counts}")
    if counts != expect(corr_pyramid_bf16=1, encoder_conv_bf16=4, encoder_join_bf16=2):
        raise AssertionError(f"realtime prelude launches {counts}")
    check_bf16_prelude("[realtime-e2e]", fused, unfused)
    fused, unfused, counts = preludes["fp32"]
    worst = 0.0
    for name, (a, b) in prelude_parts(fused, unfused).items():
        rel = max_err(a, b) / max(float(a.abs().max().item()), 1e-30)
        worst = max(worst, rel)
        log(f"[realtime-e2e] fp32 fused vs unfused prelude {name} {tuple(a.shape)}: max abs diff "
            f"{max_err(a, b):.3e}, relative to max |value| {rel:.3e}")
    log(f"[realtime-e2e] fp32 fused prelude state worst relative diff {worst:.3e} (tol {FUSED_STATE_REL_TOL:g}); "
        f"launches {counts}")
    if counts != expect(corr_pyramid=1, encoder_conv=4, encoder_join=2) or not worst <= FUSED_STATE_REL_TOL:
        raise AssertionError(f"the fp32 realtime fused prelude disagrees with the unfused one: {worst}, {counts}")


def phase_realtime_evaluate(card: str) -> None:
    """(a) The realtime command line through `cli.main` (`--dataset kitti
    --dry_run`, at the dry run's synthetic shape): exit 0, its validator
    line and REALTIME_PER_REQUEST launches per image. (b) `Evaluator(model,
    iters=7)` with `validate_kitti` on KITTI_IMAGES synthetic KITTI-shaped
    pairs: seconds per image (the median after one warm image), peak
    memory and launches per image."""
    argv = ["evaluate", "--dataset", "kitti", "--dry_run", "--shared_backbone", "--n_downsample", "3",
            "--n_gru_layers", "2", "--slow_fast_gru", "--valid_iters", str(REALTIME_ITERS), "--corr_implementation",
            "reg_cuda", "--mixed_precision", "--fused_encoder", "--fused_gru_tail"]
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = launches()
    for line in out.getvalue().splitlines():
        log(f"[realtime-evaluate] {line}")
    n = len(SyntheticEvalDataset())
    log(f"[realtime-evaluate] {' '.join(argv)}: exit {rc}, {wall:.3f} s, launches {counts}")
    if rc != 0 or counts != realtime_expect(n) or "Validation KITTI: EPE" not in out.getvalue():
        raise AssertionError(f"realtime evaluate CLI: exit {rc}, launches {counts} != expected {realtime_expect(n)}")

    model = build_model(REALTIME_CONFIG, seed=SEED, device=DEVICE)
    evaluator = Evaluator(model, iters=REALTIME_ITERS)
    record = []

    def timed(image1, image2):
        before = launches()
        flow, seconds = evaluator(image1, image2)
        record.append((flow, seconds, {k: v - before[k] for k, v in launches().items()}))
        return flow, seconds

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        result = validate_kitti(timed, dataset=SyntheticEvalDataset(n=KITTI_IMAGES, shape=KITTI_SHAPE))
    peak = torch.cuda.max_memory_allocated()
    seconds = [s for _, s, _ in record]
    per_image = statistics.median(seconds[1:])
    log(f"[realtime-evaluate] {card}; Evaluator(iters={REALTIME_ITERS}) + validate_kitti on {KITTI_IMAGES} "
        f"synthetic {KITTI_SHAPE[0]}x{KITTI_SHAPE[1]} pairs (padded to {-(-KITTI_SHAPE[0] // 32) * 32}x"
        f"{-(-KITTI_SHAPE[1] // 32) * 32}), batch 1: {per_image:.4f} s/image (median of images 2-{KITTI_IMAGES}; "
        f"all: {', '.join(f'{s:.4f}' for s in seconds)} s); peak memory {peak / 2**30:.3f} GiB ({peak} B); "
        f"launches per image {record[-1][2]}; metrics {result}")
    for flow, _, delta in record:
        if delta != realtime_expect() or flow.shape != KITTI_SHAPE or not np.isfinite(flow).all():
            raise AssertionError(f"realtime evaluate: launches {delta} or flow {flow.shape} wrong")


def phase_mixed_levers() -> dict:
    """The JAX bench's mixed configuration on one synthetic Middlebury-F
    image (1980x2870, 32 iterations) with each test-mode lever in turn
    against the lever off, on the same seeded weights: seconds per image
    (one warm run first) and the launches that show each lever's bf16
    kernel ran. `prefetch_lookup` equals lever off bit for bit (the windowed
    lookup is the dense one's function); `fused_gru_tail` and the gate pair
    equal their runs with this slice's wrappers swapped for the plain
    twins; their difference from lever off (other rounding points) is
    printed. Returns the levers' launch counts."""
    item = SyntheticEvalDataset(n=1, shape=EVAL_SHAPE).get_item(0, None)
    pair = (item["image1"], item["image2"])
    flows, counts = {}, {}
    base = {"encoder_conv_bf16": 8, "encoder_join_bf16": 4, "corr_pyramid_bf16": 1}
    it = EVAL_ITERS
    wants = {"off": expect(**base, corr_lookup_bf16=it),
             "prefetch_lookup": expect(**base, corr_prefetch_lookup_bf16=it),
             "fused_gru_tail": expect(**base, corr_lookup_bf16=it, gru_tail_bf16=3 * it, motion_tail_bf16=it),
             "gates": expect(**base, corr_lookup_bf16=it, gates_rh_bf16=3 * it, gates_combine_bf16=3 * it)}
    if set(wants) != set(LEVERS):
        raise AssertionError(f"[mixed-levers] expects launches for {sorted(wants)}, the levers are "
                             f"{sorted(LEVERS)}")
    weights = None
    for name, (flags, gates_on) in LEVERS.items():
        model = build_model(dataclasses.replace(MIXED_CONFIG, **flags), seed=SEED, device=DEVICE)
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        evaluator = Evaluator(model, iters=EVAL_ITERS)
        if gates_on:
            os.environ[gates.ENV_VAR] = "1"
        try:
            evaluator(*pair)
            reset_launches()
            flows[name], seconds = evaluator(*pair)
            counts[name] = launches()
            twin = None
            if name in ("fused_gru_tail", "gates"):
                with plain_twins(name):
                    reset_launches()
                    twin, _ = evaluator(*pair)
                    twin_counts = launches()
        finally:
            os.environ.pop(gates.ENV_VAR, None)
        diff = np.abs(flows[name] - flows["off"])
        log(f"[mixed-levers] {name}: {seconds:.4f} s/image ({EVAL_SHAPE[0]}x{EVAL_SHAPE[1]}, {EVAL_ITERS} iters, "
            f"after one warm run); launches {counts[name]}; against lever off (printed): max abs diff "
            f"{diff.max():.4f} px, mean {diff.mean():.5f} px")
        if counts[name] != wants[name] or not np.isfinite(flows[name]).all():
            raise AssertionError(f"mixed lever {name}: launches {counts[name]} != expected {wants[name]}")
        if name == "prefetch_lookup" and not np.array_equal(flows[name], flows["off"]):
            raise AssertionError("the bf16 windowed lookup changed the mixed flow")
        if twin is not None:
            same = np.array_equal(flows[name], twin)
            log(f"[mixed-levers] {name} against its run with the wrappers swapped for the plain twins: bitwise "
                f"equal {same}; twin launches {twin_counts}")
            if not same:
                raise AssertionError(f"mixed lever {name} disagrees with its plain twins")
        del model, evaluator
        torch.cuda.empty_cache()
    return counts


def phase_timing(gen, errs, counts) -> list:
    """Kernel, plain and library times at the 512x768 bucket's shapes (the
    JSON rows), and at Middlebury-F's for the evaluate path's kernels."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)  # 256 MB > L2
    out = []

    def entry(name, ms, plain_ms, nbytes, flops, library_ms, tensor_flops=0):
        """`flops`: operations at the fp32 peak; `tensor_flops`: bf16
        products, at the bf16 tensor-core peak."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (flops / FP32_FLOPS_PER_S + tensor_flops / BF16_TENSOR_FLOPS_PER_S) * 1e3
        src, replaces = KERNELS[name]
        e = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        mixed = f"{len(MIXED_REQUESTS)} requests of the mixed configuration"
        where = {"corr_scatter": f"{TRAIN_TIMED_STEPS} training steps",
                 "corr_scatter_bf16": f"{MIXED_TRAIN_TIMED_STEPS} mixed training steps",
                 "corr_lookup_bf16": mixed, "corr_pyramid_bf16": mixed, "encoder_conv_bf16": mixed,
                 "encoder_join_bf16": mixed,
                 "corr_prefetch_lookup": "the [evaluate] run (2 images)",
                 "gates_rh": f"one {EVAL_ITERS}-iteration gates forward",
                 "gates_combine": f"one {EVAL_ITERS}-iteration gates forward",
                 "gru_tail_bf16": f"{len(REALTIME_REQUESTS)} requests of the realtime configuration",
                 "motion_tail_bf16": f"{len(REALTIME_REQUESTS)} requests of the realtime configuration",
                 "gates_rh_bf16": f"one {EVAL_ITERS}-iteration mixed forward with the gate pair",
                 "gates_combine_bf16": f"one {EVAL_ITERS}-iteration mixed forward with the gate pair",
                 "corr_prefetch_lookup_bf16": f"one {EVAL_ITERS}-iteration mixed forward with prefetch_lookup",
                 }.get(name, f"{len(REQUESTS)} requests")
        log(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}, {nbytes} B, {flops} ops; {e['bound_ms'] / ms:.0%} of it), library {lib}, "
            f"launches {counts[name]} over {where}")
        out.append(e)

    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        pyramid, coords = lookup_inputs(gen, 1, hh // 4, ww // 4, ww // 4)
        ms = time_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4), flush=flush)
        pf_ms = time_ms(lambda: corr_cuda.prefetch_corr_lookup(pyramid, coords, 4), flush=flush)
        # Both entry points launch csrc/corr_window.cuh's kernel.
        dev = kernel_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4), ("corr_window",), flush)
        pf_dev = kernel_ms(lambda: corr_cuda.prefetch_corr_lookup(pyramid, coords, 4), ("corr_window",), flush)
        plain_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4), flush=flush)
        nbytes = lookup_bytes(pyramid, coords, 4)
        plan = corr_cuda.prefetch_plan_for(pyramid, coords, 4)
        log(f"[timing] corr_lookup {label} fp32: dense kernel {ms:.4f} ms (alone on the device {alone_text(dev)}), windowed "
            f"kernel {pf_ms:.4f} ms (alone {alone_text(pf_dev)}; plan {plan.path}, runs of {plan.run}, {plan.stages} stages, "
            f"{plan.blocks} blocks), plain {plain_ms:.4f} ms; {lookup_bounds(pyramid, coords, 4, alone=dev)}")
        if label == "512x768":
            rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)

            def sample():
                return F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

            lib_ms = time_ms(sample, flush=flush)
            lib = sample().reshape(4, -1, 9).permute(1, 0, 2).reshape(coords.shape + (36,))
            log(f"[timing] corr_lookup {label}: grid_sample vs kernel max abs diff "
                f"{max_err(lib, corr_cuda.corr_lookup(pyramid, coords, 4)):.3e}")
            entry("corr_lookup", ms, plain_ms, nbytes, 3 * coords.numel() * 36, lib_ms)
            # The windowed lookup computes the same function on the same inputs.
            entry("corr_prefetch_lookup", pf_ms, plain_ms, nbytes, 3 * coords.numel() * 36, lib_ms)
            del rows, grid, lib
        else:
            # cuDNN's grid sampler refuses a batch of one row per query at
            # this size, so no library time here.
            log(f"[timing] corr_lookup {label}: library not measured")
        del pyramid, coords

    # The tails and gates at the GRU's three scales of the 512x768 bucket
    # (the first is the JSON row's) and at Middlebury-F's 1/4.
    gru_shapes = [(512 // d, 768 // d) for d in (4, 8, 16)] + [(496, 720)]
    for h, w in gru_shapes:
        ops = tail_inputs(gen, 128, h, w)
        ms = time_ms(lambda: gru_tail.fused_gru_tail(*ops), flush=flush)
        plain_ms = time_ms(lambda: gru_tail.plain_gru_tail(*ops), flush=flush)
        n = ops[0].numel()
        if (h, w) == gru_shapes[0]:
            entry("gru_tail", ms, plain_ms, 6 * 4 * n, 12 * n, None)
        else:
            log(f"[timing] gru_tail 128x{h}x{w}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, "
                f"bound {6 * 4 * n / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
        del ops

    for hh, ww in gru_shapes:
        zx, cz, qx, cq, h = tail_inputs(gen, 128, hh, ww)
        rh_ms = time_ms(lambda: gates.fused_rh(zx, cz, h), flush=flush)
        rh_plain_ms = time_ms(lambda: gates.plain_rh(zx, cz, h), flush=flush)
        c_ms = time_ms(lambda: gates.fused_combine(zx, cz, qx, cq, h), flush=flush)
        c_plain_ms = time_ms(lambda: gates.plain_combine(zx, cz, qx, cq, h), flush=flush)
        n = h.numel()
        if (hh, ww) == gru_shapes[0]:
            # rh: two adds, a negation, an exp, a division and a product per
            # element; combine: the GRU tail's dozen.
            entry("gates_rh", rh_ms, rh_plain_ms, 4 * 4 * n, 6 * n, None)
            entry("gates_combine", c_ms, c_plain_ms, 6 * 4 * n, 12 * n, None)
        else:
            log(f"[timing] gates 128x{hh}x{ww}: rh {rh_ms:.4f} ms (plain {rh_plain_ms:.4f}, "
                f"bound {4 * 4 * n / HBM_BYTES_PER_S * 1e3:.4f}), combine {c_ms:.4f} ms (plain "
                f"{c_plain_ms:.4f}, bound {6 * 4 * n / HBM_BYTES_PER_S * 1e3:.4f})")
        del zx, cz, qx, cq, h

    pre, flow = motion_inputs(gen, 128, 192)
    ms = time_ms(lambda: gru_tail.fused_motion_tail(pre, flow), flush=flush)
    dev = kernel_ms(lambda: gru_tail.fused_motion_tail(pre, flow), ("motion_tail",), flush)
    plain_ms = time_ms(lambda: gru_tail.plain_motion_tail(pre, flow), flush=flush)
    hw = 128 * 192
    bound = 4 * hw * (126 + 1 + 128) / HBM_BYTES_PER_S * 1e3
    plan = gru_tail.motion_tail_plan(1, 126, hw, 4, _build.multiprocessors(0))
    log(f"[timing] motion_tail 126x128x192 fp32: kernel {ms:.4f} ms by events ({bound / ms:.0%} of its "
        f"{bound:.4f} ms bound), alone on the device {alone_text(dev)} ({share_text(bound, dev)}); plan {plan.per_thread} units "
        f"per thread, grid {plan.grid}")
    entry("motion_tail", ms, plain_ms, 4 * hw * (126 + 1 + 128), 126 * hw, None)
    del pre, flow

    # The pyramid at both shapes, with its rate and share of the bound.
    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        f1, f2 = fmap_inputs(gen, 1, hh // 4, ww // 4)
        b, h, w, d = f1.shape
        plan = corr_cuda.pyramid_plan_for(f1, f2, 4)
        ms = time_ms(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4), flush=flush)
        plain_ms = time_ms(lambda: corr_cuda.corr_state(f1, f2, 4), flush=flush)
        # The library yardstick computes the volume only (no scaling, no pooling).
        lib_ms = time_ms(lambda: torch.matmul(f1, f2.transpose(-1, -2)), flush=flush)
        widths = [w >> l for l in range(4)]
        nbytes = 4 * (2 * b * h * w * d + b * h * w * sum(widths))
        # The GEMM, the division of each volume entry, an add and a halving per pooled value.
        flops = 2 * b * h * w * w * d + b * h * w * (w + 2 * sum(widths[1:]))
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
        log(f"[timing] corr_pyramid {label}: kernel {ms:.4f} ms = {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound / ms:.0%} of its {bound:.4f} ms bound (tile {plan.tile[0]}x{plan.tile[1]}, "
            f"{plan.blocks} blocks); torch.matmul of the volume alone {lib_ms:.4f} ms = "
            f"{2 * b * h * w * w * d / (lib_ms * 1e-3) / 1e12:.1f} TFLOP/s")
        if label == "512x768":
            dev = kernel_ms(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4), ("corr_pyramid",), flush)
            log(f"[timing] corr_pyramid {label}: the kernel alone on the device (profiler) {alone_text(dev)} ms, "
                f"{share_text(bound, dev)} of the bound")
            entry("corr_pyramid", ms, plain_ms, nbytes, flops, lib_ms)
        else:
            log(f"[timing] corr_pyramid {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound:.4f} ms (operations), torch.matmul volume alone {lib_ms:.4f} ms")
        del f1, f2

    for hh, ww in ((512, 768), (384, 512)):
        for b, form, stats in ((1, "in", True), (2, "in", True), (1, "bn", False)):
            x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
            ms = time_ms(lambda: encoder_cuda.fused_conv(x, weight, bias, aff, form, stats), flush=flush)
            # The conv and, with statistics, the two launches that sum its partials.
            dev = kernel_ms(lambda: encoder_cuda.fused_conv(x, weight, bias, aff, form, stats),
                            ("encoder_conv_kernel", "encoder_stats"), flush)
            plain_ms = time_ms(lambda: encoder_cuda.plain_conv(x, weight, bias, aff, form, stats), flush=flush)
            z = encoder_cuda.apply_affine(x, aff, form)
            lib_ms = time_ms(lambda: F.conv2d(z, weight, bias, padding=1), flush=flush)
            hw = hh * ww
            nbytes = 4 * (2 * b * 64 * hw + 64 * 64 * 9 + 64 + 2 * b * 64 * (1 + stats))
            # The GEMM, the operand affine and relu (3 per input), bias and statistics (3 per output).
            flops = 2 * 9 * 64 * 64 * b * hw + 3 * b * 64 * hw * (1 + stats)
            label = f"b{b} {hh}x{ww} form {form}{' + stats' if stats else ''}"
            bound = flops / FP32_FLOPS_PER_S * 1e3
            log(f"[timing] encoder_conv {label}: kernel {ms:.4f} ms, its kernels alone on the device {alone_text(dev)} ms "
                f"({share_text(bound, dev)} of its bound), plain {plain_ms:.4f} ms, bound {bound:.4f} ms (operations), "
                f"F.conv2d {lib_ms:.4f} ms, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
            if (hh, b, form) == (512, 1, "in"):
                log(f"[timing] encoder_conv {label}: library is F.conv2d of the normalized operand "
                    f"(cuDNN, TF32 off), without affine or statistics")
                entry("encoder_conv", ms, plain_ms, nbytes, flops, lib_ms)
            del x, z

    # The scatter at the training recipe's 1/4 resolution. Its library
    # yardstick is the backward of the F.grid_sample lookup timed above as
    # the lookup's: autograd.grad of its output with respect to the sampled
    # rows (atomic adds), on the same coordinates and cotangent.
    b, h, w = TRAIN_BATCH, TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
    pyramid, coords = lookup_inputs(gen, b, h, w, w)
    widths = [lvl.shape[-1] for lvl in pyramid]
    grad = torch.randn((b, h, w, 36), generator=gen, device=DEVICE)
    ms = time_ms(lambda: corr_cuda.corr_scatter(coords, grad, widths, 4), flush=flush)
    dev = kernel_ms(lambda: corr_cuda.corr_scatter(coords, grad, widths, 4), ("corr_scatter_kernel",), flush)
    plain_ms = time_ms(lambda: corr_cuda.plain_corr_scatter(coords, grad, widths, 4), flush=flush)
    rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)
    rows.requires_grad_()
    sampled = F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    # The cotangent in grid_sample's (level, query, tap) order.
    gout = grad.reshape(-1, 4, 9).permute(1, 0, 2).reshape(sampled.shape).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(sampled, rows, gout, retain_graph=True), flush=flush)
    (d_rows,) = torch.autograd.grad(sampled, rows, gout, retain_graph=True)
    d_rows = d_rows.reshape(4, -1, w)
    lib_err = max(max_err(d_rows[l, :, :wl].reshape(b, h, w, wl), d)
                  for l, (wl, d) in enumerate(zip(widths, corr_cuda.corr_scatter(coords, grad, widths, 4))))
    log(f"[timing] corr_scatter b{b} {h}x{w}: library is autograd.grad of the F.grid_sample lookup "
        f"(per-tap fractions, atomic adds); its d(pyramid) vs the kernel's max abs diff {lib_err:.3e}")
    n_q = coords.numel()
    # Coordinates and cotangent read once, every level's dense row written
    # once; a multiply-add pair per output inside the window.
    nbytes = 4 * (n_q + n_q * 36 + n_q * sum(widths))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    plan = corr_cuda.scatter_plan(n_q, widths, 4)
    log(f"[timing] corr_scatter b{b} {h}x{w}: kernel {ms:.4f} ms = {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
        f"{bound / ms:.0%} of its {bound:.4f} ms bound ({plan.run} queries per block, {plan.blocks} blocks); "
        f"alone on the device {alone_text(dev)} ms ({share_text(bound, dev)} of the bound); "
        f"grid_sample backward {lib_ms:.4f} ms = {nbytes / (lib_ms * 1e-3) / 1e12:.3f} TB/s")
    entry("corr_scatter", ms, plain_ms, nbytes, 3 * n_q * 4 * 10, lib_ms)
    del pyramid, coords, grad, rows, grid, sampled, gout, d_rows

    hw = 512 * 768
    skip = torch.randn((1, 64, 512, 768), generator=gen, device=DEVICE)
    y = torch.randn((1, 64, 512, 768), generator=gen, device=DEVICE)
    aff_y, aff_s = affine_rows(gen, 1, "in"), affine_rows(gen, 1, "in")
    ms = time_ms(lambda: encoder_cuda.fused_join(skip, y, aff_y, "in", aff_s, "in"), flush=flush)
    plain_ms = time_ms(lambda: encoder_cuda.plain_join(skip, y, aff_y, "in", aff_s, "in"), flush=flush)
    # Two affines and relus (3 ops each), the add and the last relu.
    entry("encoder_join", ms, plain_ms, 4 * (3 * 64 * hw + 4 * 64), 8 * 64 * hw, None)
    del skip, y
    out.extend(bf16_timing(gen, flush, entry))
    out.extend(lever_bf16_timing(gen, flush, entry))
    halo_conv_timing(gen, flush)
    return out


def halo_conv_timing(gen, flush) -> None:
    """The conv's halo form at HALO_CONV_CASES' Middlebury-F bottom band
    and 512x768 middle band, fp32 and bf16, instance form with statistics:
    events, its kernels alone, the bound, the plain twin and cuDNN's
    F.conv2d of the normalized operand at the band's shape (zero rows only
    where the band has no neighbour)."""
    for label, b, hh, ww, halo in HALO_CONV_CASES[1:]:
        for dtype in (torch.float32, BF16):
            x, weight, bias, aff = conv_inputs(gen, b, hh + sum(halo), ww, "in")
            x = x.to(dtype)
            call = lambda: encoder_cuda.fused_conv(x, weight, bias, aff, "in", True, halo)  # noqa: E731
            ms = time_ms(call, reps=10, flush=flush)
            kernel = "encoder_conv_wgmma" if dtype == BF16 else "encoder_conv_kernel"
            dev = kernel_ms(call, (kernel, "encoder_stats"), flush, reps=5)
            plain_ms = time_ms(lambda: encoder_cuda.plain_conv(x, weight, bias, aff, "in", True, halo), reps=5,
                               flush=flush)
            z = F.pad(encoder_cuda.apply_affine(x, aff, "in"), (0, 0, 1 - halo[0], 1 - halo[1]))
            wl, bl = weight.to(dtype), bias.to(dtype)
            lib_ms = time_ms(lambda: F.conv2d(z, wl, bl, padding=(0, 1)), reps=10, flush=flush)
            size = 2 if dtype == BF16 else 4
            hw = hh * ww
            nbytes = size * (b * 64 * (hh + sum(halo)) * ww + b * 64 * hw + 64 * 64 * 9) + 4 * (64 + 2 * b * 64 * 3)
            gemm = 2 * 9 * 64 * 64 * b * hw
            rest = 3 * b * 64 * (hh + sum(halo)) * ww + 3 * b * 64 * hw
            ops_s = (gemm / BF16_TENSOR_FLOPS_PER_S + rest / FP32_FLOPS_PER_S if dtype == BF16
                     else (gemm + rest) / FP32_FLOPS_PER_S)
            bound = max(nbytes / HBM_BYTES_PER_S, ops_s) * 1e3
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops_s else "operations"
            name = "encoder_conv_bf16" if dtype == BF16 else "encoder_conv"
            log(f"[timing] {name} halo form, {label} (b{b}, {hh} + {sum(halo)} rows x {ww}, form in + stats): "
                f"kernel {ms:.4f} ms, its kernels alone on the device {alone_text(dev)} ms ({share_text(bound, dev)} of "
                f"its bound), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), cuDNN F.conv2d of the normalized "
                f"operand at the band's shape {lib_ms:.4f} ms")
            del x, z
    torch.cuda.empty_cache()


def bf16_timing(gen, flush, entry) -> list:
    """The bf16 variants (the mixed configuration's kernels) at the 512x768
    bucket's shapes, the pyramid and the lookup also at Middlebury-F's, the
    conv also at Middlebury-F's full resolution and the realtime model's
    192x624; the pyramid and the conv also alone on the device. The
    library calls: bf16 torch.matmul for the volume alone, F.grid_sample on
    the bf16 levels (its grid in bf16 too, as it takes one dtype: the
    positions rounded, so the closest call rather than the same function),
    cuDNN's bf16 F.conv2d of the normalized operand."""
    out = []
    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        f1, f2 = (f.to(BF16) for f in fmap_inputs(gen, 1, hh // 4, ww // 4))
        b, h, w, d = f1.shape
        plan = corr_cuda.pyramid_plan_for(f1, f2, 4)
        ms = time_ms(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4, BF16), flush=flush)
        dev = kernel_ms(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4, BF16), ("corr_pyramid",), flush)
        plain_ms = time_ms(lambda: corr_cuda.corr_state(f1, f2, 4, BF16), flush=flush)
        lib_ms = time_ms(lambda: torch.matmul(f1, f2.transpose(-1, -2)), flush=flush)
        widths = [w >> l for l in range(4)]
        nbytes = 2 * (2 * b * h * w * d + b * h * w * sum(widths))
        gemm = 2 * b * h * w * w * d
        rest = b * h * w * (w + 2 * sum(widths[1:]))
        bound = max(nbytes / HBM_BYTES_PER_S, gemm / BF16_TENSOR_FLOPS_PER_S + rest / FP32_FLOPS_PER_S) * 1e3
        log(f"[timing] corr_pyramid_bf16 {label}: kernel {ms:.4f} ms = {gemm / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bound / ms:.0%} of its {bound:.4f} ms bound ({nbytes} B; plan {plan.path} {plan.tile[0]}x{plan.tile[1]}, "
            f"{plan.blocks} blocks); the kernel alone on the device (profiler) {alone_text(dev)} ms, {share_text(bound, dev)} of "
            f"the bound; plain {plain_ms:.4f} ms; bf16 torch.matmul of the volume alone {lib_ms:.4f} ms")
        if label == "512x768":
            entry("corr_pyramid_bf16", ms, plain_ms, nbytes, rest, lib_ms, tensor_flops=gemm)
        del f1, f2
    # The dense bf16 lookup at both buckets' shapes and at the bf16
    # training step's 1/4 (4 x 80 x 180 queries, W2 180).
    for label, (b, h, w) in (("512x768", (1, 128, 192)), ("1984x2880", (1, 496, 720)),
                             ("bf16 training step 4x80x180", (4, 80, 180))):
        pyramid, coords = lookup_inputs(gen, b, h, w, w)
        pyramid = tuple(lvl.to(BF16) for lvl in pyramid)
        times = {}
        for out_dtype in (torch.float32, BF16):
            times[out_dtype] = time_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4, out_dtype), flush=flush)
        dev = kernel_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4, BF16), ("corr_window",), flush)
        plain_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4).to(BF16), flush=flush)
        nbytes = lookup_bytes(pyramid, coords, 4, out_bytes=2)
        log(f"[timing] corr_lookup_bf16 {label}: bf16 levels, bf16 taps {times[BF16]:.4f} ms (alone on the device "
            f"{alone_text(dev)}), fp32 taps {times[torch.float32]:.4f} ms; plain {plain_ms:.4f} ms; "
            f"{lookup_bounds(pyramid, coords, 4, 2, alone=dev)}")
        if label == "512x768":
            rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)
            rows, grid = rows.to(BF16), grid.to(BF16)
            lib_ms = time_ms(lambda: F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros",
                                                   align_corners=True), flush=flush)
            entry("corr_lookup_bf16", times[BF16], plain_ms, nbytes, 3 * coords.numel() * 36, lib_ms)
            del rows, grid
        del pyramid, coords
    # The conv at the 512x768 bucket's full resolution (the JSON row), at
    # Middlebury-F's (the feature trunk: 2 images, instance norm and
    # statistics) and at the realtime model's KITTI bucket (half resolution:
    # 2 images, frozen BN, no statistics). Library: cuDNN's bf16 F.conv2d of
    # the normalized operand, without affine or statistics.
    for label, (b, hh, ww, form, emit) in (("512x768", (1, 512, 768, "in", True)),
                                           ("1984x2880", (2, 1984, 2880, "in", True)),
                                           ("realtime 192x624", (2, 192, 624, "bn", False))):
        x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
        x = x.to(BF16)
        ms = time_ms(lambda: encoder_cuda.fused_conv(x, weight, bias, aff, form, emit), flush=flush)
        # The conv and, with statistics, the pass that sums its partials.
        dev = kernel_ms(lambda: encoder_cuda.fused_conv(x, weight, bias, aff, form, emit),
                        ("encoder_conv_wgmma", "encoder_stats"), flush)
        plain_ms = time_ms(lambda: encoder_cuda.plain_conv(x, weight, bias, aff, form, emit), flush=flush)
        z = encoder_cuda.apply_affine(x, aff, form)
        wb, bb = weight.to(BF16), bias.to(BF16)
        lib_ms = time_ms(lambda: F.conv2d(z, wb, bb, padding=1), flush=flush)
        hw = hh * ww
        # bf16 operand and output; fp32 weights, bias, affine rows and statistics.
        nbytes = 2 * (2 * b * 64 * hw) + 4 * (64 * 64 * 9 + 64 + (2 * b * 64 if form != "none" else 0)
                                              + (2 * b * 64 if emit else 0))
        tensor = 2 * 9 * 64 * 64 * b * hw
        # Per output element: the affine and relu (3 ops), the bias (1), the statistics (2).
        ops = ((3 if form != "none" else 0) + 1 + (2 if emit else 0)) * b * 64 * hw
        bound = max(nbytes / HBM_BYTES_PER_S, tensor / BF16_TENSOR_FLOPS_PER_S + ops / FP32_FLOPS_PER_S) * 1e3
        log(f"[timing] encoder_conv_bf16 b{b} {label} form {form}{' + stats' if emit else ''}: kernel {ms:.4f} ms, "
            f"{bound / ms:.0%} of its {bound:.4f} ms bound; its kernels alone on the device (profiler: the conv"
            f"{' and the statistics pass' if emit else ''}) {alone_text(dev)} ms, "
            f"{share_text(bound, dev)} of the bound; plain {plain_ms:.4f} ms; cuDNN's bf16 F.conv2d of the normalized "
            f"operand {lib_ms:.4f} ms")
        if label == "512x768":
            entry("encoder_conv_bf16", ms, plain_ms, nbytes, ops, lib_ms, tensor_flops=tensor)
        del x, z
    hh, ww = 512, 768
    hw = hh * ww
    skip = torch.randn((1, 64, hh, ww), generator=gen, device=DEVICE).to(BF16)
    y = torch.randn((1, 64, hh, ww), generator=gen, device=DEVICE).to(BF16)
    aff_y, aff_s = affine_rows(gen, 1, "in"), affine_rows(gen, 1, "in")
    ms = time_ms(lambda: encoder_cuda.fused_join(skip, y, aff_y, "in", aff_s, "in"), flush=flush)
    plain_ms = time_ms(lambda: encoder_cuda.plain_join(skip, y, aff_y, "in", aff_s, "in"), flush=flush)
    entry("encoder_join_bf16", ms, plain_ms, 2 * 3 * 64 * hw + 4 * 4 * 64, 8 * 64 * hw, None)
    del skip, y
    # The bf16 scatter (bf16 cotangent, bf16 levels) at the fp32 row's shape
    # and at the bench's training setup (the JSON row). Library: autograd of
    # the bf16 F.grid_sample lookup (bf16 rows and grid, as in the lookup's
    # bf16 row) with respect to its rows.
    for b in (TRAIN_BATCH, MIXED_TRAIN_BATCH):
        h, w = TRAIN_HW[0] // 4, TRAIN_HW[1] // 4
        pyramid, coords = lookup_inputs(gen, b, h, w, w)
        widths = [lvl.shape[-1] for lvl in pyramid]
        grad = torch.randn((b, h, w, 36), generator=gen, device=DEVICE).to(BF16)
        dtypes = [BF16] * 4
        ms = time_ms(lambda: corr_cuda.corr_scatter(coords, grad, widths, 4, dtypes), flush=flush)
        dev = kernel_ms(lambda: corr_cuda.corr_scatter(coords, grad, widths, 4, dtypes), ("corr_scatter_kernel",),
                        flush)
        plain_ms = time_ms(lambda: corr_cuda.plain_corr_scatter(coords, grad, widths, 4, dtypes), flush=flush)
        rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)
        rows = rows.to(BF16).requires_grad_()
        sampled = F.grid_sample(rows, grid.to(BF16), mode="bilinear", padding_mode="zeros", align_corners=True)
        gout = grad.reshape(-1, 4, 9).permute(1, 0, 2).reshape(sampled.shape).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(sampled, rows, gout, retain_graph=True), flush=flush)
        n_q = coords.numel()
        # Coordinates (fp32) and the bf16 cotangent read once, every level's
        # dense bf16 row written once.
        nbytes = 4 * n_q + 2 * n_q * 36 + 2 * n_q * sum(widths)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[timing] corr_scatter_bf16 b{b} {h}x{w}: kernel {ms:.4f} ms = {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{bound / ms:.0%} of its {bound:.4f} ms bound ({nbytes} B); alone on the device {alone_text(dev)} ms "
            f"({share_text(bound, dev)} of the bound); plain {plain_ms:.4f} ms; bf16 grid_sample backward "
            f"{lib_ms:.4f} ms")
        if b == MIXED_TRAIN_BATCH:
            entry("corr_scatter_bf16", ms, plain_ms, nbytes, 3 * n_q * 4 * 10, lib_ms)
        del pyramid, coords, grad, rows, grid, sampled, gout
    return out


def lever_bf16_timing(gen, flush, entry) -> list:
    """The levers' bf16 kernels at the 512x768 bucket's finest GRU scale
    (128x128x192; the JSON rows), the tail also at the realtime model's
    KITTI scales, and the windowed lookup at the bucket's 1/4 with bf16
    levels and taps (the library call is row 1b's: F.grid_sample on the
    bf16 levels, its grid in bf16)."""
    out = []
    for c, h, w in ((128, 128, 192), (128, 48, 156), (128, 24, 78)):
        zx, cz, qx, cq, hh = ((torch.randn((1, c, h, w), generator=gen, device=DEVICE) * 2).to(BF16)
                              for _ in range(5))
        n = hh.numel()
        ms = time_ms(lambda: gru_tail.fused_gru_tail(zx, cz, qx, cq, hh), flush=flush)
        plain_ms = time_ms(lambda: gru_tail.plain_fused_gru_tail(zx, cz, qx, cq, hh), flush=flush)
        if (h, w) == (128, 192):
            entry("gru_tail_bf16", ms, plain_ms, 6 * 2 * n, 12 * n, None)
            rh_ms = time_ms(lambda: gates.fused_rh(zx, cz, hh), flush=flush)
            rh_plain_ms = time_ms(lambda: gates.plain_rh(zx, cz, hh), flush=flush)
            entry("gates_rh_bf16", rh_ms, rh_plain_ms, 4 * 2 * n, 6 * n, None)
            c_ms = time_ms(lambda: gates.fused_combine(zx, cz, qx, cq, hh), flush=flush)
            c_plain_ms = time_ms(lambda: gates.plain_combine(zx, cz, qx, cq, hh), flush=flush)
            entry("gates_combine_bf16", c_ms, c_plain_ms, 6 * 2 * n, 12 * n, None)
        else:
            log(f"[timing] gru_tail_bf16 {c}x{h}x{w} (realtime, KITTI bucket): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {6 * 2 * n / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
        del zx, cz, qx, cq, hh
    for h, w in ((128, 192), (48, 156)):
        pre = torch.randn((1, 126, h, w), generator=gen, device=DEVICE).to(BF16)
        flow = torch.randn((1, 1, h, w), generator=gen, device=DEVICE).to(BF16)
        ms = time_ms(lambda: gru_tail.fused_motion_tail(pre, flow), flush=flush)
        dev = kernel_ms(lambda: gru_tail.fused_motion_tail(pre, flow), ("motion_tail",), flush)
        plain_ms = time_ms(lambda: gru_tail.plain_motion_tail(pre, flow), flush=flush)
        hw = h * w
        bound = 2 * hw * 255 / HBM_BYTES_PER_S * 1e3
        plan = gru_tail.motion_tail_plan(1, 126, hw, 2, _build.multiprocessors(0))
        where = "512x768 bucket" if (h, w) == (128, 192) else "realtime, KITTI bucket"
        log(f"[timing] motion_tail_bf16 126x{h}x{w} ({where}): kernel {ms:.4f} ms by events ({bound / ms:.0%} of "
            f"its {bound:.4f} ms bound), alone on the device {alone_text(dev)} ({share_text(bound, dev)}); plain {plain_ms:.4f} ms; "
            f"plan {plan.per_thread} units per thread, grid {plan.grid}")
        if (h, w) == (128, 192):
            entry("motion_tail_bf16", ms, plain_ms, 2 * hw * (126 + 1 + 128), 126 * hw, None)
        del pre, flow
    for label, (h, w) in (("512x768", (128, 192)), ("1984x2880", (496, 720))):
        pyramid, coords = lookup_inputs(gen, 1, h, w, w)
        pyramid = tuple(lvl.to(BF16) for lvl in pyramid)
        ms = time_ms(lambda: corr_cuda.prefetch_corr_lookup(pyramid, coords, 4, BF16), flush=flush)
        dense_ms = time_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4, BF16), flush=flush)
        dev = kernel_ms(lambda: corr_cuda.prefetch_corr_lookup(pyramid, coords, 4, BF16), ("corr_window",), flush)
        dense_dev = kernel_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4, BF16), ("corr_window",), flush)
        plain_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4).to(BF16), flush=flush)
        nbytes = lookup_bytes(pyramid, coords, 4, out_bytes=2)
        log(f"[timing] corr_prefetch_lookup_bf16 {label}: windowed {ms:.4f} ms (alone on the device {alone_text(dev)}), dense "
            f"bf16 kernel {dense_ms:.4f} ms (alone {alone_text(dense_dev)}), plain {plain_ms:.4f} ms, "
            f"{lookup_bounds(pyramid, coords, 4, 2)}")
        if label == "512x768":
            rows, grid = grid_sample_lookup_inputs(pyramid, coords, 4)
            rows, grid = rows.to(BF16), grid.to(BF16)
            lib_ms = time_ms(lambda: F.grid_sample(rows, grid, mode="bilinear", padding_mode="zeros",
                                                   align_corners=True), flush=flush)
            entry("corr_prefetch_lookup_bf16", ms, plain_ms, nbytes, 3 * coords.numel() * 36, lib_ms)
            del rows, grid
        del pyramid, coords
    return out


# -- the thirteenth slice: the train, evaluate and demo command lines ----------

# `python -m raft_stereo_tpu_torch train` in the JAX bench's training setup
# (the default architecture, reg_cuda with mixed precision and a bf16
# pyramid, batch 4 at 320x720, 22 iterations) with the reference's SceneFlow
# recipe's augmentation, over a FlyingThings3D tree at SceneFlow's 540x960
# written from the seed, with process workers and the device prefetcher.
# 8 steps, to keep the script inside its time limit now that the banded
# runs (several seconds a step) take the same steps.
TRAIN_CLI_STEPS = 8
TRAIN_CLI_PREEMPT_AFTER = 4
TRAIN_CLI_HW = (540, 960)
TRAIN_CLI_PAIRS = (8, 2)
TRAIN_CLI_FLAGS = ("--corr_implementation", "reg_cuda", "--mixed_precision", "--batch_size", "4",
                   "--image_size", "320", "720", "--train_iters", "22", "--spatial_scale", "-0.2", "0.4",
                   "--saturation_range", "0", "1.4", "--train_datasets", "sceneflow", "--root_dataset", "datasets",
                   "--worker_type", "process", "--num_workers", "4", "--device_prefetch",
                   "--num_steps", str(TRAIN_CLI_STEPS),
                   "--valid_datasets", "things", "--validate_every", str(TRAIN_CLI_STEPS))
TRAIN_CLI_VALID_ITERS = 32
TRAIN_CLI_LOSS_RTOL = 1e-3
TRAIN_CLI_TIMEOUT_S = 600
GATED_DAY = "2024-03-05_11-20-00"
STEP_LINE = re.compile(r"^(\S+ \S+) INFO .* step (\d+): live_loss (\S+),", re.M)


def log_time(stamp: str) -> float:
    """A logging timestamp ("2026-01-02 03:04:05,678") in seconds since the
    epoch (local time, as logging writes it)."""
    day, ms = stamp.split(",")
    return time.mktime(time.strptime(day, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3


def cli_env() -> dict:
    """The command lines' environment: the checkout on the import path, the
    rest inherited."""
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))


class CliRun:
    """One command-line process in its own process group, its output in
    files under `workdir`; `kill()` ends the whole group. `launcher` is
    what runs the package's command line (torchrun's module, or a rank
    that joins its process group first), `env` replaces `cli_env()`."""

    def __init__(self, workdir: str, tag: str, argv, launcher=("-m", "raft_stereo_tpu_torch"), env=None):
        self.tag = tag
        self.out_path = os.path.join(workdir, f"{tag}.out")
        self.err_path = os.path.join(workdir, f"{tag}.err")
        self.argv = [sys.executable, *launcher, *argv]
        self.t0 = time.time()
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(self.argv, cwd=workdir, env=env or cli_env(), stdout=out, stderr=err,
                                         text=True, start_new_session=True)

    def err(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def out(self) -> str:
        with open(self.out_path) as f:
            return f.read()

    def wait(self, timeout=TRAIN_CLI_TIMEOUT_S) -> int:
        return self.proc.wait(timeout=timeout)

    def signal_group(self, sig) -> None:
        os.killpg(self.proc.pid, sig)

    def kill(self) -> None:
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait(timeout=60)

    def steps(self) -> dict:
        """{step: (log time, live loss)} from the run's step lines."""
        return {int(n): (log_time(t), float(v)) for t, n, v in STEP_LINE.findall(self.err())}

    def launches(self) -> dict:
        found = re.findall(r"kernel launches: (\{.*\})", self.err())
        if not found:
            raise AssertionError(f"[train-cli] {self.tag}: no launch counts logged")
        return json.loads(found[-1])

    def fail(self, what: str):
        raise AssertionError(f"[train-cli] {self.tag}: {what}\n{' '.join(self.argv)}\n{self.err()[-3000:]}")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def train_numbers(run: CliRun, workdir: str, tag: str, phase: str = "train-cli") -> dict:
    """s/step (median after the warm step), data wait per step and
    checkpoint save s from the run's flight recorder (rank 0's); boot to
    the first step from its log; peak memory and the PNG decoder from its
    log."""
    recorder = read_json(os.path.join(workdir, "runs", "flight_recorder.json"))
    spans = [r for r in recorder["records"] if r.get("kind") == "span"]
    steps = [r["ms"] / 1e3 for r in spans if r["name"] == "step"]
    waits = [r["ms"] / 1e3 for r in spans if r["name"] == "data-wait"]
    saves = [r["ms"] / 1e3 for r in spans if r["name"] == "checkpoint-save"]
    first = min(run.steps().items())[1][0]
    peak = re.search(r"peak device memory: (\d+) bytes allocated, (\d+) bytes reserved", run.err())
    png = re.search(r"PNG decoder: (.*)", run.err())
    nums = {
        "s_per_step_median": statistics.median(steps[1:]) if len(steps) > 1 else None,
        "warm_step_s": steps[0] if steps else None,
        "data_wait_s_median": statistics.median(waits[1:]) if len(waits) > 1 else None,
        "data_wait_s_max": max(waits[1:]) if len(waits) > 1 else None,
        "checkpoint_save_s": saves,
        "boot_to_first_step_s": first - run.t0,
        "peak_allocated_bytes": int(peak.group(1)) if peak else None,
        "peak_reserved_bytes": int(peak.group(2)) if peak else None,
        "png_decoder": png.group(1).strip() if png else None,
    }
    log(f"[{phase}] {tag} numbers: {json.dumps(nums)}")
    return nums


def check_committed(workdir: str, name: str, step: int, tag: str) -> str:
    from raft_stereo_tpu_torch.utils import checkpoints as ck

    step_dir = os.path.join(workdir, "checkpoints", name, str(step))
    problems = ck.validate_checkpoint(step_dir)
    if problems:
        raise AssertionError(f"[train-cli] {tag}: step {step} is not committed: {problems}")
    return step_dir


def prefetch_check(workdir: str) -> None:
    """In process, on the written tree: the DevicePrefetcher hands the card
    the loader's batches value for value, and a mixed training step in the
    [train-cli] configuration on a prefetched batch equals the step on the
    same batch copied plainly, bit for bit (two trainers from one seed)."""
    from raft_stereo_tpu_torch.config import AugmentConfig
    from raft_stereo_tpu_torch.data.datasets import build_training_dataset
    from raft_stereo_tpu_torch.data.loader import DataLoader
    from raft_stereo_tpu_torch.data.prefetch import DevicePrefetcher

    cfg = TrainConfig(model=MIXED_TRAIN_CONFIG, augment=AugmentConfig(crop_size=TRAIN_HW, min_scale=-0.2,
                                                                      max_scale=0.4, saturation_range=(0.0, 1.4)),
                      batch_size=MIXED_TRAIN_BATCH, train_iters=MIXED_TRAIN_ITERS,
                      root_dataset=os.path.join(workdir, "datasets"))
    dataset = build_training_dataset(cfg)
    plain_loader = DataLoader(dataset, cfg.batch_size, seed=cfg.seed, num_workers=2)
    staged_loader = DataLoader(dataset, cfg.batch_size, seed=cfg.seed, num_workers=2)
    try:
        host = [b for _, b in zip(range(2), plain_loader)]
        staged = [b for _, b in zip(range(2), DevicePrefetcher(staged_loader, DEVICE))]
        same = all(torch.equal(s[k].cpu(), torch.from_numpy(h[k])) for h, s in zip(host, staged) for k in s)
        a, b = Trainer(cfg, (*TRAIN_HW, 3), device=DEVICE), Trainer(cfg, (*TRAIN_HW, 3), device=DEVICE)
        ma, mb = a.train_step(host[1]), b.train_step(staged[1])
        torch.cuda.synchronize()
        params = all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))
    finally:
        plain_loader.close()
        staged_loader.close()
    log(f"[train-cli] prefetch: 2 batches staged on the card equal the loader's: {same}; a mixed step on the "
        f"staged batch vs the plain copy: loss {mb['live_loss']!r} vs {ma['live_loss']!r}, parameters bit for bit "
        f"equal: {params}")
    if not (same and ma == mb and params):
        raise AssertionError(f"[train-cli] prefetched batches or step differ: {same}, {ma} vs {mb}, {params}")
    del a, b
    torch.cuda.empty_cache()


class Beside:
    """`fn()` on a thread of its own while the caller runs another phase;
    `join()` waits for it and raises what it raised."""

    def __init__(self, fn):
        self.error = None
        self.thread = threading.Thread(target=self._run, args=(fn,), name=f"beside-{fn.__name__}", daemon=True)
        self.thread.start()

    def _run(self, fn) -> None:
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - raised again by join()
            self.error = exc

    def join(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise self.error


def phase_train_cli(card: str, beside=None) -> dict:
    """The train, evaluate and demo command lines as a user runs them, each
    as a process on a dataset written from the seed: a control run of
    TRAIN_CLI_STEPS steps (exit 0, a valid run report, a committed last
    step, the lookup and scatter kernels launched every step); the same
    command with --auto_resume under another name, stopped with SIGTERM to
    its process group after TRAIN_CLI_PREEMPT_AFTER steps (exit 13, a
    committed checkpoint at the stopped step), then rerun (resumed from that
    step, exit 0 at the last step, the loader cursor at the last step equal
    to the control's, every later step's loss within TRAIN_CLI_LOSS_RTOL of
    the control's); then `evaluate --dataset things` and `demo` (the JAX
    bench's test-mode levers) on the control's model.pth: exit 0, finite
    EPE and MAE, one depth output per frame; then [parallel] and
    [spatial] (ii)-(iv), with `beside()`, when given, on a thread of its
    own while (ii)-(iv) run. Any failure kills every process and fails
    the phase."""
    from raft_stereo_tpu_torch.data import trees
    from raft_stereo_tpu_torch.utils.run_report import validate_run_report

    rng = np.random.default_rng(SEED)
    workdir = tempfile.mkdtemp(prefix="train-cli-")
    runs = []
    numbers = {}
    try:
        t0 = time.perf_counter()
        trees.write_sceneflow(os.path.join(workdir, "datasets"), rng, *TRAIN_CLI_PAIRS, *TRAIN_CLI_HW)
        trees.write_gated(os.path.join(workdir, "gated"), rng, [GATED_DAY], 2, modalities=("RGB",))
        log(f"[train-cli] dataset: FlyingThings3D {TRAIN_CLI_PAIRS[0]} TRAIN + {TRAIN_CLI_PAIRS[1]} TEST pairs at "
            f"{TRAIN_CLI_HW[0]}x{TRAIN_CLI_HW[1]}, a 2-frame gated RGB tree at 720x1280, written in "
            f"{time.perf_counter() - t0:.1f} s")

        prefetch_check(workdir)

        def start(tag, argv, **kw):
            run = CliRun(workdir, tag, argv, **kw)
            runs.append(run)
            return run

        def finish(run, want_code):
            try:
                code = run.wait()
            except subprocess.TimeoutExpired:
                run.fail(f"no exit within {TRAIN_CLI_TIMEOUT_S} s")
            if code != want_code:
                run.fail(f"exit {code}, expected {want_code}")
            report = read_json(os.path.join(workdir, "runs", "run_report.json"))
            problems = validate_run_report(report)
            if problems:
                run.fail(f"run report invalid: {problems}")
            return report

        # 1. Control.
        control = start("control", ["train", "--name", "control", *TRAIN_CLI_FLAGS])
        report = finish(control, 0)
        if report["final_step"] != TRAIN_CLI_STEPS or report["last_good_step"] != TRAIN_CLI_STEPS:
            control.fail(f"report {report}")
        control_dir = check_committed(workdir, "control", TRAIN_CLI_STEPS, "control")
        control_steps = control.steps()
        if sorted(control_steps) != list(range(1, TRAIN_CLI_STEPS + 1)):
            control.fail(f"step lines {sorted(control_steps)}")
        n_valid = TRAIN_CLI_PAIRS[1]
        want = expect(corr_lookup_bf16=MIXED_TRAIN_ITERS * TRAIN_CLI_STEPS + n_valid * TRAIN_CLI_VALID_ITERS,
                      corr_scatter_bf16=MIXED_TRAIN_ITERS * TRAIN_CLI_STEPS)
        counts = control.launches()
        log(f"[train-cli] control: exit 0, {TRAIN_CLI_STEPS} steps, step {TRAIN_CLI_STEPS} committed, "
            f"validation {re.findall(r'validation .*', control.err())[-1:]}, launches {counts}")
        if counts != want:
            control.fail(f"launches {counts} != expected {want}")
        numbers["control"] = train_numbers(control, workdir, "control")

        # 2. Preemption: SIGTERM to the process group once the run has taken
        # TRAIN_CLI_PREEMPT_AFTER steps, read from its step lines.
        resume_flags = ["train", "--name", "preempt", "--auto_resume", *TRAIN_CLI_FLAGS]
        first = start("preempt", resume_flags)
        deadline = time.time() + TRAIN_CLI_TIMEOUT_S
        while first.proc.poll() is None and max(first.steps(), default=0) < TRAIN_CLI_PREEMPT_AFTER:
            if time.time() > deadline:
                first.fail("no progress")
            time.sleep(0.05)
        seen = max(first.steps(), default=0)
        first.signal_group(signal.SIGTERM)
        t_sig = time.time()
        report = finish(first, 13)
        stopped = report["last_good_step"]
        if report["stop_cause"] != "preempted" or report["preempt_signal"] != "SIGTERM" or stopped < seen or \
                stopped >= TRAIN_CLI_STEPS or report["final_step"] != stopped:
            first.fail(f"report {report}")
        check_committed(workdir, "preempt", stopped, "preempt")
        log(f"[train-cli] preempt: SIGTERM after step {seen}, exit 13 {time.time() - t_sig:.2f} s later with "
            f"stop_cause preempted and step {stopped} committed")
        numbers["preempt"] = train_numbers(first, workdir, "preempt")

        # 3. Resume: the same command again.
        second = start("resume", resume_flags)
        report = finish(second, 0)
        if report["resumed_from_step"] != stopped or report["final_step"] != TRAIN_CLI_STEPS or \
                report["resume_count"] != 1:
            second.fail(f"report {report}")
        resume_dir = check_committed(workdir, "preempt", TRAIN_CLI_STEPS, "resume")
        cursor = {k: read_json(os.path.join(d, "run_state.json"))["loader"] for k, d in
                  (("control", control_dir), ("resume", resume_dir))}
        if cursor["control"] != cursor["resume"]:
            second.fail(f"loader cursor {cursor['resume']} != the control's {cursor['control']}")
        resumed_steps = second.steps()
        if sorted(resumed_steps) != list(range(stopped + 1, TRAIN_CLI_STEPS + 1)):
            second.fail(f"step lines {sorted(resumed_steps)}")
        gaps = {n: abs(resumed_steps[n][1] - control_steps[n][1]) / abs(control_steps[n][1]) for n in resumed_steps}
        worst = max(gaps.values())
        log(f"[train-cli] resume: from step {stopped}, exit 0 at step {TRAIN_CLI_STEPS}; loader cursor "
            f"{cursor['resume']} equals the control's; largest relative loss gap to the control over steps "
            f"{stopped + 1}-{TRAIN_CLI_STEPS} {worst:.3e} (tol {TRAIN_CLI_LOSS_RTOL:g}); per step "
            f"{ {n: f'{g:.2e}' for n, g in sorted(gaps.items())} }")
        if not worst <= TRAIN_CLI_LOSS_RTOL:
            second.fail(f"losses differ from the control's by {worst:.3e} relative")
        numbers["resume"] = train_numbers(second, workdir, "resume")
        numbers["resume"]["resume_to_first_step_s"] = min(resumed_steps.items())[1][0] - second.t0

        # 4. Evaluate and demo on the control's model.pth, side by side.
        model_pth = os.path.join(control_dir, "model.pth")
        demo_out = os.path.join(workdir, "demo-out")
        ev = start("evaluate", ["evaluate", "--dataset", "things", "--restore_ckpt", model_pth, "--root_dataset",
                                "datasets", "--corr_implementation", "reg_cuda", "--mixed_precision"])
        dm = start("demo", ["demo", "--restore_ckpt", model_pth, "--root_dataset", "gated", "--output_path", demo_out,
                            "--save_numpy", "--corr_implementation", "reg_cuda", "--mixed_precision",
                            "--fused_encoder", "--fused_gru_tail"])
        for run in (ev, dm):
            if run.wait() != 0:
                run.fail("exit non-zero")
        found = re.search(r"Validation FlyingThings: (\S+), (\S+)", ev.out())
        if found is None or not all(np.isfinite(float(v)) for v in found.groups()):
            ev.fail(f"no finite validation line: {ev.out()[-500:]}")
        ev_counts = ev.launches()
        if ev_counts != expect(corr_lookup_bf16=n_valid * TRAIN_CLI_VALID_ITERS):
            ev.fail(f"launches {ev_counts}")
        log(f"[train-cli] evaluate --dataset things on control/{TRAIN_CLI_STEPS}/model.pth: exit 0, EPE, D1 "
            f"{[float(v) for v in found.groups()]}, launches {ev_counts}")
        found = re.search(r"AVG MAE: (\S+)", dm.out())
        depths = sorted(glob.glob(os.path.join(demo_out, GATED_DAY, "cam_stereo", "left", "model", "npy", "*.npy")))
        if found is None or not np.isfinite(float(found.group(1))) or len(depths) != 2 or \
                not all(np.isfinite(np.load(d)).all() and np.load(d).shape == (720, 1280) for d in depths):
            dm.fail(f"MAE line {found and found.group(0)}, depth outputs {depths}")
        dm_counts = dm.launches()
        n_frames = 2
        want_demo = expect(corr_pyramid_bf16=n_frames, encoder_conv_bf16=8 * n_frames, encoder_join_bf16=4 * n_frames,
                           corr_lookup_bf16=TRAIN_CLI_VALID_ITERS * n_frames,
                           gru_tail_bf16=3 * TRAIN_CLI_VALID_ITERS * n_frames,
                           motion_tail_bf16=TRAIN_CLI_VALID_ITERS * n_frames)
        log(f"[train-cli] demo (--fused_encoder --fused_gru_tail) on the gated RGB tree: exit 0, {found.group(0)}, "
            f"{len(depths)} depth outputs, launches {dm_counts}; evaluate and demo together "
            f"{time.time() - ev.t0:.1f} s")
        if dm_counts != want_demo:
            dm.fail(f"launches {dm_counts} != expected {want_demo}")
        log(f"[train-cli] {card}: {json.dumps(numbers)}")
        phase_parallel(card, workdir, control_steps, start)
        other = Beside(beside) if beside is not None else None
        try:
            phase_spatial_train(card, workdir, control_steps, start)
        finally:
            if other is not None:
                other.thread.join()
        if other is not None:
            other.join()
        return {"control": counts, "evaluate": ev_counts, "demo": dm_counts}
    finally:
        for run in runs:
            if run.proc.poll() is None:
                run.kill()
        shutil.rmtree(workdir, ignore_errors=True)


# -- the fifteenth slice: training across processes and cards -------------------

# [parallel]: `train` in [train-cli]'s configuration and on its dataset,
# launched as ranks: torchrun with one rank (NCCL) under dp, then under fsdp
# with the async commit and the /metrics sidecar, stopped by SIGTERM and
# resumed under dp; and two ranks sharing the one card over gloo (NCCL
# refuses two ranks on one device), each on 2 rows of the host's batch of 4,
# one of them stopped by SIGTERM. Every run keeps the control's
# --num_steps (the one-cycle schedule is drawn over it), so its steps are
# comparable to the control's.
PARALLEL_PREEMPT_AFTER = 4
# Two ranks of 2 rows against the control's batch of 4: the batch's
# composition moves cuDNN's choices and the bf16 sums' order; the mixed
# training step's tolerance (MIXED_TRAIN_GRAD_TOL).
PARALLEL_TWO_RANK_RTOL = 2.5e-2
TORCHRUN_ONE_RANK = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                     "-m", "raft_stereo_tpu_torch")
GLOO_RANK = ("-c", "import sys; from raft_stereo_tpu_torch.parallel import init_multihost; "
             "init_multihost(backend='gloo'); from raft_stereo_tpu_torch import cli; sys.exit(cli.main(sys.argv[1:]))")


def parallel_report(run: CliRun, workdir: str, name: str = "run_report.json") -> dict:
    from raft_stereo_tpu_torch.utils.run_report import validate_run_report

    report = read_json(os.path.join(workdir, "runs", name))
    problems = validate_run_report(report)
    if problems:
        run.fail(f"{name} invalid: {problems}")
    return report


def parallel_wait(run: CliRun) -> int:
    try:
        return run.wait()
    except subprocess.TimeoutExpired:
        run.fail(f"no exit within {TRAIN_CLI_TIMEOUT_S} s")


def parallel_check(run: CliRun, control_steps: dict, first: int, last: int, rtol: float,
                   validate_at: int = TRAIN_CLI_STEPS) -> tuple:
    """The step losses first..last against the control's, and the lookup
    and scatter kernels launched once an iteration of every step taken
    (and the lookup of every validation iteration, when the run reached
    its validation step, `validate_at`: the control's unless the run sets
    its own)."""
    got = run.steps()
    if sorted(got) != list(range(first, last + 1)):
        run.fail(f"step lines {sorted(got)}, expected {first}-{last}")
    gap = max(abs(got[n][1] - control_steps[n][1]) / abs(control_steps[n][1]) for n in got)
    if not gap <= rtol:
        run.fail(f"losses differ from the control's by {gap:.3e} relative (tol {rtol:g}): "
                 f"{gap_text(run, control_steps)}")
    taken = last - first + 1
    validated = TRAIN_CLI_PAIRS[1] * TRAIN_CLI_VALID_ITERS if last == validate_at else 0
    counts = run.launches()
    if counts != expect(corr_lookup_bf16=MIXED_TRAIN_ITERS * taken + validated,
                        corr_scatter_bf16=MIXED_TRAIN_ITERS * taken):
        run.fail(f"launches {counts} for {taken} steps")
    backend = re.findall(r"process group joined: .*backend (\w+)", run.err())
    return gap, counts, backend


def gap_text(run: CliRun, control_steps: dict) -> str:
    got = run.steps()
    return "{" + ", ".join(f"{n}: {abs(v - control_steps[n][1]) / abs(control_steps[n][1]):.2e}"
                           for n, (_, v) in sorted(got.items())) + "}"


def until_step(runs, watch: CliRun, step: int) -> int:
    """Wait for `watch` to log `step`; every run must still be going."""
    deadline = time.time() + TRAIN_CLI_TIMEOUT_S
    while max(watch.steps(), default=0) < step:
        for run in runs:
            if run.proc.poll() is not None or time.time() > deadline:
                run.fail(f"no step {step} (exit {run.proc.poll()})")
        time.sleep(0.05)
    return max(watch.steps())


def phase_parallel(card: str, workdir: str, control_steps: dict, start) -> dict:
    """`train` across ranks on [train-cli]'s tree against its control run
    (TRAIN_CLI_STEPS steps): (b) fsdp with the async commit every 2 steps and
    the /metrics sidecar scraped while it runs, stopped by SIGTERM to
    torchrun after PARALLEL_PREEMPT_AFTER steps (the rank's report:
    preempted, its checkpoints committed), then rerun with `--auto_resume`
    under dp to the end, beside `--explain_sharding` listing every
    parameter; (c) two ranks on the one card over gloo, 2 rows each:
    SIGTERM to rank 1 alone, both ranks stopped at one step with exit 13
    and preempted reports, one checkpoint committed, losses within
    PARALLEL_TWO_RANK_RTOL of the control's batch-4 steps. Any failure
    fails the phase (no rank moves to the CPU)."""
    numbers = {}
    last = TRAIN_CLI_STEPS

    # (a), dp over the control's whole run under torchrun, is left out to
    # keep the script inside its time limit: (b)'s resume runs the same
    # path (torchrun, one rank, NCCL, dp) over the steps after the fsdp
    # run's stop against the control.

    # (b) fsdp, one rank, async commit, /metrics; SIGTERM to torchrun.
    port = free_port()
    fs = start("parallel-fsdp", ["train", "--name", "par-fsdp", "--auto_resume", *TRAIN_CLI_FLAGS,
                                 "--sharding_rules", "fsdp", "--async_checkpoint", "--checkpoint_every", "2",
                                 "--metrics_port", str(port)], launcher=TORCHRUN_ONE_RANK)
    scraped = []
    while max(fs.steps(), default=0) < PARALLEL_PREEMPT_AFTER:
        if fs.proc.poll() is not None:
            fs.fail("exited before the signal")
        try:
            body = request(f"http://127.0.0.1:{port}/metrics", timeout_s=2).body.decode()
            found = re.search(r"^raft_train_steps_total (\S+)$", body, re.M)
            if found:
                scraped.append(float(found.group(1)))
        except (ConnectionError, OSError):
            pass
        time.sleep(0.1)
    seen = max(fs.steps())
    fs.signal_group(signal.SIGTERM)
    code = parallel_wait(fs)
    report = parallel_report(fs, workdir)
    stop = report["final_step"]
    spine = report["io_spine"]
    if code == 0 or report["stop_cause"] != "preempted" or stop < seen or report["last_good_step"] != stop:
        fs.fail(f"torchrun exit {code}, report {report}")
    gap, counts, backend = parallel_check(fs, control_steps, 1, stop, TRAIN_CLI_LOSS_RTOL)
    if not scraped or max(scraped) < 1 or not spine["async_checkpoint"] or spine["async_commits"] < 1:
        fs.fail(f"/metrics step counts {scraped}, io_spine {spine}")
    committed = ck_steps(workdir, "par-fsdp")
    for n in committed:
        check_committed(workdir, "par-fsdp", n, "parallel fsdp")
    if committed[-1] != stop:
        fs.fail(f"committed steps {committed}, stopped at {stop}")
    numbers["fsdp"] = train_numbers(fs, workdir, "fsdp, world 1", phase="parallel")
    log(f"[parallel] (b) torchrun, 1 rank, backend {backend}, fsdp, --async_checkpoint --checkpoint_every 2: SIGTERM "
        f"to torchrun after step {seen}, torchrun exit {code}, the rank's report preempted at step {stop}; largest "
        f"relative loss gap to the control {gap:.3e}, launches {counts}; /metrics scraped {len(scraped)} times "
        f"during the run, step counter {sorted(set(scraped))}; {spine['async_commits']} async commits, longest "
        f"{spine['max_commit_latency_s']:.3f} s; steps {committed} committed")

    # (b) resumed under dp, beside the fsdp placement dump.
    resume = start("parallel-resume", ["train", "--name", "par-fsdp", "--auto_resume", *TRAIN_CLI_FLAGS,
                                       "--sharding_rules", "dp"], launcher=TORCHRUN_ONE_RANK)
    explain = start("parallel-explain", ["train", "--explain_sharding", "--sharding_rules", "fsdp",
                                         *TRAIN_CLI_FLAGS])
    if parallel_wait(resume) != 0:
        resume.fail("exit non-zero")
    report = parallel_report(resume, workdir)
    if report["resumed_from_step"] != stop or report["final_step"] != last or report["resume_count"] != 1:
        resume.fail(f"report {report}")
    gap, counts, backend = parallel_check(resume, control_steps, stop + 1, last, TRAIN_CLI_LOSS_RTOL)
    if parallel_wait(explain) != 0:
        explain.fail("exit non-zero")
    with torch.device("meta"):
        names = [n for n, _ in RAFTStereo(MIXED_TRAIN_CONFIG).named_parameters()]
    missing = [n for n in names if not re.search(rf"^{re.escape(n)} ", explain.out(), re.M)]
    if missing or "sharding preset: fsdp" not in explain.out():
        explain.fail(f"parameters missing from the dump: {missing[:5]}")
    numbers["dp"] = train_numbers(resume, workdir, "dp resumed, world 1", phase="parallel")
    log(f"[parallel] (b) --auto_resume under dp (torchrun, 1 rank, backend {backend}) from the fsdp run's step "
        f"{stop}: exit 0 at step {last}, "
        f"relative loss gaps to the control per step {gap_text(resume, control_steps)} (tol "
        f"{TRAIN_CLI_LOSS_RTOL:g}), launches {counts}; "
        f"--explain_sharding: {len(names)} parameters, each listed")

    # (c) two ranks on the one card over gloo; SIGTERM to rank 1.
    port = free_port()
    ranks = [start(f"parallel-rank{r}", ["train", "--name", "par-two", *TRAIN_CLI_FLAGS, "--sharding_rules", "dp"],
                   launcher=GLOO_RANK,
                   env=dict(cli_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
             for r in range(2)]
    seen = until_step(ranks, ranks[1], PARALLEL_PREEMPT_AFTER)
    ranks[1].proc.send_signal(signal.SIGTERM)
    t_sig = time.time()
    codes = [parallel_wait(run) for run in ranks]
    if codes != [13, 13]:
        ranks[0].fail(f"exit codes {codes}; rank 1: {ranks[1].err()[-2000:]}")
    reports = [parallel_report(run, workdir, name) for run, name in zip(ranks, ("run_report.json",
                                                                                  "run_report.p1.json"))]
    stop = reports[0]["final_step"]
    if any(r["stop_cause"] != "preempted" or r["final_step"] != stop or r["last_good_step"] != stop or
           r["process_count"] != 2 for r in reports) or stop < seen:
        ranks[0].fail(f"reports {reports}")
    step_dir = check_committed(workdir, "par-two", stop, "parallel two ranks")
    if ck_steps(workdir, "par-two") != [stop] or not os.path.exists(os.path.join(step_dir, "run_state.p1.json")):
        ranks[0].fail(f"checkpoints {ck_steps(workdir, 'par-two')}")
    checks = [parallel_check(run, control_steps, 1, stop, PARALLEL_TWO_RANK_RTOL) for run in ranks]
    numbers["two ranks"] = train_numbers(ranks[0], workdir, "dp, 2 ranks on one card", phase="parallel")
    log(f"[parallel] (c) 2 ranks on one card over gloo, dp, 2 rows each: SIGTERM to rank 1 after its "
        f"step {seen}; both exit 13 {time.time() - t_sig:.2f} s later at step {stop} (reports: "
        f"{reports[0]['preempt_signal']}, {reports[1]['preempt_signal']}; {reports[0]['coord_syncs']} pod syncs), "
        f"step {stop} committed with both ranks' run states; largest relative loss gap to the control's batch-4 "
        f"steps {max(c[0] for c in checks):.3e} (tol {PARALLEL_TWO_RANK_RTOL:g}); launches per rank {checks[0][1]}")
    log(f"[parallel] {card}: {json.dumps(numbers)}")
    return numbers


# -- the sixteenth slice: row bands over the spatial axis ------------------------

# [spatial]: the spatial presets on the one card, two (or four) ranks sharing
# it over gloo as [parallel] (c) does. (i) The test-mode forward at
# Middlebury-F, the default architecture with mixed precision and "pallas"
# (MIXED_UNFUSED_CONFIG: the fused encoder is refused on bands, and with it
# the pyramid kernel, which runs under that flag only), `mild_model`'s
# weights, 32 iterations, each rank on its 992 rows of a (1, 2) mesh,
# against the unsharded forward in this process. As run, cuDNN picks its
# bf16 convolutions by shape, so a band and the whole image round
# differently (0.014 px after one iteration) and the untrained GRU carries
# that chaotically (px after 32, flows reaching 550 px): printed, as
# [mixed-evaluate] prints its chaotic gap. Held: the same forwards with the
# shape-dependent reductions pinned (`band_pinned`: cuDNN off in both, and
# the control's instance norm summing its two row halves as the two bands
# do) to E2E_TOL_PX at 32 iterations (the serving front's pinned bound;
# measured 0.0). (ii) `train` under `--sharding_rules spatial --mesh_shape
# 1 2` in [train-cli]'s setup over the control's first steps (2 since the
# eighteenth slice, below), validation on bands included: losses within
# the two-rank tolerance of [parallel] (c) (the bands round the bf16 sums
# in another order), 22 lookups and 22 scatters a step on each rank.
# (iii) `dp+spatial` on a (2, 2) mesh, four ranks, 2 steps (the schedule
# matches the control's up to step 2).
# The seventeenth slice adds to (i) the JAX bench's model (MIXED_CONFIG:
# the fused encoder and the bf16 pyramid kernel) on the same two bands,
# in the same rank processes: per rank per forward 8 bf16 conv launches
# (the halo form), 4 joins, 1 pyramid and a lookup per iteration; the
# prelude's outputs (both feature maps and the context) against the whole
# image's fused prelude with every shape-dependent reduction pinned
# (`band_pinned`, and `fused_halves` for the fused layer1's statistics),
# held to SPATIAL_PRELUDE_ULPS bf16 ulps of each tensor's largest
# magnitude (measured 0.0 on the CPU; the tolerance is [mixed-e2e]'s for
# the fused against the direct prelude, MIXED_STATE_ULPS); the flow drift
# as run at 1, 4 and 32 iterations printed, and the exchanges a forward
# against the unfused model's.
# The eighteenth slice adds (iv): `fsdp` on the same (2, 2) mesh in (iii)'s
# setup, FSDP2 over each data group of two ranks on the one card (its
# all-gather and reduce-scatter over gloo on CUDA tensors) inside the row
# bands; each rank logs its local shapes of a conv weight whose C_out
# divides 2 (half) and of the C_out=1 flow head (whole), with both AdamW
# moments, after its last step (`fsdp_train_rank`). To keep the script
# inside its time limit (iv) took from (ii) its steps 3-8: (ii) runs 2
# steps and validates on bands at step 2 (the one-cycle schedule matches
# the control's up to step 2, as (iii)'s does).
SPATIAL_PRELUDE_ULPS = MIXED_STATE_ULPS
SPATIAL_ITERS = 32
# Shorter forwards as run, for the drift's growth with the iterations.
SPATIAL_DRIFT_ITERS = (1, 4)
SPATIAL_TRAIN_RTOL = PARALLEL_TWO_RANK_RTOL
SPATIAL_PAIR_STEPS = 2
SPATIAL_QUAD_STEPS = 2
SPATIAL_RANK = ("-c", "import sys, chip_smoke; sys.exit(chip_smoke.spatial_forward_rank(sys.argv[1]))")
FSDP_RANK = ("-c", "import sys; from raft_stereo_tpu_torch.parallel import init_multihost; "
             "init_multihost(backend='gloo'); import chip_smoke; sys.exit(chip_smoke.fsdp_train_rank(sys.argv[1:]))")
# (label, mesh, preset, steps, extra flags, launcher). The ranks read with
# loader threads, not [train-cli]'s worker processes (which the control,
# preempt and resume runs and [parallel] keep): a worker process per
# rank imports torch beside the ranks on the host's 8 cores and slowed
# their boot, and the convergence test runs beside them; the batches are
# the same (each sample's generator is seeded by its index) and a step's
# data wait is milliseconds either way.
SPATIAL_LOADER = ("--worker_type", "thread", "--num_workers", "1")
SPATIAL_TRAIN_RUNS = (("(ii)", (1, 2), "spatial", SPATIAL_PAIR_STEPS,
                       ("--validate_every", str(SPATIAL_PAIR_STEPS), *SPATIAL_LOADER), GLOO_RANK),
                      ("(iii)", (2, 2), "dp+spatial", SPATIAL_QUAD_STEPS, SPATIAL_LOADER, GLOO_RANK),
                      ("(iv)", (2, 2), "fsdp", SPATIAL_QUAD_STEPS, SPATIAL_LOADER, FSDP_RANK))
# (iv)'s shape checks: C_out 256 (sharded over the data axis of 2) and 1 (whole).
FSDP_SHAPE_PARAMS = {"fnet.conv2.weight": 2, "update_block.flow_head.conv2.weight": 1}


@contextlib.contextmanager
def band_pinned(halves: bool):
    """cuDNN off (PyTorch's own convolution, whose sums do not depend on
    the image's height) and, with `halves`, the instance norm's statistics
    summed over the two row halves separately and then added, as two bands
    sum theirs (parallel/spatial.py): a whole image's forward then equals
    its two bands' bit for bit."""
    def split(self, x):
        xs = x.float() if x.dtype == torch.bfloat16 else x
        h = x.shape[2] // 2
        sums = [torch.stack([part.sum(dim=(2, 3)), (part * part).sum(dim=(2, 3))])
                for part in (xs[:, :, :h].contiguous(), xs[:, :, h:].contiguous())]
        total = sums[0] + sums[1]
        n = x.shape[2] * x.shape[3]
        mean = (total[0] / n)[..., None, None]
        var = torch.clamp((total[1] / n)[..., None, None] - mean * mean, min=0.0)
        return (x - mean.to(x.dtype)) * torch.rsqrt(var + self.epsilon).to(x.dtype)

    with torch.backends.cudnn.flags(enabled=False):
        if not halves:
            yield
            return
        with swapped(layers.InstanceNorm, forward=split):
            yield


@contextlib.contextmanager
def fused_halves():
    """The fused layer1's statistics summed as two row bands sum theirs
    (ops/encoder_cuda.py `fused_layer1` in a band scope): each conv's
    [sum, sum of squares] from the kernel on each row half with its
    neighbour row (the halo form), added in fp32, and the stem's over each
    half, added. With `band_pinned(halves=True)` a whole image's fused
    forward then equals its two bands' bit for bit."""
    conv, stats = encoder_cuda.fused_conv, encoder_cuda.channel_stats

    def halves_conv(x, weight, bias, aff, form="none", emit_stats=False, halo=(0, 0)):
        y, s = conv(x, weight, bias, aff, form, emit_stats, halo)
        if emit_stats and tuple(halo) == (0, 0):
            h = x.shape[2] // 2
            s = (conv(x[:, :, :h + 1].contiguous(), weight, bias, aff, form, True, (0, 1))[1]
                 + conv(x[:, :, h - 1:].contiguous(), weight, bias, aff, form, True, (1, 0))[1])
        return y, s

    def halves_stats(y):
        h = y.shape[2] // 2
        return stats(y[:, :, :h].contiguous()) + stats(y[:, :, h:].contiguous())

    with swapped(encoder_cuda, fused_conv=halves_conv, channel_stats=halves_stats):
        yield


def prelude_outputs(model: RAFTStereo, i1, i2, scope=None) -> dict:
    """A test-mode prelude's feature maps (the feature encoder's output,
    caught by a hook) and context, as fp32 numpy, NCHW: on `scope`'s band
    when given."""
    caught = []
    hook = model.fnet.register_forward_hook(lambda mod, args, out: caught.append(out))
    try:
        with torch.inference_mode(), (scope.bands(i1.shape[1], model.config.n_downsample) if scope is not None
                                      else contextlib.nullcontext()):
            state = model.encode_features(i1, i2, test_mode=True)
    finally:
        hook.remove()
    fmap1, fmap2 = torch.chunk(torch.cat(caught), 2, dim=0)
    out = {"fmap1": fmap1, "fmap2": fmap2}
    out.update({f"context{i}.{j}": t for i, c in enumerate(state["context"]) for j, t in enumerate(c)})
    return {k: v.float().cpu().numpy() for k, v in out.items()}


def bf16_ulps_of_max(x: np.ndarray) -> float:
    """One bf16 ulp at the largest magnitude of `x`."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def gloo_rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for rank `rank` of `world` ranks sharing the
    one card (LOCAL_RANK 0 for all: each binds card 0)."""
    return dict(cli_env(), RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def spatial_forward_rank(workdir: str) -> int:
    """One rank of [spatial] (i): its band of the pair in `workdir`, the
    short forwards (which warm the kernels), the timed one with the launch
    counts set to 0 just before it, then the pinned one; then the same for
    the fused model and its pinned prelude; writes band<k>[-<iters>].npy,
    pinned<k>.npy, fused<k>[-<iters>].npy, prelude<k>.npz and
    rank<k>.json."""
    from raft_stereo_tpu_torch.parallel import init_multihost, spatial
    from raft_stereo_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    init_multihost(backend="gloo")
    rank = torch.distributed.get_rank()
    scope = spatial.band_scope_for(make_mesh((1, 2), device_type="cuda"))
    model = spatial.BandedModel(mild_model(MIXED_UNFUSED_CONFIG), scope)
    band = [scope.take_band(torch.from_numpy(np.load(os.path.join(workdir, f"image{k}.npy"))), 1).contiguous()
            .to(DEVICE) for k in (1, 2)]
    # The short forwards come first and warm every kernel of the timed one.
    for iters in SPATIAL_DRIFT_ITERS:
        up = timed_forward(model, *band, iters)[1]
        np.save(os.path.join(workdir, f"band{rank}-{iters}.npy"), up.float().cpu().numpy())
    reset_launches()
    before = scope.exchanges
    _, up, seconds, peak = timed_forward(model, *band, SPATIAL_ITERS)
    counts = launches()
    exchanges = scope.exchanges - before
    np.save(os.path.join(workdir, f"band{rank}.npy"), up.float().cpu().numpy())
    with band_pinned(halves=False):
        _, up, pinned_s, _ = timed_forward(model, *band, SPATIAL_ITERS)
    np.save(os.path.join(workdir, f"pinned{rank}.npy"), up.float().cpu().numpy())
    del model
    torch.cuda.empty_cache()
    # The fused model (the JAX bench's) on the same band.
    fused = spatial.BandedModel(mild_model(MIXED_CONFIG), scope)
    for iters in SPATIAL_DRIFT_ITERS:
        up = timed_forward(fused, *band, iters)[1]
        np.save(os.path.join(workdir, f"fused{rank}-{iters}.npy"), up.float().cpu().numpy())
    reset_launches()
    before = scope.exchanges
    _, up, fused_s, fused_peak = timed_forward(fused, *band, SPATIAL_ITERS)
    fused_counts = launches()
    fused_exchanges = scope.exchanges - before
    np.save(os.path.join(workdir, f"fused{rank}.npy"), up.float().cpu().numpy())
    with band_pinned(halves=False):
        np.savez(os.path.join(workdir, f"prelude{rank}.npz"), **prelude_outputs(fused.model, *band, scope))
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"seconds": seconds, "peak_bytes": peak, "launches": counts, "exchanges": exchanges,
                   "pinned_seconds": pinned_s, "fused_seconds": fused_s, "fused_peak_bytes": fused_peak,
                   "fused_launches": fused_counts, "fused_exchanges": fused_exchanges}, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_spatial_forward(card: str) -> dict:
    """[spatial] (i): the unsharded controls in this process (as run and
    pinned; the fused model's prelude pinned), then the two ranks; each
    rank's flow_up band against the control's rows, s/image and peak
    memory per rank against the control's, the launches of each rank's
    timed forward, the fused prelude against the whole image's rows."""
    tag = "[spatial]"
    workdir = tempfile.mkdtemp(prefix="spatial-")
    runs = []
    try:
        rng = np.random.default_rng(SEED + 16)
        pair = stereo_pair(rng, *MIDDLEBURY_F)
        for k, img in zip((1, 2), pair):
            np.save(os.path.join(workdir, f"image{k}.npy"), img[None])
        model = mild_model(MIXED_UNFUSED_CONFIG)
        i1, i2 = (torch.from_numpy(img[None]).to(DEVICE) for img in pair)
        want_at = {iters: timed_forward(model, i1, i2, iters)[1].float().cpu().numpy()
                   for iters in SPATIAL_DRIFT_ITERS}
        reset_launches()
        _, want, control_s, control_peak = timed_forward(model, i1, i2, SPATIAL_ITERS)
        control_counts = launches()
        want = want.float().cpu().numpy()
        with band_pinned(halves=True):
            want_pinned = timed_forward(model, i1, i2, SPATIAL_ITERS)[1].float().cpu().numpy()
        del model
        fused = mild_model(MIXED_CONFIG)
        fused_at = {iters: timed_forward(fused, i1, i2, iters)[1].float().cpu().numpy()
                    for iters in SPATIAL_DRIFT_ITERS}
        _, fused_want, fused_control_s, fused_control_peak = timed_forward(fused, i1, i2, SPATIAL_ITERS)
        fused_at[SPATIAL_ITERS] = fused_want.float().cpu().numpy()
        with band_pinned(halves=True), fused_halves():
            prelude_want = prelude_outputs(fused, i1, i2)
        del fused, fused_want, i1, i2
        torch.cuda.empty_cache()
        if control_counts != expect(corr_lookup_bf16=SPATIAL_ITERS):
            raise AssertionError(f"{tag} control launches {control_counts}")
        port = free_port()
        runs = [CliRun(workdir, f"spatial-forward{r}", [workdir], launcher=SPATIAL_RANK,
                       env=gloo_rank_env(r, 2, port)) for r in range(2)]
        for run in runs:
            if run.wait(timeout=600) != 0:
                raise AssertionError(f"{tag} forward rank {run.tag}: exit {run.proc.returncode}\n{run.err()[-3000:]}")
        ranks, drift, pinned, drift_at = [], [], [], {}
        fused_drift, prelude_ulps = {}, {}
        rows = MIDDLEBURY_F[0] // 2
        for r in range(2):
            band, band_pin = (np.load(os.path.join(workdir, f"{name}{r}.npy")) for name in ("band", "pinned"))
            ranks.append(read_json(os.path.join(workdir, f"rank{r}.json")))
            for got in (band, band_pin):
                if got.shape != (1, rows, MIDDLEBURY_F[1], 1) or not np.isfinite(got).all():
                    raise AssertionError(f"{tag} rank {r}: band {got.shape}, finite {np.isfinite(got).all()}")
            mine = slice(r * rows, (r + 1) * rows)
            drift.append(float(np.abs(band - want[:, mine]).max()))
            for iters in SPATIAL_DRIFT_ITERS:
                got = np.load(os.path.join(workdir, f"band{r}-{iters}.npy"))
                drift_at.setdefault(iters, []).append(float(np.abs(got - want_at[iters][:, mine]).max()))
            pinned.append(float(np.abs(band_pin - want_pinned[:, mine]).max()))
            if ranks[r]["launches"] != expect(corr_lookup_bf16=SPATIAL_ITERS):
                raise AssertionError(f"{tag} rank {r} launches {ranks[r]['launches']}")
            want_fused = expect(corr_lookup_bf16=SPATIAL_ITERS, corr_pyramid_bf16=1, encoder_conv_bf16=2 * LAYER1_CONVS,
                                encoder_join_bf16=2 * LAYER1_JOINS)
            if ranks[r]["fused_launches"] != want_fused:
                raise AssertionError(f"{tag} rank {r} fused launches {ranks[r]['fused_launches']} != {want_fused}")
            for iters in (*SPATIAL_DRIFT_ITERS, SPATIAL_ITERS):
                got = np.load(os.path.join(workdir, f"fused{r}{'' if iters == SPATIAL_ITERS else f'-{iters}'}.npy"))
                if got.shape != (1, rows, MIDDLEBURY_F[1], 1) or not np.isfinite(got).all():
                    raise AssertionError(f"{tag} rank {r}: fused band {got.shape}, finite {np.isfinite(got).all()}")
                fused_drift.setdefault(iters, []).append(float(np.abs(got - fused_at[iters][:, mine]).max()))
            with np.load(os.path.join(workdir, f"prelude{r}.npz")) as got:
                for name, whole in prelude_want.items():
                    part = whole[:, :, r * got[name].shape[2]:(r + 1) * got[name].shape[2]]
                    ulps = float(np.abs(got[name] - part).max()) / bf16_ulps_of_max(whole)
                    prelude_ulps[name] = max(prelude_ulps.get(name, 0.0), ulps)
                    if got[name].shape != part.shape or not ulps <= SPATIAL_PRELUDE_ULPS:
                        raise AssertionError(f"{tag} rank {r} fused prelude {name}: {got[name].shape} against "
                                             f"{part.shape}, {ulps} bf16 ulps of max (tol {SPATIAL_PRELUDE_ULPS})")
        gib = 2.0 ** 30
        numbers = {"control_s": control_s, "control_peak_gib": control_peak / gib,
                   "rank_s": [x["seconds"] for x in ranks], "rank_peak_gib": [x["peak_bytes"] / gib for x in ranks],
                   "drift_px": drift, "drift_px_at": drift_at, "pinned_err_px": pinned,
                   "pinned_rank_s": [x["pinned_seconds"] for x in ranks],
                   "exchanges_per_forward": [x["exchanges"] for x in ranks],
                   "fused_control_s": fused_control_s, "fused_control_peak_gib": fused_control_peak / gib,
                   "fused_rank_s": [x["fused_seconds"] for x in ranks],
                   "fused_rank_peak_gib": [x["fused_peak_bytes"] / gib for x in ranks],
                   "fused_exchanges_per_forward": [x["fused_exchanges"] for x in ranks],
                   "fused_drift_px_at": fused_drift, "fused_prelude_ulps": prelude_ulps}
        log(f"{tag} (i) Middlebury-F {MIDDLEBURY_F[0]}x{MIDDLEBURY_F[1]}, mixed 'pallas', {SPATIAL_ITERS} iterations, "
            f"2 ranks on one card over gloo, (1, 2) mesh, {rows} rows each: flow_up bands against the unsharded "
            f"forward with the shape-dependent reductions pinned max |err| {pinned[0]:.3e}, {pinned[1]:.3e} px "
            f"(tol {E2E_TOL_PX:g}); as run (cuDNN's bf16 choices by shape, chaotic over {SPATIAL_ITERS} iterations) "
            f"{drift[0]:.3e}, {drift[1]:.3e} px, flows up to {np.abs(want).max():.2f} px ("
            + ", ".join(f"{max(e):.3e} px after {n} (flows up to {np.abs(want_at[n]).max():.2f})"
                        for n, e in drift_at.items())
            + f"); s/image per rank "
            f"{ranks[0]['seconds']:.4f}, {ranks[1]['seconds']:.4f} against the control's {control_s:.4f}; peak "
            f"allocated per rank {ranks[0]['peak_bytes'] / gib:.2f}, {ranks[1]['peak_bytes'] / gib:.2f} GiB "
            f"against {control_peak / gib:.2f}; launches per rank "
            f"{ {k: v for k, v in ranks[0]['launches'].items() if v} }, "
            f"{ {k: v for k, v in ranks[1]['launches'].items() if v} } (the control's "
            f"{ {k: v for k, v in control_counts.items() if v} }); {ranks[0]['exchanges']} exchanges a forward per "
            f"rank")
        log(f"{tag} (i) the fused model (mixed, bf16 pyramid kernel, fused_encoder) on the same bands: launches per "
            f"rank per forward {[{k: v for k, v in x['fused_launches'].items() if v} for x in ranks]}; prelude "
            f"against the whole image's, reductions pinned, in bf16 ulps of each tensor's largest magnitude "
            + ", ".join(f"{k} {v:.1f}" for k, v in prelude_ulps.items())
            + f" (tol {SPATIAL_PRELUDE_ULPS}); flow drift as run "
            + ", ".join(f"{max(e):.3e} px after {n} (flows up to {np.abs(fused_at[n]).max():.2f})"
                        for n, e in fused_drift.items())
            + f"; s/image per rank {ranks[0]['fused_seconds']:.4f}, {ranks[1]['fused_seconds']:.4f} against the "
            f"whole image's {fused_control_s:.4f} (unfused bands {ranks[0]['seconds']:.4f}); peak per rank "
            f"{ranks[0]['fused_peak_bytes'] / gib:.2f}, {ranks[1]['fused_peak_bytes'] / gib:.2f} GiB against "
            f"{fused_control_peak / gib:.2f}; exchanges a forward per rank {ranks[0]['fused_exchanges']} against the "
            f"unfused model's {ranks[0]['exchanges']}")
        if not max(pinned) <= E2E_TOL_PX:
            raise AssertionError(f"{tag} pinned bands differ from the unsharded forward by {max(pinned):.3e} px")
        log(f"{tag} (i) {card}: {json.dumps(numbers)}")
        return numbers
    finally:
        for run in runs:
            if run.proc.poll() is None:
                run.kill()
        shutil.rmtree(workdir, ignore_errors=True)


# -- the seventeenth slice: spatial serving across the cards of one process -----

# [spatial-serving]: the banded engine (serving/engine.py, a spatial preset
# over `devices`), the JAX bench's model (MIXED_CONFIG, `mild_model`'s
# weights) on the 512x768 bucket, two bands on the one card
# (devices=[cuda:0, cuda:0]: each band its worker thread, the halos and
# norm sums card to card through `spatial.ThreadComm`, no host copy),
# against the unsharded engine on the same weights. It answers requests at
# batch 1 and 2 through `run_batch` (the batcher's entry point) and
# through the service; each response is held against the unsharded
# engine's with the shape-dependent reductions pinned (`band_pinned`, and
# `fused_halves` in the unsharded one) to E2E_TOL_PX (expected 0.0, as
# [spatial] (i)'s unfused pair), and its drift as run is printed; the
# launches of one banded request (every kernel of the path, on both bands),
# the exchanges a request, s/request of both engines and the peak memory.
# A band that waits at the comm's barrier runs again only once the band
# that released it gives up the interpreter, at CPython's switch interval
# (5 ms by default) at the latest: one more pair of turns at batch 1 with
# the interval at SPATIAL_SWITCH_S shows how much of a request that
# handoff is (the package leaves the process's setting alone).
SPATIAL_SERVE_CHUNK = 8
SPATIAL_SWITCH_S = 1e-4
SPATIAL_SERVE_TIMED = 3


def spatial_serve_config(rules: str) -> ServeConfig:
    return ServeConfig(model=MIXED_CONFIG, buckets=(MIXED_BUCKET,), max_batch=2, chunk_iters=SPATIAL_SERVE_CHUNK,
                       max_iters=EVAL_ITERS, sharding_rules=rules)


def engine_flows(engine, i1, i2) -> np.ndarray:
    n = i1.shape[0]
    res = engine.run_batch(MIXED_BUCKET, i1, i2, [None] * n, [EVAL_ITERS] * n)
    if any(r.iters_completed != EVAL_ITERS for r in res):
        raise AssertionError(f"[spatial-serving] iterations {[r.iters_completed for r in res]}")
    return np.stack([r.flow_up for r in res])


def phase_spatial_serving(rng, card: str) -> dict:
    tag = "[spatial-serving]"
    model = mild_model(MIXED_CONFIG)
    plain = StereoService(spatial_serve_config("dp"), model=model, device=DEVICE).start()
    banded = StereoService(spatial_serve_config("spatial"), model=model, device=DEVICE,
                           devices=[torch.device(DEVICE, 0)] * 2).start()
    try:
        eng, ref = banded.engine, plain.engine
        if eng.sharding != "spatial over 2 device(s)" or banded.healthz()["serving"]["sharding"] != eng.sharding:
            raise AssertionError(f"{tag} sharding {eng.sharding!r}")
        log(f"{tag} booted: {json.dumps(banded.warm_summary)}")
        i1, i2 = card_pair(rng, *MIXED_BUCKET, b=2)
        # The main path's run: one banded request, every count set to 0 just before it.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        before = eng.band_exchanges
        engine_flows(eng, i1[:1], i2[:1])
        counts = launches()
        exchanges = eng.band_exchanges - before
        peak = torch.cuda.max_memory_allocated()
        want = expect(corr_lookup_bf16=2 * EVAL_ITERS, corr_pyramid_bf16=2, encoder_conv_bf16=2 * 2 * LAYER1_CONVS,
                      encoder_join_bf16=2 * 2 * LAYER1_JOINS)
        if counts != want:
            raise AssertionError(f"{tag} launches of one banded request {counts} != {want}")
        torch.cuda.reset_peak_memory_stats()
        engine_flows(ref, i1[:1], i2[:1])
        ref_peak = torch.cuda.max_memory_allocated()
        numbers = {"launches_per_request": {k: v for k, v in counts.items() if v}, "exchanges_per_request": exchanges,
                   "peak_gib": peak / 2**30, "unsharded_peak_gib": ref_peak / 2**30}
        for b in (1, 2):
            x1, x2 = i1[:b], i2[:b]
            got, base = engine_flows(eng, x1, x2), engine_flows(ref, x1, x2)
            with band_pinned(halves=False):
                got_pin = engine_flows(eng, x1, x2)
            with band_pinned(halves=True), fused_halves():
                base_pin = engine_flows(ref, x1, x2)
            if got.shape != (b, *MIXED_BUCKET, 1) or not np.isfinite(got).all():
                raise AssertionError(f"{tag} batch {b}: flows {got.shape}, finite {np.isfinite(got).all()}")
            pinned = float(np.abs(got_pin - base_pin).max())
            walls = {}
            for name, e in (("unsharded", ref), ("banded", eng), ("banded", eng), ("unsharded", ref)):
                t = time.perf_counter()
                for _ in range(SPATIAL_SERVE_TIMED):
                    engine_flows(e, x1, x2)
                walls.setdefault(name, []).append((time.perf_counter() - t) / (SPATIAL_SERVE_TIMED * b))
            numbers[f"b{b}"] = {"pinned_err_px": pinned, "drift_px": float(np.abs(got - base).max()),
                                "flow_max_px": float(np.abs(base).max()), "s_per_request": walls}
            log(f"{tag} batch {b}, {EVAL_ITERS} iterations: banded against unsharded with the reductions pinned max "
                f"|err| {pinned:.3e} px (tol {E2E_TOL_PX:g}); as run {numbers[f'b{b}']['drift_px']:.3e} px (flows up "
                f"to {numbers[f'b{b}']['flow_max_px']:.2f}); s/request in turns (unsharded, banded, banded, "
                f"unsharded) {walls['unsharded'][0]:.4f}, {walls['banded'][0]:.4f}, {walls['banded'][1]:.4f}, "
                f"{walls['unsharded'][1]:.4f}")
            if not pinned <= E2E_TOL_PX:
                raise AssertionError(f"{tag} batch {b}: pinned banded responses {pinned} px from the unsharded ones")
        default = sys.getswitchinterval()
        sys.setswitchinterval(SPATIAL_SWITCH_S)
        try:
            quick = []
            for _ in range(2):
                t = time.perf_counter()
                for _ in range(SPATIAL_SERVE_TIMED):
                    engine_flows(eng, i1[:1], i2[:1])
                quick.append((time.perf_counter() - t) / SPATIAL_SERVE_TIMED)
        finally:
            sys.setswitchinterval(default)
        numbers["b1"]["s_per_request_switch"] = quick
        log(f"{tag} batch 1 with the interpreter's switch interval at {SPATIAL_SWITCH_S * 1e3:g} ms (default "
            f"{default * 1e3:g}): banded s/request {quick[0]:.4f}, {quick[1]:.4f}")
        # Through the service: two requests batched, then one alone.
        img = [(i1[k].cpu().numpy(), i2[k].cpu().numpy()) for k in range(2)]
        futures = [banded.submit(*img[k]) for k in range(2)]
        outs = [f.result(timeout=FRONT_WAIT_S) for f in futures] + [banded.submit(*img[0]).result(timeout=FRONT_WAIT_S)]
        for out in outs:
            if out["disparity"].shape != MIXED_BUCKET or not np.isfinite(out["disparity"]).all():
                raise AssertionError(f"{tag} service response {out['disparity'].shape}")
        health = banded.healthz()["serving"]
        log(f"{tag} the service answered {len(outs)} requests ({banded.batcher.metrics.snapshot()['batches_total']} "
            f"batches), state {health['state']}, sharding {health['sharding']!r}")
        log(card)
        log(f"{tag} {MIXED_BUCKET[0]}x{MIXED_BUCKET[1]}, 2 bands on one card: launches per request "
            f"{numbers['launches_per_request']} (both bands), {exchanges} exchanges a request over both bands "
            f"({exchanges // 2} per band), peak "
            f"{peak / 2**30:.2f} GiB against the unsharded engine's {ref_peak / 2**30:.2f}; {json.dumps(numbers)}")
        return numbers
    finally:
        banded.close()
        plain.close()


def rank_peak_gib(run: CliRun) -> float:
    found = re.search(r"peak device memory: (\d+) bytes allocated", run.err())
    if found is None:
        run.fail("no peak memory line")
    return int(found.group(1)) / 2.0 ** 30


def fsdp_train_rank(argv) -> int:
    """`train` (cli.main(argv)) in a rank that logs, after its fit, its
    local shapes of FSDP_SHAPE_PARAMS and of their AdamW moments as
    "local shapes: {name: [param, mu, nu]}"."""
    from raft_stereo_tpu_torch.parallel.sharding import local_tensor
    from raft_stereo_tpu_torch.train import trainer as tr

    fit = tr.Trainer.fit

    def logged_fit(self, *args, **kwargs):
        out = fit(self, *args, **kwargs)
        named = dict(self.model.named_parameters())
        shapes = {n: [list(local_tensor(t).shape) for t in (named[n], *(self.optimizer.state[named[n]][k]
                                                                       for k in ("mu", "nu")))]
                  for n in FSDP_SHAPE_PARAMS}
        print(f"local shapes: {json.dumps(shapes)}", file=sys.stderr, flush=True)
        return out

    tr.Trainer.fit = logged_fit
    return cli.main(argv)


def fsdp_shape_check(run: CliRun) -> dict:
    """(iv): the rank's local shapes: C_out / FSDP_SHAPE_PARAMS[name] rows
    of the parameter and of both moments, the other dims whole."""
    found = re.findall(r"local shapes: (\{.*\})", run.err())
    if not found:
        run.fail("no local shapes logged")
    shapes = json.loads(found[-1])
    with torch.device("meta"):
        named = dict(RAFTStereo(MIXED_TRAIN_CONFIG).named_parameters())
    for name, split in FSDP_SHAPE_PARAMS.items():
        full = list(named[name].shape)
        if shapes[name] != [[full[0] // split, *full[1:]]] * 3:
            run.fail(f"{name}: local shapes {shapes[name]}, whole {full}, expected C_out / {split}")
    return shapes


def phase_spatial_train(card: str, workdir: str, control_steps: dict, start) -> dict:
    """[spatial] (ii)-(iv) on [train-cli]'s tree against its control run:
    each rank exit 0 with a completed report, the last step committed,
    losses within SPATIAL_TRAIN_RTOL of the control's, the lookup and the
    scatter on every step of every rank (and validation's lookups on bands);
    under fsdp each rank's local shapes; s/step and peak memory per rank."""
    tag = "[spatial]"
    numbers = {}
    for label, mesh, preset, steps, extra, launcher in SPATIAL_TRAIN_RUNS:
        world = mesh[0] * mesh[1]
        port = free_port()
        name = f"spatial-{preset.replace('+', '-')}-{mesh[0]}x{mesh[1]}"
        ranks = [start(f"{name}-rank{r}", ["train", "--name", name, *TRAIN_CLI_FLAGS, "--sharding_rules", preset,
                                            "--mesh_shape", *map(str, mesh), "--num_steps", str(steps), *extra],
                       launcher=launcher, env=gloo_rank_env(r, world, port)) for r in range(world)]
        codes = [parallel_wait(run) for run in ranks]
        if codes != [0] * world:
            ranks[0].fail(f"exit codes {codes}; " + "; ".join(run.err()[-1500:] for run in ranks[1:]))
        reports = [parallel_report(run, workdir, rank_file("run_report.json", r)) for r, run in enumerate(ranks)]
        if any(r["stop_cause"] != "completed" or r["final_step"] != steps or r["process_count"] != world
               for r in reports):
            ranks[0].fail(f"reports {reports}")
        step_dir = check_committed(workdir, name, steps, f"spatial {label}")
        verdict = fsck_root(os.path.dirname(step_dir))
        if verdict["invalid_steps"] or verdict["latest_valid"] != steps:
            ranks[0].fail(f"fsck: {verdict}")
        # A run that sets its own validation cadence validates at its last step.
        validate_at = steps if "--validate_every" in extra else TRAIN_CLI_STEPS
        checks = [parallel_check(run, control_steps, 1, steps, SPATIAL_TRAIN_RTOL, validate_at) for run in ranks]
        nums = train_numbers(ranks[0], workdir, f"{preset} {mesh[0]}x{mesh[1]}, {world} ranks on one card",
                             phase="spatial")
        nums["rank_peak_gib"] = [rank_peak_gib(run) for run in ranks]
        nums["loss_gap"] = max(c[0] for c in checks)
        nums["launches_per_rank"] = [c[1] for c in checks]
        shapes = ""
        if preset == "fsdp":
            nums["local_shapes"] = [fsdp_shape_check(run) for run in ranks]
            shapes = f"; local shapes (parameter, mu, nu) on every rank {json.dumps(nums['local_shapes'][0])}"
        numbers[f"{label} {preset}"] = nums
        log(f"{tag} {label} `train --sharding_rules {preset} --mesh_shape {mesh[0]} {mesh[1]}`, {world} ranks on one "
            f"card over gloo, {steps} steps: every rank exit {codes}, completed reports, step {steps} committed and "
            f"fsck-valid; largest relative loss gap to the control {nums['loss_gap']:.3e} (tol "
            f"{SPATIAL_TRAIN_RTOL:g}), per step {gap_text(ranks[0], control_steps)}; s/step "
            f"{nums['s_per_step_median']} (rank 0); peak allocated per rank "
            f"{', '.join(f'{g:.2f}' for g in nums['rank_peak_gib'])} GiB; launches per rank "
            f"{nums['launches_per_rank']}{shapes}")
    log(f"{tag} (ii)-(iv) {card}: {json.dumps(numbers)}")
    return numbers


def ck_steps(workdir: str, name: str) -> list:
    from raft_stereo_tpu_torch.utils import checkpoints as ck

    return ck.list_checkpoint_steps(os.path.join(workdir, "checkpoints", name))


# -- the fourteenth slice: the model options, the fleet, the front tier ---------

# [model-options]. "alt" has no kernel of its own (the JAX package's is plain
# XLA): its lookup runs in plain ops beside the fused GRU tail, against
# "reg" and "pallas" with the same flags and weights.
ALT_CONFIG = RAFTStereoConfig(corr_implementation="alt", fused_gru_tail=True)
REG_TAIL_CONFIG = RAFTStereoConfig(corr_implementation="reg", fused_gru_tail=True)
ALT_MIXED_CONFIG = dataclasses.replace(MIXED_CONFIG, corr_implementation="alt")
# The JAX bench's model (bench.py): the mixed configuration with the
# sequential encoder.
BENCH_CONFIG = dataclasses.replace(MIXED_CONFIG, sequential_encoder=True)
OPTIONS_BUCKET = (512, 768)
MIDDLEBURY_F = (1984, 2880)
# alt against reg taps: the same sums over D in another order (an
# elementwise multiply and a sum against an fp32 matmul, TF32 off), to this
# share of the largest |tap|.
ALT_TAPS_REL_TOL = 1e-5
# Conv and join launches of the fused encoder's layer 1 per encoder call
# (the stem norm and two residual blocks: four convs, two joins).
LAYER1_CONVS, LAYER1_JOINS = 4, 2


def timed_forward(model, i1, i2, iters) -> tuple:
    """One test-mode forward on the card: (flow_lowres, flow_up, seconds,
    peak bytes allocated during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.inference_mode():
        lo, up = model(i1, i2, iters=iters, test_mode=True)
    torch.cuda.synchronize()
    return lo, up, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def card_pair(rng, h, w, b=1):
    pairs = [stereo_pair(rng, h, w) for _ in range(b)]
    return tuple(torch.from_numpy(np.stack([p[k] for p in pairs])).to(DEVICE) for k in (0, 1))


def phase_model_options(rng, card: str) -> None:
    tag = "[model-options]"
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    h, w = OPTIONS_BUCKET[0] // 4, OPTIONS_BUCKET[1] // 4
    f1, f2 = (torch.randn((1, h, w, 256), generator=gen, device=DEVICE) for _ in range(2))
    x = torch.arange(w, device=DEVICE, dtype=torch.float32) - 48.0 * torch.rand((1, h, w), generator=gen,
                                                                                 device=DEVICE)
    reg = corr.corr_lookup(corr.corr_pyramid(corr.corr_volume(f1, f2), 4), x, 4)
    levels = corr.pool_fmap_levels(f2, 4)
    alt = corr.corr_lookup_alt(f1, levels, x, 4)
    rel = float((alt - reg).abs().max() / reg.abs().max())
    alt_ms = time_ms(lambda: corr.corr_lookup_alt(f1, levels, x, 4), reps=10)
    log(f"{tag} alt taps at the {OPTIONS_BUCKET[0]}x{OPTIONS_BUCKET[1]} bucket (1 x {h} x {w} x 256, 4 levels, "
        f"radius 4, fp32, TF32 off) against the reg taps: max |diff| / max |tap| {rel:.3e} (tol {ALT_TAPS_REL_TOL:g}); "
        f"the alt lookup {alt_ms:.4f} ms an iteration")
    if not rel <= ALT_TAPS_REL_TOL:
        raise AssertionError(f"{tag} alt taps are {rel} of max |tap| from reg")
    del f1, f2, x, reg, levels, alt

    # Four iterations on the same (mild) weights: alt against reg.
    i1, i2 = card_pair(rng, *OPTIONS_BUCKET)
    models = {name: mild_model(cfg) for name, cfg in (("alt", ALT_CONFIG), ("reg", REG_TAIL_CONFIG),
                                                      ("pallas", KERNEL_CONFIG))}
    reset_launches()
    _, up_alt, _, _ = timed_forward(models["alt"], i1, i2, E2E_ITERS)
    counts = launches()
    _, up_reg, _, _ = timed_forward(models["reg"], i1, i2, E2E_ITERS)
    err = float((up_alt - up_reg).abs().max())
    log(f"{tag} {E2E_ITERS} iterations at {OPTIONS_BUCKET[0]}x{OPTIONS_BUCKET[1]}, alt against reg: flow_up max "
        f"|diff| {err:.3e} px (tol {E2E_TOL_PX:g} px), |flow_up| max {up_reg.abs().max().item():.3f}; alt launches "
        f"{counts}")
    if counts != expect(gru_tail=3 * E2E_ITERS, motion_tail=E2E_ITERS):
        raise AssertionError(f"{tag} alt launches {counts}")
    if not (torch.isfinite(up_alt).all() and err <= E2E_TOL_PX):
        raise AssertionError(f"{tag} alt is {err} px from reg after {E2E_ITERS} iterations")

    # 32 iterations, fp32, batch 1: seconds and peak memory per strategy.
    rows = []
    for name in ("alt", "reg", "pallas", "pallas", "reg", "alt"):
        _, up, seconds, peak = timed_forward(models[name], i1, i2, EVAL_ITERS)
        rows.append((name, seconds, peak))
    del models, up, up_alt, up_reg
    torch.cuda.empty_cache()
    log(card)
    log(f"{tag} {OPTIONS_BUCKET[0]}x{OPTIONS_BUCKET[1]}, fp32, {EVAL_ITERS} iterations, batch 1, in turns: "
        + "; ".join(f"{n} {s:.4f} s, peak {p / 2**30:.3f} GiB" for n, s, p in rows))

    # Mixed Middlebury-F through the Evaluator: alt against pallas.
    item = SyntheticEvalDataset(n=1, shape=EVAL_SHAPE).get_item(0, None)
    per = {}
    for name, cfg in (("pallas", MIXED_CONFIG), ("alt", ALT_MIXED_CONFIG)):
        evaluator = Evaluator(mild_model(cfg), iters=EVAL_ITERS)
        evaluator(item["image1"], item["image2"])  # first use of the shapes
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        flow, seconds = evaluator(item["image1"], item["image2"])
        per[name] = (flow, seconds, torch.cuda.max_memory_allocated(), launches())
        del evaluator
        torch.cuda.empty_cache()
    gap = np.abs(per["alt"][0] - per["pallas"][0])
    log(f"{tag} mixed, {EVAL_SHAPE[0]}x{EVAL_SHAPE[1]} padded to {MIDDLEBURY_F[0]}x{MIDDLEBURY_F[1]}, {EVAL_ITERS} "
        f"iterations, batch 1, through the Evaluator: "
        + "; ".join(f"{n} {s:.4f} s, peak {p / 2**30:.3f} GiB ({p} B), launches {c}"
                    for n, (_, s, p, c) in per.items())
        + f"; flow alt against pallas: mean |diff| {gap.mean():.4f} px, max {gap.max():.4f} px")
    want = {"pallas": expect(corr_lookup_bf16=EVAL_ITERS, corr_pyramid_bf16=1, encoder_conv_bf16=2 * LAYER1_CONVS,
                             encoder_join_bf16=2 * LAYER1_JOINS),
            "alt": expect(encoder_conv_bf16=2 * LAYER1_CONVS, encoder_join_bf16=2 * LAYER1_JOINS)}
    for name, (flow, _, _, c) in per.items():
        if c != want[name] or flow.shape != EVAL_SHAPE or not np.isfinite(flow).all():
            raise AssertionError(f"{tag} mixed {name}: launches {c} != {want[name]}, or flow {flow.shape} not finite")
    del per, item
    torch.cuda.empty_cache()
    phase_sequential(rng, card)


def bench_launches(b: int, sequential: bool) -> dict:
    """One bench-model forward's launches: the layer-1 kernels once per
    encoder call (the context encoder's over the batch; the feature
    encoder's over the pair, or per image when sequential)."""
    fnet_calls = 2 * b if sequential else 1
    return expect(corr_lookup_bf16=EVAL_ITERS, corr_pyramid_bf16=1,
                  encoder_conv_bf16=(1 + fnet_calls) * LAYER1_CONVS,
                  encoder_join_bf16=(1 + fnet_calls) * LAYER1_JOINS)


def phase_sequential(rng, card: str) -> None:
    """The JAX bench's model at Middlebury-F: sequential_encoder on and off
    at batch 1 and 2 (seconds, peak memory, launches), the flows on
    against off with the batch-dependent reductions pinned in the encoders
    (held to the serving bound) and without (printed), and
    sequential_batch_forward at batch 2 against batch-1 forwards."""
    tag = "[model-options]"
    on, off = mild_model(BENCH_CONFIG), mild_model(MIXED_CONFIG)
    i1, i2 = card_pair(rng, *MIDDLEBURY_F, b=2)
    runs = {}
    for b in (1, 2):
        for name, model in (("on", on), ("off", off)):
            timed_forward(model, i1[:b], i2[:b], 1)  # first use of the shapes
            reset_launches()
            lo, up, seconds, peak = timed_forward(model, i1[:b], i2[:b], EVAL_ITERS)
            runs[(name, b)] = (up, seconds, peak, launches())
            if runs[(name, b)][3] != bench_launches(b, name == "on"):
                raise AssertionError(f"{tag} sequential_encoder {name} at batch {b}: launches "
                                     f"{runs[(name, b)][3]} != {bench_launches(b, name == 'on')}")
            torch.cuda.empty_cache()
    free = {b: float((runs[("on", b)][0] - runs[("off", b)][0]).abs().max()) for b in (1, 2)}
    log(card)
    log(f"{tag} the bench model (mixed, bf16 pyramid, fused encoder, pallas) at {MIDDLEBURY_F[0]}x{MIDDLEBURY_F[1]}, "
        f"{EVAL_ITERS} iterations: "
        + "; ".join(f"sequential_encoder {n} batch {b}: {s:.4f} s ({s / b:.4f} s/image), peak {p / 2**30:.3f} GiB "
                    f"({p} B), launches conv {c['encoder_conv_bf16']} join {c['encoder_join_bf16']}"
                    for (n, b), (_, s, p, c) in runs.items())
        + f"; flow_up on against off, cuDNN as chosen: batch 1 {free[1]:.3e} px, batch 2 {free[2]:.3e} px")

    # With cuDNN off and the instance norm per image in the encoders (the
    # reductions whose order depends on the batch), on and off compute the
    # same per-image encoder, and the iterations run the same batch.
    encode = RAFTStereo.encode_features

    def pinned_encode(self, *args, **kwargs):
        with batch_invariant():
            return encode(self, *args, **kwargs)

    with swapped(RAFTStereo, encode_features=pinned_encode):
        t = time.perf_counter()
        pinned = [float((timed_forward(on, i1[:1], i2[:1], EVAL_ITERS)[1]
                         - timed_forward(off, i1[:1], i2[:1], EVAL_ITERS)[1]).abs().max())]
        pinned_s = time.perf_counter() - t
    log(f"{tag} flow_up on against off at batch 1 with the encoders' batch-dependent reductions pinned: "
        f"{pinned[0]:.3e} px (tol {E2E_TOL_PX:g} px; {pinned_s:.1f} s)")
    if not pinned[0] <= E2E_TOL_PX:
        raise AssertionError(f"{tag} sequential_encoder moves the flow {pinned[0]} px with the reductions pinned")
    if not all(torch.isfinite(r[0]).all() for r in runs.values()):
        raise AssertionError(f"{tag} non-finite flows")

    # sequential_batch_forward at batch 2: each map its batch-1 forward.
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, ups = sequential_batch_forward(on, i1, i2, iters=EVAL_ITERS)
    torch.cuda.synchronize()
    seq_s, seq_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated()
    one = [timed_forward(on, i1[k:k + 1], i2[k:k + 1], EVAL_ITERS) for k in range(2)]
    equal = [bool(torch.equal(ups[k:k + 1], one[k][1])) for k in range(2)]
    log(f"{tag} sequential_batch_forward, batch 2: {seq_s:.4f} s ({seq_s / 2:.4f} s/map), peak "
        f"{seq_peak / 2**30:.3f} GiB ({seq_peak} B); batch 1: {one[0][2]:.4f} s, peak {one[0][3] / 2**30:.3f} GiB; "
        f"each map bit for bit its batch-1 forward: {equal}")
    if not all(equal):
        raise AssertionError(f"{tag} sequential_batch_forward differs from the batch-1 forwards: {equal}")
    del on, off, runs, ups, one
    torch.cuda.empty_cache()


# [fleet]: two replicas on one card, the mixed configuration with the fused
# encoder at the 512x768 bucket, batches up to 4; a 3 s watchdog, the
# injected hang sleeps 8 s on the host.
FLEET_BUCKET = (512, 768)
FLEET_HANG_TIMEOUT_S = 3.0
FLEET_HANG_S = 8.0
FLEET_CLIENTS = 6
FLEET_BURST = 24
FLEET_WAIT_S = 300


def fleet_config(replicas: int) -> ServeConfig:
    return ServeConfig(model=MIXED_CONFIG, buckets=(FLEET_BUCKET,), max_batch=4, replicas=replicas,
                       auto_respawn=replicas > 1, hang_timeout_s=FLEET_HANG_TIMEOUT_S, breaker_degrade_after=1,
                       breaker_fail_after=3, breaker_probation=2, drain_timeout_s=120.0)


def mixed_batch_launches(batches) -> dict:
    """Launches of the mixed configuration over `batches` (their results):
    the prelude's kernels once a batch, the lookup once an iteration."""
    n = len(batches)
    return expect(corr_pyramid_bf16=n, encoder_conv_bf16=2 * LAYER1_CONVS * n, encoder_join_bf16=2 * LAYER1_JOINS * n,
                  corr_lookup_bf16=sum(max(r.iters_completed for r in res) for res in batches))


def fleet_burst(service, jobs) -> tuple:
    """`jobs` submitted in process from FLEET_CLIENTS threads: (answers,
    seconds, client latencies in ms)."""
    answers, lat, errors = [None] * len(jobs), [None] * len(jobs), []

    def client(k):
        try:
            for i in range(k, len(jobs), FLEET_CLIENTS):
                t = time.perf_counter()
                answers[i] = service.submit(*jobs[i]).result(timeout=FLEET_WAIT_S)
                lat[i] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
            errors.append(repr(exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_WAIT_S)
    if errors or any(a is None for a in answers):
        raise AssertionError(f"[fleet] clients failed: {errors}")
    return answers, time.perf_counter() - t0, lat


def replay_equal(single, batches) -> bool:
    """Every recorded batch replayed through one single engine equals what
    the fleet answered, bit for bit."""
    for bucket, i1, i2, res in batches:
        again = single.run_batch(tuple(bucket), torch.from_numpy(i1).to(DEVICE), torch.from_numpy(i2).to(DEVICE),
                                 deadlines_s=[None] * len(res), max_iters=[r.iters_completed for r in res])
        if not all(np.array_equal(x.flow_up, y.flow_up) for x, y in zip(res, again)):
            return False
    return True


def percentiles(vals) -> str:
    v = np.asarray(vals, np.float64)
    return f"p50 {np.percentile(v, 50):.3f} ms, p99 {np.percentile(v, 99):.3f} ms"


def phase_fleet(rng, card: str) -> None:
    from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
    from raft_stereo_tpu_torch.serving.lifecycle import CheckpointMismatchError

    tag = "[fleet]"
    bh, bw = FLEET_BUCKET
    sizes = [(bh, bw), (bh * 15 // 16, bw * 15 // 16), (bh * 3 // 4, bw * 5 // 6), (bh * 125 // 128, bw * 175 // 192)]
    jobs = [int_pair(rng, *sizes[i % len(sizes)]) for i in range(FLEET_BURST)]
    numbers = {}
    # One replica: the single engine, the same burst.
    single_service = StereoService(fleet_config(1), mild_model(MIXED_CONFIG), device=DEVICE).start()
    try:
        _, seconds, lat = fleet_burst(single_service, jobs)
        numbers[1] = (seconds, lat, [real for _, real, _ in single_service.batcher.metrics.batch_log])
    finally:
        drain_service(single_service, tag)
    t0 = time.perf_counter()
    service = StereoService(fleet_config(2), mild_model(MIXED_CONFIG), devices=["cuda:0", "cuda:0"]).start()
    fleet = service.engine
    log(f"{tag} two replicas on {[str(r.device) for r in fleet.replicas]}: boot + warm "
        f"{time.perf_counter() - t0:.2f} s ({service.warm_summary['combos']} combos each)")
    single = AnytimeEngine(fleet_config(1), mild_model(MIXED_CONFIG), device=DEVICE)
    recorder = StagedRecorder(fleet)
    try:
        # A burst from several clients: each batch bit for bit the single
        # engine's, the kernels once per batch.
        reset_launches()
        answers, seconds, lat = fleet_burst(service, jobs)
        numbers[2] = (seconds, lat, [real for _, real, _ in service.batcher.metrics.batch_log])
        wait_idle(service)
        counts = launches()
        batches = [res for _, _, _, res in recorder.batches]
        by_replica = dict(service.metrics()["batches_by_replica"])
        if counts != mixed_batch_launches(batches):
            raise AssertionError(f"{tag} launches {counts} != once per batch {mixed_batch_launches(batches)}")
        if not replay_equal(single, recorder.batches):
            raise AssertionError(f"{tag} a batch differs from the single engine's replay")
        for (a, _), ans in zip(jobs, answers):
            if ans["disparity"].shape != a.shape[:2] or not np.isfinite(ans["disparity"]).all():
                raise AssertionError(f"{tag} a response has shape {ans['disparity'].shape} or non-finite values")
        log(f"{tag} burst of {len(jobs)} requests from {FLEET_CLIENTS} clients in {len(batches)} batches "
            f"(sizes {[len(r) for r in batches]}), batches by replica {by_replica}: every batch equals the single "
            f"engine's replay bit for bit; launches once per batch {counts}")
        if len(by_replica) != 2:
            raise AssertionError(f"{tag} the burst did not use both replicas: {by_replica}")
        log(card)
        for n, (s, lt, sizes_run) in sorted(numbers.items()):
            log(f"{tag} {n} replica(s) on one card: {len(jobs)} requests in {s:.3f} s, {len(jobs) / s:.3f} "
                f"requests/s, client latency {percentiles(lt)}, {len(sizes_run)} batches of {sizes_run}")

        one_job = int_pair(rng, *FLEET_BUCKET)

        def one_request():
            _quiesce(fleet)
            before = len(recorder.batches)
            reset_launches()
            out = service.submit(*one_job).result(timeout=FLEET_WAIT_S)
            wait_idle(service)
            return out, recorder.batches[before:], launches()

        # An injected raise on replica 0 after its batch ran: requeued once
        # onto replica 1, nothing shed, the fleet degraded.
        eng0 = fleet.replicas[0].engine
        real_run = eng0.run_batch
        raised = []

        def raise_after(*args, **kwargs):
            out = real_run(*args, **kwargs)
            if not raised:
                raised.append(True)
                raise RuntimeError("injected fault after the batch ran on replica 0")
            return out

        eng0.run_batch = raise_after
        before = service.metrics()
        try:
            out, recs, counts = one_request()
        finally:
            del eng0.run_batch
        snap = service.metrics()
        states = [r.lifecycle.state for r in fleet.replicas]
        log(f"{tag} injected raise on replica 0: requeues +{snap['requeues_total'] - before['requeues_total']}, shed "
            f"+{snap['shed_total'] - before['shed_total']}, failed +{snap['failed_requests_total'] - before['failed_requests_total']}; "
            f"replicas {states}, fleet {service.lifecycle.state}; launches {counts} (the batch twice)")
        if (snap["requeues_total"] - before["requeues_total"] != 1 or snap["shed_total"] != before["shed_total"]
                or snap["failed_requests_total"] != before["failed_requests_total"]
                or states != ["degraded", "healthy"] or service.lifecycle.state != "degraded"):
            raise AssertionError(f"{tag} the raise was not failed over once")
        if counts != mixed_batch_launches([r for *_, r in recs] * 2) or not replay_equal(single, recs):
            raise AssertionError(f"{tag} the requeued batch: launches {counts} or its answer differs")

        # A host-side hang past the watchdog on replica 0: abandoned and
        # requeued; the sticky failure starts the auto-respawn.
        model0 = eng0.model
        real_step = model0.iteration_step
        slept = []

        def sleepy(state):
            if not slept:
                slept.append(True)
                time.sleep(FLEET_HANG_S)
            return real_step(state)

        model0.iteration_step = sleepy
        before = service.metrics()
        t = time.perf_counter()
        try:
            out, recs, _ = one_request()
            answered_s = time.perf_counter() - t
        finally:
            del model0.iteration_step
        snap = service.metrics()
        if (snap["requeues_total"] - before["requeues_total"] != 1 or snap["shed_total"] != before["shed_total"]
                or not replay_equal(single, recs[-1:])):
            raise AssertionError(f"{tag} the hung batch was not abandoned and requeued")
        deadline = time.monotonic() + FLEET_WAIT_S
        while fleet.respawns_total < 1:
            if time.monotonic() > deadline:
                raise AssertionError(f"{tag} no respawn after the sticky failure")
            time.sleep(0.05)
        summary = dict(fleet.last_respawn)
        if not eng0._lock.acquire(timeout=FLEET_WAIT_S):
            raise AssertionError(f"{tag} the wedged call never ended")
        eng0._lock.release()
        del eng0, model0, real_run, real_step
        gc.collect()
        settled = torch.cuda.memory_allocated()
        states_after_respawn = [r.lifecycle.state for r in fleet.replicas]
        for _ in range(6):
            one_request()
            if [r.lifecycle.state for r in fleet.replicas] == ["healthy", "healthy"]:
                break
        states = [r.lifecycle.state for r in fleet.replicas]
        log(f"{tag} host-side hang of {FLEET_HANG_S:g} s on replica 0 (watchdog {FLEET_HANG_TIMEOUT_S:g} s): answered "
            f"by replica 1 in {answered_s:.2f} s, requeues +1; auto-respawn of replica 0 in "
            f"{summary['warm_seconds']:.2f} s, allocated {summary['memory_allocated_before']} B before, "
            f"{summary['memory_allocated_after']} B after (the wedged call still running), {settled} B after it "
            f"ended; replicas {states_after_respawn} -> {states} with traffic")
        if states != ["healthy", "healthy"] or service.lifecycle.state != "healthy":
            raise AssertionError(f"{tag} the respawned replica did not heal: {states}")

        # A rolling swap under traffic to a second .pth; then a mid-roll
        # refusal rolls back.
        with tempfile.TemporaryDirectory() as tmp:
            new_pth = os.path.join(tmp, "new.pth")
            torch.save(export_reference_state_dict(build_model(MIXED_CONFIG, seed=SEED + 1, device="cpu")), new_pth)
            before = service.metrics()
            results, errors = [], []

            def roll_client():
                for _ in range(3):
                    try:
                        results.append(service.submit(*one_job).result(timeout=FLEET_WAIT_S))
                    except Exception as exc:  # noqa: BLE001 - reported below
                        errors.append(repr(exc))

            clients = [threading.Thread(target=roll_client) for _ in range(4)]
            for c in clients:
                c.start()
            t = time.perf_counter()
            reload = service.reload_checkpoint(new_pth)
            roll_s = time.perf_counter() - t
            for c in clients:
                c.join(timeout=FLEET_WAIT_S)
            snap = service.metrics()
            if errors or len(results) != 12 or snap["shed_total"] != before["shed_total"] or \
                    reload["swap_generation"] != 1:
                raise AssertionError(f"{tag} the rolling swap dropped requests: {errors}, {reload}")
            fresh = load_reference_checkpoint(build_model(MIXED_CONFIG, seed=SEED + 2, device="cpu"), new_pth)
            single_new = AnytimeEngine(fleet_config(1), fresh.to(DEVICE), device=DEVICE)
            out, recs, _ = one_request()
            same = replay_equal(single_new, recs)
            real_swap = fleet.replicas[1].engine.swap_variables

            def refuse(state):
                raise CheckpointMismatchError("injected mid-roll refusal on replica 1")

            fleet.replicas[1].engine.swap_variables = refuse
            try:
                service.reload_checkpoint(new_pth)
                raise AssertionError(f"{tag} the mid-roll refusal did not raise")
            except CheckpointMismatchError:
                pass
            finally:
                fleet.replicas[1].engine.swap_variables = real_swap
            sd = [r.engine.model.state_dict() for r in fleet.replicas]
            rolled_back = all(torch.equal(sd[0][k], sd[1][k]) for k in sd[0])
            out2, recs2, _ = one_request()
            log(f"{tag} rolling swap to a second .pth under traffic from 4 clients: {roll_s:.2f} s, 12 answered, "
                f"shed +0, generation {reload['swap_generation']}; a fresh single engine on the new weights answers "
                f"bit for bit {same}; a mid-roll refusal on replica 1 rolled replica 0 back ({rolled_back}), "
                f"generation {fleet.swap_generation}")
            if not (same and rolled_back and fleet.swap_generation == 1 and replay_equal(single_new, recs2)):
                raise AssertionError(f"{tag} the rolling swap or its rollback")
            del single_new, fresh
    finally:
        recorder.close()
        del single
        drained = service.drain(timeout_s=120)
    alive = [t.name for t in service.batcher._runners if t.is_alive()]
    log(f"{tag} drain: backlog drained {drained}, runner threads alive {alive}")
    if not drained or alive:
        raise AssertionError(f"{tag} drain: {drained}, {alive}")
    torch.cuda.empty_cache()


def _quiesce(fleet, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while any(r.in_flight for r in fleet.replicas):
        if time.monotonic() > deadline:
            raise AssertionError("[fleet] the fleet never went idle")
        time.sleep(0.005)


# [frontier]: two `serve` processes on the card (the mixed configuration,
# one bucket, batches of one so every answer is a batch-1 forward) and one
# `frontier` process, all as a user starts them (no --device).
FRONTIER_BUCKET = (192, 256)
FRONTIER_SERVE_FLAGS = ("--buckets", f"{FRONTIER_BUCKET[0]}x{FRONTIER_BUCKET[1]}", "--max_batch", "1", "--stream",
                        *SERVE_CLI_CONFIGS[1][1])
FRONTIER_CLIENTS = 4
FRONTIER_REQUESTS = 8
FRONTIER_BOOT_S = 300


class ServeProcess(CliRun):
    """A `serve` or `frontier` process (CliRun: its own process group, its
    output in files)."""

    def wait_healthy(self, url: str, timeout_s: float = FRONTIER_BOOT_S) -> float:
        """Seconds from the process's start until its /healthz says healthy."""
        while time.time() - self.t0 < timeout_s and self.proc.poll() is None:
            try:
                resp = request_json(f"{url}/healthz", timeout_s=10)
                body = resp.json() if resp.ok else {}
                if (body.get("serving") or body.get("frontier") or {}).get("state") == "healthy":
                    return time.time() - self.t0
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"[frontier] {self.tag} not healthy (exit {self.proc.poll()}): {self.err()[-2000:]}")

    def stop(self) -> int:
        """SIGTERM, then the exit code (SIGKILL after 120 s)."""
        self.signal_group(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.kill()
            return -9


def frontier_post(url, a, b, path="/predict", **extra) -> tuple:
    t = time.perf_counter()
    resp = request_json(f"{url}{path}", method="POST", timeout_s=FRONT_WAIT_S,
                        payload={"image1": json_image(a), "image2": json_image(b), **extra})
    return resp.status, resp.json(), (time.perf_counter() - t) * 1e3


def frontier_burst(url, jobs, path="/predict", during=None) -> tuple:
    """`jobs` from FRONTIER_CLIENTS threads; `during()` runs once the first
    answer is in. Returns (answers, seconds, latencies ms)."""
    answers, errors = [None] * len(jobs), []
    first = threading.Event()

    def client(k):
        try:
            for i in range(k, len(jobs), FRONTIER_CLIENTS):
                answers[i] = frontier_post(url, *jobs[i], path=path)
                first.set()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))
            first.set()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(FRONTIER_CLIENTS)]
    for t in threads:
        t.start()
    if during is not None:
        first.wait(timeout=FRONT_WAIT_S)
        during()
    for t in threads:
        t.join(timeout=FRONT_WAIT_S)
    if errors or any(a is None for a in answers):
        raise AssertionError(f"[frontier] clients failed: {errors}")
    return answers, time.perf_counter() - t0, [ms for _, _, ms in answers]


def phase_frontier(rng, card: str) -> None:
    tag = "[frontier]"
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        base, new = os.path.join(tmp, "base.pth"), os.path.join(tmp, "new.pth")
        torch.save(export_reference_state_dict(mild_model(MIXED_CONFIG).cpu()), base)
        torch.save(export_reference_state_dict(build_model(MIXED_CONFIG, seed=SEED + 1, device="cpu")), new)
        ports = [free_port() for _ in range(3)]
        backends = [f"127.0.0.1:{p}" for p in ports[:2]]
        furl = f"http://127.0.0.1:{ports[2]}"

        def serve(k):
            p = ServeProcess(tmp, f"serve{k}-{len(procs)}", ["serve", "--port", str(ports[k]), "--restore_ckpt", base,
                                                             *FRONTIER_SERVE_FLAGS])
            procs.append(p)
            return p

        try:
            servers = [serve(0), serve(1)]
            boot_s = [p.wait_healthy(f"http://{b}") for p, b in zip(servers, backends)]
            front = ServeProcess(tmp, "frontier", ["frontier", "--backends", *backends, "--port", str(ports[2]),
                                                   "--health_interval_s", "0.5", "--breaker_fail_after", "2"])
            procs.append(front)
            front_ms = front.wait_healthy(furl, timeout_s=60) * 1e3
            log(f"{tag} two serve processes healthy after {boot_s[0]:.2f} s and {boot_s[1]:.2f} s; the frontier "
                f"answered /healthz {front_ms:.1f} ms after its process started")

            # Mixed plain and stream traffic; each answer equal to the same
            # request posted to its backend directly.
            jobs = [int_pair(rng, *FRONTIER_BUCKET) for _ in range(FRONTIER_REQUESTS)]
            h, w = FRONTIER_BUCKET
            scene = rng.uniform(0, 255, (h, w + 24, 3)).astype(np.float32)
            frames = [(low_contrast(scene[:, 12 + t: 12 + t + w]), low_contrast(scene[:, t: t + w]))
                      for t in range(4)]
            stream = [frontier_post(furl, *frames[t], stream_id="cam0") for t in range(2)]
            answers, front_s, front_lat = frontier_burst(furl, jobs)
            direct_answers, direct_s, direct_lat = frontier_burst(f"http://{backends[0]}", jobs, path="/v1/predict")
            used = {body["backend"] for _, body, _ in answers}
            mismatch = 0
            for (a, b), (status, body, _) in zip(jobs, answers):
                d_status, d_body, _ = frontier_post(f"http://{body['backend']}", a, b, path="/v1/predict")
                mismatch += status != 200 or d_status != 200 or d_body["disparity"] != body["disparity"]
            pinned = stream[0][1]["backend"]
            log(f"{tag} {len(jobs)} plain requests through the frontier from {FRONTIER_CLIENTS} clients, answered by "
                f"{sorted(used)}; {mismatch} differ from the same request posted to their backend directly; stream "
                f"cam0 pinned to {pinned}, frame 1 warm_started {stream[1][1]['warm_started']}")
            if mismatch or len(used) != 2 or stream[1][1]["backend"] != pinned or not stream[1][1]["warm_started"]:
                raise AssertionError(f"{tag} routing: mismatches {mismatch}, backends {used}, stream {stream}")
            log(card)
            log(f"{tag} {len(jobs)} requests at {h}x{w}: through the frontier {len(jobs) / front_s:.3f} requests/s, "
                f"{percentiles(front_lat)}; direct to one backend {len(jobs) / direct_s:.3f} requests/s, "
                f"{percentiles(direct_lat)}")

            # kill -9 the stream-pinned backend mid-traffic.
            victim = servers[backends.index(pinned)]
            survivor = backends[1 - backends.index(pinned)]
            before = request_json(f"{furl}/metrics").json()
            answers, _, _ = frontier_burst(furl, jobs, during=lambda: victim.signal_group(signal.SIGKILL))
            victim.proc.wait(timeout=60)
            lost = sum(status != 200 for status, _, _ in answers)
            differ = 0
            for (a, b), (status, body, _) in zip(jobs, answers):
                _, d_body, _ = frontier_post(f"http://{survivor}", a, b, path="/v1/predict")
                differ += body.get("disparity") != d_body["disparity"]
            after = request_json(f"{furl}/metrics").json()
            moved = frontier_post(furl, *frames[2], stream_id="cam0")[1]
            log(f"{tag} kill -9 of {pinned} mid-traffic: {lost} of {len(jobs)} plain requests lost, {differ} differ "
                f"from the survivor's direct answer; retries +{after['retries_total'] - before['retries_total']}; the "
                f"stream moved to {moved['backend']}: migrated {moved['migrated']}, warm_started "
                f"{moved['warm_started']}")
            if lost or differ or after["retries_total"] <= before["retries_total"] or not moved["migrated"] or \
                    moved["warm_started"] or moved["backend"] != survivor:
                raise AssertionError(f"{tag} the kill: lost {lost}, differ {differ}, stream {moved}")

            # The backend restarted on its port: failed -> probation -> healthy.
            walk = [request_json(f"{furl}/metrics").json()["per_backend"][pinned]["state"]]
            t = time.perf_counter()
            reborn = serve(backends.index(pinned))
            servers[backends.index(pinned)] = reborn
            reborn_s = reborn.wait_healthy(f"http://{pinned}")
            deadline = time.monotonic() + 120
            while walk[-1] != "healthy":
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag} the restarted backend never turned healthy: {walk}")
                state = request_json(f"{furl}/metrics").json()["per_backend"][pinned]["state"]
                if state != walk[-1]:
                    walk.append(state)
                if state == "degraded":
                    frontier_post(furl, *jobs[0])
                time.sleep(0.05)
            log(f"{tag} {pinned} restarted on its port: healthy after {reborn_s:.2f} s; the frontier walked it "
                f"{' -> '.join(walk)} in {time.perf_counter() - t:.2f} s")
            if walk[0] != "failed" or "degraded" not in walk:
                raise AssertionError(f"{tag} breaker walk {walk}")

            # frontier --rollout to the second .pth.
            t = time.perf_counter()
            roll = subprocess.run([sys.executable, "-m", "raft_stereo_tpu_torch", "frontier", "--rollout", new,
                                   "--port", str(ports[2])], env=cli_env(), capture_output=True, text=True,
                                  timeout=600)
            roll_s = time.perf_counter() - t
            record = json.loads(roll.stdout) if roll.returncode == 0 else {}
            gens = [request_json(f"http://{b}/healthz").json()["serving"] for b in backends]
            block = record.get("rollout", {})
            log(f"{tag} frontier --rollout new.pth: exit {roll.returncode} in {roll_s:.2f} s, phase "
                f"{record.get('phase')}, canary changed {record.get('canary_changed')}, mixed_generation_seconds "
                f"{block.get('mixed_generation_seconds')}; backends on generations "
                f"{[g['swap_generation'] for g in gens]}, checkpoints {[os.path.basename(str(g['checkpoint'])) for g in gens]}")
            if roll.returncode != 0 or record.get("phase") != "completed" or \
                    block.get("mixed_generation_seconds") != 0 or \
                    any(g["swap_generation"] != 1 or g["checkpoint"] != new for g in gens):
                raise AssertionError(f"{tag} rollout: {roll.returncode} {roll.stdout[-2000:]} {roll.stderr[-2000:]}")

            # SIGTERM drains the frontier to exit 0.
            code = front.stop()
            log(f"{tag} SIGTERM -> frontier exit {code}")
            if code != 0 or "in-flight forwards drained" not in front.err():
                raise AssertionError(f"{tag} the frontier exited {code}: {front.err()[-2000:]}")
            codes = [p.stop() for p in servers]
            if codes != [0, 0]:
                raise AssertionError(f"{tag} the backends exited {codes}")
        finally:
            for p in procs:
                if p.proc.poll() is None:
                    p.kill()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    adopt_orphans()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, stop_on_signal)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = gpu_line()
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    phase_build()
    errs = phase_kernels(gen)
    errs.update(phase_fused_kernels(gen))
    errs.update(phase_prefetch_kernels(gen))
    errs.update(phase_gates_kernels(gen))
    errs.update(phase_bf16_kernels(gen))
    for name, err in phase_bf16_lever_kernels(gen).items():
        errs[name] = max(errs.get(name, 0.0), err)
    for name, err in phase_prefetch_paths(gen).items():
        errs[name] = max(errs[name], err)
    torch.cuda.empty_cache()
    service, counts = phase_serving(rng)
    phase_stage_times(service)
    phase_end_to_end(service, rng)
    fused_service, fused_counts = phase_serving_fused(rng, service.engine.model.state_dict())
    phase_fused_end_to_end(service, fused_service, rng)
    phase_stage_compare(service, fused_service)
    mixed_service_, mixed_counts = phase_mixed_serving(rng, service.engine.model.state_dict())
    phase_mixed_e2e(mixed_service_, rng)
    del service, fused_service, mixed_service_
    torch.cuda.empty_cache()
    phase_serving_front(rng, card)
    torch.cuda.empty_cache()
    phase_serve_cli(rng)
    torch.cuda.empty_cache()
    eval_counts, gates_counts, eval_flow = phase_evaluate()
    torch.cuda.empty_cache()
    phase_mixed_evaluate(eval_flow)
    torch.cuda.empty_cache()
    phase_evaluate_cli()
    phase_mixed_cli()
    phase_mixed_budget()
    errs.update(phase_scatter_kernels(gen))
    trainer, train_counts, batch = phase_train(rng)
    del trainer
    torch.cuda.empty_cache()
    phase_train_e2e(batch)
    torch.cuda.empty_cache()
    errs.update(phase_bf16_scatter_kernels(gen))
    torch.cuda.empty_cache()
    mixed_train_counts, mixed_batch = phase_mixed_train(rng)
    torch.cuda.empty_cache()
    phase_mixed_train_e2e(mixed_batch)
    torch.cuda.empty_cache()
    realtime_counts = phase_realtime(rng)
    torch.cuda.empty_cache()
    phase_realtime_e2e(rng)
    torch.cuda.empty_cache()
    phase_realtime_evaluate(card)
    torch.cuda.empty_cache()
    lever_counts = phase_mixed_levers()
    torch.cuda.empty_cache()
    phase_spatial_forward(card)
    torch.cuda.empty_cache()
    phase_spatial_serving(rng, card)
    torch.cuda.empty_cache()
    phase_train_cli(card, beside=phase_mixed_converge)
    torch.cuda.empty_cache()
    phase_model_options(rng, card)
    torch.cuda.empty_cache()
    phase_fleet(rng, card)
    torch.cuda.empty_cache()
    phase_frontier(rng, card)
    torch.cuda.empty_cache()
    # Each kernel's launches come from the main-path run of the slice that
    # added it: serving for the forward kernels, training for the scatter,
    # evaluation for the windowed lookup, the gates configuration's forward
    # for the gate pair, the mixed configuration's serving for the bf16
    # forward variants, mixed training for the bf16 scatter, the realtime
    # configuration's serving for the bf16 GRU and motion tails, the mixed
    # configuration's lever runs for the bf16 gate pair and windowed lookup.
    for name in ("corr_pyramid", "encoder_conv", "encoder_join"):
        counts[name] = fused_counts[name]
    counts["corr_scatter"] = train_counts["corr_scatter"]
    counts["corr_prefetch_lookup"] = eval_counts["corr_prefetch_lookup"]
    for name in ("gates_rh", "gates_combine"):
        counts[name] = gates_counts[name]
    for name in ("corr_lookup_bf16", "corr_pyramid_bf16", "encoder_conv_bf16", "encoder_join_bf16"):
        counts[name] = mixed_counts[name]
    counts["corr_scatter_bf16"] = mixed_train_counts["corr_scatter_bf16"]
    for name in ("gru_tail_bf16", "motion_tail_bf16"):
        counts[name] = realtime_counts[name]
    for name in ("gates_rh_bf16", "gates_combine_bf16"):
        counts[name] = lever_counts["gates"][name]
    counts["corr_prefetch_lookup_bf16"] = lever_counts["prefetch_lookup"]["corr_prefetch_lookup_bf16"]
    kernels = phase_timing(gen, errs, counts)
    left = stop_descendants()
    log(f"[processes] still running at the end and stopped now: {left or 'none'}")

    log("[phase-seconds] " + ", ".join(f"{k} {v:.1f}" for k, v in sorted(PHASE_SECONDS.items(),
                                                                       key=lambda kv: -kv[1])))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_descendants()
    sys.exit(code)
