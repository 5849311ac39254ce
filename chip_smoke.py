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
and checks one step against plain autograd, and times every kernel.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Needs no JAX. Exits non-zero on any failure, and before printing anything
when no CUDA device is available. Prints the card's name and power limit,
then one JSON line describing the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, TrainConfig
from raft_stereo_tpu_torch.evaluate import Evaluator, SyntheticEvalDataset, validate_middlebury
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import _build, corr, corr_cuda, encoder_cuda, gates, gru_tail
from raft_stereo_tpu_torch.serving.service import StereoService
from raft_stereo_tpu_torch.train.trainer import Trainer

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
TRAIN_TIMED_STEPS = 5
# The fourth slice's: the evaluate entry point's configuration, the kernel
# one with the windowed lookup, at 32 iterations on a synthetic set of two
# Middlebury-F-sized pairs (1980x2870 pads to 1984x2880: the padding and
# the crop run on the card); and the gates configuration, which needs the
# fused tail off (it takes precedence over the gates, as in JAX), run with
# the gates' environment variable set against its twin without it.
EVAL_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=True, prefetch_lookup=True)
GATES_CONFIG = RAFTStereoConfig(corr_implementation="pallas", fused_gru_tail=False, prefetch_lookup=True)
EVAL_SHAPE = (1980, 2870)
# The windowed lookup's checks: the 512x768 bucket's 1/4 resolution and
# Middlebury-F's, (label, (query rows, W1 = W2)).
PREFETCH_CASES = (("512x768", (128, 192)), ("1984x2880", (496, 720)))
EVAL_ITERS = 32
# Iterations of the evaluate path's end-to-end checks against plain code
# and the gates' twin.
E2E_ITERS = 4
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Tolerances. The kernels are compiled with -fmad=false and round where the
# plain versions round, so the lookup and motion tail are expected to agree
# exactly; the GRU tail may differ in the last ulp of expf/tanhf.
# The join is built the same way and must agree exactly. The conv and the
# pyramid build need not sum in cuDNN's and cuBLAS's order (they may pick
# other algorithms on another card or version), so their tolerances are
# stated for unit-scale inputs (weights scaled by 1/sqrt(9*64), so y is
# unit-scale too; the volume's dot products are divided by sqrt(D)).
# The conv statistics are held relative to sum|y| and sum y^2 per channel.
TOL = {"corr_lookup": 1e-5, "gru_tail": 1e-6, "motion_tail": 0.0,
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
TRAIN_LOSS_RTOL = 1e-6
TRAIN_NORM_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_FNET_GRAD_TOL = 1e-1

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


def log(msg: str) -> None:
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


def lookup_bytes(pyramid, coords, radius) -> int:
    """Bytes the lookup must move on these inputs: coordinates and outputs
    once, plus each in-range pyramid sample a query's window touches."""
    n_q = coords.numel()
    k = 2 * radius + 1
    total = 4 * n_q + 4 * n_q * len(pyramid) * k
    for lvl, vol in enumerate(pyramid):
        w2 = vol.shape[-1]
        lo = torch.floor(coords / (2**lvl) - radius)
        hi = lo + 2 * radius + 1
        touched = (torch.minimum(hi, torch.tensor(w2 - 1.0, device=coords.device))
                   - torch.maximum(lo, torch.zeros((), device=coords.device)) + 1).clamp(min=0)
        total += 4 * int(touched.sum().item())
    return total


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


def fmap_inputs(gen, b, h, w, d=256):
    """Feature maps as the model hands them to the pyramid build: (B, H, W, D)
    views of NCHW tensors."""
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
        err = max_err(got, corr.corr_lookup(pyramid, coords, 4))
        log(f"[kernels] corr_lookup {hh}x{ww} (queries {hh // 4}x{ww // 4}, W2 {ww // 4}): "
            f"max abs diff {err:.3e} (tol {TOL['corr_lookup']:g})")
        if not err <= TOL["corr_lookup"]:
            raise AssertionError(f"corr_lookup disagrees with its plain version at {hh}x{ww}: {err}")
        errs["corr_lookup"] = max(errs.get("corr_lookup", 0.0), err)
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
        err = max_err(got, gru_tail.plain_motion_tail(pre, flow))
        log(f"[kernels] motion_tail 126x{hh // 4}x{ww // 4}: max abs diff {err:.3e} "
            f"(tol {TOL['motion_tail']:g})")
        if not err <= TOL["motion_tail"]:
            raise AssertionError(f"motion_tail disagrees with its plain version at {hh}x{ww}: {err}")
        errs["motion_tail"] = max(errs.get("motion_tail", 0.0), err)
    return errs


def phase_fused_kernels(gen) -> dict:
    """The fused encoder's three kernels against their plain versions at the
    main path's shapes: the conv at full resolution of both buckets (batch 1
    is the context trunk, batch 2 the feature trunk), every form, with
    statistics; the join over every form pair; the pyramid at both buckets'
    1/4 resolution (D = 256) and at Middlebury-F."""
    errs = {}

    def check(name, err, label, extra=""):
        log(f"[kernels] {name} {label}: max abs diff {err:.3e} (tol {TOL[name]:g}){extra}")
        if not err <= TOL[name]:
            raise AssertionError(f"{name} disagrees with its plain version at {label}: {err}")
        errs[name] = max(errs.get(name, 0.0), err)

    for hh, ww in ((384, 512), (512, 768)):
        for b in (1, 2):
            for form in ("none", "in", "bn"):
                x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
                y, stats = encoder_cuda.fused_conv(x, weight, bias, aff, form, emit_stats=True)
                torch.cuda.synchronize()
                want_y, _ = encoder_cuda.plain_conv(x, weight, bias, aff, form, False)
                rel = stats_rel_err(stats, want_y)
                check("encoder_conv", max_err(y, want_y), f"b{b} {hh}x{ww} form {form}",
                      f"; stats rel diff {rel:.3e} (tol {STATS_REL_TOL:g})")
                if not rel <= STATS_REL_TOL:
                    raise AssertionError(f"encoder_conv statistics disagree at b{b} {hh}x{ww} {form}: {rel}")
                del x, y, want_y
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
    for hh, ww in ((384, 512), (512, 768), (1984, 2880)):
        f1, f2 = fmap_inputs(gen, 1, hh // 4, ww // 4)
        got = corr_cuda.fused_pyramid_state(f1, f2, 4)
        torch.cuda.synchronize()
        want = corr_cuda.corr_state(f1, f2, 4)
        check("corr_pyramid", max(max_err(g, w) for g, w in zip(got, want)),
              f"{hh}x{ww} (rows {hh // 4}, W1 = W2 = {ww // 4}, D 256, 4 levels)")
        del f1, f2, got, want
    return errs


def scatter_inputs(gen, b, h, w1, w2, levels=4, radius=4):
    """The lookup's coordinates at the recipe's 1/4 resolution (mostly in
    range, 10% far outside on both sides) with the adversarial values in
    the first row (negative, 0, integral, W2_l - 1, W2, +-1e6, NaN, inf),
    and a unit-scale tap cotangent."""
    _, coords = lookup_inputs(gen, b, h, w1, w2, levels, radius)
    special = [-1.0, -3.5, 0.0, 3.0, float(w2), 1e6, -1e6, float("nan"), float("inf"), float("-inf")]
    special += [float(((w2 >> l) - 1) << l) for l in range(levels)]
    coords.view(-1)[: len(special)] = torch.tensor(special, device=DEVICE)
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
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    log(f"[kernels] corr_scatter b{b} {h}x{w} (W2 {w}, widths {widths}, adversarial coords): max abs diff "
        f"{err:.3e} (tol {TOL['corr_scatter']:g}); two launches bitwise equal: {same}")
    if not err <= TOL["corr_scatter"] or not same:
        raise AssertionError(f"corr_scatter disagrees with its plain version ({err}) or is not reproducible")
    del got, again, want
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
    """The training step at the recipe: one warm step, then timed steps,
    each with its launch counts. Returns (trainer, launch counts over the
    timed steps, a batch for the e2e check)."""
    h, w = TRAIN_HW
    cfg = TrainConfig(model=TRAIN_CONFIG, batch_size=TRAIN_BATCH, train_iters=TRAIN_ITERS, seed=SEED)
    t0 = time.perf_counter()
    batches = [train_batch(rng, TRAIN_BATCH, h, w) for _ in range(3)]
    log(f"[train] {len(batches)} synthetic batches of {TRAIN_BATCH}x{h}x{w} from seed {SEED}: "
        f"{time.perf_counter() - t0:.2f} s; valid share {np.mean([b_['valid'].mean() for b_ in batches]):.3f}")
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    before = [p.detach().clone() for p in trainer.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    m = trainer.train_step(batches[0])
    torch.cuda.synchronize()
    log(f"[train] warm step: loss {m['live_loss']:.6f}, grad_norm {m['grad_norm']:.6f}, lr {m['learning_rate']:.6e}, "
        f"{time.perf_counter() - t:.3f} s")
    per_step = expect(corr_lookup=TRAIN_ITERS, corr_scatter=TRAIN_ITERS)
    reset_launches()
    secs = []
    for i in range(TRAIN_TIMED_STEPS):
        before_counts = launches()
        t = time.perf_counter()
        m = trainer.train_step(batches[(i + 1) % len(batches)])
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


def step_grads(model_cfg, batch) -> tuple:
    """One Trainer step from the seed's weights; returns (metrics, trainer
    with the step's clipped gradients in .grad)."""
    h, w = TRAIN_HW
    cfg = TrainConfig(model=model_cfg, batch_size=TRAIN_BATCH, train_iters=TRAIN_ITERS, seed=SEED)
    trainer = Trainer(cfg, (h, w, 3), device=DEVICE)
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    return metrics, trainer


def phase_train_e2e(batch) -> None:
    """One step of the kernel configuration against the plain one (the
    "reg" lookup, autograd through its gather) from the same seeded weights
    and batch: loss, global gradient norm, each parameter's gradient."""
    mk, tk = step_grads(TRAIN_CONFIG, batch)
    gk = {n: p.grad.detach().clone() for n, p in tk.model.named_parameters()}
    del tk
    mp, tp = step_grads(TRAIN_PLAIN_CONFIG, batch)
    gp = {n: p.grad for n, p in tp.model.named_parameters()}
    loss_rel = abs(mk["live_loss"] - mp["live_loss"]) / abs(mp["live_loss"])
    norm_rel = abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"]
    largest = float(max(g.abs().max().item() for g in gp.values()))
    worst, worst_fnet = (0.0, ""), (0.0, "")
    for name, g in gp.items():
        a = gk[name]
        fnet_trunk = name.startswith("fnet.trunk.")
        if fnet_trunk and name.endswith(".bias") and "norm" not in name:
            noise = max(float(a.abs().max().item()), float(g.abs().max().item())) / largest
            if not noise <= 1e-6:
                raise AssertionError(f"train e2e: {name} (a zero gradient) is {noise} of the largest gradient")
            continue
        rel = max_err(a, g) / max(float(g.abs().max().item()), 1e-30)
        if fnet_trunk:
            worst_fnet = max(worst_fnet, (rel, name))
        else:
            worst = max(worst, (rel, name))
    log(f"[train-e2e] b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, {TRAIN_ITERS} iters, kernels vs plain autograd: "
        f"loss {mk['live_loss']:.7f} vs {mp['live_loss']:.7f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_RTOL:g}); "
        f"grad_norm {mk['grad_norm']:.6f} vs {mp['grad_norm']:.6f} (rel {norm_rel:.3e}, tol {TRAIN_NORM_RTOL:g}); "
        f"worst parameter gradient {worst[0]:.3e} of its max ({worst[1]}, tol {TRAIN_GRAD_TOL:g}); "
        f"feature-encoder trunk worst {worst_fnet[0]:.3e} ({worst_fnet[1]}, tol {TRAIN_FNET_GRAD_TOL:g})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_NORM_RTOL and worst[0] <= TRAIN_GRAD_TOL
            and worst_fnet[0] <= TRAIN_FNET_GRAD_TOL):
        raise AssertionError("the kernel configuration's training step disagrees with the plain one")


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
    over two synthetic 1980x2870 pairs in the evaluate configuration, 32
    iterations, with each image's forward seconds and launches; the first
    image again in the kernel configuration (the dense lookup): flow_up
    equal bit for bit; the evaluate configuration against the plain one
    at 4 iterations; the gates configuration at 32 iterations (launches)
    and against its twin without the variable at 4. Returns the launch
    counts of the evaluate run and of the 32-iteration gates forward."""
    dataset = SyntheticEvalDataset(n=2, shape=EVAL_SHAPE)
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
    dense = build_model(KERNEL_CONFIG, seed=SEED, device=DEVICE)
    dense.load_state_dict(model.state_dict())
    dense_ev = Evaluator(dense, iters=EVAL_ITERS)
    times = {"evaluate": [record[0][1]], "kernel": []}
    for name, ev in (("kernel", dense_ev), ("kernel", dense_ev), ("evaluate", evaluator)):
        flow, seconds = ev(*pair)
        times[name].append(seconds)
        if ev is dense_ev:
            dense_flow = flow
    equal = np.array_equal(dense_flow, record[0][0])
    log(f"[evaluate] first image, {EVAL_ITERS} iters, kernel configuration (dense lookup) vs evaluate "
        f"configuration (windowed lookup): flow_up bitwise equal {equal}, max abs diff "
        f"{np.abs(dense_flow - record[0][0]).max():.3e}; forward s, in turns (evaluate, kernel, kernel, "
        f"evaluate): evaluate {', '.join(f'{t:.3f}' for t in times['evaluate'])}; kernel "
        f"{', '.join(f'{t:.3f}' for t in times['kernel'])}")
    if not equal:
        raise AssertionError("the evaluate configuration's flow differs from the dense kernel configuration's")
    del dense

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
    ev = Evaluator(gated, iters=EVAL_ITERS)
    os.environ[gates.ENV_VAR] = "1"
    try:
        reset_launches()
        _, seconds = ev(*pair)
        gates_counts = launches()
        ev.iters = E2E_ITERS
        reset_launches()
        flow_gates, _ = ev(*pair)
        short_counts = launches()
    finally:
        os.environ.pop(gates.ENV_VAR)
    reset_launches()
    flow_twin, _ = ev(*pair)
    twin_counts = launches()
    err = float(np.abs(flow_gates - flow_twin).max())
    log(f"[evaluate] gates configuration, first image, {EVAL_ITERS} iters: forward {seconds:.3f} s, launches "
        f"{gates_counts}; at {E2E_ITERS} iters against its twin without {gates.ENV_VAR}: flow_up max abs "
        f"diff {err:.3e} px (tol {E2E_TOL_PX:g} px); twin launches {twin_counts}")
    want = expect(corr_prefetch_lookup=EVAL_ITERS, gates_rh=3 * EVAL_ITERS, gates_combine=3 * EVAL_ITERS)
    if gates_counts != want:
        raise AssertionError(f"gates configuration: launches {gates_counts} != expected {want}")
    it = E2E_ITERS
    if short_counts != expect(corr_prefetch_lookup=it, gates_rh=3 * it, gates_combine=3 * it):
        raise AssertionError(f"gates configuration at {it} iters: launches {short_counts}")
    if twin_counts != expect(corr_prefetch_lookup=it):
        raise AssertionError(f"gates twin: launches {twin_counts} != expected only the windowed lookup")
    if not (np.isfinite(flow_gates).all() and err <= E2E_TOL_PX):
        raise AssertionError(f"the gates configuration disagrees with its twin: {err} px")
    return eval_counts, gates_counts


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


def phase_timing(gen, errs, counts) -> list:
    """Kernel, plain and library times at the 512x768 bucket's shapes (the
    JSON rows), and at Middlebury-F's for the evaluate path's kernels."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEVICE)  # 256 MB > L2
    out = []

    def entry(name, ms, plain_ms, nbytes, flops, library_ms):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        src, replaces = KERNELS[name]
        e = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        where = {"corr_scatter": f"{TRAIN_TIMED_STEPS} training steps",
                 "corr_prefetch_lookup": "the [evaluate] run (2 images)",
                 "gates_rh": f"one {EVAL_ITERS}-iteration gates forward",
                 "gates_combine": f"one {EVAL_ITERS}-iteration gates forward"}.get(name, f"{len(REQUESTS)} requests")
        log(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}, {nbytes} B, {flops} ops), library {lib}, "
            f"launches {counts[name]} over {where}")
        out.append(e)

    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        pyramid, coords = lookup_inputs(gen, 1, hh // 4, ww // 4, ww // 4)
        ms = time_ms(lambda: corr_cuda.corr_lookup(pyramid, coords, 4), flush=flush)
        pf_ms = time_ms(lambda: corr_cuda.prefetch_corr_lookup(pyramid, coords, 4), flush=flush)
        plain_ms = time_ms(lambda: corr.corr_lookup(pyramid, coords, 4), flush=flush)
        nbytes = lookup_bytes(pyramid, coords, 4)
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
            log(f"[timing] corr_lookup {label}: kernel {ms:.4f} ms, windowed kernel (corr_prefetch_lookup) "
                f"{pf_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes), library not measured")
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
    plain_ms = time_ms(lambda: gru_tail.plain_motion_tail(pre, flow), flush=flush)
    hw = 128 * 192
    entry("motion_tail", ms, plain_ms, 4 * hw * (126 + 1 + 128), 126 * hw, None)
    del pre, flow

    for label, (hh, ww) in (("512x768", (512, 768)), ("1984x2880", (1984, 2880))):
        f1, f2 = fmap_inputs(gen, 1, hh // 4, ww // 4)
        b, h, w, d = f1.shape
        ms = time_ms(lambda: corr_cuda.fused_pyramid_state(f1, f2, 4), flush=flush)
        plain_ms = time_ms(lambda: corr_cuda.corr_state(f1, f2, 4), flush=flush)
        # The library yardstick computes the volume only (no scaling, no pooling).
        lib_ms = time_ms(lambda: torch.matmul(f1, f2.transpose(-1, -2)), flush=flush)
        widths = [w >> l for l in range(4)]
        nbytes = 4 * (2 * b * h * w * d + b * h * w * sum(widths))
        # The GEMM, the division of each volume entry, an add and a halving per pooled value.
        flops = 2 * b * h * w * w * d + b * h * w * (w + 2 * sum(widths[1:]))
        if label == "512x768":
            log(f"[timing] corr_pyramid {label}: library is torch.matmul of the volume alone")
            entry("corr_pyramid", ms, plain_ms, nbytes, flops, lib_ms)
        else:
            log(f"[timing] corr_pyramid {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3:.4f} ms (operations), "
                f"torch.matmul volume alone {lib_ms:.4f} ms")
        del f1, f2

    for hh, ww in ((512, 768), (384, 512)):
        for b, form, stats in ((1, "in", True), (2, "in", True), (1, "bn", False)):
            x, weight, bias, aff = conv_inputs(gen, b, hh, ww, form)
            ms = time_ms(lambda: encoder_cuda.fused_conv(x, weight, bias, aff, form, stats), flush=flush)
            plain_ms = time_ms(lambda: encoder_cuda.plain_conv(x, weight, bias, aff, form, stats), flush=flush)
            z = encoder_cuda.apply_affine(x, aff, form)
            lib_ms = time_ms(lambda: F.conv2d(z, weight, bias, padding=1), flush=flush)
            hw = hh * ww
            nbytes = 4 * (2 * b * 64 * hw + 64 * 64 * 9 + 64 + 2 * b * 64 * (1 + stats))
            # The GEMM, the operand affine and relu (3 per input), bias and statistics (3 per output).
            flops = 2 * 9 * 64 * 64 * b * hw + 3 * b * 64 * hw * (1 + stats)
            label = f"b{b} {hh}x{ww} form {form}{' + stats' if stats else ''}"
            if (hh, b, form) == (512, 1, "in"):
                log(f"[timing] encoder_conv {label}: library is F.conv2d of the normalized operand "
                    f"(cuDNN, TF32 off), without affine or statistics")
                entry("encoder_conv", ms, plain_ms, nbytes, flops, lib_ms)
            else:
                log(f"[timing] encoder_conv {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                    f"bound {flops / FP32_FLOPS_PER_S * 1e3:.4f} ms (operations), F.conv2d {lib_ms:.4f} ms, "
                    f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s")
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
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
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
    service, counts = phase_serving(rng)
    phase_stage_times(service)
    phase_end_to_end(service, rng)
    fused_service, fused_counts = phase_serving_fused(rng, service.engine.model.state_dict())
    phase_fused_end_to_end(service, fused_service, rng)
    phase_stage_compare(service, fused_service)
    del service, fused_service
    torch.cuda.empty_cache()
    eval_counts, gates_counts = phase_evaluate()
    torch.cuda.empty_cache()
    phase_evaluate_cli()
    errs.update(phase_scatter_kernels(gen))
    trainer, train_counts, batch = phase_train(rng)
    del trainer
    torch.cuda.empty_cache()
    phase_train_e2e(batch)
    torch.cuda.empty_cache()
    # Each kernel's launches come from the main-path run of the slice that
    # added it: serving for the forward kernels, training for the scatter,
    # evaluation for the windowed lookup, the gates configuration's forward
    # for the gate pair.
    for name in ("corr_pyramid", "encoder_conv", "encoder_join"):
        counts[name] = fused_counts[name]
    counts["corr_scatter"] = train_counts["corr_scatter"]
    counts["corr_prefetch_lookup"] = eval_counts["corr_prefetch_lookup"]
    for name in ("gates_rh", "gates_combine"):
        counts[name] = gates_counts[name]
    kernels = phase_timing(gen, errs, counts)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
