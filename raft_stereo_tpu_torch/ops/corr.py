"""1D (epipolar) all-pairs correlation: volume, pyramid and radius lookup.

PyTorch counterpart of `raft_stereo_tpu/ops/corr.py`. The volume is stored
in fp32 or bf16 (`out_dtype`, the model's `corr_dtype`); otherwise these
functions follow their inputs' dtype, so a float64 copy of the model can
serve the tests as an arbiter of fp32 rounding.

The bf16 contract, the JAX package's: the volume's operands are rounded to
bf16, their products summed in fp32 (a product of two bf16 values is exact
in fp32, so this is an fp32 matmul of the rounded operands, with TF32 off
on the card), divided by sqrt(D) in fp32 and rounded once to bf16; each
level is pooled from the previous level's STORED bf16 values with an fp32
sum and rounded once; the lookup interpolates in fp32 and returns fp32
taps, which the caller rounds to its compute dtype. Tensors
keep the JAX package's layout at these functions: feature maps (B, H, W, D),
volumes (B, H, W1, W2), coordinates (B, H, W1). `corr_lookup` is the
"reg" strategy's lookup and the plain version of the CUDA lookup kernel in
`ops/corr_cuda.py`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from raft_stereo_tpu_torch.utils.geometry import linear_sample_1d

# The bf16 pyramid's accuracy budget, a copy of the JAX package's
# `BF16_CORR_EPE_BUDGET_PX`: the largest end-point-error shift (px) that a
# bf16-stored pyramid may introduce against the fp32 one, measured with fp32
# compute over 2 refinement iterations (at random init the GRU amplifies
# the pyramid's rounding chaotically with the iteration count).
BF16_CORR_EPE_BUDGET_PX = 0.05


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(B, H, W1, D) x (B, H, W2, D) -> (B, H, W1, W2), divided by sqrt(D).
    `out_dtype` torch.bfloat16 stores it in bf16 by the module's contract;
    otherwise it follows the inputs' dtype, bf16 maps widened to fp32 (the
    JAX package's fp32 volume of bf16 features)."""
    dim = fmap1.shape[-1]
    if out_dtype == torch.bfloat16:
        f1 = fmap1.to(torch.bfloat16).float()
        f2 = fmap2.to(torch.bfloat16).float()
        return (torch.matmul(f1, f2.transpose(-1, -2)) / math.sqrt(dim)).to(torch.bfloat16)
    if fmap1.dtype == torch.bfloat16:
        fmap1, fmap2 = fmap1.float(), fmap2.float()
    vol = torch.matmul(fmap1, fmap2.transpose(-1, -2))
    return vol / math.sqrt(dim)


def _avg_pool_last(x: torch.Tensor) -> torch.Tensor:
    """Average pairs along the last axis, floor semantics (a trailing odd
    sample is dropped): (a + b) / 2 rounds exactly as JAX's 0.5-weight
    pair matmul does, since halving is exact. A bf16 level is summed in
    fp32 and rounded once, as JAX's fp32-accumulating matmul does."""
    w2 = x.shape[-1] // 2
    if x.dtype == torch.bfloat16:
        return ((x[..., 0 : 2 * w2 : 2].float() + x[..., 1 : 2 * w2 : 2].float()) * 0.5).to(x.dtype)
    return (x[..., 0 : 2 * w2 : 2] + x[..., 1 : 2 * w2 : 2]) * 0.5


def corr_pyramid(volume: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Pyramid over W2: level l has W2 // 2**l samples, each contiguous."""
    pyramid = [volume.contiguous()]
    for _ in range(num_levels - 1):
        pyramid.append(_avg_pool_last(pyramid[-1]).contiguous())
    return pyramid


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1) linearly interpolated taps around `coords` / 2**l at every
    level; coords (B, H, W1) at level-0 resolution. Returns
    (B, H, W1, L*(2r+1)), level-major. Samples outside [0, W2_l) are zero.
    bf16 levels are interpolated in fp32 (the taps are fp32)."""
    offsets = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    out = []
    for i, vol in enumerate(pyramid):
        x = coords[..., None] / (2**i) + offsets
        out.append(linear_sample_1d(vol, x))
    return torch.cat(out, dim=-1)


def pool_fmap_levels(fmap2: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Right-image features of the on-the-fly ("alt") strategy: fmap2
    (B, H, W2, D) widened to fp32 (other dtypes kept), then each level
    averages pairs along W (a trailing odd sample dropped), as the JAX
    package's `pool_fmap_levels`. Every level is contiguous."""
    if fmap2.dtype == torch.bfloat16:
        fmap2 = fmap2.float()
    levels = [fmap2.contiguous()]
    for _ in range(num_levels - 1):
        prev = levels[-1]
        w2 = prev.shape[2] // 2
        levels.append(((prev[:, :, 0 : 2 * w2 : 2] + prev[:, :, 1 : 2 * w2 : 2]) * 0.5).contiguous())
    return levels


def corr_lookup_alt(fmap1: torch.Tensor, fmap2_levels: Sequence[torch.Tensor], coords: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """On-the-fly correlation taps (the "alt" strategy): sample each level's
    features at the (2r+1) tap positions around coords / 2**l with
    `linear_sample_1d`'s zero-outside weights, dot with fmap1 over D and
    divide by sqrt(D). fmap1 (B, H, W1, D), levels (B, H, W2_l, D),
    coords (B, H, W1); returns (B, H, W1, L*(2r+1)), level-major.

    The values are the JAX package's `corr_lookup_alt`: each sampled
    feature is g0 * (w0 * valid0) + g1 * (w1 * valid1), and its product with
    fmap1 is summed over D as an elementwise multiply and a sum (never a
    matmul, so TF32 cannot reach it whatever the process-wide flags say).
    Memory: one tap position at a time, so a level costs three
    (B, H, W1, D) tensors (the two gathers and their blend) and not the
    (B, H, D, W1 * (2r+1)) block that JAX's broadcast form materializes;
    the gather's index is a view expanded over D."""
    if fmap1.dtype == torch.bfloat16:
        fmap1 = fmap1.float()
    b, h, w1, dim = fmap1.shape
    scale = math.sqrt(dim)
    out = []
    for i, f2 in enumerate(fmap2_levels):
        w2 = f2.shape[2]
        for off in range(-radius, radius + 1):
            x = coords / (2**i) + off
            x0f = torch.floor(x)
            frac = x - x0f
            x0 = x0f.long()
            sampled = None
            for idx, weight in ((x0, 1.0 - frac), (x0 + 1, frac)):
                valid = (idx >= 0) & (idx <= w2 - 1)
                index = idx.clamp(0, w2 - 1)[..., None].expand(b, h, w1, dim)
                tap = torch.gather(f2, 2, index) * (weight * valid.to(weight.dtype))[..., None]
                sampled = tap if sampled is None else sampled + tap
            out.append((sampled * fmap1).sum(dim=-1) / scale)
    return torch.stack(out, dim=-1)
