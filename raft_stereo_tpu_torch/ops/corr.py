"""1D (epipolar) all-pairs correlation: volume, pyramid and radius lookup.

PyTorch counterpart of `raft_stereo_tpu/ops/corr.py` (fp32 only). Tensors
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


def corr_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(B, H, W1, D) x (B, H, W2, D) -> (B, H, W1, W2), divided by sqrt(D)."""
    dim = fmap1.shape[-1]
    vol = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return vol / math.sqrt(dim)


def _avg_pool_last(x: torch.Tensor) -> torch.Tensor:
    """Average pairs along the last axis, floor semantics (a trailing odd
    sample is dropped): (a + b) / 2 rounds exactly as JAX's 0.5-weight
    pair matmul does, since halving is exact."""
    w2 = x.shape[-1] // 2
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
    (B, H, W1, L*(2r+1)), level-major. Samples outside [0, W2_l) are zero."""
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    out = []
    for i, vol in enumerate(pyramid):
        x = coords.float()[..., None] / (2**i) + offsets
        out.append(linear_sample_1d(vol, x))
    return torch.cat(out, dim=-1)
