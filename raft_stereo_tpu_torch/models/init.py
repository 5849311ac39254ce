"""Seeded random model variables: counterpart of
`raft_stereo_tpu/models/init_cache.py`.

Draws every parameter from an explicit `torch.Generator` with the JAX
package's initializers: conv kernels from a truncated normal with variance
2 / fan_out (flax `variance_scaling(2.0, "fan_out", "truncated_normal")`),
biases zero, norms the identity. The draw happens on the CPU, so a seed
gives the same weights on every device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.layers import FrozenBatchNorm, GroupNorm
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo

# Standard deviation of a unit normal truncated to [-2, 2], which flax
# divides out so the truncated draw keeps the requested variance.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter and buffer of `module` in place."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            out_ch, _, kh, kw = m.weight.shape
            std = math.sqrt(2.0 / (out_ch * kh * kw)) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            m.weight.copy_(w * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


def build_model(config: RAFTStereoConfig, seed: int = 0, device="cuda") -> RAFTStereo:
    """A `RAFTStereo` in eval mode on `device` with weights drawn from `seed`."""
    with torch.device("meta"):
        model = RAFTStereo(config)
    model = model.to_empty(device="cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
