"""Neural building blocks of the encoders and the update block, NCHW.

PyTorch counterpart of `raft_stereo_tpu/models/layers.py` (direct-conv
path; the W-space-to-depth classes are a TPU layout and are not ported).
Normalization follows the JAX package: `FrozenBatchNorm` always uses stored
statistics, `InstanceNorm` has no parameters and takes one-pass fp32
statistics. Attribute names follow the flax module names, except that the
norms of a block are `norm1`, `norm2`, `norm3` in call order (flax numbers
them `<Norm>_0`, `_1`, `_2`; utils/checkpoints.py maps between the two).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """Conv2d with the JAX package's default symmetric padding kernel // 2."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = None):
        super().__init__(
            in_features, features, kernel_size, stride=stride,
            padding=kernel_size // 2 if padding is None else padding,
        )


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics only: a per-channel affine
    `x * inv + shift`, inv = rsqrt(var + eps) * scale, shift = bias - mean * inv."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over (H, W), no parameters,
    with the JAX package's one-pass statistics: var = E[x^2] - mean^2."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2] * x.shape[3]
        mean = x.sum(dim=(2, 3), keepdim=True) / n
        var = torch.clamp((x * x).sum(dim=(2, 3), keepdim=True) / n - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.epsilon)


class GroupNorm(nn.Module):
    """GroupNorm with per-channel scale and bias (flax `scale`/`bias`)."""

    def __init__(self, features: int, num_groups: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.epsilon)


def make_norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "batch":
        return FrozenBatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm(features)
    if norm_fn == "group":
        return GroupNorm(features, num_groups=features // 8)
    if norm_fn == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    """conv -> norm -> relu twice, a strided 1x1 conv + norm on the skip
    path iff the stride is not 1 or the width changes, relu(x + y)."""

    def __init__(self, in_features: int, features: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, stride=stride)
        self.norm1 = make_norm(norm_fn, features)
        self.conv2 = Conv(features, features, 3)
        self.norm2 = make_norm(norm_fn, features)
        self.has_skip_conv = not (stride == 1 and in_features == features)
        if self.has_skip_conv:
            self.downsample = Conv(in_features, features, 1, stride=stride, padding=0)
            self.norm3 = make_norm(norm_fn, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.has_skip_conv:
            x = self.norm3(self.downsample(x))
        return torch.relu(x + y)
