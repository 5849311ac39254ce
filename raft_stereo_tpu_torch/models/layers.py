"""Neural building blocks of the encoders and the update block, NCHW.

PyTorch counterpart of `raft_stereo_tpu/models/layers.py` (direct-conv
path; the W-space-to-depth classes are a TPU layout and are not ported).
Normalization follows the JAX package: `FrozenBatchNorm` always uses stored
statistics, `InstanceNorm` has no parameters and takes one-pass fp32
statistics. Attribute names follow the flax module names, except that the
norms of a block are `norm1`, `norm2`, `norm3` in call order (flax numbers
them `<Norm>_0`, `_1`, `_2`; utils/checkpoints.py maps between the two).

Inside a band scope (parallel/spatial.py) `Conv` takes its row halo from
the neighbouring bands and the instance and group norms sum their
statistics over the bands; outside one they are the plain layers.

Compute dtype follows the input, as in the JAX package: parameters stay
fp32 and are cast to a bf16 input's dtype at use (never the module itself,
which the weight bridge and training keep in fp32). Under bf16 each torch
op rounds its result to bf16; the norms take their statistics and fold
their affines in fp32 and cast the result once.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from raft_stereo_tpu_torch.parallel import spatial


class Conv(nn.Conv2d):
    """Conv2d with the JAX package's default symmetric padding kernel // 2.
    On an input of another dtype than its fp32 parameters (bf16) the conv
    runs in the input's dtype with the kernel cast at use, its result is
    rounded, and only then the cast bias is added (flax `nn.Conv` with
    `dtype=x.dtype`)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = None):
        super().__init__(
            in_features, features, kernel_size, stride=stride,
            padding=kernel_size // 2 if padding is None else padding,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scope = spatial.banded()
        if scope is not None and self.kernel_size[0] > 1:
            return self._banded(x, scope)
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        return y + self.bias.to(x.dtype)[None, :, None, None]

    def _banded(self, x: torch.Tensor, scope) -> torch.Tensor:
        """This band's output rows from its rows and the halo, with no row
        padding (the halo's zero rows at the image's edges are it)."""
        x = scope.halo_rows(x, *spatial.conv_halo(self.kernel_size[0], self.stride[0], self.padding[0]))
        padding = (0, self.padding[1])
        if x.dtype == self.weight.dtype:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding, self.dilation, self.groups)
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, padding, self.dilation, self.groups)
        return y + self.bias.to(x.dtype)[None, :, None, None]


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

    def affine(self):
        """The folded (inv, shift) pair (fp32, as the parameters are), which
        `forward` applies: the counterpart of calling the flax module with
        x=None."""
        inv = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        shift = self.bias - self.running_mean * inv
        return inv, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = (t.to(x.dtype)[None, :, None, None] for t in self.affine())
        return x * inv + shift


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over (H, W), no parameters,
    with the JAX package's one-pass statistics: var = E[x^2] - mean^2, both
    sums at least fp32 (a bf16 input is summed in fp32), then
    (x - mean) * inv in the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2] * x.shape[3]
        xs = x.float() if x.dtype == torch.bfloat16 else x
        scope = spatial.banded()
        if scope is None:
            mean = xs.sum(dim=(2, 3), keepdim=True) / n
            var = torch.clamp((xs * xs).sum(dim=(2, 3), keepdim=True) / n - mean * mean, min=0.0)
        else:
            # The band's sums, summed over the bands, over the whole image.
            n *= scope.count
            sums = scope.band_sum(torch.stack([xs.sum(dim=(2, 3)), (xs * xs).sum(dim=(2, 3))]))
            mean = (sums[0] / n)[..., None, None]
            var = torch.clamp((sums[1] / n)[..., None, None] - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.epsilon)
        return (x - mean.to(x.dtype)) * inv.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with per-channel scale and bias (flax `scale`/`bias`)."""

    def __init__(self, features: int, num_groups: int, epsilon: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 (at least) statistics and affine, cast back to x's dtype.
        On a band: one-pass statistics (flax's fast variance) summed over
        the bands."""
        scope = spatial.banded()
        if scope is not None:
            return self._banded(x, scope)
        if x.dtype != torch.bfloat16:
            return F.group_norm(x, self.num_groups, self.weight, self.bias, self.epsilon)
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.epsilon).to(x.dtype)

    def _banded(self, x: torch.Tensor, scope) -> torch.Tensor:
        b, c, h, w = x.shape
        xs = (x.float() if x.dtype == torch.bfloat16 else x).reshape(b, self.num_groups, -1)
        n = xs.shape[2] * scope.count
        sums = scope.band_sum(torch.stack([xs.sum(dim=2), (xs * xs).sum(dim=2)]))
        mean = (sums[0] / n)[..., None]
        var = torch.clamp(sums[1] / n - mean[..., 0] * mean[..., 0], min=0.0)[..., None]
        y = ((xs - mean) * torch.rsqrt(var + self.epsilon)).reshape(b, c, h, w)
        return (y * self.weight[None, :, None, None] + self.bias[None, :, None, None]).to(x.dtype)


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
