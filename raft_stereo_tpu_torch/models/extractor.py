"""Feature and context encoders, NCHW: counterpart of
`raft_stereo_tpu/models/extractor.py` on its direct-conv path.

Channel progression 64 -> 64 -> 96 -> 128, strides `1 + (downsample > k)`,
a 7x7 stem (the JAX package's column-im2col stem is the same math as this
plain conv), and per-scale (hidden, context) heads in `MultiBasicEncoder`,
finest scale first.

`fused_layer1` (config.fused_encoder) runs the stem norm and layer1 through
the fused kernels of ops/encoder_cuda.py, on the same parameters, where the
JAX package's `EncoderTrunk` takes its fused branch: even W at stem
resolution and instance or batch norm, and only in a test-mode forward
(`forward(x, test_mode=True)`), as the JAX model builds its encoders with
`fused_layer1=cfg.fused_encoder and test_mode`: the kernels have no
backward, so a training forward takes the direct path.

On a band (parallel/spatial.py) the trunk's levels are banded and the
context encoder's layer4/layer5 levels follow the ragged-level rule
(`spatial.coarser`, `spatial.level`); `fused_layer1` runs there too, its
convs on their halo form with one row of each neighbour band and its
instance statistics (the stem's and every conv's) summed over the bands.

Both encoders follow their input's dtype: under mixed precision the images
arrive in bf16, the convs and norms run in bf16 on fp32 parameters, and the
fused layer1 takes the kernels' bf16 variants.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from raft_stereo_tpu_torch.models.layers import Conv, ResidualBlock, make_norm
from raft_stereo_tpu_torch.ops import encoder_cuda
from raft_stereo_tpu_torch.parallel import spatial


def _stride(downsample: int, threshold: int) -> int:
    return 1 + int(downsample > threshold)


class EncoderTrunk(nn.Module):
    """Stem + layer1-3: input -> 128 channels at 1/2**downsample."""

    def __init__(self, norm_fn: str, downsample: int, in_channels: int = 3,
                 fused_layer1: bool = False):
        super().__init__()
        self.norm_fn = norm_fn
        self.fused_layer1 = fused_layer1
        self.conv1 = Conv(in_channels, 64, 7, stride=_stride(downsample, 2), padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        s1, s2 = _stride(downsample, 1), _stride(downsample, 0)
        self.layer1_0 = ResidualBlock(64, 64, norm_fn, stride=1)
        self.layer1_1 = ResidualBlock(64, 64, norm_fn, stride=1)
        self.layer2_0 = ResidualBlock(64, 96, norm_fn, stride=s1)
        self.layer2_1 = ResidualBlock(96, 96, norm_fn, stride=1)
        self.layer3_0 = ResidualBlock(96, 128, norm_fn, stride=s2)
        self.layer3_1 = ResidualBlock(128, 128, norm_fn, stride=1)

    def forward(self, x: torch.Tensor, test_mode: bool = False) -> torch.Tensor:
        x = self.conv1(x)
        if (self.fused_layer1 and test_mode and x.shape[3] % 2 == 0
                and self.norm_fn in ("instance", "batch")):
            x = self._fused_layer1(x)
        else:
            x = self.layer1_1(self.layer1_0(torch.relu(self.norm1(x))))
        for layer in (self.layer2_0, self.layer2_1, self.layer3_0, self.layer3_1):
            x = layer(x)
        return x

    def _fused_layer1(self, stem_y: torch.Tensor) -> torch.Tensor:
        """Stem norm + layer1 from the RAW stem output: the stem's norm is
        left pending and folded into the first conv's operand read (on a
        band with the whole image's statistics)."""
        b = stem_y.shape[0]
        batch_norm = self.norm_fn == "batch"
        if batch_norm:
            stem_aff = encoder_cuda.bn_affine(*self.norm1.affine(), b)
        else:
            stem_aff = encoder_cuda.instance_affine_from_stats(*encoder_cuda.band_stats(stem_y))
        blocks = []
        for blk in (self.layer1_0, self.layer1_1):
            affs = ((encoder_cuda.bn_affine(*blk.norm1.affine(), b),
                     encoder_cuda.bn_affine(*blk.norm2.affine(), b)) if batch_norm else (None, None))
            blocks.append((blk.conv1.weight, blk.conv1.bias, blk.conv2.weight, blk.conv2.bias, *affs))
        return encoder_cuda.fused_layer1(stem_y, stem_aff, blocks, self.norm_fn)


class BasicEncoder(nn.Module):
    """Correlation-feature encoder: trunk + 1x1 projection to `output_dim`."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance", downsample: int = 3,
                 in_channels: int = 3, fused_layer1: bool = False):
        super().__init__()
        self.trunk = EncoderTrunk(norm_fn, downsample, in_channels, fused_layer1)
        self.conv2 = Conv(128, output_dim, 1, padding=0)

    def forward(self, x: torch.Tensor, test_mode: bool = False) -> torch.Tensor:
        return self.conv2(self.trunk(x, test_mode))


class MultiBasicEncoder(nn.Module):
    """Context encoder: trunk + stride-2 layer4/layer5 + per-scale heads.

    Returns `num_layers` scales, finest first; each scale is a tuple of one
    tensor per entry of `output_dims`. `output_dims[j][2]` is the finest
    (1/2**downsample) width, `[j][1]` the next, `[j][0]` the coarsest.
    Layers a smaller `num_layers` never runs are not built.

    With `dual_inp` (the shared backbone) the input is the 2B batch
    [image1, image2]: the trunk runs on all of it (with `fused_layer1` the
    batch norm's fused layer1 over 2B images), the heads on the first B,
    and the trunk output (2B, 128, ...) is returned as well:
    (scales, trunk_out)."""

    def __init__(self, output_dims: Sequence[Tuple[int, ...]] = ((128, 128, 128), (128, 128, 128)),
                 norm_fn: str = "batch", downsample: int = 3, in_channels: int = 3,
                 num_layers: int = 3, fused_layer1: bool = False):
        super().__init__()
        self.n_heads = len(output_dims)
        self.num_layers = num_layers
        self.downsample = downsample
        self.trunk = EncoderTrunk(norm_fn, downsample, in_channels, fused_layer1)
        for j, dims in enumerate(output_dims):
            self.add_module(f"res08_{j}", ResidualBlock(128, 128, norm_fn, stride=1))
            self.add_module(f"out08_{j}", Conv(128, dims[2], 3))
        if num_layers >= 2:
            self.layer4_0 = ResidualBlock(128, 128, norm_fn, stride=2)
            self.layer4_1 = ResidualBlock(128, 128, norm_fn, stride=1)
            for j, dims in enumerate(output_dims):
                self.add_module(f"res16_{j}", ResidualBlock(128, 128, norm_fn, stride=1))
                self.add_module(f"out16_{j}", Conv(128, dims[1], 3))
        if num_layers >= 3:
            self.layer5_0 = ResidualBlock(128, 128, norm_fn, stride=2)
            self.layer5_1 = ResidualBlock(128, 128, norm_fn, stride=1)
            for j, dims in enumerate(output_dims):
                self.add_module(f"out32_{j}", Conv(128, dims[0], 3))

    def _heads(self, x, scale, with_res=True):
        mods = self._modules
        if with_res:
            return tuple(mods[f"out{scale}_{j}"](mods[f"res{scale}_{j}"](x)) for j in range(self.n_heads))
        return tuple(mods[f"out{scale}_{j}"](x) for j in range(self.n_heads))

    def forward(self, x: torch.Tensor, test_mode: bool = False, dual_inp: bool = False):
        x = self.trunk(x, test_mode)
        trunk_out = None
        if dual_inp:
            trunk_out = x
            x = x[: x.shape[0] // 2]
        scales = [self._heads(x, "08")]
        lv = self.downsample
        if self.num_layers >= 2:
            y = spatial.coarser(x, lv, lambda t: self.layer4_1(self.layer4_0(t)))
            with spatial.level(lv + 1):
                scales.append(self._heads(y, "16"))
        if self.num_layers >= 3:
            z = spatial.coarser(y, lv + 1, lambda t: self.layer5_1(self.layer5_0(t)))
            with spatial.level(lv + 2):
                scales.append(self._heads(z, "32", with_res=False))
        if dual_inp:
            return tuple(scales), trunk_out
        return tuple(scales)
