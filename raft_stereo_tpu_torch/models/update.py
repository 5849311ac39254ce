"""Iterative-refinement update block, NCHW: counterpart of
`raft_stereo_tpu/models/update.py`.

The flow field is 1-channel disparity as in the JAX package; the motion
encoder's output carries a zero plane in place of the always-zero flow-y
channel. The JAX package's segmented 3x3 convs (a sum of per-segment convs
that never materializes the concat) are a concat plus one conv here: the
same math up to rounding. Under mixed precision the block runs in bf16
(`layers.Conv` casts its fp32 parameters at use), where the difference is
larger: JAX rounds each per-segment partial to bf16 before the sum, the
concat conv rounds once. The flow head's output goes back to fp32 in the
model, which keeps the coordinates fp32.

With `fused_tail` (config.fused_gru_tail) the ConvGRU gate tail and the
motion encoder's relu + concat run as the CUDA kernels of `ops/gru_tail.py`
in a test-mode forward (`test_mode=True`) only, as the JAX model gates the
flag (`fused_tail=cfg.fused_gru_tail and test_mode`): the kernels have no
backward. r = sigmoid(convr + cr) stays in torch, and the tail kernel takes
the pre-activations zx and qx. Under mixed precision the kernels compute in
fp32 and round once to bf16, where the unfused bf16 formula
(`gru_tail.plain_gru_tail`) rounds after every op, so the fused and unfused
bf16 forwards differ by those roundings (fp32: bit for bit).

With `pallas_gates` (the experiment of `ops/gates.py`, switched on by its
environment variable in a test-mode forward) the ConvGRU's gating runs as
that module's two kernels instead: rh = sigmoid(rx + cr) * h before the
candidate conv, and the blend after it. The fused tail takes precedence
over it, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from raft_stereo_tpu_torch.models.layers import Conv
from raft_stereo_tpu_torch.ops import gates, gru_tail
from raft_stereo_tpu_torch.utils.geometry import avg_pool2x, resize_bilinear_align_corners


class FlowHead(nn.Module):
    """conv3x3 -> relu -> conv3x3 emitting `output_dim` (1) channels."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256, output_dim: int = 1):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden_dim, 3)
        self.conv2 = Conv(hidden_dim, output_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """Conv GRU cell with precomputed context biases (cz, cr, cq); `inputs`
    join `h` (or r*h for the candidate) on the channel axis."""

    def __init__(self, hidden_dim: int, input_dim: int, fused_tail: bool = False):
        super().__init__()
        self.fused_tail = fused_tail
        self.convz = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convr = Conv(hidden_dim + input_dim, hidden_dim, 3)
        self.convq = Conv(hidden_dim + input_dim, hidden_dim, 3)

    def forward(self, h, cz, cr, cq, *inputs, test_mode: bool = False, pallas_gates: bool = False):
        hx = torch.cat([h, *inputs], dim=1)
        if pallas_gates and not (self.fused_tail and test_mode):
            zx = self.convz(hx)
            rh = gates.fused_rh(self.convr(hx), cr, h)
            qx = self.convq(torch.cat([rh, *inputs], dim=1))
            return gates.fused_combine(zx, cz, qx, cq, h)
        r = torch.sigmoid(self.convr(hx) + cr)
        qx = self.convq(torch.cat([r * h, *inputs], dim=1))
        zx = self.convz(hx)
        if self.fused_tail and test_mode:
            return gru_tail.fused_gru_tail(zx, cz, qx, cq, h)
        return gru_tail.plain_gru_tail(zx, cz, qx, cq, h)


class BasicMotionEncoder(nn.Module):
    """Correlation taps + 1-channel flow -> 128 motion features:
    cat[relu(conv(...)) (126), flow (1), zeros (1)]."""

    def __init__(self, corr_channels: int, fused_tail: bool = False):
        super().__init__()
        self.fused_tail = fused_tail
        self.convc1 = Conv(corr_channels, 64, 1, padding=0)
        self.convc2 = Conv(64, 64, 3)
        self.convf1 = Conv(1, 64, 7)
        self.convf2 = Conv(64, 64, 3)
        self.conv = Conv(128, 126, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor, test_mode: bool = False) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        pre = self.conv(torch.cat([cor, flo], dim=1))
        if self.fused_tail and test_mode:
            return gru_tail.fused_motion_tail(pre, flow)
        return gru_tail.plain_motion_tail(pre, flow)


def _interp_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_align_corners(x, like.shape[2], like.shape[3])


class BasicMultiUpdateBlock(nn.Module):
    """1-3 coupled ConvGRUs across scales + flow head.

    `net` is the hidden-state tuple, finest first; `context` holds per-scale
    (cz, cr, cq). `hidden_dims[2]` is the finest scale's width. The
    iter08/iter16/iter32 flags give the slow_fast_gru schedule; with
    `update=False` only the hidden states advance. `test_mode` lets
    `fused_tail` take effect; `pallas_gates` reaches every ConvGRU."""

    def __init__(self, hidden_dims: Sequence[int], corr_channels: int, n_gru_layers: int,
                 n_downsample: int, fused_tail: bool = False):
        super().__init__()
        self.n_gru_layers = n = n_gru_layers
        self.encoder = BasicMotionEncoder(corr_channels, fused_tail=fused_tail)
        self.gru08 = ConvGRU(hidden_dims[2], 128 + (hidden_dims[1] if n > 1 else 0), fused_tail)
        if n >= 2:
            self.gru16 = ConvGRU(hidden_dims[1], hidden_dims[2] + (hidden_dims[0] if n == 3 else 0),
                                 fused_tail)
        if n == 3:
            self.gru32 = ConvGRU(hidden_dims[0], hidden_dims[1], fused_tail)
        self.flow_head = FlowHead(hidden_dims[2], 256, output_dim=1)

    def forward(
        self,
        net: Tuple[torch.Tensor, ...],
        context: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        corr: Optional[torch.Tensor] = None,
        flow: Optional[torch.Tensor] = None,
        iter08: bool = True,
        iter16: bool = True,
        iter32: bool = True,
        update: bool = True,
        test_mode: bool = False,
        pallas_gates: bool = False,
    ):
        net = list(net)
        n = self.n_gru_layers
        modes = {"test_mode": test_mode, "pallas_gates": pallas_gates}
        if iter32 and n == 3:
            net[2] = self.gru32(net[2], *context[2], avg_pool2x(net[1]), **modes)
        if iter16 and n >= 2:
            if n > 2:
                net[1] = self.gru16(net[1], *context[1], avg_pool2x(net[0]), _interp_to(net[2], net[1]),
                                    **modes)
            else:
                net[1] = self.gru16(net[1], *context[1], avg_pool2x(net[0]), **modes)
        if iter08:
            motion = self.encoder(flow, corr, test_mode=test_mode)
            if n > 1:
                net[0] = self.gru08(net[0], *context[0], motion, _interp_to(net[1], net[0]), **modes)
            else:
                net[0] = self.gru08(net[0], *context[0], motion, **modes)
        if not update:
            return tuple(net)
        return tuple(net), self.flow_head(net[0])


class UpsampleMaskHead(nn.Module):
    """Convex-upsampling mask head, applied once to the final hidden state:
    conv3x3 -> relu -> conv1x1 to 9 * f * f channels, scaled by 0.25."""

    def __init__(self, n_downsample: int, input_dim: int = 128):
        super().__init__()
        factor = 2**n_downsample
        self.mask_conv1 = Conv(input_dim, 256, 3)
        self.mask_conv2 = Conv(256, factor * factor * 9, 1, padding=0)

    def forward(self, net0: torch.Tensor) -> torch.Tensor:
        return 0.25 * self.mask_conv2(torch.relu(self.mask_conv1(net0)))
