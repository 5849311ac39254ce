"""RAFT-Stereo test-mode forward on PyTorch: counterpart of
`raft_stereo_tpu/models/raft_stereo.py` (`encode_features`, `_corr_state`,
`_corr_sample`, `_IterationBody`, `RAFTStereo(test_mode=True)`).

Modules compute in NCHW; the public edges keep the JAX package's shapes:
images (B, H, W, C) in [0, 255], `flow_lowres` (B, H/f, W/f) and `flow_up`
(B, H, W, 1). The refinement loop is a Python loop over `iteration_step`,
and the serving tier's chunked forward (models/anytime.py) is built from
the same three functions as `RAFTStereo.forward`, so both agree exactly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import Conv
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock, UpsampleMaskHead
from raft_stereo_tpu_torch.ops import corr as corr_ops
from raft_stereo_tpu_torch.ops import corr_cuda
from raft_stereo_tpu_torch.utils.geometry import convex_upsample, coords_grid_x


def corr_state(cfg: RAFTStereoConfig, fmap1: torch.Tensor, fmap2: torch.Tensor):
    """Loop-invariant correlation state from NCHW feature maps: the pooled
    pyramid, (B, H, W1, W2 // 2**l) per level, for both strategies; with
    "pallas" and `fused_encoder` built by one kernel (as in JAX, the flag
    leaves the "reg" pyramid to the plain ops)."""
    f1 = fmap1.permute(0, 2, 3, 1)
    f2 = fmap2.permute(0, 2, 3, 1)
    if cfg.corr_implementation == "pallas":
        if cfg.fused_encoder:
            return corr_cuda.fused_pyramid_state(f1, f2, cfg.corr_levels)
        return corr_cuda.corr_state(f1, f2, cfg.corr_levels)
    return tuple(corr_ops.corr_pyramid(corr_ops.corr_volume(f1, f2), cfg.corr_levels))


def corr_sample(cfg: RAFTStereoConfig, state, coords: torch.Tensor) -> torch.Tensor:
    """Correlation taps at `coords` (B, H, W1) -> NCHW (B, L*(2r+1), H, W1)."""
    if cfg.corr_implementation == "pallas":
        taps = corr_cuda.corr_lookup(state, coords, cfg.corr_radius)
    else:
        taps = corr_ops.corr_lookup(state, coords, cfg.corr_radius)
    return taps.permute(0, 3, 1, 2).contiguous()


class RAFTStereo(nn.Module):
    """Full model, test mode. Submodule names follow the JAX parameter tree
    ("cnet", "fnet", "context_zqr_conv{i}", "update_block", "mask_head")."""

    # utils/checkpoints.py: the JAX package scans the update block under
    # the module "iteration".
    flax_scopes = {"update_block": ("iteration", "update_block")}

    def __init__(self, config: RAFTStereoConfig):
        super().__init__()
        self.config = cfg = config
        self.cnet = MultiBasicEncoder(
            output_dims=(tuple(cfg.hidden_dims), tuple(cfg.context_dims)),
            norm_fn="batch", downsample=cfg.n_downsample, in_channels=cfg.in_channels,
            num_layers=cfg.n_gru_layers, fused_layer1=cfg.fused_encoder,
        )
        self.fnet = BasicEncoder(
            output_dim=256, norm_fn="instance", downsample=cfg.n_downsample,
            in_channels=cfg.in_channels, fused_layer1=cfg.fused_encoder,
        )
        # Scale i (finest first) feeds a GRU of width hidden_dims[2 - i].
        for i in range(cfg.n_gru_layers):
            width = cfg.hidden_dims[2 - i]
            self.add_module(f"context_zqr_conv{i}", Conv(cfg.context_dims[2 - i], width * 3, 3))
        self.update_block = BasicMultiUpdateBlock(
            cfg.hidden_dims, cfg.corr_channels, cfg.n_gru_layers, cfg.n_downsample,
            fused_tail=cfg.fused_gru_tail,
        )
        self.mask_head = UpsampleMaskHead(cfg.n_downsample, cfg.hidden_dims[2])

    def encode_features(self, image1: torch.Tensor, image2: torch.Tensor) -> dict:
        """Everything before the first GRU iteration: normalization, both
        encoders, the context biases, the correlation state and the
        coordinate grid. Returns the refinement state dict
        {"net", "coords1", "context", "corr", "coords0"}, coords1 == coords0."""
        cfg = self.config
        image1 = (2.0 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
        image2 = (2.0 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
        scales = self.cnet(image1)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1, fmap2 = torch.chunk(fmaps, 2, dim=0)

        net = tuple(torch.tanh(s[0]) for s in scales)
        context = []
        for i, s in enumerate(scales):
            czqr = self._modules[f"context_zqr_conv{i}"](torch.relu(s[1]))
            # Contiguous once here: the GRU tail kernel takes contiguous
            # operands, and the context is loop-invariant.
            context.append(tuple(c.contiguous() for c in torch.chunk(czqr, 3, dim=1)))

        b, _, h, w = net[0].shape
        coords0 = coords_grid_x(b, h, w, device=net[0].device)
        return {
            "net": net,
            "coords1": coords0,
            "context": tuple(context),
            "corr": corr_state(cfg, fmap1, fmap2),
            "coords0": coords0,
        }

    def iteration_step(self, state: dict) -> dict:
        """One GRU refinement step: lookup, motion encoder, GRUs, flow head."""
        cfg = self.config
        net, coords1, context = state["net"], state["coords1"], state["context"]
        corr = corr_sample(cfg, state["corr"], coords1)
        flow = (coords1 - state["coords0"])[:, None]
        n = cfg.n_gru_layers
        if cfg.slow_fast_gru and n == 3:
            net = self.update_block(net, context, iter32=True, iter16=False, iter08=False, update=False)
        if cfg.slow_fast_gru and n >= 2:
            net = self.update_block(net, context, iter32=n == 3, iter16=True, iter08=False, update=False)
        net, delta_flow = self.update_block(net, context, corr, flow, iter32=n == 3, iter16=n >= 2)
        return dict(state, net=net, coords1=coords1 + delta_flow[:, 0])

    def finalize(self, state: dict):
        """Mask head + convex upsample on the current state:
        (flow_lowres (B, h, w), flow_up (B, H, W, 1))."""
        flow_lowres = state["coords1"] - state["coords0"]
        mask = self.mask_head(state["net"][0])
        flow_up = convex_upsample(flow_lowres[:, None], mask, self.config.downsample_factor)
        return flow_lowres, flow_up.permute(0, 2, 3, 1)

    @staticmethod
    def apply_flow_init(state: dict, flow_init: Optional[torch.Tensor]) -> dict:
        """Warm start: coords1 = coords0 + flow_init ((B, h, w) or (B, h, w, 1))."""
        if flow_init is None:
            return state
        if flow_init.dim() == 4:
            flow_init = flow_init[..., 0]
        return dict(state, coords1=state["coords1"] + flow_init)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12,
                flow_init: Optional[torch.Tensor] = None):
        state = self.apply_flow_init(self.encode_features(image1, image2), flow_init)
        for _ in range(iters):
            state = self.iteration_step(state)
        return self.finalize(state)
