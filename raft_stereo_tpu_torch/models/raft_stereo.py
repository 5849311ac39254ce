"""RAFT-Stereo forward on PyTorch, test and train mode: counterpart of
`raft_stereo_tpu/models/raft_stereo.py` (`encode_features`, `_corr_state`,
`_corr_sample`, `_IterationBody`, `RAFTStereo`, `sequential_batch_forward`).

Modules compute in NCHW; the public edges keep the JAX package's shapes:
images (B, H, W, C) in [0, 255]; in test mode `flow_lowres` (B, H/f, W/f)
and `flow_up` (B, H, W, 1); in train mode the per-iteration upsampled
flows in the blocked layout (iters, B, H/f, f, W/f, f). The refinement loop
is a Python loop over `iteration_step`, and the serving tier's chunked
forward (models/anytime.py) is built from the same three functions as the
test-mode `RAFTStereo.forward`, so both agree exactly.

With `mixed_precision` the forward keeps the JAX package's dtype
boundaries: the images are normalized in fp32 and then cast to bf16, the
encoders and the update block run in bf16 on fp32 parameters cast at use,
the correlation state is built from the feature maps widened to fp32 (by
`corr_dtype`'s contract), the taps and the flow enter the update block in
bf16, the coordinates stay fp32 (`coords1 += delta_flow` widened), and the
mask goes back to fp32 before the convex upsample, in both modes. Training
keeps the same boundaries: with "pallas" the lookup kernel stores the taps
in bf16 and they are saved in bf16 across the remat, the flows the loss
reads are fp32, and the lookup's backward (`ops/corr_cuda.py` `CorrLookup`)
returns d(pyramid) in the pyramid's dtype.

The training forward detaches the coordinates at the start of every
iteration, as JAX's `stop_gradient` does, and with `remat_iterations` runs
each iteration body under `torch.utils.checkpoint`; with `remat_save_corr`
the lookup stays outside it, so the taps are saved and the lookup kernel
never runs again in backward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import Conv, ResidualBlock
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock, UpsampleMaskHead
from raft_stereo_tpu_torch.ops import corr as corr_ops
from raft_stereo_tpu_torch.ops import corr_cuda, gates
from raft_stereo_tpu_torch.utils.geometry import convex_upsample, convex_upsample_blocked, coords_grid_x


def corr_state(cfg: RAFTStereoConfig, fmap1: torch.Tensor, fmap2: torch.Tensor, test_mode: bool):
    """Loop-invariant correlation state from NCHW feature maps. "alt":
    (fmap1 (B, H, W1, D), (level_0, ..., level_{L-1})), the left features
    and the pooled right ones (B, H, W2 // 2**l, D), fp32 whatever
    `corr_dtype` says, as in JAX. "reg" and "pallas": the pooled
    pyramid, (B, H, W1, W2 // 2**l) per level in `corr_dtype`; with
    "pallas" and `fused_encoder` in test mode built by one kernel (as in JAX, the flag leaves the "reg" pyramid to the plain ops).
    In train mode the "pallas" pyramid is the plain volume and pooling, so
    autograd reaches the feature maps through them, as JAX's autodiff does
    through `pallas_corr_state`. bf16 maps are taken as fp32 values, as the
    JAX model widens them (the kernel reads bf16 maps of a bf16 pyramid in
    place: the same values)."""
    f1 = fmap1.permute(0, 2, 3, 1)
    f2 = fmap2.permute(0, 2, 3, 1)
    corr_dtype = torch.bfloat16 if cfg.corr_dtype == "bfloat16" else torch.float32
    if cfg.corr_implementation == "alt":
        f1 = (f1.float() if f1.dtype == torch.bfloat16 else f1).contiguous()
        return f1, tuple(corr_ops.pool_fmap_levels(f2, cfg.corr_levels))
    if cfg.corr_implementation == "pallas":
        if cfg.fused_encoder and test_mode:
            return corr_cuda.fused_pyramid_state(f1, f2, cfg.corr_levels, corr_dtype)
        return corr_cuda.corr_state(f1, f2, cfg.corr_levels, corr_dtype)
    return tuple(corr_ops.corr_pyramid(corr_ops.corr_volume(f1, f2, corr_dtype), cfg.corr_levels))


def corr_sample(cfg: RAFTStereoConfig, state, coords: torch.Tensor, prefetch: bool = False) -> torch.Tensor:
    """Correlation taps at `coords` (B, H, W1) -> NCHW (B, L*(2r+1), H, W1),
    in the compute dtype (bf16 under `mixed_precision`: the lookup kernels
    store them so; the "reg" lookup's fp32 taps are cast). `prefetch` (the
    test-mode `prefetch_lookup` strategy) takes the windowed lookup kernel in
    place of the dense one for "pallas", in the same dtypes; it has no
    backward, so callers keep it out of training forwards."""
    out_dtype = torch.bfloat16 if cfg.mixed_precision else None
    if cfg.corr_implementation == "pallas":
        if prefetch:
            taps = corr_cuda.prefetch_corr_lookup(state, coords, cfg.corr_radius, out_dtype)
        else:
            taps = corr_cuda.corr_lookup(state, coords, cfg.corr_radius, out_dtype)
    elif cfg.corr_implementation == "alt":
        f1, levels = state
        taps = corr_ops.corr_lookup_alt(f1, levels, coords, cfg.corr_radius)
    else:
        taps = corr_ops.corr_lookup(state, coords, cfg.corr_radius)
    if out_dtype is not None:
        taps = taps.to(out_dtype)
    return taps.permute(0, 3, 1, 2).contiguous()


class RAFTStereo(nn.Module):
    """Full model. Submodule names follow the JAX parameter tree ("cnet",
    "fnet", "context_zqr_conv{i}", "update_block", "mask_head"; under
    `shared_backbone` "conv2_res" and "conv2_out" in place of "fnet")."""

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
        if cfg.shared_backbone:
            # The correlation head on the shared trunk (the JAX package's
            # nn.Sequential of these two, named as there).
            self.conv2_res = ResidualBlock(128, 128, "instance", stride=1)
            self.conv2_out = Conv(128, 256, 3)
        else:
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

    def encode_features(self, image1: torch.Tensor, image2: torch.Tensor, test_mode: bool) -> dict:
        """Everything before the first GRU iteration: normalization, both
        encoders (under `shared_backbone` the context encoder's trunk on
        both images, its heads on image1, and `conv2_res` + `conv2_out` on
        the trunk for the feature maps), the context biases, the
        correlation state and the coordinate grid. Returns the refinement
        state dict
        {"net", "coords1", "context", "corr", "coords0"}, coords1 == coords0."""
        cfg = self.config
        image1 = (2.0 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
        image2 = (2.0 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2).contiguous()
        # The coordinates keep the images' dtype (fp32; float64 in a float64
        # copy of the model); the encoders take the compute dtype.
        coords_dtype = image1.dtype
        if cfg.mixed_precision:
            image1, image2 = image1.to(torch.bfloat16), image2.to(torch.bfloat16)
        if cfg.shared_backbone:
            scales, trunk = self.cnet(torch.cat([image1, image2], dim=0), test_mode, dual_inp=True)
            fmaps = self.conv2_out(self.conv2_res(trunk))
        else:
            scales = self.cnet(image1, test_mode)
            if cfg.sequential_encoder and image1.shape[0] > 1:
                # One image at a time over [image1, image2], in that order
                # (the JAX package's scan over the stacked batch).
                fmaps = torch.cat([self.fnet(img[None], test_mode) for img in torch.cat([image1, image2])])
            elif cfg.sequential_encoder:
                # The JAX package's B=1 form: its scalar anchor orders the
                # two passes there; eager PyTorch runs them in order anyway,
                # and the anchor keeps the values JAX's.
                fmap1 = self.fnet(image1, test_mode)
                anchor = (fmap1.reshape(-1)[0] * 1e-30).to(image2.dtype)
                fmaps = torch.cat([fmap1, self.fnet(image2 + anchor, test_mode)])
            else:
                fmaps = self.fnet(torch.cat([image1, image2], dim=0), test_mode)
        fmap1, fmap2 = torch.chunk(fmaps, 2, dim=0)

        net = tuple(torch.tanh(s[0]) for s in scales)
        context = []
        for i, s in enumerate(scales):
            czqr = self._modules[f"context_zqr_conv{i}"](torch.relu(s[1]))
            # Contiguous once here: the GRU tail kernel takes contiguous
            # operands, and the context is loop-invariant.
            context.append(tuple(c.contiguous() for c in torch.chunk(czqr, 3, dim=1)))

        b, _, h, w = net[0].shape
        coords0 = coords_grid_x(b, h, w, device=net[0].device, dtype=coords_dtype)
        return {
            "net": net,
            "coords1": coords0,
            "context": tuple(context),
            "corr": corr_state(cfg, fmap1, fmap2, test_mode),
            "coords0": coords0,
        }

    def iteration_step(self, state: dict) -> dict:
        """One test-mode GRU refinement step: lookup, motion encoder, GRUs,
        flow head."""
        net, coords1 = self._update(state, state["net"], state["coords1"].detach(), None, test_mode=True)
        return dict(state, net=net, coords1=coords1)

    def _update(self, state: dict, net, coords1: torch.Tensor, corr: Optional[torch.Tensor],
                test_mode: bool):
        """The iteration body from (net, coords1) to the next (net, coords1);
        the lookup runs here unless its taps `corr` are given. The kernels
        without a backward act only in test mode, as in JAX: the windowed
        lookup (`prefetch_lookup`) and the gate pair (`ops/gates.py`,
        switched on by its environment variable, read on every call; on CPU
        tensors its wrappers run the plain versions), at fp32 or bf16. The
        flow enters the update block in the compute dtype, as in JAX."""
        cfg = self.config
        context = state["context"]
        pallas_gates = gates.enabled() and test_mode
        if corr is None:
            corr = corr_sample(cfg, state["corr"], coords1, prefetch=cfg.prefetch_lookup and test_mode)
        flow = (coords1 - state["coords0"])[:, None]
        if cfg.mixed_precision:
            flow = flow.to(torch.bfloat16)
        n = cfg.n_gru_layers
        modes = {"test_mode": test_mode, "pallas_gates": pallas_gates}
        if cfg.slow_fast_gru and n == 3:
            net = self.update_block(net, context, iter32=True, iter16=False, iter08=False, update=False, **modes)
        if cfg.slow_fast_gru and n >= 2:
            net = self.update_block(net, context, iter32=n == 3, iter16=True, iter08=False, update=False,
                                    **modes)
        net, delta_flow = self.update_block(net, context, corr, flow, iter32=n == 3, iter16=n >= 2, **modes)
        return net, coords1 + delta_flow[:, 0].to(coords1.dtype)

    def finalize(self, state: dict):
        """Mask head + convex upsample on the current state:
        (flow_lowres (B, h, w), flow_up (B, H, W, 1))."""
        flow_lowres = state["coords1"] - state["coords0"]
        mask = self.mask_head(state["net"][0]).to(flow_lowres.dtype)
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
                flow_init: Optional[torch.Tensor] = None, test_mode: bool = False):
        """test_mode=True: (flow_lowres (B, h, w), flow_up (B, H, W, 1)).
        test_mode=False: the per-iteration upsampled flows, blocked
        (iters, B, h, f, w, f) with element [it, b, y, i, x, j] at full-res
        pixel (y*f + i, x*f + j) (`utils.geometry.unblock_predictions` gives
        the row-major (iters, B, H, W, 1) stack)."""
        state = self.apply_flow_init(self.encode_features(image1, image2, test_mode), flow_init)
        if test_mode:
            for _ in range(iters):
                state = self.iteration_step(state)
            return self.finalize(state)
        return self._train_iterations(state, iters)

    def _train_iterations(self, state: dict, iters: int) -> torch.Tensor:
        """The training refinement loop, then the mask head once over the
        stacked per-iteration hidden states and the convex upsample of every
        iteration's flow (the JAX model's batched form after its scan)."""
        cfg = self.config
        remat = cfg.remat_iterations
        lookup_outside = not remat or cfg.remat_save_corr
        net, coords1 = state["net"], state["coords1"]
        flows, net0s = [], []
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_sample(cfg, state["corr"], coords1) if lookup_outside else None
            if remat:
                net, coords1 = checkpoint(self._update, state, net, coords1, corr, test_mode=False,
                                          use_reentrant=False)
            else:
                net, coords1 = self._update(state, net, coords1, corr, test_mode=False)
            flows.append(coords1 - state["coords0"])
            net0s.append(net[0])
        b, h, w = coords1.shape
        f = cfg.downsample_factor
        mask = self.mask_head(torch.cat(net0s, dim=0)).to(coords1.dtype)
        up = convex_upsample_blocked(torch.cat(flows, dim=0)[:, None], mask, f)
        return up.reshape(iters, b, h, f, w, f)


def sequential_batch_forward(model: RAFTStereo, image1: torch.Tensor, image2: torch.Tensor, iters: int = 32):
    """Test-mode inference over a batch as a loop of single-pair forwards
    (the JAX package's `sequential_batch_forward`): each map is its batch-1
    forward's, bit for bit, and peak memory stays at one pair's whatever
    the batch. Images (B, H, W, C); returns (flow_lowres (B, h, w),
    flow_up (B, H, W, 1))."""
    lows, ups = [], []
    with torch.inference_mode():
        for i in range(image1.shape[0]):
            lo, up = model(image1[i : i + 1], image2[i : i + 1], iters=iters, test_mode=True)
            lows.append(lo)
            ups.append(up)
    return torch.cat(lows), torch.cat(ups)
