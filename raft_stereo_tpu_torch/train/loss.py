"""Sequence loss and metrics: counterpart of `raft_stereo_tpu/train/loss.py`.

An exponentially weighted L1 over the per-iteration disparity predictions,
with the reference's gamma adjustment `gamma ** (15 / (n - 1))` so the
effective decay does not depend on the iteration count, masked to valid
pixels with |gt| < max_flow, as a masked sum over the mask's count (the
JAX package's shape-static form of the reference's boolean indexing).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: torch.Tensor,
    loss_gamma: float = 0.9,
    max_flow: float = 700.0,
    count: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: (iters, B, H, W, 1) row-major, or the train-mode model's
    blocked (iters, B, H/f, f, W/f, f), in which case the ground truth and
    the mask are reshaped into that layout (a view) instead; flow_gt
    (B, H, W, 1); valid (B, H, W), >= 0.5 is valid.

    Returns (loss, metrics) with the reference's epe/1px/3px/5px metrics
    over the final prediction; every value is a 0-dim fp32 tensor.

    `count` replaces the mask's own count in every denominator: a rank of
    a data-parallel step passes the global batch's count
    (`valid_count` all-reduced), so the ranks' values add up to the global
    batch's."""
    n_predictions = flow_preds.shape[0]
    gt = flow_gt[..., 0]
    if flow_preds.dim() == 6:
        _, b, hb, f1, wb, f2 = flow_preds.shape
        gt = gt.reshape(b, hb, f1, wb, f2)
        valid = valid.reshape(b, hb, f1, wb, f2)
        preds = flow_preds
    else:
        preds = flow_preds[..., 0]
    mask = (valid >= 0.5) & (gt.abs() < max_flow)
    mask_f = mask.float()
    denom = torch.clamp(mask_f.sum() if count is None else count, min=1.0)

    adjusted_gamma = loss_gamma ** (15.0 / (n_predictions - 1)) if n_predictions > 1 else loss_gamma
    # Weight of prediction i: gamma^(n-1-i), in fp32 as the JAX package takes it.
    exponents = torch.arange(n_predictions - 1, -1, -1, dtype=torch.float32, device=preds.device)
    # torch.full, not torch.tensor: filled on the device, no copy from the host.
    weights = torch.full((), adjusted_gamma, dtype=torch.float32, device=preds.device) ** exponents

    abs_err = (preds - gt[None]).abs()
    per_iter = (abs_err * mask_f[None]).sum(dim=tuple(range(1, abs_err.dim()))) / denom
    flow_loss = (weights * per_iter).sum()

    epe = (preds[-1] - gt).abs()
    metrics = {
        "epe": (epe * mask_f).sum() / denom,
        "1px": ((epe < 1) & mask).sum() / denom,
        "3px": ((epe < 3) & mask).sum() / denom,
        "5px": ((epe < 5) & mask).sum() / denom,
    }
    return flow_loss, metrics


def valid_count(flow_gt: torch.Tensor, valid: torch.Tensor, max_flow: float = 700.0) -> torch.Tensor:
    """The number of pixels `sequence_loss` averages over: valid and with
    |gt| < max_flow (a 0-dim fp32 tensor)."""
    return ((valid >= 0.5) & (flow_gt[..., 0].abs() < max_flow)).float().sum()
