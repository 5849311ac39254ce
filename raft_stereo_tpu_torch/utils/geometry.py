"""Tensor utilities of the forward pass, PyTorch counterpart of
`raft_stereo_tpu/utils/geometry.py`.

Inside a band scope (parallel/spatial.py) `avg_pool2x` and
`extract_3x3_patches` take their row halo from the neighbouring bands, and
`resize_bilinear_align_corners(..., rows=)` computes a band of the output
rows from a whole input.

Layout: the JAX functions are NHWC; these take the NCHW tensors the port's
modules carry (`coords_grid_x` and `linear_sample_1d` have no channel axis
and keep the JAX shapes).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.parallel import spatial


def coords_grid_x(batch: int, height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Base x-coordinate grid, (B, H, W). Stereo matching is 1D, so only the
    x grid is carried."""
    xs = torch.arange(width, dtype=dtype, device=device)
    return xs[None, None, :].expand(batch, height, width).contiguous()


def linear_sample_1d(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate `values` (..., W) at positions `x` (..., K);
    leading dims agree. Each of the two taps contributes zero outside
    [0, W-1] (grid_sample align_corners=True, zero padding)."""
    w = values.shape[-1]
    x0f = torch.floor(x)
    frac = x - x0f
    x0 = x0f.long()
    x1 = x0 + 1

    def tap(idx, weight):
        valid = (idx >= 0) & (idx <= w - 1)
        gathered = torch.gather(values, -1, idx.clamp(0, w - 1))
        return gathered * (weight * valid.float())

    return tap(x0, 1.0 - frac) + tap(x1, frac)


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """(n_out, n_in) align-corners interpolation matrix: row o holds
    1 - frac and frac at the two samples around position o * (n_in - 1) /
    (n_out - 1), as in the JAX package. Built outside inference mode even
    when first asked for inside it: the cached matrix also serves training
    forwards, and autograd cannot save an inference tensor."""
    with torch.inference_mode(False):
        return _build_interp_matrix(n_in, n_out, device)


def _build_interp_matrix(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    m = torch.zeros((n_out, n_in), dtype=torch.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return _to_device(m, device)
    # Positions in float32 exactly as XLA evaluates the JAX package's
    # linspace(0, n_in - 1, n_out): ((n_in - 1) * (1 / (n_out - 1))) * o.
    recip = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(n_out - 1))
    scale = torch.tensor(float(n_in - 1)) * recip
    pos = torch.arange(n_out, dtype=torch.float32) * scale
    pos[-1] = n_in - 1.0
    i0 = torch.clamp(torch.floor(pos).long(), 0, n_in - 2)
    frac = pos - i0.float()
    o = torch.arange(n_out)
    m.index_put_((o, i0), 1.0 - frac, accumulate=True)
    m.index_put_((o, i0 + 1), frac, accumulate=True)
    return _to_device(m, device)


def _to_device(m: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host matrix on `device`; onto a card from pinned memory without
    blocking the host (its first use may fall inside a training step,
    which makes no sync)."""
    if torch.device(device).type != "cuda":
        return m.to(device)
    return m.pin_memory().to(device, non_blocking=True)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int, rows: slice = None) -> torch.Tensor:
    """Bilinear resize with align_corners=True, NCHW -> (B, C, out_h, out_w),
    as separable products with 2-banded interpolation matrices (the JAX
    package's formulation; `F.interpolate` places samples differently in
    the last bits). `rows` keeps only those output rows (a band's: the
    band's rows of the row matrix, the same sums)."""
    in_h, in_w = x.shape[-2:]
    if rows is not None:
        x = torch.matmul(_interp_matrix(in_h, out_h, x.device)[rows].to(x.dtype), x)
    elif in_h != out_h:
        x = torch.matmul(_interp_matrix(in_h, out_h, x.device).to(x.dtype), x)
    if in_w != out_w:
        x = torch.matmul(x, _interp_matrix(in_w, out_w, x.device).to(x.dtype).t())
    return x


def upsample_bilinear_scaled(field: torch.Tensor, factor: int) -> torch.Tensor:
    """Bilinear `factor`-x upsample (align corners) that also scales the
    values by `factor`, NCHW (B, C, h, w) -> (B, C, h * factor, w *
    factor): the JAX package's generalization of the reference's `upflow8`
    to any downsample factor."""
    h, w = field.shape[-2:]
    return factor * resize_bilinear_align_corners(field, h * factor, w * factor)


def avg_pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 average pool, zero padding 1, divisor always 9, NCHW.
    On a band: 1 halo row above, the columns zero-padded, no row padding
    (the halo's zero row at the image's top is the padding)."""
    scope = spatial.banded()
    if scope is None:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    x = F.pad(scope.halo_rows(x, *spatial.conv_halo(3, 2, 1)), (1, 1))
    return F.avg_pool2d(x, 3, stride=2, padding=0)


def extract_3x3_patches(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 neighbourhoods: (B, C, H, W) -> (B, C, 9, H, W), taps
    in (ky, kx) row-major order (the JAX function's axis 3). On a band: a
    halo row on each side, only the columns padded."""
    b, c, h, w = x.shape
    scope = spatial.banded()
    if scope is None:
        return F.unfold(x, (3, 3), padding=1).view(b, c, 9, h, w)
    return F.unfold(scope.halo_rows(x, 1, 1), (3, 3), padding=(0, 1)).view(b, c, 9, h, w)


def convex_upsample_blocked(field: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    """`convex_upsample` before the final reshape: (B, C, H, f, W, f) with
    out[b, c, h, i, w, j] == upsampled[b, c, h*f+i, w*f+j]."""
    b, c, h, w = field.shape
    weights = torch.softmax(mask.view(b, 1, 9, factor, factor, h, w), dim=2)
    patches = extract_3x3_patches(field * factor).view(b, c, 9, 1, 1, h, w)
    up = (weights * patches).sum(dim=2)  # (B, C, f, f, H, W)
    return up.permute(0, 1, 4, 2, 5, 3)


def convex_upsample(field: torch.Tensor, mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Convex-combination upsampling of a low-res field, NCHW.

    field (B, C, H, W); mask (B, 9*f*f, H, W) raw logits whose channels are
    ordered (9, f, f) fastest-last. Each fine pixel is the softmax-weighted
    combination of the 3x3 coarse neighbourhood of `field * f`. Returns
    (B, C, H*f, W*f)."""
    b, c, h, w = field.shape
    return convex_upsample_blocked(field, mask, factor).reshape(b, c, h * factor, w * factor)


def unblock_predictions(flows: torch.Tensor) -> torch.Tensor:
    """(iters, B, H/f, f, W/f, f) blocked prediction stack (the train-mode
    model output) -> (iters, B, H, W, 1) row-major full resolution: a pure
    reshape."""
    it, b, hb, f1, wb, f2 = flows.shape
    return flows.reshape(it, b, hb * f1, wb * f2, 1)
