"""PyTorch-port geometry and padding against the JAX package (atol 1e-6).

The port's geometry is NCHW, the JAX package's NHWC; inputs are made once
with numpy and transposed at the boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.utils import geometry as jgeo
from raft_stereo_tpu.utils.padding import InputPadder as JPadder
from raft_stereo_tpu_torch.utils import geometry as tgeo
from raft_stereo_tpu_torch.utils.padding import InputPadder
from torch_parity import nchw, nhwc, torch_single_thread  # noqa: F401 (autouse fixture)

ATOL = 1e-6


def test_coords_grid_x():
    want = np.asarray(jgeo.coords_grid_x(2, 3, 5))
    np.testing.assert_array_equal(tgeo.coords_grid_x(2, 3, 5).numpy(), want)


def test_linear_sample_1d_in_and_out_of_range(rng):
    values = rng.standard_normal((2, 3, 17)).astype(np.float32)
    x = rng.uniform(-4, 21, (2, 3, 9)).astype(np.float32)
    x[0, 0, :3] = [0.0, 16.0, 15.5]  # exact ends and the last interval
    want = np.asarray(jgeo.linear_sample_1d(jnp.asarray(values), jnp.asarray(x)))
    got = tgeo.linear_sample_1d(torch.from_numpy(values), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw,out", [((6, 8), (12, 16)), ((3, 4), (6, 8)), ((7, 5), (4, 9)), ((1, 4), (2, 8))])
def test_resize_bilinear_align_corners(rng, hw, out):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jgeo.resize_bilinear_align_corners(jnp.asarray(x), *out))
    got = nhwc(tgeo.resize_bilinear_align_corners(nchw(x), *out))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(12, 16), (7, 9), (1, 2)])
def test_avg_pool2x(rng, hw):
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    want = np.asarray(jgeo.avg_pool2x(jnp.asarray(x)))
    got = nhwc(tgeo.avg_pool2x(nchw(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_extract_3x3_patches(rng):
    x = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    want = np.asarray(jgeo.extract_3x3_patches(jnp.asarray(x)))  # (B, H, W, 9, C)
    got = tgeo.extract_3x3_patches(nchw(x)).numpy()  # (B, C, 9, H, W)
    np.testing.assert_array_equal(got.transpose(0, 3, 4, 2, 1), want)


@pytest.mark.parametrize("factor", [4, 2])
def test_convex_upsample_and_blocked(rng, factor):
    field = rng.standard_normal((2, 6, 8, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 6, 8, 9 * factor * factor)).astype(np.float32)
    want = np.asarray(jgeo.convex_upsample(jnp.asarray(field), jnp.asarray(mask), factor))
    got = nhwc(tgeo.convex_upsample(nchw(field), nchw(mask), factor))
    np.testing.assert_allclose(got, want, atol=ATOL * factor, rtol=0)
    want_b = np.asarray(jgeo.convex_upsample_blocked(jnp.asarray(field), jnp.asarray(mask), factor))
    got_b = tgeo.convex_upsample_blocked(nchw(field), nchw(mask), factor).numpy()
    # port (B, C, H, f, W, f) -> JAX (B, H, f, W, f, C)
    np.testing.assert_allclose(got_b.transpose(0, 2, 3, 4, 5, 1), want_b, atol=ATOL * factor, rtol=0)


def test_resize_is_differentiable_after_an_inference_mode_call():
    """The interpolation matrices are cached per shape; one first built
    under `torch.inference_mode` (a serving or evaluation forward) must
    still serve a training forward at the same shapes afterwards."""
    x = torch.ones((1, 2, 5, 7))
    with torch.inference_mode():
        tgeo.resize_bilinear_align_corners(x, 11, 13)
    y = x.clone().requires_grad_()
    tgeo.resize_bilinear_align_corners(y, 11, 13).sum().backward()
    assert y.grad is not None and y.grad.shape == y.shape


@pytest.mark.parametrize(
    "dims,kwargs",
    [
        ((1, 50, 70, 3), {"target": (64, 96), "divis_by": 32}),
        ((1, 50, 70, 3), {"mode": "sintel", "divis_by": 8}),
        ((1, 50, 70, 3), {"mode": "kitti", "divis_by": 8}),
        ((1, 50, 70, 3), {"divis_by": 8, "bucket": 32}),
        ((1, 64, 96, 3), {"target": (64, 96), "divis_by": 32}),
    ],
)
def test_input_padder(rng, dims, kwargs):
    x = rng.uniform(0, 255, dims).astype(np.float32)
    jp, tp = JPadder(dims, **kwargs), InputPadder(dims, **kwargs)
    assert tp.pad_amounts == jp.pad_amounts
    # The serving front pads on the host with np.pad and these amounts.
    left, right, top, bottom = tp.pad_amounts
    got = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)), mode="edge")
    want = np.asarray(jp.pad(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # Evaluation pads on the device with InputPadder.pad, several tensors at once.
    a, b = tp.pad(torch.from_numpy(x), torch.from_numpy(x + 1.0))
    np.testing.assert_array_equal(a.numpy(), want)
    np.testing.assert_array_equal(b.numpy(), want + 1.0)
    np.testing.assert_array_equal(tp.unpad(torch.from_numpy(got)).numpy(), x)
    np.testing.assert_array_equal(tp.unpad(want), np.asarray(jp.unpad(jnp.asarray(want))))


def test_input_padder_rejects_small_or_misaligned_target():
    with pytest.raises(ValueError, match="smaller"):
        InputPadder((1, 70, 70, 3), target=(64, 96), divis_by=32)
    with pytest.raises(ValueError, match="multiple"):
        InputPadder((1, 50, 70, 3), target=(60, 96), divis_by=32)
