"""PyTorch-port GRU tail and motion tail against the JAX Pallas kernels
(`ops/gru_tail_pallas.py`, interpret mode on the CPU), tolerance 1e-6.

The JAX kernels are NHWC, the port's motion tail is NCHW; the GRU tail is
elementwise. Row counts include one that is not a multiple of the TPU
kernel's 1024-row block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.ops import gru_tail_pallas
from raft_stereo_tpu_torch.ops import gru_tail
from torch_parity import nchw, nhwc, torch_single_thread  # noqa: F401 (autouse fixture)

TOL = 1e-6


@pytest.mark.parametrize("shape", [(1, 12, 16, 32), (2, 7, 9, 128), (1, 40, 30, 8)])
def test_gru_tail_matches_pallas_interpret(rng, shape):
    ops = [(2 * rng.standard_normal(shape)).astype(np.float32) for _ in range(5)]
    want = np.asarray(gru_tail_pallas.fused_gru_tail(*[jnp.asarray(a) for a in ops]))
    before = dict(gru_tail.LAUNCHES)
    got = gru_tail.fused_gru_tail(*[nchw(a) for a in ops])
    np.testing.assert_allclose(nhwc(got), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(
        nhwc(gru_tail.plain_gru_tail(*[nchw(a) for a in ops])), want, atol=TOL, rtol=0
    )
    assert gru_tail.LAUNCHES == before  # CPU tensors: the plain version ran


@pytest.mark.parametrize("shape", [(1, 12, 16), (2, 7, 9), (1, 40, 30)])
def test_motion_tail_matches_pallas_interpret(rng, shape):
    pre = rng.standard_normal((*shape, 126)).astype(np.float32)
    flow = rng.standard_normal((*shape, 1)).astype(np.float32)
    want = np.asarray(gru_tail_pallas.fused_motion_tail(jnp.asarray(pre), jnp.asarray(flow)))
    got = gru_tail.fused_motion_tail(nchw(pre), nchw(flow))
    assert got.shape == (shape[0], 128, *shape[1:])
    np.testing.assert_allclose(nhwc(got), want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[:, 127].numpy(), 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(12, 16), (7, 9)])  # vector and scalar kernel paths
def test_kernels_match_plain_on_cuda(rng, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tail kernels have no CPU form")
    ops = [torch.from_numpy(2 * rng.standard_normal((2, 32, *hw)).astype(np.float32)).cuda() for _ in range(5)]
    got = gru_tail.fused_gru_tail(*ops).cpu().numpy()
    np.testing.assert_allclose(got, gru_tail.plain_gru_tail(*ops).cpu().numpy(), atol=TOL, rtol=0)
    pre = torch.from_numpy(rng.standard_normal((2, 126, *hw)).astype(np.float32)).cuda()
    flow = torch.from_numpy(rng.standard_normal((2, 1, *hw)).astype(np.float32)).cuda()
    got = gru_tail.fused_motion_tail(pre, flow)
    np.testing.assert_array_equal(got.cpu().numpy(), gru_tail.plain_motion_tail(pre, flow).cpu().numpy())
    with pytest.raises(ValueError, match="contiguous"):
        gru_tail.fused_gru_tail(*[o.transpose(2, 3) for o in ops])
