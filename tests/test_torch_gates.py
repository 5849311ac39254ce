"""PyTorch-port ConvGRU gate pair (`ops/gates.py`) against the JAX Pallas
kernels (`ops/gates_pallas.py` `fused_rh`, `fused_combine`, interpret mode
on the CPU), tolerance 1e-6.

The JAX kernels take NHWC rows in 1024-row blocks; the shapes are the three
GRU scales (1/4, 1/8, 1/16) of a 512x512 image at the GRU width 128, so
every row count is a whole number of blocks. The port's wrappers take NCHW
and, on CPU tensors, run their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.ops import gates_pallas
from raft_stereo_tpu_torch.ops import gates, gru_tail
from torch_parity import nchw, nhwc, torch_single_thread  # noqa: F401 (autouse fixture)

TOL = 1e-6
SCALES = {"1/4": (1, 128, 128, 128), "1/8": (1, 64, 64, 128), "1/16": (1, 32, 32, 128)}


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_gates_match_pallas_interpret(rng, scale):
    shape = SCALES[scale]
    rx, cr, h, zx, cz, qx, cq = [(2 * rng.standard_normal(shape)).astype(np.float32) for _ in range(7)]
    before = dict(gates.LAUNCHES)
    want_rh = np.asarray(gates_pallas.fused_rh(*map(jnp.asarray, (rx, cr, h))))
    got_rh = gates.fused_rh(*map(nchw, (rx, cr, h)))
    np.testing.assert_allclose(nhwc(got_rh), want_rh, atol=TOL, rtol=0)
    want = np.asarray(gates_pallas.fused_combine(*map(jnp.asarray, (zx, cz, qx, cq, h))))
    got = gates.fused_combine(*map(nchw, (zx, cz, qx, cq, h)))
    np.testing.assert_allclose(nhwc(got), want, atol=TOL, rtol=0)
    # CPU tensors: the plain versions ran, no launch was counted; combine is
    # the GRU tail's function.
    assert gates.LAUNCHES == before
    assert torch.equal(got, gru_tail.plain_gru_tail(*map(nchw, (zx, cz, qx, cq, h))))


def test_enabled_reads_the_environment_on_every_call(monkeypatch):
    monkeypatch.delenv(gates.ENV_VAR, raising=False)
    assert not gates.enabled()
    monkeypatch.setenv(gates.ENV_VAR, "1")
    assert gates.enabled()
    monkeypatch.setenv(gates.ENV_VAR, "0")
    assert not gates.enabled()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 128, 32, 48), (2, 3, 5, 7)])  # vector path; scalar tail only
def test_gate_kernels_match_plain_on_cuda(rng, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gate kernels have no CPU form")
    ops = [torch.from_numpy((2 * rng.standard_normal(shape)).astype(np.float32)).cuda() for _ in range(5)]
    zx, cz, qx, cq, h = ops
    before = dict(gates.LAUNCHES)
    rh = gates.fused_rh(zx, cz, h)
    combined = gates.fused_combine(*ops)
    torch.cuda.synchronize()
    assert gates.LAUNCHES == {k: v + 1 for k, v in before.items()}
    np.testing.assert_allclose(rh.cpu().numpy(), gates.plain_rh(zx, cz, h).cpu().numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(combined.cpu().numpy(), gates.plain_combine(*ops).cpu().numpy(), atol=TOL, rtol=0)
    # One device formula: combine and the fused GRU tail agree bit for bit.
    assert torch.equal(combined, gru_tail.fused_gru_tail(*ops))
    with pytest.raises(ValueError, match="contiguous"):
        gates.fused_rh(zx.transpose(2, 3), cz.transpose(2, 3), h.transpose(2, 3))
