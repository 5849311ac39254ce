"""PyTorch-port correlation ops against the JAX package (tolerance 1e-5).

The plain `corr_volume`/`corr_pyramid`/`corr_lookup` are held against the
JAX reg strategy, and the "pallas" strategy's wrappers on CPU tensors (the
plain version of the CUDA lookup kernel) against `pallas_corr_lookup_padded`
over `pallas_corr_state` — the TPU kernel in Pallas interpret mode.
Cases: odd W2, W2 > 128 (several 128-lane tiles in the TPU kernel), and
coordinates below 0 and past W2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.ops import corr as jcorr
from raft_stereo_tpu.ops.corr_pallas import pallas_corr_lookup_padded, pallas_corr_state
from raft_stereo_tpu_torch.ops import corr, corr_cuda
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
LEVELS, RADIUS = 4, 4


def make_case(rng, w1, w2, b=2, h=3, d=16):
    f1 = rng.standard_normal((b, h, w1, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w2, d)).astype(np.float32)
    x = np.arange(w1, dtype=np.float32)[None, None, :] - rng.uniform(0, w2 / 3, (b, h, w1))
    # A share of queries far outside the row on both sides, and some exactly
    # on integer positions.
    wild = rng.uniform(0, 1, (b, h, w1)) < 0.15
    x = np.where(wild, rng.uniform(-3 * w2, 3 * w2, (b, h, w1)), x).astype(np.float32)
    x[0, 0, :4] = [-1.0, 0.0, w2 - 1.0, float(w2)]
    return f1, f2, x


CASES = {"odd_w2": (24, 37), "multi_tile_w2": (40, 150), "small": (16, 16)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_volume_and_pyramid_match_jax(rng, case):
    f1, f2, _ = make_case(rng, *CASES[case])
    want = jcorr.corr_pyramid(jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2)), LEVELS)
    got = corr.corr_pyramid(corr.corr_volume(torch.from_numpy(f1), torch.from_numpy(f2)), LEVELS)
    assert [g.shape[-1] for g in got] == [CASES[case][1] // 2**l for l in range(LEVELS)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_lookup_matches_jax_reg(rng, case):
    f1, f2, x = make_case(rng, *CASES[case])
    pyr = jcorr.corr_pyramid(jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2)), LEVELS)
    want = np.asarray(jcorr.corr_lookup(pyr, jnp.asarray(x), RADIUS))
    got = corr.corr_lookup([torch.from_numpy(np.array(p)) for p in pyr], torch.from_numpy(x), RADIUS)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_strategy_on_cpu_matches_pallas_interpret(rng, case):
    f1, f2, x = make_case(rng, *CASES[case])
    state = pallas_corr_state(jnp.asarray(f1), jnp.asarray(f2), LEVELS)
    want = np.asarray(pallas_corr_lookup_padded(state, jnp.asarray(x), RADIUS))
    before = dict(corr_cuda.LAUNCHES)
    tstate = corr_cuda.corr_state(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)
    got = corr_cuda.corr_lookup(tstate, torch.from_numpy(x), RADIUS)
    assert got.shape == (*x.shape, LEVELS * (2 * RADIUS + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # CPU tensors take the plain version: no kernel launch is counted.
    assert corr_cuda.LAUNCHES == before


def test_far_out_of_range_taps_are_zero(rng):
    f1, f2, _ = make_case(rng, 8, 20)
    state = corr_cuda.corr_state(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)
    far = torch.full((2, 3, 8), -50.0)
    assert corr_cuda.corr_lookup(state, far, RADIUS).abs().max().item() == 0.0
    assert corr_cuda.corr_lookup(state, far + 200.0, RADIUS).abs().max().item() == 0.0


@pytest.mark.gpu
def test_lookup_kernel_matches_plain_on_cuda(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lookup kernel has no CPU form")
    f1, f2, x = make_case(rng, *CASES["multi_tile_w2"])
    state = corr_cuda.corr_state(torch.from_numpy(f1).cuda(), torch.from_numpy(f2).cuda(), LEVELS)
    coords = torch.from_numpy(x).cuda()
    before = corr_cuda.LAUNCHES["corr_lookup"]
    got = corr_cuda.corr_lookup(state, coords, RADIUS)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["corr_lookup"] == before + 1
    want = corr.corr_lookup(state, coords, RADIUS)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="without grad"):
        corr_cuda.corr_lookup(state, coords.clone().requires_grad_(), RADIUS)
