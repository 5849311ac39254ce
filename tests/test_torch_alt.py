"""The "alt" correlation strategy and `upsample_bilinear_scaled` of the port
against the JAX package.

- `pool_fmap_levels` and `corr_lookup_alt` against JAX `make_corr_fn("alt")`
  (odd widths, queries outside the row, integer positions): 1e-5. The
  port's alt taps against its own "reg" taps (pooling and the dot are both
  linear, so every level agrees up to rounding; JAX's tests/test_corr.py
  holds level 0): 1e-5 of the largest |tap|.
- A test-mode forward with alt against JAX at 48x64, 3 iterations, on
  perturbed kernel-halved weights: 1e-4 (tests/test_torch_model.py).
- A train-mode forward's loss and gradients with alt against JAX
  `value_and_grad`, within tests/test_torch_train.py's GRAD_TOL (FNET_TOL
  for the feature encoder's trunk).
- `upsample_bilinear_scaled` against JAX: 1e-6.

`evaluate --corr_implementation alt` and `alt_cuda` are run by
tests/test_torch_eval.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops import corr as jcorr
from raft_stereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raft_stereo_tpu.utils.geometry import upsample_bilinear_scaled as jax_upsample_bilinear_scaled
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo, corr_sample, corr_state
from raft_stereo_tpu_torch.ops import corr
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from raft_stereo_tpu_torch.utils.geometry import upsample_bilinear_scaled
from test_torch_train import FNET_TOL, GRAD_TOL
from torch_parity import (  # noqa: F401 (autouse fixture)
    flat_leaves,
    flax_params,
    halve_kernels,
    jax_apply,
    jax_init,
    nchw,
    torch_single_thread,
)

TOL = 1e-5
H, W, ITERS = 48, 64, 3
HID = (32, 32, 32)
ALT = {"corr_implementation": "alt"}


def make_case(rng, w1, w2, b=2, h=3, d=16):
    f1 = rng.standard_normal((b, h, w1, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w2, d)).astype(np.float32)
    x = np.arange(w1, dtype=np.float32)[None, None, :] - rng.uniform(0, w2 / 3, (b, h, w1))
    wild = rng.uniform(0, 1, (b, h, w1)) < 0.15
    x = np.where(wild, rng.uniform(-3 * w2, 3 * w2, (b, h, w1)), x).astype(np.float32)
    x[0, 0, :4] = [-1.0, 0.0, w2 - 1.0, float(w2)]
    return f1, f2, x


@pytest.mark.parametrize("w1,w2,levels,radius", [(24, 24, 4, 4), (19, 37, 3, 2), (40, 131, 4, 3)],
                         ids=["square", "odd", "wide"])
def test_alt_lookup_matches_jax(w1, w2, levels, radius):
    f1, f2, x = make_case(np.random.default_rng(w2), w1, w2)
    want_levels = jcorr.pool_fmap_levels(jnp.asarray(f2), levels)
    got_levels = corr.pool_fmap_levels(torch.from_numpy(f2), levels)
    assert [tuple(g.shape) for g in got_levels] == [w.shape for w in want_levels]
    for g, w in zip(got_levels, want_levels):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    want = np.asarray(jcorr.make_corr_fn("alt", jnp.asarray(f1), jnp.asarray(f2), levels, radius)(jnp.asarray(x)))
    got = corr.corr_lookup_alt(torch.from_numpy(f1), got_levels, torch.from_numpy(x), radius)
    assert got.shape == want.shape == (2, 3, w1, levels * (2 * radius + 1))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_alt_taps_equal_reg_taps():
    f1, f2, x = make_case(np.random.default_rng(5), 33, 45)
    t1, t2, tx = map(torch.from_numpy, (f1, f2, x))
    alt = corr.corr_lookup_alt(t1, corr.pool_fmap_levels(t2, 4), tx, 4)
    reg = corr.corr_lookup(corr.corr_pyramid(corr.corr_volume(t1, t2), 4), tx, 4)
    scale = reg.abs().max().item()
    assert scale > 1.0
    np.testing.assert_allclose(alt.numpy(), reg.numpy(), rtol=0, atol=TOL * scale)


def test_alt_state_ignores_corr_dtype_and_widens_bf16():
    """As in JAX: the alt state is (fmap1, levels) in fp32 whatever
    `corr_dtype` and the maps' dtype, and the taps come out in the compute
    dtype."""
    rng = np.random.default_rng(2)
    fm1, fm2 = (torch.from_numpy(rng.standard_normal((1, 16, 4, 24)).astype(np.float32)) for _ in range(2))
    coords = torch.from_numpy(rng.uniform(-2, 26, (1, 4, 24)).astype(np.float32))
    taps = {}
    for dtype, mixed in ((torch.float32, False), (torch.bfloat16, True)):
        cfg = RAFTStereoConfig(corr_implementation="alt", corr_dtype="bfloat16", mixed_precision=mixed)
        f1, levels = corr_state(cfg, fm1.to(dtype), fm2.to(dtype), test_mode=True)
        assert f1.dtype == torch.float32 and all(lv.dtype == torch.float32 for lv in levels)
        assert len(levels) == cfg.corr_levels and f1.shape == (1, 4, 24, 16)
        taps[dtype] = corr_sample(cfg, (f1, levels), coords)
        assert taps[dtype].dtype == dtype and taps[dtype].shape == (1, cfg.corr_channels, 4, 24)
    want = corr.corr_lookup_alt(fm1.permute(0, 2, 3, 1), corr.pool_fmap_levels(fm2.permute(0, 2, 3, 1), 4),
                                coords, 4)
    assert torch.equal(taps[torch.float32], want.permute(0, 3, 1, 2))


@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (1, H, W + 6, 3)).astype(np.float32)
    return left[:, :, 6:], left[:, :, :W]


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights)


def test_alt_forward_matches_jax(weights, images):
    want_lo, want_up = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **ALT)), weights, *images, iters=ITERS,
                                 test_mode=True)
    with torch.inference_mode():
        got_lo, got_up = port_model(weights, **ALT).eval()(*map(torch.from_numpy, images), iters=ITERS,
                                                           test_mode=True)
    assert np.abs(want_up).max() > 1.0
    np.testing.assert_allclose(got_lo.numpy(), want_lo, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), want_up, rtol=1e-4, atol=1e-4)


def test_alt_gradients_match_jax(weights):
    """Loss and d(loss)/d(params) of a 2-iteration alt training forward
    against JAX, remat on in both. The port's alt backward is autograd of
    the gather (a scatter-add: on the card atomic, so not bit-reproducible
    there; exact on the CPU)."""
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (1, H, W + 6, 3)).astype(np.float32)
    batch = {"image1": left[:, :, 6:], "image2": left[:, :, :W],
             "flow": -rng.uniform(0, 8, (1, H, W, 1)).astype(np.float32),
             "valid": (rng.uniform(0, 1, (1, H, W)) > 0.1).astype(np.float32)}
    iters = 2
    model = JaxRAFTStereo(JaxConfig(hidden_dims=HID, encoder_s2d=False, remat_iterations=True, **ALT))

    def loss_fn(params):
        flows = model.apply({"params": params, "batch_stats": weights["batch_stats"]}, batch["image1"],
                            batch["image2"], iters=iters)
        return jax_sequence_loss(flows, batch["flow"], batch["valid"], 0.9, 700.0)[0]

    with jax.default_matmul_precision("highest"):
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(weights["params"])
    want = flat_leaves(want)

    port = port_model(weights, **ALT)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = sequence_loss(port(t["image1"], t["image2"], iters=iters), t["flow"], t["valid"])
    loss.backward()
    got = flat_leaves(flax_params(port, grads=True))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    largest = max(np.abs(g).max() for g in want.values())
    for key, w in want.items():
        fnet = key[:2] == ("fnet", "trunk")
        if fnet and key[-1] == "bias":
            assert max(np.abs(got[key]).max(), np.abs(w).max()) <= 1e-6 * largest, key
            continue
        tol = FNET_TOL if fnet else GRAD_TOL
        np.testing.assert_allclose(got[key], w, atol=tol * np.abs(w).max(), rtol=0, err_msg="/".join(key))


@pytest.mark.parametrize("factor,shape", [(4, (2, 6, 9, 1)), (8, (1, 5, 7, 2)), (2, (1, 1, 3, 1))])
def test_upsample_bilinear_scaled_matches_jax(factor, shape):
    field = np.random.default_rng(factor).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_upsample_bilinear_scaled(jnp.asarray(field), factor))
    got = upsample_bilinear_scaled(nchw(field), factor)
    assert got.shape == (shape[0], shape[3], shape[1] * factor, shape[2] * factor)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=1e-6, atol=1e-6)
