"""The PyTorch port's test-mode forward, anytime split and serving core.

- `RAFTStereo` against the JAX model on the same (perturbed) weights, with
  the kernel configuration (`pallas` + `fused_gru_tail`, the JAX Pallas
  kernels in interpret mode), with that plus `fused_encoder`, and with the
  plain `reg` one: 3 iterations at 48x64, rtol = atol = 1e-4 (precedent
  tests/test_model.py).
- prelude + k chunks + finalize against a direct forward in the port, in the
  kernel and the fused-encoder configurations: exact.
- `AnytimeEngine.run_batch` and `StereoService.submit` on the CPU against
  the direct forward, deadline early exit, and bucket overflow.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.serving.service import BucketOverflowError, StereoService
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixtures)
    jax_apply,
    jax_init,
    pallas_tpu_compiler_params,
    torch_single_thread,
)

H, W, ITERS = 48, 64, 3
HID = (32, 32, 32)
KERNEL = {"corr_implementation": "pallas", "fused_gru_tail": True}
PLAIN = {"corr_implementation": "reg", "fused_gru_tail": False}
FUSED = dict(KERNEL, fused_encoder=True)


def _halve_kernels(tree):
    return {k: _halve_kernels(v) if isinstance(v, dict) else (0.5 * v if k == "kernel" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    """One perturbed JAX init shared by both configurations (the strategy
    flags do not change the parameter tree), conv kernels halved.

    Flax's fan-out He init makes the untrained GRU chaotic: at full scale
    both fp32 implementations drift about 1e-3 px from a float64 run of the
    port within 3 iterations, so no 1e-4 comparison could hold. Halved
    kernels (about the scale of PyTorch's default init, which the precedent
    test uses) keep that drift near 5e-6 px while the flows still reach
    about 14 px — a wrong port still fails by orders of magnitude."""
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": _halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (1, H, W + 6, 3)).astype(np.float32)
    return left[:, :, 6:], left[:, :, :W]


def port_model(weights, **flags):
    model = RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags))
    return load_jax_variables(model, weights).eval()


@pytest.mark.parametrize("flags", [KERNEL, PLAIN, FUSED],
                         ids=["pallas+fused_gru_tail", "reg", "pallas+fused_gru_tail+fused_encoder"])
def test_forward_matches_jax(weights, images, flags):
    jm = JaxRAFTStereo(JaxConfig(hidden_dims=HID, **flags))
    want_lo, want_up = jax_apply(jm, weights, *images, iters=ITERS, test_mode=True)
    with torch.inference_mode():
        got_lo, got_up = port_model(weights, **flags)(*map(torch.from_numpy, images), iters=ITERS, test_mode=True)
    assert got_lo.shape == (1, H // 4, W // 4) and got_up.shape == (1, H, W, 1)
    assert np.abs(want_up).max() > 1.0  # the flows moved: the comparison has teeth
    np.testing.assert_allclose(got_lo.numpy(), want_lo, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), want_up, rtol=1e-4, atol=1e-4)


def test_anytime_chunks_equal_direct_forward(weights, images):
    check_anytime_chunks(port_model(weights, **KERNEL), images)


def test_fused_encoder_anytime_chunks_equal_direct_forward(weights, images):
    check_anytime_chunks(port_model(weights, **FUSED), images)


def check_anytime_chunks(model, images):
    i1, i2 = map(torch.from_numpy, images)
    with torch.inference_mode():
        direct = model(i1, i2, iters=6, test_mode=True)
        state = anytime.prelude(model, i1, i2)
        for _ in range(3):
            state = anytime.chunk(model, state, 2)
        chunked = anytime.finalize(model, state)
        # A warm start through the prelude equals the direct flow_init path.
        flow0 = direct[0] * 0.5
        warm_direct = model(i1, i2, iters=2, flow_init=flow0, test_mode=True)
        warm_chunked = anytime.finalize(model, anytime.chunk(model, anytime.prelude(model, i1, i2, flow0), 2))
    for a, b in zip(direct + warm_direct, chunked + warm_chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def serve_config(**kw):
    return ServeConfig(
        model=RAFTStereoConfig(hidden_dims=HID, **KERNEL),
        buckets=((64, 96), (96, 128)), max_batch=2, chunk_iters=2, max_iters=4, **kw,
    )


def padded_pair(rng, h=64, w=96, b=1):
    return tuple(torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)) for _ in range(2))


def test_engine_run_batch_matches_direct_forward(weights):
    rng = np.random.default_rng(3)
    engine = AnytimeEngine(serve_config(), port_model(weights, **KERNEL), device="cpu")
    summary = engine.warm()
    assert summary["combos"] == 4 and engine.chunk_estimate_s((64, 96), 2) > 0
    i1, i2 = padded_pair(rng, b=2)
    res = engine.run_batch((64, 96), i1, i2, deadlines_s=[None, None], max_iters=[4, 1])
    with torch.inference_mode():
        lo4, up4 = engine.model(i1, i2, iters=4, test_mode=True)
        lo2, up2 = engine.model(i1, i2, iters=2, test_mode=True)
    # Row 0 runs its full budget; row 1 asked for 1 iteration and gets one
    # whole chunk (2), finalized at that point.
    assert [r.iters_completed for r in res] == [4, 2]
    assert [r.early_exit for r in res] == [False, False]
    np.testing.assert_array_equal(res[0].flow_up, up4[0].numpy())
    np.testing.assert_array_equal(res[0].flow_lowres, lo4[0].numpy())
    np.testing.assert_array_equal(res[1].flow_up, up2[1].numpy())


def test_engine_tight_deadline_exits_after_one_chunk(weights):
    rng = np.random.default_rng(4)
    engine = AnytimeEngine(serve_config(), port_model(weights, **KERNEL), device="cpu")
    engine.warm()
    i1, i2 = padded_pair(rng)
    (res,) = engine.run_batch((64, 96), i1, i2, deadlines_s=[time.monotonic()], max_iters=[4])
    assert res.iters_completed == 2 and res.early_exit
    assert np.isfinite(res.flow_up).all() and res.flow_up.shape == (64, 96, 1)


def test_service_submit_unpads_and_rejects_oversize(weights):
    rng = np.random.default_rng(5)
    service = StereoService(serve_config(), port_model(weights, **KERNEL), device="cpu").start()
    assert service.pick_bucket(50, 70) == (64, 96) and service.pick_bucket(65, 70) == (96, 128)
    i1 = rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)
    i2 = rng.uniform(0, 255, (50, 70, 3)).astype(np.float32)
    out = service.submit(i1, i2).result(timeout=0)
    assert out["disparity"].shape == (50, 70) and out["bucket"] == [64, 96]
    assert out["iters_completed"] == 4 and not out["early_exit"] and out["latency_ms"] > 0
    bucket, padder, p1, p2 = service._admit(i1, i2)
    with torch.inference_mode():
        _, up = service.engine.model(torch.from_numpy(p1[None]), torch.from_numpy(p2[None]), iters=4, test_mode=True)
    np.testing.assert_array_equal(out["disparity"], padder.unpad(up.numpy())[0, :, :, 0])
    with pytest.raises(BucketOverflowError):
        service.submit(np.zeros((97, 70, 3)), np.zeros((97, 70, 3)))
    with pytest.raises(ValueError, match="equal"):
        service.submit(np.zeros((50, 70, 3)), np.zeros((50, 71, 3)))
