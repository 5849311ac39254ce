"""Spatial serving across the devices of one process: the banded engine
(serving/engine.py `AnytimeEngine` with a spatial preset and `devices`),
JAX's `serve --sharding_rules spatial` on a (1, n) mesh.

On the CPU two bands share the CPU (`devices=["cpu", "cpu"]`), each band in
its worker thread over the in-process comm (`spatial.ThreadComm`), at a
64x64 bucket (every level divides by 2 bands), hidden 32, "pallas" (the
plain twins on the CPU), 3 iterations in one chunk, seeded weights with
halved kernels (tests/test_torch_model.py says why):

- each response equals the unsharded engine's and JAX's plain forward
  (`RAFTStereo.apply(..., test_mode=True)` on the same weights) within
  1e-4 px, at batch 1 and 2, also warm-started from a stream's
  `flow_init` (taken per band): tests/test_torch_spatial.py's bound for
  bands against the whole image (only the order of the cross-band sums
  differs, amplified by the untrained GRU);
- `swap_variables` reaches every band's copy of the model (bands on two
  distinct CPU devices, "cpu" and "cpu:0", hold two copies);
- a band that raises fails the batch, the breaker counts it, and the next
  batch is served;
- a bucket off the band rule is refused at boot with the height to use;
- `serve` refuses a spatial preset only with `--replicas` other than 1.
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.serving.service import StereoService
from torch_parity import flax_variables, jax_apply
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

BUCKET = (64, 64)
ITERS = 3
HID = (32, 32, 32)
MODEL = RAFTStereoConfig(hidden_dims=HID, corr_implementation="pallas")
TOL_PX = 1e-4


def serve_config(rules: str = "spatial", buckets=(BUCKET,), **kw) -> ServeConfig:
    return ServeConfig(model=MODEL, buckets=buckets, max_batch=2, chunk_iters=ITERS, max_iters=ITERS,
                       sharding_rules=rules, **kw)


def mild_model(seed: int = 0):
    model = build_model(MODEL, seed=seed, device="cpu").eval()
    with torch.no_grad():
        for tensor in model.state_dict().values():
            if tensor.dim() == 4:
                tensor.mul_(0.5)
    return model


@pytest.fixture(scope="module")
def model():
    return mild_model()


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(23)
    left = rng.uniform(0, 255, (2, BUCKET[0], BUCKET[1] + 6, 3)).astype(np.float32)
    return torch.from_numpy(left[:, :, 6:].copy()), torch.from_numpy(left[:, :, :BUCKET[1]].copy())


@pytest.fixture(scope="module")
def engines(model):
    plain = AnytimeEngine(serve_config("dp"), model, device="cpu")
    banded = AnytimeEngine(serve_config(), model, device="cpu", devices=["cpu", "cpu"])
    yield plain, banded
    banded.close()
    plain.close()


def flows(engine, i1, i2, flow_init=None):
    n = i1.shape[0]
    return np.stack([r.flow_up for r in engine.run_batch(BUCKET, i1, i2, [None] * n, [ITERS] * n,
                                                         flow_init=flow_init)])


def test_banded_engine_matches_unsharded_and_jax(engines, pair, model):
    plain, banded = engines
    assert banded.sharding == "spatial over 2 device(s)"
    summary = banded.warm()
    assert summary["sharding"] == "spatial over 2 device(s)" and summary["combos"] == 2
    assert banded.chunk_estimate_s(BUCKET, 1) > 0 and banded.chunk_estimate_s(BUCKET, 2) > 0
    jm = JaxRAFTStereo(JaxConfig(hidden_dims=HID, corr_implementation="reg"))
    want_jax = jax_apply(jm, flax_variables(model), *(t.numpy() for t in pair), iters=ITERS, test_mode=True)[1]
    for b in (1, 2):
        i1, i2 = (t[:b] for t in pair)
        before = banded.band_exchanges
        got = flows(banded, i1, i2)
        assert banded.band_exchanges - before > 100  # halos and norm sums, on both bands
        want = flows(plain, i1, i2)
        assert got.shape == want.shape == (b, *BUCKET, 1) and np.abs(want).max() > 1.0
        np.testing.assert_allclose(got, want, rtol=TOL_PX, atol=TOL_PX)
        np.testing.assert_allclose(got, want_jax[:b], rtol=TOL_PX, atol=TOL_PX)


def test_banded_engine_warm_start_per_band(engines, pair):
    """A stream's warm start: each band takes its rows of the low-res
    flow_init."""
    plain, banded = engines
    f = MODEL.downsample_factor
    rng = np.random.default_rng(29)
    flow0 = torch.from_numpy(-rng.uniform(0, 4, (2, BUCKET[0] // f, BUCKET[1] // f)).astype(np.float32))
    got, want = flows(banded, *pair, flow0), flows(plain, *pair, flow0)
    np.testing.assert_allclose(got, want, rtol=TOL_PX, atol=TOL_PX)
    assert np.abs(got - flows(plain, *pair)).max() > 1e-2  # the warm start moved the flows


def test_swap_variables_reaches_every_band(pair):
    served, other = mild_model(0), mild_model(1)
    banded = AnytimeEngine(serve_config(), served, device="cpu", devices=["cpu", "cpu:0"])
    try:
        models = banded._bands.models
        assert models[0] is not models[1]  # two devices, two copies
        gen = banded.swap_variables(other.state_dict())
        assert gen == 1
        for m in models:
            for name, t in m.state_dict().items():
                assert torch.equal(t, other.state_dict()[name]), name
        plain = AnytimeEngine(serve_config("dp"), other, device="cpu")
        np.testing.assert_allclose(flows(banded, *pair), flows(plain, *pair), rtol=TOL_PX, atol=TOL_PX)
    finally:
        banded.close()


def test_band_failure_fails_the_batch_and_counts_on_the_breaker(model, pair):
    cfg = serve_config(breaker_degrade_after=1, breaker_fail_after=3)
    service = StereoService(cfg, model=model, device="cpu", devices=["cpu", "cpu"]).start()
    try:
        assert service.healthz()["serving"]["sharding"] == "spatial over 2 device(s)"
        scope = service.engine._bands.scopes[1]

        def broken(t):
            raise RuntimeError("band 1 lost its card")

        scope.band_sum = broken
        img1, img2 = (t[0].numpy() for t in pair)
        with pytest.raises(RuntimeError, match="band 1 lost its card"):
            service.submit(img1, img2).result(timeout=120)
        snap = service.lifecycle.snapshot()
        assert snap["batch_failures_total"] == 1 and snap["breaker"]["consecutive_failures"] == 1
        assert service.lifecycle.state == "degraded"
        del scope.band_sum
        out = service.submit(img1, img2).result(timeout=120)
        assert out["disparity"].shape == BUCKET and np.isfinite(out["disparity"]).all()
        assert service.lifecycle.snapshot()["batch_successes_total"] >= 1
    finally:
        service.close()


def test_bucket_off_the_band_rule_is_refused_at_boot(model):
    """Three bands need a height that divides by 3 x 4 (every bucket is a
    multiple of 32, which two bands always divide): 64 rows are refused
    with the height to use, 96 boot; nothing is padded."""
    with pytest.raises(ValueError, match=r"bucket 64x64 over 3 bands: .*use a height of 72"):
        AnytimeEngine(serve_config(buckets=((96, 64), BUCKET)), model, device="cpu", devices=["cpu"] * 3)
    three = AnytimeEngine(serve_config(buckets=((96, 64),)), model, device="cpu", devices=["cpu"] * 3)
    assert three.sharding == "spatial over 3 device(s)"
    three.close()
    # One device serves any bucket unsharded, whatever the preset.
    one = AnytimeEngine(serve_config(buckets=(BUCKET,)), model, device="cpu", devices=["cpu"])
    assert one.sharding == "spatial requested; one visible device: dp (single-program)"


def test_serve_refuses_a_spatial_preset_only_with_replicas(capsys):
    assert cli._spatial_serving_problem("spatial", 1) is None
    assert cli._spatial_serving_problem("dp+spatial", 1) is None
    assert "replicas require --sharding_rules dp" in cli._spatial_serving_problem("spatial", 2)
    assert "replicas require --sharding_rules dp" in cli._spatial_serving_problem("dp+spatial", 0)
    assert cli.main(["serve", "--device", "cpu", "--sharding_rules", "spatial", "--replicas", "2"]) == 2
    assert "serve: " in capsys.readouterr().err
