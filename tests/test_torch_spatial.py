"""Row bands over the spatial axis (parallel/spatial.py) against the whole
image: the port's `spatial` and `dp+spatial` presets.

Primitives, in one process: two bands run in two threads over the
package's in-process comm (`spatial.ThreadComm`, the band scope's
collectives as shared slots behind a barrier), no process group. Each banded layer's
output, gathered, equals the whole layer's at fp32 within 1e-6 (only the
conv algorithm's blocking and the norms' sums differ), and the halo's
backward equals autograd of the whole conv:
- `Conv` with a halo for the 7x7 stride-2 stem, a 3x3 stride-2 conv, a
  3x3 conv, the 7x7 motion conv and a 1x1 stride-2 conv;
- `avg_pool2x`, the 3x3 unfold of the convex upsample and the
  align-corners resize of a whole coarse level to a band of a finer one;
- `InstanceNorm` and `GroupNorm` with their sums over the bands.

The model, over two gloo ranks spawned once for the module
(tests/torch_spatial_worker.py) on a (1, 2) mesh, from seeded weights
with halved kernels (tests/test_torch_model.py says why) handed to both
packages:
- (a) the test-mode forward, 3 iterations, "reg" and "pallas" (the plain
  twins on the CPU), at 48x64 (the 1/16 level, 3 rows, is ragged) and
  64x64 (every level divides): each rank's `flow_up` rows are the
  matching rows of the port's unsharded forward and of JAX's forward
  (`RAFTStereo.apply(..., test_mode=True)`, "highest" matmul precision).
  Tolerance rtol = atol = 1e-4, tests/test_model.py's precedent for two
  fp32 forwards: the bands differ from the whole image only by the order
  of the cross-band norm sums and the conv's blocking (a float64 run
  agrees to 1e-12), amplified by the untrained GRU over 3 iterations;
  JAX's own spatial check holds 2e-4 / 2e-3 (tests/test_spatial.py).
  `forward_whole` (evaluation's path) gathers the whole flow on every rank;
- (b) the correlation chain makes no exchange: the band scope's count
  across every `corr_state` and `corr_sample` call is 0 while the forward
  as a whole exchanges halos and sums (the counterpart of JAX's
  no-collectives audit of that chain, tests/test_spatial.py);
- (c) one training step under `spatial`, "pallas", fp32, 2 iterations:
  metrics, the gradient norm, each clipped gradient and each updated
  parameter against the port's unsharded step at
  tests/test_torch_train.py's tolerances; `dp` on the same (1, 2) mesh
  runs the same bands (JAX's batch rules shard rows over `spatial` under
  every preset) and takes the same step.

Plus the refusals (a crop off the band rule, fsdp on bands, serving a
spatial preset with replicas) and what is accepted (`fused_encoder` on
bands), the loader's shard for a spatial group and the band loss against
the whole loss.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import AugmentConfig, RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.layers import Conv, GroupNorm, InstanceNorm
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.parallel import distributed, spatial
from raft_stereo_tpu_torch.parallel.mesh import Mesh, shard_batch
from raft_stereo_tpu_torch.parallel.sharding import ShardingEngine
from raft_stereo_tpu_torch.train.loss import sequence_loss, valid_count
from raft_stereo_tpu_torch.train.trainer import Trainer, rank_batch_size
from raft_stereo_tpu_torch.utils import geometry
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import assert_updates_match_one_process, flax_variables, free_port, jax_apply, rank_env, run_bands
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
W, ITERS, TRAIN_ITERS, B = 64, 3, 2, 2
HID = (32, 32, 32)
MODEL = {"hidden_dims": HID}
CASES = [("reg", 48), ("pallas", 48), ("reg", 64), ("pallas", 64)]


# -- two bands in two threads -----------------------------------------------------


def banded(scope, height, fn):
    """fn() in `scope`'s banded state for an image of `height` rows."""
    with scope.bands(height // scope.count, n_downsample=0):
        return fn()


CONVS = {
    "stem7x7s2": (3, 8, 7, 2, 3),
    "conv3x3s2": (8, 8, 3, 2, 1),
    "conv3x3": (8, 8, 3, 1, 1),
    "convf1 7x7": (1, 8, 7, 1, 3),
    "conv1x1s2": (8, 8, 1, 2, 0),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_halo_conv_equals_whole_conv(name):
    """A band's conv with its halo (asymmetric for stride 2) gives the
    whole conv's rows of that band, and its backward (the halo's gradients
    sent back to their bands) gives the whole conv's input and weight
    gradients."""
    c_in, c_out, k, stride, pad = CONVS[name]
    torch.manual_seed(0)
    conv = Conv(c_in, c_out, k, stride=stride, padding=pad)
    x = torch.randn(2, c_in, 24, 20, requires_grad=True)
    y = conv(x)
    g = torch.randn_like(y)
    y.backward(g)
    want_dx, want_dw = x.grad.clone(), conv.weight.grad.clone()

    def band(scope):
        xb = scope.take_band(x.detach(), 2).clone().requires_grad_(True)
        convb = Conv(c_in, c_out, k, stride=stride, padding=pad)
        convb.load_state_dict(conv.state_dict())
        yb = banded(scope, 24, lambda: convb(xb))
        yb.backward(scope.take_band(g, 2))
        return yb.detach(), xb.grad, convb.weight.grad

    parts = run_bands(band)
    torch.testing.assert_close(torch.cat([p[0] for p in parts], 2), y.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 2), want_dx, rtol=1e-6, atol=1e-6)
    # dW sums over every output pixel, here in two halves: 1e-6 of its
    # largest magnitude.
    dw = parts[0][2] + parts[1][2]
    assert (dw - want_dw).abs().max() <= 1e-6 * want_dw.abs().max()


@pytest.mark.parametrize("op", ["avg_pool2x", "unfold3x3", "resize_to_band"])
def test_pool_unfold_resize_bands_equal_whole(op):
    """avg_pool2x (1 halo row above, count_include_pad by the zero halo),
    the convex upsample's 3x3 unfold (a halo row each side) and the
    align-corners resize of a whole 3-row level to a band of 6 (the band's
    rows of the interpolation matrix) on bands equal the whole ops."""
    torch.manual_seed(1)
    x = torch.randn(2, 4, 12, 10)
    whole = {"avg_pool2x": lambda: geometry.avg_pool2x(x),
             "unfold3x3": lambda: geometry.extract_3x3_patches(x),
             "resize_to_band": lambda: geometry.resize_bilinear_align_corners(x[:, :, :3], 12, 10)}[op]()
    dim = 3 if op == "unfold3x3" else 2

    def band(scope):
        xb = scope.take_band(x, 2)
        if op == "avg_pool2x":
            return banded(scope, 12, lambda: geometry.avg_pool2x(xb))
        if op == "unfold3x3":
            return banded(scope, 12, lambda: geometry.extract_3x3_patches(xb))
        rows = slice(scope.index * 6, (scope.index + 1) * 6)
        return geometry.resize_bilinear_align_corners(x[:, :, :3], 12, 10, rows)

    parts = run_bands(band)
    torch.testing.assert_close(torch.cat(parts, dim), whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm", ["instance", "group"])
def test_norm_sums_over_bands(norm):
    """Instance and group norm on a band take the whole image's statistics
    (their one-pass sums over the bands), forward and backward."""
    torch.manual_seed(2)
    layer = InstanceNorm(8) if norm == "instance" else GroupNorm(8, num_groups=2)
    if norm == "group":
        with torch.no_grad():
            layer.weight.uniform_(0.5, 1.5)
            layer.bias.uniform_(-0.5, 0.5)
    x = (3.0 + torch.randn(2, 8, 12, 10)).requires_grad_(True)
    y = layer(x)
    g = torch.randn_like(y)
    y.backward(g)

    def band(scope):
        xb = scope.take_band(x.detach(), 2).clone().requires_grad_(True)
        yb = banded(scope, 12, lambda: layer(xb))
        yb.backward(scope.take_band(g, 2))
        return yb.detach(), xb.grad

    parts = run_bands(band)
    torch.testing.assert_close(torch.cat([p[0] for p in parts], 2), y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 2), x.grad, rtol=1e-5, atol=1e-5)


def test_ragged_level_rule():
    """The ragged-level rule on a 48-row image over 2 bands: levels 0-3
    banded, 1/16 and 1/32 whole; on 64 rows every level banded."""
    scope = spatial.BandScope(None, 0, 2)
    with scope.bands(24, n_downsample=2):
        assert [scope.banded_level(lv) for lv in range(6)] == [True, True, True, True, False, False]
        assert [scope.rows(lv) for lv in range(6)] == [48, 24, 12, 6, 3, 2]
    with scope.bands(32, n_downsample=2):
        assert all(scope.banded_level(lv) for lv in range(6))
    assert spatial.active() is None and spatial.banded() is None


# -- the model over two gloo ranks -------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Seeded port weights (a flax init is a slow compile here) with every
    conv kernel halved (tests/test_torch_model.py says why) and the frozen
    batch norms' statistics moved off the identity, as a flax tree for
    both packages."""
    model = build_model(RAFTStereoConfig(**MODEL), seed=0, device="cpu")
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dim() == 4:
                t.mul_(0.5)
            elif name.endswith("running_mean"):
                t.add_(torch.from_numpy(rng.normal(0, 0.1, t.shape).astype(np.float32)))
            elif name.endswith("running_var"):
                t.mul_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
    return flax_variables(model)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    out = {}
    for h in (48, 64):
        left = rng.uniform(0, 255, (1, h, W + 6, 3)).astype(np.float32)
        out[h] = (left[:, :, 6:], left[:, :, :W])
    return out


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    h = 48
    left = rng.uniform(0, 255, (B, h, W + 6, 3)).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, h, W, 1)).astype(np.float32)
    flow[0, :3, :5] = -800.0  # past max_flow: masked out
    valid = (rng.uniform(0, 1, (B, h, W)) > 0.1).astype(np.float32)
    return {"image1": left[:, :, 6:], "image2": left[:, :, :W], "flow": flow, "valid": valid}


def port_model(weights, impl):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(**MODEL, corr_implementation=impl)), weights).eval()


def train_config(**kw):
    return TrainConfig(model=RAFTStereoConfig(**MODEL, corr_implementation="pallas"), batch_size=B,
                       train_iters=TRAIN_ITERS, num_steps=1000, **kw)


@pytest.fixture(scope="module")
def runs(weights, images, batch, tmp_path_factory):
    """The two ranks' forwards and steps (one launch); the unsharded port
    forwards and step and the JAX forwards computed while they run."""
    workdir = tmp_path_factory.mktemp("spatial")
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump({"weights": weights, "images": images, "batch": batch, "cases": CASES, "model": MODEL,
                     "iters": ITERS, "train_iters": TRAIN_ITERS, "num_steps": 1000, "train_hw": (48, W)}, f)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_spatial_worker.py"), str(workdir)],
                              env=rank_env(r, 2, port), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        want = {"jax": {}, "port": {}}
        for h in (48, 64):
            jm = JaxRAFTStereo(JaxConfig(hidden_dims=HID, corr_implementation="reg"))
            want["jax"][h] = jax_apply(jm, weights, *images[h], iters=ITERS, test_mode=True)[1]
        with torch.inference_mode():
            for impl, h in CASES:
                want["port"][(impl, h)] = port_model(weights, impl)(
                    *map(torch.from_numpy, images[h]), iters=ITERS, test_mode=True)[1].numpy()
        trainer = Trainer(train_config(), (48, W, 3), device="cpu")
        load_jax_variables(trainer.model, weights)
        before = {n: p.detach().clone().numpy() for n, p in trainer.model.named_parameters()}
        metrics = trainer.train_step(batch)
        want["step"] = {"metrics": metrics, "before": before,
                        "params": {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
                        "grads": {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()}}
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    got = []
    for r in range(2):
        with open(workdir / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return got, want


@pytest.mark.parametrize("case", CASES, ids=[f"{i}-{h}x{W}" for i, h in CASES])
def test_forward_bands_match_unsharded_and_jax(runs, case):
    """(a) Each rank's flow_up is its band of the port's unsharded forward
    and of JAX's, and the whole flow gathered for evaluation equals the
    unsharded one."""
    got, want = runs
    h = case[1]
    full = want["port"][case]
    assert np.abs(full).max() > 1.0  # the flows moved: the comparison has teeth
    for r in range(2):
        band = got[r]["forward"][case]["up"]
        assert band.shape == (1, h // 2, W, 1)
        rows = slice(r * h // 2, (r + 1) * h // 2)
        np.testing.assert_allclose(band, full[:, rows], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(band, want["jax"][h][:, rows], rtol=1e-4, atol=1e-4)
        whole = got[r]["forward"][case]["whole"]
        if whole is not None:
            np.testing.assert_allclose(whole, full, rtol=1e-4, atol=1e-4)
    assert any(got[r]["forward"][case]["whole"] is not None for r in range(2)) == (case == CASES[0])


@pytest.mark.parametrize("case", CASES, ids=[f"{i}-{h}x{W}" for i, h in CASES])
def test_correlation_chain_makes_no_exchange(runs, case):
    """(b) Zero exchanges inside every corr_state and corr_sample call (one
    state and ITERS lookups a forward) on both ranks, while the forward as a whole
    exchanged its halos and norm sums."""
    got, _ = runs
    for r in range(2):
        rec = got[r]["forward"][case]
        # The first case's `forward_whole` runs a second forward.
        assert len(rec["corr_exchanges"]) == (1 + ITERS) * (2 if case == CASES[0] else 1)
        assert sum(rec["corr_exchanges"]) == 0
        assert rec["exchanges"] > 100


@pytest.mark.parametrize("preset", ["spatial", "dp"])
def test_training_step_on_bands_matches_unsharded(runs, preset):
    """(c) One step on two bands (each rank its 24 rows of the batch)
    against the port's unsharded step: metrics 1e-5, the norm 1e-4, every
    clipped gradient within tests/test_torch_train.py's GRAD_TOL of its
    leaf's largest magnitude (FNET_TOL in the feature trunk), every update
    within the step's size and within 1e-3 lr where the gradient is well
    resolved (`torch_parity.assert_updates_match_one_process`). dp on a (1, 2)
    mesh runs the same bands."""
    got, want = runs
    step = want["step"]
    for r in range(2):
        mine = got[r]["train"][preset]
        assert mine["banded"]
        assert sum(mine["corr_exchanges"]) == 0 and len(mine["corr_exchanges"]) == 1 + TRAIN_ITERS
        assert mine["metrics"] == got[0]["train"][preset]["metrics"]  # the global batch's, on every rank
        for k in ("epe", "1px", "3px", "5px", "live_loss"):
            np.testing.assert_allclose(mine["metrics"][k], step["metrics"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(mine["metrics"]["grad_norm"], step["metrics"]["grad_norm"], rtol=1e-4)
        assert mine["metrics"]["learning_rate"] == step["metrics"]["learning_rate"]
        assert_updates_match_one_process(mine["params"], mine["grads"], step)
        # Both ranks hold the same parameters after the step.
        for name, value in mine["params"].items():
            assert np.array_equal(value, got[0]["train"][preset]["params"][name]), name


# -- the refusals, the loader's shard and the band loss -----------------------------


def test_band_rule_refusals():
    """A crop off the band rule raises with what to use; on a spatial axis
    of 1 it is fine. fsdp is accepted on bands (tests/test_torch_fsdp_spatial.py
    runs it; on a data axis of 1 its loss is unscaled), and so is
    fused_encoder (its layer1 runs there: tests/test_torch_spatial_fused.py)."""
    TrainConfig(model=RAFTStereoConfig(fused_encoder=True), mesh_shape=(1, 2))
    with pytest.raises(ValueError, match=r"crop_size \(100, 720\).*use a height of 104"):
        TrainConfig(augment=AugmentConfig(crop_size=(100, 720)), mesh_shape=(1, 2))
    with pytest.raises(ValueError, match="use a height of 48"):
        TrainConfig(augment=AugmentConfig(crop_size=(32, 720)), mesh_shape=(1, 4))
    TrainConfig(sharding_rules="fsdp", mesh_shape=(1, 2))
    engine = ShardingEngine(Mesh(1, 2), "fsdp")
    assert engine.banded and engine.loss_scale == 1
    TrainConfig(model=RAFTStereoConfig(fused_encoder=True), augment=AugmentConfig(crop_size=(100, 720)),
                sharding_rules="spatial")
    scope = spatial.BandScope(None, 1, 2)
    with pytest.raises(ValueError, match="use a height of 24"):
        with scope.bands(10, n_downsample=2):
            pass


def test_serve_spatial_on_one_device_and_refused_on_two(capsys, monkeypatch):
    """`serve --sharding_rules spatial` boots the plain engine on one
    visible device and says so; with two visible cards it is not refused
    (the banded engine serves them, tests/test_torch_spatial_serving.py),
    and with two replicas it exits 2 before anything is built, as JAX's
    `--replicas` requires dp."""
    argv = ["serve", "--device", "cpu", "--warmup_only", "--buckets", "64x96", "--max_batch", "1",
            "--chunk_iters", "1", "--max_iters", "1", "--hidden_dims", "16", "16", "16"]
    assert cli.main([*argv, "--sharding_rules", "dp+spatial"]) == 0
    assert '"sharding": "dp+spatial requested; one visible device: dp (single-program)"' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cli._spatial_serving_problem("spatial", 1) is None
    assert cli.main(["serve", "--device", "cuda", "--sharding_rules", "spatial", "--replicas", "2"]) == 2
    assert "replicas require --sharding_rules dp" in capsys.readouterr().err


def test_spatial_group_reads_the_same_batch_and_keeps_disjoint_bands(monkeypatch, batch):
    """The loader's shard is the data coordinate: the two ranks of a (1, 2)
    mesh read the same samples (host 0 of 1), of a (2, 2) mesh ranks 0-1
    and 2-3 pair up; `shard_batch` gives each rank of a group its band,
    and the bands make up the batch. The rank's batch holds its data
    group's rows."""
    shards = []
    for rank in range(2):
        monkeypatch.setattr(distributed, "process_topology", lambda r=rank: (r, 2))
        shards.append(distributed.host_shard_args((1, 2)))
    assert shards == [{"host_id": 0, "num_hosts": 1}] * 2
    quad = []
    for rank in range(4):
        monkeypatch.setattr(distributed, "process_topology", lambda r=rank: (r, 4))
        quad.append(distributed.host_shard_args((-1, 2)))
    assert [q["host_id"] for q in quad] == [0, 0, 1, 1] and {q["num_hosts"] for q in quad} == {2}
    assert rank_batch_size(4, 2, spatial=2) == 4 and rank_batch_size(4, 4, spatial=2) == 2
    bands = [shard_batch(Mesh(1, 2), batch, spatial_index=k) for k in range(2)]
    for key in ("image1", "image2", "flow", "valid"):
        assert bands[0][key].shape[1] == bands[1][key].shape[1] == 24
        np.testing.assert_array_equal(torch.cat([b[key] for b in bands], 1).numpy(), batch[key])


def test_band_losses_sum_to_the_whole_loss(batch):
    """Each band's loss and metrics over the global valid count, summed
    over the bands, are the whole batch's (the blocked layout)."""
    rng = np.random.default_rng(3)
    f = 4
    preds = torch.from_numpy(rng.normal(-4, 3, (3, B, 48 // f, f, W // f, f)).astype(np.float32))
    gt, valid = torch.from_numpy(batch["flow"]), torch.from_numpy(batch["valid"])
    want_loss, want_metrics = sequence_loss(preds, gt, valid)
    count = valid_count(gt, valid)
    loss, metrics = 0.0, {k: 0.0 for k in want_metrics}
    for k in range(2):
        rows = slice(k * 24, (k + 1) * 24)
        lk, mk = sequence_loss(preds[:, :, k * 6:(k + 1) * 6], gt[:, rows], valid[:, rows], count=count)
        loss = loss + lk
        metrics = {n: metrics[n] + mk[n] for n in metrics}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for n in want_metrics:
        np.testing.assert_allclose(float(metrics[n]), float(want_metrics[n]), rtol=1e-6, err_msg=n)
