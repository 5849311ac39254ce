"""The mixed-precision (bf16) training step of the PyTorch port against the
JAX package's shipping training numerics.

The configuration is `corr_implementation="pallas"`, `mixed_precision=True`,
`corr_dtype="bfloat16"` (the JAX package's `train/trainer.py` calls it its
shipping numerics; its bench times it). Shared (perturbed, kernel-halved —
see tests/test_torch_model.py) weights and a numpy batch at 48x64, batch 2,
3 iterations; JAX with `encoder_s2d=False` (the port computes the direct
convs), its Pallas lookup and scatter in interpret mode, remat on with the
taps saved in both packages.

- The plain bf16 scatter (`plain_corr_scatter` with bf16 levels and a bf16
  cotangent) against `_scatter_pallas_padded` at bf16: within 1 bf16 ulp
  per element (XLA contracts the combined weight g[m](1-f) + g[m-1]f into a
  fused multiply-add on the CPU, which can move its rounding to bf16 by one
  ulp), with the share of differing elements at most 1e-3.
- The training forward, d(loss)/d(params) and one `Trainer.train_step`
  against JAX's: bf16 rounds at other places in the two frameworks (XLA
  keeps excess precision inside fused bf16 chains, and the JAX update
  block's segmented convs round each partial sum), so each value is held to
  twice JAX's own bf16-vs-fp32 gap on the same weights and batch, leaf by
  leaf for the gradients (tests/test_torch_mixed.py's rule for the
  forward).
- The port's copy of the convergence harness (`train/synthetic.py`) equal
  to `tests/synthetic_stereo.py`, array for array, and its `validate_epe`
  against the JAX helper on the same weights.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops.corr_pallas import _round_up, _scatter_pallas_padded, _w1_blocks
from raft_stereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raft_stereo_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from raft_stereo_tpu.train.trainer import TrainState, make_train_step
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import corr_cuda
from raft_stereo_tpu_torch.train import synthetic
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.trainer import Trainer
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixture)
    bf16_ulps,
    flat_leaves,
    flax_params,
    halve_kernels,
    jax_init,
    scatter_case,
    torch_single_thread,
)

import synthetic_stereo

BF16 = torch.bfloat16
H, W, ITERS, B = 48, 64, 3, 2
HID = (32, 32, 32)
MIXED = {"corr_implementation": "pallas", "mixed_precision": True, "corr_dtype": "bfloat16"}


# -- the plain bf16 scatter -----------------------------------------------------

# (B, H, W1, W2, levels, radius): the bench's widths (bf16 rows of 360,
# 180, 90 and 44 bytes), odd widths, a level of width 1, query counts that
# are not a multiple of the kernel's queries per block.
SCATTER_CASES = {
    "bench_widths": (1, 2, 180, 180, 4, 4),
    "odd_w2": (2, 3, 40, 37, 4, 4),
    "width_one": (1, 1, 9, 5, 3, 1),
    "r3_l2": (2, 2, 16, 23, 2, 3),
}


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_plain_bf16_scatter_matches_jax(rng, case):
    b, h, w1, w2, levels, radius = SCATTER_CASES[case]
    x, g, widths = scatter_case(rng, *SCATTER_CASES[case])
    g = torch.from_numpy(g).to(BF16)
    _, w1_pad = _w1_blocks(w1)
    shapes = [(b * h, w1_pad, _round_up(max(w, 1), 128)) for w in widths]
    g_jax = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    want = _scatter_pallas_padded(shapes, [jnp.bfloat16] * levels, jnp.asarray(x), g_jax, radius)
    before = dict(corr_cuda.LAUNCHES)
    got = corr_cuda.corr_scatter(torch.from_numpy(x), g, widths, radius, [BF16] * levels)
    assert corr_cuda.LAUNCHES == before  # CPU tensors: the plain version
    differing = total = 0
    for t, wl, w in zip(got, want, widths):
        assert t.dtype == BF16 and wl.dtype == jnp.bfloat16 and t.shape == (b, h, w1, w)
        ref = np.asarray(wl.astype(jnp.float32))[:, :w1, :w].reshape(b, h, w1, w)
        ulps = bf16_ulps(t.float().numpy(), ref)
        assert ulps.max() <= 1
        differing += int((ulps > 0).sum())
        total += ulps.size
        # Far-out queries (+-1e6 in the first row) write all-zero rows.
        assert not t.float().numpy().reshape(-1, w)[5:7].any()
    assert differing <= 1e-3 * total, differing / total
    # The same function as the fp32 scatter's, rounded once: cw in fp32 from
    # the widened cotangent.
    f32 = corr_cuda.corr_scatter(torch.from_numpy(x), g.float(), widths, radius)
    for t, t32 in zip(got, f32):
        assert torch.equal(t, t32.to(BF16))


def test_corr_lookup_bf16_backward_returns_each_levels_dtype(rng):
    """`CorrLookup` with bf16 taps: a bf16 cotangent reaches the scatter,
    and each level's gradient comes back in that level's dtype (bf16 and
    fp32 levels alike: autograd requires it, as JAX's VJP does)."""
    x, g, widths = scatter_case(rng, *SCATTER_CASES["odd_w2"])
    g = torch.from_numpy(g).to(BF16)
    b, h, w1 = x.shape
    for level_dtype in (BF16, torch.float32):
        levels = [torch.from_numpy(rng.standard_normal((b, h, w1, w)).astype(np.float32)).to(level_dtype)
                  .requires_grad_() for w in widths]
        taps = corr_cuda.corr_lookup(levels, torch.from_numpy(x), 4, BF16)
        assert taps.dtype == BF16 and type(taps.grad_fn).__name__ == "CorrLookupBackward"
        taps.backward(g)
        want = corr_cuda.plain_corr_scatter(torch.from_numpy(x), g, widths, 4, [level_dtype] * len(widths))
        for lvl, d in zip(levels, want):
            assert lvl.grad.dtype == level_dtype
            assert torch.equal(lvl.grad, d)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCATTER_CASES) + ["run_one"])
def test_bf16_scatter_kernel_matches_plain_on_cuda(rng, case):
    """The bf16 scatter kernel against its plain version on the card, bit
    for bit and across launches, for a bf16 or fp32 cotangent into bf16
    levels and a bf16 cotangent into fp32 levels, with NaN and infinite
    coordinates; "run_one" (radius 4000: one query per block) starts the
    spans at every 2-byte offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scatter kernel has no CPU form")
    shape = (1, 1, 61, 1001, 2, 4000) if case == "run_one" else SCATTER_CASES[case]
    x, g, widths = scatter_case(rng, *shape)
    g = torch.from_numpy(g).to(BF16)
    x.reshape(-1)[8:11] = [np.nan, np.inf, -np.inf]
    radius, levels = shape[-1], shape[-2]
    coords = torch.from_numpy(x).cuda()
    for grad_dtype, level_dtype in ((BF16, BF16), (torch.float32, BF16), (BF16, torch.float32)):
        grad = g.to(grad_dtype).cuda()
        dtypes = [level_dtype] * levels
        before = dict(corr_cuda.LAUNCHES)
        got = corr_cuda.corr_scatter(coords, grad, widths, radius, dtypes)
        again = corr_cuda.corr_scatter(coords, grad, widths, radius, dtypes)
        torch.cuda.synchronize()
        assert corr_cuda.LAUNCHES == dict(before, corr_scatter_bf16=before["corr_scatter_bf16"] + 2)
        want = corr_cuda.plain_corr_scatter(coords, grad, widths, radius, dtypes)
        bits = torch.int16 if level_dtype == BF16 else torch.int32
        for t, t2, w in zip(got, again, want):
            assert t.dtype == level_dtype
            assert torch.equal(t.view(bits), t2.view(bits)) and torch.equal(t.view(bits), w.view(bits))


# -- the training step ------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (B, H, W + 6, 3)).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, H, W, 1)).astype(np.float32)
    flow[0, :3, :5] = -800.0  # past max_flow: masked out
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32)
    return {"image1": left[:, :, 6:], "image2": left[:, :, :W], "flow": flow, "valid": valid}


def jax_config(**flags):
    return JaxConfig(hidden_dims=HID, encoder_s2d=False, remat_iterations=True, remat_save_corr=True, **flags)


def jax_objective(weights, batch, flags):
    """Loss, metrics, the blocked flows and d(loss)/d(params) of the JAX
    training objective (`make_train_step`'s loss_fn) in one jitted
    value_and_grad."""
    model = JaxRAFTStereo(jax_config(**flags))

    def loss_fn(params):
        flows = model.apply({"params": params, "batch_stats": weights["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        loss, metrics = jax_sequence_loss(flows, batch["flow"], batch["valid"], 0.9, 700.0)
        return loss, (metrics, flows)

    with jax.default_matmul_precision("highest"):
        (loss, (metrics, flows)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(weights["params"])
    return (float(loss), {k: float(v) for k, v in metrics.items()}, np.asarray(flows, np.float32),
            flat_leaves(grads))


@pytest.fixture(scope="module")
def jax_fp32(weights, batch):
    return jax_objective(weights, batch, {"corr_implementation": "pallas"})


@pytest.fixture(scope="module")
def jax_mixed(weights, batch):
    return jax_objective(weights, batch, MIXED)


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights)


def port_objective(weights, batch, **flags):
    model = port_model(weights, **flags)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    flows = model(t["image1"], t["image2"], iters=ITERS)
    loss, metrics = sequence_loss(flows, t["flow"], t["valid"])
    loss.backward()
    return model, loss.item(), {k: v.item() for k, v in metrics.items()}, flows.detach()


@pytest.fixture(scope="module")
def port_mixed(weights, batch):
    return port_objective(weights, batch, **MIXED)


def test_mixed_train_forward_matches_jax(weights, batch, jax_fp32, jax_mixed, port_mixed):
    """The blocked per-iteration flows of the mixed training forward
    ("pallas": the lookup kernel's plain version storing bf16 taps), fp32,
    within twice JAX's own bf16-vs-fp32 gap."""
    got = port_mixed[3]
    want16, want32 = jax_mixed[2], jax_fp32[2]
    assert got.dtype == torch.float32 and got.shape == (ITERS, B, H // 4, 4, W // 4, 4) == want16.shape
    assert np.abs(want32).max() > 1.0  # the flows moved
    gap = np.abs(want16 - want32).max()
    assert gap > 1e-3  # bf16 compute shows: the bound has a scale
    assert np.abs(got.numpy() - want16).max() <= 2 * gap


def test_mixed_reg_train_forward_matches_jax(weights, batch):
    """The same for "reg" (the plain lookup's fp32 taps of the bf16
    pyramid, cast to bf16 by the caller)."""
    flags = dict(MIXED, corr_implementation="reg")
    outs = {}
    for name, f in (("16", flags), ("32", {"corr_implementation": "reg"})):
        model = JaxRAFTStereo(jax_config(**f))
        with jax.default_matmul_precision("highest"):
            outs[name] = np.asarray(jax.jit(lambda v, a, b: model.apply(v, a, b, iters=ITERS))(
                weights, batch["image1"], batch["image2"]), np.float32)
    with torch.no_grad():
        got = port_model(weights, **flags)(*(torch.from_numpy(batch[k]) for k in ("image1", "image2")), iters=ITERS)
    gap = np.abs(outs["16"] - outs["32"]).max()
    assert gap > 1e-3
    assert got.dtype == torch.float32 and np.abs(got.numpy() - outs["16"]).max() <= 2 * gap


# Gradient bounds, in units of JAX's own bf16-vs-fp32 gap of the leaf
# (measured at this size: weights seed 0, batch seed 11, jax 0.9 and torch
# 2.13 on the CPU):
# - GAP_FACTOR for every leaf: measured at most 1.35 gaps outside the
#   context encoder's 1/32 branch.
# - COARSE_GAP_FACTOR for that branch (`cnet/layer5_*`, `cnet/out32_*`): at
#   48x64 its maps are 2x2 pixels, so each gradient sums a handful of
#   bf16-rounded terms and a rounding taken in one framework and skipped in
#   the other is not averaged away; the port's own bf16-vs-fp32 gap there is
#   up to 2.7 times JAX's, and the port is up to 2.6 JAX gaps from JAX's
#   bf16 gradient (layer5_1/conv1).
# A wrong gradient (a lost scatter term, a missing cast) is off by O(1).
GAP_FACTOR = 2.0
COARSE_GAP_FACTOR = 4.0
# Both sides' gradient of a feature-trunk conv bias (true value zero: an
# instance norm follows and removes any per-channel constant) is bf16
# rounding noise; held to this share of the model's largest fp32 gradient
# (measured: JAX's 9.7e-3, trunk/conv1; the port's 3.8e-4).
ZERO_GRAD_TOL = 2e-2
# AdamW's epsilon (both packages' default).
ADAM_EPS = 1e-8


def gap_factor(key) -> float:
    return COARSE_GAP_FACTOR if key[0] == "cnet" and key[1].startswith(("layer5", "out32")) else GAP_FACTOR


def test_mixed_gradients_match_jax(jax_fp32, jax_mixed, port_mixed):
    """The slice's acceptance test on the CPU: d(sequence_loss)/d(params) of
    the mixed configuration, remat on with the taps saved, every leaf fp32
    and within twice JAX's own bf16-vs-fp32 gap of that leaf."""
    model, loss, metrics, _ = port_mixed
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    got = flat_leaves(flax_params(model, grads=True))
    want16, want32 = jax_mixed[3], jax_fp32[3]
    assert set(got) == set(want16) == set(want32)
    largest = max(np.abs(g).max() for g in want32.values())
    for key, w16 in want16.items():
        name = "/".join(key)
        if key[:2] == ("fnet", "trunk") and key[-1] == "bias":
            assert max(np.abs(got[key]).max(), np.abs(w16).max()) <= ZERO_GRAD_TOL * largest, name
            continue
        gap = np.abs(w16 - want32[key]).max()
        assert gap > 0, name  # bf16 compute reaches every leaf
        assert np.abs(got[key] - w16).max() <= gap_factor(key) * gap, name
    assert abs(loss - jax_mixed[0]) <= 2 * abs(jax_mixed[0] - jax_fp32[0])


def test_mixed_train_step_matches_jax(weights, batch, jax_fp32, jax_mixed):
    """One mixed `Trainer.train_step` against one step of JAX's
    `make_train_step` from the same weights and optimizer state: the metrics
    within twice JAX's own bf16-vs-fp32 gap (the counting metrics also
    within one pixel of the valid count), the updated parameters as
    tests/test_torch_train.py holds them, with each leaf's gradient bound in
    place of its tolerance.

    The first AdamW step moves a parameter by lr (g / (|g| + eps) + wd p),
    g the clipped gradient. Where JAX's |g| is beyond 1.5 times the leaf's
    bound, both gradients have its sign and at least a third of its size, so
    the two updates differ by at most lr eps / (|g| / 3) from the gradients,
    plus 1e-3 lr as in the fp32 test (bf16 gradients are coarse enough that
    the mask head's, about 1e-7 after clipping, feel eps)."""
    jcfg = JaxTrainConfig(model=jax_config(**MIXED), batch_size=B, train_iters=ITERS, num_steps=1000)
    tx, schedule = jax_make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay, jcfg.grad_clip_norm)
    params = jax.tree.map(jnp.asarray, weights["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]), opt_state=tx.init(params))
    with jax.default_matmul_precision("highest"):
        new_state, want = jax.jit(make_train_step(jcfg, tx, schedule))(state, batch)
    want = {k: float(v) for k, v in want.items()}

    cfg = TrainConfig(model=RAFTStereoConfig(hidden_dims=HID, **MIXED), batch_size=B, train_iters=ITERS,
                      num_steps=1000)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    load_jax_variables(trainer.model, weights)
    before = flat_leaves(flax_params(trainer.model))
    got = trainer.train_step(batch)
    assert set(got) == set(want)
    assert got["learning_rate"] == want["learning_rate"] and got["nonfinite"] == want["nonfinite"] == 0.0
    loss32, metrics32, _, grads32 = jax_fp32
    ref32 = dict(metrics32, live_loss=loss32,
                 grad_norm=float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads32.values()))))
    pixel = 1.0 / batch["valid"].sum()
    for k, v32 in ref32.items():
        gap = abs(want[k] - v32)
        slack = pixel if k.endswith("px") else 0.0
        assert abs(got[k] - want[k]) <= 2 * gap + slack, (k, got[k], want[k], v32)

    lr = want["learning_rate"]
    after = flat_leaves(flax_params(trainer.model))
    g16 = jax_mixed[3]
    jnew = flat_leaves(jax.tree.map(np.asarray, new_state.params))
    for key, w_new in jnew.items():
        d_got, d_want = after[key] - before[key], w_new - before[key]
        assert np.abs(d_got - d_want).max() <= 2.0 * lr * (1 + 1e-3), key
        if key[:2] == ("fnet", "trunk") and key[-1] == "bias":
            continue  # a zero gradient's rounding noise: its sign is a coin
        gap = np.abs(g16[key] - grads32[key]).max()
        sure = np.abs(g16[key]) > 1.5 * gap_factor(key) * gap
        clipped = np.abs(g16[key]) * min(1.0, 1.0 / want["grad_norm"])
        ulp = np.spacing(np.maximum(np.abs(w_new), np.abs(after[key])))
        allow = lr * (1e-3 + 3 * ADAM_EPS / np.maximum(clipped, 1e-30)) + ulp
        assert (np.abs(d_got - d_want) <= allow)[sure].all(), key


# -- the convergence harness -----------------------------------------------------------

def test_synthetic_generator_equals_the_tests_copy():
    for seed in ((7, 0), (7, 599), (31337, 3), 5):
        for h, w in ((48, 64), (37, 50)):
            np.testing.assert_array_equal(synthetic._texture(np.random.default_rng(seed), h, w),
                                          synthetic_stereo._texture(np.random.default_rng(seed), h, w))
            for a, b in zip(synthetic.make_sample(np.random.default_rng(seed), h, w),
                            synthetic_stereo.make_sample(np.random.default_rng(seed), h, w)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        got = synthetic.make_batch(np.random.default_rng(seed), 4, 48, 64)
        want = synthetic_stereo.make_batch(np.random.default_rng(seed), 4, 48, 64)
        assert set(got) == set(want) == {"image1", "image2", "flow", "valid"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_validate_epe_matches_the_jax_helper(weights):
    """The port's held-out EPE (test-mode forward, samples from
    default_rng((31337, i))) against the JAX helper's on the same fp32
    weights: 1e-4 px, the test-mode forward's parity bound."""
    cfg = JaxConfig(hidden_dims=HID, encoder_s2d=False)
    state = types.SimpleNamespace(params=weights["params"], batch_stats=weights["batch_stats"])
    with jax.default_matmul_precision("highest"):
        want = synthetic_stereo.validate_epe(cfg, state, H, W, n=2, iters=2)
    got = synthetic.validate_epe(port_model(weights), H, W, n=2, iters=2)
    assert np.isfinite(got) and got > 0.1  # untrained: far from the disparity
    assert abs(got - want) <= 1e-4, (got, want)
