"""The PyTorch port's training step against the JAX package.

Shared (perturbed, kernel-halved — see tests/test_torch_model.py) weights
and a numpy batch at 48x64, batch 2, 3 iterations, with invalid pixels and
ground truth past `max_flow`. JAX runs fp32 under "highest" matmul
precision with `encoder_s2d=False` (the exact-parity regime of
tests/test_grad_parity.py; the port computes the direct convs), the Pallas
lookup and its scatter in interpret mode.

- The train-mode forward (blocked per-iteration flows) for "pallas" and
  "reg": rtol = atol = 1e-4, as the test-mode precedent.
- `sequence_loss` for both layouts: 1e-6 relative.
- `onecycle_linear`: exact; five clipped AdamW steps against optax: 1e-6
  relative.
- The acceptance test: d(sequence_loss)/d(params) against
  `jax.value_and_grad` of the JAX objective, remat on in both, each leaf
  within 5e-3 of its largest magnitude, the feature encoder's trunk within
  2e-1: the measured bounds with a margin, with their reasons at GRAD_TOL.
- One `Trainer.train_step` against the JAX `make_train_step`: metrics and
  updated parameters.
- Port-only: remat settings and the test-mode-only fused flags change no
  gradient; the non-finite policies; `fit` re-iterates its data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.train.loss import sequence_loss as jax_sequence_loss
from raft_stereo_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from raft_stereo_tpu.train.optimizer import onecycle_linear as jax_onecycle_linear
from raft_stereo_tpu.train.trainer import TrainState, make_train_step
from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import corr_cuda
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.optimizer import make_optimizer, onecycle_linear
from raft_stereo_tpu_torch.train.trainer import NonFiniteLossError, Trainer
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from raft_stereo_tpu_torch.utils.geometry import unblock_predictions
from torch_parity import (  # noqa: F401 (autouse fixtures)
    flat_leaves,
    flax_params,
    jax_init,
    torch_single_thread,
)

H, W, ITERS, B = 48, 64, 3, 2
HID = (32, 32, 32)
PALLAS = {"corr_implementation": "pallas"}
REG = {"corr_implementation": "reg"}


def _halve_kernels(tree):
    return {k: _halve_kernels(v) if isinstance(v, dict) else (0.5 * v if k == "kernel" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": _halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (B, H, W + 6, 3)).astype(np.float32)
    flow = -rng.uniform(0, 8, (B, H, W, 1)).astype(np.float32)
    flow[0, :3, :5] = -800.0  # past max_flow: masked out
    valid = (rng.uniform(0, 1, (B, H, W)) > 0.1).astype(np.float32)
    return {"image1": left[:, :, 6:], "image2": left[:, :, :W], "flow": flow, "valid": valid}


def jax_config(**flags):
    return JaxConfig(hidden_dims=HID, encoder_s2d=False, **flags)


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights)


def port_loss(model, batch, iters=ITERS):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    flows = model(t["image1"], t["image2"], iters=iters)
    return (flows, *sequence_loss(flows, t["flow"], t["valid"]))


@pytest.mark.parametrize("flags", [PALLAS, REG], ids=["pallas", "reg"])
def test_train_forward_matches_jax(weights, batch, flags):
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, a, b: JaxRAFTStereo(jax_config(**flags)).apply(v, a, b, iters=ITERS))(
            weights, batch["image1"], batch["image2"])
    want = np.asarray(want)
    got = port_model(weights, **flags)(*(torch.from_numpy(batch[k]) for k in ("image1", "image2")), iters=ITERS)
    assert got.shape == (ITERS, B, H // 4, 4, W // 4, 4) == want.shape
    assert got.requires_grad
    assert np.abs(want).max() > 1.0  # the flows moved: the comparison has teeth
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    assert unblock_predictions(got).shape == (ITERS, B, H, W, 1)


def test_fused_flags_do_not_touch_training(weights, batch):
    """`fused_encoder` and `fused_gru_tail` are test-mode only: a training
    forward and backward with them on is the one without them, bit for bit."""
    outs = []
    for flags in (PALLAS, dict(PALLAS, fused_encoder=True, fused_gru_tail=True)):
        model = port_model(weights, **flags)
        flows, loss, _ = port_loss(model, batch)
        loss.backward()
        outs.append((flows.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["blocked", "row_major"])
def test_sequence_loss_matches_jax(layout):
    rng = np.random.default_rng(5)
    n, f = 4, 4
    preds = rng.normal(-4, 3, (n, B, H // f, f, W // f, f)).astype(np.float32)
    gt = -rng.uniform(0, 9, (B, H, W, 1)).astype(np.float32)
    gt[1, 10:14, 20:30] = 750.0  # |gt| >= max_flow
    gt[0, 0, :8] = -700.0  # exactly max_flow: masked
    valid = rng.uniform(0, 1, (B, H, W)).astype(np.float32)  # >= 0.5 is valid
    if layout == "row_major":
        preds = preds.reshape(n, B, H, W, 1)
    want_loss, want = jax_sequence_loss(jnp.asarray(preds), jnp.asarray(gt), jnp.asarray(valid), 0.9, 700.0)
    got_loss, got = sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt), torch.from_numpy(valid), 0.9, 700.0)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-6)
    assert set(got) == set(want) == {"epe", "1px", "3px", "5px"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)
    # A single prediction takes gamma itself (no 15/(n-1) adjustment).
    one_j, _ = jax_sequence_loss(jnp.asarray(preds[:1]), jnp.asarray(gt), jnp.asarray(valid))
    one_t, _ = sequence_loss(torch.from_numpy(preds[:1]), torch.from_numpy(gt), torch.from_numpy(valid))
    np.testing.assert_allclose(one_t.item(), float(one_j), rtol=1e-6)


@pytest.mark.parametrize("peak,total", [(2e-4, 100_100), (1e-3, 350)])
def test_onecycle_matches_optax(peak, total):
    want = jax_onecycle_linear(peak, total)
    got = onecycle_linear(peak, total)
    warmup_end = max(int(round(0.01 * total)) - 1, 1)
    for step in (0, 1, warmup_end - 1, warmup_end, warmup_end + 1, total // 2, total - 2, total - 1, total + 5):
        assert got(step) == float(want(jnp.int32(step))), step


@pytest.mark.parametrize("scale", [10.0, 1e-3], ids=["norm_over_1", "norm_under_1"])
def test_optimizer_matches_optax(scale):
    """Five steps of clip + AdamW + schedule on the same params and the same
    gradient sequence as the JAX package's optax chain."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4, 5), "b": (7,), "c": (2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s) / 4).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tx, _ = jax_make_optimizer(2e-4, 200, 1e-5, 1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, _ = make_optimizer(list(tp.values()), 2e-4, 200, 1e-5, 1.0)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.clip_grads_()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        assert (norm.item() > 1.0) == (scale > 1.0)
        opt.step()
    assert opt.count == 5
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def jax_grads(weights, batch):
    """Loss, metrics and d(loss)/d(params) of the JAX training objective
    (`make_train_step`'s loss_fn), "pallas", remat on."""
    model = JaxRAFTStereo(jax_config(remat_iterations=True, remat_save_corr=True, **PALLAS))

    def loss_fn(params):
        flows = model.apply({"params": params, "batch_stats": weights["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        return jax_sequence_loss(flows, batch["flow"], batch["valid"], 0.9, 700.0)

    with jax.default_matmul_precision("highest"):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(weights["params"])
    return float(loss), {k: float(v) for k, v in metrics.items()}, flat_leaves(grads)


def port_grads(weights, batch, **flags):
    model = port_model(weights, **PALLAS, **flags)
    _, loss, metrics = port_loss(model, batch)
    loss.backward()
    return loss.item(), {k: v.item() for k, v in metrics.items()}, flat_leaves(flax_params(model, grads=True))


# Gradient tolerances, from measurement at this size (weights seed 0, batch
# seed 11, jax 0.9 and torch 2.13 on the CPU) with the reason for each. Two
# fp32 effects make a gradient leaf differ between two correct
# implementations by more than a forward does:
# - A relu whose pre-activation lies within rounding of 0 takes the other
#   branch, and its unit's gradient jumps; every leaf upstream of it moves.
#   Measured: the port's fp32 gradients differ from a float64 run of the port
#   by up to 7.5e-4 of the leaf's largest magnitude outside the feature
#   encoder, JAX's by up to 4e-7 on this input, and the port's from JAX's by
#   up to 7.5e-4 (cnet/trunk/conv1). Another XLA may round JAX's forward
#   across other kinks: held to GRAD_TOL = 5e-3.
# - The feature encoder's convs pass an instance norm in every block, and
#   for the cotangent the correlation hands back, that norm's fp32 backward
#   is ill-conditioned: the port and JAX each differ from the float64 run by
#   up to 4e-2 (layer1_0/conv1: JAX 4.0e-2, port 2.5e-3; layer2_1/conv2:
#   both 3e-2). Held to FNET_TOL = 2e-1, against JAX and against the
#   float64 run alike.
# - The biases there have a true gradient of zero (the norm removes any
#   per-channel constant): both sides' values are rounding noise, held to
#   1e-6 of the largest gradient of the model.
# A wrong gradient (a missing detach, a lost scatter term) is off by O(1).
GRAD_TOL = 5e-3
FNET_TOL = 2e-1


def test_gradients_match_jax(weights, batch, jax_grads):
    """The slice's acceptance test: every parameter's gradient of the
    training loss, port ("pallas", remat on, taps saved) against JAX, and
    both against a float64 run of the port on the same weights and batch."""
    want_loss, want_metrics, want = jax_grads
    loss, metrics, got = port_grads(weights, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
    arbiter = port_model(weights, **PALLAS).double()
    _, loss64, _ = port_loss(arbiter, {k: v.astype(np.float64) for k, v in batch.items()})
    loss64.backward()
    exact = flat_leaves(flax_params(arbiter, grads=True))
    assert set(got) == set(want) == set(exact)
    largest = max(np.abs(g).max() for g in exact.values())
    fnet = {k for k in want if k[0] == "fnet" and k[1] == "trunk"}
    for key, w in want.items():
        name = "/".join(key)
        if key in fnet and key[-1] == "bias":
            assert max(np.abs(got[key]).max(), np.abs(w).max()) <= 1e-6 * largest, name
            continue
        tol = FNET_TOL if key in fnet else GRAD_TOL
        np.testing.assert_allclose(got[key], w, atol=tol * np.abs(w).max(), rtol=0, err_msg=name)
        for side in (got[key], w):
            np.testing.assert_allclose(side, exact[key], atol=tol * np.abs(exact[key]).max(), rtol=0,
                                       err_msg=name)


def test_remat_settings_give_the_same_gradients(weights, batch):
    """Per-iteration checkpointing, with the taps saved or recomputed, and
    no checkpointing give the same port gradients."""
    runs = [port_grads(weights, batch, remat_iterations=r, remat_save_corr=s)
            for r, s in ((True, True), (True, False), (False, True))]
    for loss, _, grads in runs[1:]:
        assert loss == runs[0][0]
        for key, g in grads.items():
            np.testing.assert_allclose(g, runs[0][2][key], rtol=0, atol=1e-6 * np.abs(g).max(),
                                       err_msg="/".join(key))


def test_train_step_matches_jax(weights, batch):
    """One `Trainer.train_step` against one step of the JAX `make_train_step`
    from the same weights and optimizer state: the whole metrics dict and
    the updated parameters."""
    jcfg = JaxTrainConfig(model=jax_config(**PALLAS), batch_size=B, train_iters=ITERS, num_steps=1000)
    tx, schedule = jax_make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay, jcfg.grad_clip_norm)
    params = jax.tree.map(jnp.asarray, weights["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]), opt_state=tx.init(params))
    with jax.default_matmul_precision("highest"):
        new_state, want = jax.jit(make_train_step(jcfg, tx, schedule))(state, batch)
    want = {k: float(v) for k, v in want.items()}

    cfg = TrainConfig(model=RAFTStereoConfig(hidden_dims=HID, **PALLAS), batch_size=B, train_iters=ITERS,
                      num_steps=1000)
    trainer = Trainer(cfg, (H, W, 3), device="cpu")
    load_jax_variables(trainer.model, weights)
    before = flat_leaves(flax_params(trainer.model))
    launches = dict(corr_cuda.LAUNCHES)
    got = trainer.train_step(batch)
    assert set(got) == set(want) == {"epe", "1px", "3px", "5px", "live_loss", "grad_norm", "nonfinite",
                                     "learning_rate"}
    assert got["learning_rate"] == want["learning_rate"] == trainer.schedule(0)
    assert abs(got["learning_rate"] / (2e-4 / 25) - 1) < 1e-5  # the one-cycle floor, peak / 25
    assert got["nonfinite"] == want["nonfinite"] == 0.0
    for k in ("epe", "1px", "3px", "5px", "live_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # The norm sums every gradient, the feature encoder's included (see
    # FNET_TOL); they are a small share of it.
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert trainer.step == 1 and trainer.optimizer.count == 1
    assert corr_cuda.LAUNCHES == launches  # CPU tensors: the plain versions

    # The first AdamW step moves each parameter by lr * (g / (|g| + eps) +
    # wd * p): about lr * sign(g), which no gradient tolerance pins where
    # |g| sits within the two gradients' difference. Hold each update to
    # 1e-3 lr (plus the rounding of the new value) where the gradient is
    # above 1.5 times its leaf's tolerance (GRAD_TOL, FNET_TOL), and every
    # update to the step's size.
    lr = want["learning_rate"]
    after = flat_leaves(flax_params(trainer.model))
    # The step's (clipped) gradients mark where |g| is well resolved.
    jgrad = flat_leaves(flax_params(trainer.model, grads=True))
    jnew = flat_leaves(jax.tree.map(np.asarray, new_state.params))
    for key, w_new in jnew.items():
        d_got, d_want = after[key] - before[key], w_new - before[key]
        assert np.abs(d_got - d_want).max() <= 2.0 * lr * (1 + 1e-3), key
        if key[:2] == ("fnet", "trunk") and key[-1] == "bias":
            continue  # a zero gradient's rounding noise: its sign is a coin
        g = np.abs(jgrad[key])
        sure = g > 1.5 * (FNET_TOL if key[:2] == ("fnet", "trunk") else GRAD_TOL) * g.max()
        # Each side rounds p + update to the parameter's own spacing.
        ulp = np.spacing(np.maximum(np.abs(w_new), np.abs(after[key])))
        assert (np.abs(d_got - d_want) <= 1e-3 * lr + ulp)[sure].all(), key


def small_trainer(policy="raise", num_steps=5):
    cfg = TrainConfig(model=RAFTStereoConfig(hidden_dims=(16, 16, 16), **PALLAS), batch_size=B, train_iters=1,
                      num_steps=num_steps, nan_policy=policy)
    return Trainer(cfg, (H, W, 3), device="cpu")


def test_nonfinite_step_is_skipped_or_raises(batch):
    bad = dict(batch, image1=np.full_like(batch["image1"], np.nan))
    trainer = small_trainer("skip")
    before = [p.detach().clone() for p in trainer.model.parameters()]
    out = trainer.train_step(bad)
    assert out["nonfinite"] == 1.0 and not np.isfinite(out["live_loss"])
    # Params and optimizer state untouched (the moments, made at the first
    # dispatch as optax makes them at init, all zero; the count 0); the
    # step count (and the schedule it reads) advances.
    assert all(torch.equal(a, p) for a, p in zip(before, trainer.model.parameters()))
    assert trainer.optimizer.count == 0
    assert all(not v.any() for st in trainer.optimizer.state.values() for v in st.values())
    assert trainer.step == 1 and out["learning_rate"] == trainer.schedule(0)
    good = trainer.train_step(batch)
    assert good["nonfinite"] == 0.0 and good["learning_rate"] == trainer.schedule(1)
    assert trainer.optimizer.count == 1 and trainer.step == 2
    with pytest.raises(NonFiniteLossError):
        small_trainer("raise").train_step(bad)
    with pytest.raises(ValueError, match="nan_policy"):
        TrainConfig(nan_policy="sometimes")


def test_fit_reiterates_its_data(batch, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # fit writes its final checkpoint and run report
    trainer = small_trainer(num_steps=3)
    seen = []

    class Data:
        def __iter__(self):
            seen.append(len(seen))
            return iter([batch, batch])

    out = trainer.fit(Data())
    assert trainer.step == 3 and seen == [0, 1]
    assert np.isfinite(out["live_loss"]) and out["nonfinite"] == 0.0
    with pytest.raises(ValueError, match="shape"):
        trainer.train_step(dict(batch, valid=batch["valid"][:, :-1]))
