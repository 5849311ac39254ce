"""The mixed-precision (bf16) slice of the PyTorch port against the JAX package.

The JAX bench's configuration (`corr_implementation="pallas"`,
`mixed_precision=True`, `corr_dtype="bfloat16"`, `fused_encoder=True`) and
its pieces, each on the same numpy inputs made from a seed:

- config and CLI: the JAX defaults and validation of `mixed_precision` and
  `corr_dtype`, the CLI's rule that `reg_cuda` with `--mixed_precision`
  stores a bf16 pyramid, and the combinations that are not ported yet,
  which raise with "not ported yet" in the config or the CLI;
- the plain bf16 volume and pyramid (`ops/corr.py`, and `fused_pyramid_state`
  on CPU tensors) against `corr_volume`/`corr_pyramid` and against the
  Pallas `fused_pyramid_state` in interpret mode;
- the plain lookup at the four (level, tap) dtype pairs against
  `_lookup_pallas_padded` in interpret mode;
- the plain bf16 conv and join (`ops/encoder_cuda.py`) against
  `fused_conv_s2d` and `fused_join_s2d` in interpret mode;
- `InstanceNorm`, `FrozenBatchNorm` and `Conv` on bf16 inputs;
- the whole mixed forward for "reg" and for "pallas" + `fused_encoder`;
- the anytime engine at bf16 against the direct bf16 forward;
- the bf16-vs-fp32 pyramid's EPE delta against `BF16_CORR_EPE_BUDGET_PX`.

Tolerances come from bf16 rounding, where one bf16 ulp is 2**-7 of a
value's power of two (8 significant bits). XLA on the CPU keeps excess
precision in fused bf16 elementwise chains (Pallas interpret mode runs
through it too), so the JAX side may skip a rounding that the port takes:
the port rounds after every op, as each torch op on bf16 tensors does.

- Volume, pyramid, lookup, conv, join: at most 1 bf16 ulp per element
  (a skipped rounding, or an fp32 sum taken in another order, can move a
  value across one rounding boundary); the conv's fp32 statistics are over
  the stored bf16 outputs in the port and may be over the unrounded ones
  in JAX: |d sum| <= 2**-8 sum |y| and |d sumsq| <= 2**-7 sum y**2 (half
  an ulp of relative error per value, doubled for the square, with a
  factor 2 to spare).
- The model: the JAX update block's segmented convs round each
  per-segment partial to bf16 before the sum, where the port's concat conv
  rounds once, and the fused elementwise chains above differ the same way;
  so the port's mixed forward is held to no more than twice JAX's own
  bf16-vs-fp32 gap on the same weights and inputs (48x64, 2 iterations,
  conv kernels halved as in tests/test_torch_model.py).
- The EPE delta: the budget itself, 0.05 px, on the port's own seeded
  weights (see `test_bf16_corr_epe_delta_within_budget`), and the port's
  delta within a tenth of the budget of JAX's on the same weights.

`gpu`-marked tests hold the four bf16 kernel variants against their plain
versions on the card: lookup and join exactly; the pyramid and the conv,
which sum on the tensor cores in another order than cuBLAS and cuDNN, to 1
bf16 ulp of each value (for the conv also of its pre-bias sum, which is
rounded before the bias is added) plus 2**-15 of the tensor's largest
magnitude, with pooled levels inheriting their inputs' allowance
(chip_smoke.py states the same checks).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import cli as jcli
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.data.datasets import make_synthetic_sequence
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.models import layers as jlayers
from raft_stereo_tpu.models.layers import dense_w_kernel, w_s2d
from raft_stereo_tpu.ops import corr as jcorr
from raft_stereo_tpu.ops import corr_pallas as jcp
from raft_stereo_tpu.ops import encoder_pallas as jenc
from raft_stereo_tpu_torch import cli, evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig, TrainConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models import layers
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import corr, corr_cuda, encoder_cuda, gates
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixtures)
    bf16_ulps,
    flax_params,
    halve_kernels,
    jax_apply,
    jax_init,
    nchw,
    nhwc,
    numpy_tree,
    pallas_tpu_compiler_params,
    torch_single_thread,
)

BF16 = torch.bfloat16
C = 64
H, W, ITERS = 48, 64, 2
HID = (32, 32, 32)
MIXED = {"mixed_precision": True, "corr_dtype": "bfloat16"}
BENCH = dict(MIXED, corr_implementation="pallas", fused_encoder=True)


def to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16 (round to nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16).float().numpy()


def jnp_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- config and CLI -------------------------------------------------------------

def test_config_defaults_and_validation_match_jax():
    port, ref = RAFTStereoConfig(), JaxConfig()
    assert (port.mixed_precision, port.corr_dtype) == (ref.mixed_precision, ref.corr_dtype) == (False, "float32")
    for cls in (RAFTStereoConfig, JaxConfig):
        with pytest.raises(ValueError, match="corr_dtype"):
            cls(corr_dtype="float16")
    assert RAFTStereoConfig(**BENCH).corr_dtype == "bfloat16"
    # A bf16 pyramid with fp32 compute keeps the fp32 tail kernels.
    assert RAFTStereoConfig(corr_dtype="bfloat16", fused_gru_tail=True).fused_gru_tail


@pytest.mark.parametrize("flags", [
    dict(mixed_precision=True, fused_gru_tail=True),
    dict(mixed_precision=True, corr_implementation="pallas", prefetch_lookup=True),
    dict(corr_dtype="bfloat16", corr_implementation="pallas", prefetch_lookup=True),
], ids=["mixed+fused_gru_tail", "mixed+prefetch_lookup", "bf16_corr+prefetch_lookup"])
def test_config_refuses_unported_bf16_combinations(flags):
    with pytest.raises(ValueError, match="not ported yet"):
        RAFTStereoConfig(**flags)


@pytest.mark.parametrize("flags", [dict(mixed_precision=True), dict(corr_dtype="bfloat16")],
                         ids=["mixed", "bf16_corr"])
def test_training_refuses_bf16(flags):
    """Since the bf16 scatter (tests/test_torch_mixed_train.py) bf16
    training is ported: the name is kept, the refusal is gone. Each flag,
    with the "pallas" lookup, is accepted by `TrainConfig`, one CPU training
    forward and backward runs, and every parameter gradient is fp32 (the
    layers cast the fp32 parameters at use); the lookup under autograd
    returns each level's gradient in the level's dtype."""
    cfg = RAFTStereoConfig(hidden_dims=(16, 16, 16), corr_implementation="pallas", **flags)
    assert TrainConfig(model=cfg).model == cfg
    model = build_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    img1, img2 = (torch.from_numpy(rng.uniform(0, 255, (1, 32, 64, 3)).astype(np.float32)) for _ in range(2))
    flows = model(img1, img2, iters=2, test_mode=False)
    assert flows.dtype == torch.float32 and flows.shape == (2, 1, 8, 4, 16, 4)
    flows.abs().mean().backward()
    assert all(p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    levels = [torch.zeros((1, 2, 8, 8), dtype=BF16, requires_grad=True)]
    corr_cuda.corr_lookup(levels, torch.zeros((1, 2, 8)), 1, BF16).sum().backward()
    assert levels[0].grad.dtype == BF16 and levels[0].grad.shape == (1, 2, 8, 8)


def test_gate_switch_refused_under_mixed_precision(monkeypatch):
    monkeypatch.setenv(gates.ENV_VAR, "1")
    model = build_model(RAFTStereoConfig(hidden_dims=(16, 16, 16), mixed_precision=True), seed=0, device="cpu")
    img = torch.zeros((1, 32, 64, 3))
    with torch.inference_mode(), pytest.raises(ValueError, match="not ported yet"):
        model(img, img, iters=1, test_mode=True)
    with pytest.raises(ValueError, match="not ported yet"):
        cli.main(["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", "--mixed_precision"])


def parse_model_args(add_model_args, argv):
    p = argparse.ArgumentParser()
    add_model_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [], ["--mixed_precision"], ["--corr_implementation", "reg_cuda"],
    ["--corr_implementation", "reg_cuda", "--mixed_precision"],
    ["--corr_implementation", "reg_cuda", "--mixed_precision", "--corr_dtype", "float32"],
    ["--corr_implementation", "pallas", "--mixed_precision"],
    ["--corr_dtype", "bfloat16"],
    ["--corr_implementation", "reg_cuda", "--mixed_precision", "--fused_encoder"],
], ids=["default", "mixed", "reg_cuda", "reg_cuda+mixed", "reg_cuda+mixed+fp32", "pallas+mixed", "bf16",
        "bench"])
def test_cli_dtype_rule_matches_jax(argv):
    """The JAX CLI's default rule: a bf16 pyramid only for `reg_cuda` with
    `--mixed_precision`, unless `--corr_dtype` says otherwise."""
    port = cli._model_config(parse_model_args(cli._add_model_args, argv))
    ref = jcli._model_config(parse_model_args(jcli._add_model_args, argv))
    for field in ("corr_implementation", "mixed_precision", "corr_dtype", "fused_encoder"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("flags", [["--mixed_precision", "--fused_gru_tail"],
                                   ["--corr_dtype", "bfloat16", "--prefetch_lookup"]],
                         ids=["mixed+fused_gru_tail", "bf16+prefetch_lookup"])
def test_cli_refuses_unported_bf16(flags):
    with pytest.raises(ValueError, match="not ported yet"):
        cli.main(["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", *flags])


# -- correlation ------------------------------------------------------------------

@pytest.mark.parametrize("shape,levels", [((2, 4, 24, 16), 4), ((1, 2, 37, 16), 3), ((1, 3, 150, 32), 4)],
                         ids=["small", "odd_w", "multi_tile"])
def test_plain_bf16_pyramid_matches_jax(rng, shape, levels):
    """fp32 maps rounded to bf16 by the contract; the fused form on CPU
    tensors takes permuted NCHW views, as the model passes them."""
    b, h, w, d = shape
    f1, f2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = jcorr.corr_pyramid(jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2), out_dtype=jnp.bfloat16), levels)
    want_fused = jax.jit(lambda a, c: jcp.fused_pyramid_state(a, c, levels, corr_dtype=jnp.bfloat16))(
        jnp.asarray(f1), jnp.asarray(f2))
    got = corr.corr_pyramid(corr.corr_volume(torch.from_numpy(f1), torch.from_numpy(f2), BF16), levels)
    t1, t2 = (torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1) for f in (f1, f2))
    before = dict(corr_cuda.LAUNCHES)
    got_fused = corr_cuda.fused_pyramid_state(t1, t2, levels, BF16)
    assert corr_cuda.LAUNCHES == before  # CPU tensors take the plain version
    for l, (g, gf, wl, wf) in enumerate(zip(got, got_fused, want, want_fused)):
        w2 = w >> l
        assert g.dtype == gf.dtype == BF16 and wl.dtype == wf.dtype == jnp.bfloat16
        assert g.shape == gf.shape == (b, h, w, w2) and gf.is_contiguous()
        ref_fused = jnp_f32(wf)[:, :w, :w2].reshape(b, h, w, w2)
        assert bf16_ulps(g, jnp_f32(wl)).max() <= 1
        assert bf16_ulps(gf, ref_fused).max() <= 1
        assert torch.equal(g, gf)


def test_fp32_pyramid_of_bf16_maps_widens_them(rng):
    """Mixed precision with an fp32 pyramid: bf16 feature maps are taken as
    their fp32 values (JAX's `_corr_state` widens them)."""
    f1, f2 = (to_bf16(rng.standard_normal((1, 3, 40, 16)).astype(np.float32)) for _ in range(2))
    want = jcorr.corr_pyramid(jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2)), 4)
    got = corr_cuda.fused_pyramid_state(torch.from_numpy(f1).to(BF16), torch.from_numpy(f2).to(BF16), 4)
    for g, wl in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("level_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_lookup_dtype_pairs_match_jax(rng, level_dtype, out_dtype):
    """fp32 interpolation, one rounding to the tap dtype: fp32 taps to
    1e-6 (XLA contracts the lerp into a fused multiply-add on the CPU),
    bf16 taps to 1 bf16 ulp."""
    b, h, w1, w2 = 2, 3, 40, 150
    jl, tl = [], []
    for l in range(4):
        v = rng.standard_normal((b, h, w1, w2 >> l)).astype(np.float32)
        jl.append(jnp.asarray(v).astype(level_dtype))
        tl.append(torch.from_numpy(v).to(getattr(torch, level_dtype)))
    x = np.arange(w1, dtype=np.float32)[None, None] - rng.uniform(0, w2 / 3, (b, h, w1))
    x = np.where(rng.uniform(0, 1, x.shape) < 0.15, rng.uniform(-3 * w2, 3 * w2, x.shape), x).astype(np.float32)
    x[0, 0, :4] = [-1.0, 0.0, w2 - 1.0, float(w2)]
    padded = jcp.pad_pyramid(jl, (b, h, w1))
    want = jcp._lookup_pallas_padded(padded, jnp.asarray(x), 4, jnp.dtype(out_dtype))
    got = corr_cuda.corr_lookup(tl, torch.from_numpy(x), 4, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and want.dtype == jnp.dtype(out_dtype)
    assert got.shape == (b, h, w1, 36)
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    else:
        assert bf16_ulps(got, jnp_f32(want)).max() <= 1


# -- fused encoder layer1 -----------------------------------------------------------

def conv_params(rng):
    k = (rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)
    return k, (0.1 * rng.standard_normal(C)).astype(np.float32)


def affine_rows(rng, b, form):
    if form == "in":
        first, second = 0.3 * rng.standard_normal((b, C)), rng.uniform(0.5, 2.0, (b, C))
    else:
        first, second = rng.uniform(0.5, 2.0, (b, C)), 0.3 * rng.standard_normal((b, C))
    return np.stack([first, second], axis=1).astype(np.float32)


def tile2(a):
    return None if a is None else jnp.asarray(np.concatenate([a, a], axis=-1))


@pytest.mark.parametrize("form", ["none", "in", "bn"])
def test_plain_bf16_conv_matches_jax(rng, form):
    b, hh, w = 2, 6, 16
    x = to_bf16(rng.standard_normal((b, hh, w, C)).astype(np.float32))
    k, bias = conv_params(rng)
    aff = None if form == "none" else affine_rows(rng, b, form)
    y, st = jax.jit(lambda x, w_, b_, a: jenc.fused_conv_s2d(x, w_, b_, a, form, emit_stats=True))(
        w_s2d(jnp.asarray(x).astype(jnp.bfloat16)), dense_w_kernel(jnp.asarray(k)).astype(jnp.bfloat16),
        tile2(bias), tile2(aff))
    want_y = jnp_f32(y).reshape(x.shape)
    want_s = np.asarray(st)[..., :C] + np.asarray(st)[..., C:]
    got_y, got_s = encoder_cuda.fused_conv(
        nchw(x).to(BF16), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias),
        None if aff is None else torch.from_numpy(aff), form, True)
    assert got_y.dtype == BF16 and got_s.dtype == torch.float32
    assert bf16_ulps(nhwc(got_y.float()), want_y).max() <= 1
    yf = nhwc(got_y.float()).astype(np.float64)
    sum_abs = np.abs(yf).sum(axis=(1, 2))
    sum_sq = (yf * yf).sum(axis=(1, 2))
    assert (np.abs(got_s.numpy()[:, 0] - want_s[:, 0]) <= 2.0**-8 * sum_abs).all()
    assert (np.abs(got_s.numpy()[:, 1] - want_s[:, 1]) <= 2.0**-7 * sum_sq).all()


@pytest.mark.parametrize("skip_form", ["none", "in", "bn"])
@pytest.mark.parametrize("y_form", ["in", "bn"])
def test_plain_bf16_join_matches_jax(rng, y_form, skip_form):
    b, hh, w = 2, 6, 16
    skip, y = (to_bf16(rng.standard_normal((b, hh, w, C)).astype(np.float32)) for _ in range(2))
    aff_y = affine_rows(rng, b, y_form)
    aff_s = None if skip_form == "none" else affine_rows(rng, b, skip_form)
    want = jax.jit(lambda s, v, a, c: jenc.fused_join_s2d(s, v, a, y_form, c, skip_form))(
        w_s2d(jnp.asarray(skip).astype(jnp.bfloat16)), w_s2d(jnp.asarray(y).astype(jnp.bfloat16)),
        tile2(aff_y), tile2(aff_s))
    got = encoder_cuda.fused_join(nchw(skip).to(BF16), nchw(y).to(BF16), torch.from_numpy(aff_y), y_form,
                                  None if aff_s is None else torch.from_numpy(aff_s), skip_form)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert bf16_ulps(nhwc(got.float()), jnp_f32(want).reshape(skip.shape)).max() <= 1


# -- layers ------------------------------------------------------------------------

def test_bf16_layers_match_jax(rng):
    """Conv (cast at use, bias after the rounded conv), FrozenBatchNorm
    (fp32 fold, one cast) and InstanceNorm (fp32 statistics) on bf16
    inputs, parameters fp32 on both sides; the port's parameters stay fp32."""
    x = to_bf16(rng.standard_normal((2, 12, 16, 8)).astype(np.float32))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    cases = [
        (jlayers.Conv(16, (3, 3)), layers.Conv(8, 16, 3)),
        (jlayers.FrozenBatchNorm(8), layers.FrozenBatchNorm(8)),
        (jlayers.InstanceNorm(8), layers.InstanceNorm(8)),
    ]
    for jm, tm in cases:
        v = jax_init(jm, xj)
        want = jax.jit(lambda v_, a: jm.apply(v_, a))(v, xj)
        with torch.no_grad():
            if isinstance(tm, layers.Conv):
                tm.weight.copy_(torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()))
                tm.bias.copy_(torch.from_numpy(v["params"]["Conv_0"]["bias"]))
            elif isinstance(tm, layers.FrozenBatchNorm):
                for name, (col, key) in {"weight": ("params", "scale"), "bias": ("params", "bias"),
                                         "running_mean": ("batch_stats", "mean"),
                                         "running_var": ("batch_stats", "var")}.items():
                    getattr(tm, name).copy_(torch.from_numpy(v[col][key]))
            got = tm(nchw(x).to(BF16))
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16, type(tm).__name__
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        # One rounding more or less per op: the conv's sum and bias add,
        # the affine's product and sum, the norm's difference and product.
        assert bf16_ulps(nhwc(got.float()), jnp_f32(want)).max() <= 2, type(tm).__name__


# -- the whole forward ---------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """One perturbed JAX init, conv kernels halved (tests/test_torch_model.py
    `weights` says why)."""
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    left = rng.uniform(0, 255, (1, H, W + 6, 3)).astype(np.float32)
    return left[:, :, 6:], left[:, :, :W]


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights).eval()


@pytest.mark.parametrize("flags", [dict(corr_implementation="reg"),
                                   dict(corr_implementation="pallas", fused_encoder=True)],
                         ids=["reg", "pallas+fused_encoder"])
def test_mixed_forward_matches_jax(weights, images, flags):
    jax32 = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **flags)), weights, *images, iters=ITERS,
                      test_mode=True)
    jax16 = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **MIXED, **flags)), weights, *images,
                      iters=ITERS, test_mode=True)
    model = port_model(weights, **MIXED, **flags)
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, images), iters=ITERS, test_mode=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert got[0].shape == (1, H // 4, W // 4) and got[1].shape == (1, H, W, 1)
    assert np.abs(jax32[1]).max() > 1.0  # the flows moved
    for g, w16, w32 in zip(got, jax16, jax32):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        gap = np.abs(w16 - w32).max()
        assert gap > 1e-3  # bf16 compute shows: the bound below has a scale
        assert np.abs(g.numpy() - w16).max() <= 2 * gap


def test_mixed_anytime_engine_equals_direct_forward(weights, images):
    """The bench configuration's bf16 carry through prelude, chunks and
    finalize (coordinates fp32) equals the direct bf16 forward exactly,
    through `AnytimeEngine.run_batch` too."""
    model = port_model(weights, **BENCH)
    i1, i2 = map(torch.from_numpy, images)
    with torch.inference_mode():
        direct = model(i1, i2, iters=4, test_mode=True)
        state = anytime.prelude(model, i1, i2)
        assert state["net"][0].dtype == BF16 and state["context"][0][0].dtype == BF16
        assert state["coords1"].dtype == torch.float32 and state["corr"][0].dtype == BF16
        for _ in range(2):
            state = anytime.chunk(model, state, 2)
        chunked = anytime.finalize(model, state)
    for a, b in zip(direct, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    cfg = ServeConfig(model=RAFTStereoConfig(hidden_dims=HID, **BENCH), buckets=((H, W),), max_batch=1,
                      chunk_iters=2, max_iters=4, divis_by=16)
    engine = AnytimeEngine(cfg, model, device="cpu")
    assert engine.warm()["combos"] == 1
    (res,) = engine.run_batch((H, W), i1, i2, deadlines_s=[None], max_iters=[4])
    assert res.iters_completed == 4 and not res.early_exit
    np.testing.assert_array_equal(res.flow_up, direct[1][0].numpy())
    np.testing.assert_array_equal(res.flow_lowres, direct[0][0].numpy())


def identity_stats(tree):
    """A flax batch_stats tree of shapes filled with mean 0 and var 1."""
    return {k: identity_stats(v) if isinstance(v, dict) else np.full(v.shape, float(k == "var"), np.float32)
            for k, v in tree.items()}


def test_bf16_corr_epe_delta_within_budget():
    """The bf16 pyramid's EPE delta against the fp32 pyramid in the budget's
    regime (tests/test_fast_path.py `test_bf16_epe_delta_within_budget`):
    fp32 compute, "reg", the pair `make_synthetic_sequence` makes at
    128x192 (`evaluate.synthetic_plane_pair`, the port's copy of it,
    checked equal here), 2 iterations, the default architecture at random
    init; measured by `evaluate.corr_precision`, which chip_smoke.py also
    runs on the card.

    The weights are the port's own seeded draw (`build_model(..., seed=0)`,
    a torch generator on the CPU), the same on every machine. The JAX
    test's draw, flax init from PRNGKey(0), depends on the JAX version's
    random-bit defaults, and under jax 0.9.0 the JAX test itself exceeds
    the budget on it (0.088 px). At random init the GRU amplifies the
    pyramid's rounding chaotically (the JAX package's `ops/corr.py`), so one
    draw's delta is a noisy sample: the port is also held to JAX's own
    delta on the same weights and pair, within a tenth of the budget."""
    h, w = 128, 192
    frame = make_synthetic_sequence(np.random.default_rng(5), 1, h, w)[0]
    mine = evaluate.synthetic_plane_pair(np.random.default_rng(5), h, w)
    for key in ("image1", "image2", "flow", "valid"):
        np.testing.assert_array_equal(mine[key], frame[key])
    assert corr.BF16_CORR_EPE_BUDGET_PX == jcorr.BF16_CORR_EPE_BUDGET_PX == 0.05
    got = evaluate.corr_precision(RAFTStereoConfig(corr_implementation="reg"), seed=0, device="cpu")
    assert got["budget_px"] == 0.05 and got["delta_px"] <= got["budget_px"], got

    i1, i2 = frame["image1"][None], frame["image2"][None]
    base = build_model(RAFTStereoConfig(corr_implementation="reg"), seed=0, device="cpu")
    # The port's frozen batch norms hold the identity statistics, as flax init does.
    shapes = jax.eval_shape(lambda: JaxRAFTStereo(JaxConfig()).init(jax.random.PRNGKey(0), i1, i2, iters=1))
    variables = {"params": flax_params(base), "batch_stats": identity_stats(shapes["batch_stats"])}
    epe = {}
    for dt in ("float32", "bfloat16"):
        jm = JaxRAFTStereo(JaxConfig(corr_implementation="reg", corr_dtype=dt))
        up = jax.jit(lambda v, a, b: jm.apply(v, a, b, iters=2, test_mode=True))(variables, i1, i2)[1]
        epe[dt] = float(np.abs(np.asarray(up)[0, :, :, 0] - frame["flow"][..., 0]).mean())
    jax_delta = abs(epe["bfloat16"] - epe["float32"])
    assert abs(got["delta_px"] - jax_delta) <= 0.1 * corr.BF16_CORR_EPE_BUDGET_PX, (got, jax_delta)


# -- the kernels on the card ----------------------------------------------------------

def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 kernels have no CPU form")


def ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (0 at 0)."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, torch.zeros_like(x, dtype=torch.float32), torch.ldexp(torch.ones_like(x.float()), e - 8))


@pytest.mark.gpu
def test_bf16_kernels_match_plain_on_cuda(rng):
    """Lookup (four dtype pairs) and join exactly; pyramid and conv by the
    allowance of the module docstring."""
    cuda_or_skip()
    dev = "cuda"
    maps = [torch.from_numpy(rng.standard_normal((1, 256, 16, 192)).astype(np.float32)).to(dev).to(BF16)
            .permute(0, 2, 3, 1) for _ in range(2)]
    got = corr_cuda.fused_pyramid_state(*maps, 4, BF16)
    want = corr_cuda.corr_state(*maps, 4, BF16)
    allow = None
    for g, wl in zip(got, want):
        g, wl = g.float(), wl.float()
        own = ulp(torch.maximum(g.abs(), wl.abs()))
        if allow is None:
            allow = own + 2.0**-15 * float(wl.abs().max())
        else:
            n = g.shape[-1]
            allow = (allow[..., 0:2 * n:2] + allow[..., 1:2 * n:2]) * 0.5 + own
        assert ((g - wl).abs() <= allow).all()
    coords = (torch.arange(192.0, device=dev) - 20.0 * torch.rand((1, 16, 192), device=dev)).contiguous()
    for level_dtype in (torch.float32, BF16):
        levels = [lvl.to(level_dtype) for lvl in want]
        for out_dtype in (torch.float32, BF16):
            taps = corr_cuda.corr_lookup(levels, coords, 4, out_dtype)
            plain = corr.corr_lookup(levels, coords, 4).to(out_dtype)
            assert taps.dtype == out_dtype and torch.equal(taps, plain)
    x = torch.from_numpy(rng.standard_normal((2, C, 20, 72)).astype(np.float32)).to(dev).to(BF16)
    k, bias = conv_params(rng)
    wt, bt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(dev), torch.from_numpy(bias).to(dev)
    aff = torch.from_numpy(affine_rows(rng, 2, "in")).to(dev)
    y, stats = encoder_cuda.fused_conv(x, wt, bt, aff, "in", True)
    want_y, _ = encoder_cuda.plain_conv(x, wt, bt, aff, "in", False)
    b16 = bt.to(BF16).float()[None, :, None, None]
    g, wy = y.float(), want_y.float()
    pre = torch.maximum((g - b16).abs() + ulp(g), (wy - b16).abs() + ulp(wy))
    allow = ulp(pre) + ulp(torch.maximum(g.abs(), wy.abs())) + 2.0**-15 * float(wy.abs().max())
    assert y.dtype == BF16 and ((g - wy).abs() <= allow).all()
    np.testing.assert_allclose(stats.cpu().numpy(), encoder_cuda.channel_stats(y).cpu().numpy(), rtol=1e-5, atol=1e-4)
    aff_s = torch.from_numpy(affine_rows(rng, 2, "bn")).to(dev)
    joined = encoder_cuda.fused_join(x, y, aff, "in", aff_s, "bn")
    assert torch.equal(joined, encoder_cuda.plain_join(x, y, aff, "in", aff_s, "bn"))
