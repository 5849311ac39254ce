"""The fused encoder on row bands: the conv's halo form and `fused_layer1`
inside a band scope (ops/encoder_cuda.py, parallel/spatial.py) against the
whole image and the JAX package.

Bands run in threads of one process over the package's in-process comm
(`spatial.ThreadComm`), as tests/test_torch_spatial.py runs them:

- the conv's plain twin in its halo form (`fused_conv(..., halo=...)` on
  CPU tensors, the neighbour rows exchanged by `raw_halo_rows`) for the
  top, middle and bottom band of three equals the whole image's
  `plain_conv` rows, at every form, fp32 and bf16. Tolerance 1e-6 of the
  largest |y| at fp32 and one bf16 ulp of it at bf16: the same conv of the
  same z rows, which the CPU's convolution may block differently at
  another height (measured 0.0);
- the banded `fused_layer1` (two bands, the stem's statistics from
  `band_stats`) equals JAX's whole-image `fused_layer1_s2d` in Pallas
  interpret mode, under instance norm and frozen batch norm: fp32 within
  1e-5 of the output's largest magnitude (the convs sum in another order
  than XLA's, the statistics over the bands in another order than over
  the image); bf16 within twice JAX's own bf16-vs-fp32 gap on the same
  inputs (tests/test_torch_mixed.py's bound for bf16 against JAX);
- the banded fused prelude (`encode_features` in test mode on two bands
  of a 64x64 pair, every level banded) equals the unfused banded prelude
  and the whole image's fused prelude: the correlation levels, the context
  and the hidden state, at fp32 within 1e-5 of each tensor's largest
  magnitude against the whole fused prelude (only the order of the
  cross-band sums differs) and 1e-4 against the unfused one
  (chip_smoke.py's FUSED_STATE_REL_TOL: the fused and direct layer1
  round alike but sum their statistics in another order), and in bf16
  within 4 bf16 ulps of the tensor's largest magnitude (chip_smoke.py's
  MIXED_STATE_ULPS); the fused layer1 makes as many exchanges as the
  direct one it replaces (a halo per conv, a sum per instance norm);
- on a card (marked `gpu`, skipped here): the halo kernel against its
  twin, bitwise at fp32 and within the conv's bf16 allowance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models.layers import dense_w_kernel, w_s2d
from raft_stereo_tpu.ops import encoder_pallas as jenc
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.ops import encoder_cuda
from torch_parity import nchw, nhwc, run_bands
from torch_parity import pallas_tpu_compiler_params, torch_single_thread  # noqa: F401 (autouse fixtures)

C = 64
BF16 = torch.bfloat16


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def conv_params(rng):
    """HWIO kernel scaled for unit-scale outputs, and a bias."""
    k = (rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)
    return k, (0.1 * rng.standard_normal(C)).astype(np.float32)


def affine_rows(rng, b, form):
    """(B, 2, C) rows: instance [mean, inv] or batch [inv, shift]."""
    if form == "none":
        return None
    if form == "in":
        first, second = 0.3 * rng.standard_normal((b, C)), rng.uniform(0.5, 2.0, (b, C))
    else:
        first, second = rng.uniform(0.5, 2.0, (b, C)), 0.3 * rng.standard_normal((b, C))
    return np.stack([first, second], axis=1).astype(np.float32)


def oihw(k):
    return torch.from_numpy(k.transpose(3, 2, 0, 1).copy())


def banded(scope, rows, fn):
    with scope.bands(rows, n_downsample=0):
        return fn()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["none", "in", "bn"])
def test_halo_plain_conv_equals_whole_rows(rng, form, dtype):
    """Three bands of a 15-row image: the top band takes a row from below,
    the middle one a row from each side, the bottom one a row from above;
    each band's conv equals the whole conv's rows of that band."""
    dt = getattr(torch, dtype)
    b, h, w = 2, 15, 12
    x = torch.from_numpy(rng.standard_normal((b, C, h, w)).astype(np.float32)).to(dt)
    k, bias = conv_params(rng)
    aff = affine_rows(rng, b, form)
    aff = None if aff is None else torch.from_numpy(aff)
    want, _ = encoder_cuda.plain_conv(x, oihw(k), torch.from_numpy(bias), aff, form, False)

    def band(scope):
        xb = scope.take_band(x, 2)
        ext, top, bottom = scope.raw_halo_rows(xb, 1, 1)
        assert (top, bottom) == (int(scope.index > 0), int(scope.index < 2))
        assert ext.shape[2] == 5 + top + bottom
        return encoder_cuda.fused_conv(ext, oihw(k), torch.from_numpy(bias), aff, form, False,
                                       halo=(top, bottom))[0]

    got = torch.cat(run_bands(band, n=3), dim=2)
    scale = float(want.float().abs().max())
    tol = 1e-6 * scale if dt == torch.float32 else 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert got.dtype == dt and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_halo_form_is_validated():
    x = torch.zeros(1, C, 3, 8)
    w, bias = torch.zeros(C, C, 3, 3), torch.zeros(C)
    with pytest.raises(ValueError, match="0 or 1"):
        encoder_cuda.fused_conv(x, w, bias, None, "none", halo=(2, 0))
    with pytest.raises(ValueError, match="no output row"):
        encoder_cuda.fused_conv(x[:, :, :2], w, bias, None, "none", halo=(1, 1))
    y, _ = encoder_cuda.fused_conv(x, w, bias, None, "none", halo=(1, 1))
    assert y.shape == (1, C, 1, 8)


def layer1_inputs(rng, norm_fn, b=2, hh=12, w=16):
    x = rng.standard_normal((b, hh, w, C)).astype(np.float32)
    params = [conv_params(rng) + conv_params(rng) for _ in range(2)]
    if norm_fn == "instance":
        bn = [(None, None)] * 2
        stem_aff = None
    else:
        stem_aff = affine_rows(rng, b, "bn")
        bn = [(affine_rows(rng, b, "bn"), affine_rows(rng, b, "bn")) for _ in range(2)]
    return x, params, bn, stem_aff


def jax_layer1(x, params, bn, stem_aff, norm_fn, dtype):
    """JAX's whole-image fused_layer1_s2d (interpret mode) at fp32 or bf16
    operands, the stem's instance affine from the whole image's statistics."""
    b, hh, w, _ = x.shape
    if stem_aff is None:
        stem = encoder_cuda.channel_stats(nchw(x))
        stem_aff = encoder_cuda.instance_affine_from_stats(stem, hh * w).numpy()
    tile2 = lambda a: None if a is None else jnp.asarray(np.concatenate([a, a], axis=-1))  # noqa: E731
    wd = (lambda k: dense_w_kernel(jnp.asarray(k)).astype(jnp.bfloat16)) if dtype == "bfloat16" else \
        (lambda k: dense_w_kernel(jnp.asarray(k)))
    jblocks = [(wd(k1), tile2(b1), wd(k2), tile2(b2), tile2(a1), tile2(a2))
               for (k1, b1, k2, b2), (a1, a2) in zip(params, bn)]
    xs = w_s2d(jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda y, a: jenc.fused_layer1_s2d(y, a, jblocks, norm_fn))(xs, tile2(stem_aff))
    return np.asarray(out.astype(jnp.float32)).reshape(x.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_banded_fused_layer1_matches_jax_whole_image(rng, norm_fn, dtype):
    """Two bands of 6 rows, each with the stem's pending norm from the
    bands' summed statistics (instance) or the frozen batch norm, against
    JAX's whole 12-row image."""
    x, params, bn, stem_aff = layer1_inputs(rng, norm_fn)
    dt = getattr(torch, dtype)
    if dt == BF16:
        x = torch.from_numpy(x).to(BF16).float().numpy()  # bf16 values on both sides
    want = jax_layer1(x, params, bn, stem_aff, norm_fn, dtype)
    t = torch.from_numpy
    blocks = [(oihw(k1), t(b1), oihw(k2), t(b2), None if a1 is None else t(a1), None if a2 is None else t(a2))
              for (k1, b1, k2, b2), (a1, a2) in zip(params, bn)]
    xt = nchw(x).to(dt)

    def band(scope):
        xb = scope.take_band(xt, 2).contiguous()

        def run():
            aff = (t(stem_aff) if stem_aff is not None
                   else encoder_cuda.instance_affine_from_stats(*encoder_cuda.band_stats(xb)))
            return encoder_cuda.fused_layer1(xb, aff, blocks, norm_fn)

        before = scope.exchanges
        out = banded(scope, 6, run)
        # A halo per conv; under instance norm also the stem's sum and a sum per conv.
        assert scope.exchanges - before == (9 if norm_fn == "instance" else 4)
        return out

    got = nhwc(torch.cat(run_bands(band), dim=2).float())
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    if dt == torch.float32:
        assert err <= 1e-5 * float(np.abs(want).max()), err
    else:
        gap = float(np.abs(want - jax_layer1(x, params, bn, stem_aff, norm_fn, "float32")).max())
        assert gap > 1e-3  # bf16 shows: the bound has a scale
        assert err <= 2 * gap, (err, gap)


def prelude_model(fused: bool, mixed: bool):
    """The default architecture at hidden 32, "pallas", seeded weights with
    halved kernels (tests/test_torch_model.py says why)."""
    cfg = RAFTStereoConfig(hidden_dims=(32, 32, 32), corr_implementation="pallas", fused_encoder=fused,
                           mixed_precision=mixed, corr_dtype="bfloat16" if mixed else "float32")
    model = build_model(cfg, seed=3, device="cpu").eval()
    with torch.no_grad():
        for tensor in model.state_dict().values():
            if tensor.dim() == 4:
                tensor.mul_(0.5)
    return model


def prelude_tensors(state) -> dict:
    """The prelude's outputs by name, NCHW (the correlation levels as
    (B, H, W1, W2): rows on dim 1)."""
    out = {f"corr{i}": (lvl, 1) for i, lvl in enumerate(state["corr"])}
    out.update({f"net{i}": (t, 2) for i, t in enumerate(state["net"])})
    out.update({f"context{i}.{j}": (t, 2) for i, c in enumerate(state["context"]) for j, t in enumerate(c)})
    return out


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "mixed"])
def test_banded_fused_prelude_matches_unfused_bands_and_whole_image(rng, mixed):
    h, w = 64, 64
    left = rng.uniform(0, 255, (1, h, w + 5, 3)).astype(np.float32)
    i1, i2 = torch.from_numpy(left[:, :, 5:].copy()), torch.from_numpy(left[:, :, :w].copy())
    fused, unfused = prelude_model(True, mixed), prelude_model(False, mixed)
    with torch.inference_mode():
        whole = prelude_tensors(fused.encode_features(i1, i2, test_mode=True))

    def band(scope):
        rows = h // 2
        b1, b2 = (scope.take_band(t, 1).contiguous() for t in (i1, i2))
        out = {}
        with torch.inference_mode():
            for name, model in (("fused", fused), ("unfused", unfused)):
                before = scope.exchanges
                with scope.bands(rows, n_downsample=2):
                    out[name] = prelude_tensors(model.encode_features(b1, b2, test_mode=True))
                out[f"{name} exchanges"] = scope.exchanges - before
        return out

    parts = run_bands(band)
    for p in parts:
        assert p["fused exchanges"] == p["unfused exchanges"] > 0
    for name, (want, dim) in whole.items():
        got = torch.cat([p["fused"][name][0] for p in parts], dim=dim).float()
        direct = torch.cat([p["unfused"][name][0] for p in parts], dim=dim).float()
        want = want.float()
        assert got.shape == want.shape, name
        scale = float(want.abs().max())
        if mixed:
            ulps4 = 4 * 2.0 ** (np.floor(np.log2(scale)) - 7)
            tol_whole = tol_direct = ulps4
        else:
            tol_whole, tol_direct = 1e-5 * scale, 1e-4 * scale
        assert float((got - want).abs().max()) <= tol_whole, name
        assert float((got - direct).abs().max()) <= tol_direct, name


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv kernel's halo form has no CPU form")


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [(1, 1), (1, 0), (0, 1)])
@pytest.mark.parametrize("form", ["none", "in", "bn"])
def test_halo_kernel_matches_twin_on_cuda(rng, form, halo):
    """The halo kernel against its plain twin on the card, TF32 off: fp32
    bit for bit (both sum each output's 576 products in one order; cuDNN
    was measured to pick that order at these shapes), bf16 within 1 bf16
    ulp of the pre-bias sum plus 1 ulp of the output plus 2**-15 of the
    largest |output| (chip_smoke.py `conv_bf16_check`)."""
    cuda_or_skip()
    torch.backends.cudnn.allow_tf32 = False
    b, h, w = 2, 40, 128
    top, bottom = halo
    k, bias = conv_params(rng)
    aff = affine_rows(rng, b, form)
    wt, bt = oihw(k).cuda(), torch.from_numpy(bias).cuda()
    aff = None if aff is None else torch.from_numpy(aff).cuda()
    for dt in (torch.float32, BF16):
        x = torch.from_numpy(rng.standard_normal((b, C, h + top + bottom, w)).astype(np.float32)).cuda().to(dt)
        y, stats = encoder_cuda.fused_conv(x, wt, bt, aff, form, True, halo=halo)
        torch.cuda.synchronize()
        want, want_s = encoder_cuda.plain_conv(x, wt, bt, aff, form, True, halo)
        assert y.shape == (b, C, h, w)
        if dt == torch.float32:
            assert torch.equal(y.view(torch.int32), want.view(torch.int32))
        else:
            g, v = y.float(), want.float()
            bb = bt.to(BF16).float()[None, :, None, None]
            ulp = lambda t: torch.where(t == 0, torch.zeros_like(t), torch.ldexp(  # noqa: E731
                torch.ones_like(t), torch.frexp(t)[1] - 8))
            pre = torch.maximum((g - bb).abs() + ulp(g), (v - bb).abs() + ulp(v))
            allow = ulp(pre) + ulp(torch.maximum(g.abs(), v.abs())) + 2.0**-15 * float(v.abs().max())
            assert bool(((g - v).abs() <= allow).all())
        np.testing.assert_allclose(stats.cpu().numpy(), encoder_cuda.channel_stats(y).cpu().numpy(),
                                   rtol=1e-4, atol=1e-3)
