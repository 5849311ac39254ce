"""The fused encoder slice (config.fused_encoder) against the JAX package.

The plain versions of the port's three new kernels — `plain_conv`,
`plain_join` (ops/encoder_cuda.py) and `fused_pyramid_state` on CPU tensors
(ops/corr_cuda.py) — and the fused layer1 chain and both encoders built on
them, held against the JAX Pallas kernels in interpret mode
(`fused_conv_s2d`, `fused_join_s2d`, `fused_layer1_s2d`,
`fused_pyramid_state`) and the flax encoders with `fused_layer1=True`.

The JAX kernels work in the W-space-to-depth layout: `w_s2d` (a pure
reshape) and `dense_w_kernel` carry the port's NHWC values into it, affine
rows are tiled over the two phases, and the JAX statistics' two phase
blocks are summed before they are compared with the port's (B, 2, C).

Tolerances: conv y 2e-5 and statistics rtol = atol = 1e-4 (precedent
tests/test_encoder_pallas.py), join 1e-5, affines 1e-6, the layer1 chain
5e-4 (precedent), pyramid 1e-6, encoders 1e-5 of the output's scale (as in
tests/test_torch_modules.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models import extractor as jext
from raft_stereo_tpu.models.layers import dense_w_kernel, w_s2d
from raft_stereo_tpu.ops import corr_pallas as jcorr_pallas
from raft_stereo_tpu.ops import encoder_pallas as jenc
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.ops import corr_cuda, encoder_cuda
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixtures)
    jax_apply,
    jax_init,
    nchw,
    nhwc,
    pallas_tpu_compiler_params,
    torch_single_thread,
)

C = 64
HID = (32, 32, 32)


def conv_params(rng):
    """HWIO kernel scaled for unit-scale outputs, and a bias."""
    k = (rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)
    return k, (0.1 * rng.standard_normal(C)).astype(np.float32)


def affine_rows(rng, b, form):
    """(B, 2, C) rows: instance [mean, inv] or batch [inv, shift]."""
    if form == "in":
        first, second = 0.3 * rng.standard_normal((b, C)), rng.uniform(0.5, 2.0, (b, C))
    else:
        first, second = rng.uniform(0.5, 2.0, (b, C)), 0.3 * rng.standard_normal((b, C))
    return np.stack([first, second], axis=1).astype(np.float32)


def tile2(a):
    """Per-channel rows -> both s2d phases."""
    return None if a is None else jnp.asarray(np.concatenate([a, a], axis=-1))


def unphase(stats):
    """JAX (B, 2, 2C) statistics -> the port's (B, 2, C): sum the phases."""
    s = np.asarray(stats)
    return s[..., :C] + s[..., C:]


def jax_conv(x, k, bias, aff, form, emit_stats):
    with jax.default_matmul_precision("highest"):
        y, stats = jax.jit(
            lambda x, w, b, a: jenc.fused_conv_s2d(x, w, b, a, form, emit_stats=emit_stats)
        )(w_s2d(jnp.asarray(x)), dense_w_kernel(jnp.asarray(k)), tile2(bias), tile2(aff))
    return np.asarray(y).reshape(x.shape), (None if stats is None else unphase(stats))


def port_conv(x, k, bias, aff, form, emit_stats):
    y, stats = encoder_cuda.fused_conv(
        nchw(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias),
        None if aff is None else torch.from_numpy(aff), form, emit_stats,
    )
    return nhwc(y), (None if stats is None else stats.numpy())


@pytest.mark.parametrize("form", ["none", "in", "bn"])
@pytest.mark.parametrize("hh", [6, 1, 9])
def test_conv_matches_jax(rng, form, hh):
    b, w = 2, 16
    x = rng.standard_normal((b, hh, w, C)).astype(np.float32)
    k, bias = conv_params(rng)
    aff = None if form == "none" else affine_rows(rng, b, form)
    want_y, want_s = jax_conv(x, k, bias, aff, form, True)
    before = dict(encoder_cuda.LAUNCHES)
    got_y, got_s = port_conv(x, k, bias, aff, form, True)
    assert encoder_cuda.LAUNCHES == before  # CPU tensors take the plain version
    np.testing.assert_allclose(got_y, want_y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-4, atol=1e-4)
    assert port_conv(x, k, bias, aff, form, False)[1] is None


@pytest.mark.parametrize("skip_form", ["none", "in", "bn"])
@pytest.mark.parametrize("y_form", ["in", "bn"])
def test_join_matches_jax(rng, y_form, skip_form):
    b, hh, w = 2, 6, 16
    skip = rng.standard_normal((b, hh, w, C)).astype(np.float32)
    y = rng.standard_normal((b, hh, w, C)).astype(np.float32)
    aff_y = affine_rows(rng, b, y_form)
    aff_s = None if skip_form == "none" else affine_rows(rng, b, skip_form)
    want = jax.jit(lambda s, v, a, c: jenc.fused_join_s2d(s, v, a, y_form, c, skip_form))(
        w_s2d(jnp.asarray(skip)), w_s2d(jnp.asarray(y)), tile2(aff_y), tile2(aff_s))
    got = encoder_cuda.fused_join(
        nchw(skip), nchw(y), torch.from_numpy(aff_y), y_form,
        None if aff_s is None else torch.from_numpy(aff_s), skip_form,
    )
    np.testing.assert_allclose(nhwc(got), np.asarray(want).reshape(skip.shape), rtol=1e-5, atol=1e-5)


def test_affines_match_jax(rng):
    b, n = 3, 96
    halves = [rng.uniform(-20, 20, (b, 2, C)).astype(np.float32) for _ in range(2)]
    for h in halves:
        h[:, 1] = np.abs(h[:, 1]) + 40.0  # sum of squares large enough for a positive variance
    want = jenc.instance_affine_from_stats(jnp.asarray(np.concatenate(halves, axis=-1)), n)
    got = encoder_cuda.instance_affine_from_stats(torch.from_numpy(halves[0] + halves[1]), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :C], rtol=1e-6, atol=1e-6)
    inv = rng.uniform(0.5, 2.0, C).astype(np.float32)
    shift = rng.standard_normal(C).astype(np.float32)
    want = jenc.bn_affine(jnp.asarray(np.tile(inv, 2)), jnp.asarray(np.tile(shift, 2)), b)
    got = encoder_cuda.bn_affine(torch.from_numpy(inv), torch.from_numpy(shift), b)
    assert got.shape == (b, 2, C) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :C], rtol=1e-6, atol=1e-6)


def test_affine_forms_are_validated():
    x = torch.zeros((1, C, 2, 4))
    w, bias = torch.zeros((C, C, 3, 3)), torch.zeros(C)
    with pytest.raises(ValueError, match="not in"):
        encoder_cuda.fused_conv(x, w, bias, None, "group")
    with pytest.raises(ValueError, match="iff"):
        encoder_cuda.fused_conv(x, w, bias, None, "in")
    with pytest.raises(ValueError, match="iff"):
        encoder_cuda.fused_conv(x, w, bias, torch.zeros((1, 2, C)), "none")
    with pytest.raises(ValueError, match="y_form"):
        encoder_cuda.fused_join(x, x, torch.zeros((1, 2, C)), "none")
    with pytest.raises(ValueError, match="aff_skip"):
        encoder_cuda.fused_join(x, x, torch.zeros((1, 2, C)), "in", None, "bn")
    with pytest.raises(ValueError, match="instance or batch"):
        encoder_cuda.fused_layer1(x, torch.zeros((1, 2, C)), [], "group")


@pytest.mark.parametrize("norm_fn", ["instance", "batch"])
def test_layer1_chain_matches_jax(rng, norm_fn):
    b, hh, w = 2, 6, 16
    x = rng.standard_normal((b, hh, w, C)).astype(np.float32)
    params = [conv_params(rng) + conv_params(rng) for _ in range(2)]
    if norm_fn == "instance":
        stem = encoder_cuda.channel_stats(nchw(x))
        stem_aff = encoder_cuda.instance_affine_from_stats(stem, hh * w).numpy()
        bn = [(None, None)] * 2
    else:
        stem_aff = affine_rows(rng, b, "bn")
        bn = [(affine_rows(rng, b, "bn"), affine_rows(rng, b, "bn")) for _ in range(2)]
    jblocks = [(dense_w_kernel(jnp.asarray(k1)), tile2(b1), dense_w_kernel(jnp.asarray(k2)), tile2(b2),
                tile2(a1), tile2(a2)) for (k1, b1, k2, b2), (a1, a2) in zip(params, bn)]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda y, a: jenc.fused_layer1_s2d(y, a, jblocks, norm_fn))(
            w_s2d(jnp.asarray(x)), tile2(stem_aff))
    t = torch.from_numpy
    tblocks = [(t(k1.transpose(3, 2, 0, 1).copy()), t(b1), t(k2.transpose(3, 2, 0, 1).copy()), t(b2),
                None if a1 is None else t(a1), None if a2 is None else t(a2))
               for (k1, b1, k2, b2), (a1, a2) in zip(params, bn)]
    got = encoder_cuda.fused_layer1(nchw(x), t(stem_aff), tblocks, norm_fn)
    np.testing.assert_allclose(nhwc(got), np.asarray(want).reshape(x.shape), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("shape,levels", [((2, 4, 24, 16), 4), ((1, 2, 37, 16), 3), ((1, 2, 800, 8), 4)],
                         ids=["small", "odd_w", "multi_block"])
def test_pyramid_matches_jax(rng, shape, levels):
    b, h, w, d = shape
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    want = jax.jit(lambda a, c: jcorr_pallas.fused_pyramid_state(a, c, levels))(jnp.asarray(f1), jnp.asarray(f2))
    # The model passes permuted views of NCHW feature maps.
    t1 = torch.from_numpy(np.ascontiguousarray(f1.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    t2 = torch.from_numpy(np.ascontiguousarray(f2.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    before = dict(corr_cuda.LAUNCHES)
    got = corr_cuda.fused_pyramid_state(t1, t2, levels)
    assert corr_cuda.LAUNCHES == before
    assert len(got) == len(want) == levels
    for l, (g, wl) in enumerate(zip(got, want)):
        w2 = w >> l
        assert g.shape == (b, h, w, w2) and g.is_contiguous()
        ref = np.asarray(wl)[:, :w, :w2].reshape(b, h, w, w2)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-6, atol=1e-6)


def close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("width", [64, 62], ids=["fused", "odd_w_unfused"])
def test_basic_encoder_fused_matches_jax(rng, width):
    """W = 62 with a stride-2 stem (downsample 3) is odd at stem resolution:
    both sides take the unfused branch."""
    downsample = 2 if width == 64 else 3
    x = rng.uniform(-1, 1, (2, 48, width, 3)).astype(np.float32)
    jm = jext.BasicEncoder(output_dim=64, norm_fn="instance", downsample=downsample, fused_layer1=True)
    v = jax_init(jm, jnp.asarray(x))
    tm = load_jax_variables(BasicEncoder(64, "instance", downsample=downsample, fused_layer1=True), v).eval()
    with torch.no_grad():
        close(nhwc(tm(nchw(x), test_mode=True)), jax_apply(jm, v, x))


def test_multi_basic_encoder_fused_matches_jax(rng):
    x = rng.uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    jm = jext.MultiBasicEncoder(output_dims=(HID, HID), norm_fn="batch", downsample=2, fused_layer1=True)
    v = jax_init(jm, jnp.asarray(x), num_layers=3)
    want = jax_apply(jm, v, x, num_layers=3)
    tm = load_jax_variables(
        MultiBasicEncoder((HID, HID), "batch", downsample=2, num_layers=3, fused_layer1=True), v).eval()
    with torch.no_grad():
        got = tm(nchw(x), test_mode=True)
    for g_scale, w_scale in zip(got, want):
        for g, w in zip(g_scale, w_scale):
            close(nhwc(g), w)


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the encoder and pyramid kernels have no CPU form")


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["none", "in", "bn"])
def test_conv_kernel_matches_plain_on_cuda(rng, form):
    cuda_or_skip()
    b, hh, w = 2, 20, 72
    x = torch.from_numpy(rng.standard_normal((b, C, hh, w)).astype(np.float32)).cuda()
    k, bias = conv_params(rng)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).cuda()
    bt = torch.from_numpy(bias).cuda()
    aff = None if form == "none" else torch.from_numpy(affine_rows(rng, b, form)).cuda()
    before = encoder_cuda.LAUNCHES["encoder_conv"]
    y, stats = encoder_cuda.fused_conv(x, wt, bt, aff, form, True)
    torch.cuda.synchronize()
    assert encoder_cuda.LAUNCHES["encoder_conv"] == before + 1
    want_y, want_s = encoder_cuda.plain_conv(x, wt, bt, aff, form, True)
    np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stats.cpu().numpy(), want_s.cpu().numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
def test_join_and_pyramid_kernels_match_plain_on_cuda(rng):
    cuda_or_skip()
    b, hh, w = 2, 12, 20
    skip, y = (torch.from_numpy(rng.standard_normal((b, C, hh, w)).astype(np.float32)).cuda() for _ in range(2))
    aff_y = torch.from_numpy(affine_rows(rng, b, "in")).cuda()
    aff_s = torch.from_numpy(affine_rows(rng, b, "bn")).cuda()
    got = encoder_cuda.fused_join(skip, y, aff_y, "in", aff_s, "bn")
    want = encoder_cuda.plain_join(skip, y, aff_y, "in", aff_s, "bn")
    assert torch.equal(got, want)
    f1, f2 = (torch.from_numpy(rng.standard_normal((1, 3, 150, 32)).astype(np.float32)).cuda() for _ in range(2))
    got = corr_cuda.fused_pyramid_state(f1, f2, 4)
    want = corr_cuda.corr_state(f1, f2, 4)
    for g, wl in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), wl.cpu().numpy(), rtol=0, atol=1e-5)


# The pyramid kernel's plans at the model's shapes and at its edges:
# (rows, W1 = W2, layout, levels). Both buckets' 1/4 resolution and
# Middlebury-F's in the model's layout (permuted NCHW views: 16-byte copies
# along W), the contiguous (B, H, W, D) layout (4-byte copies along D),
# widths no tile divides, 128 rows at W 190 (the 96 x 192 tile with the
# shared-memory epilogue), and 1, 5, 6 and 7 levels at W 192 (the register
# epilogue up to 6) and W 150 (the shared-memory epilogue).
PYRAMID_CUDA_CASES = {
    "384x512": (96, 128, "nchw", 4),
    "512x768": (128, 192, "nchw", 4),
    "1984x2880": (496, 720, "nchw", 4),
    "contiguous_bhwd": (5, 192, "bhwd", 4),
    "w150": (3, 150, "nchw", 4),
    "w150_contiguous_bhwd": (3, 150, "bhwd", 4),
    "w37": (3, 37, "nchw", 4),
    "w190_shared_96x192": (128, 190, "nchw", 4),
    **{f"w192_l{lv}": (128, 192, "nchw", lv) for lv in (1, 5, 6, 7)},
    **{f"w150_l{lv}": (3, 150, "nchw", lv) for lv in (1, 5, 6, 7)},
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PYRAMID_CUDA_CASES))
def test_pyramid_kernel_matches_corr_state_on_cuda(rng, case):
    """The plan's kernel against `corr_state` (tolerance 2e-5, as in
    chip_smoke.py; the FFMA order is cuBLAS's, so 0.0 is expected)."""
    cuda_or_skip()
    rows, w, layout, levels = PYRAMID_CUDA_CASES[case]
    maps = [rng.standard_normal((1, 256, rows, w)).astype(np.float32) for _ in range(2)]
    if layout == "nchw":
        f1, f2 = (torch.from_numpy(m).cuda().permute(0, 2, 3, 1) for m in maps)
    else:
        f1, f2 = (torch.from_numpy(m.transpose(0, 2, 3, 1).copy()).cuda() for m in maps)
    want = corr_cuda.corr_state(f1, f2, levels)
    before = corr_cuda.LAUNCHES["corr_pyramid"]
    got = corr_cuda.fused_pyramid_state(f1, f2, levels)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["corr_pyramid"] == before + 1
    assert len(got) == levels
    for g, wl in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), wl.cpu().numpy(), rtol=0, atol=2e-5)
