"""PyTorch-port correlation ops against the JAX package (tolerance 1e-5).

The plain `corr_volume`/`corr_pyramid`/`corr_lookup` are held against the
JAX reg strategy, and the "pallas" strategy's wrappers on CPU tensors (the
plain version of the CUDA lookup kernel) against `pallas_corr_lookup_padded`
over `pallas_corr_state` — the TPU kernel in Pallas interpret mode.
Cases: odd W2, W2 > 128 (several 128-lane tiles in the TPU kernel), and
coordinates below 0 and past W2.

The windowed lookup (`prefetch_lookup`): `corr_cuda.prefetch_corr_lookup`
on CPU tensors (the plain lookup) against `prefetch_corr_lookup_padded` in
interpret mode, on the five input families of tests/test_fast_path.py:
smooth coordinates, W = 600 (a strict JAX window), odd width 27, edge
coordinates, and uniform-random coordinates (JAX falls back to the dense
kernel).

The lookup's gradient: `plain_corr_scatter` (the plain version of the
scatter kernel) against `_scatter_pallas_padded` in interpret mode,
`CorrLookup` against `jax.vjp` of the padded lookup, and d(feature maps)
through the train-mode state against `jax.grad`. The JAX scatter is not
matched bit for bit on the CPU: XLA contracts g[m](1-f) + g[m-1]f into a
fused multiply-add, the port rounds the product first (as the kernel,
built with -fmad=false, does), so the two differ by up to an ulp of the
result: the tolerance is 1e-6 of max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.ops import corr as jcorr
from raft_stereo_tpu.ops.corr_pallas import (
    _round_up,
    _scatter_pallas_padded,
    _w1_blocks,
    pad_pyramid,
    pallas_corr_lookup_padded,
    pallas_corr_state,
    prefetch_corr_lookup_padded,
)
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


def prefetch_case(rng, family):
    """tests/test_fast_path.py's inputs: (B, H, W, D) = (2, 4, W, 16)
    feature maps and the family's coordinates."""
    w = {"smooth": 24, "strict_window_600": 600, "odd_width_27": 27, "edge": 24, "uniform_random": 600}[family]
    f1 = rng.standard_normal((2, 4, w, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 4, w, 16)).astype(np.float32)
    if family == "edge":
        x = np.linspace(-5.0, w + 5.0, w, dtype=np.float32)
    elif family == "uniform_random":
        x = rng.uniform(-6, w + 6, size=(2, 4, w)).astype(np.float32)
    else:  # the grid minus a smooth bounded disparity
        disp = 0.5 + 5.5 * (0.5 + 0.5 * np.sin(np.linspace(0, 3.0, w, dtype=np.float32)))
        x = np.arange(w, dtype=np.float32) - disp
    return f1, f2, np.ascontiguousarray(np.broadcast_to(x, (2, 4, w)), dtype=np.float32)


@pytest.mark.parametrize("family", ["smooth", "strict_window_600", "odd_width_27", "edge", "uniform_random"])
def test_prefetch_lookup_on_cpu_matches_pallas_interpret(rng, family):
    f1, f2, x = prefetch_case(rng, family)
    state = pallas_corr_state(jnp.asarray(f1), jnp.asarray(f2), LEVELS)
    want = np.asarray(prefetch_corr_lookup_padded(state, jnp.asarray(x), RADIUS))
    before = dict(corr_cuda.LAUNCHES)
    tstate = corr_cuda.corr_state(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)
    got = corr_cuda.prefetch_corr_lookup(tstate, torch.from_numpy(x), RADIUS)
    assert got.shape == (*x.shape, LEVELS * (2 * RADIUS + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # CPU tensors take the plain version, the dense lookup's: no kernel
    # launch is counted, and the taps are the dense wrapper's.
    assert corr_cuda.LAUNCHES == before
    assert torch.equal(got, corr_cuda.corr_lookup(tstate, torch.from_numpy(x), RADIUS))


def test_prefetch_lookup_has_no_backward(rng):
    f1, f2, x = prefetch_case(rng, "smooth")
    levels = [lvl.requires_grad_() for lvl in corr_cuda.corr_state(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)]
    with pytest.raises(RuntimeError, match="no backward"):
        corr_cuda.prefetch_corr_lookup(levels, torch.from_numpy(x), RADIUS)
    with torch.no_grad():
        assert corr_cuda.prefetch_corr_lookup(levels, torch.from_numpy(x), RADIUS).shape[-1] == 36


def test_far_out_of_range_taps_are_zero(rng):
    f1, f2, _ = make_case(rng, 8, 20)
    state = corr_cuda.corr_state(torch.from_numpy(f1), torch.from_numpy(f2), LEVELS)
    far = torch.full((2, 3, 8), -50.0)
    assert corr_cuda.corr_lookup(state, far, RADIUS).abs().max().item() == 0.0
    assert corr_cuda.corr_lookup(state, far + 200.0, RADIUS).abs().max().item() == 0.0


# (B, H, W1, W2, levels, radius): 1-4 levels, radii 1-4, W2 neither a multiple
# of 2**L nor of 128 (and above 128), W1 past one 768-query block of the TPU
# kernel, a level of width 1.
SCATTER_CASES = {
    "r4_l4_multi_tile": (2, 3, 40, 150, 4, 4),
    "r2_l2_two_w1_blocks": (1, 2, 800, 37, 2, 2),
    "r1_l3_width_one": (1, 1, 9, 5, 3, 1),
    "r3_l1": (2, 2, 16, 16, 1, 3),
}


def scatter_case(rng, b, h, w1, w2, levels, radius):
    """Coordinates mostly in range, a share far out on both sides, and in
    the first row: negative, 0, integral, W2_l - 1 of every level, W2, far
    out (+-1e6), and mid-sample."""
    x = np.arange(w1, dtype=np.float32)[None, None, :] - rng.uniform(0, w2 / 3, (b, h, w1))
    wild = rng.uniform(0, 1, (b, h, w1)) < 0.2
    x = np.where(wild, rng.uniform(-3 * w2, 3 * w2, (b, h, w1)), x).astype(np.float32)
    special = [-1.0, -3.5, 0.0, 3.0, float(w2), 1e6, -1e6, w2 - 0.5]
    special += [float(((w2 >> l) - 1) << l) for l in range(levels)]
    x.reshape(-1)[: len(special)] = special[: x.size]
    g = rng.standard_normal((b, h, w1, levels * (2 * radius + 1))).astype(np.float32)
    return x, g, [w2 >> l for l in range(levels)]


@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_plain_scatter_matches_jax(rng, case):
    b, h, w1, w2, levels, radius = SCATTER_CASES[case]
    x, g, widths = scatter_case(rng, *SCATTER_CASES[case])
    _, w1_pad = _w1_blocks(w1)
    shapes = [(b * h, w1_pad, _round_up(max(w, 1), 128)) for w in widths]
    want = _scatter_pallas_padded(shapes, [jnp.float32] * levels, jnp.asarray(x), jnp.asarray(g), radius)
    before = dict(corr_cuda.LAUNCHES)
    got = corr_cuda.corr_scatter(torch.from_numpy(x), torch.from_numpy(g), widths, radius)
    assert corr_cuda.LAUNCHES == before
    assert [tuple(t.shape) for t in got] == [(b, h, w1, w) for w in widths]
    tol = 1e-6 * np.abs(g).max()
    for t, wl, w in zip(got, want, widths):
        ref = np.asarray(wl)[:, :w1, :w].reshape(b, h, w1, w)
        np.testing.assert_allclose(t.numpy(), ref, atol=tol, rtol=0)
    # Far-out queries (+-1e6 in the first row) write all-zero rows.
    for t in got:
        assert not t.numpy().reshape(-1, t.shape[-1])[5:7].any()


def lookup_levels(rng, b, h, w1, widths):
    return [rng.standard_normal((b, h, w1, w)).astype(np.float32) for w in widths]


@pytest.mark.parametrize("case", ["r4_l4_multi_tile", "r1_l3_width_one"])
def test_corr_lookup_function_matches_jax_vjp(rng, case):
    """d(levels) of the port's lookup (`CorrLookup`, CPU: the plain scatter)
    against jax.vjp of the padded Pallas lookup through `pad_pyramid`; no
    gradient reaches the coordinates."""
    b, h, w1, w2, levels, radius = SCATTER_CASES[case]
    x, g, widths = scatter_case(rng, *SCATTER_CASES[case])
    lv = lookup_levels(rng, b, h, w1, widths)

    def taps(pyramid):
        return pallas_corr_lookup_padded(pad_pyramid(pyramid, x.shape), jnp.asarray(x), radius)

    want_out, vjp = jax.vjp(taps, tuple(jnp.asarray(v) for v in lv))
    (want,) = vjp(jnp.asarray(g))
    tlv = [torch.from_numpy(v).requires_grad_() for v in lv]
    coords = torch.from_numpy(x).requires_grad_()
    out = corr_cuda.corr_lookup(tlv, coords, radius)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "CorrLookupBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    out.backward(torch.from_numpy(g))
    assert coords.grad is None
    for t, w in zip(tlv, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-6 * np.abs(g).max(), rtol=0)


def test_corr_lookup_function_against_plain_autograd(rng):
    """`CorrLookup`'s d(levels) against torch autograd of the plain lookup.
    They differ only where the forward's per-tap fraction t - floor(t),
    t = x + (k - r), differs from the one shared fraction x - floor(x) the
    backward uses: by at most half an ulp of t, 2**-24 |t| < 2**-24 (W2 + 1)
    for a tap that lands in the row. A sample takes at most two such terms,
    plus the rounding of each product, so the bound is
    2**-23 (W2 + 3) max |g|."""
    b, h, w1, w2, levels, radius = SCATTER_CASES["r4_l4_multi_tile"]
    x, g, widths = scatter_case(rng, b, h, w1, w2, levels, radius)
    lv = lookup_levels(rng, b, h, w1, widths)
    a = [torch.from_numpy(v).requires_grad_() for v in lv]
    p = [torch.from_numpy(v).requires_grad_() for v in lv]
    corr_cuda.corr_lookup(a, torch.from_numpy(x), radius).backward(torch.from_numpy(g))
    corr.corr_lookup(p, torch.from_numpy(x), radius).backward(torch.from_numpy(g))
    tol = 2.0**-23 * (w2 + 3) * np.abs(g).max()
    for ta, tp in zip(a, p):
        np.testing.assert_allclose(ta.grad.numpy(), tp.grad.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", ["odd_w2", "multi_tile_w2"])
def test_fmap_gradients_through_state_match_jax(rng, case):
    """d(fmap1), d(fmap2) of sum(taps * G) through the port's train-mode
    "pallas" state (plain volume and pooling) and `CorrLookup`, against
    jax.grad through `pallas_corr_state` and `pallas_corr_lookup_padded`:
    1e-5 of the largest gradient (the volume product sums D terms in
    another order)."""
    f1, f2, x = make_case(rng, *CASES[case])
    gw = rng.standard_normal((*x.shape, LEVELS * (2 * RADIUS + 1))).astype(np.float32)

    def objective(a, c):
        return jnp.sum(pallas_corr_lookup_padded(pallas_corr_state(a, c, LEVELS), jnp.asarray(x), RADIUS) * gw)

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(objective, argnums=(0, 1)))(f1, f2)
    t1, t2 = torch.from_numpy(f1).requires_grad_(), torch.from_numpy(f2).requires_grad_()
    taps = corr_cuda.corr_lookup(corr_cuda.corr_state(t1, t2, LEVELS), torch.from_numpy(x), RADIUS)
    (taps * torch.from_numpy(gw)).sum().backward()
    for t, w in zip((t1, t2), want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


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
    # Under autograd the lookup is differentiable in the levels: the backward
    # launches the scatter kernel once.
    levels = [lvl.clone().requires_grad_() for lvl in state]
    before = corr_cuda.LAUNCHES["corr_scatter"]
    corr_cuda.corr_lookup(levels, coords, RADIUS).sum().backward()
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["corr_scatter"] == before + 1
    assert all(lvl.grad is not None for lvl in levels)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_kernel_matches_plain_on_cuda(rng, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scatter kernel has no CPU form")
    radius = SCATTER_CASES[case][-1]
    x, g, widths = scatter_case(rng, *SCATTER_CASES[case])
    coords, grad = torch.from_numpy(x).cuda(), torch.from_numpy(g).cuda()
    before = corr_cuda.LAUNCHES["corr_scatter"]
    got = corr_cuda.corr_scatter(coords, grad, widths, radius)
    again = corr_cuda.corr_scatter(coords, grad, widths, radius)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["corr_scatter"] == before + 2
    want = corr_cuda.plain_corr_scatter(coords, grad, widths, radius)
    for t, t2, w in zip(got, again, want):
        assert torch.equal(t, t2)  # no atomics: the same bits every launch
        np.testing.assert_array_equal(t.cpu().numpy(), w.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["smooth", "strict_window_600", "odd_width_27", "edge", "uniform_random"])
def test_prefetch_kernel_equals_dense_kernel_on_cuda(rng, family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefetch kernel has no CPU form")
    f1, f2, x = prefetch_case(rng, family)
    x.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, 1e6, -1e6]
    state = corr_cuda.corr_state(torch.from_numpy(f1).cuda(), torch.from_numpy(f2).cuda(), LEVELS)
    coords = torch.from_numpy(x).cuda()
    before = corr_cuda.LAUNCHES["corr_prefetch_lookup"]
    got = corr_cuda.prefetch_corr_lookup(state, coords, RADIUS)
    torch.cuda.synchronize()
    assert corr_cuda.LAUNCHES["corr_prefetch_lookup"] == before + 1
    dense = corr_cuda.corr_lookup(state, coords, RADIUS)
    plain = corr.corr_lookup(state, coords, RADIUS)
    np.testing.assert_array_equal(got.cpu().numpy(), dense.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), plain.cpu().numpy())
