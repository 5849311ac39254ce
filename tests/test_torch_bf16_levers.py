"""The test-mode levers under mixed precision (bf16) in the PyTorch port
against the JAX package: the GRU tail and the motion tail
(`fused_gru_tail`), the gate pair (`RAFT_STEREO_TPU_PALLAS_GATES=1`) and
the windowed lookup (`prefetch_lookup`).

The JAX kernels compute in fp32 and store in the operand's dtype
(`ops/gru_tail_pallas.py`, `ops/gates_pallas.py`, `ops/corr_pallas.py`),
here in Pallas interpret mode on bf16 inputs made with numpy from a seed.
On CPU tensors the port's wrappers run their plain versions, the kernels'
twins: each operand widened to fp32, the fp32 formula, one rounding.

Tolerances, one bf16 ulp being 2**-7 of a value's power of two:

- The motion tail: bit for bit (relu, copy and zero are exact).
- The windowed lookup: bit for bit the port's dense plain lookup (one
  function), and within 1 bf16 ulp of the JAX windowed kernel (XLA on the
  CPU may contract the lerp into a fused multiply-add before the one
  rounding; measured: bit for bit on the smooth coordinates, 1 ulp in
  1.2e-5 of the taps on the uniform ones).
- The tail, rh and combine: within 1 bf16 ulp of the JAX kernels, the share
  of differing elements at most ULP_SHARE (XLA's `logistic` and `tanh` on
  the CPU need not round as torch's do before the one bf16 rounding;
  measured: bit for bit on every shape here, where the unfused per-op bf16
  formula differs from them in 43-44% of the elements).
- The mixed forward with `fused_gru_tail` or `prefetch_lookup`, against
  JAX's bf16 forward with the same lever on the same weights: within twice
  JAX's own bf16-vs-fp32 gap (tests/test_torch_mixed.py says why). The JAX
  model never takes the gate pair off a TPU (its `_IterationBody` gates it
  on `jax.default_backend() == "tpu"`), so the gate pair at bf16 is held at
  the kernel level only, here and on the card.

Row counts include ones that are not a multiple of the TPU kernels'
1024-row block. `gpu`-marked tests hold each bf16 kernel against its plain
version on the card; they skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.ops import corr_pallas as jcp
from raft_stereo_tpu.ops import gates_pallas, gru_tail_pallas
from raft_stereo_tpu_torch import profile_stages
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import corr, corr_cuda, gates, gru_tail
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixture)
    bf16_ulps,
    halve_kernels,
    jax_apply,
    jax_init,
    nchw,
    nhwc,
    torch_single_thread,
)

BF16 = torch.bfloat16
# NHWC shapes: rows 192, 126 and 1200 (not a multiple of 1024), channels
# 32, 128 and 8.
SHAPES = [(1, 12, 16, 32), (2, 7, 9, 128), (1, 40, 30, 8)]
# Share of elements allowed to differ by the one ulp (measured 0 for the
# tail, rh and combine, 1.2e-5 for the windowed lookup).
ULP_SHARE = 0.02
H, W, ITERS = 48, 64, 3
HID = (32, 32, 32)
MIXED = dict(corr_implementation="pallas", mixed_precision=True, corr_dtype="bfloat16")


def bf16_inputs(rng, shape, n):
    """n arrays of 2 x standard normal values, rounded to bf16 (round to
    nearest even), as numpy fp32: both packages take the same bf16 values."""
    return [torch.from_numpy((2 * rng.standard_normal(shape)).astype(np.float32)).to(BF16).float().numpy()
            for _ in range(n)]


def jax_bf16(arrays):
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]


def torch_bf16(arrays):
    return [nchw(a).to(BF16) for a in arrays]


def as_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def check_ulp(got, want):
    """got (NCHW torch bf16) within 1 bf16 ulp of want (NHWC jax bf16), the
    differing share below ULP_SHARE; returns that share."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    ulps = bf16_ulps(nhwc(got.float()), as_f32(want))
    share = float((ulps > 0).mean())
    assert ulps.max() <= 1 and share <= ULP_SHARE, (ulps.max(), share)
    return share


# -- the kernels' plain versions against the Pallas bodies ------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_tail_matches_pallas(rng, shape):
    ops = bf16_inputs(rng, shape, 5)
    want = gru_tail_pallas.fused_gru_tail(*jax_bf16(ops))
    before = dict(gru_tail.LAUNCHES)
    got = gru_tail.fused_gru_tail(*torch_bf16(ops))
    check_ulp(got, want)
    assert gru_tail.LAUNCHES == before  # CPU tensors: the plain version ran
    # The twin rounds once; the unfused ConvGRU formula rounds at every op,
    # and at this size the two differ somewhere.
    assert torch.equal(got, gru_tail.plain_fused_gru_tail(*torch_bf16(ops)))
    assert not torch.equal(got, gru_tail.plain_gru_tail(*torch_bf16(ops)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_motion_tail_matches_pallas(rng, shape):
    pre, flow = bf16_inputs(rng, (*shape[:3], 126), 1)[0], bf16_inputs(rng, (*shape[:3], 1), 1)[0]
    want = gru_tail_pallas.fused_motion_tail(*jax_bf16([pre, flow]))
    got = gru_tail.fused_motion_tail(*torch_bf16([pre, flow]))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(nhwc(got.float()), as_f32(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_gates_match_pallas(rng, shape):
    rx, cr, h, zx, cz, qx, cq = bf16_inputs(rng, shape, 7)
    before = dict(gates.LAUNCHES)
    check_ulp(gates.fused_rh(*torch_bf16([rx, cr, h])), gates_pallas.fused_rh(*jax_bf16([rx, cr, h])))
    combined = gates.fused_combine(*torch_bf16([zx, cz, qx, cq, h]))
    check_ulp(combined, gates_pallas.fused_combine(*jax_bf16([zx, cz, qx, cq, h])))
    assert gates.LAUNCHES == before
    # combine is the fused tail's function, in bf16 too.
    assert torch.equal(combined, gru_tail.plain_fused_gru_tail(*torch_bf16([zx, cz, qx, cq, h])))


def test_plain_twins_are_the_fp32_formulas_on_fp32(rng):
    """On fp32 operands the twins are today's fp32 plain versions exactly."""
    ops = [torch.from_numpy(a) for a in bf16_inputs(rng, (1, 8, 12, 16), 5)]
    assert torch.equal(gru_tail.plain_fused_gru_tail(*ops), gru_tail.plain_gru_tail(*ops))
    assert torch.equal(gates.plain_combine(*ops), gru_tail.plain_gru_tail(*ops))
    assert torch.equal(gates.plain_rh(*ops[:3]), torch.sigmoid(ops[0] + ops[1]) * ops[2])


@pytest.mark.parametrize("family", ["smooth", "uniform"])
def test_plain_bf16_windowed_lookup_matches_pallas(rng, family):
    """bf16 levels, bf16 taps. "smooth" coordinates (the model's regime) run
    the JAX windowed kernel; "uniform" ones defeat its window plan and take
    its dense fallback."""
    b, h, w1, w2 = 2, 2, 600, 600
    levels = [torch.from_numpy(rng.standard_normal((b, h, w1, w2 >> l)).astype(np.float32)).to(BF16)
              for l in range(4)]
    if family == "smooth":
        disp = 0.5 + 5.5 * (0.5 + 0.5 * np.sin(np.linspace(0, 3.0, w1, dtype=np.float32)))
        x = np.broadcast_to(np.arange(w1, dtype=np.float32) - disp, (b, h, w1))
    else:
        x = rng.uniform(-6, w2 + 6, size=(b, h, w1))
    x = np.ascontiguousarray(x, dtype=np.float32)
    padded = jcp.pad_pyramid([jnp.asarray(lvl.float().numpy()).astype(jnp.bfloat16) for lvl in levels], x.shape)
    want = jcp.prefetch_corr_lookup_padded(padded, jnp.asarray(x), 4, jnp.bfloat16)
    # The reference's own claim: its windowed kernel is its dense one, bit for bit.
    np.testing.assert_array_equal(as_f32(want), as_f32(jcp._lookup_pallas_padded(padded, jnp.asarray(x), 4,
                                                                                   jnp.bfloat16)))
    before = dict(corr_cuda.LAUNCHES)
    got = corr_cuda.prefetch_corr_lookup(levels, torch.from_numpy(x), 4, BF16)
    assert corr_cuda.LAUNCHES == before
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == (b, h, w1, 36)
    assert torch.equal(got, corr_cuda.corr_lookup(levels, torch.from_numpy(x), 4, BF16))
    assert torch.equal(got, corr.corr_lookup(levels, torch.from_numpy(x), 4).to(BF16))
    ulps = bf16_ulps(got, as_f32(want))
    assert ulps.max() <= 1 and (ulps > 0).mean() <= ULP_SHARE


# -- the levers in the mixed forward ------------------------------------------------

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


LEVERS = {name: lever for name, lever in profile_stages.LEVERS.items() if name != "off"}


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_mixed_forward_hands_each_wrapper_one_dtype(monkeypatch, images, lever):
    """A mixed test-mode forward (hidden 16, 48x64, 3 iterations) with the
    lever on: every operand that reaches the tail, motion-tail, rh and
    combine wrappers, and the windowed lookup's levels and taps, are bf16,
    so the kernels' one-dtype rule (a mix raises on the card) holds on the
    model's path."""
    flags, gates_on = LEVERS[lever]
    if gates_on:
        monkeypatch.setenv(gates.ENV_VAR, "1")
    else:
        monkeypatch.delenv(gates.ENV_VAR, raising=False)
    seen = {}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            tensors = [t for t in args if isinstance(t, torch.Tensor)]
            if name == "prefetch_corr_lookup":
                tensors = list(args[0]) + [out]  # levels and taps; the coordinates stay fp32
            seen.setdefault(name, set()).update(t.dtype for t in (*tensors, out))
            return out

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((gru_tail, "fused_gru_tail"), (gru_tail, "fused_motion_tail"), (gates, "fused_rh"),
                         (gates, "fused_combine"), (corr_cuda, "prefetch_corr_lookup")):
        spy(module, name)
    model = build_model(RAFTStereoConfig(hidden_dims=(16, 16, 16), **MIXED, **flags), seed=0, device="cpu")
    with torch.inference_mode():
        lo, up = model(*map(torch.from_numpy, images), iters=ITERS, test_mode=True)
    assert torch.isfinite(up).all() and up.dtype == torch.float32
    want = {"fused_gru_tail": {"fused_gru_tail", "fused_motion_tail"}, "prefetch_lookup": {"prefetch_corr_lookup"},
            "gates": {"fused_rh", "fused_combine"}}[lever]
    assert set(seen) == want
    assert all(dtypes == {BF16} for dtypes in seen.values()), seen


@pytest.mark.parametrize("lever", ["fused_gru_tail", "prefetch_lookup"])
def test_mixed_lever_forward_matches_jax(weights, images, lever):
    flags = LEVERS[lever][0]
    cfg = dict(hidden_dims=HID, corr_implementation="pallas", **flags)
    jax32 = jax_apply(JaxRAFTStereo(JaxConfig(**cfg)), weights, *images, iters=ITERS, test_mode=True)
    jax16 = jax_apply(JaxRAFTStereo(JaxConfig(**cfg, mixed_precision=True, corr_dtype="bfloat16")), weights,
                      *images, iters=ITERS, test_mode=True)
    model = load_jax_variables(RAFTStereo(RAFTStereoConfig(**cfg, mixed_precision=True, corr_dtype="bfloat16")),
                               weights).eval()
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, images), iters=ITERS, test_mode=True)
    assert np.abs(jax32[1]).max() > 1.0  # the flows moved
    for g, w16, w32 in zip(got, jax16, jax32):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        gap = np.abs(w16 - w32).max()
        assert gap > 1e-3  # bf16 compute shows: the bound below has a scale
        assert np.abs(g.numpy() - w16).max() <= 2 * gap


# -- the kernels on the card ----------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(12, 16), (7, 9)])  # vector and scalar kernel paths
def test_bf16_lever_kernels_match_plain_on_cuda(rng, hw):
    """Each bf16 kernel against its plain version: bit for bit (the tail,
    rh and combine compute the plain version's fp32 formulas under
    -fmad=false and round once; motion tail and windowed lookup exact)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 kernels have no CPU form")
    ops = [torch.from_numpy(a).cuda().to(BF16) for a in bf16_inputs(rng, (2, 32, *hw), 5)]
    assert torch.equal(gru_tail.fused_gru_tail(*ops), gru_tail.plain_fused_gru_tail(*ops))
    assert torch.equal(gates.fused_rh(*ops[:3]), gates.plain_rh(*ops[:3]))
    assert torch.equal(gates.fused_combine(*ops), gates.plain_combine(*ops))
    pre = torch.from_numpy(bf16_inputs(rng, (2, 126, *hw), 1)[0]).cuda().to(BF16)
    flow = torch.from_numpy(bf16_inputs(rng, (2, 1, *hw), 1)[0]).cuda().to(BF16)
    assert torch.equal(gru_tail.fused_motion_tail(pre, flow), gru_tail.plain_motion_tail(pre, flow))
    levels = [torch.randn((1, hw[0], hw[1], 40 >> l), device="cuda").to(BF16) for l in range(4)]
    x = (torch.arange(hw[1], device="cuda") - 3.0 * torch.rand((1, *hw), device="cuda")).contiguous()
    assert torch.equal(corr_cuda.prefetch_corr_lookup(levels, x, 4, BF16), corr_cuda.corr_lookup(levels, x, 4, BF16))
    with pytest.raises(ValueError, match="one dtype"):
        gru_tail.fused_gru_tail(*ops[:4], ops[4].float())
