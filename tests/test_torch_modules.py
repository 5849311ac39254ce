"""PyTorch-port modules against the flax modules, through the weight bridge:
ResidualBlock, both encoders, BasicMultiUpdateBlock with
the fused tail on and off (the JAX tail kernels in Pallas interpret mode),
and UpsampleMaskHead. Every module's batch-norm statistics and biases are
perturbed before use (tests/torch_parity.py).

Tolerance: 1e-5 of the output's scale (max |JAX output|). Through a whole
encoder both fp32 implementations sit about 2e-6 of that scale away from a
float64 run of the port, which is the noise this bound must admit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.models import extractor as jext
from raft_stereo_tpu.models import layers as jlayers
from raft_stereo_tpu.models import update as jupdate
from raft_stereo_tpu_torch.models.extractor import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.models.layers import ResidualBlock
from raft_stereo_tpu_torch.models.update import BasicMultiUpdateBlock, UpsampleMaskHead
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import jax_apply, jax_init, jnp_tree, nchw, nhwc, torch_single_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
HID = (32, 32, 32)


def port(module, variables):
    return load_jax_variables(module, variables).eval()


def close(got, want):
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize(
    "norm,stride,cin,cout",
    [("instance", 1, 32, 32), ("batch", 2, 32, 48), ("group", 1, 16, 32), ("batch", 1, 32, 32),
     ("none", 2, 16, 16)],
)
def test_residual_block(rng, norm, stride, cin, cout):
    x = rng.standard_normal((2, 12, 16, cin)).astype(np.float32)
    jm = jlayers.ResidualBlock(cout, norm, stride=stride, in_features=cin)
    v = jax_init(jm, jnp.asarray(x))
    tm = port(ResidualBlock(cin, cout, norm, stride=stride), v)
    assert tm.has_skip_conv == (stride != 1 or cin != cout)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), jax_apply(jm, v, x))


def test_basic_encoder(rng):
    x = rng.uniform(-1, 1, (2, 48, 64, 3)).astype(np.float32)
    jm = jext.BasicEncoder(output_dim=64, norm_fn="instance", downsample=2)
    v = jax_init(jm, jnp.asarray(x))
    tm = port(BasicEncoder(64, "instance", downsample=2), v)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), jax_apply(jm, v, x))


def test_multi_basic_encoder(rng):
    x = rng.uniform(-1, 1, (1, 48, 64, 3)).astype(np.float32)
    jm = jext.MultiBasicEncoder(output_dims=(HID, HID), norm_fn="batch", downsample=2)
    v = jax_init(jm, jnp.asarray(x), num_layers=3)
    want = jax_apply(jm, v, x, num_layers=3)
    tm = port(MultiBasicEncoder((HID, HID), "batch", downsample=2, num_layers=3), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 3
    for g_scale, w_scale in zip(got, want):
        for g, w in zip(g_scale, w_scale):
            close(nhwc(g), w)


def update_inputs(rng, b=2, h=12, w=16):
    net = tuple(
        np.tanh(rng.standard_normal((b, h >> i, w >> i, HID[2 - i]))).astype(np.float32) for i in range(3)
    )
    context = tuple(
        tuple(rng.standard_normal((b, h >> i, w >> i, HID[2 - i])).astype(np.float32) for _ in range(3))
        for i in range(3)
    )
    corr = rng.standard_normal((b, h, w, 36)).astype(np.float32)
    flow = rng.uniform(-3, 3, (b, h, w, 1)).astype(np.float32)
    return net, context, corr, flow


@pytest.mark.parametrize("fused_tail", [False, True])
def test_update_block(rng, fused_tail):
    net, context, corr, flow = update_inputs(rng)
    jm = jupdate.BasicMultiUpdateBlock(HID, 36, n_gru_layers=3, n_downsample=2, fused_tail=fused_tail)
    jargs = jnp_tree((net, context, corr, flow))
    v = jax_init(jm, *jargs)
    want_net, want_delta = jax_apply(jm, v, *jargs)
    # The slow_fast_gru schedule: coarse GRUs only, no heads.
    want_slow = jax_apply(jm, v, jargs[0], jargs[1], iter08=False, update=False)

    tm = port(BasicMultiUpdateBlock(HID, 36, 3, 2, fused_tail=fused_tail), v)
    tnet = tuple(nchw(n) for n in net)
    tctx = tuple(tuple(nchw(c) for c in scale) for scale in context)
    with torch.no_grad():
        got_net, got_delta = tm(tnet, tctx, nchw(corr), nchw(flow), test_mode=True)
        got_slow = tm(tnet, tctx, iter08=False, update=False, test_mode=True)
    close(nhwc(got_delta), want_delta)
    for g, w in zip(got_net, want_net):
        close(nhwc(g), w)
    for g, w in zip(got_slow, want_slow):
        close(nhwc(g), w)


def test_upsample_mask_head(rng):
    x = np.tanh(rng.standard_normal((2, 12, 16, 32))).astype(np.float32)
    jm = jupdate.UpsampleMaskHead(n_downsample=2)
    v = jax_init(jm, jnp.asarray(x))
    tm = port(UpsampleMaskHead(2, 32), v)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), jax_apply(jm, v, x))
