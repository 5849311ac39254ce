"""`sequential_encoder` and `sequential_batch_forward` of the port against
the JAX package, at 48x64, 3 iterations, on perturbed kernel-halved
weights (tests/test_torch_model.py says why).

- A sequential config's JAX variables (its scanned "fnet" at B=2) load
  into the port with `load_jax_variables` and no new rule: the tree is
  the batched one's.
- `sequential_encoder` at B=1 (the anchor form) and B=2 (one image at a
  time) against JAX's sequential forward: 1e-4; against the port's
  batched encoder on the same weights: 1e-5 (the same per-image math in
  another grouping), with the fused encoder too.
- `sequential_batch_forward` at B=2: each map equal to its batch-1
  forward bit for bit, and to JAX's `sequential_batch_forward` to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.models import sequential_batch_forward as jax_sequential_batch_forward
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo, sequential_batch_forward
from raft_stereo_tpu_torch.utils.checkpoints import load_jax_variables
from torch_parity import (  # noqa: F401 (autouse fixtures)
    flat_leaves,
    halve_kernels,
    jax_apply,
    jax_init,
    torch_single_thread,
)

H, W, ITERS = 48, 64, 3
HID = (32, 32, 32)
SEQ = {"corr_implementation": "reg", "sequential_encoder": True}


@pytest.fixture(scope="module")
def weights():
    """Initialized through the sequential config at B=2 (the scanned fnet),
    so loading it proves the tree is unchanged."""
    img = jnp.zeros((2, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **SEQ)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(17)
    left = rng.uniform(0, 255, (2, H, W + 6, 3)).astype(np.float32)
    return left[:, :, 6:], left[:, :, :W]


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights).eval()


def test_sequential_tree_is_the_batched_tree(weights):
    img = jnp.zeros((1, H, W, 3))
    batched = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID)), img, img, iters=1)
    assert {k: v.shape for k, v in flat_leaves(batched["params"]).items()} == {
        k: v.shape for k, v in flat_leaves(weights["params"]).items()}


@pytest.mark.parametrize("batch", [1, 2])
def test_sequential_encoder_matches_jax_and_batched(weights, images, batch):
    i1, i2 = (x[:batch] for x in images)
    want_lo, want_up = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **SEQ)), weights, i1, i2, iters=ITERS,
                                 test_mode=True)
    t1, t2 = torch.from_numpy(i1), torch.from_numpy(i2)
    with torch.inference_mode():
        got_lo, got_up = port_model(weights, **SEQ)(t1, t2, iters=ITERS, test_mode=True)
        plain_lo, plain_up = port_model(weights, corr_implementation="reg")(t1, t2, iters=ITERS, test_mode=True)
    assert np.abs(want_up).max() > 1.0
    np.testing.assert_allclose(got_lo.numpy(), want_lo, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), want_up, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), plain_up.numpy(), rtol=1e-5, atol=1e-5)


def test_sequential_fused_encoder_matches_batched(weights, images):
    """With the fused encoder the layer-1 kernels (their plain versions on
    the CPU) run per image; the flows are the batched encoder's."""
    fused = {"corr_implementation": "pallas", "fused_gru_tail": True, "fused_encoder": True}
    t1, t2 = map(torch.from_numpy, images)
    with torch.inference_mode():
        seq = port_model(weights, sequential_encoder=True, **fused)(t1, t2, iters=ITERS, test_mode=True)
        batched = port_model(weights, **fused)(t1, t2, iters=ITERS, test_mode=True)
    for a, b in zip(seq, batched):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_sequential_batch_forward_is_batch_one_and_jax(weights, images):
    model = port_model(weights, **SEQ)
    t1, t2 = map(torch.from_numpy, images)
    lo, up = sequential_batch_forward(model, t1, t2, iters=ITERS)
    assert lo.shape == (2, H // 4, W // 4) and up.shape == (2, H, W, 1)
    with torch.inference_mode():
        for b in range(2):
            one_lo, one_up = model(t1[b : b + 1], t2[b : b + 1], iters=ITERS, test_mode=True)
            assert torch.equal(lo[b : b + 1], one_lo) and torch.equal(up[b : b + 1], one_up)
    jm = JaxRAFTStereo(JaxConfig(hidden_dims=HID, **SEQ))
    want_lo, want_up = jax_sequential_batch_forward(jm, weights, jnp.asarray(images[0]), jnp.asarray(images[1]),
                                                    iters=ITERS)
    np.testing.assert_allclose(lo.numpy(), np.asarray(want_lo), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(up.numpy(), np.asarray(want_up), rtol=1e-4, atol=1e-4)
