"""The reference's realtime model (`shared_backbone`, `n_downsample=3`,
`n_gru_layers=2`, `slow_fast_gru`) in the PyTorch port against the JAX
package.

Shared (perturbed, kernel-halved: tests/test_torch_model.py `weights`
says why) weights of the JAX realtime model at hidden 32, 64x96 images,
3 iterations; JAX under "highest" matmul precision, its Pallas kernels in
interpret mode. On CPU tensors the port's wrappers run their plain versions.

- The architecture at fp32, "reg" and "pallas" with `fused_encoder` and
  `fused_gru_tail` on both sides (the cnet's fused layer1 over the 2B
  batch, frozen batch norm, so no instance statistics in the fused part):
  rtol = atol = 1e-4 (measured at most 6.2e-6 px of flows up to 14 px).
- The realtime configuration in full (mixed precision, bf16 pyramid,
  "pallas", `fused_encoder`, `fused_gru_tail`) against JAX's bf16 forward
  with the same flags: within twice JAX's own bf16-vs-fp32 gap on the same
  weights (tests/test_torch_mixed.py says why; measured 0.84 of the gap
  for the low-resolution flow, 0.52 for the upsampled one).
- The weight bridge: `load_jax_variables` on the shared-backbone tree (no
  `fnet`; an `fnet` leaf left over, or `conv2_out` missing, raises) and the
  reference `.pth` restore of a synthesized state dict with `conv2.0.*`
  and `conv2.1.*`, which gives the very same forward.
- The CLI's realtime command line (`--dataset eth3d --dry_run --device
  cpu`) runs to its validation line.
- The anytime engine serves the realtime configuration at 7 iterations in
  one chunk (`chunk_iters=7, max_iters=7`) and equals the direct forward.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.utils.checkpoints import convert_state_dict as jax_convert_state_dict
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.utils.checkpoints import (
    convert_state_dict,
    load_jax_variables,
    load_reference_checkpoint,
)
from torch_parity import (  # noqa: F401 (autouse fixtures)
    flat_leaves,
    halve_kernels,
    jax_apply,
    jax_init,
    pallas_tpu_compiler_params,
    reference_state_dict,
    torch_single_thread,
)

H, W, ITERS = 64, 96, 3
HID = (32, 32, 32)
ARCH = dict(shared_backbone=True, n_downsample=3, n_gru_layers=2, slow_fast_gru=True)
MIXED = dict(mixed_precision=True, corr_dtype="bfloat16")
LEVERS = dict(corr_implementation="pallas", fused_encoder=True, fused_gru_tail=True)
REALTIME = dict(ARCH, **MIXED, **LEVERS)
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    img = jnp.zeros((1, H, W, 3))
    v = jax_init(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **ARCH)), img, img, iters=1)
    return {"params": halve_kernels(v["params"]), "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    left = rng.uniform(0, 255, (1, H, W + 8, 3)).astype(np.float32)
    return left[:, :, 8:], left[:, :, :W]


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights).eval()


def port_forward(model, images, iters=ITERS):
    with torch.inference_mode():
        return model(*map(torch.from_numpy, images), iters=iters, test_mode=True)


def jax_forward(weights, images, **flags):
    return jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **flags)), weights, *images, iters=ITERS,
                     test_mode=True)


@pytest.mark.parametrize("flags", [dict(corr_implementation="reg"), LEVERS],
                         ids=["reg", "pallas+fused_encoder+fused_gru_tail"])
def test_realtime_architecture_matches_jax(weights, images, flags):
    want = jax_forward(weights, images, **ARCH, **flags)
    model = port_model(weights, **ARCH, **flags)
    assert not hasattr(model, "fnet") and model.cnet.num_layers == 2
    got = port_forward(model, images)
    assert got[0].shape == (1, H // 8, W // 8) and got[1].shape == (1, H, W, 1)
    assert np.abs(want[1]).max() > 1.0  # the flows moved: the comparison has teeth
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_realtime_configuration_matches_jax_bf16(weights, images):
    jax32 = jax_forward(weights, images, **ARCH, **LEVERS)
    jax16 = jax_forward(weights, images, **REALTIME)
    model = port_model(weights, **REALTIME)
    got = port_forward(model, images)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for g, w16, w32 in zip(got, jax16, jax32):
        assert g.dtype == torch.float32 and np.isfinite(g.numpy()).all()
        gap = np.abs(w16 - w32).max()
        assert gap > 1e-3  # bf16 compute shows: the bound below has a scale
        assert np.abs(g.numpy() - w16).max() <= 2 * gap


def test_load_jax_variables_takes_the_shared_backbone_tree(weights):
    params = weights["params"]
    assert "fnet" not in params and {"conv2_res", "conv2_out"} <= set(params)
    model = port_model(weights, **ARCH)
    np.testing.assert_array_equal(model.conv2_out.weight.detach().numpy(),
                                  params["conv2_out"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    extra = {"params": dict(params, fnet={"conv2": {"Conv_0": {"bias": np.zeros(256, np.float32)}}}),
             "batch_stats": weights["batch_stats"]}
    with pytest.raises(KeyError, match="left unused"):
        port_model(extra, **ARCH)
    missing = {"params": {k: v for k, v in params.items() if k != "conv2_out"},
               "batch_stats": weights["batch_stats"]}
    with pytest.raises(KeyError, match="conv2_out"):
        port_model(missing, **ARCH)
    # The seeded draw covers the new convs too (biases zero, kernels drawn).
    seeded = build_model(RAFTStereoConfig(hidden_dims=HID, **ARCH), seed=0, device="cpu")
    for conv in (seeded.conv2_res.conv1, seeded.conv2_res.conv2, seeded.conv2_out):
        assert conv.weight.std() > 0 and not conv.bias.any()


def test_reference_pth_restores_the_shared_backbone(weights, images, tmp_path):
    jcfg = JaxConfig(hidden_dims=HID, **ARCH)
    sd = reference_state_dict(weights, jcfg, np.random.default_rng(5))
    assert {"conv2.0.conv1.weight", "conv2.0.conv2.bias", "conv2.1.weight", "conv2.1.bias"} <= set(sd)
    assert not any(k.startswith("fnet.") for k in sd)
    want = flat_leaves(jax_convert_state_dict(sd, jcfg))
    got = flat_leaves(convert_state_dict(sd, RAFTStereoConfig(hidden_dims=HID, **ARCH)))
    assert got.keys() == want.keys() == flat_leaves(weights).keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    path = tmp_path / "raftstereo-realtime.pth"
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    restored = load_reference_checkpoint(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **REALTIME)), str(path))
    for a, b in zip(port_forward(restored.eval(), images), port_forward(port_model(weights, **REALTIME), images)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cli_realtime_command_line_runs(capsys):
    argv = ["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", "--shared_backbone",
            "--n_downsample", "3", "--n_gru_layers", "2", "--slow_fast_gru", "--valid_iters", "7",
            "--corr_implementation", "reg_cuda", "--mixed_precision", "--fused_encoder", "--fused_gru_tail"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Validation ETH3D: EPE" in out
    p = argparse.ArgumentParser()
    p.add_argument("--valid_iters", type=int)
    cli._add_model_args(p)
    config = cli._model_config(p.parse_args(argv[6:]))
    assert config == RAFTStereoConfig(**REALTIME)


def test_engine_serves_the_realtime_configuration(weights, images):
    """7 iterations in one chunk: `chunk_iters=7, max_iters=7` (the engine
    rounds a budget up to whole chunks, so the realtime budget is one
    chunk, not two of 4)."""
    model = port_model(weights, **REALTIME)
    cfg = ServeConfig(model=model.config, buckets=((H, W),), max_batch=1, chunk_iters=7, max_iters=7)
    engine = AnytimeEngine(cfg, model, device="cpu")
    assert engine.warm()["combos"] == 1
    i1, i2 = map(torch.from_numpy, images)
    (res,) = engine.run_batch((H, W), i1, i2, deadlines_s=[None], max_iters=[7])
    assert res.iters_completed == 7 and not res.early_exit
    lo, up = port_forward(model, images, iters=7)
    np.testing.assert_array_equal(res.flow_up, up[0].numpy())
    np.testing.assert_array_equal(res.flow_lowres, lo[0].numpy())
