"""The weight bridge (JAX variables -> port), the port's seeded init, and the
port's import isolation from JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.utils.checkpoints import _flax_key, load_jax_variables
from torch_parity import jax_init, pallas_tpu_compiler_params, torch_single_thread  # noqa: F401 (autouse fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[3, 2])
def bundle(request):
    n = request.param
    img = jnp.zeros((1, 32, 64, 3))
    jcfg = JaxConfig(hidden_dims=(32, 48, 64), n_gru_layers=n)
    variables = jax_init(JaxRAFTStereo(jcfg), img, img, iters=1)
    return RAFTStereoConfig(hidden_dims=(32, 48, 64), n_gru_layers=n), variables


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*prefix, k))
        else:
            yield (*prefix, k), v


def test_bridge_sets_every_tensor_from_its_leaf(bundle):
    cfg, variables = bundle
    check_every_tensor_from_its_leaf(load_jax_variables(RAFTStereo(cfg), variables), variables)


def test_bridge_takes_a_fused_encoder_tree():
    """Variables of a JAX model initialized with `fused_encoder=True` (the
    fused branch traced) fill the port's fused model: no leaf unused, no
    tensor unset."""
    img = jnp.zeros((1, 32, 64, 3))
    flags = {"hidden_dims": (32, 48, 64), "corr_implementation": "pallas", "fused_encoder": True}
    variables = jax_init(JaxRAFTStereo(JaxConfig(**flags)), img, img, iters=1, test_mode=True)
    model = load_jax_variables(RAFTStereo(RAFTStereoConfig(**flags)), variables)
    check_every_tensor_from_its_leaf(model, variables)


def check_every_tensor_from_its_leaf(model, variables):
    leaves = {(c, *p): v for c in ("params", "batch_stats") for p, v in _leaves(variables[c])}
    state = model.state_dict()
    assert len(state) == len(leaves)
    seen = set()
    for name, tensor in state.items():
        key, is_kernel = _flax_key(model, name)
        want = leaves[key].transpose(3, 2, 0, 1) if is_kernel else leaves[key]
        np.testing.assert_array_equal(tensor.numpy(), want)
        seen.add(key)
    assert seen == set(leaves)


def test_bridge_raises_on_unused_missing_or_misshapen_leaves(bundle):
    cfg, variables = bundle
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros(3, np.float32)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="left unused"):
        load_jax_variables(RAFTStereo(cfg), extra)
    missing = {"params": {k: v for k, v in variables["params"].items() if k != "mask_head"},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="has no JAX leaf"):
        load_jax_variables(RAFTStereo(cfg), missing)
    params = dict(variables["params"])
    params["context_zqr_conv0"] = {"Conv_0": {"kernel": np.zeros((3, 3, 32, 5), np.float32),
                                              "bias": np.zeros(5, np.float32)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(RAFTStereo(cfg), {"params": params, "batch_stats": variables["batch_stats"]})


def test_seeded_init_is_deterministic_and_matches_the_jax_tree(bundle):
    cfg, variables = bundle
    a = build_model(cfg, seed=3, device="cpu")
    b = build_model(cfg, seed=3, device="cpu")
    c = build_model(cfg, seed=4, device="cpu")
    for (name, ta), tb, tc in zip(a.state_dict().items(), b.state_dict().values(), c.state_dict().values()):
        assert torch.equal(ta, tb), name
        if name.endswith("conv1.weight"):
            assert not torch.equal(ta, tc), name
    # Same tensors, same shapes as the JAX tree: the bridge accepts it.
    load_jax_variables(a, variables)
    w = a.update_block.gru08.convz.weight
    assert w.shape[0] == cfg.hidden_dims[2]


def test_flax_init_scale_is_reproduced():
    """Conv kernels follow flax's truncated-normal He fan-out init."""
    model = build_model(RAFTStereoConfig(hidden_dims=(32, 32, 32)), seed=0, device="cpu")
    w = model.update_block.gru08.convq.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() / np.sqrt(2.0 / fan_out) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 * np.sqrt(2.0 / fan_out) / 0.87962566103423978 + 1e-6
    assert model.update_block.gru08.convq.bias.detach().abs().max().item() == 0.0


def test_port_imports_no_jax():
    """Importing every port module (the training package, the evaluate
    entry point and its command line included), chip_smoke.py's imports and
    train_compare.py's loads no JAX and nothing of the JAX package."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import raft_stereo_tpu_torch\n"
        "for m in pkgutil.walk_packages(raft_stereo_tpu_torch.__path__, 'raft_stereo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, train_compare\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'raft_stereo_tpu' or k.startswith('raft_stereo_tpu.'))\n"
        "assert not bad, bad\n"
        "walked = {k for k in sys.modules if k.startswith('raft_stereo_tpu_torch')}\n"
        "for m in ('train.loss', 'train.optimizer', 'train.trainer', 'train.synthetic', 'ops.corr_cuda',\n"
        "          'serving.service', 'evaluate', 'cli', '__main__', 'ops.gates', 'serving.batcher',\n"
        "          'serving.lifecycle', 'video.session', 'obs.trace', 'obs.prom', 'obs.memory',\n"
        "          'utils.run_report', 'utils.http', 'utils.resilience', 'utils.retry', 'utils.metrics',\n"
        "          'utils.profiling', 'utils.checkpoints', 'data.native_io', 'data.png', 'data.frame_io',\n"
        "          'data.augment', 'data.datasets', 'data.loader', 'data.prefetch', 'data.trees', 'demo',\n"
        "          'serving.fleet', 'serving.frontier', 'serving.engine', 'models.raft_stereo', 'ops.corr',\n"
        "          'parallel', 'parallel.distributed', 'parallel.mesh', 'parallel.sharding',\n"
        "          'parallel.coordination', 'train.io_spine', 'parallel.spatial', 'utils.fsck',\n"
        "          'utils.check_report', 'utils.jit_hygiene', 'serving.aot'):\n"
        "    assert 'raft_stereo_tpu_torch.' + m in walked, m\n"
        "print('ok', len(walked))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_frontier_imports_neither_torch_nor_jax():
    """The front tier holds no model: importing it, and the `frontier`
    subcommand's parser path, in a fresh interpreter loads neither torch
    nor JAX (a frontier process boots in milliseconds)."""
    code = (
        "import sys\n"
        "import raft_stereo_tpu_torch.serving.frontier\n"
        "from raft_stereo_tpu_torch import cli\n"
        "assert cli.main(['frontier', '--rollout', 'x.pth', '--port', '1']) == cli.EXIT_ADMIN_UNREACHABLE\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('torch', 'jax', 'raft_stereo_tpu', 'numpy'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a CUDA device the smoke test exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the package, it cannot run either.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and '"ok"' not in out.stdout
