"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
variables come from one jitted flax init per module, with every norm
statistic and every bias perturbed by numpy noise — flax init gives an
identity batch norm and zero biases, which would hide a wrong mapping in the
weight bridge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu.utils.checkpoints import convert_state_dict as jax_convert_state_dict


@pytest.fixture(autouse=True, scope="module")
def torch_single_thread():
    """One PyTorch CPU thread while a port test module runs. PyTorch
    defaults to a thread per core in every process; under the test runner's
    parallel workers that oversubscribes the machine and slowed these tests
    about tenfold. Import this fixture into a test module to apply it."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def pallas_tpu_compiler_params():
    """Lets the JAX package's fused encoder conv (`fused_conv_s2d`, which
    names `pltpu.TPUCompilerParams`) run in Pallas interpret mode under a
    JAX that has renamed the class to `pltpu.CompilerParams`. A no-op where
    the old name exists; the JAX package itself is untouched. Import this
    fixture into a test module that calls the fused conv."""
    from jax.experimental.pallas import tpu as pltpu

    if hasattr(pltpu, "TPUCompilerParams"):
        yield
        return
    pltpu.TPUCompilerParams = pltpu.CompilerParams
    try:
        yield
    finally:
        del pltpu.TPUCompilerParams


def numpy_tree(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturb(variables, seed: int = 0):
    """Noise on every bias and on the batch-norm scale/mean/var (var stays
    positive). Returns a new nested-dict tree."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        noise = rng.standard_normal(tree.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, tree.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (tree + 0.1 * noise).astype(np.float32)
        if name == "scale":
            return (tree * (1.0 + 0.1 * noise)).astype(np.float32)
        return tree

    return {c: walk(t) for c, t in numpy_tree(variables).items()}


def jax_init(module, *args, seed: int = 0, **kwargs):
    """One jitted flax init, perturbed, as nested dicts of numpy arrays."""
    init = jax.jit(lambda r, *a: module.init(r, *a, **kwargs))
    return perturb(init(jax.random.PRNGKey(seed), *args), seed)


def halve_kernels(tree):
    """A variables tree with every conv kernel halved: the model-level
    parity tests' weights (tests/test_torch_model.py `weights` says why)."""
    return {k: halve_kernels(v) if isinstance(v, dict) else (0.5 * v if k == "kernel" else v)
            for k, v in tree.items()}


def jax_apply(module, variables, *args, **kwargs):
    """One jitted flax apply at full fp32 precision, outputs as numpy."""
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(variables, *args)
    return jax.tree.map(np.asarray, out)


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(x: torch.Tensor) -> np.ndarray:
    """NCHW torch -> NHWC numpy."""
    return np.moveaxis(x.detach().numpy(), 1, -1)


def jnp_tree(tree):
    """A nested structure of numpy arrays as jax arrays."""
    return jax.tree.map(jnp.asarray, tree)


def flax_params(model, grads: bool = False) -> dict:
    """The parameters of a port module (or, with `grads`, their `.grad`) as
    a nested dict of numpy arrays in the flax params layout (conv kernels
    OIHW -> HWIO), through the weight bridge's name mapping run in
    reverse."""
    from raft_stereo_tpu_torch.utils.checkpoints import _flax_key

    tree = {}
    for name, p in model.named_parameters():
        (collection, *path), is_kernel = _flax_key(model, name)
        assert collection == "params", name
        v = (p.grad if grads else p).detach().numpy().copy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v.transpose(2, 3, 1, 0) if is_kernel else v
    return tree


def flat_leaves(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


def bf16_ulps(got, want) -> np.ndarray:
    """Per-element distance in bf16 ulps of two arrays of bf16 values
    (either side fp32 or bf16, torch or numpy): the difference of their
    bit patterns as bf16, whose order follows the value's within one sign."""
    a = np.asarray(got.float() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32), np.float32)
    b = np.asarray(want.float() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32), np.float32)
    assert (a.view(np.uint32) & 0xFFFF == 0).all() and (b.view(np.uint32) & 0xFFFF == 0).all()
    ia = (a.view(np.int32) >> 16).astype(np.int64)
    ib = (b.view(np.int32) >> 16).astype(np.int64)
    # Map the sign-magnitude patterns onto one ordered line.
    ia = np.where(ia < 0, -(ia & 0x7FFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFF), ib)
    return np.abs(ia - ib)


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


def reference_state_dict(variables, jcfg, rng):
    """A state dict with the reference's keys that the JAX converter maps
    onto `variables`: the converter is run once on a probe whose every
    tensor holds its own key's index, which names the key behind each flax
    leaf; then each leaf is laid out as the reference stores it (OIHW
    kernels), with a random second channel in `convf1` and a random second
    row in `flow_head.conv2`, which both converters drop."""
    keys = []

    class Probe(dict):
        def __getitem__(self, key):
            if key not in keys:
                keys.append(key)
            return np.full((2, 2, 2, 2), float(keys.index(key)), np.float32)

        def __contains__(self, key):
            return True

    leaves = flat_leaves(variables)
    sd = {}
    for path, probe in flat_leaves(jax_convert_state_dict(Probe(), jcfg)).items():
        if path not in leaves:  # a bias the probe offered that the model lacks
            continue
        key = keys[int(probe.flat[0])]
        value = leaves[path]
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if key == "update_block.encoder.convf1.weight":
            value = np.concatenate([value, rng.standard_normal(value.shape).astype(np.float32)], axis=1)
        if key.startswith("update_block.flow_head.conv2."):
            value = np.concatenate([value, rng.standard_normal(value.shape).astype(np.float32)], axis=0)
        sd[key] = np.ascontiguousarray(value)
    return sd
