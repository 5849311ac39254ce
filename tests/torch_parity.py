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
