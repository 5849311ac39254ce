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


def jax_sharded_step(weights, batch, preset, mesh_shape, hidden_dims, iters):
    """One JAX training step under `preset` on a `mesh_shape` mesh of the
    conftest's host devices, jitted with the JAX `ShardingEngine`'s
    shardings as the JAX Trainer jits it (fp32, "highest" matmul
    precision), on `batch` (the global batch) from `weights`. Returns
    (metrics, new params) as numpy."""
    from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
    from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
    from raft_stereo_tpu.parallel.mesh import make_mesh
    from raft_stereo_tpu.parallel.sharding import ShardingEngine
    from raft_stereo_tpu.train.optimizer import make_optimizer
    from raft_stereo_tpu.train.trainer import TrainState, make_train_step

    jcfg = JaxTrainConfig(model=JaxConfig(hidden_dims=tuple(hidden_dims), encoder_s2d=False,
                                          corr_implementation="pallas"),
                          batch_size=len(batch["image1"]), train_iters=iters, num_steps=1000,
                          mesh_shape=tuple(mesh_shape), sharding_rules=preset)
    tx, schedule = make_optimizer(jcfg.lr, jcfg.num_steps, jcfg.wdecay, jcfg.grad_clip_norm)
    params = jax.tree.map(jnp.asarray, weights["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]), opt_state=tx.init(params))
    engine = ShardingEngine(make_mesh(tuple(mesh_shape)), preset)
    shardings = engine.state_shardings(state)
    step = jax.jit(make_train_step(jcfg, tx, schedule), in_shardings=(shardings, engine.batch_shardings()),
                   out_shardings=(shardings, engine.replicated()))
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(engine.place_state(state), engine.place_batch(batch))
    return {k: float(v) for k, v in metrics.items()}, flat_leaves(jax.tree.map(np.asarray, new_state.params))


def to_flax(model, named: dict) -> dict:
    """{port parameter name of `model`: OIHW array} as {flax path: HWIO
    array}, through the weight bridge's name mapping."""
    from raft_stereo_tpu_torch.utils.checkpoints import _flax_key

    out = {}
    for name, v in named.items():
        (_, *path), is_kernel = _flax_key(model, name)
        out[tuple(path)] = v.transpose(2, 3, 1, 0) if is_kernel else v
    return out


def assert_step_matches_jax(model, weights, metrics, params, grads, want, grad_tol=5e-3, fnet_tol=2e-1):
    """One port training step against JAX's (`want`: `jax_sharded_step`'s
    metrics and new params) from the same JAX `weights`, with
    tests/test_torch_train.py::test_train_step_matches_jax's tolerances
    (its GRAD_TOL and FNET_TOL): the metrics at rtol 1e-5, the gradient norm
    before clipping at 1e-4, every update within the step's size, and
    within 1e-3 lr (plus rounding) where the gradient is well resolved.
    `params` and `grads` are `model`'s, whole, by port name."""
    want_metrics, want_params = want
    assert set(metrics) == set(want_metrics)
    assert metrics["nonfinite"] == want_metrics["nonfinite"] == 0.0
    assert metrics["learning_rate"] == want_metrics["learning_rate"]
    for k in ("epe", "1px", "3px", "5px", "live_loss"):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"], want_metrics["grad_norm"], rtol=1e-4)
    lr = want_metrics["learning_rate"]
    before = flat_leaves(weights["params"])
    after, grads = to_flax(model, params), to_flax(model, grads)
    assert set(after) == set(want_params)
    for key, w_new in want_params.items():
        d_got, d_want = after[key] - before[key], w_new - before[key]
        assert np.abs(d_got - d_want).max() <= 2.0 * lr * (1 + 1e-3), key
        if key[:2] == ("fnet", "trunk") and key[-1] == "bias":
            continue
        g = np.abs(grads[key])
        sure = g > 1.5 * (fnet_tol if key[:2] == ("fnet", "trunk") else grad_tol) * g.max()
        ulp = np.spacing(np.maximum(np.abs(w_new), np.abs(after[key])))
        assert (np.abs(d_got - d_want) <= 1e-3 * lr + ulp)[sure].all(), key


def assert_updates_match_one_process(params, grads, want, grad_tol=5e-3, fnet_tol=2e-1):
    """A sharded port step's whole `params` and `grads` (by port name)
    against the port's one-process step on the whole batch (`want`: its
    "metrics", parameters "before" and after ("params"), and "grads"), with
    tests/test_torch_train.py's GRAD_TOL and FNET_TOL: every update within
    the step's size, each gradient within its tolerance of the leaf's
    largest, and the update within 1e-3 lr (plus rounding) where the
    gradient is well resolved; the feature trunk's biases, whose true
    gradient is zero, hold only rounding noise."""
    lr = want["metrics"]["learning_rate"]
    largest = max(np.abs(g).max() for g in want["grads"].values())
    for name, w_new in want["params"].items():
        trunk = name.startswith("fnet.trunk.")
        g_want, g_got = want["grads"][name], grads[name]
        d_got, d_want = params[name] - want["before"][name], w_new - want["before"][name]
        assert np.abs(d_got - d_want).max() <= 2.0 * lr * (1 + 1e-3), name
        if trunk and name.endswith("bias"):
            # A true gradient of zero: rounding noise, its sign a coin.
            assert max(np.abs(g_got).max(), np.abs(g_want).max()) <= 1e-6 * largest, name
            continue
        tol = (fnet_tol if trunk else grad_tol) * np.abs(g_want).max()
        assert np.abs(g_got - g_want).max() <= tol, name
        sure = np.abs(g_want) > 1.5 * tol
        ulp = np.spacing(np.maximum(np.abs(w_new), np.abs(params[name])))
        assert (np.abs(d_got - d_want) <= 1e-3 * lr + ulp)[sure].all(), name


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


def flax_variables(model) -> dict:
    """A port model's tensors as a flax variables tree (the weight bridge's
    names, HWIO kernels): what `load_jax_variables` reads back, and what
    the JAX package's model takes."""
    from raft_stereo_tpu_torch.utils.checkpoints import _flax_key

    tree = {}
    for name, tensor in model.state_dict().items():
        key, is_kernel = _flax_key(model, name)
        value = tensor.numpy().copy()
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = value.transpose(2, 3, 1, 0) if is_kernel else value
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


def run_bands(fn, n: int = 2):
    """fn(scope) on each of n row bands, one thread each, over the port's
    in-process comm (`spatial.ThreadComm`); the results in band order. A
    failure in one band aborts the others' barrier and raises."""
    import threading

    from raft_stereo_tpu_torch.parallel import spatial

    comm = spatial.ThreadComm(n)
    out, errors = [None] * n, []

    def work(k):
        try:
            torch.set_num_threads(1)
            out[k] = fn(spatial.BandScope(comm.bound(k), k, n))
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            comm.abort()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def free_port() -> int:
    """A TCP port free on localhost (for a process group's store)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank of a one-host job on the CPU,
    with the repository on the import path and one thread per rank."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                PYTHONPATH=repo)
