"""The PyTorch port's evaluate entry point and its two test-mode levers
against the JAX package.

Shared (perturbed, kernel-halved — see tests/test_torch_model.py) weights,
48x64 images, 3 iterations; JAX under "highest" matmul precision, its
Pallas kernels in interpret mode. On CPU tensors the port's wrappers run
their plain versions.

- The evaluate configuration (`pallas` + `fused_gru_tail` +
  `prefetch_lookup`) and the gates configuration (`pallas` +
  `prefetch_lookup`, `RAFT_STEREO_TPU_PALLAS_GATES=1`) against the JAX model
  with `prefetch_lookup=True`: rtol = atol = 1e-4.
- The levers change no bit of a test-mode forward, and a training step
  with them set (and the gates' variable on) gives the very same gradients.
- `Evaluator` + `validate_eth3d` and `validate_middlebury` on
  `SyntheticEvalDataset()` (90x158: padding and cropping run) against the
  JAX ones, 2 iterations, with and without `pad_bucket`: metrics within
  1e-4 relative.
- `python -m raft_stereo_tpu_torch evaluate --dry_run` on the CPU, the
  flags the port does not have, and the ones that raised before their
  slice, which now run.
- `--restore_ckpt`: the port's `convert_state_dict` against the JAX one on a
  reference-keyed state dict, and a `.pth` restored into a model whose
  forward matches the JAX model's.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_stereo_tpu import evaluate as jeval
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.utils.checkpoints import convert_state_dict as jax_convert_state_dict
from raft_stereo_tpu_torch import cli, evaluate
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops import corr_cuda, gates, gru_tail
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.utils.checkpoints import (
    convert_state_dict,
    load_jax_variables,
    load_reference_checkpoint,
)
from torch_parity import (  # noqa: F401 (autouse fixture)
    flat_leaves,
    halve_kernels,
    jax_apply,
    jax_init,
    reference_state_dict,
    torch_single_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, ITERS = 48, 64, 3
HID = (32, 32, 32)
PALLAS = {"corr_implementation": "pallas"}
EVAL = dict(PALLAS, fused_gru_tail=True, prefetch_lookup=True)
GATES = dict(PALLAS, fused_gru_tail=False, prefetch_lookup=True)
CONFIGS = {"evaluate": (EVAL, False), "gates": (GATES, True)}  # flags, gates variable on


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


@pytest.fixture(scope="module")
def jax_forward(weights, images):
    """The JAX model with `prefetch_lookup` (its windowed kernel, interpret
    mode) and the fused tails: (flow_lowres, flow_up)."""
    return jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **EVAL)), weights, *images, iters=ITERS,
                     test_mode=True)


def port_model(weights, **flags):
    return load_jax_variables(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **flags)), weights).eval()


def port_forward(model, images, iters=ITERS):
    with torch.inference_mode():
        return model(*map(torch.from_numpy, images), iters=iters, test_mode=True)


def counts():
    return {**corr_cuda.LAUNCHES, **gru_tail.LAUNCHES, **gates.LAUNCHES}


def set_gates(monkeypatch, on):
    if on:
        monkeypatch.setenv(gates.ENV_VAR, "1")
    else:
        monkeypatch.delenv(gates.ENV_VAR, raising=False)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_with_levers_matches_jax(weights, images, jax_forward, monkeypatch, config):
    flags, gates_on = CONFIGS[config]
    set_gates(monkeypatch, gates_on)
    if config == "gates":
        # JAX's fused tail takes precedence over the gates, so the gates
        # configuration has it off; the JAX model takes the plain gates off
        # the TPU, which compute the same function.
        want_lo, want_up = jax_apply(JaxRAFTStereo(JaxConfig(hidden_dims=HID, **GATES)), weights, *images,
                                     iters=ITERS, test_mode=True)
    else:
        want_lo, want_up = jax_forward
    before = counts()
    got_lo, got_up = port_forward(port_model(weights, **flags), images)
    assert counts() == before  # CPU tensors: no kernel launched
    assert np.abs(want_up).max() > 1.0  # the flows moved: the comparison has teeth
    np.testing.assert_allclose(got_lo.numpy(), want_lo, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), want_up, rtol=1e-4, atol=1e-4)


def test_levers_are_numerically_invisible(weights, images, monkeypatch):
    """The port's analog of tests/test_fast_path.py
    `test_model_levers_are_numerically_invisible`: on the CPU the windowed
    lookup, the fused tails and the gates are their plain versions, so each
    configuration's test-mode output equals the lever-free one, bit for bit."""
    set_gates(monkeypatch, False)
    base = port_forward(port_model(weights, **PALLAS), images)
    for flags, gates_on in (*CONFIGS.values(), (dict(PALLAS, prefetch_lookup=True), False)):
        set_gates(monkeypatch, gates_on)
        got = port_forward(port_model(weights, **flags), images)
        for a, b in zip(got, base):
            assert torch.equal(a, b), (flags, gates_on)


def test_training_gradients_unchanged_by_levers(weights, images, monkeypatch):
    """The port's analog of tests/test_fast_path.py
    `test_training_gradients_bit_identical_with_levers_on`: the windowed
    lookup and the gates act only in test mode, so a training forward and
    backward with `prefetch_lookup` set and the gates' variable on is the
    one without them, bit for bit."""
    rng = np.random.default_rng(11)
    flow = torch.from_numpy(-rng.uniform(0, 8, (1, H, W, 1)).astype(np.float32))
    valid = torch.ones((1, H, W))
    outs = []
    for flags, gates_on in ((PALLAS, False), (GATES, True)):
        set_gates(monkeypatch, gates_on)
        model = port_model(weights, **flags)
        flows = model(*map(torch.from_numpy, images), iters=2)
        loss, _ = sequence_loss(flows, flow, valid)
        loss.backward()
        outs.append((flows.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pad_bucket", [0, 64])
def test_evaluate_matches_jax(weights, pad_bucket):
    jev = jeval.Evaluator(JaxConfig(hidden_dims=HID, **EVAL), weights, iters=2, pad_bucket=pad_bucket)
    tev = evaluate.Evaluator(port_model(weights, **EVAL), iters=2, pad_bucket=pad_bucket)
    for name in ("eth3d", "middlebury_F"):
        want = jeval.VALIDATORS[name](jev, dataset=jeval.SyntheticEvalDataset())
        got = evaluate.VALIDATORS[name](tev, dataset=evaluate.SyntheticEvalDataset())
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0, err_msg=k)
    flow, seconds = tev(*(evaluate.SyntheticEvalDataset().get_item(0, None)[k] for k in ("image1", "image2")))
    assert flow.shape == (90, 158) and seconds > 0


def test_validation_fn_and_missing_dataset(weights):
    model = port_model(weights, **EVAL)
    validate = evaluate.make_validation_fn(
        model.config, ["eth3d"], iters=1,
        validator_kwargs={"eth3d": {"dataset": evaluate.SyntheticEvalDataset(n=1)}},
    )
    beats = []
    validate.set_heartbeat(lambda: beats.append(1))
    metrics = validate(model)
    assert set(metrics) == {"eth3d-epe", "eth3d-d1"} and beats == [1]
    with pytest.raises(ValueError, match="not the validation config"):
        validate(port_model(weights, **PALLAS))
    # Without a dataset object a validator reads its reader's tree under
    # `root` (data/datasets.py): an empty root holds no pair.
    ev = evaluate.Evaluator(model, iters=1)
    for name in evaluate.VALIDATORS:
        with pytest.warns(RuntimeWarning) if name == "eth3d" else pytest.raises((ValueError, FileNotFoundError)):
            result = evaluate.VALIDATORS[name](ev, root=os.path.join(REPO, "tests", "no-such-dataset"))
            assert all(np.isnan(v) for v in result.values())


def test_cli_dry_run_on_cpu():
    cmd = [sys.executable, "-m", "raft_stereo_tpu_torch", "evaluate", "--dataset", "eth3d", "--dry_run",
           "--valid_iters", "2", "--device", "cpu", "--prefetch_lookup", "--corr_implementation", "reg_cuda"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "The model has 11.11M learnable parameters." in out.stdout
    assert "Validation ETH3D: EPE" in out.stdout


@pytest.mark.parametrize("flags", [["--corr_implementation", "alt"], ["--corr_implementation", "alt_cuda"]])
def test_cli_unported_flags_raise(flags, capsys):
    """`alt` and `alt_cuda` raised "not ported yet" before their slice; now
    both map to the port's "alt" strategy and run the dry-run evaluate
    path to its validation line."""
    assert cli._model_config(cli._train_parser().parse_args(flags)).corr_implementation == "alt"
    argv = ["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", "--valid_iters", "2",
            "--hidden_dims", "16", "16", "16", *flags]
    assert cli.main(argv) == 0
    assert "Validation ETH3D: EPE" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--mixed_precision", "--fused_gru_tail"],
                                   ["--corr_dtype", "bfloat16", "--corr_implementation", "reg_cuda",
                                    "--prefetch_lookup"],
                                   ["--shared_backbone", "--n_downsample", "3", "--n_gru_layers", "2",
                                    "--slow_fast_gru"]],
                         ids=["mixed+fused_gru_tail", "bf16+prefetch_lookup", "shared_backbone"])
def test_cli_formerly_unported_flags_run(flags, capsys):
    """The three combinations that raised "not ported yet" before their
    slice (the bf16 levers and the shared backbone) run the dry-run evaluate
    path on the CPU to its validation line. (The windowed lookup is
    "pallas" only, so its case names reg_cuda, which the refusal did not
    need.)"""
    argv = ["evaluate", "--dataset", "eth3d", "--dry_run", "--device", "cpu", "--valid_iters", "2", *flags]
    assert cli.main(argv) == 0
    assert "Validation ETH3D: EPE" in capsys.readouterr().out


@pytest.mark.parametrize("command", ["train", "demo", "serve", "frontier", "bogus"])
def test_cli_other_subcommands_exit_2(command, capsys):
    """Every subcommand is ported; each exits 2 on what it cannot run: a
    mesh that does not fit the world (train's 1x2 in one process), a fleet larger than the
    visible cards (serve's `--replicas` with no card here), a usage error
    (demo without its required paths, frontier without backends), or an
    unknown subcommand."""
    argv = {"serve": ["serve", "--replicas", "2"], "train": ["train", "--mesh_shape", "1", "2"],
            "demo": ["demo"]}.get(command, [command])
    try:
        code = cli.main(argv)
    except SystemExit as e:  # argparse's usage error
        code = e.code
    assert code == 2
    err = capsys.readouterr().err
    want = {"demo": "the following arguments are required: --restore_ckpt, --root_dataset",
            "frontier": "--backends is required (except with --rollout)",
            "serve": "--replicas 2 exceeds the 0 visible card(s)",
            "train": "mesh 1x2 covers 2 rank(s) but the world has 1",
            "bogus": "usage: python -m raft_stereo_tpu_torch"}[command]
    assert want in err


def test_convert_state_dict_matches_jax(weights):
    jcfg = JaxConfig(hidden_dims=HID)
    sd = reference_state_dict(weights, jcfg, np.random.default_rng(3))
    assert sd["update_block.encoder.convf1.weight"].shape == (64, 2, 7, 7)
    assert sd["update_block.flow_head.conv2.weight"].shape[0] == 2
    want = flat_leaves(jax_convert_state_dict(sd, jcfg))
    # The inverse is right: the JAX converter gives back the variables.
    assert want.keys() == flat_leaves(weights).keys()
    for path, leaf in flat_leaves(weights).items():
        np.testing.assert_array_equal(want[path], leaf, err_msg=str(path))
    got = flat_leaves(convert_state_dict(sd, RAFTStereoConfig(hidden_dims=HID, **EVAL)))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_reference_pth_restores(weights, images, jax_forward, tmp_path):
    sd = reference_state_dict(weights, JaxConfig(hidden_dims=HID), np.random.default_rng(3))
    path = tmp_path / "raftstereo.pth"
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, path)
    model = load_reference_checkpoint(RAFTStereo(RAFTStereoConfig(hidden_dims=HID, **EVAL)), str(path)).eval()
    got_lo, got_up = port_forward(model, images)
    np.testing.assert_allclose(got_lo.numpy(), jax_forward[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_up.numpy(), jax_forward[1], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="orbax"):
        load_reference_checkpoint(model, str(tmp_path))
