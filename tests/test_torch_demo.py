"""The port's validators and demo against the JAX package's, on trees the
tests write, and the `train`, `evaluate` and `demo` command lines on the
CPU.

- The four validators read their datasets from `root` (ETH3D, KITTI,
  FlyingThings TEST and Middlebury trees at 48x64) and return JAX's metrics
  within 1e-4 relative over 3 iterations, from the same weights (a seeded
  port model, conv kernels halved, carried to JAX through the reference's
  state dict); an empty root reads as it does in JAX.
- `run_demo` on a GatedStereo RGB tree: the same frames, the disparity
  behind each depth map within 1e-4 px and relative of the JAX demo's,
  the MAE within 1e-4 relative; `collect_frames`,
  `lidar_mae` and `depth_from_disparity` equal JAX's.
- `python -m raft_stereo_tpu_torch train` (in process, --device cpu) on a
  SceneFlow tree with in-training validation, then `evaluate` and `demo`
  on the model.pth it wrote.
- The entry points default to the card and never fall back to the CPU:
  without --device on a machine with no card, `train` exits 1 with a run
  report naming the failure.
"""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from raft_stereo_tpu import demo as jax_demo
from raft_stereo_tpu import evaluate as jeval
from raft_stereo_tpu.config import CameraConfig as JaxCameraConfig
from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.utils.checkpoints import convert_state_dict as jax_convert_state_dict
from raft_stereo_tpu_torch import cli, demo, evaluate
from raft_stereo_tpu_torch.config import CameraConfig, RAFTStereoConfig
from raft_stereo_tpu_torch.data import frame_io, png, trees
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.utils.checkpoints import export_reference_state_dict, validate_checkpoint
from raft_stereo_tpu_torch.utils.run_report import validate_run_report
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

H, W, ITERS = 48, 64, 3
MODEL = dict(hidden_dims=(16, 16, 16), corr_levels=2, corr_radius=2)
TINY = ["--hidden_dims", "16", "16", "16", "--corr_levels", "2", "--corr_radius", "2"]
DAY = "2024-05-06_12-00-00"


@pytest.fixture(scope="module")
def models():
    """(port model, JAX config, JAX variables): one seeded port model with
    its conv kernels halved (mild weights: the untrained GRU amplifies
    rounding), carried to JAX through the reference's state dict."""
    model = build_model(RAFTStereoConfig(**MODEL), seed=0, device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
    sd = {k: v.numpy() for k, v in export_reference_state_dict(model).items()}
    jcfg = JaxConfig(encoder_s2d=False, **MODEL)
    variables = jax.tree.map(np.asarray, jax_convert_state_dict(sd, jcfg))
    return model.eval(), jcfg, variables


def _write_eth3d(root, rng, n=2):
    for i in range(n):
        left, right, disp = trees.plane_pair(rng, H, W, 8.0)
        scene = f"scene_{i}"
        for sub in ("two_view_training", "two_view_training_gt"):
            os.makedirs(os.path.join(root, sub, scene), exist_ok=True)
        png.write_png(os.path.join(root, "two_view_training", scene, "im0.png"), left)
        png.write_png(os.path.join(root, "two_view_training", scene, "im1.png"), right)
        frame_io.write_pfm(os.path.join(root, "two_view_training_gt", scene, "disp0GT.pfm"), disp)
        png.write_png(os.path.join(root, "two_view_training_gt", scene, "mask0nocc.png"),
                           ((rng.uniform(0, 1, (H, W)) > 0.2) * 255).astype(np.uint8))


def _write_middlebury(root, rng, n=2):
    names = [f"Scene{i}" for i in range(n)]
    os.makedirs(os.path.join(root, "MiddEval3"), exist_ok=True)
    with open(os.path.join(root, "MiddEval3", "official_train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for name in names:
        d = os.path.join(root, "MiddEval3", "trainingF", name)
        os.makedirs(d, exist_ok=True)
        left, right, disp = trees.plane_pair(rng, H, W, 8.0)
        png.write_png(os.path.join(d, "im0.png"), left)
        png.write_png(os.path.join(d, "im1.png"), right)
        frame_io.write_pfm(os.path.join(d, "disp0GT.pfm"), disp)
        png.write_png(os.path.join(d, "mask0nocc.png"), np.full((H, W), 255, np.uint8))


@pytest.fixture(scope="module")
def datasets_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval") / "datasets"
    rng = np.random.default_rng(9)
    trees.write_sceneflow(str(root), rng, 0, 2, h=H, w=W, max_disp=8.0)
    trees.write_kitti(str(root / "KITTI"), rng, 2, h=H, w=W, max_disp=8.0)
    _write_eth3d(str(root / "ETH3D"), rng)
    _write_middlebury(str(root / "Middlebury"), rng)
    return root


def test_validators_match_jax(models, datasets_root, tmp_path):
    model, jcfg, variables = models
    jev = jeval.Evaluator(jcfg, variables, iters=ITERS)
    tev = evaluate.Evaluator(model, iters=ITERS)
    for name in ("eth3d", "kitti", "things", "middlebury_F"):
        root = str(datasets_root / cli._DATASET_SUBDIR[name])
        want = jeval.VALIDATORS[name](jev, root=root)
        got = evaluate.VALIDATORS[name](tev, root=root)
        assert got.keys() == want.keys() and want, name
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=f"{name} {k}")
        print(name, got)
    # An empty root reads as in JAX: NaN metrics, or the same error.
    empty = tmp_path / "empty"
    empty.mkdir()
    for name in ("eth3d", "kitti", "things", "middlebury_F"):
        outcome = []
        for validators, ev in ((jeval.VALIDATORS, jev), (evaluate.VALIDATORS, tev)):
            try:
                outcome.append({k: bool(np.isnan(v)) for k, v in validators[name](ev, root=str(empty)).items()})
            except Exception as e:  # noqa: BLE001 - the exception type is what is compared
                outcome.append(type(e).__name__)
        assert outcome[0] == outcome[1], (name, outcome)


def test_run_demo_matches_jax(models, tmp_path, capsys):
    model, jcfg, variables = models
    root = str(tmp_path / "gated")
    trees.write_gated(root, np.random.default_rng(3), [DAY], 2, h=H, w=W, max_disp=16.0, min_disp=8.0)
    index = os.path.join(root, "test_gatedstereo.txt")
    assert demo.collect_frames(root, index, "RGB") == jax_demo.collect_frames(root, index, "RGB")
    outs = {}
    for side, run in (("jax", lambda a: jax_demo.run_demo(a, jcfg, variables)), ("port", lambda a: demo.run_demo(a, model))):
        args = argparse.Namespace(restore_ckpt="model-under-test.pth", root_dataset=root, indexes_file=None,
                                  output_path=str(tmp_path / side), valid_iters=ITERS, save_numpy=True, device="cpu")
        capsys.readouterr()
        assert run(args) == 0
        mae = float(capsys.readouterr().out.split("AVG MAE:")[1])
        npy = os.path.join(str(tmp_path / side), DAY, "cam_stereo", "left", "model-under-test", "npy")
        outs[side] = (mae, {f: np.load(os.path.join(npy, f)) for f in sorted(os.listdir(npy))})
    assert outs["port"][1].keys() == outs["jax"][1].keys() and len(outs["port"][1]) == 2
    # Depth is f*B over the predicted disparity; compare that disparity (a
    # near-zero disparity makes a depth's relative error large).
    fb = CameraConfig().focal_px * CameraConfig().baseline_m
    for f, want in outs["jax"][1].items():
        np.testing.assert_allclose(fb / outs["port"][1][f], fb / want, rtol=1e-4, atol=1e-4, err_msg=f)
    np.testing.assert_allclose(outs["port"][0], outs["jax"][0], rtol=1e-4)
    vis = os.path.join(str(tmp_path / "port"), DAY, "cam_stereo", "left", "model-under-test", "visualization")
    assert frame_io.read_image(os.path.join(vis, "00000_rect.png")).shape == (H, W, 3)
    # The depth conversion and the lidar band.
    disp = np.random.default_rng(1).uniform(1, 20, (6, 7)).astype(np.float32)
    gt = np.random.default_rng(2).uniform(0, 300, (6, 7)).astype(np.float32)
    np.testing.assert_array_equal(demo.depth_from_disparity(disp, CameraConfig()),
                                  jax_demo.depth_from_disparity(disp, JaxCameraConfig()))
    assert demo.lidar_mae(disp, gt, CameraConfig()) == jax_demo.lidar_mae(disp, gt, JaxCameraConfig())


def test_train_evaluate_demo_cli_on_cpu(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(4)
    trees.write_sceneflow(str(tmp_path / "datasets"), rng, 4, 2, h=60, w=88, max_disp=8.0)
    trees.write_gated(str(tmp_path / "gated"), rng, ["2024-05-06_12-00-00"], 1, h=64, w=96, max_disp=16.0,
                      min_disp=8.0)
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--device", "cpu", *TINY, "--batch_size", "2", "--image_size", "48", "64",
            "--train_iters", "2", "--num_steps", "2", "--root_dataset", "datasets", "--num_workers", "1",
            "--spatial_scale", "-0.2", "0.4", "--saturation_range", "0", "1.4", "--valid_datasets", "things",
            "--validate_every", "2", "--valid_iters", "2", "--name", "cli"]
    assert cli.main(argv) == 0
    report = json.load(open(tmp_path / "runs" / "run_report.json"))
    assert validate_run_report(report) == [] and report["final_step"] == 2 and report["last_good_step"] == 2
    step_dir = tmp_path / "checkpoints" / "cli" / "2"
    assert validate_checkpoint(str(step_dir)) == []
    metrics = [json.loads(line) for line in open(tmp_path / "runs" / "metrics.jsonl")]
    assert any("things-epe" in m for m in metrics)
    capsys.readouterr()
    model = str(step_dir / "model.pth")
    assert cli.main(["evaluate", "--dataset", "things", "--device", "cpu", "--restore_ckpt", model,
                     "--root_dataset", "datasets", "--valid_iters", "2", *TINY]) == 0
    out = capsys.readouterr().out
    assert "Validation FlyingThings:" in out
    assert cli.main(["demo", "--device", "cpu", "--restore_ckpt", model, "--root_dataset", "gated",
                     "--valid_iters", "2", "--save_numpy", *TINY]) == 0
    mae = float(capsys.readouterr().out.split("AVG MAE:")[1])
    assert np.isfinite(mae)
    depth = np.load(tmp_path / "gated" / "2024-05-06_12-00-00" / "cam_stereo" / "left" / "model" / "npy"
                    / "00000_rect.npy")
    assert depth.shape == (64, 96) and np.isfinite(depth).all()


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """`train` and `demo` default to --device cuda; on a machine without a
    card neither moves to the CPU."""
    import argparse

    import torch

    from raft_stereo_tpu_torch import demo

    assert cli._train_parser().parse_args([]).device == "cuda"
    p = argparse.ArgumentParser()
    demo.add_demo_args(p)
    assert p.parse_args(["--restore_ckpt", "x", "--root_dataset", "y"]).device == "cuda"
    if torch.cuda.is_available():
        return  # with a card the default runs there; the refusal below is a CPU-only machine's
    trees.write_sceneflow(str(tmp_path / "datasets"), np.random.default_rng(0), 2, 0, h=60, w=88, max_disp=8.0)
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", *TINY, "--batch_size", "2", "--image_size", "48", "64", "--root_dataset",
                     "datasets", "--num_steps", "1", "--num_workers", "1"]) == 1
    report = json.load(open(tmp_path / "runs" / "run_report.json"))
    assert report["stop_cause"] == "error" and "CUDA" in report["error"]
    assert not os.path.exists(tmp_path / "checkpoints")
