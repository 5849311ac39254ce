"""Gated-stereo inference demo: depth maps and lidar MAE. The port's
counterpart of the JAX package's `raft_stereo_tpu/demo.py` (the fork's
rewritten demo.py).

Walks the GatedStereo tree through a (date, frame) index file for any of
the three modalities, runs the test-mode forward on the card, converts
disparity to metric depth with the rig intrinsics, reports the MAE against
projected VLS-128 lidar in the 3-200 m band, and writes a jet-coloured depth
PNG (the port's PNG writer; the JAX demo uses matplotlib) and, with
`--save_numpy`, the depth `.npy` into `<output>/<day>/.../<model_name>/`.
"""

from __future__ import annotations

import argparse
import glob as globlib
import logging
import os
from typing import List

import numpy as np

from raft_stereo_tpu_torch.config import (
    CameraConfig,
    MODALITY_ALL_GATED,
    MODALITY_PASSIVE_GATED,
    MODALITY_RGB,
)

logger = logging.getLogger(__name__)

GATED_TYPES = ("type6", "type7", "type8", "type9", "type10")


def depth_from_disparity(disp: np.ndarray, camera: CameraConfig) -> np.ndarray:
    return camera.focal_px * camera.baseline_m / (disp + 1e-9)


def lidar_mae(disp: np.ndarray, gt_depth: np.ndarray, camera: CameraConfig) -> float:
    """MAE of predicted depth vs lidar inside the valid band (reference
    demo.py:20-31)."""
    depth = depth_from_disparity(disp, camera)
    valid = (gt_depth > camera.min_depth_m) & (gt_depth < camera.max_depth_m)
    return float(np.abs(depth - gt_depth)[valid].sum() / valid.sum())


def collect_frames(root: str, indexes_file: str, data_modality: str):
    """(left, right, lidar, day) tuples for every indexed frame present on
    disk (reference demo.py:53-111)."""
    with open(indexes_file) as f:
        pairs = [line.rstrip().split(",") for line in f if line.strip()]

    frames = []
    for day, ind in pairs:
        if data_modality == MODALITY_RGB:
            left = sorted(globlib.glob(os.path.join(root, day, "cam_stereo/left/image_rect", ind + "*.png")))
            right = sorted(globlib.glob(os.path.join(root, day, "cam_stereo/right/image_rect", ind + "*.png")))
            gt = sorted(globlib.glob(os.path.join(root, day, "cam_stereo/left/lidar_vls128_projected", ind + "*.npz")))
            if len(left) == len(right) == len(gt) == 1:
                frames.append((left[0], right[0], gt[0], day))
        elif data_modality == MODALITY_PASSIVE_GATED:
            left = sorted(globlib.glob(os.path.join(root, day, "framegrabber/left/bwv/type7/image_rect8", ind + "*.png")))
            right = sorted(globlib.glob(os.path.join(root, day, "framegrabber/right/bwv/type7/image_rect8", ind + "*.png")))
            gt = sorted(globlib.glob(os.path.join(root, day, "framegrabber/left/lidar_vls128_projected", ind + "*.npz")))
            if len(left) == len(right) == len(gt) == 1:
                frames.append((left[0], right[0], gt[0], day))
        elif data_modality == MODALITY_ALL_GATED:
            gt = sorted(globlib.glob(os.path.join(root, day, "framegrabber/left/lidar_vls128_projected", ind + "*.npz")))
            if len(gt) != 1:
                continue
            lefts, rights = [], []
            for t in GATED_TYPES:
                l = sorted(globlib.glob(os.path.join(root, day, f"framegrabber/left/bwv/{t}/image_rect8", ind + "*.png")))
                r = sorted(globlib.glob(os.path.join(root, day, f"framegrabber/right/bwv/{t}/image_rect8", ind + "*.png")))
                if len(l) != 1 or len(r) != 1:
                    break
                lefts.append(l[0])
                rights.append(r[0])
            else:
                frames.append((lefts, rights, gt[0], day))
    return frames


def _load_pair(left, right, data_modality: str):
    from raft_stereo_tpu_torch.data import frame_io

    if data_modality == MODALITY_ALL_GATED:
        img1 = np.stack([frame_io.read_image(p) for p in left], axis=-1).astype(np.float32)[8:-8]
        img2 = np.stack([frame_io.read_image(p) for p in right], axis=-1).astype(np.float32)[8:-8]
    elif data_modality == MODALITY_PASSIVE_GATED:
        img1 = np.stack([frame_io.read_image(left)] * 3, axis=-1).astype(np.float32)[8:-8]
        img2 = np.stack([frame_io.read_image(right)] * 3, axis=-1).astype(np.float32)[8:-8]
    else:
        img1 = np.asarray(frame_io.read_image(left), np.float32)[..., :3]
        img2 = np.asarray(frame_io.read_image(right), np.float32)[..., :3]
    return img1, img2


# matplotlib's "jet" colormap: (position, value) breakpoints per channel.
_JET = {
    "red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
    "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
}


def jet_image(values: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 jet colours over their min..max, as
    matplotlib's imsave maps them (a 256-entry table)."""
    lo, hi = float(np.min(values)), float(np.max(values))
    norm = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
    idx = np.clip((norm * 256).astype(np.int64), 0, 255)
    grid = np.linspace(0.0, 1.0, 256)
    lut = np.stack([np.interp(grid, *zip(*_JET[c])) for c in ("red", "green", "blue")], axis=-1)
    return (lut[idx] * 255 + 0.5).astype(np.uint8)


def _save_outputs(out_root, day, data_modality, model_name, src_name, depth, save_numpy):
    from raft_stereo_tpu_torch.data import png

    subtree = "cam_stereo" if data_modality == MODALITY_RGB else "framegrabber"
    base = os.path.join(out_root, day, subtree, "left", model_name)
    os.makedirs(os.path.join(base, "visualization"), exist_ok=True)
    os.makedirs(os.path.join(base, "npy"), exist_ok=True)
    stem = os.path.splitext(os.path.basename(src_name))[0]
    vis_path = os.path.join(base, "visualization", stem + ".png")
    if save_numpy:
        np.save(os.path.join(base, "npy", stem + ".npy"), depth)
    png.write_png(vis_path, jet_image(depth))
    return vis_path


def add_demo_args(p: argparse.ArgumentParser):
    p.add_argument("--restore_ckpt", required=True)
    p.add_argument("--root_dataset", required=True, help="GatedStereo dataset root")
    p.add_argument("--indexes_file", default=None, help="test (date,frame) index; default <root>/test_gatedstereo.txt")
    p.add_argument("--output_path", default=None, help="output tree root; default = dataset root")
    p.add_argument("--valid_iters", type=int, default=32)
    p.add_argument("--save_numpy", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device of the model (default: the card)")


def run_demo(args, model, camera: CameraConfig = CameraConfig()) -> int:
    """Run the demo over `args` (add_demo_args) with `model`, a port
    RAFTStereo on its device; prints the average lidar MAE."""
    from raft_stereo_tpu_torch.evaluate import Evaluator

    data_modality = model.config.data_modality
    indexes_file = args.indexes_file or os.path.join(args.root_dataset, "test_gatedstereo.txt")
    out_root = args.output_path or args.root_dataset.rstrip("/")
    model_name = os.path.basename(os.path.normpath(args.restore_ckpt)).replace(".pth", "")

    frames = collect_frames(args.root_dataset, indexes_file, data_modality)
    logger.info("demo: %d frames for modality %r", len(frames), data_modality)
    evaluator = Evaluator(model, iters=args.valid_iters)

    maes: List[float] = []
    for left, right, gt_path, day in frames:
        depth_gt = np.load(gt_path)["arr_0"]
        if data_modality != MODALITY_RGB:
            depth_gt = depth_gt[8:-8]
        img1, img2 = _load_pair(left, right, data_modality)
        flow, _ = evaluator(img1, img2)
        disp = np.abs(flow)
        maes.append(lidar_mae(disp, depth_gt, camera))
        depth = depth_from_disparity(disp, camera)
        src = left[0] if isinstance(left, list) else left
        path = _save_outputs(out_root, day, data_modality, model_name, src, depth, args.save_numpy)
        logger.info("%s MAE %.3f m -> %s", os.path.basename(src), maes[-1], path)

    if maes:
        print("AVG MAE:", sum(maes) / len(maes))
    return 0
