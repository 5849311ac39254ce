"""Synthetic dataset trees in the reference's on-disk layouts, made from a
seed: the inputs of the `train`, `evaluate` and `demo` command lines where
no downloaded data exists (the card's smoke test, the CPU tests).

Every pair is a smooth random texture (datasets.py `_sequence_texture`)
under a tilted disparity plane: image1 is the texture, image2 the texture
sampled at x + d (linear interpolation), as in the port's
`train/synthetic.py`. Images are written as PNGs through the port's codec,
disparity as PFM (SceneFlow), 16-bit PNG (KITTI) or projected-lidar npz
depth (GatedStereo). numpy only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch.config import CameraConfig
from raft_stereo_tpu_torch.data import frame_io, png
from raft_stereo_tpu_torch.data.datasets import GATED_SLICE_TYPES, _sequence_texture


def plane_pair(rng: np.random.Generator, h: int, w: int, max_disp: float,
               min_disp: float = 1.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image1, image2) uint8 (h, w, 3) and the float32 disparity (h, w),
    the plane's offset drawn from [min_disp, max_disp - 1]."""
    margin = int(np.ceil(max_disp)) + 1
    base = _sequence_texture(rng, h, w + margin)
    a = rng.uniform(min_disp, max_disp - 1.0)
    bx = rng.uniform(-2.0, 2.0) / max(w, 1)
    cy = rng.uniform(-2.0, 2.0) / max(h, 1)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    disp = np.clip(a + bx * xs + cy * ys, 0.5, max_disp).astype(np.float32)
    coords = xs + disp
    x0 = np.floor(coords).astype(int)
    fx = (coords - x0)[..., None]
    x0 = np.clip(x0, 0, base.shape[1] - 2)
    rows = np.arange(h)[:, None]
    image2 = base[rows, x0] * (1 - fx) + base[rows, x0 + 1] * fx
    to_u8 = lambda x: np.clip(np.rint(x), 0, 255).astype(np.uint8)  # noqa: E731
    return to_u8(base[:, :w]), to_u8(image2), disp


def write_sceneflow(root: str, rng: np.random.Generator, n_train: int, n_test: int, h: int = 540, w: int = 960,
                    max_disp: float = 48.0) -> Dict[str, int]:
    """FlyingThings3D's layout under `root` (the --root_dataset parent):
    FlyingThings3D/{frames_cleanpass,frames_finalpass}/{TRAIN,TEST}/A/<seq>/
    {left,right}/NNNN.png and disparity/{TRAIN,TEST}/A/<seq>/left/NNNN.pfm.
    Both passes hold the same pair; returns the pair counts."""
    for split, n in (("TRAIN", n_train), ("TEST", n_test)):
        for i in range(n):
            seq = f"{i // 4:04d}"
            stem = f"{6 + i % 4:04d}"
            left, right, disp = plane_pair(rng, h, w, max_disp)
            for dstype in ("frames_cleanpass", "frames_finalpass"):
                for side, img in (("left", left), ("right", right)):
                    d = os.path.join(root, "FlyingThings3D", dstype, split, "A", seq, side)
                    os.makedirs(d, exist_ok=True)
                    png.write_png(os.path.join(d, stem + ".png"), img)
            d = os.path.join(root, "FlyingThings3D", "disparity", split, "A", seq, "left")
            os.makedirs(d, exist_ok=True)
            frame_io.write_pfm(os.path.join(d, stem + ".pfm"), disp)
    return {"TRAIN": n_train, "TEST": n_test}


def write_kitti(root: str, rng: np.random.Generator, n: int, h: int = 96, w: int = 160,
                max_disp: float = 16.0) -> None:
    """KITTI 2015's layout under `root` (datasets/KITTI): training/
    {image_2,image_3}/NNNNNN_10.png and training/disp_occ_0/NNNNNN_10.png
    (uint16 disparity * 256, zero where invalid: every seventh row)."""
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    for i in range(n):
        left, right, disp = plane_pair(rng, h, w, max_disp)
        enc = np.rint(disp * 256).astype(np.uint16)
        enc[::7] = 0
        name = f"{i:06d}_10.png"
        png.write_png(os.path.join(root, "training", "image_2", name), left)
        png.write_png(os.path.join(root, "training", "image_3", name), right)
        png.write_png(os.path.join(root, "training", "disp_occ_0", name), enc)


def _lidar_depth(disp: np.ndarray, camera: CameraConfig, rng: np.random.Generator) -> np.ndarray:
    """Projected lidar: depth f*B/d on a sparse set of pixels (one in four
    rows, one in two columns, 80% of those), zero elsewhere."""
    depth = np.zeros_like(disp)
    mask = np.zeros(disp.shape, bool)
    mask[::4, ::2] = True
    mask &= rng.uniform(0, 1, disp.shape) < 0.8
    depth[mask] = camera.focal_px * camera.baseline_m / disp[mask]
    return depth.astype(np.float32)


def write_gated(root: str, rng: np.random.Generator, days: Sequence[str], frames_per_day: int,
                modalities: Sequence[str] = ("RGB",), h: int = 720, w: int = 1280, max_disp: float = 32.0,
                min_disp: float = 6.0, camera: CameraConfig = CameraConfig(), index_name: str = "test_gatedstereo.txt") -> List[str]:
    """The GatedStereo layout under `root`: <day>/cam_stereo/{left,right}/
    image_rect/<ind>_rect.png with <day>/cam_stereo/left/
    lidar_vls128_projected/<ind>_rect.npz for the RGB modality, and
    <day>/framegrabber/{left,right}/bwv/type{6..10}/image_rect8/<ind>_rect.png
    with <day>/framegrabber/left/lidar_vls128_projected/<ind>_rect.npz for
    the gated ones ("gated" in
    `modalities`). `days` are 'YYYY-MM-DD_HH-MM-SS'. The planes start at
    `min_disp`, so most lidar depths fall in the demo's 3-200 m band.
    Writes the (day, ind) index `index_name` and returns its lines."""
    lines = []
    for day in days:
        for i in range(frames_per_day):
            ind = f"{i:05d}"
            stem = f"{ind}_rect"  # the rig names frames <index>_<suffix>
            left, right, disp = plane_pair(rng, h, w, max_disp, min_disp)
            depth = _lidar_depth(disp, camera, rng)
            if "RGB" in modalities:
                for side, img in (("left", left), ("right", right)):
                    d = os.path.join(root, day, "cam_stereo", side, "image_rect")
                    os.makedirs(d, exist_ok=True)
                    png.write_png(os.path.join(d, stem + ".png"), img)
                d = os.path.join(root, day, "cam_stereo", "left", "lidar_vls128_projected")
                os.makedirs(d, exist_ok=True)
                np.savez(os.path.join(d, stem + ".npz"), depth)
            if "gated" in modalities:
                for k, t in enumerate(GATED_SLICE_TYPES):
                    for side, img in (("left", left), ("right", right)):
                        d = os.path.join(root, day, "framegrabber", side, "bwv", t, "image_rect8")
                        os.makedirs(d, exist_ok=True)
                        png.write_png(os.path.join(d, stem + ".png"), img[..., k % 3])
                d = os.path.join(root, day, "framegrabber", "left", "lidar_vls128_projected")
                os.makedirs(d, exist_ok=True)
                np.savez(os.path.join(d, stem + ".npz"), depth)
            lines.append(f"{day},{ind}")
    with open(os.path.join(root, index_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
