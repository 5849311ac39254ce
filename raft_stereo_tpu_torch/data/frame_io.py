"""Image, disparity and flow readers and writers: the port's copy of the
JAX package's `raft_stereo_tpu/data/frame_io.py` (the reference's
core/utils/frame_utils.py), with the same readers, names and conventions.

Each reader returns a disparity array or a (disparity, valid) pair, as the
dataset layer expects. PNG decodes through the native IO core
(native_io.py) when it is built, and otherwise through the port's stdlib
codec (png.py), which also writes PNGs; PFM through the native core when
built, else numpy. Nothing here needs PIL, cv2 or matplotlib; a non-PNG
image (JPEG, PPM) is read with PIL when it is installed and raises a clear
error when it is not.
"""

from __future__ import annotations

import json
import os
import re
from typing import Tuple, Union

import numpy as np

from raft_stereo_tpu_torch.data import png

_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury `.flo` optical flow (H, W, 2) (reference frame_utils.py:14-33)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def read_pfm(path: str) -> np.ndarray:
    """PFM image, bottom-up flipped to top-down (reference frame_utils.py:35-70).
    Decodes through the native IO core when built (bit-exact with the
    numpy path below, which remains the fallback)."""
    from raft_stereo_tpu_torch.data import native_io

    if native_io.available():
        try:
            return native_io.read_pfm(path)
        except IOError:
            pass  # header variant the strict C parser rejects: fall back
    return _read_pfm_py(path)


def _read_pfm_py(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = f.readline()
        m = re.match(rb"^(\d+)\s(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM header {dims!r}")
        width, height = map(int, m.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if channels == 3 else (height, width)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path: str, array: np.ndarray) -> None:
    """Little-endian single-channel PFM (reference frame_utils.py:72-84)."""
    assert array.ndim == 2, "write_pfm expects (H, W)"
    h, w = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")
        np.flipud(array).astype("<f4").tofile(f)


def read_png(path: str) -> np.ndarray:
    """A PNG in PIL's array layout: the native decoder when built, else the
    stdlib codec (16-bit multichannel files, which the native decoder
    leaves to the fallback, always take the codec)."""
    from raft_stereo_tpu_torch.data import native_io

    if native_io.available():
        try:
            return native_io.read_png(path)
        except IOError:
            pass  # a layout the native decoder leaves to the fallback
    return png.read_png(path)


def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI disparity: uint16 PNG / 256 (reference frame_utils.py:135-138)."""
    disp = read_png(path).astype(np.float32) / 256.0
    return disp, disp > 0.0


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI flow PNG: (u, v) = (png[..., :2] - 2^15) / 64, valid = 3rd channel
    (reference frame_utils.py:118-123); every 16-bit sample kept."""
    raw = png.read_png(path, full_depth=True).astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2**15) / 64.0, valid


def write_flow_kitti(path: str, uv: np.ndarray) -> None:
    enc = (64.0 * uv + 2**15).astype(np.uint16)
    valid = np.ones((*uv.shape[:2], 1), np.uint16)
    png.write_png(path, np.concatenate([enc, valid], axis=-1))


def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Sintel packed-RGB disparity + occlusion mask sibling (reference
    frame_utils.py:141-147)."""
    a = read_png(path).astype(np.float32)
    disp = a[..., 0] * 4 + a[..., 1] / 2**6 + a[..., 2] / 2**14
    mask = read_png(path.replace("disparities", "occlusions"))
    return disp, (mask == 0) & (disp > 0)


def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """FallingThings depth PNG -> disparity via fx * 6cm baseline (reference
    frame_utils.py:150-157)."""
    a = read_png(path).astype(np.float32)
    with open(os.path.join(os.path.dirname(path), "_camera_settings.json")) as f:
        intr = json.load(f)
    fx = intr["camera_settings"][0]["intrinsic_settings"]["fx"]
    disp = (fx * 6.0 * 100) / a
    return disp, disp > 0


def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TartanAir depth npy -> disparity 80/depth (reference frame_utils.py:160-164)."""
    depth = np.load(path)
    disp = 80.0 / depth
    return disp, disp > 0


def read_disp_middlebury(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Middlebury GT PFM + nocc mask (MiddEval3) or 2014 disp0.pfm (reference
    frame_utils.py:167-179)."""
    base = os.path.basename(path)
    if base == "disp0GT.pfm":
        disp = read_pfm(path).astype(np.float32)
        nocc = read_png(path.replace("disp0GT.pfm", "mask0nocc.png")) == 255
        return disp, nocc
    disp = read_pfm(path).astype(np.float32)
    return disp, disp < 1e3


def read_disp_gated_lidar(
    path: str, focal_px: float = 2840.562197, baseline_m: float = 658.280549 / 2840.562197
) -> Tuple[np.ndarray, np.ndarray]:
    """Gated-rig projected-lidar npz depth -> disparity f*B/depth; zero depth
    is invalid (reference frame_utils.py:126-133; the intrinsics come from
    config.CameraConfig)."""
    depth = np.load(path)["arr_0"]
    with np.errstate(divide="ignore"):
        disp = focal_px * baseline_m / (depth + 1e-9)
    disp[depth == 0.0] = 0
    return disp, (disp > 0.0) & (depth > 0.0)


def read_image(path: str) -> np.ndarray:
    """Image file -> numpy (H, W, C), or (H, W) for grayscale. PNG through
    `read_png`; any other format through PIL when it is installed."""
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(f"{path}: only PNG images are read without PIL, which is not installed") from None
    return np.asarray(Image.open(path))


def read_gen(path: str) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Extension-dispatched generic reader (reference frame_utils.py:188-202)."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        arr = read_pfm(path).astype(np.float32)
        return arr if arr.ndim == 2 else arr[:, :, :-1]
    raise ValueError(f"unsupported extension {ext!r} for {path}")
