"""Host-side data augmentation (numpy, explicit RNG): the port's copy of
the JAX package's `raft_stereo_tpu/data/augment.py` (the reference's
core/utils/augmentor.py), drawing from the same `np.random.Generator` calls
in the same order, so a seeded item is the JAX item.

The JAX module calls cv2 twice; the port has no cv2 and computes both as
cv2 does:

- `resize_linear` is `cv2.resize(..., INTER_LINEAR)` on float arrays
  (images and dense flow): half-pixel sample positions, edge clamping,
  the output size rounded to nearest;
- `adjust_hue` goes through `rgb_to_hsv_u8` / `hsv_to_rgb_u8`, OpenCV's
  uint8 HSV conversions (H over [0, 180)) with its rounding rules.

Dense (`FlowAugmentor` semantics) and sparse (`SparseFlowAugmentor`)
variants share this module with a `sparse` flag; the sparse path resizes
flow by nearest-scatter of valid samples and crops with the reference's
(20, 50) margins.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

_GRAY = np.array([0.2989, 0.587, 0.114], np.float32)


def _f32c(img: np.ndarray) -> np.ndarray:
    """Owned, C-contiguous float32 copy — the buffer the in-place ops mutate."""
    return np.array(img, np.float32, order="C")


# In-place photometric primitives. Fast path: one fused C pass per op in the
# native core (native/io_core.cc); the numpy fallbacks are term-for-term the
# same math.


def _brightness_(out: np.ndarray, factor: float) -> None:
    from raft_stereo_tpu_torch.data import native_io

    if native_io.blend_scalar_(out, factor, 0.0):
        return
    out *= np.float32(factor)
    np.clip(out, 0, 255, out=out)


def _contrast_(out: np.ndarray, factor: float) -> None:
    from raft_stereo_tpu_torch.data import native_io

    mean = native_io.gray_mean(out)
    if mean is None:
        mean = float((out @ _GRAY).mean(dtype=np.float32))
    if native_io.blend_scalar_(out, factor, (1.0 - factor) * mean):
        return
    out *= np.float32(factor)
    out += np.float32((1.0 - factor) * mean)
    np.clip(out, 0, 255, out=out)


def _saturation_(out: np.ndarray, factor: float) -> None:
    from raft_stereo_tpu_torch.data import native_io

    if native_io.blend_gray_(out, factor):
        return
    gray = (out @ _GRAY)[..., None]
    out *= np.float32(factor)
    out += np.float32(1.0 - factor) * gray
    np.clip(out, 0, 255, out=out)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    out = _f32c(img)
    _brightness_(out, factor)
    return out


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    out = _f32c(img)
    _contrast_(out, factor)
    return out


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    out = _f32c(img)
    _saturation_(out, factor)
    return out


def adjust_hue(img: np.ndarray, offset: float) -> np.ndarray:
    """Shift hue by `offset` (fraction of the hue circle, torchvision range
    [-0.5, 0.5]) through OpenCV's uint8 HSV, where H runs over [0, 180)."""
    hsv = rgb_to_hsv_u8(img.astype(np.uint8))
    h = hsv[..., 0].astype(np.int32)
    hsv[..., 0] = ((h + int(round(offset * 180))) % 180).astype(hsv.dtype)
    return hsv_to_rgb_u8(hsv).astype(np.float32)


# OpenCV's uint8 RGB <-> HSV (imgproc color_hsv: RGB2HSV_b, HSV2RGB_b),
# rule for rule: fixed-point division tables with a 12-bit shift forward,
# float32 sector arithmetic backward; both equal cv2 on every uint8 triple,
# in rows of any width.
_HSV_SHIFT = 12
_HSV_VECTOR = 32
_SDIV = np.array([0] + [int(np.rint((255 << _HSV_SHIFT) / float(i))) for i in range(1, 256)], np.int64)
_HDIV180 = np.array([0] + [int(np.rint((180 << _HSV_SHIFT) / (6.0 * i))) for i in range(1, 256)], np.int64)
# (b, g, r) rows of the tab index per sector: tab = (v, p, q, t).
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV) for uint8 (..., 3) arrays."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    vr = v == r
    vg = v == g
    round_ = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + round_) >> _HSV_SHIFT
    h = np.where(vr, g - b, np.where(vg, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + round_) >> _HSV_SHIFT
    h = h + np.where(h < 0, 180, 0)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) for uint8 (..., 3) arrays."""
    h = hsv[..., 0].astype(np.float32)
    s = hsv[..., 1].astype(np.float32) * np.float32(1 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1 / 255.0)
    h = h * np.float32(6.0 / 180)
    h = np.where(h >= 6, h - np.float32(6), h).astype(np.float32)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector.astype(np.float32)).astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1.0)
    # OpenCV's vector path fuses 1 - s*h into one multiply-add; float64
    # holds the product exactly, so one rounding to float32 is the fused
    # result (checked against cv2 on every uint8 HSV triple).
    s64 = s.astype(np.float64)
    q = (one - s64 * h).astype(np.float32)
    t = (one - s64 * (one - h)).astype(np.float32)
    tab = np.stack([v, v * (one - s), v * q, v * t], axis=-1)
    idx = _SECTOR[sector]  # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, idx, axis=-1)
    gray = (s == 0)[..., None]
    bgr = np.where(gray, v[..., None], bgr)
    rgb = bgr[..., ::-1] * np.float32(255.0)
    # Per row, OpenCV's vector path (its AVX2 build: blocks of 32 pixels)
    # truncates to uint8; the row's last width % 32 pixels take the scalar
    # path, which rounds to nearest.
    w = rgb.shape[-2]
    vector = (np.arange(w) < w - w % _HSV_VECTOR)[:, None]
    out = np.where(vector, np.floor(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)


def _linear_taps(n_src: int, n_dst: int, scale: float):
    """OpenCV's INTER_LINEAR source taps along one axis for `cv2.resize(...,
    fx=scale)`: half-pixel centres at (d + 0.5) / scale - 0.5 (computed in
    double, rounded to float32), clamped to the edge with a zero weight."""
    pos = ((np.arange(n_dst, dtype=np.float64) + 0.5) * (1.0 / scale) - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0.astype(np.float32)).astype(np.float32)
    low = i0 < 0
    high = i0 >= n_src - 1
    i0 = np.where(low, 0, np.where(high, n_src - 1, i0))
    frac = np.where(low | high, np.float32(0), frac).astype(np.float32)
    i1 = np.minimum(i0 + 1, n_src - 1)
    return i0, i1, frac


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """`cv2.resize(img, None, fx=fx, fy=fy, interpolation=cv2.INTER_LINEAR)`
    for float (H, W[, C]) arrays: the output size rounds to nearest, each
    axis samples at OpenCV's half-pixel positions with edge clamping, the
    rows are interpolated first and the columns of the result second, in the
    input's precision."""
    h, w = img.shape[:2]
    dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
    if (dh, dw) == (h, w):
        return img.copy()
    dt = img.dtype
    x0, x1, ax = _linear_taps(w, dw, fx)
    y0, y1, ay = _linear_taps(h, dh, fy)
    ax = ax.astype(dt).reshape((1, dw) + (1,) * (img.ndim - 2))
    ay = ay.astype(dt).reshape((dh, 1) + (1,) * (img.ndim - 2))
    one = dt.type(1)
    horiz = img[:, x0] * (one - ax) + img[:, x1] * ax
    return horiz[y0] * (one - ay) + horiz[y1] * ay


def _gamma_(out: np.ndarray, gamma: float, gain: float) -> None:
    from raft_stereo_tpu_torch.data import native_io

    if gamma == 1.0:
        # identity-gamma fast path: the default aug config (gamma=(1,1,1,1))
        # always lands here; skip the per-pixel pow.
        _brightness_(out, gain)
        return
    if native_io.gamma_(out, gamma, gain):
        return
    np.clip(out, 0, None, out=out)
    out *= np.float32(1 / 255.0)
    np.power(out, np.float32(gamma), out=out)
    out *= np.float32(255.0 * gain)
    np.clip(out, 0, 255, out=out)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    out = _f32c(img)
    _gamma_(out, gamma, gain)
    return out


@dataclasses.dataclass
class StereoAugmentor:
    """Photometric + eraser + spatial augmentation for a rectified stereo pair.

    `sparse=False` reproduces FlowAugmentor semantics (dense GT, y-jitter
    crop); `sparse=True` reproduces SparseFlowAugmentor (sparse GT, scatter
    resize, margin crop). Flow arrays are (H, W, 2) with the stereo
    convention flow = (-disp, 0) (reference core/stereo_datasets.py:218).
    """

    crop_size: Tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: Optional[str] = None  # None | 'h' (stereo swap) | 'hf' | 'v'
    yjitter: bool = False
    saturation_range: Tuple[float, float] = (0.6, 1.4)
    gamma: Tuple[float, float, float, float] = (1, 1, 1, 1)
    sparse: bool = False

    # reference constants (augmentor.py:66-83, 191-203)
    brightness: float = 0.4
    contrast: float = 0.4
    hue: float = 0.5 / 3.14
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5
    stretch_prob: float = 0.8
    max_stretch: float = 0.2

    @property
    def spatial_aug_prob(self) -> float:
        return 0.8 if self.sparse else 1.0

    # --- photometric ---
    def _color_jitter(
        self, rng: np.random.Generator, img: np.ndarray, owned: bool = False
    ) -> np.ndarray:
        # Factor draw order and the op permutation are part of the
        # reproducibility contract (seeded rng) — keep them stable.
        b = rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = rng.uniform(*self.saturation_range)
        h = rng.uniform(-self.hue, self.hue)
        # One owned float32 buffer, mutated in place by the fused ops (hue
        # goes through the uint8 HSV path and yields a fresh buffer). `owned`
        # callers pass a freshly built float32 array to skip the copy.
        if not (owned and img.dtype == np.float32 and img.flags["C_CONTIGUOUS"]):
            img = _f32c(img)
        for i in rng.permutation(4):
            if i == 0:
                _brightness_(img, b)
            elif i == 1:
                _contrast_(img, c)
            elif i == 2:
                _saturation_(img, s)
            else:
                img = adjust_hue(img, h)
        g_min, g_max, gain_min, gain_max = self.gamma
        _gamma_(img, rng.uniform(g_min, g_max), rng.uniform(gain_min, gain_max))
        return img

    def color_transform(self, rng, img1, img2):
        if self.sparse:
            # sparse path: gamma-only, always symmetric (augmentor.py:203,205-210)
            g_min, g_max, gain_min, gain_max = self.gamma
            gamma, gain = rng.uniform(g_min, g_max), rng.uniform(gain_min, gain_max)
            return adjust_gamma(img1, gamma, gain), adjust_gamma(img2, gamma, gain)
        if rng.random() < self.asymmetric_color_aug_prob:
            return self._color_jitter(rng, img1), self._color_jitter(rng, img2)
        # concat + uint8->float32 in one pass; the jitter mutates it in place
        stacked = self._color_jitter(
            rng, np.concatenate([img1, img2], axis=0, dtype=np.float32), owned=True
        )
        return np.split(stacked, 2, axis=0)

    # --- occlusion eraser (augmentor.py:98-111) ---
    def eraser_transform(self, rng, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, img2.shape[-1]).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0 : y0 + dy, x0 : x0 + dx, :] = mean_color
        return img1, img2

    # --- sparse flow resize by scatter (augmentor.py:233-266) ---
    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx, fy):
        ht, wd = flow.shape[:2]
        ys, xs = np.meshgrid(np.arange(ht), np.arange(wd), indexing="ij")
        coords = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        keep = valid.reshape(-1) >= 1
        coords0, flow0 = coords[keep], flow_flat[keep]

        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        coords1 = coords0 * [fx, fy]
        flow1 = flow0 * [fx, fy]
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        inb = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

        flow_img = np.zeros((ht1, wd1, 2), np.float32)
        valid_img = np.zeros((ht1, wd1), np.int32)
        flow_img[yy[inb], xx[inb]] = flow1[inb]
        valid_img[yy[inb], xx[inb]] = 1
        return flow_img, valid_img

    # --- spatial (augmentor.py:113-170, 268-305) ---
    def spatial_transform(self, rng, img1, img2, flow, valid=None):
        ht, wd = img1.shape[:2]
        pad = 1 if self.sparse else 8
        floor_scale = max((self.crop_size[0] + pad) / ht, (self.crop_size[1] + pad) / wd)

        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if not self.sparse and rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, floor_scale)
        scale_y = max(scale_y, floor_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            if self.sparse:
                flow, valid = self.resize_sparse_flow_map(flow, valid, scale_x, scale_y)
            else:
                flow = resize_linear(flow, scale_x, scale_y)
                flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if self.do_flip == "hf" and rng.random() < 0.5:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.do_flip == "h" and rng.random() < 0.5:
                # stereo-consistent flip: swap eyes and mirror
                img1, img2 = img2[:, ::-1], img1[:, ::-1]
            if self.do_flip == "v" and rng.random() < 0.1:
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        ch, cw = self.crop_size
        if self.sparse:
            # margin crop biased to image edges (augmentor.py:296-305)
            y0 = int(np.clip(rng.integers(0, img1.shape[0] - ch + 20), 0, img1.shape[0] - ch))
            x0 = int(np.clip(rng.integers(-50, img1.shape[1] - cw + 50), 0, img1.shape[1] - cw))
            y1 = y0
        elif self.yjitter:
            # simulate imperfect rectification: img2 rows offset ±2 (augmentor.py:155-162)
            y0 = int(rng.integers(2, img1.shape[0] - ch - 2))
            x0 = int(rng.integers(2, img1.shape[1] - cw - 2))
            y1 = y0 + int(rng.integers(-2, 3))
        else:
            y0 = int(rng.integers(0, img1.shape[0] - ch))
            x0 = int(rng.integers(0, img1.shape[1] - cw))
            y1 = y0

        img1 = img1[y0 : y0 + ch, x0 : x0 + cw]
        img2 = img2[y1 : y1 + ch, x0 : x0 + cw]
        flow = flow[y0 : y0 + ch, x0 : x0 + cw]
        if self.sparse:
            valid = valid[y0 : y0 + ch, x0 : x0 + cw]
            return img1, img2, flow, valid
        return img1, img2, flow

    def __call__(self, rng: np.random.Generator, img1, img2, flow, valid=None):
        """Returns (img1, img2, flow[, valid]) as contiguous float32 arrays."""
        img1 = np.asarray(img1, np.float32)
        img2 = np.asarray(img2, np.float32)
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2)
        out = self.spatial_transform(rng, img1, img2, flow, valid)
        return tuple(np.ascontiguousarray(x) for x in out)


# ---------------------------------------------------------------------------
# Gated-modality ambient-light augmentation (fork-specific;
# reference core/stereo_datasets.py:30-119). The per-slice dark levels and
# exposure times are calibration DATA for the gated rig, reproduced verbatim.
# ---------------------------------------------------------------------------

_DARK_LEVEL = {
    "left": {
        "day": {6: 72.4, 7: 74.2, 8: 72.8, 9: 57.2, 10: 73.3},
        "night": {6: 74.7, 7: 79.6, 8: 73.7, 9: 58.7, 10: 74.3},
    },
    "right": {
        "day": {6: 81.9, 7: 81.8, 8: 81.4, 9: 57.6, 10: 68.2},
        "night": {6: 57.8, 7: 41.8, 8: 68.2, 9: 61.4, 10: 83.6},
    },
}
_EXPOSURE = {
    "day": {6: 21, 7: 108, 8: 161.7, 9: 161.7, 10: 161.7},
    "night": {6: 804.9, 7: 1744.7, 8: 323.4, 9: 323.4, 10: 323.4},
}
_SLICE_TYPES = (6, 7, 8, 9, 10)  # channel order of the 5-slice stack


def vary_ambient_light(
    rng: np.random.Generator,
    img: np.ndarray,
    weight_darker: float,
    is_left: bool,
    date: str,
) -> np.ndarray:
    """Gated ambient-light augmentation on a (H, W, 5) float slice stack.

    Subtracts the rig's per-slice dark level (10-bit scaled to 8-bit), then
    with p=0.3 darkens by `weight_darker` using an ambient-light estimate from
    the two short-exposure slices rescaled to slice-8 exposure (reference
    core/stereo_datasets.py:88-116). `date` is 'YYYY-MM-DD_HH-MM-SS'; hours
    (8, 18) are day.
    """
    hour = int(date.split("_")[-1].split("-")[0])
    if not 0 <= hour < 25:
        raise ValueError(f"bad hour {hour} parsed from date {date!r}")
    day_night = "day" if 8 < hour < 18 else "night"
    side = "left" if is_left else "right"

    img = np.array(img, dtype=np.float32)  # one owned copy (was astype+copy)
    for ch, t in enumerate(_SLICE_TYPES):
        img[:, :, ch] -= _DARK_LEVEL[side][day_night][t] * 255 / (2**10 - 1)

    if rng.random() > 0.7:
        exp = _EXPOSURE[day_night]
        amb6 = np.clip(img[:, :, 0] * exp[8] / exp[6], 0, 255)
        amb7 = np.clip(img[:, :, 1] * exp[8] / exp[7], 0, 255)
        ambient = (amb6 + amb7) / 2.0
        img[:, :, 0] -= weight_darker * img[:, :, 0]
        img[:, :, 1] -= weight_darker * img[:, :, 1]
        for ch in (2, 3, 4):
            img[:, :, ch] -= weight_darker * ambient

    return np.clip(img, 0, 255, out=img)
