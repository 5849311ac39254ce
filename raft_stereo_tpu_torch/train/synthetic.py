"""Procedural synthetic stereo for convergence checks: the port's copy of
the JAX package's test generator (`tests/synthetic_stereo.py`, which the
port may not import), array for array the same from the same seed, and
`validate_epe` on the port's test-mode forward.

Each sample is a random smooth texture (low-frequency noise octaves, so
matching is locally unambiguous but not trivial) with a random disparity
plane d(x, y) = a + bx + cy, so a run trains on fresh data every step and
shows generalizing optimization, not memorization. image2 is a subpixel
warp of image1 by the disparity (flow = (-d, 0), the reference's
convention), taken from a texture wider than the image so the warp needs no
border fill.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Random smooth RGB texture in [0, 255]: noise octaves upsampled with
    bilinear interpolation (numpy only)."""
    img = np.zeros((h, w, 3), np.float32)
    for scale in (4, 8, 16):
        gh, gw = max(2, h // scale), max(2, w // scale)
        grid = rng.uniform(-1, 1, (gh, gw, 3)).astype(np.float32)
        # bilinear upsample grid -> (h, w)
        yy = np.linspace(0, gh - 1, h, dtype=np.float32)
        xx = np.linspace(0, gw - 1, w, dtype=np.float32)
        y0 = np.floor(yy).astype(int).clip(0, gh - 2)
        x0 = np.floor(xx).astype(int).clip(0, gw - 2)
        fy = (yy - y0)[:, None, None]
        fx = (xx - x0)[None, :, None]
        g = (
            grid[y0][:, x0] * (1 - fy) * (1 - fx)
            + grid[y0][:, x0 + 1] * (1 - fy) * fx
            + grid[y0 + 1][:, x0] * fy * (1 - fx)
            + grid[y0 + 1][:, x0 + 1] * fy * fx
        )
        img += g * scale
    img -= img.min()
    img *= 255.0 / max(img.max(), 1e-6)
    return img


def make_sample(rng: np.random.Generator, h: int, w: int, max_disp: float = 8.0):
    """One stereo pair with a random disparity plane. Returns
    (image1, image2, flow, valid) with flow = -disparity (x channel only)."""
    margin = int(np.ceil(max_disp)) + 1
    base = _texture(rng, h, w + margin)
    # disparity plane, clipped to [0.5, max_disp]
    a = rng.uniform(1.0, max_disp - 1.0)
    bx = rng.uniform(-2.0, 2.0) / max(w, 1)
    cy = rng.uniform(-2.0, 2.0) / max(h, 1)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    disp = np.clip(a + bx * xs + cy * ys, 0.5, max_disp).astype(np.float32)

    image1 = base[:, :w]
    # image2(x) = image1(x + d): subpixel gather with linear interpolation
    coords = xs + disp  # (h, w)
    x0 = np.floor(coords).astype(int)
    fx = (coords - x0)[..., None]
    x0 = np.clip(x0, 0, base.shape[1] - 2)
    rows = np.arange(h)[:, None]
    image2 = base[rows, x0] * (1 - fx) + base[rows, x0 + 1] * fx

    flow = -disp[..., None]
    valid = np.ones((h, w), np.float32)
    return image1, image2.astype(np.float32), flow, valid


def make_batch(rng: np.random.Generator, b: int, h: int, w: int) -> Dict[str, np.ndarray]:
    samples = [make_sample(rng, h, w) for _ in range(b)]
    return {
        "image1": np.stack([s[0] for s in samples]),
        "image2": np.stack([s[1] for s in samples]),
        "flow": np.stack([s[2] for s in samples]),
        "valid": np.stack([s[3] for s in samples]),
    }


def validate_epe(model, h: int, w: int, n: int = 8, iters: int = 12) -> float:
    """Mean end-point error (px) of `model`'s test-mode forward over `n`
    held-out samples, sample i from `np.random.default_rng((31337, i))`, as
    the JAX package's test helper takes them: the in-sandbox stand-in for
    the reference validators. Runs on the model's device."""
    device = next(model.parameters()).device
    epes = []
    with torch.no_grad():
        for i in range(n):
            image1, image2, flow, _ = make_sample(np.random.default_rng((31337, i)), h, w)
            _, up = model(torch.from_numpy(image1[None]).to(device), torch.from_numpy(image2[None]).to(device),
                          iters=iters, test_mode=True)
            epes.append(float(np.abs(up[0, ..., 0].cpu().numpy() - flow[..., 0]).mean()))
    return float(np.mean(epes))
