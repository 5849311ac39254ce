"""The serving front's core: counterpart of `StereoService.pick_bucket`,
`_admit` and `submit` in `raft_stereo_tpu/serving/service.py`.

Admission maps a request onto the smallest configured bucket that fits
(by padded area), edge-pads it on the host to that exact shape, runs it as a
batch of one on the anytime engine, and unpads the disparity to the input's
own H x W. An input larger than every bucket raises `BucketOverflowError`.
`submit` runs in place and returns an already-resolved Future; the
micro-batcher, lifecycle breaker, HTTP front and streams are not ported yet.
"""

from __future__ import annotations

import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.serving.engine import AnytimeEngine
from raft_stereo_tpu_torch.utils.padding import InputPadder


class BucketOverflowError(ValueError):
    """Input larger than every configured shape bucket."""


class StereoService:
    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 device="cuda", seed: int = 0):
        self.config = config
        self.engine = AnytimeEngine(config, model, device=device, seed=seed)
        self.warm_summary = None

    def start(self) -> "StereoService":
        """Warm every (bucket, batch) combination."""
        self.warm_summary = self.engine.warm()
        return self

    def pick_bucket(self, h: int, w: int) -> Tuple[int, int]:
        """Smallest configured bucket fitting (h, w), by padded area."""
        fits = [b for b in self.config.buckets if b[0] >= h and b[1] >= w]
        if not fits:
            raise BucketOverflowError(f"input {h}x{w} exceeds every bucket {list(self.config.buckets)}")
        return min(fits, key=lambda b: b[0] * b[1])

    def _admit(self, image1, image2):
        """Validate, pick a bucket, edge-pad on the host.
        Returns (bucket, padder, p1, p2)."""
        i1 = np.asarray(image1, np.float32)
        i2 = np.asarray(image2, np.float32)
        if i1.shape != i2.shape or i1.ndim != 3:
            raise ValueError(f"expected two equal (H, W, C) images, got {i1.shape} and {i2.shape}")
        h, w = i1.shape[0], i1.shape[1]
        bucket = self.pick_bucket(h, w)
        padder = InputPadder((1, h, w, i1.shape[2]), divis_by=self.config.divis_by, target=bucket)
        left, right, top, bottom = padder.pad_amounts
        p1 = np.pad(i1, ((top, bottom), (left, right), (0, 0)), mode="edge")
        p2 = np.pad(i2, ((top, bottom), (left, right), (0, 0)), mode="edge")
        return bucket, padder, p1, p2

    def submit(self, image1: np.ndarray, image2: np.ndarray, deadline_ms: Optional[float] = None,
               max_iters: Optional[int] = None) -> Future:
        """Run one stereo pair; the returned Future is already resolved to
        {"disparity": (H, W) float32, "iters_completed", "early_exit",
        "latency_ms", "bucket"}. `deadline_ms` is relative to now (None
        takes the config default; 0 disables)."""
        t_admit = time.monotonic()
        bucket, padder, p1, p2 = self._admit(image1, image2)
        if deadline_ms is None:
            deadline_ms = self.config.deadline_ms
        deadline_s = t_admit + deadline_ms / 1e3 if deadline_ms else None
        device = self.engine.device
        i1 = torch.from_numpy(p1[None]).to(device)
        i2 = torch.from_numpy(p2[None]).to(device)
        res = self.engine.run_batch(
            bucket, i1, i2, deadlines_s=[deadline_s],
            max_iters=[self.config.max_iters if max_iters is None else int(max_iters)],
        )[0]
        disparity = np.asarray(padder.unpad(res.flow_up[None])[0, :, :, 0], np.float32)
        future: Future = Future()
        future.set_result({
            "disparity": disparity,
            "iters_completed": res.iters_completed,
            "early_exit": res.early_exit,
            "latency_ms": (time.monotonic() - t_admit) * 1e3,
            "bucket": list(bucket),
        })
        return future
