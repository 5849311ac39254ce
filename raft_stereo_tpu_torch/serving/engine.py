"""Warmed, chunked, deadline-aware refinement: counterpart of the core of
`raft_stereo_tpu/serving/engine.py` (`BatchResult`, `AnytimeEngine`).

`warm()` runs every (bucket, batch size) once and measures the wall time of
one chunk; `run_batch` runs the prelude, then chunks of `chunk_iters` GRU
iterations with a host-side deadline check after each, and finalizes a
request when its iteration target is reached or when one more chunk would
pass its deadline (`t + est > deadline`). Every request gets at least one
chunk. A device synchronize after each chunk plays the role of JAX's
`block_until_ready`.

Not ported yet: the hang watchdog, tracer, AOT cache, jit hygiene monitor,
fleet, hot swap and stream warm starts (`flow_init`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import ServeConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo


@dataclasses.dataclass
class BatchResult:
    """Per-request outcome of one engine batch."""

    flow_up: np.ndarray  # (H, W, 1) at the padded bucket resolution, float32
    iters_completed: int
    early_exit: bool
    flow_lowres: Optional[np.ndarray] = None  # (H/f, W/f)
    # Wall time of the completed device work up to this request's delivery:
    # the chunk walls plus the finalize fetch.
    device_time_s: float = 0.0


class AnytimeEngine:
    """One model on one device, warmed for every configured bucket.

    `model` is a `RAFTStereo` already on `device`; None builds one with
    seeded random weights. `run_batch` holds a lock: the device serves one
    batch at a time."""

    def __init__(self, config: ServeConfig, model: Optional[RAFTStereo] = None,
                 device="cuda", seed: int = 0):
        self.config = config
        self.device = torch.device(device)
        if model is None:
            model = build_model(config.model, seed=seed, device=self.device)
        self.model = model.eval()
        self._chunk_est_s: Dict[Tuple[Tuple[int, int], int], float] = {}
        self.prelude_s: Dict[Tuple[Tuple[int, int], int], float] = {}
        self._lock = threading.Lock()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def warm(self) -> Dict[str, object]:
        """Run prelude, two chunks and finalize for every (bucket, batch);
        the second chunk's wall time is that combo's deadline estimate."""
        cfg = self.config
        t_start = time.monotonic()
        for hw in cfg.buckets:
            for batch in cfg.batch_sizes:
                img = torch.zeros((batch, *hw, cfg.model.in_channels), device=self.device)
                t = time.monotonic()
                state = anytime.prelude(self.model, img, img)
                self._sync()
                self.prelude_s[(hw, batch)] = time.monotonic() - t
                state = anytime.chunk(self.model, state, cfg.chunk_iters)
                self._sync()
                t = time.monotonic()
                state = anytime.chunk(self.model, state, cfg.chunk_iters)
                self._sync()
                self._chunk_est_s[(hw, batch)] = time.monotonic() - t
                anytime.finalize(self.model, state)
                self._sync()
        return {
            "combos": len(cfg.buckets) * len(cfg.batch_sizes),
            "warm_seconds": time.monotonic() - t_start,
            "chunk_est_ms": {f"{hw[0]}x{hw[1]}/b{b}": s * 1e3 for (hw, b), s in self._chunk_est_s.items()},
            "prelude_ms": {f"{hw[0]}x{hw[1]}/b{b}": s * 1e3 for (hw, b), s in self.prelude_s.items()},
        }

    def chunk_estimate_s(self, bucket: Tuple[int, int], batch: int) -> float:
        return self._chunk_est_s.get((bucket, batch), 0.0)

    @torch.inference_mode()
    def run_batch(
        self,
        bucket: Tuple[int, int],
        image1: torch.Tensor,
        image2: torch.Tensor,
        deadlines_s: Sequence[Optional[float]],
        max_iters: Sequence[int],
        now=time.monotonic,
    ) -> List[BatchResult]:
        """Refine one padded batch (B, H, W, C) on the engine's device.

        Rows beyond `len(deadlines_s)` are fill and get no result.
        `deadlines_s[i]` is an absolute `now()` deadline or None;
        `max_iters[i]` is rounded up to whole chunks."""
        cfg = self.config
        n = len(deadlines_s)
        batch = int(image1.shape[0])
        targets = [max(1, -(-min(int(m), cfg.max_iters) // cfg.chunk_iters)) for m in max_iters]
        est = self.chunk_estimate_s(bucket, batch)
        results: List[Optional[BatchResult]] = [None] * n
        with self._lock:
            device_s = 0.0
            state = anytime.prelude(self.model, image1, image2)
            pending = set(range(n))
            for k in range(1, max(targets) + 1):
                t0 = time.perf_counter()
                state = anytime.chunk(self.model, state, cfg.chunk_iters)
                self._sync()
                device_s += time.perf_counter() - t0
                iters_done = k * cfg.chunk_iters
                t = now()
                deliver = [
                    i for i in sorted(pending)
                    if targets[i] <= k or (deadlines_s[i] is not None and t + est > deadlines_s[i])
                ]
                if not deliver:
                    continue
                t0 = time.perf_counter()
                flow_lo, flow_up = anytime.finalize(self.model, state)
                flow_np = flow_up.float().cpu().numpy()
                lo_np = flow_lo.float().cpu().numpy()
                device_s += time.perf_counter() - t0
                for i in deliver:
                    results[i] = BatchResult(
                        flow_up=flow_np[i],
                        iters_completed=iters_done,
                        early_exit=iters_done < min(int(max_iters[i]), cfg.max_iters),
                        flow_lowres=lo_np[i],
                        device_time_s=device_s,
                    )
                    pending.discard(i)
                if not pending:
                    break
        assert not pending, "engine loop ended with undelivered requests"
        return results  # type: ignore[return-value]
