"""Streaming video stereo: per-stream warm-started anytime refinement,
counterpart of `raft_stereo_tpu/video/session.py`.

On video the previous frame's disparity is a far better starting point
than `coords1 == coords0`, so a warm-started frame reaches the cold-start
error in a fraction of the iterations. `StreamSession` is the standalone
entry point: it runs the port's anytime stages (models/anytime.py) on one model,
carries the previous frame's low-res flow (and optionally the GRU hidden
state) across `process()` calls, and feeds it back through the prelude's
`flow_init` — the same ops as `RAFTStereo.forward(flow_init=...)`.

Reset gate — the error proxy. Ground truth doesn't exist at inference, so
a candidate `flow_init` is scored by its photometric warp error on the NEW
frame pair at 1/4 resolution (`flow_warp_error`, numpy on the host
images): warp image2 along x by the candidate flow and compare to image1.
On continuous video the previous flow explains the new pair about as well
as its own (ratio ~1); after a scene cut the error jumps. The gate resets
when the candidate error exceeds `reset_error_ratio` x the error the same
flow reached on its own frame AND the absolute `reset_error_floor`; the
frame then cold-starts with the full `cold_iters` budget. The gate decides
before the refinement runs, so a reset costs one cold frame. The serving
front (serving/service.py `submit_stream`) uses the same gate.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from raft_stereo_tpu_torch.config import VideoConfig
from raft_stereo_tpu_torch.models import anytime
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo


def downsample_gray(image: np.ndarray, factor: int) -> np.ndarray:
    """(H, W, C) or (H, W) [0, 255] image -> (H//f, W//f) grayscale by block
    mean (trailing rows/cols beyond a multiple of `factor` are cropped)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    h = img.shape[0] - img.shape[0] % factor
    w = img.shape[1] - img.shape[1] % factor
    img = img[:h, :w]
    return img.reshape(h // factor, factor, w // factor, factor).mean(axis=(1, 3))


def flow_warp_error(
    image1: np.ndarray, image2: np.ndarray, flow_lowres: np.ndarray, factor: int
) -> float:
    """EPE proxy without ground truth: mean |I1 - warp(I2, flow)| at 1/4 res.

    `flow_lowres` is the model's low-res flow field (h, w) in LOW-RES pixel
    units with the model's sign convention (flow = -disparity): the corr
    lookup samples image2 at `x + flow`, so warping image2 by `+flow`
    reconstructs image1 where the flow is right. Bilinear along x only —
    stereo is a 1-D correspondence problem. Returns mean absolute intensity
    error in [0, 255] units. A non-finite flow or image (poisoned frame, NaN
    refinement output) returns +inf — "maximally wrong", so the reset gate
    always fires and the serving tier refuses to carry the flow forward —
    instead of feeding NaNs into the int cast below."""
    i1 = downsample_gray(image1, factor)
    i2 = downsample_gray(image2, factor)
    h, w = i1.shape
    flow = np.asarray(flow_lowres, np.float32).reshape(h, w)
    if not (np.isfinite(flow).all() and np.isfinite(i1).all() and np.isfinite(i2).all()):
        return float("inf")
    xs = np.arange(w, dtype=np.float32)[None, :] + flow
    x0 = np.floor(xs)
    frac = xs - x0
    x0i = np.clip(x0.astype(np.int64), 0, w - 1)
    x1i = np.clip(x0i + 1, 0, w - 1)
    rows = np.arange(h)[:, None]
    warped = (1.0 - frac) * i2[rows, x0i] + frac * i2[rows, x1i]
    err = float(np.mean(np.abs(warped - i1)))
    return err if np.isfinite(err) else float("inf")


def should_reset(
    err_candidate: float, err_prev: Optional[float], video: VideoConfig
) -> bool:
    """The reset verdict (see module docstring). `err_prev` is the warp error
    the candidate flow achieved on its OWN frame pair; None (no history)
    never resets — there is nothing to compare against."""
    if err_prev is None:
        return False
    return (
        err_candidate > video.reset_error_floor
        and err_candidate > video.reset_error_ratio * err_prev
    )


def gt_flow_lowres(frame: Dict[str, Any], factor: int) -> np.ndarray:
    """Ground-truth full-res flow (H, W, 1) -> the model's low-res field
    (H//f, W//f): block-mean downsample AND divide by `factor` (the model's
    low-res flow is in low-res pixel units; convex_upsample multiplies by
    the factor on the way up). Used to emulate a converged model's carried
    flow in the parity A/B and the reset-gate tests."""
    flow = np.asarray(frame["flow"], np.float32)[..., 0]
    return downsample_gray(flow, factor) / float(factor)


def sequence_epe(flow_up: np.ndarray, frame: Dict[str, Any]) -> float:
    """Mean end-point error of a full-res flow (H, W, 1) against a GT-bearing
    sequence frame dict ({"flow": (H, W, 1), "valid": (H, W)}). Disparity
    flow is 1-D, so EPE is |delta flow|."""
    valid = np.asarray(frame["valid"]) > 0.5
    gt = np.asarray(frame["flow"], np.float32)[..., 0]
    return float(np.mean(np.abs(np.asarray(flow_up)[..., 0] - gt)[valid]))


def _chunks(iters: int, chunk_iters: int) -> int:
    return max(1, -(-iters // chunk_iters))


class StreamSession:
    """One video stream's warm-started refinement (module docstring).

    Not thread-safe — one session per stream, frames in order. For many
    concurrent streams through the micro-batcher use
    `StereoService.submit_stream`; this class is the standalone / offline
    entry point. `model` is a `RAFTStereo` on the device the frames should run
    on (the images are moved there).
    """

    # Optional obs.trace.Tracer: each process() call records a "frame" span.
    tracer = None

    def __init__(self, model: RAFTStereo, video: Optional[VideoConfig] = None):
        self.model = model.eval()
        self.config = model.config
        self.video = video if video is not None else VideoConfig()
        self.device = next(model.parameters()).device
        self.frames = 0
        self.warm_frames = 0
        self.resets = 0
        self._flow = None  # device (1, h, w) low-res flow from the last frame
        self._flow_host = None  # same, host-resident (h, w), for the gate
        self._net = None  # previous GRU hidden state when carry_hidden
        self._err = None  # warp error self._flow reached on its own pair
        self._shape = None

    def reset(self) -> None:
        """Drop all carried state; the next frame cold-starts."""
        self._flow = None
        self._flow_host = None
        self._net = None
        self._err = None

    def seed(self, image1, image2, flow_lowres) -> None:
        """Inject a carried flow as if the session had just produced
        `flow_lowres` ((h, w) low-res units) on the pair (image1, image2):
        the offline/test hook for driving the reset gate with a known prior."""
        i1 = self._batched(image1)
        i2 = self._batched(image2)
        self._shape = i1.shape
        host = np.asarray(flow_lowres, np.float32)
        self._flow = torch.from_numpy(host[None]).to(self.device)
        self._flow_host = host
        self._net = None
        self._err = flow_warp_error(i1[0], i2[0], host, self.config.downsample_factor)

    @staticmethod
    def _batched(image) -> np.ndarray:
        arr = np.asarray(image, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4 or arr.shape[0] != 1:
            raise ValueError(f"StreamSession takes one (H, W, C) frame at a time, got shape {arr.shape}")
        return arr

    @torch.inference_mode()
    def process(self, image1, image2) -> Dict[str, Any]:
        """Refine one frame pair; returns the full-res disparity plus the
        session's warm/reset verdict for this frame."""
        v = self.video
        t_start = time.perf_counter()
        i1 = self._batched(image1)
        i2 = self._batched(image2)
        if self._shape is not None and i1.shape != self._shape:
            self.reset()  # resolution change == new scene
        self._shape = i1.shape
        factor = self.config.downsample_factor

        warm = False
        reset = False
        err_candidate = None
        flow_init = None
        if v.warm_start and self._flow is not None:
            err_candidate = flow_warp_error(i1[0], i2[0], self._flow_host, factor)
            if should_reset(err_candidate, self._err, v):
                reset = True
                self.resets += 1
                self.reset()
            else:
                warm = True
                flow_init = self._flow

        iters = v.warm_iters if warm else v.cold_iters
        chunks = _chunks(iters, v.chunk_iters)
        t1 = torch.from_numpy(i1).to(self.device)
        t2 = torch.from_numpy(i2).to(self.device)
        state = anytime.prelude(self.model, t1, t2, flow_init)
        if flow_init is not None and v.carry_hidden and self._net is not None:
            state = dict(state, net=self._net)
        for _ in range(chunks):
            state = anytime.chunk(self.model, state, v.chunk_iters)
        flow_lo, flow_up = anytime.finalize(self.model, state)

        self._flow = flow_lo
        self._flow_host = flow_lo.float().cpu().numpy()[0]
        self._net = state["net"] if v.carry_hidden else None
        self._err = flow_warp_error(i1[0], i2[0], self._flow_host, factor)
        up = flow_up.float().cpu().numpy()[0]
        self.frames += 1
        if warm:
            self.warm_frames += 1
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.span("frame", t0=t_start, t1=time.perf_counter(), frame_index=self.frames - 1,
                        warm=warm, reset=reset, iters=chunks * v.chunk_iters)
        return {
            "disparity": -up[..., 0],
            "flow_up": up,
            "flow_lowres": self._flow_host,
            "iters": chunks * v.chunk_iters,
            "warm_started": warm,
            "reset": reset,
            "warp_error_prior": err_candidate,
            "warp_error": self._err,
            "frame_index": self.frames - 1,
        }


def replay_sequence(session: StreamSession, frames: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Feed an ordered frame sequence through one session and wall-clock
    the frames after the first (frame 0 is a cold start and, on a card, the
    kernels' first build), so `video_maps_per_sec` is streaming throughput."""
    results = [session.process(frames[0]["image1"], frames[0]["image2"])]
    t0 = time.perf_counter()
    for frame in frames[1:]:
        results.append(session.process(frame["image1"], frame["image2"]))
    wall = time.perf_counter() - t0
    n_timed = len(frames) - 1
    return {
        "video_maps_per_sec": (n_timed / wall) if (n_timed and wall > 0) else 0.0,
        "frames": len(frames),
        "warm_frames": sum(1 for r in results if r["warm_started"]),
        "resets": sum(1 for r in results if r["reset"]),
        "results": results,
    }


@torch.inference_mode()
def warm_cold_parity(model: RAFTStereo, frames: Sequence[Dict[str, Any]], video: VideoConfig,
                     cold_iters: Optional[int] = None, prior: str = "gt") -> Dict[str, Any]:
    """How many warm-started iterations match the cold-start `cold_iters`
    error on a GT-bearing sequence.

    For every frame after the first, runs (a) a cold forward with the full
    budget and (b) a warm forward seeded from the previous frame's flow,
    finalizing after EVERY chunk for the warm error ladder. Parity is the
    smallest iteration count whose mean warm error is <= the mean cold
    error; if no rung reaches it, parity is `cold_iters`.

    `prior` picks the warm-start source: "gt", the previous frame's
    ground-truth low-res flow (what a converged model would carry; the mode
    for random weights), or "model", each next frame seeded from the warm
    run's own state at `video.warm_iters` (a trained checkpoint's mode).
    """
    if prior not in ("gt", "model"):
        raise ValueError(f"prior must be 'gt' or 'model', got {prior!r}")
    v = video
    model = model.eval()
    device = next(model.parameters()).device
    budget = cold_iters if cold_iters is not None else v.cold_iters
    n_chunks = _chunks(budget, v.chunk_iters)
    budget = n_chunks * v.chunk_iters
    factor = model.config.downsample_factor

    def up_np(t):
        return t.float().cpu().numpy()[0]

    prev_flow = None
    cold_epes: List[float] = []
    warm_ladders: List[List[float]] = []
    for t, frame in enumerate(frames):
        i1 = torch.from_numpy(np.asarray(frame["image1"], np.float32)[None]).to(device)
        i2 = torch.from_numpy(np.asarray(frame["image2"], np.float32)[None]).to(device)
        state = anytime.prelude(model, i1, i2)
        for _ in range(n_chunks):
            state = anytime.chunk(model, state, v.chunk_iters)
        cold_lo, cold_up = anytime.finalize(model, state)
        if t == 0:
            prev_flow = cold_lo
            continue
        cold_epes.append(sequence_epe(up_np(cold_up), frame))
        if prior == "gt":
            prev_flow = torch.from_numpy(gt_flow_lowres(frames[t - 1], factor)[None]).to(device)
        state = anytime.prelude(model, i1, i2, prev_flow)
        ladder: List[float] = []
        next_source = None
        for k in range(1, n_chunks + 1):
            state = anytime.chunk(model, state, v.chunk_iters)
            lo_w, up_w = anytime.finalize(model, state)
            ladder.append(sequence_epe(up_np(up_w), frame))
            if next_source is None and k * v.chunk_iters >= v.warm_iters:
                next_source = lo_w
        warm_ladders.append(ladder)
        prev_flow = next_source if next_source is not None else lo_w

    cold_epe = float(np.mean(cold_epes))
    warm_by_iters = {
        (k + 1) * v.chunk_iters: float(np.mean([lad[k] for lad in warm_ladders]))
        for k in range(n_chunks)
    }
    parity = budget
    for it in sorted(warm_by_iters):
        if warm_by_iters[it] <= cold_epe:
            parity = it
            break
    return {
        "cold_iters": int(budget),
        "cold_epe": cold_epe,
        "warm_iters_to_parity": int(parity),
        "warm_epe_at_parity": warm_by_iters.get(parity, cold_epe),
        "warm_epe_by_iters": {str(k): e for k, e in sorted(warm_by_iters.items())},
        "frames": len(frames),
    }
