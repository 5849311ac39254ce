"""Validation harness on PyTorch: counterpart of `raft_stereo_tpu/evaluate.py`,
with the reference's metric definitions unchanged.

All four validators share one skeleton (pad to a multiple of 32 -> test-mode
forward -> unpad -> EPE), differing in the bad-pixel threshold and the
valid-pixel rule:

- ETH3D: bad > 1px, valid = valid_gt >= 0.5
- KITTI: bad > 3px, valid = valid_gt >= 0.5, plus FPS timing skipping the
  first 50 images; per-pixel D1 aggregation
- FlyingThings (TEST subset): bad > 1px, valid also requires |gt| < 192
- Middlebury F/H/Q: bad > 2px, valid = valid_gt >= -0.5 & gt > -1000

The forward runs on the model's device (the card unless the caller built
the model on the CPU); images are padded there, and the forward is timed
between two `torch.cuda.synchronize` calls, so the KITTI FPS figure is
synchronized wall time: the device's work plus the host's launch gaps
between kernels (`profile_stages` separates device time). The dataset
readers are not ported yet: a validator takes a dataset object
(`SyntheticEvalDataset`, or any object with `__len__` and
`get_item(index, rng)` returning the item dict) and raises without one.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.utils.padding import InputPadder

logger = logging.getLogger(__name__)


class Evaluator:
    """Test-mode forward of a port `RAFTStereo` under `torch.no_grad()`.
    `pad_bucket` > 0 additionally rounds padded sizes up to a multiple of
    that bucket (replicate-edge, cropped after the forward, so only
    border-context numerics can shift); pad_bucket=0 (default) reproduces
    the reference's exact minimal padding to a multiple of 32."""

    def __init__(self, model: Optional[RAFTStereo], iters: int = 32, pad_bucket: int = 0):
        self.model = model
        self.iters = iters
        self.pad_bucket = pad_bucket
        # Optional liveness callback, invoked after every completed forward
        # (the JAX trainer wires its step watchdog here).
        self.heartbeat = None

    def __call__(self, image1: np.ndarray, image2: np.ndarray) -> Tuple[np.ndarray, float]:
        """image1/2: (H, W, C) float arrays in [0, 255]. Returns
        ((H, W) disparity-flow, forward seconds)."""
        device = next(self.model.parameters()).device
        i1 = torch.as_tensor(image1, dtype=torch.float32, device=device)[None]
        i2 = torch.as_tensor(image2, dtype=torch.float32, device=device)[None]
        padder = InputPadder(i1.shape, divis_by=32, bucket=self.pad_bucket)
        i1, i2 = padder.pad(i1, i2)
        with torch.no_grad():
            _sync(device)
            start = time.perf_counter()
            _, up = self.model(i1, i2, iters=self.iters, test_mode=True)
            _sync(device)
            elapsed = time.perf_counter() - start
        if self.heartbeat is not None:
            self.heartbeat()
        return padder.unpad(up)[0, :, :, 0].cpu().numpy(), elapsed


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _epe_1d(flow_pred: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    """Endpoint error; the reference's 2D norm reduces to |dx| because both
    y components are identically zero."""
    return np.abs(flow_pred - flow_gt)


def _require(dataset, name: str):
    if dataset is None:
        raise NotImplementedError(
            f"the {name} dataset reader is not ported yet (ROADMAP Queue A item 11): pass dataset=, "
            "e.g. SyntheticEvalDataset()"
        )
    return dataset


def validate_eth3d(evaluator: Evaluator, dataset=None) -> Dict[str, float]:
    dataset = _require(dataset, "ETH3D")
    epe_list, out_list = [], []
    for i in range(len(dataset)):
        item = dataset.get_item(i, np.random.default_rng(0))
        flow, _ = evaluator(item["image1"], item["image2"])
        epe = _epe_1d(flow, item["flow"][..., 0]).ravel()
        val = item["valid"].ravel() >= 0.5
        epe_list.append(epe[val].mean())
        out_list.append((epe[val] > 1.0).mean())
        logger.info("ETH3D %d/%d EPE %.4f D1 %.4f", i + 1, len(dataset), epe_list[-1], out_list[-1])
    result = {"eth3d-epe": float(np.mean(epe_list)), "eth3d-d1": 100 * float(np.mean(out_list))}
    print("Validation ETH3D: EPE %f, D1 %f" % (result["eth3d-epe"], result["eth3d-d1"]))
    return result


def validate_kitti(evaluator: Evaluator, dataset=None) -> Dict[str, float]:
    dataset = _require(dataset, "KITTI")
    epe_list, out_list, elapsed = [], [], []
    for i in range(len(dataset)):
        item = dataset.get_item(i, np.random.default_rng(0))
        flow, dt = evaluator(item["image1"], item["image2"])
        if i > 50:
            elapsed.append(dt)
        epe = _epe_1d(flow, item["flow"][..., 0]).ravel()
        val = item["valid"].ravel() >= 0.5
        epe_list.append(epe[val].mean())
        out_list.append(epe[val] > 3.0)
    result = {
        "kitti-epe": float(np.mean(epe_list)),
        "kitti-d1": 100 * float(np.concatenate(out_list).mean()),
    }
    if elapsed:
        result["kitti-fps"] = 1.0 / float(np.mean(elapsed))
        print(
            f"Validation KITTI: EPE {result['kitti-epe']}, D1 {result['kitti-d1']}, "
            f"{result['kitti-fps']:.2f}-FPS"
        )
    else:
        print(f"Validation KITTI: EPE {result['kitti-epe']}, D1 {result['kitti-d1']}")
    return result


def validate_things(evaluator: Evaluator, dataset=None) -> Dict[str, float]:
    dataset = _require(dataset, "SceneFlow")
    epe_list, out_list = [], []
    for i in range(len(dataset)):
        item = dataset.get_item(i, np.random.default_rng(0))
        flow, _ = evaluator(item["image1"], item["image2"])
        gt = item["flow"][..., 0]
        epe = _epe_1d(flow, gt).ravel()
        val = (item["valid"].ravel() >= 0.5) & (np.abs(gt).ravel() < 192)
        epe_list.append(epe[val].mean())
        out_list.append(epe[val] > 1.0)
    result = {
        "things-epe": float(np.mean(epe_list)),
        "things-d1": 100 * float(np.concatenate(out_list).mean()),
    }
    print("Validation FlyingThings: %f, %f" % (result["things-epe"], result["things-d1"]))
    return result


def validate_middlebury(evaluator: Evaluator, dataset=None, split="F") -> Dict[str, float]:
    dataset = _require(dataset, "Middlebury")
    epe_list, out_list = [], []
    for i in range(len(dataset)):
        item = dataset.get_item(i, np.random.default_rng(0))
        flow, _ = evaluator(item["image1"], item["image2"])
        gt = item["flow"][..., 0]
        epe = _epe_1d(flow, gt).ravel()
        val = (item["valid"].ravel() >= -0.5) & (gt.ravel() > -1000)
        epe_list.append(epe[val].mean())
        out_list.append((epe[val] > 2.0).mean())
        logger.info(
            "Middlebury %d/%d EPE %.4f D1 %.4f", i + 1, len(dataset), epe_list[-1], out_list[-1]
        )
    result = {
        f"middlebury{split}-epe": float(np.mean(epe_list)),
        f"middlebury{split}-d1": 100 * float(np.mean(out_list)),
    }
    print(f"Validation Middlebury{split}: EPE %f, D1 %f" % tuple(result.values()))
    return result


VALIDATORS = {
    "eth3d": validate_eth3d,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury_F": lambda ev, **kw: validate_middlebury(ev, split="F", **kw),
    "middlebury_H": lambda ev, **kw: validate_middlebury(ev, split="H", **kw),
    "middlebury_Q": lambda ev, **kw: validate_middlebury(ev, split="Q", **kw),
}


class SyntheticEvalDataset:
    """Dataset stand-in for `--dry_run` evaluation: runs the whole evaluate
    path (validator loop, padding, forward, metric math, logging) without
    downloaded data. Items follow the validators' contract (image1/image2
    float in [0, 255], flow (H, W, 1) negative disparity, valid mask)."""

    # Default shape is deliberately NOT a multiple of 32 so the dry run
    # exercises real padding and unpad cropping, not a zero pad.
    def __init__(self, n: int = 2, shape: Tuple[int, int] = (90, 158), channels: int = 3):
        self.n = n
        self.shape = shape
        self.channels = channels

    def __len__(self) -> int:
        return self.n

    def get_item(self, index: int, rng) -> Dict[str, np.ndarray]:
        h, w = self.shape
        r = np.random.default_rng(index)
        base = r.uniform(0, 255, (h, w + 4, self.channels)).astype(np.float32)
        return {
            "image1": base[:, 4:],
            "image2": base[:, :-4],
            "flow": np.full((h, w, 1), -4.0, np.float32),
            "valid": np.ones((h, w), np.float32),
        }


def make_validation_fn(
    model_config: RAFTStereoConfig,
    datasets,
    iters: int = 32,
    validator_kwargs: Dict[str, dict] | None = None,
    pad_bucket: int = 0,
):
    """An in-training validation hook: model -> metrics for each named
    validator. `model_config` is the configuration the hook evaluates; it
    must be the model's. One Evaluator is reused across rounds."""
    evaluator = Evaluator(None, iters=iters, pad_bucket=pad_bucket)
    validator_kwargs = validator_kwargs or {}

    def validate(model: RAFTStereo) -> Dict[str, float]:
        if model.config != model_config:
            raise ValueError(f"model config {model.config} is not the validation config {model_config}")
        evaluator.model = model
        results: Dict[str, float] = {}
        for name in datasets:
            results.update(VALIDATORS[name](evaluator, **validator_kwargs.get(name, {})))
        return results

    def set_heartbeat(fn) -> None:
        """Wire a per-image liveness callback."""
        evaluator.heartbeat = fn

    validate.set_heartbeat = set_heartbeat
    return validate
