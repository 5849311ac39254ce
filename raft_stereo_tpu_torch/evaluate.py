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
between kernels (`profile_stages` separates device time). A validator
reads its dataset from `root` (data/datasets.py, the JAX package's
defaults), or takes a dataset object (`SyntheticEvalDataset`, or any
object with `__len__` and `get_item(index, rng)` returning the item
dict).

The Evaluator runs the model in its own configuration: a
`mixed_precision` model takes the fp32 images and returns fp32 flows, its
forward in bf16. `corr_precision` measures the bf16 pyramid's EPE delta
against the fp32 one in the budget's regime (`BF16_CORR_EPE_BUDGET_PX`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.corr import BF16_CORR_EPE_BUDGET_PX
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
        # A banded model (parallel/spatial.py, validation inside a spatial
        # run) takes this rank's band of the padded images and gathers the
        # whole flow on every rank of its group; with `fused_encoder` its
        # test-mode forward runs the fused layer1 and the pyramid kernel
        # on the band.
        whole = getattr(self.model, "forward_whole", None)
        with torch.no_grad():
            _sync(device)
            start = time.perf_counter()
            if whole is not None:
                _, up = whole(i1, i2, iters=self.iters)
            else:
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


def validate_eth3d(evaluator: Evaluator, dataset=None, root="datasets/ETH3D") -> Dict[str, float]:
    from raft_stereo_tpu_torch.data.datasets import ETH3D

    dataset = dataset if dataset is not None else ETH3D(None, root=root)
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


def validate_kitti(evaluator: Evaluator, dataset=None, root="datasets/KITTI") -> Dict[str, float]:
    from raft_stereo_tpu_torch.data.datasets import KITTI

    dataset = dataset if dataset is not None else KITTI(None, root=root, image_set="training")
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


def validate_things(evaluator: Evaluator, dataset=None, root="datasets") -> Dict[str, float]:
    from raft_stereo_tpu_torch.data.datasets import SceneFlowDatasets

    dataset = (dataset if dataset is not None
               else SceneFlowDatasets(None, root=root, dstype="frames_finalpass", things_test=True))
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


def validate_middlebury(evaluator: Evaluator, dataset=None, split="F", root="datasets/Middlebury") -> Dict[str, float]:
    from raft_stereo_tpu_torch.data.datasets import Middlebury

    dataset = dataset if dataset is not None else Middlebury(None, root=root, split=split)
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


def synthetic_plane_pair(rng: np.random.Generator, h: int, w: int, max_disp: float = 8.0) -> Dict[str, np.ndarray]:
    """A stereo pair with known disparity: the first frame of
    `data.datasets.make_synthetic_sequence(rng, 1, h, w, max_disp)`, a
    smooth random texture under a tilted disparity plane of 0.5 to
    `max_disp` px. Item dict as the validators take it; every pixel valid."""
    from raft_stereo_tpu_torch.data.datasets import make_synthetic_sequence

    return make_synthetic_sequence(rng, 1, h, w, max_disp)[0]


def corr_precision(config: RAFTStereoConfig, seed: int = 0, device="cuda", shape: Tuple[int, int] = (128, 192),
                   iters: int = 2) -> Dict[str, float]:
    """The bf16 pyramid's accuracy against the fp32 pyramid in the regime of
    `ops/corr.py` `BF16_CORR_EPE_BUDGET_PX` (the JAX bench's
    `corr_precision` block): `config` with `corr_dtype` float32 and
    bfloat16 on the same seeded weights, each evaluated over `iters`
    iterations on `synthetic_plane_pair(default_rng(5), *shape)`.
    Returns both EPEs (px), their difference and the budget."""
    frame = synthetic_plane_pair(np.random.default_rng(5), *shape)
    epe = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(config, corr_dtype=dtype), seed=seed, device=device)
        flow, _ = Evaluator(model, iters=iters)(frame["image1"], frame["image2"])
        err = np.abs(flow - frame["flow"][..., 0]) * frame["valid"]
        epe[dtype] = float(err.sum() / frame["valid"].sum())
    return {"epe_fp32_px": epe["float32"], "epe_bf16_px": epe["bfloat16"],
            "delta_px": abs(epe["bfloat16"] - epe["float32"]), "budget_px": BF16_CORR_EPE_BUDGET_PX}


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
