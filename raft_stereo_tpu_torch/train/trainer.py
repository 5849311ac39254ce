"""The training step and a minimal loop: counterpart of the core of
`raft_stereo_tpu/train/trainer.py` (`create_train_state`,
`make_train_step`, the step loop of `Trainer.fit`).

One process, one device. `Trainer.train_step` takes one optimizer step on a
host batch and returns the JAX step's metrics dict; `Trainer.fit` iterates
host batches, re-iterating the data when it runs out. Frozen batch norm is
structural here as in the JAX package: `FrozenBatchNorm` never consumes
batch statistics, so only its scale and bias train.

Under `nan_policy="skip"` a non-finite loss or gradient norm leaves the
parameters and the optimizer's state (moments and count) untouched while
the trainer's step count advances, as the JAX step keeps its old params and
opt_state; `learning_rate` in the metrics is the schedule at the trainer's
step, as in JAX. Under "raise" the step raises `NonFiniteLossError` before
any update lands.

Mixed precision trains as in JAX (`RAFTStereoConfig(corr_implementation=
"pallas", mixed_precision=True, corr_dtype="bfloat16")`, the JAX package's
shipping numerics): bf16 compute and pyramid, with parameters, gradients,
clipping, the AdamW state and the loss in fp32 (the layers cast the fp32
parameters at use, so their gradients come back fp32) and no loss scaling.

Not ported yet: checkpoints and resume, `nan_policy="rollback"`, the
watchdog, the multi-host coordinator, data loading and augmentation,
validation hooks, metric sinks, data parallelism.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.train.loss import sequence_loss
from raft_stereo_tpu_torch.train.optimizer import make_optimizer

logger = logging.getLogger(__name__)


class NonFiniteLossError(RuntimeError):
    """Training produced a NaN/Inf loss or gradient norm under
    nan_policy="raise"."""


class Trainer:
    """Owns the model, the optimizer and schedule, and the step count.

    `sample_shape` is (H, W, C) of one training image; every batch must
    have it. The model's weights are drawn from `config.seed`
    (`models/init.build_model`)."""

    def __init__(self, config: TrainConfig, sample_shape: Tuple[int, int, int], device="cuda"):
        if sample_shape[2] != config.model.in_channels:
            raise ValueError(f"sample_shape {tuple(sample_shape)} has {sample_shape[2]} channels; "
                             f"the model takes {config.model.in_channels}")
        self.config = config
        self.sample_shape = tuple(sample_shape)
        self.device = torch.device(device)
        self.model = build_model(config.model, seed=config.seed, device=self.device)
        self.optimizer, self.schedule = make_optimizer(
            list(self.model.parameters()), config.lr, config.num_steps, config.wdecay, config.grad_clip_norm
        )
        self.step = 0

    def _device_batch(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        b = self.config.batch_size
        h, w, c = self.sample_shape
        want = {"image1": (b, h, w, c), "image2": (b, h, w, c), "flow": (b, h, w, 1), "valid": (b, h, w)}
        out = {}
        for key, shape in want.items():
            t = torch.as_tensor(batch[key])
            if tuple(t.shape) != shape:
                raise ValueError(f"batch[{key!r}] has shape {tuple(t.shape)}, expected {shape}")
            out[key] = t.to(device=self.device, dtype=torch.float32)
        return out

    def train_step(self, batch: Mapping[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a host batch: image1/image2 (B, H, W, C) in
        [0, 255], flow (B, H, W, 1), valid (B, H, W). Returns epe, 1px, 3px,
        5px, live_loss, grad_norm (before clipping), nonfinite (1.0 when the
        loss or the norm was NaN/Inf) and learning_rate (the schedule at
        this step)."""
        cfg = self.config
        b = self._device_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        flows = self.model(b["image1"], b["image2"], iters=cfg.train_iters)
        loss, metrics = sequence_loss(flows, b["flow"], b["valid"], cfg.loss_gamma, cfg.max_flow)
        loss.backward()
        grad_norm = self.optimizer.clip_grads_()
        values = torch.stack([*metrics.values(), loss.detach(), grad_norm]).tolist()
        finite = bool(np.isfinite(values[-2]) and np.isfinite(values[-1]))
        if finite:
            self.optimizer.step()
        elif cfg.nan_policy == "raise":
            raise NonFiniteLossError(f"non-finite loss/grad_norm at step {self.step} (nan_policy=raise)")
        out = dict(zip(metrics, values))
        out.update(live_loss=values[-2], grad_norm=values[-1], nonfinite=0.0 if finite else 1.0,
                   learning_rate=self.schedule(self.step))
        self.step += 1
        return out

    def fit(self, data: Iterable[Mapping[str, np.ndarray]], num_steps: Optional[int] = None) -> Dict[str, float]:
        """Step until the trainer's step count reaches `num_steps` (default
        `config.num_steps`) over `data`, an iterable of host batches that is
        iterated again whenever it runs out (the reference's epoch-wrapping
        loop). Logs the metrics every `config.log_every` steps and returns
        the last step's."""
        total = self.config.num_steps if num_steps is None else num_steps
        it = iter(data)
        metrics: Dict[str, float] = {}
        while self.step < total:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(data)
                try:
                    batch = next(it)
                except StopIteration:
                    raise ValueError("fit: the data yielded no batch") from None
            metrics = self.train_step(batch)
            if self.step % self.config.log_every == 0 or self.step == total:
                logger.info("step %d: %s", self.step,
                            ", ".join(f"{k} {v:.6g}" for k, v in metrics.items()))
        return metrics
