"""Configuration of the PyTorch port: the fields the ported path reads.

A copy, not an import, of the matching parts of `raft_stereo_tpu/config.py`
(`RAFTStereoConfig`, `input_channels`, the modality constants, the serving
subset of `ServeConfig` and the training-step subset of `TrainConfig`): the
port runs on machines without JAX and imports nothing from the JAX package.
Defaults and validation match the original field for field.

`mixed_precision` and `corr_dtype` are ported for test-mode forwards
(inference, serving, evaluation) and for training (the JAX package's
shipping numerics: "pallas", bf16 compute, a bf16 pyramid, whose lookup's
backward is the bf16 scatter kernel). A bf16 configuration with the fused
GRU tail or the windowed lookup raises "not ported yet" at construction, and
a `mixed_precision` test-mode forward with the gate pair raises in the
model (their bf16 kernels come later); a training forward runs none of the
three, as in JAX.

Not yet ported, so not present: the `"alt"` correlation
strategy, `shared_backbone`, `sequential_encoder`, `encoder_s2d` (a TPU
layout; the port computes its values with the direct convs), every serving
option beyond the anytime engine's (batcher, fleet, AOT cache, streams),
every training option beyond one process's optimizer step (data,
augmentation, mesh, checkpoints, resilience beyond `nan_policy`
"raise"/"skip", logging sinks), the dataset readers (evaluation runs on
`evaluate.SyntheticEvalDataset` or a dataset object the caller passes) and
the demo.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Data modalities of the gated-stereo fork: "RGB" and "1 Passive Gated" are
# 3-channel, "All Gated" stacks 5 gated slices.
MODALITY_RGB = "RGB"
MODALITY_PASSIVE_GATED = "1 Passive Gated"
MODALITY_ALL_GATED = "All Gated"
MODALITIES = (MODALITY_RGB, MODALITY_PASSIVE_GATED, MODALITY_ALL_GATED)

# "reg" precomputes the pyramid and samples it with plain torch ops;
# "pallas" keeps the name of the JAX package's fused-lookup strategy and
# samples the same pyramid with the hand-written CUDA kernel
# (ops/corr_cuda.py).
CORR_IMPLEMENTATIONS = ("reg", "pallas")
CORR_DTYPES = ("float32", "bfloat16")
# Non-finite loss or gradient norm: "raise" fails the step; "skip" drops
# the update (params and optimizer state untouched) and goes on. The JAX
# package's third policy, "rollback", needs checkpoints and is not ported.
NAN_POLICIES = ("raise", "skip")


def input_channels(data_modality: str) -> int:
    """Encoder input channels per modality."""
    if data_modality not in MODALITIES:
        raise ValueError(f"unknown data_modality {data_modality!r}; expected one of {MODALITIES}")
    return 5 if data_modality == MODALITY_ALL_GATED else 3


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """Model architecture. `hidden_dims` is indexed coarsest-first:
    hidden_dims[2] is the finest (1/2**n_downsample) scale's width."""

    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    corr_implementation: str = "reg"
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    n_gru_layers: int = 3
    slow_fast_gru: bool = False
    data_modality: str = MODALITY_RGB
    # bf16 compute in the encoders and the update block, the JAX package's
    # dtype policy standing in for the reference's AMP autocast: parameters
    # stay fp32 and are cast at use, the images are normalized in fp32 and
    # then cast, the coordinates stay fp32, the lookup taps and the update
    # block's inputs are bf16, and the mask goes back to fp32 before the
    # convex upsample. Training keeps fp32 parameters, gradients and
    # optimizer state, and an fp32 loss on fp32 flows.
    mixed_precision: bool = False
    # Storage dtype of the correlation pyramid. "bfloat16" builds the volume
    # from bf16 operands with fp32 sums, divides by sqrt(D) in fp32 and
    # rounds once; each level is pooled from the stored bf16 level; the
    # lookup interpolates in fp32 either way (ops/corr.py).
    corr_dtype: str = "float32"
    # Run the GRU gate tail and the motion-encoder concat as the fused CUDA
    # kernels of ops/gru_tail.py (test-mode forwards only, as in JAX).
    fused_gru_tail: bool = False
    # Fused encoder prelude: the stem norm and both layer1 residual blocks
    # run as the CUDA conv and join kernels of ops/encoder_cuda.py (each
    # norm and relu folded into the next conv's operand read, the instance
    # statistics into its epilogue), and with "pallas" the correlation
    # volume and pyramid are built in one kernel (ops/corr_cuda.py
    # `fused_pyramid_state`). Applies where the JAX package's does: even W
    # at stem resolution, instance or batch norm. Test-mode forwards only,
    # as in JAX (`fused = cfg.fused_encoder and test_mode`): the kernels
    # have no backward, so a training forward takes the direct path.
    fused_encoder: bool = False
    # Windowed correlation lookup (ops/corr_cuda.py `prefetch_corr_lookup`,
    # csrc/corr_prefetch.cu): the same taps as the dense lookup, bit for
    # bit, with each query's window of every level staged in shared memory
    # so each pyramid sample is read from memory once. "pallas" only.
    # Test-mode forwards only, as in JAX (`prefetch=cfg.prefetch_lookup and
    # test_mode`): the kernel has no backward, so training keeps the dense
    # lookup and its scatter.
    prefetch_lookup: bool = False
    # Rematerialize each GRU iteration in the backward pass
    # (`torch.utils.checkpoint` of the iteration body): training memory
    # drops from O(iters * per-iteration activations) to O(iters * carry) at
    # the cost of one extra forward per iteration in backward. No effect on
    # test-mode forwards.
    remat_iterations: bool = True
    # With remat_iterations on, additionally SAVE the correlation-lookup
    # taps across the forward pass instead of recomputing them in backward
    # (the JAX package's "save_only_these_names" policy on the taps): the
    # lookup runs outside the checkpointed body, so its kernel runs once per
    # iteration. The taps are small, (B, L*(2r+1), H/2^K, W/2^K) per
    # iteration.
    remat_save_corr: bool = True

    @property
    def context_dims(self) -> Tuple[int, ...]:
        return self.hidden_dims

    @property
    def in_channels(self) -> int:
        return input_channels(self.data_modality)

    @property
    def downsample_factor(self) -> int:
        return 2**self.n_downsample

    @property
    def corr_channels(self) -> int:
        """Motion-encoder corr input planes: levels * (2r+1)."""
        return self.corr_levels * (2 * self.corr_radius + 1)

    def __post_init__(self):
        if self.corr_implementation not in CORR_IMPLEMENTATIONS:
            raise ValueError(
                f"corr_implementation {self.corr_implementation!r} not in {CORR_IMPLEMENTATIONS}"
            )
        if not 1 <= self.n_gru_layers <= 3:
            raise ValueError("n_gru_layers must be in [1, 3]")
        if len(self.hidden_dims) != 3:
            raise ValueError("hidden_dims must have 3 entries (coarse, mid, fine)")
        if self.data_modality not in MODALITIES:
            raise ValueError(f"unknown data_modality {self.data_modality!r}")
        if self.corr_dtype not in CORR_DTYPES:
            raise ValueError(f"corr_dtype must be float32 or bfloat16, got {self.corr_dtype!r}")
        unported = []
        if self.mixed_precision and self.fused_gru_tail:
            unported.append("fused_gru_tail")
        if (self.mixed_precision or self.corr_dtype == "bfloat16") and self.prefetch_lookup:
            unported.append("prefetch_lookup")
        if unported:
            raise ValueError(f"not ported yet: {' and '.join(unported)} with "
                             f"{'mixed_precision' if self.mixed_precision else 'corr_dtype=bfloat16'} "
                             "(their bf16 kernels are still to come)")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The anytime engine's part of the serving config.

    Every (bucket, batch) combination is warmed at boot; admission maps a
    request onto the smallest bucket that fits. Refinement runs in chunks
    of `chunk_iters`; `max_iters` is rounded up to whole chunks.
    """

    model: RAFTStereoConfig = dataclasses.field(default_factory=RAFTStereoConfig)
    buckets: Tuple[Tuple[int, int], ...] = ((384, 512), (512, 768))
    max_batch: int = 4
    chunk_iters: int = 4
    max_iters: int = 32
    # Default per-request deadline; requests may override. 0 disables.
    deadline_ms: float = 0.0
    # 1/4-res disparity plus three 1/8..1/32 context scales below it.
    divis_by: int = 32

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        for hw in self.buckets:
            if len(hw) != 2 or hw[0] % self.divis_by or hw[1] % self.divis_by:
                raise ValueError(
                    f"bucket {hw} must be (H, W) with both multiples of "
                    f"divis_by ({self.divis_by})"
                )
        if len(set(self.buckets)) != len(self.buckets):
            raise ValueError(f"duplicate buckets in {self.buckets}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {self.chunk_iters}")
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if self.deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {self.deadline_ms}")

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        """Warmed batch sizes: powers of two up to and including max_batch."""
        sizes = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)
        return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training step's part of the training config (the JAX package's
    `TrainConfig`, reference train_stereo.py:234-272): model, batch,
    optimizer, schedule, loss and the non-finite policy. Every model
    configuration trains, fp32 or bf16: `RAFTStereoConfig(corr_implementation=
    "pallas", mixed_precision=True, corr_dtype="bfloat16")` is the JAX
    package's shipping training numerics."""

    model: RAFTStereoConfig = dataclasses.field(default_factory=RAFTStereoConfig)
    batch_size: int = 6
    lr: float = 2e-4
    num_steps: int = 100_000
    train_iters: int = 16
    wdecay: float = 1e-5
    # Loss (train_stereo.py:35-70).
    loss_gamma: float = 0.9
    max_flow: float = 700.0
    grad_clip_norm: float = 1.0
    seed: int = 1234
    nan_policy: str = "raise"
    # Steps between metric lines that `Trainer.fit` logs.
    log_every: int = 100

    def __post_init__(self):
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy {self.nan_policy!r} not in {NAN_POLICIES}")
