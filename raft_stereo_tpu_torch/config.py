"""Configuration of the PyTorch port: the fields the ported path reads.

A copy, not an import, of the matching parts of `raft_stereo_tpu/config.py`
(`RAFTStereoConfig`, `input_channels`, the modality constants, the serving
subset of `ServeConfig` and the training-step subset of `TrainConfig`): the
port runs on machines without JAX and imports nothing from the JAX package.
Defaults and validation match the original field for field.

`mixed_precision` and `corr_dtype` are ported for test-mode forwards
(inference, serving, evaluation) and for training (the JAX package's
shipping numerics: "pallas", bf16 compute, a bf16 pyramid, whose lookup's
backward is the bf16 scatter kernel). The test-mode levers run at bf16 as
at fp32: `fused_gru_tail`, `prefetch_lookup` and the gate pair
(`RAFT_STEREO_TPU_PALLAS_GATES=1`) take their kernels' bf16 forms; a
training forward runs none of the three, as in JAX. `shared_backbone` is
ported: the context encoder's trunk runs on both images and a residual
block and a conv on its output give the correlation features (the
reference's realtime model, with `n_downsample=3`, `n_gru_layers=2`,
`slow_fast_gru`).

Not yet ported, so not present: the `"alt"` correlation
strategy, `sequential_encoder` (and the JAX package's
`sequential_batch_forward`), `encoder_s2d` (a TPU
layout; the port computes its values with the direct convs), the serving
fleet and its options (`replicas`, `auto_respawn`, `sharding_rules`), the
AOT executable cache (`aot_cache_dir`) and the HLO audit (`hlo_audit`),
every training option beyond one process's optimizer step (data,
augmentation, mesh, checkpoints, resilience beyond `nan_policy`
"raise"/"skip", logging sinks), the dataset readers (evaluation runs on
`evaluate.SyntheticEvalDataset` or a dataset object the caller passes) and
the demo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    # One trunk for both encoders (models/raft_stereo.py `encode_features`):
    # the context encoder's trunk runs on [image1, image2], its heads on
    # image1's half, and `conv2_res` + `conv2_out` turn the whole trunk
    # output into the correlation features; no `fnet` is built.
    shared_backbone: bool = False
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


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Stream session policy (video/session.py; `ServeConfig.video`).

    A stream carries the previous frame's low-res flow and warm-starts the
    next frame through the prelude's `flow_init`, so warm frames reach the
    cold-start error in fewer GRU iterations. A host-side proxy, the
    photometric warp error of the candidate flow on the new pair at 1/4
    resolution, gates the warm start: a scene cut resets the stream to a
    cold start instead of refining from a wrong prior.
    """

    # Warm-start at all. False degrades every frame to a cold start.
    warm_start: bool = True
    # Also carry the ConvGRU hidden state across frames (StreamSession
    # only: it swaps state["net"] between prelude and first chunk).
    carry_hidden: bool = False
    # GRU iterations per chunk for the standalone StreamSession; serving
    # streams use ServeConfig.chunk_iters, which must agree.
    chunk_iters: int = 4
    # Refinement budget for cold frames (frame 0, frames after a reset).
    cold_iters: int = 32
    # Refinement budget for warm-started frames.
    warm_iters: int = 8
    # Reset when the candidate flow's warp error on the new pair exceeds
    # `reset_error_ratio` x the error the same flow reached on its own
    # frame AND `reset_error_floor` (mean |I1 - warp(I2)| in [0, 255]
    # intensity units; the floor keeps near-perfect warps from tripping the
    # ratio on noise).
    reset_error_ratio: float = 2.5
    reset_error_floor: float = 4.0

    def __post_init__(self):
        if self.chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {self.chunk_iters}")
        if self.cold_iters < 1:
            raise ValueError(f"cold_iters must be >= 1, got {self.cold_iters}")
        if self.warm_iters < 1:
            raise ValueError(f"warm_iters must be >= 1, got {self.warm_iters}")
        if self.warm_iters > self.cold_iters:
            raise ValueError(
                f"warm_iters ({self.warm_iters}) must be <= cold_iters ({self.cold_iters}) — warm "
                "start exists to spend FEWER iterations"
            )
        if self.reset_error_ratio <= 0:
            raise ValueError(f"reset_error_ratio must be > 0, got {self.reset_error_ratio}")
        if self.reset_error_floor < 0:
            raise ValueError(f"reset_error_floor must be >= 0, got {self.reset_error_floor}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving config (serving/ package).

    Every (bucket, batch) combination is warmed at boot; admission maps a
    request onto the smallest bucket that fits. Refinement runs in chunks
    of `chunk_iters`; `max_iters` is rounded up to whole chunks. The JAX
    package's fleet, sharding, AOT-cache and HLO-audit fields are not
    ported (the `serve` flags for them exit 2).
    """

    model: RAFTStereoConfig = dataclasses.field(default_factory=RAFTStereoConfig)
    buckets: Tuple[Tuple[int, int], ...] = ((384, 512), (512, 768))
    max_batch: int = 4
    chunk_iters: int = 4
    max_iters: int = 32
    # Default per-request deadline; requests may override. 0 disables.
    deadline_ms: float = 0.0
    # How long the batcher waits for a partial batch to fill before
    # dispatching it anyway.
    batch_window_ms: float = 2.0
    # 1/4-res disparity plus three 1/8..1/32 context scales below it.
    divis_by: int = 32
    host: str = "127.0.0.1"
    port: int = 8080
    # The reference's .pth the served weights come from (None: seeded
    # random weights).
    restore_ckpt: Optional[str] = None
    # Stream sessions. None = plain per-request serving; a VideoConfig
    # admits `submit_stream` / HTTP "stream_id" and makes warm() also run
    # the flow_init prelude per (bucket, batch).
    video: Optional[VideoConfig] = None
    # Live stream sessions kept; the least recently used beyond this are
    # evicted (their next frame cold-starts).
    max_streams: int = 1024
    # Breaker (serving/lifecycle.py): consecutive batch failures that mark
    # the service degraded (still admitting) and failed (shedding with 503
    # until a checkpoint swap or a restart); consecutive successes that take
    # a degraded service back to healthy.
    breaker_degrade_after: int = 2
    breaker_fail_after: int = 5
    breaker_probation: int = 2
    # Per-batch hang watchdog: a chunk with no heartbeat for this long
    # dumps every thread's stack and fails the service (the process stays
    # up to answer /healthz). 0 disables.
    hang_timeout_s: float = 0.0
    # Budget of service.drain(): how long a graceful shutdown waits for
    # queued and running requests before closing anyway.
    drain_timeout_s: float = 30.0
    # Where the flight recorder dumps flight_recorder.json (breaker moves,
    # watchdog fires, close). None disables dumps.
    log_dir: Optional[str] = None
    # Flight-recorder ring capacity (spans and events); 0 disables it.
    flight_recorder_events: int = 512

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
        if self.batch_window_ms < 0:
            raise ValueError(f"batch_window_ms must be >= 0, got {self.batch_window_ms}")
        if self.max_streams < 1:
            raise ValueError(f"max_streams must be >= 1, got {self.max_streams}")
        if not 1 <= self.breaker_degrade_after <= self.breaker_fail_after:
            raise ValueError(
                f"need 1 <= breaker_degrade_after ({self.breaker_degrade_after}) <= "
                f"breaker_fail_after ({self.breaker_fail_after})"
            )
        if self.breaker_probation < 1:
            raise ValueError(f"breaker_probation must be >= 1, got {self.breaker_probation}")
        if self.hang_timeout_s < 0:
            raise ValueError(f"hang_timeout_s must be >= 0, got {self.hang_timeout_s}")
        if self.drain_timeout_s < 0:
            raise ValueError(f"drain_timeout_s must be >= 0, got {self.drain_timeout_s}")
        if self.flight_recorder_events < 0:
            raise ValueError(
                f"flight_recorder_events must be >= 0, got {self.flight_recorder_events}"
            )
        if self.video is not None:
            if self.video.chunk_iters != self.chunk_iters:
                raise ValueError(
                    f"video.chunk_iters ({self.video.chunk_iters}) must match serving "
                    f"chunk_iters ({self.chunk_iters}): stream frames run through the same chunks"
                )
            if self.video.warm_iters > self.max_iters:
                raise ValueError(
                    f"video.warm_iters ({self.video.warm_iters}) must be <= max_iters ({self.max_iters})"
                )

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
