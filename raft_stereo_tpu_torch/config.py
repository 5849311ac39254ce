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

`TrainConfig` is the JAX package's whole training config (with
`CameraConfig` and `AugmentConfig`), defaults and validation included,
plus the port's own check of a spatial axis above 1 (the band rule,
`band_shape_problem`, under every preset, fsdp included). The
fields the training loop does not act on keep their JAX names and
defaults, and the `train` command line refuses any other value with exit
2 (`UNPORTED_TRAIN_DEFAULTS`): `strict_mode`, `recompile_grace` and
`compilation_cache_dir`.

The `"alt"` correlation strategy and `sequential_encoder` (with
`models.raft_stereo.sequential_batch_forward`) are ported; `ServeConfig`
has the fleet's `replicas` and `auto_respawn`, and `FrontierConfig` is the
JAX package's, field for field (the front tier, serving/frontier.py).

Not yet ported, so not present: `encoder_s2d` (a TPU layout; the port
computes its values with the direct convs), the AOT executable cache
(`aot_cache_dir`) and the HLO audit (`hlo_audit`).
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
# "alt" never builds the volume: it samples the pooled right-image features
# at the taps and dots them with the left ones (plain torch ops, as the JAX
# package's is plain XLA; `corr_dtype` does not apply); "pallas" keeps the
# name of the JAX package's fused-lookup strategy and samples the "reg"
# pyramid with the hand-written CUDA kernel (ops/corr_cuda.py).
CORR_IMPLEMENTATIONS = ("reg", "alt", "pallas")
CORR_DTYPES = ("float32", "bfloat16")
# Non-finite loss or gradient norm: "raise" fails the step; "skip" drops
# the update (params and optimizer state untouched) and goes on;
# "rollback" also restores the last good checkpoint after `nan_patience`
# consecutive bad steps (utils/resilience.py NonFiniteGuard).
NAN_POLICIES = ("raise", "skip", "rollback")
# Loader reaction to a sample that keeps failing decode (data/loader.py).
SAMPLE_POLICIES = ("raise", "quarantine")
# The JAX package's sharding rule presets (parallel/sharding.py); the
# mesh's axis sizes decide what runs: a spatial preset on an (n, 1) mesh is
# dp, as in JAX.
SHARDING_PRESETS = ("dp", "spatial", "dp+spatial", "fsdp")


def band_shape_problem(height: int, spatial: int, n_downsample: int):
    """The band rule of parallel/spatial.py: None when an image of `height`
    rows splits into `spatial` row bands (it divides by spatial *
    2**n_downsample, with at least 3 rows per band at 1/2**n_downsample,
    the halo of the motion encoder's 7x7 conv), else what is wrong and the
    height to use."""
    if spatial <= 1:
        return None
    unit = spatial * 2**n_downsample
    least = 3 * unit
    if height % unit == 0 and height >= least:
        return None
    want = max(least, -(-height // unit) * unit)
    return (f"image height {height} does not split into {spatial} row bands: it must divide by "
            f"spatial x 2**n_downsample = {unit} and be at least {least} (3 rows per band at "
            f"1/{2**n_downsample} resolution, the 7x7 motion conv's halo); use a height of {want}")


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
    # Run the feature encoder one image at a time (ignored under
    # `shared_backbone`, as in JAX): at B=1 on image1 and then on image2
    # plus a 1e-30-scaled element of image1's features (the JAX package's
    # data dependency that frees image1's trunk first; kept so the values
    # are JAX's), at B >= 2 over [image1, image2] row by row. Peak memory
    # is one image's trunk whatever the batch; the parameters are fnet's.
    sequential_encoder: bool = False
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
    package's AOT-cache and HLO-audit fields are not ported (the `serve`
    flags for them exit 2). `sharding_rules` is JAX's: every preset but dp
    (fsdp included) maps to a row-band mesh over the visible devices, and
    with one visible device the plain engine serves (as JAX's does;
    /healthz says so).
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
    # Engine replicas (serving/fleet.EngineFleet), one per card by default:
    # each holds its own copy of the weights, its own breaker and watchdog,
    # so one hung or failing replica is one fault domain and its batch is
    # requeued onto another. 1 keeps the single-engine path.
    replicas: int = 1
    # A `SHARDING_PRESETS` name, as in JAX (serving/engine.py: every preset
    # but dp serves row bands across the engine's devices, and unsharded on
    # one).
    sharding_rules: str = "dp"
    # Fleet self-healing: a replica whose breaker sticks `failed` is
    # replaced in the background by a fresh engine on the same device,
    # validated against the serving weights and entered in probation.
    # Requires replicas >= 2.
    auto_respawn: bool = False
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
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.sharding_rules not in SHARDING_PRESETS:
            raise ValueError(f"sharding_rules {self.sharding_rules!r} not in {SHARDING_PRESETS}")
        if self.auto_respawn and self.replicas < 2:
            raise ValueError(
                "auto_respawn requires replicas >= 2: respawn replaces one fleet replica while the others "
                "keep serving — a single engine has nothing to fail over to (restart it instead)"
            )
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
class FrontierConfig:
    """Front-tier router config (serving/frontier.py), a field-for-field
    copy of the JAX package's.

    The frontier is a stdlib HTTP process routing /predict across N
    backend `StereoService` hosts. It holds no model, no device and no
    carry state — only routing tables, per-backend breakers (the same
    `ServingLifecycle` machine the backends run) and counters — so a
    frontier restart loses nothing but stream pinnings (streams simply
    cold-start on their next frame).
    """

    # Backend addresses as "host:port" strings. Order is only a tiebreak:
    # routing prefers admissible backends with the fewest in-flight
    # requests.
    backends: Tuple[str, ...] = ()
    host: str = "127.0.0.1"
    port: int = 8081
    # Active health probing: every backend's /healthz is polled at this
    # interval; probe failures feed the same per-backend breaker as
    # forwarding failures, and probe successes are the ONLY thing that can
    # move a sticky-`failed` backend to probation (real traffic then earns
    # it back to healthy).
    health_interval_s: float = 2.0
    health_timeout_s: float = 5.0
    # Per-forward read timeout. Generous by default: a backend may be
    # queueing behind a large bucket; the deadline_ms inside the request
    # is the latency authority, this only bounds a wedged connection.
    request_timeout_s: float = 600.0
    # Retry policy for idempotent plain requests (streams never retry
    # blindly — they migrate, see frontier.py): attempts counts the total
    # tries, backoff is utils/retry.py's jittered exponential schedule.
    retry_attempts: int = 3
    retry_base_delay_s: float = 0.05
    retry_max_delay_s: float = 2.0
    retry_jitter: float = 0.5
    # Retry budget: retries are allowed while
    #   retries_total < retry_budget_min + retry_budget_percent% * requests
    # so a sick fleet can't melt itself with retry amplification, while a
    # cold frontier (zero requests yet) can still retry its first failure.
    retry_budget_percent: float = 20.0
    retry_budget_min: int = 10
    # Opt-in tail-latency hedging: after a plain request has been pending
    # for max(live queue-wait p95, hedge_floor_ms), dispatch a duplicate to
    # a DIFFERENT backend and take the first answer. Off by default —
    # hedging doubles work under exactly the load that makes tails long.
    hedge: bool = False
    hedge_floor_ms: float = 50.0
    # Overload brownout: when the worst backend queue-wait p95 crosses
    # brownout_queue_p95_ms (0 disables), the frontier tightens forwarded
    # requests — deadline_ms clamped to brownout_deadline_ms (if > 0) and
    # max_iters capped at brownout_max_iters (if > 0) — so the anytime
    # engines early-exit: quality degrades before ANY request is shed.
    # Hysteresis: brownout disengages only once the p95 falls below
    # threshold * brownout_recover_ratio.
    brownout_queue_p95_ms: float = 0.0
    brownout_deadline_ms: float = 0.0
    brownout_max_iters: int = 0
    brownout_recover_ratio: float = 0.5
    # Per-backend breaker thresholds (ServingLifecycle): forwarding/probe
    # failures degrade after N, fail after M; probation successes heal.
    breaker_degrade_after: int = 1
    breaker_fail_after: int = 3
    breaker_probation: int = 2
    # Graceful-shutdown budget: how long drain() waits for in-flight
    # forwards before closing anyway.
    drain_timeout_s: float = 30.0
    # Stream-session table ceiling (LRU eviction beyond it; an evicted
    # stream's next frame is routed fresh and cold-starts on its backend).
    max_sessions: int = 4096
    # Checkpoint rollout orchestration (POST /rollout, `frontier --rollout`):
    # the frontier rolls /reload across its backends one at a time —
    # quiesce, reload, verify (healthz generation advance + bit-wise canary
    # against the new-generation reference), probation — and aborts +
    # rolls already-swapped backends back on any failure.
    #
    # What happens to stream sessions pinned to the backend being swapped:
    #   "migrate" — the session moves to another backend immediately via
    #               the generation-aliased affinity path (guaranteed cold
    #               restart there);
    #   "hold"    — frames park until their host swaps back into rotation
    #               (carry survives; bounded by rollout_hold_timeout_s,
    #               after which the frame migrates anyway).
    rollout_stream_policy: str = "migrate"
    # Consecutive successful orchestrator probes (healthz on the NEW
    # generation) a swapped backend must pass before the roll proceeds.
    rollout_probation: int = 2
    # Per-backend budget for in-flight forwards to drain after quiesce.
    rollout_drain_timeout_s: float = 30.0
    # Budget for a swapped backend's /healthz to report the new generation.
    rollout_verify_timeout_s: float = 30.0
    # Ceiling on how long a request parks during the rollout flip window
    # (and a "hold"-policy stream frame waits for its host) before the
    # frontier gives up and sheds/migrates.
    rollout_hold_timeout_s: float = 60.0
    # Orchestrator probe cadence while verifying/probating one backend.
    rollout_probe_interval_s: float = 0.1
    # Flight recorder (obs/trace.py), same semantics as ServeConfig.
    log_dir: Optional[str] = None
    flight_recorder_events: int = 512

    def __post_init__(self):
        if not self.backends:
            raise ValueError("backends must be non-empty")
        if len(set(self.backends)) != len(self.backends):
            raise ValueError(f"duplicate backends in {self.backends}")
        for addr in self.backends:
            host, sep, port = str(addr).rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    f"backend {addr!r} must look like host:port"
                )
        if self.health_interval_s <= 0:
            raise ValueError(
                f"health_interval_s must be > 0, got {self.health_interval_s}"
            )
        if self.health_timeout_s <= 0:
            raise ValueError(
                f"health_timeout_s must be > 0, got {self.health_timeout_s}"
            )
        if self.request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0, got {self.request_timeout_s}"
            )
        if self.retry_attempts < 1:
            raise ValueError(
                f"retry_attempts must be >= 1, got {self.retry_attempts}"
            )
        if self.retry_base_delay_s < 0 or self.retry_max_delay_s < 0:
            raise ValueError("retry delays must be >= 0")
        if self.retry_budget_percent < 0:
            raise ValueError(
                f"retry_budget_percent must be >= 0, "
                f"got {self.retry_budget_percent}"
            )
        if self.retry_budget_min < 0:
            raise ValueError(
                f"retry_budget_min must be >= 0, got {self.retry_budget_min}"
            )
        if self.hedge_floor_ms < 0:
            raise ValueError(
                f"hedge_floor_ms must be >= 0, got {self.hedge_floor_ms}"
            )
        if self.brownout_queue_p95_ms < 0:
            raise ValueError(
                f"brownout_queue_p95_ms must be >= 0, "
                f"got {self.brownout_queue_p95_ms}"
            )
        if self.brownout_queue_p95_ms > 0 and not (
            self.brownout_deadline_ms > 0 or self.brownout_max_iters > 0
        ):
            raise ValueError(
                "brownout enabled (brownout_queue_p95_ms > 0) but no action "
                "knob set: need brownout_deadline_ms > 0 or "
                "brownout_max_iters > 0 — a brownout that tightens nothing "
                "is a no-op pretending to shed load"
            )
        if not 0 < self.brownout_recover_ratio <= 1:
            raise ValueError(
                f"brownout_recover_ratio must be in (0, 1], "
                f"got {self.brownout_recover_ratio}"
            )
        if not 1 <= self.breaker_degrade_after <= self.breaker_fail_after:
            raise ValueError(
                f"need 1 <= breaker_degrade_after "
                f"({self.breaker_degrade_after}) <= breaker_fail_after "
                f"({self.breaker_fail_after})"
            )
        if self.breaker_probation < 1:
            raise ValueError(
                f"breaker_probation must be >= 1, got {self.breaker_probation}"
            )
        if self.drain_timeout_s < 0:
            raise ValueError(
                f"drain_timeout_s must be >= 0, got {self.drain_timeout_s}"
            )
        if self.max_sessions < 1:
            raise ValueError(
                f"max_sessions must be >= 1, got {self.max_sessions}"
            )
        if self.rollout_stream_policy not in ("migrate", "hold"):
            raise ValueError(
                f"rollout_stream_policy must be 'migrate' or 'hold', "
                f"got {self.rollout_stream_policy!r}"
            )
        if self.rollout_probation < 1:
            raise ValueError(
                f"rollout_probation must be >= 1, got {self.rollout_probation}"
            )
        for knob in (
            "rollout_drain_timeout_s",
            "rollout_verify_timeout_s",
            "rollout_hold_timeout_s",
            "rollout_probe_interval_s",
        ):
            if getattr(self, knob) <= 0:
                raise ValueError(
                    f"{knob} must be > 0, got {getattr(self, knob)}"
                )
        if self.flight_recorder_events < 0:
            raise ValueError(
                "flight_recorder_events must be >= 0, "
                f"got {self.flight_recorder_events}"
            )


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Gated-stereo rig intrinsics, hardcoded in the reference
    (core/utils/frame_utils.py:127-128, demo.py:21-22)."""

    focal_px: float = 2840.562197
    baseline_m: float = 658.280549 / 2840.562197
    # Lidar-MAE valid depth range in meters (demo.py:28-29).
    min_depth_m: float = 3.0
    max_depth_m: float = 200.0


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Data-augmentation knobs (reference train_stereo.py:267-271 plus the
    aug-params assembly in core/stereo_datasets.py:500-514)."""

    crop_size: Tuple[int, int] = (320, 720)
    # Reference argparse default is --spatial_scale 0 0 (train_stereo.py:270);
    # the README training recipe uses `--spatial_scale -0.2 0.4`.
    min_scale: float = 0.0
    max_scale: float = 0.0
    do_flip: Optional[str] = None  # None | "h" (stereo swap) | "hf" | "v"
    yjitter: bool = True
    saturation_range: Optional[Tuple[float, float]] = None
    img_gamma: Optional[Tuple[float, float]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop config (reference train_stereo.py:234-272), the JAX
    package's field for field. Every model configuration trains, fp32 or
    bf16: `RAFTStereoConfig(corr_implementation="pallas",
    mixed_precision=True, corr_dtype="bfloat16")` is the JAX package's
    shipping training numerics."""

    model: RAFTStereoConfig = dataclasses.field(default_factory=RAFTStereoConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)

    name: str = "raft-stereo"
    batch_size: int = 6
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    lr: float = 2e-4
    num_steps: int = 100_000
    train_iters: int = 16
    valid_iters: int = 32
    wdecay: float = 1e-5
    # Loss (train_stereo.py:35-70).
    loss_gamma: float = 0.9
    max_flow: float = 700.0
    grad_clip_norm: float = 1.0
    seed: int = 1234
    # Checkpoint cadence (train_stereo.py:172).
    checkpoint_every: int = 500
    # Retention, as orbax's CheckpointManager prunes: keep the newest
    # `max_to_keep` steps and, with `keep_period`, also every step divisible
    # by it.
    max_to_keep: int = 5
    keep_period: Optional[int] = None
    # Crash-consistent auto-resume (utils/checkpoints.py): restore the newest
    # step of this run whose integrity manifest verifies, walking past (and
    # quarantining) torn steps, with the full run state; none starts fresh.
    auto_resume: bool = False
    # In-training validation cadence (train_stereo.py:172,208-210), active
    # when the trainer is given a validate_fn.
    validate_every: int = 500
    checkpoint_dir: str = "checkpoints"
    restore_ckpt: Optional[str] = None
    root_dataset: Optional[str] = None
    log_every: int = 100
    # (data, spatial) mesh over the ranks of a process group (-1 infers the
    # data axis from the world size) and the sharding rule preset
    # (parallel/sharding.py). A spatial axis above 1 runs row bands
    # (parallel/spatial.py): the crop height must follow the band rule.
    mesh_shape: Tuple[int, int] = (1, 1)
    sharding_rules: str = "dp"
    num_workers: int = 4
    # "thread" shares memory; "process" is the reference's worker model and
    # scales the numpy augment path past the GIL.
    worker_type: str = "thread"
    # Metrics (JSONL) land in log_dir with run_report.json; profile_steps > 0
    # writes a torch.profiler Chrome trace of that many steps after warm-up
    # into <log_dir>/profile (utils/profiling.py).
    log_dir: str = "runs"
    profile_steps: int = 0

    # --- resilience (utils/resilience.py) ---
    nan_policy: str = "raise"
    # Consecutive non-finite steps before skip escalates to an error or
    # rollback restores the last good checkpoint.
    nan_patience: int = 10
    # Host-side detection cadence in steps; None resolves to 1 (the port's
    # step reads its loss and norm on the host every step anyway).
    nan_check_every: Optional[int] = None
    # Pod coordination cadence in steps across ranks
    # (parallel/coordination.py); None resolves to nan_check_every.
    coord_interval: Optional[int] = None
    # Step watchdog: a step boundary that takes longer dumps every thread's
    # stack, writes run_report.json (stop_cause "watchdog") and exits 16.
    # 0 disables.
    step_timeout_s: float = 0.0
    # Extra allowance on the first interval (kernel builds, cuDNN autotune).
    watchdog_grace_s: float = 300.0
    # Retry with backoff (utils/retry.py) on checkpoint and frame I/O.
    io_retries: int = 3
    io_backoff: float = 0.5
    # Loader per-sample failure policy and budget (data/loader.py).
    sample_policy: str = "quarantine"
    sample_retries: int = 2
    failure_budget: float = 0.05
    # SIGTERM/SIGINT stop the run at the next step boundary with a final
    # checkpoint.
    handle_signals: bool = True

    # --- the JAX package's jit hygiene: not ported (no XLA compiles) ---
    strict_mode: bool = False
    recompile_grace: int = 2

    # --- training I/O spine ---
    # Commit checkpoints on a background thread (train/io_spine.py): the
    # snapshot stays on the step thread, at most one commit in flight.
    async_checkpoint: bool = False
    # Copy batch N+1 to the card on a side stream while step N runs
    # (data/prefetch.py).
    device_prefetch: bool = False

    # --- observability ---
    # Prometheus /metrics sidecar of the training loop on this port, rank 0
    # only (obs/prom.py serve_registry); 0 disables.
    metrics_port: int = 0
    # Flight-recorder ring capacity (obs/trace.py): dumped as
    # <log_dir>/flight_recorder.json on every fit() exit path.
    flight_recorder_events: int = 256
    # The JAX package's persistent XLA compilation cache: not ported.
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        if self.nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy {self.nan_policy!r} not in {NAN_POLICIES}")
        if self.sample_policy not in SAMPLE_POLICIES:
            raise ValueError(f"sample_policy {self.sample_policy!r} not in {SAMPLE_POLICIES}")
        if self.nan_patience < 1:
            raise ValueError(f"nan_patience must be >= 1, got {self.nan_patience}")
        if self.nan_check_every is not None and self.nan_check_every < 1:
            raise ValueError(f"nan_check_every must be >= 1, got {self.nan_check_every}")
        if self.coord_interval is not None and self.coord_interval < 1:
            raise ValueError(f"coord_interval must be >= 1, got {self.coord_interval}")
        if self.step_timeout_s < 0:
            raise ValueError(f"step_timeout_s must be >= 0, got {self.step_timeout_s}")
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {self.max_to_keep}")
        if self.keep_period is not None and self.keep_period < 1:
            raise ValueError(f"keep_period must be >= 1, got {self.keep_period}")
        if self.io_retries < 1:
            raise ValueError(f"io_retries must be >= 1, got {self.io_retries}")
        if self.recompile_grace < 0:
            raise ValueError(f"recompile_grace must be >= 0, got {self.recompile_grace}")
        if not 0.0 <= self.failure_budget <= 1.0:
            raise ValueError(f"failure_budget must be in [0, 1], got {self.failure_budget}")
        if self.sharding_rules not in SHARDING_PRESETS:
            raise ValueError(f"sharding_rules {self.sharding_rules!r} not in {SHARDING_PRESETS}")
        spatial = self.mesh_shape[1]
        if spatial > 1:
            problem = band_shape_problem(self.augment.crop_size[0], spatial, self.model.n_downsample)
            if problem is not None:
                raise ValueError(f"crop_size {tuple(self.augment.crop_size)}: {problem}")
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(f"metrics_port must be in [0, 65535], got {self.metrics_port}")
        if self.flight_recorder_events < 0:
            raise ValueError(f"flight_recorder_events must be >= 0, got {self.flight_recorder_events}")


# The fields the port's training loop does not act on yet, with the one
# value it runs (the JAX default): the `train` command line refuses any
# other with exit 2.
UNPORTED_TRAIN_DEFAULTS = {
    "strict_mode": False,
    "recompile_grace": 2,
    "compilation_cache_dir": None,
}


def finalize_train_config(config: TrainConfig) -> TrainConfig:
    """Resolve `nan_check_every` None to 1 (the JAX package resolves it per
    backend; the port's step already reads its loss on the host every
    step) and `coord_interval` None to `nan_check_every`, as JAX does.
    Idempotent."""
    if config.nan_check_every is not None and config.coord_interval is not None:
        return config
    nan_check = config.nan_check_every if config.nan_check_every is not None else 1
    coord = config.coord_interval if config.coord_interval is not None else nan_check
    return dataclasses.replace(config, nan_check_every=nan_check, coord_interval=coord)
