"""Configuration of the PyTorch port: the fields the ported path reads.

A copy, not an import, of the matching parts of `raft_stereo_tpu/config.py`
(`RAFTStereoConfig`, `input_channels`, the modality constants and the
serving subset of `ServeConfig`): the port runs on machines without JAX and
imports nothing from the JAX package. Defaults and validation match the
original field for field.

Not yet ported, so not present: `mixed_precision` and `corr_dtype` (the port
runs fp32 throughout), the `"alt"` correlation strategy, `shared_backbone`,
`sequential_encoder`, `fused_encoder`, `prefetch_lookup`, and every serving
option beyond the anytime engine's (batcher, fleet, AOT cache, streams).
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
    # Run the GRU gate tail and the motion-encoder concat as the fused CUDA
    # kernels of ops/gru_tail.py (test-mode forwards only, as in JAX).
    fused_gru_tail: bool = False

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
