"""PyTorch + CUDA port of raft_stereo_tpu for NVIDIA Hopper (H100).

The JAX package `raft_stereo_tpu` is the reference; this package imports
nothing from it and never imports JAX. Entry points take a `device`
argument that defaults to "cuda"; pass device="cpu" to run the plain
PyTorch versions of the kernels (the tests do).
"""

from raft_stereo_tpu_torch.config import RAFTStereoConfig, ServeConfig

__all__ = ["RAFTStereoConfig", "ServeConfig"]
