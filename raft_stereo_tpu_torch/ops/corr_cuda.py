"""The "pallas" correlation strategy on CUDA: counterpart of
`raft_stereo_tpu/ops/corr_pallas.py` (state build and fused lookup).

`corr_state` builds the unpadded pyramid once per forward; the 128-lane
padded layout of the TPU state is not carried over, only its values.
`corr_lookup` samples every level in one launch of the hand-written kernel
`csrc/corr_lookup.cu` for CUDA tensors, and runs the plain version
(`ops/corr.py` `corr_lookup`) for CPU tensors. There is no other route: a
CUDA tensor the kernel cannot take raises.

Inference only: the lookup's backward (the JAX package's `_scatter_kernel`)
is not ported yet, so the wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from raft_stereo_tpu_torch.ops import _build, corr

# Kernel launches since the last reset; chip_smoke.py reads it to prove the
# serving path went through the kernel.
LAUNCHES = {"corr_lookup": 0}
MAX_LEVELS = 8  # csrc/corr_lookup.cu MAX_LEVELS


def corr_state(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """fmap1 (B, H, W1, D), fmap2 (B, H, W2, D) -> the L contiguous fp32
    pyramid levels (B, H, W1, W2 // 2**l)."""
    return tuple(corr.corr_pyramid(corr.corr_volume(fmap1, fmap2), levels))


def _lib():
    lib = _build.load("corr_lookup")
    fn = lib.raft_corr_lookup_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # coords
            ctypes.c_void_p,  # host array of level pointers
            ctypes.c_void_p,  # host array of level widths (int32)
            ctypes.c_int,  # num_levels
            ctypes.c_longlong,  # n_queries
            ctypes.c_int,  # radius
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.raft_corr_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_error_string.restype = ctypes.c_char_p
    return lib


def corr_lookup(state: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Taps of every pyramid level around `coords` (B, H, W1):
    (B, H, W1, L*(2r+1)) fp32, level-major; zero outside [0, W2_l)."""
    if not coords.is_cuda:
        return corr.corr_lookup(state, coords, radius)
    levels = list(state)
    b, h, w1 = coords.shape
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"corr_lookup kernel takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    for t in (coords, *levels):
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("corr_lookup kernel needs contiguous fp32 tensors on one CUDA device")
        if t.requires_grad:
            raise ValueError("corr_lookup kernel has no backward yet; call it without grad")
    for lvl in levels:
        if lvl.dim() != 4 or tuple(lvl.shape[:3]) != (b, h, w1):
            raise ValueError(f"level shape {tuple(lvl.shape)} does not match coords {(b, h, w1)}")
    out = torch.empty((b, h, w1, len(levels) * (2 * radius + 1)), dtype=torch.float32, device=coords.device)
    ptrs = (ctypes.c_void_p * len(levels))(*[lvl.data_ptr() for lvl in levels])
    widths = (ctypes.c_int * len(levels))(*[lvl.shape[-1] for lvl in levels])
    lib = _lib()
    status = lib.raft_corr_lookup_f32(
        coords.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p),
        len(levels),
        b * h * w1,
        radius,
        out.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, "corr_lookup kernel", lib.raft_corr_error_string)
    LAUNCHES["corr_lookup"] += 1
    return out
