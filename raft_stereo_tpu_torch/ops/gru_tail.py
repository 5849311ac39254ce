"""Fused ConvGRU gate tail and motion-encoder tail (config.fused_gru_tail):
counterpart of `raft_stereo_tpu/ops/gru_tail_pallas.py`.

    tail:   h' = (1 - z) * h + z * tanh(qx + cq),  z = sigmoid(zx + cz)
    motion: cat[relu(pre), flow, zeros] on the channel axis -> 128 channels

Each wrapper launches its kernel from `csrc/gru_tail.cu` for CUDA tensors and
runs its plain version for CPU tensors; a CUDA tensor the kernel cannot take
raises. The two kernels share one CUDA source with the correlation lookup's
build path (ops/_build.py): Triton would serve these elementwise passes
too, but one nvcc route keeps a single builder and loader for every kernel
of the port. Test-mode only, as in JAX: no backward.

Layout: `fused_gru_tail` is elementwise over five tensors of one shape;
`fused_motion_tail` takes NCHW `pre` (B, 126, H, W) and `flow` (B, 1, H, W).
"""

from __future__ import annotations

import ctypes

import torch

from raft_stereo_tpu_torch.ops import _build

# Kernel launches since the last reset; chip_smoke.py reads them to prove
# the serving path went through the kernels.
LAUNCHES = {"gru_tail": 0, "motion_tail": 0}


def plain_gru_tail(zx, cz, qx, cq, h):
    """The plain PyTorch version of the tail kernel."""
    z = torch.sigmoid(zx + cz)
    q = torch.tanh(qx + cq)
    return (1.0 - z) * h + z * q


def plain_motion_tail(pre, flow):
    """The plain PyTorch version of the motion-tail kernel (NCHW)."""
    return torch.cat([torch.relu(pre), flow, torch.zeros_like(flow)], dim=1)


def _lib():
    lib = _build.load("gru_tail")
    if lib.raft_gru_tail_f32.argtypes is None:
        lib.raft_gru_tail_f32.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.raft_gru_tail_f32.restype = ctypes.c_int
        lib.raft_motion_tail_f32.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.raft_motion_tail_f32.restype = ctypes.c_int
        lib.raft_gru_tail_error_string.argtypes = [ctypes.c_int]
        lib.raft_gru_tail_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name, tensors, device):
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous fp32 tensors on one CUDA device")
        if t.requires_grad:
            raise ValueError(f"{name} kernel has no backward; call it without grad")


def _aligned(tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def fused_gru_tail(zx, cz, qx, cq, h):
    """h' = (1 - z) h + z tanh(qx + cq), z = sigmoid(zx + cz), one pass."""
    if not h.is_cuda:
        return plain_gru_tail(zx, cz, qx, cq, h)
    ops = (zx, cz, qx, cq, h)
    if any(t.shape != h.shape for t in ops):
        raise ValueError(f"fused_gru_tail operands differ in shape: {[tuple(t.shape) for t in ops]}")
    _check_operands("fused_gru_tail", ops, h.device)
    out = torch.empty_like(h)
    n = h.numel()
    vec = int(n % 4 == 0 and _aligned((*ops, out)))
    lib = _lib()
    status = lib.raft_gru_tail_f32(
        *[t.data_ptr() for t in ops], out.data_ptr(), n, vec,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(status, "fused_gru_tail kernel", lib.raft_gru_tail_error_string)
    LAUNCHES["gru_tail"] += 1
    return out


def fused_motion_tail(pre, flow):
    """cat[relu(pre), flow, zeros_like(flow)] along channels, one pass:
    pre (B, C, H, W), flow (B, 1, H, W) -> (B, C + 2, H, W)."""
    if not pre.is_cuda:
        return plain_motion_tail(pre, flow)
    b, c, h, w = pre.shape
    if tuple(flow.shape) != (b, 1, h, w):
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match pre {tuple(pre.shape)}")
    _check_operands("fused_motion_tail", (pre, flow), pre.device)
    out = torch.empty((b, c + 2, h, w), dtype=torch.float32, device=pre.device)
    hw = h * w
    vec = int(hw % 4 == 0 and _aligned((pre, flow, out)))
    lib = _lib()
    status = lib.raft_motion_tail_f32(
        pre.data_ptr(), flow.data_ptr(), out.data_ptr(), b, c, hw, vec,
        torch.cuda.current_stream(pre.device).cuda_stream,
    )
    _build.check(status, "fused_motion_tail kernel", lib.raft_gru_tail_error_string)
    LAUNCHES["motion_tail"] += 1
    return out
