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

Dtypes, the JAX kernels' contract: every operand fp32, or every operand
bf16 (mixed precision); the math is fp32 and the output is rounded once to
the operands' dtype (the tail's follows h, the motion tail's pre). So the
tail kernel's plain version, `plain_fused_gru_tail`, widens its operands,
computes `plain_gru_tail`'s formula in fp32 and rounds once; on fp32
operands it is `plain_gru_tail` itself. `plain_gru_tail` stays the unfused
ConvGRU's formula (models/update.py), which under bf16 rounds after every
op, so the fused and unfused bf16 forwards differ by those roundings. The
motion tail is exact in any dtype.

Layout: `fused_gru_tail` is elementwise over five tensors of one shape;
`fused_motion_tail` takes NCHW `pre` (B, 126, H, W) and `flow` (B, 1, H, W).

The operand check and the tail's grid (`stream_blocks`) are
ops/_build.py's, shared with the gate pair (ops/gates.py). The motion
tail's launch is `motion_tail_plan`: a grid over output planes that covers
every unit once.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raft_stereo_tpu_torch.ops import _build

# Kernel launches since the last reset; chip_smoke.py reads them to prove
# the serving path went through the kernels. The bf16 forms count apart.
LAUNCHES = {"gru_tail": 0, "motion_tail": 0, "gru_tail_bf16": 0, "motion_tail_bf16": 0}

# csrc/gru_tail.cu's motion tail: threads per block, the units a thread
# may move (largest first), the grid's y and z limits (channels, batch).
MOTION_THREADS = 256
MOTION_UNITS_PER_THREAD = (4, 2, 1)
MAX_GRID_YZ = 65535


class MotionTailPlan(NamedTuple):
    """A launch of the motion tail: units of `unit` elements (16 bytes'
    worth on the vector path, else 1), `per_thread` of them per thread,
    grid (`tiles`, C + 2, B) of MOTION_THREADS threads: block (x, c, b)
    covers units [x * MOTION_THREADS * per_thread, (x + 1) * ...) of output
    plane (b, c), thread t units t, t + MOTION_THREADS, ..."""

    unit: int
    per_thread: int
    tiles: int
    grid: tuple


def motion_tail_plan(b: int, c: int, hw: int, elem_bytes: int, sms: int, vec: bool = True) -> MotionTailPlan:
    """The motion tail's launch for pre (B, C, H*W = hw) of `elem_bytes`
    elements (4 fp32, 2 bf16) on a card of `sms` multiprocessors; `vec`:
    16-byte units (the wrapper's test: hw divides by the unit and the bases
    are aligned). A thread moves 4 units, or 2 or 1 where fewer would leave
    the grid under two blocks per multiprocessor (a small plane). Raises
    for a shape the grid cannot hold."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"motion tail kernel takes fp32 or bf16, got {elem_bytes}-byte elements")
    unit = 16 // elem_bytes if vec else 1
    if min(b, c, hw) < 0 or hw % unit:
        raise ValueError(f"motion tail kernel: bad shape B {b}, C {c}, H*W {hw} for {unit}-element units")
    if b > MAX_GRID_YZ or c + 2 > MAX_GRID_YZ or hw // unit > 2**31 - 1:
        raise ValueError(f"motion tail kernel: B {b}, C + 2 = {c + 2} or H*W {hw} exceed its grid")
    units = hw // unit
    for per_thread in MOTION_UNITS_PER_THREAD:
        tiles = -(-units // (MOTION_THREADS * per_thread))
        if b * (c + 2) * tiles >= 2 * sms:
            break
    return MotionTailPlan(unit, per_thread, tiles, (tiles, c + 2, b))


def plain_gru_tail(zx, cz, qx, cq, h):
    """The unfused ConvGRU's tail: each op in the operands' dtype (under
    bf16 every op rounds)."""
    z = torch.sigmoid(zx + cz)
    q = torch.tanh(qx + cq)
    return (1.0 - z) * h + z * q


def plain_fused_gru_tail(zx, cz, qx, cq, h):
    """The plain PyTorch version of the tail kernel: every operand widened
    to fp32 (at least; float64 stays), `plain_gru_tail`'s formula, one
    rounding to h's dtype. On fp32 operands it is `plain_gru_tail`."""
    ops = [t.to(torch.promote_types(t.dtype, torch.float32)) for t in (zx, cz, qx, cq, h)]
    return plain_gru_tail(*ops).to(h.dtype)


def plain_motion_tail(pre, flow):
    """The plain PyTorch version of the motion-tail kernel (NCHW); exact in
    any dtype."""
    return torch.cat([torch.relu(pre), flow, torch.zeros_like(flow)], dim=1)


def _lib():
    lib = _build.load("gru_tail")
    if lib.raft_gru_tail.argtypes is None:
        # vec, bf16, blocks, stream
        tail = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.raft_gru_tail.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + tail
        lib.raft_gru_tail.restype = ctypes.c_int
        lib.raft_motion_tail.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,  # batch, C, H*W
            ctypes.c_int, ctypes.c_int,  # vec, bf16
            ctypes.c_int, ctypes.c_longlong,  # plan: units per thread, tiles
            ctypes.c_void_p]  # stream
        lib.raft_motion_tail.restype = ctypes.c_int
        lib.raft_gru_tail_error_string.argtypes = [ctypes.c_int]
        lib.raft_gru_tail_error_string.restype = ctypes.c_char_p
    return lib


def fused_gru_tail(zx, cz, qx, cq, h):
    """h' = (1 - z) h + z tanh(qx + cq), z = sigmoid(zx + cz), one pass, in
    h's dtype (fp32 or bf16, as every operand)."""
    if not h.is_cuda:
        return plain_fused_gru_tail(zx, cz, qx, cq, h)
    ops = (zx, cz, qx, cq, h)
    if any(t.shape != h.shape for t in ops):
        raise ValueError(f"fused_gru_tail operands differ in shape: {[tuple(t.shape) for t in ops]}")
    _build.check_operands("fused_gru_tail", ops, h.device)
    out = torch.empty_like(h)
    n = h.numel()
    width = _build.vector_width(h.dtype)
    vec = int(n % width == 0 and _build.aligned((*ops, out)))
    bf16 = h.dtype == torch.bfloat16
    lib = _lib()
    status = lib.raft_gru_tail(
        *[t.data_ptr() for t in ops], out.data_ptr(), n, vec, int(bf16),
        _build.device_blocks(-(-n // width) if vec else n, h.device),
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(status, "fused_gru_tail kernel", lib.raft_gru_tail_error_string)
    LAUNCHES["gru_tail_bf16" if bf16 else "gru_tail"] += 1
    return out


def fused_motion_tail(pre, flow):
    """cat[relu(pre), flow, zeros_like(flow)] along channels, one pass:
    pre (B, C, H, W), flow (B, 1, H, W) -> (B, C + 2, H, W), in pre's dtype
    (fp32 or bf16, as flow)."""
    if not pre.is_cuda:
        return plain_motion_tail(pre, flow)
    b, c, h, w = pre.shape
    if tuple(flow.shape) != (b, 1, h, w):
        raise ValueError(f"flow shape {tuple(flow.shape)} does not match pre {tuple(pre.shape)}")
    _build.check_operands("fused_motion_tail", (pre, flow), pre.device)
    out = torch.empty((b, c + 2, h, w), dtype=pre.dtype, device=pre.device)
    hw = h * w
    vec = hw % _build.vector_width(pre.dtype) == 0 and _build.aligned((pre, flow, out))
    bf16 = pre.dtype == torch.bfloat16
    plan = motion_tail_plan(b, c, hw, pre.element_size(), _build.multiprocessors(pre.device.index), vec)
    lib = _lib()
    status = lib.raft_motion_tail(
        pre.data_ptr(), flow.data_ptr(), out.data_ptr(), b, c, hw, int(vec), int(bf16), plan.per_thread,
        plan.tiles, torch.cuda.current_stream(pre.device).cuda_stream,
    )
    _build.check(status, "fused_motion_tail kernel", lib.raft_gru_tail_error_string)
    LAUNCHES["motion_tail_bf16" if bf16 else "motion_tail"] += 1
    return out
