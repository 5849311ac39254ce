"""ConvGRU gate pair: counterpart of `raft_stereo_tpu/ops/gates_pallas.py`.

    rh:      sigmoid(rx + cr) * h                      (feeds the q conv)
    combine: (1 - z) * h + z * tanh(qx + cq),  z = sigmoid(zx + cz)

An experiment kept for A/B runs only. On the TPU the JAX package measured
the three-kernel gate split against the compiler's own fusions and retired
it as a clear loss (its operands were forced out of the convolutions'
fusions and written and read again across every kernel boundary); the
kernels stay there so that the comparison can be re-run after a toolchain
upgrade, and nothing in the product path uses them. The port keeps the same
status and the same switch: the environment variable
`RAFT_STEREO_TPU_PALLAS_GATES=1`, read per forward (`enabled()`), as the JAX
model reads it per trace, and not a config field. The model takes the gate
pair only in a test-mode forward whose config has `fused_gru_tail` off: the
fused tail takes precedence, as in JAX (models/update.py).

Each wrapper launches its kernel from `csrc/gates.cu` for CUDA tensors and
runs its plain version for CPU tensors; a CUDA tensor the kernel cannot take
raises. No backward. The combine kernel computes the fused GRU tail's
function with the tail's own device formula (`csrc/gru_gates.cuh`), so the
two agree bit for bit; it has its own launch and its own count. Like the
port's other elementwise kernels it is built by nvcc with -fmad=false
(ops/_build.py), so that it rounds where the plain version rounds.

Layout: elementwise over tensors of one shape (the model passes NCHW).
"""

from __future__ import annotations

import ctypes
import os

import torch

from raft_stereo_tpu_torch.ops import _build

ENV_VAR = "RAFT_STEREO_TPU_PALLAS_GATES"
# Kernel launches since the last reset; chip_smoke.py reads them to prove
# the gates configuration went through the kernels.
LAUNCHES = {"gates_rh": 0, "gates_combine": 0}


def enabled() -> bool:
    """Whether the gate pair is switched on (`RAFT_STEREO_TPU_PALLAS_GATES=1`)."""
    return os.environ.get(ENV_VAR) == "1"


def plain_rh(rx, cr, h):
    """The plain PyTorch version of the rh kernel."""
    return torch.sigmoid(rx + cr) * h


def plain_combine(zx, cz, qx, cq, h):
    """The plain PyTorch version of the combine kernel."""
    z = torch.sigmoid(zx + cz)
    q = torch.tanh(qx + cq)
    return (1.0 - z) * h + z * q


def _lib():
    lib = _build.load("gates")
    if lib.raft_gates_rh_f32.argtypes is None:
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]  # n, vec, stream
        lib.raft_gates_rh_f32.argtypes = [ctypes.c_void_p] * 4 + tail
        lib.raft_gates_rh_f32.restype = ctypes.c_int
        lib.raft_gates_combine_f32.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.raft_gates_combine_f32.restype = ctypes.c_int
        lib.raft_gates_error_string.argtypes = [ctypes.c_int]
        lib.raft_gates_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, fn, ops):
    """Check the operands, launch `fn` on them and return its output."""
    h = ops[-1]
    if any(t.shape != h.shape for t in ops):
        raise ValueError(f"{name} operands differ in shape: {[tuple(t.shape) for t in ops]}")
    for t in ops:
        if t.device != h.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous fp32 tensors on one CUDA device")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name} kernel has no backward; call it without grad")
    out = torch.empty_like(h)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (*ops, out)))
    status = fn(*[t.data_ptr() for t in ops], out.data_ptr(), h.numel(), vec,
                torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(status, f"{name} kernel", _lib().raft_gates_error_string)
    return out


def fused_rh(rx, cr, h):
    """sigmoid(rx + cr) * h in one pass."""
    if not h.is_cuda:
        return plain_rh(rx, cr, h)
    out = _launch("gates_rh", _lib().raft_gates_rh_f32, (rx, cr, h))
    LAUNCHES["gates_rh"] += 1
    return out


def fused_combine(zx, cz, qx, cq, h):
    """(1 - z) * h + z * tanh(qx + cq) with z = sigmoid(zx + cz), one pass."""
    if not h.is_cuda:
        return plain_combine(zx, cz, qx, cq, h)
    out = _launch("gates_combine", _lib().raft_gates_combine_f32, (zx, cz, qx, cq, h))
    LAUNCHES["gates_combine"] += 1
    return out
