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

Dtypes, the JAX kernels' contract: the operands all fp32 or all bf16 (a
mix raises), the math fp32, the output rounded once to their dtype. The
plain versions widen, compute in fp32 and round once the same way; on fp32
operands they are the plain fp32 formulas. They are the kernels' twins,
not the unfused ConvGRU's bf16 formula (which rounds after every op).

Layout: elementwise over tensors of one shape (the model passes NCHW).
"""

from __future__ import annotations

import ctypes
import os

import torch

from raft_stereo_tpu_torch.ops import _build, gru_tail

ENV_VAR = "RAFT_STEREO_TPU_PALLAS_GATES"
# Kernel launches since the last reset; chip_smoke.py reads them to prove
# the gates configuration went through the kernels. The bf16 forms count
# apart.
LAUNCHES = {"gates_rh": 0, "gates_combine": 0, "gates_rh_bf16": 0, "gates_combine_bf16": 0}


def enabled() -> bool:
    """Whether the gate pair is switched on (`RAFT_STEREO_TPU_PALLAS_GATES=1`)."""
    return os.environ.get(ENV_VAR) == "1"


def plain_rh(rx, cr, h):
    """The plain PyTorch version of the rh kernel: operands widened to fp32
    (at least), sigmoid(rx + cr) * h, one rounding to rx's dtype."""
    wide = [t.to(torch.promote_types(t.dtype, torch.float32)) for t in (rx, cr, h)]
    return (torch.sigmoid(wide[0] + wide[1]) * wide[2]).to(rx.dtype)


def plain_combine(zx, cz, qx, cq, h):
    """The plain PyTorch version of the combine kernel: the fused GRU tail's
    (`gru_tail.plain_fused_gru_tail`), output in zx's dtype (one dtype for
    all operands on the card)."""
    return gru_tail.plain_fused_gru_tail(zx, cz, qx, cq, h).to(zx.dtype)


def _lib():
    lib = _build.load("gates")
    if lib.raft_gates_rh.argtypes is None:
        # n, vec, bf16, blocks, stream
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.raft_gates_rh.argtypes = [ctypes.c_void_p] * 4 + tail
        lib.raft_gates_rh.restype = ctypes.c_int
        lib.raft_gates_combine.argtypes = [ctypes.c_void_p] * 6 + tail
        lib.raft_gates_combine.restype = ctypes.c_int
        lib.raft_gates_error_string.argtypes = [ctypes.c_int]
        lib.raft_gates_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, fn, ops):
    """Check the operands, launch `fn` on them and return its output (in
    their dtype) and whether it was the bf16 form."""
    h = ops[-1]
    if any(t.shape != h.shape for t in ops):
        raise ValueError(f"{name} operands differ in shape: {[tuple(t.shape) for t in ops]}")
    _build.check_operands(name, ops, h.device)
    out = torch.empty_like(h)
    n = h.numel()
    vec = int(_build.aligned((*ops, out)))
    width = _build.vector_width(h.dtype)
    bf16 = h.dtype == torch.bfloat16
    status = fn(*[t.data_ptr() for t in ops], out.data_ptr(), n, vec, int(bf16),
                _build.device_blocks(-(-n // width) if vec else n, h.device),
                torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(status, f"{name} kernel", _lib().raft_gates_error_string)
    return out, bf16


def fused_rh(rx, cr, h):
    """sigmoid(rx + cr) * h in one pass, in the operands' dtype."""
    if not h.is_cuda:
        return plain_rh(rx, cr, h)
    out, bf16 = _launch("gates_rh", _lib().raft_gates_rh, (rx, cr, h))
    _build.count_launch(LAUNCHES, "gates_rh_bf16" if bf16 else "gates_rh")
    return out


def fused_combine(zx, cz, qx, cq, h):
    """(1 - z) * h + z * tanh(qx + cq) with z = sigmoid(zx + cz), one pass,
    in the operands' dtype."""
    if not h.is_cuda:
        return plain_combine(zx, cz, qx, cq, h)
    out, bf16 = _launch("gates_combine", _lib().raft_gates_combine, (zx, cz, qx, cq, h))
    _build.count_launch(LAUNCHES, "gates_combine_bf16" if bf16 else "gates_combine")
    return out
