"""The "pallas" correlation strategy on CUDA: counterpart of
`raft_stereo_tpu/ops/corr_pallas.py` (state build and fused lookup).

`corr_state` builds the unpadded pyramid once per forward; the 128-lane
padded layout of the TPU state is not carried over, only its values.
`fused_pyramid_state` (config.fused_encoder) builds the same levels in one
launch of `csrc/corr_pyramid.cu` for CUDA tensors — the volume GEMM with
the pooling chain in its epilogue — and runs `corr_state`, its plain
version, for CPU tensors.
`corr_lookup` samples every level in one launch of the hand-written kernel
`csrc/corr_lookup.cu` for CUDA tensors, and runs the plain version
(`ops/corr.py` `corr_lookup`) for CPU tensors. There is no other route: a
CUDA tensor the kernel cannot take raises.

`prefetch_corr_lookup` (config.prefetch_lookup, test mode) computes the
lookup's function with the windowed kernel `csrc/corr_prefetch.cu`: each
query's window of every level staged in shared memory, bit for bit the
dense kernel's taps on every input. It has no backward, as in JAX: it raises
where autograd would record.

The lookup's gradient is `CorrLookup`, the counterpart of the JAX package's
custom VJP of `pallas_corr_lookup_padded`: d(pyramid) from the tap cotangent
by `corr_scatter` (one launch of `csrc/corr_scatter.cu` per backward for
CUDA tensors, `plain_corr_scatter` for CPU tensors), and no gradient to the
coordinates. `corr_lookup` goes through it whenever autograd records.

Not ported: the bf16 pyramid and taps (`corr_dtype="bfloat16"`, under
`mixed_precision`) and the "alt" strategy's on-the-fly lookup.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from raft_stereo_tpu_torch.ops import _build, corr

# Kernel launches since the last reset; chip_smoke.py reads it to prove the
# serving and training paths went through the kernels.
LAUNCHES = {"corr_lookup": 0, "corr_pyramid": 0, "corr_scatter": 0, "corr_prefetch_lookup": 0}
MAX_LEVELS = 8  # MAX_LEVELS of csrc/corr_lookup.cu, corr_prefetch.cu and corr_scatter.cu
# csrc/corr_pyramid.cu: a 64-column volume tile pools into every level, so
# its columns must align to 2**(L-1).
PYRAMID_MAX_LEVELS = 7


def corr_state(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """fmap1 (B, H, W1, D), fmap2 (B, H, W2, D) -> the L contiguous fp32
    pyramid levels (B, H, W1, W2 // 2**l)."""
    return tuple(corr.corr_pyramid(corr.corr_volume(fmap1, fmap2), levels))


def fused_pyramid_state(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> Tuple[torch.Tensor, ...]:
    """`corr_state` in one kernel launch: fmap1 (B, H, W1, D), fmap2
    (B, H, W2, D), any strides (the model passes permuted views of its NCHW
    feature maps, which the kernel reads in place) -> the L contiguous fp32
    levels (B, H, W1, W2 // 2**l)."""
    if not fmap1.is_cuda:
        return corr_state(fmap1, fmap2, levels)
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    if tuple(fmap2.shape) != (b, h, w2, d):
        raise ValueError(f"fmap2 shape {tuple(fmap2.shape)} does not match fmap1 {tuple(fmap1.shape)}")
    if not 1 <= levels <= PYRAMID_MAX_LEVELS:
        raise ValueError(f"corr_pyramid kernel takes 1..{PYRAMID_MAX_LEVELS} levels, got {levels}")
    for t in (fmap1, fmap2):
        if t.device != fmap1.device or t.dtype != torch.float32:
            raise ValueError("corr_pyramid kernel needs fp32 tensors on one CUDA device")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("corr_pyramid kernel has no backward; call it without grad")
    out = tuple(torch.empty((b, h, w1, w2 >> l), dtype=torch.float32, device=fmap1.device)
                for l in range(levels))
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in out])
    strides = (ctypes.c_longlong * 8)(*fmap1.stride(), *fmap2.stride())
    lib = _pyramid_lib()
    status = lib.raft_corr_pyramid_f32(
        fmap1.data_ptr(), fmap2.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        b, h, w1, w2, d, levels, ctypes.cast(ptrs, ctypes.c_void_p),
        torch.cuda.current_stream(fmap1.device).cuda_stream,
    )
    _build.check(status, "corr_pyramid kernel", lib.raft_corr_pyramid_error_string)
    LAUNCHES["corr_pyramid"] += 1
    return out


def _pyramid_lib():
    lib = _build.load("corr_pyramid")
    fn = lib.raft_corr_pyramid_f32
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3  # fmap1, fmap2, host array of the 8 element strides
            + [ctypes.c_int] * 6  # B, H, W1, W2, D, levels
            + [ctypes.c_void_p] * 2  # host array of level pointers, stream
        )
        fn.restype = ctypes.c_int
        lib.raft_corr_pyramid_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_pyramid_error_string.restype = ctypes.c_char_p
    return lib


# The C signature of both lookup kernels, dense and windowed.
_LOOKUP_ARGTYPES = [
    ctypes.c_void_p,  # coords
    ctypes.c_void_p,  # host array of level pointers
    ctypes.c_void_p,  # host array of level widths (int32)
    ctypes.c_int,  # num_levels
    ctypes.c_longlong,  # n_queries
    ctypes.c_int,  # radius
    ctypes.c_void_p,  # out
    ctypes.c_void_p,  # stream
]


def _lib():
    lib = _build.load("corr_lookup")
    fn = lib.raft_corr_lookup_f32
    if fn.argtypes is None:
        fn.argtypes = _LOOKUP_ARGTYPES
        fn.restype = ctypes.c_int
        lib.raft_corr_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_error_string.restype = ctypes.c_char_p
    return lib


def corr_lookup(state: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Taps of every pyramid level around `coords` (B, H, W1):
    (B, H, W1, L*(2r+1)) fp32, level-major; zero outside [0, W2_l). Under
    autograd (grad mode on and a level or `coords` requiring grad) the
    result is differentiable in the levels through `CorrLookup`."""
    levels = tuple(state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (coords, *levels)):
        return CorrLookup.apply(coords, radius, *levels)
    return _lookup(levels, coords, radius)


def _lookup(levels: Tuple[torch.Tensor, ...], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup without autograd: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not coords.is_cuda:
        return corr.corr_lookup(levels, coords, radius)
    lib = _lib()
    out = _launch_lookup("corr_lookup", lib.raft_corr_lookup_f32, lib.raft_corr_error_string,
                         levels, coords, radius)
    LAUNCHES["corr_lookup"] += 1
    return out


def _launch_lookup(name, fn, error_string, levels, coords, radius) -> torch.Tensor:
    """Check the operands of a lookup kernel (dense or windowed: one C
    signature), launch it on the current stream and return its taps."""
    b, h, w1 = coords.shape
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{name} kernel takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    for t in (coords, *levels):
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous fp32 tensors on one CUDA device")
    for lvl in levels:
        if lvl.dim() != 4 or tuple(lvl.shape[:3]) != (b, h, w1):
            raise ValueError(f"level shape {tuple(lvl.shape)} does not match coords {(b, h, w1)}")
    out = torch.empty((b, h, w1, len(levels) * (2 * radius + 1)), dtype=torch.float32, device=coords.device)
    ptrs = (ctypes.c_void_p * len(levels))(*[lvl.data_ptr() for lvl in levels])
    widths = (ctypes.c_int * len(levels))(*[lvl.shape[-1] for lvl in levels])
    status = fn(
        coords.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p),
        len(levels),
        b * h * w1,
        radius,
        out.data_ptr(),
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, f"{name} kernel", error_string)
    return out


def _prefetch_lib():
    lib = _build.load("corr_prefetch")
    fn = lib.raft_corr_prefetch_f32
    if fn.argtypes is None:
        fn.argtypes = _LOOKUP_ARGTYPES
        fn.restype = ctypes.c_int
        lib.raft_corr_prefetch_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_prefetch_error_string.restype = ctypes.c_char_p
    return lib


def prefetch_corr_lookup(state: Sequence[torch.Tensor], coords: torch.Tensor, radius: int) -> torch.Tensor:
    """`corr_lookup`'s taps by the windowed kernel `csrc/corr_prefetch.cu`
    for CUDA tensors (the counterpart of the JAX package's
    `prefetch_corr_lookup_padded`, bit for bit the dense kernel's output on
    every input), by the plain lookup (`ops/corr.py` `corr_lookup`) for CPU
    tensors. No backward: raises where autograd would record."""
    levels = tuple(state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (coords, *levels)):
        raise RuntimeError("prefetch_corr_lookup has no backward (test-mode forwards only); "
                           "call it without grad or use corr_lookup")
    if not coords.is_cuda:
        return corr.corr_lookup(levels, coords, radius)
    lib = _prefetch_lib()
    out = _launch_lookup("corr_prefetch_lookup", lib.raft_corr_prefetch_f32,
                         lib.raft_corr_prefetch_error_string, levels, coords, radius)
    LAUNCHES["corr_prefetch_lookup"] += 1
    return out


class CorrLookup(torch.autograd.Function):
    """`corr_lookup` with the JAX package's gradient contract
    (`pallas_corr_lookup_padded`): d(levels) by `corr_scatter`, none to
    `coords`. Saves only the coordinates and the level widths; the backward
    needs no level values."""

    @staticmethod
    def forward(ctx, coords: torch.Tensor, radius: int, *levels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.widths = tuple(lvl.shape[-1] for lvl in levels)
        return _lookup(levels, coords, radius)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (coords,) = ctx.saved_tensors
        d_levels = corr_scatter(coords, grad.contiguous(), ctx.widths, ctx.radius)
        return (None, None, *d_levels)


def _scatter_lib():
    lib = _build.load("corr_scatter")
    fn = lib.raft_corr_scatter_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # coords
            ctypes.c_void_p,  # grad
            ctypes.c_void_p,  # host array of level pointers
            ctypes.c_void_p,  # host array of level widths (int32)
            ctypes.c_int,  # num_levels
            ctypes.c_longlong,  # n_queries
            ctypes.c_int,  # radius
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.raft_corr_scatter_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_scatter_error_string.restype = ctypes.c_char_p
    return lib


def corr_scatter(coords: torch.Tensor, grad: torch.Tensor, widths: Sequence[int],
                 radius: int) -> Tuple[torch.Tensor, ...]:
    """d(pyramid) of the lookup: coords (B, H, W1) at level-0 resolution,
    grad (B, H, W1, L*(2r+1)) the tap cotangent -> L dense levels
    (B, H, W1, widths[l]) fp32. One launch of `csrc/corr_scatter.cu` for
    CUDA tensors, `plain_corr_scatter` for CPU tensors."""
    if not coords.is_cuda:
        return plain_corr_scatter(coords, grad, widths, radius)
    b, h, w1 = coords.shape
    levels = len(widths)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"corr_scatter kernel takes 1..{MAX_LEVELS} levels, got {levels}")
    if tuple(grad.shape) != (b, h, w1, levels * (2 * radius + 1)):
        raise ValueError(f"grad shape {tuple(grad.shape)} does not match coords {(b, h, w1)} "
                         f"with {levels} levels of {2 * radius + 1} taps")
    for t in (coords, grad):
        if t.device != coords.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("corr_scatter kernel needs contiguous fp32 tensors on one CUDA device")
    out = tuple(torch.empty((b, h, w1, w), dtype=torch.float32, device=coords.device) for w in widths)
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in out])
    c_widths = (ctypes.c_int * levels)(*widths)
    lib = _scatter_lib()
    status = lib.raft_corr_scatter_f32(
        coords.data_ptr(),
        grad.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(c_widths, ctypes.c_void_p),
        levels,
        b * h * w1,
        radius,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, "corr_scatter kernel", lib.raft_corr_scatter_error_string)
    LAUNCHES["corr_scatter"] += 1
    return out


def plain_corr_scatter(coords: torch.Tensor, grad: torch.Tensor, widths: Sequence[int],
                       radius: int) -> Tuple[torch.Tensor, ...]:
    """The function of `corr_scatter` in plain PyTorch: per level, x =
    coords / 2**l, one fraction f = x - floor(x) for every tap, and sample
    floor(x) - r + m of the query's row gets cw[m] = g[m](1-f) + g[m-1]f,
    m = 0..2r+1 (g[-1] = g[2r+1] = 0); all other samples are zero."""
    k = 2 * radius + 1
    zero = grad.new_zeros((*grad.shape[:-1], 1))
    out = []
    for lvl, w2 in enumerate(widths):
        x = coords / (2**lvl)
        x0f = torch.floor(x)
        frac = (x - x0f)[..., None]
        g = grad[..., lvl * k:(lvl + 1) * k]
        cw = torch.cat([g, zero], dim=-1) * (1.0 - frac) + torch.cat([zero, g], dim=-1) * frac
        # Window offset of every sample, in float so that far-out and NaN
        # coordinates select nothing; position k + 1 of `cw_pad` is zero.
        pos = torch.arange(w2, dtype=coords.dtype, device=coords.device)
        m = pos - (x0f[..., None] - radius)
        idx = torch.where((m >= 0) & (m <= k), m, float(k + 1)).long()
        out.append(torch.gather(torch.cat([cw, zero], dim=-1), -1, idx))
    return tuple(out)
