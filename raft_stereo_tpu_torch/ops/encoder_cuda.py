"""Fused encoder layer1 on CUDA (config.fused_encoder): counterpart of
`raft_stereo_tpu/ops/encoder_pallas.py`.

The stem norm and the two layer1 residual blocks run as two hand-written
kernels, in NCHW at C = 64:

- `fused_conv` (`csrc/encoder_conv.cu`): a 3x3 stride-1 "same" conv of
  `z = form(x)`, plus bias, where the pending norm and relu of the previous
  layer are applied to the operand as it is read, and optionally the
  per-channel `[sum y, sum y^2]` of the output (the next instance norm's
  statistics) from the conv's epilogue.
- `fused_join` (`csrc/encoder_join.cu`): the block tail
  `relu(skip' + relu(norm(y)))` in one elementwise pass, where `skip'` may
  carry the stem's pending norm.

Affine forms, with `a = aff[:, 0]` and `b = aff[:, 1]` per (batch, channel):
"none" `x`; "in" `relu((x - a) * b)` (instance norm from [mean, inv]);
"bn" `relu(x * a + b)` (frozen batch norm from [inv, shift]). The zero
padding of the conv pads `z`, not `x`.

The operands are fp32 or bf16 (the compute dtype; bf16 under mixed
precision), with the JAX kernels' bf16 contract: the fp32 affine rows,
weights and bias are cast to the operand dtype at use, the affine and relu
run in that dtype, the conv sums its products in fp32, rounds the sum and
adds the bias in the operand dtype, and the statistics are fp32 sums over
the stored outputs. The join runs in the operand dtype.

The conv takes a halo form (`halo=(top, bottom)`, each 0 or 1): x then
holds `top` rows above and `bottom` rows below the output's rows, the
neighbour band's real rows (parallel/spatial.py `raw_halo_rows`), and z
is zero only outside x's rows and columns, so such a row enters the conv
with the affine and relu applied; y and its statistics cover the output's
rows only. `fused_layer1` inside a band scope takes one such row from each
neighbour band for every conv and sums the instance statistics over the
bands (the join is row-local).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`plain_conv`, `plain_join`) for CPU tensors; a CUDA tensor the
kernel cannot take raises. Both conv kernels (fp32 FFMA, bf16 wgmma)
launch what `conv_plan` says: persistent blocks (one per multiprocessor of
the card) with the weights resident, and whether the raw tile comes by TMA
with 16-byte stores or element by element. Test-mode only, as in JAX: there is no backward,
so the wrappers refuse to run where autograd would record them. The TPU
kernels' W-space-to-depth layout is not carried over, only their values.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.ops import _build
from raft_stereo_tpu_torch.parallel import spatial

# Kernel launches since the last reset; chip_smoke.py reads them to prove
# the serving path went through the kernels. One conv call counts one
# launch (its statistics reduction is a second, small launch of the call).
# The bf16 variants count under "<name>_bf16".
LAUNCHES = {"encoder_conv": 0, "encoder_join": 0, "encoder_conv_bf16": 0, "encoder_join_bf16": 0}
FORMS = {"none": 0, "in": 1, "bn": 2}
CHANNELS = 64  # layer1's width at every hidden_dims; the conv kernel is built for it
TILE_H, TILE_W = 8, 32  # csrc/encoder_conv.cu TILE_H, TILE_W: the bf16 kernel's tile
# The fp32 kernel (F_* of csrc/encoder_conv.cu): 8 x 64 tiles, persistent
# blocks of 256 threads, one per multiprocessor; shared memory: 128 bytes of
# alignment slack, the raw TMA box (8 channels x 10 rows x 72 pixels), the
# resident (Ci, 3, 3, Co) weights, two (8+2) x (64+2) patch slots of 8
# channels (row stride 68) and the box's barrier (16 bytes).
CONV_F32_TILE_W = 64
CONV_F32_SHARED_BYTES = 128 + 4 * (8 * (TILE_H + 2) * (CONV_F32_TILE_W + 8) + CHANNELS * 9 * CHANNELS
                                   + 2 * 8 * (TILE_H + 2) * 68) + 16
# The statistics pass (STATS_RUN of csrc/encoder_conv.cu): its first launch
# sums runs of this many partials (two per tile) per image.
CONV_STATS_RUN = 256
# The bf16 kernel (WC_* of csrc/encoder_conv.cu): persistent blocks of 384
# threads, one per multiprocessor; shared memory: 1024 bytes of alignment
# slack, the nine taps' 64 x 64 bf16 weights, two (8+2) x (32+2) halo
# patches of 64 bf16 channels (a consumed one holds the channel-major output
# tile), the raw tile (64 channels x 10 rows x 48 pixels of bf16, its TMA
# box), the 8 consumer warps' statistics and five barriers.
CONV_THREADS = 384
CONV_BLOCKS_PER_SM = 1
CONV_SHARED_BYTES = (1024 + 9 * CHANNELS * CHANNELS * 2 + 2 * (TILE_H + 2) * (TILE_W + 2) * CHANNELS * 2
                     + CHANNELS * (TILE_H + 2) * (TILE_W + 16) * 2 + 8 * 2 * CHANNELS * 4 + 5 * 8)


class ConvPlan(NamedTuple):
    """A launch of a conv kernel: `blocks` persistent blocks walk the
    (batch, tile) list, tile t = (b, ty, tx) with t = b * tiles + ty *
    tiles_x + tx, blocks taking t, t + blocks, ...; `vec`: the raw tile by
    TMA and 16-byte stores along W; `stat_runs`: the statistics pass's runs
    of CONV_STATS_RUN partials per image."""

    tiles_x: int
    tiles: int
    blocks: int
    shared_bytes: int
    vec: bool
    stat_runs: int


def conv_plan(b: int, h: int, w: int, sms: int, aligned: bool = True, elem_bytes: int = 2) -> ConvPlan:
    """The conv kernel's plan for x (b, 64, h, w) of `elem_bytes` (2: the
    bf16 wgmma kernel, 8 x 32 tiles; 4: the fp32 FFMA kernel, 8 x 64 tiles)
    on a card of `sms` multiprocessors: one block per multiprocessor up to
    the tile count, the raw tile by TMA and 16-byte stores where a row is a
    multiple of 16 bytes (W a multiple of 8 in bf16, of 4 in fp32) and x
    and y start 16-byte aligned (`aligned`; a tensor map's strides and base
    must be multiples of 16 bytes), element by element otherwise. Raises
    for what the kernels do not take."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"encoder_conv kernel takes fp32 or bf16 (4 or 2 bytes), got {elem_bytes}")
    if min(b, h, w) < 0 or b > 65535:
        raise ValueError(f"encoder_conv kernel: bad shape {(b, h, w)}")
    tiles_x = -(-w // (TILE_W if elem_bytes == 2 else CONV_F32_TILE_W))
    tiles = tiles_x * -(-h // TILE_H)
    if b * tiles > 2**31 - 1:
        raise ValueError(f"encoder_conv kernel: {b * tiles} tiles exceed int32")
    shared = CONV_SHARED_BYTES if elem_bytes == 2 else CONV_F32_SHARED_BYTES
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(f"encoder_conv kernel: {shared} shared bytes exceed {_build.MAX_SHARED_BYTES}")
    return ConvPlan(tiles_x, tiles, min(b * tiles, sms * CONV_BLOCKS_PER_SM), shared,
                    aligned and w % (16 // elem_bytes) == 0, -(-2 * tiles // CONV_STATS_RUN))


def apply_affine(x: torch.Tensor, aff: Optional[torch.Tensor], form: str) -> torch.Tensor:
    """The operand stage of both kernels on NCHW `x` and (B, 2, C) `aff`,
    in x's dtype (the rows cast at use)."""
    if form == "none":
        return x
    a = aff[:, 0, :, None, None].to(x.dtype)
    b = aff[:, 1, :, None, None].to(x.dtype)
    return torch.relu((x - a) * b if form == "in" else x * a + b)


def channel_stats(y: torch.Tensor) -> torch.Tensor:
    """(B, 2, C) fp32 [sum, sum of squares] of NCHW `y` over H x W."""
    y = y.float()
    return torch.stack([y.sum(dim=(2, 3)), (y * y).sum(dim=(2, 3))], dim=1)


def plain_conv(x, weight, bias, aff, form, emit_stats, halo: Tuple[int, int] = (0, 0)):
    """The plain PyTorch version of the conv kernel: (y, stats or None). A
    bf16 operand is convolved as fp32 values of the bf16-rounded operand
    and weights (their products are exact in fp32; TF32 off on the card),
    the sum rounded to bf16, then the bf16 bias added in bf16. With a halo
    the affine and relu apply to every row of x, z gets a zero row only on
    a side without a halo row, and the conv pads no row."""
    top, bottom = _check_halo(halo, x.shape[2])
    z = apply_affine(x, aff, form)
    padding = 1
    if top or bottom:
        z = F.pad(z, (0, 0, 1 - top, 1 - bottom))
        padding = (0, 1)
    if x.dtype == torch.bfloat16:
        y = F.conv2d(z.float(), weight.to(x.dtype).float(), None, padding=padding).to(x.dtype)
        y = y + bias.to(x.dtype)[None, :, None, None]
    else:
        y = F.conv2d(z, weight, bias, padding=padding)
    return y, (channel_stats(y) if emit_stats else None)


def _check_halo(halo, rows: int) -> Tuple[int, int]:
    top, bottom = (int(v) for v in halo)
    if top not in (0, 1) or bottom not in (0, 1):
        raise ValueError(f"encoder_conv halo rows must be 0 or 1 on each side, got {tuple(halo)}")
    if rows - top - bottom < 1:
        raise ValueError(f"encoder_conv: {rows} rows leave no output row under a halo of {tuple(halo)}")
    return top, bottom


def plain_join(skip, y, aff_y, y_form, aff_skip=None, skip_form="none"):
    """The plain PyTorch version of the join kernel."""
    return torch.relu(apply_affine(skip, aff_skip, skip_form) + apply_affine(y, aff_y, y_form))


def band_stats(y: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(`channel_stats(y)`, H x W) of NCHW `y`; inside a band scope the sums
    over the bands and the whole image's pixel count."""
    stats, n = channel_stats(y), y.shape[2] * y.shape[3]
    scope = spatial.banded()
    if scope is not None:
        stats, n = scope.band_sum(stats), n * scope.count
    return stats, n


def instance_affine_from_stats(stats: torch.Tensor, n: int, epsilon: float = 1e-5) -> torch.Tensor:
    """(B, 2, C) [sum, sumsq] over n values -> (B, 2, C) [mean, inv] rows,
    the one-pass statistics of models/layers.InstanceNorm."""
    mean = stats[:, 0] / n
    var = torch.clamp(stats[:, 1] / n - mean * mean, min=0.0)
    return torch.stack([mean, torch.rsqrt(var + epsilon)], dim=1)


def bn_affine(inv: torch.Tensor, shift: torch.Tensor, batch: int) -> torch.Tensor:
    """A frozen batch norm's folded affine as (B, 2, C) rows, one per
    batch element, so the kernels index every affine per batch element."""
    return torch.stack([inv, shift]).float()[None].expand(batch, 2, inv.shape[-1]).contiguous()


def _conv_lib():
    lib = _build.load("encoder_conv")
    if lib.raft_encoder_conv.argtypes is None:
        lib.raft_encoder_conv.argtypes = (
            [ctypes.c_void_p] * 4  # x, weight (Ci, 3, 3, Co), bias, aff or NULL
            + [ctypes.c_int] * 6  # form, batch, H (output rows), W, halo rows above and below
            + [ctypes.c_void_p] * 4  # y, partial sums, their double runs, stats (the last three or NULL)
            + [ctypes.c_int] * 5  # bf16; plan: blocks, shared bytes, vec, statistics runs
            + [ctypes.c_void_p]  # stream
        )
        lib.raft_encoder_conv.restype = ctypes.c_int
        lib.raft_encoder_conv_error_string.argtypes = [ctypes.c_int]
        lib.raft_encoder_conv_error_string.restype = ctypes.c_char_p
    return lib


def _join_lib():
    lib = _build.load("encoder_join")
    if lib.raft_encoder_join.argtypes is None:
        lib.raft_encoder_join.argtypes = (
            [ctypes.c_void_p] * 5  # skip, y, aff_y, aff_skip or NULL, out
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]  # batch, channels, H*W
            + [ctypes.c_int] * 5  # y_form, skip_form, vec, bf16, blocks
            + [ctypes.c_void_p]  # stream
        )
        lib.raft_encoder_join.restype = ctypes.c_int
        lib.raft_encoder_join_error_string.argtypes = [ctypes.c_int]
        lib.raft_encoder_join_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name, operands, params, device):
    """Contiguous tensors on one CUDA device, without grad: the operands
    all fp32 or all bf16, the parameters (weights, bias, affine rows) fp32."""
    dtype = operands[0].dtype
    if dtype not in _build.DTYPE_FLAGS:
        raise ValueError(f"{name} kernel takes fp32 or bf16 operands, got {dtype}")
    for t, want in [(o, dtype) for o in operands] + [(p, torch.float32) for p in params]:
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous {dtype} operands and fp32 parameters "
                             "on one CUDA device")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name} kernel has no backward; call it without grad")


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 `t` rounded to `dtype` (bf16), as fp32 again: how the kernels
    receive the parameters they cast at use (the identity for fp32)."""
    return t.to(dtype).float()


def fused_conv(x, weight, bias, aff: Optional[torch.Tensor], form: str = "none",
               emit_stats: bool = False, halo: Tuple[int, int] = (0, 0)
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """3x3 "same" conv of form(x) with bias: x (B, 64, H + top + bottom, W)
    fp32 or bf16 for `halo` = (top, bottom) rows around the output's H,
    weight (64, 64, 3, 3) OIHW, bias (64,), aff (B, 2, 64) or None with
    "none", all three fp32. Returns (y (B, 64, H, W) in x's dtype, stats
    (B, 2, 64) fp32 [sum, sumsq] of y or None)."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} not in {tuple(FORMS)}")
    if (aff is None) != (form == "none"):
        raise ValueError("aff must be given iff form != 'none'")
    top, bottom = _check_halo(halo, x.shape[2])
    if not x.is_cuda:
        return plain_conv(x, weight, bias, aff, form, emit_stats, (top, bottom))
    b, c, rows, w = x.shape
    h = rows - top - bottom
    if c != CHANNELS or tuple(weight.shape) != (CHANNELS, CHANNELS, 3, 3) or tuple(bias.shape) != (CHANNELS,):
        raise ValueError(f"encoder_conv kernel takes 64 -> 64 channels, 3x3; got x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if aff is not None and tuple(aff.shape) != (b, 2, CHANNELS):
        raise ValueError(f"aff shape {tuple(aff.shape)} != {(b, 2, CHANNELS)}")
    _check_operands("encoder_conv", (x,), [t for t in (weight, bias, aff) if t is not None], x.device)
    # fp32: (Ci, 3, 3, Co), each input channel's 9 x 64 weights contiguous,
    # the layout the FFMA kernel stages with 16-byte loads; bf16: (3, 3, Co,
    # Ci), each (tap, output channel)'s input channels contiguous, the wgmma
    # kernel's B operand rows.
    if x.dtype == torch.bfloat16:
        w_t = weight.to(torch.bfloat16).permute(2, 3, 0, 1).contiguous()
    else:
        w_t = weight.permute(1, 2, 3, 0).contiguous()
    bias = _rounded(bias, x.dtype)
    aff = None if aff is None else _rounded(aff, x.dtype)
    y = torch.empty((b, c, h, w), dtype=x.dtype, device=x.device)
    plan = conv_plan_for(x, y)
    stats = partial = sums = None
    if emit_stats:
        # Two partials per tile (bf16: one per consumer warpgroup; fp32: one
        # per column half), summed in runs in double, then per image.
        partial = torch.empty((b, 2 * plan.tiles, 2, CHANNELS), dtype=torch.float32, device=x.device)
        sums = torch.empty((b, plan.stat_runs, 2, CHANNELS), dtype=torch.float64, device=x.device)
        stats = torch.empty((b, 2, CHANNELS), dtype=torch.float32, device=x.device)
    lib = _conv_lib()
    status = lib.raft_encoder_conv(
        x.data_ptr(), w_t.data_ptr(), bias.data_ptr(), 0 if aff is None else aff.data_ptr(),
        FORMS[form], b, h, w, top, bottom, y.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (partial, sums, stats)),
        _build.DTYPE_FLAGS[x.dtype], plan.blocks, plan.shared_bytes, int(plan.vec), plan.stat_runs,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "encoder_conv kernel", lib.raft_encoder_conv_error_string)
    _build.count_launch(LAUNCHES, "encoder_conv_bf16" if x.dtype == torch.bfloat16 else "encoder_conv")
    return y, stats


def conv_plan_for(x: torch.Tensor, y: torch.Tensor) -> ConvPlan:
    """`conv_plan` for CUDA x and y (B, 64, H, W) of one dtype (x with its
    halo rows): y's shape, the element size and alignment and their card's
    multiprocessors."""
    b, _, h, w = y.shape
    return conv_plan(b, h, w, _build.multiprocessors(x.device.index), _build.aligned((x, y)), x.element_size())


def join_blocks(b: int, c: int, hw: int, vec: bool, sms: int) -> int:
    """The join kernel's grid on a card of `sms` multiprocessors: its
    grid-stride loop's units (4-element groups on the vector path, else
    elements) over `_build.stream_blocks`, one unit per thread up to 32
    blocks of 256 per multiprocessor."""
    return _build.stream_blocks(b * c * (hw // 4 if vec else hw), sms)


def fused_join(skip, y, aff_y, y_form: str, aff_skip: Optional[torch.Tensor] = None,
               skip_form: str = "none") -> torch.Tensor:
    """relu(skip' + relu(y_form(y))) over NCHW (B, C, H, W), fp32 or bf16
    (both alike; the fp32 affine rows cast at use); skip' is `skip` for
    "none", else relu(skip_form(skip)) with `aff_skip`."""
    if y_form not in ("in", "bn"):
        raise ValueError(f"y_form {y_form!r} not in ('in', 'bn')")
    if skip_form not in FORMS:
        raise ValueError(f"skip_form {skip_form!r} not in {tuple(FORMS)}")
    if aff_skip is None and skip_form != "none":
        raise ValueError("aff_skip required for skip_form != 'none'")
    if not skip.is_cuda:
        return plain_join(skip, y, aff_y, y_form, aff_skip, skip_form)
    b, c, h, w = skip.shape
    if tuple(y.shape) != tuple(skip.shape):
        raise ValueError(f"y shape {tuple(y.shape)} != skip shape {tuple(skip.shape)}")
    affs = [aff_y] + ([aff_skip] if skip_form != "none" else [])
    for a in affs:
        if tuple(a.shape) != (b, 2, c):
            raise ValueError(f"affine shape {tuple(a.shape)} != {(b, 2, c)}")
    _check_operands("encoder_join", (skip, y), affs, skip.device)
    aff_y, aff_skip = (None if a is None else _rounded(a, skip.dtype) for a in (aff_y, aff_skip))
    out = torch.empty_like(skip)
    hw = h * w
    vec = int(hw % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (skip, y, out)))
    lib = _join_lib()
    status = lib.raft_encoder_join(
        skip.data_ptr(), y.data_ptr(), aff_y.data_ptr(),
        aff_skip.data_ptr() if skip_form != "none" else 0, out.data_ptr(),
        b, c, hw, FORMS[y_form], FORMS[skip_form], vec, _build.DTYPE_FLAGS[skip.dtype],
        join_blocks(b, c, hw, vec, _build.multiprocessors(skip.device.index)),
        torch.cuda.current_stream(skip.device).cuda_stream,
    )
    _build.check(status, "encoder_join kernel", lib.raft_encoder_join_error_string)
    _build.count_launch(LAUNCHES, "encoder_join_bf16" if skip.dtype == torch.bfloat16 else "encoder_join")
    return out


def fused_layer1(stem_y: torch.Tensor, stem_aff: torch.Tensor,
                 blocks: Sequence[Tuple[torch.Tensor, ...]], norm_fn: str) -> torch.Tensor:
    """Stem norm + the layer1 residual blocks, fused-kernel form.

    stem_y: (B, 64, H, W) RAW stem conv output; stem_aff: (B, 2, 64) its
    pending norm (instance [mean, inv] or batch [inv, shift]). blocks: per
    residual block (w1, b1, w2, b2, aff_bn1, aff_bn2), the BN affines None
    under instance norm (the conv kernels produce those statistics).
    Returns the joined layer1 output.

    Inside a band scope (parallel/spatial.py) stem_y is this band's rows,
    stem_aff the whole image's (`band_stats`), every conv takes one row of
    its raw operand from each neighbour band and its statistics are summed
    over the bands, over the whole image's pixel count."""
    if norm_fn not in ("instance", "batch"):
        raise ValueError(f"fused layer1 takes instance or batch norm, got {norm_fn!r}")
    form = "in" if norm_fn == "instance" else "bn"
    emit = norm_fn == "instance"
    scope = spatial.banded()
    n = stem_y.shape[2] * stem_y.shape[3] * (scope.count if scope is not None else 1)

    def conv(x, weight, bias, aff, x_form):
        halo = (0, 0)
        if scope is not None:
            x, top, bottom = scope.raw_halo_rows(x, 1, 1)
            halo = (top, bottom)
        y, stats = fused_conv(x, weight, bias, aff, x_form, emit_stats=emit, halo=halo)
        if emit and scope is not None:
            stats = scope.band_sum(stats)
        return y, (instance_affine_from_stats(stats, n) if emit else None)

    cur, cur_aff, cur_form = stem_y, stem_aff, form
    for w1, b1, w2, b2, aff_bn1, aff_bn2 in blocks:
        y1, aff1 = conv(cur, w1, b1, cur_aff, cur_form)
        aff1 = aff1 if emit else aff_bn1
        y2, aff2 = conv(y1, w2, b2, aff1, form)
        aff2 = aff2 if emit else aff_bn2
        cur = fused_join(cur, y2, aff2, form, aff_skip=cur_aff, skip_form=cur_form)
        cur_aff, cur_form = None, "none"
    return cur
