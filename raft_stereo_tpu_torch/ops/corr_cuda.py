"""The "pallas" correlation strategy on CUDA: counterpart of
`raft_stereo_tpu/ops/corr_pallas.py` (state build and fused lookup).

`corr_state` builds the unpadded pyramid once per forward; the 128-lane
padded layout of the TPU state is not carried over, only its values.
`fused_pyramid_state` (config.fused_encoder) builds the same levels in one
launch of `csrc/corr_pyramid.cu` for CUDA tensors — the volume GEMM with
the pooling chain in its epilogue — and runs `corr_state`, its plain
version, for CPU tensors. Both store the levels in fp32 or bf16
(`corr_dtype`) by `ops/corr.py`'s contract.
`corr_lookup` samples every level in one launch of the hand-written kernel
behind `csrc/corr_lookup.cu` for CUDA tensors, and runs the plain version
(`ops/corr.py` `corr_lookup`) for CPU tensors; it takes fp32 or bf16
levels and stores fp32 or bf16 taps. There is no other route: a CUDA
tensor the kernel cannot take raises.

`prefetch_corr_lookup` (config.prefetch_lookup, test mode) computes the
same function through `csrc/corr_prefetch.cu`. Both entry points launch
the one windowed kernel of `csrc/corr_window.cuh`: each query's window of
every level fetched as 16-byte chunks into a per-warp ring in shared
memory, runs of queries in flight while the previous run's taps are
formed, in the four (level, tap) dtype pairs. So the two give the same
taps bit for bit; they keep their own libraries and launch counters.
`prefetch_plan` chooses the launch of both (the compile-time r = 4,
4-level instantiation, the generic one, or the element path for unaligned
levels; run length, ring depth, and a grid from the card's multiprocessor
count). `prefetch_corr_lookup` has no backward, as in JAX: it raises where
autograd would record.

The lookup's gradient is `CorrLookup`, the counterpart of the JAX package's
custom VJP of `pallas_corr_lookup_padded`: d(pyramid) from the tap cotangent
by `corr_scatter` (one launch of `csrc/corr_scatter.cu` per backward for
CUDA tensors, `plain_corr_scatter` for CPU tensors), each level's gradient
in that level's dtype, and no gradient to the coordinates. `corr_lookup`
goes through it whenever autograd records, for fp32 or bf16 levels and
taps (bf16 training: the scatter reads a bf16 cotangent in place and
stores bf16 levels).

The pyramid and scatter kernels launch what a plain function here plans
(`pyramid_plan`: kernel, tile, copy width, grid, shared bytes, ring depth;
`scatter_plan`: queries per block, grid, shared bytes, 64-bit indexing); a
shape or stride no plan takes raises. The bf16 pyramid has two kernels in
`csrc/corr_pyramid.cu`, and the plan names the one that takes the shape:
the wgmma kernel (TMA tensor maps, persistent blocks) where W is a multiple
of 8 along the unit-stride axis of both maps, else the mma.sync kernel.

Not ported: the "alt" strategy's on-the-fly lookup.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.ops import _build, corr

# Kernel launches since the last reset; chip_smoke.py reads it to prove the
# serving and training paths went through the kernels. The bf16 variants
# count apart: the pyramid's tensor-core kernel under "corr_pyramid_bf16",
# a lookup with bf16 levels or taps under "corr_lookup_bf16" (windowed:
# "corr_prefetch_lookup_bf16"), a scatter with a bf16 cotangent or bf16
# levels under "corr_scatter_bf16".
LAUNCHES = {"corr_lookup": 0, "corr_pyramid": 0, "corr_scatter": 0, "corr_prefetch_lookup": 0,
            "corr_lookup_bf16": 0, "corr_pyramid_bf16": 0, "corr_scatter_bf16": 0,
            "corr_prefetch_lookup_bf16": 0}
MAX_LEVELS = 8  # MAX_LEVELS of csrc/corr_window.cuh (both lookups) and corr_scatter.cu
# csrc/corr_pyramid.cu: a volume tile pools into every level, so its
# columns must align to 2**(L-1); its level table holds 7.
PYRAMID_MAX_LEVELS = 7
# Its instantiations: tile (W1 x W2 extent of a block) -> register tile
# per thread (TM x TN), on a (tile / register tile) grid of 256 threads;
# its D chunk, ring depth and operand-row padding. Two blocks of either are
# resident on an SM (its __launch_bounds__).
PYRAMID_TILES = {(128, 128): (8, 8), (96, 192): (6, 12)}
# The kernels of the build, by the C entry point's `path`: the fp32 FFMA
# kernel, the bf16 mma.sync kernel (one tile of 256 threads, 8 warps of 64
# x 32, mma.sync m16n8k16, the shared-memory epilogue; it takes every
# shape and layout), and the bf16 wgmma kernel (persistent blocks of 384
# threads, TMA loads, the 8-column chunk epilogue; it takes what its
# tensor maps and stores take, `pyramid_plan` says what).
PYRAMID_PATHS = {"ffma": 0, "mma": 1, "wgmma": 2}
PYRAMID_MMA_TILE, PYRAMID_MMA_THREADS = (128, 128), 256
PYRAMID_TK, PYRAMID_STAGES, PYRAMID_PAD = 16, 4, 4
PYRAMID_BLOCKS_PER_SM = 2
PYRAMID_REG_LEVELS = 6  # REG_LEVELS of csrc/corr_pyramid.cu: levels its register epilogue reaches
# The wgmma kernel (WG_* of csrc/corr_pyramid.cu): 128 W1 rows (two
# consumer warpgroups of 64) by one of its instantiated W2 widths (the
# wgmma N: a multiple of 8 up to 256), k64 stages of 64 x 64 TMA boxes
# (8192 bytes each), at most 4 levels (an 8-column chunk of level 0 pools
# into levels 1-3), one block per multiprocessor.
PYRAMID_WGMMA_BM = 128
PYRAMID_WGMMA_WIDTHS = (64, 96, 128, 160, 192, 240, 256)
PYRAMID_WGMMA_THREADS = 384
PYRAMID_WGMMA_BOX, PYRAMID_WGMMA_BOX_BYTES = 64, 8192
PYRAMID_WGMMA_MIN_STAGES, PYRAMID_WGMMA_MAX_STAGES = 2, 4
PYRAMID_WGMMA_LEVELS = 4
PYRAMID_WGMMA_BLOCKS_PER_SM = 1
# csrc/corr_scatter.cu: the run of queries a block of 256 threads owns
# (32-128 time within 2% of each other on the H100, PERF.md row 2).
SCATTER_RUN = 64
# csrc/corr_window.cuh, the kernel of both lookups: blocks of 8 warps (its
# __launch_bounds__ asks for 3 per multiprocessor), a warp per run of
# queries; the compile-time instantiation's radius and level count; a
# stage's coordinate bytes.
PREFETCH_WARPS = 8
PREFETCH_BLOCKS_PER_SM = 3
PREFETCH_USUAL = (4, 4)
PREFETCH_COORD_BYTES = 128
PREFETCH_MAX_STAGES = 3
PREFETCH_PATHS = {"usual": 0, "generic": 1, "element": 2}
# H100 limit: the grid's x.
MAX_GRID_X = 2**31 - 1
INT32_MAX = 2**31 - 1


class PyramidPlan(NamedTuple):
    """A launch of `csrc/corr_pyramid.cu`'s kernel `path` ("ffma", "mma" or
    "wgmma"): tiles of W1 x W2 (`tile`), `m_tiles` x `n_tiles` per row, the
    tiles of a row consecutive; "ffma" and "mma" launch one block of
    `threads` per tile, "wgmma" `blocks` persistent blocks that walk the
    tile list (tile t, t + blocks, ...) with a ring of `stages` k64 slots;
    `vec` elements per copy (16 bytes along W: 4 fp32 or 8 bf16; 1: one
    element); `direct`: the fp32 epilogue pools and stores from the
    registers."""

    tile: Tuple[int, int]
    threads: int
    vec: int
    m_tiles: int
    n_tiles: int
    blocks: int
    shared_bytes: int
    direct: bool
    path: str = "ffma"
    stages: int = 0


def pyramid_shared_bytes(tile: Tuple[int, int], elem_bytes: int = 4) -> int:
    """The ring of D chunks of both operands (elements of `elem_bytes`,
    each staged row padded by 16 bytes) or the epilogue's padded fp32 volume
    tile, which aliases it: whichever is larger (the "ffma" and "mma"
    kernels)."""
    bm, bn = tile
    pad = PYRAMID_PAD * 4 // elem_bytes
    ring = PYRAMID_STAGES * PYRAMID_TK * (bm + bn + 2 * pad) * elem_bytes
    return max(ring, 4 * bm * (bn + 1))


def pyramid_wgmma_shared_bytes(width: int, stages: int) -> int:
    """The wgmma kernel's shared bytes (`WgTile<N>::shared_bytes`): 1024 to
    align the ring to a swizzle atom; `stages` slots of two fmap1 boxes and
    ceil(width / 64) fmap2 boxes; the two consumer warpgroups' bf16 staging
    tiles of 64 rows by width + 8; a full and an empty barrier per slot."""
    boxes = -(-width // PYRAMID_WGMMA_BOX)
    slot = (PYRAMID_WGMMA_BM // PYRAMID_WGMMA_BOX + boxes) * PYRAMID_WGMMA_BOX_BYTES
    return 1024 + stages * slot + PYRAMID_WGMMA_BM * (width + 8) * 2 + 16 * stages


def pyramid_wgmma_width(w2: int, levels: int) -> int:
    """The wgmma tile's W2 width for rows of `w2`: among the instantiated
    widths that are multiples of 2**(L-1), the one of least tiles x (width
    + 64) (the MMA columns plus a tile's fixed cost), the wider on a tie:
    a width that divides W2 where one does (720 -> 240, 192 -> 192)."""
    step = 1 << (levels - 1)
    admissible = [n for n in PYRAMID_WGMMA_WIDTHS if n % step == 0]
    return min(admissible, key=lambda n: (-(-w2 // n) * (n + 64), -n))


def _pyramid_cost(tile: Tuple[int, int], rows: int, w1: int, w2: int, sms: int) -> int:
    """Relative time of a tile's grid on a card of `sms` multiprocessors:
    its waves (blocks over the blocks the card holds at once) times the
    FFMAs of a block."""
    bm, bn = tile
    blocks = rows * -(-w1 // bm) * -(-w2 // bn)
    return -(-blocks // (sms * PYRAMID_BLOCKS_PER_SM)) * bm * bn


def pyramid_plan(b: int, h: int, w1: int, w2: int, d: int, levels: int, strides: Sequence[int],
                 sms: int, aligned: bool = True, elem_bytes: int = 4) -> PyramidPlan:
    """The launch plan of the pyramid kernel for fmap1 (B, H, W1, D) and
    fmap2 (B, H, W2, D) with element strides `strides` (b, h, w, d of fmap1
    then fmap2) on a card of `sms` multiprocessors; `aligned`: both base
    addresses are 16-byte aligned; `elem_bytes`: 4 for fp32 operands and
    levels, 2 for bf16.

    Copies move 16 bytes (4 fp32 or 8 bf16 elements) only where W is the
    unit-stride axis of both maps and every other stride that moves is a
    multiple of that many elements. fp32: the "ffma" kernel; among the
    tiles whose W2 extent is a multiple of 2**(L-1) (the pooling stays
    inside a block), the one of least `_pyramid_cost`, the larger on a tie;
    its epilogue pools in the registers (`direct`) where every level row
    starts 16-byte aligned (W2 a multiple of 4: it stores float4 runs) and
    there are at most 6 levels. bf16: the "wgmma" kernel where its tensor
    maps and stores take the shape (16-byte copies, so every moving stride
    is a multiple of 16 bytes; W2 a multiple of 8, so every level row and
    8-column chunk starts aligned for its vector stores; at most 4 levels),
    with `pyramid_wgmma_width`'s W2 width, the deepest ring of 2-4 slots
    that fits and one block per multiprocessor up to the tile count;
    otherwise the "mma" kernel's 128 x 128 tile (the realtime model's
    KITTI bucket, W 156, and other widths, the contiguous (B, H, W, D)
    layout, more levels). Raises for what no instantiation takes."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"corr_pyramid kernel takes fp32 or bf16 (2 or 4 bytes), got {elem_bytes}")
    if not 1 <= levels <= PYRAMID_MAX_LEVELS:
        raise ValueError(f"corr_pyramid kernel takes 1..{PYRAMID_MAX_LEVELS} levels, got {levels}")
    if len(strides) != 8 or min(b, h, w1, w2, d) < 0:
        raise ValueError(f"corr_pyramid kernel: bad shape {(b, h, w1, w2, d)} or strides {tuple(strides)}")
    sizes = (b, h, w1, d, b, h, w2, d)
    moving = [s for i, (s, n) in enumerate(zip(strides, sizes)) if n > 1 and i not in (2, 6)]
    unit_w = all(n <= 1 or strides[i] == 1 for i, n in ((2, w1), (6, w2)))
    run = 16 // elem_bytes
    vec = run if aligned and unit_w and all(s % run == 0 for s in moving) else 1
    if elem_bytes == 2 and vec == run and w2 % 8 == 0 and levels <= PYRAMID_WGMMA_LEVELS and d >= 1:
        width = pyramid_wgmma_width(w2, levels)
        stages = max((s for s in range(PYRAMID_WGMMA_MIN_STAGES, PYRAMID_WGMMA_MAX_STAGES + 1)
                      if pyramid_wgmma_shared_bytes(width, s) <= _build.MAX_SHARED_BYTES), default=0)
        if not stages:
            raise ValueError(f"corr_pyramid kernel: no ring of a {width}-wide tile fits "
                             f"{_build.MAX_SHARED_BYTES} bytes")
        m_tiles, n_tiles = -(-w1 // PYRAMID_WGMMA_BM), -(-w2 // width)
        tiles = b * h * m_tiles * n_tiles
        if tiles > INT32_MAX:
            raise ValueError(f"corr_pyramid kernel: {tiles} tiles exceed int32")
        return PyramidPlan((PYRAMID_WGMMA_BM, width), PYRAMID_WGMMA_THREADS, vec, m_tiles, n_tiles,
                           min(tiles, sms * PYRAMID_WGMMA_BLOCKS_PER_SM), pyramid_wgmma_shared_bytes(width, stages),
                           False, "wgmma", stages)
    if elem_bytes == 2:
        tile = PYRAMID_MMA_TILE
    else:
        admissible = [t for t in PYRAMID_TILES if t[1] % (1 << (levels - 1)) == 0]
        tile = min(admissible, key=lambda t: (_pyramid_cost(t, b * h, w1, w2, sms), -t[0] * t[1]))
    m_tiles, n_tiles = -(-w1 // tile[0]), -(-w2 // tile[1])
    blocks = b * h * m_tiles * n_tiles
    if blocks > MAX_GRID_X:
        raise ValueError(f"corr_pyramid kernel: {blocks} blocks exceed the grid's {MAX_GRID_X}")
    shared = pyramid_shared_bytes(tile, elem_bytes)
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(f"corr_pyramid kernel: {shared} shared bytes exceed {_build.MAX_SHARED_BYTES}")
    if elem_bytes == 2:
        return PyramidPlan(tile, PYRAMID_MMA_THREADS, vec, m_tiles, n_tiles, blocks, shared, False, "mma")
    tm, tn = PYRAMID_TILES[tile]
    direct = w2 % 4 == 0 and levels <= PYRAMID_REG_LEVELS
    return PyramidPlan(tile, (tile[0] // tm) * (tile[1] // tn), vec, m_tiles, n_tiles, blocks, shared, direct)


class ScatterPlan(NamedTuple):
    """A launch of `csrc/corr_scatter.cu`: block i owns queries
    [i * run, min((i + 1) * run, n_queries)); `wide`: 64-bit indexing;
    `vec`: output elements per 16-byte store (4 fp32 or 8 bf16)."""

    run: int
    blocks: int
    shared_bytes: int
    wide: bool
    vec: int


def scatter_shared_bytes(run: int, levels: int, radius: int) -> int:
    """Cotangents, combined weights, window starts and coordinates of a run,
    all 4 bytes an element whatever the cotangent's and levels' dtypes (a
    bf16 cotangent is widened to fp32 as it is staged; the weights are
    fp32 until the store rounds them)."""
    taps = 2 * radius + 1
    return 4 * run * (levels * taps + levels * (taps + 2) + 1)


def scatter_plan(n_queries: int, widths: Sequence[int], radius: int, elem_bytes: int = 4) -> ScatterPlan:
    """The launch plan of the scatter kernel for levels of `elem_bytes` (4
    fp32, 2 bf16): SCATTER_RUN queries per block, halved until its shared
    memory fits, one block per run, 64-bit indexing past 2**31 - 1 outputs
    (or cotangents) and 16 // elem_bytes elements per vector store. The
    index limits count elements, so they are the same for both dtypes; the
    element size sets only the vector width. Raises for what the kernel
    does not take."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"corr_scatter kernel stores fp32 or bf16 levels (4 or 2 bytes), got {elem_bytes}")
    levels = len(widths)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"corr_scatter kernel takes 1..{MAX_LEVELS} levels, got {levels}")
    if radius < 0 or n_queries < 0 or any(not 0 <= w < 2**24 for w in widths):
        raise ValueError(f"corr_scatter kernel: bad radius {radius}, queries {n_queries} or widths {tuple(widths)}")
    run = SCATTER_RUN
    while run > 1 and scatter_shared_bytes(run, levels, radius) > _build.MAX_SHARED_BYTES:
        run //= 2
    shared = scatter_shared_bytes(run, levels, radius)
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(f"corr_scatter kernel: a run of {run} queries needs {shared} shared bytes")
    if run * max(max(widths), levels * (2 * radius + 1)) > INT32_MAX:
        raise ValueError(f"corr_scatter kernel: a run's span of {run} x {max(widths)} exceeds int32")
    blocks = -(-n_queries // run)
    if blocks > MAX_GRID_X:
        raise ValueError(f"corr_scatter kernel: {blocks} blocks exceed the grid's {MAX_GRID_X}")
    wide = n_queries * max(sum(widths), levels * (2 * radius + 1)) > INT32_MAX
    return ScatterPlan(run, blocks, shared, wide, 16 // elem_bytes)


class PrefetchPlan(NamedTuple):
    """A launch of the lookup kernel of `csrc/corr_window.cuh` (through
    either entry point, `csrc/corr_lookup.cu` or `csrc/corr_prefetch.cu`):
    kernel `path` ("usual": radius 4 and 4 levels at compile time;
    "generic": any radius and level count;
    both stage each window's 16-byte chunks in a ring of `stages` per warp;
    "element": each sample loaded by its tap, for levels whose base is not
    16-byte aligned), `run` queries per warp run (run i covers queries
    [i * run, min((i + 1) * run, n_queries))), window slots of `slot_bytes`,
    `blocks` persistent blocks of PREFETCH_WARPS warps, warp w of the grid
    taking runs w, w + warps, ..., and `shared_bytes` per block."""

    path: str
    run: int
    stages: int
    slot_bytes: int
    blocks: int
    shared_bytes: int


def prefetch_chunks(radius: int, level_bytes: int) -> int:
    """16-byte chunks that a window of 2r+3 samples of `level_bytes` can
    span, at any of its alignments."""
    v = 16 // level_bytes
    return (2 * radius + 3 + v - 2) // v + 1


def prefetch_run(levels: int, radius: int, out_bytes: int) -> int:
    """Queries per warp run: the most whose (query, level) pairs fit a warp
    and whose output span (run x L x (2r+1) taps of `out_bytes`) is a
    multiple of 16 bytes, so every run's span starts 16-byte aligned; the
    most that fit a warp if none is (the kernel then writes each span's
    partial first and last chunks element by element)."""
    most = 32 // levels
    return next((q for q in range(most, 0, -1) if q * levels * (2 * radius + 1) * out_bytes % 16 == 0), most)


def prefetch_shared_bytes(path: str, run: int, levels: int, radius: int, out_bytes: int, stages: int,
                          slot_bytes: int) -> int:
    """A block's shared bytes (`warp_bytes` of csrc/corr_window.cuh, times
    its warps): per warp, `stages` stages of the run's coordinates and 32
    window slots (none on the element path), then the output staging (the
    run's taps and 16 bytes of room for the span's phase, rounded up to 16)."""
    stage = PREFETCH_COORD_BYTES + (0 if path == "element" else 32 * slot_bytes)
    ostage = -(-(run * levels * (2 * radius + 1) * out_bytes + 16) // 16) * 16
    return PREFETCH_WARPS * (stages * stage + ostage)


@functools.lru_cache(maxsize=256)
def prefetch_plan(n_queries: int, widths: Sequence[int], radius: int, level_bytes: int, out_bytes: int,
                  sms: int, aligned: bool = True) -> PrefetchPlan:
    """The launch plan of the lookup kernel for `n_queries` queries of
    levels `widths` (elements of `level_bytes`, 4 fp32 or 2 bf16) and taps
    of `out_bytes` on a card of `sms` multiprocessors; `aligned`: every
    level's base is 16-byte aligned. The staged paths need aligned levels
    (their chunks count from the level's base): "usual" at radius 4 with 4
    levels, "generic" otherwise, each with the deepest ring of 3 or 2
    stages whose block fits the shared memory; the element path takes
    unaligned levels and windows too large to stage, with fewer queries
    per run where a run's taps would not fit its output staging. Row and
    output offsets are 64-bit on every path, so levels past 2**31 elements
    need no other one. Grid: one warp per run up to PREFETCH_BLOCKS_PER_SM
    blocks per multiprocessor (fewer where the shared memory holds fewer).
    Raises for what no instantiation takes."""
    if level_bytes not in (2, 4) or out_bytes not in (2, 4):
        raise ValueError(f"corr lookup kernel takes fp32 or bf16 levels and taps, got {level_bytes} and "
                         f"{out_bytes} bytes")
    levels = len(widths)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"corr lookup kernel takes 1..{MAX_LEVELS} levels, got {levels}")
    if radius < 0 or n_queries < 0 or any(not 0 <= w < 2**24 for w in widths):
        raise ValueError(f"corr lookup kernel: bad radius {radius}, queries {n_queries} or widths {tuple(widths)}")
    run = prefetch_run(levels, radius, out_bytes)
    path, stages, slot = "element", 1, 0
    if aligned:
        ch = prefetch_chunks(radius, level_bytes)
        slot_bytes = 16 * (ch | 1)  # an odd count of chunks: 8 lanes' 16-byte reads hit distinct banks
        staged = "usual" if (radius, levels) == PREFETCH_USUAL else "generic"
        fits = [s for s in range(PREFETCH_MAX_STAGES, 1, -1)
                if prefetch_shared_bytes(staged, run, levels, radius, out_bytes, s, slot_bytes)
                <= _build.MAX_SHARED_BYTES]
        if fits:
            path, stages, slot = staged, fits[0], slot_bytes
    if path == "element":
        run = next((q for q in range(run, 0, -1)
                    if prefetch_shared_bytes(path, q, levels, radius, out_bytes, 1, 0) <= _build.MAX_SHARED_BYTES), run)
    shared = prefetch_shared_bytes(path, run, levels, radius, out_bytes, stages, slot)
    if shared > _build.MAX_SHARED_BYTES:
        raise ValueError(f"corr lookup kernel: a block of runs of {run} queries with {levels} levels at radius "
                         f"{radius} needs {shared} shared bytes")
    per_sm = min(PREFETCH_BLOCKS_PER_SM, _build.MAX_SHARED_BYTES // (shared + 1024))
    runs = -(-n_queries // run)
    blocks = min(-(-runs // PREFETCH_WARPS), sms * per_sm)
    return PrefetchPlan(path, run, stages, slot, blocks, shared)


def corr_state(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int,
               corr_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
    """fmap1 (B, H, W1, D), fmap2 (B, H, W2, D) -> the L contiguous pyramid
    levels (B, H, W1, W2 // 2**l) in `corr_dtype` (fp32 or bf16; the JAX
    package's `pallas_corr_state` values)."""
    return tuple(corr.corr_pyramid(corr.corr_volume(fmap1, fmap2, corr_dtype), levels))


def fused_pyramid_state(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int,
                        corr_dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
    """`corr_state` in one kernel launch: fmap1 (B, H, W1, D), fmap2
    (B, H, W2, D), any strides (the model passes permuted views of its NCHW
    feature maps, which the kernel reads in place) -> the L contiguous
    levels (B, H, W1, W2 // 2**l) in `corr_dtype`. The kernel's operands
    are in `corr_dtype` too: maps of another dtype are cast first (the bf16
    contract rounds fp32 maps to bf16; bf16 maps of an fp32 pyramid widen
    exactly), keeping their strides."""
    if not fmap1.is_cuda:
        return corr_state(fmap1, fmap2, levels, corr_dtype)
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    if tuple(fmap2.shape) != (b, h, w2, d):
        raise ValueError(f"fmap2 shape {tuple(fmap2.shape)} does not match fmap1 {tuple(fmap1.shape)}")
    if corr_dtype not in _build.DTYPE_FLAGS:
        raise ValueError(f"corr_pyramid kernel builds fp32 or bf16 levels, not {corr_dtype}")
    for t in (fmap1, fmap2):
        if t.device != fmap1.device or t.dtype not in _build.DTYPE_FLAGS:
            raise ValueError("corr_pyramid kernel needs fp32 or bf16 tensors on one CUDA device")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("corr_pyramid kernel has no backward; call it without grad")
    fmap1, fmap2 = fmap1.to(corr_dtype), fmap2.to(corr_dtype)
    plan = pyramid_plan_for(fmap1, fmap2, levels)
    out = tuple(torch.empty((b, h, w1, w2 >> l), dtype=corr_dtype, device=fmap1.device)
                for l in range(levels))
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in out])
    strides = (ctypes.c_longlong * 8)(*fmap1.stride(), *fmap2.stride())
    lib = _pyramid_lib()
    status = lib.raft_corr_pyramid(
        fmap1.data_ptr(), fmap2.data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        b, h, w1, w2, d, levels, ctypes.cast(ptrs, ctypes.c_void_p),
        *plan.tile, plan.vec, plan.m_tiles, plan.n_tiles, plan.blocks, plan.shared_bytes,
        int(plan.direct), PYRAMID_PATHS[plan.path], plan.stages,
        torch.cuda.current_stream(fmap1.device).cuda_stream,
    )
    _build.check(status, "corr_pyramid kernel", lib.raft_corr_pyramid_error_string)
    _build.count_launch(LAUNCHES, "corr_pyramid_bf16" if corr_dtype == torch.bfloat16 else "corr_pyramid")
    return out


def pyramid_plan_for(fmap1: torch.Tensor, fmap2: torch.Tensor, levels: int) -> PyramidPlan:
    """`pyramid_plan` for these CUDA feature maps (both of the pyramid's
    dtype): their shapes, strides, element size, base-address alignment and
    their card's multiprocessors."""
    b, h, w1, d = fmap1.shape
    return pyramid_plan(b, h, w1, fmap2.shape[2], d, levels, (*fmap1.stride(), *fmap2.stride()),
                        _build.multiprocessors(fmap1.device.index), _build.aligned((fmap1, fmap2)),
                        fmap1.element_size())


def _pyramid_lib():
    lib = _build.load("corr_pyramid")
    fn = lib.raft_corr_pyramid
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 3  # fmap1, fmap2, host array of the 8 element strides
            + [ctypes.c_int] * 6  # B, H, W1, W2, D, levels
            + [ctypes.c_void_p]  # host array of level pointers
            + [ctypes.c_int] * 5  # plan: tile (W1, W2 extent), vec, m_tiles, n_tiles
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # plan: blocks, shared bytes, direct
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # plan: path, ring slots; stream
        )
        fn.restype = ctypes.c_int
        lib.raft_corr_pyramid_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_pyramid_error_string.restype = ctypes.c_char_p
    return lib


# The C signature of both lookup entry points.
_LOOKUP_ARGTYPES = [
    ctypes.c_void_p,  # coords
    ctypes.c_void_p,  # host array of level pointers
    ctypes.c_void_p,  # host array of level widths (int32)
    ctypes.c_int,  # num_levels
    ctypes.c_longlong,  # n_queries
    ctypes.c_int,  # radius
    ctypes.c_void_p,  # out
    ctypes.c_int,  # the levels are bf16
    ctypes.c_int,  # the taps are bf16
    ctypes.c_int,  # plan: path
    ctypes.c_int,  # plan: queries per run
    ctypes.c_int,  # plan: ring stages
    ctypes.c_int,  # plan: window slot bytes
    ctypes.c_int,  # plan: blocks
    ctypes.c_int,  # plan: shared bytes
    ctypes.c_void_p,  # stream
]


def _lookup_lib(source: str, entry: str, error_string: str):
    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _LOOKUP_ARGTYPES
        fn.restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
    return fn, getattr(lib, error_string)


def corr_lookup(state: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Taps of every pyramid level (fp32 or bf16) around `coords` (B, H, W1):
    (B, H, W1, L*(2r+1)) in `out_dtype` (fp32 or bf16; None: fp32, or the
    plain version's own dtype on the CPU), level-major; zero outside
    [0, W2_l). The interpolation is fp32 and each tap is rounded once to
    `out_dtype`. Under autograd (grad mode on and a level or `coords`
    requiring grad) the result is differentiable in the levels, fp32 or
    bf16, through `CorrLookup`."""
    levels = tuple(state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (coords, *levels)):
        return CorrLookup.apply(coords, radius, out_dtype, *levels)
    return _lookup(levels, coords, radius, out_dtype)


def _lookup(levels: Tuple[torch.Tensor, ...], coords: torch.Tensor, radius: int,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The lookup without autograd: the kernel (through `csrc/corr_lookup.cu`,
    planned by `prefetch_plan`) for CUDA tensors, the plain version
    (`ops/corr.py` `corr_lookup`, then one cast) for CPU tensors."""
    if not coords.is_cuda:
        return _plain_lookup(levels, coords, radius, out_dtype)
    return _launch_lookup("corr_lookup", ("corr_lookup", "raft_corr_lookup", "raft_corr_error_string"),
                          levels, coords, radius, out_dtype)


def _plain_lookup(levels, coords, radius, out_dtype):
    """The plain version of both lookup kernels: `ops/corr.py` `corr_lookup`,
    then one cast to `out_dtype` (None: its own dtype)."""
    taps = corr.corr_lookup(levels, coords, radius)
    return taps if out_dtype is None else taps.to(out_dtype)


def _launch_lookup(name, lib_names, levels, coords, radius, out_dtype=None) -> torch.Tensor:
    """Check the operands of the lookup kernel, launch it through one entry
    point (`lib_names` = source, entry point, error-string function) on the
    current stream with its `prefetch_plan`, count the launch under `name`
    (or `name`_bf16 for bf16 levels or taps) and return its taps: fp32
    coordinates, levels all of the first one's dtype (fp32 or bf16), output
    in `out_dtype` (fp32 or bf16; None: fp32)."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in _build.DTYPE_FLAGS or levels[0].dtype not in _build.DTYPE_FLAGS:
        raise ValueError(f"{name} kernel takes fp32 or bf16 levels and taps, got {levels[0].dtype} "
                         f"and {out_dtype}")
    b, h, w1 = coords.shape
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{name} kernel takes 1..{MAX_LEVELS} levels, got {len(levels)}")
    for t in (coords, *levels):
        want = torch.float32 if t is coords else levels[0].dtype
        if t.device != coords.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors on one CUDA device: fp32 coordinates, "
                             "levels of one dtype")
    for lvl in levels:
        if lvl.dim() != 4 or tuple(lvl.shape[:3]) != (b, h, w1):
            raise ValueError(f"level shape {tuple(lvl.shape)} does not match coords {(b, h, w1)}")
    plan = prefetch_plan_for(levels, coords, radius, out_dtype)
    out = torch.empty((b, h, w1, len(levels) * (2 * radius + 1)), dtype=out_dtype, device=coords.device)
    ptrs = (ctypes.c_void_p * len(levels))(*[lvl.data_ptr() for lvl in levels])
    widths = (ctypes.c_int * len(levels))(*[lvl.shape[-1] for lvl in levels])
    fn, error_string = _lookup_lib(*lib_names)
    status = fn(
        coords.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(widths, ctypes.c_void_p),
        len(levels),
        b * h * w1,
        radius,
        out.data_ptr(),
        _build.DTYPE_FLAGS[levels[0].dtype],
        _build.DTYPE_FLAGS[out_dtype],
        PREFETCH_PATHS[plan.path], plan.run, plan.stages, plan.slot_bytes, plan.blocks, plan.shared_bytes,
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, f"{name} kernel", error_string)
    _build.count_launch(LAUNCHES, f"{name}_bf16" if torch.bfloat16 in (levels[0].dtype, out_dtype) else name)
    return out


def prefetch_plan_for(levels: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                      out_dtype: Optional[torch.dtype] = None) -> PrefetchPlan:
    """`prefetch_plan` for these CUDA levels and coordinates: the query
    count, the levels' widths, element size and base alignment, the taps'
    dtype (None: fp32) and the card's multiprocessors."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    level_bytes = levels[0].element_size() if levels else 4  # no levels: prefetch_plan raises
    return prefetch_plan(coords.numel(), tuple(lvl.shape[-1] for lvl in levels), radius, level_bytes,
                         torch.finfo(out_dtype).bits // 8, _build.multiprocessors(coords.device.index),
                         _build.aligned(levels))


def prefetch_corr_lookup(state: Sequence[torch.Tensor], coords: torch.Tensor, radius: int,
                         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`corr_lookup`'s taps through the windowed entry point
    `csrc/corr_prefetch.cu` for CUDA tensors (the counterpart of the JAX
    package's `prefetch_corr_lookup_padded`; the same kernel as
    `corr_lookup`'s, so bit for bit its output on every input, fp32 or bf16
    levels and taps in `out_dtype` as `corr_lookup` takes them), counted
    under "corr_prefetch_lookup[_bf16]"; by the plain lookup (`ops/corr.py`
    `corr_lookup`, then one cast) for CPU tensors. No backward: raises where
    autograd would record."""
    levels = tuple(state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (coords, *levels)):
        raise RuntimeError("prefetch_corr_lookup has no backward (test-mode forwards only); "
                           "call it without grad or use corr_lookup")
    if not coords.is_cuda:
        return _plain_lookup(levels, coords, radius, out_dtype)
    return _launch_lookup("corr_prefetch_lookup",
                          ("corr_prefetch", "raft_corr_prefetch", "raft_corr_prefetch_error_string"),
                          levels, coords, radius, out_dtype)


class CorrLookup(torch.autograd.Function):
    """`corr_lookup` with the JAX package's gradient contract
    (`pallas_corr_lookup_padded`): d(levels) by `corr_scatter`, each in its
    level's dtype, none to `coords`. Saves only the coordinates and the
    levels' widths and dtypes; the backward needs no level values. The taps
    are stored in `out_dtype`, so the cotangent arrives in it (bf16 taps
    give a bf16 cotangent, which the scatter reads in place)."""

    @staticmethod
    def forward(ctx, coords: torch.Tensor, radius: int, out_dtype: Optional[torch.dtype],
                *levels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.widths = tuple(lvl.shape[-1] for lvl in levels)
        ctx.dtypes = tuple(lvl.dtype for lvl in levels)
        return _lookup(levels, coords, radius, out_dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (coords,) = ctx.saved_tensors
        d_levels = corr_scatter(coords, grad.contiguous(), ctx.widths, ctx.radius, ctx.dtypes)
        return (None, None, None, *d_levels)


def _scatter_lib():
    lib = _build.load("corr_scatter")
    fn = lib.raft_corr_scatter
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p,  # coords
            ctypes.c_void_p,  # grad
            ctypes.c_void_p,  # host array of level pointers
            ctypes.c_void_p,  # host array of level widths (int32)
            ctypes.c_int,  # num_levels
            ctypes.c_longlong,  # n_queries
            ctypes.c_int,  # radius
            ctypes.c_int,  # plan: queries per block
            ctypes.c_longlong,  # plan: blocks
            ctypes.c_int,  # plan: shared bytes
            ctypes.c_int,  # plan: 64-bit indexing
            ctypes.c_int,  # plan: elements per vector store
            ctypes.c_int,  # the cotangent is bf16
            ctypes.c_int,  # the levels are bf16
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.raft_corr_scatter_error_string.argtypes = [ctypes.c_int]
        lib.raft_corr_scatter_error_string.restype = ctypes.c_char_p
    return lib


def corr_scatter(coords: torch.Tensor, grad: torch.Tensor, widths: Sequence[int], radius: int,
                 dtypes: Optional[Sequence[torch.dtype]] = None) -> Tuple[torch.Tensor, ...]:
    """d(pyramid) of the lookup: coords (B, H, W1) at level-0 resolution,
    grad (B, H, W1, L*(2r+1)) the tap cotangent -> L dense levels
    (B, H, W1, widths[l]), level l in dtypes[l] (None: the cotangent's
    compute dtype, fp32 for an fp32 or bf16 cotangent). One launch of
    `csrc/corr_scatter.cu` for CUDA tensors, which takes fp32 coordinates,
    an fp32 or bf16 cotangent and levels all fp32 or all bf16, and raises
    for anything else; `plain_corr_scatter` for CPU tensors."""
    if not coords.is_cuda:
        return plain_corr_scatter(coords, grad, widths, radius, dtypes)
    b, h, w1 = coords.shape
    levels = len(widths)
    dtypes = (torch.float32,) * levels if dtypes is None else tuple(dtypes)
    if len(dtypes) != levels or len(set(dtypes)) != 1 or dtypes[0] not in _build.DTYPE_FLAGS:
        raise ValueError(f"corr_scatter kernel stores levels all fp32 or all bf16, got {dtypes}")
    if grad.dtype not in _build.DTYPE_FLAGS:
        raise ValueError(f"corr_scatter kernel takes an fp32 or bf16 cotangent, got {grad.dtype}")
    out_dtype = dtypes[0]
    plan = scatter_plan(b * h * w1, widths, radius, torch.finfo(out_dtype).bits // 8)
    if tuple(grad.shape) != (b, h, w1, levels * (2 * radius + 1)):
        raise ValueError(f"grad shape {tuple(grad.shape)} does not match coords {(b, h, w1)} "
                         f"with {levels} levels of {2 * radius + 1} taps")
    if coords.dtype != torch.float32 or grad.device != coords.device or not (
            coords.is_contiguous() and grad.is_contiguous()):
        raise ValueError("corr_scatter kernel needs contiguous tensors on one CUDA device, fp32 coordinates")
    out = tuple(torch.empty((b, h, w1, w), dtype=out_dtype, device=coords.device) for w in widths)
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in out])
    c_widths = (ctypes.c_int * levels)(*widths)
    lib = _scatter_lib()
    status = lib.raft_corr_scatter(
        coords.data_ptr(),
        grad.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(c_widths, ctypes.c_void_p),
        levels,
        b * h * w1,
        radius,
        plan.run,
        plan.blocks,
        plan.shared_bytes,
        int(plan.wide),
        plan.vec,
        _build.DTYPE_FLAGS[grad.dtype],
        _build.DTYPE_FLAGS[out_dtype],
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, "corr_scatter kernel", lib.raft_corr_scatter_error_string)
    _build.count_launch(LAUNCHES, "corr_scatter_bf16" if torch.bfloat16 in (grad.dtype, out_dtype) else "corr_scatter")
    return out


def plain_corr_scatter(coords: torch.Tensor, grad: torch.Tensor, widths: Sequence[int], radius: int,
                       dtypes: Optional[Sequence[torch.dtype]] = None) -> Tuple[torch.Tensor, ...]:
    """The function of `corr_scatter` in plain PyTorch: per level, x =
    coords / 2**l, one fraction f = x - floor(x) for every tap, and sample
    floor(x) - r + m of the query's row gets cw[m] = g[m](1-f) + g[m-1]f,
    m = 0..2r+1 (g[-1] = g[2r+1] = 0); all other samples are zero. cw is
    computed in fp32 (a bf16 cotangent widened, which is exact; a float64
    one stays float64) and each level is cast once to dtypes[l] (None: that
    compute dtype)."""
    k = 2 * radius + 1
    grad = grad.to(torch.promote_types(grad.dtype, torch.float32))
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
        d = torch.gather(torch.cat([cw, zero], dim=-1), -1, idx)
        out.append(d if dtypes is None else d.to(dtypes[lvl]))
    return tuple(out)
