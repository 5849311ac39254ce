"""Launch plans of the port's pyramid build and scatter kernels
(ops/corr_cuda.py `pyramid_plan`, `scatter_plan`), checked without a card:
the plans are plain Python and the kernels launch exactly what they say.

Pyramid: every W2 tile starts at a multiple of 2**(L-1) (the pooling chain
stays inside a block), the blocks' tiles cover [0, W1) x [0, W2) of every
row exactly once, the grid and block are within CUDA's limits, the shared
bytes within the H100's 227 KB, 16-byte copies (4 fp32 or 8 bf16 elements)
only where W is the unit-stride axis and every other moving stride and both
base addresses are 16-byte aligned, the register epilogue only where level
rows start aligned for its 4-element runs (W2 a multiple of 4) and L <= 6,
and an input no instantiation takes raises. The bf16 build (elem_bytes 2)
takes a tensor-core kernel: the wgmma kernel where its TMA tensor maps and
vector stores take the shape (128 x N tiles, N dividing W2 where an
instantiated width does, a multiple of 2**(L-1) and at most 256; persistent
blocks, at most one per multiprocessor, that walk every tile once; a ring
of 2-4 slots within the shared memory), else the mma.sync kernel's 128 x
128 tile with its own copy width and shared bytes.
Conv (ops/encoder_cuda.py `conv_plan`, the bf16 kernel): persistent blocks
that walk every (batch, tile) once, the shared bytes, and the TMA raw tile
only where W is a multiple of 8 and the tensors are 16-byte aligned.
Scatter: the runs of queries cover every query exactly once (also where the
count is not a multiple of the run), the shared bytes fit, and 64-bit
indexing is chosen past 2**31 - 1 outputs. The bf16 levels (elem_bytes 2)
take the same runs, shared bytes and index limits (all counted in elements
or fp32 staging), and 8 elements per 16-byte store: every level's span of
a block splits into an element-by-element head up to its first 16-byte
boundary, whole vectors and an element-by-element tail.

Streaming grid (ops/_build.py `stream_blocks`, the GRU tail, motion
tail and gate pair kernels): one thread per unit of work, at most 32
blocks of 256 per multiprocessor of the card, at least one block; on an
H100's 132 the grid the kernels computed for themselves before the count
was read from the device, and every unit covered by the grid-stride loop.

`block_tile`, `block_queries` and `span_split` below restate how the kernels
map a block to its work; that the .cu files derive the same mapping is shown only on the
card (chip_smoke.py PYRAMID_CASES, PYRAMID_BF16_CASES, BF16_CONV_SHAPES and
SCATTER_CASES, and the gpu-marked tests in test_torch_encoder.py,
test_torch_corr.py and test_torch_mixed.py).
"""

import numpy as np
import pytest
import torch

from raft_stereo_tpu_torch.ops import _build, corr_cuda
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

WIDTHS = [1, 5, 32, 37, 96, 128, 150, 192, 720, 800]
SMS = 132  # multiprocessors of an H100 SXM


def model_strides(b, h, w, d=256):
    """Element strides (b, h, w, d) of a permuted NCHW feature map, twice."""
    return (d * h * w, w, 1, h * w) * 2


def contiguous_strides(b, h, w, d=256):
    """Element strides of a contiguous (B, H, W, D) map, twice."""
    return (h * w * d, w * d, d, 1) * 2


def block_tile(plan, block):
    """(row, W1 start, W2 start) of `block`, as csrc/corr_pyramid.cu derives it."""
    row, rem = divmod(block, plan.m_tiles * plan.n_tiles)
    return row, (rem // plan.n_tiles) * plan.tile[0], (rem % plan.n_tiles) * plan.tile[1]


def assert_covered_once(plan, rows, w1, w2):
    """Every (row, w1, w2) cell is covered by exactly one block; every tile
    starts inside the map. A row's blocks are consecutive, so one row's
    counts are held at a time."""
    bm, bn = plan.tile
    per_row = plan.m_tiles * plan.n_tiles
    assert plan.blocks == rows * per_row
    for r in range(rows):
        count = np.zeros((w1, w2), np.int32)
        for block in range(r * per_row, (r + 1) * per_row):
            row, m0, n0 = block_tile(plan, block)
            assert row == r and 0 <= m0 < w1 and 0 <= n0 < w2
            count[m0:m0 + bm, n0:n0 + bn] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("w", WIDTHS)
def test_pyramid_plan_tiles_cover_once_and_keep_pooling_in_a_block(w):
    """At a few rows and at a wave's worth, where the plan may pick the
    other tile, for 1, 4 and the most levels."""
    d = 256
    tiles = set()
    for b, h in ((2, 3), (1, 128)):
        for levels in (1, 4, corr_cuda.PYRAMID_MAX_LEVELS):
            step = 1 << (levels - 1)
            plan = corr_cuda.pyramid_plan(b, h, w, w, d, levels, model_strides(b, h, w), SMS)
            tiles.add(plan.tile)
            assert plan.tile in corr_cuda.PYRAMID_TILES
            assert plan.tile[1] % step == 0
            assert plan.blocks == b * h * plan.m_tiles * plan.n_tiles
            assert all(block_tile(plan, i)[2] % step == 0 for i in range(plan.blocks))
            assert_covered_once(plan, b * h, w, w)
            assert 1 <= plan.blocks <= corr_cuda.MAX_GRID_X
            assert plan.threads <= 1024 and plan.threads % 32 == 0
            assert plan.shared_bytes == corr_cuda.pyramid_shared_bytes(plan.tile) <= _build.MAX_SHARED_BYTES
    if w in (150, 192, 720):
        # 6 rows take 128 x 128 (one wave either way); 128 rows fit in
        # fewer waves of 96 x 192, so both tiles' mappings are covered.
        assert tiles == set(corr_cuda.PYRAMID_TILES)


def test_pyramid_plan_chooses_a_tile_per_shape():
    """The model's shapes: 384x512 (W 128) and Middlebury-F (W 720) take the
    128 x 128 tile, 512x768 (W 192) the 96 x 192 tile, one wave of 256
    blocks on the card's 2 x 132 slots. 128 rows at W 190 take the 96 x 192
    tile with 4-byte copies (a row of 190 floats breaks the 16-byte
    alignment, and the epilogue goes through shared memory)."""
    for rows, w, tile, vec in ((96, 128, (128, 128), 4), (128, 192, (96, 192), 4), (496, 720, (128, 128), 4),
                               (128, 190, (96, 192), 1)):
        plan = corr_cuda.pyramid_plan(1, rows, w, w, 256, 4, model_strides(1, rows, w), SMS)
        assert (plan.tile, plan.vec) == (tile, vec)
    plan = corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, model_strides(1, 128, 192), SMS)
    assert plan.blocks == 256 <= SMS * corr_cuda.PYRAMID_BLOCKS_PER_SM


def test_pyramid_plan_tile_follows_the_cards_multiprocessors():
    """7 rows at W 720: 252 blocks of 128 x 128 or 224 of 96 x 192. Both are
    one wave on 132 multiprocessors (the tie keeps 128 x 128); on 114 (an
    H100 PCIe) only the 224 are."""
    strides = model_strides(1, 7, 720)
    assert corr_cuda.pyramid_plan(1, 7, 720, 720, 256, 4, strides, SMS).tile == (128, 128)
    assert corr_cuda.pyramid_plan(1, 7, 720, 720, 256, 4, strides, 114).tile == (96, 192)


def test_pyramid_plan_copy_width():
    # The model's layout: W is the unit-stride axis and H*W, W, D*H*W are
    # multiples of 4 floats.
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, model_strides(1, 128, 192), SMS).vec == 4
    # The same views at an unaligned base address.
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, model_strides(1, 128, 192), SMS,
                                  aligned=False).vec == 1
    # H*W = 450 floats: a D step breaks the 16-byte alignment.
    assert corr_cuda.pyramid_plan(1, 3, 150, 150, 256, 4, model_strides(1, 3, 150), SMS).vec == 1
    # The contiguous (B, H, W, D) layout: W is not the unit-stride axis.
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, contiguous_strides(1, 128, 192), SMS).vec == 1
    # One map aligned, the other not.
    mixed = model_strides(1, 128, 192)[:4] + contiguous_strides(1, 128, 192)[4:]
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, mixed, SMS).vec == 1
    # A stride of a dimension of size 1 never moves, so it need not align.
    strides = (7, 192, 1, 128 * 192) * 2
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, strides, SMS).vec == 4


def assert_walk_covers_once(plan, rows, w1, w2):
    """Every (row, w1, w2) cell is covered by exactly one tile of exactly one
    persistent block; the grid has at most one block per multiprocessor."""
    bm, bn = plan.tile
    per_row = plan.m_tiles * plan.n_tiles
    tiles = rows * per_row
    assert plan.blocks == min(tiles, SMS * corr_cuda.PYRAMID_WGMMA_BLOCKS_PER_SM)
    owner = np.full(tiles, -1)
    for block in range(plan.blocks):
        for t in range(block, tiles, plan.blocks):
            assert owner[t] == -1
            owner[t] = block
    assert (owner >= 0).all()
    for r in range(min(rows, 3)):
        count = np.zeros((w1, w2), np.int32)
        for t in range(r * per_row, (r + 1) * per_row):
            row, m0, n0 = block_tile(plan, t)
            assert row == r and 0 <= m0 < w1 and 0 <= n0 < w2
            count[m0:m0 + bm, n0:n0 + bn] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("w", WIDTHS)
def test_bf16_pyramid_plan_takes_the_tensor_core_tile(w):
    """The bf16 plan launches a tensor-core kernel: the wgmma kernel where
    its tensor maps and vector stores take the shape (W a multiple of 8, so
    every moving stride of the model's views is 16 bytes; at most 4
    levels): 128 x N tiles of 384 threads, N from `pyramid_wgmma_width`,
    persistent blocks walking every tile once, a ring of 2-4 k64 slots that
    fits (at most 4: the D loop of 256 is 4 slots); otherwise the mma.sync kernel's 128 x 128 tiles of 256 threads
    covering every row once, with a ring of bf16 rows padded by 16 bytes (or
    the fp32 epilogue tile, which aliases it, if larger), 8-element copies
    where every moving stride allows. Never the fp32 register epilogue."""
    for b, h in ((2, 3), (1, 128)):
        for levels in (1, 4, corr_cuda.PYRAMID_MAX_LEVELS):
            strides = model_strides(b, h, w)
            plan = corr_cuda.pyramid_plan(b, h, w, w, 256, levels, strides, SMS, elem_bytes=2)
            assert plan.tile[1] % (1 << (levels - 1)) == 0 and not plan.direct
            assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
            if w % 8 == 0 and levels <= corr_cuda.PYRAMID_WGMMA_LEVELS:
                width = corr_cuda.pyramid_wgmma_width(w, levels)
                assert (plan.path, plan.tile, plan.threads, plan.vec) == ("wgmma", (128, width), 384, 8)
                assert plan.shared_bytes == corr_cuda.pyramid_wgmma_shared_bytes(width, plan.stages)
                assert 2 <= plan.stages <= 4
                assert plan.stages == 4 or corr_cuda.pyramid_wgmma_shared_bytes(width, plan.stages + 1) > \
                    _build.MAX_SHARED_BYTES
                assert_walk_covers_once(plan, b * h, w, w)
                continue
            assert (plan.path, plan.tile, plan.threads, plan.stages) == ("mma", corr_cuda.PYRAMID_MMA_TILE, 256, 0)
            assert_covered_once(plan, b * h, w, w)
            bm, bn = plan.tile
            ring = corr_cuda.PYRAMID_STAGES * corr_cuda.PYRAMID_TK * (bm + bn + 2 * 8) * 2
            assert plan.shared_bytes == max(ring, 4 * bm * (bn + 1)) == corr_cuda.pyramid_shared_bytes(plan.tile, 2)
            # The strides that move: D's (H*W), H's (W) for h > 1, B's for b > 1.
            moving = [h * w] + [w] * (h > 1) + [256 * h * w] * (b > 1)
            assert plan.vec == (8 if all(s % 8 == 0 for s in moving) else 1)


@pytest.mark.parametrize("w2, levels, width", [
    (720, 4, 240), (192, 4, 192), (96, 4, 96), (64, 4, 64), (128, 4, 128), (800, 4, 160), (32, 4, 64),
    (720, 1, 240), (256, 4, 256), (1024, 4, 256), (480, 4, 240), (184, 2, 192),
])
def test_bf16_pyramid_wgmma_width(w2, levels, width):
    """The wgmma tile's W2 width divides W2 where an instantiated width does
    (Middlebury-F's 720 -> 240, the 512x768 bucket's 192, the realtime
    buckets' 64 and 96), is a multiple of 8 and of 2**(L-1), at most 256,
    and otherwise pads least (800 -> 5 x 160, 32 -> one 64)."""
    got = corr_cuda.pyramid_wgmma_width(w2, levels)
    assert got == width
    assert got in corr_cuda.PYRAMID_WGMMA_WIDTHS and got % 8 == 0 and got % (1 << (levels - 1)) == 0
    assert got <= 256
    divisors = [n for n in corr_cuda.PYRAMID_WGMMA_WIDTHS if w2 % n == 0 and n % (1 << (levels - 1)) == 0]
    if divisors and w2 >= min(divisors):
        assert w2 % got == 0


@pytest.mark.parametrize("w, layout, aligned, levels, path", [
    (720, "nchw", True, 4, "wgmma"), (192, "nchw", True, 4, "wgmma"), (96, "nchw", True, 4, "wgmma"),
    (64, "nchw", True, 4, "wgmma"), (156, "nchw", True, 4, "mma"), (150, "nchw", True, 4, "mma"),
    (37, "nchw", True, 4, "mma"), (192, "bhwd", True, 4, "mma"), (192, "nchw", False, 4, "mma"),
    (192, "nchw", True, 5, "mma"), (192, "nchw", True, 7, "mma"), (720, "nchw", True, 1, "wgmma"),
])
def test_bf16_pyramid_plan_path(w, layout, aligned, levels, path):
    """Which shapes take the tensor-map (wgmma) path: the model's permuted
    NCHW views at W 720, 192, 96 and 64 do; W 156 (the realtime model's
    KITTI bucket at 1/8), 150 and 37 (rows not 16-byte aligned), the
    contiguous (B, H, W, D) layout (W is not the unit-stride axis), an
    unaligned base and more than 4 levels take the mma.sync kernel. The fp32
    build is the FFMA kernel whatever the shape."""
    h = 48
    strides = model_strides(1, h, w) if layout == "nchw" else contiguous_strides(1, h, w)
    plan = corr_cuda.pyramid_plan(1, h, w, w, 256, levels, strides, SMS, aligned=aligned, elem_bytes=2)
    assert plan.path == path
    assert corr_cuda.pyramid_plan(1, h, w, w, 256, levels, strides, SMS, aligned=aligned).path == "ffma"


@pytest.mark.parametrize("width", corr_cuda.PYRAMID_WGMMA_WIDTHS)
def test_bf16_pyramid_wgmma_shared_bytes(width):
    """Every instantiated width fits at least two ring slots in the H100's
    232,448 bytes, and the plan takes the deepest ring that fits: 3 slots
    of a 128 x 240 or 128 x 256 tile (a k64 slot of 16 + 32 KB; 4 do not
    fit beside the staging tiles), 4 of the narrower ones. A slot is two
    fmap1 boxes and ceil(width / 64) fmap2 boxes of 8192 bytes."""
    assert corr_cuda.pyramid_wgmma_shared_bytes(width, 2) <= _build.MAX_SHARED_BYTES
    slot = (2 + -(-width // 64)) * 8192
    assert corr_cuda.pyramid_wgmma_shared_bytes(width, 3) - corr_cuda.pyramid_wgmma_shared_bytes(width, 2) == slot + 16
    plan = corr_cuda.pyramid_plan(1, 8, width, width, 256, 4, model_strides(1, 8, width), SMS, elem_bytes=2)
    assert plan.tile == (128, width)
    assert plan.stages == (3 if width >= 240 else 4)
    assert plan.shared_bytes == corr_cuda.pyramid_wgmma_shared_bytes(width, plan.stages) <= _build.MAX_SHARED_BYTES


@pytest.mark.parametrize("rows, w", [(496, 720), (128, 192), (48, 64), (64, 96), (3, 720), (1, 64), (0, 64)])
def test_bf16_pyramid_persistent_grid(rows, w):
    """At most one block per multiprocessor (one fits: its shared memory),
    at most one per tile, and the blocks' walks cover every tile exactly
    once; on a smaller card the same tiles spread over fewer blocks."""
    for sms in (SMS, 114, 7):
        plan = corr_cuda.pyramid_plan(1, rows, w, w, 256, 4, model_strides(1, max(rows, 1), w), sms, elem_bytes=2)
        tiles = rows * plan.m_tiles * plan.n_tiles
        assert plan.path == "wgmma" and plan.blocks == min(tiles, sms)
        seen = np.zeros(tiles, np.int32)
        for block in range(plan.blocks):
            seen[block::plan.blocks] += 1
        assert (seen == 1).all()


def test_bf16_pyramid_plan_raises_for_what_no_instantiation_takes():
    strides = model_strides(1, 4, 64)
    for levels in (0, corr_cuda.PYRAMID_MAX_LEVELS + 1):
        with pytest.raises(ValueError, match="levels"):
            corr_cuda.pyramid_plan(1, 4, 64, 64, 256, levels, strides, SMS, elem_bytes=2)
    with pytest.raises(ValueError, match="int32"):
        corr_cuda.pyramid_plan(2**16, 2**16, 720, 720, 256, 4, model_strides(1, 1, 720), SMS, elem_bytes=2)
    with pytest.raises(ValueError, match="grid"):
        corr_cuda.pyramid_plan(2**16, 2**16, 150, 150, 256, 4, model_strides(1, 1, 150), SMS, elem_bytes=2)


def test_bf16_pyramid_plan_copy_width():
    """16 bytes are 8 bf16 elements: every moving stride a multiple of 8."""
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, model_strides(1, 128, 192), SMS, elem_bytes=2).vec == 8
    assert corr_cuda.pyramid_plan(1, 496, 720, 720, 256, 4, model_strides(1, 496, 720), SMS, elem_bytes=2).vec == 8
    # W 36: H*W = 108 is a multiple of 4 but not of 8: fp32 copies 16 bytes, bf16 one element.
    strides = model_strides(1, 3, 36)
    assert corr_cuda.pyramid_plan(1, 3, 36, 36, 256, 4, strides, SMS).vec == 4
    assert corr_cuda.pyramid_plan(1, 3, 36, 36, 256, 4, strides, SMS, elem_bytes=2).vec == 1
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, model_strides(1, 128, 192), SMS, aligned=False,
                                  elem_bytes=2).vec == 1
    assert corr_cuda.pyramid_plan(1, 128, 192, 192, 256, 4, contiguous_strides(1, 128, 192), SMS,
                                  elem_bytes=2).vec == 1
    with pytest.raises(ValueError, match="fp32 or bf16"):
        corr_cuda.pyramid_plan(1, 3, 36, 36, 256, 4, strides, SMS, elem_bytes=8)


def test_pyramid_plan_register_epilogue():
    """The fp32 kernel's register epilogue stores float4 runs: level rows
    must start 16-byte aligned, so W2 % 4 == 0, and the shuffles reach 6
    levels; otherwise, and always in bf16, the shared-memory epilogue."""
    for w, levels, direct in ((192, 4, True), (192, 6, True), (192, 7, False), (190, 4, False), (150, 4, False),
                              (720, 4, True), (128, 1, True), (36, 3, True)):
        plan = corr_cuda.pyramid_plan(1, 3, w, w, 256, levels, model_strides(1, 3, w), SMS)
        assert plan.direct == direct, (w, levels)
        assert not corr_cuda.pyramid_plan(1, 3, w, w, 256, levels, model_strides(1, 3, w), SMS, elem_bytes=2).direct


def test_pyramid_plan_raises_for_what_no_instantiation_takes():
    strides = model_strides(1, 4, 64)
    for levels in (0, corr_cuda.PYRAMID_MAX_LEVELS + 1):
        with pytest.raises(ValueError, match="levels"):
            corr_cuda.pyramid_plan(1, 4, 64, 64, 256, levels, strides, SMS)
    with pytest.raises(ValueError, match="grid"):
        corr_cuda.pyramid_plan(2**16, 2**16, 720, 720, 256, 4, model_strides(1, 1, 720), SMS)
    with pytest.raises(ValueError, match="strides"):
        corr_cuda.pyramid_plan(1, 4, 64, 64, 256, 4, strides[:6], SMS)


def block_queries(plan, block, n_queries):
    """The queries of `block`, as csrc/corr_scatter.cu derives them."""
    return range(block * plan.run, min((block + 1) * plan.run, n_queries))


@pytest.mark.parametrize("n_queries", [1, 9, 63, 64, 65, 240, 1600, 86400])
def test_scatter_plan_runs_cover_every_query_once(n_queries):
    widths = [180, 90, 45, 22]
    plan = corr_cuda.scatter_plan(n_queries, widths, 4)
    assert plan.run == corr_cuda.SCATTER_RUN
    seen = np.zeros(n_queries, np.int32)
    for block in range(plan.blocks):
        queries = block_queries(plan, block, n_queries)
        assert 1 <= len(queries) <= plan.run
        seen[queries.start:queries.stop] += 1
    assert (seen == 1).all()
    assert plan.blocks == -(-n_queries // plan.run) <= corr_cuda.MAX_GRID_X
    assert not plan.wide


def test_scatter_plan_shared_bytes_fit():
    plan = corr_cuda.scatter_plan(86400, [180, 90, 45, 22], 4)
    # Cotangents, weights (2r+2), window starts and coordinates of a run.
    assert plan.shared_bytes == 4 * plan.run * (36 + 4 * 10 + 4 + 1) <= _build.MAX_SHARED_BYTES
    # A wide window: the run shrinks until a block's shared memory fits.
    plan = corr_cuda.scatter_plan(1000, [4096] * 8, 200)
    assert plan.run < corr_cuda.SCATTER_RUN
    assert plan.shared_bytes == corr_cuda.scatter_shared_bytes(plan.run, 8, 200) <= _build.MAX_SHARED_BYTES
    assert corr_cuda.scatter_shared_bytes(2 * plan.run, 8, 200) > _build.MAX_SHARED_BYTES


def test_scatter_plan_chooses_64_bit_indexing_past_int32():
    widths = [180, 90, 45, 22]  # 337 outputs per query
    n = (2**31 - 1) // 337
    assert not corr_cuda.scatter_plan(n, widths, 4).wide
    assert corr_cuda.scatter_plan(n + 1, widths, 4).wide
    # The cotangent alone can pass int32 too (L(2r+1) > sum of widths).
    assert corr_cuda.scatter_plan(2**31 // 9 + 1, [1], 4).wide


def test_scatter_plan_raises_for_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="levels"):
        corr_cuda.scatter_plan(10, [], 4)
    with pytest.raises(ValueError, match="levels"):
        corr_cuda.scatter_plan(10, [8] * (corr_cuda.MAX_LEVELS + 1), 4)
    with pytest.raises(ValueError, match="radius"):
        corr_cuda.scatter_plan(10, [8, 4], -1)
    with pytest.raises(ValueError, match="widths"):
        corr_cuda.scatter_plan(10, [2**24], 4)
    # A window so wide that one query's weights overflow a block's shared memory.
    with pytest.raises(ValueError, match="shared"):
        corr_cuda.scatter_plan(10, [8] * 8, 2000)


def span_split(start: int, n: int, elem_bytes: int):
    """(head, vectors, tail) of a span of `n` elements that starts `start`
    elements past a 16-byte boundary, as csrc/corr_scatter.cu splits each
    level's span of a block (the level's base is 16-byte aligned)."""
    vec = 16 // elem_bytes
    head = min((16 - start * elem_bytes % 16) % 16 // elem_bytes, n)
    vectors = (n - head) // vec
    return head, vectors, n - head - vectors * vec


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("w", [180, 90, 45, 22])
def test_scatter_plan_spans_split_at_element_granularity(w, elem_bytes):
    """At the bench's widths (57,600 queries: batch 4 at 80 x 180), and at a
    count that leaves the last block a partial run: every span of every
    block is covered once by its head, vectors and tail, the vectors start
    on 16-byte boundaries, head and tail are shorter than a vector. Runs of
    64 queries keep every block's span 16-byte aligned in bf16 too, so only
    a partial last run has a tail; a run of one query (a window too wide
    for more) starts its spans at every 2-byte offset."""
    for n_queries in (57600, 57600 - 37):
        plan = corr_cuda.scatter_plan(n_queries, [w], 4, elem_bytes)
        assert plan.vec == 16 // elem_bytes and plan.run == corr_cuda.SCATTER_RUN
        covered = np.zeros(n_queries * w, np.int32)
        tails = 0
        for block in range(plan.blocks):
            queries = block_queries(plan, block, n_queries)
            start, n = queries.start * w, len(queries) * w
            head, vectors, tail = span_split(start, n, elem_bytes)
            assert head == 0  # 64 * w elements: a multiple of 16 bytes
            assert 0 <= tail < plan.vec and head + vectors * plan.vec + tail == n
            assert (start + head) * elem_bytes % 16 == 0
            covered[start:start + n] += 1
            tails += tail > 0
        assert (covered == 1).all()
        assert tails == (n_queries * w % plan.vec != 0)
    # One query per block (chip_smoke.py's "run 1" case): at the odd width
    # the spans start at every element offset of a vector.
    plan = corr_cuda.scatter_plan(61, [1001, 500], 4000, elem_bytes)
    assert plan.run == 1 and plan.vec == 16 // elem_bytes
    assert {span_split(q * 1001, 1001, elem_bytes)[0] for q in range(61)} == set(range(plan.vec))


def test_bf16_scatter_plan_limits_count_elements():
    """The bf16 plan takes the fp32 plan's runs, grid, shared bytes (a bf16
    cotangent is staged widened to fp32) and 64-bit threshold (indices
    count elements), and only the vector width differs; other element sizes
    raise."""
    widths = [180, 90, 45, 22]
    n = (2**31 - 1) // 337
    for n_queries, radius in ((57600, 4), (86400, 4), (n, 4), (n + 1, 4), (1000, 200)):
        f32 = corr_cuda.scatter_plan(n_queries, widths, radius, 4)
        b16 = corr_cuda.scatter_plan(n_queries, widths, radius, 2)
        assert f32._replace(vec=8) == b16 and (f32.vec, b16.vec) == (4, 8)
    assert not corr_cuda.scatter_plan(n, widths, 4, 2).wide
    assert corr_cuda.scatter_plan(n + 1, widths, 4, 2).wide
    assert corr_cuda.scatter_plan(57600, widths, 4, 2).shared_bytes == 4 * 64 * (36 + 40 + 4 + 1)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        corr_cuda.scatter_plan(10, [8], 4, 8)


def fixed_grid_blocks(n, vec):
    """The grid csrc/gru_gates.cuh computed in C for an H100 before the
    multiprocessor count was read from the device: (n + 3) / 4 fp32 units
    on the vector path, capped at 132 x 32 blocks of 256."""
    units = (n + 3) // 4 if vec else n
    return max(1, min((units + 255) // 256, 132 * 32))


@pytest.mark.parametrize("n", [0, 1, 7, 255, 256, 257, 4096, 128 * 96 * 128, 128 * 496 * 720, 2**31 + 5])
def test_stream_blocks(n):
    for vec in (0, 1):
        units = -(-n // 4) if vec else n
        blocks = _build.stream_blocks(units, SMS)
        assert blocks == fixed_grid_blocks(n, vec)
        # The grid-stride loop covers every unit; the cap scales with the card.
        assert blocks * _build.STREAM_THREADS * -(-max(units, 1) // (blocks * _build.STREAM_THREADS)) >= units
        assert _build.stream_blocks(units, 66) == max(1, min(-(-units // 256), 66 * 32))
    assert _build.vector_width(torch.float32) == 4 and _build.vector_width(torch.bfloat16) == 8


@pytest.mark.parametrize("b, h, w", [(1, 512, 768), (2, 512, 768), (2, 1984, 2880), (2, 13, 70), (2, 192, 624),
                                     (1, 8, 32), (3, 9, 33), (0, 8, 32)])
def test_bf16_conv_plan_walks_every_tile_once(b, h, w):
    """The bf16 conv's persistent blocks (ops/encoder_cuda.py `conv_plan`):
    at most one per multiprocessor (its 227,368 shared bytes leave room for
    one) and per tile; walking t, t + blocks, ... they cover every (batch,
    8 x 32 tile) exactly once, and the tiles cover the image."""
    from raft_stereo_tpu_torch.ops import encoder_cuda
    for sms in (SMS, 114, 5):
        plan = encoder_cuda.conv_plan(b, h, w, sms)
        assert plan.tiles_x == -(-w // 32) and plan.tiles == plan.tiles_x * -(-h // 8)
        total = b * plan.tiles
        assert plan.blocks == min(total, sms * encoder_cuda.CONV_BLOCKS_PER_SM)
        seen = np.zeros(total, np.int32)
        for block in range(plan.blocks):
            seen[block::plan.blocks] += 1
        assert (seen == 1).all()
        if b and h and w:
            cover = np.zeros((h, w), np.int32)
            for tile in range(plan.tiles):
                y0, x0 = (tile // plan.tiles_x) * 8, (tile % plan.tiles_x) * 32
                cover[y0:y0 + 8, x0:x0 + 32] += 1
            assert (cover == 1).all()


def test_bf16_conv_plan_shared_bytes_and_vector_width():
    """Shared memory: the resident weights (9 x 64 x 64 bf16), two halo
    patches ((8+2) x (32+2) pixels of 64 bf16 channels; the output tile, 64
    channels x 8 x 32 pixels each padded by 16 bytes, takes a consumed
    one's place), the raw tile's TMA box (48 x 10 pixels x 64 channels), the
    statistics of 8 warps, 5 barriers and 1024 bytes to align the weights
    to a swizzle atom: within the H100's 232,448. The TMA raw tile and
    16-byte stores only where W is a multiple of 8 and both tensors start
    16-byte aligned; a bad shape raises."""
    from raft_stereo_tpu_torch.ops import encoder_cuda
    want = 1024 + 9 * 64 * 64 * 2 + 2 * 10 * 34 * 128 + 64 * 10 * 48 * 2 + 8 * 2 * 64 * 4 + 40
    assert 64 * (8 * 32 * 2 + 16) <= 10 * 34 * 128
    assert encoder_cuda.CONV_SHARED_BYTES == want == 227368 <= _build.MAX_SHARED_BYTES
    assert encoder_cuda.conv_plan(1, 512, 768, SMS).shared_bytes == want
    assert encoder_cuda.conv_plan(1, 512, 768, SMS).vec
    assert not encoder_cuda.conv_plan(1, 512, 768, SMS, aligned=False).vec
    assert not encoder_cuda.conv_plan(2, 13, 70, SMS).vec
    assert encoder_cuda.conv_plan(2, 192, 624, SMS).vec
    with pytest.raises(ValueError, match="shape"):
        encoder_cuda.conv_plan(-1, 8, 8, SMS)
    with pytest.raises(ValueError, match="shape"):
        encoder_cuda.conv_plan(65536, 8, 8, SMS)


# -- the windowed lookup (ops/corr_cuda.py `prefetch_plan`) --------------------

MIDDLEBURY_WIDTHS = (720, 360, 180, 90)


def warp_runs(plan, n_queries):
    """The runs each warp of the grid takes, as csrc/corr_prefetch.cu walks
    them: warp w of blocks x PREFETCH_WARPS takes runs w, w + warps, ..."""
    warps = plan.blocks * corr_cuda.PREFETCH_WARPS
    n_runs = -(-n_queries // plan.run)
    return [list(range(w, n_runs, warps)) for w in range(warps)]


@pytest.mark.parametrize("n_queries, widths, radius", [
    (128 * 192, [192, 96, 48, 24], 4), (496 * 720, MIDDLEBURY_WIDTHS, 4), (48 * 156, [156, 78, 39, 19], 4),
    (63, [37, 18, 9, 4], 4), (128 * 192, [192, 96], 2), (1, [5], 0), (1000, [64] * 7, 0), (0, [8, 4], 4)])
@pytest.mark.parametrize("level_bytes", [4, 2])
def test_prefetch_plan_runs_cover_every_query_once_in_order(n_queries, widths, radius, level_bytes):
    """Every query lies in exactly one run of one warp, a run's queries are
    consecutive, and each warp takes its runs in increasing order; the grid
    holds at most PREFETCH_BLOCKS_PER_SM blocks per multiprocessor."""
    for sms in (SMS, 7):
        plan = corr_cuda.prefetch_plan(n_queries, tuple(widths), radius, level_bytes, 4, sms)
        assert plan.run * len(widths) <= 32
        assert plan.blocks <= sms * corr_cuda.PREFETCH_BLOCKS_PER_SM
        seen = np.zeros(n_queries, np.int32)
        for runs in warp_runs(plan, n_queries):
            assert runs == sorted(runs)
            for r in runs:
                seen[r * plan.run:min((r + 1) * plan.run, n_queries)] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("radius, levels", [(4, 4), (2, 2), (4, 1), (0, 8), (12, 3), (40, 2)])
@pytest.mark.parametrize("level_bytes, out_bytes", [(4, 4), (4, 2), (2, 4), (2, 2)])
def test_prefetch_plan_shared_bytes_and_slots(radius, levels, level_bytes, out_bytes):
    """A block's shared bytes fit the H100's 227 KB with the ring the plan
    names: per warp `stages` stages of the run's coordinates and 32 window
    slots, then the output staging (the run's taps plus 16 bytes of room,
    rounded to 16). A slot holds the chunks a window of 2r+3 samples can
    span at any alignment (brute force), as an odd count of 16-byte
    chunks; the usual (r = 4, 4 levels) fp32 slot is 80 bytes, bf16 48."""
    plan = corr_cuda.prefetch_plan(496 * 720, tuple(720 >> l for l in range(levels)), radius, level_bytes, out_bytes,
                                   SMS)
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
    n, v = 2 * radius + 3, 16 // level_bytes
    spans = max((phase + n - 1) // v + 1 for phase in range(v))
    assert corr_cuda.prefetch_chunks(radius, level_bytes) == spans
    if plan.path != "element":
        assert plan.slot_bytes == 16 * (spans | 1) and plan.stages in (2, 3)
        stage = corr_cuda.PREFETCH_COORD_BYTES + 32 * plan.slot_bytes
    else:
        assert plan.stages == 1 and plan.slot_bytes == 0
        stage = corr_cuda.PREFETCH_COORD_BYTES
    taps_bytes = plan.run * levels * (2 * radius + 1) * out_bytes
    assert plan.shared_bytes == corr_cuda.PREFETCH_WARPS * (plan.stages * stage + -(-(taps_bytes + 16) // 16) * 16)
    if (radius, levels) == (4, 4):
        assert (plan.path, plan.run, plan.stages, plan.slot_bytes) == ("usual", 8, 3, 80 if level_bytes == 4 else 48)


def span_chunks(start_bytes: int, n: int, elem_bytes: int):
    """How csrc/corr_prefetch.cu's `copy_out` writes a run's span of n
    elements starting `start_bytes` into the output: ph elements of room,
    then whole 16-byte chunks as vectors and the partial first and last
    chunks element by element. Returns (element writes, vector writes) as
    lists of element indices of the span."""
    v = 16 // elem_bytes
    ph = (start_bytes % 16) // elem_bytes
    scalar, vector = [], []
    for c in range(-(-(ph + n) // v)):
        e0 = c * v
        if e0 >= ph and e0 + v <= ph + n:
            vector.extend(range(e0 - ph, e0 - ph + v))
        else:
            scalar.extend(range(max(e0, ph) - ph, min(e0 + v, ph + n) - ph))
    return scalar, vector


@pytest.mark.parametrize("levels, radius, out_bytes", [(4, 4, 4), (4, 4, 2), (2, 2, 4), (2, 2, 2), (3, 4, 4),
                                                       (7, 0, 2), (5, 1, 2)])
def test_prefetch_plan_output_spans(levels, radius, out_bytes):
    """Every run's output span starts 16-byte aligned where a run length
    makes the span a multiple of 16 bytes (then only the last, partial run
    has a scalar tail); where none does (7 levels of 1 bf16 tap: 14 bytes a
    query, at most 4 queries a run; 5 levels of 3 bf16 taps: 30 bytes, at
    most 6), the spans take a scalar head and tail. Either way every output
    element is written exactly once."""
    n_queries = 1001
    plan = corr_cuda.prefetch_plan(n_queries, tuple(64 >> l for l in range(levels)), radius, 4, out_bytes, SMS)
    per_query = levels * (2 * radius + 1)
    aligned_runs = plan.run * per_query * out_bytes % 16 == 0
    assert aligned_runs == ((levels, radius, out_bytes) not in ((7, 0, 2), (5, 1, 2)))
    if (levels, radius) == (4, 4):
        assert plan.run == 8
    written = np.zeros(n_queries * per_query, np.int32)
    for r in range(-(-n_queries // plan.run)):
        q0 = r * plan.run
        n = min(plan.run, n_queries - q0) * per_query
        scalar, vector = span_chunks(q0 * per_query * out_bytes, n, out_bytes)
        if aligned_runs and q0 + plan.run <= n_queries:
            assert scalar == []
        for e in scalar + vector:
            written[q0 * per_query + e] += 1
    assert (written == 1).all()


def test_prefetch_plan_paths():
    """The plan's path: the compile-time instantiation for radius 4 with 4
    levels, the generic one for other radii and level counts (the model's
    configuration at radius 2 with 2 levels; 4 levels at radius 3), both
    only for 16-byte-aligned levels; an unaligned level (a view at an odd
    offset) takes the element path; levels past 2**31 elements (9
    Middlebury-F images) take the usual path, whose offsets are 64-bit, with
    the full persistent grid; a window too large to stage takes the element
    path."""
    n = 496 * 720
    assert corr_cuda.prefetch_plan(n, MIDDLEBURY_WIDTHS, 4, 4, 4, SMS).path == "usual"
    assert corr_cuda.prefetch_plan(n, MIDDLEBURY_WIDTHS, 4, 2, 2, SMS).path == "usual"
    assert corr_cuda.prefetch_plan(n, (720, 360), 2, 4, 4, SMS).path == "generic"
    assert corr_cuda.prefetch_plan(n, MIDDLEBURY_WIDTHS, 3, 4, 4, SMS).path == "generic"
    assert corr_cuda.prefetch_plan(n, MIDDLEBURY_WIDTHS[:3], 4, 2, 4, SMS).path == "generic"
    for level_bytes in (4, 2):
        plan = corr_cuda.prefetch_plan(n, MIDDLEBURY_WIDTHS, 4, level_bytes, 4, SMS, aligned=False)
        assert (plan.path, plan.stages, plan.slot_bytes) == ("element", 1, 0)
    big = 9 * n
    assert big * 720 > 2**31
    plan = corr_cuda.prefetch_plan(big, MIDDLEBURY_WIDTHS, 4, 4, 4, SMS)
    assert plan.path == "usual" and plan.blocks == SMS * corr_cuda.PREFETCH_BLOCKS_PER_SM
    assert corr_cuda.prefetch_plan(100, (4096,) * 4, 60, 4, 4, SMS).path == "element"


def test_prefetch_plan_raises_for_what_no_instantiation_takes():
    with pytest.raises(ValueError, match="levels"):
        corr_cuda.prefetch_plan(10, (), 4, 4, 4, SMS)
    with pytest.raises(ValueError, match="levels"):
        corr_cuda.prefetch_plan(10, (8,) * (corr_cuda.MAX_LEVELS + 1), 4, 4, 4, SMS)
    with pytest.raises(ValueError, match="radius"):
        corr_cuda.prefetch_plan(10, (8, 4), -1, 4, 4, SMS)
    with pytest.raises(ValueError, match="widths"):
        corr_cuda.prefetch_plan(10, (2**24,), 4, 4, 4, SMS)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        corr_cuda.prefetch_plan(10, (8,), 4, 8, 4, SMS)
    with pytest.raises(ValueError, match="shared bytes"):
        corr_cuda.prefetch_plan(10, (8000,), 4000, 4, 4, SMS)


# -- the fp32 conv (ops/encoder_cuda.py `conv_plan`, elem_bytes 4) -------------

@pytest.mark.parametrize("b, h, w", [(1, 512, 768), (2, 512, 768), (1, 384, 512), (2, 13, 70), (2, 192, 624),
                                     (1, 20, 66), (3, 9, 65), (0, 8, 64)])
def test_fp32_conv_plan_walks_every_tile_once(b, h, w):
    """The fp32 conv's persistent blocks: one per multiprocessor up to the
    tile count; walking t, t + blocks, ... they cover every (batch, 8 x 64
    tile) exactly once, and the tiles cover the image; the statistics pass
    sums two partials per tile in runs of CONV_STATS_RUN."""
    from raft_stereo_tpu_torch.ops import encoder_cuda
    for sms in (SMS, 114, 5):
        plan = encoder_cuda.conv_plan(b, h, w, sms, elem_bytes=4)
        assert plan.tiles_x == -(-w // 64) and plan.tiles == plan.tiles_x * -(-h // 8)
        total = b * plan.tiles
        assert plan.blocks == min(total, sms * encoder_cuda.CONV_BLOCKS_PER_SM)
        assert plan.stat_runs == -(-2 * plan.tiles // encoder_cuda.CONV_STATS_RUN)
        seen = np.zeros(total, np.int32)
        for block in range(plan.blocks):
            seen[block::plan.blocks] += 1
        assert (seen == 1).all()
        if b and h and w:
            cover = np.zeros((h, w), np.int32)
            for tile in range(plan.tiles):
                y0, x0 = (tile // plan.tiles_x) * 8, (tile % plan.tiles_x) * 64
                cover[y0:y0 + 8, x0:x0 + 64] += 1
            assert (cover == 1).all()


def test_fp32_conv_plan_shared_bytes_and_path():
    """Shared memory: 128 bytes of alignment slack, the raw TMA box (8
    channels x 10 rows x 72 pixels), the resident (64, 3, 3, 64) weights,
    two (8+2) x (64+2) patch slots of 8 channels at row stride 68 (4 mod
    32: rows 16-byte aligned, and a quarter warp's 16-byte reads, 2 rows x
    4 column groups of 8, hit 8 distinct bank groups) and a 16-byte
    barrier: within the H100's 232,448. The TMA raw box and 16-byte stores only where W is
    a multiple of 4 (a tensor map's row stride is a multiple of 16 bytes)
    and x and y start 16-byte aligned; the element path otherwise."""
    from raft_stereo_tpu_torch.ops import encoder_cuda
    want = 128 + 4 * (8 * 10 * 72 + 64 * 9 * 64 + 2 * 8 * 10 * 68) + 16
    assert 72 * 4 % 16 == 0 and 68 % 4 == 0
    assert len({(68 * row + 8 * q) // 4 % 8 for row in (0, 1) for q in range(4)}) == 8
    assert encoder_cuda.CONV_F32_SHARED_BYTES == want == 214160 <= _build.MAX_SHARED_BYTES
    plan = encoder_cuda.conv_plan(1, 512, 768, SMS, elem_bytes=4)
    assert plan.shared_bytes == want and plan.vec
    assert encoder_cuda.conv_plan(2, 192, 624, SMS, elem_bytes=4).vec
    assert encoder_cuda.conv_plan(1, 20, 68, SMS, elem_bytes=4).vec
    assert not encoder_cuda.conv_plan(1, 512, 768, SMS, aligned=False, elem_bytes=4).vec
    assert not encoder_cuda.conv_plan(2, 13, 70, SMS, elem_bytes=4).vec
    assert not encoder_cuda.conv_plan(2, 20, 66, SMS, elem_bytes=4).vec
    # The bf16 kernel's plan is the default and unchanged by the fp32 one.
    assert encoder_cuda.conv_plan(2, 20, 68, SMS) == encoder_cuda.conv_plan(2, 20, 68, SMS, elem_bytes=2)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        encoder_cuda.conv_plan(1, 8, 8, SMS, elem_bytes=8)
