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
is the tensor-core kernel: one 128 x 128 tile, its own copy width and
shared bytes, the shared-memory epilogue.
Scatter: the runs of queries cover every query exactly once (also where the
count is not a multiple of the run), the shared bytes fit, and 64-bit
indexing is chosen past 2**31 - 1 outputs. The bf16 levels (elem_bytes 2)
take the same runs, shared bytes and index limits (all counted in elements
or fp32 staging), and 8 elements per 16-byte store: every level's span of
a block splits into an element-by-element head up to its first 16-byte
boundary, whole vectors and an element-by-element tail.

`block_tile`, `block_queries` and `span_split` below restate how the kernels
map a block to its work; that the .cu files derive the same mapping is shown only on the
card (chip_smoke.py PYRAMID_CASES and SCATTER_CASES, and the gpu-marked
tests in test_torch_encoder.py and test_torch_corr.py).
"""

import numpy as np
import pytest

from raft_stereo_tpu_torch.ops import corr_cuda
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
            assert plan.shared_bytes == corr_cuda.pyramid_shared_bytes(plan.tile) <= corr_cuda.MAX_SHARED_BYTES
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


@pytest.mark.parametrize("w", WIDTHS)
def test_bf16_pyramid_plan_takes_the_tensor_core_tile(w):
    """The bf16 plan launches the tensor-core kernel: 128 x 128 tiles of 256
    threads covering every row once, the shared-memory epilogue, a ring of
    bf16 rows padded by 16 bytes (or the fp32 epilogue tile, which aliases
    it, if larger), and 8-element copies where every moving stride allows."""
    for b, h in ((2, 3), (1, 128)):
        for levels in (1, 4, corr_cuda.PYRAMID_MAX_LEVELS):
            strides = model_strides(b, h, w)
            plan = corr_cuda.pyramid_plan(b, h, w, w, 256, levels, strides, SMS, elem_bytes=2)
            assert (plan.tile, plan.threads, plan.direct) == (corr_cuda.PYRAMID_MMA_TILE, 256, False)
            assert plan.tile[1] % (1 << (levels - 1)) == 0
            assert_covered_once(plan, b * h, w, w)
            bm, bn = plan.tile
            ring = corr_cuda.PYRAMID_STAGES * corr_cuda.PYRAMID_TK * (bm + bn + 2 * 8) * 2
            assert plan.shared_bytes == max(ring, 4 * bm * (bn + 1)) == corr_cuda.pyramid_shared_bytes(plan.tile, 2)
            assert plan.shared_bytes <= corr_cuda.MAX_SHARED_BYTES
            # The strides that move: D's (H*W), H's (W) for h > 1, B's for b > 1.
            moving = [h * w] + [w] * (h > 1) + [256 * h * w] * (b > 1)
            assert plan.vec == (8 if all(s % 8 == 0 for s in moving) else 1)


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
    assert plan.shared_bytes == 4 * plan.run * (36 + 4 * 10 + 4 + 1) <= corr_cuda.MAX_SHARED_BYTES
    # A wide window: the run shrinks until a block's shared memory fits.
    plan = corr_cuda.scatter_plan(1000, [4096] * 8, 200)
    assert plan.run < corr_cuda.SCATTER_RUN
    assert plan.shared_bytes == corr_cuda.scatter_shared_bytes(plan.run, 8, 200) <= corr_cuda.MAX_SHARED_BYTES
    assert corr_cuda.scatter_shared_bytes(2 * plan.run, 8, 200) > corr_cuda.MAX_SHARED_BYTES


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
