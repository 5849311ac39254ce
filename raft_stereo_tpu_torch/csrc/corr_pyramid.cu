// Correlation volume and pyramid in one kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py
// `_pyramid_kernel` (launched by `fused_pyramid_state`). Same function: for
// every row (b, h)
//     vol[w1, w2]  = (sum_d f1[w1, d] * f2[w2, d]) / sqrt(D)   (fp32 sums, stored)
//     lvl_l[w1, j] = (lvl_{l-1}[w1, 2j] + lvl_{l-1}[w1, 2j+1]) * 0.5,   j < W2 >> l
// each level pooled from the STORED previous level with floor semantics (a
// trailing odd column is dropped), rounding exactly as ops/corr.py
// `_avg_pool_last` does. Output: the L contiguous, unpadded levels
// (B, H, W1, W2 >> l) that the lookup kernel reads; the 128-lane padding of
// the TPU state is not carried over.
//
// What bounds it on the H100: operations. At the 512x768 bucket (128 rows,
// W1 = W2 = 192, D = 256) the GEMM is 2.42 GFLOP of fp32 (0.036 ms at
// 67 TFLOP/s) against about 60 MB of traffic (0.018 ms at 3.35 TB/s); at
// Middlebury-F (496 rows, W = 720) 131.6 GFLOP, 1.96 ms. The function is
// fp32 with TF32 off, so the tensor cores are not used: the bound is the
// 67 TFLOP/s of FFMA.
//
// Design: an FFMA GEMM per row with a register tile and an asynchronous
// copy ring. One block of 256 threads computes one BM x BN tile of
// (W1, W2) of one row, TM x TN accumulators per thread: 128 x 128 with 8x8,
// or 96 x 192 with 6x12 (one wave of 256 blocks at 512x768, where W = 192).
// A thread's rows (columns) are float4 runs 4 NT apart (and a float2 run
// for TM = 6), and a warp's lanes are laid out 4 x 8, so every k-step's
// shared reads are float4/float2 that take one wavefront each: 4 loads per
// 64 FFMAs (8x8), 5 per 72 (6x12). D is taken in chunks of TK = 16, held in
// a ring of STAGES = 4 chunks in dynamic shared memory (k-major, operand
// rows padded by 4 floats) that cp.async fills: the next three chunks are
// in flight while the FFMAs run on the current one, behind one barrier per
// chunk. Where W is the unit-stride axis and every other stride and both
// base addresses are 16-byte aligned (the model's permuted NCHW views), a
// copy moves 4 floats along W (cp.async.cg, 16 B, zero-filled past W), from
// per-thread addresses worked out once; otherwise each float is its own
// 4-byte copy, in the order of the smaller stride (the contiguous
// (B, H, W, D) layout reads along D). The tile, the copy width, the grid (one
// block per (row, tile), the tiles of a row consecutive so they share its
// operands in L2) and the shared bytes are chosen in Python
// (ops/corr_cuda.py `pyramid_plan`).
//
// The pooling chain runs in the epilogue: a tile starts at a multiple of BN
// and so of 2**(L-1), and its columns [c0, c0 + BN) of level 0 give exactly
// columns [c0 >> l, (c0 + BN) >> l) of level l, so the volume never leaves
// the block before it is pooled. Where every level's rows are 16-byte
// aligned (W2 % 4 == 0) and L <= 6, it runs in the registers: each thread
// stores its float4 runs of level 0, pools each run into two columns of
// level 1 and one of level 2, and pairs that with its neighbour lanes'
// (shuffles) for levels 3-5; consecutive lanes store consecutive runs and
// there is no barrier. Otherwise the tile goes through shared memory, which
// aliases the drained ring, and each level is written once from it with
// consecutive threads on consecutive columns.
//
// Measured (chip_smoke.py [timing], H100 80GB HBM3 at 700 W; PERF.md
// section 6, row 4): 31.2 TFLOP/s at 512x768 (47% of the bound) and 36.7
// at Middlebury-F (55%), against torch.matmul's volume alone at 32.7 and
// 42.3. What is left is the epilogue's 35 MB of stores at 512x768, which
// one wave of blocks issues only after its GEMM, and at Middlebury-F the
// padding of W = 720 to 768, which no tile of float4 runs divides.
//
// Rounding: each entry is one FFMA chain (__fmaf_rn) over d = 0 .. D-1 in
// order, from 0, with no split of D; the division by sqrtf(D) is IEEE
// (__fdiv_rn, or for a power of two the same value as a product with its
// exact reciprocal) and the pooling uses __fadd_rn / __fmul_rn, so the
// pyramid is built from the stored volume exactly as the plain version
// builds it. cuBLAS's fp32 GEMM on the H100 was measured to agree bit for
// bit, but that is its choice of algorithm, so the checks keep a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#define TK 16        // D chunk
#define STAGES 4     // chunks in the ring
#define PAD 4        // floats of padding per operand row of a chunk
#define MAX_LEVELS 7 // 2**(MAX_LEVELS-1) must divide every tile's W2 extent
#define REG_LEVELS 6 // levels the register epilogue reaches (two in a thread, three shuffles)

struct Levels {
    float* ptr[MAX_LEVELS];
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// A thread's T rows (or columns) of the tile: T / 4 float4 runs at
// 4 NT p + 4t, then, for T = 4q + 2, a float2 run at 4 NT q + 2t (t: the
// thread's coordinate, NT threads along the axis).
template <int T, int NT>
__device__ __forceinline__ int frag_pos(int i, int t) {
    return i < 4 * (T / 4) ? 4 * NT * (i / 4) + 4 * t + (i % 4) : 4 * NT * (T / 4) + 2 * t + (i - 4 * (T / 4));
}

template <int T, int NT>
__device__ __forceinline__ void load_frag(const float* row, int t, float (&v)[T]) {
#pragma unroll
    for (int p = 0; p < T / 4; ++p) {
        const float4 x = *reinterpret_cast<const float4*>(row + 4 * NT * p + 4 * t);
        v[4 * p] = x.x; v[4 * p + 1] = x.y; v[4 * p + 2] = x.z; v[4 * p + 3] = x.w;
    }
    if constexpr (T % 4 == 2) {
        const float2 y = *reinterpret_cast<const float2*>(row + 4 * NT * (T / 4) + 2 * t);
        v[T - 2] = y.x; v[T - 1] = y.y;
    }
}

// One pooled value from the stored pair, rounded as ops/corr.py rounds it.
__device__ __forceinline__ float pool2(float left, float right) {
    return __fmul_rn(__fadd_rn(left, right), 0.5f);
}

// k rows of a chunk that one pass of 16-byte copies covers: the largest
// power of two whose PER_ROW x KPP copies fit in the block.
constexpr int copy_rows(int per_row, int threads) {
    int k = TK;
    while (k > 1 && per_row * k > threads) k /= 2;
    return k;
}

// One operand's rows [r0, r0 + R) of `n` along the tile axis, element
// (r, d) at base[r * sr + d * sd], staged chunk by chunk into dst[k][r]
// (row stride R + PAD). With VEC == 4 (sr == 1, 16-byte aligned runs) each
// of the first PER_ROW x KPP threads owns one column group of 4 floats and
// every KPP-th k row: its source pointer, byte count (zero-filled past n)
// and shared offset are worked out once and kept in four registers, so a
// chunk costs it a few instructions per copy. With VEC == 1 each float is
// its own copy, in the order of the smaller stride.
template <int R, int THREADS, int VEC>
struct ChunkLoader {
    static constexpr int LD = R + PAD;
    static constexpr int PER_ROW = R / 4;
    static constexpr int KPP = copy_rows(PER_ROW, THREADS);
    const float* src;  // this thread's first copy at chunk 0, or the row base
    int kf, soff, bytes;  // first k row, shared offset, bytes (-1: no copies)

    __device__ __forceinline__ ChunkLoader(const float* base, long long sd, int r0, int n, int tid)
        : src(base), kf(0), soff(0), bytes(0) {
        if constexpr (VEC == 4) {
            const int k = tid / PER_ROW;
            const int r = (tid - k * PER_ROW) * 4;
            int valid = n - (r0 + r);
            valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
            bytes = tid < PER_ROW * KPP ? 4 * valid : -1;
            kf = k;
            soff = k * LD + r;
            if (valid) src = base + (r0 + r) + k * sd;
        }
    }

    __device__ __forceinline__ void load(float* dst, int k0, int dim, int tid, const float* base, long long sr,
                                         long long sd, int r0, int n) const {
        if constexpr (VEC == 4) {
            if (bytes < 0) return;
#pragma unroll
            for (int pass = 0; pass < TK / KPP; ++pass) {
                const bool in_d = k0 + kf + pass * KPP < dim;
                const float* p = in_d ? src + (long long)(k0 + pass * KPP) * sd : src;
                cp_async16(dst + soff + pass * KPP * LD, p, in_d ? bytes : 0);
            }
        } else {
            const bool k_fast = sd < sr;  // read along the unit-stride axis
            for (int e = tid; e < TK * R; e += THREADS) {
                int k, r;
                if (k_fast) { r = e / TK; k = e - r * TK; }
                else { k = e / R; r = e - k * R; }
                const int d = k0 + k;
                const bool ok = r0 + r < n && d < dim;
                const float* p = ok ? base + (long long)(r0 + r) * sr + (long long)d * sd : base;
                cp_async4(dst + k * LD + r, p, ok ? 4 : 0);
            }
        }
    }
};

// Level L of the pyramid from level L - 1 in the tile's first BN >> (L-1)
// columns: every pooled value into registers, a barrier, then into the
// tile's first BN >> L columns and out to `out` (width wl, the tile's
// columns starting at c0), consecutive threads on consecutive columns.
// Widths are compile-time, so the index arithmetic folds.
template <int BM, int BN, int THREADS, int L>
__device__ __forceinline__ void pool_level(float* tile, float* __restrict__ out, long long row_w1, int m0,
                                           int w1, int wl, int c0, int tid) {
    constexpr int LT = BN + 1;
    constexpr int COLS = BN >> L;
    constexpr int N = BM * COLS;
    constexpr int PT = (N + THREADS - 1) / THREADS;
    float v[PT];
#pragma unroll
    for (int it = 0; it < PT; ++it) {
        const int e = tid + it * THREADS;
        const int m = e / COLS;
        const int c = e - m * COLS;
        if (N % THREADS == 0 || e < N)
            v[it] = pool2(tile[m * LT + 2 * c], tile[m * LT + 2 * c + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < PT; ++it) {
        const int e = tid + it * THREADS;
        const int m = e / COLS;
        const int c = e - m * COLS;
        if (N % THREADS == 0 || e < N) {
            tile[m * LT + c] = v[it];
            if (m0 + m < w1 && c0 + c < wl) out[(row_w1 + m0 + m) * wl + c0 + c] = v[it];
        }
    }
    __syncthreads();
}

// Store a run of LEN consecutive values at column c of a row whose first
// tile column is n0, width w (a vector store where the run lies inside it).
template <int LEN>
__device__ __forceinline__ void store_run(float* dst, int n0, int c, int w, const float* v) {
    if (n0 + c + LEN <= w) {
        if constexpr (LEN == 4) *reinterpret_cast<float4*>(dst + c) = make_float4(v[0], v[1], v[2], v[3]);
        else *reinterpret_cast<float2*>(dst + c) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int q = 0; q < LEN; ++q)
            if (n0 + c + q < w) dst[c + q] = v[q];
    }
}

__device__ __forceinline__ float* level_ptr(const Levels& levels, int l) {
    float* out = levels.ptr[0];
#pragma unroll
    for (int j = 1; j < MAX_LEVELS; ++j)
        if (j == l) out = levels.ptr[j];
    return out;
}

// Every level of one thread's float4 run of level-0 values (tile columns
// [c, c + 4) of output row `out_row`), straight from the registers: the run
// pools in place into two columns of level 1 and one of level 2; each
// further level pairs that value with the neighbouring lane's (a shuffle
// over lane bits 0-2, which are tx bits 0-2), the lane of the left column
// keeping the result and storing it. Reaches level 5.
__device__ __forceinline__ void pool_run_registers(const float* v, int c, int tx, bool in_row, long long out_row,
                                                   int n0, int w2, int num_levels, const Levels& levels) {
    if (in_row) store_run<4>(levels.ptr[0] + out_row * w2 + n0, n0, c, w2, v);
    if (num_levels <= 1) return;
    int col = c >> 1;
    const float l1[2] = {pool2(v[0], v[1]), pool2(v[2], v[3])};
    if (in_row) store_run<2>(levels.ptr[1] + out_row * (w2 >> 1) + (n0 >> 1), n0 >> 1, col, w2 >> 1, l1);
    if (num_levels <= 2) return;
    float x = pool2(l1[0], l1[1]);
    col >>= 1;
    if (in_row && (n0 >> 2) + col < (w2 >> 2)) levels.ptr[2][out_row * (w2 >> 2) + (n0 >> 2) + col] = x;
#pragma unroll
    for (int l = 3; l < REG_LEVELS; ++l) {
        if (num_levels <= l) return;  // uniform over the block: every lane shuffles
        const int bit = 1 << (l - 3);
        const float other = __shfl_xor_sync(0xffffffffu, x, bit);
        x = (tx & bit) == 0 ? pool2(x, other) : pool2(other, x);
        col >>= 1;
        const int wl = w2 >> l;
        if (in_row && (tx & (2 * bit - 1)) == 0 && (n0 >> l) + col < wl)
            level_ptr(levels, l)[out_row * wl + (n0 >> l) + col] = x;
    }
}

// One block: the BM x BN tile of (W1, W2) of one row, TM x TN accumulators
// per thread on a (BM / TM) x (BN / TN) thread grid; the tiles of a row
// are consecutive blocks, so they share its operands in L2.
template <int BM, int BN, int TM, int TN, int VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)
corr_pyramid_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    long long s1b, long long s1h, long long s1w, long long s1d,
                    long long s2b, long long s2h, long long s2w, long long s2d,
                    int height, int w1, int w2, int dim, int num_levels, int m_tiles, int n_tiles,
                    bool direct, Levels levels) {
    static_assert(TN % 4 == 0, "the epilogue stores and pools float4 column runs");
    constexpr int NTM = BM / TM, NTN = BN / TN;
    constexpr int THREADS = NTM * NTN;
    constexpr int WN = NTN / 8;  // warps along N; a warp's lanes are 4 (M) x 8 (N)
    constexpr int LDA = BM + PAD, LDB = BN + PAD;
    constexpr int STAGE = TK * (LDA + LDB);  // A then B
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int ty = (warp / WN) * 4 + (lane >> 3);
    const int tx = (warp % WN) * 8 + (lane & 7);
    const int tiles = m_tiles * n_tiles;
    const int row = blockIdx.x / tiles;  // b * H + h
    const int rem = blockIdx.x - row * tiles;
    const int m0 = (rem / n_tiles) * BM;
    const int n0 = (rem - (rem / n_tiles) * n_tiles) * BN;
    const int b = row / height;
    const int h = row - b * height;
    const float* a_row = f1 + b * s1b + h * s1h;
    const float* b_row = f2 + b * s2b + h * s2h;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    const ChunkLoader<BM, THREADS, VEC> a_load(a_row, s1d, m0, w1, tid);
    const ChunkLoader<BN, THREADS, VEC> b_load(b_row, s2d, n0, w2, tid);
    const int chunks = (dim + TK - 1) / TK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < chunks) {
            a_load.load(smem + s * STAGE, s * TK, dim, tid, a_row, s1w, s1d, m0, w1);
            b_load.load(smem + s * STAGE + TK * LDA, s * TK, dim, tid, b_row, s2w, s2d, n0, w2);
        }
        cp_async_commit();
    }
    for (int kt = 0; kt < chunks; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        // The slot refilled here was read in the previous step, which every
        // thread has finished at the barrier above.
        const int next = kt + STAGES - 1;
        if (next < chunks) {
            float* dst = smem + (next % STAGES) * STAGE;
            a_load.load(dst, next * TK, dim, tid, a_row, s1w, s1d, m0, w1);
            b_load.load(dst + TK * LDA, next * TK, dim, tid, b_row, s2w, s2d, n0, w2);
        }
        cp_async_commit();
        const float* as = smem + (kt % STAGES) * STAGE;
        const float* bs = as + TK * LDA;
#pragma unroll
        for (int k = 0; k < TK; ++k) {
            float av[TM], bv[TN];
            load_frag<TM, NTM>(as + k * LDA, ty, av);
            load_frag<TN, NTN>(bs + k * LDB, tx, bv);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: the epilogue tile may alias it

    // vol / sqrt(D); where sqrt(D) is a power of two (D = 256: 16) the
    // product with its exact reciprocal is the same correctly rounded value.
    const float scale = sqrtf((float)dim);
    const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0 && scale >= 1.0f;
    const float inv = __frcp_rn(scale);
    auto scaled = [&](float x) { return pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, scale); };
    const long long row_w1 = (long long)row * w1;
    if (direct && num_levels <= REG_LEVELS) {
        // Every level straight from the registers, with no barrier; each
        // lane stores its runs of a row, consecutive lanes on consecutive
        // runs.
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int m = frag_pos<TM, NTM>(i, ty);
            float v[TN];
#pragma unroll
            for (int j = 0; j < TN; ++j) v[j] = scaled(acc[i][j]);
#pragma unroll
            for (int p = 0; p < TN / 4; ++p)
                pool_run_registers(v + 4 * p, 4 * NTN * p + 4 * tx, tx, m0 + m < w1, row_w1 + m0 + m, n0, w2,
                                   num_levels, levels);
        }
        return;
    }

    // Otherwise through a padded tile in shared memory, which aliases the
    // ring: level 0 from the registers, then each pooled level in place
    // (columns [0, BN >> l) hold level l after step l), each written out
    // with consecutive threads on consecutive columns.
    constexpr int LT = BN + 1;
    float* tile = smem;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
            tile[frag_pos<TM, NTM>(i, ty) * LT + frag_pos<TN, NTN>(j, tx)] = scaled(acc[i][j]);
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < BM * BN; e += THREADS) {
        const int m = e / BN;
        const int n = e - m * BN;
        if (m0 + m < w1 && n0 + n < w2) levels.ptr[0][(row_w1 + m0 + m) * w2 + n0 + n] = tile[m * LT + n];
    }
    if (num_levels > 1) pool_level<BM, BN, THREADS, 1>(tile, levels.ptr[1], row_w1, m0, w1, w2 >> 1, n0 >> 1, tid);
    if (num_levels > 2) pool_level<BM, BN, THREADS, 2>(tile, levels.ptr[2], row_w1, m0, w1, w2 >> 2, n0 >> 2, tid);
    if (num_levels > 3) pool_level<BM, BN, THREADS, 3>(tile, levels.ptr[3], row_w1, m0, w1, w2 >> 3, n0 >> 3, tid);
    if (num_levels > 4) pool_level<BM, BN, THREADS, 4>(tile, levels.ptr[4], row_w1, m0, w1, w2 >> 4, n0 >> 4, tid);
    if (num_levels > 5) pool_level<BM, BN, THREADS, 5>(tile, levels.ptr[5], row_w1, m0, w1, w2 >> 5, n0 >> 5, tid);
    if (num_levels > 6) pool_level<BM, BN, THREADS, 6>(tile, levels.ptr[6], row_w1, m0, w1, w2 >> 6, n0 >> 6, tid);
}

template <int BM, int BN, int TM, int TN, int VEC>
static int launch(const float* f1, const float* f2, const long long* s, int height, int w1, int w2, int dim,
                  int num_levels, int m_tiles, int n_tiles, long long blocks, int shared_bytes, bool direct,
                  const Levels& levels, cudaStream_t stream) {
    constexpr int THREADS = (BM / TM) * (BN / TN);
    constexpr int RING = STAGES * TK * (BM + BN + 2 * PAD);
    constexpr int TILE = BM * (BN + 1);
    if (shared_bytes < 4 * (RING > TILE ? RING : TILE)) return (int)cudaErrorInvalidValue;
    auto kernel = corr_pyramid_kernel<BM, BN, TM, TN, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, THREADS, shared_bytes, stream>>>(
        f1, f2, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], height, w1, w2, dim, num_levels, m_tiles,
        n_tiles, direct, levels);
    return (int)cudaGetLastError();
}

// strides: the 8 element strides (b, h, w, d) of f1 then f2. The launch
// plan (tile, copy width, tiles per row, blocks, shared bytes) comes from
// ops/corr_cuda.py `pyramid_plan`; a plan no instantiation takes is refused.
extern "C" int raft_corr_pyramid_f32(const void* f1, const void* f2, const long long* strides,
                                     int batch, int height, int w1, int w2, int dim, int num_levels,
                                     void* const* level_ptrs, int tile_m, int tile_n, int vec, int m_tiles,
                                     int n_tiles, long long blocks, int shared_bytes, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (tile_n % (1 << (num_levels - 1)) != 0) return (int)cudaErrorInvalidValue;
    if (blocks != (long long)batch * height * m_tiles * n_tiles || blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if ((long long)m_tiles * tile_m < w1 || (long long)n_tiles * tile_n < w2) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    Levels levels;
    // Level rows 16-byte aligned: the epilogue may store from registers.
    bool direct = (w2 & 3) == 0;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        levels.ptr[l] = l < num_levels ? (float*)level_ptrs[l] : nullptr;
        direct = direct && ((uintptr_t)levels.ptr[l] & 15) == 0;
    }
    const float* a = (const float*)f1;
    const float* b = (const float*)f2;
    cudaStream_t s = (cudaStream_t)stream;
#define RAFT_PYRAMID_CASE(BM, BN, TM, TN, VEC)                                                          \
    if (tile_m == BM && tile_n == BN && vec == VEC)                                                     \
        return launch<BM, BN, TM, TN, VEC>(a, b, strides, height, w1, w2, dim, num_levels, m_tiles,       \
                                           n_tiles, blocks, shared_bytes, direct, levels, s);
    RAFT_PYRAMID_CASE(128, 128, 8, 8, 4)
    RAFT_PYRAMID_CASE(128, 128, 8, 8, 1)
    RAFT_PYRAMID_CASE(96, 192, 6, 12, 4)
    RAFT_PYRAMID_CASE(96, 192, 6, 12, 1)
#undef RAFT_PYRAMID_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* raft_corr_pyramid_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
