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
// The operands and levels are fp32, or bf16 (`corr_dtype="bfloat16"`), as
// the JAX kernel takes them: bf16 operands, their products (exact in fp32)
// summed in fp32, the division by sqrt(D) in fp32 and one rounding to bf16;
// each level pooled from the previous level's stored bf16 values with an
// fp32 sum and rounded once. Each dtype has its own kernels: the fp32 one
// below, and two bf16 ones after it (`corr_pyramid_wgmma_kernel` and
// `corr_pyramid_mma_kernel`), whose products are exactly the JAX kernel's,
// bf16 x bf16 on the tensor cores with fp32 sums.
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
// Measured (chip_smoke.py [timing], H100 80GB HBM3, 700.00 W; PERF.md
// section 6, row 4): 31.2 TFLOP/s at 512x768 (47% of the bound) and 36.7
// at Middlebury-F (55%), against torch.matmul's volume alone at 32.7 and
// 42.3. What is left is the epilogue's 35 MB of stores at 512x768, which
// one wave of blocks issues only after its GEMM, and at Middlebury-F the
// padding of W = 720 to 768, which no tile of float4 runs divides.
//
// The bf16 build: in bf16 the bytes halve (365.6 MB of operands and 964
// MB of levels at Middlebury-F: 1.33 GB) and the bound becomes the bytes,
// against the 989 TFLOP/s of dense bf16 tensor cores: 0.397 ms there (131.6
// GFLOP take 0.133 ms), 0.0128 ms at 512x768. 964 MB of it are the levels'
// stores, so the design keeps the tensor cores fed while a tile's stores
// drain, and stores in wide units.
//
// `corr_pyramid_wgmma_kernel` (the plan's "wgmma" path): persistent blocks,
// one per SM (384 threads, 117-216 KB of shared memory by tile width),
// walk the (row, W1 tile, W2 tile) list in a fixed order, the tiles of a
// row consecutive so concurrent blocks share its operands in L2. A tile is
// 128 W1 rows by N W2 columns, N an instantiated wgmma width (64, 96, 128,
// 160, 192, 240, 256) that divides W2 where one does: 240 at Middlebury-F's
// 720, which the 128-wide tile padded to 768. Warpgroup 2's one producer
// thread loads the D loop's k64 stages by TMA from (W, H, D, B) tensor maps
// of the model's permuted NCHW views (64 x 64 boxes, 128-byte swizzle,
// zeros outside) into a ring of 3-4 slots, full barriers counting the
// bytes in and empty barriers the 8 consumer warps out. Warpgroups 0 and 1
// each issue four wgmma m64nNk16 per stage on their 64 rows, both operands
// MN-major straight from the slot (transpose flags set). At the tile's end
// each scales its accumulators, rounds them to bf16 pairs and stores them
// with stmatrix into its own staging tile (rows of N + 8 elements, so a
// matrix's eight rows fall in eight bank groups); then a thread per 8-column
// chunk of level 0 writes 16 bytes of level 0, pools them into 8 bytes of
// level 1, 4 of level 2 and 2 of level 3 (fp32 sums of the rounded values,
// one rounding, two values per conversion), consecutive threads on
// consecutive chunks. The producer meanwhile fills the freed slots with the
// next tile's stages. ptxas -v: 168 registers at launch (setmaxnreg moves
// the producer to 40 and the consumers to 232), no spills. Measured
// (chip_smoke.py [timing] and kernel_compare.py, H100 80GB HBM3, 700.00 W):
// at Middlebury-F 0.5603-0.5765 ms alone on the device, 69-71% of the bound
// (the mma.sync kernel at the same shape: 1.5937-1.6211 ms; bf16
// torch.matmul of the volume alone 0.3422-0.3443 ms); at 512x768
// 0.0202-0.0206 ms, 62-63% (mma.sync: 0.0497-0.0505). The rest at Middlebury-F: the operands' 192 KB per tile from L2
// (the fmap2 boxes cover 256 of a 240-wide tile) and the epilogue, which
// the block's own tensor cores do not overlap.
//
// `corr_pyramid_mma_kernel` (the "mma" path) takes what the tensor maps and
// vector stores do not: rows not 16-byte aligned (the realtime model's
// KITTI bucket at 1/8, W 156), the contiguous (B, H, W, D) layout, more than
// 4 levels. It keeps the fp32 kernel's ring (bf16 rows, 16-byte copies of 8
// elements where the strides allow), tiles of 128 x 128 with mma.sync
// m16n8k16 (bf16 in, fp32 sums), ldmatrix.trans fragments from the k-major
// rows, and the shared-memory epilogue with bf16 stores.
//
// Rounding: each entry is one FFMA chain (__fmaf_rn) over d = 0 .. D-1 in
// order, from 0, with no split of D; the division by sqrtf(D) is IEEE
// (__fdiv_rn, or for a power of two the same value as a product with its
// exact reciprocal) and the pooling uses __fadd_rn / __fmul_rn, so the
// pyramid is built from the stored volume exactly as the plain version
// builds it. cuBLAS's fp32 GEMM on the H100 was measured to agree bit for
// bit, but that is its choice of algorithm, so the checks keep a tolerance.
// In bf16 the tensor cores sum the exact products in their own order, and
// every stored value is rounded once to bf16 (round to nearest even), each
// level from the previous level's rounded values: a sum that lands near a
// rounding boundary may round one bf16 ulp away from the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "hopper.cuh"

#define TK 16        // D chunk
#define STAGES 4     // chunks in the ring
#define PAD_BYTES 16 // padding per operand row of a chunk (4 floats, 8 bf16)
#define MAX_LEVELS 7 // 2**(MAX_LEVELS-1) must divide every tile's W2 extent
#define REG_LEVELS 6 // levels the register epilogue reaches (two in a thread, three shuffles)

template <typename T>
struct Levels {
    T* ptr[MAX_LEVELS];
};

template <typename E>
__device__ __forceinline__ void cp_async16(E* smem, const E* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

// One element into shared memory: an asynchronous 4-byte copy for fp32; a
// bf16 element is 2 bytes, below cp.async's least size, so it is copied by
// the thread itself (the ring's barriers order it like the others).
__device__ __forceinline__ void copy_elem(float* smem, const float* gmem, bool ok) { cp_async4(smem, gmem, ok ? 4 : 0); }
__device__ __forceinline__ void copy_elem(__nv_bfloat16* smem, const __nv_bfloat16* gmem, bool ok) {
    *smem = ok ? *gmem : __float2bfloat16_rn(0.0f);
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

// A thread's fragment of a staged operand row, widened to fp32: 4-element
// runs (16 bytes of fp32, 8 of bf16) and a 2-element run for T = 4q + 2.
template <int T, int NT, typename E>
__device__ __forceinline__ void load_frag(const E* row, int t, float (&v)[T]) {
#pragma unroll
    for (int p = 0; p < T / 4; ++p) load_vec<4>(row + 4 * NT * p + 4 * t, v + 4 * p);
    if constexpr (T % 4 == 2) load_vec<2>(row + 4 * NT * (T / 4) + 2 * t, v + T - 2);
}

// One pooled value from the stored pair, rounded as ops/corr.py rounds it:
// an fp32 sum and halving, then one rounding to the level's dtype.
template <typename E>
__device__ __forceinline__ float pool2(float left, float right) {
    return Elem<E>::round(__fmul_rn(__fadd_rn(left, right), 0.5f));
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
// (row stride R + PAD elements, PAD_BYTES of padding). With VEC > 1 (16
// bytes: 4 fp32 or 8 bf16 elements; sr == 1, 16-byte aligned runs) each of
// the first PER_ROW x KPP threads owns one column group of VEC elements and
// every KPP-th k row: its source pointer, byte count (zero-filled past n)
// and shared offset are worked out once and kept in four registers, so a
// chunk costs it a few instructions per copy. With VEC == 1 each element is
// its own copy, in the order of the smaller stride.
template <typename E, int R, int THREADS, int VEC>
struct ChunkLoader {
    static constexpr int PAD = PAD_BYTES / (int)sizeof(E);
    static constexpr int LD = R + PAD;
    static constexpr int PER_ROW = R / (VEC > 1 ? VEC : 4);
    static constexpr int KPP = copy_rows(PER_ROW, THREADS);
    static_assert(VEC == 1 || VEC * sizeof(E) == 16, "vector copies move 16 bytes");
    static_assert((LD * sizeof(E)) % 16 == 0, "staged rows start 16-byte aligned");
    const E* src;  // this thread's first copy at chunk 0, or the row base
    int kf, soff, bytes;  // first k row, shared offset, bytes (-1: no copies)

    __device__ __forceinline__ ChunkLoader(const E* base, long long sd, int r0, int n, int tid)
        : src(base), kf(0), soff(0), bytes(0) {
        if constexpr (VEC > 1) {
            const int k = tid / PER_ROW;
            const int r = (tid - k * PER_ROW) * VEC;
            int valid = n - (r0 + r);
            valid = valid < 0 ? 0 : (valid > VEC ? VEC : valid);
            bytes = tid < PER_ROW * KPP ? (int)sizeof(E) * valid : -1;
            kf = k;
            soff = k * LD + r;
            if (valid) src = base + (r0 + r) + k * sd;
        }
    }

    __device__ __forceinline__ void load(E* dst, int k0, int dim, int tid, const E* base, long long sr,
                                         long long sd, int r0, int n) const {
        if constexpr (VEC > 1) {
            if (bytes < 0) return;
#pragma unroll
            for (int pass = 0; pass < TK / KPP; ++pass) {
                const bool in_d = k0 + kf + pass * KPP < dim;
                const E* p = in_d ? src + (long long)(k0 + pass * KPP) * sd : src;
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
                const E* p = ok ? base + (long long)(r0 + r) * sr + (long long)d * sd : base;
                copy_elem(dst + k * LD + r, p, ok);
            }
        }
    }
};

// Level L of the pyramid from level L - 1 in the tile's first BN >> (L-1)
// columns: every pooled value into registers, a barrier, then into the
// tile's first BN >> L columns and out to `out` (width wl, the tile's
// columns starting at c0), consecutive threads on consecutive columns.
// Widths are compile-time, so the index arithmetic folds.
template <typename E, int BM, int BN, int THREADS, int L>
__device__ __forceinline__ void pool_level(float* tile, E* __restrict__ out, long long row_w1, int m0,
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
            v[it] = pool2<E>(tile[m * LT + 2 * c], tile[m * LT + 2 * c + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < PT; ++it) {
        const int e = tid + it * THREADS;
        const int m = e / COLS;
        const int c = e - m * COLS;
        if (N % THREADS == 0 || e < N) {
            tile[m * LT + c] = v[it];
            if (m0 + m < w1 && c0 + c < wl) Elem<E>::store(out + (row_w1 + m0 + m) * wl + c0 + c, v[it]);
        }
    }
    __syncthreads();
}

// Store a run of LEN consecutive values at column c of a row whose first
// tile column is n0, width w (a vector store where the run lies inside it).
template <int LEN>
__device__ __forceinline__ void store_run(float* dst, int n0, int c, int w, const float* v) {
    if (n0 + c + LEN <= w) {
        store_vec<LEN>(dst + c, v);
    } else {
#pragma unroll
        for (int q = 0; q < LEN; ++q)
            if (n0 + c + q < w) dst[c + q] = v[q];
    }
}

__device__ __forceinline__ float* level_ptr(const Levels<float>& levels, int l) {
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
                                                   int n0, int w2, int num_levels, const Levels<float>& levels) {
    if (in_row) store_run<4>(levels.ptr[0] + out_row * w2 + n0, n0, c, w2, v);
    if (num_levels <= 1) return;
    int col = c >> 1;
    const float l1[2] = {pool2<float>(v[0], v[1]), pool2<float>(v[2], v[3])};
    if (in_row) store_run<2>(levels.ptr[1] + out_row * (w2 >> 1) + (n0 >> 1), n0 >> 1, col, w2 >> 1, l1);
    if (num_levels <= 2) return;
    float x = pool2<float>(l1[0], l1[1]);
    col >>= 1;
    if (in_row && (n0 >> 2) + col < (w2 >> 2)) levels.ptr[2][out_row * (w2 >> 2) + (n0 >> 2) + col] = x;
#pragma unroll
    for (int l = 3; l < REG_LEVELS; ++l) {
        if (num_levels <= l) return;  // uniform over the block: every lane shuffles
        const int bit = 1 << (l - 3);
        const float other = __shfl_xor_sync(0xffffffffu, x, bit);
        x = (tx & bit) == 0 ? pool2<float>(x, other) : pool2<float>(other, x);
        col >>= 1;
        const int wl = w2 >> l;
        if (in_row && (tx & (2 * bit - 1)) == 0 && (n0 >> l) + col < wl)
            level_ptr(levels, l)[out_row * wl + (n0 >> l) + col] = x;
    }
}

// The levels of one tile from level 0 in shared memory (`tile`, BM x BN
// floats, row stride BN + 1, values already rounded to E): level 0 written
// out, then each pooled level in place (columns [0, BN >> l) hold level l
// after step l), each written once with consecutive threads on consecutive
// columns.
template <typename E, int BM, int BN, int THREADS>
__device__ __forceinline__ void epilogue_from_tile(float* tile, const Levels<E>& levels, long long row_w1, int m0,
                                                   int n0, int w1, int w2, int num_levels, int tid) {
    constexpr int LT = BN + 1;
#pragma unroll 4
    for (int e = tid; e < BM * BN; e += THREADS) {
        const int m = e / BN;
        const int n = e - m * BN;
        if (m0 + m < w1 && n0 + n < w2) Elem<E>::store(levels.ptr[0] + (row_w1 + m0 + m) * w2 + n0 + n, tile[m * LT + n]);
    }
    if (num_levels > 1) pool_level<E, BM, BN, THREADS, 1>(tile, levels.ptr[1], row_w1, m0, w1, w2 >> 1, n0 >> 1, tid);
    if (num_levels > 2) pool_level<E, BM, BN, THREADS, 2>(tile, levels.ptr[2], row_w1, m0, w1, w2 >> 2, n0 >> 2, tid);
    if (num_levels > 3) pool_level<E, BM, BN, THREADS, 3>(tile, levels.ptr[3], row_w1, m0, w1, w2 >> 3, n0 >> 3, tid);
    if (num_levels > 4) pool_level<E, BM, BN, THREADS, 4>(tile, levels.ptr[4], row_w1, m0, w1, w2 >> 4, n0 >> 4, tid);
    if (num_levels > 5) pool_level<E, BM, BN, THREADS, 5>(tile, levels.ptr[5], row_w1, m0, w1, w2 >> 5, n0 >> 5, tid);
    if (num_levels > 6) pool_level<E, BM, BN, THREADS, 6>(tile, levels.ptr[6], row_w1, m0, w1, w2 >> 6, n0 >> 6, tid);
}

// The fp32 build. One block: the BM x BN tile of (W1, W2) of one row, TM x
// TN accumulators per thread on a (BM / TM) x (BN / TN) thread grid; the
// tiles of a row are consecutive blocks, so they share its operands in L2.
template <int BM, int BN, int TM, int TN, int VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), 2)
corr_pyramid_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    long long s1b, long long s1h, long long s1w, long long s1d,
                    long long s2b, long long s2h, long long s2w, long long s2d,
                    int height, int w1, int w2, int dim, int num_levels, int m_tiles, int n_tiles,
                    bool direct, Levels<float> levels) {
    static_assert(TN % 4 == 0, "the epilogue stores and pools 4-element column runs");
    constexpr int NTM = BM / TM, NTN = BN / TN;
    constexpr int THREADS = NTM * NTN;
    constexpr int WN = NTN / 8;  // warps along N; a warp's lanes are 4 (M) x 8 (N)
    using ALoader = ChunkLoader<float, BM, THREADS, VEC>;
    using BLoader = ChunkLoader<float, BN, THREADS, VEC>;
    constexpr int LDA = ALoader::LD, LDB = BLoader::LD;
    constexpr int STAGE = TK * (LDA + LDB);  // A then B
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    float* smem = reinterpret_cast<float*>(smem_bytes);

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

    const ALoader a_load(a_row, s1d, m0, w1, tid);
    const BLoader b_load(b_row, s2d, n0, w2, tid);
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
    // ring: level 0 from the registers, then `epilogue_from_tile`.
    float* tile = reinterpret_cast<float*>(smem_bytes);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
            tile[frag_pos<TM, NTM>(i, ty) * (BN + 1) + frag_pos<TN, NTN>(j, tx)] = scaled(acc[i][j]);
    __syncthreads();
    epilogue_from_tile<float, BM, BN, THREADS>(tile, levels, row_w1, m0, n0, w1, w2, num_levels, tid);
}

// ---- The bf16 build: tensor cores ----------------------------------------

// Four 8x8 bf16 matrices from shared memory, transposed: lanes 8j .. 8j+7
// give the addresses of matrix j's eight 16-byte rows, and register j of
// every lane receives its pair of matrix j's transpose (row lane / 4,
// columns 2 (lane % 4) and the next).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 products
// summed in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                 "{%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block: the 128 x 128 tile of (W1, W2) of one row, 8 warps as 2 (M) x
// 4 (N), each warp 64 x 32 of it as 4 x 4 tiles of mma.sync m16n8k16. The
// operands come through the fp32 build's ring (bf16 elements, k-major rows,
// 16-byte copies of 8 elements along W where the plan allows), one k-step
// of 16 per chunk; ldmatrix.trans turns the k-major rows into the A and B
// fragments. The epilogue writes the rounded level 0 into a shared tile
// that aliases the drained ring and pools it there (`epilogue_from_tile`).
constexpr int MMA_BM = 128, MMA_BN = 128, MMA_THREADS = 256;
constexpr int MMA_WM = 64, MMA_WN = 32;  // a warp's tile
constexpr int MMA_MT = MMA_WM / 16, MMA_NT = MMA_WN / 8;

template <int VEC>
__global__ void __launch_bounds__(MMA_THREADS, 2)
corr_pyramid_mma_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ f2,
                        long long s1b, long long s1h, long long s1w, long long s1d,
                        long long s2b, long long s2h, long long s2w, long long s2d,
                        int height, int w1, int w2, int dim, int num_levels, int m_tiles, int n_tiles,
                        Levels<__nv_bfloat16> levels) {
    using bf16 = __nv_bfloat16;
    using ALoader = ChunkLoader<bf16, MMA_BM, MMA_THREADS, VEC>;
    using BLoader = ChunkLoader<bf16, MMA_BN, MMA_THREADS, VEC>;
    constexpr int LDA = ALoader::LD, LDB = BLoader::LD;
    constexpr int STAGE = TK * (LDA + LDB);  // A then B
    static_assert(TK == 16, "one mma k-step per chunk");
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    bf16* smem = reinterpret_cast<bf16*>(smem_bytes);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp / (MMA_BN / MMA_WN) * MMA_WM;  // the warp's first row and column in the tile
    const int wn = warp % (MMA_BN / MMA_WN) * MMA_WN;
    const int tiles = m_tiles * n_tiles;
    const int row = blockIdx.x / tiles;  // b * H + h
    const int rem = blockIdx.x - row * tiles;
    const int m0 = (rem / n_tiles) * MMA_BM;
    const int n0 = (rem - (rem / n_tiles) * n_tiles) * MMA_BN;
    const int b = row / height;
    const int h = row - b * height;
    const bf16* a_row = f1 + b * s1b + h * s1h;
    const bf16* b_row = f2 + b * s2b + h * s2h;

    float acc[MMA_MT][MMA_NT][4];
#pragma unroll
    for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
        for (int j = 0; j < MMA_NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

    // ldmatrix row addresses: lane group q = lane / 8 gives one matrix's
    // eight rows (r = lane % 8), k-major in shared memory. A's matrices in
    // register order are (m, k) blocks (0, 0), (8, 0), (0, 8), (8, 8); a B
    // load covers two n8 tiles, (k, n) blocks (0, 0), (8, 0), (0, 8), (8, 8).
    const int q = lane >> 3, r = lane & 7;
    const int a_off = (r + 8 * (q >> 1)) * LDA + wm + 8 * (q & 1);
    const int b_off = (r + 8 * (q & 1)) * LDB + wn + 8 * (q >> 1);

    const ALoader a_load(a_row, s1d, m0, w1, tid);
    const BLoader b_load(b_row, s2d, n0, w2, tid);
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
        const int next = kt + STAGES - 1;
        if (next < chunks) {
            bf16* dst = smem + (next % STAGES) * STAGE;
            a_load.load(dst, next * TK, dim, tid, a_row, s1w, s1d, m0, w1);
            b_load.load(dst + TK * LDA, next * TK, dim, tid, b_row, s2w, s2d, n0, w2);
        }
        cp_async_commit();
        const bf16* as = smem + (kt % STAGES) * STAGE;
        const bf16* bs = as + TK * LDA;
        unsigned af[MMA_MT][4], bfr[MMA_NT][2];
#pragma unroll
        for (int i = 0; i < MMA_MT; ++i) ldmatrix_x4_trans(af[i], as + a_off + 16 * i);
#pragma unroll
        for (int j = 0; j < MMA_NT; j += 2) {
            unsigned t[4];
            ldmatrix_x4_trans(t, bs + b_off + 8 * j);
            bfr[j][0] = t[0]; bfr[j][1] = t[1]; bfr[j + 1][0] = t[2]; bfr[j + 1][1] = t[3];
        }
#pragma unroll
        for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
            for (int j = 0; j < MMA_NT; ++j) mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: the epilogue tile may alias it

    const float scale = sqrtf((float)dim);
    const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0 && scale >= 1.0f;
    const float inv = __frcp_rn(scale);
    auto scaled = [&](float x) { return Elem<bf16>::round(pow2 ? __fmul_rn(x, inv) : __fdiv_rn(x, scale)); };
    // Accumulator c of tile (i, j): row g (+8 for c >= 2), columns 2t, 2t+1.
    constexpr int LT = MMA_BN + 1;
    float* tile = reinterpret_cast<float*>(smem_bytes);
    const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
        for (int j = 0; j < MMA_NT; ++j) {
            float* p = tile + (wm + 16 * i + g) * LT + wn + 8 * j + t2;
            p[0] = scaled(acc[i][j][0]);
            p[1] = scaled(acc[i][j][1]);
            p[8 * LT] = scaled(acc[i][j][2]);
            p[8 * LT + 1] = scaled(acc[i][j][3]);
        }
    __syncthreads();
    epilogue_from_tile<bf16, MMA_BM, MMA_BN, MMA_THREADS>(tile, levels, (long long)row * w1, m0, n0, w1, w2,
                                                           num_levels, tid);
}

// ---- The bf16 build on Hopper: TMA, wgmma, persistent blocks --------------
//
// The design is in the note at the top. Roles: warpgroups 0 and 1 consume
// (64 of the tile's rows each), warpgroup 2 produces (its first thread
// issues every TMA load). Barriers: full[s] (1 arrival + the slot's bytes)
// and empty[s] (the 8 consumer warps) per ring slot s, phases counted over
// the block's whole (tile, k64 stage) sequence.

constexpr int WG_BM = 128;                          // W1 rows of a tile: two consumer warpgroups of 64
constexpr int WG_BK = 64;                           // D per stage
constexpr int WG_BOX = 64;                          // W extent of a TMA box: 128 bytes, the swizzle span
constexpr int WG_BOX_BYTES = WG_BOX * WG_BK * 2;    // 8192
constexpr int WG_THREADS = 384;                     // consumer warpgroups 0-1, producer warpgroup 2
constexpr int WG_LEVELS = 4;                        // levels one 8-column chunk of level 0 pools into
constexpr int WG_PAD = 8;                           // staging row padding (elements)
constexpr int WG_K_STEP_BYTES = 16 * WG_BOX * 2;    // one k16 step: 16 rows of a box

template <int N>
struct WgTile {
    static constexpr int BOXES = (N + WG_BOX - 1) / WG_BOX;
    static constexpr int STAGE_BYTES = (WG_BM / WG_BOX + BOXES) * WG_BOX_BYTES;
    static constexpr int LDS = N + WG_PAD;
    static constexpr int STAGING_BYTES = WG_BM * LDS * 2;
    // The slack to align the ring to a 1024-byte swizzle atom, the ring, the
    // two staging tiles, a full and an empty barrier per slot.
    static constexpr int shared_bytes(int stages) { return 1024 + stages * STAGE_BYTES + STAGING_BYTES + 16 * stages; }
};

template <int N>
__global__ void __launch_bounds__(WG_THREADS, 1)
corr_pyramid_wgmma_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
                          int height, int w1, int w2, int dim, int num_levels, int m_tiles, int n_tiles, int tiles,
                          int stages, Levels<__nv_bfloat16> levels) {
    using bf16 = __nv_bfloat16;
    using T = WgTile<N>;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bf16* staging = reinterpret_cast<bf16*>(ring + stages * T::STAGE_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * T::STAGE_BYTES + T::STAGING_BYTES);
    uint64_t* empty = full + stages;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 8);
        }
        mbar_init_fence();
    }
    __syncthreads();
    const int chunks = (dim + WG_BK - 1) / WG_BK;
    const int per_row = m_tiles * n_tiles;

    if (wg == 2) {
        // Producer: one thread issues every load.
        setmaxnreg_dec<40>();
        if (tid == 256) {
            uint32_t it = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int row = t / per_row;
                const int rem = t - row * per_row;
                const int m0 = (rem / n_tiles) * WG_BM;
                const int n0 = (rem - (rem / n_tiles) * n_tiles) * N;
                const int b = row / height;
                const int h = row - b * height;
                for (int kc = 0; kc < chunks; ++kc, ++it) {
                    const uint32_t s = it % stages;
                    mbar_wait(empty + s, ((it / stages) & 1) ^ 1);
                    unsigned char* slot = ring + s * T::STAGE_BYTES;
                    mbar_arrive_expect_tx(full + s, T::STAGE_BYTES);
#pragma unroll
                    for (int i = 0; i < WG_BM / WG_BOX; ++i)
                        tma_load_4d(slot + i * WG_BOX_BYTES, &map1, full + s, m0 + i * WG_BOX, h, kc * WG_BK, b);
#pragma unroll
                    for (int i = 0; i < T::BOXES; ++i)
                        tma_load_4d(slot + (WG_BM / WG_BOX + i) * WG_BOX_BYTES, &map2, full + s, n0 + i * WG_BOX, h,
                                    kc * WG_BK, b);
                }
            }
        }
    } else {
        setmaxnreg_inc<232>();
        const int t128 = tid & 127;
        const int warp = t128 >> 5, lane = tid & 31;
        const float scale = sqrtf((float)dim);
        const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0 && scale >= 1.0f;
        const float inv = __frcp_rn(scale);
        bf16* stg = staging + wg * 64 * T::LDS;
        // stmatrix addresses: lane l gives row l % 8 of matrix l / 8, which
        // is (rows 8 (l / 8 % 2) .., columns 8 (l / 16) ..) of a 16 x 16 block.
        const int st_row = 16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
        const int st_col = 8 * (lane >> 4);
        float acc[N / 2];
        uint32_t it = 0;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
            const int row = t / per_row;
            const int rem = t - row * per_row;
            const int m0 = (rem / n_tiles) * WG_BM;
            const int n0 = (rem - (rem / n_tiles) * n_tiles) * N;
            for (int kc = 0; kc < chunks; ++kc, ++it) {
                const uint32_t s = it % stages;
                mbar_wait(full + s, (it / stages) & 1);
                const uint32_t slot = smem_u32(ring + s * T::STAGE_BYTES);
                const uint32_t a_addr = slot + wg * WG_BOX_BYTES;
                const uint32_t b_addr = slot + (WG_BM / WG_BOX) * WG_BOX_BYTES;
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < WG_BK / 16; ++k)
                    WgmmaSS<N>::mma(acc, sw128_desc(a_addr + k * WG_K_STEP_BYTES, WG_BOX_BYTES, 1024),
                                    sw128_desc(b_addr + k * WG_K_STEP_BYTES, WG_BOX_BYTES, 1024), kc > 0 || k > 0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_operands(acc);
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
            }

            // Epilogue: the rounded level 0 into the staging tile ...
            named_barrier(1 + wg, 128);  // this warpgroup's reads of the previous tile are done
#pragma unroll
            for (int j = 0; j < N / 8; j += 2) {
                float v[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) v[e] = pow2 ? __fmul_rn(acc[4 * j + e], inv) : __fdiv_rn(acc[4 * j + e], scale);
                const uint32_t r[4] = {bf16x2_rn(v[0], v[1]), bf16x2_rn(v[2], v[3]), bf16x2_rn(v[4], v[5]),
                                       bf16x2_rn(v[6], v[7])};
                stmatrix_x4(stg + st_row * T::LDS + 8 * j + st_col, r);
            }
            named_barrier(1 + wg, 128);
            // ... then every level out of it, one 8-column chunk per thread.
            const long long row_w1 = (long long)row * w1;
            constexpr int CPR = N / 8;  // chunks per row
            for (int e = t128; e < 64 * CPR; e += 128) {
                const int r = e / CPR;
                const int c = e - r * CPR;
                const int gm = m0 + 64 * wg + r;
                const int gn = n0 + 8 * c;
                if (gm >= w1 || gn >= w2) continue;
                const long long orow = row_w1 + gm;
                const uint4 u = *reinterpret_cast<const uint4*>(stg + r * T::LDS + 8 * c);
                *reinterpret_cast<uint4*>(levels.ptr[0] + orow * w2 + gn) = u;
                if (num_levels < 2) continue;
                // Each level pooled from the previous level's rounded values:
                // an fp32 sum and halving, one rounding (two values at a time).
                auto pool = [](float a, float b) { return __fmul_rn(__fadd_rn(a, b), 0.5f); };
                const uint2 p1 = make_uint2(bf16x2_rn(pool(bf16_lo(u.x), bf16_hi(u.x)), pool(bf16_lo(u.y), bf16_hi(u.y))),
                                            bf16x2_rn(pool(bf16_lo(u.z), bf16_hi(u.z)), pool(bf16_lo(u.w), bf16_hi(u.w))));
                *reinterpret_cast<uint2*>(levels.ptr[1] + orow * (w2 >> 1) + (gn >> 1)) = p1;
                if (num_levels < 3) continue;
                const uint32_t p2 = bf16x2_rn(pool(bf16_lo(p1.x), bf16_hi(p1.x)), pool(bf16_lo(p1.y), bf16_hi(p1.y)));
                *reinterpret_cast<uint32_t*>(levels.ptr[2] + orow * (w2 >> 2) + (gn >> 2)) = p2;
                if (num_levels < 4) continue;
                Elem<bf16>::store(levels.ptr[3] + orow * (w2 >> 3) + (gn >> 3), pool(bf16_lo(p2), bf16_hi(p2)));
            }
        }
    }
}

// A (W, H, D, B) tensor map of one feature map (element strides s[0..3] of
// b, h, w, d; w unit-stride): 64 x 64 (W x D) boxes, 128-byte swizzling,
// zeros outside. A dimension of size 1 never moves, so its stride is
// replaced by a packed one (TMA takes only multiples of 16 bytes).
static int encode_fmap(CUtensorMap* map, const void* base, int batch, int height, int w, int dim,
                       const long long* s) {
    TensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    if (s[2] != 1 || ((uintptr_t)base & 15) != 0) return (int)cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)height, (cuuint64_t)dim, (cuuint64_t)batch};
    const long long want[3] = {s[1], s[3], s[0]};  // h, d, b
    cuuint64_t strides[3];
    cuuint64_t packed = (cuuint64_t)w * 2;
    for (int i = 0; i < 3; ++i) {
        packed = (packed + 15) / 16 * 16;
        strides[i] = dims[i + 1] == 1 ? packed : (cuuint64_t)want[i] * 2;
        if (strides[i] % 16 != 0) return (int)cudaErrorInvalidValue;
        packed = strides[i] * dims[i + 1];
    }
    const cuuint32_t box[4] = {WG_BOX, 1, WG_BK, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The shared bytes a kernel of element E with a BM x BN tile needs: its ring
// or the fp32 epilogue tile that aliases it, whichever is larger.
template <typename E, int BM, int BN>
constexpr int needed_shared() {
    constexpr int ring = STAGES * TK * (BM + BN + 2 * (PAD_BYTES / (int)sizeof(E))) * (int)sizeof(E);
    constexpr int tile = BM * (BN + 1) * 4;
    return ring > tile ? ring : tile;
}

template <typename E>
static int level_table(Levels<E>& levels, void* const* level_ptrs, int num_levels, bool direct) {
    for (int l = 0; l < MAX_LEVELS; ++l) {
        levels.ptr[l] = l < num_levels ? (E*)level_ptrs[l] : nullptr;
        // The register epilogue stores float4 runs: level rows must start
        // 16-byte aligned, which the plan asks of W2 and the wrapper's
        // allocations give.
        if (direct && l < num_levels && ((uintptr_t)levels.ptr[l] & 15) != 0) return (int)cudaErrorInvalidValue;
    }
    return 0;
}

template <int BM, int BN, int TM, int TN, int VEC>
static int launch(const void* f1, const void* f2, const long long* s, int height, int w1, int w2, int dim,
                  int num_levels, void* const* level_ptrs, int m_tiles, int n_tiles, long long blocks,
                  int shared_bytes, bool direct, cudaStream_t stream) {
    constexpr int THREADS = (BM / TM) * (BN / TN);
    if (shared_bytes < needed_shared<float, BM, BN>()) return (int)cudaErrorInvalidValue;
    Levels<float> levels;
    int status = level_table(levels, level_ptrs, num_levels, direct);
    if (status != 0) return status;
    auto kernel = corr_pyramid_kernel<BM, BN, TM, TN, VEC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, THREADS, shared_bytes, stream>>>(
        (const float*)f1, (const float*)f2, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], height, w1, w2, dim,
        num_levels, m_tiles, n_tiles, direct, levels);
    return (int)cudaGetLastError();
}

template <int VEC>
static int launch_mma(const void* f1, const void* f2, const long long* s, int height, int w1, int w2, int dim,
                      int num_levels, void* const* level_ptrs, int m_tiles, int n_tiles, long long blocks,
                      int shared_bytes, cudaStream_t stream) {
    if (shared_bytes < needed_shared<__nv_bfloat16, MMA_BM, MMA_BN>()) return (int)cudaErrorInvalidValue;
    Levels<__nv_bfloat16> levels;
    level_table(levels, level_ptrs, num_levels, false);
    auto kernel = corr_pyramid_mma_kernel<VEC>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, MMA_THREADS, shared_bytes, stream>>>(
        (const __nv_bfloat16*)f1, (const __nv_bfloat16*)f2, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], height,
        w1, w2, dim, num_levels, m_tiles, n_tiles, levels);
    return (int)cudaGetLastError();
}

template <int N>
static int launch_wgmma(const void* f1, const void* f2, const long long* s, int batch, int height, int w1, int w2,
                        int dim, int num_levels, void* const* level_ptrs, int m_tiles, int n_tiles, long long blocks,
                        int shared_bytes, int stages, cudaStream_t stream) {
    const long long tiles = (long long)batch * height * m_tiles * n_tiles;
    if (shared_bytes != WgTile<N>::shared_bytes(stages) || stages < 2 || dim < 1 || num_levels > WG_LEVELS ||
        (w2 & 7) != 0 || tiles > 0x7fffffffLL || blocks < 1 || blocks > tiles)
        return (int)cudaErrorInvalidValue;
    Levels<__nv_bfloat16> levels;
    level_table(levels, level_ptrs, num_levels, false);
    for (int l = 0; l < num_levels; ++l)  // 16-byte level-0 chunks, 8- and 4-byte pooled runs
        if (((uintptr_t)levels.ptr[l] & 15) != 0) return (int)cudaErrorInvalidValue;
    CUtensorMap map1, map2;
    int status = encode_fmap(&map1, f1, batch, height, w1, dim, s);
    if (status == 0) status = encode_fmap(&map2, f2, batch, height, w2, dim, s + 4);
    if (status != 0) return status;
    auto kernel = corr_pyramid_wgmma_kernel<N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, WG_THREADS, shared_bytes, stream>>>(map1, map2, height, w1, w2, dim, num_levels,
                                                                   m_tiles, n_tiles, (int)tiles, stages, levels);
    return (int)cudaGetLastError();
}

// Kernels by `path`: 0 the fp32 FFMA build, 1 the bf16 mma.sync build (128
// x 128 tiles, one block per tile, the shared-memory epilogue), 2 the bf16
// wgmma build (persistent blocks, tile 128 x tile_n, `stages` ring slots).
// f1, f2 and the levels are fp32 for path 0, bf16 otherwise; strides: the
// 8 element strides (b, h, w, d) of f1 then f2. The launch plan (path,
// tile, copy width, tiles per row, blocks, shared bytes, register
// epilogue, ring depth) comes from ops/corr_cuda.py `pyramid_plan`; a plan
// no instantiation takes is refused.
extern "C" int raft_corr_pyramid(const void* f1, const void* f2, const long long* strides, int batch,
                                 int height, int w1, int w2, int dim, int num_levels, void* const* level_ptrs,
                                 int tile_m, int tile_n, int vec, int m_tiles, int n_tiles, long long blocks,
                                 int shared_bytes, int direct, int path, int stages, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (tile_n % (1 << (num_levels - 1)) != 0) return (int)cudaErrorInvalidValue;
    if ((long long)m_tiles * tile_m < w1 || (long long)n_tiles * tile_n < w2) return (int)cudaErrorInvalidValue;
    if (path != 2 && (blocks != (long long)batch * height * m_tiles * n_tiles || blocks > 0x7fffffffLL))
        return (int)cudaErrorInvalidValue;
    if (direct && ((w2 & 3) != 0 || num_levels > REG_LEVELS || path != 0)) return (int)cudaErrorInvalidValue;
    if ((long long)batch * height * m_tiles * n_tiles == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (path == 2) {
        if (tile_m != WG_BM || vec != 8) return (int)cudaErrorInvalidValue;
#define RAFT_PYRAMID_WGMMA_CASE(N)                                                                          \
        if (tile_n == N)                                                                                    \
            return launch_wgmma<N>(f1, f2, strides, batch, height, w1, w2, dim, num_levels, level_ptrs, m_tiles, \
                                   n_tiles, blocks, shared_bytes, stages, s);
        RAFT_PYRAMID_WGMMA_CASE(64)
        RAFT_PYRAMID_WGMMA_CASE(96)
        RAFT_PYRAMID_WGMMA_CASE(128)
        RAFT_PYRAMID_WGMMA_CASE(160)
        RAFT_PYRAMID_WGMMA_CASE(192)
        RAFT_PYRAMID_WGMMA_CASE(240)
        RAFT_PYRAMID_WGMMA_CASE(256)
#undef RAFT_PYRAMID_WGMMA_CASE
        return (int)cudaErrorInvalidValue;
    }
    if (path == 1) {
        if (tile_m != MMA_BM || tile_n != MMA_BN) return (int)cudaErrorInvalidValue;
        if (vec == 8)
            return launch_mma<8>(f1, f2, strides, height, w1, w2, dim, num_levels, level_ptrs, m_tiles, n_tiles,
                                 blocks, shared_bytes, s);
        if (vec == 1)
            return launch_mma<1>(f1, f2, strides, height, w1, w2, dim, num_levels, level_ptrs, m_tiles, n_tiles,
                                 blocks, shared_bytes, s);
        return (int)cudaErrorInvalidValue;
    }
    if (path != 0) return (int)cudaErrorInvalidValue;
#define RAFT_PYRAMID_CASE(BM, BN, TM, TN, VEC)                                                          \
    if (tile_m == BM && tile_n == BN && vec == VEC)                                                     \
        return launch<BM, BN, TM, TN, VEC>(f1, f2, strides, height, w1, w2, dim, num_levels, level_ptrs,   \
                                           m_tiles, n_tiles, blocks, shared_bytes, direct != 0, s);
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
