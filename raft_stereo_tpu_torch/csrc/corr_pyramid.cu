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
// 67 TFLOP/s) against about 86 MB of traffic (0.026 ms at 3.35 TB/s); at
// Middlebury-F (496 rows, W = 720) 131.6 GFLOP, 1.96 ms.
//
// Design: one block of 256 threads per (row, 64 x 64 tile of W1 x W2). The
// GEMM is computed here, not by a library: D is looped in chunks of 16 staged
// into shared memory k-major, each thread accumulating a 4 x 4 register tile.
// The feature maps are read in place through the strides the wrapper passes:
// the model hands over permuted views of its NCHW maps, in which W is the
// unit-stride axis, so each chunk is loaded as contiguous runs along W.
// The pooling chain runs in the epilogue on the tile held in shared memory:
// a tile starts at a multiple of 64 and so of 2**(L-1), and its columns
// [c0, c0 + 64) of level 0 give exactly columns [c0 >> l, (c0 + 64) >> l) of
// level l, so the volume never leaves the block before it is pooled; each
// level is written once, with consecutive threads on consecutive columns.
//
// Rounding: built with contraction on (the GEMM is FFMAs); the division is an
// IEEE __fdiv_rn by sqrtf(D) and the pooling uses __fadd_rn / __fmul_rn, so
// the pyramid is built from the stored volume exactly as the plain version
// builds it. Each entry sums over D in order with one FFMA chain; cuBLAS's
// fp32 GEMM on the H100 was measured to agree bit for bit, but that is its
// choice of algorithm, so the checks keep a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#define TM 64   // W1 tile
#define TN 64   // W2 tile
#define TK 16   // D chunk
#define THREADS 256
#define MAX_LEVELS 7  // 2**(MAX_LEVELS-1) must divide TN

struct Levels {
    float* ptr[MAX_LEVELS];
};

__global__ void __launch_bounds__(THREADS)
corr_pyramid_kernel(const float* __restrict__ f1, const float* __restrict__ f2,
                    long long s1b, long long s1h, long long s1w, long long s1d,
                    long long s2b, long long s2h, long long s2w, long long s2d,
                    int height, int w1, int w2, int dim, int num_levels, Levels levels) {
    __shared__ __align__(16) float as[TK][TM];
    __shared__ __align__(16) float bs[TK][TN];
    __shared__ float tile[TM][TN + 1];

    const int tid = threadIdx.x;
    const int tx = tid & 15;  // columns tx*4 .. +3 of the tile (W2)
    const int ty = tid >> 4;  // rows ty*4 .. +3 (W1)
    const int n0 = blockIdx.x * TN;
    const int m0 = blockIdx.y * TM;
    const int row = blockIdx.z;  // b * H + h
    const int b = row / height;
    const int h = row - b * height;
    const float* a_row = f1 + b * s1b + h * s1h;
    const float* b_row = f2 + b * s2b + h * s2h;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < dim; k0 += TK) {
        for (int e = tid; e < TK * TM; e += THREADS) {
            const int k = e / TM;
            const int m = e - k * TM;
            const int d = k0 + k;
            as[k][m] = (m0 + m < w1 && d < dim) ? a_row[(m0 + m) * s1w + d * s1d] : 0.0f;
            bs[k][m] = (n0 + m < w2 && d < dim) ? b_row[(n0 + m) * s2w + d * s2d] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
            const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
            const float av[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
    }

    const float scale = sqrtf((float)dim);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tile[ty * 4 + i][tx * 4 + j] = __fdiv_rn(acc[i][j], scale);
    __syncthreads();

    // Level 0, then each pooled level in place: columns [0, TN >> l) of the
    // shared tile hold level l after step l.
    for (int e = tid; e < TM * TN; e += THREADS) {
        const int m = e / TN;
        const int n = e - m * TN;
        if (m0 + m < w1 && n0 + n < w2) levels.ptr[0][((long long)row * w1 + m0 + m) * w2 + n0 + n] = tile[m][n];
    }
    int wl = w2;
    for (int l = 1; l < num_levels; ++l) {
        wl >>= 1;
        const int cols = TN >> l;
        const int c0 = n0 >> l;
        float* out = levels.ptr[0];
#pragma unroll
        for (int j = 1; j < MAX_LEVELS; ++j)
            if (j == l) out = levels.ptr[j];
        // Read every pair of this level into registers, then overwrite the
        // tile's first columns; fixed trip counts keep `v` in registers.
        constexpr int per_thread = TM * (TN / 2) / THREADS;
        float v[per_thread];
#pragma unroll
        for (int it = 0; it < per_thread; ++it) {
            const int e = tid + it * THREADS;
            const int m = e / cols;
            const int n = e - m * cols;
            if (e < TM * cols) v[it] = __fmul_rn(__fadd_rn(tile[m][2 * n], tile[m][2 * n + 1]), 0.5f);
        }
        __syncthreads();
#pragma unroll
        for (int it = 0; it < per_thread; ++it) {
            const int e = tid + it * THREADS;
            const int m = e / cols;
            const int n = e - m * cols;
            if (e < TM * cols) {
                tile[m][n] = v[it];
                if (m0 + m < w1 && c0 + n < wl) out[((long long)row * w1 + m0 + m) * wl + c0 + n] = v[it];
            }
        }
        __syncthreads();
    }
}

// strides: the 8 element strides (b, h, w, d) of f1 then f2.
extern "C" int raft_corr_pyramid_f32(const void* f1, const void* f2, const long long* strides,
                                     int batch, int height, int w1, int w2, int dim, int num_levels,
                                     void* const* level_ptrs, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (batch * height == 0 || w1 == 0 || w2 == 0) return 0;
    if ((long long)batch * height > 65535) return (int)cudaErrorInvalidValue;
    Levels levels;
    for (int l = 0; l < MAX_LEVELS; ++l) levels.ptr[l] = l < num_levels ? (float*)level_ptrs[l] : nullptr;
    const dim3 grid((w2 + TN - 1) / TN, (w1 + TM - 1) / TM, batch * height);
    corr_pyramid_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)f1, (const float*)f2, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5], strides[6], strides[7], height, w1, w2, dim, num_levels, levels);
    return (int)cudaGetLastError();
}

extern "C" const char* raft_corr_pyramid_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
