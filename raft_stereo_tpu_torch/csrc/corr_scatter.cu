// Backward of the fused correlation-pyramid lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py `_scatter_kernel`
// (launched by `_scatter_pallas_padded`, the custom VJP of
// `pallas_corr_lookup_padded`). Same function: for every query q = (b, h, w1)
// and level l, with x = coords[q] / 2**l, base = floor(x) - r and the ONE
// fraction f = x - floor(x) that all 2r+1 taps share, the combined weights
//     cw[m] = g[m]*(1-f) + g[m-1]*f,  m = 0..2r+1,  g[-1] = g[2r+1] = 0
// land on the 2r+2 contiguous samples base+m of the query's own row of
// d(level l); every other sample of the row is zero. g is the query's slice
// of the tap cotangent (B, H, W1, L*(2r+1)), level-major, fp32 or bf16
// (the TPU wrapper widens it to fp32 first, which is exact, so reading bf16
// in place computes the same function). Out: the dense d(level l)
// (B, H, W1, W2_l), W2_l = W2 // 2**l, for every level, in the levels'
// type: fp32, or bf16 (bf16 training: the TPU kernel stores d(level) in the
// level's dtype).
//
// The shared fraction is the TPU backward's, not the per-tap fraction
// t - floor(t) of the forward: the two differ in the last bits where
// x + (k - r) rounds, so this is the JAX gradient, not bit for bit the
// vector-Jacobian product of the forward kernel.
//
// What bounds it on the H100: bytes. It writes the whole dense pyramid
// (sum_l W2_l elements per query: 116 MB in fp32 at the fp32 training
// recipe's 1/4 resolution, 0.035 ms at 3.35 TB/s; 38.8 MB in bf16 at the
// bf16 recipe's) and reads the coordinate and the L*(2r+1) cotangents of
// each query; there is at most one multiply-add pair per output.
//
// Design: a block of 256 threads owns a run of Q consecutive queries
// (ops/corr_cuda.py `scatter_plan` chooses Q, the grid and the shared
// bytes) over all L levels, in two phases.
// Phase 1 loads the run's coordinates and tap cotangents (contiguous,
// Q x L(2r+1) values, widened to fp32) into shared memory and works out
// each (query, level) once: x, floor(x), f, the window start floor(x) - r, or no window, and
// the 2r+2 combined weights cw.
// Phase 2 streams, level by level, the block's contiguous output span
// [q0 W2_l, (q0 + Q) W2_l): 16-byte streaming stores of VEC elements (4 fp32
// or 8 bf16; __stcs: the output is not re-read soon), element by element
// before the span's first 16-byte boundary (head) and after its last one
// (tail). Head, vector and tail counts are in elements: a bf16 row of 180,
// 90, 45 or 22 samples is 360, 180, 90 or 44 bytes, so most spans start at
// a 2-byte offset. Per element only its query and sample (one division per
// vector, then a wrapping counter), one compare against the window and a
// shared read of cw are left, then the store's rounding to bf16.
// Each query writes only its own rows, so there are no atomics and the
// result is the same on every run. The window test is done in float before
// any integer conversion, so coordinates far outside the row, infinite or
// NaN ones select no sample and cannot overflow an index.
//
// Measured (chip_smoke.py [timing], H100 80GB HBM3 at 700 W; PERF.md
// section 6, row 2): fp32, 2.42 TB/s at the recipe, 72% of the bound, with
// 32 to 128 queries per block within 2% of each other (16: 15% slower);
// bf16: PERF.md row 2b.
//
// Rounding: x / 2**l is an exact IEEE division, floorf matches torch.floor,
// and the library is compiled with -fmad=false, so cw is rounded exactly as
// the plain PyTorch version (ops/corr_cuda.py plain_corr_scatter) rounds it
// in fp32; a bf16 output rounds it once more, to nearest even
// (__float2bfloat16_rn), as the plain version's one cast does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

#define MAX_LEVELS 8
#define THREADS 256
#define NO_WINDOW 0x40000000  // a window start no sample index reaches

template <typename T>
struct LevelTable {
    T* ptr[MAX_LEVELS];
    int width[MAX_LEVELS];
};

// One element, rounded to T, as a streaming store.
__device__ __forceinline__ void stream_one(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void stream_one(__nv_bfloat16* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// 16 bytes of elements (4 fp32 or 8 bf16) at a 16-byte boundary, rounded
// to T, as one streaming store.
__device__ __forceinline__ void stream_vec(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void stream_vec(__nv_bfloat16* p, const float* v) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]), bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7])));
}

// d(level) of one element: sample s of local query j of the current level.
__device__ __forceinline__ float cw_at(const int* start, const float* cw, int p, int s, int k_cw) {
    const unsigned m = (unsigned)(s - start[p]);
    return m < (unsigned)k_cw ? cw[p * k_cw + m] : 0.0f;
}

template <typename G, typename T, typename Index>
__global__ void __launch_bounds__(THREADS)
corr_scatter_kernel(const float* __restrict__ coords, const G* __restrict__ grad, LevelTable<T> levels,
                    int num_levels, int radius, Index n_queries, int run) {
    constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte store
    extern __shared__ __align__(16) float smem[];
    const int taps = 2 * radius + 1;
    const int k_cw = taps + 1;  // combined weights per (query, level)
    const int lk = num_levels * taps;
    float* g_s = smem;                               // run x L(2r+1) cotangents
    float* cw_s = g_s + run * lk;                    // run x L x (2r+2) weights
    int* start_s = (int*)(cw_s + run * num_levels * k_cw);  // run x L window starts
    float* x_s = (float*)(start_s + run * num_levels);      // run coordinates

    const int tid = threadIdx.x;
    const Index q0 = (Index)blockIdx.x * run;
    const int nq = (int)(n_queries - q0 < (Index)run ? n_queries - q0 : (Index)run);
    for (int i = tid; i < nq; i += THREADS) x_s[i] = coords[q0 + i];
    const G* g_run = grad + q0 * lk;
    for (int i = tid; i < nq * lk; i += THREADS) g_s[i] = Elem<G>::load(g_run + i);
    __syncthreads();

    // Phase 1: one (query, level) pair per thread and pass.
    for (int p = tid; p < nq * num_levels; p += THREADS) {
        const int j = p / num_levels;
        const int l = p - j * num_levels;
        int w2 = levels.width[0];
#pragma unroll
        for (int t = 1; t < MAX_LEVELS; ++t)
            if (t == l) w2 = levels.width[t];
        const float x = x_s[j] / (float)(1 << l);
        const float x0f = floorf(x);
        const float frac = x - x0f;
        // Window start floor(x) - r, in float first: a sample s is selected
        // where s - start lies in [0, 2r+1], which some s in [0, W2_l) reaches
        // only for a start in [-(2r+1), W2_l - 1] (false for NaN).
        const float startf = x0f - (float)radius;
        const bool hit = startf >= -(float)taps && startf <= (float)(w2 - 1);
        start_s[p] = hit ? (int)startf : NO_WINDOW;
        const float* g = g_s + j * lk + l * taps;
        float* cw = cw_s + p * k_cw;
        for (int m = 0; m < k_cw; ++m) {
            const float g_lo = m < taps ? g[m] : 0.0f;
            const float g_hi = m > 0 ? g[m - 1] : 0.0f;
            cw[m] = g_lo * (1.0f - frac) + g_hi * frac;
        }
    }
    __syncthreads();

    // Phase 2: each level's span of the block, as one store stream.
#pragma unroll 1
    for (int l = 0; l < num_levels; ++l) {
        T* base = levels.ptr[0];
        int w2 = levels.width[0];
#pragma unroll
        for (int t = 1; t < MAX_LEVELS; ++t)
            if (t == l) {
                base = levels.ptr[t];
                w2 = levels.width[t];
            }
        if (w2 == 0) continue;
        T* dst = base + q0 * w2;
        const int n = nq * w2;
        // Elements before the span's first 16-byte boundary (the address is
        // a multiple of the element size), then whole vectors, then the tail.
        int head = (int)(((16u - ((unsigned)(uintptr_t)dst & 15u)) & 15u) / sizeof(T));
        head = head < n ? head : n;
        const int nvec = (n - head) / VEC;
        for (int e = tid; e < head; e += THREADS) {
            const int j = e / w2;
            stream_one(dst + e, cw_at(start_s, cw_s, j * num_levels + l, e - j * w2, k_cw));
        }
        for (int v = tid; v < nvec; v += THREADS) {
            const int e0 = head + VEC * v;
            int j = e0 / w2;
            int s = e0 - j * w2;
            float out[VEC];
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                out[i] = cw_at(start_s, cw_s, j * num_levels + l, s, k_cw);
                if (++s == w2) {
                    s = 0;
                    ++j;
                }
            }
            stream_vec(dst + e0, out);
        }
        for (int e = head + VEC * nvec + tid; e < n; e += THREADS) {
            const int j = e / w2;
            stream_one(dst + e, cw_at(start_s, cw_s, j * num_levels + l, e - j * w2, k_cw));
        }
    }
}

template <typename G, typename T, typename Index>
static cudaError_t launch(const void* coords, const void* grad, const LevelTable<T>& table, int num_levels,
                          long long n_queries, int radius, int run, long long blocks, int shared_bytes,
                          cudaStream_t s) {
    auto kernel = corr_scatter_kernel<G, T, Index>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks, THREADS, shared_bytes, s>>>(
        (const float*)coords, (const G*)grad, table, num_levels, radius, (Index)n_queries, run);
    return cudaGetLastError();
}

template <typename G, typename T>
static int dispatch(const void* coords, const void* grad, void* const* level_ptrs, const int* level_widths,
                    int num_levels, long long n_queries, int radius, int run, long long blocks, int shared_bytes,
                    int wide, int vec, cudaStream_t s) {
    if (vec != 16 / (int)sizeof(T)) return (int)cudaErrorInvalidValue;
    LevelTable<T> table;
    long long widest = (long long)num_levels * (2 * radius + 1);
    for (int l = 0; l < MAX_LEVELS; ++l) {
        table.ptr[l] = l < num_levels ? (T*)level_ptrs[l] : nullptr;
        table.width[l] = l < num_levels ? level_widths[l] : 0;
        if (table.width[l] > widest) widest = table.width[l];
    }
    // Element counts, whatever the element size: 32-bit indexing only where
    // every output and cotangent index fits.
    if (!wide && n_queries * widest > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    return (int)(wide ? launch<G, T, long long>(coords, grad, table, num_levels, n_queries, radius, run, blocks,
                                                shared_bytes, s)
                      : launch<G, T, int>(coords, grad, table, num_levels, n_queries, radius, run, blocks,
                                          shared_bytes, s));
}

// The launch plan (queries per block, blocks, shared bytes, 64-bit
// indexing, elements per vector store) comes from ops/corr_cuda.py
// `scatter_plan`. grad_bf16: the cotangent is bf16 (else fp32); out_bf16:
// every level is bf16 (else fp32). Coordinates are fp32.
extern "C" int raft_corr_scatter(const void* coords, const void* grad, void* const* level_ptrs,
                                 const int* level_widths, int num_levels, long long n_queries, int radius,
                                 int run, long long blocks, int shared_bytes, int wide, int vec, int grad_bf16,
                                 int out_bf16, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0 || run < 1) return (int)cudaErrorInvalidValue;
    if (blocks != (n_queries + run - 1) / run || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const long long lk = (long long)num_levels * (2 * radius + 1);
    const long long need = 4LL * run * (lk + num_levels * (2LL * radius + 3) + 1);
    if (shared_bytes < need) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    using bf16 = __nv_bfloat16;
    if (grad_bf16)
        return out_bf16 ? dispatch<bf16, bf16>(coords, grad, level_ptrs, level_widths, num_levels, n_queries, radius,
                                               run, blocks, shared_bytes, wide, vec, s)
                        : dispatch<bf16, float>(coords, grad, level_ptrs, level_widths, num_levels, n_queries,
                                                radius, run, blocks, shared_bytes, wide, vec, s);
    return out_bf16 ? dispatch<float, bf16>(coords, grad, level_ptrs, level_widths, num_levels, n_queries, radius,
                                            run, blocks, shared_bytes, wide, vec, s)
                    : dispatch<float, float>(coords, grad, level_ptrs, level_widths, num_levels, n_queries, radius,
                                             run, blocks, shared_bytes, wide, vec, s);
}

extern "C" const char* raft_corr_scatter_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
