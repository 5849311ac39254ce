// Windowed all-level correlation-pyramid lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py
// `_pf_lookup_kernel` (launched by `_lookup_pallas_prefetch_windowed`,
// planned by `_pf_plan`, entered through `prefetch_corr_lookup_padded`).
// Same function as the dense lookup (csrc/corr_lookup.cu) and bit for bit
// its result: for every query q = (b, h, w1) and level l, with
// x = coords[q] / 2**l, the 2r+1 taps t = x - r .. x + r are each the linear
// interpolation between samples floor(t) and floor(t)+1 of the query's own
// row of level l; a sample outside [0, W2_l) is zero. Out
// (B, H, W1, L*(2r+1)), level-major. The levels are fp32 or bf16 and the
// taps fp32 or bf16, in the four pairs the dense kernel takes: a sample is
// widened to fp32 as it is staged, the interpolation is fp32, and a tap is
// rounded once to its dtype (round to nearest even), as the dense kernel
// does.
//
// What bounds it on the H100: bytes. Per query and level the taps need the
// 2r+2 samples around x (40 bytes at r = 4 in fp32, 20 in bf16) and write
// 2r+1 outputs (36 or 18 bytes), with one multiply-add pair per output.
//
// Design. The TPU kernel shares one window of 128-lane tiles across a block
// of up to 256 queries, because a Pallas BlockSpec DMAs a (queries, 128) tile
// of every query's row; it needs a plan of window starts, a predicate that
// every tap fits, and the dense kernel as a fallback. None of that is carried
// over: on the card every query owns its own contiguous row of each level,
// so the window is per query. A block takes a run of consecutive queries and
// loads their coordinates itself (the TPU's scalar prefetch becomes "a block
// loads its own indices"). For every query and level it stages the window
// [floor(x) - r, floor(x) + r + 2] into shared memory: neighbouring threads
// load neighbouring samples of one row, every sample once, each bounds test
// done in float before any integer conversion as in corr_lookup.cu (far-out,
// infinite and NaN coordinates read nothing). The window holds 2r+3 samples,
// one more than the 2r+2 the taps of floor(x) touch: a tap's t = x + (k - r)
// is rounded, and fl(x + n) can reach floor(x) + n + 1 when x lies within
// half an ulp below an integer, so floor(t) is floor(x) + n or one more (the
// rounding is monotone and floor(x) + n is representable). With that sample
// every tap lands inside its window by construction, so the kernel is exact
// on every input: no plan, no predicate, no fallback. The window is staged
// as fp32 whatever the levels' dtype (a bf16 sample widens exactly), so the
// shared-memory plan per query is the same for both. Then the block forms
// each tap exactly as corr_lookup.cu does (the same t, floor, fraction and
// bounds tests; only the load comes from shared memory) and writes its
// (queries, L*(2r+1)) output, one contiguous span, coalesced.
//
// Rounding: x / 2**l is an exact IEEE division, floorf matches torch.floor,
// and the library is compiled with -fmad=false, so tap0*(1-f) + tap1*f is
// rounded exactly as the dense kernel and the plain PyTorch version round it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

#define MAX_LEVELS 8
#define BLOCK_QUERIES 64
#define THREADS 256
#define MAX_SHARED_BYTES (48 * 1024)

template <typename TL>
struct LevelTable {
    const TL* ptr[MAX_LEVELS];
    int width[MAX_LEVELS];
};

// Select level l's row pointer base and width with static indices: indexing
// the by-value table with the runtime `l` would copy it to local memory in
// every thread.
template <typename TL>
__device__ __forceinline__ void select_level(const LevelTable<TL>& levels, int l, const TL*& base,
                                             int& w2) {
    base = levels.ptr[0];
    w2 = levels.width[0];
#pragma unroll
    for (int j = 1; j < MAX_LEVELS; ++j) {
        if (j == l) {
            base = levels.ptr[j];
            w2 = levels.width[j];
        }
    }
}

template <typename TL, typename TO>
__global__ void corr_prefetch_kernel(const float* __restrict__ coords, LevelTable<TL> levels,
                                     int num_levels, int radius, int block_queries,
                                     long long n_queries, TO* __restrict__ out) {
    extern __shared__ float smem[];
    const int span = 2 * radius + 3;  // staged samples per (query, level)
    const int taps = 2 * radius + 1;
    float* xs = smem;                         // [block_queries]
    float* win = smem + block_queries;        // [block_queries][num_levels][span]
    const long long q0 = (long long)blockIdx.x * block_queries;
    const int nq = (int)(n_queries - q0 < block_queries ? n_queries - q0 : block_queries);

    for (int i = threadIdx.x; i < nq; i += blockDim.x) xs[i] = coords[q0 + i];
    __syncthreads();

    const int per_query_win = num_levels * span;
    for (int i = threadIdx.x; i < nq * per_query_win; i += blockDim.x) {
        const int ql = i / per_query_win;
        const int rem = i - ql * per_query_win;
        const int l = rem / span;
        const int m = rem - l * span;
        const TL* base;
        int w2;
        select_level(levels, l, base, w2);
        const float x = xs[ql] / (float)(1 << l);
        const float idx = floorf(x) - (float)radius + (float)m;
        float v = 0.0f;
        if (idx >= 0.0f && idx <= (float)(w2 - 1)) v = Elem<TL>::load(base + (q0 + ql) * w2 + (int)idx);
        win[i] = v;
    }
    __syncthreads();

    const int per_query_out = num_levels * taps;
    TO* dst = out + q0 * per_query_out;
    for (int i = threadIdx.x; i < nq * per_query_out; i += blockDim.x) {
        const int ql = i / per_query_out;
        const int rem = i - ql * per_query_out;
        const int l = rem / taps;
        const int k = rem - l * taps;
        const TL* unused;
        int w2;
        select_level(levels, l, unused, w2);
        const float x = xs[ql] / (float)(1 << l);
        const float t = x + (float)(k - radius);
        const float x0f = floorf(t);
        const float frac = t - x0f;
        // Window entry of sample x0f: in {k, k + 1} whenever x0f is in the
        // row (see the note at the top), so both reads stay in the window.
        const float* w = win + (ql * num_levels + l) * span;
        const float start = floorf(x) - (float)radius;
        float v0 = 0.0f, v1 = 0.0f;
        if (x0f >= 0.0f && x0f <= (float)(w2 - 1)) v0 = w[(int)(x0f - start)];
        if (x0f + 1.0f >= 0.0f && x0f + 1.0f <= (float)(w2 - 1)) v1 = w[(int)(x0f - start) + 1];
        Elem<TO>::store(dst + i, v0 * (1.0f - frac) + v1 * frac);
    }
}

template <typename TL, typename TO>
static int launch(const void* coords, const void* const* level_ptrs, const int* level_widths, int num_levels,
                  long long n_queries, int radius, void* out, void* stream) {
    LevelTable<TL> table;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        table.ptr[l] = l < num_levels ? (const TL*)level_ptrs[l] : nullptr;
        table.width[l] = l < num_levels ? level_widths[l] : 0;
    }
    if (n_queries == 0) return 0;
    // Shared memory per query: its coordinate and its windows, all fp32.
    // Fewer queries per block where a large radius or many levels would
    // pass 48 KB.
    const long long per_query = 4LL * (1 + (long long)num_levels * (2 * radius + 3));
    long long bq = MAX_SHARED_BYTES / per_query;
    if (bq < 1) return (int)cudaErrorInvalidValue;
    if (bq > BLOCK_QUERIES) bq = BLOCK_QUERIES;
    const long long blocks = (n_queries + bq - 1) / bq;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    corr_prefetch_kernel<TL, TO><<<(unsigned)blocks, THREADS, (size_t)(bq * per_query), (cudaStream_t)stream>>>(
        (const float*)coords, table, num_levels, radius, (int)bq, n_queries, (TO*)out);
    return (int)cudaGetLastError();
}

// coords fp32; the levels fp32 (level_bf16 = 0) or bf16 (1); the taps fp32
// (out_bf16 = 0) or bf16 (1): the dense kernel's signature
// (csrc/corr_lookup.cu `raft_corr_lookup`).
extern "C" int raft_corr_prefetch(const void* coords, const void* const* level_ptrs, const int* level_widths,
                                  int num_levels, long long n_queries, int radius, void* out, int level_bf16,
                                  int out_bf16, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0) return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    if (level_bf16 && out_bf16)
        return launch<bf16, bf16>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    if (level_bf16)
        return launch<bf16, float>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    if (out_bf16)
        return launch<float, bf16>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    return launch<float, float>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
}

extern "C" const char* raft_corr_prefetch_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
