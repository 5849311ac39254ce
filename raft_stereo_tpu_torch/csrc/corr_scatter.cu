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
// of the tap cotangent (B, H, W1, L*(2r+1)), level-major. Out: the dense
// d(level l) (B, H, W1, W2_l), fp32, for every level, W2_l = W2 // 2**l.
//
// The shared fraction is the TPU backward's, not the per-tap fraction
// t - floor(t) of the forward: the two differ in the last bits where
// x + (k - r) rounds, so this is the JAX gradient, not bit for bit the
// vector-Jacobian product of the forward kernel.
//
// What bounds it on the H100: bytes. It writes the whole dense pyramid
// (sum_l W2_l floats per query) and reads 4 + 4*L*(2r+1) bytes per query;
// there is at most one multiply-add pair per output.
//
// Design: one thread per OUTPUT element (query, level, sample), all levels
// in one launch. Neighbouring threads write neighbouring samples of a row,
// so stores are fully coalesced; the threads of one row read the same
// coordinate and the same 2r+1 cotangents, which the L1 cache serves. Each
// query writes only its own rows, so there are no atomics and the result is
// the same on every run. The level of an output is found from the level
// offsets with static indices (a by-value table indexed at run time would be
// copied to local memory in every thread). The window test is done in float
// before any integer conversion, so coordinates far outside the row, infinite
// or NaN ones select no sample and cannot overflow an index.
//
// Rounding: x / 2**l is an exact IEEE division, floorf matches torch.floor,
// and the library is compiled with -fmad=false, so cw is rounded exactly as
// the plain PyTorch version (ops/corr_cuda.py plain_corr_scatter) rounds it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_LEVELS 8

struct LevelTable {
    float* ptr[MAX_LEVELS];
    int width[MAX_LEVELS];
    int offset[MAX_LEVELS];  // first sample of the level in a query's run; INT_MAX past the last level
};

template <typename Index>
__global__ void corr_scatter_kernel(const float* __restrict__ coords, const float* __restrict__ grad,
                                    LevelTable levels, int num_levels, int radius, int samples,
                                    Index total) {
    const int taps = 2 * radius + 1;
    for (Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x; i < total;
         i += (Index)gridDim.x * blockDim.x) {
        const Index q = i / samples;
        const int rem = (int)(i - q * samples);
        int l = 0;
        float* base = levels.ptr[0];
        int w2 = levels.width[0];
        int off = 0;
#pragma unroll
        for (int j = 1; j < MAX_LEVELS; ++j) {
            if (rem >= levels.offset[j]) {
                l = j;
                base = levels.ptr[j];
                w2 = levels.width[j];
                off = levels.offset[j];
            }
        }
        const int s = rem - off;
        const float x = coords[q] / (float)(1 << l);
        const float x0f = floorf(x);
        const float frac = x - x0f;
        // Window offset of sample s: m = s - (floor(x) - r), in float first.
        const float mf = (float)s - (x0f - (float)radius);
        float v = 0.0f;
        if (mf >= 0.0f && mf <= (float)taps) {
            const int m = (int)mf;
            const float* g = grad + (long long)q * num_levels * taps + l * taps;
            const float g_lo = m < taps ? g[m] : 0.0f;
            const float g_hi = m > 0 ? g[m - 1] : 0.0f;
            v = g_lo * (1.0f - frac) + g_hi * frac;
        }
        base[(long long)q * w2 + s] = v;
    }
}

extern "C" int raft_corr_scatter_f32(const void* coords, const void* grad, void* const* level_ptrs,
                                     const int* level_widths, int num_levels, long long n_queries,
                                     int radius, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    LevelTable table;
    int samples = 0;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        table.ptr[l] = l < num_levels ? (float*)level_ptrs[l] : nullptr;
        table.width[l] = l < num_levels ? level_widths[l] : 0;
        table.offset[l] = l < num_levels ? samples : INT_MAX;
        if (l < num_levels) samples += level_widths[l];
    }
    const long long total = n_queries * samples;
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
    if (total <= 0x7fffffffLL - (long long)blocks * threads) {
        corr_scatter_kernel<int><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)coords, (const float*)grad, table, num_levels, radius, samples, (int)total);
    } else {
        corr_scatter_kernel<long long><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)coords, (const float*)grad, table, num_levels, radius, samples, total);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* raft_corr_scatter_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
