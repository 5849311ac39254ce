// Fused all-level correlation-pyramid lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py `_lookup_kernel`
// (launched by `_lookup_pallas_padded`, the forward of
// `pallas_corr_lookup_padded`). Same function: for every query q = (b, h, w1)
// and level l, with x = coords[q] / 2**l, the 2r+1 taps t = x - r .. x + r
// are each the linear interpolation between samples floor(t) and floor(t)+1
// of the query's own row of level l. A sample outside [0, W2_l) is zero,
// where W2_l = W2 // 2**l is the level's true width. Out (B, H, W1, L*(2r+1)),
// level-major. The levels are fp32 or bf16 (`corr_dtype`) and the taps fp32
// or bf16 (the compute dtype), in any of the four pairs, as the JAX kernel
// takes them: samples are widened to fp32, the interpolation is fp32, and
// a tap is rounded once to the output dtype (round to nearest even).
//
// What bounds it on the H100: bytes. Per query and level the taps read at
// most 2r+2 contiguous samples (40 bytes at r = 4 in fp32, 20 in bf16) and
// write 2r+1 outputs (36 or 18 bytes); there is one multiply-add per
// output, so the kernel sits far below the card's operations-per-byte
// balance point.
//
// Design: one thread per OUTPUT element (query, level, tap). Neighbouring
// threads write neighbouring outputs, so stores are fully coalesced, and the
// 2r+1 threads of one (query, level) read neighbouring samples of one row,
// so loads of a window share sectors. All L levels run in the one launch
// (the TPU kernel fuses them too): the level pointers and widths travel in a
// by-value table, selected with static indices. The pyramid is the unpadded
// (B, H, W1, W2_l) levels; the 128-lane padding the TPU kernel needed for its zero rule is replaced by an
// explicit bounds test, done in float before any integer conversion so that
// coordinates far outside the row can neither read out of bounds nor
// overflow the index.
//
// Rounding: x / 2**l is an exact IEEE division, floorf matches torch.floor,
// and the library is compiled with -fmad=false, so tap0*(1-f) + tap1*f is
// rounded exactly as the plain PyTorch version rounds it (and then once to
// the output dtype, as the plain version's cast does).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

#define MAX_LEVELS 8

template <typename TL>
struct LevelTable {
    const TL* ptr[MAX_LEVELS];
    int width[MAX_LEVELS];
};

template <typename TL, typename TO, typename Index>
__global__ void corr_lookup_kernel(const float* __restrict__ coords, LevelTable<TL> levels,
                                   int num_levels, int radius, Index total,
                                   TO* __restrict__ out) {
    const int taps = 2 * radius + 1;
    const int per_query = num_levels * taps;
    for (Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x; i < total;
         i += (Index)gridDim.x * blockDim.x) {
        const Index q = i / per_query;
        const int rem = (int)(i - q * per_query);
        const int l = rem / taps;
        const int k = rem - l * taps;
        // Select the level with static indices: indexing the by-value table
        // with the runtime `l` would copy it to local memory in every thread.
        const TL* base = levels.ptr[0];
        int w2 = levels.width[0];
#pragma unroll
        for (int j = 1; j < MAX_LEVELS; ++j) {
            if (j == l) {
                base = levels.ptr[j];
                w2 = levels.width[j];
            }
        }
        const float x = coords[q] / (float)(1 << l);
        const float t = x + (float)(k - radius);
        const float x0f = floorf(t);
        const float frac = t - x0f;
        const TL* row = base + (long long)q * w2;
        float v0 = 0.0f, v1 = 0.0f;
        if (x0f >= 0.0f && x0f <= (float)(w2 - 1)) v0 = Elem<TL>::load(row + (int)x0f);
        if (x0f + 1.0f >= 0.0f && x0f + 1.0f <= (float)(w2 - 1)) v1 = Elem<TL>::load(row + (int)x0f + 1);
        Elem<TO>::store(out + i, v0 * (1.0f - frac) + v1 * frac);
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
    const long long total = n_queries * num_levels * (2 * radius + 1);
    if (total == 0) return 0;
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
    // 32-bit index arithmetic whenever the output fits it (the common case);
    // 64-bit division costs several times more per thread.
    if (total <= 0x7fffffffLL - (long long)blocks * threads) {
        corr_lookup_kernel<TL, TO, int><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)coords, table, num_levels, radius, (int)total, (TO*)out);
    } else {
        corr_lookup_kernel<TL, TO, long long><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)coords, table, num_levels, radius, total, (TO*)out);
    }
    return (int)cudaGetLastError();
}

// coords fp32; the levels fp32 (level_bf16 = 0) or bf16 (1); the taps fp32
// (out_bf16 = 0) or bf16 (1).
extern "C" int raft_corr_lookup(const void* coords, const void* const* level_ptrs, const int* level_widths,
                                int num_levels, long long n_queries, int radius, void* out, int level_bf16,
                                int out_bf16, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    if (level_bf16 && out_bf16)
        return launch<bf16, bf16>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    if (level_bf16)
        return launch<bf16, float>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    if (out_bf16)
        return launch<float, bf16>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
    return launch<float, float>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, stream);
}

extern "C" const char* raft_corr_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
