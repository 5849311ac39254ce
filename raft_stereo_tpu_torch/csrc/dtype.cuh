// Element types of the kernels that take fp32 or bf16 tensors
// (csrc/corr_lookup.cu, corr_prefetch.cu, corr_pyramid.cu, encoder_conv.cu,
// encoder_join.cu, corr_scatter.cu, and through gru_gates.cuh gru_tail.cu
// and gates.cu).
//
// Arithmetic is fp32 in both: an element is widened to float on load, and
// `Elem<T>::round` rounds a float result to T's precision (round to nearest
// even) where the plain PyTorch version, which runs each op in T, rounds it.
// For float it is the identity, so the fp32 instantiations compute exactly
// what they computed before they were templated.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

template <typename T>
struct Elem;

template <>
struct Elem<float> {
    static __device__ __forceinline__ float load(const float* p) { return *p; }
    static __device__ __forceinline__ float round(float v) { return v; }
    static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elem<__nv_bfloat16> {
    static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
    static __device__ __forceinline__ float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// N consecutive elements as aligned vector accesses: fp32 runs of 2 or a
// multiple of 4 (8 or 16 bytes per access), bf16 runs of 4 or 8 (8 or 16
// bytes).
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
    if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        v[0] = x.x; v[1] = x.y;
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(p + i);
            v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
        }
    }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
    if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
        for (int i = 0; i < N; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
}

// bf16 pairs travel as 32-bit words, the lower address in the low half; a
// bf16 widens to the float whose upper 16 bits it is.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
           | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Four bf16 values (8 bytes) as two 32-bit words, eight (16 bytes) as four.
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
    static_assert(N == 4 || N == 8, "bf16 runs of 4 or 8");
    if constexpr (N == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
        v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
    } else {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
        v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
        v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
        v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
    }
}

// The values are rounded to bf16 (round to nearest even) as they are packed.
template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
    static_assert(N == 4 || N == 8, "bf16 runs of 4 or 8");
    if constexpr (N == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]));
    } else {
        *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]),
                                                  bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7]));
    }
}

// Elements of T in one 16-byte access: 4 fp32 or 8 bf16.
template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);
