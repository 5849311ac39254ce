// Residual join of the fused encoder's layer1 blocks for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/encoder_pallas.py `_join_kernel`
// (launched by `fused_join_s2d`). Same function, in NCHW:
//     out = relu(skip' + relu(n(y)))
// where n is the block's pending norm over per-(batch, channel) rows
// a = aff[b, 0, c], b = aff[b, 1, c]:
//     form 1 "in": (v - a) * b      (instance norm from [mean, inv])
//     form 2 "bn":  v * a + b       (frozen batch norm from [inv, shift])
// and skip' = skip (form 0), or relu(n_skip(skip)) when the skip is the raw
// stem output whose norm is still pending (layer1_0). The tensors are fp32
// or bf16 (the operand dtype, bf16 under mixed precision); the affine rows
// come as fp32 already rounded to that dtype (the wrapper casts them, as
// the JAX kernel casts them at use).
//
// What bounds it on the H100: bytes. It reads two tensors and writes one
// (12 bytes per element in fp32, 6 in bf16) for a handful of flops: at the
// 512x768 bucket (64 x 393,216 per image) that is 302 MB in fp32, 0.090 ms
// at 3.35 TB/s, and half that in bf16.
//
// Design: a grid-stride loop over the output, four elements per thread with
// vector loads and stores (16 bytes in fp32, 8 in bf16) where every pointer
// is 16-byte aligned and H*W divides by four (then a 4-wide group never straddles a channel plane), a
// scalar loop otherwise; the wrapper (ops/encoder_cuda.py) passes the `vec`
// flag after checking both, and the grid (`join_blocks`: one unit per
// thread up to 32 blocks of 256 per multiprocessor of the card, read from
// the device). Each group reads its channel's two affine rows,
// which stay in L1.
//
// Rounding: built with -fmad=false and written with explicit _rn
// intrinsics, each result rounded to the tensors' dtype (dtype.cuh), so
// each product and sum is rounded where the plain PyTorch version rounds
// it: the kernel agrees with it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

#define FORM_NONE 0
#define FORM_IN 1
#define FORM_BN 2

template <typename T>
__device__ __forceinline__ float norm_relu(float v, float a, float b, int form) {
    using E = Elem<T>;
    const float t = form == FORM_IN ? E::round(__fmul_rn(E::round(__fsub_rn(v, a)), b))
                                    : E::round(__fadd_rn(E::round(__fmul_rn(v, a)), b));
    return fmaxf(t, 0.0f);
}

template <typename T>
__device__ __forceinline__ float join_one(float s, float v, float ya, float yb, int y_form,
                                          float sa, float sb, int skip_form) {
    if (skip_form != FORM_NONE) s = norm_relu<T>(s, sa, sb, skip_form);
    return fmaxf(Elem<T>::round(__fadd_rn(s, norm_relu<T>(v, ya, yb, y_form))), 0.0f);
}

// Index unit: one element (vec = 0) or one 4-element group (vec = 1).
template <typename T, typename Index>
__global__ void join_kernel(const T* __restrict__ skip, const T* __restrict__ y,
                            const float* __restrict__ aff_y, const float* __restrict__ aff_s,
                            T* __restrict__ out, Index units, Index hw_units, int channels,
                            int y_form, int skip_form, int vec) {
    for (Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x; i < units;
         i += (Index)gridDim.x * blockDim.x) {
        const Index plane = i / hw_units;  // b * C + c
        const Index b = plane / channels;
        const int c = (int)(plane - b * channels);
        const Index row = b * 2 * channels + c;  // aff[b, 0, c]; aff[b, 1, c] is `channels` further
        const float ya = aff_y[row], yb = aff_y[row + channels];
        float sa = 0.0f, sb = 0.0f;
        if (skip_form != FORM_NONE) {
            sa = aff_s[row];
            sb = aff_s[row + channels];
        }
        if (vec) {
            float s4[4], v4[4], r[4];
            load_vec<4>(skip + 4 * i, s4);
            load_vec<4>(y + 4 * i, v4);
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] = join_one<T>(s4[j], v4[j], ya, yb, y_form, sa, sb, skip_form);
            store_vec<4>(out + 4 * i, r);
        } else {
            Elem<T>::store(out + i, join_one<T>(Elem<T>::load(skip + i), Elem<T>::load(y + i), ya, yb, y_form,
                                                sa, sb, skip_form));
        }
    }
}

template <typename T>
static int launch(const void* skip, const void* y, const void* aff_y, const void* aff_skip, void* out,
                  long long batch, int channels, long long hw, int y_form, int skip_form, int vec, int blocks,
                  void* stream) {
    if (y_form != FORM_IN && y_form != FORM_BN) return (int)cudaErrorInvalidValue;
    if (skip_form < FORM_NONE || skip_form > FORM_BN) return (int)cudaErrorInvalidValue;
    if (skip_form != FORM_NONE && aff_skip == nullptr) return (int)cudaErrorInvalidValue;
    if (vec && hw % 4 != 0) return (int)cudaErrorInvalidValue;
    const long long hw_units = vec ? hw / 4 : hw;
    const long long units = batch * channels * hw_units;
    if (units == 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    // 32-bit index arithmetic whenever the tensors fit it.
    if (units * (vec ? 4 : 1) <= 0x7fffffffLL - (long long)blocks * threads) {
        join_kernel<T, int><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const T*)skip, (const T*)y, (const float*)aff_y, (const float*)aff_skip,
            (T*)out, (int)units, (int)hw_units, channels, y_form, skip_form, vec);
    } else {
        join_kernel<T, long long><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const T*)skip, (const T*)y, (const float*)aff_y, (const float*)aff_skip,
            (T*)out, units, hw_units, channels, y_form, skip_form, vec);
    }
    return (int)cudaGetLastError();
}

// skip, y and out are fp32 (bf16 = 0) or bf16 (bf16 = 1); the affine rows
// (B, 2, C) are fp32 in either case; `blocks` of 256 threads.
extern "C" int raft_encoder_join(const void* skip, const void* y, const void* aff_y, const void* aff_skip,
                                 void* out, long long batch, int channels, long long hw, int y_form,
                                 int skip_form, int vec, int bf16, int blocks, void* stream) {
    if (bf16)
        return launch<__nv_bfloat16>(skip, y, aff_y, aff_skip, out, batch, channels, hw, y_form, skip_form, vec,
                                     blocks, stream);
    return launch<float>(skip, y, aff_y, aff_skip, out, batch, channels, hw, y_form, skip_form, vec, blocks,
                         stream);
}

extern "C" const char* raft_encoder_join_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
