// ConvGRU gate tail and motion-encoder tail for Hopper (sm_90a).
//
// Replaces the TPU kernels of raft_stereo_tpu/ops/gru_tail_pallas.py:
//   `_tail_kernel` (via `fused_gru_tail`):
//       h' = (1 - z) * h + z * tanh(qx + cq),   z = sigmoid(zx + cz)
//   `_motion_tail_kernel` (via `fused_motion_tail`), here in NCHW:
//       out[:, 0:126] = relu(pre), out[:, 126] = flow, out[:, 127] = 0
//
// What bounds them on the H100: bytes. The tail reads five fp32 operands and
// writes one (24 bytes per element) for about a dozen flops; the motion tail
// reads 127 and writes 128 channels per pixel with no arithmetic beyond a
// max. Both are pure streaming passes.
//
// Design: grid-stride loops over the output, four elements per thread with
// 16-byte loads and stores where every pointer is 16-byte aligned and the
// count (for the motion tail, H*W) divides by four; a scalar loop otherwise.
// The wrappers (ops/gru_tail.py) pass the `vec` flag after checking both.
// In the motion tail a 4-wide group never straddles a channel because H*W
// is a multiple of four on the vector path. The tail's loop and formula are
// `gru_stream` and `gru_blend` of gru_gates.cuh, which the gate pair
// (csrc/gates.cu) shares.
//
// Rounding: built with -fmad=false, the blend is rounded as the plain
// PyTorch version rounds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_gates.cuh"

__global__ void gru_tail_kernel(const float* __restrict__ zx, const float* __restrict__ cz,
                                const float* __restrict__ qx, const float* __restrict__ cq,
                                const float* __restrict__ h, float* __restrict__ out,
                                long long n, int vec) {
    gru_stream(GruBlend(), out, n, vec, zx, cz, qx, cq, h);
}

// out (B, c_pre + 2, HW); pre (B, c_pre, HW); flow (B, 1, HW). Index unit is
// one element (vec = 0) or one 4-element group (vec = 1, HW % 4 == 0).
template <typename Index>
__global__ void motion_tail_kernel(const float* __restrict__ pre, const float* __restrict__ flow,
                                   float* __restrict__ out, Index batch, int c_pre,
                                   Index hw, int vec) {
    const int width = vec ? 4 : 1;
    const Index hw_u = hw / width;
    const Index per_b = (Index)(c_pre + 2) * hw_u;
    const Index n = batch * per_b;
    for (Index i = blockIdx.x * (Index)blockDim.x + threadIdx.x; i < n;
         i += (Index)gridDim.x * blockDim.x) {
        const Index b = i / per_b;
        const Index rem = i - b * per_b;
        const int c = (int)(rem / hw_u);
        const Index p = rem - (Index)c * hw_u;
        if (vec) {
            float4 v;
            if (c < c_pre) {
                v = reinterpret_cast<const float4*>(pre)[(b * c_pre + c) * hw_u + p];
                v.x = fmaxf(v.x, 0.0f); v.y = fmaxf(v.y, 0.0f);
                v.z = fmaxf(v.z, 0.0f); v.w = fmaxf(v.w, 0.0f);
            } else if (c == c_pre) {
                v = reinterpret_cast<const float4*>(flow)[b * hw_u + p];
            } else {
                v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
            reinterpret_cast<float4*>(out)[i] = v;
        } else {
            float v;
            if (c < c_pre) v = fmaxf(pre[(b * c_pre + c) * hw + p], 0.0f);
            else if (c == c_pre) v = flow[b * hw + p];
            else v = 0.0f;
            out[i] = v;
        }
    }
}

extern "C" int raft_gru_tail_f32(const void* zx, const void* cz, const void* qx,
                                 const void* cq, const void* h, void* out, long long n,
                                 int vec, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    gru_tail_kernel<<<gru_stream_blocks(n, vec, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)zx, (const float*)cz, (const float*)qx, (const float*)cq, (const float*)h,
        (float*)out, n, vec);
    return (int)cudaGetLastError();
}

extern "C" int raft_motion_tail_f32(const void* pre, const void* flow, void* out,
                                    long long batch, int c_pre, long long hw, int vec,
                                    void* stream) {
    const long long n = batch * (long long)(c_pre + 2) * (vec ? hw / 4 : hw);
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned blocks = gru_stream_blocks(n, 0, threads);
    const long long elements = batch * (long long)(c_pre + 2) * hw;
    // 32-bit index arithmetic whenever the tensors fit it.
    if (elements <= 0x7fffffffLL - (long long)blocks * threads) {
        motion_tail_kernel<int><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)pre, (const float*)flow, (float*)out, (int)batch, c_pre, (int)hw, vec);
    } else {
        motion_tail_kernel<long long><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)pre, (const float*)flow, (float*)out, batch, c_pre, hw, vec);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* raft_gru_tail_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
