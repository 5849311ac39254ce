// ConvGRU gate tail and motion-encoder tail for Hopper (sm_90a).
//
// Replaces the TPU kernels of raft_stereo_tpu/ops/gru_tail_pallas.py:
//   `_tail_kernel` (via `fused_gru_tail`):
//       h' = (1 - z) * h + z * tanh(qx + cq),   z = sigmoid(zx + cz)
//   `_motion_tail_kernel` (via `fused_motion_tail`), here in NCHW:
//       out[:, 0:126] = relu(pre), out[:, 126] = flow, out[:, 127] = 0
// Both take fp32 or bf16 tensors, all operands of one dtype, and store in
// it (the JAX kernels' output follows h and pre): math in fp32 after a
// widening load, one rounding at the store. relu, copy and zero are exact
// in bf16, so the motion tail is a typed copy.
//
// What bounds them on the H100: bytes. The tail reads five operands and
// writes one (24 bytes per element in fp32, 12 in bf16) for about a dozen
// flops; the motion tail reads 127 and writes 128 channels per pixel with
// no arithmetic beyond a max. Both are pure streaming passes.
//
// Design: grid-stride loops over the output, 16 bytes per thread and step
// (4 fp32 or 8 bf16 elements) where every pointer is 16-byte aligned and
// the count (for the motion tail, H*W) divides by the unit; a scalar loop
// otherwise. The wrappers (ops/gru_tail.py) pass the `vec` flag after
// checking both, and the grid (`stream_blocks`, from the card's
// multiprocessor count). In the motion tail a unit never straddles a
// channel because H*W is a multiple of it on the vector path. The tail's
// loop and formula are `gru_stream` and `gru_blend` of gru_gates.cuh, which
// the gate pair (csrc/gates.cu) shares.
//
// Rounding: built with -fmad=false, the blend is rounded as the plain
// PyTorch version rounds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_gates.cuh"

template <typename T>
__global__ void gru_tail_kernel(const T* __restrict__ zx, const T* __restrict__ cz,
                                const T* __restrict__ qx, const T* __restrict__ cq,
                                const T* __restrict__ h, T* __restrict__ out, long long n, int vec) {
    gru_stream(GruBlend(), out, n, vec, zx, cz, qx, cq, h);
}

// out (B, c_pre + 2, HW); pre (B, c_pre, HW); flow (B, 1, HW). Index unit is
// one element (vec = 0) or one 16-byte unit of N elements (vec = 1,
// HW % N == 0).
template <typename T, typename Index>
__global__ void motion_tail_kernel(const T* __restrict__ pre, const T* __restrict__ flow,
                                   T* __restrict__ out, Index batch, int c_pre, Index hw, int vec) {
    constexpr int N = kVec16<T>;
    const int width = vec ? N : 1;
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
            float v[N];
            if (c < c_pre) {
                load_vec<N>(pre + ((b * c_pre + c) * hw_u + p) * N, v);
#pragma unroll
                for (int k = 0; k < N; ++k) v[k] = fmaxf(v[k], 0.0f);
            } else if (c == c_pre) {
                load_vec<N>(flow + (b * hw_u + p) * N, v);
            } else {
#pragma unroll
                for (int k = 0; k < N; ++k) v[k] = 0.0f;
            }
            store_vec<N>(out + i * N, v);
        } else {
            float v;
            if (c < c_pre) v = fmaxf(Elem<T>::load(pre + (b * c_pre + c) * hw + p), 0.0f);
            else if (c == c_pre) v = Elem<T>::load(flow + b * hw + p);
            else v = 0.0f;
            Elem<T>::store(out + i, v);
        }
    }
}

template <typename T>
static int launch_tail(const void* zx, const void* cz, const void* qx, const void* cq, const void* h,
                       void* out, long long n, int vec, int blocks, void* stream) {
    gru_tail_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const T*)zx, (const T*)cz, (const T*)qx, (const T*)cq, (const T*)h, (T*)out, n, vec);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_motion(const void* pre, const void* flow, void* out, long long batch, int c_pre,
                         long long hw, int vec, int blocks, void* stream) {
    const long long elements = batch * (long long)(c_pre + 2) * hw;
    // 32-bit index arithmetic whenever the tensors fit it.
    if (elements <= 0x7fffffffLL - (long long)blocks * 256) {
        motion_tail_kernel<T, int><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const T*)pre, (const T*)flow, (T*)out, (int)batch, c_pre, (int)hw, vec);
    } else {
        motion_tail_kernel<T, long long><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const T*)pre, (const T*)flow, (T*)out, batch, c_pre, hw, vec);
    }
    return (int)cudaGetLastError();
}

// Every operand and the output fp32 (bf16 = 0) or bf16 (1); `blocks` of 256
// threads.
extern "C" int raft_gru_tail(const void* zx, const void* cz, const void* qx, const void* cq,
                             const void* h, void* out, long long n, int vec, int bf16, int blocks,
                             void* stream) {
    if (n == 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    if (bf16) return launch_tail<__nv_bfloat16>(zx, cz, qx, cq, h, out, n, vec, blocks, stream);
    return launch_tail<float>(zx, cz, qx, cq, h, out, n, vec, blocks, stream);
}

extern "C" int raft_motion_tail(const void* pre, const void* flow, void* out, long long batch,
                                int c_pre, long long hw, int vec, int bf16, int blocks, void* stream) {
    if (batch * (long long)(c_pre + 2) * hw == 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    if (bf16) return launch_motion<__nv_bfloat16>(pre, flow, out, batch, c_pre, hw, vec, blocks, stream);
    return launch_motion<float>(pre, flow, out, batch, c_pre, hw, vec, blocks, stream);
}

extern "C" const char* raft_gru_tail_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
