// ConvGRU gate pair for Hopper (sm_90a).
//
// Replaces the TPU kernels of raft_stereo_tpu/ops/gates_pallas.py (both
// launched by `_run_elementwise`):
//   `_rh_kernel` (via `fused_rh`):           rh = sigmoid(rx + cr) * h
//   `_combine_kernel` (via `fused_combine`): h' = (1 - z) * h + z * tanh(qx + cq),
//                                            z = sigmoid(zx + cz)
// Elementwise over tensors of one shape and one dtype, fp32 or bf16 (the
// port's NCHW hidden states and conv outputs; the TPU kernels take NHWC
// rows, which changes nothing for an elementwise pass). The output follows
// the operands' dtype (the JAX kernels': the first operand's): math in fp32
// after a widening load, one rounding at the store.
//
// What bounds them on the H100: bytes. rh reads three operands and writes
// one (16 bytes per element in fp32, 8 in bf16), combine reads five and
// writes one (24 or 12 bytes), each for about a dozen operations: pure
// streaming passes.
//
// Design: the TPU kernels tile (N, C) rows into 1024-row VMEM blocks; here a
// grid-stride loop streams the flat tensors, 16 bytes per thread and step
// (4 fp32 or 8 bf16 elements) when every pointer is 16-byte aligned (the
// wrapper, ops/gates.py, passes that as `vec`), then a scalar loop over the
// remaining elements (fewer than one unit on the vector path, all of them
// otherwise). The loop and the formulas are gru_gates.cuh's and the grid is
// ops/_build.py `stream_blocks`, which the fused GRU tail
// (csrc/gru_tail.cu) shares, so combine and the tail agree bit for bit;
// combine keeps its own entry point and launch all the same.
//
// Rounding: built with -fmad=false, as the plain PyTorch versions round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_gates.cuh"

template <typename T>
__global__ void gates_rh_kernel(const T* __restrict__ rx, const T* __restrict__ cr,
                                const T* __restrict__ h, T* __restrict__ out, long long n, int vec) {
    gru_stream(GruRh(), out, n, vec, rx, cr, h);
}

template <typename T>
__global__ void gates_combine_kernel(const T* __restrict__ zx, const T* __restrict__ cz,
                                     const T* __restrict__ qx, const T* __restrict__ cq,
                                     const T* __restrict__ h, T* __restrict__ out, long long n, int vec) {
    gru_stream(GruBlend(), out, n, vec, zx, cz, qx, cq, h);
}

// Every operand and the output fp32 (bf16 = 0) or bf16 (1); `blocks` of 256
// threads.
extern "C" int raft_gates_rh(const void* rx, const void* cr, const void* h, void* out, long long n,
                             int vec, int bf16, int blocks, void* stream) {
    if (n == 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    if (bf16) {
        gates_rh_kernel<bf><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const bf*)rx, (const bf*)cr, (const bf*)h, (bf*)out, n, vec);
    } else {
        gates_rh_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const float*)rx, (const float*)cr, (const float*)h, (float*)out, n, vec);
    }
    return (int)cudaGetLastError();
}

extern "C" int raft_gates_combine(const void* zx, const void* cz, const void* qx, const void* cq,
                                  const void* h, void* out, long long n, int vec, int bf16, int blocks,
                                  void* stream) {
    if (n == 0) return 0;
    if (blocks < 1) return (int)cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    if (bf16) {
        gates_combine_kernel<bf><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const bf*)zx, (const bf*)cz, (const bf*)qx, (const bf*)cq, (const bf*)h, (bf*)out, n, vec);
    } else {
        gates_combine_kernel<float><<<blocks, 256, 0, (cudaStream_t)stream>>>(
            (const float*)zx, (const float*)cz, (const float*)qx, (const float*)cq, (const float*)h,
            (float*)out, n, vec);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* raft_gates_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
