// ConvGRU gate pair for Hopper (sm_90a).
//
// Replaces the TPU kernels of raft_stereo_tpu/ops/gates_pallas.py (both
// launched by `_run_elementwise`):
//   `_rh_kernel` (via `fused_rh`):           rh = sigmoid(rx + cr) * h
//   `_combine_kernel` (via `fused_combine`): h' = (1 - z) * h + z * tanh(qx + cq),
//                                            z = sigmoid(zx + cz)
// Elementwise over tensors of one shape (the port's NCHW hidden states and
// conv outputs; the TPU kernels take NHWC rows, which changes nothing for
// an elementwise pass).
//
// What bounds them on the H100: bytes. rh reads three fp32 operands and
// writes one (16 bytes per element), combine reads five and writes one (24
// bytes), each for about a dozen operations: pure streaming passes.
//
// Design: the TPU kernels tile (N, C) rows into 1024-row VMEM blocks; here a
// grid-stride loop streams the flat tensors, four elements per thread with
// 16-byte loads and stores when every pointer is 16-byte aligned (the
// wrapper, ops/gates.py, passes that as `vec`), then a scalar loop over the
// remaining elements (fewer than four on the vector path, all of them
// otherwise). The loop, its grid and the formulas are gru_gates.cuh's, which
// the fused GRU tail (csrc/gru_tail.cu) shares, so combine and the tail
// agree bit for bit; combine keeps its own entry point and launch all the
// same.
//
// Rounding: built with -fmad=false, as the plain PyTorch versions round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_gates.cuh"

__global__ void gates_rh_kernel(const float* __restrict__ rx, const float* __restrict__ cr,
                                const float* __restrict__ h, float* __restrict__ out,
                                long long n, int vec) {
    gru_stream(GruRh(), out, n, vec, rx, cr, h);
}

__global__ void gates_combine_kernel(const float* __restrict__ zx, const float* __restrict__ cz,
                                     const float* __restrict__ qx, const float* __restrict__ cq,
                                     const float* __restrict__ h, float* __restrict__ out,
                                     long long n, int vec) {
    gru_stream(GruBlend(), out, n, vec, zx, cz, qx, cq, h);
}

extern "C" int raft_gates_rh_f32(const void* rx, const void* cr, const void* h, void* out,
                                 long long n, int vec, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    gates_rh_kernel<<<gru_stream_blocks(n, vec, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)rx, (const float*)cr, (const float*)h, (float*)out, n, vec);
    return (int)cudaGetLastError();
}

extern "C" int raft_gates_combine_f32(const void* zx, const void* cz, const void* qx,
                                      const void* cq, const void* h, void* out, long long n,
                                      int vec, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    gates_combine_kernel<<<gru_stream_blocks(n, vec, threads), threads, 0, (cudaStream_t)stream>>>(
        (const float*)zx, (const float*)cz, (const float*)qx, (const float*)cq, (const float*)h,
        (float*)out, n, vec);
    return (int)cudaGetLastError();
}

extern "C" const char* raft_gates_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
