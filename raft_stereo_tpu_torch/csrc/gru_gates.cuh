// The ConvGRU gate formulas and the streaming loop shared by
// csrc/gru_tail.cu (the fused tail) and csrc/gates.cu (the gate pair), so
// that the two compute and stream alike and agree bit for bit.
//
// Rounding: expf and tanhf (not the __expf fast path), sigmoid written as
// 1 / (1 + exp(-x)) as PyTorch writes it, and both libraries are built with
// -fmad=false, so every product and sum is rounded where the plain PyTorch
// versions round them. bf16 operands are widened to fp32 exactly, the
// formulas run in fp32 unchanged, and the result is rounded once to bf16,
// the JAX kernels' contract (fp32 in registers, one store in the operand's
// dtype).

#pragma once

#include "dtype.cuh"

__device__ __forceinline__ float gru_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// rh = sigmoid(rx + cr) * h, the candidate conv's gated hidden state.
__device__ __forceinline__ float gru_rh(float rx, float cr, float h) {
    return gru_sigmoid(rx + cr) * h;
}

// h' = (1 - z) * h + z * tanh(qx + cq),  z = sigmoid(zx + cz).
__device__ __forceinline__ float gru_blend(float zx, float cz, float qx, float cq, float h) {
    const float z = gru_sigmoid(zx + cz);
    const float q = tanhf(qx + cq);
    return (1.0f - z) * h + z * q;
}

// The formulas as function objects, for gru_stream.
struct GruRh {
    __device__ __forceinline__ float operator()(float rx, float cr, float h) const {
        return gru_rh(rx, cr, h);
    }
};
struct GruBlend {
    __device__ __forceinline__ float operator()(float zx, float cz, float qx, float cq,
                                                float h) const {
        return gru_blend(zx, cz, qx, cq, h);
    }
};

// One 16-byte unit of an operand, widened to fp32.
template <int N>
struct Unit {
    float v[N];
};

template <int N, typename Op, typename... U>
__device__ __forceinline__ void gru_apply_unit(Op op, float* r, const U&... u) {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = op(u.v[k]...);
}

template <int N, typename T>
__device__ __forceinline__ Unit<N> gru_load_unit(const T* p) {
    Unit<N> u;
    load_vec<N>(p, u.v);
    return u;
}

// out[i] = op(in[i]...) for i < n, as a grid-stride loop over elements of T
// (fp32 or bf16): each operand is widened to fp32 on load, `op` computes in
// fp32, and the store rounds once to T (round to nearest even; the identity
// for fp32, whose instantiation computes exactly what the fp32-only loop
// did). With `vec` (every pointer 16-byte aligned; the wrapper checks)
// each thread takes 16 bytes of every operand per step, 4 fp32 or 8 bf16
// elements, then a scalar loop covers the remaining elements (fewer than
// one unit on the vector path, all of them otherwise). The kernels that
// call it take their pointers __restrict__; the grid is the wrapper's
// (ops/_build.py `stream_blocks`).
template <typename Op, typename T, typename... P>
__device__ __forceinline__ void gru_stream(Op op, T* out, long long n, int vec, const P*... in) {
    constexpr int N = kVec16<T>;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long nv = vec ? n / N : 0;
    for (long long i = first; i < nv; i += stride) {
        float r[N];
        gru_apply_unit<N>(op, r, gru_load_unit<N>(in + N * i)...);
        store_vec<N>(out + N * i, r);
    }
    for (long long i = N * nv + first; i < n; i += stride) {
        Elem<T>::store(out + i, op(Elem<T>::load(in + i)...));
    }
}
