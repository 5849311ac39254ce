// The ConvGRU gate formulas and the streaming loop shared by
// csrc/gru_tail.cu (the fused tail) and csrc/gates.cu (the gate pair), so
// that the two compute and stream alike and agree bit for bit.
//
// Rounding: expf and tanhf (not the __expf fast path), sigmoid written as
// 1 / (1 + exp(-x)) as PyTorch writes it, and both libraries are built with
// -fmad=false, so every product and sum is rounded where the plain PyTorch
// versions round them.

#pragma once

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

template <typename Op, typename... V>
__device__ __forceinline__ float4 gru_apply4(Op op, V... v) {
    float4 r;
    r.x = op(v.x...);
    r.y = op(v.y...);
    r.z = op(v.z...);
    r.w = op(v.w...);
    return r;
}

// out[i] = op(in[i]...) for i < n, as a grid-stride loop: four elements per
// thread with 16-byte loads and stores when `vec` (every pointer 16-byte
// aligned; the wrapper checks), then a scalar loop over the remaining
// elements (fewer than four on the vector path, all of them otherwise).
// The kernels that call it take their pointers __restrict__.
template <typename Op, typename... P>
__device__ __forceinline__ void gru_stream(Op op, float* out, long long n, int vec,
                                           const P*... in) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long n4 = vec ? n / 4 : 0;
    for (long long i = first; i < n4; i += stride) {
        reinterpret_cast<float4*>(out)[i] = gru_apply4(op, reinterpret_cast<const float4*>(in)[i]...);
    }
    for (long long i = 4 * n4 + first; i < n; i += stride) out[i] = op(in[i]...);
}

// Blocks of a grid-stride pass over n elements (four per thread when
// `vec`): one thread per unit of work, at most 32 blocks per SM of the
// H100's 132; the loop strides over the rest.
static inline unsigned gru_stream_blocks(long long n, int vec, int threads) {
    const long long units = vec ? (n + 3) / 4 : n;
    long long blocks = (units + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;
    return (unsigned)(blocks < 1 ? 1 : blocks);
}
