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
// Design of the tail: a grid-stride loop over the output, 16 bytes per
// thread and step (4 fp32 or 8 bf16 elements) where every pointer is
// 16-byte aligned and the count divides by the unit; a scalar loop
// otherwise. The wrapper (ops/gru_tail.py) passes the `vec` flag after
// checking both, and the grid (`stream_blocks`, from the card's
// multiprocessor count). Its loop and formula are `gru_stream` and
// `gru_blend` of gru_gates.cuh, which the gate pair (csrc/gates.cu) shares.
//
// Design of the motion tail: a grid over output planes, (tiles, C + 2, B),
// so that a block knows its plane from blockIdx without a division and
// every thread of it does one thing: a data plane loads pre, applies relu
// and stores, the flow plane copies, the zero plane only stores. Each
// thread moves up to 4 units (16 bytes each where H*W divides by the unit
// and the bases are 16-byte aligned, the wrapper's `vec`; one element
// otherwise), issuing all its loads before its stores, with streaming
// cache hints; the grid covers every unit once (ops/gru_tail.py
// `motion_tail_plan`, which also picks the units per thread so that a
// small plane still gives every multiprocessor two blocks).
// Measured alone on the device (kernel_compare.py, H100 80GB HBM3,
// 700.00 W, L2 flushed): 126 x 128 x 192 (the 512x768 bucket) 0.0092-0.0094
// ms in fp32 against its 0.0075 bound (80-82%), 0.0061-0.0062 in bf16
// against 0.0037 (60-61%); 126 x 48 x 156 (the realtime model's 1/8) in
// bf16 0.0035-0.0036 against 0.0011. What is left: each thread's loads and
// then its stores form one wave per launch, so reads and writes overlap
// only across blocks, and the launch's ramp is a share of so short a pass.
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

// The motion tail's 16-byte or element units as raw bits: relu widens
// them to fp32, takes fmaxf(v, 0) and rounds back (exact: relu of a bf16
// is a bf16), the flow plane copies them and the zero plane stores zero
// bits. Loads and stores carry streaming hints (ld.global.cs, st.global.cs):
// each byte is touched once.
template <typename T, int W>
struct MotionUnit;

template <>
struct MotionUnit<float, 4> {
    using Raw = uint4;
    static __device__ __forceinline__ Raw relu(Raw u) {
        return make_uint4(__float_as_uint(fmaxf(__uint_as_float(u.x), 0.0f)),
                          __float_as_uint(fmaxf(__uint_as_float(u.y), 0.0f)),
                          __float_as_uint(fmaxf(__uint_as_float(u.z), 0.0f)),
                          __float_as_uint(fmaxf(__uint_as_float(u.w), 0.0f)));
    }
};

template <>
struct MotionUnit<__nv_bfloat16, 8> {
    using Raw = uint4;
    static __device__ __forceinline__ uint32_t relu2(uint32_t w) {
        return bf16_pack(fmaxf(bf16_lo(w), 0.0f), fmaxf(bf16_hi(w), 0.0f));
    }
    static __device__ __forceinline__ Raw relu(Raw u) {
        return make_uint4(relu2(u.x), relu2(u.y), relu2(u.z), relu2(u.w));
    }
};

template <>
struct MotionUnit<float, 1> {
    using Raw = float;
    static __device__ __forceinline__ Raw relu(Raw v) { return fmaxf(v, 0.0f); }
};

template <>
struct MotionUnit<__nv_bfloat16, 1> {
    using Raw = unsigned short;
    static __device__ __forceinline__ Raw relu(Raw u) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(fmaxf(__uint_as_float((uint32_t)u << 16), 0.0f)));
    }
};

template <typename R>
__device__ __forceinline__ R zero_raw() {
    if constexpr (sizeof(R) == 16) return make_uint4(0u, 0u, 0u, 0u);
    else return R(0);
}

// out (B, c_pre + 2, HW) from pre (B, c_pre, HW) and flow (B, 1, HW), in
// units of W elements (W = 16 bytes' worth on the vector path, where
// HW % W == 0 and every base is 16-byte aligned; 1 otherwise): hw_units
// units per plane. Grid (tiles, c_pre + 2, B): blockIdx.z is the batch
// and blockIdx.y the output channel, so a block's plane and its source
// are uniform and no index is divided; blockIdx.x is a tile of
// MOTION_THREADS * U units of that plane, thread t taking units
// t, t + MOTION_THREADS, ... (U of them), all U loads issued before any
// store. The grid covers the work once (ops/gru_tail.py
// `motion_tail_plan`): no grid-stride loop.
#define MOTION_THREADS 256

template <typename T, int W, int U>
__global__ void __launch_bounds__(MOTION_THREADS)
motion_tail_kernel(const T* __restrict__ pre, const T* __restrict__ flow, T* __restrict__ out, int c_pre,
                   int hw_units) {
    using Unit = MotionUnit<T, W>;
    using Raw = typename Unit::Raw;
    const int c = blockIdx.y;
    const long long b = blockIdx.z;
    const int first = blockIdx.x * (MOTION_THREADS * U) + threadIdx.x;
    Raw* dst = reinterpret_cast<Raw*>(out) + (b * (c_pre + 2) + c) * hw_units;
    if (c > c_pre) {  // the zero plane: stores only
#pragma unroll
        for (int k = 0; k < U; ++k) {
            const int u = first + k * MOTION_THREADS;
            if (u < hw_units) __stcs(dst + u, zero_raw<Raw>());
        }
        return;
    }
    const Raw* src = reinterpret_cast<const Raw*>(c < c_pre ? pre + (b * c_pre + c) * ((long long)hw_units * W)
                                                            : flow + b * ((long long)hw_units * W));
    Raw v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
        const int u = first + k * MOTION_THREADS;
        if (u < hw_units) v[k] = __ldcs(src + u);
    }
    if (c < c_pre) {
#pragma unroll
        for (int k = 0; k < U; ++k) v[k] = Unit::relu(v[k]);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
        const int u = first + k * MOTION_THREADS;
        if (u < hw_units) __stcs(dst + u, v[k]);
    }
}

template <typename T>
static int launch_tail(const void* zx, const void* cz, const void* qx, const void* cq, const void* h,
                       void* out, long long n, int vec, int blocks, void* stream) {
    gru_tail_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const T*)zx, (const T*)cz, (const T*)qx, (const T*)cq, (const T*)h, (T*)out, n, vec);
    return (int)cudaGetLastError();
}

template <typename T, int W>
static int launch_motion(const void* pre, const void* flow, void* out, int batch, int c_pre, int hw_units,
                         int per_thread, long long tiles, void* stream) {
    const dim3 grid((unsigned)tiles, (unsigned)(c_pre + 2), (unsigned)batch);
#define RAFT_MOTION_LAUNCH(U)                                                                          \
    motion_tail_kernel<T, W, U><<<grid, MOTION_THREADS, 0, (cudaStream_t)stream>>>((const T*)pre,       \
                                                                                  (const T*)flow,      \
                                                                                  (T*)out, c_pre, hw_units)
    if (per_thread == 4) RAFT_MOTION_LAUNCH(4);
    else if (per_thread == 2) RAFT_MOTION_LAUNCH(2);
    else RAFT_MOTION_LAUNCH(1);
#undef RAFT_MOTION_LAUNCH
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

// The motion tail: pre (B, c_pre, HW), flow (B, 1, HW), out (B, c_pre + 2,
// HW), all fp32 (bf16 = 0) or bf16 (1); the plan (ops/gru_tail.py
// `motion_tail_plan`): vec (16-byte units), units per thread (1, 2 or 4)
// and tiles per plane, checked against the shape and refused if it does
// not cover every unit exactly once.
extern "C" int raft_motion_tail(const void* pre, const void* flow, void* out, long long batch, int c_pre,
                                long long hw, int vec, int bf16, int per_thread, long long tiles, void* stream) {
    if (batch * (long long)(c_pre + 2) * hw == 0) return 0;
    const int width = vec ? (bf16 ? 8 : 4) : 1;
    if (batch > 65535 || c_pre < 0 || c_pre + 2 > 65535 || hw % width != 0 || hw / width > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (per_thread != 1 && per_thread != 2 && per_thread != 4) return (int)cudaErrorInvalidValue;
    const long long hw_units = hw / width;
    const long long per_tile = (long long)MOTION_THREADS * per_thread;
    if (tiles != (hw_units + per_tile - 1) / per_tile || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (bf16) {
        return vec ? launch_motion<__nv_bfloat16, 8>(pre, flow, out, (int)batch, c_pre, (int)hw_units, per_thread,
                                                     tiles, stream)
                   : launch_motion<__nv_bfloat16, 1>(pre, flow, out, (int)batch, c_pre, (int)hw_units, per_thread,
                                                     tiles, stream);
    }
    return vec ? launch_motion<float, 4>(pre, flow, out, (int)batch, c_pre, (int)hw_units, per_thread, tiles, stream)
               : launch_motion<float, 1>(pre, flow, out, (int)batch, c_pre, (int)hw_units, per_thread, tiles, stream);
}

extern "C" const char* raft_gru_tail_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
