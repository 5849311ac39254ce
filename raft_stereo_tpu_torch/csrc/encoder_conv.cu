// Fused layer1 conv of the encoders for Hopper (sm_90a).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/encoder_pallas.py
// `_conv_s2d_kernel` (launched by `fused_conv_s2d`). Same function, in NCHW
// at C = 64 in and out (layer1's width at every model size):
//     z = form(x):  form 0 "none": x
//                   form 1 "in":   relu((x - a) * b)   (instance norm, [mean, inv])
//                   form 2 "bn":   relu(x * a + b)     (frozen batch norm, [inv, shift])
//         with a = aff[b, 0, ci], b = aff[b, 1, ci]; the zero padding of the
//         conv pads z, not x;
//     y = conv3x3(z, w) + bias        (stride 1, "same");
//     stats[b, 0, co] = sum over H x W of y, stats[b, 1, co] = sum of y^2
//         (of the stored fp32 y), when asked for: the next instance norm's
//         statistics without another pass over y.
//
// What bounds it on the H100: operations. One conv on one 512x768 image is
// 2 * 9 * 64 * 64 * 393,216 = 29.0 GFLOP of fp32 (0.433 ms at 67 TFLOP/s
// outside the tensor cores; the model runs fp32 with TF32 off) against about
// 201 MB of traffic (0.060 ms at 3.35 TB/s).
//
// Design: an FFMA implicit GEMM. A block of 256 threads computes a tile of
// 8 x 32 output pixels for all 64 output channels. It loops over the input
// channels in chunks of 8: the chunk's (8+2) x (32+2) halo patch is staged
// into shared memory with the affine, the relu and the zero padding applied
// as it is loaded (so the normalized operand never exists in device memory),
// and the chunk's 8 x 9 x 64 weights beside it (the wrapper hands them over as
// (Ci, 3, 3, Co), so this is a contiguous 16-byte copy). Each thread then
// accumulates 8 consecutive pixels of one row x 8 output channels in
// registers: per input channel and kernel row it reads 10 patch values and
// 24 weights for 192 FMAs. A warp shares its 8 output channels, so weight
// reads are broadcasts, and the patch row stride (41) makes the warp's 32
// patch reads fall in 32 different banks. The epilogue adds the bias, stores
// y, and, when statistics are asked for, reduces each warp's per-channel sums
// over its 32 lanes with shuffles and writes one partial per (block, channel)
// to a (B, tiles, 2, 64) buffer; a second small launch sums the partials of
// each (batch, channel) in a fixed order, in double, one block per sum. No
// float atomics: the statistics are the same on every run.
//
// Rounding: built with contraction on (the inner loop is FFMAs); the
// operand affine uses __fsub_rn / __fmul_rn / __fadd_rn, so z is rounded
// exactly as the plain version rounds it. Each output sums its 576 products
// in (ci, kh, kw) order with one FFMA chain; cuDNN's fp32 implicit GEMM on
// the H100 was measured to do the same and the two agree bit for bit, but
// that is cuDNN's choice of algorithm, so the checks keep a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

#define C 64
#define TILE_H 8
#define TILE_W 32
#define PX 8          // consecutive output pixels (along W) per thread
#define CO 8          // output channels per thread
#define CK 8          // input channels per shared-memory chunk
#define THREADS 256
#define PATCH_H (TILE_H + 2)
#define PATCH_W (TILE_W + 2)
#define PATCH_STRIDE 41  // > PATCH_W; odd, so a warp's patch reads hit 32 banks

#define FORM_NONE 0
#define FORM_IN 1
#define FORM_BN 2

__global__ void __launch_bounds__(THREADS, 2)
encoder_conv_kernel(const float* __restrict__ x, const float* __restrict__ w_t,
                    const float* __restrict__ bias, const float* __restrict__ aff, int form,
                    int height, int width, int tiles_x, float* __restrict__ y,
                    float* __restrict__ partial) {
    __shared__ float patch[CK][PATCH_H][PATCH_STRIDE];
    __shared__ __align__(16) float wsm[CK][9][C];

    const int tid = threadIdx.x;
    const int lane = tid & 31;        // pixel group: row lane >> 2, columns (lane & 3) * PX ...
    const int cgrp = tid >> 5;        // output channels cgrp * CO ...
    const int prow = lane >> 2;
    const int pcol = (lane & 3) * PX;
    const int tile = blockIdx.x;
    const int b = blockIdx.y;
    const int y0 = (tile / tiles_x) * TILE_H;
    const int x0 = (tile % tiles_x) * TILE_W;
    const long long plane = (long long)height * width;
    const float* xb = x + (long long)b * C * plane;

    float acc[PX][CO];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
        for (int k = 0; k < CO; ++k) acc[j][k] = 0.0f;

    for (int ci0 = 0; ci0 < C; ci0 += CK) {
        // Stage the chunk's halo patch, normalized and zero padded.
        for (int e = tid; e < CK * PATCH_H * PATCH_W; e += THREADS) {
            const int c = e / (PATCH_H * PATCH_W);
            const int rem = e - c * (PATCH_H * PATCH_W);
            const int pr = rem / PATCH_W;
            const int pc = rem - pr * PATCH_W;
            const int gy = y0 - 1 + pr;
            const int gx = x0 - 1 + pc;
            float z = 0.0f;
            if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
                z = xb[(long long)(ci0 + c) * plane + (long long)gy * width + gx];
                if (form != FORM_NONE) {
                    const float a = aff[(b * 2) * C + ci0 + c];
                    const float s = aff[(b * 2 + 1) * C + ci0 + c];
                    z = form == FORM_IN ? __fmul_rn(__fsub_rn(z, a), s) : __fadd_rn(__fmul_rn(z, a), s);
                    z = fmaxf(z, 0.0f);
                }
            }
            patch[c][pr][pc] = z;
        }
        // Stage the chunk's weights: w_t is (Ci, 3, 3, Co), so the chunk is
        // CK * 9 * 64 contiguous floats.
        const float4* wsrc = reinterpret_cast<const float4*>(w_t + (long long)ci0 * 9 * C);
        float4* wdst = reinterpret_cast<float4*>(&wsm[0][0][0]);
        for (int e = tid; e < CK * 9 * C / 4; e += THREADS) wdst[e] = wsrc[e];
        __syncthreads();

#pragma unroll 1
        for (int c = 0; c < CK; ++c) {
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
                float in[PX + 2];
#pragma unroll
                for (int j = 0; j < PX + 2; ++j) in[j] = patch[c][prow + kh][pcol + j];
#pragma unroll
                for (int kw = 0; kw < 3; ++kw) {
                    const float4 wa = *reinterpret_cast<const float4*>(&wsm[c][kh * 3 + kw][cgrp * CO]);
                    const float4 wb = *reinterpret_cast<const float4*>(&wsm[c][kh * 3 + kw][cgrp * CO + 4]);
                    const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                    for (int j = 0; j < PX; ++j)
#pragma unroll
                        for (int k = 0; k < CO; ++k) acc[j][k] += in[j + kw] * wv[k];
                }
            }
        }
        __syncthreads();
    }

    // Epilogue: bias, store, per-channel partial statistics.
    const int gy = y0 + prow;
    const int gx0 = x0 + pcol;
    // Two 16-byte stores per channel where the thread's 8 pixels are all in
    // the image and rows start 16-byte aligned.
    const bool whole = gy < height && gx0 + PX <= width && (width & 3) == 0;
    float s[CO], q[CO];
#pragma unroll
    for (int k = 0; k < CO; ++k) {
        const int co = cgrp * CO + k;
        const float bk = bias[co];
        float* yrow = y + ((long long)b * C + co) * plane + (long long)gy * width + gx0;
        float v[PX];
        s[k] = 0.0f;
        q[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < PX; ++j) {
            v[j] = acc[j][k] + bk;
            if (gy < height && gx0 + j < width) {
                s[k] += v[j];
                q[k] += v[j] * v[j];
                if (!whole) yrow[j] = v[j];
            }
        }
        if (whole) {
            reinterpret_cast<float4*>(yrow)[0] = make_float4(v[0], v[1], v[2], v[3]);
            reinterpret_cast<float4*>(yrow)[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
    }
    if (partial != nullptr) {
        // Butterfly over the warp's 32 pixel groups: a fixed order.
#pragma unroll
        for (int k = 0; k < CO; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
                q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
            }
        }
        if (lane == 0) {
            float* dst = partial + ((long long)b * gridDim.x + tile) * 2 * C + cgrp * CO;
#pragma unroll
            for (int k = 0; k < CO; ++k) {
                dst[k] = s[k];
                dst[C + k] = q[k];
            }
        }
    }
}

// stats[b, t] = sum over tiles of partial[b, tile, t] (t indexes [sum | sumsq] x 64),
// in double: one block per (t, b); each thread sums a fixed stride of tiles,
// then a fixed tree over the block. The same order on every run.
#define STATS_THREADS 128
__global__ void __launch_bounds__(STATS_THREADS)
encoder_stats_kernel(const float* __restrict__ partial, int tiles, float* __restrict__ stats) {
    __shared__ double red[STATS_THREADS];
    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const float* src = partial + (long long)b * tiles * 2 * C + t;
    double total = 0.0;
    for (int i = threadIdx.x; i < tiles; i += STATS_THREADS) total += (double)src[(long long)i * 2 * C];
    red[threadIdx.x] = total;
    __syncthreads();
    for (int half = STATS_THREADS / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) stats[b * 2 * C + t] = (float)red[0];
}

extern "C" int raft_encoder_conv_f32(const void* x, const void* w_t, const void* bias, const void* aff,
                                     int form, int batch, int height, int width, void* y,
                                     void* partial, void* stats, void* stream) {
    if (form < FORM_NONE || form > FORM_BN) return (int)cudaErrorInvalidValue;
    if ((form != FORM_NONE) != (aff != nullptr)) return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (stats == nullptr)) return (int)cudaErrorInvalidValue;
    if (batch == 0 || height == 0 || width == 0) return 0;
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    const int tiles = tiles_x * ((height + TILE_H - 1) / TILE_H);
    cudaStream_t s = (cudaStream_t)stream;
    encoder_conv_kernel<<<dim3(tiles, batch), THREADS, 0, s>>>(
        (const float*)x, (const float*)w_t, (const float*)bias, (const float*)aff, form, height, width,
        tiles_x, (float*)y, (float*)partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || stats == nullptr) return (int)err;
    encoder_stats_kernel<<<dim3(2 * C, batch), STATS_THREADS, 0, s>>>((const float*)partial, tiles, (float*)stats);
    return (int)cudaGetLastError();
}

extern "C" const char* raft_encoder_conv_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
