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
//         (of the stored y), when asked for: the next instance norm's
//         statistics without another pass over y.
// x and y are fp32, or bf16 under mixed precision, each dtype with its own
// kernel. In bf16, as the JAX kernel computes it: the affine rows, weights
// and bias are rounded to bf16 (the wrapper hands the rows and the bias
// over as fp32 values already rounded), the affine and relu run in bf16
// with a rounding after each op, the conv sums its exact bf16 products in
// fp32, the sum is rounded to bf16 and the bias added in bf16; the
// statistics stay fp32 sums over the stored bf16 values.
//
// What bounds it on the H100: operations. One conv on one 512x768 image is
// 2 * 9 * 64 * 64 * 393,216 = 29.0 GFLOP of fp32 (0.433 ms at 67 TFLOP/s
// outside the tensor cores; the model runs fp32 with TF32 off) against about
// 201 MB of traffic (0.060 ms at 3.35 TB/s).
//
// In bf16 the products go to the tensor cores (989 TFLOP/s dense): the
// bound falls to about 0.03 ms at 512x768, set by the bytes (100.8 MB: half
// the fp32 traffic) and the operations alike. The bf16 kernel is described
// after the fp32 one.
//
// The fp32 kernel: an FFMA implicit GEMM. A block of 256 threads computes a tile of
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

#include "dtype.cuh"

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

// ---- The bf16 build: tensor cores ------------------------------------------
//
// The same tile of 8 x 32 output pixels x 64 output channels per block of
// 256 threads, as an implicit GEMM on mma.sync m16n8k16 (bf16 products, fp32
// sums): warp w computes output row w of the tile, 32 pixels (two m16 tiles)
// x 64 channels (eight n8 tiles). The input channels go in chunks of 16, one
// k-step per kernel tap: the chunk's halo patch is staged pixel-major
// ([row][col][16 channels], rows of 48 bytes so that ldmatrix's eight rows
// fall in eight different bank groups) with the affine, relu and zero
// padding applied, and its 9 x 64 x 16 weights channel-minor
// ([tap][out channel][16 channels]); a tap's A fragment is then the
// patch shifted by the tap, read by ldmatrix straight from the staged rows.
// The epilogue rounds as the FFMA kernel does, reduces the statistics over
// the warp's pixels by shuffles and over the 8 warps in a fixed order in
// shared memory, and stages the bf16 output tile there for 16-byte stores.

#define MMA_CK 16  // input channels per chunk: one mma k-step per tap
#define MMA_LD 24  // a staged pixel's (or output channel's) 16 channels, padded to 48 bytes
#define OUT_LD 40  // a staged output row of 32 pixels, padded to 80 bytes

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
                 "{%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int MMA_PATCH_BYTES = PATCH_H * PATCH_W * MMA_LD * 2;
constexpr int MMA_W_BYTES = 9 * C * MMA_LD * 2;
constexpr int MMA_OUT_BYTES = C * TILE_H * OUT_LD * 2;
constexpr int MMA_SMEM_BYTES =
    MMA_PATCH_BYTES + MMA_W_BYTES > MMA_OUT_BYTES ? MMA_PATCH_BYTES + MMA_W_BYTES : MMA_OUT_BYTES;

// w_mma: the bf16 weights as (3, 3, Co, Ci).
__global__ void __launch_bounds__(THREADS, 2)
encoder_conv_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_mma,
                        const float* __restrict__ bias, const float* __restrict__ aff, int form,
                        int height, int width, int tiles_x, __nv_bfloat16* __restrict__ y,
                        float* __restrict__ partial) {
    using bf16 = __nv_bfloat16;
    using E = Elem<bf16>;
    __shared__ __align__(16) unsigned char smem[MMA_SMEM_BYTES];
    __shared__ float red[THREADS / 32][2][C];
    bf16* patch = reinterpret_cast<bf16*>(smem);                    // [PATCH_H][PATCH_W][MMA_LD]
    bf16* wsm = reinterpret_cast<bf16*>(smem + MMA_PATCH_BYTES);    // [9][C][MMA_LD]
    bf16* out_s = reinterpret_cast<bf16*>(smem);                    // [C][TILE_H][OUT_LD], after the loop

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int q = lane >> 3, r = lane & 7;
    const int tile = blockIdx.x;
    const int b = blockIdx.y;
    const int y0 = (tile / tiles_x) * TILE_H;
    const int x0 = (tile % tiles_x) * TILE_W;
    const long long plane = (long long)height * width;
    const bf16* xb = x + (long long)b * C * plane;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

    for (int ci0 = 0; ci0 < C; ci0 += MMA_CK) {
        // The chunk's halo patch, normalized and zero padded, pixel-major.
        for (int e = tid; e < MMA_CK * PATCH_H * PATCH_W; e += THREADS) {
            const int c = e / (PATCH_H * PATCH_W);
            const int rem = e - c * (PATCH_H * PATCH_W);
            const int pr = rem / PATCH_W;
            const int pc = rem - pr * PATCH_W;
            const int gy = y0 - 1 + pr;
            const int gx = x0 - 1 + pc;
            float z = 0.0f;
            if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
                z = E::load(xb + (long long)(ci0 + c) * plane + (long long)gy * width + gx);
                if (form != FORM_NONE) {
                    const float a = aff[(b * 2) * C + ci0 + c];
                    const float s = aff[(b * 2 + 1) * C + ci0 + c];
                    z = form == FORM_IN ? E::round(__fmul_rn(E::round(__fsub_rn(z, a)), s))
                                        : E::round(__fadd_rn(E::round(__fmul_rn(z, a)), s));
                    z = fmaxf(z, 0.0f);
                }
            }
            patch[(pr * PATCH_W + pc) * MMA_LD + c] = __float2bfloat16_rn(z);  // exact: z is a bf16 value
        }
        // The chunk's weights: row (tap, co) holds channels ci0 .. ci0 + 15,
        // two 16-byte copies.
        for (int e = tid; e < 9 * C * 2; e += THREADS) {
            const int row = e >> 1, half = e & 1;
            *reinterpret_cast<uint4*>(wsm + row * MMA_LD + 8 * half) =
                *reinterpret_cast<const uint4*>(w_mma + (long long)row * C + ci0 + 8 * half);
        }
        __syncthreads();
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
                // A: pixels (rows) x channels, matrices (pixel, channel) blocks
                // (0, 0), (8, 0), (0, 8), (8, 8); B: (out channel, channel)
                // blocks (0, 0), (0, 8), (8, 0), (8, 8) of two n8 tiles.
                unsigned a[2][4], bq[8][2];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
                    ldmatrix_x4(a[mt], patch + ((warp + kh) * PATCH_W + mt * 16 + r + 8 * (q & 1) + kw) * MMA_LD
                                           + 8 * (q >> 1));
#pragma unroll
                for (int nt = 0; nt < 8; nt += 2) {
                    unsigned t[4];
                    ldmatrix_x4(t, wsm + ((kh * 3 + kw) * C + nt * 8 + r + 8 * (q >> 1)) * MMA_LD + 8 * (q & 1));
                    bq[nt][0] = t[0]; bq[nt][1] = t[1]; bq[nt + 1][0] = t[2]; bq[nt + 1][1] = t[3];
                }
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], a[mt], bq[nt][0], bq[nt][1]);
            }
        }
        __syncthreads();
    }

    // Epilogue. Accumulator c of tile (mt, nt): pixel mt * 16 + g (+8 for
    // c >= 2) of row `warp`, channels nt * 8 + 2t (+1 for odd c).
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const int gy = y0 + warp;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int co = nt * 8 + t2 + j;
            const float bk = bias[co];
            float s = 0.0f, sq = 0.0f;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int px = mt * 16 + g + 8 * hf;
                    const float v = E::round(__fadd_rn(E::round(acc[mt][nt][2 * hf + j]), bk));
                    if (gy < height && x0 + px < width) {
                        s += v;
                        sq += v * v;
                    }
                    out_s[(co * TILE_H + warp) * OUT_LD + px] = __float2bfloat16_rn(v);
                }
            }
            // Over the warp's 8 pixel groups (lane bits 2-4): a fixed order.
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, off);
                sq += __shfl_xor_sync(0xffffffffu, sq, off);
            }
            if (g == 0) {
                red[warp][0][co] = s;
                red[warp][1][co] = sq;
            }
        }
    }
    __syncthreads();
    if (partial != nullptr && tid < 2 * C) {
        float total = 0.0f;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) total += red[w][tid / C][tid % C];
        partial[((long long)b * gridDim.x + tile) * 2 * C + tid] = total;
    }
    // The bf16 tile out, 8 pixels (16 bytes) per store where they are all
    // in the image and rows start 16-byte aligned.
    for (int e = tid; e < C * TILE_H * (TILE_W / 8); e += THREADS) {
        const int co = e / (TILE_H * (TILE_W / 8));
        const int rem = e - co * (TILE_H * (TILE_W / 8));
        const int row = rem / (TILE_W / 8);
        const int seg = rem - row * (TILE_W / 8);
        const int oy = y0 + row, ox = x0 + seg * 8;
        if (oy >= height || ox >= width) continue;
        const bf16* src = out_s + (co * TILE_H + row) * OUT_LD + seg * 8;
        bf16* dst = y + ((long long)b * C + co) * plane + (long long)oy * width + ox;
        if (ox + 8 <= width && (width & 7) == 0) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            for (int k = 0; k < 8 && ox + k < width; ++k) dst[k] = src[k];
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

// x and y are fp32 (bf16 = 0: the FFMA kernel, w_t the fp32 weights as
// (Ci, 3, 3, Co)) or bf16 (bf16 = 1: the tensor-core kernel, w_t the bf16
// weights as (3, 3, Co, Ci)); bias and the affine rows are fp32 in either
// case (in bf16, values the wrapper has rounded to bf16).
extern "C" int raft_encoder_conv(const void* x, const void* w_t, const void* bias, const void* aff,
                                 int form, int batch, int height, int width, void* y,
                                 void* partial, void* stats, int bf16, void* stream) {
    if (form < FORM_NONE || form > FORM_BN) return (int)cudaErrorInvalidValue;
    if ((form != FORM_NONE) != (aff != nullptr)) return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (stats == nullptr)) return (int)cudaErrorInvalidValue;
    if (batch == 0 || height == 0 || width == 0) return 0;
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    const int tiles_x = (width + TILE_W - 1) / TILE_W;
    const int tiles = tiles_x * ((height + TILE_H - 1) / TILE_H);
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        encoder_conv_mma_kernel<<<dim3(tiles, batch), THREADS, 0, s>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w_t, (const float*)bias, (const float*)aff, form,
            height, width, tiles_x, (__nv_bfloat16*)y, (float*)partial);
    else
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
