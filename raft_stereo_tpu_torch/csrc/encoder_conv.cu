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
// bound falls to 0.0316 ms at 512x768, set by the operations (29.0 GFLOP)
// and the bytes (100.8 MB: half the fp32 traffic) alike; 0.917 ms for
// Middlebury-F's two images. The bf16 kernel (`encoder_conv_wgmma_kernel`)
// is described after the fp32 one: persistent blocks with the weights
// resident in shared memory, a producer warpgroup that stages each tile's
// normalized halo patch (a TMA raw tile where W is a multiple of 8) into one
// of two slots, and two consumer warpgroups on wgmma. ptxas -v: 168
// registers, no spills, 227,368 bytes of dynamic shared memory. Measured
// (kernel_compare.py and chip_smoke.py [timing], H100 80GB HBM3, 700.00 W),
// the conv kernel alone on the device, without the pass that sums its
// statistics partials: 0.0880-0.0906 ms at 512x768 (1 image, instance
// form and statistics: 35-36% of the bound; the first mma.sync version of
// this kernel 0.3396-0.3397, cuDNN's bf16 F.conv2d of the normalized
// operand 0.2575-0.2593), 2.140-2.268 ms for Middlebury-F's two images
// (40-43%; mma.sync 9.425-9.438, cuDNN 6.88-6.95), 0.0654-0.0673 ms at the
// realtime model's 192x624 (frozen BN, no statistics: 28-29% of its
// 0.0188 ms bound; mma.sync 0.2231-0.2266, cuDNN 0.1717-0.1723). What is
// left, not yet split by a measurement: the producer's staging of a tile
// (its 61 KB raw tile, the transpose into the patch) and the consumers'
// 144 wgmma m64n64k16 per tile, which read A and B from shared memory
// (about 590 KB per tile).
//
// The fp32 kernel (`encoder_conv_kernel`): an FFMA implicit GEMM on
// persistent blocks, one per multiprocessor, that walk the (batch, 8 x 64
// tile) list in a fixed order (tile t, t + grid, ...). A block of 256
// threads loads the (Ci, 3, 3, Co) fp32 weights into shared memory once
// (147,456 bytes; the wrapper hands them over in that layout) and keeps
// them there. It walks each tile's input channels in chunks of 8. Where W
// is a multiple of 4 and x and y are 16-byte aligned (`vec`, the plan's
// choice), a chunk's raw halo box, 72 x 10 pixels x 8 channels from column
// x0 - 4 (a TMA box must start on a 16-byte boundary along W), arrives by
// one TMA load (x as an fp32 (W, H, 64 B) tensor map, zeros outside),
// issued by one thread as soon as the previous chunk's box has been read,
// so it lands while the block computes; otherwise the threads load the
// chunk element by element. The block then applies the affine and relu
// once per staged element (each warp 10 patch rows, their loads all in
// flight), writing z into one of two (8+2) x (64+2) patch slots, and sets
// every element outside the image to 0: the conv pads z, not x, and TMA's
// zero fill would otherwise turn into relu(-a b) or relu(b). One barrier
// per chunk: the slot is complete, the raw box is free for the next load,
// and the other slot is no longer read. Each thread accumulates 8
// consecutive pixels of one row x 16 output channels in registers (128
// accumulators under the 255 registers one block per multiprocessor
// leaves): per input channel and kernel row it reads its 10 patch values
// as three float4 (patch row stride 68: 16-byte reads without bank
// conflicts) and 12 float4 weights (broadcast: a warp shares its 16
// channels) for 384 FFMAs. The epilogue adds the bias, stores y with
// 16-byte stores where the thread's 8 pixels are whole, and, when
// statistics are asked for, reduces each warp's per-channel sums over its
// 32 lanes with shuffles into one partial per (batch, tile, column half),
// the layout the bf16 kernel writes.
//
// Measured (chip_smoke.py [timing] and kernel_compare.py, H100 80GB HBM3,
// 700.00 W), one 512x768 image, instance form with statistics: 0.7004-
// 0.7143 ms by CUDA events, its kernels alone on the device 0.6894-0.7250
// (60-63% of the 0.435 ms bound), against the first version of this
// kernel's 0.9094-0.9180 (one block per tile, synchronous staging, the
// weights reloaded per tile) and cuDNN's fp32 F.conv2d of the normalized
// operand, 0.7853-0.7920; two images 1.3710-1.3898 (first version
// 1.7788-1.7932, cuDNN 1.5695-1.5831); at 384x512 0.3636-0.3724 (0.4640-
// 0.4680, cuDNN 0.3952-0.3995). ptxas: 246 registers, no spills, 214,160
// bytes of dynamic shared memory. What is left, not split by a committed
// measurement: the staging pass between chunks, which a barrier keeps
// apart from the FFMAs (a variant that staged each next chunk in place,
// warps staggered against the ones computing, with three TMA slots, was
// slower and was dropped), and the last of 768 tiles' 5.8 rounds over 132
// blocks.
//
// The statistics pass, shared by both kernels: the first launch sums runs
// of 256 partials per (batch, run) in double, the second the runs per
// batch, each in a fixed order with 8 loads in flight per thread (a warp
// reads 32 consecutive entries of one partial, 128 bytes; see
// `stats_sum`). No float atomics: the statistics are the same on every
// run.
//
// Rounding: built with contraction on (the inner loop is FFMAs); the
// operand affine uses __fsub_rn / __fmul_rn / __fadd_rn, so z is rounded
// exactly as the plain version rounds it. Each output sums its 576 products
// in (ci, kh, kw) order with one FFMA chain, then adds the bias; no split
// of the sum, no tensor cores (the model runs fp32 with TF32 off). cuDNN's
// fp32 implicit GEMM on the H100 was measured to sum in the same order and
// the two agree bit for bit, but that is cuDNN's choice of algorithm, so
// the checks keep a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dtype.cuh"
#include "hopper.cuh"

#define C 64
#define TILE_H 8
#define TILE_W 32     // the bf16 kernel's tile width
#define THREADS 256
#define PATCH_H (TILE_H + 2)
#define PATCH_W (TILE_W + 2)

#define FORM_NONE 0
#define FORM_IN 1
#define FORM_BN 2

// The fp32 kernel's geometry and shared memory (ops/encoder_cuda.py
// CONV_F32_SHARED_BYTES mirrors F_SMEM_BYTES).
constexpr int F_TILE_W = 64;                                // an fp32 tile: 8 x 64 output pixels
constexpr int F_PX = 8;                                     // consecutive pixels (along W) per thread
constexpr int F_CO = 16;                                    // output channels per thread
constexpr int F_CK = 8;                                     // input channels per chunk
constexpr int F_PATCH_W = F_TILE_W + 2;                     // 66
// Patch row stride: 68 = 4 mod 32, so the rows start 16-byte aligned and
// the 8 lanes of a quarter warp (2 rows x 4 column groups) read 8 distinct
// 16-byte bank groups; a thread's 12 floats (10 used) end at column 67.
constexpr int F_STRIDE = 68;
constexpr int F_PATCH_FLOATS = F_CK * PATCH_H * F_STRIDE;   // 5,440
constexpr int F_RAW_W = F_TILE_W + 8;                       // raw box columns x0 - 4 .. x0 + 67 (288 bytes)
constexpr int F_RAW_FLOATS = F_CK * PATCH_H * F_RAW_W;      // 5,760: the TMA box
constexpr int F_W_FLOATS = C * 9 * C;                       // 36,864: the resident weights
// 128 bytes of slack to align the raw box, the raw box, the weights, two
// patch slots and the raw box's barrier (16 bytes).
constexpr int F_SMEM_BYTES = 128 + 4 * (F_RAW_FLOATS + F_W_FLOATS + 2 * F_PATCH_FLOATS) + 16;

__device__ __forceinline__ float form_fp32(float z, float a, float s, int form) {
    if (form == FORM_NONE) return z;
    z = form == FORM_IN ? __fmul_rn(__fsub_rn(z, a), s) : __fadd_rn(__fmul_rn(z, a), s);
    return fmaxf(z, 0.0f);
}

// xmap: x as (W, H, 64 B) with 72 x 10 x 8 boxes (unused without vec);
// w_t: the fp32 weights as (Ci, 3, 3, Co); `tiles` per image, `total` =
// batch x tiles.
__global__ void __launch_bounds__(THREADS, 1)
encoder_conv_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                    const float* __restrict__ w_t, const float* __restrict__ bias, const float* __restrict__ aff,
                    int form, int height, int width, int tiles_x, int tiles, int total, int vec,
                    float* __restrict__ y, float* __restrict__ partial) {
    extern __shared__ __align__(128) unsigned char smem_f32[];
    float* raw = reinterpret_cast<float*>(smem_f32 + ((128 - (smem_u32(smem_f32) & 127)) & 127));
    float* wsm = raw + F_RAW_FLOATS;
    float* patches = wsm + F_W_FLOATS;
    uint64_t* raw_full = reinterpret_cast<uint64_t*>(patches + 2 * F_PATCH_FLOATS);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int cg = warp >> 1;                            // output channels 16 cg ..
    const int half = warp & 1;                           // tile columns 32 half ..
    const int prow = lane >> 2;                          // the thread's tile row
    const int pcol = 32 * half + F_PX * (lane & 3);      // its first tile column
    const long long plane = (long long)height * width;
    constexpr int CHUNKS = C / F_CK;

    // One thread: the raw box of chunk k of tile t.
    auto load_raw = [&](int t, int k) {
        const int b = t / tiles;
        const int tile = t - b * tiles;
        const int ty = tile / tiles_x;
        mbar_arrive_expect_tx(raw_full, F_RAW_FLOATS * 4);
        tma_load_3d(raw, &xmap, raw_full, (tile - ty * tiles_x) * F_TILE_W - 4, ty * TILE_H - 1, b * C + k * F_CK);
    };
    if (tid == 0) {
        mbar_init(raw_full, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (vec && tid == 0 && (int)blockIdx.x < total) load_raw(blockIdx.x, 0);
    // The weights, once (visible after the first chunk's barrier).
    for (int e = tid; e < F_W_FLOATS / 4; e += THREADS)
        reinterpret_cast<float4*>(wsm)[e] = __ldg(reinterpret_cast<const float4*>(w_t) + e);

    int n = 0;  // chunks staged so far: chunk n uses patch slot n % 2 and raw phase n % 2
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int b = t / tiles;
        const int tile = t - b * tiles;
        const int ty = tile / tiles_x;
        const int y0 = ty * TILE_H;
        const int x0 = (tile - ty * tiles_x) * F_TILE_W;
        const float* xb = x + (long long)b * C * plane;
        float acc[F_PX][F_CO];
#pragma unroll
        for (int j = 0; j < F_PX; ++j)
#pragma unroll
            for (int k = 0; k < F_CO; ++k) acc[j][k] = 0.0f;

        for (int k = 0; k < CHUNKS; ++k, ++n) {
            float* patch = patches + (n & 1) * F_PATCH_FLOATS;
            // Stage chunk k as z = form(x), 0 outside the image: warp w takes
            // patch rows (channel, row) w, w + 8, ..., lane l columns l + 1 and
            // l + 33 of each; the 80 rows' halo columns 0 and 65 go to 160
            // threads after. The affine values are read once per row.
            if (vec) mbar_wait(raw_full, n & 1);
            // Unrolled, so that every row's loads are in flight at once.
#pragma unroll
            for (int i = 0; i < F_CK * PATCH_H / (THREADS / 32); ++i) {
                const int row = warp + (THREADS / 32) * i;
                const int c = row / PATCH_H;
                const int gy = y0 - 1 + (row - c * PATCH_H);
                const int ci = k * F_CK + c;
                const bool row_in = gy >= 0 && gy < height;
                const float a = form != FORM_NONE ? aff[(b * 2) * C + ci] : 0.0f;
                const float sc = form != FORM_NONE ? aff[(b * 2 + 1) * C + ci] : 0.0f;
                const float* src = vec ? raw + row * F_RAW_W + 3 : xb + (long long)ci * plane + (long long)gy * width + x0 - 1;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int pc = 1 + lane + 32 * h;
                    const int gx = x0 - 1 + pc;
                    patch[row * F_STRIDE + pc] = row_in && gx < width ? form_fp32(src[pc], a, sc, form) : 0.0f;
                }
            }
            if (tid < 2 * F_CK * PATCH_H) {
                const int row = tid >> 1;
                const int pc = tid & 1 ? F_PATCH_W - 1 : 0;
                const int c = row / PATCH_H;
                const int gy = y0 - 1 + (row - c * PATCH_H);
                const int gx = x0 - 1 + pc;
                const int ci = k * F_CK + c;
                float z = 0.0f;
                if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
                    z = vec ? raw[row * F_RAW_W + pc + 3] : xb[(long long)ci * plane + (long long)gy * width + gx];
                    if (form != FORM_NONE) z = form_fp32(z, aff[(b * 2) * C + ci], aff[(b * 2 + 1) * C + ci], form);
                }
                patch[row * F_STRIDE + pc] = z;
            }
            __syncthreads();  // the slot is staged, the raw box read, the other slot's reads done
            if (vec && tid == 0) {
                const int nt = k + 1 < CHUNKS ? t : t + (int)gridDim.x;
                if (nt < total) {
                    fence_proxy_async();
                    load_raw(nt, k + 1 < CHUNKS ? k + 1 : 0);
                }
            }
            const float* pb = patch + prow * F_STRIDE + pcol;
            const float* wb = wsm + k * F_CK * 9 * C + F_CO * cg;
#pragma unroll 1
            for (int c = 0; c < F_CK; ++c) {
#pragma unroll
                for (int kh = 0; kh < 3; ++kh) {
                    float in[F_PX + 2];
                    {
                        // Three 16-byte reads: the 10 values and 2 unused.
                        const float4* pv = reinterpret_cast<const float4*>(pb + (c * PATCH_H + kh) * F_STRIDE);
                        const float4 a4 = pv[0], b4 = pv[1], c4 = pv[2];
                        in[0] = a4.x; in[1] = a4.y; in[2] = a4.z; in[3] = a4.w; in[4] = b4.x; in[5] = b4.y;
                        in[6] = b4.z; in[7] = b4.w; in[8] = c4.x; in[9] = c4.y;
                    }
#pragma unroll
                    for (int kw = 0; kw < 3; ++kw) {
                        const float4* wp = reinterpret_cast<const float4*>(wb + (c * 9 + kh * 3 + kw) * C);
                        float wv[F_CO];
#pragma unroll
                        for (int i = 0; i < F_CO / 4; ++i) {
                            const float4 w4 = wp[i];
                            wv[4 * i] = w4.x; wv[4 * i + 1] = w4.y; wv[4 * i + 2] = w4.z; wv[4 * i + 3] = w4.w;
                        }
#pragma unroll
                        for (int o = 0; o < F_CO; ++o)
#pragma unroll
                            for (int j = 0; j < F_PX; ++j) acc[j][o] = fmaf(in[j + kw], wv[o], acc[j][o]);
                    }
                }
            }
        }

        // Epilogue: bias, store, per-channel partial statistics.
        const int gy = y0 + prow;
        const int gx0 = x0 + pcol;
        // Two 16-byte stores per channel where the thread's 8 pixels are all
        // in the image (vec: rows start 16-byte aligned).
        const bool whole = vec && gy < height && gx0 + F_PX <= width;
        float s[F_CO], q[F_CO];
#pragma unroll
        for (int o = 0; o < F_CO; ++o) {
            const int co = F_CO * cg + o;
            const float bk = bias[co];
            float* yrow = y + ((long long)b * C + co) * plane + (long long)gy * width + gx0;
            float v[F_PX];
            s[o] = 0.0f;
            q[o] = 0.0f;
#pragma unroll
            for (int j = 0; j < F_PX; ++j) {
                v[j] = acc[j][o] + bk;
                if (gy < height && gx0 + j < width) {
                    s[o] += v[j];
                    q[o] += v[j] * v[j];
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
            for (int o = 0; o < F_CO; ++o) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    s[o] += __shfl_xor_sync(0xffffffffu, s[o], off);
                    q[o] += __shfl_xor_sync(0xffffffffu, q[o], off);
                }
            }
            if (lane == 0) {
                float* dst = partial + (((long long)b * tiles + tile) * 2 + half) * 2 * C + F_CO * cg;
#pragma unroll
                for (int o = 0; o < F_CO; ++o) {
                    dst[o] = s[o];
                    dst[C + o] = q[o];
                }
            }
        }
    }
}

// ---- The bf16 build on Hopper: resident weights, wgmma, persistent blocks ----
//
// One block per multiprocessor walks the (batch, 8 x 32 tile) list in a
// fixed order (tile t, t + grid, ...). The block first loads all nine
// taps' 64 x 64 bf16 weights into shared memory once (73,728 bytes), as
// wgmma's K-major B operand: a row of 64 input channels (128 bytes) per
// (tap, output channel), 128-byte swizzled. Warpgroup 2 is the producer:
// it stages each tile's (8+2) x (32+2) halo patch of z = form(x) into one
// of two patch slots, pixel-major (a pixel's 64 channels in 128 bytes, its
// eight 16-byte chunks XOR-swizzled by the pixel's column), with the
// affine, relu and zero padding applied in registers on bf16 pairs: a lane
// takes 8 pixels of one channel (16 bytes along W), and stmatrix.trans
// turns 8 channels x 32 pixels of a warp into 32 pixel rows of 16 bytes.
// Where W is a multiple of 8 (`vec`) the raw tile, 48 x 10 pixels of 64
// channels around it, arrives by one TMA load into a staging buffer,
// issued as soon as the previous tile is staged; otherwise the producer
// loads the tile element by element. Warpgroups 0 and 1 compute rows 0-3
// and 4-7 of the tile: two m64 blocks each (2 rows x 32 pixels), per tap
// and per 16 input channels one wgmma m64n64k16 with A from registers
// (ldmatrix of the patch shifted by the tap; the next tap's fragments load
// while this tap's wgmmas run) and B from the resident weights. The
// producer stages the next tile into the other slot meanwhile. After the
// last tap the two consumer warpgroups meet once, and the consumed slot
// takes the output tile: each warpgroup rounds the sum and adds the bias
// on bf16 pairs, stores its rows there channel-major (stmatrix.trans),
// writes them out in 16-byte rows and reduces the statistics in a fixed
// order into one partial per (batch, tile, warpgroup); then it releases
// the slot.

constexpr int WC_THREADS = 384;                          // consumer warpgroups 0-1, producer warpgroup 2
constexpr int WC_PIX = C * 2;                            // a staged pixel: 64 bf16 channels, eight 16-byte chunks
constexpr int WC_PATCH_BYTES = PATCH_H * PATCH_W * WC_PIX;  // 43,520
constexpr int WC_TAP_BYTES = C * C * 2;                  // one tap's weights: 8,192
constexpr int WC_W_BYTES = 9 * WC_TAP_BYTES;             // 73,728
constexpr int WC_RAW_W = TILE_W + 16;                    // the raw tile's columns x0 - 8 .. x0 + 39
constexpr int WC_RAW_BYTES = C * PATCH_H * WC_RAW_W * 2; // 61,440: [channel][patch row][48 pixels]
constexpr int WC_OUT_LD = TILE_H * TILE_W * 2 + 16;      // a staged output channel: 8 x 32 pixels + 16 bytes
constexpr int WC_OUT_BYTES = C * WC_OUT_LD;              // 33,792
constexpr int WC_RED_BYTES = 8 * 2 * C * 4;              // the 8 consumer warps' [sum, sumsq] x 64
// The slack to align the weights to a 1024-byte swizzle atom, the weights,
// two patches (the output tile takes the place of the one just consumed),
// the raw tile, the reduction and five barriers (each patch full and
// empty, the raw tile in).
static_assert(WC_OUT_BYTES <= WC_PATCH_BYTES, "the output tile fits in a patch slot");
constexpr int WC_SMEM_BYTES = 1024 + WC_W_BYTES + 2 * WC_PATCH_BYTES + WC_RAW_BYTES + WC_RED_BYTES + 5 * 8;

// Byte offset of (pixel row pr, column pc, 16-byte channel chunk ck) in a patch.
__device__ __forceinline__ int patch_off(int pr, int pc, int ck) {
    return (pr * PATCH_W + pc) * WC_PIX + ((ck ^ (pc & 7)) << 4);
}

// z = form(x) of one bf16 value, rounded after each op as the plain
// version rounds it.
template <int FORM>
__device__ __forceinline__ float form_bf16(float x, float a, float s) {
    using E = Elem<__nv_bfloat16>;
    if (FORM == FORM_NONE) return x;
    const float z = FORM == FORM_IN ? E::round(__fmul_rn(E::round(__fsub_rn(x, a)), s))
                                    : E::round(__fadd_rn(E::round(__fmul_rn(x, a)), s));
    return fmaxf(z, 0.0f);
}

// The same on a pair of bf16 values in one word (a2, s2: the affine
// values of its channel in both halves).
template <int FORM>
__device__ __forceinline__ uint32_t form_bf16x2(uint32_t x, uint32_t a2, uint32_t s2) {
    if (FORM == FORM_NONE) return x;
    return bf16x2_relu(FORM == FORM_IN ? bf16x2_mul(bf16x2_sub(x, a2), s2) : bf16x2_add(bf16x2_mul(x, a2), s2));
}

// w_mma: the bf16 weights as (3, 3, Co, Ci); `vec`: W is a multiple of 8
// and x and y start 16-byte aligned (the TMA raw tile, 16-byte stores);
// xmap: x as (W, H, 64 B) with 48 x 10 x 64 boxes (unused without vec).
template <int FORM>
__global__ void __launch_bounds__(WC_THREADS, 1)
encoder_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w_mma, const float* __restrict__ bias,
                          const float* __restrict__ aff, int height, int width, int tiles_x, int tiles, int total,
                          int vec, __nv_bfloat16* __restrict__ y, float* __restrict__ partial) {
    using bf16 = __nv_bfloat16;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* wsm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* patches = wsm + WC_W_BYTES;
    unsigned char* raw = patches + 2 * WC_PATCH_BYTES;
    float* red = reinterpret_cast<float*>(raw + WC_RAW_BYTES);  // [8 warps][2][64]
    uint64_t* patch_full = reinterpret_cast<uint64_t*>(raw + WC_RAW_BYTES + WC_RED_BYTES);  // [2]
    uint64_t* patch_empty = patch_full + 2;                                                  // [2]
    uint64_t* raw_full = patch_full + 4;

    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int lane = tid & 31;
    const int t128 = tid & 127;
    // The weights, once: chunk (tap, co, 8 input channels) at its swizzled place.
    for (int e = tid; e < 9 * C * 8; e += WC_THREADS) {
        const int row = e >> 3, ck = e & 7;  // row = tap * 64 + co
        *reinterpret_cast<uint4*>(wsm + row * WC_PIX + ((ck ^ (row & 7)) << 4)) =
            *reinterpret_cast<const uint4*>(w_mma + (long long)row * C + 8 * ck);
    }
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(patch_full + i, 128);
            mbar_init(patch_empty + i, 8);
        }
        mbar_init(raw_full, 1);
        mbar_init_fence();
    }
    fence_proxy_async();  // the weights are read by wgmma
    __syncthreads();
    const long long plane = (long long)height * width;

    if (wg == 2) {
        // Producer. Warp w stages the interior of channel groups w and w + 4
        // (a lane: channel rho of the group, pixels 8q .. 8q+7 of the tile's
        // row), task i being patch row i / 2 of group w + 4 (i % 2); thread
        // t128 stages the halo column (t128 < 64: left) of channel t128 % 64.
        const int warp = t128 >> 5;
        const int rho = lane >> 2, q = lane & 3;
        const int mi = lane >> 3, mj = lane & 7;  // the stmatrix row this lane addresses
        // Pixel of that row: column mj of matrix mi, whose registers hold
        // pixel pair (mi + q') % 4 of run q' (the rotation keeps the eight
        // rows of a matrix in eight bank groups).
        const int st_px = 8 * (mj >> 1) + 2 * ((mi + (mj >> 1)) & 3) + (mj & 1);
        const int hc = t128 & (C - 1);
        const int hpc = t128 >> 6 ? PATCH_W - 1 : 0;
        constexpr int TASKS = PATCH_H * 2;  // per warp
        auto load_raw = [&](int t) {  // one thread: the raw tile of tile t
            const int b = t / tiles;
            const int tile = t - b * tiles;
            mbar_arrive_expect_tx(raw_full, WC_RAW_BYTES);
            tma_load_3d(raw, &xmap, raw_full, (tile - (tile / tiles_x) * tiles_x) * TILE_W - 8,
                        (tile / tiles_x) * TILE_H - 1, b * C);
        };
        if (vec && t128 == 0 && (int)blockIdx.x < total) load_raw(blockIdx.x);
        // The affine values of this thread's channels, for batch cur_b.
        int cur_b = -1;
        float fa[2] = {0.0f, 0.0f}, fs[2] = {0.0f, 0.0f}, ha = 0.0f, hs = 0.0f;
        uint32_t a2[2] = {0u, 0u}, s2[2] = {0u, 0u};
        int k = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x, ++k) {
            const int s = k & 1;  // the patch slot
            const int b = t / tiles;
            const int tile = t - b * tiles;
            const int y0 = (tile / tiles_x) * TILE_H;
            const int x0 = (tile - (tile / tiles_x) * tiles_x) * TILE_W;
            const bf16* xb = x + (long long)b * C * plane;
            unsigned char* patch = patches + s * WC_PATCH_BYTES;
            const int gx = x0 + 8 * q;
            if (FORM != FORM_NONE && b != cur_b) {
                cur_b = b;
#pragma unroll
                for (int g2 = 0; g2 < 2; ++g2) {
                    fa[g2] = aff[(b * 2) * C + 8 * (warp + 4 * g2) + rho];
                    fs[g2] = aff[(b * 2 + 1) * C + 8 * (warp + 4 * g2) + rho];
                    a2[g2] = bf16x2_splat(fa[g2]);
                    s2[g2] = bf16x2_splat(fs[g2]);
                }
                ha = aff[(b * 2) * C + hc];
                hs = aff[(b * 2 + 1) * C + hc];
            }
            const int hgx = x0 - 1 + hpc;
            float hv[PATCH_H];
            uint4 in[TASKS];
            if (vec) {
                mbar_wait(raw_full, k & 1);
#pragma unroll
                for (int task = 0; task < TASKS; ++task) {
                    const int c = 8 * (warp + 4 * (task & 1)) + rho;
                    in[task] = *reinterpret_cast<const uint4*>(raw + ((c * PATCH_H + (task >> 1)) * WC_RAW_W + 8 + 8 * q) * 2);
                }
#pragma unroll
                for (int pr = 0; pr < PATCH_H; ++pr)
                    hv[pr] = bf16_lo(*reinterpret_cast<const uint16_t*>(raw + ((hc * PATCH_H + pr) * WC_RAW_W + (hpc ? WC_RAW_W - 8 : 7)) * 2));
                named_barrier(3, 128);  // every producer thread has read the raw tile
                if (t128 == 0 && t + (int)gridDim.x < total) {
                    fence_proxy_async();
                    load_raw(t + gridDim.x);
                }
            } else {
                // Element by element: W is not a multiple of 8 (or x is not
                // 16-byte aligned).
#pragma unroll
                for (int task = 0; task < TASKS; ++task) {
                    const int c = 8 * (warp + 4 * (task & 1)) + rho;
                    const int gy = y0 - 1 + (task >> 1);
                    const bf16* src = xb + c * plane + (long long)gy * width + gx;
                    uint32_t w4[4] = {0u, 0u, 0u, 0u};
                    if (gy >= 0 && gy < height) {
#pragma unroll
                        for (int e = 0; e < 8; e += 2) {
                            const uint32_t lo = gx + e < width ? __bfloat16_as_ushort(src[e]) : 0u;
                            const uint32_t hi = gx + e + 1 < width ? __bfloat16_as_ushort(src[e + 1]) : 0u;
                            w4[e >> 1] = lo | (hi << 16);
                        }
                    }
                    in[task] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
                }
#pragma unroll
                for (int pr = 0; pr < PATCH_H; ++pr) {
                    const int gy = y0 - 1 + pr;
                    hv[pr] = gy >= 0 && gy < height && hgx >= 0 && hgx < width
                                 ? Elem<bf16>::load(xb + hc * plane + (long long)gy * width + hgx)
                                 : 0.0f;
                }
            }
            mbar_wait(patch_empty + s, ((k >> 1) & 1) ^ 1);  // the consumers are done with this slot's last tile
#pragma unroll
            for (int task = 0; task < TASKS; ++task) {
                const int g2 = task & 1;
                const int pr = task >> 1;
                const int gy = y0 - 1 + pr;
                const uint32_t w4[4] = {in[task].x, in[task].y, in[task].z, in[task].w};
                uint32_t pk[4];
                // Zero padding pads z, not x: a pixel outside the image is 0.
                if (gy >= 0 && gy < height && gx + 8 <= width) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) pk[e] = form_bf16x2<FORM>(w4[e], a2[g2], s2[g2]);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const bool row_in = gy >= 0 && gy < height;
                        const float lo = row_in && gx + 2 * e < width ? form_bf16<FORM>(bf16_lo(w4[e]), fa[g2], fs[g2]) : 0.0f;
                        const float hi =
                            row_in && gx + 2 * e + 1 < width ? form_bf16<FORM>(bf16_hi(w4[e]), fa[g2], fs[g2]) : 0.0f;
                        pk[e] = bf16_pack(lo, hi);  // exact: bf16 values
                    }
                }
                // Register e holds pair (e + q) % 4: rotate by q's bits.
                if (q & 1) {
                    const uint32_t t0 = pk[0];
                    pk[0] = pk[1]; pk[1] = pk[2]; pk[2] = pk[3]; pk[3] = t0;
                }
                if (q & 2) {
                    const uint32_t t0 = pk[0], t1 = pk[1];
                    pk[0] = pk[2]; pk[1] = pk[3]; pk[2] = t0; pk[3] = t1;
                }
                stmatrix_x4_trans(patch + patch_off(pr, 1 + st_px, warp + 4 * g2), pk);
            }
            // The halo columns 0 and 33, one element each.
#pragma unroll
            for (int pr = 0; pr < PATCH_H; ++pr) {
                const int gy = y0 - 1 + pr;
                const bool in_image = gy >= 0 && gy < height && hgx >= 0 && hgx < width;
                *reinterpret_cast<bf16*>(patch + patch_off(pr, hpc, hc >> 3) + 2 * (hc & 7)) =
                    __float2bfloat16_rn(in_image ? form_bf16<FORM>(hv[pr], ha, hs) : 0.0f);
            }
            mbar_arrive(patch_full + s);
        }
    } else {
        // Consumers: warpgroup wg computes tile rows 4 wg .. 4 wg + 3.
        const int warp = tid >> 5;  // 0-7
        const int wq = warp & 3;    // warp within the warpgroup
        const int g = lane >> 2, t2 = 2 * (lane & 3);
        // ldmatrix: lane l gives row l % 8 of matrix l / 8: pixel l % 8 (+8
        // for odd l / 8), channel chunk +1 for l / 8 >= 2.
        const int ld_px = 16 * (wq & 1) + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int ld_ck = lane >> 4;
        // stmatrix.trans of the output: lane l gives output channel row l % 8
        // of matrix l / 8 (channel block +1 for l / 8 >= 2, pixels +8 for odd).
        const int so_co = (lane & 7) + 8 * (lane >> 4);
        const int so_px = 16 * (wq & 1) + 8 * ((lane >> 3) & 1);
        // The bias of the thread's channels 8j + t2, +1, as bf16 pairs.
        uint32_t bias2[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            bias2[j] = (__float_as_uint(bias[8 * j + t2]) >> 16) | (__float_as_uint(bias[8 * j + t2 + 1]) & 0xffff0000u);
        const uint32_t w_base = smem_u32(wsm);
        float acc[2][32];
        int k = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x, ++k) {
            const int s = k & 1;  // the patch slot; the output tile after the wgmmas
            const int b = t / tiles;
            const int tile = t - b * tiles;
            const int y0 = (tile / tiles_x) * TILE_H;
            const int x0 = (tile - (tile / tiles_x) * tiles_x) * TILE_W;
            unsigned char* patch = patches + s * WC_PATCH_BYTES;
            unsigned char* out_s = patch;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int i = 0; i < 32; ++i) acc[m][i] = 0.0f;
            mbar_wait(patch_full + s, (k >> 1) & 1);
            // A fragments of a tap: ldmatrix of the patch shifted by the tap,
            // two buffers, so that tap t + 1's are loaded while tap t's
            // wgmmas run.
            uint32_t a[2][2][4][4];
            auto load_tap = [&](int tap, uint32_t(&dst)[2][4][4]) {
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int pr = 4 * wg + 2 * m + (wq >> 1) + tap / 3;
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        ldmatrix_x4(dst[m][kk], patch + patch_off(pr, ld_px + tap % 3, 2 * kk + ld_ck));
                }
            };
            load_tap(0, a[0]);
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t db = sw128_desc(w_base + tap * WC_TAP_BYTES + kk * 32, 16, 1024);
#pragma unroll
                    for (int m = 0; m < 2; ++m) wgmma_rs_m64n64(acc[m], a[tap & 1][m][kk], db);
                }
                wgmma_commit();
                if (tap < 8) {
                    wgmma_wait<1>();  // tap t - 1's wgmmas are done: its buffer is free
                    load_tap(tap + 1, a[(tap + 1) & 1]);
                }
            }
            named_barrier(4, 256);  // both warpgroups have read the patch: its slot takes the output tile
            wgmma_wait<0>();
            fence_operands(acc[0]);
            fence_operands(acc[1]);

            // Epilogue, per warpgroup. Accumulator 4j + e of block m: pixel g
            // (+8 for e >= 2) of the warp's 16, channel 8j + t2 (+1 for odd e).
            named_barrier(1 + wg, 128);  // the previous tile's reduction is read
            const int orow = 4 * wg + (wq >> 1);  // + 2m
            float st[16], sq[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) st[i] = sq[i] = 0.0f;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int gy = y0 + orow + 2 * m;
#pragma unroll
                for (int j = 0; j < 8; j += 2) {
                    uint32_t r[4];
#pragma unroll
                    for (int h = 0; h < 4; ++h) {  // matrix h: channel block j + h / 2, pixels +8 for odd h
                        const int jj = j + (h >> 1), hf = h & 1;
                        // The sum rounded to bf16, then the bf16 bias added: one
                        // rounding each.
                        r[h] = bf16x2_add(bf16x2_rn(acc[m][4 * jj + 2 * hf], acc[m][4 * jj + 2 * hf + 1]), bias2[jj]);
                        if (gy < height && x0 + 16 * (wq & 1) + g + 8 * hf < width) {
                            const float v0 = bf16_lo(r[h]), v1 = bf16_hi(r[h]);
                            st[2 * jj] += v0;
                            sq[2 * jj] += v0 * v0;
                            st[2 * jj + 1] += v1;
                            sq[2 * jj + 1] += v1 * v1;
                        }
                    }
                    stmatrix_x4_trans(out_s + (8 * j + so_co) * WC_OUT_LD + (orow + 2 * m) * (TILE_W * 2) + so_px * 2,
                                      r);
                }
            }
            // Over the warp's 8 pixel groups (lane bits 2-4): a fixed order.
#pragma unroll
            for (int i = 0; i < 16; ++i) {
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) {
                    st[i] += __shfl_xor_sync(0xffffffffu, st[i], off);
                    sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], off);
                }
            }
            if (g == 0) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        red[(warp * 2 + 0) * C + 8 * j + t2 + e] = st[2 * j + e];
                        red[(warp * 2 + 1) * C + 8 * j + t2 + e] = sq[2 * j + e];
                    }
            }
            named_barrier(1 + wg, 128);
            // One partial per (batch, tile, warpgroup): its 4 warps in order.
            if (partial != nullptr) {
                float sum = 0.0f;
#pragma unroll
                for (int w = 0; w < 4; ++w) sum += red[((4 * wg + w) * 2 + (t128 >> 6)) * C + (t128 & (C - 1))];
                partial[(((long long)b * tiles + tile) * 2 + wg) * 2 * C + t128] = sum;
            }
            // The warpgroup's 4 rows out, 8 pixels (16 bytes) per store where
            // they lie in the image and rows start 16-byte aligned.
            for (int e = t128; e < C * 4 * (TILE_W / 8); e += 128) {
                const int co = e >> 4;
                const int row = 4 * wg + ((e >> 2) & 3);
                const int seg = e & 3;
                const int oy = y0 + row, ox = x0 + 8 * seg;
                if (oy >= height || ox >= width) continue;
                const unsigned char* src = out_s + co * WC_OUT_LD + row * (TILE_W * 2) + seg * 16;
                bf16* dst = y + ((long long)b * C + co) * plane + (long long)oy * width + ox;
                if (vec) {
                    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
                } else {
                    const bf16* sv = reinterpret_cast<const bf16*>(src);
                    for (int i = 0; i < 8 && ox + i < width; ++i) dst[i] = sv[i];
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(patch_empty + s);  // the slot is read out; the producer may restage it
        }
    }
}

// x as a (W, H, 64 B) tensor map of `elem` (BFLOAT16 or FLOAT32) elements
// for the raw tiles, boxes of box_w x 10 x box_c, zeros outside.
static int encode_x_map(CUtensorMap* map, const void* x, int batch, int height, int width, CUtensorMapDataType elem,
                        int elem_bytes, int box_w, int box_c) {
    TensorMapEncodeTiled encode = tensor_map_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)height, (cuuint64_t)C * batch};
    const cuuint64_t strides[2] = {(cuuint64_t)width * elem_bytes, (cuuint64_t)height * width * elem_bytes};
    const cuuint32_t box[3] = {(cuuint32_t)box_w, PATCH_H, (cuuint32_t)box_c};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult res = encode(map, elem, 3, const_cast<void*>(x), dims, strides, box, unit,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int FORM>
static int launch_conv_wgmma(const CUtensorMap& xmap, const void* x, const void* w_t, const void* bias,
                             const void* aff, int height, int width, int tiles_x, int tiles, int total, int vec,
                             void* y, void* partial, int blocks, cudaStream_t s) {
    auto kernel = encoder_conv_wgmma_kernel<FORM>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WC_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks, WC_THREADS, WC_SMEM_BYTES, s>>>(xmap, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w_t,
                                                     (const float*)bias, (const float*)aff, height, width, tiles_x,
                                                     tiles, total, vec, (__nv_bfloat16*)y, (float*)partial);
    return (int)cudaGetLastError();
}

// The statistics: stats[b, t] = the sum over parts of partial[b, part, t]
// (t indexes [sum | sumsq] x 64; both kernels write two parts per tile),
// in double, in two launches of blocks of STATS_GROUPS x 128 threads: the
// first sums runs of STATS_RUN parts per (run, batch) into sums[b, run, t],
// the second sums the runs per batch into stats. In a block, thread t of
// group g sums entry t of its contiguous share of the rows in order, 8
// loads in flight (a warp reads 32 consecutive entries of a row, 128
// bytes), and thread t of group 0 adds the groups' sums in order: the
// same order on every run. The wrapper hands over `runs` = ceil(parts /
// STATS_RUN) and the (B, runs, 128) double buffer.
#define STATS_ENTRIES (2 * C)
#define STATS_GROUPS 8
#define STATS_THREADS (STATS_GROUPS * STATS_ENTRIES)
#define STATS_RUN 256

// The sum of rows [begin, end) of src (rows of STATS_ENTRIES), entry t of
// thread t of group 0's result; every thread of the block calls it.
template <typename T>
__device__ __forceinline__ double stats_sum(const T* __restrict__ src, int begin, int end, double* red) {
    const int t = threadIdx.x % STATS_ENTRIES;
    const int g = threadIdx.x / STATS_ENTRIES;
    const int share = (end - begin + STATS_GROUPS - 1) / STATS_GROUPS;
    const int lo = begin + g * share;
    const int hi = lo + share < end ? lo + share : end;
    double total = 0.0;
    for (int i0 = lo; i0 < hi; i0 += 8) {
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = i0 + j < hi ? src[(long long)(i0 + j) * STATS_ENTRIES + t] : T(0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (i0 + j < hi) total += (double)v[j];
    }
    red[threadIdx.x] = total;
    __syncthreads();
    double sum = 0.0;
#pragma unroll
    for (int k = 0; k < STATS_GROUPS; ++k) sum += red[k * STATS_ENTRIES + t];
    return sum;
}

__global__ void __launch_bounds__(STATS_THREADS)
encoder_stats_runs_kernel(const float* __restrict__ partial, int parts, int runs, double* __restrict__ sums) {
    __shared__ double red[STATS_THREADS];
    const int r = blockIdx.x;
    const int b = blockIdx.y;
    const int end = (r + 1) * STATS_RUN < parts ? (r + 1) * STATS_RUN : parts;
    const double sum = stats_sum(partial + (long long)b * parts * STATS_ENTRIES, r * STATS_RUN, end, red);
    if (threadIdx.x < STATS_ENTRIES) sums[((long long)b * runs + r) * STATS_ENTRIES + threadIdx.x] = sum;
}

__global__ void __launch_bounds__(STATS_THREADS)
encoder_stats_kernel(const double* __restrict__ sums, int runs, float* __restrict__ stats) {
    __shared__ double red[STATS_THREADS];
    const int b = blockIdx.x;
    const double sum = stats_sum(sums + (long long)b * runs * STATS_ENTRIES, 0, runs, red);
    if (threadIdx.x < STATS_ENTRIES) stats[b * STATS_ENTRIES + threadIdx.x] = (float)sum;
}

// x and y are fp32 (bf16 = 0: the FFMA kernel, w_t the fp32 weights as
// (Ci, 3, 3, Co), 8 x 64 tiles) or bf16 (bf16 = 1: the wgmma kernel, w_t
// the bf16 weights as (3, 3, Co, Ci), 8 x 32 tiles); either kernel runs
// `blocks` persistent blocks of `shared_bytes`, `vec` its TMA raw tile and
// 16-byte stores (the plan is ops/encoder_cuda.py `conv_plan`); bias and
// the affine rows are fp32 in either case (in bf16, values the wrapper has
// rounded to bf16). With statistics: `partial` (B, 2 tiles, 2, 64) fp32 and
// `sums` (B, stat_runs, 2, 64) double run sums, `stats` (B, 2, 64).
extern "C" int raft_encoder_conv(const void* x, const void* w_t, const void* bias, const void* aff,
                                 int form, int batch, int height, int width, void* y,
                                 void* partial, void* sums, void* stats, int bf16, int blocks, int shared_bytes,
                                 int vec, int stat_runs, void* stream) {
    if (form < FORM_NONE || form > FORM_BN) return (int)cudaErrorInvalidValue;
    if ((form != FORM_NONE) != (aff != nullptr)) return (int)cudaErrorInvalidValue;
    if ((partial == nullptr) != (stats == nullptr) || (partial == nullptr) != (sums == nullptr))
        return (int)cudaErrorInvalidValue;
    if (batch == 0 || height == 0 || width == 0) return 0;
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    const int tile_w = bf16 ? TILE_W : F_TILE_W;
    const int tiles_x = (width + tile_w - 1) / tile_w;
    const int tiles = tiles_x * ((height + TILE_H - 1) / TILE_H);
    const long long total = (long long)batch * tiles;
    if (blocks < 1 || blocks > total || total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (vec && ((width & (bf16 ? 7 : 3)) != 0 || ((uintptr_t)x & 15) != 0 || ((uintptr_t)y & 15) != 0))
        return (int)cudaErrorInvalidValue;
    if (stats != nullptr && stat_runs != (2 * tiles + STATS_RUN - 1) / STATS_RUN) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    CUtensorMap xmap;
    memset(&xmap, 0, sizeof(xmap));
    if (vec) {
        const int status = bf16 ? encode_x_map(&xmap, x, batch, height, width, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                               WC_RAW_W, C)
                                : encode_x_map(&xmap, x, batch, height, width, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                                               F_RAW_W, F_CK);
        if (status != 0) return status;
    }
    if (bf16) {
        if (shared_bytes != WC_SMEM_BYTES) return (int)cudaErrorInvalidValue;
        int status;
        if (form == FORM_IN)
            status = launch_conv_wgmma<FORM_IN>(xmap, x, w_t, bias, aff, height, width, tiles_x, tiles, (int)total, vec,
                                                y, partial, blocks, s);
        else if (form == FORM_BN)
            status = launch_conv_wgmma<FORM_BN>(xmap, x, w_t, bias, aff, height, width, tiles_x, tiles, (int)total, vec,
                                                y, partial, blocks, s);
        else
            status = launch_conv_wgmma<FORM_NONE>(xmap, x, w_t, bias, aff, height, width, tiles_x, tiles, (int)total,
                                                  vec, y, partial, blocks, s);
        if (status != 0) return status;
    } else {
        if (shared_bytes != F_SMEM_BYTES) return (int)cudaErrorInvalidValue;
        cudaError_t err = cudaFuncSetAttribute(encoder_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               F_SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        encoder_conv_kernel<<<blocks, THREADS, F_SMEM_BYTES, s>>>(
            xmap, (const float*)x, (const float*)w_t, (const float*)bias, (const float*)aff, form, height, width,
            tiles_x, tiles, (int)total, vec, (float*)y, (float*)partial);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || stats == nullptr) return (int)err;
    encoder_stats_runs_kernel<<<dim3(stat_runs, batch), STATS_THREADS, 0, s>>>((const float*)partial, 2 * tiles,
                                                                                stat_runs, (double*)sums);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    encoder_stats_kernel<<<batch, STATS_THREADS, 0, s>>>((const double*)sums, stat_runs, (float*)stats);
    return (int)cudaGetLastError();
}

extern "C" const char* raft_encoder_conv_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
