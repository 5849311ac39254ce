// Hopper (sm_90a) building blocks of the bf16 pyramid build
// (csrc/corr_pyramid.cu) and the bf16 layer1 conv (csrc/encoder_conv.cu):
// mbarriers, TMA tensor loads and their host-side tensor maps, wgmma with
// its shared-memory matrix descriptors, stmatrix and named barriers.
//
// wgmma names its accumulators one by one in the instruction, so each tile
// width N is its own function below: the register lists are spliced from
// the WG_R* strings and WG_O* operand lists (blocks of eight).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---- shared memory, barriers ------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads, before the block's first __syncthreads.
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// Returns once the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: waiting on parity 1 returns at once). The waits here last
// microseconds; one that has not completed in 10 s means a broken pipeline,
// and the kernel traps (a launch error) rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done;
    uint64_t start = 0;
    for (;;) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
        if (done) return;
        if (start == 0) start = global_ns();
        else if (global_ns() - start > 10000000000ull) __trap();
    }
}

// A barrier among `threads` threads of the block (whole warps), id 1-15.
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory become visible to the async proxy
// (wgmma's operand reads, TMA).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---- TMA ----------------------------------------------------------------------

// One box of a 3- or 4-dimensional tensor map into shared memory; its
// bytes complete the barrier's transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
        "[%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                         const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                         CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point lookup
// (cudaGetDriverEntryPoint), so the library needs no -lcuda. Null if the
// lookup finds none.
static TensorMapEncodeTiled tensor_map_encoder() {
    static TensorMapEncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                           &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (TensorMapEncodeTiled)p;
    }
    return fn;
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wgmma_wait: the accumulators are read (or rewritten) only after
// this point, which the compiler cannot see from the wait alone.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor with 128-byte swizzling (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
// Every operand tile here starts on a 1024-byte swizzle atom, so the base
// offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
           ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

#define WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_R3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_R5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_R6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_R7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_R8 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define WG_R9 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define WG_R10 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define WG_R11 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define WG_R12 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define WG_R13 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define WG_R14 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define WG_R15 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define WG_REGS32 WG_R0 WG_R1 WG_R2 WG_R3
#define WG_REGS48 WG_REGS32 WG_R4 WG_R5
#define WG_REGS64 WG_REGS48 WG_R6 WG_R7
#define WG_REGS80 WG_REGS64 WG_R8 WG_R9
#define WG_REGS96 WG_REGS80 WG_R10 WG_R11
#define WG_REGS120 WG_REGS96 WG_R12 WG_R13 WG_R14
#define WG_REGS128 WG_REGS120 WG_R15

#define WG_O(i) "+f"(d[i])
#define WG_O8(i) WG_O(i), WG_O(i + 1), WG_O(i + 2), WG_O(i + 3), WG_O(i + 4), WG_O(i + 5), WG_O(i + 6), WG_O(i + 7)
#define WG_OPS32 WG_O8(0), WG_O8(8), WG_O8(16), WG_O8(24)
#define WG_OPS48 WG_OPS32, WG_O8(32), WG_O8(40)
#define WG_OPS64 WG_OPS48, WG_O8(48), WG_O8(56)
#define WG_OPS80 WG_OPS64, WG_O8(64), WG_O8(72)
#define WG_OPS96 WG_OPS80, WG_O8(80), WG_O8(88)
#define WG_OPS120 WG_OPS96, WG_O8(96), WG_O8(104), WG_O8(112)
#define WG_OPS128 WG_OPS120, WG_O8(120)

// d (64 x N, fp32) = A (64 x 16) B (16 x N) + (scale_d ? d : 0), bf16
// operands from shared memory, both MN-major (the transpose flags: W is
// their unit-stride axis). d's register j holds, in warp w and lane l of
// the warpgroup, row 16 w + l / 4 (+8 for j % 4 >= 2), column 8 (j / 4) +
// 2 (l % 4) (+1 for odd j).
template <int N>
struct WgmmaSS;

#define RAFT_WGMMA_SS(N, R, REGS, OPS, DA, DB, SC)                                                             \
    template <>                                                                                                \
    struct WgmmaSS<N> {                                                                                        \
        static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {     \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                                       \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " DA ", " DB    \
                         ", p, 1, 1, 1, 1;\n}\n"                                                               \
                         : OPS                                                                                 \
                         : "l"(da), "l"(db), "r"(scale_d));                                                    \
        }                                                                                                      \
    };

RAFT_WGMMA_SS(64, 32, WG_REGS32, WG_OPS32, "%32", "%33", "%34")
RAFT_WGMMA_SS(96, 48, WG_REGS48, WG_OPS48, "%48", "%49", "%50")
RAFT_WGMMA_SS(128, 64, WG_REGS64, WG_OPS64, "%64", "%65", "%66")
RAFT_WGMMA_SS(160, 80, WG_REGS80, WG_OPS80, "%80", "%81", "%82")
RAFT_WGMMA_SS(192, 96, WG_REGS96, WG_OPS96, "%96", "%97", "%98")
RAFT_WGMMA_SS(240, 120, WG_REGS120, WG_OPS120, "%120", "%121", "%122")
RAFT_WGMMA_SS(256, 128, WG_REGS128, WG_OPS128, "%128", "%129", "%130")
#undef RAFT_WGMMA_SS

// d (64 x 64, fp32) += A (64 x 16, bf16, from registers: each warp's 16
// rows in mma.m16n8k16's A fragment) B (16 x 64, bf16, K-major in shared
// memory); d's layout as above.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_REGS32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, "
        "0;\n}\n"
        : WG_OPS32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- packed bf16 arithmetic -------------------------------------------------
//
// Pairs of bf16 values in 32-bit words, the lower one in the low half
// (dtype.cuh bf16_pack's layout), each op rounded once to nearest even.
// For bf16 operands these are the values of the fp32 op followed by one
// rounding to bf16, as the plain PyTorch version computes them: a product
// of two bf16 values is exact in fp32, and so is a sum or difference
// whose exponents differ by at most 15 (otherwise the smaller operand is
// below half an ulp of the result either way).

// Two floats rounded to bf16 in one instruction.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}
// relu of both halves: max(x, +0), as fmaxf(x, 0.0f) takes it.
__device__ __forceinline__ uint32_t bf16x2_relu(uint32_t a) {
    uint32_t d;
    asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
    return d;
}
// A float that holds a bf16 value, as both halves of a word.
__device__ __forceinline__ uint32_t bf16x2_splat(float v) { return (__float_as_uint(v) >> 16) * 0x10001u; }

// ---- register <-> shared-memory tiles ---------------------------------------------

// Four 8x8 bf16 matrices out of the registers: lanes 8i .. 8i+7 give the
// addresses of matrix i's eight 16-byte rows; register i of lane l holds
// the pair (row l / 4, columns 2 (l % 4), +1) of matrix i.
__device__ __forceinline__ void stmatrix_x4(void* p, const uint32_t (&r)[4]) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "r"(r[0]),
                 "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
}

// The same, each matrix transposed: row j at lane 8i + j's address holds
// column j of the registers' matrix i.
__device__ __forceinline__ void stmatrix_x4_trans(void* p, const uint32_t (&r)[4]) {
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)),
                 "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// Register budget of a warp-specialised block: the producer warpgroup
// gives registers back, the consumers take them.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
