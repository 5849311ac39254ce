// The windowed all-level correlation-pyramid lookup for Hopper (sm_90a),
// shared by the two lookup entry points: the dense one (csrc/corr_lookup.cu,
// `raft_corr_lookup`, the main path's lookup and the training forward's)
// and the windowed one (csrc/corr_prefetch.cu, `raft_corr_prefetch`, the
// `prefetch_lookup` lever). Each file includes this header and keeps its
// own C entry point, launch counter and library; the device code is one.
//
// The function: for every query q = (b, h, w1) and level l, with
// x = coords[q] / 2**l, the 2r+1 taps t = x - r .. x + r are each the
// linear interpolation between samples floor(t) and floor(t)+1 of the
// query's own row of level l; a sample outside [0, W2_l) is zero, where
// W2_l is the level's true width. Out (B, H, W1, L*(2r+1)), level-major.
// The levels are fp32 or bf16 and the taps fp32 or bf16, in any of the four
// pairs: a sample is widened to fp32 when a tap reads it, the interpolation
// is fp32, and a tap is rounded once to its dtype (round to nearest even),
// as the plain PyTorch version (ops/corr.py `corr_lookup`, then one cast)
// computes it.
//
// What bounds it on the H100: bytes, and the sectors they come in. Per
// query and level the taps need the 2r+3 samples [floor(x) - r,
// floor(x) + r + 2] (44 bytes at r = 4 in fp32, 22 in bf16; the extra
// sample is explained below) and write 2r+1 outputs. There is one
// multiply-add per output, far below the card's operations-per-byte
// balance point.
//
// Design. Every query owns its window. The window holds 2r+3 samples, one
// more than the 2r+2 that floor(x)'s taps touch: a tap's t = x + (k - r) is
// rounded, and fl(x + n) can reach floor(x) + n + 1 when x lies within half
// an ulp below an integer, so floor(t) is floor(x) + n or one more (the
// rounding is monotone and floor(x) + n is representable). With that
// sample every tap lands inside its window by construction: exact on every
// input, with no plan of windows and no fallback.
//
// The work is cut into runs of consecutive queries, one run per warp at a
// time: 8 queries at r = 4 with 4 levels, 32 (query, level) pairs, one per
// lane. Persistent blocks of 8 warps (grid from the card's multiprocessor
// count, ops/corr_cuda.py `prefetch_plan`) walk the runs, warp w taking
// runs w, w + warps, ... Each warp keeps a ring of 2-3 stages in shared
// memory and issues run i+1's (and i+2's) window copies before it forms
// run i's taps, so loads stay in flight while it computes:
//   - a window is fetched as the aligned 16-byte chunks that cover it (at
//     most 4 in fp32, 3 in bf16), one lane per chunk, so a warp instruction
//     fetches the chunks of 8 windows, with `cp.async` in the levels' own
//     dtype; chunks are counted from the level's base (16-byte aligned on
//     this path), so rows that do not start on a 16-byte boundary cost
//     nothing, a chunk past the level's last element is read only up to it
//     (the copy's source size), a chunk before its first is not read, and a
//     window that misses the row (far-out, infinite and NaN coordinates,
//     tested in float before any address is formed) reads nothing;
//   - the run's coordinates are loaded two runs ahead, by the lanes, and
//     staged with the run;
//   - a lane forms its pair's 2r+1 taps from its window slot: with r = 4
//     and 4 levels (the usual configuration, compile-time), it reads the
//     slot as 16-byte vectors, shifts out the window's place in its first
//     chunk by selects and keeps the 2r+3 samples in registers with static
//     indices; tap k's left sample is window entry k or k + 1, chosen by a
//     predicate (a runtime index into a register array would move the
//     array to local memory). Other radii and level counts take the generic
//     instantiation, which reads each sample from the slot;
//   - the run's outputs are one contiguous span (its queries' L*(2r+1)
//     taps each), staged in shared memory and written with 16-byte stores;
//     the plan's run length keeps every span 16-byte aligned where one
//     can, and a span's partial first and last chunks go element by
//     element.
// A level that is a view at an unaligned offset takes the element path
// (the plan's choice): the same runs and coalesced stores, each sample
// loaded from device memory by its tap. Row offsets are 64-bit on every
// path: a batch of Middlebury-F images passes 2**31 elements in its first
// level.
//
// What this design cannot fix: consecutive queries read different rows of
// the volume (query q's row of level l starts q * W2_l elements in), so no
// two windows share a 32-byte sector: a 44-byte fp32 window costs 2 or 3
// sectors, each in its own DRAM row, and at Middlebury-F every one comes
// from device memory (the levels take 1.9 GB in fp32). The kernel sits at
// about 50% of that sector bound there. Going past it needs another level
// layout, one in which neighbouring queries' windows are neighbours in
// memory (a level indexed by disparity), and that layout reaches the
// pyramid build and the scatter backward too.
//
// Rounding: x / 2**l is taken as x * 2**-l, one correctly rounded product
// of the same value as an IEEE division; floorf matches torch.floor, and
// the libraries are compiled with -fmad=false, so tap0*(1-f) + tap1*f is
// rounded exactly as the plain PyTorch version rounds it.
//
// The kernel and its helpers have internal linkage (an unnamed namespace):
// the two libraries that include this header each carry their own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

#define MAX_LEVELS 8
#define WARPS 8                // warps per block
#define THREADS (32 * WARPS)
#define BLOCKS_PER_SM 3        // ops/corr_cuda.py PREFETCH_BLOCKS_PER_SM
#define COORD_BYTES 128        // a stage's coordinates: up to 32 queries
#define USUAL_RADIUS 4
#define USUAL_LEVELS 4

#define PATH_USUAL 0    // compile-time radius 4 and 4 levels, staged windows
#define PATH_GENERIC 1  // any radius and level count, staged windows
#define PATH_ELEMENT 2  // any, each sample loaded by its tap (unaligned levels)

namespace {

template <typename TL>
struct LevelTable {
    const TL* ptr[MAX_LEVELS];
    int width[MAX_LEVELS];
};

// Select level l's base and width with static indices: indexing the
// by-value table with the runtime `l` would copy it to local memory in
// every thread.
template <typename TL>
__device__ __forceinline__ void select_level(const LevelTable<TL>& levels, int l, const TL*& base, int& w2) {
    base = levels.ptr[0];
    w2 = levels.width[0];
#pragma unroll
    for (int j = 1; j < MAX_LEVELS; ++j) {
        if (j == l) {
            base = levels.ptr[j];
            w2 = levels.width[j];
        }
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 bytes from device to shared memory, of which the first `src_bytes`
// are read and the rest are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The window of one (query, level): x = coord / 2**l, its first sample
// start = floor(x) - r; `any`: one of its 2r+3 samples lies in the row,
// tested in float before any address is formed; e0: the element index of
// sample `start` from the level's base (64-bit, negative for row 0 when
// start < 0), and `phase` its place in its 16-byte chunk of V elements.
struct Window {
    float x, start;
    bool any;
    long long e0;
    int phase;
};

// 2**-l: x * 2**-l is x / 2**l rounded once, as an exact IEEE
// division rounds it (denormals are kept), in one instruction.
__device__ __forceinline__ float inv_pow2(int l) { return __int_as_float((127 - l) << 23); }

template <int V>
__device__ __forceinline__ Window window_of(float coord, int l, int w2, long long q, int radius) {
    Window win;
    win.x = coord * inv_pow2(l);
    win.start = floorf(win.x) - (float)radius;
    win.any = win.start <= (float)(w2 - 1) && win.start + (float)(2 * radius + 2) >= 0.0f;
    win.e0 = win.any ? q * w2 + (long long)(int)win.start : 0;
    win.phase = (int)(win.e0 & (V - 1));
    return win;
}

// The N window samples of a slot, widened to fp32, w[m] = sample start + m:
// the slot's chunks read as 16-byte vectors, the window's phase in the
// first chunk shifted out by selects on its bits, every register index
// static. CH: the chunks N samples can span, the slot's fill.
template <typename TL, int N>
struct SlotWindow;

template <int N>
struct SlotWindow<float, N> {
    static constexpr int CH = (N + 2) / 4 + 1;
    static __device__ __forceinline__ void read(const unsigned char* slot, int phase, float (&w)[N]) {
        float r[4 * CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const float4 v = reinterpret_cast<const float4*>(slot)[c];
            r[4 * c] = v.x; r[4 * c + 1] = v.y; r[4 * c + 2] = v.z; r[4 * c + 3] = v.w;
        }
        float s[N + 2];
#pragma unroll
        for (int j = 0; j < N + 2; ++j) s[j] = (phase & 1) ? r[j + 1] : r[j];
#pragma unroll
        for (int m = 0; m < N; ++m) w[m] = (phase & 2) ? s[m + 2] : s[m];
    }
};

template <int N>
struct SlotWindow<__nv_bfloat16, N> {
    static constexpr int CH = (N + 6) / 8 + 1;
    static __device__ __forceinline__ void read(const unsigned char* slot, int phase, float (&w)[N]) {
        constexpr int NW = (N + 1) / 2;  // words of the shifted window
        uint32_t u[4 * CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const uint4 v = reinterpret_cast<const uint4*>(slot)[c];
            u[4 * c] = v.x; u[4 * c + 1] = v.y; u[4 * c + 2] = v.z; u[4 * c + 3] = v.w;
        }
        // Words by phase / 2 (two selects), then bf16 halves by phase % 2.
        uint32_t a[NW + 3], b[NW + 1];
#pragma unroll
        for (int j = 0; j < NW + 3; ++j) a[j] = (phase & 2) ? u[j + 1] : u[j];
#pragma unroll
        for (int j = 0; j < NW + 1; ++j) b[j] = (phase & 4) ? a[j + 2] : a[j];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            const uint32_t c = (phase & 1) ? __funnelshift_r(b[j], b[j + 1], 16) : b[j];
            w[2 * j] = bf16_lo(c);
            if (2 * j + 1 < N) w[2 * j + 1] = bf16_hi(c);
        }
    }
};

// The run's outputs from the warp's staging buffer to out[dst, dst + span):
// the staging holds them from element `ph` on, where dst lies `ph`
// elements past a 16-byte boundary, so staging and destination agree
// modulo 16 bytes; whole 16-byte chunks go as vectors, the span's partial
// first and last chunks element by element.
template <typename TO>
__device__ __forceinline__ void copy_out(const TO* stage, TO* dst, int ph, int span, int lane) {
    constexpr int V = kVec16<TO>;
    const int chunks = (ph + span + V - 1) / V;
    TO* base = reinterpret_cast<TO*>(reinterpret_cast<uintptr_t>(dst) - (uintptr_t)ph * sizeof(TO));
    for (int c = lane; c < chunks; c += 32) {
        const int e0 = c * V;
        if (e0 >= ph && e0 + V <= ph + span) {
            reinterpret_cast<uint4*>(base)[c] = reinterpret_cast<const uint4*>(stage)[c];
        } else {
            const int lo = e0 > ph ? e0 : ph, hi = e0 + V < ph + span ? e0 + V : ph + span;
            for (int e = lo; e < hi; ++e) base[e] = stage[e];
        }
    }
}

// R, L: compile-time radius and level count (PATH_USUAL), 0 for runtime.
// A warp's shared memory: `stages` stages of [the run's coordinates
// (COORD_BYTES) | 32 window slots of `slot_bytes`], then the output staging
// of `out_stage_bytes`.
template <typename TL, typename TO, int R, int L, int PATH>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
corr_window_kernel(const float* __restrict__ coords, LevelTable<TL> levels, int num_levels, int radius,
                   long long n_queries, int run_arg, int stages, int slot_bytes, int out_stage_bytes,
                   TO* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int V = kVec16<TL>;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int r = R ? R : radius;
    const int nl = L ? L : num_levels;
    const int taps = 2 * r + 1;
    const int n = 2 * r + 3;  // window samples
    const int run = PATH == PATH_USUAL ? 32 / USUAL_LEVELS : run_arg;
    const int pairs = run * nl;  // (query, level) pairs of a run: at most 32
    const int per_query = nl * taps;
    const int ch = (n + V - 2) / V + 1;  // chunks a window can span
    const int stage_bytes = COORD_BYTES + (PATH == PATH_ELEMENT ? 0 : 32 * slot_bytes);
    unsigned char* wsm = smem + (size_t)warp * (stages * stage_bytes + out_stage_bytes);
    TO* ostage = reinterpret_cast<TO*>(wsm + stages * stage_bytes);
    const long long n_runs = (n_queries + run - 1) / run;
    const long long warps_total = (long long)gridDim.x * WARPS;
    const long long first = (long long)blockIdx.x * WARPS + warp;

    // This lane forms the taps of pair `lane`: query lane / L, level lane % L.
    const int tq = lane / nl;
    const int tl = lane - tq * nl;
    const TL* tbase;
    int tw2;
    select_level(levels, tl, tbase, tw2);

    // The usual path's copying lanes: level (lane / 4) % 4 for every run.
    const int ll_l = (lane >> 2) & 3;
    const TL* ll_base;
    int ll_w2;
    select_level(levels, ll_l, ll_base, ll_w2);
    const long long ll_total = n_queries * ll_w2;

    // Run i of this warp's walk (global index; past n_runs: nothing to do).
    auto run_index = [&](int i) { return first + (long long)i * warps_total; };
    // Lane j < run: the coordinate of query j of run i.
    auto load_coord = [&](int i) -> float {
        const long long q = run_index(i) * run + lane;
        return lane < run && q < n_queries ? coords[q] : 0.0f;
    };
    // Stage run i's coordinates and issue its window copies (one commit group).
    auto issue = [&](int i, float c) {
        const long long q0 = run_index(i) * run;
        unsigned char* st = wsm + (i % stages) * stage_bytes;
        float* sc = reinterpret_cast<float*>(st);
        if (lane < run) sc[lane] = c;
        __syncwarp();
        if (PATH == PATH_USUAL && q0 < n_queries) {
            // Chunk j = lane % 4 of level (lane / 4) % 4 for queries lane / 16
            // + 2i: the lane's level is fixed, so its base, width and element
            // count are the hoisted `ll_*`; 8 lanes a warp instruction are
            // the chunks of 2 windows of each of 4 levels.
            const int j = lane & 3;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int ql = (lane >> 4) + 2 * i;
                const long long q = q0 + ql;
                if (q >= n_queries) continue;
                const Window win = window_of<V>(sc[ql], ll_l, ll_w2, q, USUAL_RADIUS);
                if (!win.any || j > (win.phase + n - 1) / V) continue;
                const long long c = (win.e0 - win.phase) / V + j;
                const long long avail = ll_total - c * V;
                if (c < 0 || avail <= 0) continue;
                cp_async16(st + COORD_BYTES + (ql * USUAL_LEVELS + ll_l) * slot_bytes + 16 * j, ll_base + c * V,
                           (int)(avail < V ? avail : V) * (int)sizeof(TL));
            }
        } else if (PATH == PATH_GENERIC && q0 < n_queries) {
            for (int s = lane; s < pairs * ch; s += 32) {
                const int pair = s / ch;
                const int j = s - pair * ch;
                const int ql = pair / nl;
                const int l = pair - ql * nl;
                const long long q = q0 + ql;
                if (q >= n_queries) continue;
                const TL* base;
                int w2;
                select_level(levels, l, base, w2);
                const Window win = window_of<V>(sc[ql], l, w2, q, r);
                if (!win.any || j > (win.phase + n - 1) / V) continue;
                const long long c = (win.e0 - win.phase) / V + j;  // chunk index from the level's base
                const long long avail = n_queries * w2 - c * V;     // elements of the level from the chunk on
                if (c < 0 || avail <= 0) continue;
                cp_async16(st + COORD_BYTES + pair * slot_bytes + 16 * j, base + c * V,
                           (int)(avail < V ? avail : V) * (int)sizeof(TL));
            }
        }
        cp_async_commit();
    };

    // Prologue: the first stages - 1 runs in flight, the next coordinate loaded.
    float c_next = load_coord(0);
    for (int i = 0; i < stages - 1; ++i) {
        const float c = c_next;
        c_next = load_coord(i + 1);
        issue(i, c);
    }
    for (int i = 0; run_index(i) < n_runs; ++i) {
        {
            const float c = c_next;
            c_next = load_coord(i + stages);
            issue(i + stages - 1, c);
        }
        if (stages == 3) cp_async_wait<2>();
        else if (stages == 2) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncwarp();  // every lane's copies of run i have landed

        const long long q0 = run_index(i) * run;
        const unsigned char* st = wsm + (i % stages) * stage_bytes;
        const long long left = n_queries - q0;
        const int nq = left < run ? (int)left : run;
        TO* dst = out + q0 * per_query;
        const int ph = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(TO));
        if (lane < pairs && tq < nq) {
            const long long q = q0 + tq;
            const Window win = window_of<V>(reinterpret_cast<const float*>(st)[tq], tl, tw2, q, r);
            TO* o = ostage + ph + lane * taps;
            const float hi_f = (float)(tw2 - 1);
            if constexpr (PATH == PATH_USUAL) {
                constexpr int NS = 2 * USUAL_RADIUS + 3;
                float w[NS];
                SlotWindow<TL, NS>::read(st + COORD_BYTES + lane * slot_bytes, win.phase, w);
#pragma unroll
                for (int k = 0; k < 2 * USUAL_RADIUS + 1; ++k) {
                    const float t = win.x + (float)(k - USUAL_RADIUS);
                    const float x0f = floorf(t);
                    const float frac = t - x0f;
                    // Window entry of sample x0f: k, or k + 1 (see the note
                    // at the top) whenever x0f is in the row.
                    const bool pick = x0f > win.start + (float)k;
                    const float v0 = x0f >= 0.0f && x0f <= hi_f ? (pick ? w[k + 1] : w[k]) : 0.0f;
                    const float v1 = x0f + 1.0f >= 0.0f && x0f + 1.0f <= hi_f ? (pick ? w[k + 2] : w[k + 1]) : 0.0f;
                    Elem<TO>::store(o + k, v0 * (1.0f - frac) + v1 * frac);
                }
            } else {
                const TL* slot = reinterpret_cast<const TL*>(st + COORD_BYTES + lane * slot_bytes) + win.phase;
                const TL* row = tbase + q * tw2;
                for (int k = 0; k < taps; ++k) {
                    const float t = win.x + (float)(k - r);
                    const float x0f = floorf(t);
                    const float frac = t - x0f;
                    float v0 = 0.0f, v1 = 0.0f;
                    if (PATH == PATH_ELEMENT) {
                        if (x0f >= 0.0f && x0f <= hi_f) v0 = Elem<TL>::load(row + (int)x0f);
                        if (x0f + 1.0f >= 0.0f && x0f + 1.0f <= hi_f) v1 = Elem<TL>::load(row + (int)x0f + 1);
                    } else {
                        // Window entry of sample x0f: x0f - start, k or k + 1.
                        if (x0f >= 0.0f && x0f <= hi_f) v0 = Elem<TL>::load(slot + (int)(x0f - win.start));
                        if (x0f + 1.0f >= 0.0f && x0f + 1.0f <= hi_f)
                            v1 = Elem<TL>::load(slot + (int)(x0f - win.start) + 1);
                    }
                    Elem<TO>::store(o + k, v0 * (1.0f - frac) + v1 * frac);
                }
            }
        }
        __syncwarp();
        copy_out(ostage, dst, ph, nq * per_query, lane);
        __syncwarp();  // the staging is read out before the next run's taps
    }
}

// One stage: the run's coordinates, then 32 window slots (none on the
// element path); the output staging: the run's taps plus one 16-byte
// chunk of room for the span's phase, rounded to 16 bytes. Mirrored by
// ops/corr_cuda.py `prefetch_shared_bytes`.
long long warp_bytes(int path, int run, int levels, int radius, int out_size, int stages, int slot_bytes) {
    const long long stage = COORD_BYTES + (path == PATH_ELEMENT ? 0 : 32LL * slot_bytes);
    const long long ostage = ((long long)run * levels * (2 * radius + 1) * out_size + 16 + 15) / 16 * 16;
    return stages * stage + ostage;
}

template <typename TL, typename TO>
int corr_window_launch(const void* coords, const void* const* level_ptrs, const int* level_widths, int num_levels,
                       long long n_queries, int radius, void* out, int path, int run, int stages, int slot_bytes,
                       int blocks, int shared_bytes, void* stream) {
    LevelTable<TL> table;
    for (int l = 0; l < MAX_LEVELS; ++l) {
        table.ptr[l] = l < num_levels ? (const TL*)level_ptrs[l] : nullptr;
        table.width[l] = l < num_levels ? level_widths[l] : 0;
    }
    if (n_queries == 0) return 0;
    // The plan (ops/corr_cuda.py `prefetch_plan`) is checked, not corrected:
    // a launch it did not describe is refused.
    constexpr int V = kVec16<TL>;
    const int n = 2 * radius + 3;
    const int ch = (n + V - 2) / V + 1;
    if (path == PATH_USUAL && (radius != USUAL_RADIUS || num_levels != USUAL_LEVELS || run != 32 / USUAL_LEVELS))
        return (int)cudaErrorInvalidValue;
    if (run < 1 || run * num_levels > 32 || stages < 1 || stages > 3 || blocks < 1) return (int)cudaErrorInvalidValue;
    if (path != PATH_ELEMENT) {
        if (slot_bytes < 16 * ch || slot_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
        for (int l = 0; l < num_levels; ++l)
            if (((uintptr_t)level_ptrs[l] & 15) != 0) return (int)cudaErrorInvalidValue;
    }
    if ((long long)shared_bytes != WARPS * warp_bytes(path, run, num_levels, radius, (int)sizeof(TO), stages,
                                                      slot_bytes))
        return (int)cudaErrorInvalidValue;
    void (*kernel)(const float*, LevelTable<TL>, int, int, long long, int, int, int, int, TO*) =
        path == PATH_USUAL     ? corr_window_kernel<TL, TO, USUAL_RADIUS, USUAL_LEVELS, PATH_USUAL>
        : path == PATH_GENERIC ? corr_window_kernel<TL, TO, 0, 0, PATH_GENERIC>
                               : corr_window_kernel<TL, TO, 0, 0, PATH_ELEMENT>;
    // The kernel's dynamic shared-memory limit, raised once per device and
    // path: a runtime call on every launch would add host time to a short
    // kernel.
    static int raised[64][3];
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device >= 64) return (int)cudaErrorInvalidDevice;
    if (shared_bytes > raised[device][path]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
        if (err != cudaSuccess) return (int)err;
        raised[device][path] = shared_bytes;
    }
    const int out_stage = (int)warp_bytes(path, run, num_levels, radius, (int)sizeof(TO), 0, slot_bytes);
    kernel<<<blocks, THREADS, shared_bytes, (cudaStream_t)stream>>>((const float*)coords, table, num_levels, radius,
                                                                    n_queries, run, stages, slot_bytes, out_stage,
                                                                    (TO*)out);
    return (int)cudaGetLastError();
}

// A C entry point's body: coords fp32; the levels fp32 (level_bf16 = 0) or
// bf16 (1); the taps fp32 (out_bf16 = 0) or bf16 (1); the plan
// (ops/corr_cuda.py `prefetch_plan`): path, queries per run, ring stages,
// window slot bytes, persistent blocks, shared bytes per block.
int corr_window_entry(const void* coords, const void* const* level_ptrs, const int* level_widths, int num_levels,
                      long long n_queries, int radius, void* out, int level_bf16, int out_bf16, int path, int run,
                      int stages, int slot_bytes, int blocks, int shared_bytes, void* stream) {
    if (num_levels < 1 || num_levels > MAX_LEVELS || radius < 0 || path < PATH_USUAL || path > PATH_ELEMENT)
        return (int)cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
#define RAFT_WINDOW_LAUNCH(TL, TO)                                                                             \
    corr_window_launch<TL, TO>(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, path, run, \
                               stages, slot_bytes, blocks, shared_bytes, stream)
    if (level_bf16 && out_bf16) return RAFT_WINDOW_LAUNCH(bf16, bf16);
    if (level_bf16) return RAFT_WINDOW_LAUNCH(bf16, float);
    if (out_bf16) return RAFT_WINDOW_LAUNCH(float, bf16);
    return RAFT_WINDOW_LAUNCH(float, float);
#undef RAFT_WINDOW_LAUNCH
}

}  // namespace
