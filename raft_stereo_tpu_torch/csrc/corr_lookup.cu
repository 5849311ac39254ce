// Fused all-level correlation-pyramid lookup for Hopper (sm_90a): the dense
// entry point, the main path's lookup (every "pallas" / reg_cuda forward
// and, through ops/corr_cuda.py `CorrLookup`, every training forward).
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py `_lookup_kernel`
// (launched by `_lookup_pallas_padded`, the forward of
// `pallas_corr_lookup_padded`). Same function: for every query q = (b, h, w1)
// and level l, with x = coords[q] / 2**l, the 2r+1 taps t = x - r .. x + r
// are each the linear interpolation between samples floor(t) and floor(t)+1
// of the query's own row of level l; a sample outside [0, W2_l) is zero.
// Out (B, H, W1, L*(2r+1)), level-major, fp32 or bf16 levels and taps in
// any of the four pairs, as the JAX kernel takes them. The TPU kernel
// needed the levels padded to 128 lanes for its zero rule; here the levels
// are unpadded and the rule is a bounds test done in float before any
// address is formed.
//
// What bounds it on the H100: bytes, in 32-byte sectors, and the launch
// runs the windowed kernel of corr_window.cuh, which says why and how: per
// query and level a window of 2r+3 samples fetched as 16-byte chunks into a
// per-warp cp.async ring, runs of consecutive queries in flight while the
// previous run's taps are formed from registers, each run's outputs
// written as 16-byte stores, persistent blocks sized from the card's
// multiprocessor count (ops/corr_cuda.py `prefetch_plan`, passed in by the
// wrapper). The windowed entry point (csrc/corr_prefetch.cu) launches the
// same kernel; this file keeps its own entry point, library and launch
// counter ("corr_lookup[_bf16]"), and the PERF.md table keeps its own row.
// What the design cannot fix, and what would: corr_window.cuh's header.
//
// Measured (kernel_compare.py, H100 80GB HBM3, 700.00 W), alone on the
// device (torch.profiler, L2 flushed before each call): at Middlebury-F's
// 1/4 (496 x 720 queries, W2 720) 0.0780-0.0792 ms in fp32 and
// 0.0668-0.0676 with bf16 levels and taps, against 0.0395 and 0.0257 at
// 32-byte sectors (50% and 38% of them); at the 512x768 bucket's 1/4
// 0.0090-0.0091 and 0.0079; at the bf16 training step's 4 x 80 x 180
// (W2 180) 0.0171-0.0175 and 0.0149-0.0155. ptxas: 47-67 registers, no
// stack frame.

#include "corr_window.cuh"

extern "C" int raft_corr_lookup(const void* coords, const void* const* level_ptrs, const int* level_widths,
                                int num_levels, long long n_queries, int radius, void* out, int level_bf16,
                                int out_bf16, int path, int run, int stages, int slot_bytes, int blocks,
                                int shared_bytes, void* stream) {
    return corr_window_entry(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, level_bf16,
                             out_bf16, path, run, stages, slot_bytes, blocks, shared_bytes, stream);
}

extern "C" const char* raft_corr_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
