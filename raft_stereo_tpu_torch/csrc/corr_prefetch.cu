// Windowed all-level correlation-pyramid lookup for Hopper (sm_90a): the
// `prefetch_lookup` lever's entry point.
//
// Replaces the TPU kernel raft_stereo_tpu/ops/corr_pallas.py
// `_pf_lookup_kernel` (launched by `_lookup_pallas_prefetch_windowed`,
// planned by `_pf_plan`, entered through `prefetch_corr_lookup_padded`).
// Same function as the dense lookup (csrc/corr_lookup.cu) and bit for bit
// its result, since both launch one kernel: the windowed kernel of
// corr_window.cuh, whose header says what bounds it and how it is built.
// The TPU kernel shares one window of 128-lane tiles across a block of
// queries, with a plan of window starts, a predicate that every tap fits
// and the dense kernel as a fallback. None of that is carried over: every
// query owns its window of 2r+3 samples, so every tap lands inside it on
// every input.
//
// This file keeps its own entry point, library and launch counter
// (ops/corr_cuda.py "corr_prefetch_lookup[_bf16]"), so the lever's launches
// are counted apart from the main path's.
//
// Measured: the dense entry point's times (csrc/corr_lookup.cu), which
// kernel_compare.py reads in the same calls.

#include "corr_window.cuh"

extern "C" int raft_corr_prefetch(const void* coords, const void* const* level_ptrs, const int* level_widths,
                                  int num_levels, long long n_queries, int radius, void* out, int level_bf16,
                                  int out_bf16, int path, int run, int stages, int slot_bytes, int blocks,
                                  int shared_bytes, void* stream) {
    return corr_window_entry(coords, level_ptrs, level_widths, num_levels, n_queries, radius, out, level_bf16,
                             out_bf16, path, run, stages, slot_bytes, blocks, shared_bytes, stream);
}

extern "C" const char* raft_corr_prefetch_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
