// Coarse 4-D hit-count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B1: triplet_match_tpu/search/score_pallas.py:_coarse_kernel
// (wrapper score_groups_coarse).  The device code, its arithmetic, design and
// bound are in coarse_rank.cuh, which coarse_linear_rank.cu (TPU kernel B4)
// shares; this file instantiates B1's operand build from the pose's rotation
// and translation.  At the main path's shapes phase 1 is 256 groups x 512
// poses x 64 points against 128 + 128 own-kind representatives.

#include "coarse_rank.cuh"

// Launch on `stream`.  groups [g, 8, k], poses [g, hg, 16] (poses_to_rows
// layout, not centre-shifted), block [8, ld] of which the first n_reps columns
// are real representatives, edge ones first (n_edge of them), out [g, hg]; all
// float32, contiguous, on the device; (cx, cy, cz) the model centre.  A
// non-zero `cross` also sweeps the other kind's representatives (for gates at
// or above off^2).  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t coarse_rank_launch(const void* groups, const void* poses,
                                          const void* block, void* out, int g, int hg, int k,
                                          int ld, int n_edge, int n_reps, float cx, float cy,
                                          float cz, float t2, float off, float t2s, float w_inf,
                                          float w_str, int cross, void* stream) {
  return coarse_rank::launch<false>(groups, poses, block, out, g, hg, k, ld, n_edge, n_reps, cx,
                                    cy, cz, t2, off, t2s, w_inf, w_str, cross, stream);
}

extern "C" const char* coarse_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
