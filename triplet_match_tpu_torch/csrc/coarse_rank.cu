// Coarse 4-D hit-count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B1: triplet_match_tpu/search/score_pallas.py:_coarse_kernel
// (wrapper score_groups_coarse).  The device code, its arithmetic, design and
// bound are in coarse_rank.cuh, which coarse_linear_rank.cu (TPU kernel B4)
// shares; this file instantiates B1's operand build from the pose's rotation
// and translation.  At the main path's shapes phase 1 is 256 groups x 512
// poses x 64 points x 256 reps = 2.1 G (pose, point, rep) evaluations.

#include "coarse_rank.cuh"

// Launch on `stream`.  groups [g, 8, k], poses [g, hg, 16] (centre-shifted,
// kernel row layout), block [8, nc], out [g, hg]; all float32, contiguous, on
// the device.  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t coarse_rank_launch(const void* groups, const void* poses,
                                          const void* block, void* out, int g, int hg, int k,
                                          int nc, float t2, float off, float t2s, float w_inf,
                                          float w_str, void* stream) {
  return coarse_rank::launch<false>(groups, poses, block, out, g, hg, k, nc, t2, off, t2s, w_inf,
                                    w_str, stream);
}

extern "C" const char* coarse_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
