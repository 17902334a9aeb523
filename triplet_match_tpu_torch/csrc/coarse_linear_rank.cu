// Pose-linearised coarse 4-D hit-count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B4: triplet_match_tpu/search/score_pallas.py:_coarse_linear_kernel
// (wrapper score_groups_coarse_linear), the same contract and outputs as B1.
// The operand comes from per-pose coefficient rows W [8, 7], which the kernel
// builds from the pose as score_kernel.coarse_linear_rows does, and per-point
// statics [x, y, z, p2_hi, p2_lo, 1, w], using tp^2 = |p|^2 + 2 p . R^T t +
// |t|^2.  The device code, its arithmetic, design and bound are in
// coarse_rank.cuh, which coarse_rank.cu (B1) shares; this file instantiates the
// linear operand build.  The TPU kernel's block-diagonal matmul, the d2_bf16
// variant and the pose-tile shrink for VMEM are not reproduced.

#include "coarse_rank.cuh"

// Launch on `stream`.  The arguments are coarse_rank_launch's: groups
// [g, 8, k], poses [g, hg, 16] (not centre-shifted), block [8, ld] with n_reps
// real representatives, edge ones first (n_edge), out [g, hg]; all float32,
// contiguous, on the device; (cx, cy, cz) the model centre.  A non-zero
// `cross` also sweeps the other kind's representatives (for gates at or above
// off^2).  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t coarse_linear_rank_launch(const void* groups, const void* poses,
                                                 const void* block, void* out, int g, int hg,
                                                 int k, int ld, int n_edge, int n_reps, float cx,
                                                 float cy, float cz, float t2, float off,
                                                 float t2s, float w_inf, float w_str,
                                                 int cross, void* stream) {
  return coarse_rank::launch<true>(groups, poses, block, out, g, hg, k, ld, n_edge, n_reps, cx,
                                   cy, cz, t2, off, t2s, w_inf, w_str, cross, stream);
}

extern "C" const char* coarse_linear_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
