// Exact two-minimum count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B2: triplet_match_tpu/search/score_pallas.py:_kernel in
// count mode (full=False), wrapper score_groups_pallas(mode="count").  The
// device code, its arithmetic, the exactness of what it skips, its design and
// bound are in exact_rank.cuh, which full_rank.cu (TPU kernel B3, the full
// mode) shares; this file instantiates the count mode.  On the fog route's
// main path phase 1 is 256 groups x 512 poses x ~6 eligible edge points, phase
// 2 256 x 64 x ~41, against 600 edge + 1800 surface model columns.

#include "exact_rank.cuh"

// Launch on `stream`.  groups [g, 8, k], poses [g, hg, 16] (poses_to_rows
// layout, not centre-shifted), me / ms the first 4 rows of the compact blocks
// with `ne` / `ns` columns each and row strides ld_e / ld_s, score [g, hg]
// float32, count [g, hg] int32; all contiguous, on the device; npt the pose
// tiles per block (score_kernel.exact_pose_tiles); (cx, cy, cz) the model
// centre.  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t exact_rank_launch(const void* groups, const void* poses, const void* me,
                                         int ne, int ld_e, const void* ms, int ns, int ld_s,
                                         void* score, void* count, int g, int hg, int k, int npt,
                                         float cx, float cy, float cz, float t2, float inv2t,
                                         int weighted, int negative, void* stream) {
  return exact_rank::launch<false>(groups, poses, me, ne, ld_e, ms, ns, ld_s, nullptr, 0,
                                   nullptr, 0, score, count, g, hg, k, npt, cx, cy, cz, t2,
                                   inv2t, 0.0f, weighted, negative, stream);
}

extern "C" const char* exact_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
