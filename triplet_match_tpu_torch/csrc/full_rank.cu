// Orientation-weighted exact ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B3: triplet_match_tpu/search/score_pallas.py:_kernel in
// full mode (full=True, :472-499), wrapper score_groups_pallas(mode="full").
// The count is B2's; each counted point adds w_at_min (times the weighted
// epilogue's exp term), the mean over the tie set of |(R ref) . mref| at the
// own-kind nearest model point, which a second pass over the own-kind block
// takes for the counted entries of a survivor chunk together.  The device
// code, its arithmetic, design and bound are in exact_rank.cuh, which
// exact_rank.cu (B2) shares; this file instantiates the full mode.
//
// Shared memory (exact_rank::Layout): 32 bytes per model column and per scene
// point (the blocks and points with their reference vectors), 48 per pose of
// the block, and a 16 KB survivor list: a 4096-point pack at K = 512 and 256
// poses per block takes 176 KB.  The wrapper (score_kernel._exact_launch)
// raises above the card's 227 KB per block; the TPU's trace-time guard at
// K * N * 8 > 12 MB was a VMEM limit and has no counterpart here.

#include "exact_rank.cuh"

// Launch on `stream`.  As exact_rank_launch, plus re / rs the 3 rows of the
// compact blocks' reference vectors (row strides ld_re / ld_rs, the same
// columns as me / ms) and eps, the tie tolerance on E.  score is the
// orientation-weighted (signed) sum, count the plain correspondence count.
extern "C" cudaError_t full_rank_launch(const void* groups, const void* poses, const void* me,
                                        int ne, int ld_e, const void* ms, int ns, int ld_s,
                                        const void* re, int ld_re, const void* rs, int ld_rs,
                                        void* score, void* count, int g, int hg, int k, int npt,
                                        float cx, float cy, float cz, float t2, float inv2t,
                                        float eps, int weighted, int negative, void* stream) {
  return exact_rank::launch<true>(groups, poses, me, ne, ld_e, ms, ns, ld_s, re, ld_re, rs, ld_rs,
                                  score, count, g, hg, k, npt, cx, cy, cz, t2, inv2t, eps,
                                  weighted, negative, stream);
}

extern "C" const char* full_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
