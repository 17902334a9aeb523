// Coarse 4-D hit-count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B1: triplet_match_tpu/search/score_pallas.py:_coarse_kernel
// (wrapper score_groups_coarse).  For each pose of each group it transforms the
// group's K scene points, takes the squared 4-D distance of every point to each
// of the Nc representatives of a model block (4th coordinate: the kind offset on
// edge points; ineligible points carry +BIG), the per-point minimum, and scores
//   w_inf * #(dmin <= t2) + w_str * #(dmin <= t2s).
//
// Arithmetic: the TPU kernel's float32 operations in the TPU kernel's order —
// the 8-channel distance product accumulated channel by channel with fused
// multiply-adds, |tp4|^2 split into a bfloat16 part and its remainder — written
// with explicit __fmaf_rn/__fmul_rn/__fadd_rn so the compiler cannot contract
// or reorder them.  The point's two |tp4|^2 terms are added once after the
// minimum (exact, since rounding is monotone).  The plain PyTorch version (score_kernel.py
// score_groups_coarse_plain) performs the same operations, so the per-point
// distances agree bit for bit and the integer counts exactly; the per-pose sum
// is a fixed-order warp reduction (no atomics: results are deterministic), which
// may round the fractional tiebreak term differently from the plain sum.
//
// Design: one block of 8 warps per (group, tile of 32 poses); the group's K
// points and the block's Nc representatives are staged in shared memory; one
// warp per pose, lanes striding over points, each lane sweeping all Nc
// representatives for its running minimum.  Every lane reads the same
// representative at a time, so the shared-memory reads are broadcasts.
//
// Bound on H100: FP32 issue.  At the main path's shapes phase 1 is
// 256 groups x 512 poses x 64 points x 256 reps = 2.1 G (pose, point, rep)
// evaluations of 1 mul + 3 FMA + 2 adds + 1 min, plus 6 shared loads each;
// the bytes are KB per block (K <= 128 points, Nc <= 512 reps).  A faster
// form (tensor cores on a hi/lo split, register-tiled representatives) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPosesPerBlock = 32;
constexpr float kBig = 1.0e12f;

// float32 -> bfloat16 (round to nearest even) -> float32, for finite values
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kWarps * 32)
coarse_rank_kernel(const float* __restrict__ groups, const float* __restrict__ poses,
                   const float* __restrict__ block, float* __restrict__ out, int hg, int k,
                   int nc, float t2, float off, float t2s, float w_inf, float w_str) {
  extern __shared__ float smem[];
  float* s_pts = smem;          // [5, k]: x, y, z, kind offset w, ineligibility penalty
  float* s_blk = smem + 5 * k;  // [6, nc]: block rows x, y, z, w, |p4|^2 hi, |p4|^2 lo

  const int g = blockIdx.x;
  const float* grp = groups + (size_t)g * 8 * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    s_pts[i] = grp[i];
    s_pts[k + i] = grp[k + i];
    s_pts[2 * k + i] = grp[2 * k + i];
    s_pts[3 * k + i] = __fmul_rn(off, grp[3 * k + i]);
    s_pts[4 * k + i] = __fmul_rn(__fsub_rn(1.0f, grp[4 * k + i]), kBig);
  }
  for (int i = threadIdx.x; i < 6 * nc; i += blockDim.x) s_blk[i] = block[i];
  __syncthreads();

  const float* bx = s_blk;
  const float* by = s_blk + nc;
  const float* bz = s_blk + 2 * nc;
  const float* bw = s_blk + 3 * nc;
  const float* bhi = s_blk + 4 * nc;
  const float* blo = s_blk + 5 * nc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p_end = min(hg, (int)(blockIdx.y + 1) * kPosesPerBlock);

  for (int p = blockIdx.y * kPosesPerBlock + warp; p < p_end; p += kWarps) {
    const float* q = poses + ((size_t)g * hg + p) * 16;
    float r[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) r[i] = q[i];

    float acc = 0.0f;
    for (int i = lane; i < k; i += 32) {
      const float px = s_pts[i], py = s_pts[k + i], pz = s_pts[2 * k + i];
      const float w = s_pts[3 * k + i], inel = s_pts[4 * k + i];
      float tp[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        tp[a] = __fadd_rn(
            __fmaf_rn(r[3 * a + 2], pz, __fmaf_rn(r[3 * a], px, __fmul_rn(r[3 * a + 1], py))),
            r[9 + a]);
      }
      const float tp2 = __fadd_rn(
          __fadd_rn(__fmaf_rn(tp[2], tp[2], __fmaf_rn(tp[0], tp[0], __fmul_rn(tp[1], tp[1]))),
                    __fmul_rn(w, w)),
          inel);
      const float hi = bf16_round(tp2);
      const float lo = __fsub_rn(tp2, hi);
      const float a0 = -2.0f * tp[0], a1 = -2.0f * tp[1], a2 = -2.0f * tp[2], a3 = -2.0f * w;

      float dmin = __int_as_float(0x7f800000);  // +inf
      for (int m = 0; m < nc; ++m) {
        float d = __fmul_rn(a0, bx[m]);
        d = __fmaf_rn(a1, by[m], d);
        d = __fmaf_rn(a2, bz[m], d);
        d = __fmaf_rn(a3, bw[m], d);
        d = __fadd_rn(d, bhi[m]);
        d = __fadd_rn(d, blo[m]);
        dmin = fminf(dmin, d);
      }
      // the point's |tp4|^2 is the same for every representative, and
      // x -> (x + hi) + lo is monotone under rounding, so adding it after the
      // min gives the TPU kernel's per-representative sum's minimum bit for bit
      dmin = __fadd_rn(__fadd_rn(dmin, hi), lo);
      acc = __fadd_rn(acc, __fadd_rn(dmin <= t2 ? w_inf : 0.0f, dmin <= t2s ? w_str : 0.0f));
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
    if (lane == 0) out[(size_t)g * hg + p] = acc;
  }
}

}  // namespace

// Launch on `stream`.  groups [g, 8, k], poses [g, hg, 16] (centre-shifted,
// kernel row layout), block [8, nc], out [g, hg]; all float32, contiguous, on
// the device.  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t coarse_rank_launch(const void* groups, const void* poses,
                                          const void* block, void* out, int g, int hg, int k,
                                          int nc, float t2, float off, float t2s, float w_inf,
                                          float w_str, void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || nc <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * k + 6 * nc) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(coarse_rank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + kPosesPerBlock - 1) / kPosesPerBlock);
  coarse_rank_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)poses, (const float*)block, (float*)out, hg, k, nc,
      t2, off, t2s, w_inf, w_str);
  return cudaGetLastError();
}

extern "C" const char* coarse_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
