// Coarse 4-D hit-count rankers for Hopper (sm_90a): the device code that
// coarse_rank.cu (TPU kernel B1, score_pallas.py:_coarse_kernel) and
// coarse_linear_rank.cu (TPU kernel B4, score_pallas.py:_coarse_linear_kernel)
// share.  The two differ only in how they build a pose's operand; kLinear
// selects B4's.
//
// For each pose of each group the kernel transforms the group's K scene points,
// takes the squared 4-D distance of every point to each of the Nc
// representatives of a model block (4th coordinate: the kind offset on edge
// points; ineligible points carry +BIG), the per-point minimum, and scores
//   w_inf * #(dmin <= t2) + w_str * #(dmin <= t2s).
//
// The operand of a (pose, point) pair is a0..a3 = -2 (tp, w) and |tp4|^2 split
// into a bfloat16 part and its remainder.  B1 builds it from the pose's
// rotation and translation: tp = R p + t and |tp4|^2 = |tp|^2 + w^2 + inelig as
// fused multiply-add chains.  B4 builds it from per-pose coefficient rows W
// [8, 7] (score_kernel.coarse_linear_rows, the rows the TPU caller builds) and
// per-point statics S = [x, y, z, p2_hi, p2_lo, 1, w] staged once per group:
// rows 0-3 and 6 of A = W S, each a fused multiply-add chain over the 7 channels
// in channel order, with tp^2 = |p|^2 + 2 p . R^T t + |t|^2 in row 6.  The TPU
// kernel formed A with a block-diagonal matmul on the MXU; on Hopper the 35
// FMAs per (pose, point) cost less than one representative's sweep.
//
// Arithmetic: the TPU kernels' float32 operations in their order — the
// 8-channel distance product accumulated channel by channel with fused
// multiply-adds, |tp4|^2 split hi/lo — written with explicit __fmaf_rn /
// __fmul_rn / __fadd_rn so the compiler cannot contract or reorder them.  The
// point's two |tp4|^2 terms are added once after the minimum (exact, since
// rounding is monotone).  The plain PyTorch versions (score_kernel.py
// score_groups_coarse_plain, score_groups_coarse_linear_plain) perform the same
// operations, so the per-point distances agree bit for bit and the integer
// counts exactly; the per-pose sum is a fixed-order warp reduction (no atomics:
// results are deterministic), which may round the fractional tiebreak term
// differently from the plain sum.
//
// Design: one block of 8 warps per (group, tile of 32 poses); the group's
// per-point values and the block's Nc representatives are staged in shared
// memory; one warp per pose, lanes striding over points, each lane sweeping all
// Nc representatives for its running minimum.  Every lane reads the same
// representative at a time, so the shared-memory reads are broadcasts.
//
// Bound on H100: FP32 issue.  Each (pose, eligible point, representative)
// evaluation is 1 mul + 3 FMA + 2 adds + 1 min; the operand build is 12 (B1) or
// 35 (B4) FMAs per (pose, point), amortized over the Nc representatives; the
// bytes are KB per block (K <= 128 points, Nc <= 512 reps).  A faster form
// (tensor cores on a hi/lo split, register-tiled representatives) is later
// work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coarse_rank {

constexpr int kWarps = 8;
constexpr int kPosesPerBlock = 32;
constexpr float kBig = 1.0e12f;
constexpr int kLinC = 7;    // statics channels: x, y, z, p2_hi, p2_lo, 1, w
constexpr int kLinRows = 8;  // coefficient rows per pose (rows 4, 5 are ones, 7 unused)

// float32 -> bfloat16 (round to nearest even) -> float32, for finite values
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// One row of A = W S: the 7-channel FMA chain in channel order.
__device__ __forceinline__ float lin_row(const float* w, const float (&s)[kLinC]) {
  float acc = __fmul_rn(w[0], s[0]);
#pragma unroll
  for (int c = 1; c < kLinC; ++c) acc = __fmaf_rn(w[c], s[c], acc);
  return acc;
}

template <bool kLinear>
__global__ void __launch_bounds__(kWarps * 32)
rank_kernel(const float* __restrict__ groups, const float* __restrict__ pose_rows,
            const float* __restrict__ block, float* __restrict__ out, int hg, int k, int nc,
            float t2, float off, float t2s, float w_inf, float w_str) {
  // per point: B1 x, y, z, kind offset w, ineligibility penalty; B4 the statics
  constexpr int kStat = kLinear ? kLinC : 5;
  constexpr int kRow = kLinear ? kLinRows * kLinC : 16;  // floats per pose row
  extern __shared__ float smem[];
  float* s_pts = smem;              // [kStat, k]
  float* s_blk = smem + kStat * k;  // [6, nc]: block rows x, y, z, w, |p4|^2 hi, |p4|^2 lo

  const int g = blockIdx.x;
  const float* grp = groups + (size_t)g * 8 * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float x = grp[i], y = grp[k + i], z = grp[2 * k + i];
    const float w = __fmul_rn(off, grp[3 * k + i]);
    const float inel = __fmul_rn(__fsub_rn(1.0f, grp[4 * k + i]), kBig);
    s_pts[i] = x;
    s_pts[k + i] = y;
    s_pts[2 * k + i] = z;
    if constexpr (kLinear) {
      const float p2 = __fadd_rn(
          __fadd_rn(__fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y))), __fmul_rn(w, w)), inel);
      const float hi = bf16_round(p2);
      s_pts[3 * k + i] = hi;
      s_pts[4 * k + i] = __fsub_rn(p2, hi);
      s_pts[5 * k + i] = 1.0f;
      s_pts[6 * k + i] = w;
    } else {
      s_pts[3 * k + i] = w;
      s_pts[4 * k + i] = inel;
    }
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
    const float* q = pose_rows + ((size_t)g * hg + p) * kRow;
    // B1: R rows and t; B4: coefficient rows 0-3 and 6
    float r[kLinear ? 5 * kLinC : 12];
    if constexpr (kLinear) {
#pragma unroll
      for (int i = 0; i < 4 * kLinC; ++i) r[i] = q[i];
#pragma unroll
      for (int i = 0; i < kLinC; ++i) r[4 * kLinC + i] = q[6 * kLinC + i];
    } else {
#pragma unroll
      for (int i = 0; i < 12; ++i) r[i] = q[i];
    }

    float acc = 0.0f;
    for (int i = lane; i < k; i += 32) {
      float a0, a1, a2, a3, tp2;
      if constexpr (kLinear) {
        float s[kLinC];
#pragma unroll
        for (int c = 0; c < kLinC; ++c) s[c] = s_pts[c * k + i];
        a0 = lin_row(r, s);
        a1 = lin_row(r + kLinC, s);
        a2 = lin_row(r + 2 * kLinC, s);
        a3 = lin_row(r + 3 * kLinC, s);
        tp2 = lin_row(r + 4 * kLinC, s);
      } else {
        const float px = s_pts[i], py = s_pts[k + i], pz = s_pts[2 * k + i];
        const float w = s_pts[3 * k + i], inel = s_pts[4 * k + i];
        float tp[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          tp[a] = __fadd_rn(
              __fmaf_rn(r[3 * a + 2], pz, __fmaf_rn(r[3 * a], px, __fmul_rn(r[3 * a + 1], py))),
              r[9 + a]);
        }
        tp2 = __fadd_rn(
            __fadd_rn(__fmaf_rn(tp[2], tp[2], __fmaf_rn(tp[0], tp[0], __fmul_rn(tp[1], tp[1]))),
                      __fmul_rn(w, w)),
            inel);
        a0 = -2.0f * tp[0];
        a1 = -2.0f * tp[1];
        a2 = -2.0f * tp[2];
        a3 = -2.0f * w;
      }
      const float hi = bf16_round(tp2);
      const float lo = __fsub_rn(tp2, hi);

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

template <bool kLinear>
cudaError_t launch(const void* groups, const void* pose_rows, const void* block, void* out, int g,
                   int hg, int k, int nc, float t2, float off, float t2s, float w_inf, float w_str,
                   void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || nc <= 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)((kLinear ? kLinC : 5) * k + 6 * nc) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rank_kernel<kLinear>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + kPosesPerBlock - 1) / kPosesPerBlock);
  rank_kernel<kLinear><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)pose_rows, (const float*)block, (float*)out, hg, k, nc,
      t2, off, t2s, w_inf, w_str);
  return cudaGetLastError();
}

}  // namespace coarse_rank
