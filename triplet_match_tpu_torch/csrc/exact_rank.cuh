// Exact two-minimum rankers for Hopper (sm_90a): the device code that
// exact_rank.cu (TPU kernel B2, count mode) and full_rank.cu (TPU kernel B3,
// full mode) share.  Both replace triplet_match_tpu/search/score_pallas.py:_kernel
// (wrapper score_groups_pallas); kFull selects the full mode.
//
// For each pose of each group the kernel transforms the group's eligible scene
// points and takes, per point, the exact nearest-neighbour squared distance to
// the compact edge block and to the compact surface block of the model (two
// minima).  A point counts when its own-kind distance is within the gate t2 and
// no larger than the other kind's.  Count mode scores the count, or with the
// epilogue knobs the signed sum: `weighted` scores exp(-dk * inv2t) per counted
// point, `negative` subtracts exp(-do * inv2t) (or 1) per point whose other-kind
// neighbour is within the gate and nearer.  Full mode multiplies each counted
// point's term by its orientation weight w_at_min = |mean over the tie set of
// (R ref) . mref_m|, the tie set being the own-kind model points whose E lies
// within eps of the own-kind minimum (TPU kernel :472-499).
//
// Arithmetic: the TPU kernel's float32 operations in its order — tp = R p + t,
// |tp|^2, R ref and the orientation product (R ref) . mref as fused multiply-add
// chains, the block product E = -2 tp . m + |m|^2 as an FMA chain in channel
// order, d2 = |tp|^2 + min_m E, the tie threshold emin + eps rounded to float32,
// w_at_min divided in float32 — written with explicit __fmaf_rn / __fmul_rn /
// __fadd_rn so the compiler cannot contract or reorder them.  The plain PyTorch
// versions (score_kernel.py score_groups_exact_plain, score_groups_full_plain)
// perform the same operations, so every per-point distance agrees bit for bit and
// the counts exactly.  A min is exact in any order, so the lanes may split the
// representatives between them.  Sums run in double in a fixed order
// (deterministic, no atomics).
//
// Design: one block of 8 warps per (group, tile of 128 poses).  The block stages
// both model blocks in shared memory as packed float4 (x, y, z, |m|^2), only
// their real columns (the FAR padding can never be an eligible point's nearest
// neighbour), and compacts the group's eligible points (x, y, z, kind) with a
// warp ballot: an ineligible point adds nothing to any output, and on the fog
// route, which ranks on edge points only, most of a ball is ineligible fog.  One
// warp per pose; the warp takes kPts eligible points at a time, every lane
// sweeps a 32-strided slice of the representatives for all kPts points (one
// float4 load feeds kPts evaluations), and the per-point minima are combined by
// a fixed xor-shuffle, which leaves every lane with the same minima.
//
// Full mode, the Hopper design: the TPU kernel takes the argmin over the whole
// pack with a +BIG penalty on the other kind's columns; here every other-kind
// column loses anyway and w_at_min only matters where the point counts, so a
// second pass runs only for counted points and only over the own-kind compact
// block (the same points, with identical E values, as the pack's own-kind
// columns), whose minimum the first pass already holds.  The model's reference
// vectors and the points' own ride beside the blocks in shared memory.
//
// Bound on H100: FP32 issue.  Each (pose, eligible point, representative)
// evaluation of the first pass is 5 fp32 instructions (mul, 2 FMA, add, min);
// the second pass adds 5 (mul, 2 FMA, add, compare) per (counted point, own-kind
// representative) plus the tie set's orientation products; bytes are KB per
// block.  A faster form (tensor cores on a hi/lo split, register-tiled
// representatives) is later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace exact_rank {

constexpr int kWarps = 8;
constexpr int kPosesPerBlock = 128;
constexpr int kPts = 4;

__device__ __forceinline__ float block_e(float a0, float a1, float a2, float4 b) {
  float e = __fmul_rn(a0, b.x);
  e = __fmaf_rn(a1, b.y, e);
  e = __fmaf_rn(a2, b.z, e);
  return __fadd_rn(e, b.w);
}

__device__ __forceinline__ void sweep(const float4* __restrict__ blk, int n, int lane,
                                      const float (&a0)[kPts], const float (&a1)[kPts],
                                      const float (&a2)[kPts], float (&emin)[kPts]) {
#pragma unroll
  for (int j = 0; j < kPts; ++j) emin[j] = __int_as_float(0x7f800000);  // +inf
  for (int m = lane; m < n; m += 32) {
    const float4 b = blk[m];
#pragma unroll
    for (int j = 0; j < kPts; ++j) emin[j] = fminf(emin[j], block_e(a0[j], a1[j], a2[j], b));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < kPts; ++j)
      emin[j] = fminf(emin[j], __shfl_xor_sync(0xffffffffu, emin[j], s));
  }
}

// r . v for one row of the pose's rotation, in the TPU kernel's FMA order
__device__ __forceinline__ float rot_row(const float* r, int a, float x, float y, float z) {
  return __fmaf_rn(r[3 * a + 2], z, __fmaf_rn(r[3 * a], x, __fmul_rn(r[3 * a + 1], y)));
}

// Full mode's second pass for one counted point: the orientation weight
// |mean over the tie set e <= emin + eps of tr . mref| over the own-kind block.
__device__ __forceinline__ float orientation_weight(const float4* __restrict__ blk,
                                                    const float4* __restrict__ ref, int n,
                                                    int lane, float a0, float a1, float a2,
                                                    float thr, float tr0, float tr1, float tr2) {
  double wsum = 0.0;
  int ties = 0;
  for (int m = lane; m < n; m += 32) {
    if (block_e(a0, a1, a2, blk[m]) <= thr) {
      const float4 mr = ref[m];
      wsum += (double)__fmaf_rn(tr2, mr.z, __fmaf_rn(tr1, mr.y, __fmul_rn(tr0, mr.x)));
      ++ties;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    wsum += __shfl_xor_sync(0xffffffffu, wsum, s);
    ties += __shfl_xor_sync(0xffffffffu, ties, s);
  }
  return fabsf(__fdiv_rn((float)wsum, (float)max(ties, 1)));
}

template <bool kFull>
__global__ void __launch_bounds__(kWarps * 32)
rank_kernel(const float* __restrict__ groups, const float* __restrict__ poses,
            const float* __restrict__ me, int ne, int ld_e, const float* __restrict__ ms, int ns,
            int ld_s, const float* __restrict__ re, int ld_re, const float* __restrict__ rs,
            int ld_rs, float* __restrict__ score, int* __restrict__ count, int hg, int k,
            float t2, float inv2t, float eps, int weighted, int negative) {
  extern __shared__ float4 smem[];
  float4* s_e = smem;            // [ne] edge representatives: x, y, z, |m|^2
  float4* s_s = smem + ne;       // [ns] surface representatives
  float4* s_p = smem + ne + ns;  // [<= k] eligible points, compacted: x, y, z, kind
  float4* s_er = s_p + k;        // full mode: [ne] edge reference vectors (tangents)
  float4* s_sr = s_er + ne;      // full mode: [ns] surface reference vectors (normals)
  float4* s_pr = s_sr + ns;      // full mode: [<= k] the points' reference vectors
  __shared__ int s_np;

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < ne; i += blockDim.x) {
    s_e[i] = make_float4(me[i], me[ld_e + i], me[2 * ld_e + i], me[3 * ld_e + i]);
    if constexpr (kFull)
      s_er[i] = make_float4(re[i], re[ld_re + i], re[2 * ld_re + i], 0.0f);
  }
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    s_s[i] = make_float4(ms[i], ms[ld_s + i], ms[2 * ld_s + i], ms[3 * ld_s + i]);
    if constexpr (kFull)
      s_sr[i] = make_float4(rs[i], rs[ld_rs + i], rs[2 * ld_rs + i], 0.0f);
  }
  const float* grp = groups + (size_t)g * 8 * k;
  if (warp == 0) {
    int base = 0;
    for (int c = 0; c < k; c += 32) {
      const int i = c + lane;
      const bool el = i < k && grp[4 * k + i] > 0.5f;
      const unsigned mask = __ballot_sync(0xffffffffu, el);
      if (el) {
        const int slot = base + __popc(mask & ((1u << lane) - 1u));
        s_p[slot] = make_float4(grp[i], grp[k + i], grp[2 * k + i], grp[3 * k + i]);
        if constexpr (kFull)
          s_pr[slot] = make_float4(grp[5 * k + i], grp[6 * k + i], grp[7 * k + i], 0.0f);
      }
      base += __popc(mask);
    }
    if (lane == 0) s_np = base;
  }
  __syncthreads();
  const int np = s_np;
  const bool signed_sum = kFull || weighted || negative;

  const int p_end = min(hg, (int)(blockIdx.y + 1) * kPosesPerBlock);
  for (int p = blockIdx.y * kPosesPerBlock + warp; p < p_end; p += kWarps) {
    int cnt = 0;
    double pos_sum = 0.0, neg_sum = 0.0;
    if (np > 0) {
      const float* q = poses + ((size_t)g * hg + p) * 16;
      float r[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) r[i] = q[i];
      for (int c = 0; c < np; c += kPts) {
        float a0[kPts], a1[kPts], a2[kPts], tp2[kPts], kind[kPts];
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const float4 pt = s_p[min(c + j, np - 1)];
          float tp[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) tp[a] = __fadd_rn(rot_row(r, a, pt.x, pt.y, pt.z), r[9 + a]);
          tp2[j] = __fmaf_rn(tp[2], tp[2], __fmaf_rn(tp[0], tp[0], __fmul_rn(tp[1], tp[1])));
          a0[j] = -2.0f * tp[0];
          a1[j] = -2.0f * tp[1];
          a2[j] = -2.0f * tp[2];
          kind[j] = pt.w;
        }
        float emin_e[kPts], emin_s[kPts];
        sweep(s_e, ne, lane, a0, a1, a2, emin_e);
        sweep(s_s, ns, lane, a0, a1, a2, emin_s);
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          if (c + j >= np) break;
          const float d2e = __fadd_rn(tp2[j], emin_e[j]);
          const float d2s = __fadd_rn(tp2[j], emin_s[j]);
          const bool edge = kind[j] > 0.5f;
          const float dk = edge ? d2e : d2s;
          const float dother = edge ? d2s : d2e;
          const bool ok = dk <= t2 && dk <= dother;  // the same in every lane
          cnt += ok ? 1 : 0;
          if (signed_sum) {
            if (ok) {
              float term = weighted ? expf(__fmul_rn(-dk, inv2t)) : 1.0f;
              if constexpr (kFull) {
                const float4 pr = s_pr[c + j];
                const float thr = __fadd_rn(edge ? emin_e[j] : emin_s[j], eps);
                const float w_at_min = orientation_weight(
                    edge ? s_e : s_s, edge ? s_er : s_sr, edge ? ne : ns, lane, a0[j], a1[j],
                    a2[j], thr, rot_row(r, 0, pr.x, pr.y, pr.z), rot_row(r, 1, pr.x, pr.y, pr.z),
                    rot_row(r, 2, pr.x, pr.y, pr.z));
                term = __fmul_rn(w_at_min, term);
              }
              pos_sum += (double)term;
            }
            if (negative && dother <= t2 && dother < dk)
              neg_sum += weighted ? (double)expf(__fmul_rn(-dother, inv2t)) : 1.0;
          }
        }
      }
    }
    if (lane == 0) {
      const size_t o = (size_t)g * hg + p;
      count[o] = cnt;
      score[o] = signed_sum ? (float)(pos_sum - neg_sum) : (float)cnt;
    }
  }
}

// Dynamic shared memory of one block: the staged blocks and points, and in
// full mode their reference vectors.
inline size_t smem_bytes(bool full, int ne, int ns, int k) {
  return (size_t)(ne + ns + k) * sizeof(float4) * (full ? 2 : 1);
}

template <bool kFull>
cudaError_t launch(const void* groups, const void* poses, const void* me, int ne, int ld_e,
                   const void* ms, int ns, int ld_s, const void* re, int ld_re, const void* rs,
                   int ld_rs, void* score, void* count, int g, int hg, int k, float t2,
                   float inv2t, float eps, int weighted, int negative, void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || ne <= 0 || ns <= 0 || ld_e < ne || ld_s < ns)
    return cudaErrorInvalidValue;
  if (kFull && (ld_re < ne || ld_rs < ns)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(kFull, ne, ns, k);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rank_kernel<kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + kPosesPerBlock - 1) / kPosesPerBlock);
  rank_kernel<kFull><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)poses, (const float*)me, ne, ld_e, (const float*)ms,
      ns, ld_s, (const float*)re, ld_re, (const float*)rs, ld_rs, (float*)score, (int*)count, hg,
      k, t2, inv2t, eps, weighted, negative);
  return cudaGetLastError();
}

}  // namespace exact_rank
