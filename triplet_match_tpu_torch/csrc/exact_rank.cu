// Exact two-minimum count ranker for Hopper (sm_90a).
//
// Replaces TPU kernel B2: triplet_match_tpu/search/score_pallas.py:_kernel in
// count mode (full=False), wrapper score_groups_pallas(mode="count").  For each
// pose of each group it transforms the group's eligible scene points and takes,
// per point, the exact nearest-neighbour squared distance to the compact edge
// block and to the compact surface block of the model (two minima).  A point
// counts when its own-kind distance is within the gate t2 and no larger than the
// other kind's.  Epilogue knobs: `weighted` scores exp(-dk * inv2t) per counted
// point, `negative` subtracts exp(-do * inv2t) (or 1) per point whose other-kind
// neighbour is within the gate and nearer.  Outputs score [g, hg] float32 and
// count [g, hg] int32.
//
// Arithmetic: the TPU kernel's float32 operations in its order — tp = R p + t and
// |tp|^2 as fused multiply-add chains, the block product E = -2 tp . m + |m|^2 as
// an FMA chain in channel order, d2 = |tp|^2 + min_m E — written with explicit
// __fmaf_rn/__fmul_rn/__fadd_rn so the compiler cannot contract or reorder them.
// The plain PyTorch version (score_kernel.py score_groups_exact_plain) performs
// the same operations, so every per-point distance agrees bit for bit and the
// counts exactly.  A min is exact in any order, so the lanes may split the
// representatives between them.  The weighted sums are accumulated in double in
// a fixed order (deterministic, no atomics).
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
// a fixed xor-shuffle.  Up to 4096 model points and K = 512 take ~72 KB of shared
// memory: dynamic shared memory, raised above 48 KB with cudaFuncSetAttribute.
//
// Bound on H100: FP32 issue.  Each (pose, eligible point, representative)
// evaluation is 5 fp32 instructions (mul, 2 FMA, add, min); bytes are KB per
// block.  So the least time is 5 * evaluations / 3.35e13 instructions/s (the
// 67 TFLOP/s fp32 peak counts an FMA as two).  A faster form (tensor cores on a
// hi/lo split, register-tiled representatives) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kPosesPerBlock = 128;
constexpr int kPts = 4;

__device__ __forceinline__ void sweep(const float4* __restrict__ blk, int n, int lane,
                                      const float (&a0)[kPts], const float (&a1)[kPts],
                                      const float (&a2)[kPts], float (&emin)[kPts]) {
#pragma unroll
  for (int j = 0; j < kPts; ++j) emin[j] = __int_as_float(0x7f800000);  // +inf
  for (int m = lane; m < n; m += 32) {
    const float4 b = blk[m];
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      float e = __fmul_rn(a0[j], b.x);
      e = __fmaf_rn(a1[j], b.y, e);
      e = __fmaf_rn(a2[j], b.z, e);
      e = __fadd_rn(e, b.w);
      emin[j] = fminf(emin[j], e);
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < kPts; ++j)
      emin[j] = fminf(emin[j], __shfl_xor_sync(0xffffffffu, emin[j], s));
  }
}

__global__ void __launch_bounds__(kWarps * 32)
exact_rank_kernel(const float* __restrict__ groups, const float* __restrict__ poses,
                  const float* __restrict__ me, int ne, int ld_e, const float* __restrict__ ms,
                  int ns, int ld_s, float* __restrict__ score, int* __restrict__ count, int hg,
                  int k, float t2, float inv2t, int weighted, int negative) {
  extern __shared__ float4 smem[];
  float4* s_e = smem;            // [ne] edge representatives: x, y, z, |m|^2
  float4* s_s = smem + ne;       // [ns] surface representatives
  float4* s_p = smem + ne + ns;  // [<= k] eligible points, compacted: x, y, z, kind
  __shared__ int s_np;

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < ne; i += blockDim.x)
    s_e[i] = make_float4(me[i], me[ld_e + i], me[2 * ld_e + i], me[3 * ld_e + i]);
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    s_s[i] = make_float4(ms[i], ms[ld_s + i], ms[2 * ld_s + i], ms[3 * ld_s + i]);
  const float* grp = groups + (size_t)g * 8 * k;
  if (warp == 0) {
    int base = 0;
    for (int c = 0; c < k; c += 32) {
      const int i = c + lane;
      const bool el = i < k && grp[4 * k + i] > 0.5f;
      const unsigned mask = __ballot_sync(0xffffffffu, el);
      if (el)
        s_p[base + __popc(mask & ((1u << lane) - 1u))] =
            make_float4(grp[i], grp[k + i], grp[2 * k + i], grp[3 * k + i]);
      base += __popc(mask);
    }
    if (lane == 0) s_np = base;
  }
  __syncthreads();
  const int np = s_np;
  const bool signed_sum = weighted || negative;

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
          for (int a = 0; a < 3; ++a) {
            tp[a] = __fadd_rn(__fmaf_rn(r[3 * a + 2], pt.z,
                                        __fmaf_rn(r[3 * a], pt.x, __fmul_rn(r[3 * a + 1], pt.y))),
                              r[9 + a]);
          }
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
          const bool ok = dk <= t2 && dk <= dother;
          cnt += ok ? 1 : 0;
          if (signed_sum) {
            if (ok) pos_sum += weighted ? (double)expf(__fmul_rn(-dk, inv2t)) : 1.0;
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

}  // namespace

// Launch on `stream`.  groups [g, 8, k], poses [g, hg, 16] (centre-shifted,
// kernel row layout), me / ms the first 4 rows of the compact blocks with `ne` /
// `ns` columns each and row strides ld_e / ld_s, score [g, hg] float32, count
// [g, hg] int32; all contiguous, on the device.  Returns cudaGetLastError()
// after the launch.
extern "C" cudaError_t exact_rank_launch(const void* groups, const void* poses, const void* me,
                                         int ne, int ld_e, const void* ms, int ns, int ld_s,
                                         void* score, void* count, int g, int hg, int k, float t2,
                                         float inv2t, int weighted, int negative, void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || ne <= 0 || ns <= 0 || ld_e < ne || ld_s < ns)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)(ne + ns + k) * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(exact_rank_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + kPosesPerBlock - 1) / kPosesPerBlock);
  exact_rank_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)poses, (const float*)me, ne, ld_e, (const float*)ms,
      ns, ld_s, (float*)score, (int*)count, hg, k, t2, inv2t, weighted, negative);
  return cudaGetLastError();
}

extern "C" const char* exact_rank_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
