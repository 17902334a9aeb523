// Coarse 4-D hit-count rankers for Hopper (sm_90a): the device code that
// coarse_rank.cu (TPU kernel B1, score_pallas.py:_coarse_kernel) and
// coarse_linear_rank.cu (TPU kernel B4, score_pallas.py:_coarse_linear_kernel)
// share.  The two differ only in how they build a pose's operand; kLinear
// selects B4's.
//
// Contract.  For each pose of each group the TPU kernel transforms the group's
// K scene points, takes the squared 4-D distance of every point to each of the
// Nc representatives of a model block (4th coordinate: the kind offset on edge
// points; ineligible points carry +BIG), the per-point minimum, and scores
//   w_inf * #(dmin <= t2) + w_str * #(dmin <= t2s).
// The operand of a (pose, point) pair is a0..a3 = -2 (tp, w) and |tp4|^2 split
// into a bfloat16 part and its remainder.  B1 builds it from the pose's rotation
// and translation: tp = R p + t and |tp4|^2 = |tp|^2 + w^2 + inelig as fused
// multiply-add chains.  B4 builds it from per-pose coefficient rows W [8, 7]
// (score_kernel.coarse_linear_rows) and per-point statics S = [x, y, z, p2_hi,
// p2_lo, 1, w]: rows 0-3 and 6 of A = W S, each a fused multiply-add chain over
// the 7 channels in channel order, with tp^2 = |p|^2 + 2 p . R^T t + |t|^2 in
// row 6.  Both kernels take the uncentred pose rows and the model centre c and
// build everything else themselves: t - c is one float32 subtraction (the
// wrapper's), and B4's rows (R^T t and |t|^2 as FMA chains in XLA's order,
// -2 R, -2 t, 2 R^T t) are computed per pose in the block's prologue.  In the
// rows' zero and one entries, w * s + acc is acc + 0 or acc + s exactly, so the
// kernel skips the zero terms and adds the one terms; only the sign of a zero
// can differ, which no count sees.
//
// Arithmetic: the TPU kernels' float32 operations in their order — the 8-channel
// distance product accumulated channel by channel with fused multiply-adds,
// |tp4|^2 split hi/lo — written with explicit __fmaf_rn / __fmul_rn / __fadd_rn
// so the compiler cannot contract or reorder them.  The point's two |tp4|^2
// terms are added once after the minimum (exact, since x -> (x + hi) + lo is
// monotone under rounding).  The plain PyTorch versions (score_kernel.py
// score_groups_coarse_plain, score_groups_coarse_linear_plain) perform the same
// operations over every representative, so the counts agree exactly; the
// per-pose score is w_inf * n_inf + w_str * n_str from integer counts, which may
// round the fractional tiebreak otherwise than the plain float sum (within K
// ulps) and is deterministic (integer partial counts summed in a fixed order,
// no atomics).
//
// What each point sweeps: only the real representatives of its own kind (edge
// points [0, n_edge), surface points [n_edge, n_reps)), and only eligible points
// are swept at all.  This is exact while both gates lie below kind_off^2:
//   - a cross-kind pair sits kind_off^2 apart in the 4th coordinate, and
//     kind_off is a power of two at least 4x the model's extent
//     (score_kernel.pack_model), so a cross-kind distance is above such a gate.
//     If a point's global minimum is of its own kind, the own-kind minimum is
//     the same value bit for bit; otherwise both lie above the gates;
//   - with `cross` set (the launcher sets it when the larger gate reaches
//     kind_off^2) each point's sweep goes on over the other kind's real
//     representatives, and points of a kind without representatives of its own
//     are staged too, so the minimum is the one over every real representative,
//     as the TPU kernel's; the main path's gates never set it;
//   - a padded representative carries |p4|^2 = 2e12 and never hits;
//   - an ineligible point carries +1e12 on |tp4|^2 and never hits, so it adds 0;
//   - without `cross`, a point of a kind with no representative has an
//     infinite own-kind minimum and never hits; such points are not staged.
//
// Why not tensor cores: the distance is an 8-channel product, which the TPU ran
// on its MXU with a bf16 hi/lo split.  TF32 or a 3 x bf16 split on Hopper would
// round the distance otherwise, so counts could differ near the gates, and the
// port requires counts equal to the reference kernel's (ROADMAP C4).  The kernel
// stays in exact fp32 FMA on the CUDA cores.
//
// Diagnosis of the earlier design (one warp per pose, lanes over points, every
// lane sweeping every representative), measured from its SASS
// (kernels/sass_mix.py, cuobjdump -sass): the representative loop, unrolled by
// 16, held 224 instructions, 96 of them shared loads (LDS: x, y, z, w, hi, lo,
// each a broadcast from its own row) against 112 fp32 instructions, 6 loads per
// 7 fp32.  An SM issues about one shared wavefront per clock against four
// warp-wide fp32 instructions, so the loop was bound by its loads: it ran at
// 26-27 % of its fp32 bound, and half its evaluations (the cross-kind ones)
// decided nothing.
//
// Design: one block of 128 threads per (group, tile of kTP * npt poses).  The
// prologue stages the group's channels, the block's representative records (8
// floats: x, y, z, w, hi, lo, pad: two broadcast loads per representative) and
// the block's poses (B1: R and t - c; B4: its coefficient rows) in shared
// memory, then one warp compacts the eligible points by kind with a ballot
// (edge points, then surface points, each kind padded to a multiple of kTQ).
// Each thread owns a register tile of kTP = 2 poses x kTQ = 4 points of one
// kind: it keeps their operands and running minima in registers and reuses
// every loaded representative 8 times, so the loop does 2 shared loads per 8
// evaluations and is bound by fp32 issue (the SASS loop: 112 fp32 instructions,
// 4 shared loads, 4 others per two representatives).  Thread t takes pose tile
// t % npt and the point tiles t / npt, t / npt + 128 / npt, ...; the lanes of a
// warp take one or a few neighbouring point tiles (kind-major order), so they
// read the same representative at a time and only the warp at the edge/surface
// boundary reads two.  npt (pose tiles per block, a power of two <= 32) is
// chosen by the launcher so that the grid puts at least two blocks on every SM.
// The tile and block sizes were the fastest of those tried at the main path's
// shapes (kTP x kTQ of 1 x 8 to 4 x 4, 128 or 256 threads); larger tiles spill.
// 116-120 registers, no spills: four blocks per SM.
//
// Bound on H100: FP32 issue.  Each (pose, eligible point, own-kind
// representative) evaluation is 1 mul + 3 FMA + 2 adds + 1 min.  Each (pose,
// eligible point) pair needs its operand and, after the minimum, the |tp4|^2
// hi/lo adds: B1 20 fp32 instructions (tp 12, |tp4|^2 5, hi/lo 3; the -2
// scaling is exact and not counted), B4 21 (rows 0-2 12, row 6 6, hi/lo 3);
// each pose 3 (t - c) or, for B4's rows, 15.  chip_smoke.py counts this way.
// The bytes are KB per block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coarse_rank {

constexpr int kThreads = 128;
constexpr int kTP = 2;  // poses per thread tile
constexpr int kTQ = 4;  // points (of one kind) per thread tile
constexpr int kMaxPoseTiles = 32;
constexpr float kBig = 1.0e12f;

// float32 -> bfloat16 (round to nearest even) -> float32, for finite values
__device__ __forceinline__ float bf16_round(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// Shared-memory layout of one block, in float4 units.
struct Layout {
  int rep, pose, pt, part, grp, total_bytes;
  __host__ __device__ Layout(int n_reps, int pb, int k) {
    rep = 0;                          // [2 n_reps] (x, y, z, w), (hi, lo, 0, 0)
    pose = 2 * n_reps;                // [4 pb] 16 floats per pose
    pt = pose + 4 * pb;               // [2 (k + 2 kTQ)] (x, y, z, w), (B1 inel | B4 p2 hi, lo)
    part = pt + 2 * (k + 2 * kTQ);    // [kThreads kTP / 2] int2 (n_inf, n_str) per thread pose
    grp = part + kThreads * kTP / 2;  // [5 k] floats: the group's channels 0-4
    total_bytes = (grp + (5 * k + 3) / 4) * 16;
  }
};

// One representative m against the thread's register tile: the 8-channel
// distance product in the TPU kernel's order, folded into the running minima.
__device__ __forceinline__ void sweep_rep(const float4* s_rep, int m,
                                          const float (&a0)[kTP][kTQ],
                                          const float (&a1)[kTP][kTQ],
                                          const float (&a2)[kTP][kTQ], const float (&a3)[kTQ],
                                          float (&dmin)[kTP][kTQ]) {
  const float4 b = s_rep[2 * m];
  const float2 hl = *reinterpret_cast<const float2*>(s_rep + 2 * m + 1);
#pragma unroll
  for (int i = 0; i < kTP; ++i)
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      float d = __fmul_rn(a0[i][j], b.x);
      d = __fmaf_rn(a1[i][j], b.y, d);
      d = __fmaf_rn(a2[i][j], b.z, d);
      d = __fmaf_rn(a3[j], b.w, d);
      d = __fadd_rn(d, hl.x);
      d = __fadd_rn(d, hl.y);
      dmin[i][j] = fminf(dmin[i][j], d);
    }
}

template <bool kLinear>
__global__ void __launch_bounds__(kThreads, 4)
rank_kernel(const float* __restrict__ groups, const float* __restrict__ poses,
            const float* __restrict__ block, float* __restrict__ out, int hg, int k, int ld,
            int n_edge, int n_reps, float cx, float cy, float cz, float t2, float off, float t2s,
            float w_inf, float w_str, int npt, int cross) {
  extern __shared__ float4 smem[];
  const int pb = npt * kTP;
  const Layout lay(n_reps, pb, k);
  float4* s_rep = smem + lay.rep;
  float4* s_pose = smem + lay.pose;
  float4* s_pt = smem + lay.pt;
  int2* s_part = reinterpret_cast<int2*>(smem + lay.part);
  float* s_grp = reinterpret_cast<float*>(smem + lay.grp);
  __shared__ int s_ne, s_ns;

  const int g = blockIdx.x;
  const int p0 = blockIdx.y * pb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const float* grp = groups + (size_t)g * 8 * k;
  for (int i = tid; i < 5 * k; i += kThreads) s_grp[i] = grp[i];
  for (int m = tid; m < n_reps; m += kThreads) {
    s_rep[2 * m] = make_float4(block[m], block[ld + m], block[2 * ld + m], block[3 * ld + m]);
    s_rep[2 * m + 1] = make_float4(block[4 * ld + m], block[5 * ld + m], 0.0f, 0.0f);
  }
  if (tid < pb) {  // a pose past hg repeats the last one; its score is not written
    const float* q = poses + ((size_t)g * hg + min(p0 + tid, hg - 1)) * 16;
    float r[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) r[i] = q[i];
    const float t0 = __fsub_rn(q[9], cx), t1 = __fsub_rn(q[10], cy), t2_ = __fsub_rn(q[11], cz);
    float4* dst = s_pose + 4 * tid;
    if constexpr (kLinear) {
      // coefficient rows 0-2 (-2 R_i on x, y, z and -2 t_i on the ones channel)
      // and row 6 (2 R^T t on x, y, z, |t|^2 on the ones channel), as
      // score_kernel.coarse_linear_rows
      float rt[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        rt[i] = __fmaf_rn(r[6 + i], t2_, __fmaf_rn(r[3 + i], t1, __fmul_rn(r[i], t0)));
      const float tn = __fmaf_rn(t2_, t2_, __fmaf_rn(t1, t1, __fmul_rn(t0, t0)));
      dst[0] = make_float4(-2.0f * r[0], -2.0f * r[1], -2.0f * r[2], -2.0f * t0);
      dst[1] = make_float4(-2.0f * r[3], -2.0f * r[4], -2.0f * r[5], -2.0f * t1);
      dst[2] = make_float4(-2.0f * r[6], -2.0f * r[7], -2.0f * r[8], -2.0f * t2_);
      dst[3] = make_float4(2.0f * rt[0], 2.0f * rt[1], 2.0f * rt[2], tn);
    } else {
      dst[0] = make_float4(r[0], r[1], r[2], t0);
      dst[1] = make_float4(r[3], r[4], r[5], t1);
      dst[2] = make_float4(r[6], r[7], r[8], t2_);
      dst[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // eligible points of each kind that has representatives, compacted by a
    // warp ballot: edge points at [0, ne), surface points at [ne_p, ne_p + ns)
    const float* grp = s_grp;
    int base = 0, ne = 0;
#pragma unroll 1
    for (int kind = 1; kind >= 0; --kind) {
      const bool has_reps = cross ? n_reps > 0 : kind ? n_edge > 0 : n_reps > n_edge;
      const int start = base;
      for (int c = 0; has_reps && c < k; c += 32) {
        const int i = c + lane;
        const bool el =
            i < k && grp[4 * k + i] > 0.5f && (grp[3 * k + i] > 0.5f) == (kind == 1);
        const unsigned mask = __ballot_sync(0xffffffffu, el);
        if (el) {
          const int slot = base + __popc(mask & ((1u << lane) - 1u));
          const float x = grp[i], y = grp[k + i], z = grp[2 * k + i];
          const float w = __fmul_rn(off, grp[3 * k + i]);
          const float inel = __fmul_rn(__fsub_rn(1.0f, grp[4 * k + i]), kBig);
          s_pt[2 * slot] = make_float4(x, y, z, w);
          if constexpr (kLinear) {
            const float p2 = __fadd_rn(
                __fadd_rn(__fmaf_rn(z, z, __fmaf_rn(x, x, __fmul_rn(y, y))), __fmul_rn(w, w)),
                inel);
            const float hi = bf16_round(p2);
            s_pt[2 * slot + 1] = make_float4(hi, __fsub_rn(p2, hi), 0.0f, 0.0f);
          } else {
            s_pt[2 * slot + 1] = make_float4(inel, 0.0f, 0.0f, 0.0f);
          }
        }
        base += __popc(mask);
      }
      const int n = base - start;
      // pad the kind to whole tiles; padded points are computed but not counted
      for (int i = base + lane; i < start + (n + kTQ - 1) / kTQ * kTQ; i += 32) {
        s_pt[2 * i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        s_pt[2 * i + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      base = start + (n + kTQ - 1) / kTQ * kTQ;
      if (kind) ne = n;
      else if (lane == 0) { s_ne = ne; s_ns = n; }
    }
  }
  __syncthreads();

  const int ne = s_ne, ns = s_ns;
  const int tiles_e = (ne + kTQ - 1) / kTQ;
  const int tiles = tiles_e + (ns + kTQ - 1) / kTQ;
  const int pt = tid % npt;  // this thread's pose tile
  const int npl = kThreads / npt;
  int n_inf[kTP], n_str[kTP];
#pragma unroll
  for (int i = 0; i < kTP; ++i) n_inf[i] = n_str[i] = 0;

  for (int tile = tid / npt; tile < tiles; tile += npl) {
    const bool edge = tile < tiles_e;
    const int r0 = edge ? 0 : n_edge, r1 = edge ? n_edge : n_reps;
    // the other kind's representatives, swept after the own kind's with `cross`
    const int x0 = cross ? (edge ? n_edge : 0) : 0, x1 = cross ? (edge ? n_reps : n_edge) : 0;
    const int q0 = tile * kTQ;
    const int n_real = edge ? ne - q0 : ns - (q0 - tiles_e * kTQ);
    float a0[kTP][kTQ], a1[kTP][kTQ], a2[kTP][kTQ], tp2[kTP][kTQ], a3[kTQ];
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      const float4 p = s_pt[2 * (q0 + j)];
      const float4 ps = s_pt[2 * (q0 + j) + 1];
      a3[j] = -2.0f * p.w;
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        const float4* q = s_pose + 4 * (pt * kTP + i);
        const float4 q0r = q[0], q1r = q[1], q2r = q[2];
        if constexpr (kLinear) {
          const float4 q3r = q[3];
          // rows 0-2: fmul(W_i0, x), FMA W_i1 y, FMA W_i2 z, + (-2 t_i)
          a0[i][j] = __fadd_rn(__fmaf_rn(q0r.z, p.z, __fmaf_rn(q0r.y, p.y, __fmul_rn(q0r.x, p.x))),
                               q0r.w);
          a1[i][j] = __fadd_rn(__fmaf_rn(q1r.z, p.z, __fmaf_rn(q1r.y, p.y, __fmul_rn(q1r.x, p.x))),
                               q1r.w);
          a2[i][j] = __fadd_rn(__fmaf_rn(q2r.z, p.z, __fmaf_rn(q2r.y, p.y, __fmul_rn(q2r.x, p.x))),
                               q2r.w);
          // row 6: 2 R^T t . p, + p2_hi, + p2_lo, + |t|^2
          tp2[i][j] = __fadd_rn(
              __fadd_rn(__fadd_rn(__fmaf_rn(q3r.z, p.z, __fmaf_rn(q3r.y, p.y,
                                                                  __fmul_rn(q3r.x, p.x))),
                                  ps.x),
                        ps.y),
              q3r.w);
        } else {
          const float tx = __fadd_rn(
              __fmaf_rn(q0r.z, p.z, __fmaf_rn(q0r.x, p.x, __fmul_rn(q0r.y, p.y))), q0r.w);
          const float ty = __fadd_rn(
              __fmaf_rn(q1r.z, p.z, __fmaf_rn(q1r.x, p.x, __fmul_rn(q1r.y, p.y))), q1r.w);
          const float tz = __fadd_rn(
              __fmaf_rn(q2r.z, p.z, __fmaf_rn(q2r.x, p.x, __fmul_rn(q2r.y, p.y))), q2r.w);
          tp2[i][j] = __fadd_rn(
              __fadd_rn(__fmaf_rn(tz, tz, __fmaf_rn(tx, tx, __fmul_rn(ty, ty))),
                        __fmul_rn(p.w, p.w)),
              ps.x);
          a0[i][j] = -2.0f * tx;
          a1[i][j] = -2.0f * ty;
          a2[i][j] = -2.0f * tz;
        }
      }
    }

    float dmin[kTP][kTQ];
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int j = 0; j < kTQ; ++j) dmin[i][j] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 2
    for (int m = r0; m < r1; ++m) sweep_rep(s_rep, m, a0, a1, a2, a3, dmin);
#pragma unroll 1
    for (int m = x0; m < x1; ++m) sweep_rep(s_rep, m, a0, a1, a2, a3, dmin);
#pragma unroll
    for (int j = 0; j < kTQ; ++j) {
      if (j >= n_real) break;
#pragma unroll
      for (int i = 0; i < kTP; ++i) {
        const float hi = bf16_round(tp2[i][j]);
        const float lo = __fsub_rn(tp2[i][j], hi);
        const float d = __fadd_rn(__fadd_rn(dmin[i][j], hi), lo);
        n_inf[i] += d <= t2;
        n_str[i] += d <= t2s;
      }
    }
  }

  // partial counts per (thread, pose), summed in a fixed order per pose
#pragma unroll
  for (int i = 0; i < kTP; ++i) s_part[tid * kTP + i] = make_int2(n_inf[i], n_str[i]);
  __syncthreads();
  if (tid < pb && p0 + tid < hg) {
    const int t_pt = tid / kTP, i = tid % kTP;
    int ci = 0, cs = 0;
    for (int l = 0; l < npl; ++l) {
      const int2 c = s_part[(l * npt + t_pt) * kTP + i];
      ci += c.x;
      cs += c.y;
    }
    out[(size_t)g * hg + p0 + tid] =
        __fadd_rn(__fmul_rn(w_inf, (float)ci), __fmul_rn(w_str, (float)cs));
  }
}

// Pose tiles per block: the largest power of two <= kMaxPoseTiles that leaves
// no more than half of a block's pose tiles empty and puts at least two blocks
// on every SM.
inline int pose_tiles(int g, int hg, int sms) {
  int npt = kMaxPoseTiles;
  while (npt > 1) {
    const int pb = npt * kTP;
    const long blocks = (long)g * ((hg + pb - 1) / pb);
    if (pb / 2 < hg && blocks >= 2L * sms) break;
    npt /= 2;
  }
  return npt;
}

template <bool kLinear>
cudaError_t launch(const void* groups, const void* poses, const void* block, void* out, int g,
                   int hg, int k, int ld, int n_edge, int n_reps, float cx, float cy, float cz,
                   float t2, float off, float t2s, float w_inf, float w_str, int cross,
                   void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || n_reps < 0 || n_reps > ld || n_edge < 0 || n_edge > n_reps)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int npt = pose_tiles(g, hg, sms);
  const int pb = npt * kTP;
  const size_t smem = (size_t)Layout(n_reps, pb, k).total_bytes;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(rank_kernel<kLinear>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + pb - 1) / pb);
  rank_kernel<kLinear><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)poses, (const float*)block, (float*)out, hg, k, ld,
      n_edge, n_reps, cx, cy, cz, t2, off, t2s, w_inf, w_str, npt, cross);
  return cudaGetLastError();
}

}  // namespace coarse_rank
