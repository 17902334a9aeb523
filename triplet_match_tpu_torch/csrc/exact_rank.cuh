// Exact two-minimum rankers for Hopper (sm_90a): the device code that
// exact_rank.cu (TPU kernel B2, count mode) and full_rank.cu (TPU kernel B3,
// full mode) share.  Both replace triplet_match_tpu/search/score_pallas.py:_kernel
// (wrapper score_groups_pallas, pallas_call :596); kFull selects the full mode
// (:472-499).
//
// Contract.  For each pose of each group the kernel transforms the group's
// eligible scene points and takes, per point, the exact nearest-neighbour
// squared distance to the compact edge block and to the compact surface block
// of the model (two minima).  A point counts when its own-kind distance dk is
// within the gate t2 and no larger than the other kind's, do.  Count mode
// scores the count, or with the epilogue knobs the signed sum: `weighted`
// scores exp(-dk * inv2t) per counted point, `negative` subtracts
// exp(-do * inv2t) (or 1) per point whose other-kind neighbour is within the
// gate and nearer.  Full mode multiplies each counted point's term by its
// orientation weight w_at_min = |mean over the tie set of (R ref) . mref_m|,
// the tie set being the own-kind model points whose E lies within eps of the
// own-kind minimum.
//
// Arithmetic: the TPU kernel's float32 operations in its order — t - c (one
// subtraction, the wrapper's before), tp = R p + t, |tp|^2, R ref and the
// orientation product (R ref) . mref as fused multiply-add chains, the block
// product E = -2 tp . m + |m|^2 as an FMA chain in channel order,
// d2 = |tp|^2 + min_m E, the tie threshold emin + eps rounded to float32,
// w_at_min divided in float32 — written with explicit __fmaf_rn / __fmul_rn /
// __fadd_rn / __fsub_rn so the compiler cannot contract or reorder them.  The
// plain PyTorch versions (score_kernel.py score_groups_exact_plain,
// score_groups_full_plain) perform the same operations over every column of
// both blocks for every pair, so every distance the kernel takes agrees bit for
// bit and the counts exactly.  A min is exact in any order.  Sums run in
// double in a fixed order (deterministic, no atomics).
//
// What the kernel sweeps, and why that is exact:
//   - only eligible points (an ineligible point adds nothing to any output) and
//     only the blocks' real columns (the FAR padding can never be an eligible
//     point's nearest neighbour); on the fog route, which ranks on edge points
//     only, most of a ball is ineligible fog;
//   - the own-kind block for every (pose, eligible point) pair, and the
//     other-kind block only for the pairs whose dk <= t2, unless `negative` is
//     on.  A pair with dk > t2 is not counted whatever do is, so it adds
//     nothing to the count, to the weighted sum or to the full mode's sum; only
//     the negative term reads do without dk <= t2, so with `negative` every
//     pair sweeps both blocks;
//   - full mode's second pass (the tie set) only for counted pairs, over the
//     own-kind block, whose minimum the first pass holds: the TPU kernel takes
//     the argmin over the whole pack with a +BIG penalty on the other kind's
//     columns, so every other-kind column loses, and w_at_min only matters
//     where the pair counts.  The pass recomputes E with the same operations
//     on the same operand, so the minimum's own column is in the tie set.
//
// Diagnosis of the earlier design (one warp per pose, 4 points at a time,
// every lane sweeping a 32-strided slice of both blocks), from its SASS
// (sass_mix.py) and the shares chip_smoke.py measures, both in PERF.md.  Its
// column loop was sound (one 16-byte load per 20 fp32 instructions), but per
// 4-point chunk the warp spent ~650 more instructions outside it: all 32
// lanes built the same 4 operands, and the lanes' minima were combined by
// 5 x 4 shuffles and 20 mins per block, against only 19 (edge) or 56
// (surface) columns per lane; the chunks were padded over ~6 eligible points
// at the fog phase 1; every pair swept the other-kind block, though only
// 26-51 % of the pairs lie within the gate; and B3's second pass ran one
// counted point at a time, each ending in 5 rounds of a double and an int
// shuffle.  It ran at 26-48 % of the bound it was held to.
//
// Design: one block of kThreads = 256 threads per (group, tile of kTP * npt
// poses).  The prologue stages both blocks' real columns (x, y, z, |m|^2) and,
// in full mode, their reference vectors, and the block's poses (R rows, t - c)
// in shared memory; all warps then compact the group's eligible points by kind
// with a ballot (edge points, then surface points, each kind padded to whole
// tiles of kTQ).  Tiles of kTP = 2 poses x kTQ = 4 points of one kind go to
// the threads in rounds of 256: thread t keeps pose tile t % npt in every
// round.  A round:
//   1. own-kind pass: each thread builds its tile's operands (-2 tp, |tp|^2)
//      in registers and sweeps the own-kind block; every representative is one
//      broadcast 16-byte shared load feeding 8 evaluations, with no cross-lane
//      reduction.  The pairs that need the other minimum (dk <= t2, or all with
//      `negative`) are survivors;
//   2. a block-wide prefix of the survivor counts (warp shuffles, then the
//      warp totals) gives each survivor a slot in a shared list, edge points'
//      survivors first: the order is fixed, so are the sums;
//   3. the block sweeps the list over the other-kind block, dealt evenly:
//      ceil(n / 256) survivors a thread (each load feeding them all), at most
//      4 in count mode and 2 in full mode, which holds more registers for its
//      tie pass.  In full mode a thread's counted entries then sweep the
//      own-kind block once more together for the tie set, testing once per
//      column whether any entry ties: no shuffle, and a lane without a counted
//      entry skips the pass.  Each survivor gets (counted, term) back in its
//      slot;
//   4. each thread adds its own survivors' results, in its fixed order, to
//      its per-pose count and double sums.
// A last round of at most half the threads' tiles splits them into tiles of 2
// or 1 points, so that more threads share it.  At the end the per-(thread,
// pose) partials are summed per pose in a fixed order.  The launcher
// (score_kernel.exact_pose_tiles, passed in as npt) picks the largest npt (a
// power of two <= 256) that leaves at least two blocks per SM.
//
// Why these sizes: the fastest of those tried on the card at the main path's
// shapes, each compared within one call (PERF.md): 128 or 256 threads;
// at most 4, 3 or 2 blocks per SM; up to 32, 64, 128 or 256 pose tiles;
// survivor chunks of up to 2, 3, 4 or 8, by fit, by an instruction-count
// model or dealt evenly; the split last round or none; the model's reference
// vectors in shared or in device memory.  A clock-instrumented build (made
// for the sweep, not kept) showed most of a block's cycles in step 3, so 256
// threads (more warps for it) and even dealing won; the caps keep the kernels
// at 128 / 118 registers with no spills (full mode spilled with chunks of 4).
// 2 x 4 is the coarse rankers' best tile too (coarse_rank.cuh); 4 x 2 needs
// twice the partials.
//
// Bound on H100: FP32 issue.  Each (pose, eligible point, representative)
// evaluation is 5 fp32 instructions (mul, 2 FMA, add, min); the second pass is
// 5 per (counted pair, own-kind representative) (mul, 2 FMA, add, compare).
// What this run's data needs: own-kind columns for every eligible pair,
// other-kind columns only for the pairs within the gate (every pair with
// `negative`), the second pass, and each pair's operand (tp 12, |tp|^2 5) and
// each pose's t - c (3); chip_smoke.py counts this from the plain version's
// own-kind distances and prints beside it the both-blocks bound (both blocks
// for every pair), which the earlier design was held to.  Bytes are KB per
// block.  Tensor cores stay out: the block product at TF32 or a bf16 split
// rounds E otherwise near the gate, and the counts must equal the
// reference's (ROADMAP C4).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace exact_rank {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 2;                       // poses per thread tile
constexpr int kTQ = 4;                       // points (of one kind) per thread tile
constexpr int kList = kThreads * kTP * kTQ;  // survivor slots of one round
constexpr int kMaxPoseTiles = kThreads;
constexpr int kPoseBits = 10;                // pose index in a block < kTP kMaxPoseTiles
constexpr int kMinBlocks = 2;                // per SM: at most 128 registers a thread
constexpr int kMaxChunk = 4;                 // survivors a thread sweeps at a time (count mode)
constexpr int kMaxChunkFull = 2;             // (full mode, whose tie pass holds more registers)
static_assert(kTQ == 4, "the last round splits tiles into 2 and 1 points");
static_assert(kTP * kMaxPoseTiles <= (1 << kPoseBits), "a slot's pose index");

// Bytes of the list region: the survivors (int2 each) of one round, or at the
// end the per-(thread, pose) partials (a double2 and an int each).
constexpr int kListBytes = kList * 8 > kThreads * kTP * 20 ? kList * 8 : kThreads * kTP * 20;

// Shared-memory layout of one block, in float4 units.
struct Layout {
  int ref, pt, ptr, pose, list, total_bytes;
  __host__ __device__ Layout(bool full, int ne, int ns, int k, int pb) {
    const int r = ne + ns, kp = k + 2 * kTQ;
    ref = r;                        // [0, r) representatives x, y, z, |m|^2 (edge, surface);
                                    // full mode: [r, 2 r) their reference vectors
    pt = ref + (full ? r : 0);      // [kp] eligible points x, y, z, kind, compacted by kind
    ptr = pt + kp;                  // full mode: [kp] the points' reference vectors
    pose = ptr + (full ? kp : 0);   // [3 pb] R rows with (t - c) in .w
    list = pose + 3 * pb;           // kListBytes: the survivor list; the prologue's chunk
                                    // counts and the final partials use it too
    total_bytes = list * 16 + kListBytes;
  }
};

__device__ __forceinline__ float block_e(float a0, float a1, float a2, float4 b) {
  float e = __fmul_rn(a0, b.x);
  e = __fmaf_rn(a1, b.y, e);
  e = __fmaf_rn(a2, b.z, e);
  return __fadd_rn(e, b.w);
}

// one row of R times (x, y, z), in the TPU kernel's FMA order
__device__ __forceinline__ float rot_row(float4 row, float x, float y, float z) {
  return __fmaf_rn(row.z, z, __fmaf_rn(row.x, x, __fmul_rn(row.y, y)));
}

// -2 tp and |tp|^2 of one (pose, point) pair
__device__ __forceinline__ void operand(const float4* __restrict__ pose, float4 p, float& a0,
                                        float& a1, float& a2, float& tp2) {
  const float tx = __fadd_rn(rot_row(pose[0], p.x, p.y, p.z), pose[0].w);
  const float ty = __fadd_rn(rot_row(pose[1], p.x, p.y, p.z), pose[1].w);
  const float tz = __fadd_rn(rot_row(pose[2], p.x, p.y, p.z), pose[2].w);
  tp2 = __fmaf_rn(tz, tz, __fmaf_rn(tx, tx, __fmul_rn(ty, ty)));
  a0 = -2.0f * tx;
  a1 = -2.0f * ty;
  a2 = -2.0f * tz;
}

// per entry, min over the block's n columns of E
template <int N>
__device__ __forceinline__ void sweep(const float4* __restrict__ blk, int n, const float (&a0)[N],
                                      const float (&a1)[N], const float (&a2)[N],
                                      float (&emin)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) emin[j] = __int_as_float(0x7f800000);  // +inf
#pragma unroll 4
  for (int m = 0; m < n; ++m) {
    const float4 b = blk[m];
#pragma unroll
    for (int j = 0; j < N; ++j) emin[j] = fminf(emin[j], block_e(a0[j], a1[j], a2[j], b));
  }
}

// What a block shares: its staged arrays and the scalars.
struct Block {
  const float4* rep;  // [ne] edge, then [ns] surface representatives
  const float4* ref;  // full mode: their reference vectors
  const float4* pt;   // eligible points, edge ones at [0, ne_pad), surface ones after
  const float4* ptr;  // full mode: the points' reference vectors
  const float4* pose;
  int2* list;
  int* warp_sums;     // [kWarps]
  int ne, ns, tot_e, tot_s, ne_pad, npt, p0, hg;
  float t2, inv2t, eps;
  bool weighted, negative, signed_sum;
};

// Step 3 of a round: the survivors [0, n_se) (edge points) and [n_se, n_se +
// n_ss) (surface points), C to a thread, against the other kind's block; in
// full mode the counted ones once more against their own kind's block.  A slot
// holds (pose | point << kPoseBits, own-kind minimum) and gets back (1, positive
// term) for a counted pair, else (0, negative term): a pair never has both.
template <int C, bool kFull>
__device__ void sweep_survivors(const Block& b, int n_se, int n_ss) {
  const int ch_e = (n_se + C - 1) / C;
  const int chunks = ch_e + (n_ss + C - 1) / C;
  for (int ch = threadIdx.x; ch < chunks; ch += kThreads) {
    const bool edge = ch < ch_e;  // the survivors' own kind
    const int s0 = edge ? ch * C : n_se + (ch - ch_e) * C;
    const int n = min(C, (edge ? n_se : n_se + n_ss) - s0);
    float a0[C], a1[C], a2[C], tp2[C], eown[C];
    int ent[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int2 e = b.list[s0 + min(j, n - 1)];
      ent[j] = e.x;
      eown[j] = __int_as_float(e.y);
      operand(b.pose + 3 * (e.x & ((1 << kPoseBits) - 1)), b.pt[e.x >> kPoseBits], a0[j], a1[j],
              a2[j], tp2[j]);
    }
    float eo[C];
    sweep<C>(edge ? b.rep + b.ne : b.rep, edge ? b.ns : b.ne, a0, a1, a2, eo);
    bool ok[C];
    float dk[C], d_other[C];
    bool any_ok = false;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      dk[j] = __fadd_rn(tp2[j], eown[j]);  // the first pass's, bit for bit
      d_other[j] = __fadd_rn(tp2[j], eo[j]);
      ok[j] = j < n && dk[j] <= b.t2 && dk[j] <= d_other[j];
      any_ok |= ok[j];
    }
    float w_at_min[C];
#pragma unroll
    for (int j = 0; j < C; ++j) w_at_min[j] = 1.0f;
    if constexpr (kFull) {
      if (any_ok) {
        // the tie set E <= emin + eps over the own-kind block, for counted entries
        float thr[C], tr0[C], tr1[C], tr2[C];
        double wsum[C];
        int ties[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          thr[j] = ok[j] ? __fadd_rn(eown[j], b.eps) : __int_as_float(0xff800000);  // -inf
          const float4* pose = b.pose + 3 * (ent[j] & ((1 << kPoseBits) - 1));
          const float4 pr = b.ptr[ent[j] >> kPoseBits];
          tr0[j] = rot_row(pose[0], pr.x, pr.y, pr.z);
          tr1[j] = rot_row(pose[1], pr.x, pr.y, pr.z);
          tr2[j] = rot_row(pose[2], pr.x, pr.y, pr.z);
          wsum[j] = 0.0;
          ties[j] = 0;
        }
        const float4* blk = edge ? b.rep : b.rep + b.ne;
        const float4* ref = edge ? b.ref : b.ref + b.ne;
        const int nb = edge ? b.ne : b.ns;
#pragma unroll 4
        for (int m = 0; m < nb; ++m) {
          const float4 c = blk[m];
          float e[C];
          bool tie = false;
#pragma unroll
          for (int j = 0; j < C; ++j) {
            e[j] = block_e(a0[j], a1[j], a2[j], c);
            tie |= e[j] <= thr[j];
          }
          if (tie) {  // rare: the minimum's own column and its ties
            const float4 mr = ref[m];
#pragma unroll
            for (int j = 0; j < C; ++j) {
              if (e[j] <= thr[j]) {
                wsum[j] += (double)__fmaf_rn(tr2[j], mr.z,
                                             __fmaf_rn(tr1[j], mr.y, __fmul_rn(tr0[j], mr.x)));
                ++ties[j];
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < C; ++j)
          w_at_min[j] = fabsf(__fdiv_rn((float)wsum[j], (float)max(ties[j], 1)));
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j >= n) break;
      float pos = 0.0f, neg = 0.0f;
      if (b.signed_sum) {
        if (ok[j]) {
          const float term = b.weighted ? expf(__fmul_rn(-dk[j], b.inv2t)) : 1.0f;
          pos = kFull ? __fmul_rn(w_at_min[j], term) : term;
        }
        if (b.negative && d_other[j] <= b.t2 && d_other[j] < dk[j])
          neg = b.weighted ? expf(__fmul_rn(-d_other[j], b.inv2t)) : 1.0f;
      }
      b.list[s0 + j] = make_int2(ok[j] ? 1 : 0, __float_as_int(ok[j] ? pos : neg));
    }
  }
}


// One round: the virtual tiles v0 + threadIdx.x of TQ points (tile v: pose
// tile v % npt, slots (v / npt) TQ ...), steps 1-4; the thread's results go to
// its per-pose count and sums.
template <int TQ, bool kFull>
__device__ void run_round(const Block& b, int v0, int n_virtual, int (&cnt)[kTP],
                          double (&pos_sum)[kTP], double (&neg_sum)[kTP]) {
  constexpr int kN = kTP * TQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pt = tid % b.npt;  // this thread's pose tile, the same in every round
  // 1. own-kind pass over one tile
  const int v = v0 + tid;
  unsigned surv = 0;  // bit i * TQ + j: the pair needs the other kind
  bool edge = true;
  int q0 = 0;
  float eown[kN];
  if (v < n_virtual) {
    q0 = v / b.npt * TQ;
    edge = q0 < b.ne_pad;
    const int n_real = edge ? b.tot_e - q0 : b.tot_s - (q0 - b.ne_pad);
    float a0[kN], a1[kN], a2[kN], tp2[kN];
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const float4 p = b.pt[q0 + j];
#pragma unroll
      for (int i = 0; i < kTP; ++i)
        operand(b.pose + 3 * (pt * kTP + i), p, a0[i * TQ + j], a1[i * TQ + j], a2[i * TQ + j],
                tp2[i * TQ + j]);
    }
    sweep<kN>(edge ? b.rep : b.rep + b.ne, edge ? b.ne : b.ns, a0, a1, a2, eown);
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int j = 0; j < TQ; ++j) {
        const int e = i * TQ + j;
        if (j < n_real && b.p0 + pt * kTP + i < b.hg &&
            (b.negative || __fadd_rn(tp2[e], eown[e]) <= b.t2))
          surv |= 1u << e;
      }
  }
  // 2. slots: a block-wide prefix of the survivor counts, edge points' first
  const int mine = __popc(surv);
  const int val = edge ? mine : mine << 16;
  int incl = val;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) b.warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = b.warp_sums[w];
    all += s;
    before += w < warp ? s : 0;
  }
  const int excl = before + incl - val;
  const int n_se = all & 0xffff, n_ss = all >> 16;
  const int slot0 = edge ? (excl & 0xffff) : n_se + (excl >> 16);
  int slot = slot0;
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (surv & (1u << e))
      b.list[slot++] =
          make_int2((pt * kTP + e / TQ) | ((q0 + e % TQ) << kPoseBits), __float_as_int(eown[e]));
  __syncthreads();
  // 3. the survivors against the other kind (and full mode's tie set)
  // (ceil(n / kThreads) survivors a thread, up to the mode's cap, so that the
  // list spreads evenly over the warps and each load feeds them all)
  constexpr int kCap = kFull ? kMaxChunkFull : kMaxChunk;
  const int n_all = n_se + n_ss;
  if (kCap >= 4 && n_all > 3 * kThreads)
    sweep_survivors<(kCap >= 4 ? 4 : 1), kFull>(b, n_se, n_ss);
  else if (kCap >= 3 && n_all > 2 * kThreads)
    sweep_survivors<(kCap >= 3 ? 3 : 1), kFull>(b, n_se, n_ss);
  else if (kCap >= 2 && n_all > kThreads)
    sweep_survivors<(kCap >= 2 ? 2 : 1), kFull>(b, n_se, n_ss);
  else if (n_all > 0)
    sweep_survivors<1, kFull>(b, n_se, n_ss);
  __syncthreads();
  // 4. this thread's survivors' results, in its order
  slot = slot0;
#pragma unroll
  for (int e = 0; e < kN; ++e)
    if (surv & (1u << e)) {
      const int2 r = b.list[slot++];
      const double val_r = (double)__int_as_float(r.y);
      cnt[e / TQ] += r.x;
      if (r.x)
        pos_sum[e / TQ] += val_r;
      else
        neg_sum[e / TQ] += val_r;
    }
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rank_kernel(const float* __restrict__ groups, const float* __restrict__ poses,
            const float* __restrict__ me, int ne, int ld_e, const float* __restrict__ ms, int ns,
            int ld_s, const float* __restrict__ re, int ld_re, const float* __restrict__ rs,
            int ld_rs, float* __restrict__ score, int* __restrict__ count, int hg, int k, int npt,
            float cx, float cy, float cz, float t2, float inv2t, float eps, int weighted,
            int negative) {
  extern __shared__ float4 smem[];
  const int pb = npt * kTP;
  const Layout lay(kFull, ne, ns, k, pb);
  float4* s_rep = smem;
  float4* s_ref = smem + lay.ref;
  float4* s_pt = smem + lay.pt;
  float4* s_ptr = smem + lay.ptr;
  float4* s_pose = smem + lay.pose;
  int2* s_list = reinterpret_cast<int2*>(smem + lay.list);
  __shared__ int s_warp[kWarps];

  const int g = blockIdx.x;
  const int p0 = blockIdx.y * pb;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

#pragma unroll 4
  for (int i = tid; i < ne + ns; i += kThreads) {
    const bool e = i < ne;
    const float* src = e ? me + i : ms + (i - ne);
    const int ld = e ? ld_e : ld_s;
    s_rep[i] = make_float4(src[0], src[ld], src[2 * ld], src[3 * ld]);
    if constexpr (kFull) {
      const float* r = e ? re + i : rs + (i - ne);
      const int ldr = e ? ld_re : ld_rs;
      s_ref[i] = make_float4(r[0], r[ldr], r[2 * ldr], 0.0f);
    }
  }
  for (int i = tid; i < pb; i += kThreads) {  // a pose past hg repeats the last one
    const float* q = poses + ((size_t)g * hg + min(p0 + i, hg - 1)) * 16;
    s_pose[3 * i] = make_float4(q[0], q[1], q[2], __fsub_rn(q[9], cx));
    s_pose[3 * i + 1] = make_float4(q[3], q[4], q[5], __fsub_rn(q[10], cy));
    s_pose[3 * i + 2] = make_float4(q[6], q[7], q[8], __fsub_rn(q[11], cz));
  }

  // eligible points compacted by kind, all warps: per 32-point chunk the
  // ballot counts of edge and surface points, then each chunk's slots
  const float* grp = groups + (size_t)g * 8 * k;
  int* s_cnt = reinterpret_cast<int*>(s_list);  // [2 chunks]
  const int chunks = (k + 31) / 32;
  for (int c = warp; c < chunks; c += kWarps) {
    const int i = c * 32 + lane;
    const bool el = i < k && grp[4 * k + i] > 0.5f;
    const bool ed = el && grp[3 * k + i] > 0.5f;
    const unsigned be = __ballot_sync(0xffffffffu, ed), bs = __ballot_sync(0xffffffffu, el && !ed);
    if (lane == 0) {
      s_cnt[2 * c] = __popc(be);
      s_cnt[2 * c + 1] = __popc(bs);
    }
  }
  __syncthreads();
  int tot_e = 0, tot_s = 0;
  for (int c = lane; c < chunks; c += 32) {
    tot_e += s_cnt[2 * c];
    tot_s += s_cnt[2 * c + 1];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tot_e += __shfl_xor_sync(0xffffffffu, tot_e, o);
    tot_s += __shfl_xor_sync(0xffffffffu, tot_s, o);
  }
  const int tiles_e = (tot_e + kTQ - 1) / kTQ;
  const int tiles = tiles_e + (tot_s + kTQ - 1) / kTQ;
  const int ne_pad = tiles_e * kTQ;
  for (int c = warp; c < chunks; c += kWarps) {
    int be0 = 0, bs0 = 0;  // points of each kind in the chunks before c
    for (int c2 = lane; c2 < c; c2 += 32) {
      be0 += s_cnt[2 * c2];
      bs0 += s_cnt[2 * c2 + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      be0 += __shfl_xor_sync(0xffffffffu, be0, o);
      bs0 += __shfl_xor_sync(0xffffffffu, bs0, o);
    }
    const int i = c * 32 + lane;
    const bool el = i < k && grp[4 * k + i] > 0.5f;
    const bool ed = el && grp[3 * k + i] > 0.5f;
    const unsigned be = __ballot_sync(0xffffffffu, ed), bs = __ballot_sync(0xffffffffu, el && !ed);
    const unsigned below = (1u << lane) - 1u;
    if (el) {
      const int slot = ed ? be0 + __popc(be & below) : ne_pad + bs0 + __popc(bs & below);
      s_pt[slot] = make_float4(grp[i], grp[k + i], grp[2 * k + i], grp[3 * k + i]);
      if constexpr (kFull)
        s_ptr[slot] = make_float4(grp[5 * k + i], grp[6 * k + i], grp[7 * k + i], 0.0f);
    }
  }
  // pad each kind to whole tiles; padded points are computed, never counted
  for (int i = tot_e + tid; i < ne_pad; i += kThreads) s_pt[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = ne_pad + tot_s + tid; i < tiles * kTQ; i += kThreads)
    s_pt[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const Block b{s_rep, s_ref, s_pt, s_ptr, s_pose, s_list, s_warp, ne, ns, tot_e, tot_s,
                ne_pad, npt, p0, hg, t2, inv2t, eps, weighted != 0, negative != 0,
                kFull || weighted != 0 || negative != 0};
  int cnt[kTP];
  double pos_sum[kTP], neg_sum[kTP];
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    cnt[i] = 0;
    pos_sum[i] = neg_sum[i] = 0.0;
  }
  // rounds of kThreads tiles; a last round of at most half that many splits
  // its tiles into 2 or 1 points, so more threads share it
  const int total = tiles * npt;
  for (int base = 0; base < total; base += kThreads) {
    const int left = total - base;
    if (2 * left > kThreads) {
      run_round<kTQ, kFull>(b, base, total, cnt, pos_sum, neg_sum);
    } else if (4 * left > kThreads) {
      run_round<kTQ / 2, kFull>(b, 2 * base, 2 * total, cnt, pos_sum, neg_sum);
    } else {
      run_round<kTQ / 4, kFull>(b, 4 * base, 4 * total, cnt, pos_sum, neg_sum);
    }
  }

  // partials per (thread, pose), summed per pose in a fixed order
  __syncthreads();
  double2* s_pd = reinterpret_cast<double2*>(s_list);            // [kThreads kTP]
  int* s_pc = reinterpret_cast<int*>(s_pd + kThreads * kTP);     // [kThreads kTP]
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    s_pd[tid * kTP + i] = make_double2(pos_sum[i], neg_sum[i]);
    s_pc[tid * kTP + i] = cnt[i];
  }
  __syncthreads();
  for (int pp = tid; pp < pb && p0 + pp < hg; pp += kThreads) {
    const int t_pt = pp / kTP, i = pp % kTP;
    int c = 0;
    double ps = 0.0, ng = 0.0;
    for (int l = 0; l < kThreads / npt; ++l) {
      const int o = (l * npt + t_pt) * kTP + i;
      c += s_pc[o];
      ps += s_pd[o].x;
      ng += s_pd[o].y;
    }
    const size_t o = (size_t)g * hg + p0 + pp;
    count[o] = c;
    score[o] = b.signed_sum ? (float)(ps - ng) : (float)c;
  }
}

template <bool kFull>
cudaError_t launch(const void* groups, const void* poses, const void* me, int ne, int ld_e,
                   const void* ms, int ns, int ld_s, const void* re, int ld_re, const void* rs,
                   int ld_rs, void* score, void* count, int g, int hg, int k, int npt, float cx,
                   float cy, float cz, float t2, float inv2t, float eps, int weighted,
                   int negative, void* stream) {
  if (g <= 0 || hg <= 0 || k <= 0 || ne <= 0 || ns <= 0 || ld_e < ne || ld_s < ns ||
      npt <= 0 || npt > kMaxPoseTiles || (npt & (npt - 1)) != 0 ||
      (k + 31) / 32 * 2 * 4 > kListBytes)
    return cudaErrorInvalidValue;
  if (kFull && (ld_re < ne || ld_rs < ns)) return cudaErrorInvalidValue;
  const int pb = npt * kTP;
  const size_t smem = (size_t)Layout(kFull, ne, ns, k, pb).total_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(g, (hg + pb - 1) / pb);
  rank_kernel<kFull><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)groups, (const float*)poses, (const float*)me, ne, ld_e, (const float*)ms,
      ns, ld_s, (const float*)re, ld_re, (const float*)rs, ld_rs, (float*)score, (int*)count, hg,
      k, npt, cx, cy, cz, t2, inv2t, eps, weighted, negative);
  return cudaGetLastError();
}

}  // namespace exact_rank
