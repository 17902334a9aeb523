// The join's scoring pass for Hopper (sm_90a): every (pose, scene point) of
// one finish_find call in one launch, bit for bit with the plain pass.
//
// Replaces no TPU kernel.  The JAX package leaves this pass to XLA, which
// fuses it; the port's plain version (search/score._score_points, which the
// wrapper search/score.finish_find takes on the CPU) is some 65 PyTorch ops a
// call with the one-read voxel table and 190 with the exact 2x2x2 one, each
// a launch over [poses, points] arrays with [poses, points, 3] temporaries
// between them.  The join calls it about 20 times a round.
//
// Per (pose, point): the transform, the voxel-table lookup (one LUT read, or
// the exact variant's eight reads and arg-min with the plain pass's tie
// order), the distance gate, validity, claims, bounds, the tangent test of
// samples_on_all=False, the kind test, the distance weight, the orientation
// weight and the negative score.  Outputs: ok and model_idx per pair (or
// nothing, in count-only mode) and, per pose, the count (exact, int64) and the
// score (float32, a fixed-order sum).
//
// Bit for bit: ok, model_idx and count depend on the float32 roundings of the
// gate (dist_thres x resolution), the transform, the voxel coordinates, the
// squared distances and the norms.  Each is written below with explicit
// round-to-nearest intrinsics in the order the plain pass's own ops take on
// the card (torch 2.11, CUDA 12.8; measured against candidates on an H100):
// cuBLAS's FMA chain over k = 0, 1, 2 for the [.., 3] x [3, 3] products, then
// a separate add; ATen's reduction of a 3-wide last dimension, (x0^2 + x2^2)
// + x1^2 with each square rounded, for both torch.linalg.vector_norm (then a
// rounded sqrt) and (d * d).sum(-1).  The model's edge test |tangent| > 0.7
// takes that same norm, so the kernel reads the model's own arrays and holds
// no table of its own.  The orders are those of the shapes where parity is
// checked: the card tests' and every pass of chip_smoke.py's main paths
// (its join audit).  cuBLAS may pick another gemm at another shape, and the
// kernel would not follow it there; the audit is what would show it.
//
// Bound: bytes.  Per pair it reads the scene point's position and flags (15
// bytes; its 12-byte reference direction only where the pair scores), one or
// eight int64 LUT entries (the 512^3 table is 1 GiB, beyond L2) and one or
// eight model positions (L2-resident), and writes 9 bytes of ok and
// model_idx; a few dozen fp32 instructions each.  The join's passes are small
// ([4, 65536] pairs under the subset join), so each pair's chain of dependent
// loads (point, LUT, model row) sets the time.  Design: one thread per (pose,
// point), one pose per block row (grid.y), so that as many chains as the card
// holds are in flight at once; the pose and the voxel map sit in registers,
// and a shared scene's points are re-read by every pose from L2.  Read-only
// data goes through the non-coherent cache (__ldg).  Scores and counts reduce
// in a fixed order: a shuffle tree, the warps in order, one partial per
// block, then a second kernel sums each pose's partials in a fixed tree.  No
// float atomics, so two launches on the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace join_score {

constexpr int THREADS = 256;  // threads per block: one (pose, point) each

struct Args {
  const float* poses;    // [P, 16] row-major 4x4, scene -> model
  const float* dist_p;   // [P] per-pose dist_thres, or null: dist
  float dist;            // dist_thres (a float32 value)
  const float* res;      // [1] the model's resolution: gate = dist_thres x resolution
  const float* xyz;      // [B, N, 3]: pose p reads scene batch p % B
  const float* normal;
  const float* tangent;
  const unsigned char* valid;  // [B, N] bool
  const unsigned char* tmask;
  const unsigned char* consumed;
  int n, batches;
  const float* mxyz;     // [M, 3] the model's points
  const float* mnormal;  // [M, 3]
  const float* mtangent;  // [M, 3]
  const long long* lut;  // [ex, ey, ez] row-major
  int ex, ey, ez;
  const float* to_voxel;  // [4, 4] row-major world -> voxel affine
  int exact, weighted, negative, on_all;
  unsigned char* ok;  // [P, N] or null (count only)
  long long* midx;    // [P, N] or null
  float* part;        // [3, P, nblk]: positive score, negative score, count (int
                      // bits); nblk = ceil(N / THREADS), sized by join_score_part_floats
  int nblk;
  float* score;       // [P]
  long long* count;   // [P]
};

// y_i = (sum_k a_k m_ik) + m_i3, as cuBLAS's FMA chain over k and a separate add
__device__ __forceinline__ float affine_row(float a0, float a1, float a2, float m0, float m1,
                                            float m2, float m3) {
  return __fadd_rn(__fmaf_rn(a2, m2, __fmaf_rn(a1, m1, __fmul_rn(a0, m0))), m3);
}

// x0 + x1 + x2 over a 3-wide last dimension, in ATen's reduction order
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(x0, x2), x1);
}

__device__ __forceinline__ float sum_sq(float d0, float d1, float d2) {
  return sum3(__fmul_rn(d0, d0), __fmul_rn(d1, d1), __fmul_rn(d2, d2));
}

// squared distance from (t0, t1, t2) to model point m
__device__ __forceinline__ float model_d2(const Args& a, long long m, float t0, float t1,
                                          float t2) {
  const float* q = a.mxyz + 3 * m;
  return sum_sq(__fsub_rn(t0, __ldg(q)), __fsub_rn(t1, __ldg(q + 1)),
                __fsub_rn(t2, __ldg(q + 2)));
}

__device__ __forceinline__ long long lut_at(const Args& a, long long i, long long j, long long k) {
  const long long c0 = min(max(i, 0LL), (long long)a.ex - 1);
  const long long c1 = min(max(j, 0LL), (long long)a.ey - 1);
  const long long c2 = min(max(k, 0LL), (long long)a.ez - 1);
  return __ldg(a.lut + (c0 * a.ey + c1) * a.ez + c2);
}

__device__ __forceinline__ bool in_grid(const Args& a, long long i, long long j, long long k) {
  return i >= 0 && i < a.ex && j >= 0 && j < a.ey && k >= 0 && k < a.ez;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS) score_kernel(const Args a) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float s_pos = 0.0f, s_neg = 0.0f;
  int cnt = 0;
  if (i < a.n) {
    float r[12], v[12];
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      r[q] = __ldg(a.poses + p * 16 + q);
      v[q] = __ldg(a.to_voxel + q);
    }
    const float thr = __fmul_rn(a.dist_p ? __ldg(a.dist_p + p) : a.dist, __ldg(a.res));
    const long long si = (long long)(p % a.batches) * a.n + i;
    const float p0 = __ldg(a.xyz + 3 * si), p1 = __ldg(a.xyz + 3 * si + 1),
                p2 = __ldg(a.xyz + 3 * si + 2);
    const float t0 = affine_row(p0, p1, p2, r[0], r[1], r[2], r[3]);
    const float t1 = affine_row(p0, p1, p2, r[4], r[5], r[6], r[7]);
    const float t2 = affine_row(p0, p1, p2, r[8], r[9], r[10], r[11]);
    const float v0 = affine_row(t0, t1, t2, v[0], v[1], v[2], v[3]);
    const float v1 = affine_row(t0, t1, t2, v[4], v[5], v[6], v[7]);
    const float v2 = affine_row(t0, t1, t2, v[8], v[9], v[10], v[11]);
    long long m;
    bool inb;
    if (a.exact) {
      // voxel_query_exact: the arg-min over the 2x2x2 voxels around the
      // point, strict <, in (dx, dy, dz) order from index 0 at +inf
      const long long b0 = (long long)floorf(__fsub_rn(v0, 0.5f));
      const long long b1 = (long long)floorf(__fsub_rn(v1, 0.5f));
      const long long b2 = (long long)floorf(__fsub_rn(v2, 0.5f));
      long long idx[8];  // the eight reads first, so they are in flight together
#pragma unroll
      for (int c = 0; c < 8; ++c)
        idx[c] = lut_at(a, b0 + (c >> 2), b1 + ((c >> 1) & 1), b2 + (c & 1));
      float best = CUDART_INF_F;
      m = 0;
      inb = false;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const bool in = in_grid(a, b0 + (c >> 2), b1 + ((c >> 1) & 1), b2 + (c & 1));
        const float d2 = in ? model_d2(a, idx[c], t0, t1, t2) : CUDART_INF_F;
        if (d2 < best) {
          best = d2;
          m = idx[c];
        }
        inb = inb || in;
      }
    } else {
      const long long i0 = (long long)floorf(v0), i1 = (long long)floorf(v1),
                      i2 = (long long)floorf(v2);
      inb = in_grid(a, i0, i1, i2);
      m = lut_at(a, i0, i1, i2);
    }
    const float dist = __fsqrt_rn(model_d2(a, m, t0, t1, t2));
    const bool use_tan = a.tmask[si] != 0;
    bool elig = a.valid[si] && !a.consumed[si] && inb && dist <= thr;
    if (!a.on_all && elig) {
      const float* g = a.tangent + 3 * si;
      elig = __fsqrt_rn(sum_sq(__ldg(g), __ldg(g + 1), __ldg(g + 2))) > 0.7f;
    }
    bool ok = false;
    if (elig) {
      const float* mt = a.mtangent + 3 * m;
      const float m0 = __ldg(mt), m1 = __ldg(mt + 1), m2 = __ldg(mt + 2);
      const bool is_tan = __fsqrt_rn(sum_sq(m0, m1, m2)) > 0.7f;
      const float weight = a.weighted ? expf(__fdiv_rn(__fmul_rn(-dist, dist),
                                                       __fmul_rn(2.0f, thr)))
                                      : 1.0f;
      ok = use_tan == is_tan;
      if (ok) {
        const float* e = (use_tan ? a.tangent : a.normal) + 3 * si;
        const float e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2);
        const float* rn = is_tan ? mt : a.mnormal + 3 * m;
        const float u0 = __fmaf_rn(e2, r[2], __fmaf_rn(e1, r[1], __fmul_rn(e0, r[0])));
        const float u1 = __fmaf_rn(e2, r[6], __fmaf_rn(e1, r[5], __fmul_rn(e0, r[4])));
        const float u2 = __fmaf_rn(e2, r[10], __fmaf_rn(e1, r[9], __fmul_rn(e0, r[8])));
        const float dot = sum3(__fmul_rn(u0, __ldg(rn)), __fmul_rn(u1, __ldg(rn + 1)),
                               __fmul_rn(u2, __ldg(rn + 2)));
        s_pos = __fmul_rn(weight, fabsf(dot));
        cnt = 1;
      } else if (a.negative) {
        s_neg = weight;
      }
    }
    if (a.ok) {
      const long long pi = (long long)p * a.n + i;
      a.ok[pi] = ok;
      a.midx[pi] = m;
    }
  }
  __shared__ float sh_pos[THREADS / 32], sh_neg[THREADS / 32];
  __shared__ int sh_cnt[THREADS / 32];
  s_pos = warp_sum(s_pos);
  s_neg = warp_sum(s_neg);
  cnt = warp_sum(cnt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_pos[warp] = s_pos;
    sh_neg[warp] = s_neg;
    sh_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sp = 0.0f, sn = 0.0f;
    int c = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      sp = __fadd_rn(sp, sh_pos[w]);
      sn = __fadd_rn(sn, sh_neg[w]);
      c += sh_cnt[w];
    }
    const long long slot = (long long)p * a.nblk + blockIdx.x;
    const long long plane = (long long)gridDim.y * a.nblk;
    a.part[slot] = sp;
    a.part[plane + slot] = sn;
    reinterpret_cast<int*>(a.part)[2 * plane + slot] = c;
  }
}

// one block per pose: its partials in a fixed tree, then score = pos - neg
__global__ void __launch_bounds__(THREADS) reduce_kernel(const Args a, int poses) {
  const int p = blockIdx.x;
  const long long plane = (long long)poses * a.nblk;
  const float* pos = a.part + (long long)p * a.nblk;
  const float* neg = pos + plane;
  const int* cnt = reinterpret_cast<const int*>(pos + 2 * plane);
  float sp = 0.0f, sn = 0.0f;
  long long c = 0;
  for (int j = threadIdx.x; j < a.nblk; j += THREADS) {
    sp = __fadd_rn(sp, pos[j]);
    sn = __fadd_rn(sn, neg[j]);
    c += cnt[j];
  }
  __shared__ float sh_pos[THREADS], sh_neg[THREADS];
  __shared__ long long sh_cnt[THREADS];
  sh_pos[threadIdx.x] = sp;
  sh_neg[threadIdx.x] = sn;
  sh_cnt[threadIdx.x] = c;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sh_pos[threadIdx.x] = __fadd_rn(sh_pos[threadIdx.x], sh_pos[threadIdx.x + s]);
      sh_neg[threadIdx.x] = __fadd_rn(sh_neg[threadIdx.x], sh_neg[threadIdx.x + s]);
      sh_cnt[threadIdx.x] += sh_cnt[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.score[p] = __fsub_rn(sh_pos[0], sh_neg[0]);
    a.count[p] = sh_cnt[0];
  }
}

}  // namespace join_score

extern "C" {

int join_score_launch(const float* poses, int n_poses, const float* dist_p, float dist,
                      const float* res, const float* xyz, const float* normal,
                      const float* tangent, const unsigned char* valid,
                      const unsigned char* tmask, const unsigned char* consumed, int n,
                      int batches, const float* mxyz, const float* mnormal,
                      const float* mtangent, const long long* lut, int ex, int ey, int ez,
                      const float* to_voxel, int exact, int weighted, int negative, int on_all,
                      unsigned char* ok, long long* midx, float* part, float* score,
                      long long* count, cudaStream_t stream) {
  join_score::Args a;
  a.poses = poses;
  a.dist_p = dist_p;
  a.dist = dist;
  a.res = res;
  a.xyz = xyz;
  a.normal = normal;
  a.tangent = tangent;
  a.valid = valid;
  a.tmask = tmask;
  a.consumed = consumed;
  a.n = n;
  a.batches = batches;
  a.mxyz = mxyz;
  a.mnormal = mnormal;
  a.mtangent = mtangent;
  a.lut = lut;
  a.ex = ex;
  a.ey = ey;
  a.ez = ez;
  a.to_voxel = to_voxel;
  a.exact = exact;
  a.weighted = weighted;
  a.negative = negative;
  a.on_all = on_all;
  a.ok = ok;
  a.midx = midx;
  a.part = part;
  a.nblk = (n + join_score::THREADS - 1) / join_score::THREADS;
  a.score = score;
  a.count = count;
  join_score::score_kernel<<<dim3(a.nblk, n_poses), join_score::THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  join_score::reduce_kernel<<<n_poses, join_score::THREADS, 0, stream>>>(a, n_poses);
  return (int)cudaGetLastError();
}

// floats of the per-block partials (the launcher's `part`) for n points and
// n_poses poses
long long join_score_part_floats(int n, int n_poses) {
  return 3LL * n_poses * ((n + join_score::THREADS - 1) / join_score::THREADS);
}

const char* join_score_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
