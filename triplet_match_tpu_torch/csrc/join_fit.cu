// The join's pose fit for Hopper (sm_90a): one ICP or polish step's fit of
// every pose of a call in one launch.
//
// Replaces no TPU kernel.  The JAX package leaves the fits to XLA; the
// port's plain fit (refine/icp._fit_plain, which the wrapper
// refine/icp._fit takes on CPU tensors) is
// core/transforms.weighted_kabsch (some 50 PyTorch ops with a cuSOLVER
// batched SVD and an LU determinant) or gauss_newton_pose_step with the
// polish's weights, transform_points and `upd @ t` (some 120-160 ops), with
// [poses, points, 3, 3] or [poses, 6, points, 3] temporaries between them.
// The join calls it 10-16 times a search.
//
// Per pose, over its corrs (ok, model_idx of the step's scoring pass):
//   - the weight: 1 on a corr; under edges_only, the corrs on raw edges
//     (the tangent mask) alone where a pose has 12 or more of them, else
//     all; under orient, times |(R ref) . ref_n| (the scene's tangent or
//     normal by its mask, the model's tangent where |tangent| > 0.7, else
//     its normal);
//   - Kabsch (weighted_kabsch): the weighted means and cov(dst, src) about
//     them, the rotation U diag(1, 1, sign det(U V^T)) V^T of its SVD and
//     t = mu_dst - R mu_src; identity where the weights sum to <= 1e-12;
//   - Gauss-Newton (gauss_newton_pose_step, then `upd @ t`): the 6x6 normal
//     equations of the hybrid point-to-plane / point-to-line objective at
//     the transformed points, damped by 1e-6 * trace / 6, solved, turned
//     into a rotation by Rodrigues' formula (axis guarded at angle 1e-12)
//     and composed onto the pose;
//   - with `count`, a pose whose step scored fewer than 3 corrs keeps its
//     pose (the polish's select).
//
// Precision: weighted_kabsch warns that raw float32 second moments lose the
// pose's digits to cancellation.  Here every product and sum is float64 (the
// float32 inputs widened exactly), raw moments included: at a few metres
// from the origin and a spread of centimetres the cancellation costs some 4
// of float64's 16 digits.  The 3x3 SVD (one-sided Jacobi) and the 6x6 solve
// (Gaussian elimination, partial pivoting) run in float64 too; the pose is
// rounded to float32 once, at the end.  So the kernel is the plain fit
// evaluated in float64 up to that rounding, nearer to it than the plain fit
// in float32, whose own error the tests and chip_smoke.py's audit bound it by.
// The rotation is taken as u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T from the
// two largest singular pairs: that is U diag(1, 1, sign det(U V^T)) V^T,
// the one proper rotation of that form, and needs no third singular vector.
//
// Bound: bytes, and not many.  A pose reads its corrs' flags (1 byte a scene
// point) and, for each corr, its model index, the scene point and the model
// point (32 bytes; the directions too under orient or Gauss-Newton): some
// 0.3-0.6 MB a call at the join's shapes, a few microseconds of the card's
// bandwidth, below the launches' own latency.  What the kernel removes is
// the host's enqueue of the plain fit's ops.  Design: a moments kernel
// with one pose per block row (grid.y) and blocks over the points; each
// thread sums PER_THREAD points into float64 registers, a block reduces them
// in a fixed order (a shuffle tree, then the warps in order) into one
// partial per block, and a solve kernel, one warp per pose, sums a pose's
// partials in a fixed order and solves.  No atomics, so two launches on the
// same inputs give the same bits.  Under edges_only the edge corrs and the
// others are summed apart, with the edge count, so that one pass serves
// both sides of the 12-corr fallback.
//
// Under a scene-sharded mesh the fit splits at the per-pose totals: each
// shard's launch stops after them (join_fit_launch with `tot`), the caller
// sums the [P, NACC] float64 totals over the shards in one collective, and
// join_fit_solve solves from the sums, the same on every shard.  The raw
// moments need that one sum; the plain fit's centred Kabsch needs two (the
// means, then the covariance about them).  The edge count is one of the
// totals, so the 12-corr fallback reads the whole scene's count.

#include <cuda_runtime.h>

namespace join_fit {

constexpr int THREADS = 128;   // threads of a moments block
constexpr int PER_THREAD = 8;  // points a thread sums: a block takes SPAN points
constexpr int SPAN = THREADS * PER_THREAD;
constexpr int KABSCH = 16;     // w, w src (3), w dst (3), w dst src^T (9)
constexpr int GAUSS = 27;      // A's upper triangle (21), b (6)

struct Args {
  const float* poses;   // [P, 16] row-major 4x4 scene -> model: the step's start
  const float* xyz;     // [B, N, 3]: pose p reads scene batch p % B
  const float* normal;
  const float* tangent;
  const unsigned char* tmask;  // [B, N] bool: the scene's tangent (or raw-edge) mask
  int n, batches;
  const unsigned char* valid;  // [P, N] bool: the corrs
  const long long* midx;       // [P, N]
  const long long* count;      // [P], or null: no keep test
  const float* mxyz;           // [M, 3] the model's points
  const float* mnormal;
  const float* mtangent;
  int orient;
  int nblk;                    // moments blocks per pose: ceil(N / SPAN)
  double* part;                // [P, nblk, NACC], written by the moments kernel
  double* tot;                 // [P, NACC], or null: the solve kernel writes the totals
                               // there and stops
  float* out;                  // [P, 16]
};

// |v| > 0.7 of a float32 3-vector as the plain fit's torch.linalg.vector_norm
// rounds it on the card: (x0^2 + x2^2) + x1^2, then a rounded sqrt
__device__ __forceinline__ bool is_edge_dir(float m0, float m1, float m2) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(m0, m0), __fmul_rn(m2, m2)),
                              __fmul_rn(m1, m1))) > 0.7f;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// one corr's terms: Kabsch's moments or Gauss-Newton's normal equations
template <bool GN>
__device__ __forceinline__ void terms(const Args& a, const float* r, long long si, long long m,
                                      double* c) {
  const double s0 = __ldg(a.xyz + 3 * si), s1 = __ldg(a.xyz + 3 * si + 1),
               s2 = __ldg(a.xyz + 3 * si + 2);
  const float* q = a.mxyz + 3 * m;
  const double d0 = __ldg(q), d1 = __ldg(q + 1), d2 = __ldg(q + 2);
  double w = 1.0;
  bool edge = false;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f;  // the model's direction
  if (GN || a.orient) {
    const float* mt = a.mtangent + 3 * m;
    const float t0 = __ldg(mt), t1 = __ldg(mt + 1), t2 = __ldg(mt + 2);
    edge = is_edge_dir(t0, t1, t2);
    const float* mn = a.mnormal + 3 * m;
    n0 = edge ? t0 : __ldg(mn);
    n1 = edge ? t1 : __ldg(mn + 1);
    n2 = edge ? t2 : __ldg(mn + 2);
  }
  if (a.orient) {
    const float* e = (a.tmask[si] ? a.tangent : a.normal) + 3 * si;
    const double e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2);
    const double u0 = (double)r[0] * e0 + (double)r[1] * e1 + (double)r[2] * e2;
    const double u1 = (double)r[4] * e0 + (double)r[5] * e1 + (double)r[6] * e2;
    const double u2 = (double)r[8] * e0 + (double)r[9] * e1 + (double)r[10] * e2;
    w = fabs(u0 * n0 + u1 * n1 + u2 * n2);
  }
  if (!GN) {
    const double s[3] = {s0, s1, s2}, d[3] = {d0, d1, d2};
    c[0] = w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[1 + k] = w * s[k];
      c[4 + k] = w * d[k];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) c[7 + 3 * i + j] = w * d[i] * s[j];
    return;
  }
  // the transformed point p, the unit direction m, and M v: (v . m) m on a
  // surface corr, v - (v . m) m on an edge corr
  const double p0 = (double)r[0] * s0 + (double)r[1] * s1 + (double)r[2] * s2 + (double)r[3];
  const double p1 = (double)r[4] * s0 + (double)r[5] * s1 + (double)r[6] * s2 + (double)r[7];
  const double p2 = (double)r[8] * s0 + (double)r[9] * s1 + (double)r[10] * s2 + (double)r[11];
  double m0 = n0, m1 = n1, m2 = n2;
  const double inv = 1.0 / fmax(sqrt(m0 * m0 + m1 * m1 + m2 * m2), 1e-12);
  m0 *= inv;
  m1 *= inv;
  m2 *= inv;
  // J = [-[p]x | I], column by column; then M J and M (p - d)
  double col[7][3] = {{0.0, -p2, p1}, {p2, 0.0, -p0}, {-p1, p0, 0.0}, {1.0, 0.0, 0.0},
                      {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}, {p0 - d0, p1 - d1, p2 - d2}};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const double along = col[k][0] * m0 + col[k][1] * m1 + col[k][2] * m2;
    col[k][0] = edge ? col[k][0] - along * m0 : along * m0;
    col[k][1] = edge ? col[k][1] - along * m1 : along * m1;
    col[k][2] = edge ? col[k][2] - along * m2 : along * m2;
  }
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j)
      c[k++] = w * (col[i][0] * col[j][0] + col[i][1] * col[j][1] + col[i][2] * col[j][2]);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    c[21 + i] = -w * (col[i][0] * col[6][0] + col[i][1] * col[6][1] + col[i][2] * col[6][2]);
}

// per block, per pose: the moments of its SPAN points, or, under SPLIT, those
// of the edge corrs, of the others, and the edge corrs' count
template <bool GN, bool SPLIT>
__global__ void __launch_bounds__(THREADS) moments_kernel(const Args a) {
  constexpr int K = GN ? GAUSS : KABSCH;
  constexpr int NACC = SPLIT ? 2 * K + 1 : K;
  const int p = blockIdx.y;
  const long long b = p % a.batches;
  float r[12];  // the pose's top rows, widened where they are used
#pragma unroll
  for (int q = 0; q < 12; ++q) r[q] = __ldg(a.poses + 16 * p + q);
  double acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0;
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = blockIdx.x * SPAN + j * THREADS + threadIdx.x;
    if (i >= a.n) break;
    const long long pi = (long long)p * a.n + i;
    if (!a.valid[pi]) continue;
    const long long si = b * a.n + i;
    double c[K];
    terms<GN>(a, r, si, a.midx[pi], c);
    if (SPLIT) {
      const bool e = a.tmask[si] != 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] += e ? c[k] : 0.0;
        acc[K + k] += e ? 0.0 : c[k];
      }
      acc[2 * K] += e ? 1.0 : 0.0;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += c[k];
    }
  }
  __shared__ double sh[THREADS / 32][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) sh[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NACC; k += THREADS) {
    double s = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) s += sh[w][k];
    a.part[((long long)p * a.nblk + blockIdx.x) * NACC + k] = s;
  }
}

__device__ __forceinline__ void cross(const double* u, const double* v, double* o) {
  o[0] = u[1] * v[2] - u[2] * v[1];
  o[1] = u[2] * v[0] - u[0] * v[2];
  o[2] = u[0] * v[1] - u[1] * v[0];
}

// a unit vector orthogonal to the unit vector u
__device__ void orthogonal(const double* u, double* o) {
  const int k = fabs(u[0]) <= fabs(u[1]) ? (fabs(u[0]) <= fabs(u[2]) ? 0 : 2)
                                         : (fabs(u[1]) <= fabs(u[2]) ? 1 : 2);
  double e[3] = {0.0, 0.0, 0.0};
  e[k] = 1.0;
  cross(u, e, o);
  const double l = sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
  o[0] /= l;
  o[1] /= l;
  o[2] /= l;
}

// R = U diag(1, 1, sign det(U V^T)) V^T of s = U S V^T (row-major 3x3), by
// one-sided Jacobi: rotations V on the right until the columns of s V are
// orthogonal; their norms are the singular values, their directions U
__device__ void kabsch_rotation(const double* s, double* rot) {
  double x[3][3], v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) x[i][j] = s[3 * i + j];
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int sweep = 0; sweep < 32; ++sweep) {
    bool turned = false;
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pairs[pq][0], q = pairs[pq][1];
      double al = 0.0, be = 0.0, ga = 0.0;
      for (int i = 0; i < 3; ++i) {
        al += x[i][p] * x[i][p];
        be += x[i][q] * x[i][q];
        ga += x[i][p] * x[i][q];
      }
      if (!(fabs(ga) > 1e-15 * sqrt(al * be))) continue;
      turned = true;
      const double zeta = (be - al) / (2.0 * ga);
      const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t), sn = c * t;
      for (int i = 0; i < 3; ++i) {
        const double xp = x[i][p], xq = x[i][q];
        x[i][p] = c * xp - sn * xq;
        x[i][q] = sn * xp + c * xq;
        const double vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - sn * vq;
        v[i][q] = sn * vp + c * vq;
      }
    }
    if (!turned) break;
  }
  double sv[3];
  for (int j = 0; j < 3; ++j)
    sv[j] = sqrt(x[0][j] * x[0][j] + x[1][j] * x[1][j] + x[2][j] * x[2][j]);
  // the two largest, first of equals
  int i1 = 0;
  for (int j = 1; j < 3; ++j)
    if (sv[j] > sv[i1]) i1 = j;
  int i2 = i1 == 0 ? 1 : 0;
  for (int j = 0; j < 3; ++j)
    if (j != i1 && sv[j] > sv[i2]) i2 = j;
  double u1[3], u2[3], v1[3], v2[3], u3[3], v3[3];
  for (int i = 0; i < 3; ++i) {
    v1[i] = v[i][i1];
    v2[i] = v[i][i2];
  }
  if (!(sv[i1] > 0.0)) {  // s = 0: every rotation fits alike; the identity
    for (int i = 0; i < 9; ++i) rot[i] = (i % 4 == 0) ? 1.0 : 0.0;
    return;
  }
  for (int i = 0; i < 3; ++i) u1[i] = x[i][i1] / sv[i1];
  if (sv[i2] > 1e-14 * sv[i1]) {
    for (int i = 0; i < 3; ++i) u2[i] = x[i][i2] / sv[i2];
  } else {  // rank one: the turn about u1 is free
    orthogonal(u1, u2);
  }
  cross(u1, u2, u3);
  cross(v1, v2, v3);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) rot[3 * i + j] = u1[i] * v1[j] + u2[i] * v2[j] + u3[i] * v3[j];
}

// x = A^-1 b for a 6x6 A (row-major, overwritten), Gaussian elimination with
// partial pivoting
__device__ void solve6(double* A, double* b, double* x) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int i = c + 1; i < 6; ++i)
      if (fabs(A[6 * i + c]) > fabs(A[6 * piv + c])) piv = i;
    if (piv != c) {
      for (int j = 0; j < 6; ++j) {
        const double tmp = A[6 * c + j];
        A[6 * c + j] = A[6 * piv + j];
        A[6 * piv + j] = tmp;
      }
      const double tmp = b[c];
      b[c] = b[piv];
      b[piv] = tmp;
    }
    for (int i = c + 1; i < 6; ++i) {
      const double f = A[6 * i + c] / A[6 * c + c];
      for (int j = c; j < 6; ++j) A[6 * i + j] -= f * A[6 * c + j];
      b[i] -= f * b[c];
    }
  }
  for (int i = 5; i >= 0; --i) {
    double s = b[i];
    for (int j = i + 1; j < 6; ++j) s -= A[6 * i + j] * x[j];
    x[i] = s / A[6 * i + i];
  }
}

// one warp per pose: its partials summed in a fixed order, then the fit (or,
// with a.tot, the sums written out for the caller to add over the shards)
template <bool GN, bool SPLIT>
__global__ void __launch_bounds__(32) solve_kernel(const Args a) {
  constexpr int K = GN ? GAUSS : KABSCH;
  constexpr int NACC = SPLIT ? 2 * K + 1 : K;
  const int p = blockIdx.x, lane = threadIdx.x;
  __shared__ double tot[NACC];
  for (int k = 0; k < NACC; ++k) {
    double s = 0.0;
    for (int j = lane; j < a.nblk; j += 32) s += a.part[((long long)p * a.nblk + j) * NACC + k];
    s = warp_sum(s);
    if (lane == 0) tot[k] = s;
  }
  if (lane != 0) return;
  if (a.tot) {
    for (int k = 0; k < NACC; ++k) a.tot[(long long)p * NACC + k] = tot[k];
    return;
  }
  double m[K];
  // under SPLIT: the edge corrs' terms alone with 12 or more of them, else all
  const bool all = SPLIT && tot[2 * K] < 12.0;
  for (int k = 0; k < K; ++k) m[k] = tot[k] + (all ? tot[K + k] : 0.0);
  const float* pose = a.poses + 16 * p;
  float* out = a.out + 16 * p;
  if (a.count && a.count[p] < 3) {  // the step keeps the pose
    for (int q = 0; q < 16; ++q) out[q] = pose[q];
    return;
  }
  double rot[9], tr[3];
  if (!GN) {
    const double w = m[0];
    if (w <= 1e-12) {
      for (int i = 0; i < 9; ++i) rot[i] = (i % 4 == 0) ? 1.0 : 0.0;
      tr[0] = tr[1] = tr[2] = 0.0;
    } else {
      double ms[3], md[3], cov[9];
      for (int i = 0; i < 3; ++i) {
        ms[i] = m[1 + i] / w;
        md[i] = m[4 + i] / w;
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) cov[3 * i + j] = m[7 + 3 * i + j] / w - md[i] * ms[j];
      kabsch_rotation(cov, rot);
      for (int i = 0; i < 3; ++i)
        tr[i] = md[i] - (rot[3 * i] * ms[0] + rot[3 * i + 1] * ms[1] + rot[3 * i + 2] * ms[2]);
    }
  } else {
    double A[36], b[6], x[6];
    int k = 0;
    for (int i = 0; i < 6; ++i)
      for (int j = i; j < 6; ++j) {
        A[6 * i + j] = m[k];
        A[6 * j + i] = m[k];
        ++k;
      }
    double trace = 0.0;
    for (int i = 0; i < 6; ++i) {
      b[i] = m[21 + i];
      trace += A[7 * i];
    }
    for (int i = 0; i < 6; ++i) A[7 * i] += 1e-6 * trace / 6.0;
    solve6(A, b, x);
    const double angle = sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
    const double g = 1.0 / fmax(angle, 1e-12);
    const double ax = x[0] * g, ay = x[1] * g, az = x[2] * g;
    const double kk[9] = {0.0, -az, ay, az, 0.0, -ax, -ay, ax, 0.0};
    const double sa = sin(angle), ca = 1.0 - cos(angle);
    double upd[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double k2 = 0.0;
        for (int l = 0; l < 3; ++l) k2 += kk[3 * i + l] * kk[3 * l + j];
        upd[3 * i + j] = (i == j ? 1.0 : 0.0) + sa * kk[3 * i + j] + ca * k2;
      }
    // upd @ pose
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        rot[3 * i + j] = upd[3 * i] * (double)pose[j] + upd[3 * i + 1] * (double)pose[4 + j] +
                         upd[3 * i + 2] * (double)pose[8 + j];
      tr[i] = upd[3 * i] * (double)pose[3] + upd[3 * i + 1] * (double)pose[7] +
              upd[3 * i + 2] * (double)pose[11] + x[3 + i];
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) out[4 * i + j] = (float)rot[3 * i + j];
    out[4 * i + 3] = (float)tr[i];
  }
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

template <bool GN, bool SPLIT>
int launch(const Args& a, int n_poses, cudaStream_t stream) {
  if (a.nblk > 0) {
    moments_kernel<GN, SPLIT><<<dim3(a.nblk, n_poses), THREADS, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  solve_kernel<GN, SPLIT><<<n_poses, 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace join_fit

extern "C" {

// The fit of n_poses poses; with `tot` ([P, join_fit_totals] doubles), the
// per-pose totals of the moments alone, written there for join_fit_solve
// (`out` unused).
int join_fit_launch(const float* poses, int n_poses, const float* xyz, const float* normal,
                    const float* tangent, const unsigned char* tmask, int n, int batches,
                    const unsigned char* valid, const long long* midx, const long long* count,
                    const float* mxyz, const float* mnormal, const float* mtangent,
                    int gauss_newton, int edges_only, int orient, double* part, double* tot,
                    float* out, cudaStream_t stream) {
  join_fit::Args a = {};
  a.poses = poses;
  a.xyz = xyz;
  a.normal = normal;
  a.tangent = tangent;
  a.tmask = tmask;
  a.n = n;
  a.batches = batches;
  a.valid = valid;
  a.midx = midx;
  a.count = count;
  a.mxyz = mxyz;
  a.mnormal = mnormal;
  a.mtangent = mtangent;
  a.orient = orient;
  a.nblk = (n + join_fit::SPAN - 1) / join_fit::SPAN;
  a.part = part;
  a.tot = tot;
  a.out = out;
  if (gauss_newton)
    return edges_only ? join_fit::launch<true, true>(a, n_poses, stream)
                      : join_fit::launch<true, false>(a, n_poses, stream);
  return edges_only ? join_fit::launch<false, true>(a, n_poses, stream)
                    : join_fit::launch<false, false>(a, n_poses, stream);
}

// The fit of n_poses poses from their totals `tot` [P, join_fit_totals] (as
// join_fit_launch writes them, summed over a mesh's shards): the solve
// kernel alone, reading the totals as one partial a pose.
int join_fit_solve(const float* poses, int n_poses, const long long* count, int gauss_newton,
                   int edges_only, const double* tot, float* out, cudaStream_t stream) {
  join_fit::Args a = {};
  a.poses = poses;
  a.count = count;
  a.nblk = 1;
  a.part = const_cast<double*>(tot);  // read alone
  a.out = out;
  if (gauss_newton) {
    if (edges_only) join_fit::solve_kernel<true, true><<<n_poses, 32, 0, stream>>>(a);
    else join_fit::solve_kernel<true, false><<<n_poses, 32, 0, stream>>>(a);
  } else {
    if (edges_only) join_fit::solve_kernel<false, true><<<n_poses, 32, 0, stream>>>(a);
    else join_fit::solve_kernel<false, false><<<n_poses, 32, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// doubles of one pose's totals (a row of `tot`) in the mode
long long join_fit_totals(int gauss_newton, int edges_only) {
  const long long k = gauss_newton ? join_fit::GAUSS : join_fit::KABSCH;
  return edges_only ? 2 * k + 1 : k;
}

// doubles of the per-block partials (the launcher's `part`) for n points,
// n_poses poses and the mode
long long join_fit_part_doubles(int n, int n_poses, int gauss_newton, int edges_only) {
  return join_fit_totals(gauss_newton, edges_only) * n_poses *
         ((n + join_fit::SPAN - 1) / join_fit::SPAN);
}

const char* join_fit_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
