// Exact voxel LUT for Hopper (sm_90a): the nearest model point to every
// voxel's sample point, by brute force over every point.
//
// Replaces no TPU kernel.  The JAX package builds LUTs above 2M voxels by jump
// flood (ops/jfa.py), which is almost exact: about 2-3 % of voxels get a point
// up to ~0.55 voxel diagonals farther than the nearest.  The C++ reference's
// table is exact (impl/model.hpp:81-94), and SearchPolicy.exact_lut asks for
// that table on the big grids.  The plain PyTorch version is
// ops/knn.nearest_grid_plain (a chunked 1-NN of the same sample points), which
// the wrapper ops/knn.nearest_grid takes on the CPU.
//
// Work: every (voxel, point) pair, V x N of them (512^3 x 19950 = 2.7e12 for
// the recall lattice), a few fp32 instructions each, so the kernel is bound by
// fp32 instructions; the bytes (the points once, the int64 LUT once) are
// negligible beside them.  Design: the grid's world <-> voxel map is diagonal
// in x and y (the wrapper checks it), so one thread takes RZ voxels of one
// (i, j) column, whose sample points share x and y: per point it forms
// dx^2 + dy^2 once and then spends 5 instructions per voxel (FADD, FFMA, a
// compare and two selects) on independent chains held in registers.  The block
// streams the points through shared memory in tiles, every thread reading the
// same point at once (a broadcast).  Ties go to the lower point index (strict
// <, points in index order), as torch's argmin does.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace nearest_grid {

constexpr int THREADS = 256;  // threads per block
constexpr int RZ = 32;        // voxels along z per thread
constexpr int TILE = 1024;    // points per shared-memory tile (16 KB)

// pts [m] float4: x, y, z and the point's index in the cloud (int bits in w);
// lut [ex, ey, ez] int64, row-major.  Sample point of voxel (i, j, k):
// x = a00 i + a01 j + a03, y = a10 i + a11 j + a13, z = a20 i + a21 j + a22 k + a23.
__global__ void __launch_bounds__(THREADS)
kernel(const float4* __restrict__ pts, int m, long long* __restrict__ lut, int ex, int ey,
       int ez, float a00, float a01, float a03, float a10, float a11, float a13, float a20,
       float a21, float a22, float a23) {
  __shared__ float4 tile[TILE];
  const int zchunks = (ez + RZ - 1) / RZ;
  const long long task = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = task < (long long)ex * ey * zchunks;
  const int zc = active ? (int)(task % zchunks) : 0;
  const long long col = active ? task / zchunks : 0;
  const int j = (int)(col % ey), i = (int)(col / ey);
  const float fi = (float)i, fj = (float)j;
  const float cx = fmaf(a01, fj, a00 * fi) + a03;
  const float cy = fmaf(a11, fj, a10 * fi) + a13;
  const float cz0 = fmaf(a21, fj, a20 * fi);
  float cz[RZ], best[RZ];
  int bi[RZ];
#pragma unroll
  for (int r = 0; r < RZ; ++r) {
    cz[r] = fmaf(a22, (float)(zc * RZ + r), cz0) + a23;
    best[r] = CUDART_INF_F;
    bi[r] = 0;
  }
  for (int t0 = 0; t0 < m; t0 += TILE) {
    const int cnt = min(TILE, m - t0);
    for (int p = threadIdx.x; p < cnt; p += THREADS) tile[p] = pts[t0 + p];
    __syncthreads();
    if (active) {
      for (int p = 0; p < cnt; ++p) {
        const float4 q = tile[p];
        const float dx = q.x - cx, dy = q.y - cy;
        const float dxy = fmaf(dx, dx, dy * dy);
#pragma unroll
        for (int r = 0; r < RZ; ++r) {
          const float dz = q.z - cz[r];
          const float d = fmaf(dz, dz, dxy);
          if (d < best[r]) {
            best[r] = d;
            bi[r] = t0 + p;
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  long long* out = lut + ((long long)i * ey + j) * ez;
#pragma unroll
  for (int r = 0; r < RZ; ++r) {
    const int k = zc * RZ + r;
    if (k < ez) out[k] = (long long)__float_as_int(pts[bi[r]].w);
  }
}

}  // namespace nearest_grid

// Launch on `stream`: pts [m] float4 (m >= 1), lut [ex, ey, ez] int64, both
// contiguous on the device; a* the world coordinates of a voxel's sample point
// as above.  Returns cudaGetLastError() after the launch.
extern "C" cudaError_t nearest_grid_launch(const void* pts, int m, void* lut, int ex, int ey,
                                           int ez, float a00, float a01, float a03, float a10,
                                           float a11, float a13, float a20, float a21, float a22,
                                           float a23, void* stream) {
  const long long tasks = (long long)ex * ey * ((ez + nearest_grid::RZ - 1) / nearest_grid::RZ);
  const unsigned blocks = (unsigned)((tasks + nearest_grid::THREADS - 1) / nearest_grid::THREADS);
  nearest_grid::kernel<<<blocks, nearest_grid::THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)pts, m, (long long*)lut, ex, ey, ez, a00, a01, a03, a10, a11, a13, a20, a21,
      a22, a23);
  return cudaGetLastError();
}

extern "C" const char* nearest_grid_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
