// Kernel R1: radius neighbour count, the inner loop of the pseudo-label
// factory's Persistence Point Score (PPScore).
//
//   out[i, w] = #{ j : window[j] == w and |query[i] - support[j]|^2 <= r2 }
//
// It stands in for no Pallas kernel. It replaces a JAX op chain
// (cpd_tpu/unsupervised/ppscore.py::ppscore_jax, a brute force over every
// pair) and the host library that the JAX factory calls
// (cpd_tpu/native/src/pointcloud.cpp::radius_neighbor_count, a hash grid on
// the CPU). That library looks up each neighbouring cell from a shifted float
// coordinate, key_of(q + d * cell): near a cell edge the rounded coordinate
// lands in the wrong cell, one cell is walked twice and a true neighbour cell
// is skipped. This kernel walks integer offsets of the query's own cell.
//
// The host (ops/radius.py) gives every point integer cell coordinates
// floor(x / cell) from one origin, with cell a hair above r so that rounding
// can never put a neighbour two cells away, sorts the support by the key
// ((w * NX + gx) * NY + gy) * NZ + gz (torch.sort), and sorts the queries by
// their cell. One thread owns one query and walks, for every window, the 9
// (dx, dy) columns of its 27 cells: the 3 cells of a column are consecutive
// keys, so two binary searches find the column's run of support points.
//
// The distance is (dx*dx + dy*dy) + dz*dz in f32, each operation rounded on
// its own (__fmul_rn / __fadd_rn: no FMA contraction), the order the plain
// version and the JAX brute force use: the counts are bit-identical to them.
//
// What bounds it on an H100: operations. The bytes are small (a frame's
// queries and windows, 12-16 bytes a point, each read once when the runs are
// cached), but every query tests every support point of its 27 cells (27 /
// (4/3 pi) = 6.4 times the neighbours where points fill a volume, 9 / pi =
// 2.9 on a surface), at 8 f32 operations a test on the CUDA cores. Queries sorted by cell let the
// threads of a warp walk the same runs (L1 and L2 hits, little divergence).
// Binary searches cost 2 x 9 x W searches of log2(M) steps a query.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ keys, int64_t n,
                                               int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
radius_count_kernel(const float* __restrict__ query, const int32_t* __restrict__ qcell,
                    const int64_t* __restrict__ keys, const float* __restrict__ support,
                    int N, int64_t M, int W, int NX, int NY, int NZ, float r2,
                    int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= N) return;
  const float qx = query[3 * i], qy = query[3 * i + 1], qz = query[3 * i + 2];
  const int gx = qcell[3 * i], gy = qcell[3 * i + 1], gz = qcell[3 * i + 2];
  for (int w = 0; w < W; ++w) {
    int32_t c = 0;
    for (int dx = -1; dx <= 1; ++dx) {
      for (int dy = -1; dy <= 1; ++dy) {
        // the host pads the grid by one cell on every side: no wrap-around
        const int64_t base = ((static_cast<int64_t>(w) * NX + gx + dx) * NY + gy + dy) * NZ + gz;
        int64_t j = lower_bound(keys, M, base - 1);
        const int64_t end = lower_bound(keys, M, base + 2);
        for (; j < end; ++j) {
          const float ex = __fsub_rn(qx, __ldg(support + 3 * j));
          const float ey = __fsub_rn(qy, __ldg(support + 3 * j + 1));
          const float ez = __fsub_rn(qz, __ldg(support + 3 * j + 2));
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)),
                                     __fmul_rn(ez, ez));
          c += d2 <= r2;
        }
      }
    }
    out[i * W + w] = c;
  }
}

}  // namespace

// query (N, 3) f32 and qcell (N, 3) int32 sorted by cell; keys (M,) int64
// sorted and support (M, 3) f32 in the keys' order; out (N, W) int32.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int cpd_radius_count(const void* query, const void* qcell, const void* keys,
                                const void* support, int N, long long M, int W, int NX, int NY,
                                int NZ, float r2, void* out, void* stream) {
  if (N == 0 || W == 0) return 0;
  if (N < 0 || M < 0 || W < 0 || NX < 3 || NY < 3 || NZ < 3) return (int)cudaErrorInvalidValue;
  const int blocks = static_cast<int>((static_cast<int64_t>(N) + kThreads - 1) / kThreads);
  radius_count_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const int32_t*>(qcell),
      static_cast<const int64_t*>(keys), static_cast<const float*>(support), N, M, W, NX, NY,
      NZ, r2, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
