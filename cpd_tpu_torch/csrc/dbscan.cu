// Kernel R2: DBSCAN labels of the pseudo-label factory's clustering, with
// the labels of sklearn.cluster.DBSCAN in closed form:
//
//   core[i]   = #{ j : |p_i - p_j|^2 <= eps^2 } >= min_samples  (i counts itself)
//   clusters  = connected components of the core points under that relation,
//               numbered in the order of each component's smallest core index
//   label[i]  = its component's number for a core point; for any other point
//               the smallest number among its core neighbours, or -1
//
// sklearn expands cluster after cluster from the smallest unlabelled core
// index, so a cluster's seed is its smallest core index and a border point
// keeps the first (smallest) cluster that reaches it: the same labels. So
// does the JAX package's fallback (cpd_tpu/unsupervised/outline.py::
// _dbscan_bfs). It stands in for no Pallas kernel: it replaces a host
// library (sklearn's DBSCAN, which the card's machine does not have; without
// it the JAX factory runs _dbscan_bfs, a Python loop over every point).
//
// The coordinates are f64 and the test is (dx*dx + dy*dy) + dz*dz <= eps^2
// in f64, each operation rounded on its own (__dmul_rn / __dadd_rn): the
// clouds come in f64 and sklearn compares in f64 in that order.
//
// The host (ops/dbscan.py) gives every point integer cell coordinates
// floor(x / cell) with cell a hair above eps and sorts the points by cell
// (torch.sort), as for kernel R1; a point's neighbours lie in the 27 cells
// around its own, 9 runs of 3 consecutive keys. Five launches:
//   1. count: one thread a point counts its neighbours, marks the core
//      points and starts every point as its own root;
//   2. union: one thread a core point i hooks, for every core neighbour
//      j > i, the larger of the two roots under the smaller with atomicMin
//      (when the root moved meanwhile the loop unites the old parent too, so
//      no link is lost). Parents only ever decrease, so every component ends
//      with its smallest index as root, whatever the order of the threads:
//      the labels do not depend on scheduling;
//   3. compress: every core point's parent becomes its root;
//   4. rank: one block scans the roots in index order: a root's cluster
//      number is the count of roots before it;
//   5. label: core points take their root's number; the other points walk
//      their neighbours again for the smallest root among the core ones
//      (numbers grow with the root's index).
//
// What bounds it on an H100: operations on the CUDA cores, and latency. Each
// point walks its 27 cells three times (count, union, label) at 8 f64
// operations a pair test; the union's find loops and atomics are dependent
// loads through L2. The bytes (32 bytes a point in, 4 out) are small.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

// This thread's point; 64-bit so that the last block of N < 2^31 cannot wrap.
__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
}

struct Grid {
  const double* pts;     // (N, 3), sorted by cell
  const int32_t* cell;   // (N, 3), the cells of pts
  const int64_t* keys;   // (N,), sorted
  const int32_t* perm;   // (N,), sorted position -> original index
  int N, NX, NY, NZ;
  double eps2;
};

__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ keys, int n, int64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Calls f(u) for the sorted position u of every point within eps of the point
// at sorted position t (t itself included).
template <class F>
__device__ __forceinline__ void for_neighbours(const Grid& g, int t, F&& f) {
  const int64_t t3 = 3LL * t;
  const double px = g.pts[t3], py = g.pts[t3 + 1], pz = g.pts[t3 + 2];
  const int gx = g.cell[t3], gy = g.cell[t3 + 1], gz = g.cell[t3 + 2];
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      const int64_t base = (static_cast<int64_t>(gx + dx) * g.NY + gy + dy) * g.NZ + gz;
      int u = lower_bound(g.keys, g.N, base - 1);
      const int end = lower_bound(g.keys, g.N, base + 2);
      for (; u < end; ++u) {
        const int64_t u3 = 3LL * u;
        const double ex = __dadd_rn(px, -g.pts[u3]);
        const double ey = __dadd_rn(py, -g.pts[u3 + 1]);
        const double ez = __dadd_rn(pz, -g.pts[u3 + 2]);
        const double d2 = __dadd_rn(__dadd_rn(__dmul_rn(ex, ex), __dmul_rn(ey, ey)),
                                    __dmul_rn(ez, ez));
        if (d2 <= g.eps2) f(u);
      }
    }
  }
}

// Root of i: parents are read past L1 (other SMs hook roots with atomics);
// a stale parent is still an ancestor, so the walk stays right.
__device__ __forceinline__ int find_root(const int32_t* parent, int i) {
  while (true) {
    const int p = __ldcg(parent + i);
    if (p == i) return i;
    i = p;
  }
}

__device__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;  // b was still a root: hooked under a
    // b had been hooked under old meanwhile; parent[b] is now min(old, a), so
    // a and old must be united as well
    b = old;
  }
}

__global__ void __launch_bounds__(kThreads)
count_kernel(Grid g, int min_samples, uint8_t* core_sorted, uint8_t* core, int32_t* parent) {
  const int64_t t64 = thread_index();
  if (t64 >= g.N) return;
  const int t = static_cast<int>(t64);
  int c = 0;
  for_neighbours(g, t, [&](int) { ++c; });
  const uint8_t is_core = c >= min_samples;
  const int i = g.perm[t];
  core_sorted[t] = is_core;
  core[i] = is_core;
  parent[i] = i;
}

__global__ void __launch_bounds__(kThreads)
union_kernel(Grid g, const uint8_t* __restrict__ core_sorted, int32_t* parent) {
  const int64_t t64 = thread_index();
  if (t64 >= g.N || !core_sorted[t64]) return;
  const int t = static_cast<int>(t64);
  const int i = g.perm[t];
  for_neighbours(g, t, [&](int u) {
    if (core_sorted[u]) {
      const int j = g.perm[u];
      if (j > i) unite(parent, i, j);
    }
  });
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(int N, const uint8_t* __restrict__ core, int32_t* parent) {
  const int64_t i = thread_index();
  if (i < N && core[i]) parent[i] = find_root(parent, static_cast<int>(i));
}

// One block: rank[i] = the number of roots before i, for every root i.
__global__ void __launch_bounds__(kScanThreads)
rank_kernel(int N, const uint8_t* __restrict__ core, const int32_t* __restrict__ parent,
            int32_t* __restrict__ rank) {
  __shared__ int sums[kScanThreads];
  const int tid = threadIdx.x;
  const int per = static_cast<int>((static_cast<int64_t>(N) + kScanThreads - 1) / kScanThreads);
  const int lo = min(N, tid * per), hi = min(N, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += core[i] && parent[i] == i;
  sums[tid] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan of the chunk sums
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int run = tid ? sums[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    rank[i] = run;
    run += core[i] && parent[i] == i;
  }
}

__global__ void __launch_bounds__(kThreads)
label_kernel(Grid g, const uint8_t* __restrict__ core_sorted, const int32_t* __restrict__ parent,
             const int32_t* __restrict__ rank, int32_t* __restrict__ labels) {
  const int64_t t64 = thread_index();
  if (t64 >= g.N) return;
  const int t = static_cast<int>(t64);
  const int i = g.perm[t];
  if (core_sorted[t]) {
    labels[i] = rank[parent[i]];
    return;
  }
  int best = INT_MAX;
  for_neighbours(g, t, [&](int u) {
    if (core_sorted[u]) best = min(best, parent[g.perm[u]]);
  });
  labels[i] = best == INT_MAX ? -1 : rank[best];
}

}  // namespace

// pts (N, 3) f64, cell (N, 3) int32, keys (N,) int64 sorted by cell, perm
// (N,) int32 (sorted position -> original index); scratch core_sorted and
// core (N,) uint8, parent and rank (N,) int32; labels (N,) int32 by original
// index. Returns the first CUDA error of the five launches (0 when all were
// accepted).
extern "C" int cpd_dbscan(const void* pts, const void* cell, const void* keys, const void* perm,
                          int N, int NX, int NY, int NZ, double eps2, int min_samples,
                          void* core_sorted, void* core, void* parent, void* rank, void* labels,
                          void* stream) {
  if (N == 0) return 0;
  if (N < 0 || NX < 3 || NY < 3 || NZ < 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Grid g;
  g.pts = static_cast<const double*>(pts);
  g.cell = static_cast<const int32_t*>(cell);
  g.keys = static_cast<const int64_t*>(keys);
  g.perm = static_cast<const int32_t*>(perm);
  g.N = N, g.NX = NX, g.NY = NY, g.NZ = NZ, g.eps2 = eps2;
  auto* cs = static_cast<uint8_t*>(core_sorted);
  auto* co = static_cast<uint8_t*>(core);
  auto* pa = static_cast<int32_t*>(parent);
  auto* rk = static_cast<int32_t*>(rank);
  const int blocks = static_cast<int>((static_cast<int64_t>(N) + kThreads - 1) / kThreads);
  count_kernel<<<blocks, kThreads, 0, s>>>(g, min_samples, cs, co, pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  union_kernel<<<blocks, kThreads, 0, s>>>(g, cs, pa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  compress_kernel<<<blocks, kThreads, 0, s>>>(N, co, pa);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_kernel<<<1, kScanThreads, 0, s>>>(N, co, pa, rk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  label_kernel<<<blocks, kThreads, 0, s>>>(g, cs, pa, rk, static_cast<int32_t*>(labels));
  return (int)cudaGetLastError();
}
