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
// One launch clusters many clouds (segments) at once, each alone: the host
// (ops/dbscan.py) gives each segment its own grid origin and dims and puts
// the segment in the column number, so points of two segments never meet;
// roots are original indices and a segment's cluster numbers start at the
// rank of its first point. A single cloud is one segment, on the grid of
// radius.grid_cells.
//
// The coordinates are f64 and the test is (dx*dx + dy*dy) + dz*dz <= eps^2
// in f64, each operation rounded on its own (__dmul_rn / __dadd_rn): the
// clouds come in f64 and sklearn compares in f64 in that order.
//
// The grid, the column table and the walk are kernel R1's (cell_walk.cuh;
// this library launches the runs itself, cpd_dbscan_runs): a warp walks a
// piece of a group's candidates. The host finds each segment's lowest and
// highest cell first (bounds_kernel, cpd_segment_bounds: blocks reduce a
// share of a segment, atomics join them).
//   1. count (cpd_dbscan_count): each point's neighbours, itself included;
//      the host marks the core points and scans the counts less one into
//      64-bit row offsets;
//   2. link (cpd_dbscan_link), by the list where the card can hold it
//      (the host's allocation of 8 bytes a pair succeeds): the list walk
//      writes, once, each core point's core neighbours of larger index
//      and each other point's core neighbours (a ballot's prefix under
//      one atomicAdd on the row's cursor) and hooks each core point under
//      its smallest core neighbour;
//      union_edges_kernel takes one thread an edge (i, j), and hooks the
//      larger of the two roots under the smaller with atomicMin (when the
//      root moved meanwhile the loop unites the old parent too, so no link
//      is lost). Parents only ever decrease, so every component ends with
//      its smallest index as root, whatever the order of the threads: the
//      labels do not depend on scheduling. Without the list union_walk
//      walks the cells a second time and unites as it finds the pairs;
//   3. labels (cpd_dbscan_labels): compress (every core point's parent
//      becomes its root), rank (the roots before each index: blocks count
//      their chunk's roots, one block scans the counts, blocks write the
//      ranks), the smallest root among each other point's core neighbours
//      (its row of the list, or a third walk without it), and the
//      labels.
//
// What bounds it on an H100: the union's dependent loads and the walks'
// instructions, not bytes (32 bytes a point in, 4 out, 8 a listed pair
// written and read once). The count and list walks test each point against
// the points of its 27 cells at 8 f64 operations a test (5.76 tests a pair
// on the drive's largest cloud). Every edge of a dense cluster reads the
// same few roots: the finds read parents through L1, and the smallest-
// neighbour hooks keep the trees shallow, so a union costs a few L1 hits
// and rarely an atomic. On the drive's largest cloud (117,184 points, 6.1M
// pairs) and on a frame's 130 box clouds (19.2M pairs) the union took 0.34
// and 0.49 ms and the list walk 0.35 and 0.58 ms on an H100 (chip_smoke.py
// phase 15's profile).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "cell_walk.cuh"

namespace {

using namespace cellwalk;

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

// Root of i. Parents go through L1, where a copy may be stale (other SMs
// hook roots with atomics), but a stale parent is still an ancestor, below
// its node, so the walk stays right and ends; a stale root only costs the
// union another turn, whose atomicMin reads the parent afresh. The roots of
// a dense cluster are read by every thread of its edges: from L1, not from
// one line of L2.
__device__ __forceinline__ int find_root(const int32_t* parent, int i) {
  while (true) {
    const int p = parent[i];
    if (p == i) return i;
    i = p;
  }
}

__device__ __forceinline__ void unite(int32_t* parent, int a, int b) {
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

// Lists, by original index, what the union and the border labels read: for
// a core query its core neighbours of larger index (the union's edges), for
// any other query its core neighbours (its label's candidates); src gets the
// query's index, ~index where it is not core. One atomicAdd on the row's
// cursor a query and chunk with entries, the entries at their ballot's
// prefix; a row's slots past its entries keep the host's -1. A core query
// also hooks itself under its smallest core neighbour (atomicMin on its
// parent; nothing else writes parents during the walk): a forest of true
// edges, whose trees are shallow, so that the union finds most pairs joined.
struct ListOp {
  static constexpr bool kOwnQuery = false;
  unsigned long long* cursor;
  int32_t* list;
  int32_t* src;
  const uint8_t* core;
  const int32_t* perm;
  int32_t* parent;
  int cand = -1;  // the candidate's original index when it is core, else -1
  int smallest = INT_MAX;
  __device__ __forceinline__ bool keeps(int) const { return true; }
  __device__ __forceinline__ int aux(int qpos) const {
    return core[qpos] ? perm[qpos] : ~perm[qpos];
  }
  __device__ __forceinline__ void candidate(int u, bool valid) {
    cand = valid && core[u] ? perm[u] : -1;
  }
  __device__ __forceinline__ void visit(int t, int qpos, int q, bool hit, int lane) {
    const bool linked = hit && cand >= 0;
    const int m = __reduce_min_sync(kFull, linked ? cand : INT_MAX);
    if (lane == t) smallest = min(smallest, m);
    const bool h = linked && (q < 0 || cand > q);
    const unsigned b = __ballot_sync(kFull, h);
    if (b == 0) return;
    unsigned long long base = 0;
    if (lane == 0) base = atomicAdd(cursor + qpos, static_cast<unsigned long long>(__popc(b)));
    base = __shfl_sync(kFull, base, 0);
    if (h) {
      const unsigned long long e = base + __popc(b & ((1u << lane) - 1u));
      list[e] = cand;
      src[e] = q;
    }
  }
  __device__ __forceinline__ void done(int qpos, int) {
    if (qpos < 0 || !core[qpos]) return;
    const int i = perm[qpos];
    if (smallest < i) atomicMin(parent + i, smallest);
  }
};

// Core queries unite with their core neighbours of larger original index.
struct UnionWalkOp {
  static constexpr bool kOwnQuery = false;
  const uint8_t* core;
  const int32_t* perm;
  int32_t* parent;
  int cand = -1;  // the candidate's original index when it is core, else -1
  __device__ __forceinline__ bool keeps(int qpos) const { return core[qpos] != 0; }
  __device__ __forceinline__ int aux(int qpos) const { return perm[qpos]; }
  __device__ __forceinline__ void candidate(int u, bool valid) {
    cand = valid && core[u] ? perm[u] : -1;
  }
  __device__ __forceinline__ void visit(int, int, int i, bool hit, int) {
    if (hit && cand > i) unite(parent, i, cand);
  }
  __device__ __forceinline__ void done(int, int) {}
};

// Each point that is not core: the smallest root among its core neighbours.
struct BestWalkOp {
  static constexpr bool kOwnQuery = false;
  const uint8_t* core;
  const int32_t* perm;
  const int32_t* parent;
  int32_t* best;
  int root = INT_MAX;
  int mine = INT_MAX;
  __device__ __forceinline__ bool keeps(int qpos) const { return core[qpos] == 0; }
  __device__ __forceinline__ int aux(int) const { return 0; }
  __device__ __forceinline__ void candidate(int u, bool valid) {
    root = valid && core[u] ? parent[perm[u]] : INT_MAX;
  }
  __device__ __forceinline__ void visit(int t, int, int, bool hit, int lane) {
    const int m = __reduce_min_sync(kFull, hit ? root : INT_MAX);
    if (lane == t) mine = min(mine, m);
  }
  __device__ __forceinline__ void done(int qpos, int) {
    if (qpos >= 0 && mine != INT_MAX) atomicMin(best + qpos, mine);
  }
};

template <class Op>
__global__ void __launch_bounds__(kBlock)
walk_kernel(Plan p, int n_pieces, const double2* __restrict__ pts, double eps2, Op op) {
  __shared__ WarpSlots<double> slots[kWarpsPerBlock];
  const int warp = threadIdx.x / kWarp;
  const int64_t piece = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (piece >= n_pieces) return;
  Op mine = op;  // the op's per-lane state
  walk_piece(p, static_cast<int>(piece), pts, pts, eps2, slots[warp], mine);
}

// Blocks (s, y) over segment s: lo[3 s + a] and hi[3 s + a] become the
// smallest and the largest cell of the segment's points along axis a (the
// host fills them with the extremes; an empty segment keeps the fill). Each
// block reduces its share and meets the others' with one atomic an entry.
__device__ __forceinline__ int64_t lower(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t upper(int64_t a, int64_t b) { return a < b ? b : a; }

__global__ void __launch_bounds__(kThreads)
bounds_kernel(const int64_t* __restrict__ cells, const int64_t* __restrict__ offs,
              int64_t* __restrict__ lo, int64_t* __restrict__ hi) {
  __shared__ int64_t part[2][3][kThreads / kWarp];
  const int s = blockIdx.x;
  const int64_t a = offs[s], b = offs[s + 1];
  if (a == b) return;
  int64_t mn0 = LLONG_MAX, mn1 = LLONG_MAX, mn2 = LLONG_MAX;
  int64_t mx0 = LLONG_MIN, mx1 = LLONG_MIN, mx2 = LLONG_MIN;
  for (int64_t i = a + static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x; i < b;
       i += static_cast<int64_t>(gridDim.y) * kThreads) {
    const int64_t x = cells[3 * i], y = cells[3 * i + 1], z = cells[3 * i + 2];
    mn0 = lower(mn0, x), mn1 = lower(mn1, y), mn2 = lower(mn2, z);
    mx0 = upper(mx0, x), mx1 = upper(mx1, y), mx2 = upper(mx2, z);
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    mn0 = lower(mn0, __shfl_down_sync(kFull, mn0, off));
    mn1 = lower(mn1, __shfl_down_sync(kFull, mn1, off));
    mn2 = lower(mn2, __shfl_down_sync(kFull, mn2, off));
    mx0 = upper(mx0, __shfl_down_sync(kFull, mx0, off));
    mx1 = upper(mx1, __shfl_down_sync(kFull, mx1, off));
    mx2 = upper(mx2, __shfl_down_sync(kFull, mx2, off));
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (lane == 0) {
    part[0][0][warp] = mn0, part[0][1][warp] = mn1, part[0][2][warp] = mn2;
    part[1][0][warp] = mx0, part[1][1][warp] = mx1, part[1][2][warp] = mx2;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int which = threadIdx.x / 3, axis = threadIdx.x % 3;
    int64_t v = part[which][axis][0];
    for (int w = 1; w < kThreads / kWarp; ++w)
      v = which ? upper(v, part[which][axis][w]) : lower(v, part[which][axis][w]);
    auto* at = reinterpret_cast<long long*>((which ? hi : lo) + 3 * s + axis);
    if (which)
      atomicMax(at, static_cast<long long>(v));
    else
      atomicMin(at, static_cast<long long>(v));
  }
}

// One thread an entry of the list: an edge (src[e], list[e]) of two core
// points, the second the larger; other entries (a row of a point that is not
// core, a slot left empty) have a negative side.
__global__ void __launch_bounds__(kThreads)
union_edges_kernel(int64_t n_edges, const int32_t* __restrict__ src,
                   const int32_t* __restrict__ list, int32_t* parent) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_edges) return;
  const int j = list[e];
  if (j < 0) return;
  const int i = src[e];
  if (i >= 0) unite(parent, i, j);
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(int N, const uint8_t* __restrict__ core, int32_t* parent) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < N && core[i]) parent[i] = find_root(parent, static_cast<int>(i));
}

__device__ __forceinline__ int is_root(const uint8_t* core, const int32_t* parent, int64_t i) {
  return core[i] && parent[i] == i;
}

// The exclusive prefix of v over the block's threads; *total gets the sum.
// Once a kernel: the warps' sums stay in shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int incl = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / kWarp; ++w) {
    const int x = warp_sums[w];
    before += w < warp ? x : 0;
    all += x;
  }
  *total = all;
  return before + incl - v;
}

// The rank of every index, the roots before it, in three launches: each
// block counts the roots of its chunk of kRankChunk indices, one block scans
// the chunks' counts, each block writes its chunk's ranks.
constexpr int kRankItems = 8;
constexpr int kRankChunk = kThreads * kRankItems;

__global__ void __launch_bounds__(kThreads)
root_count_kernel(int N, const uint8_t* __restrict__ core, const int32_t* __restrict__ parent,
                  int32_t* __restrict__ chunk_sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRankChunk + threadIdx.x * kRankItems;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kRankItems; ++k)
    if (first + k < N) c += is_root(core, parent, first + k);
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) chunk_sums[blockIdx.x] = total;
}

// One block: the exclusive scan of the B chunk sums, in place.
__global__ void __launch_bounds__(kScanThreads)
chunk_scan_kernel(int B, int32_t* __restrict__ sums) {
  __shared__ int part[kScanThreads];
  const int tid = threadIdx.x;
  const int per = (B + kScanThreads - 1) / kScanThreads;
  const int lo = min(B, tid * per), hi = min(B, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += sums[i];
  part[tid] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan of the parts
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = tid ? part[tid - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int x = sums[i];
    sums[i] = run;
    run += x;
  }
}

__global__ void __launch_bounds__(kThreads)
rank_kernel(int N, const uint8_t* __restrict__ core, const int32_t* __restrict__ parent,
            const int32_t* __restrict__ chunk_sums, int32_t* __restrict__ rank) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRankChunk + threadIdx.x * kRankItems;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kRankItems; ++k)
    if (first + k < N) c += is_root(core, parent, first + k);
  int total;
  int run = chunk_sums[blockIdx.x] + block_exclusive_scan(c, &total);
#pragma unroll
  for (int k = 0; k < kRankItems; ++k) {
    if (first + k < N) {
      rank[first + k] = run;
      run += is_root(core, parent, first + k);
    }
  }
}

// The labels by original index. A point that is not core takes the smallest
// root among its core neighbours: from its row of the list (off, list), or
// from best (the walk's). A segment's numbers start at the rank of its first
// point (seg_first, by sorted position; null for one segment).
__global__ void __launch_bounds__(kThreads)
finish_kernel(int N, const uint8_t* __restrict__ core_sorted, const int32_t* __restrict__ perm,
              const int32_t* __restrict__ parent, const int32_t* __restrict__ rank,
              const int64_t* __restrict__ off, const int32_t* __restrict__ list,
              const int32_t* __restrict__ best, const int32_t* __restrict__ seg_first,
              int32_t* __restrict__ labels) {
  const int64_t t64 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t64 >= N) return;
  const int t = static_cast<int>(t64);
  const int i = perm[t];
  const int base = seg_first ? rank[seg_first[t]] : 0;
  if (core_sorted[t]) {
    labels[i] = rank[parent[i]] - base;
    return;
  }
  int root = INT_MAX;
  if (list) {
    for (int64_t e = off[t]; e < off[t + 1]; ++e) {
      const int j = list[e];
      if (j >= 0) root = min(root, parent[j]);
    }
  } else {
    root = best[t];
  }
  labels[i] = root == INT_MAX ? -1 : rank[root] - base;
}

Plan walk_plan(const void* keys, const void* start, const void* gstart, const void* gcol,
               const void* gz, const void* gny, int NZ, const void* runs,
               const void* piece_item, const void* piece_k) {
  Plan p = make_plan(keys, start, gstart, gcol, gz, gny, 0, 1, NZ);
  p.runs = static_cast<const int2*>(runs);
  p.piece_item = static_cast<const int32_t*>(piece_item);
  p.piece_k = static_cast<const int32_t*>(piece_k);
  return p;
}

template <class Op>
int launch_walk(const Plan& p, int P, const void* pts, double eps2, Op op, cudaStream_t s) {
  if (P == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(P) + kWarpsPerBlock - 1) /
                                                kWarpsPerBlock);
  walk_kernel<<<blocks, kBlock, 0, s>>>(p, P, static_cast<const double2*>(pts), eps2, op);
  return (int)cudaGetLastError();
}

unsigned blocks_of(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// The runs of every item (group, segments' one window), cellwalk::launch_runs.
extern "C" int cpd_dbscan_runs(const void* keys, const void* start, const void* gstart,
                               const void* gcol, const void* gz, const void* gny, int G,
                               long long plane, int W, int NZ, void* runs, void* stream) {
  return launch_runs(keys, start, gstart, gcol, gz, gny, G, plane, W, NZ, runs, stream);
}

// cells (N, 3) int64, each segment's points together; offs (S + 1,) int64;
// lo and hi (S, 3) int64, filled by the host with the int64 extremes;
// blocks a segment. Returns the CUDA error of the launch.
extern "C" int cpd_segment_bounds(const void* cells, const void* offs, int S, int blocks,
                                  void* lo, void* hi, void* stream) {
  if (S < 0 || blocks < 1 || blocks > 65535) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  bounds_kernel<<<dim3(S, blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(cells), static_cast<const int64_t*>(offs),
      static_cast<int64_t*>(lo), static_cast<int64_t*>(hi));
  return (int)cudaGetLastError();
}

// The plan (keys, start, gstart, gcol, gz, gny, NZ, runs, piece_item,
// piece_k, P) as kernel R1's, over one window; pts (N, 4) f64 sorted by
// (segment, cell). counts (N,) int32, zeroed: each point's neighbours,
// itself included. Returns the CUDA error of the launch.
extern "C" int cpd_dbscan_count(const void* keys, const void* start, const void* gstart,
                                const void* gcol, const void* gz, const void* gny, int NZ,
                                const void* runs, const void* piece_item, const void* piece_k,
                                int P, const void* pts, double eps2, void* counts, void* stream) {
  if (P < 0 || NZ < 3) return (int)cudaErrorInvalidValue;
  const Plan p = walk_plan(keys, start, gstart, gcol, gz, gny, NZ, runs, piece_item, piece_k);
  CountOp op{static_cast<int32_t*>(counts), 1};
  return launch_walk(p, P, pts, eps2, op, static_cast<cudaStream_t>(stream));
}

// The union. With a list (list != null): cursor (N,) int64, each row's
// offset; list (n_edges,) int32, filled with -1, and src (n_edges,) int32,
// the entries' original indices (ListOp); the list walk fills both,
// union_edges_kernel unites. Without: the walk
// unites. core (N,) uint8 and perm (N,) int32 by sorted position; parent
// (N,) int32 by original index, parent[i] = i. Returns the first CUDA error.
extern "C" int cpd_dbscan_link(const void* keys, const void* start, const void* gstart,
                               const void* gcol, const void* gz, const void* gny, int NZ,
                               const void* runs, const void* piece_item, const void* piece_k,
                               int P, const void* pts, double eps2, const void* core,
                               const void* perm, void* cursor, void* list, void* src,
                               long long n_edges, void* parent, void* stream) {
  if (P < 0 || NZ < 3 || n_edges < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = walk_plan(keys, start, gstart, gcol, gz, gny, NZ, runs, piece_item, piece_k);
  const auto* co = static_cast<const uint8_t*>(core);
  const auto* pe = static_cast<const int32_t*>(perm);
  auto* pa = static_cast<int32_t*>(parent);
  if (list == nullptr) return launch_walk(p, P, pts, eps2, UnionWalkOp{co, pe, pa}, s);
  int err = launch_walk(p, P, pts, eps2,
                        ListOp{static_cast<unsigned long long*>(cursor),
                               static_cast<int32_t*>(list), static_cast<int32_t*>(src), co, pe,
                               pa}, s);
  if (err != 0 || n_edges == 0) return err;
  union_edges_kernel<<<blocks_of(n_edges), kThreads, 0, s>>>(
      n_edges, static_cast<const int32_t*>(src), static_cast<const int32_t*>(list), pa);
  return (int)cudaGetLastError();
}

// The labels: core_sorted (N,) and core (N,) uint8 by sorted position and by
// original index; perm (N,) int32; parent (N,) int32 after the union; rank
// (N,) int32 and chunk_sums (ceil(N / 2048),) int32 scratch; off (N + 1,)
// int64 and list as cpd_dbscan_link's, or
// list null and best (N,) int32 scratch for the walk; seg_first (N,) int32
// by sorted position, or null; labels (N,) int32 by original index. Returns
// the first CUDA error of the launches.
extern "C" int cpd_dbscan_labels(const void* keys, const void* start, const void* gstart,
                                 const void* gcol, const void* gz, const void* gny, int NZ,
                                 const void* runs, const void* piece_item, const void* piece_k,
                                 int P, const void* pts, double eps2, int N,
                                 const void* core_sorted, const void* core, const void* perm,
                                 void* parent, void* rank, void* chunk_sums, const void* off,
                                 const void* list, void* best, const void* seg_first,
                                 void* labels, void* stream) {
  if (N < 0 || P < 0 || NZ < 3) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* cs = static_cast<const uint8_t*>(core_sorted);
  const auto* pe = static_cast<const int32_t*>(perm);
  auto* pa = static_cast<int32_t*>(parent);
  auto* rk = static_cast<int32_t*>(rank);
  const auto* co = static_cast<const uint8_t*>(core);
  compress_kernel<<<blocks_of(N), kThreads, 0, s>>>(N, co, pa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto* sums = static_cast<int32_t*>(chunk_sums);
  const int chunks = static_cast<int>((static_cast<int64_t>(N) + kRankChunk - 1) / kRankChunk);
  root_count_kernel<<<chunks, kThreads, 0, s>>>(N, co, pa, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chunk_scan_kernel<<<1, kScanThreads, 0, s>>>(chunks, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_kernel<<<chunks, kThreads, 0, s>>>(N, co, pa, sums, rk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto* be = static_cast<int32_t*>(best);
  if (list == nullptr) {
    const Plan p = walk_plan(keys, start, gstart, gcol, gz, gny, NZ, runs, piece_item, piece_k);
    const int e = launch_walk(p, P, pts, eps2, BestWalkOp{cs, pe, pa, be}, s);
    if (e != 0) return e;
  }
  finish_kernel<<<blocks_of(N), kThreads, 0, s>>>(
      N, cs, pe, pa, rk, static_cast<const int64_t*>(off), static_cast<const int32_t*>(list),
      be, static_cast<const int32_t*>(seg_first), static_cast<int32_t*>(labels));
  return (int)cudaGetLastError();
}
