// The cell table and the warp-cooperative neighbour walk shared by kernels
// R1 (radius_count.cu) and R2 (dbscan.cu).
//
// The host (ops/radius.py) gives every point integer cell coordinates
// floor(x / cell), with the cell a hair above the radius so that the 27
// cells around a query's own hold every neighbour, and numbers the columns
// (window or segment, gx, gy) of the grid. The candidates are sorted by the
// key col * NZ + gz; start[col] .. start[col + 1] are the sorted positions
// of column col (the column table, built on the device from the sorted
// keys). The queries, sorted by cell, are cut into groups of at most 32 of
// one cell. An item is (group, window): its 9 columns (dx, dy in -1..1) each
// hold one run of the cells gz - 1 .. gz + 1, found by a search inside the
// column (runs_kernel; each library launches it from an entry of its own).
// The 9 runs of an item, end to end, are its candidates; a piece is up to kPiece of them, and one warp
// walks one piece: the lanes take 32 consecutive candidates (one coalesced
// 16-byte load each), and for every query of the group in turn the warp
// tests its 32 pairs at once. An op decides what a hit does (count with a
// ballot, list, unite, or keep the smallest root), so every walk of both
// kernels is this loop. Pieces bound the work of a warp, so the densest
// cells are spread over many warps instead of one.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cellwalk {

constexpr int kWarp = 32;
constexpr int kPiece = 1024;  // candidates a piece: 32 chunks of 32 lanes
constexpr int kWarpsPerBlock = 8;
constexpr int kBlock = kWarp * kWarpsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// What a walk reads besides the points.
struct Plan {
  const int64_t* keys;    // (M,) the candidates' keys, sorted
  const int32_t* start;   // (C + 1,) the column table
  const int32_t* gstart;  // (G + 1,) each group's first position among the sorted queries
  const int32_t* gcol;    // (G,) the column of the group's cell in window 0
  const int32_t* gz;      // (G,) its z cell
  const int32_t* gny;     // (G,) the columns of one x row of its grid
  const int2* runs;       // (9 * items,) each item's 9 runs: (first position, count)
  const int32_t* piece_item;  // (P,) each piece's item = group * W + window
  const int32_t* piece_k;     // (P,) its index among the item's pieces
  int64_t plane;          // columns a window
  int W;                  // windows
  int NZ;
};

// A point with a pad, aligned so that a query reads back from shared memory
// in 16-byte loads.
template <class T>
struct alignas(4 * sizeof(T)) Vec3 {
  T x, y, z, pad;
};

// f32 points are stored (N, 4) as float4, f64 points (N, 4) as two double2.
__device__ __forceinline__ Vec3<float> load_point(const float4* __restrict__ pts, int i) {
  const float4 v = __ldg(pts + i);
  return {v.x, v.y, v.z, 0.f};
}

__device__ __forceinline__ Vec3<double> load_point(const double2* __restrict__ pts, int i) {
  const double2 a = __ldg(pts + 2 * static_cast<int64_t>(i));
  const double2 b = __ldg(pts + 2 * static_cast<int64_t>(i) + 1);
  return {a.x, a.y, b.x, 0.0};
}

// (dx*dx + dy*dy) + dz*dz <= r2, each operation rounded on its own (no FMA
// contraction): the order of the plain versions, so the relations are the
// same bit for bit.
__device__ __forceinline__ bool within(const Vec3<float>& q, const Vec3<float>& c, float r2) {
  const float ex = __fsub_rn(q.x, c.x), ey = __fsub_rn(q.y, c.y), ez = __fsub_rn(q.z, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez)) <= r2;
}

__device__ __forceinline__ bool within(const Vec3<double>& q, const Vec3<double>& c, double r2) {
  const double ex = __dadd_rn(q.x, -c.x), ey = __dadd_rn(q.y, -c.y), ez = __dadd_rn(q.z, -c.z);
  return __dadd_rn(__dadd_rn(__dmul_rn(ex, ex), __dmul_rn(ey, ey)), __dmul_rn(ez, ez)) <= r2;
}

// The shared memory of one warp's piece.
template <class T>
struct WarpSlots {
  Vec3<T> q[kWarp];   // the kept queries of the group
  Vec3<T> c[kWarp];   // a chunk's candidates, where each lane owns a query
  int qpos[kWarp];    // their sorted positions
  int qaux[kWarp];    // what the op keeps of each (Op::aux)
  int first[9];       // the 9 runs' first positions
  int pre[10];        // and their counts' prefix sums
};

// One warp walks piece `piece`; every lane calls it. The op gives
//   keeps(qpos)      whether a query takes part (its lane: one query each);
//   aux(qpos)        an int kept with the query;
//   candidate(u, v)  once a chunk, every lane: its candidate u (v: valid);
//   visit(t, qpos, aux, hit, lane)  for every kept query t of the chunk,
//                    every lane in step (hit: this lane's candidate is
//                    within r2 of query t);
//   done(qpos, w)    at the end, every lane: lane t with query t's position
//                    (-1 for lanes without a query) and the item's window.
// An op whose kOwnQuery is true counts only (own(hit)): a full group of 32
// then runs the other way round, each lane its own query against the
// chunk's candidates read back from shared memory, with no ballot.
template <class T, class Pts, class Op>
__device__ __forceinline__ void walk_piece(const Plan& p, int piece, const Pts* __restrict__ queries,
                                           const Pts* __restrict__ cands, T r2,
                                           WarpSlots<T>& s, Op& op) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int item = p.piece_item[piece];
  const int g = item / p.W, w = item - g * p.W;
  const int qs = p.gstart[g], ng = p.gstart[g + 1] - qs;
  const bool keep = lane < ng && op.keeps(qs + lane);
  const unsigned kept = __ballot_sync(kFull, keep);
  if (kept == 0) return;
  const int nq = __popc(kept);
  __syncwarp();  // the slots of the warp's previous piece are read
  if (keep) {
    const int slot = __popc(kept & ((1u << lane) - 1u));
    s.q[slot] = load_point(queries, qs + lane);
    s.qpos[slot] = qs + lane;
    s.qaux[slot] = op.aux(qs + lane);
  }
  int2 run = make_int2(0, 0);
  if (lane < 9) run = p.runs[9LL * item + lane];
  int incl = run.y;  // inclusive scan of the counts over lanes 0..8
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane < 9) {
    s.first[lane] = run.x;
    s.pre[lane + 1] = incl;
  }
  if (lane == 0) s.pre[0] = 0;
  __syncwarp();
  const int k0 = p.piece_k[piece] * kPiece;
  const int k1 = min(s.pre[9], k0 + kPiece);
  int r = 0;
  if constexpr (Op::kOwnQuery) {
    if (nq == kWarp) {
      const Vec3<T> mine = s.q[lane];
      for (int kb = k0; kb < k1; kb += kWarp) {
        const int k = kb + lane;
        if (k < k1) {
          while (k >= s.pre[r + 1]) ++r;
          s.c[lane] = load_point(cands, s.first[r] + (k - s.pre[r]));
        }
        __syncwarp();
        const int n = min(kWarp, k1 - kb);
#pragma unroll 4
        for (int j = 0; j < n; ++j) op.own(within(mine, s.c[j], r2));
        __syncwarp();
      }
      op.done(s.qpos[lane], w);
      return;
    }
  }
  for (int kb = k0; kb < k1; kb += kWarp) {
    const int k = kb + lane;
    const bool valid = k < k1;
    int u = -1;
    Vec3<T> c{T(0), T(0), T(0), T(0)};
    if (valid) {
      while (k >= s.pre[r + 1]) ++r;
      u = s.first[r] + (k - s.pre[r]);
      c = load_point(cands, u);
    }
    op.candidate(u, valid);
#pragma unroll 4
    for (int t = 0; t < nq; ++t) {
      const bool hit = valid && within(s.q[t], c, r2);
      op.visit(t, s.qpos[t], s.qaux[t], hit, lane);
    }
  }
  op.done(lane < nq ? s.qpos[lane] : -1, w);
}

// Counts each query's hits: a ballot a query and chunk, summed in the
// query's lane; the piece's counts are added to out[qpos * W + w].
struct CountOp {
  static constexpr bool kOwnQuery = true;
  int32_t* out;
  int W;
  int count = 0;
  __device__ __forceinline__ void own(bool hit) { count += hit; }
  __device__ __forceinline__ bool keeps(int) const { return true; }
  __device__ __forceinline__ int aux(int) const { return 0; }
  __device__ __forceinline__ void candidate(int, bool) {}
  __device__ __forceinline__ void visit(int t, int, int, bool hit, int lane) {
    const unsigned b = __ballot_sync(kFull, hit);
    if (lane == t) count += __popc(b);
  }
  __device__ __forceinline__ void done(int qpos, int w) {
    if (qpos >= 0 && count) atomicAdd(out + static_cast<int64_t>(qpos) * W + w, count);
  }
};

__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ keys, int lo, int hi,
                                           int64_t key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// runs[9 * item + j] = (first sorted position, count) of the cells
// gz - 1 .. gz + 1 in column j (dx = j / 3 - 1, dy = j % 3 - 1) of item =
// group * W + window. The host pads every grid by one empty cell on each
// side: no column leaves its window's (or segment's) grid.
__global__ void __launch_bounds__(kBlock)
runs_kernel(Plan p, int64_t n_items, int2* __restrict__ runs) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= 9 * n_items) return;
  const int64_t item = idx / 9;
  const int j = static_cast<int>(idx - item * 9);
  const int g = static_cast<int>(item / p.W), w = static_cast<int>(item - static_cast<int64_t>(g) * p.W);
  const int64_t col = w * p.plane + p.gcol[g] + static_cast<int64_t>(j / 3 - 1) * p.gny[g] +
                      (j % 3 - 1);
  const int cs = p.start[col], ce = p.start[col + 1];
  const int64_t key = col * p.NZ + p.gz[g] - 1;
  const int lo = lower_bound(p.keys, cs, ce, key);
  const int hi = lower_bound(p.keys, lo, ce, key + 3);
  runs[idx] = make_int2(lo, hi - lo);
}

inline Plan make_plan(const void* keys, const void* start, const void* gstart, const void* gcol,
                      const void* gz, const void* gny, long long plane, int W, int NZ) {
  Plan p{};
  p.keys = static_cast<const int64_t*>(keys);
  p.start = static_cast<const int32_t*>(start);
  p.gstart = static_cast<const int32_t*>(gstart);
  p.gcol = static_cast<const int32_t*>(gcol);
  p.gz = static_cast<const int32_t*>(gz);
  p.gny = static_cast<const int32_t*>(gny);
  p.plane = plane;
  p.W = W;
  p.NZ = NZ;
  return p;
}

// The runs of every item (group, window), one launch of runs_kernel: keys
// (M,) int64 sorted, start (C + 1,) int32 column table, gstart (G + 1,),
// gcol, gz, gny (G,) int32; runs (9 * G * W, 2) int32. Each kernel library
// exports it under its own name. Returns the CUDA error of the launch.
inline int launch_runs(const void* keys, const void* start, const void* gstart,
                       const void* gcol, const void* gz, const void* gny, int G,
                       long long plane, int W, int NZ, void* runs, void* stream) {
  if (G < 0 || W < 1 || NZ < 3) return (int)cudaErrorInvalidValue;
  const int64_t threads = 9LL * G * W;
  if (threads == 0) return 0;
  const Plan p = make_plan(keys, start, gstart, gcol, gz, gny, plane, W, NZ);
  runs_kernel<<<static_cast<unsigned>((threads + kBlock - 1) / kBlock), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(p, static_cast<int64_t>(G) * W,
                                                     static_cast<int2*>(runs));
  return (int)cudaGetLastError();
}

}  // namespace cellwalk
