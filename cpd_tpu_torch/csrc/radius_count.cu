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
// ((w * NX + gx) * NY + gy) * NZ + gz (torch.sort) and builds the column
// table over (w, gx, gy) from the sorted keys; it sorts the queries by cell
// and cuts them into groups of at most 32 of one cell. Two launches:
//   1. runs (cpd_radius_count_runs, cell_walk.cuh's runs_kernel, which R2
//      launches too): one thread an (item, column):
//      the run of cells gz - 1 .. gz + 1 inside one of the item's 9 columns,
//      by a search of at most log2(column) steps inside the column. No search
//      runs over all keys;
//   2. count: one warp a piece of up to 1024 candidates of an item (the host
//      cuts the items into pieces from the runs' counts): the lanes load 32
//      support points at once (float4), every query of the group is tested
//      against them, and __popc(__ballot_sync(...)) counts its hits; a full
//      group of 32 queries runs the other way round, each lane its own
//      query against the 32 points read back from shared memory. A piece
//      adds its counts with atomicAdd (integers: the sum does not depend on
//      the order).
// cell_walk.cuh holds the walk.
//
// The distance is (dx*dx + dy*dy) + dz*dz in f32, each operation rounded on
// its own (__fmul_rn / __fadd_rn: no FMA contraction), the order the plain
// version and the JAX brute force use: the counts are bit-identical to them.
//
// What bounds it on an H100: the CUDA cores' instruction rate. Every
// query tests every support point of its 27 cells (3.09 tests a neighbour
// pair on a drive's windows), at 12-16 warp instructions for 32 tests (the
// query's or the candidate's broadcast from shared memory, the 8 f32
// operations, the compare and the count); the bytes (each window's support
// read once a piece, from L2) are small. Pieces bound a warp's work to 1024
// candidates times the group's queries, so the densest cells (thousands of
// support points) are spread over many warps. On the middle frame of a
// 20-frame drive (200k queries, 4 windows of 1M points) 98.9% of the lanes
// test a pair; the count takes about 0.77 ms on an H100 (chip_smoke.py
// phase 15's profile), 19 times the f32 bound of the pairs the counts hold.
#include <cstdint>
#include <cuda_runtime.h>

#include "cell_walk.cuh"

namespace {

using namespace cellwalk;

__global__ void __launch_bounds__(kBlock)
count_kernel(Plan p, int n_pieces, const float4* __restrict__ query,
             const float4* __restrict__ support, float r2, int32_t* __restrict__ out) {
  __shared__ WarpSlots<float> slots[kWarpsPerBlock];
  const int warp = threadIdx.x / kWarp;
  const int64_t piece = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  if (piece >= n_pieces) return;
  CountOp op{out, p.W};
  walk_piece(p, static_cast<int>(piece), query, support, r2, slots[warp], op);
}

}  // namespace

// The runs of every item (group, window), cellwalk::launch_runs.
extern "C" int cpd_radius_count_runs(const void* keys, const void* start, const void* gstart,
                                     const void* gcol, const void* gz, const void* gny, int G,
                                     long long plane, int W, int NZ, void* runs, void* stream) {
  return launch_runs(keys, start, gstart, gcol, gz, gny, G, plane, W, NZ, runs, stream);
}

// query (N, 4) f32 sorted by cell; the plan's arrays as for launch_runs,
// with keys the support's and runs its result; piece_item and piece_k (P,)
// int32; support (M, 4) f32 in the keys' order; out (N, W) int32, zeroed,
// in the queries' order. Returns the CUDA error of the launch.
extern "C" int cpd_radius_count(const void* query, const void* keys, const void* start,
                                const void* gstart, const void* gcol, const void* gz,
                                const void* gny, long long plane, int W, int NZ,
                                const void* runs, const void* piece_item, const void* piece_k,
                                int P, const void* support, float r2, void* out, void* stream) {
  if (P < 0 || W < 1 || NZ < 3) return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  Plan p = make_plan(keys, start, gstart, gcol, gz, gny, plane, W, NZ);
  p.runs = static_cast<const int2*>(runs);
  p.piece_item = static_cast<const int32_t*>(piece_item);
  p.piece_k = static_cast<const int32_t*>(piece_k);
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(P) + kWarpsPerBlock - 1) /
                                                kWarpsPerBlock);
  count_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      p, P, static_cast<const float4*>(query), static_cast<const float4*>(support), r2,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
