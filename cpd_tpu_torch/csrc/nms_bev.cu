// Kernels B4a, B4b and B4c: rotated BEV overlap and NMS.
//
//   B4a pairwise_overlap_bev  out[b, i, j] = min(area(A_bi clipped by B_bj),
//                                                dx_a * dy_a, dx_b * dy_b)
//   B4b nms_mask_bev          bit j of mask[b, i, j / 64] = j > i, valid[b, i],
//                             valid[b, j] and IoU(i, j) > thresh (BEV or 3D)
//   B4c nms_suppress          keep[b, i], greedy or fast, from those words
//
// They stand in for no Pallas kernel. They replace JAX op chains:
// cpd_tpu/ops/iou3d.py::boxes_overlap_bev (with boxes_iou_bev and
// boxes_iou3d on it), cpd_tpu/ops/nms.py::nms_bev's IoU matrix and its
// _greedy_suppress (a lax.fori_loop over K) and _fast_suppress, and the sweep
// of nms_normal_bev. The mask-block layout follows the reference's
// iou3d_nms_kernel.cu (nms_kernel: 64 x 64 tiles, one bit a pair).
//
// The overlap is the JAX package's clip formulation (iou3d.py
// _overlap_bev_clip): Sutherland-Hodgman clipping of quad A by the four
// half-planes of quad B with a fixed capacity of 8 vertices, each pass
// emitting, slot by slot, the crossing point (if the edge crosses) and the
// next vertex (if it is inside), at most 8 kept; then the shoelace sum over
// the slots in order. The port caps it at the smaller footprint: a box
// narrower than the f32 spacing at its place has coincident corners, and its
// inside tests (edges of length 0) pass everything. The plain versions in
// ops/iou3d.py and ops/nms.py repeat this arithmetic operation for operation
// without fused multiply-adds, and this file is built with -fmad=false
// (ops/cuda_build.py), so the two give the same bits on the same corners; the
// wrappers compute the corners with one torch function for both.
//
// Design. The clip keeps the polygon in registers: every slot loop is
// unrolled over the 8 slots, a vertex is emitted by a chain of predicated
// moves on its position, and no index is dynamic, so no kernel has a stack
// frame; the slot loops stop at the polygon's count. Before it clips, a pair
// meets the disjoint-pair reject of ops/iou3d.py (clip_reject): the box
// centres further apart than the sum of the footprints' half-diagonals,
// grown by a margin. The clip of such a pair is exactly 0.0
// (tests/test_torch_port_nms_kernel.py holds this on over a million pairs),
// so it is skipped; the footprint cap and the IoU after it are unchanged,
// and a box with a non-finite value or a side near the f32 spacing of its
// coordinates (a sliver, whose zero-length edges clip to an unbounded strip)
// is never rejected. How many pairs end there depends on the boxes: most of
// a real NMS's, 0.2-48% of the seeded models' crowded proposals.
// B4a: one thread a pair, blocks of 8 rows x 32 columns whose corners, areas
// and circles are staged in shared memory.
// B4b: one block of 256 threads a strip of 4 rows of a 64 x 64 tile on or
// above the diagonal (16 * words * (words + 1) / 2 blocks a sample, from one
// linear block index). The block stages its 4 rows and the tile's 64
// columns, meets each needed pair with the reject (one a thread), appends
// the pairs it lets through to a list in shared memory (one atomicAdd a
// warp), then clips the list 32 pairs a warp and sets the bits with
// atomicOr on the strip's 4 words. A strip above the diagonal also writes 4
// zero words of its mirror tile below it. The float IoU never reaches device
// memory: at K = 4096 the words are 2 MiB a sample.
// B4c fast (keep[i] = valid[i] and no valid row j < i has bit (j, i)): a
// block owns 4 adjacent words of a sample (a 32-byte sector of each row) and
// ORs them over every valid row whose diagonal word is at most theirs, 512
// threads in strides of 128 rows, then a warp reduction and the keep flags
// of the block's 256 rows; no atomics, no scratch.
// B4c greedy: one block a sample walks the 64-row blocks in order. The next
// block's rows (words from its diagonal on) come into shared memory with
// cp.async while the current block resolves in one warp: lane l holds rows l
// and l + 32's diagonal words; a candidate that no candidate above names is
// kept at once (two warp OR reductions), and the rest are taken lowest first,
// a __shfl_sync each. Then 4 threads a word OR the kept rows' words, from
// shared memory, into the `removed` words to the right. Shared memory: the
// `removed` words and two 64-row slabs, 1032 bytes a word of a row (K at
// most 14,400).
//
// What bounds them on an H100: B4a and B4b are operation bound (the reject's
// 8 operations on every needed pair and 80-400 f32 operations on each pair
// that reaches the clip, against 32 bytes of corners a box), but they run
// far from it: short NMS calls at the latency of a launch, a staging pass
// and one clip chain (the 4 passes' predicated moves, up to about 2,000
// instructions one after another), long ones at the clip's instruction
// count, a warp running to its slowest pair (a B4a warp clips when any of
// its 32 pairs does). B4c moves a few
// MB at most and is latency bound: fast by a launch and one round of loads
// per 128 rows, greedy by 2 block barriers and a warp's resolve per 64 rows,
// on one SM a sample.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 8;
constexpr float kEps = 1e-8f;
// the disjoint-pair reject (ops/iou3d.py clip_reject): a box takes part when
// its 7 values are finite and dx, dy >= (|x| + |y| + 1) * kSolid; its circle
// has the radius half its diagonal times kGrow, plus kPad
constexpr float kSolid = 1.0f / 1024.0f;
constexpr float kGrow = 1.0f + 1.0f / 64.0f;
constexpr float kPad = 1.0f / 1024.0f;
constexpr int kRowsA = 8;     // B4a block: 8 rows x 32 columns
constexpr int kColsA = 32;
constexpr int kTile = 64;     // B4b tile and word width
constexpr int kStrip = 4;     // B4b block: 4 rows of a 64 x 64 tile, 256 threads
constexpr int kMaskThreads = 256;
constexpr int kFastWords = 4;  // B4c fast: words a block owns
constexpr int kFastThreads = 512;
constexpr int kGreedyThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// torch.minimum / torch.clamp(min=) semantics: a NaN operand propagates
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Writes (x, y) to slot n of the pass's output when `on` (and n < kCap),
// then counts it; `most` is the highest slot it can reach at this point of
// the unrolled pass. Static indices only: the polygon stays in registers.
__device__ __forceinline__ void emit(float (&qx)[kCap], float (&qy)[kCap], int& n, bool on,
                                     float x, float y, int most) {
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    if (k <= most && on && n == k) {
      qx[k] = x;
      qy[k] = y;
    }
  }
  n += on ? 1 : 0;
}

// Area of quad a (4 ccw corners, x y interleaved) clipped by quad b. Each
// slot loop stops at `count`, the passes at an empty polygon: a warp whose
// pairs' quads lie apart leaves early.
__device__ __forceinline__ float clip_area(const float (&a)[8], const float (&b)[8]) {
  float px[kCap], py[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    px[k] = k < 4 ? a[2 * (k & 3)] : 0.0f;
    py[k] = k < 4 ? a[2 * (k & 3) + 1] : 0.0f;
  }
  int count = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (count == 0) return 0.0f;
    const float ax = b[2 * e], ay = b[2 * e + 1];
    const float evx = b[2 * ((e + 1) & 3)] - ax, evy = b[2 * ((e + 1) & 3) + 1] - ay;
    // a vertex's side test, computed once: slot s's next-side test is slot s + 1's
    const float side0 = evx * (py[0] - ay) - evy * (px[0] - ax);
    float cs = side0;
    float qx[kCap], qy[kCap];
#pragma unroll
    for (int k = 0; k < kCap; ++k) qx[k] = qy[k] = 0.0f;
    int n = 0;
#pragma unroll
    for (int s = 0; s < kCap; ++s) {
      if (s >= count) break;
      const bool wrap = s + 1 >= count;  // the next vertex is slot 0
      const float cx = px[s], cy = py[s];
      const float nx = wrap ? px[0] : px[(s + 1) & (kCap - 1)];
      const float ny = wrap ? py[0] : py[(s + 1) & (kCap - 1)];
      const float ns = wrap ? side0 : evx * (ny - ay) - evy * (nx - ax);
      const bool cin = cs >= -kEps, nin = ns >= -kEps;
      const bool cross = cin != nin;
      float ix = 0.0f, iy = 0.0f;
      if (cross) {
        const float denom = cs - ns;
        const float tt = cs / (fabsf(denom) > kEps ? denom : 1.0f);
        ix = cx + tt * (nx - cx);
        iy = cy + tt * (ny - cy);
      }
      emit(qx, qy, n, cross, ix, iy, 2 * s);
      emit(qx, qy, n, nin, nx, ny, 2 * s + 1);
      cs = ns;
    }
    count = n < kCap ? n : kCap;
#pragma unroll
    for (int k = 0; k < kCap; ++k) {
      px[k] = qx[k];
      py[k] = qy[k];
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kCap; ++s) {
    if (s >= count) break;
    const bool wrap = s + 1 >= count;
    const float nx = wrap ? px[0] : px[(s + 1) & (kCap - 1)];
    const float ny = wrap ? py[0] : py[(s + 1) & (kCap - 1)];
    acc = acc + (px[s] * ny - nx * py[s]);
  }
  return count >= 3 ? 0.5f * fabsf(acc) : 0.0f;
}

// The reject's circle of a box (x, y, z, dx, dy, dz, heading): its centre and
// its grown radius, NaN where the box takes no part (so every test fails).
__device__ __forceinline__ float4 reject_circle(const float* bx) {
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 7; ++k) finite = finite && fabsf(bx[k]) <= FLT_MAX;
  const float x = bx[0], y = bx[1], dx = bx[3], dy = bx[4];
  const float least = (fabsf(x) + fabsf(y) + 1.0f) * kSolid;
  const float r = 0.5f * sqrtf(dx * dx + dy * dy) * kGrow + kPad;
  return make_float4(x, y, finite && dx >= least && dy >= least ? r : __int_as_float(0x7fc00000),
                     0.0f);
}

// True only where both circles are finite and apart: the pair's clip is 0.0.
__device__ __forceinline__ bool disjoint(const float4& a, const float4& b) {
  const float ex = a.x - b.x, ey = a.y - b.y, s = a.z + b.z;
  return ex * ex + ey * ey > s * s;
}

// The overlap capped at the smaller footprint.
__device__ __forceinline__ float capped(float clipped, float area_a, float area_b) {
  return nan_min(clipped, nan_min(area_a, area_b));
}

__global__ void __launch_bounds__(kRowsA * kColsA)
pairwise_overlap_bev_kernel(const float* __restrict__ corners_a, const float* __restrict__ boxes_a,
                            const float* __restrict__ corners_b, const float* __restrict__ boxes_b,
                            int N, int M, float* __restrict__ out) {
  __shared__ float ca_s[kRowsA][8], cb_s[kColsA][8], area_a_s[kRowsA], area_b_s[kColsA];
  __shared__ float4 oa_s[kRowsA], ob_s[kColsA];
  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRowsA, col0 = blockIdx.y * kColsA;
  const int tid = threadIdx.y * kColsA + threadIdx.x;
  const float* ca = corners_a + static_cast<int64_t>(b) * N * 8;
  const float* cb = corners_b + static_cast<int64_t>(b) * M * 8;
  for (int e = tid; e < kRowsA * 8; e += kRowsA * kColsA) {
    const int r = e / 8;
    if (row0 + r < N) ca_s[r][e % 8] = ca[static_cast<int64_t>(row0 + r) * 8 + e % 8];
  }
  for (int e = tid; e < kColsA * 8; e += kRowsA * kColsA) {
    const int c = e / 8;
    if (col0 + c < M) cb_s[c][e % 8] = cb[static_cast<int64_t>(col0 + c) * 8 + e % 8];
  }
  if (tid < kRowsA && row0 + tid < N) {
    const float* bx = boxes_a + (static_cast<int64_t>(b) * N + row0 + tid) * 7;
    area_a_s[tid] = bx[3] * bx[4];
    oa_s[tid] = reject_circle(bx);
  }
  if (tid < kColsA && col0 + tid < M) {
    const float* bx = boxes_b + (static_cast<int64_t>(b) * M + col0 + tid) * 7;
    area_b_s[tid] = bx[3] * bx[4];
    ob_s[tid] = reject_circle(bx);
  }
  __syncthreads();
  const int i = row0 + threadIdx.y, j = col0 + threadIdx.x;
  if (i >= N || j >= M) return;
  float clipped = 0.0f;
  if (!disjoint(oa_s[threadIdx.y], ob_s[threadIdx.x]))
    clipped = clip_area(ca_s[threadIdx.y], cb_s[threadIdx.x]);
  out[(static_cast<int64_t>(b) * N + i) * M + j] =
      capped(clipped, area_a_s[threadIdx.y], area_b_s[threadIdx.x]);
}

struct BoxTerms {
  float area, vol, zmin, zmax;
};

__device__ __forceinline__ BoxTerms box_terms(const float* bx) {
  BoxTerms t;
  t.area = bx[3] * bx[4];
  t.vol = t.area * bx[5];
  t.zmin = bx[2] - bx[5] / 2.0f;
  t.zmax = bx[2] + bx[5] / 2.0f;
  return t;
}

// IoU as ops/iou3d.py computes it from the capped overlap
// (iou_bev_from_overlap, iou3d_from_overlap)
__device__ __forceinline__ float pair_iou(float ov, const BoxTerms& a, const BoxTerms& b,
                                          bool bev) {
  if (bev) return ov / nan_max(a.area + b.area - ov, 1e-6f);
  const float h = nan_max(nan_min(a.zmax, b.zmax) - nan_max(a.zmin, b.zmin), 0.0f);
  const float ov3 = ov * h;
  return ov3 / nan_max(a.vol + b.vol - ov3, 1e-6f);
}

// corners: (B, K, 8) f32, 16-byte aligned (the wrapper checks)
// (min 1 block an SM: ptxas then takes the 65th register that keeps the
// stack frame empty)
__global__ void __launch_bounds__(kMaskThreads, 1)
nms_mask_bev_kernel(const float* __restrict__ corners, const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid, int K, float thresh, int bev,
                    unsigned long long* __restrict__ mask) {
  // the strip's rows and the tile's columns; the clip reads their corners where
  // it needs them, so that they take no registers across it
  __shared__ __align__(16) float ca_s[kStrip][8], cb_s[kTile][8];
  __shared__ float4 oa_s[kStrip], ob_s[kTile];  // their reject circles
  __shared__ BoxTerms ta_s[kStrip], tb_s[kTile];
  __shared__ uint8_t va_s[kStrip], vb_s[kTile];
  __shared__ unsigned long long word_s[kStrip];
  __shared__ unsigned short todo_s[kStrip * kTile];  // the pairs that reach the clip, r * 64 + c
  __shared__ int n_todo;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int words = (K + kTile - 1) / kTile;
  const int strip = blockIdx.x % (kTile / kStrip);
  int rblk = 0, cblk = blockIdx.x / (kTile / kStrip);  // the tiles on and above the diagonal
  while (cblk >= words - rblk) {
    cblk -= words - rblk;
    ++rblk;
  }
  cblk += rblk;
  const int r0 = rblk * kTile + strip * kStrip, c0 = cblk * kTile;
  unsigned long long* m = mask + static_cast<int64_t>(b) * K * words;
  // this strip's share of the mirror tile below the diagonal: no bit
  const int mirror = c0 + strip * kStrip + tid;
  if (cblk > rblk && tid < kStrip && mirror < K)
    m[static_cast<int64_t>(mirror) * words + rblk] = 0ull;
  for (int e = tid; e < 2 * (kStrip + kTile); e += kMaskThreads) {  // 16-byte halves of corners
    const int box = e >> 1, half = e & 1;
    const int g = box < kStrip ? r0 + box : c0 + box - kStrip;
    if (g < K)
      reinterpret_cast<float4*>(box < kStrip ? ca_s[box] : cb_s[box - kStrip])[half] =
          reinterpret_cast<const float4*>(corners)[(static_cast<int64_t>(b) * K + g) * 2 + half];
  }
  if (tid < kStrip + kTile) {
    const int g = tid < kStrip ? r0 + tid : c0 + tid - kStrip;
    if (g < K) {
      const float* bx = boxes + (static_cast<int64_t>(b) * K + g) * 7;
      const uint8_t ok = valid[static_cast<int64_t>(b) * K + g];
      if (tid < kStrip) {
        ta_s[tid] = box_terms(bx);
        oa_s[tid] = reject_circle(bx);
        va_s[tid] = ok;
      } else {
        tb_s[tid - kStrip] = box_terms(bx);
        ob_s[tid - kStrip] = reject_circle(bx);
        vb_s[tid - kStrip] = ok;
      }
    }
  }
  if (tid < kStrip) word_s[tid] = 0ull;
  if (tid == 0) n_todo = 0;
  __syncthreads();
  // Every needed pair (j > i, both valid) meets the reject; the others go on
  // the list, each warp appending its run with one atomicAdd. A rejected
  // pair's clip is 0.0, its footprints are finite and positive, and its IoU
  // is 0 or NaN: no bit unless thresh < 0, where the IoU of the capped 0 is
  // computed.
  const bool low_thresh = 0.0f > thresh;
#pragma unroll
  for (int p = tid; p < kStrip * kTile; p += kMaskThreads) {
    const int r = p / kTile, c = p % kTile, i = r0 + r, j = c0 + c;
    const bool need = j > i && j < K && va_s[r] && vb_s[c];
    const bool clip = need && !disjoint(oa_s[r], ob_s[c]);
    if (need && !clip && low_thresh &&
        pair_iou(capped(0.0f, ta_s[r].area, tb_s[c].area), ta_s[r], tb_s[c], bev != 0) > thresh)
      atomicOr(&word_s[r], 1ull << c);
    const unsigned run = __ballot_sync(kFull, clip);
    int base = 0;
    if (lane == 0 && run) base = atomicAdd(&n_todo, __popc(run));
    base = __shfl_sync(kFull, base, 0);
    if (clip) todo_s[base + __popc(run & ((1u << lane) - 1))] = static_cast<unsigned short>(p);
  }
  __syncthreads();
  // the clips, 32 a warp
  const int n = n_todo;
  for (int t = tid; t < n; t += kMaskThreads) {
    const int p = todo_s[t], r = p / kTile, c = p % kTile;
    const float ov = capped(clip_area(ca_s[r], cb_s[c]), ta_s[r].area, tb_s[c].area);
    if (pair_iou(ov, ta_s[r], tb_s[c], bev != 0) > thresh) atomicOr(&word_s[r], 1ull << c);
  }
  __syncthreads();
  if (tid < kStrip && r0 + tid < K) m[static_cast<int64_t>(r0 + tid) * words + cblk] = word_s[tid];
}

__global__ void __launch_bounds__(kFastThreads)
nms_fast_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                int K, uint8_t* __restrict__ keep) {
  __shared__ unsigned long long part[kFastThreads / 32][kFastWords];
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int words = (K + kTile - 1) / kTile;
  const int w = g * kFastWords + (tid & (kFastWords - 1));
  const unsigned long long* m = mask + static_cast<int64_t>(b) * K * words;
  const uint8_t* v = valid + static_cast<int64_t>(b) * K;
  // rows whose words from the diagonal on reach this block's words
  const int rows = min(K, (g + 1) * kFastWords * kTile);
  unsigned long long acc = 0ull;
  if (w < words) {
#pragma unroll 4
    for (int j = tid / kFastWords; j < rows; j += kFastThreads / kFastWords) {
      const unsigned long long bits =
          j / kTile <= w ? m[static_cast<int64_t>(j) * words + w] : 0ull;
      acc |= v[j] ? bits : 0ull;
    }
  }
#pragma unroll
  for (int off = kFastWords; off < 32; off <<= 1) acc |= __shfl_xor_sync(kFull, acc, off);
  if (lane < kFastWords) part[tid >> 5][lane] = acc;
  __syncthreads();
  if (tid < kFastWords * kTile) {
    const int q = tid / kTile, i = g * kFastWords * kTile + tid;
    unsigned long long hit = 0ull;
#pragma unroll
    for (int p = 0; p < kFastThreads / 32; ++p) hit |= part[p][q];
    if (i < K) keep[static_cast<int64_t>(b) * K + i] = v[i] && !((hit >> (tid % kTile)) & 1ull);
  }
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v |= __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of row block rb's words from its diagonal word on into `slab`
// (row stride `words`).
__device__ __forceinline__ void slab_prefetch(unsigned long long* slab,
                                              const unsigned long long* m, int rb, int K,
                                              int words) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = rb * kTile, rows = min(kTile, K - r0);
  for (int r = warp; r < rows; r += kGreedyThreads / 32)
    for (int w = rb + lane; w < words; w += 32)
      cp_async8(slab + r * words + w, m + static_cast<int64_t>(r0 + r) * words + w);
}

__global__ void __launch_bounds__(kGreedyThreads)
nms_greedy_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                  int K, uint8_t* __restrict__ keep) {
  // the block's kept rows, the `removed` words, then two slabs of 64 rows x words
  extern __shared__ unsigned long long smem[];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int words = (K + kTile - 1) / kTile;
  unsigned long long* kept_s = smem;
  unsigned long long* removed = smem + 1;
  unsigned long long* slabs = removed + words;
  const unsigned long long* m = mask + static_cast<int64_t>(b) * K * words;
  const uint8_t* v = valid + static_cast<int64_t>(b) * K;
  uint8_t* out = keep + static_cast<int64_t>(b) * K;
  slab_prefetch(slabs, m, 0, K, words);
  // a row is kept when valid and not removed: invalid rows (and rows past K) start removed
  for (int w = warp; w < words; w += kGreedyThreads / 32) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(kFull, i < K && v[i]);
    const unsigned hi = __ballot_sync(kFull, i + 32 < K && v[i + 32]);
    if (lane == 0) removed[w] = ~(lo | (static_cast<unsigned long long>(hi) << 32));
  }
  cp_async_wait_all();
  __syncthreads();
  for (int rb = 0; rb < words; ++rb) {
    const unsigned long long* cur = slabs + (rb & 1) * kTile * words;
    if (rb + 1 < words) slab_prefetch(slabs + ((rb + 1) & 1) * kTile * words, m, rb + 1, K, words);
    const int r0 = rb * kTile, rows = min(kTile, K - r0);
    if (warp == 0) {
      // lane l holds the diagonal words of rows l and l + 32, their bits above
      // the row only (those at or below name rows already decided)
      const unsigned long long dlo =
          lane < rows ? cur[lane * words + rb] & (~0ull << lane << 1) : 0ull;
      const unsigned long long dhi =
          lane + 32 < rows ? cur[(lane + 32) * words + rb] & (~0ull << (lane + 32) << 1) : 0ull;
      const unsigned long long cand = ~removed[rb];  // valid and not removed so far
      // a candidate that no candidate above names is kept whatever the others do
      const unsigned long long named = warp_or(((cand >> lane) & 1ull ? dlo : 0ull) |
                                               ((cand >> (lane + 32)) & 1ull ? dhi : 0ull));
      unsigned long long kept = cand & ~named;
      const unsigned long long gone = warp_or(((kept >> lane) & 1ull ? dlo : 0ull) |
                                              ((kept >> (lane + 32)) & 1ull ? dhi : 0ull));
      // the rest in order: the lowest is kept, and removes what it names
      for (unsigned long long rest = cand & named & ~gone; rest;) {
        const int r = __ffsll(static_cast<long long>(rest)) - 1;
        const unsigned long long d = __shfl_sync(kFull, r < 32 ? dlo : dhi, r & 31);
        kept |= 1ull << r;
        rest &= rest - 1;
        rest &= ~d;
      }
      if (lane < rows) out[r0 + lane] = (kept >> lane) & 1ull;
      if (lane + 32 < rows) out[r0 + lane + 32] = (kept >> (lane + 32)) & 1ull;
      if (lane == 0) *kept_s = kept;
    }
    __syncthreads();
    // the kept rows' words to the right: 4 threads a word, 16 rows each
    const unsigned long long kept = *kept_s;
    const int g = tid & 3;
    const unsigned mine = static_cast<unsigned>(kept >> (16 * g)) & 0xffffu;
    for (int w0 = rb + 1; w0 < words; w0 += kGreedyThreads / 4) {
      const int w = w0 + (tid >> 2);
      unsigned long long acc = 0ull;
      if (w < words) {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          if ((mine >> q) & 1u) acc |= cur[(16 * g + q) * words + w];
      }
      acc |= __shfl_xor_sync(kFull, acc, 1);
      acc |= __shfl_xor_sync(kFull, acc, 2);
      if (g == 0 && w < words) removed[w] |= acc;
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

}  // namespace

extern "C" int cpd_pairwise_overlap_bev(const float* corners_a, const float* boxes_a,
                                        const float* corners_b, const float* boxes_b, int B,
                                        int N, int M, float* out, cudaStream_t stream) {
  const dim3 grid((N + kRowsA - 1) / kRowsA, (M + kColsA - 1) / kColsA, B);
  pairwise_overlap_bev_kernel<<<grid, dim3(kColsA, kRowsA), 0, stream>>>(
      corners_a, boxes_a, corners_b, boxes_b, N, M, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cpd_nms_mask_bev(const float* corners, const float* boxes, const uint8_t* valid,
                                int B, int K, float thresh, int use_bev_iou,
                                unsigned long long* mask, cudaStream_t stream) {
  const int words = (K + kTile - 1) / kTile;
  const unsigned tiles = static_cast<unsigned>(static_cast<int64_t>(words) * (words + 1) / 2);
  nms_mask_bev_kernel<<<dim3(tiles * (kTile / kStrip), B), kMaskThreads, 0, stream>>>(
      corners, boxes, valid, K, thresh, use_bev_iou, mask);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cpd_nms_suppress(const unsigned long long* mask, const uint8_t* valid, int B, int K,
                                int fast, uint8_t* keep, cudaStream_t stream) {
  const int words = (K + kTile - 1) / kTile;
  if (fast) {
    nms_fast_kernel<<<dim3(B, (words + kFastWords - 1) / kFastWords), kFastThreads, 0, stream>>>(
        mask, valid, K, keep);
  } else {
    // the kept rows' word, the `removed` words and two 64-row slabs
    const int smem = static_cast<int>(sizeof(unsigned long long)) * (1 + words * (1 + 2 * kTile));
    cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    nms_greedy_kernel<<<B, kGreedyThreads, smem, stream>>>(mask, valid, K, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
