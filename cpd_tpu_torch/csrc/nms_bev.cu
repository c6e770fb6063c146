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
// Design. B4a: one thread a pair, blocks of 8 rows x 32 columns whose corners
// and boxes are staged in shared memory. B4b: one block of 64 threads a
// 64 x 64 tile and sample; a thread walks the tile's 64 columns for its row
// and writes one 64-bit word; tiles below the diagonal write zeros and
// compute nothing. The float IoU never reaches device memory: at K = 4096
// the words are 2 MiB a sample. B4c: one block a sample, the whole batch in
// one launch. Greedy: the block walks the row blocks in order; 64 threads
// load the block's diagonal words into shared memory, one thread resolves the
// 64 rows in order against the running `removed` word, and then all threads
// OR the kept rows' words into the `removed` words to the right (ceil(K/64)
// words in shared memory). Fast: keep[i] = valid[i] and no valid row j < i
// has bit (j, i); the block ORs every valid row's words into shared memory
// (atomicOr on the nonzero ones).
//
// What bounds them on an H100: B4a and B4b are operation bound in principle
// (80-120 f32 operations a pair on the paths' boxes, most pairs clipping to
// nothing within two passes, against 32 bytes of corners), but they run
// 40-100 times that bound: the passes branch per pair and the polygon's
// vertices live in local memory (dynamic indices). B4c is latency bound: its
// greedy walk takes two block barriers per 64 rows on one SM a sample.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 8;
constexpr float kEps = 1e-8f;
constexpr int kRowsA = 8;     // B4a block: 8 rows x 32 columns
constexpr int kColsA = 32;
constexpr int kTile = 64;     // B4b tile and word width
constexpr int kSuppressThreads = 256;

// torch.minimum / torch.clamp(min=) semantics: a NaN operand propagates
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Area of quad a (4 ccw corners, x y interleaved) clipped by quad b.
__device__ float clip_area(const float* a, const float* b) {
  float px[kCap], py[kCap];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = a[2 * k];
    py[k] = a[2 * k + 1];
  }
  int count = 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ax = b[2 * e], ay = b[2 * e + 1];
    const float evx = b[2 * ((e + 1) & 3)] - ax, evy = b[2 * ((e + 1) & 3) + 1] - ay;
    float qx[kCap], qy[kCap];
    int n = 0;
    for (int s = 0; s < count; ++s) {
      const int t = s + 1 < count ? s + 1 : 0;
      const float cx = px[s], cy = py[s], nx = px[t], ny = py[t];
      const float cs = evx * (cy - ay) - evy * (cx - ax);
      const float ns = evx * (ny - ay) - evy * (nx - ax);
      const bool cin = cs >= -kEps, nin = ns >= -kEps;
      if (cin != nin) {
        const float denom = cs - ns;
        const float tt = cs / (fabsf(denom) > kEps ? denom : 1.0f);
        if (n < kCap) {
          qx[n] = cx + tt * (nx - cx);
          qy[n] = cy + tt * (ny - cy);
        }
        ++n;
      }
      if (nin) {
        if (n < kCap) {
          qx[n] = nx;
          qy[n] = ny;
        }
        ++n;
      }
    }
    count = n < kCap ? n : kCap;
    for (int s = 0; s < count; ++s) {
      px[s] = qx[s];
      py[s] = qy[s];
    }
  }
  float acc = 0.0f;
  for (int s = 0; s < count; ++s) {
    const int t = s + 1 < count ? s + 1 : 0;
    acc = acc + (px[s] * py[t] - px[t] * py[s]);
  }
  return count >= 3 ? 0.5f * fabsf(acc) : 0.0f;
}

// The capped overlap of a pair; `box` rows are (x, y, z, dx, dy, dz, heading).
__device__ __forceinline__ float overlap(const float* ca, const float* cb, float area_a,
                                         float area_b) {
  return nan_min(clip_area(ca, cb), nan_min(area_a, area_b));
}

__global__ void __launch_bounds__(kRowsA * kColsA)
pairwise_overlap_bev_kernel(const float* __restrict__ corners_a, const float* __restrict__ boxes_a,
                            const float* __restrict__ corners_b, const float* __restrict__ boxes_b,
                            int N, int M, float* __restrict__ out) {
  __shared__ float ca_s[kRowsA][8], cb_s[kColsA][8], area_a_s[kRowsA], area_b_s[kColsA];
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
  }
  if (tid < kColsA && col0 + tid < M) {
    const float* bx = boxes_b + (static_cast<int64_t>(b) * M + col0 + tid) * 7;
    area_b_s[tid] = bx[3] * bx[4];
  }
  __syncthreads();
  const int i = row0 + threadIdx.y, j = col0 + threadIdx.x;
  if (i >= N || j >= M) return;
  out[(static_cast<int64_t>(b) * N + i) * M + j] =
      overlap(ca_s[threadIdx.y], cb_s[threadIdx.x], area_a_s[threadIdx.y], area_b_s[threadIdx.x]);
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

// IoU as ops/iou3d.py computes it from the overlap (iou_bev_from_overlap,
// iou3d_from_overlap)
__device__ __forceinline__ float pair_iou(const float* ca, const float* cb, const BoxTerms& a,
                                          const BoxTerms& b, bool bev) {
  const float ov = overlap(ca, cb, a.area, b.area);
  if (bev) return ov / nan_max(a.area + b.area - ov, 1e-6f);
  const float h = nan_max(nan_min(a.zmax, b.zmax) - nan_max(a.zmin, b.zmin), 0.0f);
  const float ov3 = ov * h;
  return ov3 / nan_max(a.vol + b.vol - ov3, 1e-6f);
}

__global__ void __launch_bounds__(kTile)
nms_mask_bev_kernel(const float* __restrict__ corners, const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid, int K, float thresh, int bev,
                    unsigned long long* __restrict__ mask) {
  __shared__ float cb_s[kTile][8];
  __shared__ BoxTerms tb_s[kTile];
  __shared__ uint8_t vb_s[kTile];
  const int b = blockIdx.z, cblk = blockIdx.x, rblk = blockIdx.y;
  const int words = (K + kTile - 1) / kTile;
  const int i = rblk * kTile + threadIdx.x;
  unsigned long long* row_words = mask + (static_cast<int64_t>(b) * K + i) * words;
  if (cblk < rblk) {  // below the diagonal: no bit j > i
    if (i < K) row_words[cblk] = 0ull;
    return;
  }
  const float* cs = corners + static_cast<int64_t>(b) * K * 8;
  const float* bs = boxes + static_cast<int64_t>(b) * K * 7;
  const uint8_t* vs = valid + static_cast<int64_t>(b) * K;
  const int j0 = cblk * kTile;
  for (int e = threadIdx.x; e < kTile * 8; e += kTile) {
    const int c = e / 8;
    if (j0 + c < K) cb_s[c][e % 8] = cs[static_cast<int64_t>(j0 + c) * 8 + e % 8];
  }
  if (j0 + threadIdx.x < K) {
    tb_s[threadIdx.x] = box_terms(bs + static_cast<int64_t>(j0 + threadIdx.x) * 7);
    vb_s[threadIdx.x] = vs[j0 + threadIdx.x];
  }
  __syncthreads();
  if (i >= K) return;
  unsigned long long word = 0ull;
  if (vs[i]) {
    float ca[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ca[k] = cs[static_cast<int64_t>(i) * 8 + k];
    const BoxTerms ta = box_terms(bs + static_cast<int64_t>(i) * 7);
    const int cols = K - j0 < kTile ? K - j0 : kTile;
    for (int c = (j0 > i ? 0 : i - j0 + 1); c < cols; ++c) {
      if (vb_s[c] && pair_iou(ca, cb_s[c], ta, tb_s[c], bev != 0) > thresh) word |= 1ull << c;
    }
  }
  row_words[cblk] = word;
}

__global__ void __launch_bounds__(kSuppressThreads)
nms_greedy_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                  int K, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // words, then the block's diagonal words
  __shared__ unsigned long long kept_s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (K + kTile - 1) / kTile;
  unsigned long long* diag = removed + words;
  const unsigned long long* m = mask + static_cast<int64_t>(b) * K * words;
  const uint8_t* v = valid + static_cast<int64_t>(b) * K;
  for (int w = tid; w < words; w += kSuppressThreads) removed[w] = 0ull;
  __syncthreads();
  for (int rb = 0; rb < words; ++rb) {
    const int r0 = rb * kTile, rows = K - r0 < kTile ? K - r0 : kTile;
    if (tid < rows) diag[tid] = v[r0 + tid] ? m[static_cast<int64_t>(r0 + tid) * words + rb] : 0ull;
    __syncthreads();
    if (tid == 0) {
      unsigned long long rem = removed[rb], kept = 0ull;
      for (int r = 0; r < rows; ++r) {
        if (v[r0 + r] && !((rem >> r) & 1ull)) {
          kept |= 1ull << r;
          rem |= diag[r];
        }
      }
      removed[rb] = rem;
      kept_s = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_s;
    if (tid < rows) keep[static_cast<int64_t>(b) * K + r0 + tid] = (kept >> tid) & 1ull;
    for (int w = rb + 1 + tid; w < words; w += kSuppressThreads) {
      unsigned long long acc = 0ull;
      for (unsigned long long left = kept; left; left &= left - 1) {
        const int r = __ffsll(static_cast<long long>(left)) - 1;
        acc |= m[static_cast<int64_t>(r0 + r) * words + w];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSuppressThreads)
nms_fast_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                int K, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long hit[];  // OR of the valid rows' words
  const int b = blockIdx.x, tid = threadIdx.x;
  const int words = (K + kTile - 1) / kTile;
  const unsigned long long* m = mask + static_cast<int64_t>(b) * K * words;
  const uint8_t* v = valid + static_cast<int64_t>(b) * K;
  for (int w = tid; w < words; w += kSuppressThreads) hit[w] = 0ull;
  __syncthreads();
  const int64_t total = static_cast<int64_t>(K) * words;
  for (int64_t e = tid; e < total; e += kSuppressThreads) {
    const int j = static_cast<int>(e / words), w = static_cast<int>(e % words);
    if (w < j / kTile || !v[j]) continue;  // words left of the diagonal hold no bit
    const unsigned long long bits = m[e];
    if (bits) atomicOr(&hit[w], bits);
  }
  __syncthreads();
  for (int i = tid; i < K; i += kSuppressThreads)
    keep[static_cast<int64_t>(b) * K + i] = v[i] && !((hit[i / kTile] >> (i % kTile)) & 1ull);
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
  nms_mask_bev_kernel<<<dim3(words, words, B), kTile, 0, stream>>>(corners, boxes, valid, K,
                                                                   thresh, use_bev_iou, mask);
  return static_cast<int>(cudaGetLastError());
}

// shared memory a block of B4c asks for: the `removed` (or hit) words and,
// for the greedy walk, a block's diagonal words
extern "C" int cpd_nms_suppress_smem_bytes(int K, int fast) {
  const int words = (K + kTile - 1) / kTile;
  return static_cast<int>(sizeof(unsigned long long)) * (words + (fast ? 0 : kTile));
}

extern "C" int cpd_nms_suppress(const unsigned long long* mask, const uint8_t* valid, int B, int K,
                                int fast, uint8_t* keep, cudaStream_t stream) {
  const int smem = cpd_nms_suppress_smem_bytes(K, fast);
  if (fast) {
    cudaFuncSetAttribute(nms_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    nms_fast_kernel<<<B, kSuppressThreads, smem, stream>>>(mask, valid, K, keep);
  } else {
    cudaFuncSetAttribute(nms_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    nms_greedy_kernel<<<B, kSuppressThreads, smem, stream>>>(mask, valid, K, keep);
  }
  return static_cast<int>(cudaGetLastError());
}
