// Kernel G2: the per-tap gather-GEMM,
//
//   out[n, :] = sum over k, in tap order, of (found[n, k] ? table[idx[n, k], :] @ W[k] : 0)
//
// Replaces the TPU probe scripts/exp_tal_gather.py:86 (body :74-83): with no
// grid and every array resident in fast memory, one same-shape
// take_along_axis gather and one (V, Cin) @ (Cin, Cout) product per tap,
// summed in tap order in f32. A block on a GPU holds a tile of rows, not the
// arrays, so the tap loop runs inside each block over its tile.
//
// What bounds it on an H100: bytes (idx, found, table, W read once and the
// f32 output written once, a few tens of MB: about 0.01 ms), with the found
// taps' 2 * Cin * Cout operations below that on the tensor cores. This
// version's own time is its f32 FMAs on the CUDA cores, so the design spends
// them on found taps only: an unfound row contributes exactly zero to its
// tap's product, and 60% (the probe) to 90% (a lidar frame) of the taps are
// unfound. Per tap the block COMPACTS the tile's rows that found it (a ballot
// scan that keeps row order, as in csrc/gather_gemm_dw.cu), gathers only
// those rows, multiplies the compacted (hits, Cin) operand with W[k] in f32
// registers, and adds each product row into the tile's f32 accumulator in
// shared memory at its own output row. A row finds a tap at most once, so
// within a tap every accumulator element has one writer, and the taps are
// separated by a barrier: the sum runs in tap order, the same bits on every
// launch, with no float atomics. Kernel A1 (csrc/gather_gemm.cu) instead
// multiplies every tap of every row, zeros included. The column tile is sized
// to Cout (16, 32 or 64 wide). Tensor cores on the compacted operand are
// later work.
//
// Traps: an unfound tap's idx may be junk and is never read; an idx outside
// [0, V) is dropped, never loaded; scalar loads with a channel mask take any
// Cin (5-channel rows) and any K (3 for conv_out); the last tile is ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;       // output rows per block, scanned once per tap
constexpr int TS = 64;        // compacted rows multiplied per step
constexpr int TK = 16;        // input channels staged per step
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int TN>
__global__ void __launch_bounds__(THREADS)
gather_gemm_per_tap_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ found, const T* __restrict__ w,
                           float* __restrict__ out, int V, int N, int K, int Cin, int Cout) {
  constexpr int TXN = TN / 4;         // threads along the columns
  constexpr int TYN = THREADS / TXN;  // threads along the compacted rows
  constexpr int RM = TS / TYN;        // compacted rows per thread
  __shared__ float Os[TM * TN];       // the tile's f32 accumulator
  __shared__ float As[TK][TS + 1];    // gathered rows of the staged hits, channel-major
  __shared__ float Bs[TK][TN];        // W[k] chunk
  __shared__ int src[TM];             // table row of each hit, in row order
  __shared__ int dst[TM];             // its row of the tile
  __shared__ int warp_cnt[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TXN;  // this thread's columns:        j0 + tx + TXN * j
  const int ty = tid / TXN;  // this thread's compacted rows: s0 + ty + TYN * i
  const int n0 = blockIdx.x * TM;
  const int j0 = blockIdx.y * TN;

  for (int e = tid; e < TM * TN; e += THREADS) Os[e] = 0.f;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    // which rows of the tile found tap k: compact them, keeping row order
    int hit = 0, s = 0;
    if (tid < TM && n0 + tid < N) {
      const size_t g = (size_t)(n0 + tid) * K + k;
      if (found[g]) {
        const int v = idx[g];
        if (v >= 0 && v < V) {  // never read outside the table
          hit = 1;
          s = v;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      const int c = warp_cnt[i];
      if (i < warp) offset += c;
      total += c;
    }
    if (hit) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      src[pos] = s;
      dst[pos] = tid;
    }
    __syncthreads();

    for (int s0 = 0; s0 < total; s0 += TS) {
      float acc[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c0 = 0; c0 < Cin; c0 += TK) {
        for (int e = tid; e < TS * TK; e += THREADS) {
          const int m = e / TK, c = e % TK;
          float v = 0.f;
          if (s0 + m < total && c0 + c < Cin)
            v = to_float(table[(size_t)src[s0 + m] * Cin + c0 + c]);
          As[c][m] = v;
        }
        for (int e = tid; e < TK * TN; e += THREADS) {
          const int c = e / TN, j = e % TN;
          float v = 0.f;
          if (c0 + c < Cin && j0 + j < Cout)
            v = to_float(w[((size_t)k * Cin + c0 + c) * Cout + j0 + j]);
          Bs[c][j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int c = 0; c < TK; ++c) {
          float a[RM], bb[4];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = As[c][ty + TYN * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = Bs[c][tx + TXN * j];
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
        }
        __syncthreads();
      }
      // one writer per accumulator element within a tap: a row finds it once
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int slot = s0 + ty + TYN * i;
        if (slot >= total) continue;
        float* o = Os + dst[slot] * TN;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[tx + TXN * j] += acc[i][j];
      }
    }
    __syncthreads();  // the next tap rewrites src/dst and adds to the same rows
  }

  for (int e = tid; e < TM * TN; e += THREADS) {
    const int n = n0 + e / TN, col = j0 + e % TN;
    if (n < N && col < Cout) out[(size_t)n * Cout + col] = Os[e];
  }
}

template <typename T, int TN>
int launch_tn(const void* table, const int32_t* idx, const uint8_t* found, const void* w,
              float* out, int V, int N, int K, int Cin, int Cout, cudaStream_t stream) {
  dim3 grid((N + TM - 1) / TM, (Cout + TN - 1) / TN);
  gather_gemm_per_tap_kernel<T, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(table), idx, found, static_cast<const T*>(w), out, V, N, K, Cin,
      Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table, const int32_t* idx, const uint8_t* found, const void* w,
           float* out, int V, int N, int K, int Cin, int Cout, cudaStream_t stream) {
  if (Cout <= 16) return launch_tn<T, 16>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
  if (Cout <= 32) return launch_tn<T, 32>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
  return launch_tn<T, 64>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table and w). All tensors contiguous: table (V, Cin), idx (N, K) int32,
// found (N, K) bytes, w (K, Cin, Cout), out (N, Cout) f32. Returns the CUDA
// error of the launch (0 = none).
extern "C" int cpd_gather_gemm_per_tap(const void* table, const void* idx, const void* found,
                                       const void* w, void* out, int V, int N, int K, int Cin,
                                       int Cout, int dtype, void* stream) {
  if (N == 0 || Cout == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f8 = static_cast<const uint8_t*>(found);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table, i32, f8, w, o, V, N, K, Cin, Cout, s);
  if (dtype == 1) return launch<__nv_bfloat16>(table, i32, f8, w, o, V, N, K, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
