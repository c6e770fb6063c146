// Kernel A2: the weight gradient of a sparse convolution,
//
//   dW[k, c, d] = sum_{b, n} found[b, n, k] ? X[b, idx[b, n, k], c] * dY[b, n, d] : 0
//
// Replaces the TPU kernel cpd_tpu/ops/pallas_conv.py::gather_gemm_dw (the
// pl.pallas_call at :130). That kernel walks a sequential grid and adds every
// row tile's (K*Cin, Cout) product into one output block that stays resident
// in fast memory. Blocks on a GPU run in no order and share nothing, so the
// sum over rows is split in two passes here:
//
//   1. gather_gemm_dw_partial: one block per (chunk of ROWS_PER_CHUNK rows,
//      tap k, TI x TJ tile of dW[k]). It sums its rows in row order into f32
//      registers and writes its tile to partial[chunk, k, :, :] (scratch the
//      wrapper allocates). Every block writes its whole tile, so the scratch
//      needs no clearing.
//   2. gather_gemm_dw_reduce: one thread per element of dW adds the chunks in
//      chunk order.
//
// Both orders are fixed by the shapes alone, so the result is the same bits
// from run to run: no float atomics anywhere (the JAX train step is
// bit-deterministic and the port keeps that).
//
// What bounds it on an H100: the output is tiny (27 x 16 x 16 up to
// 27 x 128 x 128) and the row count large (up to 2 x 90,000), so the least
// work is reading idx/found/X/dY once (10 to 40 MB: about 0.01 ms) and
// 2 * Cin * Cout flops per found tap (less still on tensor cores). This
// first version does its FMAs in f32 on the CUDA cores, and only on found
// taps: a block compacts the rows that FOUND its tap (70-90% of the taps of
// a lidar frame are unfound) with a ballot scan that keeps row order.
// Measured on an H100 80GB HBM3 (700 W) at the training step's shapes
// (batch 2, bf16), a launch takes 0.4 to 1.0 ms whatever the channel count
// (0.70 ms at 16 -> 16 channels, 1.0 ms at 128 -> 128), so the FMAs are
// not where the time goes; the scan is the likely cost (not profiled inside
// the kernel). Every tap's blocks, and every 64 x 64 tile's, read
// the same rows' found bytes K apart (L2 absorbs the re-reads, the strided
// byte loads stay), and at 16 channels a 64 x 64 tile is 1/16 used. One scan
// of found for all taps, a tile sized to Cin x Cout and tensor cores on the
// compacted rows (the contraction is a plain X^T dY per tap) are the next
// steps.
//
// Traps handled as in kernel A1: an unfound tap's idx may be junk and is
// never read; an idx outside the table is dropped; loads are scalar with a
// channel mask (conv_input rows are 5 channels wide); any K (conv_out has 3);
// the last chunk and the last row tile are ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 64;        // dW rows (input channels) per block
constexpr int TJ = 64;        // dW columns (output channels) per block
constexpr int TR = 16;        // compacted rows staged per step
constexpr int THREADS = 256;  // also the rows scanned per compaction pass
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_gemm_dw_partial(const T* __restrict__ table, const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ found, const T* __restrict__ gout,
                       float* __restrict__ partial, int V, int N, int R, int K, int Cin,
                       int Cout, int rows_per_chunk, int tiles_i, int tiles_j) {
  __shared__ float As[TR][TI];    // gathered X rows of the staged hits
  __shared__ float Gs[TR][TJ];    // their dY rows
  __shared__ int src[THREADS];    // table row (b * V + idx) of each hit, in row order
  __shared__ int dyr[THREADS];    // dY row (b * N + n) of each hit
  __shared__ int warp_cnt[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16;  // this thread's dW columns: j0 + tx + 16 * j
  const int ty = tid / 16;  // this thread's dW rows:    i0 + ty + 16 * i
  const int chunk = blockIdx.x;
  const int k = blockIdx.y / (tiles_i * tiles_j);
  const int i0 = (blockIdx.y / tiles_j) % tiles_i * TI;
  const int j0 = blockIdx.y % tiles_j * TJ;
  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(R, row_begin + rows_per_chunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int base = row_begin; base < row_end; base += THREADS) {
    // which of these THREADS rows found tap k: compact them, keeping row order
    const int r = base + tid;
    int hit = 0, s = 0;
    if (r < row_end) {
      const size_t e = (size_t)r * K + k;
      if (found[e]) {
        const int v = idx[e];
        if (v >= 0 && v < V) {  // never read outside the table
          hit = 1;
          s = (r / N) * V + v;
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = warp_cnt[w];
      if (w < warp) offset += c;
      total += c;
    }
    if (hit) {
      const int pos = offset + __popc(ballot & ((1u << lane) - 1u));
      src[pos] = s;
      dyr[pos] = r;
    }
    __syncthreads();

    for (int t0 = 0; t0 < total; t0 += TR) {
      for (int e = tid; e < TR * TI; e += THREADS) {
        const int m = e / TI, c = e % TI;
        float v = 0.f;
        if (t0 + m < total && i0 + c < Cin)
          v = to_float(table[(size_t)src[t0 + m] * Cin + i0 + c]);
        As[m][c] = v;
      }
      for (int e = tid; e < TR * TJ; e += THREADS) {
        const int m = e / TJ, j = e % TJ;
        float v = 0.f;
        if (t0 + m < total && j0 + j < Cout)
          v = to_float(gout[(size_t)dyr[t0 + m] * Cout + j0 + j]);
        Gs[m][j] = v;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < TR; ++m) {
        float a[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[m][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = Gs[m][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
      }
      __syncthreads();  // also orders the next pass's writes to src/dyr/warp_cnt
    }
  }

  float* out = partial + ((size_t)chunk * K + k) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = i0 + ty + 16 * i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = j0 + tx + 16 * j;
      if (co < Cout) out[(size_t)ci * Cout + co] = acc[i][j];
    }
  }
}

__global__ void gather_gemm_dw_reduce(const float* __restrict__ partial,
                                      float* __restrict__ out, int chunks, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += partial[(size_t)c * E + e];  // chunk order
  out[e] = sum;
}

template <typename T>
int launch(const void* table, const int32_t* idx, const uint8_t* found, const void* gout,
           float* partial, float* out, int B, int V, int N, int K, int Cin, int Cout,
           int rows_per_chunk, cudaStream_t stream) {
  const int R = B * N;
  const int chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
  const int tiles_i = (Cin + TI - 1) / TI, tiles_j = (Cout + TJ - 1) / TJ;
  dim3 grid(chunks, K * tiles_i * tiles_j);
  gather_gemm_dw_partial<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(table), idx, found, static_cast<const T*>(gout), partial, V, N, R,
      K, Cin, Cout, rows_per_chunk, tiles_i, tiles_j);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int E = K * Cin * Cout;
  gather_gemm_dw_reduce<<<(E + 255) / 256, 256, 0, stream>>>(partial, out, chunks, E);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table and gout). All tensors contiguous: table (B, V, Cin), idx/found
// (B, N, K), gout (B, N, Cout), partial (ceil(B*N / rows_per_chunk), K, Cin,
// Cout) f32 scratch, out (K*Cin, Cout) f32. Returns the first non-zero
// cudaGetLastError() of the two launches.
extern "C" int cpd_gather_gemm_dw(const void* table, const void* idx, const void* found,
                                  const void* gout, void* partial, void* out, int B, int V,
                                  int N, int K, int Cin, int Cout, int rows_per_chunk,
                                  int dtype, void* stream) {
  if (K == 0 || Cin == 0 || Cout == 0) return 0;
  if (rows_per_chunk <= 0) return (int)cudaErrorInvalidValue;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f8 = static_cast<const uint8_t*>(found);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(table, i32, f8, gout, p, o, B, V, N, K, Cin, Cout, rows_per_chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, i32, f8, gout, p, o, B, V, N, K, Cin, Cout,
                                 rows_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}
