// Kernel A1: fused masked im2col gather + GEMM, the forward of every sparse
// convolution of the VoxelResBackBone8x backbone.
//
//   out[b, n, :] = sum_k found[b, n, k] ? table[b, idx[b, n, k], :] @ W[k] : 0
//
// Replaces the TPU kernel cpd_tpu/ops/pallas_conv.py::gather_gemm (the
// pl.pallas_call at :77), which Mosaic could not lower because it gathers
// rows in-kernel. On Hopper a thread loads a row by computed address, so the
// design becomes the live conv here.
//
// What bounds it on an H100: the gathered-row bytes. Each of the K taps
// re-reads a Cin-wide input row, so one conv reads N*K*Cin elements of the
// table for only N*K*Cin*Cout*2 flops (Cout = 16..128): far below the ~295
// flop/byte needed to be compute-bound. The design keeps the (N, K*Cin)
// im2col out of device memory entirely: the gathered rows of a tile of
// output rows are staged in shared memory one tap and one channel chunk at
// a time and consumed there by all the tile's output columns, so each
// gathered element is read from L2/HBM once per Cout tile (once in all for
// Cout <= 64) instead of being written out and read back as an im2col.
// Measured on an H100 80GB HBM3 (700 W), this first version is bound by its
// own arithmetic instead: it runs every tap's FMAs, found or not (70-90% of
// the taps are unfound on a lidar frame), on the CUDA cores, and with
// Cout = 16 or 32 most of a 64-wide column tile is masked. Tensor cores,
// skipping empty taps and a column tile sized to Cout are the next steps.
//
// The same kernel is the input gradient dX of the conv, launched on other
// operands: table = dY (B, V_out, Cout), idx/found = the TRANSPOSE rulebook
// (B, V_in, K) (for a strided conv the inverse rulebook, idx[u, k] = the
// output row whose tap k reads input row u; for a submanifold conv the
// forward rulebook with its tap columns reversed, as a contiguous copy), and
// w = W^T per tap, laid out (K*Cout, Cin):
//
//   dX[b, u, :] = sum_k t_found[b, u, k] ? dY[b, t_idx[b, u, k], :] @ W[k]^T : 0
//
// Design (right and simple first): one block per (tile of TM output rows,
// tile of TN output channels, batch). A loop over the K taps and over Cin in
// chunks of TK stages the gathered rows (zero where found is false: the
// kernel never reads table[idx] for an unfound tap, whose idx may be junk)
// and the W[k] slice in shared memory as float, then 256 threads each
// accumulate a 4x4 block of outputs in f32 registers. The result is rounded
// once to the output type. Operands are f32 or bf16 (templated), output f32
// or bf16. Scalar loads handle any Cin (Cin = 5 rows are not 16-byte
// aligned) and any K (conv_out has K = 3); rows past N and columns past
// Cout are masked. Tensor-core MMA (mma.sync / wgmma), cp.async pipelining
// and split-K come in later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TN = 64;   // output channels per block
constexpr int TK = 16;   // input channels staged per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O> __device__ __forceinline__ O from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
gather_gemm_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ found, const T* __restrict__ w,
                   O* __restrict__ out, int V, int N, int K, int Cin, int Cout) {
  __shared__ float As[TK][TM + 1];  // gathered rows, channel-major
  __shared__ float Bs[TK][TN];      // W[k] chunk
  __shared__ int rows[TM];          // input row per tile row for this tap, -1 = none

  const int b = blockIdx.z;
  const int n0 = blockIdx.x * TM;
  const int j0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // this thread's columns: j0 + tx + 16 * j
  const int ty = tid / 16;  // this thread's rows:    n0 + ty + 16 * i
  const T* tab = table + (size_t)b * V * Cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (tid < TM) {
      const int n = n0 + tid;
      int r = -1;
      if (n < N) {
        const size_t e = ((size_t)b * N + n) * K + k;
        if (found[e]) {
          r = idx[e];
          if (r < 0 || r >= V) r = -1;  // never read outside the table
        }
      }
      rows[tid] = r;
    }
    __syncthreads();
    for (int c0 = 0; c0 < Cin; c0 += TK) {
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int m = e / TK, c = e % TK;
        const int r = rows[m];
        float v = 0.f;
        if (r >= 0 && c0 + c < Cin) v = to_float(tab[(size_t)r * Cin + c0 + c]);
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
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col < Cout) out[((size_t)b * N + n) * Cout + col] = from_float<O>(acc[i][j]);
    }
  }
}

template <typename T, typename O>
void launch(const void* table, const int32_t* idx, const uint8_t* found, const void* w,
            void* out, int B, int V, int N, int K, int Cin, int Cout, cudaStream_t stream) {
  dim3 grid((N + TM - 1) / TM, (Cout + TN - 1) / TN, B);
  gather_gemm_kernel<T, O><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(table), idx, found, static_cast<const T*>(w),
      static_cast<O*>(out), V, N, K, Cin, Cout);
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
// All tensors contiguous: table (B, V, Cin), idx/found (B, N, K), w (K*Cin,
// Cout), out (B, N, Cout). Returns the cudaGetLastError() of the launch.
extern "C" int cpd_gather_gemm(const void* table, const void* idx, const void* found,
                               const void* w, void* out, int B, int V, int N, int K,
                               int Cin, int Cout, int in_dtype, int out_dtype,
                               void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f8 = static_cast<const uint8_t*>(found);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(table, i32, f8, w, out, B, V, N, K, Cin, Cout, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(table, i32, f8, w, out, B, V, N, K, Cin, Cout, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(table, i32, f8, w, out, B, V, N, K, Cin, Cout, s);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(table, i32, f8, w, out, B, V, N, K, Cin, Cout, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
