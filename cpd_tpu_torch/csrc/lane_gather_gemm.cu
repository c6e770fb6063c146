// Kernel G3: the gather-GEMM over a TRANSPOSED table (C, V),
//
//   out[n, :] = concat_k(tableT[:, idx[n, k]]) @ W        (W is (K*C, Cout))
//
// Replaces the TPU probe scripts/exp_r2i_lane_gather.py:75 (body :68-73).
// The TPU has no row gather but a lane shuffle, so the probe kept the table
// transposed (channels on sublanes, voxels on lanes), gathered
// g[c, q] = tableT[c, idx_flat[q]] along the lane axis, reordered to
// (TILE, K*C) and ran one product. Same output as kernel G1
// (csrc/gather_gemm_flat.cu) on the table's transpose; the probe has no
// ``found`` (every idx is read), and ``found`` may be given so that the kernel
// can run beside kernel A1 on a conv's rulebook.
//
// What bounds it on an H100: bytes (idx, table, W read once and the f32
// output written once). What this layout costs: a row of a row-major table
// with 64 bf16 channels is ONE 128-byte line, while the same 64 values of a
// (C, V) table lie V elements apart, one line each, so the gather touches up
// to C times as many lines. The design is the probe's formulation as it is:
// for a fixed channel, the threads of a warp read the addresses that their
// rows' idx name (neighbouring threads are neighbouring rows of the tile, so
// the scattered loads of a warp are in flight together), staging one tap and
// TK channels at a time, channel-major, for f32 FMAs on the CUDA cores with a
// column tile sized to Cout. It is kept to be measured against the row
// gather, not to win.
//
// Traps: an unfound tap's idx may be junk and is never read; an idx outside
// [0, V) is dropped, never loaded; any C and K; the last tile is ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // output rows per block
constexpr int TK = 16;   // channels staged per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int TN>
__global__ void __launch_bounds__(THREADS)
lane_gather_gemm_kernel(const T* __restrict__ table_t, const int32_t* __restrict__ idx,
                        const uint8_t* __restrict__ found, const T* __restrict__ w,
                        float* __restrict__ out, int V, int N, int K, int C, int Cout) {
  constexpr int TXN = TN / 4;         // threads along the columns
  constexpr int TYN = THREADS / TXN;  // threads along the rows
  constexpr int RM = TM / TYN;        // rows per thread
  __shared__ float As[TK][TM + 1];    // gathered values, channel-major
  __shared__ float Bs[TK][TN];        // W chunk of this tap
  __shared__ int rows[TM];            // table column per tile row for this tap, -1 = none

  const int tid = threadIdx.x;
  const int tx = tid % TXN;  // this thread's columns: j0 + tx + TXN * j
  const int ty = tid / TXN;  // this thread's rows:    n0 + ty + TYN * i
  const int n0 = blockIdx.x * TM;
  const int j0 = blockIdx.y * TN;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (tid < TM) {
      const int n = n0 + tid;
      int r = -1;
      if (n < N) {
        const size_t g = (size_t)n * K + k;
        if (found == nullptr || found[g]) {
          r = idx[g];
          if (r < 0 || r >= V) r = -1;  // never read outside the table
        }
      }
      rows[tid] = r;
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += TK) {
      // lane gather: a fixed channel, neighbouring threads on neighbouring rows
      for (int e = tid; e < TK * TM; e += THREADS) {
        const int c = e / TM, m = e % TM;
        const int r = rows[m];
        float v = 0.f;
        if (r >= 0 && c0 + c < C) v = to_float(table_t[(size_t)(c0 + c) * V + r]);
        As[c][m] = v;
      }
      for (int e = tid; e < TK * TN; e += THREADS) {
        const int c = e / TN, j = e % TN;
        float v = 0.f;
        if (c0 + c < C && j0 + j < Cout)
          v = to_float(w[((size_t)k * C + c0 + c) * Cout + j0 + j]);
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
      __syncthreads();  // also orders the next tap's write to rows
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int n = n0 + ty + TYN * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j0 + tx + TXN * j;
      if (col < Cout) out[(size_t)n * Cout + col] = acc[i][j];
    }
  }
}

template <typename T, int TN>
int launch_tn(const void* table_t, const int32_t* idx, const uint8_t* found, const void* w,
              float* out, int V, int N, int K, int C, int Cout, cudaStream_t stream) {
  dim3 grid((N + TM - 1) / TM, (Cout + TN - 1) / TN);
  lane_gather_gemm_kernel<T, TN><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(table_t), idx, found, static_cast<const T*>(w), out, V, N, K, C,
      Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* table_t, const int32_t* idx, const uint8_t* found, const void* w,
           float* out, int V, int N, int K, int C, int Cout, cudaStream_t stream) {
  if (Cout <= 16) return launch_tn<T, 16>(table_t, idx, found, w, out, V, N, K, C, Cout, stream);
  if (Cout <= 32) return launch_tn<T, 32>(table_t, idx, found, w, out, V, N, K, C, Cout, stream);
  return launch_tn<T, 64>(table_t, idx, found, w, out, V, N, K, C, Cout, stream);
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table_t and w). All tensors contiguous: table_t (C, V), idx (N, K) int32,
// found (N, K) bytes or NULL (every tap found), w (K*C, Cout), out (N, Cout)
// f32. Returns the CUDA error of the launch (0 = none).
extern "C" int cpd_lane_gather_gemm(const void* table_t, const void* idx, const void* found,
                                    const void* w, void* out, int V, int N, int K, int C,
                                    int Cout, int dtype, void* stream) {
  if (N == 0 || Cout == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f8 = static_cast<const uint8_t*>(found);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(table_t, i32, f8, w, o, V, N, K, C, Cout, s);
  if (dtype == 1) return launch<__nv_bfloat16>(table_t, i32, f8, w, o, V, N, K, C, Cout, s);
  return (int)cudaErrorInvalidValue;
}
