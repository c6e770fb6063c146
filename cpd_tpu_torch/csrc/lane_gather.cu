// Kernel G4: the gather from a TRANSPOSED table (C, V) alone, no product,
//
//   out[i, c, q] = tableT[c, idx_flat[i * TILE*K + q]]     out is (N / TILE, C, TILE*K) f32
//
// Replaces the TPU probe scripts/exp_r2i_lane_gather.py:96 (body :90-93),
// which isolates the cost of the lane-axis gather of the probe at :75 (kernel
// G3, csrc/lane_gather_gemm.cu) from its product. Rows past the last whole
// tile are not covered, as in the probe.
//
// What bounds it on an H100: bytes, and nearly all of them are the output:
// N*K*C f32 values (332 MB at the probe's 48,000 x 27 x 64) against 5 MB of
// idx and 12 MB of table, about 0.1 ms at 3.35 TB/s. The design serves the
// writes: a thread owns one gathered position q of a tile, reads its idx once
// into a register and walks the channels, so that for every channel a warp
// writes 32 neighbouring floats (one full line) while its reads scatter over
// the channel's row of the table (12 MB in all, resident in the 50 MB L2).
//
// An idx outside [0, V) is never loaded: its outputs are 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const T* __restrict__ table_t, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int V, int C, int TQ) {
  const int q = blockIdx.y * THREADS + threadIdx.x;
  if (q >= TQ) return;
  const size_t tile = blockIdx.x;
  const int r = idx[tile * TQ + q];
  const bool ok = r >= 0 && r < V;
  float* o = out + tile * C * TQ + q;
  for (int c = 0; c < C; ++c)
    o[(size_t)c * TQ] = ok ? to_float(table_t[(size_t)c * V + r]) : 0.f;
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table_t). All tensors contiguous: table_t (C, V), idx (>= tiles * TQ) int32
// with TQ = TILE * K, out (tiles, C, TQ) f32. Returns the CUDA error of the
// launch (0 = none).
extern "C" int cpd_lane_gather(const void* table_t, const void* idx, void* out, int V, int C,
                               int tiles, int TQ, int dtype, void* stream) {
  if (tiles == 0 || C == 0 || TQ == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid(tiles, (TQ + THREADS - 1) / THREADS);
  if (dtype == 0)
    lane_gather_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(table_t), i32, o, V, C, TQ);
  else if (dtype == 1)
    lane_gather_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table_t), i32, o, V, C, TQ);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
