// The transpose that kernels G3 (lane_gather_gemm.cu) and G4 (lane_gather.cu)
// start with: the TPU probes keep the table transposed, (C, V), because Mosaic
// has a lane shuffle and no row gather. On Hopper that is the worst layout for
// a gather: with random idx every gathered value is a 32-byte L2 sector of its
// own (82.9 M sectors, 2.65 GB, at the probes' 48,000 x 27 x 64 f32), where the
// rows of a row-major table take 332 MB, every sector used. So both kernels
// copy the table once into a row-major (V, C) scratch that the wrapper
// allocates, and gather whole rows from it: 12.3 MB read and 12.3 MB written
// at the probes' size, at least 7 us at 3.35 TB/s. lane_gather.cu exports it
// (cpd_lane_gather_transpose); G3's wrapper launches it from there.
//
// A block copies a tile of TC = min(C, 32) channels x TV table rows through
// shared memory, TC x TV <= 2048 elements (TV = 64 at 32 channels, 384 at 5):
// narrow tables take wide tiles, so that no block moves less than 4 KB of f32
// (or 2 KB of bf16). It reads the tile with neighbouring threads on
// neighbouring v of one channel and writes its output region in order: runs
// of 32 channels of a row, or, where C <= 32, whole rows back to back. Both
// sides are coalesced; the odd row stride of the tile (TV + 1) spreads the
// column reads over the banks. Each thread has its 8 loads in flight before
// it stores. The copy is exact: the elements keep their type.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpd {

constexpr int TRANSPOSE_ELEMS = 2048;   // elements a tile
constexpr int TRANSPOSE_THREADS = 256;  // 8 elements a thread

// (channels, table rows) of a tile at C channels
__host__ __device__ inline int transpose_tc(int C) { return C < 32 ? C : 32; }
__host__ __device__ inline int transpose_tv(int C) {
  return TRANSPOSE_ELEMS / transpose_tc(C) / 32 * 32;
}

template <typename T>
__global__ void __launch_bounds__(TRANSPOSE_THREADS)
transpose_kernel(const T* __restrict__ table_t, T* __restrict__ rows, int C, int V) {
  constexpr int PER_THREAD = TRANSPOSE_ELEMS / TRANSPOSE_THREADS;
  __shared__ T tile[TRANSPOSE_ELEMS + 32];  // TC rows of TV + 1
  const int TC = transpose_tc(C), TV = transpose_tv(C), LD = TV + 1;
  const int v0 = blockIdx.x * TV, c0 = blockIdx.y * TC;
  const int tv = min(TV, V - v0), tc = min(TC, C - c0);
  T got[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * TRANSPOSE_THREADS, c = e / TV, v = e - c * TV;
    if (c < tc && v < tv) got[i] = table_t[(size_t)(c0 + c) * V + v0 + v];
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * TRANSPOSE_THREADS, c = e / TV, v = e - c * TV;
    if (c < tc && v < tv) tile[c * LD + v] = got[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * TRANSPOSE_THREADS, v = e / tc, c = e - v * tc;
    if (v < tv) rows[(size_t)(v0 + v) * C + c0 + c] = tile[c * LD + v];
  }
}

// rows (V, C) = table_t (C, V) transposed, both contiguous, on `stream`.
// dtype codes: 0 = float32, 1 = bfloat16. Returns the CUDA error of the
// launch (0 = none).
inline int transpose_table(const void* table_t, void* rows, int C, int V, int dtype,
                           cudaStream_t stream) {
  if (C == 0 || V == 0) return 0;
  const int tc = transpose_tc(C), tv = transpose_tv(C);
  const dim3 grid((V + tv - 1) / tv, (C + tc - 1) / tc);
  if (dtype == 0)
    transpose_kernel<float><<<grid, TRANSPOSE_THREADS, 0, stream>>>(
        static_cast<const float*>(table_t), static_cast<float*>(rows), C, V);
  else if (dtype == 1)
    transpose_kernel<__nv_bfloat16><<<grid, TRANSPOSE_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table_t), static_cast<__nv_bfloat16*>(rows), C, V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace cpd
