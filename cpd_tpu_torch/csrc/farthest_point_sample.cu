// Kernel F1: farthest point sampling, the keypoint sampler of the PFE
// (VoxelSetAbstraction).
//
//   sel[b, 0] = first valid point (0 when there is none)
//   sel[b, s] = argmax over the points of min_{t < s} |p - p[sel[b, t]]|
//
// It stands in for no Pallas kernel. It replaces a JAX op chain
// (cpd_tpu/ops/pool.py::farthest_point_sample: a lax.fori_loop of
// num_samples steps, each a norm, a minimum and an argmax over all points).
// Its semantics are that loop's, exactly:
//   * the seed is argmax(valid), the first valid point;
//   * a padded point holds -inf as its distance, so it is never chosen while a
//     valid point exists; with no valid point every index is 0;
//   * a tie goes to the lower index (argmax takes the first maximum); with
//     fewer valid points than samples the loop keeps picking the first valid
//     point at distance 0, as JAX's does;
//   * the distance is sqrt(fma(dz, dz, fma(dy, dy, dx*dx))) in f32, spelled
//     out with __fmul_rn / __fmaf_rn / __fsqrt_rn: what jnp.linalg.norm of
//     three coordinates computes on XLA:CPU, which contracts the sum of
//     squares into fused multiply-adds (checked bit for bit by
//     tests/test_torch_port_pfe.py).
//
// Design (the pointnet2 sampling.cu layout): one block a sample, the whole
// batch in one launch. The coordinates come in structure-of-arrays
// (B, 3, N) and the running minimum distance lives in a device buffer (B, N)
// that the kernel initialises (+inf valid, -inf padded). Each of the
// num_samples - 1 steps: every thread folds the distance to the last chosen
// point into its points' minima and keeps its own (max, lowest index); a
// warp-shuffle reduction and one across the warps in shared memory give the
// block's argmax, which thread 0 writes out. No host sync inside the loop.
//
// What bounds it on an H100: latency, not the card's rates. A step reads and
// writes 20 bytes a point (x, y, z, the minimum read, the minimum written),
// from L2 once a frame's 4 MB is resident, through one SM a sample: the
// other SMs idle when the batch is small. Two block barriers a step.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (value, index) argmax with ties to the lower index
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ float dist(float x, float y, float z, float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy), dz = __fsub_rn(z, cz);
  return __fsqrt_rn(__fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx))));
}

__global__ void __launch_bounds__(kThreads)
farthest_point_sample_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
                             float* __restrict__ mind, int N, int S, int32_t* __restrict__ sel) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int chosen;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* px = xyz + static_cast<int64_t>(b) * 3 * N;
  const float* py = px + N;
  const float* pz = py + N;
  const uint8_t* ok = valid + static_cast<int64_t>(b) * N;
  float* md = mind + static_cast<int64_t>(b) * N;
  int32_t* out = sel + static_cast<int64_t>(b) * S;

  // the seed: the first valid point (argmax of the mask), 0 when none
  int first = N;
  for (int i = tid; i < N; i += kThreads) {
    const bool v = ok[i] != 0;
    md[i] = v ? CUDART_INF_F : -CUDART_INF_F;
    if (v && i < first) first = i;
  }
  for (int o = 16; o > 0; o >>= 1) first = min(first, __shfl_down_sync(0xffffffffu, first, o));
  if (lane == 0) warp_i[warp] = first;
  __syncthreads();
  if (tid == 0) {
    int f = N;
    for (int w = 0; w < kWarps; ++w) f = min(f, warp_i[w]);
    chosen = f == N ? 0 : f;
    out[0] = chosen;
  }
  __syncthreads();

  for (int s = 1; s < S; ++s) {
    const int c = chosen;
    const float cx = px[c], cy = py[c], cz = pz[c];
    float best_v = -CUDART_INF_F;
    int best_i = N;
    for (int i = tid; i < N; i += kThreads) {
      const float d = fminf(md[i], dist(px[i], py[i], pz[i], cx, cy, cz));
      md[i] = d;
      better(best_v, best_i, d, i);
    }
    for (int o = 16; o > 0; o >>= 1)
      better(best_v, best_i, __shfl_down_sync(0xffffffffu, best_v, o),
             __shfl_down_sync(0xffffffffu, best_i, o));
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();  // every thread has read ``chosen`` and written its warp's pair
    if (warp == 0) {
      float v = warp_v[lane];
      int i = warp_i[lane];
      for (int o = 16; o > 0; o >>= 1)
        better(v, i, __shfl_down_sync(0xffffffffu, v, o), __shfl_down_sync(0xffffffffu, i, o));
      if (lane == 0) {
        chosen = i;
        out[s] = i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// xyz (B, 3, N) f32 structure-of-arrays, valid (B, N) uint8, mind (B, N) f32
// scratch, sel (B, S) int32 out. Returns the CUDA error of the launch.
extern "C" int cpd_farthest_point_sample(const void* xyz, const void* valid, void* mind, int B,
                                         int N, int S, void* sel, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (B < 0 || N <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  farthest_point_sample_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const uint8_t*>(valid),
      static_cast<float*>(mind), N, S, static_cast<int32_t*>(sel));
  return (int)cudaGetLastError();
}
