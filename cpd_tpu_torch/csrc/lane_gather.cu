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
// idx and 12 MB of table, 0.104 ms at 3.35 TB/s.
//
// What the design does:
//   * The (C, V) table is copied once into a row-major (V, C) scratch
//     (lane_common.cuh): a position's C values are then one run of whole
//     16-byte pieces, where in the (C, V) table each is an L2 sector of its
//     own.
//   * A block owns one tile and QB = 128 positions q of it. It reads their
//     idx once, coalesced (an idx outside [0, V) becomes -1 and gives zeros,
//     never an address), then, CB = 64 channels at a time:
//       - reads each position's row from the scratch in 16-byte pieces (8
//         positions x 4 neighbouring pieces a warp) into shared memory,
//         channel-major, (CB, QB) f32. (Holding a thread's 8 loads in
//         registers first took 93 registers a thread, 2 blocks an SM, and
//         was 22% slower at P7 on an H100.)
//       - writes out[tile, c, q0 : q0 + QB] channel by channel, a warp a
//         channel, neighbouring threads on neighbouring q, as 16-byte
//         streaming stores (st.global.cs): the output streams past L2 and
//         does not evict the scratch that the gathers read.
//     Shared memory is swizzled: a value (c, q) sits at c * QB + (q ^ 8 *
//     (piece of c mod 4)). A warp's scalar writes of 8 positions x 4 pieces
//     then hit 32 banks, and a warp's float4 reads of one channel are 32
//     whole pieces. (A row-major [QB][C + pad] tile cannot do both: 4
//     neighbouring q of one channel are 4 rows apart, a 4-way conflict for
//     any pad.)
//   * The output is a copy (bf16 widened to f32 exactly): bit-equal to the
//     plain version.
//   * Rows that are not whole 16-byte pieces (C % 4 != 0 for f32, % 8 for
//     bf16) are read by scalar loads; a ragged run of positions and a tile
//     length TILE*K that is not a multiple of 4 take scalar stores.
#include "lane_common.cuh"

namespace {

constexpr int QB = 128;  // positions a block
constexpr int CB = 64;   // channels staged a pass
constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// elements of T in one 16-byte piece
template <typename T> struct Per { static constexpr int N = 16 / (int)sizeof(T); };

// where shared memory keeps (c, q) of a pass
template <typename T>
__device__ __forceinline__ int at(int c, int q) {
  return c * QB + (q ^ (8 * ((c / Per<T>::N) & 3)));
}

__device__ __forceinline__ void store_cs(float* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void store_cs(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;\n" ::"l"(p), "f"(v) : "memory");
}

// One 16-byte piece of T, widened to f32 (exact), into (c .. c + PER) x q. A
// bf16 is the high half of its f32; the piece's words hold two bf16 each,
// the first in the low half.
__device__ __forceinline__ void put(float* s, int c, int q, uint4 raw, float) {
  s[at<float>(c, q)] = __uint_as_float(raw.x);
  s[at<float>(c + 1, q)] = __uint_as_float(raw.y);
  s[at<float>(c + 2, q)] = __uint_as_float(raw.z);
  s[at<float>(c + 3, q)] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void put(float* s, int c, int q, uint4 raw, __nv_bfloat16) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[at<__nv_bfloat16>(c + 2 * i, q)] = __uint_as_float(words[i] << 16);
    s[at<__nv_bfloat16>(c + 2 * i + 1, q)] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lane_gather_kernel(const T* __restrict__ rows, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int V, int C, int TQ, int vec_in, int vec_out) {
  constexpr int PER = Per<T>::N;
  __shared__ __align__(16) float s[CB * QB];
  __shared__ int src[QB];  // table row per position, -1: none
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t tile = blockIdx.x;
  const int q0 = blockIdx.y * QB, nq = min(QB, TQ - q0);

  // 1. the block's idx, read once
  if (tid < QB) {
    int r = -1;
    if (tid < nq) {
      r = idx[tile * TQ + q0 + tid];
      if (r < 0 || r >= V) r = -1;  // never read outside the table
    }
    src[tid] = r;
  }
  __syncthreads();

  float* o = out + tile * (size_t)C * TQ + q0;
  for (int c0 = 0; c0 < C; c0 += CB) {
    const int cb = min(CB, C - c0);
    // 2. the rows' channels [c0, c0 + cb) into shared memory, channel-major
    if (vec_in) {  // C % PER == 0: 8 positions x 4 neighbouring pieces a warp
      const int pieces = cb / PER, groups = (pieces + 3) / 4;
      for (int e = tid; e < QB / 8 * groups * 32; e += THREADS) {
        const int g = e / 32, l = e % 32;
        const int p = (g % groups) * 4 + l % 4, q = (g / groups) * 8 + l / 4;
        if (p >= pieces) continue;
        const int r = src[q];
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r >= 0)
          raw = __ldg(reinterpret_cast<const uint4*>(rows + (size_t)r * C + c0 + p * PER));
        put(s, p * PER, q, raw, T());
      }
    } else {
      for (int e = tid; e < QB * cb; e += THREADS) {
        const int q = e / cb, c = e - q * cb, r = src[q];
        s[at<T>(c, q)] = r >= 0 ? to_float(rows[(size_t)r * C + c0 + c]) : 0.f;
      }
    }
    __syncthreads();
    // 3. out[tile, c0 + c, q0 : q0 + nq], a warp a channel, 4 positions a thread
    for (int c = warp; c < cb; c += THREADS / 32) {
      const int q = lane * 4;
      float* dst = o + (size_t)(c0 + c) * TQ + q;
      if (vec_out && q + 4 <= nq) {
        store_cs(dst, *reinterpret_cast<const float4*>(&s[at<T>(c, q)]));
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (q + t < nq) store_cs(dst + t, s[at<T>(c, q + t)]);
      }
    }
    __syncthreads();  // the next pass overwrites s
  }
}

template <typename T>
int launch(const void* rows, const int32_t* idx, float* out, int V, int C, int tiles, int TQ,
           cudaStream_t stream) {
  const int vec_in = C % Per<T>::N == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const int vec_out = TQ % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(tiles, (TQ + QB - 1) / QB);
  lane_gather_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(rows), idx, out, V,
                                                      C, TQ, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
//
// The transpose: rows (V, C) = table_t (C, V), both contiguous, of one dtype.
extern "C" int cpd_lane_gather_transpose(const void* table_t, void* rows, int C, int V, int dtype,
                                         void* stream) {
  return cpd::transpose_table(table_t, rows, C, V, dtype, static_cast<cudaStream_t>(stream));
}

// The gather on the transposed table: rows (V, C) the row-major scratch (of
// dtype), idx (>= tiles * TQ) int32 with TQ = TILE * K, out (tiles, C, TQ) f32,
// all contiguous. Returns the CUDA error of the launch (0 = none).
extern "C" int cpd_lane_gather(const void* rows, const void* idx, void* out, int V, int C,
                               int tiles, int TQ, int dtype, void* stream) {
  if (tiles == 0 || C == 0 || TQ == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rows, i32, o, V, C, tiles, TQ, s);
  if (dtype == 1) return launch<__nv_bfloat16>(rows, i32, o, V, C, tiles, TQ, s);
  return (int)cudaErrorInvalidValue;
}
