// Kernel G1: the flat-operand gather-GEMM,
//
//   out[n, :] = concat_k(found[n, k] ? table[idx[n, k], :] : 0) @ W      (W is (K*Cin, Cout))
//
// One kernel for four TPU probes that spell the same function with four
// different jnp gathers (fancy indexing, jnp.take, broadcast
// take_along_axis(axis=0), and the same without ``found``):
//   scripts/exp_pallas_gather.py:82   (body :68-78, f32 operands rounded to bf16 in the kernel)
//   scripts/exp_gather_variants.py:107 (body :99-105, bf16 operands)
//   scripts/exp_r2_lowering.py:213    (body :203-210, bf16 operands)
//   scripts/exp_r2h_gather2.py:99     (bodies :118 and :123, f32 operands, no found)
// Each probe asked whether Mosaic lowers that spelling; on Hopper every one
// of them is a load by computed address, so they share this kernel, launched
// at each probe's own shapes, types and ``found`` setting.
//
// What bounds it on an H100: bytes. Read once, idx + found + table + W and the
// f32 output are a few tens of MB (0.01 ms at 3.35 TB/s), and the found taps'
// 2 * Cin * Cout operations are less still on the tensor cores. The gathered
// operand is N * K * Cin elements, 10 to 30 times the table, so what the
// design must keep out of device memory is the im2col itself.
//
// Design, and how it differs from kernel A1 (csrc/gather_gemm.cu), which
// stages one tap and 16 channels per step: a block first gathers its tile's
// WHOLE flattened operand (TM rows x K*Cin columns) into shared memory, whole
// table rows at a time with 16-byte loads where Cin * element size allows
// (scalar loads otherwise: 5-channel rows are not 16-byte aligned), and then
// runs one product against the matching slab of W. Where the operand does not
// fit (64 rows x 27 taps x 128 bf16 channels is 442 KB against 227 KB a
// block) the reduction runs in chunks of KC flattened columns, each gathered
// whole before its product. The operand is staged in the type the product
// reads it in: bf16 for bf16 operands and for f32 operands that the probe
// rounds to bf16 in the kernel (which halves the footprint), f32 otherwise.
// The column tile is sized to Cout (16, 32 or 64 wide), so no lane multiplies
// masked columns at 16 or 32 channels. Products are f32 FMAs on the CUDA
// cores, accumulated in f32 registers in column order; the output is f32.
// Tensor cores (the staged operand is already the A tile of an MMA), TMA and
// cp.async are later work.
//
// Traps: an unfound tap's idx may be junk and is never read; an idx outside
// [0, V) is dropped, never loaded; any K (3 for conv_out) and any Cin; the
// last row tile and the last chunk are ragged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per block
constexpr int TK = 32;        // flattened columns per W slab step
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB: the most a block may ask for

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S> __device__ __forceinline__ S staged(float v);
template <> __device__ __forceinline__ float staged<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 staged<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

// T: element type in device memory; S: type of the staged operand (S = bf16
// with T = float rounds the operands to bf16 in the kernel); TN: column tile.
template <typename T, typename S, int TN>
__global__ void __launch_bounds__(THREADS)
gather_gemm_flat_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                        const uint8_t* __restrict__ found, const T* __restrict__ w,
                        float* __restrict__ out, int V, int N, int K, int Cin, int Cout,
                        int KC, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int TXN = TN / 4;            // threads along the columns
  constexpr int TYN = THREADS / TXN;     // threads along the rows
  constexpr int RM = TM / TYN;           // rows per thread
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem);           // (TM, K) table row or -1
  float* Bs = reinterpret_cast<float*>(rows + TM * K);  // (TK, TN) slab of W
  S* As = reinterpret_cast<S*>(Bs + TK * TN);           // (TM, stride) gathered operand
  const int stride = KC + 16 / (int)sizeof(S);  // 4 words of padding: rows fall in other banks

  const int tid = threadIdx.x;
  const int tx = tid % TXN;  // this thread's columns: j0 + tx + TXN * j
  const int ty = tid / TXN;  // this thread's rows:    n0 + ty + TYN * i
  const int n0 = blockIdx.x * TM;
  const int j0 = blockIdx.y * TN;
  const int Q = K * Cin;

  for (int e = tid; e < TM * K; e += THREADS) {
    const int n = n0 + e / K;
    int r = -1;
    if (n < N) {
      const size_t g = (size_t)n * K + e % K;
      if (found == nullptr || found[g]) {
        r = idx[g];
        if (r < 0 || r >= V) r = -1;  // never read outside the table
      }
    }
    rows[e] = r;
  }
  __syncthreads();

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += KC) {
    const int kc = min(KC, Q - q0);
    const int kc_pad = (kc + TK - 1) / TK * TK;  // <= KC: KC is a multiple of TK
    // 1. gather the tile's whole operand for columns [q0, q0 + kc_pad)
    if (vec_ok) {
      // Cin % VEC == 0: a 16-byte vector never straddles a tap or the end
      const int nv = kc_pad / VEC;
      for (int e = tid; e < TM * nv; e += THREADS) {
        const int m = e / nv, q = q0 + (e % nv) * VEC;
        S* dst = As + m * stride + (q - q0);
        int r = -1;
        if (q < Q) r = rows[m * K + q / Cin];
        if (r >= 0) {
          const uint4 raw = *reinterpret_cast<const uint4*>(table + (size_t)r * Cin + q % Cin);
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i) dst[i] = staged<S>(to_float(v[i]));
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) dst[i] = staged<S>(0.f);
        }
      }
    } else {
      for (int e = tid; e < TM * kc_pad; e += THREADS) {
        const int m = e / kc_pad, q = q0 + e % kc_pad;
        float v = 0.f;
        if (q < Q) {
          const int r = rows[m * K + q / Cin];
          if (r >= 0) v = to_float(table[(size_t)r * Cin + q % Cin]);
        }
        As[m * stride + (q - q0)] = staged<S>(v);
      }
    }
    __syncthreads();
    // 2. one product of the staged operand with rows [q0, q0 + kc) of W
    for (int c0 = 0; c0 < kc_pad; c0 += TK) {
      for (int e = tid; e < TK * TN; e += THREADS) {
        const int q = q0 + c0 + e / TN, j = j0 + e % TN;
        float v = 0.f;
        if (q < Q && j < Cout) v = to_float(staged<S>(to_float(w[(size_t)q * Cout + j])));
        Bs[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        float a[RM], bb[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = to_float(As[(ty + TYN * i) * stride + c0 + c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = Bs[c * TN + tx + TXN * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();  // also orders the next chunk's gather after these reads
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

template <typename T, typename S, int TN>
int launch_tn(const void* table, const int32_t* idx, const uint8_t* found, const void* w,
              float* out, int V, int N, int K, int Cin, int Cout, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int Q = K * Cin;
  // chunk of the flattened reduction: about 80 KB of staged operand, so that
  // two blocks fit on an SM
  const int max_cols = sizeof(S) == 2 ? 640 : 320;
  const int q_pad = (Q + 63) / 64 * 64;
  const int KC = q_pad < max_cols ? q_pad : max_cols;
  const int stride = KC + 16 / (int)sizeof(S);
  const size_t smem = (size_t)TM * K * sizeof(int) + (size_t)TK * TN * sizeof(float) +
                      (size_t)TM * stride * sizeof(S);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = gather_gemm_flat_kernel<T, S, TN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_ok = (Cin % VEC == 0) && (reinterpret_cast<uintptr_t>(table) % 16 == 0);
  dim3 grid((N + TM - 1) / TM, (Cout + TN - 1) / TN);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(table), idx, found,
                                          static_cast<const T*>(w), out, V, N, K, Cin, Cout,
                                          KC, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* table, const int32_t* idx, const uint8_t* found, const void* w,
           float* out, int V, int N, int K, int Cin, int Cout, cudaStream_t stream) {
  if (Cout <= 16) return launch_tn<T, S, 16>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
  if (Cout <= 32) return launch_tn<T, S, 32>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
  return launch_tn<T, S, 64>(table, idx, found, w, out, V, N, K, Cin, Cout, stream);
}

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table and w); round_bf16 != 0 with float32 operands rounds both to bf16 in
// the kernel. All tensors contiguous: table (V, Cin), idx (N, K) int32, found
// (N, K) bytes or NULL (every tap found), w (K*Cin, Cout), out (N, Cout) f32.
// Returns the CUDA error of the launch (0 = none).
extern "C" int cpd_gather_gemm_flat(const void* table, const void* idx, const void* found,
                                    const void* w, void* out, int V, int N, int K, int Cin,
                                    int Cout, int dtype, int round_bf16, void* stream) {
  if (N == 0 || Cout == 0) return 0;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* f8 = static_cast<const uint8_t*>(found);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !round_bf16)
    return launch<float, float>(table, i32, f8, w, o, V, N, K, Cin, Cout, s);
  if (dtype == 0)
    return launch<float, __nv_bfloat16>(table, i32, f8, w, o, V, N, K, Cin, Cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(table, i32, f8, w, o, V, N, K, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
