// Device helpers shared by kernels A1 (gather_gemm.cu), A2
// (gather_gemm_dw.cu), G1 (gather_gemm_flat.cu) and G2
// (gather_gemm_per_tap.cu): asynchronous 16-byte copies into shared memory,
// ldmatrix / mma.sync wrappers for bf16 tensor-core products, and the
// rulebook scan that A1 and A2 run once per block.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cpd {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// what a block may ask for on sm_90 (227 KB of the SM's 256 KB)
constexpr int MAX_SMEM = 232448;
// taps one scan_rulebook call compacts (a warp keeps a count for every 8th)
constexpr int MAX_TAPS = 32;
// stage buffers a block rings through: step s + 1 loads while step s multiplies.
// 3 and 4 were measured slower on an H100 on every layer shape (the shared
// memory they take costs resident blocks, and other blocks hide latency better)
constexpr int STAGES = 2;

// elements of T in one 16-byte piece (the unit of cp.async and of the row pads)
template <typename T> struct Piece { static constexpr int N = 16 / (int)sizeof(T); };

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without passing through registers; src_bytes = 0
// reads nothing and fills the 16 bytes with zeros. The _at forms take a shared
// address that the caller computed once (smem_addr).
__device__ __forceinline__ void cp_async16_at(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  cp_async16_at(smem_addr(dst), src, src_bytes);
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until all but the newest STAGES - 2 of this thread's copy groups have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// One row's piece of PER = Piece<T>::N elements, src[0..valid) kept and the
// rest zero, into shared memory: one cp.async where `vec` says the source is
// whole and 16-byte aligned, scalar loads otherwise (5-channel rows).
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* src, int valid, bool vec) {
  constexpr int PER = Piece<T>::N;
  if (vec) {
    cp_async16(dst, src, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[i] = i < valid ? src[i] : T(0.f);
  }
}

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_at(r, smem_addr(p));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  ldmatrix_x4_trans_at(r, smem_addr(p));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rulebook scan. Rows [row0, row0 + rows) of the (R, K) rulebook, taps
// [k0, k0 + G), G <= MAX_TAPS: the block reads the slab in sub-tiles of `sub`
// rows, each read once with neighbouring threads on neighbouring words (whole rows when
// G == K), into `slab` (sub * G ints then sub * G bytes); then warp g % WARPS
// compacts tap k0 + g with ballot + popcount, in row order, appending (table
// row, local row) to src/dst[g * cap ...]. No block barrier per tap: two per
// sub-tile. An unfound tap's idx is never used as an address, an idx outside
// [0, V) is dropped. `row_base(r)` is added to idx (the batch offset of A2).
// Ends with a barrier: cnt[g] and the lists are visible, `slab` is free.
template <typename RowBase>
__device__ __forceinline__ void scan_rulebook(const int32_t* __restrict__ idx,
                                              const uint8_t* __restrict__ found, size_t row0,
                                              int rows, int K, int k0, int G, int V, int sub,
                                              int cap, unsigned char* slab, int* src,
                                              uint16_t* dst, int* cnt, RowBase row_base) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* s_idx = reinterpret_cast<int*>(slab);
  uint8_t* s_found = slab + (size_t)sub * G * 4;
  int run[MAX_TAPS / WARPS] = {};  // this warp's running counts of taps warp, warp + 8, ...
  for (int r0 = 0; r0 < rows; r0 += sub) {
    const int nr = min(sub, rows - r0);
    for (int e = tid; e < nr * G; e += THREADS) {
      const int r = e / G, g = e - r * G;
      const size_t at = (row0 + r0 + r) * K + k0 + g;
      s_idx[e] = idx[at];
      s_found[e] = found[at];
    }
    __syncthreads();
#pragma unroll
    for (int slot = 0; slot < MAX_TAPS / WARPS; ++slot) {
      const int g = warp + slot * WARPS;
      if (g >= G) continue;  // uniform over the warp
      int c = run[slot];
      for (int q = 0; q < nr; q += 32) {
        const int r = q + lane;
        int hit = 0, v = 0;
        if (r < nr && s_found[r * G + g]) {
          v = s_idx[r * G + g];
          hit = v >= 0 && v < V;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (hit) {
          const int pos = g * cap + c + __popc(ballot & ((1u << lane) - 1u));
          src[pos] = v + row_base(r0 + r);
          dst[pos] = (uint16_t)(r0 + r);
        }
        c += __popc(ballot);
      }
      run[slot] = c;
    }
    __syncthreads();
  }
#pragma unroll
  for (int slot = 0; slot < MAX_TAPS / WARPS; ++slot) {
    const int g = warp + slot * WARPS;
    if (g < G && lane == 0) cnt[g] = run[slot];
  }
  __syncthreads();
}

}  // namespace cpd
