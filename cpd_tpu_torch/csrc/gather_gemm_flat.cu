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
// at each probe's own shapes, types and ``found`` setting. It is also kernel
// A1's function (csrc/gather_gemm.cu) at batch 1, written flat: one dense
// product over the flattened K*Cin reduction instead of one step per tap.
//
// What bounds it on an H100. The bytes it must move are the (N, K) idx and
// found (5 bytes a tap: 12 MB at 90,000 x 27), the table rows of the found
// taps, W and the f32 output; at the layer shapes of a lidar frame that is
// 0.005 to 0.008 ms at 3.35 TB/s. The flat product multiplies every tap, found
// or not: at found shares of 0.10 to 0.31 that is 3 to 10 times the
// multiplications of the found taps, 21.2 GFLOP at 24,000 x 27 x 128 -> 128
// (0.02 ms at 989 TFLOP/s of bf16, more at the rate mma.sync reaches). So
// the narrow layers are bound by the rulebook's bytes and the wide ones by
// the multiplications now done on zeros; per-tap work (A1's design) is gone.
//
// What the design does:
//   * One block owns TM output rows (128, or 64 where 128 would leave SMs
//     without a block: ops/gather_probes.py::g1_tile_rows) and the whole Cout
//     up to 128 (column tiles of 16, 32, 64 or 128; tiles of 128 above that).
//   * The tile's (TM, K) slab of idx and found is read once, neighbouring
//     threads on neighbouring words, into shared memory as a table row or -1.
//     An unfound tap's idx is never used as an address; an idx outside
//     [0, V) is dropped. A tile where no row finds a tap (a stage's rulebook
//     is padded to its cap and 33-48% of its rows find nothing) writes zeros
//     and returns: no gather, no product.
//   * The flattened reduction runs in steps of KC columns (64 bf16: four
//     m16n8k16 depths; 32 f32), double-buffered: step s + 1 is staged while
//     step s multiplies, one barrier a step. A gathered row goes by cp.async
//     in 16-byte pieces, and a piece whose tap is unfound or dropped goes with
//     src_bytes = 0: the hardware fills zeros and reads nothing. The W slab of
//     the same columns goes by cp.async beside it. Rows are padded by 16 bytes
//     so that ldmatrix meets no bank conflict.
//   * Rows that are not whole 16-byte pieces (Cin = 5, the first layer) are
//     staged densely with scalar loads: 135 flattened columns padded to 144,
//     not each tap padded to 16. K = 3 and a ragged last tile and step are
//     masked.
//   * Types, each its own instance: bf16 operands go to the tensor cores,
//     mma.sync.m16n8k16 bf16 -> f32, A by ldmatrix and B by ldmatrix.trans,
//     the accumulator in registers; f32 operands rounded to bf16 (P1) are
//     rounded while staging (through registers) and take the same path; f32
//     operands otherwise take exact f32 FMAs on the CUDA cores over the same
//     staged tiles (no TF32).
//   * Each output element sums its columns in one fixed order, no atomics:
//     a second launch gives the same bits. The f32 output is written once.
//
// Any K (up to 256: the slab must fit), any Cin, any Cout. A launch that the
// card refuses comes back as the returned CUDA error.
#include <type_traits>

#include "gather_common.cuh"

namespace {

using namespace cpd;

// flattened columns staged per step, by the staged type S
template <typename S> struct Depth { static constexpr int KC = sizeof(S) == 2 ? 64 : 32; };

struct Args {
  const void* table;
  const int32_t* idx;
  const uint8_t* found;  // nullptr: every tap found
  const void* w;
  float* out;
  int V, N, K, Cin, Cout;
  int vec_a, vec_w;  // 16-byte staged pieces allowed for table rows, W rows
  int even_out;      // Cout even: pairs of f32 outputs are 8-byte stores
};

struct Layout {
  int stage, a_bytes, w_bytes, total;
};

// Shared memory of one block: the (TM, K) slab as table rows, then STAGES
// stage buffers (TM x KC gathered columns, KC x NT of W; rows padded by 16
// bytes).
template <typename S, int NT>
__host__ __device__ inline Layout layout(int TM, int K) {
  constexpr int KC = Depth<S>::KC, PER = Piece<S>::N;
  Layout L;
  L.stage = round_up(TM * K * 4, 16);
  L.a_bytes = TM * (KC + PER) * (int)sizeof(S);
  L.w_bytes = KC * (NT + PER) * (int)sizeof(S);
  L.total = L.stage + STAGES * (L.a_bytes + L.w_bytes);
  return L;
}

template <typename S> __device__ __forceinline__ S staged(float v);
template <> __device__ __forceinline__ float staged<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 staged<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}
template <typename S> __device__ __forceinline__ S staged(__nv_bfloat16 v) { return v; }

// One 16-byte piece of S (Piece<S>::N elements) from src where ok, else
// zeros: cp.async where the operand is already of the staged type; through
// registers, rounding 8 floats to bf16, where it is not.
template <typename T, typename S>
__device__ __forceinline__ void put_piece(S* dst, const T* src, bool ok) {
  if constexpr (std::is_same<T, S>::value) {
    cp_async16(dst, src, ok ? 16 : 0);
  } else {
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (ok) {
      lo = __ldg(reinterpret_cast<const float4*>(src));
      hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
    }
    __align__(16) __nv_bfloat162 v[4] = {
        __floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
        __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// How the tensor-core path splits a TM x NT tile over the block's warps: WN
// warps across the columns (each a multiple of 16 columns), WM down the rows,
// MI 16-row and NJ 8-column MMA fragments a warp. At TM = 64, NT = 16 only
// four warps multiply.
template <int TM, int NT> struct Warps {
  static constexpr int WN = NT >= 32 ? 2 : 1;
  static constexpr int WM = WARPS / WN;
  static constexpr int MI = TM / 16 >= WM ? TM / 16 / WM : 1;
  static constexpr int NJ = NT / 8 / WN;
};

// How the f32 path splits it: TXN threads across the columns, 4 adjacent
// columns each; TYN down the rows, RM rows each (ty + TYN * i).
template <int TM, int NT> struct Fma {
  static constexpr int TXN = NT / 4;
  static constexpr int TYN = THREADS / TXN;
  static constexpr int RM = TM / TYN;
};

template <typename S, int TM, int NT> struct Acc;
template <int TM, int NT> struct Acc<__nv_bfloat16, TM, NT> {
  float c[Warps<TM, NT>::MI][Warps<TM, NT>::NJ][4];
};
template <int TM, int NT> struct Acc<float, TM, NT> {
  float c[Fma<TM, NT>::RM][4];
};

// One step on the tensor cores: the staged kc columns (a multiple of 16) of
// As (TM x KC) times Ws (KC x NT), added into the warp's fragments.
template <int TM, int NT>
__device__ __forceinline__ void multiply(const __nv_bfloat16* As, const __nv_bfloat16* Ws, int kc,
                                         Acc<__nv_bfloat16, TM, NT>& acc) {
  using W = Warps<TM, NT>;
  constexpr int KC = Depth<__nv_bfloat16>::KC, LDA = KC + 8, LDW = NT + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % W::WN, wm = warp / W::WN;
  if (wm * W::MI * 16 >= TM) return;  // a warp with no rows (TM = 64, NT = 16)
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    if (ks * 16 >= kc) break;
    uint32_t a[W::MI][4];
#pragma unroll
    for (int mi = 0; mi < W::MI; ++mi)
      ldmatrix_x4(a[mi], As + ((wm * W::MI + mi) * 16 + (lane & 15)) * LDA + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < W::NJ / 2; ++nb) {
      uint32_t b[4];  // 16 columns: two 8-wide MMA tiles
      ldmatrix_x4_trans(b, Ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW +
                               (wn * W::NJ / 2 + nb) * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi) {
        mma_bf16(acc.c[mi][2 * nb], a[mi], b[0], b[1]);
        mma_bf16(acc.c[mi][2 * nb + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The same step in exact f32 on the CUDA cores, columns in order.
template <int TM, int NT>
__device__ __forceinline__ void multiply(const float* As, const float* Ws, int kc,
                                         Acc<float, TM, NT>& acc) {
  using F = Fma<TM, NT>;
  constexpr int KC = Depth<float>::KC, LDA = KC + 4, LDW = NT + 4;
  const int tx = threadIdx.x % F::TXN, ty = threadIdx.x / F::TXN;
#pragma unroll 8
  for (int c = 0; c < kc; ++c) {
    const float4 wv = *reinterpret_cast<const float4*>(Ws + c * LDW + tx * 4);
#pragma unroll
    for (int i = 0; i < F::RM; ++i) {
      const float av = As[(ty + F::TYN * i) * LDA + c];
      acc.c[i][0] = fmaf(av, wv.x, acc.c[i][0]);
      acc.c[i][1] = fmaf(av, wv.y, acc.c[i][1]);
      acc.c[i][2] = fmaf(av, wv.z, acc.c[i][2]);
      acc.c[i][3] = fmaf(av, wv.w, acc.c[i][3]);
    }
  }
}

__device__ __forceinline__ void store(const Args& p, int n, int col, float v) {
  if (n < p.N && col < p.Cout) p.out[(size_t)n * p.Cout + col] = v;
}

template <int TM, int NT>
__device__ __forceinline__ void epilogue(const Args& p, int n0, int j0,
                                         const Acc<__nv_bfloat16, TM, NT>& acc) {
  using W = Warps<TM, NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % W::WN, wm = warp / W::WN;
  if (wm * W::MI * 16 >= TM) return;
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < W::NJ; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the fragment's rows lane / 4 and lane / 4 + 8
        const int n = n0 + (wm * W::MI + mi) * 16 + (lane >> 2) + h * 8;
        const int col = j0 + (wn * W::NJ + nj) * 8 + (lane & 3) * 2;
        const float x = acc.c[mi][nj][h * 2], y = acc.c[mi][nj][h * 2 + 1];
        if (p.even_out && n < p.N && col < p.Cout) {
          *reinterpret_cast<float2*>(p.out + (size_t)n * p.Cout + col) = make_float2(x, y);
        } else {
          store(p, n, col, x);
          store(p, n, col + 1, y);
        }
      }
}

template <int TM, int NT>
__device__ __forceinline__ void epilogue(const Args& p, int n0, int j0,
                                         const Acc<float, TM, NT>& acc) {
  using F = Fma<TM, NT>;
  const int tx = threadIdx.x % F::TXN, ty = threadIdx.x / F::TXN;
#pragma unroll
  for (int i = 0; i < F::RM; ++i) {
    const int n = n0 + ty + F::TYN * i, col = j0 + tx * 4;
#pragma unroll
    for (int t = 0; t < 4; ++t) store(p, n, col + t, acc.c[i][t]);
  }
}

// T: element type in device memory; S: the staged type (bf16 with T = float
// rounds the operands in the kernel); TM x NT: the output tile.
template <typename T, typename S, int TM, int NT>
__global__ void __launch_bounds__(THREADS, 2) gather_gemm_flat_kernel(const Args p) {
  constexpr int KC = Depth<S>::KC, PER = Piece<S>::N;
  constexpr int LDA = KC + PER, LDW = NT + PER;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, Cin = p.Cin, Cout = p.Cout, Q = K * Cin;
  const Layout L = layout<S, NT>(TM, K);
  int* rows = reinterpret_cast<int*>(smem);
  unsigned char* stage = smem + L.stage;
  const int stage_bytes = L.a_bytes + L.w_bytes;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TM, j0 = blockIdx.y * NT;
  const int nrows = min(TM, p.N - n0);
  const T* tab = static_cast<const T*>(p.table);
  const T* w = static_cast<const T*>(p.w);

  // 1. the tile's rulebook slab, read once: a table row or -1 per (row, tap)
  const size_t base = (size_t)n0 * K;
  int live = 0;
  for (int e = tid; e < TM * K; e += THREADS) {
    int r = -1;
    if (e < nrows * K && (p.found == nullptr || p.found[base + e])) {
      const int v = p.idx[base + e];
      if (v >= 0 && v < p.V) r = v;
    }
    rows[e] = r;
    live |= r >= 0;
  }
  if (!__syncthreads_or(live)) {  // no row of the tile finds a tap: zeros, nothing else
    for (int e = tid; e < nrows * NT; e += THREADS) store(p, n0 + e / NT, j0 + e % NT, 0.f);
    return;
  }

  // 2. the flattened reduction, KC columns a step (the last one ragged, cut
  // to a multiple of 16), step s + 1 staged while step s multiplies
  const int Qp = round_up(Q, 16);
  const int steps = (Qp + KC - 1) / KC;
  auto fetch = [&](int s, int buf) {
    if (s < steps) {
      const int q0 = s * KC, kc = min(KC, Qp - q0);
      S* As = reinterpret_cast<S*>(stage + buf * stage_bytes);
      S* Ws = reinterpret_cast<S*>(stage + buf * stage_bytes + L.a_bytes);
      if (p.vec_a) {  // Cin % PER == 0: a piece lies inside one tap, whole or past Q
        const int per_row = kc / PER;
        for (int e = tid; e < TM * per_row; e += THREADS) {
          const int m = e / per_row, q = q0 + (e - m * per_row) * PER;
          int r = -1, tap = 0;
          if (q < Q) {
            tap = q / Cin;
            r = rows[m * K + tap];
          }
          put_piece<T, S>(As + m * LDA + (q - q0),
                          r >= 0 ? tab + (size_t)r * Cin + (q - tap * Cin) : tab, r >= 0);
        }
      } else {  // dense scalar staging of the flattened columns
        for (int e = tid; e < TM * kc; e += THREADS) {
          const int m = e / kc, q = q0 + (e - m * kc);
          S v = staged<S>(0.f);
          if (q < Q) {
            const int tap = q / Cin, r = rows[m * K + tap];
            if (r >= 0) v = staged<S>(tab[(size_t)r * Cin + (q - tap * Cin)]);
          }
          As[m * LDA + (q - q0)] = v;
        }
      }
      if (p.vec_w) {  // Cout % PER == 0: a piece is whole or past Cout
        for (int e = tid; e < kc * (NT / PER); e += THREADS) {
          const int c = e / (NT / PER), col = (e % (NT / PER)) * PER;
          const bool ok = q0 + c < Q && j0 + col < Cout;
          put_piece<T, S>(Ws + c * LDW + col, ok ? w + (size_t)(q0 + c) * Cout + j0 + col : w,
                          ok);
        }
      } else {
        for (int e = tid; e < kc * NT; e += THREADS) {
          const int c = e / NT, col = e % NT;
          S v = staged<S>(0.f);
          if (q0 + c < Q && j0 + col < Cout) v = staged<S>(w[(size_t)(q0 + c) * Cout + j0 + col]);
          Ws[c * LDW + col] = v;
        }
      }
    }
    cp_async_commit();  // one group a step, empty or not: the waits count groups
  };

  Acc<S, TM, NT> acc{};  // zeros
  fetch(0, 0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait();
    __syncthreads();  // step s has landed; everyone is done with step s - 1
    fetch(s + 1, (s + 1) % STAGES);  // into the buffer that step s - 1 read
    const S* As = reinterpret_cast<const S*>(stage + s % STAGES * stage_bytes);
    const S* Ws = reinterpret_cast<const S*>(stage + s % STAGES * stage_bytes + L.a_bytes);
    multiply<TM, NT>(As, Ws, min(KC, Qp - s * KC), acc);
  }
  epilogue<TM, NT>(p, n0, j0, acc);
}

template <typename T, typename S, int TM, int NT>
int launch(const Args& p, cudaStream_t stream, int* smem_only) {
  const Layout L = layout<S, NT>(TM, p.K);
  if (smem_only) {
    *smem_only = L.total;
    return 0;
  }
  auto kernel = gather_gemm_flat_kernel<T, S, TM, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit this refusal
    return (int)err;
  }
  dim3 grid((p.N + TM - 1) / TM, (p.Cout + NT - 1) / NT);
  kernel<<<grid, THREADS, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename S, int TM>
int launch_nt(const Args& p, cudaStream_t stream, int* smem_only) {
  if (p.Cout <= 16) return launch<T, S, TM, 16>(p, stream, smem_only);
  if (p.Cout <= 32) return launch<T, S, TM, 32>(p, stream, smem_only);
  if (p.Cout <= 64) return launch<T, S, TM, 64>(p, stream, smem_only);
  return launch<T, S, TM, 128>(p, stream, smem_only);
}

template <typename T, typename S>
int launch_tm(const Args& p, int tile_rows, cudaStream_t stream, int* smem_only) {
  if (tile_rows == 128) return launch_nt<T, S, 128>(p, stream, smem_only);
  if (tile_rows == 64) return launch_nt<T, S, 64>(p, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

// dtype 1: bf16 operands; dtype 0 with round_bf16: f32 rounded to bf16 while
// staging; dtype 0: exact f32
int dispatch(const Args& p, int dtype, int round_bf16, int tile_rows, cudaStream_t stream,
             int* smem_only) {
  if (dtype == 1 && !round_bf16)
    return launch_tm<__nv_bfloat16, __nv_bfloat16>(p, tile_rows, stream, smem_only);
  if (dtype == 0 && round_bf16)
    return launch_tm<float, __nv_bfloat16>(p, tile_rows, stream, smem_only);
  if (dtype == 0) return launch_tm<float, float>(p, tile_rows, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table and w); round_bf16 != 0 with float32 operands rounds both to bf16 in
// the kernel. All tensors contiguous: table (V, Cin), idx (N, K) int32, found
// (N, K) bytes or NULL (every tap found), w (K*Cin, Cout), out (N, Cout) f32.
// tile_rows: output rows per block, 64 or 128. Returns the CUDA error of the
// launch (0 = none).
extern "C" int cpd_gather_gemm_flat(const void* table, const void* idx, const void* found,
                                    const void* w, void* out, int V, int N, int K, int Cin,
                                    int Cout, int dtype, int round_bf16, int tile_rows,
                                    void* stream) {
  if (N == 0 || Cout == 0) return 0;
  const int per = dtype == 1 || round_bf16 ? 8 : 4;  // elements of a staged 16-byte piece
  Args p;
  p.table = table, p.idx = static_cast<const int32_t*>(idx);
  p.found = static_cast<const uint8_t*>(found), p.w = w, p.out = static_cast<float*>(out);
  p.V = V, p.N = N, p.K = K, p.Cin = Cin, p.Cout = Cout;
  p.vec_a = Cin % per == 0 && aligned16(table);
  p.vec_w = Cout % per == 0 && aligned16(w);
  p.even_out = Cout % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return dispatch(p, dtype, round_bf16, tile_rows, static_cast<cudaStream_t>(stream), nullptr);
}

// The dynamic shared memory, in bytes, that a launch with these sizes asks
// for (-1 for sizes no instance takes).
extern "C" int cpd_gather_gemm_flat_smem(int K, int Cout, int dtype, int round_bf16,
                                         int tile_rows) {
  Args p = {};
  p.K = K, p.Cout = Cout;
  int bytes = 0;
  return dispatch(p, dtype, round_bf16, tile_rows, nullptr, &bytes) == 0 ? bytes : -1;
}
