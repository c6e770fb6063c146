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
// The same kernel is the input gradient dX of the conv, launched on other
// operands: table = dY (B, V_out, Cout), idx/found = the TRANSPOSE rulebook
// (B, V_in, K) (for a strided conv the inverse rulebook, idx[u, k] = the
// output row whose tap k reads input row u; for a submanifold conv the
// forward rulebook with its tap columns reversed, as a contiguous copy), and
// w = W^T per tap, laid out (K*Cout, Cin):
//
//   dX[b, u, :] = sum_k t_found[b, u, k] ? dY[b, t_idx[b, u, k], :] @ W[k]^T : 0
//
// What bounds it on an H100. By the roofline, bytes: the rulebook, the table,
// W and the output, each moved once, are 12 to 45 MB a launch (0.003 to 0.013
// ms at 3.35 TB/s), and the found taps' 2 * Cin * Cout operations are less
// than that on the tensor cores except at 128 -> 128 channels. No gather-GEMM
// gets near that bound: 70 to 90% of the taps of a lidar frame are unfound, a
// tile of output rows finds one tap only a few dozen times, and every tap
// needs another W[k], so the work arrives as K small products per tile. What
// this kernel's time is made of is the number of (tile, tap) steps an SM runs
// one after the other, each a barrier, a gather of a few dozen rows, a copy of
// W[k] and a scattered f32 add in shared memory, not the multiplications.
// Measured on an H100 80GB HBM3 (700 W) by chip_smoke.py on the layers of a
// 200k-point frame (bf16, batch 1): 0.024 to 0.15 ms a launch, 1.2 (5 -> 16
// channels) to 44 (64 -> 64) TFLOP/s on found taps, 7 to 25 times the bound;
// the first version (f32 FMAs on every tap, a 64 x 64 tile) took 0.17 to 1.49.
//
// What the design does about it:
//   * One block owns a tile of TM output rows and the whole width of Cout up
//     to 128: every gathered row is read once. The wrapper picks TM
//     (ops/gather_gemm.py::a1_tile_rows): 128, or 64 where 128 does not fit or
//     leaves SMs without a block. 192 and 256 rows win on a rulebook whose
//     rows are all live (24,000 rows as 125 tiles of 192 are one wave of
//     blocks, as 188 tiles of 128 two), but a stage's rulebook is padded to
//     its cap and half of it finds nothing, so on a frame's real rulebooks
//     128 rows are fastest or level on every layer.
//   * The tile's (TM, K) slab of idx and found is read once, neighbouring
//     threads on neighbouring words, and all K per-tap hit lists (table row,
//     tile row; row order) are built up front, one warp per tap with ballot +
//     popcount: no barrier per tap, no strided rulebook reads. An unfound
//     tap's idx is never used as an address; an idx outside [0, V) is dropped.
//   * Only found taps are multiplied. bf16 operands go to the tensor cores:
//     mma.sync.m16n8k16 (bf16 -> f32) over 16-row fragments of the hit list
//     (a list of 12 pads to 16, of 40 to 48), A by ldmatrix from the staged
//     rows, B by ldmatrix.trans from the staged W[k], which a warp keeps in
//     registers across the tap's row fragments. f32 operands keep exact f32
//     FMAs on the CUDA cores over the same compacted lists.
//   * Staging is double-buffered: tap k+1's rows and W[k+1] arrive by
//     cp.async (16 bytes a thread, zero-filled past Cin, Cout and the list's
//     end) while tap k multiplies; one barrier a step. Deeper rings (3 and 4
//     buffers) were measured slower: their shared memory costs resident
//     blocks, and other blocks on the SM hide a step's latency better. Rows
//     are padded by 16 bytes so that ldmatrix meets no bank conflict.
//     Operands that are not whole 16-byte pieces (5-channel rows) take scalar
//     loads into the same buffers. Cin above the staged depth (64 for bf16,
//     32 for f32) runs as several steps per tap.
//   * The (TM, Cout) f32 accumulator lives in dynamic shared memory. Within
//     a step every element has one writer (a row finds a tap once; a warp
//     owns 16 columns of a row fragment), steps are separated by the barrier,
//     so taps add in tap order with no atomics: the same bits on every launch
//     and for every TM.
//   * Epilogue: rounded once to the output type, 16-byte stores, ragged last
//     tile masked.
//
// Any K (taps are scanned 32 at a time), any Cin, any Cout (column tiles of
// 128 above that). A launch that the card refuses (too much shared memory)
// comes back as the returned CUDA error.
#include "gather_common.cuh"

namespace {

using namespace cpd;

struct Layout {
  int src, cnt, dst, acc, stage, a_bytes, w_bytes, total;
};

// Shared memory of one block: hit lists for G taps over TM rows, the f32
// accumulator (rows padded by 8 floats), STAGES stage buffers (the gathered rows
// of a tap, TM x KC, and W[k], KC x NT, rows padded by 16 bytes). The scan's
// slab reuses the stage buffers.
template <typename T, int KC, int NT>
__host__ __device__ inline Layout layout(int TM, int G) {
  constexpr int PER = Piece<T>::N;
  Layout L;
  int off = 0;
  L.src = off, off += G * TM * 4;
  L.cnt = off, off += MAX_TAPS * 4;
  L.dst = off, off += round_up(G * TM * 2, 16);
  L.acc = off, off += TM * (NT + 8) * 4;
  L.stage = off;
  L.a_bytes = TM * (KC + PER) * (int)sizeof(T);
  L.w_bytes = KC * (NT + PER) * (int)sizeof(T);
  L.total = off + STAGES * (L.a_bytes + L.w_bytes);
  return L;
}

struct Args {
  const void* table;
  const int32_t* idx;
  const uint8_t* found;
  const void* w;
  void* out;
  int V, N, K, Cin, Cout, TM;
  int out_bf16;  // output type: 0 = f32, 1 = bf16
  int vec_a, vec_w, vec_o;  // 16-byte pieces allowed for table rows, W rows, output rows
};

// One step's product on the tensor cores: hit rows [0, n) of As (n padded to
// 16 with zero rows) times Ws, added into acc at the rows dst[].
template <int KC, int NT>
__device__ __forceinline__ void multiply(const __nv_bfloat16* As, const __nv_bfloat16* Ws,
                                         const uint16_t* dst, int n, float* acc) {
  constexpr int LDA = KC + 8, LDW = NT + 8, LDC = NT + 8;
  constexpr int WARPS_N = NT / 16, WARPS_M = WARPS / WARPS_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp % WARPS_N, wm = warp / WARPS_N;
  const int frags = (n + 15) / 16;
  if (wm >= frags) return;
  uint32_t b[KC / 16][4];  // this warp's 16 columns of W[k]: two 8-wide MMA tiles
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks)
    ldmatrix_x4_trans(b[ks], Ws + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW +
                                 wn * 16 + (lane >> 4) * 8);
  for (int m = wm; m < frags; m += WARPS_M) {
    float c[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, As + (m * 16 + (lane & 15)) * LDA + ks * 16 + (lane >> 4) * 8);
      mma_bf16(c[0], a, b[ks][0], b[ks][1]);
      mma_bf16(c[1], a, b[ks][2], b[ks][3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the fragment's rows lane / 4 and lane / 4 + 8
      const int j = m * 16 + (lane >> 2) + h * 8;
      if (j >= n) continue;
      float* o = acc + dst[j] * LDC + wn * 16 + (lane & 3) * 2;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float2 v = *reinterpret_cast<float2*>(o + t * 8);
        v.x += c[t][h * 2], v.y += c[t][h * 2 + 1];
        *reinterpret_cast<float2*>(o + t * 8) = v;
      }
    }
  }
}

// The same step in exact f32 on the CUDA cores: a thread multiplies 4 hit
// rows by 4 columns, channels in order.
template <int KC, int NT>
__device__ __forceinline__ void multiply(const float* As, const float* Ws, const uint16_t* dst,
                                         int n, float* acc) {
  constexpr int LDA = KC + 4, LDW = NT + 4, LDC = NT + 8, Q = NT / 4;
  const int items = (n + 3) / 4 * Q;
  for (int e = threadIdx.x; e < items; e += THREADS) {
    const int j0 = e / Q * 4, q = e % Q;
    const float* a = As + j0 * LDA;
    const float* wp = Ws + q * 4;
    float s[4][4] = {};
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      const float4 wv = *reinterpret_cast<const float4*>(wp + c * LDW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = a[i * LDA + c];
        s[i][0] = fmaf(av, wv.x, s[i][0]);
        s[i][1] = fmaf(av, wv.y, s[i][1]);
        s[i][2] = fmaf(av, wv.z, s[i][2]);
        s[i][3] = fmaf(av, wv.w, s[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j0 + i >= n) continue;
      float4* o = reinterpret_cast<float4*>(acc + dst[j0 + i] * LDC + q * 4);
      float4 v = *o;
      v.x += s[i][0], v.y += s[i][1], v.z += s[i][2], v.w += s[i][3];
      *o = v;
    }
  }
}

template <typename T, int KC, int NT>
__global__ void __launch_bounds__(THREADS, 2) gather_gemm_kernel(const Args p) {
  constexpr int PER = Piece<T>::N;
  constexpr int LDA = KC + PER, LDW = NT + PER, LDC = NT + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TM = p.TM, K = p.K, Cin = p.Cin, Cout = p.Cout;
  constexpr int NS = STAGES;
  const Layout L = layout<T, KC, NT>(TM, min(K, MAX_TAPS));
  int* src = reinterpret_cast<int*>(smem + L.src);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  uint16_t* dst = reinterpret_cast<uint16_t*>(smem + L.dst);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  unsigned char* stage = smem + L.stage;
  const int stage_bytes = L.a_bytes + L.w_bytes;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * TM;
  const int j0 = blockIdx.y * NT;
  const int rows = min(TM, p.N - n0);
  const size_t row0 = (size_t)b * p.N + n0;
  const T* tab = static_cast<const T*>(p.table) + (size_t)b * p.V * Cin;
  const T* w = static_cast<const T*>(p.w);
  const int chunks = (Cin + KC - 1) / KC;

  for (int e = tid; e < TM * LDC; e += THREADS) acc[e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MAX_TAPS) {
    const int G = min(MAX_TAPS, K - k0);
    const int sub = min(TM, NS * stage_bytes / (G * 5) / 32 * 32);
    scan_rulebook(p.idx, p.found, row0, rows, K, k0, G, p.V, sub, TM, stage, src, dst, cnt,
                  [](int) { return 0; });

    // step s = (tap g, channel chunk): stage its gathered rows and its W slice
    const int steps = G * chunks;
    auto fetch = [&](int s, int buf) {
      const int g = s / chunks, c0 = (s % chunks) * KC;
      const int n = s < steps ? cnt[g] : 0;
      T* As = reinterpret_cast<T*>(stage + buf * stage_bytes);
      T* Ws = reinterpret_cast<T*>(stage + buf * stage_bytes + L.a_bytes);
      const int n16 = round_up(n, 16);
      for (int e = tid; e < n16 * (KC / PER); e += THREADS) {
        const int j = e / (KC / PER), c = c0 + e % (KC / PER) * PER;
        const int valid = j < n ? min(PER, Cin - c) : 0;
        const T* from = valid > 0 ? tab + (size_t)src[g * TM + j] * Cin + c : tab;
        stage_piece(As + j * LDA + (c - c0), from, valid, p.vec_a);
      }
      for (int e = tid; n > 0 && e < KC * (NT / PER); e += THREADS) {
        const int c = c0 + e / (NT / PER), col = e % (NT / PER) * PER;
        const int valid = c < Cin ? min(PER, Cout - j0 - col) : 0;
        const T* from = valid > 0 ? w + ((size_t)(k0 + g) * Cin + c) * Cout + j0 + col : w;
        stage_piece(Ws + (c - c0) * LDW + col, from, valid, p.vec_w);
      }
      cp_async_commit();  // one group a step, empty or not: the waits count groups
    };

    for (int s = 0; s < NS - 1; ++s) fetch(s, s);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait();
      __syncthreads();  // step s has landed; everyone is done with step s - 1
      fetch(s + NS - 1, (s + NS - 1) % NS);  // into the buffer that step s - 1 read
      const int g = s / chunks;
      const int n = cnt[g];
      if (n == 0) continue;
      const T* As = reinterpret_cast<const T*>(stage + s % NS * stage_bytes);
      const T* Ws = reinterpret_cast<const T*>(stage + s % NS * stage_bytes + L.a_bytes);
      multiply<KC, NT>(As, Ws, dst + g * TM, n, acc);
    }
    __syncthreads();  // the next scan reuses the stage buffers and the lists
  }

  // epilogue: round once, 16 bytes a thread where the output rows allow it
  if (p.out_bf16) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    if (p.vec_o) {
      for (int e = tid; e < rows * (NT / 8); e += THREADS) {
        const int r = e / (NT / 8), col = e % (NT / 8) * 8;
        if (j0 + col >= Cout) continue;  // Cout is a multiple of 8 here
        const float4 lo = *reinterpret_cast<const float4*>(acc + r * LDC + col);
        const float4 hi = *reinterpret_cast<const float4*>(acc + r * LDC + col + 4);
        __align__(16) __nv_bfloat162 v[4] = {
            __floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
            __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
        *reinterpret_cast<uint4*>(out + (row0 + r) * Cout + j0 + col) =
            *reinterpret_cast<const uint4*>(v);
      }
    } else {
      for (int e = tid; e < rows * NT; e += THREADS) {
        const int r = e / NT, col = e % NT;
        if (j0 + col < Cout)
          out[(row0 + r) * Cout + j0 + col] = __float2bfloat16(acc[r * LDC + col]);
      }
    }
  } else {
    float* out = static_cast<float*>(p.out);
    if (p.vec_o) {
      for (int e = tid; e < rows * (NT / 4); e += THREADS) {
        const int r = e / (NT / 4), col = e % (NT / 4) * 4;
        if (j0 + col >= Cout) continue;  // Cout is a multiple of 4 here
        *reinterpret_cast<float4*>(out + (row0 + r) * Cout + j0 + col) =
            *reinterpret_cast<const float4*>(acc + r * LDC + col);
      }
    } else {
      for (int e = tid; e < rows * NT; e += THREADS) {
        const int r = e / NT, col = e % NT;
        if (j0 + col < Cout) out[(row0 + r) * Cout + j0 + col] = acc[r * LDC + col];
      }
    }
  }
}

template <typename T, int KC, int NT>
int launch(const Args& p, int B, cudaStream_t stream, int* smem_only) {
  const Layout L = layout<T, KC, NT>(p.TM, p.K < MAX_TAPS ? p.K : MAX_TAPS);
  if (smem_only) {
    *smem_only = L.total;
    return 0;
  }
  auto kernel = gather_gemm_kernel<T, KC, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit this refusal
    return (int)err;
  }
  dim3 grid((p.N + p.TM - 1) / p.TM, (p.Cout + NT - 1) / NT, B);
  kernel<<<grid, THREADS, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int launch_nt(const Args& p, int B, cudaStream_t stream, int* smem_only) {
  if (p.Cout <= 16) return launch<T, KC, 16>(p, B, stream, smem_only);
  if (p.Cout <= 32) return launch<T, KC, 32>(p, B, stream, smem_only);
  if (p.Cout <= 64) return launch<T, KC, 64>(p, B, stream, smem_only);
  return launch<T, KC, 128>(p, B, stream, smem_only);
}

// the staged depth: Cin rounded up to 16, at most 64 for bf16 and 32 for f32
int dispatch(const Args& p, int B, int in_dtype, cudaStream_t stream, int* smem_only) {
  if (in_dtype == 1) {
    if (p.Cin <= 16) return launch_nt<__nv_bfloat16, 16>(p, B, stream, smem_only);
    if (p.Cin <= 32) return launch_nt<__nv_bfloat16, 32>(p, B, stream, smem_only);
    return launch_nt<__nv_bfloat16, 64>(p, B, stream, smem_only);
  }
  if (in_dtype == 0) {
    if (p.Cin <= 16) return launch_nt<float, 16>(p, B, stream, smem_only);
    return launch_nt<float, 32>(p, B, stream, smem_only);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C entry points for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
// All tensors contiguous: table (B, V, Cin), idx/found (B, N, K), w (K*Cin,
// Cout), out (B, N, Cout). tile_rows: output rows per block, a multiple of 64.
// Returns the first CUDA error of the launch (0 = none).
extern "C" int cpd_gather_gemm(const void* table, const void* idx, const void* found,
                               const void* w, void* out, int B, int V, int N, int K,
                               int Cin, int Cout, int in_dtype, int out_dtype, int tile_rows,
                               void* stream) {
  if (B == 0 || N == 0 || Cout == 0) return 0;
  if (tile_rows <= 0 || tile_rows % 64 != 0 || tile_rows > 65536 || out_dtype < 0 ||
      out_dtype > 1 || in_dtype < 0 || in_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int per = in_dtype == 1 ? 8 : 4, per_out = out_dtype == 1 ? 8 : 4;
  Args p;
  p.table = table, p.idx = static_cast<const int32_t*>(idx);
  p.found = static_cast<const uint8_t*>(found), p.w = w, p.out = out;
  p.V = V, p.N = N, p.K = K, p.Cin = Cin, p.Cout = Cout, p.TM = tile_rows;
  p.out_bf16 = out_dtype;
  p.vec_a = Cin % per == 0 && aligned16(table);
  p.vec_w = Cout % per == 0 && aligned16(w);
  p.vec_o = Cout % per_out == 0 && aligned16(out);
  return dispatch(p, B, in_dtype, static_cast<cudaStream_t>(stream), nullptr);
}

// The dynamic shared memory, in bytes, that a launch with these sizes asks for.
extern "C" int cpd_gather_gemm_smem(int K, int Cin, int Cout, int in_dtype, int tile_rows) {
  Args p = {};
  p.K = K, p.Cin = Cin, p.Cout = Cout, p.TM = tile_rows;
  int bytes = 0;
  return dispatch(p, 1, in_dtype, nullptr, &bytes) == 0 ? bytes : -1;
}
