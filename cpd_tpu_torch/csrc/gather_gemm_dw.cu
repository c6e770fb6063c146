// Kernel A2: the weight gradient of a sparse convolution,
//
//   dW[k, c, d] = sum_{b, n} found[b, n, k] ? X[b, idx[b, n, k], c] * dY[b, n, d] : 0
//
// Replaces the TPU kernel cpd_tpu/ops/pallas_conv.py::gather_gemm_dw (the
// pl.pallas_call at :130). That kernel walks a sequential grid and adds every
// row tile's (K*Cin, Cout) product into one output block that stays resident
// in fast memory. Blocks on a GPU run in no order and share nothing, so the
// sum over rows is split in two passes here:
//
//   1. gather_gemm_dw_partial: one block per (chunk of rows, group of taps).
//      It sums its rows in row order, a tap at a time, and writes each tap's
//      (Cin, Cout) tile to partial[chunk, k, :, :] (scratch the wrapper
//      allocates). Every block writes all its tiles, so the scratch needs no
//      clearing.
//   2. gather_gemm_dw_reduce: one thread per element of dW adds the chunks in
//      chunk order.
//
// Both orders are fixed by the shapes alone, so the result is the same bits
// from run to run: no float atomics anywhere (the JAX train step is
// bit-deterministic and the port keeps that).
//
// What bounds it on an H100. By the roofline, bytes: the output is tiny
// (27 x 16 x 16 up to 27 x 128 x 128) and the row count large (up to
// 2 x 90,000), so the least work is reading idx/found/X/dY once (10 to 40 MB:
// about 0.01 ms) with the found taps' 2 * Cin * Cout operations below that
// on the tensor cores. In practice the cost is finding the 10 to 30% of the
// rows that found a tap and bringing their X and dY rows together, and the
// scratch that the two-pass sum moves. Measured on an H100 80GB HBM3 (700 W)
// by chip_smoke.py on the layers of a training step (batch 2, bf16): 0.06 to
// 0.25 ms a launch, 1.6 (5 -> 16 channels) to 48 (128 -> 128) TFLOP/s on
// found taps, 8 to 21 times the bound; the first version (one block per tap
// rescanning found, a 64 x 64 tile of f32 FMAs) took 0.41 to 1.00.
//
// What the design does about it:
//   * A block reads its chunk's slab of idx and found ONCE for all its taps,
//     neighbouring threads on neighbouring words, and builds every tap's hit
//     list (table row, dY row; row order) up front, one warp per tap with
//     ballot + popcount (gather_common.cuh::scan_rulebook). The grid is not
//     multiplied by K for the scan: a block owns G taps (3 of 27, measured
//     fastest on every layer shape; 1 at 128 x 128 channels) over a chunk of
//     rows, G * chunk rows being what the lists' shared memory holds (at most
//     4096 entries); the wrapper picks both (ops/gather_gemm.py::a2_plan) so
//     that the scratch (chunks x K x Cin x Cout floats) stays under 48 MB.
//   * Per tap the contraction is X_hits^T @ dY_hits over the hit list, 64 or
//     128 hits a step (the list's end padded to 16 with zero rows), both
//     operands staged by cp.async into double-buffered shared memory while the
//     step before multiplies (deeper rings measured slower, as for A1). bf16
//     operands run on the tensor cores: mma.sync.m16n8k16 (bf16 -> f32), both
//     operands through ldmatrix.trans
//     (the hit is the reduction index and the staged rows are hit-major).
//     f32 operands keep exact f32 FMAs on the CUDA cores.
//   * The tile is sized to Cin x Cout (16 x 16 up to 128 x 128, template
//     instances) and lives in registers for the whole tap: 64 floats a thread
//     at the largest.
//
// Traps handled as in kernel A1: an unfound tap's idx may be junk and is
// never used as an address; an idx outside the table is dropped; rows that
// are not whole 16-byte pieces (conv_input rows are 5 channels wide) take
// scalar loads; any K (conv_out has 3); Cin or Cout above 128 run as several
// tiles; the last chunk is ragged.
#include "gather_common.cuh"

namespace {

using namespace cpd;

struct Layout {
  int src, cnt, begin, dst, stage, x_bytes, g_bytes, total;
};

// Shared memory of one block: hit lists of G taps over `cap` rows, the step
// table, STAGES stage buffers (X rows HP x CI and dY rows HP x CO, rows padded
// by 16 bytes). The scan's slab reuses the stage buffers.
template <typename T, int CI, int CO>
__host__ __device__ inline Layout layout(int cap, int G, int HP) {
  constexpr int PER = Piece<T>::N;
  Layout L;
  int off = 0;
  L.src = off, off += G * cap * 4;
  L.cnt = off, off += MAX_TAPS * 4;
  L.begin = off, off += (MAX_TAPS + 4) * 4;
  L.dst = off, off += round_up(G * cap * 2, 16);
  L.stage = off;
  L.x_bytes = HP * (CI + PER) * (int)sizeof(T);
  L.g_bytes = HP * (CO + PER) * (int)sizeof(T);
  L.total = off + STAGES * (L.x_bytes + L.g_bytes);
  return L;
}

// hits multiplied per step
template <typename T, int CI, int CO>
__host__ __device__ constexpr int hits_per_step() {
  return (CI + CO > 128 ? 64 : 128) * (int)sizeof(__nv_bfloat16) / (int)sizeof(T);
}

struct Args {
  const void* table;
  const int32_t* idx;
  const uint8_t* found;
  const void* gout;
  float* partial;
  int V, N, R, K, Cin, Cout;
  int chunk_rows, taps;  // rows and taps one block owns
  int vec_x, vec_g;      // 16-byte pieces allowed for table rows, dY rows
};

// A block's (CI, CO) tile of one tap's dW in registers.
template <typename T, int CI, int CO> struct Tile;

// bf16: warp w owns UPW 16 x 16 units of the tile, all in one 16-row band.
template <int CI, int CO> struct Tile<__nv_bfloat16, CI, CO> {
  static constexpr int NP = CO / 16, UNITS = CI / 16 * NP;
  static constexpr int UPW = UNITS >= WARPS ? UNITS / WARPS : 1;
  static constexpr int LDX = CI + 8, LDG = CO + 8;
  float c[UPW][2][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < UPW; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) c[i][t][v] = 0.f;
  }

  // += Xs[0..nh)^T @ Gs[0..nh); rows nh..round_up(nh, 16) are zero
  __device__ __forceinline__ void multiply(const __nv_bfloat16* Xs, const __nv_bfloat16* Gs,
                                           int nh) {
    const int lane = threadIdx.x & 31, u0 = (threadIdx.x >> 5) * UPW;
    if (u0 >= UNITS) return;
    const int mt = u0 / NP, np0 = u0 % NP;
    for (int h0 = 0; h0 < nh; h0 += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, Xs + (h0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDX + mt * 16 +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Gs + (h0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDG +
                                 (np0 + i) * 16 + (lane >> 4) * 8);
        mma_bf16(c[i][0], a, b[0], b[1]);
        mma_bf16(c[i][1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int i0, int j0, int Cin, int Cout) const {
    const int lane = threadIdx.x & 31, u0 = (threadIdx.x >> 5) * UPW;
    if (u0 >= UNITS) return;
    const int mt = u0 / NP, np0 = u0 % NP;
#pragma unroll
    for (int i = 0; i < UPW; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = i0 + mt * 16 + (lane >> 2) + h * 8;
          const int co = j0 + (np0 + i) * 16 + t * 8 + (lane & 3) * 2;
          if (ci >= Cin) continue;
          if (co < Cout) out[(size_t)ci * Cout + co] = c[i][t][h * 2];
          if (co + 1 < Cout) out[(size_t)ci * Cout + co + 1] = c[i][t][h * 2 + 1];
        }
  }
};

// f32: thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns tx + 16 j.
template <int CI, int CO> struct Tile<float, CI, CO> {
  static constexpr int TI = CI / 16, TJ = CO / 16;
  static constexpr int LDX = CI + 4, LDG = CO + 4;
  float c[TI][TJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) c[i][j] = 0.f;
  }

  __device__ __forceinline__ void multiply(const float* Xs, const float* Gs, int nh) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    for (int h = 0; h < nh; ++h) {
      float a[TI], g[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) a[i] = Xs[h * LDX + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) g[j] = Gs[h * LDG + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) c[i][j] = fmaf(a[i], g[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* out, int i0, int j0, int Cin, int Cout) const {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int ci = i0 + ty + 16 * i, co = j0 + tx + 16 * j;
        if (ci < Cin && co < Cout) out[(size_t)ci * Cout + co] = c[i][j];
      }
  }
};

template <typename T, int CI, int CO>
__global__ void __launch_bounds__(THREADS) gather_gemm_dw_partial(const Args p) {
  constexpr int PER = Piece<T>::N;
  constexpr int HP = hits_per_step<T, CI, CO>();
  constexpr int LDX = CI + PER, LDG = CO + PER;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, Cin = p.Cin, Cout = p.Cout, cap = p.chunk_rows;
  constexpr int NS = STAGES;
  const Layout L = layout<T, CI, CO>(cap, p.taps, HP);
  int* src = reinterpret_cast<int*>(smem + L.src);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* begin = reinterpret_cast<int*>(smem + L.begin);  // first step of each tap
  uint16_t* dst = reinterpret_cast<uint16_t*>(smem + L.dst);
  unsigned char* stage = smem + L.stage;
  const int stage_bytes = L.x_bytes + L.g_bytes;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int k0 = blockIdx.y * p.taps;
  const int G = min(p.taps, K - k0);
  const int co_tiles = (Cout + CO - 1) / CO;
  const int i0 = blockIdx.z / co_tiles * CI, j0 = blockIdx.z % co_tiles * CO;
  const int row_begin = chunk * cap;
  const int rows = min(cap, p.R - row_begin);
  const T* table = static_cast<const T*>(p.table);
  const T* gout = static_cast<const T*>(p.gout);
  const int N = p.N, V = p.V;

  const int sub = min(cap, NS * stage_bytes / (G * 5) / 32 * 32);
  scan_rulebook(p.idx, p.found, (size_t)row_begin, rows, K, k0, G, V, sub, cap, stage, src, dst,
                cnt, [=](int r) { return (row_begin + r) / N * V; });
  if (tid == 0) {
    int s = 0;
    for (int g = 0; g < G; ++g) {
      begin[g] = s;
      s += (cnt[g] + HP - 1) / HP;
    }
    begin[G] = s;
  }
  __syncthreads();

  // a tap that no row of the chunk found: its tile is zero
  for (int g = 0; g < G; ++g) {
    if (cnt[g] != 0) continue;
    float* out = p.partial + ((size_t)chunk * K + k0 + g) * Cin * Cout;
    for (int e = tid; e < CI * CO; e += THREADS) {
      const int ci = i0 + e / CO, co = j0 + e % CO;
      if (ci < Cin && co < Cout) out[(size_t)ci * Cout + co] = 0.f;
    }
  }

  // step s of tap g covers hits [(s - begin[g]) * HP, ...) of its list
  const int steps = begin[G];
  int gi = 0;
  auto fetch = [&](int s, int buf) {
    if (s < steps) {
      while (begin[gi + 1] <= s) ++gi;
      const int h0 = (s - begin[gi]) * HP;
      const int nh = min(HP, cnt[gi] - h0), nh16 = round_up(nh, 16);
      T* Xs = reinterpret_cast<T*>(stage + buf * stage_bytes);
      T* Gs = reinterpret_cast<T*>(stage + buf * stage_bytes + L.x_bytes);
      const int* s_src = src + gi * cap + h0;
      const uint16_t* s_dst = dst + gi * cap + h0;
      for (int e = tid; e < nh16 * (CI / PER); e += THREADS) {
        const int j = e / (CI / PER), c = e % (CI / PER) * PER;
        const int valid = j < nh ? min(PER, Cin - i0 - c) : 0;
        const T* from = valid > 0 ? table + (size_t)s_src[j] * Cin + i0 + c : table;
        stage_piece(Xs + j * LDX + c, from, valid, p.vec_x);
      }
      for (int e = tid; e < nh16 * (CO / PER); e += THREADS) {
        const int j = e / (CO / PER), c = e % (CO / PER) * PER;
        const int valid = j < nh ? min(PER, Cout - j0 - c) : 0;
        const T* from = valid > 0 ? gout + (size_t)(row_begin + s_dst[j]) * Cout + j0 + c : gout;
        stage_piece(Gs + j * LDG + c, from, valid, p.vec_g);
      }
    }
    cp_async_commit();  // one group a step, empty or not: the waits count groups
  };

  Tile<T, CI, CO> tile;
  tile.zero();
  int gc = 0;
  for (int s = 0; s < NS - 1; ++s) fetch(s, s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait();
    __syncthreads();  // step s has landed; everyone is done with step s - 1
    fetch(s + NS - 1, (s + NS - 1) % NS);  // into the buffer that step s - 1 read
    while (begin[gc + 1] <= s) ++gc;
    const int nh = min(HP, cnt[gc] - (s - begin[gc]) * HP);
    tile.multiply(reinterpret_cast<const T*>(stage + s % NS * stage_bytes),
                  reinterpret_cast<const T*>(stage + s % NS * stage_bytes + L.x_bytes), nh);
    if (s + 1 == begin[gc + 1]) {  // the tap's last step
      tile.store(p.partial + ((size_t)chunk * K + k0 + gc) * Cin * Cout, i0, j0, Cin, Cout);
      tile.zero();
    }
  }
}

__global__ void gather_gemm_dw_reduce(const float* __restrict__ partial,
                                      float* __restrict__ out, int chunks, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += partial[(size_t)c * E + e];  // chunk order
  out[e] = sum;
}

template <typename T, int CI, int CO>
int launch(const Args& p, float* out, cudaStream_t stream, int* smem_only) {
  const Layout L = layout<T, CI, CO>(p.chunk_rows, p.taps, hits_per_step<T, CI, CO>());
  if (smem_only) {
    *smem_only = L.total;
    return 0;
  }
  auto kernel = gather_gemm_dw_partial<T, CI, CO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit this refusal
    return (int)err;
  }
  const int chunks = (p.R + p.chunk_rows - 1) / p.chunk_rows;
  dim3 grid(chunks, (p.K + p.taps - 1) / p.taps,
            ((p.Cin + CI - 1) / CI) * ((p.Cout + CO - 1) / CO));
  kernel<<<grid, THREADS, L.total, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = p.K * p.Cin * p.Cout;
  gather_gemm_dw_reduce<<<(E + 255) / 256, 256, 0, stream>>>(p.partial, out, chunks, E);
  return (int)cudaGetLastError();
}

template <typename T, int CI>
int launch_co(const Args& p, float* out, cudaStream_t stream, int* smem_only) {
  if (p.Cout <= 16) return launch<T, CI, 16>(p, out, stream, smem_only);
  if (p.Cout <= 32) return launch<T, CI, 32>(p, out, stream, smem_only);
  if (p.Cout <= 64) return launch<T, CI, 64>(p, out, stream, smem_only);
  return launch<T, CI, 128>(p, out, stream, smem_only);
}

template <typename T>
int launch_ci(const Args& p, float* out, cudaStream_t stream, int* smem_only) {
  if (p.Cin <= 16) return launch_co<T, 16>(p, out, stream, smem_only);
  if (p.Cin <= 32) return launch_co<T, 32>(p, out, stream, smem_only);
  if (p.Cin <= 64) return launch_co<T, 64>(p, out, stream, smem_only);
  return launch_co<T, 128>(p, out, stream, smem_only);
}

int dispatch(const Args& p, float* out, int dtype, cudaStream_t stream, int* smem_only) {
  if (p.chunk_rows <= 0 || p.chunk_rows % 32 != 0 || p.chunk_rows > 65536 || p.taps <= 0 ||
      p.taps > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_ci<float>(p, out, stream, smem_only);
  if (dtype == 1) return launch_ci<__nv_bfloat16>(p, out, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C entry points for ctypes. dtype codes: 0 = float32, 1 = bfloat16 (of
// table and gout). All tensors contiguous: table (B, V, Cin), idx/found
// (B, N, K), gout (B, N, Cout), partial (ceil(B*N / chunk_rows), K, Cin,
// Cout) f32 scratch, out (K*Cin, Cout) f32. chunk_rows (a multiple of 32) and
// taps (at most 32) are the rows and taps one block owns.
// Returns the first CUDA error of the two launches (0 = none).
extern "C" int cpd_gather_gemm_dw(const void* table, const void* idx, const void* found,
                                  const void* gout, void* partial, void* out, int B, int V,
                                  int N, int K, int Cin, int Cout, int chunk_rows, int taps,
                                  int dtype, void* stream) {
  if (K == 0 || Cin == 0 || Cout == 0) return 0;
  const int per = dtype == 1 ? 8 : 4;
  Args p;
  p.table = table, p.idx = static_cast<const int32_t*>(idx);
  p.found = static_cast<const uint8_t*>(found), p.gout = gout;
  p.partial = static_cast<float*>(partial);
  p.V = V, p.N = N, p.R = B * N, p.K = K, p.Cin = Cin, p.Cout = Cout;
  p.chunk_rows = chunk_rows, p.taps = taps;
  p.vec_x = Cin % per == 0 && aligned16(table);
  p.vec_g = Cout % per == 0 && aligned16(gout);
  return dispatch(p, static_cast<float*>(out), dtype, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The dynamic shared memory, in bytes, that a launch with these sizes asks for.
extern "C" int cpd_gather_gemm_dw_smem(int Cin, int Cout, int chunk_rows, int taps, int dtype) {
  Args p = {};
  p.Cin = Cin, p.Cout = Cout, p.chunk_rows = chunk_rows, p.taps = taps;
  int bytes = 0;
  return dispatch(p, nullptr, dtype, nullptr, &bytes) == 0 ? bytes : -1;
}
