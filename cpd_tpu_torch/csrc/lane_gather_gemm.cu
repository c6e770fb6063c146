// Kernel G3: the gather-GEMM over a TRANSPOSED table (C, V),
//
//   out[n, :] = concat_k(tableT[:, idx[n, k]]) @ W        (W is (K*C, Cout))
//
// Replaces the TPU probe scripts/exp_r2i_lane_gather.py:75 (body :68-73).
// The TPU has no row gather but a lane shuffle, so the probe kept the table
// transposed (channels on sublanes, voxels on lanes), gathered
// g[c, q] = tableT[c, idx_flat[q]] along the lane axis, reordered to
// (TILE, K*C) and ran one product. The probe has no ``found`` (every idx is
// read); ``found`` may be given so that the kernel can run beside kernel A1 on
// a conv's rulebook.
//
// What bounds it on an H100. At the probe's operands (48,000 x 27 x 64 -> 64,
// f32, no found) the multiplications: 10.62 GFLOP, 0.158 ms at the 67 TFLOP/s
// of f32 FMAs, against 0.009 ms for its bytes (12 MB of table, 5 MB of idx,
// 12 MB of output). At the layer shapes (bf16) the bytes of the rulebook.
//
// What the design does:
//   * The (C, V) table is copied once into a row-major (V, C) scratch by
//     the transpose of lane_common.cuh (exported by lane_gather.cu's
//     library), so that every gathered row is whole 16-byte pieces: after
//     that, G3 is kernel G1's function (csrc/gather_gemm_flat.cu) on the
//     scratch, with the same column order k*C + c, the same ``found`` and the
//     same drop of an idx outside [0, V).
//   * bf16 operands: the wrapper launches G1's entry point on the scratch.
//     This file holds no bf16 product.
//   * f32 operands: the product below, exact f32 FMAs on the CUDA cores (no
//     TF32, no bf16). One block owns TM = 128 output rows and NT columns (Cout
//     padded to 16, 32, 64 or 128; tiles of 128 above that). It reads the
//     tile's (TM, K) slab of idx and found once into shared memory as a table
//     row or -1: an unfound tap's idx is never an address, an idx outside
//     [0, V) is dropped. A tile where no row finds a tap writes zeros and
//     returns, as G1's does. The flattened K*C reduction runs in steps of
//     KC = 32 columns, double-buffered: step s + 1 goes by cp.async while
//     step s multiplies. A 16-byte piece of an unfound or dropped tap goes with
//     src_bytes = 0, which reads nothing and fills zeros.
//   * A thread owns RM x CN = 8 x 4 outputs (8 x 8 at NT = 128): rows
//     ty + 16 i, columns in groups of 4 (column_of). Per 4 columns of the
//     reduction it reads CN / 4 float4 of W a column, then a float4 of each
//     of its 8 gathered rows, from shared memory, for 32 CN FMAs: 128 FMAs
//     per 12 loads at CN = 4 (the first G3: 16 per 8). Holding W's 4 x CN
//     values and one row's 4 at a time fits a thread into 85 registers (a
//     few bytes spill), so that 3 blocks of 256 threads share an SM: at 2,
//     P6's 375 blocks took two waves. Rows
//     are padded by 16 bytes, so the float4 reads of a warp meet no bank
//     conflict. NT = 16 and 32 run 64 and 128 threads a block, so that the
//     register tile stays 8 x 4.
//   * Each output sums its K*C columns in order with one accumulator: no
//     atomics, a second launch gives the same bits.
//   * Rows that are not whole 16-byte pieces (C % 4 != 0, the first layer's
//     5 channels) and W with Cout % 4 != 0 are staged by scalar loads. K = 3,
//     a ragged last tile and a ragged last step are masked (zeros past K*C in
//     both operands add +0).
#include "gather_common.cuh"

namespace {

using namespace cpd;

constexpr int TM = 128;  // output rows a block
constexpr int KC = 32;   // flattened columns a step
constexpr int RM = 8;    // rows a thread
constexpr int LDA = KC + 4;

// The f32 product's geometry at NT output columns a block.
template <int NT> struct Tile {
  static constexpr int CN = NT >= 128 ? 8 : 4;   // columns a thread
  static constexpr int TXN = NT / CN;            // threads across the columns
  static constexpr int TYN = TM / RM;            // threads down the rows
  static constexpr int THREADS = TXN * TYN;      // 64, 128, 256, 256
  static constexpr int LDW = NT + 4;
  // blocks an SM must hold: 3 at NT = 64 (P6: 375 blocks in one wave on 132
  // SMs; 85 registers a thread), else 2 (8 x 8 outputs a thread at NT = 128)
  static constexpr int MIN_BLOCKS = NT == 64 ? 3 : 2;
};

// The tile column of a thread's output j (a multiple of 4): its 4-column
// groups lie TXN * 4 apart, so that the float4 reads of W by a warp's
// neighbouring threads are neighbouring 16-byte pieces.
template <int NT>
__device__ __forceinline__ int column_of(int tx, int j) {
  return (j / 4) * Tile<NT>::TXN * 4 + tx * 4;
}

struct Args {
  const float* rows;     // (V, C) row-major scratch
  const int32_t* idx;
  const uint8_t* found;  // nullptr: every tap found
  const float* w;
  float* out;
  int V, N, K, C, Cout;
  int vec_a, vec_w, vec_out;  // 16-byte pieces of rows, of W; float4 stores of out
};

struct Layout {
  int stage, a_bytes, w_bytes, total;
};

// Shared memory of one block: the (TM, K) slab as table rows, then STAGES
// stage buffers (TM x KC gathered columns, KC x NT of W; rows padded by 16
// bytes).
template <int NT>
__host__ __device__ inline Layout layout(int K) {
  Layout L;
  L.stage = round_up(TM * K * 4, 16);
  L.a_bytes = TM * LDA * 4;
  L.w_bytes = KC * Tile<NT>::LDW * 4;
  L.total = L.stage + STAGES * (L.a_bytes + L.w_bytes);
  return L;
}

template <int NT>
__global__ void __launch_bounds__(Tile<NT>::THREADS, Tile<NT>::MIN_BLOCKS)
lane_gather_gemm_f32(const Args p) {
  using G = Tile<NT>;
  constexpr int CN = G::CN, TXN = G::TXN, TYN = G::TYN, LDW = G::LDW, THREADS_ = G::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, C = p.C, Cout = p.Cout, Q = K * C;
  const Layout L = layout<NT>(K);
  int* rows = reinterpret_cast<int*>(smem);
  unsigned char* stage = smem + L.stage;
  const int stage_bytes = L.a_bytes + L.w_bytes;
  const int tid = threadIdx.x, tx = tid % TXN, ty = tid / TXN;
  const int n0 = blockIdx.x * TM, j0 = blockIdx.y * NT;
  const int nrows = min(TM, p.N - n0);

  // 1. the tile's rulebook slab, read once: a table row or -1 per (row, tap)
  const size_t base = (size_t)n0 * K;
  int live = 0;
  for (int e = tid; e < TM * K; e += THREADS_) {
    int r = -1;
    if (e < nrows * K && (p.found == nullptr || p.found[base + e])) {
      const int v = p.idx[base + e];
      if (v >= 0 && v < p.V) r = v;
    }
    rows[e] = r;
    live |= r >= 0;
  }
  if (!__syncthreads_or(live)) {  // no row of the tile finds a tap: zeros, nothing else
    for (int e = tid; e < nrows * NT; e += THREADS_) {
      const int n = n0 + e / NT, col = j0 + e % NT;
      if (col < Cout) p.out[(size_t)n * Cout + col] = 0.f;
    }
    return;
  }

  // 2. the flattened reduction, KC columns a step, step s + 1 staged while
  // step s multiplies
  const int steps = (Q + KC - 1) / KC;
  auto fetch = [&](int s, int buf) {
    if (s < steps) {
      const int q0 = s * KC;
      float* As = reinterpret_cast<float*>(stage + buf * stage_bytes);
      float* Ws = reinterpret_cast<float*>(stage + buf * stage_bytes + L.a_bytes);
      if (p.vec_a) {  // C % 4 == 0: a piece lies inside one tap, whole or past Q
        // a thread stages the same piece of the step (THREADS_ is a multiple
        // of KC / 4) for rows m, m + THREADS_ / (KC / 4), ...: one division
        const int q = q0 + tid % (KC / 4) * 4, tap = q < Q ? q / C : K, off = q - tap * C;
        for (int m = tid / (KC / 4); m < TM; m += THREADS_ / (KC / 4)) {
          const int r = tap < K ? rows[m * K + tap] : -1;
          cp_async16(As + m * LDA + (q - q0), r >= 0 ? p.rows + (size_t)r * C + off : p.rows,
                     r >= 0 ? 16 : 0);
        }
      } else {  // scalar staging of the flattened columns
        for (int e = tid; e < TM * KC; e += THREADS_) {
          const int m = e / KC, q = q0 + e % KC;
          float v = 0.f;
          if (q < Q) {
            const int tap = q / C, r = rows[m * K + tap];
            if (r >= 0) v = p.rows[(size_t)r * C + (q - tap * C)];
          }
          As[m * LDA + (q - q0)] = v;
        }
      }
      if (p.vec_w) {  // Cout % 4 == 0: a piece is whole or past Cout
        const int col = tid % (NT / 4) * 4;  // THREADS_ is a multiple of NT / 4
        for (int c = tid / (NT / 4); c < KC; c += THREADS_ / (NT / 4)) {
          const bool ok = q0 + c < Q && j0 + col < Cout;
          cp_async16(Ws + c * LDW + col, ok ? p.w + (size_t)(q0 + c) * Cout + j0 + col : p.w,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < KC * NT; e += THREADS_) {
          const int c = e / NT, col = e % NT;
          float v = 0.f;
          if (q0 + c < Q && j0 + col < Cout) v = p.w[(size_t)(q0 + c) * Cout + j0 + col];
          Ws[c * LDW + col] = v;
        }
      }
    }
    cp_async_commit();  // one group a step, empty or not: the waits count groups
  };

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  fetch(0, 0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait();
    __syncthreads();  // step s has landed; everyone is done with step s - 1
    fetch(s + 1, (s + 1) % STAGES);  // into the buffer that step s - 1 read
    const float* As = reinterpret_cast<const float*>(stage + s % STAGES * stage_bytes);
    const float* Ws = reinterpret_cast<const float*>(stage + s % STAGES * stage_bytes + L.a_bytes);
#pragma unroll 1  // one chunk's W in registers at a time: no spill at 85 registers
    for (int c4 = 0; c4 < KC; c4 += 4) {
      float b[4][CN];  // W's 4 rows of this thread's columns
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < CN; j += 4) {
          const float4 wv =
              *reinterpret_cast<const float4*>(Ws + (c4 + cc) * LDW + column_of<NT>(tx, j));
          b[cc][j] = wv.x, b[cc][j + 1] = wv.y, b[cc][j + 2] = wv.z, b[cc][j + 3] = wv.w;
        }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(As + (ty + TYN * i) * LDA + c4);
#pragma unroll
        for (int j = 0; j < CN; ++j) {  // the 4 columns in order
          acc[i][j] = fmaf(a.x, b[0][j], acc[i][j]);
          acc[i][j] = fmaf(a.y, b[1][j], acc[i][j]);
          acc[i][j] = fmaf(a.z, b[2][j], acc[i][j]);
          acc[i][j] = fmaf(a.w, b[3][j], acc[i][j]);
        }
      }
    }
  }

  // 3. the f32 output, written once
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int n = n0 + ty + TYN * i;
    if (n >= p.N) continue;
#pragma unroll
    for (int j = 0; j < CN; j += 4) {
      const int col = j0 + column_of<NT>(tx, j);
      float* o = p.out + (size_t)n * Cout + col;
      if (p.vec_out && col + 4 <= Cout) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                                                    acc[i][j + 3]);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (col + t < Cout) o[t] = acc[i][j + t];
      }
    }
  }
}

template <int NT>
int launch(const Args& p, cudaStream_t stream, int* smem_only) {
  const Layout L = layout<NT>(p.K);
  if (smem_only) {
    *smem_only = L.total;
    return 0;
  }
  auto kernel = lane_gather_gemm_f32<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  if (err == cudaSuccess)  // all of L1 that may be shared memory, so that MIN_BLOCKS fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit this refusal
    return (int)err;
  }
  dim3 grid((p.N + TM - 1) / TM, (p.Cout + NT - 1) / NT);
  kernel<<<grid, Tile<NT>::THREADS, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch(const Args& p, cudaStream_t stream, int* smem_only) {
  if (p.Cout <= 16) return launch<16>(p, stream, smem_only);
  if (p.Cout <= 32) return launch<32>(p, stream, smem_only);
  if (p.Cout <= 64) return launch<64>(p, stream, smem_only);
  return launch<128>(p, stream, smem_only);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C entry points for ctypes. dtype codes: 0 = float32, 1 = bfloat16.
//
// The f32 product on the transposed table: rows (V, C) the row-major scratch,
// idx (N, K) int32, found (N, K) bytes or NULL (every tap found), w (K*C, Cout),
// out (N, Cout), all f32 and contiguous (dtype must be 0: bf16 operands go to
// kernel G1). Returns the CUDA error of the launch (0 = none).
extern "C" int cpd_lane_gather_gemm(const void* rows, const void* idx, const void* found,
                                    const void* w, void* out, int V, int N, int K, int C,
                                    int Cout, int dtype, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || Cout == 0) return 0;
  Args p;
  p.rows = static_cast<const float*>(rows), p.idx = static_cast<const int32_t*>(idx);
  p.found = static_cast<const uint8_t*>(found), p.w = static_cast<const float*>(w);
  p.out = static_cast<float*>(out);
  p.V = V, p.N = N, p.K = K, p.C = C, p.Cout = Cout;
  p.vec_a = C % 4 == 0 && aligned16(rows);
  p.vec_w = Cout % 4 == 0 && aligned16(w);
  p.vec_out = Cout % 4 == 0 && aligned16(out);
  return dispatch(p, static_cast<cudaStream_t>(stream), nullptr);
}

// The dynamic shared memory, in bytes, that a launch of the f32 product with
// these sizes asks for.
extern "C" int cpd_lane_gather_gemm_smem(int K, int Cout) {
  Args p = {};
  p.K = K, p.Cout = Cout;
  int bytes = 0;
  return dispatch(p, nullptr, &bytes) == 0 ? bytes : -1;
}
