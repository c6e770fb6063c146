// Kernel G2: the per-tap gather-GEMM,
//
//   out[n, :] = sum over k, in tap order, of (found[n, k] ? table[idx[n, k], :] @ W[k] : 0)
//
// Replaces the TPU probe scripts/exp_tal_gather.py:86 (body :74-83): with no
// grid and every array resident in fast memory, one same-shape
// take_along_axis gather and one (V, Cin) @ (Cin, Cout) product per tap,
// summed in tap order in f32. On Hopper what can stay resident is W: all K
// taps of it fit in one block's shared memory at the probe's 16 -> 16 and at
// the narrow layers of a lidar frame (up to 32 -> 64 at K = 27, and 128 ->
// 128 at K = 3). This kernel takes bf16 operands whose W fits; the wrapper
// (ops/gather_probes.py::gather_gemm_per_tap, g2_route) sends f32 operands and
// wider W to kernel A1 (csrc/gather_gemm.cu), which computes the same
// function at batch 1.
//
// What bounds it on an H100: bytes. The rulebook (5 bytes a tap), the found
// rows of the table, W and the f32 output, each moved once, are 35 MB at the
// probe (0.010 ms at 3.35 TB/s); the found taps' 2 * Cin * Cout operations
// are far below that on the tensor cores. What A1's time is made of instead
// is its (tile, tap) steps: a block barrier, a gather of a few dozen rows, a
// copy of W[k] and a scattered add in shared memory, one after the other.
//
// What the design does about it:
//   * Persistent blocks, one an SM, of as many warps as the wrapper plans
//     (ops/gather_probes.py::g2_warps: the registers' cap for the width, or
//     what fits beside W, cut to the fewest that keep the rounds of tiles at
//     their least: a last round that few warps run costs a whole round).
//     Each block copies all K taps of W into shared memory once by cp.async,
//     rows padded by 16 bytes so that ldmatrix.trans meets no bank conflict,
//     under one wait with every warp's first slab: the block's only barrier.
//   * Every warp works alone on tiles of 32 output rows, one row a lane,
//     tiles warp-major over the blocks (a partial last round is spread over
//     every SM; a fixed assignment: the same bits every launch). It copies
//     the tile's (32, K) slab of idx and found by cp.async, whole 16-byte
//     pieces, into warp-private shared memory and turns it in place into
//     table rows or -1: one round trip to memory a tile, not one a tap. An
//     unfound tap's idx is never an address; an idx outside [0, V) is
//     dropped.
//   * Per tap, in order, one __ballot_sync over the slab's column gives the
//     tile's hit rows. The tap loop has no __syncthreads, only __syncwarp.
//   * The gather runs through a warp-private ring of two stages: tap k + 1's
//     rows are in flight while tap k multiplies (deeper rings were tried and
//     were no faster: other warps hide the copies). Only the rows that find
//     the tap are staged: their channels below Cin by 16-byte cp.async to
//     the ring row of their own tile row, a 16-channel row (one sector) by its
//     own lane, a wider one by neighbouring lanes side by side (measured
//     faster each way round). Nothing else is written: the
//     A fragments of rows that miss are zeroed in registers after ldmatrix
//     (exact, and a stale row is never multiplied), and channels past Cin
//     meet W's zero rows (the ring is zeroed once, so what lies there is
//     finite). A half of the tile (16 rows) with no hit is not multiplied, a
//     tap with no hit costs a ballot. Rows that are not whole 16-byte pieces
//     (5 channels) take scalar loads into the ring. Shared addresses are
//     computed once a warp, not once a copy.
//   * Keeping each hit at its own ring row is the mapping that keeps the
//     accumulator in registers: the product's fragment rows are the tile's
//     output rows. mma.sync.m16n8k16 (bf16 -> f32), A by ldmatrix from the
//     ring, B by ldmatrix.trans from the resident W[k], adds tap k into the
//     (32, Cout) f32 accumulator that the warp's lanes hold. A row finds a
//     tap once and taps follow in order: no atomics, no scatter, the same bits
//     on every launch. The zero rows a half carries cost multiplications on
//     the tensor cores, far below the tap loop's latency at these widths.
//   * Epilogue: lane pairs swap halves of their fragments (shfl.xor) so that
//     each lane writes 4 adjacent f32 of one row: 16-byte stores, the ragged
//     last tile and Cout masked.
//
// Any K (the slab and W must fit; the wrapper's route checks), Cin and Cout
// up to 128. A launch that the card refuses comes back as the returned CUDA
// error.
#include "gather_common.cuh"

namespace {

using namespace cpd;

constexpr int ROWS = 32;  // output rows a warp owns: one a lane, one ballot
// stages of a warp's ring: tap k + 1 lands while tap k multiplies (3 and 4
// measured no faster on an H100: the tap loop is bound by its own latency)
constexpr int DEPTH = 2;
constexpr unsigned FULL = 0xffffffffu;

// Warps a block may run, by the accumulator's width NT (NT f32 registers a
// thread hold it); __launch_bounds__ caps the registers to match.
template <int NT> struct Cap {
  static constexpr int WARPS = NT == 16 ? 32 : NT == 32 ? 24 : NT == 64 ? 16 : 8;
};

struct Args {
  const __nv_bfloat16* table;
  const int32_t* idx;
  const uint8_t* found;
  const __nv_bfloat16* w;
  float* out;
  int V, N, K, Cin, Cout;
  int vec_r, vec_w, vec_o;  // 16-byte pieces allowed for the rulebook, W rows, output rows
};

struct Layout {
  int w_bytes, slab, warp_bytes, total;
};

// Shared memory of one block: all K taps of W (K * KP rows of NT + 8 bf16),
// then per warp its slab (ROWS x K ints) and its ring of DEPTH stages (ROWS x
// (KP + 8) bf16; at least the slab's ROWS x K found bytes, which land there
// first).
template <int KP, int NT>
__host__ __device__ inline Layout layout(int K, int warps) {
  Layout L;
  L.w_bytes = round_up(K * KP * (NT + 8) * 2, 16);
  L.slab = round_up(ROWS * K * 4, 16);
  const int ring = DEPTH * ROWS * (KP + 8) * 2, found = round_up(ROWS * K, 16);
  L.warp_bytes = L.slab + (ring > found ? ring : found);
  L.total = L.w_bytes + warps * L.warp_bytes;
  return L;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Eight bf16 of src[0..valid) (valid may pass 8), zeros after, as one 16-byte
// shared store.
__device__ __forceinline__ void put_scalar8(void* dst, const __nv_bfloat16* src, int valid) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? src[i] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// Bytes [at, at + 16 * pieces) of src (n bytes long) into dst by the warp,
// zeros past n: 16-byte cp.async where `vec` says src is 16-byte aligned,
// else byte loads.
__device__ __forceinline__ void copy_bytes(unsigned char* dst, const unsigned char* src,
                                           size_t at, size_t n, int pieces, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < pieces; i += 32) {
    const size_t o = at + (size_t)i * 16;
    const int valid = o >= n ? 0 : n - o < 16 ? (int)(n - o) : 16;
    if (vec) {
      cp_async16(dst + i * 16, valid > 0 ? src + o : src, valid);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[i * 16 + j] = j < valid ? src[o + j] : 0;
    }
  }
}

// Issue the copy of all K taps of W, (K, Cin, Cout) in device memory, into Ws
// as (K * KP, NT + 8), zeros past Cin and Cout.
template <int KP, int NT>
__device__ __forceinline__ void load_weights(const Args& p, __nv_bfloat16* Ws) {
  constexpr int LDW = NT + 8, PPC = NT / 8;  // 16-byte pieces of a W row
  for (int e = threadIdx.x; e < p.K * KP * PPC; e += blockDim.x) {
    const int r = e / PPC, col = (e - r * PPC) * 8;
    const int k = r / KP, c = r - k * KP;
    const int valid = c < p.Cin ? min(8, p.Cout - col) : 0;
    const __nv_bfloat16* src = valid > 0 ? p.w + ((size_t)k * p.Cin + c) * p.Cout + col : p.w;
    if (p.vec_w)
      cp_async16(Ws + r * LDW + col, src, valid > 0 ? 16 : 0);
    else
      put_scalar8(Ws + r * LDW + col, src, valid);
  }
}

template <int KP, int NT, bool VEC>
__global__ void __launch_bounds__(32 * Cap<NT>::WARPS)
gather_gemm_per_tap_kernel(const Args p) {
  constexpr int LDA = KP + 8, LDW = NT + 8;
  constexpr int PPR = KP / 8;        // 16-byte pieces of a staged row
  // who stages a row: its own lane where a row is one 32-byte sector (no
  // shuffles), else PPR neighbouring lanes (a row's bytes in one request)
  constexpr bool OWN_ROW = PPR == 2;
  constexpr int RSTEP = 32 / PPR;    // rows between a lane's pieces, shared rows
  constexpr int NJ = NT / 8;         // 8-column MMA tiles
  constexpr uint32_t STAGE = ROWS * LDA * 2;  // bytes of a ring stage
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = p.K, Cin = p.Cin;
  const Layout L = layout<KP, NT>(K, warps);
  int* slab = reinterpret_cast<int*>(smem + L.w_bytes + warp * L.warp_bytes);
  unsigned char* ring = smem + L.w_bytes + warp * L.warp_bytes + L.slab;
  const int* my_slab = slab + lane * K;  // this lane's row

  // what a lane stages: its own row, or 16-byte pieces of rows lane / PPR +
  // RSTEP * i at channel c; what it hands ldmatrix: A row lane % 16 of a half
  // at channel 8 (lane / 16), B row (lane % 8) + 8 ((lane / 8) % 2) at column
  // 8 (lane / 16); which rows its A fragments hold: g and g + 8 of each half
  const int c = OWN_ROW ? 0 : (lane % PPR) * 8, g = lane >> 2;
  const uint32_t put =
      smem_addr(ring) + ((OWN_ROW ? lane : lane / PPR) * LDA + c) * 2;
  const uint32_t get_a = smem_addr(ring) + ((lane & 15) * LDA + (lane >> 4) * 8) * 2;
  const uint32_t get_b =
      smem_addr(smem) + (((lane & 7) + ((lane >> 3) & 1) * 8) * LDW + (lane >> 4) * 8) * 2;
  const int ksteps = (Cin + 15) / 16, nsteps = (p.Cout + 15) / 16;

  // Stage tap k into the ring stage at byte offset `stage`: of the rows
  // that find the tap, the channels below Cin; nothing else is written (rows
  // that miss are zeroed in registers, after ldmatrix). One copy group a
  // call, empty or not: the wait counts. Returns the tap's hits, bit r for
  // row r.
  auto stage_piece = [&](uint32_t to, const __nv_bfloat16* from, int valid) {
    if (VEC)
      cp_async16_at(to, from, 16);
    else
      put_scalar8(ring + (to - smem_addr(ring)), from, valid);
  };
  auto fetch = [&](int k, uint32_t stage) {
    const int v = k < K ? my_slab[k] : -1;  // this lane's row
    const unsigned m = __ballot_sync(FULL, v >= 0);
    if constexpr (OWN_ROW) {
      if (v >= 0) {
#pragma unroll
        for (int i = 0; i < PPR; ++i)
          if (i * 8 < Cin)
            stage_piece(put + stage + i * 16, p.table + (size_t)v * Cin + i * 8, Cin - i * 8);
      }
    } else if (m) {
#pragma unroll
      for (int i = 0; i < PPR; ++i) {
        const int src = __shfl_sync(FULL, v, lane / PPR + RSTEP * i);
        if (src >= 0 && c < Cin)
          stage_piece(put + stage + i * RSTEP * LDA * 2, p.table + (size_t)src * Cin + c,
                      Cin - c);
      }
    }
    cp_async_commit();
    return m;
  };

  // the tile's slab: raw idx into the slab and raw found into the ring, by cp.async
  const int tiles = (p.N + ROWS - 1) / ROWS;
  auto read_slab = [&](int tile) {
    const size_t at = (size_t)tile * ROWS * K;
    copy_bytes(reinterpret_cast<unsigned char*>(slab),
               reinterpret_cast<const unsigned char*>(p.idx), at * 4, (size_t)p.N * K * 4,
               ROWS * K / 4, p.vec_r);
    copy_bytes(ring, p.found, at, (size_t)p.N * K, (ROWS * K + 15) / 16, p.vec_r);
    cp_async_commit();
  };

  // 1. all K taps of W and every warp's first slab, under one wait and the
  // block's only barrier. Tiles go warp-major over the blocks (tile = warp *
  // blocks + block, then + all warps), so that a last, partial round is
  // spread over every SM. The ring starts as zeros: its channels past Cin are
  // never staged and meet W's zero rows, which must not see a NaN there.
  for (int i = lane; i < (L.warp_bytes - L.slab) / 16; i += 32)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  load_weights<KP, NT>(p, reinterpret_cast<__nv_bfloat16*>(smem));
  cp_async_commit();
  const int stride = gridDim.x * warps;
  int tile = warp * gridDim.x + blockIdx.x;
  if (tile < tiles) read_slab(tile);
  cp_async_wait_all();
  __syncthreads();

  for (; tile < tiles; tile += stride) {
    const int n0 = tile * ROWS;
    const int rows = min(ROWS, p.N - n0);
    __syncwarp();
    // 2. the slab in place: a table row or -1 per (row, tap); an unfound
    // tap's idx is never an address, an idx outside [0, V) is dropped
    for (int e = lane; e < ROWS * K; e += 32) {
      const int v = slab[e];
      slab[e] = ring[e] && v >= 0 && v < p.V ? v : -1;
    }
    __syncwarp();

    // 3. taps in order, tap k + 1 staged while tap k multiplies
    float acc[2][NJ][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int t = 0; t < 4; ++t) acc[f][j][t] = 0.f;
    static_assert(DEPTH == 2, "the stages alternate");
    uint32_t cur = 0;  // byte offset of tap k's stage
    unsigned m = fetch(0, 0);  // tap k's hits: bit r for row r
    for (int k = 0; k < K; ++k) {
      const unsigned m_next = fetch(k + 1, cur ^ STAGE);  // into the stage tap k - 1 read
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // tap k has landed here
      __syncwarp();                                             // ... and for every lane
      if (m) {
        const bool lo = m & 0xffffu, hi = m >> 16;
        // the rows of this lane's A fragments that miss the tap: zeroed
        const bool miss[2][2] = {{!((m >> g) & 1), !((m >> (g + 8)) & 1)},
                                 {!((m >> (g + 16)) & 1), !((m >> (g + 24)) & 1)}};
        const uint32_t a0 = get_a + cur, b0 = get_b + k * KP * LDW * 2;
#pragma unroll
        for (int ks = 0; ks < KP / 16; ++ks) {
          if (ks >= ksteps) break;  // wholly past Cin
          uint32_t a[2][4];
          if (lo) ldmatrix_x4_at(a[0], a0 + ks * 32);
          if (hi) ldmatrix_x4_at(a[1], a0 + 16 * LDA * 2 + ks * 32);
#pragma unroll
          for (int f = 0; f < 2; ++f) {  // registers 0, 2: row g; 1, 3: row g + 8
            if (miss[f][0]) a[f][0] = a[f][2] = 0u;
            if (miss[f][1]) a[f][1] = a[f][3] = 0u;
          }
#pragma unroll
          for (int nb = 0; nb < NT / 16; ++nb) {
            if (nb >= nsteps) break;
            uint32_t b[4];  // 16 columns of W[k]: two 8-wide MMA tiles
            ldmatrix_x4_trans_at(b, b0 + (ks * 16 * LDW + nb * 16) * 2);
            if (lo) {
              mma_bf16(acc[0][2 * nb], a[0], b[0], b[1]);
              mma_bf16(acc[0][2 * nb + 1], a[0], b[2], b[3]);
            }
            if (hi) {
              mma_bf16(acc[1][2 * nb], a[1], b[0], b[1]);
              mma_bf16(acc[1][2 * nb + 1], a[1], b[2], b[3]);
            }
          }
        }
      }
      __syncwarp();  // every lane is done with tap k's stage
      cur ^= STAGE;
      m = m_next;
    }

    // 4. epilogue: a fragment holds rows lane / 4 (c0, c1) and lane / 4 + 8
    // (c2, c3) at columns 2 (lane % 4) + {0, 1}; an even lane takes its
    // partner's first row pair, an odd lane the even one's second, and each
    // writes 4 adjacent columns of one row
    const bool odd = lane & 1;
    const int q = lane & 3;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* cf = acc[f][j];
        const float r0 = __shfl_xor_sync(FULL, odd ? cf[0] : cf[2], 1);
        const float r1 = __shfl_xor_sync(FULL, odd ? cf[1] : cf[3], 1);
        const int row = f * 16 + g + (odd ? 8 : 0), col = j * 8 + (q & 2) * 2;
        if (row >= rows || col >= p.Cout) continue;
        const float4 v =
            odd ? make_float4(r0, r1, cf[2], cf[3]) : make_float4(cf[0], cf[1], r0, r1);
        float* o = p.out + (size_t)(n0 + row) * p.Cout + col;
        if (p.vec_o) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (col + t < p.Cout) o[t] = vs[t];
        }
      }
    __syncwarp();  // the next slab overwrites the slab and the ring
    if (tile + stride < tiles) {
      read_slab(tile + stride);
      cp_async_wait_all();
    }
  }
}

template <int KP, int NT, bool VEC>
int launch(const Args& p, int warps, cudaStream_t stream, int* smem_only) {
  const Layout L = layout<KP, NT>(p.K, warps);
  if (smem_only) {
    *smem_only = L.total;
    return 0;
  }
  if (warps < 1 || warps > Cap<NT>::WARPS) return (int)cudaErrorInvalidValue;
  auto kernel = gather_gemm_per_tap_kernel<KP, NT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L.total);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, L.total);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorLaunchOutOfResources;
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not inherit this refusal
    return (int)err;
  }
  const int tiles = (p.N + ROWS - 1) / ROWS;
  const int grid = min(sms * per_sm, (tiles + warps - 1) / warps);
  kernel<<<grid, warps * 32, L.total, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KP, bool VEC>
int launch_nt(const Args& p, int warps, cudaStream_t stream, int* smem_only) {
  if (p.Cout <= 16) return launch<KP, 16, VEC>(p, warps, stream, smem_only);
  if (p.Cout <= 32) return launch<KP, 32, VEC>(p, warps, stream, smem_only);
  if (p.Cout <= 64) return launch<KP, 64, VEC>(p, warps, stream, smem_only);
  if (p.Cout <= 128) return launch<KP, 128, VEC>(p, warps, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

template <bool VEC>
int launch_kp(const Args& p, int warps, cudaStream_t stream, int* smem_only) {
  if (p.Cin <= 16) return launch_nt<16, VEC>(p, warps, stream, smem_only);
  if (p.Cin <= 32) return launch_nt<32, VEC>(p, warps, stream, smem_only);
  if (p.Cin <= 64) return launch_nt<64, VEC>(p, warps, stream, smem_only);
  if (p.Cin <= 128) return launch_nt<128, VEC>(p, warps, stream, smem_only);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const Args& p, int vec_a, int warps, cudaStream_t stream, int* smem_only) {
  if (p.K < 1) return (int)cudaErrorInvalidValue;
  return vec_a ? launch_kp<true>(p, warps, stream, smem_only)
               : launch_kp<false>(p, warps, stream, smem_only);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C entry point for ctypes. dtype code 1 (bfloat16, of table and w) is
// the only one taken: f32 operands go to kernel A1. All tensors contiguous:
// table (V, Cin), idx (N, K) int32, found (N, K) bytes, w (K, Cin, Cout), out
// (N, Cout) f32; Cin and Cout at most 128. warps: warps a block, at most 32,
// 24, 16 or 8 for Cout up to 16, 32, 64 or 128. Returns the CUDA error of the
// launch (0 = none).
extern "C" int cpd_gather_gemm_per_tap(const void* table, const void* idx, const void* found,
                                       const void* w, void* out, int V, int N, int K, int Cin,
                                       int Cout, int dtype, int warps, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (N == 0 || Cout == 0) return 0;
  Args p;
  p.table = static_cast<const __nv_bfloat16*>(table);
  p.idx = static_cast<const int32_t*>(idx), p.found = static_cast<const uint8_t*>(found);
  p.w = static_cast<const __nv_bfloat16*>(w), p.out = static_cast<float*>(out);
  p.V = V, p.N = N, p.K = K, p.Cin = Cin, p.Cout = Cout;
  p.vec_r = aligned16(idx) && aligned16(found);
  p.vec_w = Cout % 8 == 0 && aligned16(w);
  p.vec_o = Cout % 4 == 0 && aligned16(out);
  return dispatch(p, Cin % 8 == 0 && aligned16(table), warps, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The dynamic shared memory, in bytes, that a launch with these sizes asks
// for (-1 for sizes no instance takes).
extern "C" int cpd_gather_gemm_per_tap_smem(int K, int Cin, int Cout, int warps) {
  Args p = {};
  p.K = K, p.Cin = Cin, p.Cout = Cout;
  int bytes = 0;
  return dispatch(p, 1, warps, nullptr, &bytes) == 0 ? bytes : -1;
}
