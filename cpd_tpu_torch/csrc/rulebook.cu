// Kernels B1a, B1b and B2: the rulebook builders of the sparse convolution,
// on one occupancy bitmap a backbone stage.
//
// They stand in for no Pallas kernel. They replace the JAX op chains of
// cpd_tpu/ops/sparse.py that the TPU runs as XLA bitmap passes:
// build_bitmap_lut / build_padded_bitmap (the stage table), _bitmap_rank
// with lookup_bitmap_packed_taps, lookup_packed_taps and
// lookup_bitmap_runs_dynamic (the tap lookups of the submanifold, strided and
// inverse rulebooks), _bitmap_downsample and _keys_from_padded_bitmap (a
// strided conv's output set); cpd_tpu/models/backbone3d.py shares one table a
// stage between them, and so does the port (models/backbone3d.py).
//
// The table of a stage (B1a) holds, per sample, the stage's occupancy as
// row-padded 32-bit words: a (z, y) row of the grid owns wr = ceil(nx / 32)
// words, bit x & 31 of word (z * ny + y) * wr + (x >> 5) is cell (z, y, x),
// and the padding bits (x >= nx) are never set. Beside the words it holds the
// INCLUSIVE prefix count of the set bits up to and including each word (one
// torch.cumsum over the per-word counts, launched with no sync). Since every
// row is word-aligned, the words run in key order, so a set cell's sorted row
// is
//
//   row = prefix[w] - popcount(word >> bit)
//
// (JAX's exclusive prefix + popcount(word & ((1 << bit) - 1))), and one
// layout serves the lookups and the downsampling, where JAX keeps two.
//
// Four kernels:
//   * set_bits (B1a): one thread a key: atomicOr of its bit into its word and
//     atomicAdd of 1 into the word's count (keys are unique, so the count is
//     the popcount). The entry zeroes both arrays on the stream first.
//   * lookup (B1b): one thread an (output row, tap): the row's key gives its
//     cell, the mode its tap's cell in the table's grid (subm: the centred
//     offset; strided: o * s - p + tap on the input table; inverse:
//     (u + p - tap) / s where every dimension divides, on the output table),
//     bounds checked per dimension before the cell is linearised (no tap wraps
//     across a row), then the rank above. Writes idx (0 where not found) and
//     found, and, for tap 0, the row's valid flag.
//   * dilate (B2, first half): one thread an output word. For each input
//     word along x of the word's receptive field it ORs the field's input
//     rows ([o * s - p, o * s - p + k - 1] in y and z, clipped to the grid),
//     and sets output bit j where that word and the one before hold a set
//     bit in [ox * s - p, ox * s - p + k - 1] along x. Any kernel and stride
//     the builders accept (kx <= 32: the wrapper checks). Writes the word and
//     its popcount.
//   * compact (B2, second half, after the cumsum of those counts): one
//     thread an output word: each set bit of rank below the cap writes its
//     key at its rank (sorted by construction), the bits of rank >= cap are
//     cleared from the word and the word's prefix is clamped to the cap, so
//     the output table is the truncated set that the next stage looks up
//     (JAX builds that stage's table from the truncated keys). The threads
//     with index in [min(total, cap), cap) write INVALID_KEY / not valid.
//
// What bounds them on an H100: bytes, and at the bench grid little of them.
// The stage-0 table of a 1504 x 1504 x 41 grid is 2.9M words (11.6 MB, and as
// much of prefix) a sample; a lookup reads a word and a prefix per tap
// (scattered, mostly from L2: a stage's rows touch a few MB of words) and
// writes 5 bytes a tap; the dilation reads its receptive field's rows from L2
// (9 rows of at most 3 words for a 3^3 kernel at stride 2). None of them
// synchronises with the host: the capacities are fixed, so the builders'
// torch.unique, per-sample loops and host-to-device copies of tap offsets
// are gone.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int32_t kInvalidKey = 0x7fffffff;
enum Mode { kSubm = 0, kStrided = 1, kInverse = 2 };

struct Dims {
  int x, y, z;
};

__global__ void __launch_bounds__(kBlock)
set_bits_kernel(const int32_t* __restrict__ keys, int V, int nx, int cells, int wr,
                int64_t n_words, uint32_t* __restrict__ words, int32_t* __restrict__ counts) {
  const int v = blockIdx.x * kBlock + threadIdx.x;
  if (v >= V) return;
  const int b = blockIdx.y;
  const int32_t key = keys[static_cast<int64_t>(b) * V + v];
  if (key < 0 || key >= cells) return;  // INVALID_KEY padding
  const int x = key % nx;
  const int64_t w = b * n_words + static_cast<int64_t>(key / nx) * wr + (x >> 5);
  atomicOr(words + w, 1u << (x & 31));
  atomicAdd(counts + w, 1);
}

__global__ void __launch_bounds__(kBlock)
lookup_kernel(const int32_t* __restrict__ row_keys, int V, int K, Dims rg,
              const uint32_t* __restrict__ words, const int32_t* __restrict__ prefix,
              int64_t n_words, Dims tg, int wr, Dims k, Dims s, Dims p, int mode,
              int32_t* __restrict__ idx, uint8_t* __restrict__ found,
              uint8_t* __restrict__ valid) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;  // row * K + tap
  const int64_t n = static_cast<int64_t>(V) * K;
  if (i >= n) return;
  const int b = blockIdx.y;
  const int row = static_cast<int>(i / K), tap = static_cast<int>(i % K);
  const int32_t key = row_keys[static_cast<int64_t>(b) * V + row];
  const bool row_ok = key != kInvalidKey;
  if (valid != nullptr && tap == 0) valid[static_cast<int64_t>(b) * V + row] = row_ok;
  int32_t out = 0;
  uint8_t hit = 0;
  if (row_ok) {
    const int x = key % rg.x, y = (key / rg.x) % rg.y, z = key / (rg.x * rg.y);
    const int dx = tap % k.x, dy = (tap / k.x) % k.y, dz = tap / (k.x * k.y);
    int cx, cy, cz;
    bool ok = true;
    if (mode == kSubm) {
      cx = x + dx - k.x / 2;
      cy = y + dy - k.y / 2;
      cz = z + dz - k.z / 2;
    } else if (mode == kStrided) {
      cx = x * s.x - p.x + dx;
      cy = y * s.y - p.y + dy;
      cz = z * s.z - p.z + dz;
    } else {  // kInverse: the output site whose tap `tap` reads this input
      const int nx_ = x + p.x - dx, ny_ = y + p.y - dy, nz_ = z + p.z - dz;
      ok = nx_ >= 0 && ny_ >= 0 && nz_ >= 0 && nx_ % s.x == 0 && ny_ % s.y == 0 &&
           nz_ % s.z == 0;
      cx = nx_ / s.x;
      cy = ny_ / s.y;
      cz = nz_ / s.z;
    }
    ok = ok && cx >= 0 && cx < tg.x && cy >= 0 && cy < tg.y && cz >= 0 && cz < tg.z;
    if (ok) {
      const int64_t w = b * n_words + (static_cast<int64_t>(cz) * tg.y + cy) * wr + (cx >> 5);
      const uint32_t word = __ldg(words + w) >> (cx & 31);
      if (word & 1u) {
        hit = 1;
        out = __ldg(prefix + w) - __popc(word);
      }
    }
  }
  idx[b * n + i] = out;
  found[b * n + i] = hit;
}

__global__ void __launch_bounds__(kBlock)
dilate_kernel(const uint32_t* __restrict__ in_words, int64_t in_n_words, Dims ig, int wri,
              int64_t out_n_words, Dims og, int wro, Dims k, Dims s, Dims p,
              uint32_t* __restrict__ out_words, int32_t* __restrict__ counts) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (w >= out_n_words) return;
  const int b = blockIdx.y;
  const int wx = static_cast<int>(w % wro);
  const int64_t zy = w / wro;
  const int oy = static_cast<int>(zy % og.y), oz = static_cast<int>(zy / og.y);
  const int z0 = max(oz * s.z - p.z, 0), z1 = min(oz * s.z - p.z + k.z - 1, ig.z - 1);
  const int y0 = max(oy * s.y - p.y, 0), y1 = min(oy * s.y - p.y + k.y - 1, ig.y - 1);
  const int ox0 = wx * 32, ox1 = min(ox0 + 31, og.x - 1);
  const int x0 = max(ox0 * s.x - p.x, 0), x1 = min(ox1 * s.x - p.x + k.x - 1, ig.x - 1);
  uint32_t out = 0;
  if (z0 <= z1 && y0 <= y1 && x0 <= x1) {
    // The field's input words along x, wlo .. wlo + nw - 1, one at a time:
    // word i is the OR of the field's rows, and the pair (word i - 1, word i)
    // serves every output bit whose x range starts in word i - 1 (a range
    // spans at most 2 words, kx <= 32). The ranges start in x order, so one
    // cursor walks the output bits; no array, so nothing lives in local
    // memory.
    const int wlo = x0 >> 5, nw = (x1 >> 5) - wlo + 1;
    const uint32_t* base = in_words + b * in_n_words + wlo;
    uint32_t prev = 0u;
    int ox = ox0;
    for (int i = 0; i <= nw; ++i) {
      uint32_t cur = 0u;
      if (i < nw)
        for (int z = z0; z <= z1; ++z)
          for (int y = y0; y <= y1; ++y)
            cur |= __ldg(base + (static_cast<int64_t>(z) * ig.y + y) * wri + i);
      for (; i > 0 && ox <= ox1; ++ox) {
        const int lo = max(ox * s.x - p.x, 0), hi = min(ox * s.x - p.x + k.x - 1, ig.x - 1);
        if (lo > hi) continue;  // the range lies outside the grid
        const int a = lo - wlo * 32, span = hi - lo;  // span < 32
        if ((a >> 5) != i - 1) break;  // starts in a later word
        const uint64_t pair = prev | (static_cast<uint64_t>(cur) << 32);
        if ((pair >> (a & 31)) & ((2ull << span) - 1ull)) out |= 1u << (ox - ox0);
      }
      prev = cur;
    }
  }
  out_words[b * out_n_words + w] = out;
  counts[b * out_n_words + w] = __popc(out);
}

__global__ void __launch_bounds__(kBlock)
compact_kernel(uint32_t* __restrict__ words, int32_t* __restrict__ prefix, int64_t n_words,
               int nx, int wr, int cap, int32_t* __restrict__ out_keys,
               uint8_t* __restrict__ out_valid) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int b = blockIdx.y;
  uint32_t* wd = words + b * n_words;
  int32_t* pre = prefix + b * n_words;
  const int64_t slots = static_cast<int64_t>(b) * cap;
  if (t < cap) {
    // the last word's owner may clamp its prefix to the cap meanwhile:
    // min(., cap) reads the same either way
    const int32_t total = min(pre[n_words - 1], cap);
    if (t >= total) {
      out_keys[slots + t] = kInvalidKey;
      out_valid[slots + t] = 0;
    }
  }
  if (t >= n_words) return;
  const int32_t incl = pre[t];
  uint32_t word = wd[t];
  if (word) {
    int32_t r = incl - __popc(word);
    const int32_t key0 = static_cast<int32_t>(t / wr) * nx + static_cast<int32_t>(t % wr) * 32;
    for (uint32_t rest = word; rest; rest &= rest - 1u, ++r) {
      const int bit = __ffs(rest) - 1;
      if (r < cap) {
        out_keys[slots + r] = key0 + bit;
        out_valid[slots + r] = 1;
      } else {
        word &= ~(1u << bit);
      }
    }
  }
  if (incl > cap) {
    wd[t] = word;
    pre[t] = cap;
  }
}

unsigned blocks_for(int64_t n) { return static_cast<unsigned>((n + kBlock - 1) / kBlock); }

int64_t words_of(int nx, int ny, int nz) {
  return static_cast<int64_t>(nz) * ny * ((nx + 31) / 32);
}

}  // namespace

// B1a. keys (B, V) int32 sorted unique, INVALID_KEY padded, on the grid
// (nx, ny, nz); words and counts (B, nz * ny * ceil(nx / 32)) 32-bit, set
// here (zeroed first). The caller takes the cumsum of counts as the prefix.
extern "C" int cpd_rulebook_table(const void* keys, int B, int V, int nx, int ny, int nz,
                                  void* words, void* counts, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_words = words_of(nx, ny, nz);
  const size_t bytes = static_cast<size_t>(B) * n_words * sizeof(uint32_t);
  cudaError_t err = cudaMemsetAsync(words, 0, bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(counts, 0, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || V == 0) return 0;
  set_bits_kernel<<<dim3(blocks_for(V), B), kBlock, 0, st>>>(
      static_cast<const int32_t*>(keys), V, nx, nx * ny * nz, (nx + 31) / 32, n_words,
      static_cast<uint32_t*>(words), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// B1b. row_keys (B, V) on the row grid rg; the table's words and inclusive
// prefix (B, words) on the table grid tg; kernel, stride, padding (x, y, z);
// mode 0 subm, 1 strided, 2 inverse. idx (B, V, K) int32, found (B, V, K)
// bytes, valid (B, V) bytes or null.
extern "C" int cpd_rulebook_lookup(const void* row_keys, int B, int V, int rnx, int rny, int rnz,
                                   const void* words, const void* prefix, int tnx, int tny,
                                   int tnz, int kx, int ky, int kz, int sx, int sy, int sz,
                                   int px, int py, int pz, int mode, void* idx, void* found,
                                   void* valid, void* stream) {
  const int K = kx * ky * kz;
  if (B == 0 || V == 0) return 0;
  lookup_kernel<<<dim3(blocks_for(static_cast<int64_t>(V) * K), B), kBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_keys), V, K, Dims{rnx, rny, rnz},
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(prefix),
      words_of(tnx, tny, tnz), Dims{tnx, tny, tnz}, (tnx + 31) / 32, Dims{kx, ky, kz},
      Dims{sx, sy, sz}, Dims{px, py, pz}, mode, static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(found), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

// B2, first half. The input table's words (B, in words) on grid ig, the
// output grid og; out_words and counts (B, out words).
extern "C" int cpd_rulebook_dilate(const void* in_words, int B, int inx, int iny, int inz,
                                   int onx, int ony, int onz, int kx, int ky, int kz, int sx,
                                   int sy, int sz, int px, int py, int pz, void* out_words,
                                   void* counts, void* stream) {
  const int64_t out_n = words_of(onx, ony, onz);
  if (B == 0 || out_n == 0) return 0;
  dilate_kernel<<<dim3(blocks_for(out_n), B), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in_words), words_of(inx, iny, inz), Dims{inx, iny, inz},
      (inx + 31) / 32, out_n, Dims{onx, ony, onz}, (onx + 31) / 32, Dims{kx, ky, kz},
      Dims{sx, sy, sz}, Dims{px, py, pz}, static_cast<uint32_t*>(out_words),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// B2, second half. words and prefix (B, words) of the grid (nx, ny, nz),
// the prefix the inclusive cumsum of the dilation's counts; both truncated to
// the cap in place. out_keys (B, cap) int32, out_valid (B, cap) bytes.
extern "C" int cpd_rulebook_compact(void* words, void* prefix, int B, int nx, int ny, int nz,
                                    int cap, void* out_keys, void* out_valid, void* stream) {
  const int64_t n_words = words_of(nx, ny, nz);
  if (B == 0 || n_words == 0) return 0;
  compact_kernel<<<dim3(blocks_for(n_words > cap ? n_words : cap), B), kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), static_cast<int32_t*>(prefix), n_words, nx, (nx + 31) / 32,
      cap, static_cast<int32_t*>(out_keys), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
