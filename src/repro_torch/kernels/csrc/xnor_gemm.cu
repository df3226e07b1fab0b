// Packed xnor/popcount binary GEMM for Hopper (sm_90a), on the 1-bit
// tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_popcount.py
// (xnor_gemm_pallas, body _kernel).  Computes
//     out[b, p, n] = 2 * sum_k popc(~(a[b, p, k] ^ w[n, k])) - k_true
// for a (B, P, Kw) int32, w (N, Kw) int32 -> out (B, P, N) int32, bit-exact
// for any words (no tail-lane convention is assumed).
//
// The AND identity.  Per bit lane xnor(a, w) = 1 - a - w + 2 (a & w), so
// over the L = 32 Kw lanes of the real words
//     agree[r, n] = L - popc_a[r] - popc_w[n] + 2 sum popc(a[r] & w[n]).
// All three sums run on the tensor cores:
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (wgmma takes
// only .and for .b1, so the kernel uses the AND form throughout).  The
// row and neuron popcounts are products of the fragments already loaded
// from the staged tiles against an all-ones operand (one extra MMA per
// m-tile and per n-tile of a warp); the correction is applied in the
// epilogue.  Zero words padded onto K (up to a multiple of 32 words, one
// ring stage of four m16n8k256 k-steps) add nothing to any of the three
// sums, and L counts only the real words.
//
// The paper's X/Y/Z decomposition (paper §II-C): an aspect axis is a grid
// dimension (one block per image for X, per tile of p_blk windows for Y,
// per tile of n_blk neurons for Z); a non-aspect axis is a serial loop
// inside the block.  A block's rows are the (image, window) pairs it owns,
// image-major: all B images when X is not an aspect, all P windows or its
// p_blk of them by Y.  The block walks its rows x neurons in MMA block
// tiles, so an FC layer (P = 1) fills the 16-row fragment with images
// wherever X is serial.  One kernel gives all seven configurations,
// selected by `par_mask` (bit 0 X, bit 1 Y, bit 2 Z).
//
// What bounds it on an H100.  At the main path's shapes the int32
// outputs are about 80 % of the bytes and the 1-bit product is far below
// the tensor cores' rate (xnor_mma_probe_kernel measures that rate), so
// the least time is set by bytes; in practice a launch is bound by its
// latency: the start of the grid, and, in a block that walks tiles
// serially, the round trip of each chunk from memory and the few hundred
// dependent instructions of each step (one block of 8 warps runs one warp
// per scheduler).  What the design does about it:
//   * 8 warps, a block tile of 64 x 64 (each warp 32 x 16: 2 x 2 MMA
//     tiles) or, where a block owns at most 16 rows (X on an FC layer),
//     16 x 64 (each warp 16 x 8), so few rows are wasted;
//   * the reduction is staged in chunks of 32 words through a cp.async
//     ring of 4 stages (6 for the 16-row tile); the ring runs across the
//     block's serial tiles, so a layer with one chunk a tile (Kw = 9)
//     still overlaps the next tiles' loads with this tile's products and
//     stores.  Each thread copies 4 words of fixed rows (8 threads a row)
//     from row pointers set once a tile: no division or tile arithmetic
//     per copy.  A stage is always whole (zeros past Kw), so its four
//     k-steps are unrolled and their fragment loads issue ahead of the
//     products.  Rows are padded to 40 words, so the 64-bit fragment loads
//     are free of bank conflicts.  16-byte copies where Kw % 4 == 0 and
//     both operands are 16-byte aligned, else 4-byte copies (a row of
//     Kw = 9 starts only 4-byte aligned); ragged rows, neurons and padded
//     words are zero-filled with the src-size operand, and nothing past an
//     operand is read;
//   * the epilogue stages the output tile in shared memory and writes it
//     with 16-byte coalesced stores where N % 4 == 0 (a row of the tile is
//     256 contiguous bytes), scalar stores otherwise; ragged N is masked.
// The k-step's word order inside a fragment is permuted (thread t of a
// quad takes words 2t, 2t+1 of the 8 in the step, as a0/a2 and b0/b1):
// the same permutation on A and W leaves the sum unchanged and turns
// four 32-bit shared loads into two 64-bit ones.
//
// Tried and dropped, timed on an H100 SXM (700 W): the earlier scalar
// kernel (one __popc per word per output on the integer pipe, 16 per
// clock per SM, one-stage staging), slower at every shape, the FC layers
// under X included; 4 warps with each thread computing its copy addresses
// per word (a division per copy, about 0.2 us per copy of a thread at one
// warp per scheduler: 7 us a step at Kw = 9); popcounts from a pass over
// the staged rows, one thread per row (about 0.5 us a step).  A dependent
// BMMA takes about 25 cycles, so the products themselves cost little at
// these shapes.  Not used: the XOR form (.xor.popc), which wgmma lacks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 32;     // reduction words staged per ring stage
constexpr int kPitch = kChunk + 8;  // shared row pitch in words (== 8 mod 32)
constexpr int kTileCols = 64;
constexpr int kOutPitch = kTileCols + 8;
constexpr int kRowThreads = 8;  // threads copying one staged row, 4 words each
constexpr int kRowsPerPass = kThreads / kRowThreads;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += popc(a & b) over a 16 x 256 by 256 x 8 bit product
__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Warps WR x WC, each MT x NT MMA tiles (16 x 8 outputs each); a ring
// of ST stages.
template <int WR, int WC, int MT, int NT, int ST>
struct Tile {
  static constexpr int kStages = ST;
  static constexpr int kRows = WR * MT * 16;
  static constexpr int kCols = WC * NT * 8;
  static constexpr int kPasses =
      (kRows + kCols + kRowsPerPass - 1) / kRowsPerPass;
  static_assert(WR * WC * 32 == kThreads, "8 warps");
  static_assert(kCols == kTileCols, "64 neurons a tile");
  static_assert(kRows <= kThreads, "one thread per row of the tile");
  static constexpr int kSmemWords =
      kStages * (kRows + kCols) * kPitch + kRows * kOutPitch + kRows;
};

template <int WR, int WC, int MT, int NT, int ST, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
xnor_gemm_kernel(const int* __restrict__ a, const int* __restrict__ w,
                 int* __restrict__ out, int B, int P, int N, int Kw,
                 int k_true, int par_mask, int p_blk, int n_blk) {
  using T = Tile<WR, WC, MT, NT, ST>;
  constexpr int TM = T::kRows;
  constexpr int TN = T::kCols;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) int smem[];
  int* a_s = smem;                          // kStages x TM x kPitch
  int* w_s = a_s + kStages * TM * kPitch;   // kStages x TN x kPitch
  int* o_s = w_s + kStages * TN * kPitch;   // TM x kOutPitch
  int* row_s = o_s + TM * kOutPitch;        // global row of each tile row

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int grp = lane / 4, quad = lane % 4;
  const int wr = warp / WC, wc = warp % WC;

  // the block's share: aspect axes from blockIdx, the others whole
  const int p_tiles = (P + p_blk - 1) / p_blk;
  const int n_tiles = (N + n_blk - 1) / n_blk;
  int g = blockIdx.x;
  int b0 = 0, p0 = 0, pc = P, n0 = 0, nc = N, nb = B;
  if (par_mask & 1) { b0 = g % B; nb = 1; g /= B; }
  if (par_mask & 2) {
    p0 = (g % p_tiles) * p_blk;
    pc = min(p_blk, P - p0);
    g /= p_tiles;
  }
  if (par_mask & 4) { n0 = (g % n_tiles) * n_blk; nc = min(n_blk, N - n0); }
  const int rows = nb * pc;  // (image, window) pairs, image-major
  const int n_end = n0 + nc;
  const int col_tiles = (nc + TN - 1) / TN;
  const int chunks = max(1, (Kw + kChunk - 1) / kChunk);
  const int tiles = (rows + TM - 1) / TM * col_tiles;
  const int steps = tiles * chunks;
  // the global row (b * P + p) of the block's i-th row
  auto grow = [&](int i) { return (b0 + i / pc) * P + p0 + i % pc; };

  // The producer: thread tid copies words 4 (tid % 8) .. +3 of staged
  // rows tid / 8 + 32 q (A rows first, then W rows), from row pointers
  // set once a tile.  It runs kStages - 1 ring steps ahead.
  int ld_tile = 0, ld_chunk = 0;
  const int* src[T::kPasses];
  const int c4 = (tid % kRowThreads) * 4;
  auto load = [&](int st) {
    if (ld_chunk == 0) {
      const int r_base = ld_tile / col_tiles * TM;
      const int n_base = n0 + ld_tile % col_tiles * TN;
#pragma unroll
      for (int q = 0; q < T::kPasses; ++q) {
        const int r = tid / kRowThreads + q * kRowsPerPass;
        src[q] = nullptr;
        if (r < TM) {
          if (r_base + r < rows) src[q] = a + (size_t)grow(r_base + r) * Kw;
        } else if (r < TM + TN) {
          if (n_base + r - TM < n_end)
            src[q] = w + (size_t)(n_base + r - TM) * Kw;
        }
      }
    }
    // the whole stage is written: words past Kw are zero-filled
    const int k0 = ld_chunk * kChunk;
    const int kn = min(kChunk, Kw - k0);
#pragma unroll
    for (int q = 0; q < T::kPasses; ++q) {
      const int r = tid / kRowThreads + q * kRowsPerPass;
      if (r >= TM + TN) break;
      int* row = r < TM ? a_s + (st * TM + r) * kPitch
                        : w_s + (st * TN + r - TM) * kPitch;
      const uint32_t dst = smem_addr(row + c4);
      if (kVec) {
        const bool in = src[q] != nullptr && c4 < kn;
        cp_async16(dst, in ? src[q] + k0 + c4 : a, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = src[q] != nullptr && c4 + e < kn;
          cp_async4(dst + 4 * e, in ? src[q] + k0 + c4 + e : a, in ? 4 : 0);
        }
      }
    }
    if (++ld_chunk == chunks) { ld_chunk = 0; ++ld_tile; }
  };

  // sum popc(a & w), and the row and neuron popcounts as products against
  // an all-ones operand: pa[i][2h] is popc_a of row grp + 8h of m-tile i,
  // pw[j][e] popc_w of neuron 2 quad + e of n-tile j
  int acc[MT][NT][4], pa[MT][4], pw[NT][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      pa[i][e] = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][e] = 0;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) pw[j][e] = 0;
  }
  const uint32_t ones_a[4] = {~0u, ~0u, ~0u, ~0u};
  const uint32_t ones_b[2] = {~0u, ~0u};
  const int L = 32 * Kw;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  int tile = 0, kc = 0;  // the consumer's tile and chunk
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step landed; the previous stage is free
    if (step + kStages - 1 < steps) load((step + kStages - 1) % kStages);
    cp_async_commit();

    // all k-steps of the stage (zeros past Kw add nothing), unrolled so
    // that the fragment loads of every step issue ahead of the products
    const int st = step % kStages;
    const int* as = a_s + st * TM * kPitch;
    const int* ws = w_s + st * TN * kPitch;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = (wr * MT + i) * 16 + grp;
        const uint2 lo = *reinterpret_cast<const uint2*>(
            as + r * kPitch + ks * 8 + 2 * quad);
        const uint2 hi = *reinterpret_cast<const uint2*>(
            as + (r + 8) * kPitch + ks * 8 + 2 * quad);
        af[i][0] = lo.x;
        af[i][1] = hi.x;
        af[i][2] = lo.y;
        af[i][3] = hi.y;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = (wc * NT + j) * 8 + grp;
        const uint2 v = *reinterpret_cast<const uint2*>(
            ws + n * kPitch + ks * 8 + 2 * quad);
        bf[j][0] = v.x;
        bf[j][1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_b1(pa[i], af[i], ones_b);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_b1(acc[i][j], af[i], bf[j]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_b1(pw[j], ones_a, bf[j]);
    }
    if (++kc != chunks) continue;
    kc = 0;

    // epilogue of the tile: correct, stage in shared memory, store
    const int r_base = tile / col_tiles * TM;
    const int n_base = n0 + tile % col_tiles * TN;
    ++tile;
    if (tid < TM) row_s[tid] = r_base + tid < rows ? grow(r_base + tid) : -1;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = (wr * MT + i) * 16 + grp;
        const int c = (wc * NT + j) * 8 + 2 * quad;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int base = L - pa[i][2 * h];
          int2 v;
          v.x = 2 * (base - pw[j][0] + 2 * acc[i][j][2 * h]) - k_true;
          v.y = 2 * (base - pw[j][1] + 2 * acc[i][j][2 * h + 1]) - k_true;
          *reinterpret_cast<int2*>(o_s + (r + 8 * h) * kOutPitch + c) = v;
          acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0;
        }
      }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int i = 0; i < MT; ++i) pa[i][e] = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) pw[j][e] = 0;
    }
    __syncthreads();
    const bool vec_out = !(N & 3) && !(n0 & 3) && !(nc & 3);
    const int c = (tid % (TN / 4)) * 4;
    const int n = n_base + c;
#pragma unroll
    for (int r = tid / (TN / 4); r < TM; r += kThreads / (TN / 4)) {
      const int gr = row_s[r];
      if (gr < 0 || n >= n_end) continue;
      int* dst = out + (size_t)gr * N + n;
      const int4 v = *reinterpret_cast<const int4*>(o_s + r * kOutPitch + c);
      if (vec_out) {  // all four in range and 16-byte aligned
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (n + 1 < n_end) dst[1] = v.y;
        if (n + 2 < n_end) dst[2] = v.z;
        if (n + 3 < n_end) dst[3] = v.w;
      }
    }
  }
  cp_async_wait<0>();
}

template <int WR, int WC, int MT, int NT, int ST, bool kVec>
int launch(const int* a, const int* w, int* out, int B, int P, int N, int Kw,
           int k_true, int par_mask, int p_blk, int n_blk, unsigned grid,
           cudaStream_t stream) {
  auto kernel = xnor_gemm_kernel<WR, WC, MT, NT, ST, kVec>;
  constexpr int bytes = 4 * Tile<WR, WC, MT, NT, ST>::kSmemWords;
  // the opt-in above 48 KB, once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a, w, out, B, P, N, Kw, k_true,
                                            par_mask, p_blk, n_blk);
  return (int)cudaGetLastError();
}

// A measure of the 1-bit tensor-core rate: every warp issues `iters` x 8
// independent m16n8k256 AND/popc products on register fragments.
__global__ void __launch_bounds__(256)
xnor_mma_probe_kernel(int* out, int iters) {
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;
  const uint32_t a[4] = {x, ~x, x * 3u, x ^ 0x5a5a5a5au};
  const uint32_t b[2] = {x ^ 0x33333333u, x + 7u};
  int acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(acc[j], a, b);
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// tile: 0 -> 64 x 64 block tile, 1 -> 16 x 64 (a block owning <= 16 rows);
// vec: 16-byte copies (Kw % 4 == 0 and 16-byte aligned operands)
extern "C" int xnor_gemm_launch(const int* a, const int* w, int* out, int B,
                                int P, int N, int Kw, int k_true,
                                int par_mask, int p_blk, int n_blk, int tile,
                                int vec, void* stream) {
  if (p_blk <= 0 || n_blk <= 0 || B <= 0 || P <= 0 || N <= 0 || Kw < 0 ||
      (par_mask & ~7) || !par_mask || (tile != 0 && tile != 1))
    return (int)cudaErrorInvalidValue;
  if (vec && ((Kw & 3) || (reinterpret_cast<uintptr_t>(a) & 15) ||
              (reinterpret_cast<uintptr_t>(w) & 15)))
    return (int)cudaErrorMisalignedAddress;
  const long long p_tiles = (P + p_blk - 1) / p_blk;
  const long long n_tiles = (N + n_blk - 1) / n_blk;
  long long grid = 1;
  if (par_mask & 1) grid *= B;
  if (par_mask & 2) grid *= p_tiles;
  if (par_mask & 4) grid *= n_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = (unsigned)grid;
  if (tile == 0)
    return vec ? launch<2, 4, 2, 2, 4, true>(a, w, out, B, P, N, Kw, k_true,
                                          par_mask, p_blk, n_blk, g, s)
               : launch<2, 4, 2, 2, 4, false>(a, w, out, B, P, N, Kw, k_true,
                                           par_mask, p_blk, n_blk, g, s);
  return vec ? launch<1, 8, 1, 1, 6, true>(a, w, out, B, P, N, Kw, k_true,
                                        par_mask, p_blk, n_blk, g, s)
             : launch<1, 8, 1, 1, 6, false>(a, w, out, B, P, N, Kw, k_true,
                                         par_mask, p_blk, n_blk, g, s);
}

extern "C" int xnor_mma_probe_launch(int* out, int blocks, int iters,
                                     void* stream) {
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  xnor_mma_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" const char* xnor_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
