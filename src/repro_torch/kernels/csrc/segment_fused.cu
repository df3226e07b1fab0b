// A whole device segment of a packed BNN in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_fused.py
// (build_pallas_segment, body _segment_kernel): the layer chain
// conv (3x3 SAME patch gather + xnor GEMM), 2x2 max-pool, step (integer
// threshold + bit-plane repack), flatten and fc.
//
// Design.  One persistent cooperative launch: as many 256-thread blocks
// as the card holds at once (occupancy x SMs, capped at the largest
// layer's tile count), and the whole batch moves through the net layer
// by layer, a grid-wide barrier (cooperative_groups grid sync) between
// layers.  The Pallas grid gave each example to one program; on an
// H100 that kept B of 132 SMs busy, one at batch 1.  Here each layer's
// outputs over all B examples, (B x rows) x cols, are cut into tiles of
// a few rows x a multiple of 32 channels, and the blocks stride over
// the tiles.  The tile shape of each layer is in the descriptor table
// that the Python wrapper builds (segment_fused.py, _Lowered), so the
// split is checked on the CPU; only the grid size comes from the card.
//
// A conv/fc tile stages its weight slab (Kw x 32k words, from weights
// transposed to (Kw, N)) and its patch rows (the 3x3 windows its output
// rows read, gathered like an im2col) in shared memory, every copy of
// the tile in flight at once, then computes from shared memory: one
// warp per output row, lane l owning channels c0 + l + 32 q.  Interior
// activations live in two global ping-pong buffers sized for B
// examples (small, they stay in L2) and are read with ld.global.cg: a
// buffer is rewritten two layers later, and an SM's L1 could still
// hold the old words.  The epilogues stay fused: a conv followed by a
// max-pool computes each pooled output directly (max over its four conv
// outputs, accumulated together so each weight word read from shared
// memory feeds four popcounts), and a conv or fc followed by a step
// thresholds in registers
// and repacks with one __ballot_sync per 32 consecutive channels (lane
// l -> bit l), so the unpacked pre-activation never reaches memory.
//
// What bounds it on an H100: the popc rate (16 per clock per SM, compute
// capability 9.0), about 240 M word-ops for CIFAR-10 at batch 16; at
// small batches the layers have fewer tiles than the card has blocks,
// and each tile's latency (one round of copies, two block barriers)
// and the grid barriers, one per layer boundary, set the time.  A 1-bit
// tensor-core product (mma .b1 xor.popc) would move that bound; it is
// an open question, not this kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// descriptor layout, kDesc ints per op (mirrors segment_fused.py)
enum OpKind { kConv = 0, kFc = 1, kPool = 2, kStep = 3, kCopy = 4 };
enum Buf { kIn = 0, kOut = 1, kS0 = 2, kS1 = 3 };
enum Field {
  fKind = 0, fSrc, fDst, fH, fW, fC, fN, fKTrue, fPool, fStep,
  fWOff, fTOff, fFOff, fRows, fCols, fTileR, fTileC, kDesc
};

// rows [r0, r1) of the layer's (B x rows) outputs, columns [c0, c1)
struct Tile {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ bool fire(int v, const int* t, const int* f,
                                     int c) {
  return (v > t[c]) != (f[c] != 0);
}

// conv [+ 2x2 max-pool] [+ step] or fc [+ step] over one tile: rows
// [r0, r1) of the (B x rows) outputs by 32 R channels.  conv: src (H, W,
// Cw) words per example, output rows are the (pooled) pixels; fc: src
// (Cw) words, one row per example.  dst (rows, N) int32, or (rows, N/32)
// words when the step is fused (N % 32 R == 0, so every lane's channel
// exists).  The tile stages two things in shared memory, all copies in
// flight at once: the weight slab w_s (Kw x 32 R, word k of the tile's
// channel j at w_s[k * 32 R + j]) and its patch rows a_s (for each row
// and pooling position, the Kw = taps x Cw words its 3x3 window reads,
// 0 outside the image).  Then warp w computes rows w, w + 8, ..., lane
// l channels c0 + l + 32 q: patch words are broadcast, slab words
// conflict-free, and the NPOS = 4 pooling positions of a row share each
// slab word read.  VEC = 4 moves words 16 bytes at a time (Cw % 4 == 0).
template <int R, int VEC, int NPOS>
__device__ void gemm_tile(const int* d, const int* src, long long sstr,
                          int* dst, long long dstr,
                          const int* __restrict__ params, int* smem,
                          const Tile& tl) {
  constexpr int kTc = 32 * R;
  constexpr int ps = NPOS == 4 ? 2 : 1;   // pooling window side
  const bool conv = d[fKind] == kConv;
  const int H = d[fH], W = d[fW], Cw = d[fC], N = d[fN];
  const int k_true = d[fKTrue], step = d[fStep];
  const int rows = d[fRows];
  const int taps = conv ? 9 : 1;
  const int Kw = taps * Cw;
  const int Wo = conv ? W / ps : 1;
  const int n_rows = tl.r1 - tl.r0;
  const int* wt = params + d[fWOff];
  const int* t = params + d[fTOff];
  const int* f = params + d[fFOff];
  int* w_s = smem;                 // [Kw][kTc]
  int* a_s = smem + Kw * kTc;      // [n_rows][NPOS][Kw]

  __syncthreads();   // the previous tile's w_s and a_s are no longer read
  for (int i = threadIdx.x; i < Kw * kTc; i += kThreads) {
    const int k = i / kTc;
    const int n = tl.c0 + (i - k * kTc);
    w_s[i] = n < tl.c1 ? __ldg(wt + (size_t)k * N + n) : 0;
  }
  const int n_chunk = Cw / VEC;
  for (int i = threadIdx.x; i < n_rows * NPOS * taps * n_chunk;
       i += kThreads) {
    const int cc = i % n_chunk;
    int slot = i / n_chunk;
    const int tap = slot % taps;
    slot /= taps;
    const int pos = slot % NPOS;
    const int j = slot / NPOS;
    const int r = tl.r0 + j;
    const int b = r / rows;
    const int p = r - b * rows;
    const int* s = src + b * sstr + cc * VEC;
    bool inside = true;
    if (conv) {
      const int oy = p / Wo, ox = p - (p / Wo) * Wo;
      const int y = oy * ps + pos / ps + tap / 3 - 1;
      const int x = ox * ps + pos % ps + tap % 3 - 1;
      inside = y >= 0 && y < H && x >= 0 && x < W;
      if (inside) s += ((size_t)y * W + x) * Cw;
    }
    int* a = a_s + (j * NPOS + pos) * Kw + tap * Cw + cc * VEC;
    if constexpr (VEC == 4)
      *reinterpret_cast<int4*>(a) =
          inside ? __ldcg(reinterpret_cast<const int4*>(s))
                 : make_int4(0, 0, 0, 0);
    else
      *a = inside ? __ldcg(s) : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int* wl = w_s + lane;
  for (int j = warp; j < n_rows; j += kWarps) {   // warp-uniform
    const int r = tl.r0 + j;
    const int b = r / rows;
    const int p = r - b * rows;
    const int* a = a_s + j * NPOS * Kw;   // position p's words at p * Kw
    int agree[NPOS][R] = {};
    if constexpr (VEC == 4) {
#pragma unroll 2
      for (int k = 0; k < Kw; k += 4) {
        int av[NPOS][4];
#pragma unroll
        for (int x = 0; x < NPOS; ++x) {
          const int4 v = *reinterpret_cast<const int4*>(a + x * Kw + k);
          av[x][0] = v.x; av[x][1] = v.y; av[x][2] = v.z; av[x][3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int w = wl[(k + e) * kTc + 32 * q];
#pragma unroll
            for (int x = 0; x < NPOS; ++x)
              agree[x][q] += __popc(~(av[x][e] ^ w));
          }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < Kw; ++k) {
        int av[NPOS];
#pragma unroll
        for (int x = 0; x < NPOS; ++x) av[x] = a[x * Kw + k];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int w = wl[k * kTc + 32 * q];
#pragma unroll
          for (int x = 0; x < NPOS; ++x) agree[x][q] += __popc(~(av[x] ^ w));
        }
      }
    }
    int best[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      best[q] = 2 * agree[0][q] - k_true;
#pragma unroll
      for (int x = 1; x < NPOS; ++x)
        best[q] = max(best[q], 2 * agree[x][q] - k_true);
    }
    int* dst_b = dst + b * dstr;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int n = tl.c0 + lane + 32 * q;
      if (step) {
        const unsigned bits = __ballot_sync(0xffffffffu, fire(best[q], t, f, n));
        if (lane == 0) dst_b[(size_t)p * (N / 32) + n / 32] = (int)bits;
      } else if (n < tl.c1) {
        dst_b[(size_t)p * N + n] = best[q];
      }
    }
  }
}

// the tile's channel width (32 R), word width (VEC) and pooling
// positions (NPOS) as template arguments
template <int R>
__device__ void gemm_dispatch_r(const int* d, const int* src,
                                long long sstr, int* dst, long long dstr,
                                const int* __restrict__ params, int* smem,
                                const Tile& tl) {
  const bool vec4 = (d[fC] & 3) == 0;
  const bool pool = d[fKind] == kConv && d[fPool];
  if (vec4 && pool)
    gemm_tile<R, 4, 4>(d, src, sstr, dst, dstr, params, smem, tl);
  else if (vec4)
    gemm_tile<R, 4, 1>(d, src, sstr, dst, dstr, params, smem, tl);
  else if (pool)
    gemm_tile<R, 1, 4>(d, src, sstr, dst, dstr, params, smem, tl);
  else
    gemm_tile<R, 1, 1>(d, src, sstr, dst, dstr, params, smem, tl);
}

__device__ void gemm_dispatch(const int* d, const int* src, long long sstr,
                              int* dst, long long dstr,
                              const int* __restrict__ params, int* smem,
                              const Tile& tl) {
  switch (d[fTileC]) {
    case 32: gemm_dispatch_r<1>(d, src, sstr, dst, dstr, params, smem, tl); break;
    case 64: gemm_dispatch_r<2>(d, src, sstr, dst, dstr, params, smem, tl); break;
    default: gemm_dispatch_r<4>(d, src, sstr, dst, dstr, params, smem, tl); break;
  }
}

// 2x2/2 max-pool over int32 elements: src (H, W, C) -> (H/2, W/2, C)
__device__ void pool_tile(const int* d, const int* src, long long sstr,
                          int* dst, long long dstr, const Tile& tl) {
  const int W = d[fW], C = d[fC], rows = d[fRows], Wo = W / 2;
  const int nc = tl.c1 - tl.c0;
  for (int i = threadIdx.x; i < (tl.r1 - tl.r0) * nc; i += kThreads) {
    const int r = tl.r0 + i / nc, c = tl.c0 + i % nc;
    const int b = r / rows, p = r - b * rows;
    const int y = 2 * (p / Wo), x = 2 * (p % Wo);
    const int* s = src + b * sstr + ((size_t)y * W + x) * C + c;
    const int row = W * C;
    dst[b * dstr + (size_t)p * C + c] =
        max(max(__ldcg(s), __ldcg(s + C)),
            max(__ldcg(s + row), __ldcg(s + row + C)));
  }
}

// step: src (rows, C) int32 -> (rows, ceil(C/32)) words, tail bits 0
__device__ void step_tile(const int* d, const int* src, long long sstr,
                          int* dst, long long dstr, const int* t,
                          const int* f, const Tile& tl) {
  const int C = d[fC], rows = d[fRows], Cw = d[fCols];
  const int nc = tl.c1 - tl.c0;
  for (int i = threadIdx.x; i < (tl.r1 - tl.r0) * nc; i += kThreads) {
    const int r = tl.r0 + i / nc, wd = tl.c0 + i % nc;
    const int b = r / rows, p = r - b * rows;
    const int* s = src + b * sstr + (size_t)p * C;
    unsigned bits = 0;
    for (int l = 0; l < 32; ++l) {
      const int c = wd * 32 + l;
      if (c < C && fire(__ldcg(s + c), t, f, c)) bits |= 1u << l;
    }
    dst[b * dstr + (size_t)p * Cw + wd] = (int)bits;
  }
}

// copy (a flatten-only segment): one row of C elements per example
__device__ void copy_tile(const int* src, long long sstr, int* dst,
                          long long dstr, const Tile& tl) {
  const int nc = tl.c1 - tl.c0;
  for (int i = threadIdx.x; i < (tl.r1 - tl.r0) * nc; i += kThreads) {
    const int b = tl.r0 + i / nc, c = tl.c0 + i % nc;
    dst[b * dstr + c] = __ldcg(src + b * sstr + c);
  }
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(const int* x, int* out, int* scratch,
               const int* __restrict__ params, const int* __restrict__ desc,
               int n_ops, int B, int in_stride, int out_stride,
               int scratch_stride) {
  extern __shared__ int4 smem_raw[];   // 16-byte aligned
  int* smem = reinterpret_cast<int*>(smem_raw);
  cg::grid_group grid = cg::this_grid();
  int* s0 = scratch;
  int* s1 = scratch + (size_t)B * scratch_stride;
  for (int o = 0; o < n_ops; ++o) {
    const int* d = desc + o * kDesc;
    const int* src = d[fSrc] == kIn ? x : (d[fSrc] == kS0 ? s0 : s1);
    const long long sstr = d[fSrc] == kIn ? in_stride : scratch_stride;
    int* dst = d[fDst] == kOut ? out : (d[fDst] == kS0 ? s0 : s1);
    const long long dstr = d[fDst] == kOut ? out_stride : scratch_stride;
    const int n_rows = B * d[fRows];
    const int tile_r = d[fTileR], tile_c = d[fTileC];
    const int n_ct = (d[fCols] + tile_c - 1) / tile_c;
    const int n_tiles = (n_rows + tile_r - 1) / tile_r * n_ct;
    // tile -> (row tile, column tile), columns fastest; _Lowered.tiles
    // enumerates the same order
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int rt = tile / n_ct, ct = tile - rt * n_ct;
      Tile tl;
      tl.r0 = rt * tile_r;
      tl.r1 = min(tl.r0 + tile_r, n_rows);
      tl.c0 = ct * tile_c;
      tl.c1 = min(tl.c0 + tile_c, d[fCols]);
      switch (d[fKind]) {
        case kConv:
        case kFc:
          gemm_dispatch(d, src, sstr, dst, dstr, params, smem, tl);
          break;
        case kPool:
          pool_tile(d, src, sstr, dst, dstr, tl);
          break;
        case kStep:
          step_tile(d, src, sstr, dst, dstr, params + d[fTOff],
                    params + d[fFOff], tl);
          break;
        default:
          copy_tile(src, sstr, dst, dstr, tl);
          break;
      }
    }
    if (o + 1 < n_ops) grid.sync();   // the layer is complete everywhere
  }
}

// blocks of segment_kernel the card holds at once with `smem` bytes of
// shared memory each; cached per size (a process here drives one card)
cudaError_t resident_blocks(int smem, int* blocks) {
  static int n_sm = 0, coop = 0, attr = 48 * 1024, last_smem = -1, last = 0;
  cudaError_t e;
  if (n_sm == 0) {
    int dev;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
  }
  if (!coop) return cudaErrorNotSupported;
  if (smem > attr) {
    if ((e = cudaFuncSetAttribute(
             segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) != cudaSuccess)
      return e;
    attr = smem;
  }
  if (smem != last_smem) {
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, segment_kernel, kThreads, smem)) != cudaSuccess)
      return e;
    last = per_sm * n_sm;
    last_smem = smem;
  }
  *blocks = last;
  return cudaSuccess;
}

}  // namespace

// Launches the segment over B examples: scratch holds 2 B scratch_stride
// words, desc n_ops rows of kDesc ints, max_tiles is the largest layer's
// tile count at this B, smem the largest weight slab in bytes.  Writes
// the grid size to *grid.  Refuses (returns an error) where no block of
// the kernel can be resident: a cooperative launch cannot be split.
extern "C" int segment_fused_launch(const int* x, int* out, int* scratch,
                                    const int* params, const int* desc,
                                    int n_ops, int B, int in_stride,
                                    int out_stride, int scratch_stride,
                                    int max_tiles, int smem, int* grid,
                                    void* stream) {
  int blocks = 0;
  cudaError_t e = resident_blocks(smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = max(1, min(blocks, max_tiles));
  void* args[] = {(void*)&x,        (void*)&out,       (void*)&scratch,
                  (void*)&params,   (void*)&desc,      (void*)&n_ops,
                  (void*)&B,        (void*)&in_stride, (void*)&out_stride,
                  (void*)&scratch_stride};
  e = cudaLaunchCooperativeKernel((const void*)segment_kernel, dim3(*grid),
                                  dim3(kThreads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* segment_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
