// Packed xnor/popcount binary GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/xnor_popcount.py
// (xnor_gemm_pallas, body _kernel).  Computes
//     out[b, p, n] = 2 * sum_k popc(~(a[b, p, k] ^ w[n, k])) - k_true
// for a (B, P, Kw) int32, w (N, Kw) int32 -> out (B, P, N) int32.
//
// The paper's CUDA decomposition of the X/Y/Z aspects: an aspect axis is
// a grid dimension (one block per image for X, per window tile for Y,
// per neuron tile for Z); a non-aspect axis is a serial loop inside the
// block.  One kernel therefore gives all seven parallel configurations,
// selected by `par_mask` (bit 0 X, bit 1 Y, bit 2 Z).
//
// Inside a (p_blk x n_blk) tile, 256 threads form a 16 x 16 grid; thread
// (ty, tx) owns outputs (ty + 16 i, tx + 16 j), i < p_blk/16, j < n_blk/16,
// with the sums in registers.  The activation and weight tiles are staged
// through shared memory in chunks of KC words of the reduction axis
// (2 x 64 x 33 words = 16.9 KB, under the 48 KB static limit).  Ragged P
// and N are masked on the store; a Kw tail needs no mask because the
// packing convention (activation tail bit 0, weight tail bit 1) makes
// every tail lane's xnor 0.
//
// What bounds it on an H100: each word of the reduction costs one xor,
// one not, one popc and one add per output; POPC issues at 16 per clock
// per SM on compute capability 9.0 (a quarter of the 32-bit logic rate),
// so the integer pipe, not HBM, bounds every main-path layer at the
// batch sizes served (word-ops / (132 SMs * 16 * clock)).  The tile
// staging keeps global reads to one pass over each operand per tile.
// Speed beyond that (tensor-core b1 MMA, larger register tiles) is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;   // threads per tile side
constexpr int kMaxBlk = 64; // p_blk, n_blk <= 64, multiples of 16
constexpr int kMaxSub = kMaxBlk / kGrid;
constexpr int kChunk = 32;  // reduction words staged per pass

__global__ void __launch_bounds__(kThreads)
xnor_gemm_kernel(const int* __restrict__ a, const int* __restrict__ w,
                 int* __restrict__ out, int B, int P, int N, int Kw,
                 int k_true, int par_mask, int p_blk, int n_blk) {
  __shared__ int as[kMaxBlk][kChunk + 1];
  __shared__ int ws[kMaxBlk][kChunk + 1];

  const int tid = threadIdx.x;
  const int tx = tid % kGrid;
  const int ty = tid / kGrid;
  const int p_tiles = (P + p_blk - 1) / p_blk;
  const int n_tiles = (N + n_blk - 1) / n_blk;
  const int mi = p_blk / kGrid;
  const int mj = n_blk / kGrid;

  // decode the aspect (grid) coordinates; non-aspect axes span all
  int g = blockIdx.x;
  int b0 = 0, b1 = B, pt0 = 0, pt1 = p_tiles, nt0 = 0, nt1 = n_tiles;
  if (par_mask & 1) { b0 = g % B; b1 = b0 + 1; g /= B; }
  if (par_mask & 2) { pt0 = g % p_tiles; pt1 = pt0 + 1; g /= p_tiles; }
  if (par_mask & 4) { nt0 = g % n_tiles; nt1 = nt0 + 1; }

  for (int b = b0; b < b1; ++b) {
    const int* a_b = a + (size_t)b * P * Kw;
    int* out_b = out + (size_t)b * P * N;
    for (int pt = pt0; pt < pt1; ++pt) {
      const int p_base = pt * p_blk;
      for (int nt = nt0; nt < nt1; ++nt) {
        const int n_base = nt * n_blk;
        int acc[kMaxSub][kMaxSub];
#pragma unroll
        for (int i = 0; i < kMaxSub; ++i)
#pragma unroll
          for (int j = 0; j < kMaxSub; ++j) acc[i][j] = 0;

        for (int k0 = 0; k0 < Kw; k0 += kChunk) {
          const int kc = min(kChunk, Kw - k0);
          __syncthreads();  // previous chunk fully consumed
          for (int idx = tid; idx < p_blk * kChunk; idx += kThreads) {
            const int r = idx / kChunk, c = idx % kChunk;
            const int p = p_base + r;
            as[r][c] = (p < P && c < kc) ? a_b[(size_t)p * Kw + k0 + c] : 0;
          }
          for (int idx = tid; idx < n_blk * kChunk; idx += kThreads) {
            const int r = idx / kChunk, c = idx % kChunk;
            const int n = n_base + r;
            ws[r][c] = (n < N && c < kc) ? w[(size_t)n * Kw + k0 + c] : 0;
          }
          __syncthreads();
          for (int c = 0; c < kc; ++c) {
            int wv[kMaxSub];
#pragma unroll
            for (int j = 0; j < kMaxSub; ++j)
              wv[j] = j < mj ? ws[tx + kGrid * j][c] : 0;
#pragma unroll
            for (int i = 0; i < kMaxSub; ++i) {
              if (i >= mi) break;
              const int av = as[ty + kGrid * i][c];
#pragma unroll
              for (int j = 0; j < kMaxSub; ++j)
                if (j < mj) acc[i][j] += __popc(~(av ^ wv[j]));
            }
          }
        }

#pragma unroll
        for (int i = 0; i < kMaxSub; ++i) {
          const int p = p_base + ty + kGrid * i;
          if (i >= mi || p >= P) continue;
#pragma unroll
          for (int j = 0; j < kMaxSub; ++j) {
            const int n = n_base + tx + kGrid * j;
            if (j < mj && n < N)
              out_b[(size_t)p * N + n] = 2 * acc[i][j] - k_true;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int xnor_gemm_launch(const int* a, const int* w, int* out, int B,
                                int P, int N, int Kw, int k_true,
                                int par_mask, int p_blk, int n_blk,
                                void* stream) {
  if (p_blk <= 0 || p_blk > kMaxBlk || p_blk % kGrid ||
      n_blk <= 0 || n_blk > kMaxBlk || n_blk % kGrid)
    return (int)cudaErrorInvalidValue;
  const long long p_tiles = (P + p_blk - 1) / p_blk;
  const long long n_tiles = (N + n_blk - 1) / n_blk;
  long long grid = 1;
  if (par_mask & 1) grid *= B;
  if (par_mask & 2) grid *= p_tiles;
  if (par_mask & 4) grid *= n_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  xnor_gemm_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, w, out, B, P, N, Kw, k_true, par_mask, p_blk, n_blk);
  return (int)cudaGetLastError();
}

extern "C" const char* xnor_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
