// The float side of a Bi-Real unit (Liu et al., ECCV 2018) around kernel 1
// (xnor_gemm.cu), for Hopper (sm_90a): one pass in, one pass out.
//
// Replaces no TPU kernel: the JAX package has no Bi-Real Net.  On the card
// the unit's float side was a chain of plain PyTorch launches around kernel
// 1 (the sign, its int64 pack and sum, the pad, nine slices and a cat, the
// correction's add, the cast, addcmul and the shortcut's add_), each taking
// its operand from device memory and putting its result back.  These two
// kernels do the same work, to the bit, in one read of each operand and one
// write of each result.
//
// bireal_patches_kernel: float32 x (B, H, W, C) NHWC -> kernel 1's operand
//     a (B, Ho * Wo, 9 * Cw) int32, Cw = ceil(C / 32), tap-major: word
//     (dy * 3 + dx) * Cw + w of output pixel (oy, ox) holds input pixel
//     (oy * stride - 1 + dy, ox * stride - 1 + dx); bit i of word w is
//     channel 32 w + i, set where x >= 0 (-0.0 sets it, NaN does not);
//     spatial pad words and a tail word's lanes past C are 0.
// bireal_epilogue_kernel: kernel 1's acc (B, P, N) int32, the padding
//     correction corr (P, N) int32, the folded per-channel scale and shift
//     (N) float32 and the shortcut res (B, P, N) float32 (the unit's input,
//     or its projection) -> y = scale * float(acc + corr) + shift + res,
//     float32, rounded as PyTorch rounds torch.addcmul(shift, s, scale)
//     then .add_(res) on the card (see EPILOGUE below).
//
// What bounds them on an H100: bytes.  Per image of Bi-Real Net-18 at
// 224 x 224 the 16 units read their float32 inputs once (12.4 MB), write
// 0.9 MB of sign words, and read acc and res and write y (11.6 MB): about
// 26 MB, 7.9 us at 3.35 TB/s; the arithmetic is a few integer operations a
// byte.  What the designs do about it:
//   * the prologue gives each block one image and a band of output rows.
//     The band's input rows are one contiguous run of memory; where C is a
//     multiple of 32 the block reads it as float4s (four loads in flight a
//     thread, few instructions a byte: a warp reading one word's 32 floats
//     a load spent its time on index arithmetic, not on memory), and 8
//     lanes OR their nibbles into one word with three shuffles; else a warp
//     reads a word's 32 channels and __ballot_sync packs them.  Each float
//     of the band and its halo rows is read once; the band's words sit in
//     shared memory, from which every output pixel's 9 taps are written
//     with coalesced 4 B stores through a per-word offset table, without a
//     division per word.  Bands are sized in the wrapper so that a launch
//     has about 4 blocks an SM; the halo rows that neighbouring bands both
//     read come mostly from L2.
//   * the epilogue is one thread per 4 outputs (16 B loads and stores where
//     N % 4 == 0 and every operand is 16 B aligned), corr, scale and shift
//     read through the read-only path (they are small and shared by every
//     image).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // loads in flight a thread

// kWide (C % 32 == 0, x 16 B aligned): the band's rows inside the image
// are one contiguous run of floats, read as float4s; 8 lanes hold a word's
// 32 channels, and three xor-shuffles OR their nibbles into it.  Else one
// warp reads the 32 channels of a word and __ballot_sync packs them.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
bireal_patches_kernel(const float* __restrict__ x, int* __restrict__ out,
                      int H, int W, int C, int Cw, int Ho, int Wo, int stride,
                      int band_rows) {
  extern __shared__ int smem[];
  const int Wp = W + 2;                 // padded columns
  const int K9 = 9 * Cw;
  int* off = smem;                      // word k -> its offset in a window
  int* sign = smem + K9;                // the band's padded sign words
  const int b = blockIdx.y;
  const int oy0 = blockIdx.x * band_rows;
  const int rows = min(band_rows, Ho - oy0);
  const int rows_in = (rows - 1) * stride + 3;
  const int iy0 = oy0 * stride - 1;     // input row of padded row 0
  const float* xb = x + (size_t)b * H * W * C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int k = threadIdx.x; k < K9; k += kThreads) {
    const int tap = k / Cw;
    const int dy = tap / 3;
    off[k] = (dy * Wp + tap - 3 * dy) * Cw + k - tap * Cw;
  }
  // 1. sign words of padded rows [0, rows_in) x columns [0, Wp), word
  // (ry * Wp + px) * Cw + w
  const int n_words = rows_in * Wp * Cw;
  if constexpr (kWide) {
    for (int i = threadIdx.x; i < n_words; i += kThreads) sign[i] = 0;
    __syncthreads();
    const int r_lo = max(iy0, 0);
    const int n4 = (min(iy0 + rows_in, H) - r_lo) * W * C / 4;
    const float4* src =
        reinterpret_cast<const float4*>(xb + (size_t)r_lo * W * C);
    const int row_words = W * Cw;
    const int at = ((r_lo - iy0) * Wp + 1) * Cw;  // the run's first word
    for (int f0 = threadIdx.x - lane; f0 < n4; f0 += kThreads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int f = f0 + u * kThreads + lane;
        v[u] = f < n4 ? __ldg(src + f) : make_float4(-1.f, -1.f, -1.f, -1.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned word = ((v[u].x >= 0.0f) | (v[u].y >= 0.0f) << 1 |
                         (v[u].z >= 0.0f) << 2 | (v[u].w >= 0.0f) << 3)
                        << (4 * (lane & 7));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        const int f = f0 + u * kThreads + lane;
        if ((lane & 7) == 0 && f < n4) {
          const int wi = f >> 3;        // word of the run
          sign[at + wi + wi / row_words * 2 * Cw] = (int)word;
        }
      }
    }
  } else {
    for (int base = warp; base < n_words; base += kWarps * 8) {
      float v[8];
      bool in[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int item = base + u * kWarps;
        const int pix = item / Cw;
        const int w = item - pix * Cw;
        const int ry = pix / Wp;
        const int ix = pix - ry * Wp - 1;
        const int iy = iy0 + ry;
        const int c = w * 32 + lane;
        in[u] = item < n_words && iy >= 0 && iy < H && ix >= 0 && ix < W &&
                c < C;
        v[u] = in[u] ? __ldg(xb + ((size_t)iy * W + ix) * C + c) : -1.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int item = base + u * kWarps;
        const unsigned word =
            __ballot_sync(0xffffffffu, in[u] && v[u] >= 0.0f);
        if (lane == 0 && item < n_words) sign[item] = (int)word;
      }
    }
  }
  __syncthreads();
  // 2. the band's output rows, (pixel, word) in memory order; each thread
  // steps its (pixel row, pixel column, word) by kThreads words at a time
  const int n_out = rows * Wo * K9;
  int* ob = out + ((size_t)b * Ho + oy0) * Wo * K9;
  const int dq = kThreads / K9, dk = kThreads - dq * K9;
  const int dly = dq / Wo, dox = dq - dly * Wo;
  int q = threadIdx.x / K9, k = threadIdx.x - q * K9;
  int ly = q / Wo, ox = q - ly * Wo;
  for (int e = threadIdx.x; e < n_out; e += kThreads) {
    ob[e] = sign[(ly * stride * Wp + ox * stride) * Cw + off[k]];
    k += dk;
    ox += dox;
    ly += dly;
    if (k >= K9) {
      k -= K9;
      ++ox;
    }
    if (ox >= Wo) {
      ox -= Wo;
      ++ly;
    }
  }
}

// EPILOGUE: torch.addcmul(shift, s, scale) rounds s * scale + shift once
// (an fma, on the card as on the CPU: measured on an H100 with PyTorch
// 2.11, where a product and a sum rounded apart differ in about a fifth of
// the outputs); .add_(res) is one more rounded sum.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bireal_epilogue_kernel(const int* __restrict__ acc,
                       const int* __restrict__ corr,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const float* __restrict__ res, float* __restrict__ out,
                       int n, int pn, int N) {
  constexpr int V = kVec ? 4 : 1;
  const int i = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (i >= n) return;
  const int j = i % pn;                 // index into corr
  const int c = j % N;                  // channel
  int a[V], k[V];
  float s[V], t[V], r[V], y[V];
  if constexpr (kVec) {
    const int4 a4 = __ldcs(reinterpret_cast<const int4*>(acc + i));
    const int4 k4 = __ldg(reinterpret_cast<const int4*>(corr + j));
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + c));
    const float4 t4 = __ldg(reinterpret_cast<const float4*>(shift + c));
    const float4 r4 = *reinterpret_cast<const float4*>(res + i);
    a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
    k[0] = k4.x; k[1] = k4.y; k[2] = k4.z; k[3] = k4.w;
    s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
    t[0] = t4.x; t[1] = t4.y; t[2] = t4.z; t[3] = t4.w;
    r[0] = r4.x; r[1] = r4.y; r[2] = r4.z; r[3] = r4.w;
  } else {
    a[0] = acc[i];
    k[0] = __ldg(corr + j);
    s[0] = __ldg(scale + c);
    t[0] = __ldg(shift + c);
    r[0] = res[i];
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float f = __int2float_rn(a[u] + k[u]);
    y[u] = __fadd_rn(__fmaf_rn(f, s[u], t[u]), r[u]);
  }
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(out + i) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    out[i] = y[0];
  }
}

}  // namespace

// the band's shared memory, as the wrapper reckons it
static long long patches_smem(int W, int Cw, int band_rows, int stride) {
  return 4LL * (9LL * Cw + (long long)((band_rows - 1) * stride + 3) *
                               (W + 2) * Cw);
}

extern "C" int bireal_patches_launch(const float* x, int* out, int B, int H,
                                     int W, int C, int stride, int band_rows,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || band_rows <= 0 ||
      (stride != 1 && stride != 2) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int Cw = (C + 31) / 32;
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const long long smem = patches_smem(W, Cw, band_rows, stride);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((Ho + band_rows - 1) / band_rows, B);
  const bool wide = C % 32 == 0 && !(reinterpret_cast<uintptr_t>(x) & 15);
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    bireal_patches_kernel<true><<<grid, kThreads, (size_t)smem, s>>>(
        x, out, H, W, C, Cw, Ho, Wo, stride, band_rows);
  else
    bireal_patches_kernel<false><<<grid, kThreads, (size_t)smem, s>>>(
        x, out, H, W, C, Cw, Ho, Wo, stride, band_rows);
  return (int)cudaGetLastError();
}

// n = B * P * N outputs; vec: N % 4 == 0 and every operand 16 B aligned
extern "C" int bireal_epilogue_launch(const int* acc, const int* corr,
                                      const float* scale, const float* shift,
                                      const float* res, float* out, int n,
                                      int pn, int N, int vec, void* stream) {
  if (n <= 0 || pn <= 0 || N <= 0 || n % pn || pn % N)
    return (int)cudaErrorInvalidValue;
  if (vec && ((N & 3) || ((reinterpret_cast<uintptr_t>(acc) |
                           reinterpret_cast<uintptr_t>(corr) |
                           reinterpret_cast<uintptr_t>(scale) |
                           reinterpret_cast<uintptr_t>(shift) |
                           reinterpret_cast<uintptr_t>(res) |
                           reinterpret_cast<uintptr_t>(out)) & 15)))
    return (int)cudaErrorMisalignedAddress;
  const int per_block = kThreads * (vec ? 4 : 1);
  const unsigned grid = (unsigned)((n + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    bireal_epilogue_kernel<true><<<grid, kThreads, 0, s>>>(
        acc, corr, scale, shift, res, out, n, pn, N);
  else
    bireal_epilogue_kernel<false><<<grid, kThreads, 0, s>>>(
        acc, corr, scale, shift, res, out, n, pn, N);
  return (int)cudaGetLastError();
}

extern "C" const char* bireal_unit_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
