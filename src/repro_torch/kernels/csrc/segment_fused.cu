// A whole device segment of a packed BNN in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_fused.py
// (build_pallas_segment, body _segment_kernel): the layer chain
// conv (3x3 SAME patch gather + xnor GEMM), 2x2 max-pool, step (integer
// threshold + bit-plane repack), flatten and fc, for one example per
// program.
//
// Design.  Grid (B,): one block per example, as the Pallas grid is.  The
// block walks a table of layer descriptors built by the Python wrapper,
// with __syncthreads() between layers.  The TPU kernel kept every weight
// and the widest intermediate resident in VMEM; an H100 block has at most
// 227 KB of shared memory, while CIFAR-10's C512 weights alone are 288 KiB
// and one unpacked 32x32x64 pre-activation is 256 KiB.  So weights stream
// from global memory (L2-resident after the first example touches them)
// and interior activations live in per-example global scratch: two
// ping-pong buffers sized to the segment's widest activation, allocated
// by the wrapper.  Where the layer order allows, the pool and the step
// are fused into the GEMM's epilogue: a conv followed by a max-pool
// computes each pooled output directly (max over its four conv outputs),
// and a conv or fc followed by a step thresholds in registers and repacks
// with one __ballot_sync per warp (32 consecutive channels -> one word,
// lane l -> bit l), so the unpacked pre-activation never reaches memory.
//
// What bounds it on an H100: the same popc rate as the xnor GEMM
// (16 per clock per SM), but one block per example, so a batch of B uses
// at most B of the 132 SMs: at B = 1 it fills one SM.  That is the price
// of keeping the Pallas kernel's one-program-per-example structure; a
// layer-parallel split of each example over several blocks is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

// 32 warps: with one block per example, each SM holds a single block,
// and the weight/activation loads are latency-bound, so the block needs
// every warp the SM can hold
constexpr int kThreads = 1024;

// descriptor layout, kDesc ints per op (mirrors segment_fused.py)
enum OpKind { kConv = 0, kFc = 1, kPool = 2, kStep = 3, kCopy = 4 };
enum Buf { kIn = 0, kOut = 1, kS0 = 2, kS1 = 3 };
enum Field {
  fKind = 0, fSrc, fDst, fH, fW, fC, fN, fKTrue, fPool, fStep,
  fWOff, fTOff, fFOff, kDesc
};

__device__ __forceinline__ bool fire(int v, const int* t, const int* f,
                                     int c) {
  return (v > t[c]) != (f[c] != 0);
}

// conv [+ 2x2 max-pool] [+ step]: src (H, W, Cw) words, weights
// transposed to (9 Cw, N), tap-major, so a warp's 32 consecutive
// neurons read 32 consecutive words; dst (Ho, Wo, N) int32, or
// (Ho, Wo, N/32) words when the step is fused (requires N % 32 == 0).
__device__ void conv_op(const int* __restrict__ src, int* __restrict__ dst,
                        const int* __restrict__ wt, const int* t,
                        const int* f, int H, int W, int Cw, int N,
                        int k_true, int pool, int step) {
  const int ps = pool ? 2 : 1;
  const int Ho = H / ps, Wo = W / ps;
  const int total = Ho * Wo * N;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx % N;
    const int pix = idx / N;
    const int oy = pix / Wo, ox = pix % Wo;
    const int* wn = wt + n;   // word k of neuron n at wn[k * N]
    int best = INT_MIN;
    for (int i = 0; i < ps; ++i) {
      for (int j = 0; j < ps; ++j) {
        const int y = oy * ps + i, x = ox * ps + j;
        int agree = 0;
        for (int dy = 0; dy < 3; ++dy) {
          const int yy = y + dy - 1;
          for (int dx = 0; dx < 3; ++dx) {
            const int xx = x + dx - 1;
            const int* wtap = wn + (size_t)(dy * 3 + dx) * Cw * N;
            if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
              const int* arow = src + ((size_t)yy * W + xx) * Cw;
              for (int c = 0; c < Cw; ++c)
                agree += __popc(~(arow[c] ^ wtap[(size_t)c * N]));
            } else {
              // pad words are 0 (all -1 pixels)
              for (int c = 0; c < Cw; ++c) agree += __popc(~wtap[(size_t)c * N]);
            }
          }
        }
        best = max(best, 2 * agree - k_true);
      }
    }
    if (step) {
      // N % 32 == 0: each warp holds 32 consecutive channels of a pixel
      const unsigned bits = __ballot_sync(0xffffffffu, fire(best, t, f, n));
      if ((threadIdx.x & 31) == 0) dst[(size_t)pix * (N / 32) + n / 32] = (int)bits;
    } else {
      dst[idx] = best;
    }
  }
}

// fc [+ step]: src (Kw) words, weights transposed to (Kw, N); dst (N)
// int32 or (N/32) words.
__device__ void fc_op(const int* __restrict__ src, int* __restrict__ dst,
                      const int* __restrict__ wt, const int* t,
                      const int* f, int Kw, int N, int k_true, int step) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int agree = 0;
    for (int c = 0; c < Kw; ++c) agree += __popc(~(src[c] ^ wt[(size_t)c * N + n]));
    const int v = 2 * agree - k_true;
    if (step) {
      const unsigned bits = __ballot_sync(0xffffffffu, fire(v, t, f, n));
      if ((threadIdx.x & 31) == 0) dst[n / 32] = (int)bits;
    } else {
      dst[n] = v;
    }
  }
}

// 2x2/2 max-pool over int32 elements: src (H, W, C) -> (H/2, W/2, C)
__device__ void pool_op(const int* __restrict__ src, int* __restrict__ dst,
                        int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2;
  const int total = Ho * Wo * C;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % C;
    const int pix = idx / C;
    const int y = 2 * (pix / Wo), x = 2 * (pix % Wo);
    const int* s = src + ((size_t)y * W + x) * C + c;
    const int row = W * C;
    dst[idx] = max(max(s[0], s[C]), max(s[row], s[row + C]));
  }
}

// step: src (P, C) int32 -> (P, ceil(C/32)) words, tail bits 0
__device__ void step_op(const int* __restrict__ src, int* __restrict__ dst,
                        const int* t, const int* f, int P, int C) {
  const int Cw = (C + 31) / 32;
  const int total = P * Cw;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int p = idx / Cw, wd = idx % Cw;
    unsigned bits = 0;
    for (int l = 0; l < 32; ++l) {
      const int c = wd * 32 + l;
      if (c < C && fire(src[(size_t)p * C + c], t, f, c)) bits |= 1u << l;
    }
    dst[idx] = (int)bits;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_kernel(const int* __restrict__ x, int* __restrict__ out,
               int* __restrict__ scratch, const int* __restrict__ params,
               const int* __restrict__ desc, int n_ops, int in_stride,
               int out_stride, int scratch_stride) {
  const size_t b = blockIdx.x;
  const int* in_b = x + b * in_stride;
  int* out_b = out + b * out_stride;
  int* s0 = scratch + b * 2 * (size_t)scratch_stride;
  int* s1 = s0 + scratch_stride;
  for (int o = 0; o < n_ops; ++o) {
    const int* d = desc + o * kDesc;
    const int* src = d[fSrc] == kIn ? in_b : (d[fSrc] == kS0 ? s0 : s1);
    int* dst = d[fDst] == kOut ? out_b : (d[fDst] == kS0 ? s0 : s1);
    const int* wt = params + d[fWOff];
    const int* t = params + d[fTOff];
    const int* f = params + d[fFOff];
    switch (d[fKind]) {
      case kConv:
        conv_op(src, dst, wt, t, f, d[fH], d[fW], d[fC], d[fN], d[fKTrue],
                d[fPool], d[fStep]);
        break;
      case kFc:
        fc_op(src, dst, wt, t, f, d[fC], d[fN], d[fKTrue], d[fStep]);
        break;
      case kPool:
        pool_op(src, dst, d[fH], d[fW], d[fC]);
        break;
      case kStep:
        step_op(src, dst, t, f, d[fH] * d[fW], d[fC]);
        break;
      default:  // kCopy: d[fC] elements
        for (int i = threadIdx.x; i < d[fC]; i += blockDim.x) dst[i] = src[i];
        break;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int segment_fused_launch(const int* x, int* out, int* scratch,
                                    const int* params, const int* desc,
                                    int n_ops, int B, int in_stride,
                                    int out_stride, int scratch_stride,
                                    void* stream) {
  segment_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, scratch, params, desc, n_ops, in_stride, out_stride,
      scratch_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* segment_fused_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
