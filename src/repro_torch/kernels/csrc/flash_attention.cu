// Blockwise online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:73
// (flash_attention_pallas, body _flash_kernel).  Computes, for
// q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) with H a multiple of Hkv,
//     o[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/g,j]) v[b,h/g,j]
// over the keys j visible to query i: j < Sk and, when causal,
// j <= i + kv_offset (suffix alignment; the ops entry passes Sk - Sq).
// Inputs are f32 or bf16, all arithmetic is f32, the output has the
// input type.  Head dims 32, 64 and 128.
//
// Design.  One block per (query tile of kBQ rows, head, batch); the
// Pallas grid's sequential key axis becomes a loop inside the block.
// The query tile and each key/value tile are converted to f32 and staged
// in shared memory (rows padded by 4 floats, so 16-byte reads stay
// aligned and a quarter-warp's reads hit distinct banks).  256 threads
// form a 16 x 16 grid: thread (ty, tx) owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 4), so the 16 threads of a row are 16
// consecutive lanes of one warp and the row max and sum are shuffles.
// The running max, sum and the thread's D/16 output columns of its four
// rows stay in f32 registers across the key loop; the probabilities of a
// tile go through shared memory into the P.V product.  Keys that are
// masked (causal, or past a ragged Sk) get probability exactly 0; the
// running max starts at the finite -1e30 of the Pallas kernel.  Key
// tiles that are masked for every row of the block are not visited,
// which halves the causal work.  A query that sees no key at all
// (i + kv_offset < 0) gets a zero row.  Ragged Sq and Sk tails are
// loaded as zeros and masked here, so no caller pads.
//
// What bounds it on an H100: operations.  At the qwen2-0.5B prefill shape
// (B 4, H 14, S 2048, D 64, causal) the two products are 30 GFLOP over
// 34 MB of q, k, v and o, about 900 FLOP per byte, far above the
// card's ~295 FLOP per byte ridge.  The bound is the tensor cores' bf16
// rate; this kernel issues scalar f32 FMAs from shared memory (the FP32
// pipe, 67 TFLOP/s), which is what f32 inputs and f32 math require, and
// keeps every score and probability on chip.  Tensor-core MMA for bf16
// inputs (mma.sync / wgmma with TMA staging) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per tile
constexpr int kGrid = 16;    // threads per side of the 16 x 16 thread grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kRows = kBQ / kGrid;   // score rows per thread
constexpr int kCols = kBK / kGrid;   // score columns per thread
constexpr int kPad = 4;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Strides {  // element strides of (b, h, s); the last axis is dense
  long long b, h, s;
};

// rows [row0, row0 + kRowsTile) x D of src into dst (stride D + kPad) as
// f32; rows at or past n_rows are zero
template <typename T, int D, int kRowsTile>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src,
                                      long long row_stride, int row0,
                                      int n_rows) {
  for (int idx = threadIdx.x; idx < kRowsTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + kPad) + d] =
        row < n_rows ? to_f32(src[(long long)row * row_stride + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int group, int Sq, int Sk, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal,
                       int kv_offset) {
  constexpr int kLd = D + kPad;
  constexpr int kVec = D >= 64 ? 4 : 2;        // output columns per read
  constexpr int kGroups = D / (kGrid * kVec);  // column groups per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kBQ][kLd]
  float* k_s = q_s + kBQ * kLd;       // [kBK][kLd]
  float* v_s = k_s + kBK * kLd;       // [kBK][kLd]
  float* p_s = v_s + kBK * kLd;       // [kBQ][kBK + kPad]

  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;
  // heavy causal tiles (late queries) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;

  const T* q_bh = q + b * qs.b + h * qs.h;
  const T* k_bh = k + b * ks.b + hk * ks.h;
  const T* v_bh = v + b * vs.b + hk * vs.h;
  T* o_bh = o + b * os.b + h * os.h;

  // key tiles any row of this block can see
  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1;
    const long long last_key = (long long)last_q + kv_offset;
    const long long vis = last_key < 0 ? 0 : last_key / kBK + 1;
    n_tiles = (int)min((long long)n_tiles, vis);
  }

  stage<T, D, kBQ>(q_s, q_bh, qs.s, q0, Sq);

  float m[kRows], l[kRows], acc[kRows][kGroups * kVec];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kGroups * kVec; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's k_s, v_s, p_s fully consumed
    stage<T, D, kBK>(k_s, k_bh, ks.s, k0, Sk);
    stage<T, D, kBK>(v_s, v_bh, vs.s, k0, Sk);
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 scores, 4 head-dim lanes a step
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &q_s[(ty + kGrid * i) * kLd + d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &k_s[(tx + kGrid * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kGrid * i;
      bool ok[kCols];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kGrid * j;
        ok[j] = kj < Sk && (!causal || (long long)kj <= (long long)qi + kv_offset);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kGrid / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + kGrid * i) * (kBK + kPad) + tx + kGrid * j] = p;
      }
#pragma unroll
      for (int off = kGrid / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kGroups * kVec; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // O += P V for this thread's 4 rows and D/16 columns
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            &p_s[(ty + kGrid * i) * (kBK + kPad) + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = &v_s[(kk + e) * kLd];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          float vv[kVec];
          if constexpr (kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                &vrow[g * kGrid * kVec + tx * kVec]);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x = *reinterpret_cast<const float2*>(
                &vrow[g * kGrid * kVec + tx * kVec]);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                           : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int c = 0; c < kVec; ++c)
              acc[i][g * kVec + c] = fmaf(pe, vv[c], acc[i][g * kVec + c]);
          }
        }
      }
    }
  }

  // o = acc / l; a row that saw no key is 0
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o_bh + (long long)qi * os.s;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        orow[g * kGrid * kVec + tx * kVec + c] =
            from_f32<T>(acc[i][g * kVec + c] * inv);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(float) * ((kBQ + 2 * kBK) * (D + kPad) +
                               kBQ * (kBK + kPad));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int group, int Sq, int Sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int kv_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // per instantiation; the attribute is per device, and a process here
  // drives one card
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, Sq, Sk, qs, ks,
      vs, os, scale, causal, kv_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int B, int H, int group, int Sq, int Sk, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal, int kv_offset,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, group, Sq, Sk, qs, ks, vs, os,
                           scale, causal, kv_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, group, Sq, Sk, qs, ks, vs, os,
                           scale, causal, kv_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, group, Sq, Sk, qs, ks, vs, os,
                            scale, causal, kv_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements, (b, h, s) of
// each tensor; the head-dim axis must be dense.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hkv, int Sq, int Sk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, int kv_offset,
    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, H / Hkv, Sq, Sk, qs, ks, vs,
                           os, scale, causal, kv_offset, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, H / Hkv, Sq, Sk, qs,
                                   ks, vs, os, scale, causal, kv_offset, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
