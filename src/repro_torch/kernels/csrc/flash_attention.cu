// Blockwise online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:73
// (flash_attention_pallas, body _flash_kernel).  Computes, for
// q (B, H, Sq, D) and k, v (B, Hkv, Sk, D) with H a multiple of Hkv,
//     o[b, h, i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/g,j]) v[b,h/g,j]
// over the keys j visible to query i: j < Sk and, when causal,
// j <= i + kv_offset (suffix alignment; the ops entry passes Sk - Sq).
// Inputs are f32 or bf16, the softmax statistics f32, the output has the
// input type.  Head dims 32, 64, 112 (zamba2-7b: d_model 3584 over 32
// heads) and 128.
//
// Shared by both paths.  One block per (query tile of 64 rows, head,
// batch); the Pallas grid's sequential key axis becomes a loop inside
// the block over key tiles of 64, with the running max, sum and output
// accumulator in f32 registers.  Keys that are masked (causal, or past a
// ragged Sk) get probability exactly 0; the running max starts at the
// finite -1e30 of the Pallas kernel.  Key tiles that are masked for
// every row of the block are not visited, which halves the causal work,
// and the heaviest causal tiles are scheduled first.  A query that sees
// no key at all (i + kv_offset < 0) gets a zero row.  Ragged Sq and Sk
// tails are loaded as zeros and masked here, so no caller pads.
//
// On request (kLse, a second instantiation of each kernel; a launch
// that does not ask runs the code it ran before) each row's natural-log
// log-sum-exp of its scaled scores, m + log(l), is written to a dense
// f32 (B, H, Sq) array: -inf for a row that saw no key.  The
// context-parallel attention launches the kernel once per KV part and
// merges the parts' outputs by these values.
//
// What bounds it on an H100: operations.  At the qwen2-0.5B prefill
// shape (B 4, H 14, S 2048, D 64, causal) the two products are 30 GFLOP
// over 34 MB of q, k, v and o, about 900 FLOP per byte, far above the
// card's ~295 FLOP per byte ridge, so the bound is the tensor cores'
// bf16 rate (989 TFLOP/s dense).
//
// bf16: tensor cores (namespace tc), the FlashAttention-2 structure with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  4 warps, 16 query rows
// each; a warp's Q fragments stay in registers for the whole key loop.
// K and V tiles go into a 2-stage shared-memory ring by cp.async (16
// bytes a thread; ragged rows zero-filled), so the next tile's copy runs
// under the current tile's products; rows are padded by 16 bytes, which
// puts the 8 rows of every ldmatrix phase on distinct banks.  S = Q K^T
// lands in f32 accumulator fragments; the mask, running max (quad
// shuffles) and exp2 are applied on those registers, and P is rounded in
// registers to the bf16 A fragments of the P.V product (ldmatrix.trans
// on V), so scores and probabilities never touch shared memory.  The
// row sums take the unrounded f32 probabilities.  Rounding P to bf16 is
// an error of the size of the bf16 output's own rounding.  The softmax
// is kept to few instructions per score, since at head dim 64 it issues
// about as many as the products: masked scores become -inf, whose exp2
// is exactly 0 (the running max keeps the finite floor), so no select
// is needed, and exp2 is the hardware's ex2.approx.ftz.  Two 16-row
// tiles per warp (each K/V fragment feeding two products) measured
// slower: at ~246 registers only 8 warps fit an SM.
//
// f32: scalar FMAs (namespace f32).  The tensor cores take f32 only as
// TF32, which keeps 10 mantissa bits and would break the f32 results'
// 1e-4 agreement with the plain version; so f32 stays on the FP32 pipe
// (67 TFLOP/s): q, k, v tiles converted to f32 in shared memory (rows
// padded by 4 floats), 256 threads as a 16 x 16 grid that owns 4 x 4
// scores each, probabilities through shared memory into P.V.
//
// wgmma with TMA staging and mbarriers is the next step for bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 64;      // keys per tile

struct Strides {  // element strides of (b, h, s); the last axis is dense
  long long b, h, s;
};

// key tiles any row of the query tile [q0, q0 + kBQ) can see
__device__ __forceinline__ int visible_tiles(int q0, int Sq, int Sk,
                                             int causal, int kv_offset) {
  int n = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kBQ, Sq) - 1;
    const long long last_key = (long long)last_q + kv_offset;
    const long long vis = last_key < 0 ? 0 : last_key / kBK + 1;
    n = (int)min((long long)n, vis);
  }
  return n;
}

// ---------------------------------------------------------------------
// f32: scalar FMAs on the FP32 pipe
// ---------------------------------------------------------------------
namespace f32 {

constexpr int kGrid = 16;    // threads per side of the 16 x 16 thread grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kRows = kBQ / kGrid;   // score rows per thread
constexpr int kCols = kBK / kGrid;   // score columns per thread
constexpr int kPad = 4;

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(float) * ((kBQ + 2 * kBK) * (D + kPad) +
                               kBQ * (kBK + kPad));
}

// rows [row0, row0 + kRowsTile) x D of src into dst (stride D + kPad);
// rows at or past n_rows are zero
template <int D, int kRowsTile>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src,
                                      long long row_stride, int row0,
                                      int n_rows) {
  for (int idx = threadIdx.x; idx < kRowsTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + kPad) + d] =
        row < n_rows ? src[(long long)row * row_stride + d] : 0.f;
  }
}

template <int D, bool kLse>
__device__ __forceinline__ void attention(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int group, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides os, float scale, int causal,
    int kv_offset) {
  constexpr int kLd = D + kPad;
  // output columns per read: the widest vector whose 16 lanes tile D
  // (112 = 16 x 7 takes single floats, in 7 groups)
  constexpr int kVec = D % (kGrid * 4) == 0 ? 4 : D % (kGrid * 2) == 0 ? 2
                                                                     : 1;
  constexpr int kGroups = D / (kGrid * kVec);  // column groups per thread
  static_assert(D % 4 == 0 && kGroups * kGrid * kVec == D,
                "the thread grid does not tile the head dim");
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

  const float* q_bh = q + b * qs.b + h * qs.h;
  const float* k_bh = k + b * ks.b + hk * ks.h;
  const float* v_bh = v + b * vs.b + hk * vs.h;
  float* o_bh = o + b * os.b + h * os.h;

  const int n_tiles = visible_tiles(q0, Sq, Sk, causal, kv_offset);

  stage<D, kBQ>(q_s, q_bh, qs.s, q0, Sq);

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
    stage<D, kBK>(k_s, k_bh, ks.s, k0, Sk);
    stage<D, kBK>(v_s, v_bh, vs.s, k0, Sk);
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
          } else if constexpr (kVec == 2) {
            const float2 x = *reinterpret_cast<const float2*>(
                &vrow[g * kGrid * kVec + tx * kVec]);
            vv[0] = x.x; vv[1] = x.y;
          } else {
            vv[0] = vrow[g * kGrid + tx];
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

  // o = acc / l; a row that saw no key is 0 (and its lse -inf); every
  // lane of a row holds the row's m and l
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kGrid * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if constexpr (kLse) {
      if (tx == 0)
        lse[((long long)b * gridDim.y + h) * Sq + qi] =
            l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    }
    float* orow = o_bh + (long long)qi * os.s;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int c = 0; c < kVec; ++c)
        orow[g * kGrid * kVec + tx * kVec + c] = acc[i][g * kVec + c] * inv;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------
// bf16: tensor cores, mma.sync.m16n8k16
// ---------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = kBQ / 16;   // 16 query rows per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;            // bf16 elements (16 bytes) per row
constexpr int kStages = 2;         // K/V ring depth

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(bf16) * (kBQ + 2 * kStages * kBK) * (D + kPad);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below 2^-126 to 0 (they weigh nothing here)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of bf16 (lo in the low half), round to nearest
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// rows [row0, row0 + kRowsTile) x D of src into dst (stride D + kPad) by
// cp.async, 8 elements a copy; rows at or past n_rows are zero
template <int D, int kRowsTile>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  static_assert(kRowsTile * kChunks % kThreads == 0, "uneven tile copy");
#pragma unroll
  for (int it = 0; it < kRowsTile * kChunks / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const bf16* g = valid ? src + (long long)(row0 + r) * row_stride + c : src;
    cp_async16(smem_addr(dst + r * (D + kPad) + c), g, valid);
  }
}

template <int D, bool kLse>
__device__ __forceinline__ void attention(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    float* __restrict__ lse, int group, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides os, float scale, int causal,
    int kv_offset) {
  constexpr int kLd = D + kPad;
  // Each 16-wide head-dim chunk is one ldmatrix.x4 of Q or K and each
  // pair of 8-wide O tiles one ldmatrix.x4.trans of V, so D need only be
  // a multiple of 16: at D 112 kKC is 7 (odd: no loop pairs chunks) and
  // rows of 120 elements (240 bytes) keep ldmatrix conflict-free.
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kKC = D / 16;     // 16-wide head-dim chunks of Q K^T
  constexpr int kNS = kBK / 8;    // 8-key column tiles of S
  constexpr int kND = D / 8;      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kBQ][kLd]
  bf16* k_s = q_s + kBQ * kLd;                     // [kStages][kBK][kLd]
  bf16* v_s = k_s + kStages * kBK * kLd;           // [kStages][kBK][kLd]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;

  const bf16* q_bh = q + b * qs.b + h * qs.h;
  const bf16* k_bh = k + b * ks.b + hk * ks.h;
  const bf16* v_bh = v + b * vs.b + hk * vs.h;
  bf16* o_bh = o + b * os.b + h * os.h;

  const int n_tiles = visible_tiles(q0, Sq, Sk, causal, kv_offset);

  load_tile<D, kBQ>(q_s, q_bh, qs.s, q0, Sq);
  if (n_tiles > 0) {
    load_tile<D, kBK>(k_s, k_bh, ks.s, 0, Sk);
    load_tile<D, kBK>(v_s, v_bh, vs.s, 0, Sk);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix x4 address roles: lane supplies row (lane & 7) of matrix
  // (lane >> 3)
  const int mi = lane >> 3;
  const int mr = lane & 7;

  // this warp's 16 rows of Q as A fragments, for the whole key loop
  unsigned qf[kKC][4];
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    const int row = warp * 16 + mr + (mi & 1) * 8;
    const int col = kc * 16 + (mi >> 1) * 8;
    ldsm_x4(smem_addr(q_s + row * kLd + col), qf[kc][0], qf[kc][1],
            qf[kc][2], qf[kc][3]);
  }

  // accumulator fragment roles: lane holds rows g and g + 8, columns
  // 2 tq and 2 tq + 1 of each 8-wide tile
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = q0 + warp * 16 + g;   // query of elements 0, 1
  const float sl2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

  float acc[kND][4];
#pragma unroll
  for (int dn = 0; dn < kND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {kNeg, kNeg};   // running max, in units of log2
  float l[2] = {0.f, 0.f};     // this lane's part of the running sum

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    // the next tile's copy runs under this tile's products; its stage
    // was released by the barrier that ended the previous iteration
    if (t + 1 < n_tiles) {
      load_tile<D, kBK>(k_s + (st ^ 1) * kBK * kLd, k_bh, ks.s,
                        (t + 1) * kBK, Sk);
      load_tile<D, kBK>(v_s + (st ^ 1) * kBK * kLd, v_bh, vs.s,
                        (t + 1) * kBK, Sk);
    }
    cp_async_commit();
    const bf16* kt = k_s + st * kBK * kLd;
    const bf16* vt = v_s + st * kBK * kLd;
    const int k0 = t * kBK;

    // S = Q K^T: K rows are the col-major B operand as they lie
    float s[kNS][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
#pragma unroll
      for (int np = 0; np < kNS / 2; ++np) {
        unsigned b0, b1, b2, b3;
        const int key = np * 16 + mr + (mi >> 1) * 8;
        const int col = kc * 16 + (mi & 1) * 8;
        ldsm_x4(smem_addr(kt + key * kLd + col), b0, b1, b2, b3);
        mma_bf16(s[2 * np], qf[kc], b0, b1);
        mma_bf16(s[2 * np + 1], qf[kc], b2, b3);
      }
    }

    // mask (only tiles that cross Sk or the causal diagonal), running max
    const bool need_mask =
        k0 + kBK > Sk ||
        (causal && (long long)k0 + kBK - 1 > (long long)q0 + kv_offset);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (need_mask) {
          const int key = k0 + 8 * j + 2 * tq + (e & 1);
          const int qi = row0 + (e >> 1) * 8;
          const bool ok = key < Sk &&
              (!causal || (long long)key <= (long long)qi + kv_offset);
          x = ok ? x : -INFINITY;   // exp2 of it is exactly 0
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int dn = 0; dn < kND; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // P in registers: masked keys weigh exactly 0; the f32 values go to
    // the row sums, their bf16 roundings to the A fragments of P.V
    unsigned pa[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = ex2(s[j][e] - m[e >> 1]);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V: V rows are row-major B, read transposed by ldmatrix
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
#pragma unroll
      for (int dp = 0; dp < kND / 2; ++dp) {
        unsigned b0, b1, b2, b3;
        const int key = kc * 16 + mr + (mi & 1) * 8;
        const int col = dp * 16 + (mi >> 1) * 8;
        ldsm_x4_trans(smem_addr(vt + key * kLd + col), b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], pa[kc], b0, b1);
        mma_bf16(acc[2 * dp + 1], pa[kc], b2, b3);
      }
    }

    cp_async_wait_all();   // the next tile is in
    __syncthreads();       // and every warp is done with this stage
  }

  // o = acc / l; a row that saw no key is 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if constexpr (kLse) {
      // m is in units of log2: lse = m ln 2 + ln l
      if (tq == 0)
        lse[((long long)b * gridDim.y + h) * Sq + qi] =
            l[i] > 0.f ? m[i] * 0.6931471805599453f + logf(l[i])
                       : -INFINITY;
    }
    bf16* orow = o_bh + (long long)qi * os.s + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < kND; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dn) =
          __floats2bfloat162_rn(acc[dn][2 * i] * inv,
                                acc[dn][2 * i + 1] * inv);
  }
}

}  // namespace tc

template <typename T>
constexpr int threads_of() {  // a call, not a template-id: launch bounds
                              // would split is_same<T, float> at its comma
  return std::is_same<T, float>::value ? f32::kThreads : tc::kThreads;
}

template <typename T, int D>
constexpr int smem_of() {
  return std::is_same<T, float>::value ? f32::smem_bytes<D>()
                                       : tc::smem_bytes<D>();
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(threads_of<T>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int group, int Sq, int Sk,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, int kv_offset) {
  if constexpr (std::is_same<T, float>::value)
    f32::attention<D, kLse>(q, k, v, o, lse, group, Sq, Sk, qs, ks, vs, os,
                            scale, causal, kv_offset);
  else
    tc::attention<D, kLse>(q, k, v, o, lse, group, Sq, Sk, qs, ks, vs, os,
                           scale, causal, kv_offset);
}

template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int group, int Sq, int Sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int kv_offset,
           cudaStream_t stream) {
  constexpr int bytes = smem_of<T, D>();
  // per instantiation; the attribute is per device, and a process here
  // drives one card
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D, kLse>
      <<<grid, threads_of<T>(), bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, group, Sq, Sk,
          qs, ks, vs, os, scale, causal, kv_offset);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_lse(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int group, int Sq, int Sk,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, int kv_offset, cudaStream_t stream) {
  if (lse != nullptr)
    return launch<T, D, true>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                              vs, os, scale, causal, kv_offset, stream);
  return launch<T, D, false>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                             vs, os, scale, causal, kv_offset, stream);
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int group, int Sq, int Sk, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             int kv_offset, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_lse<T, 32>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                               vs, os, scale, causal, kv_offset, stream);
    case 64:
      return launch_lse<T, 64>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                               vs, os, scale, causal, kv_offset, stream);
    case 112:
      return launch_lse<T, 112>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                                vs, os, scale, causal, kv_offset, stream);
    case 128:
      return launch_lse<T, 128>(q, k, v, o, lse, B, H, group, Sq, Sk, qs, ks,
                                vs, os, scale, causal, kv_offset, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// cp.async copies 16 bytes: every (b, h, s) row of a bf16 operand must
// start on a 16-byte boundary
bool aligned16(const void* p, const Strides& s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  Strides are in elements, (b, h, s) of
// each tensor; the head-dim axis must be dense.  bf16 operands must be
// 16-byte aligned (base pointers and all three strides).  lse: null, or a
// dense f32 (B, H, Sq) array for each row's log-sum-exp.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int H, int Hkv, int Sq, int Sk, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
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
    return launch_d<float>(D, q, k, v, o, static_cast<float*>(lse), B, H,
                           H / Hkv, Sq, Sk, qs, ks, vs, os, scale, causal,
                           kv_offset, st);
  if (dtype == 1) {
    if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) ||
        !aligned16(o, os))
      return (int)cudaErrorMisalignedAddress;
    return launch_d<__nv_bfloat16>(D, q, k, v, o, static_cast<float*>(lse),
                                   B, H, H / Hkv, Sq, Sk, qs, ks, vs, os,
                                   scale, causal, kv_offset, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
