// K9. Fused attention forward for Hopper (sm_90a):
//   out = softmax((q * scale) . k^T + bias) . v
// over q [B, H, Sq, Dh], k and v [B, H, Sk, Dh] and an optional additive
// float32 bias row [B, H, Sk] that is the same for every query row (a
// padding mask). Replaces `_attention_kernel`
// (egovlpv2_tpu/ops/flash.py:37-55, reached through `_flash_fwd_3d` :58),
// the kernel behind `attend`: text self-attention, the text-to-video (t2i)
// and the video-to-text (i2t) cross-attention of the fused blocks.
//
// Arithmetic, as the TPU kernel's: the logits q.k * scale + bias, the
// softmax (exp(logit - max) over the row sum) and the sums of P.V are
// float32, and the output is rounded once to the input dtype. The CUDA-core
// form raises q, k and v to float32; the tensor-core forms multiply bf16 q
// and k (exact products, float32 sums), scale the float32 product, and
// feed P to P.V as the sum of two bf16 terms (16 bits of mantissa), so P is
// not rounded to bf16 as the plain `attend` rounds it. A masked key
// carries -1e9, not -inf: a row whose keys are all masked comes out uniform
// over its Sk keys, as the plain version gives it.
//
// Layout. Nothing is copied or padded on either side: every tensor comes
// with its batch, head and row strides (in elements), the head dim is
// contiguous. q, k and v may be transposed views of a [B, S, H*Dh]
// projection or slices of one packed [B, S, 2, H, Dh] projection; the
// output is written as [B, Sq, H, Dh], so that merging the heads is a view.
//
// Bound: bytes. Three regimes at H=12, Dh=64:
//   * i2t, Sq = 785..6273 queries over Sk = 15..30 keys: the K/V of a
//     (batch, head) are a few KB and stay in L1; the kernel reads q and
//     writes the output once (617 MB at B=64, Sq=3137 in bf16: 0.18 ms at
//     3.35 TB/s) for 4*Sk*Dh operations a row;
//   * t2i, Sq = 15..30 queries over Sk = 785..6273 keys: every query row of
//     a (batch, head) reads all its K and V, 803 KB at Sk=3137 in bf16, and
//     a key row of 256 bytes feeds 4 * Sq * Dh operations (about 15 a
//     byte at Sq=15, against the 295 a byte at which the tensor cores would
//     bound it): 193 MB at B=20 (0.058 ms), 617 MB at B=64 (0.185 ms);
//   * text self-attention, Sq = Sk = 15..30: a few microseconds of work,
//     bound by the launch.
// Three forms, the one that `flash_fwd_geometry` (ops/_kernels.py) names;
// the entry point refuses any other:
//   * few queries (bf16, Dh 32, 64 or 128, Sq <= 32: t2i and text
//     self-attention): mma::fused_split_kernel, the keys of a (batch, head)
//     split over blocks and staged with cp.async, then
//     mma::fused_merge_kernel where there is more than one split; described
//     there;
//   * many queries (bf16, Dh 32, 64 or 128, Sq > 32: i2t):
//     mma::fused_fwd_kernel, described there;
//   * CUDA cores (f32, other head dims), in the simplest form that is
//     right: a group of G threads owns one query row of one head, each
//     thread 8 consecutive elements of the head dim (16 B of bf16, one
//     vector load; element by element where the head dim is not a multiple
//     of 8, the last thread's slice cut short), as in divided_attention.cu;
//     a block of 256 threads takes 256/G query rows of one (batch, head),
//     and each group streams all the keys kChunk at a time with an online
//     softmax (the running max starts at -inf). The groups of a warp hold
//     neighbouring query rows, so a key is one broadcast load a warp. It is
//     not tuned (few query rows over many keys leave most of the card
//     idle); it goes once float32 has a tensor-core form.
// No atomics in any form: two runs give the same bits.

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 8;  // keys scored between softmax rescales

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A thread's slice of a row: n of its kVec elements lie inside the head dim.
// kWhole: the head dim is a multiple of kVec and rows are 16-byte aligned
// (the Python wrapper checks it), so the slice is one vector load.
template <bool kWhole, typename T>
__device__ __forceinline__ void load_slice(const T* p, int n,
                                           float (&o)[kVec]) {
  if constexpr (kWhole) {
    load_vec(p, o);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = e < n ? widen(p[e]) : 0.f;
  }
}

template <bool kWhole, typename T>
__device__ __forceinline__ void store_slice(T* p, int n,
                                            const float (&v)[kVec]) {
  if constexpr (kWhole) {
    store_vec(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (e < n) store_one(p + e, v[e]);
    }
  }
}

// Elements between the batches, heads and sequence rows of one tensor.
struct Strides {
  int64_t b, h, s;
};

template <typename T, int G, bool kWhole>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int H, int Sq, int Sk,
                               int Dh, Strides qs, Strides ks, Strides vs,
                               Strides os, int64_t bias_b, int64_t bias_h,
                               int tiles, float scale) {
  constexpr int kRows = kThreads / G;  // query rows a block
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / tiles / H;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int row = tile * kRows + grp;
  const bool row_ok = row < Sq;
  const int r = row_ok ? row : Sq - 1;  // idle groups still join shuffles
  const bool on = lane * kVec < Dh;     // false on padding lanes

  const int64_t col = (int64_t)lane * kVec;
  const int n = Dh - lane * kVec;       // elements of the slice in the head
  const T* kp = k + b * ks.b + h * ks.h + col;
  const T* vp = v + b * vs.b + h * vs.h + col;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;

  float qv[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = 0.f;
  if (on) {
    load_slice<kWhole>(q + b * qs.b + h * qs.h + r * qs.s + col, n, qv);
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] *= scale;

  float m = -INFINITY, l = 0.f;
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  for (int i0 = 0; i0 < Sk; i0 += kChunk) {
    float s[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int64_t key = i0 + c;
      const bool valid = key < Sk;
      float part = 0.f;
      if (on && valid) {
        float kv[kVec];
        load_slice<kWhole>(kp + key * ks.s, n, kv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(qv[e], kv[e], part);
      }
      part = group_sum<G>(part);
      s[c] = valid ? (bp ? part + __ldg(bp + key) : part) : -INFINITY;
      cmax = fmaxf(cmax, s[c]);
    }
    // Key i0 is a real key (a masked one carries -1e9, not -inf), so m_new
    // is finite and exp(-inf - m_new) = 0 handles the first chunk.
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int64_t key = i0 + c;
      const float p = expf(s[c] - m_new);
      l += p;
      if (on && key < Sk) {
        float vv[kVec];
        load_slice<kWhole>(vp + key * vs.s, n, vv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
      }
    }
    m = m_new;
  }

  if (row_ok && on) {
    float o[kVec];
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < kVec; ++e) o[e] = acc[e] * inv;
    store_slice<kWhole>(out + b * os.b + h * os.h + r * os.s + col, n,
                        o);
  }
}

// The tensor-core forms: bf16 with Dh = 32, 64 or 128. QK^T and PV are
// mma.sync m16n8k16 products (bf16 in, f32 accumulate). The logits are
// q.k * scale + bias in f32 (in the log2 domain), the softmax is f32, P
// enters P.V as two bf16 A operands, hi and lo (f32 accumulate, the small
// term first), the output is rounded once.
namespace mma {

constexpr int kWarps = 4;
constexpr int kKeys = 64;     // keys a chunk (many queries)
constexpr int kSplitKeys = 128;  // keys a chunk (few queries)
constexpr int kStages = 2;       // chunks in the ring (few queries)
constexpr int kPad = 8;       // bf16 of padding a shared-memory row
constexpr int kFewRows = 32;  // the most query rows of the few-query form
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as a pair of bf16 pairs whose sum keeps 16 bits of mantissa.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Many queries (i2t). Bound: the CUDA-core form spends about 60 issue slots
// of a warp on each (row, key) pair of a group of 8 threads; here the loads
// bound it. Design, after the tensor-core K1 of divided_attention.cu: a
// block of 4 warps owns 64 query rows, 16 a warp, Q held in registers as
// mma A fragments, and walks the Sk keys of its (batch, head) in chunks of
// 64 staged in shared memory (K row-major, V transposed, rows padded by 8
// against bank conflicts, the bias row beside them times log2 e, -inf past
// the last key); only the key tiles that hold a key are multiplied, so 15
// keys cost 2 of 8 tiles.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    fused_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int64_t bias_b, int64_t bias_h, int tiles, float scale) {
  constexpr int kRows = 16 * kWarps;  // query rows a block
  constexpr int kKBytes = kKeys * (DH + kPad) * 2;
  constexpr int kStage = kKBytes + DH * (kKeys + kPad) * 2;
  __shared__ __align__(16) unsigned char smem[kStage];
  __shared__ float sbias[kKeys];
  auto sk = reinterpret_cast<__nv_bfloat16(*)[DH + kPad]>(smem);
  auto svt = reinterpret_cast<__nv_bfloat16(*)[kKeys + kPad]>(smem + kKBytes);

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / tiles / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;
  // This thread's two query rows (fragment rows g and g + 8).
  const int p_lo = tile * kRows + warp * 16 + g, p_hi = p_lo + 8;
  const bool ok_lo = p_lo < Sq, ok_hi = p_hi < Sq;

  uint32_t qa[DH / 16][4];
  {
    const __nv_bfloat16* q_lo = q + b * qs.b + h * qs.h + p_lo * qs.s;
    const __nv_bfloat16* q_hi = q + b * qs.b + h * qs.h + p_hi * qs.s;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ok_lo ? ld32(q_lo + c) : 0u;
      qa[kk][1] = ok_hi ? ld32(q_hi + c) : 0u;
      qa[kk][2] = ok_lo ? ld32(q_lo + c + 8) : 0u;
      qa[kk][3] = ok_hi ? ld32(q_hi + c + 8) : 0u;
    }
  }
  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const float sl2 = scale * kLog2e;

  for (int c0 = 0; c0 < Sk; c0 += kKeys) {
    const int n_in = min(kKeys, Sk - c0);   // keys of this chunk
    const int n16 = (n_in + 15) / 16 * 16;  // rows staged: whole mma tiles
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < n16 * (DH / 8); i += kWarps * 32) {
      const int j = i / (DH / 8), d8 = (i % (DH / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < n_in) {
        const int64_t key = c0 + j;
        kv = __ldg(reinterpret_cast<const uint4*>(kbase + key * ks.s + d8));
        vv = __ldg(reinterpret_cast<const uint4*>(vbase + key * vs.s + d8));
      }
      *reinterpret_cast<uint4*>(&sk[j][d8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[d8 + e][j] = ve[e];
    }
    if (threadIdx.x < kKeys) {
      const int j = threadIdx.x;
      sbias[j] = j < n_in ? (bp ? __ldg(bp + c0 + j) * kLog2e : 0.f) : -INFINITY;
    }
    __syncthreads();
    // Both lines change nothing (n16 <= kKeys, a chunk holds a key), but
    // without them nvcc schedules this loop with 128 registers instead of
    // 121 and the kernel runs 5% slower (i2t on an H100).
    const int n_sub = min(kKeys, n16);
    if (n_in <= 0) continue;

    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (nt * 8 < n_sub) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const __nv_bfloat16* kr = &sk[nt * 8 + g][kk * 16 + 2 * t];
          mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // -inf past the chunk's last key, and in the tiles not multiplied
        const int col = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = nt * 8 < n_sub ? fmaf(s[nt][e], sl2, sbias[col]) : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Key 0 of the chunk is a real key (a masked one carries -1e9, not
    // -inf), so the new maxima are finite and exp2(-inf - m) = 0 handles
    // the first chunk.
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo;
    l_hi *= corr_hi;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= corr_lo; o[nd][1] *= corr_lo;
      o[nd][2] *= corr_hi; o[nd][3] *= corr_hi;
    }
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      if (kc * 16 >= n_sub) continue;
      // The C fragments of key tiles 2kc, 2kc+1 are the A fragment of P,
      // as two bf16 terms (P = hi + lo to 16 bits of mantissa): P is not
      // rounded to bf16, V is bf16 already, the sums are f32.
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const __nv_bfloat16* vr = &svt[nd * 8 + g][kc * 16 + 2 * t];
        const uint32_t b0 = ld32(vr), b1 = ld32(vr + 8);
        mma_bf16(o[nd], lo, b0, b1);
        mma_bf16(o[nd], hi, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  __nv_bfloat16* obase = out + b * os.b + h * os.h;
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(obase + p_lo * os.s + c) =
          pack_bf16(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(obase + p_hi * os.s + c) =
          pack_bf16(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
  }
}

// This thread's A fragments of the 16 query rows from row r0 (fragment rows
// g and g + 8), zero past Sq.
template <int DH>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[DH / 16][4],
                                       const __nv_bfloat16* q, Strides qs,
                                       int b, int h, int r0, int Sq, int g,
                                       int t) {
  const int p_lo = r0 + g, p_hi = p_lo + 8;
  const bool ok_lo = p_lo < Sq, ok_hi = p_hi < Sq;
  const __nv_bfloat16* q_lo = q + b * qs.b + h * qs.h + p_lo * qs.s;
  const __nv_bfloat16* q_hi = q + b * qs.b + h * qs.h + p_hi * qs.s;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ok_lo ? ld32(q_lo + c) : 0u;
    qa[kk][1] = ok_hi ? ld32(q_hi + c) : 0u;
    qa[kk][2] = ok_lo ? ld32(q_lo + c + 8) : 0u;
    qa[kk][3] = ok_hi ? ld32(q_hi + c + 8) : 0u;
  }
}

// One online-softmax step of a warp's 16 rows over NT key tiles of 8:
// `s` holds the logits in the log2 domain (-inf where there is no key) and
// comes back as P; the running maxima and sums and the output are rescaled.
// The tile's first key is a real key (a masked one carries -1e9, not -inf),
// so the new maxima are finite and exp2(-inf - m) = 0 handles the first
// step.
template <int NT, int DH>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4],
                                             float (&o)[DH / 8][4],
                                             float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
  const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  l_lo *= corr_lo;
  l_hi *= corr_hi;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    o[nd][0] *= corr_lo; o[nd][1] *= corr_lo;
    o[nd][2] *= corr_hi; o[nd][3] *= corr_hi;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = exp2f(s[nt][0] - mn_lo);
    s[nt][1] = exp2f(s[nt][1] - mn_lo);
    s[nt][2] = exp2f(s[nt][2] - mn_hi);
    s[nt][3] = exp2f(s[nt][3] - mn_hi);
    l_lo += s[nt][0] + s[nt][1];
    l_hi += s[nt][2] + s[nt][3];
  }
}

// The C fragments of key tiles 2kc and 2kc + 1 are the A fragment of P, as
// two bf16 terms (P = hi + lo to 16 bits of mantissa): P is not rounded to
// bf16, V is bf16 already, the sums are f32.
template <int NT>
__device__ __forceinline__ void p_fragments(const float (&s)[NT][4], int kc,
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
  split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
  split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
  split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
}

// 4 bytes global -> shared, or 4 zero bytes where `live` is false.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Keys staged a chunk: kSplitKeys, fewer (whole 16-row tiles) where Sk
// is shorter.
inline int few_rows(int Sk) {
  const int rows = (Sk + 15) / 16 * 16;
  return rows < kSplitKeys ? rows : kSplitKeys;
}

// The ring (K, V and the bias of `rows` keys a stage), or the warps'
// partials after the last chunk where they need more.
inline int few_shared_bytes(int dh, int rows) {
  const int ring = kStages * rows * (4 * dh + 36), merge = 256 * (dh + 2);
  return ring > merge ? ring : merge;
}

// Few queries (t2i, text self-attention), the twin of `_attention_kernel`
// at Sq <= 32. Bound: bytes, K and V read once (193 MB at B=20, Sk=3137:
// 0.058 ms at 3.35 TB/s; 617 MB at B=64), about 15 operations a byte at
// Sq=15. The memory stays busy only while every block has loads in flight
// as it multiplies. Design:
//   * a block owns every query row of one (batch, head), up to 32, and a
//     run of its keys, so K and V are read once. The grid is (H, splits,
//     B), heads fastest (the heads of a key row are neighbours in a
//     [B, S, H * Dh] projection). `flash_fwd_geometry` splits the keys into
//     runs only where B * H gives fewer blocks than SMs: at B * H >= 132
//     one run a (batch, head) was fastest on an H100 (PERF.md), the bytes
//     in flight of 2-3 blocks an SM already keep the memory busy, and a
//     merge launch costs 3-5 us; below it (EgoMCQ one question at a time,
//     B=5: 60 blocks) three runs and the merge beat one run, 24 against
//     33 us;
//   * the block stages its run in chunks of kSplitKeys keys with 16-byte
//     cp.async into a ring of kStages chunks (zero-filled past the run's
//     last key, the bias beside them), so that the next chunk is in flight
//     while one is multiplied; K and V stay row-major, and ldmatrix hands
//     out the B fragments of QK^T (plain) and of P.V (transposed);
//   * RT row tiles of 16 (1 for Sq <= 16, else 2): the 4 / RT warps of a
//     row tile score their own 32 * RT keys of every chunk, each with its
//     own online softmax, and are merged through shared memory in warp
//     order at the end;
//   * one run: the block writes the output, rounded once. Several: it
//     writes its f32 partial (unnormalised output, running max and sum, in
//     the log2 domain) of each row to `partials` [B, H, splits, Sq, Dh + 2],
//     and fused_merge_kernel combines them in split order,
//     o = sum o_s 2^(m_s - M) / sum l_s 2^(m_s - M): the same bits every
//     run, no atomics. A split whose keys are all masked in a row that has
//     live keys has m_s about -1.4e9 and weighs exactly 0.
// Shared memory (dynamic): kStages x (K and V of `rows` keys, kSplitKeys or
// Sk rounded up to 16 where it is shorter, at a pitch of DH + kPad bf16,
// then their bias, f32): 75 KB at Dh=64, three blocks an SM; after the
// last chunk it holds the warps' partials.
template <int DH, int RT>
__global__ void __launch_bounds__(kWarps * 32)
    fused_split_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials, int H, int Sq, int Sk,
                       int run, int splits, int rows, Strides qs,
                       Strides ks, Strides vs, Strides os, int64_t bias_b,
                       int64_t bias_h, float scale) {
  static_assert(RT == 1 || RT == 2, "one or two row tiles of 16");
  constexpr int kTileWarps = kWarps / RT;  // warps of a row tile
  constexpr int KW = kSplitKeys / kTileWarps;  // keys a warp scores a chunk
  constexpr int NT = KW / 8;               // their 8-key tiles
  constexpr int LD = DH + kPad;
  // bf16 slots a stage: K, V, then the bias (f32, two slots a key)
  const int stage_slots = 2 * rows * LD + 2 * rows;
  // A pass of the threads over a chunk's rows: each thread 16 bytes of a
  // row, kPass rows a pass.
  constexpr int kPass = kWarps * 32 / (DH / 8);
  static_assert(kSplitKeys % kPass == 0, "whole passes a chunk");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  // Heads fastest: the blocks of the heads of a (batch, split) read
  // neighbouring slices of the same key rows of a [B, S, H * Dh]
  // projection, and run side by side.
  const int h = blockIdx.x % H;
  const int split = (blockIdx.x / H) % splits;
  const int b = blockIdx.x / H / splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int rt = warp / kTileWarps;       // this warp's row tile
  const int j0 = (warp % kTileWarps) * KW;  // its first key of every chunk
  const int k_begin = split * run, k_end = min(Sk, k_begin + run);
  const int chunks = (k_end - k_begin + kSplitKeys - 1) / kSplitKeys;
  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;

  // Chunk c into stage c % kStages, as this thread's share of the copies:
  // rows jt, jt + kPass, ... of K and of V, 8 columns from d8.
  const int jt = threadIdx.x / (DH / 8), d8 = (threadIdx.x % (DH / 8)) * 8;
  auto stage = [&](int c) {
    __nv_bfloat16* sK = ring + (c % kStages) * stage_slots;
    __nv_bfloat16* sV = sK + rows * LD;
    const int c0 = k_begin + c * kSplitKeys;
    const __nv_bfloat16* kp = kbase + (int64_t)(c0 + jt) * ks.s + d8;
    const __nv_bfloat16* vp = vbase + (int64_t)(c0 + jt) * vs.s + d8;
#pragma unroll
    for (int r = 0; r < kSplitKeys / kPass; ++r) {
      const int j = jt + r * kPass;
      const bool live = c0 + j < k_end;
      if (j < rows) {
        cp_async16(sK + j * LD + d8, live ? kp : kbase, live);
        cp_async16(sV + j * LD + d8, live ? vp : vbase, live);
      }
      kp += kPass * ks.s;
      vp += kPass * vs.s;
    }
    if (bp && static_cast<int>(threadIdx.x) < rows) {
      const int j = threadIdx.x;
      const bool live = c0 + j < k_end;
      cp_async4(reinterpret_cast<float*>(sK + 2 * rows * LD) + j,
                bp + (live ? c0 + j : 0), live);
    }
  };

  uint32_t qa[DH / 16][4];
  q_fragments<DH>(qa, q, qs, b, h, rt * 16, Sq, g, t);
  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const float sl2 = scale * kLog2e;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();  // one group a chunk, empty past the last
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c are in
    // Everyone's copies of chunk c are in, and chunk c - 1 is consumed:
    // its stage takes chunk c + kStages - 1.
    __syncthreads();
    if (c + kStages - 1 < chunks) stage(c + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sK = ring + (c % kStages) * stage_slots;
    const __nv_bfloat16* sV = sK + rows * LD;
    const float* sB = reinterpret_cast<const float*>(sV + rows * LD);
    const int n_in = min(kSplitKeys, k_end - k_begin - c * kSplitKeys);
    if (j0 >= n_in) continue;  // none of this warp's part: warp-uniform
    const int n_sub = n_in - j0;

    float s[NT][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * np][e] = s[2 * np + 1][e] = 0.f;
      if (np * 16 < n_sub) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t kb[4];
          ldsm4<false>(kb, sK + cols16(LD, j0 + np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // -inf past the run's last key, and in the tiles not multiplied
        const int col = j0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < n_in
                       ? fmaf(s[nt][e], sl2, bp ? sB[col] * kLog2e : 0.f)
                       : -INFINITY;
      }
    }
    softmax_step<NT, DH>(s, o, m_lo, m_hi, l_lo, l_hi);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      if (kc * 16 >= n_sub) continue;
      uint32_t hi[4], lo[4];
      p_fragments<NT>(s, kc, hi, lo);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        uint32_t vb[4];
        ldsm4<true>(vb, sV + rows16(LD, j0 + kc * 16, d0, lane));
        mma_bf16(o[d0 / 8], lo, vb[0], vb[1]);
        mma_bf16(o[d0 / 8], hi, vb[0], vb[1]);
        mma_bf16(o[d0 / 8 + 1], lo, vb[2], vb[3]);
        mma_bf16(o[d0 / 8 + 1], hi, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  // The warps' partials of their 16 rows, through the ring (every group is
  // complete: the last ones are empty). A warp that had no key of the run
  // keeps m = -inf and weighs 0; the first warp of a row tile always has
  // one.
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* mo = reinterpret_cast<float*>(smem);  // [kWarps][16][DH]
  float* mm = mo + kWarps * 16 * DH;           // [kWarps][16] running maxima
  float* ml = mm + kWarps * 16;                // [kWarps][16] running sums
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    float* lo = mo + (warp * 16 + g) * DH + nd * 8 + 2 * t;
    lo[0] = o[nd][0]; lo[1] = o[nd][1];
    lo[8 * DH] = o[nd][2]; lo[8 * DH + 1] = o[nd][3];
  }
  if (t == 0) {
    mm[warp * 16 + g] = m_lo; mm[warp * 16 + g + 8] = m_hi;
    ml[warp * 16 + g] = l_lo; ml[warp * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RT * 16 * (DH / 2); idx += kWarps * 32) {
    const int r = idx / (DH / 2), c = (idx % (DH / 2)) * 2;
    if (r >= Sq) break;  // rows ascend with idx
    const int w0 = (r / 16) * kTileWarps, rr = r % 16;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) mx = fmaxf(mx, mm[(w0 + w) * 16 + rr]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int at = (w0 + w) * 16 + rr;
      const float mw = mm[at];
      const float wgt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      l += ml[at] * wgt;
      a0 += mo[at * DH + c] * wgt;
      a1 += mo[at * DH + c + 1] * wgt;
    }
    if (splits == 1) {
      *reinterpret_cast<uint32_t*>(out + b * os.b + h * os.h + r * os.s + c) =
          pack_bf16(a0 / l, a1 / l);
    } else {
      const int64_t row = ((int64_t)b * H + h) * splits + split;
      float* part = partials + (row * Sq + r) * (DH + 2);
      *reinterpret_cast<float2*>(part + c) = make_float2(a0, a1);
      if (c == 0) *reinterpret_cast<float2*>(part + DH) = make_float2(mx, l);
    }
  }
}

// The merge of the splits' partials: a block a (batch, head), a thread a
// (row, 8 columns), the splits summed in order.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    fused_merge_kernel(const float* __restrict__ partials,
                       __nv_bfloat16* __restrict__ out, int H, int Sq,
                       int splits, Strides os) {
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const float* base = partials + ((int64_t)b * H + h) * splits * Sq * (DH + 2);
  for (int idx = threadIdx.x; idx < Sq * (DH / 8); idx += kWarps * 32) {
    const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
    float mx = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      mx = fmaxf(mx, base[((int64_t)s * Sq + r) * (DH + 2) + DH]);
    }
    float l = 0.f, acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float* p = base + ((int64_t)s * Sq + r) * (DH + 2);
      const float2 ms = *reinterpret_cast<const float2*>(p + DH);
      const float wgt = ms.x == -INFINITY ? 0.f : exp2f(ms.x - mx);
      l += ms.y * wgt;
#pragma unroll
      for (int e = 0; e < kVec; e += 2) {
        const float2 a = *reinterpret_cast<const float2*>(p + c + e);
        acc[e] += a.x * wgt;
        acc[e + 1] += a.y * wgt;
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] /= l;
    store_vec(out + b * os.b + h * os.h + r * os.s + c, acc);
  }
}

}  // namespace mma

template <typename T, int G, bool kWhole>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int H, int Sq, int Sk, int Dh, Strides qs,
           Strides ks, Strides vs, Strides os, int64_t bias_b, int64_t bias_h,
           float scale, cudaStream_t stream) {
  const int rows = kThreads / G;
  const int tiles = (Sq + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * H * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_attention_fwd_kernel<T, G, kWhole>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), H, Sq, Sk, Dh, qs,
      ks, vs, os, bias_b, bias_h, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// Many query rows (i2t): 64 rows a block, 16 a warp.
template <int DH>
int launch_many(const void* q, const void* k, const void* v,
                const float* bias, void* out, int B, int H, int Sq, int Sk,
                Strides qs, Strides ks, Strides vs, Strides os, int64_t bias_b,
                int64_t bias_h, float scale, cudaStream_t stream) {
  const int rows = 16 * mma::kWarps;
  const int tiles = (Sq + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * H * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mma::fused_fwd_kernel<DH><<<(unsigned)blocks, mma::kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(out), H, Sq, Sk, qs, ks, vs, os, bias_b,
      bias_h, tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

// Few query rows (t2i, text self-attention): the split kernel on the
// geometry given, then the merge where there is more than one split.
template <int DH, int RT>
int launch_split(const void* q, const void* k, const void* v,
                 const float* bias, void* out, float* partials, int B, int H,
                 int Sq, int Sk, int run, int splits, int rows, Strides qs,
                 Strides ks, Strides vs, Strides os, int64_t bias_b,
                 int64_t bias_h, float scale, int shared_bytes,
                 cudaStream_t stream) {
  const int64_t blocks = (int64_t)splits * H * B;
  if (blocks > 0x7fffffffLL || (int64_t)B * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = mma::fused_split_kernel<DH, RT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* op = static_cast<__nv_bfloat16*>(out);
  kernel<<<(unsigned)blocks, mma::kWarps * 32, shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, op, partials, H, Sq, Sk,
      run, splits, rows, qs, ks, vs, os, bias_b, bias_h, scale);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return static_cast<int>(launched);
  mma::fused_merge_kernel<DH>
      <<<(unsigned)(B * H), mma::kWarps * 32, 0, stream>>>(partials, op, H,
                                                          Sq, splits, os);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_few(const void* q, const void* k, const void* v, const float* bias,
               void* out, float* partials, int B, int H, int Sq, int Sk,
               int run, int splits, int rows, int row_tiles, Strides qs,
               Strides ks, Strides vs, Strides os, int64_t bias_b,
               int64_t bias_h, float scale, int shared_bytes,
               cudaStream_t stream) {
  auto launch = row_tiles == 1 ? launch_split<DH, 1> : launch_split<DH, 2>;
  return launch(q, k, v, bias, out, partials, B, H, Sq, Sk, run, splits, rows,
                qs, ks, vs, os, bias_b, bias_h, scale, shared_bytes, stream);
}

template <typename T>
int dispatch_group(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int H, int Sq, int Sk,
                   int Dh, Strides qs, Strides ks, Strides vs, Strides os,
                   int64_t bias_b, int64_t bias_h, float scale,
                   cudaStream_t stream) {
#define EGOVLP_LAUNCH(G)                                                     \
  return Dh % kVec == 0                                                      \
             ? launch<T, G, true>(q, k, v, bias, out, B, H, Sq, Sk, Dh, qs,  \
                                  ks, vs, os, bias_b, bias_h, scale, stream) \
             : launch<T, G, false>(q, k, v, bias, out, B, H, Sq, Sk, Dh, qs, \
                                   ks, vs, os, bias_b, bias_h, scale, stream)
  switch (group_size(Dh)) {
    case 1: EGOVLP_LAUNCH(1);
    case 2: EGOVLP_LAUNCH(2);
    case 4: EGOVLP_LAUNCH(4);
    case 8: EGOVLP_LAUNCH(8);
    case 16: EGOVLP_LAUNCH(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EGOVLP_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `bias` may be null (no bias). Strides
// are in elements; the Python wrapper has checked the shapes, the dtype,
// that the head dim is contiguous and at most 128, and, where the head dim
// is a multiple of 8, that every pointer and stride keeps 16-byte
// alignment. The geometry is `flash_fwd_geometry`'s (ops/_kernels.py):
// `form` 0 (CUDA cores), 1 (many queries) or 2 (few queries), and for the
// few-query form `run` keys a block, `splits` = ceil(Sk / run) blocks a
// (batch, head), `row_tiles` of 16 query rows, a ring of `stages` chunks in
// `shared_bytes` of dynamic shared memory, and `partials` (f32 [B, H,
// splits, Sq, Dh + 2], null at one split). It is launched as given; a form
// other than the one the dtype, Dh and Sq call for, or a few-query geometry
// that does not hold together, is refused (CUDA error 1, invalid argument).
int fused_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* partials, int dtype,
                        int B, int H, int Sq, int Sk, int Dh, int64_t q_b,
                        int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h,
                        int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s,
                        int64_t o_b, int64_t o_h, int64_t o_s, int64_t bias_b,
                        int64_t bias_h, float scale, int form, int run,
                        int splits, int row_tiles, int stages,
                        int shared_bytes, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool tensor_cores = dtype == 1 && (Dh == 32 || Dh == 64 || Dh == 128);
  const int expected = !tensor_cores ? 0 : Sq <= mma::kFewRows ? 2 : 1;
  if (form != expected) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  const float* bias_f = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    return dtype == 0
               ? dispatch_group<float>(q, k, v, bias_f, out, B, H, Sq, Sk, Dh,
                                       qs, ks, vs, os, bias_b, bias_h, scale, s)
               : dispatch_group<__nv_bfloat16>(q, k, v, bias_f, out, B, H, Sq,
                                               Sk, Dh, qs, ks, vs, os, bias_b,
                                               bias_h, scale, s);
  }
  if (form == 1) {
#define EGOVLP_MANY(DH)                                                       \
  return launch_many<DH>(q, k, v, bias_f, out, B, H, Sq, Sk, qs, ks, vs, os, \
                         bias_b, bias_h, scale, s)
    if (Dh == 32) EGOVLP_MANY(32);
    if (Dh == 64) EGOVLP_MANY(64);
    EGOVLP_MANY(128);
#undef EGOVLP_MANY
  }
  if (run < mma::kSplitKeys || run % mma::kSplitKeys ||
      splits != (Sk + run - 1) / run ||
      row_tiles != (Sq <= 16 ? 1 : 2) || stages != mma::kStages ||
      shared_bytes != mma::few_shared_bytes(Dh, mma::few_rows(Sk)) ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define EGOVLP_FEW(DH)                                                         \
  return launch_few<DH>(q, k, v, bias_f, out, part, B, H, Sq, Sk, run, splits, \
                        mma::few_rows(Sk), row_tiles, qs, ks, vs, os,          \
                        bias_b, bias_h, scale, shared_bytes, s)
  if (Dh == 32) EGOVLP_FEW(32);
  if (Dh == 64) EGOVLP_FEW(64);
  EGOVLP_FEW(128);
#undef EGOVLP_FEW
}

}  // extern "C"
