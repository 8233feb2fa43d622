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
// float32, and the output is rounded once to the input dtype. The 3xTF32
// forms raise q, k and v to float32 and multiply them to about f32
// precision; the bf16 forms multiply bf16 q
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
// In float32 the bytes double and the operations stay: at the EgoTaskQA
// shapes (B=8, Sq or Sk 785 over 15) 38.6 MB, 11.7 us, for 145 M FMAs.
// Five forms, the one that `flash_fwd_geometry` (ops/_kernels.py) names;
// the entry point refuses any other:
//   * few queries (bf16, Dh 32, 64 or 128, Sq <= 32: t2i and text
//     self-attention): mma::fused_split_kernel, the keys of a (batch, head)
//     split over blocks and staged with cp.async, then
//     fused_merge_kernel where there is more than one split; described
//     there;
//   * many queries (bf16, Dh 32, 64 or 128, Sq > 32: i2t) over at most 64
//     keys: mma::fused_ring_kernel, a block a (batch, head) and a run of
//     its rows, K and V staged once, the rows streamed through a ring of
//     slabs a warp; described there. Over more keys, or where
//     `flash_fwd_geometry` keeps it, mma::fused_fwd_kernel, the chunked
//     walk of 64 rows a block;
//   * float32 at any head dim up to 128, and bf16 at any other (a bf16 row
//     is widened to f32 as it is staged), the same two structures in
//     3xTF32 on the tensor cores: few queries
//     tf32::fused_tf32_split_kernel (then fused_merge_kernel where there
//     is more than one split), many queries tf32::fused_tf32_fwd_kernel;
//     described there.
// No atomics in any form: two runs give the same bits.

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements between the batches, heads and sequence rows of one tensor.
struct Strides {
  int64_t b, h, s;
};

// 16 bytes global -> shared, or 16 zero bytes where `live` is false.
__device__ __forceinline__ void cp_async16f(float* dst, const float* src,
                                            bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
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

// Many queries over any number of keys, chunked (i2t before the ring form;
// now the many-query form above kRingKeys keys). Bound: bytes; on the
// tensor cores a (row, key) pair costs a few issue slots, so the loads
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

// The ring form's keys: at most kRingKeys, one chunk; its slabs of query
// rows, kRingSlab a warp at a time, kRingStages of them in a warp's ring
// (one in flight while one is multiplied: 3 and 4 were no faster on an
// H100, PERF.md).
constexpr int kRingKeys = 64;
constexpr int kRingSlab = 16;
constexpr int kRingStages = 2;

// Key tiles of 16 the ring form is compiled for at Sk keys: 1, 2 or 4.
inline int ring_key_tiles(int Sk) { return Sk <= 16 ? 1 : Sk <= 32 ? 2 : 4; }

// The ring form's shared memory: K and V of 16 x key_tiles keys at a pitch
// of dh + kPad bf16, each warp's ring of kRingStages slabs at the same pitch,
// then the bias row (f32).
inline int ring_shared_bytes(int dh, int key_tiles) {
  const int ld = dh + kPad, keys = 16 * key_tiles;
  return 2 * (2 * keys + kWarps * kRingStages * kRingSlab) * ld + 4 * keys;
}

// Many queries over at most kRingKeys keys (i2t: Sq = 785..6273 over
// Sk = 15..30), the twin of `_attention_kernel` there. Bound: bytes, q read
// and the output written once (617 MB at B=64, Sq=3137: 0.18 ms at
// 3.35 TB/s); a (row, key) pair costs a few tensor-core issue slots. So the
// design keeps loads in flight and pays nothing again for each tile of rows:
//   * a block owns one (batch, head) and a run of `rows` of its query rows
//     (`flash_fwd_geometry`: the grid (H, splits, B), heads fastest, so
//     that the blocks of the heads of a run read neighbouring slices of the
//     same rows of a [B, S, H * Dh] projection). It stages the K and V rows
//     of its (batch, head) once by cp.async (KT tiles of 16 keys, zero past
//     Sk) and the bias row times log2 e (-inf past Sk), then synchronises
//     once;
//   * each warp then walks its slabs of 16 query rows (the run's slabs
//     warp, warp + 4, ...) on its own through a ring of kRingStages stages
//     of its own: the next slab's 16-byte cp.async in flight while one is
//     multiplied, its A fragments read by ldmatrix. No block barrier after
//     the staging;
//   * the keys are one chunk, so the softmax is one pass: the logits, their
//     maximum, exp2, the sum; no rescale. The arithmetic and its order are
//     fused_fwd_kernel's at one chunk (the same mma products in the same
//     order, P as hi + lo bf16 terms), so the two give the same bits;
//   * the output leaves through the slab's own stage: the warp writes its
//     16 bf16 rows there and stores them as whole 16-byte pieces of rows.
template <int DH, int KT>
__global__ void __launch_bounds__(kWarps * 32)
    fused_ring_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk,
                      int rows, int splits, Strides qs, Strides ks,
                      Strides vs, Strides os, int64_t bias_b, int64_t bias_h,
                      float scale) {
  constexpr int S = kRingStages;
  static_assert(S >= 2, "a slab in flight while one is multiplied");
  constexpr int LD = DH + kPad;
  constexpr int kKeysP = 16 * KT;            // key rows staged
  constexpr int kSlab = kRingSlab * LD;      // bf16 of a stage
  constexpr int kPieces = kRingSlab * DH / 8 / 32;  // 16-byte pieces a lane
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kKeysP * LD;
  __nv_bfloat16* ring = sV + kKeysP * LD;  // [kWarps][S][kRingSlab][LD]
  float* sbias = reinterpret_cast<float*>(ring + kWarps * S * kSlab);

  const int h = blockIdx.x % H;
  const int split = (blockIdx.x / H) % splits;
  const int b = blockIdx.x / H / splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int r_begin = split * rows, r_end = min(Sq, r_begin + rows);
  const int n16 = (Sk + 15) / 16 * 16;    // key rows staged: whole mma tiles

  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;
  for (int i = threadIdx.x; i < n16 * (DH / 8); i += kWarps * 32) {
    const int j = i / (DH / 8), d8 = (i % (DH / 8)) * 8;
    const bool live = j < Sk;
    cp_async16(sK + j * LD + d8, live ? kbase + j * ks.s + d8 : kbase, live);
    cp_async16(sV + j * LD + d8, live ? vbase + j * vs.s + d8 : vbase, live);
  }
  cp_async_commit();
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;
  if (threadIdx.x < kKeysP) {
    const int j = threadIdx.x;
    sbias[j] = j < Sk ? (bp ? __ldg(bp + j) * kLog2e : 0.f) : -INFINITY;
  }

  // This warp's slabs i = 0, 1, ...: the run's slab warp + i * kWarps, into
  // stage i % S, as 16-byte pieces, zero past the run's last row.
  const int slabs = (r_end - r_begin + kRingSlab - 1) / kRingSlab;
  const int mine = slabs > warp ? (slabs - warp + kWarps - 1) / kWarps : 0;
  __nv_bfloat16* wring = ring + warp * S * kSlab;
  const __nv_bfloat16* qbase = q + b * qs.b + h * qs.h;
  __nv_bfloat16* obase = out + b * os.b + h * os.h;
  auto load = [&](int i) {
    __nv_bfloat16* st = wring + (i % S) * kSlab;
    const int r0 = r_begin + (warp + i * kWarps) * kRingSlab;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int piece = lane + 32 * p;
      const int r = piece / (DH / 8), d8 = (piece % (DH / 8)) * 8;
      const bool live = r0 + r < r_end;
      cp_async16(st + r * LD + d8,
                 live ? qbase + (int64_t)(r0 + r) * qs.s + d8 : qbase, live);
    }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();  // one group a slab, empty past the last
  }
  cp_async_wait<S - 1>();  // the K/V group, committed first, is in
  __syncthreads();         // everyone's K, V and bias are

  const float sl2 = scale * kLog2e;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<S - 2>();  // this lane's pieces of slab i are in
    __syncwarp();            // and every lane's; slab i - 1's stage is free
    if (i + S - 1 < mine) load(i + S - 1);
    cp_async_commit();
    __nv_bfloat16* st = wring + (i % S) * kSlab;
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      ldsm4<false>(qa[kk], st + rows16(LD, 0, kk * 16, lane));
    }
    float s[2 * KT][4];
#pragma unroll
    for (int np = 0; np < KT; ++np) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * np][e] = s[2 * np + 1][e] = 0.f;
      if (np * 16 < n16) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t kb[4];
          ldsm4<false>(kb, sK + cols16(LD, np * 16, kk * 16, lane));
          mma_bf16(s[2 * np], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // -inf past the last key, and in the tiles not multiplied
        const int col = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = nt * 8 < n16 ? fmaf(s[nt][e], sl2, sbias[col]) : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Key 0 is a real key (a masked one carries -1e9, not -inf): the maxima
    // are finite.
    float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx_lo);
      s[nt][1] = exp2f(s[nt][1] - mx_lo);
      s[nt][2] = exp2f(s[nt][2] - mx_hi);
      s[nt][3] = exp2f(s[nt][3] - mx_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
    float o[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      if (kc * 16 >= n16) continue;
      uint32_t hi[4], lo[4];
      p_fragments<2 * KT>(s, kc, hi, lo);
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        uint32_t vb[4];
        ldsm4<true>(vb, sV + rows16(LD, kc * 16, d0, lane));
        mma_bf16(o[d0 / 8], lo, vb[0], vb[1]);
        mma_bf16(o[d0 / 8], hi, vb[0], vb[1]);
        mma_bf16(o[d0 / 8 + 1], lo, vb[2], vb[3]);
        mma_bf16(o[d0 / 8 + 1], hi, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    __syncwarp();  // every lane's reads of the stage are done
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      __nv_bfloat16* r = st + g * LD + nd * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(r) =
          pack_bf16(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
      *reinterpret_cast<uint32_t*>(r + 8 * LD) =
          pack_bf16(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
    __syncwarp();
    const int r0 = r_begin + (warp + i * kWarps) * kRingSlab;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int piece = lane + 32 * p;
      const int r = piece / (DH / 8), d8 = (piece % (DH / 8)) * 8;
      if (r0 + r < r_end) {
        *reinterpret_cast<uint4*>(obase + (int64_t)(r0 + r) * os.s + d8) =
            *reinterpret_cast<const uint4*>(st + r * LD + d8);
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the last slab
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

}  // namespace mma

// The merge of the splits' partials of a few-query form: a block a (batch,
// head), a thread a (row, 8 columns), the splits summed in order; stored
// as T, by vectors where `vec` (rows of whole, aligned 16-byte words) and
// the 8 columns lie in the head dim.
template <typename T>
__global__ void __launch_bounds__(128)
    fused_merge_kernel(const float* __restrict__ partials,
                       T* __restrict__ out, int H, int Sq, int Dh, int splits,
                       Strides os, bool vec) {
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int pitch = Dh + 2, groups = (Dh + kVec - 1) / kVec;
  const float* base = partials + ((int64_t)b * H + h) * splits * Sq * pitch;
  for (int idx = threadIdx.x; idx < Sq * groups; idx += 128) {
    const int r = idx / groups, c = (idx % groups) * kVec;
    const int n = min(kVec, Dh - c);
    float mx = -INFINITY;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      mx = fmaxf(mx, base[((int64_t)s * Sq + r) * pitch + Dh]);
    }
    float l = 0.f, acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float* p = base + ((int64_t)s * Sq + r) * pitch;
      const float ms = p[Dh];
      const float wgt = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      l += p[Dh + 1] * wgt;
      if (pitch % 2 == 0 && n == kVec) {  // 8-byte aligned pairs
#pragma unroll
        for (int e = 0; e < kVec; e += 2) {
          const float2 a = *reinterpret_cast<const float2*>(p + c + e);
          acc[e] += a.x * wgt;
          acc[e + 1] += a.y * wgt;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          if (e < n) acc[e] += p[c + e] * wgt;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] /= l;
    T* o = out + b * os.b + h * os.h + r * os.s + c;
    if (vec && n == kVec) {
      store_vec(o, acc);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (e < n) store_one(o + e, acc[e]);
      }
    }
  }
}

// The float32 forms, and bf16 at a head dim other than 32, 64 or 128
// (widened to f32 as it is staged): both products on the tensor cores as
// 3xTF32 mma.sync m16n8k8. Every f32 operand x is split into x_hi =
// tf32(x) and x_lo = tf32(x - x_hi), and a product is a_lo b_hi + a_hi b_lo
// + a_hi b_hi (the small terms first) with f32 sums: about the error of an
// f32 product (a_lo b_lo, 2^-22 of it, is dropped). On the CUDA cores a
// broadcast float4 of K or V feeds 4 FMAs, and the SM's shared memory
// hands its registers 128 bytes a clock against 128 FMAs, so such a loop
// runs at a quarter of the FMA rate at best (PERF.md); an mma reads each
// staged element once a warp for 8-16 products.
//
// The tiles are f32 in shared memory, the head dim padded with zeros to DHP
// (16, 32, 64 or 128): Q and K rows at a pitch of DHP + 8 floats, so that
// the float2 fragment loads of 8 rows by 4 lanes lie in distinct banks; V
// rows at DHP + 4, so that the scalar loads of rows 2t and 2t + 1 by 4
// lanes t do. The reduction dims are permuted inside each 8-step so that
// fragment column t is element 2t and column t + 4 element 2t + 1: a lane's
// two A (or B) values of a row are one float2, and the C fragment of S is
// the A fragment of P as it stands (no shuffle).
namespace tf32 {

constexpr int kWarps = 4;
constexpr int kBlock = 32 * kWarps;
constexpr int kChunk = 32;  // keys a staged chunk (few queries)
constexpr int kStages = 2;  // chunks in the ring (few queries)
constexpr int kFwdChunk = 16;  // keys a staged chunk (many queries)

inline __host__ __device__ int padded_dh(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128;
}

// Keys staged a chunk: kChunk, or Sk rounded up to `unit` where shorter.
inline __host__ __device__ int staged_keys(int Sk, int unit) {
  const int rows = (Sk + unit - 1) / unit * unit;
  return rows < kChunk ? rows : kChunk;
}

// Many queries: the 64-row Q tile (then the output), K, V and the bias of a
// chunk of kFwdChunk keys.
inline int fwd_shared_bytes(int dh) {
  const int dhp = padded_dh(dh);
  return 4 * (16 * kWarps * (dhp + 8) + kFwdChunk * (2 * dhp + 12) +
              kFwdChunk);
}

// Few queries: the ring (K, V and the bias of `keys` keys a stage) and Q;
// after the last chunk the warps' partials, where they need more.
inline int split_shared_bytes(int dh, int Sk, int row_tiles) {
  const int dhp = padded_dh(dh);
  const int keys = staged_keys(Sk, kChunk * row_tiles / kWarps);
  const int main = kStages * (keys * (2 * dhp + 12) + keys) +
                   16 * row_tiles * (dhp + 8);
  const int merge = kWarps * 16 * dhp + 2 * kWarps * 16;
  return 4 * (main > merge ? main : merge);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a and b split already.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// The A fragment, split, of the 16 rows from `r` (pitch ld: rows g and
// g + 8) at the 8-step from column k0.
__device__ __forceinline__ void a_fragment(const float* r, int ld, int k0,
                                           int g, int t, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(r + g * ld + k0 + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(r + (g + 8) * ld + k0 + 2 * t);
  split_tf32(x0.x, hi[0], lo[0]);
  split_tf32(x1.x, hi[1], lo[1]);
  split_tf32(x0.y, hi[2], lo[2]);
  split_tf32(x1.y, hi[3], lo[3]);
}

// S += Q K^T over the padded head dim for NT tiles of 8 keys from `sk`
// (pitch DHP + 8), only those before `n_sub`; Q's 16 rows from `qw`.
template <int DHP, int NT>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* qw,
                                       const float* sk, int n_sub, int g,
                                       int t) {
  constexpr int LQ = DHP + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DHP; k0 += 8) {
    uint32_t ah[4], al[4];
    a_fragment(qw, LQ, k0, g, t, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * 8 < n_sub) {  // warp-uniform
        const float2 kv = *reinterpret_cast<const float2*>(
            sk + (nt * 8 + g) * LQ + k0 + 2 * t);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kv.x, bh0, bl0);
        split_tf32(kv.y, bh1, bl1);
        mma3(s[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// O += P V for the NT tiles of 8 keys before `n_sub`: P is the C fragment
// of S as it stands (A column t is key 2t, t + 4 key 2t + 1), V from `sv`
// (pitch DHP + 4).
template <int DHP, int NT>
__device__ __forceinline__ void values(float (&o)[DHP / 8][4],
                                       const float (&p)[NT][4],
                                       const float* sv, int n_sub, int g,
                                       int t) {
  constexpr int LV = DHP + 4;
#pragma unroll
  for (int kt = 0; kt < NT; ++kt) {
    if (kt * 8 >= n_sub) continue;  // warp-uniform
    uint32_t ah[4], al[4];
    split_tf32(p[kt][0], ah[0], al[0]);
    split_tf32(p[kt][2], ah[1], al[1]);
    split_tf32(p[kt][1], ah[2], al[2]);
    split_tf32(p[kt][3], ah[3], al[3]);
    const float* v0 = sv + (kt * 8 + 2 * t) * LV + g;
#pragma unroll
    for (int nd = 0; nd < DHP / 8; ++nd) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(v0[nd * 8], bh0, bl0);
      split_tf32(v0[LV + nd * 8], bh1, bl1);
      mma3(o[nd], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The logits of NT key tiles in the log2 domain: s scale log2 e + bias
// log2 e for the keys before n_in (columns c0 + 8 nt + 2t + {0, 1}), -inf
// past them.
template <int NT>
__device__ __forceinline__ void logits(float (&s)[NT][4], const float* sb,
                                       bool has_bias, int c0, int n_in,
                                       float sl2, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + nt * 8 + 2 * t + (e & 1);
      s[nt][e] = col < n_in
                     ? fmaf(s[nt][e], sl2, has_bias ? sb[col] * kLog2e : 0.f)
                     : -INFINITY;
    }
  }
}

// Four elements from p, of which n (1..4) lie inside the head dim, as f32.
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n) {
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = e < n ? widen(__ldg(p + e)) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Rows [0, rows) of an f32 tile of `width` floats (a multiple of 4) at
// pitch ld from rows [0, live) of `src`, `stride` elements apart; zero past
// `live` and past Dh. By 16-byte cp.async where `vec` (f32 rows of whole,
// aligned float4s), else by loads widened to f32 and stored. The caller
// commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int width,
                                           const T* src, int64_t stride,
                                           int rows, int live, int Dh,
                                           bool vec) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < rows * w4; i += kBlock) {
    const int r = i / w4, c = (i % w4) * 4;
    const bool on = r < live && c < Dh;
    float* d = dst + r * ld + c;
    const T* s = on ? src + r * stride + c : src;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        cp_async16f(d, s, on);
        continue;
      }
    }
    *reinterpret_cast<float4*>(d) =
        on ? load4(s, min(4, Dh - c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The bias of keys [0, rows) from bias row `bp` (raw: times log2 e where it
// is read), zero past `live`.
__device__ __forceinline__ void stage_bias(float* dst, const float* bp,
                                           int rows, int live) {
  for (int j = threadIdx.x; j < rows; j += kBlock) {
    cp_async4(dst + j, bp + (j < live ? j : 0), j < live);
  }
}

// Many queries (i2t: Sq > 32 over Sk = 15..30 keys), the twin of
// `_attention_kernel` there. Bound: bytes, q read and the output written
// once (38.6 MB in f32 at B=8, Sq=785: 11.7 us). Design, mma::fused_fwd_kernel's
// in 3xTF32: a block of 4 warps owns 64 query rows of one (batch, head),
// 16 a warp; it stages the Q tile coalesced (cp.async) and the keys in
// chunks of kFwdChunk = 16 (one at i2t's 15 keys: two score tiles keep
// the registers low and so the blocks an SM many; 64-key chunks ran slower
// on an H100), K, V and the bias row; a warp takes its A
// fragments of Q from the tile at each 8-step, runs the online softmax in
// the log2 domain on the C fragments, and the output goes back through the
// Q tile (each warp its own rows) and out coalesced.
template <typename T, int DHP>
__global__ void __launch_bounds__(kBlock)
    fused_tf32_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int H, int Sq, int Sk, int Dh, Strides qs,
                          Strides ks, Strides vs, Strides os, int64_t bias_b,
                          int64_t bias_h, int tiles, float scale, bool vec) {
  constexpr int LQ = DHP + 8, LV = DHP + 4, kRows = 16 * kWarps;
  constexpr int NT = kFwdChunk / 8, keys = kFwdChunk;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kRows][LQ]
  float* sK = sQ + kRows * LQ;                   // [keys][LQ]
  float* sV = sK + keys * LQ;                    // [keys][LV]
  float* sB = sV + keys * LV;                    // [keys]

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / tiles / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int row0 = tile * kRows;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;
  stage_rows(sQ, LQ, DHP, q + b * qs.b + h * qs.h + row0 * qs.s, qs.s, kRows,
             Sq - row0, Dh, vec);

  float o[DHP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const float sl2 = scale * kLog2e;
  float* qw = sQ + warp * 16 * LQ;  // this warp's 16 rows
  for (int c0 = 0; c0 < Sk; c0 += keys) {
    const int n_in = min(keys, Sk - c0);
    if (c0 > 0) __syncthreads();  // the previous chunk is consumed
    stage_rows(sK, LQ, DHP, kbase + c0 * ks.s, ks.s, keys, n_in, Dh, vec);
    stage_rows(sV, LV, DHP, vbase + c0 * vs.s, vs.s, keys, n_in, Dh, vec);
    if (bp) stage_bias(sB, bp + c0, keys, n_in);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[NT][4];
    scores<DHP, NT>(s, qw, sK, n_in, g, t);
    logits<NT>(s, sB, bp != nullptr, 0, n_in, sl2, t);
    mma::softmax_step<NT, DHP>(s, o, m_lo, m_hi, l_lo, l_hi);
    values<DHP, NT>(o, s, sV, n_in, g, t);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  __syncwarp();  // the warp's reads of its Q rows are done
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd) {
    float* r = qw + g * LQ + nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(r) = make_float2(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    *reinterpret_cast<float2*>(r + 8 * LQ) =
        make_float2(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
  }
  __syncthreads();
  const int w4 = (Dh + 3) / 4;
  T* obase = out + b * os.b + h * os.h + row0 * os.s;
  for (int i = threadIdx.x; i < kRows * w4; i += kBlock) {
    const int r = i / w4, c = (i % w4) * 4;
    if (row0 + r >= Sq) break;  // rows ascend with i
    const float* o4 = sQ + r * LQ + c;
    T* dst = obase + r * os.s + c;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(o4);
        continue;
      }
    }
    const int n = min(4, Dh - c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) store_one(dst + e, o4[e]);
    }
  }
}

// Few queries (t2i, text self-attention: Sq <= 32), the twin of
// `_attention_kernel` there. Bound: bytes, K and V read once (38.6 MB in
// f32 at B=8, Sk=785: 11.7 us). Design, mma::fused_split_kernel's in
// 3xTF32: a block owns every query row of one (batch, head), up to 32, and
// a run of its keys (the grid (H, splits, B), heads fastest; more than one
// run only where B * H gives fewer blocks than SMs, and fused_merge_kernel
// merges the f32 partials in split order); the run is staged in chunks of
// kChunk = 32 keys (K, V, the bias) by cp.async into a ring of kStages, the
// next chunk in flight while one is multiplied, the Q rows once beside
// them (41 KB at Dh=64: five blocks an SM; 64-key chunks ran slower on an
// H100); RT row tiles of 16 (1 for Sq <= 16, else 2): the 4 / RT warps of a
// row tile score their own KW = 8 RT keys of every chunk, each with its own
// online softmax, and are merged through shared memory in warp order at
// the end.
template <typename T, int DHP, int RT>
__global__ void __launch_bounds__(kBlock)
    fused_tf32_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            T* __restrict__ out, float* __restrict__ partials,
                            int H, int Sq, int Sk, int Dh, int run, int splits,
                            Strides qs, Strides ks, Strides vs, Strides os,
                            int64_t bias_b, int64_t bias_h, float scale,
                            bool vec) {
  static_assert(RT == 1 || RT == 2, "one or two row tiles of 16");
  constexpr int LQ = DHP + 8, LV = DHP + 4;
  constexpr int kTileWarps = kWarps / RT;  // warps of a row tile
  constexpr int KW = kChunk / kTileWarps;  // keys a warp scores a chunk
  constexpr int NT = KW / 8;               // their 8-key tiles
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int rows = staged_keys(Sk, KW);
  const int stage_floats = rows * (LQ + LV) + rows;  // K, V, bias
  float* sQ = smem + kStages * stage_floats;         // [16 RT][LQ]

  // Heads fastest: the blocks of the heads of a (batch, split) read
  // neighbouring slices of the same key rows of a [B, S, H * Dh]
  // projection, and run side by side.
  const int h = blockIdx.x % H;
  const int split = (blockIdx.x / H) % splits;
  const int b = blockIdx.x / H / splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int rt = warp / kTileWarps;         // this warp's row tile
  const int j0 = (warp % kTileWarps) * KW;  // its first key of every chunk
  const int k_begin = split * run, k_end = min(Sk, k_begin + run);
  const int chunks = (k_end - k_begin + kChunk - 1) / kChunk;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;

  // Chunk c into stage c % kStages.
  auto stage = [&](int c) {
    float* sK = smem + (c % kStages) * stage_floats;
    const int c0 = k_begin + c * kChunk;
    const int live = min(rows, k_end - c0);
    stage_rows(sK, LQ, DHP, kbase + c0 * ks.s, ks.s, rows, live, Dh, vec);
    stage_rows(sK + rows * LQ, LV, DHP, vbase + c0 * vs.s, vs.s, rows, live,
               Dh, vec);
    if (bp) stage_bias(sK + rows * (LQ + LV), bp + c0, rows, live);
  };

  stage_rows(sQ, LQ, DHP, q + b * qs.b + h * qs.h, qs.s, 16 * RT, Sq, Dh,
             vec);
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();  // one group a chunk (Q with the first), empty past the last
  }
  float o[DHP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const float sl2 = scale * kLog2e;
  const float* qw = sQ + rt * 16 * LQ;  // this warp's row tile

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk c are in
    // Everyone's copies of chunk c are in, and chunk c - 1 is consumed:
    // its stage takes chunk c + kStages - 1.
    __syncthreads();
    if (c + kStages - 1 < chunks) stage(c + kStages - 1);
    cp_async_commit();
    const float* sK = smem + (c % kStages) * stage_floats;
    const float* sV = sK + rows * LQ;
    const float* sB = sV + rows * LV;
    const int n_in = min(kChunk, k_end - k_begin - c * kChunk);
    if (j0 >= n_in) continue;  // none of this warp's keys: warp-uniform
    const int n_sub = n_in - j0;
    float s[NT][4];
    scores<DHP, NT>(s, qw, sK + j0 * LQ, n_sub, g, t);
    logits<NT>(s, sB, bp != nullptr, j0, n_in, sl2, t);
    mma::softmax_step<NT, DHP>(s, o, m_lo, m_hi, l_lo, l_hi);
    values<DHP, NT>(o, s, sV + j0 * LV, n_sub, g, t);
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
  float* mo = smem;                    // [kWarps][16][DHP]
  float* mm = mo + kWarps * 16 * DHP;  // [kWarps][16] running maxima
  float* ml = mm + kWarps * 16;        // [kWarps][16] running sums
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd) {
    float* lo = mo + (warp * 16 + g) * DHP + nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(lo) = make_float2(o[nd][0], o[nd][1]);
    *reinterpret_cast<float2*>(lo + 8 * DHP) = make_float2(o[nd][2], o[nd][3]);
  }
  if (t == 0) {
    mm[warp * 16 + g] = m_lo; mm[warp * 16 + g + 8] = m_hi;
    ml[warp * 16 + g] = l_lo; ml[warp * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Sq * Dh; idx += kBlock) {
    const int r = idx / Dh, c = idx % Dh;
    const int w0 = (r / 16) * kTileWarps, rr = r % 16;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) mx = fmaxf(mx, mm[(w0 + w) * 16 + rr]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      const int at = (w0 + w) * 16 + rr;
      const float mw = mm[at];
      const float wgt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      lsum += ml[at] * wgt;
      a += mo[at * DHP + c] * wgt;
    }
    if (splits == 1) {
      store_one(out + b * os.b + h * os.h + r * os.s + c, a / lsum);
    } else {
      const int64_t prow = ((int64_t)b * H + h) * splits + split;
      float* p = partials + (prow * Sq + r) * (Dh + 2);
      p[c] = a;
      if (c == 0) {
        p[Dh] = mx;
        p[Dh + 1] = lsum;
      }
    }
  }
}

}  // namespace tf32


// Many query rows over at most kRingKeys keys (i2t): the ring form at the
// geometry given, `rows` query rows a block, `splits` blocks a (batch,
// head).
template <int DH, int KT>
int launch_ring_at(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int B, int H, int Sq, int Sk,
                   int rows, int splits, Strides qs, Strides ks, Strides vs,
                   Strides os, int64_t bias_b, int64_t bias_h, float scale,
                   int shared_bytes, cudaStream_t stream) {
  auto kernel = mma::fused_ring_kernel<DH, KT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)((int64_t)splits * H * B), mma::kWarps * 32,
           shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(out), H, Sq, Sk, rows, splits, qs, ks, vs,
      os, bias_b, bias_h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_ring(const void* q, const void* k, const void* v,
                const float* bias, void* out, int B, int H, int Sq, int Sk,
                int rows, int splits, Strides qs, Strides ks, Strides vs,
                Strides os, int64_t bias_b, int64_t bias_h, float scale,
                int shared_bytes, cudaStream_t stream) {
  const int kt = mma::ring_key_tiles(Sk);
  auto launch = kt == 1   ? launch_ring_at<DH, 1>
                : kt == 2 ? launch_ring_at<DH, 2>
                          : launch_ring_at<DH, 4>;
  return launch(q, k, v, bias, out, B, H, Sq, Sk, rows, splits, qs, ks, vs,
                os, bias_b, bias_h, scale, shared_bytes, stream);
}

// Many query rows over any number of keys, in chunks (i2t before the ring
// form; the form above kRingKeys keys): 64 rows a block, 16 a warp.
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

// The merge launch of a few-query form after its split kernel, where there
// is more than one split.
template <typename T>
int launch_merge(const float* partials, void* out, int B, int H, int Sq,
                 int Dh, int splits, Strides os, bool vec,
                 cudaStream_t stream) {
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return static_cast<int>(launched);
  fused_merge_kernel<T><<<(unsigned)(B * H), 128, 0, stream>>>(
      partials, static_cast<T*>(out), H, Sq, Dh, splits, os, vec);
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
  auto kernel = mma::fused_split_kernel<DH, RT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)((int64_t)splits * H * B), mma::kWarps * 32,
           shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(out), partials, H, Sq, Sk, run, splits,
      rows, qs, ks, vs, os, bias_b, bias_h, scale);
  return launch_merge<__nv_bfloat16>(partials, out, B, H, Sq, DH, splits, os,
                                     true, stream);
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

// The 3xTF32 forms' arguments, as the entry point checked them.
struct Tf32Args {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* partials;
  int B, H, Sq, Sk, Dh, run, splits;
  Strides qs, ks, vs, os;
  int64_t bias_b, bias_h;
  float scale;
  int shared_bytes;
  bool vec;
};

// Many queries in 3xTF32: 64 rows a block.
template <typename T, int DHP>
int launch_tf32_fwd(const Tf32Args& a, cudaStream_t stream) {
  const int rows = 16 * tf32::kWarps;
  const int tiles = (a.Sq + rows - 1) / rows;
  const int64_t blocks = (int64_t)a.B * a.H * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tf32::fused_tf32_fwd_kernel<T, DHP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)blocks, tf32::kBlock, a.shared_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.out), a.H, a.Sq,
      a.Sk, a.Dh, a.qs, a.ks, a.vs, a.os, a.bias_b, a.bias_h, tiles, a.scale,
      a.vec);
  return static_cast<int>(cudaGetLastError());
}

// Few queries in 3xTF32, RT row tiles; then the merge where there is more
// than one split.
template <typename T, int DHP, int RT>
int launch_tf32_split(const Tf32Args& a, cudaStream_t stream) {
  auto kernel = tf32::fused_tf32_split_kernel<T, DHP, RT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)((int64_t)a.splits * a.H * a.B), tf32::kBlock,
           a.shared_bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.bias, static_cast<T*>(a.out), a.partials,
      a.H, a.Sq, a.Sk, a.Dh, a.run, a.splits, a.qs, a.ks, a.vs, a.os,
      a.bias_b, a.bias_h, a.scale, a.vec);
  return launch_merge<T>(a.partials, a.out, a.B, a.H, a.Sq, a.Dh, a.splits,
                         a.os, a.vec, stream);
}

// Form 3 (many queries) or 4 (few queries) at the padded head dim.
template <typename T, int DHP>
int launch_tf32_dh(int form, int row_tiles, const Tf32Args& a,
                   cudaStream_t stream) {
  if (form == 3) return launch_tf32_fwd<T, DHP>(a, stream);
  return row_tiles == 1 ? launch_tf32_split<T, DHP, 1>(a, stream)
                        : launch_tf32_split<T, DHP, 2>(a, stream);
}

template <typename T>
int launch_tf32(int form, int row_tiles, const Tf32Args& a,
                cudaStream_t stream) {
  switch (tf32::padded_dh(a.Dh)) {
    case 16: return launch_tf32_dh<T, 16>(form, row_tiles, a, stream);
    case 32: return launch_tf32_dh<T, 32>(form, row_tiles, a, stream);
    case 64: return launch_tf32_dh<T, 64>(form, row_tiles, a, stream);
    default: return launch_tf32_dh<T, 128>(form, row_tiles, a, stream);
  }
}

// Every row of t at 16-byte aligned addresses: the base and each stride of
// an axis longer than one, in bytes.
bool aligned16(const void* p, int64_t elem, int nb, int64_t sb, int nh,
               int64_t sh, int ns, int64_t ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (nb == 1 || sb * elem % 16 == 0) && (nh == 1 || sh * elem % 16 == 0) &&
         (ns == 1 || ss * elem % 16 == 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `bias` may be null (no bias). Strides
// are in elements; the Python wrapper has checked the shapes, the dtype,
// that the head dim is contiguous and at most 128, and, where the head dim
// is a multiple of 8, that every pointer and stride keeps 16-byte
// alignment. The geometry is `flash_fwd_geometry`'s (ops/_kernels.py):
// `form` 1 (many queries, the ring form: Sk <= 64), 5 (many queries,
// chunked) or 2 (few queries) in bf16, 3 (many queries) or 4 (few queries)
// in 3xTF32; for the few-query forms `run` keys a block, `splits` =
// ceil(Sk / run) blocks a (batch, head), `row_tiles` of 16 query rows, a
// ring of `stages` chunks and `partials` (f32 [B, H, splits, Sq, Dh + 2],
// null at one split and in the many-query forms); for the ring form `run` query rows a block (a
// multiple of 16), `splits` = ceil(Sq / run) blocks a (batch, head), a
// ring of `stages` (kRingStages) slabs a warp, `row_tiles` 0; `shared_bytes` of
// dynamic shared memory (0 for form 5). It is launched as given; a form
// other than the one the dtype, Dh and Sq call for, or a geometry that does
// not hold together, is refused (CUDA error 1, invalid argument).
int fused_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, void* partials, int dtype,
                        int B, int H, int Sq, int Sk, int Dh, int64_t q_b,
                        int64_t q_h, int64_t q_s, int64_t k_b, int64_t k_h,
                        int64_t k_s, int64_t v_b, int64_t v_h, int64_t v_s,
                        int64_t o_b, int64_t o_h, int64_t o_s, int64_t bias_b,
                        int64_t bias_h, float scale, int form, int run,
                        int splits, int row_tiles, int stages,
                        int shared_bytes, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || Dh < 1 || Dh > 128 ||
      (dtype != 0 && dtype != 1) || (int64_t)B * H > 0x7fffffffLL) {
    return static_cast<int>(bad);
  }
  const bool tensor_cores = dtype == 1 && (Dh == 32 || Dh == 64 || Dh == 128);
  const bool few = Sq <= mma::kFewRows;
  const int expected = tensor_cores ? (few ? 2 : 1) : (few ? 4 : 3);
  // Many queries in bf16 take the ring form (1) over at most kRingKeys
  // keys, or the chunked form (5) at any Sk.
  if (form != expected &&
      !(expected == 1 && form == 5)) {
    return static_cast<int>(bad);
  }
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  const float* bias_f = static_cast<const float*>(bias);
  float* part = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (Sk > mma::kRingKeys || run < mma::kRingSlab ||
        run % mma::kRingSlab || splits != (Sq + run - 1) / run ||
        (int64_t)splits * H * B > 0x7fffffffLL || row_tiles != 0 ||
        stages != mma::kRingStages || part != nullptr ||
        shared_bytes != mma::ring_shared_bytes(Dh, mma::ring_key_tiles(Sk))) {
      return static_cast<int>(bad);
    }
#define EGOVLP_RING(DH)                                                       \
  return launch_ring<DH>(q, k, v, bias_f, out, B, H, Sq, Sk, run, splits,    \
                         qs, ks, vs, os, bias_b, bias_h, scale,              \
                         shared_bytes, s)
    if (Dh == 32) EGOVLP_RING(32);
    if (Dh == 64) EGOVLP_RING(64);
    EGOVLP_RING(128);
#undef EGOVLP_RING
  }
  if (form == 5) {
    if (splits != 1 || run != 0 || row_tiles != 0 || stages != 0 ||
        shared_bytes != 0 || part != nullptr) {
      return static_cast<int>(bad);
    }
#define EGOVLP_MANY(DH)                                                       \
  return launch_many<DH>(q, k, v, bias_f, out, B, H, Sq, Sk, qs, ks, vs, os, \
                         bias_b, bias_h, scale, s)
    if (Dh == 32) EGOVLP_MANY(32);
    if (Dh == 64) EGOVLP_MANY(64);
    EGOVLP_MANY(128);
#undef EGOVLP_MANY
  }
  const int row_tiles_want = Sq <= 16 ? 1 : 2;
  if (form == 2 || form == 4) {
    const int chunk = form == 2 ? mma::kSplitKeys : tf32::kChunk;
    const int want_bytes = form == 2
        ? mma::few_shared_bytes(Dh, mma::few_rows(Sk))
        : tf32::split_shared_bytes(Dh, Sk, row_tiles_want);
    if (run < chunk || run % chunk || splits != (Sk + run - 1) / run ||
        (int64_t)splits * H * B > 0x7fffffffLL ||
        row_tiles != row_tiles_want ||
        stages != (form == 2 ? mma::kStages : tf32::kStages) ||
        shared_bytes != want_bytes || (splits > 1 && part == nullptr)) {
      return static_cast<int>(bad);
    }
  }
  if (form == 2) {
#define EGOVLP_FEW(DH)                                                         \
  return launch_few<DH>(q, k, v, bias_f, out, part, B, H, Sq, Sk, run, splits, \
                        mma::few_rows(Sk), row_tiles, qs, ks, vs, os,          \
                        bias_b, bias_h, scale, shared_bytes, s)
    if (Dh == 32) EGOVLP_FEW(32);
    if (Dh == 64) EGOVLP_FEW(64);
    EGOVLP_FEW(128);
#undef EGOVLP_FEW
  }
  if (form == 3 && shared_bytes != tf32::fwd_shared_bytes(Dh)) {
    return static_cast<int>(bad);
  }
  // Vectors of 16 bytes where every row of q, k, v and the output is whole
  // 16-byte words at aligned addresses.
  const int64_t elem = dtype == 0 ? 4 : 2;
  const bool vec = Dh * elem % 16 == 0 &&
                   aligned16(q, elem, B, q_b, H, q_h, Sq, q_s) &&
                   aligned16(k, elem, B, k_b, H, k_h, Sk, k_s) &&
                   aligned16(v, elem, B, v_b, H, v_h, Sk, v_s) &&
                   aligned16(out, elem, B, o_b, H, o_h, Sq, o_s);
  const Tf32Args a{q,  k,  v,  bias_f, out,    part,  B,            H,
                   Sq, Sk, Dh, run,    splits, qs,    ks,           vs,
                   os, bias_b, bias_h, scale,  shared_bytes, vec};
  return dtype == 0 ? launch_tf32<float>(form, row_tiles, a, s)
                    : launch_tf32<__nv_bfloat16>(form, row_tiles, a, s);
}

}  // extern "C"
