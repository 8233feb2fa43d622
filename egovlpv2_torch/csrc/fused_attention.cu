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
// form raises q, k and v to float32; the tensor-core form multiplies bf16 q
// and k (exact products, float32 sums), scales the float32 product, and
// feeds P to P.V as the sum of two bf16 terms (16 bits of mantissa), so P is
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
//   * t2i, Sq = 15..30 queries over Sk = 785..6273 keys: the K and V of a
//     (batch, head) are 803 KB at Sk=3137 in bf16, more than the 227 KB a
//     block can hold, and every query row reads all of them;
//   * text self-attention, Sq = Sk = 15..30: a few microseconds of work,
//     bound by the launch.
// Two forms. bf16 with a head dim of 32, 64 or 128 (the models': 64) runs on
// the tensor cores (mma::fused_fwd_kernel, described there): every call the
// models make. Everything else (f32, other head dims) runs on the CUDA
// cores, in the simplest form that is right: a group of G threads owns one
// query row of one head, each thread 8 consecutive elements of the head dim
// (16 B of bf16, one vector load; element by element where the head dim is
// not a multiple of 8, the last thread's slice cut short), as in
// divided_attention.cu; a block of 256 threads takes
// 256/G query rows of one (batch, head), and each group streams all the keys
// kChunk at a time with an online softmax (the running max starts at -inf).
// The groups of a warp hold neighbouring query rows, so a key is one
// broadcast load a warp. It is not tuned (few query rows over many keys
// leave most of the card idle); it goes once float32 has a tensor-core form.
// No atomics in either form: two runs give the same bits.

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

// K9 on the tensor cores: the bf16 form for Dh = 32, 64 or 128.
// Bound: the CUDA-core form spends about 60 issue slots of a warp on each
// (row, key) pair of a group of 8 threads; here QK^T and PV are mma.sync
// m16n8k16 products (bf16 in, f32 accumulate) and the loads bound it.
// Design, after the tensor-core K1 of divided_attention.cu: a block of 4
// warps walks the Sk keys of its (batch, head) in chunks of 64 staged in
// shared memory (K row-major, V transposed, rows padded by 8 against bank
// conflicts, the bias row beside them times log2 e, -inf past the last key).
// KS = 1 (many queries, i2t): the block owns 64 query rows, 16 a warp, Q held
// in registers as mma A fragments; only the key tiles that hold a key are
// multiplied, so 15 keys cost 2 of 8 tiles. KS = 4 (few queries, t2i and
// text): the block owns 16 query rows, all four warps hold the same Q, each
// scores its own quarter of every chunk with its own online softmax, and the
// four partial (max, sum, output) sets are merged through the staging buffer
// at the end, in warp order. The logits are q.k * scale + bias in f32 (in the
// log2 domain), the softmax is f32, P enters P.V as two bf16 A operands, hi
// and lo (f32 accumulate, the small term first), the output is rounded once.
namespace mma {

constexpr int kWarps = 4;
constexpr int kKeys = 64;  // keys a chunk
constexpr int kPad = 8;    // bf16 of padding a shared-memory row
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

template <int DH, int KS>
__global__ void __launch_bounds__(kWarps * 32)
    fused_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int Sq, int Sk,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int64_t bias_b, int64_t bias_h, int tiles, float scale) {
  static_assert(KS == 1 || KS == kWarps, "one row tile a warp, or one a block");
  constexpr int kRows = 16 * (kWarps / KS);  // query rows a block
  constexpr int kSub = kKeys / KS;           // keys of a chunk a warp scores
  constexpr int kKBytes = kKeys * (DH + kPad) * 2;
  constexpr int kStage = kKBytes + DH * (kKeys + kPad) * 2;
  constexpr int kMerge = KS > 1 ? (KS * 16 * DH + 2 * KS * 16) * 4 : 0;
  constexpr int kSmem = kStage > kMerge ? kStage : kMerge;
  __shared__ __align__(16) unsigned char smem[kSmem];
  __shared__ float sbias[kKeys];
  auto sk = reinterpret_cast<__nv_bfloat16(*)[DH + kPad]>(smem);
  auto svt = reinterpret_cast<__nv_bfloat16(*)[kKeys + kPad]>(smem + kKBytes);

  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const int b = blockIdx.x / tiles / H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int rw = KS == 1 ? warp : 0;      // this warp's row tile of the block
  const int j0 = KS == 1 ? 0 : warp * kSub;  // its first key of every chunk
  const __nv_bfloat16* kbase = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vbase = v + b * vs.b + h * vs.h;
  const float* bp = bias ? bias + b * bias_b + h * bias_h : nullptr;
  // This thread's two query rows (fragment rows g and g + 8).
  const int p_lo = tile * kRows + rw * 16 + g, p_hi = p_lo + 8;
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
    const int n_sub = min(kSub, n16 - j0);  // staged keys of this warp's part
    if (j0 >= n_in) continue;               // none holds a key: warp-uniform

    float s[kSub / 8][4];
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (nt * 8 < n_sub) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const __nv_bfloat16* kr = &sk[j0 + nt * 8 + g][kk * 16 + 2 * t];
          mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // -inf past the chunk's last key, and in the tiles not multiplied
        const int col = j0 + nt * 8 + 2 * t + (e & 1);
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
    // Key j0 of the chunk is a real key (a masked one carries -1e9, not
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
    for (int nt = 0; nt < kSub / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_lo);
      s[nt][1] = exp2f(s[nt][1] - mn_lo);
      s[nt][2] = exp2f(s[nt][2] - mn_hi);
      s[nt][3] = exp2f(s[nt][3] - mn_hi);
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kc = 0; kc < kSub / 16; ++kc) {
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
        const __nv_bfloat16* vr = &svt[nd * 8 + g][j0 + kc * 16 + 2 * t];
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
  if (KS == 1) {
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
    return;
  }

  // Merge the KS warps' partial softmaxes of the block's 16 rows, in warp
  // order, through the staging buffer.
  float* mo = reinterpret_cast<float*>(smem);  // [KS][16][DH]
  float* mm = mo + KS * 16 * DH;               // [KS][16] running maxima
  float* ml = mm + KS * 16;                    // [KS][16] running sums
  __syncthreads();  // every warp is done with the staged keys
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    float* lo = mo + (warp * 16 + g) * DH + c;
    float* hi = mo + (warp * 16 + g + 8) * DH + c;
    lo[0] = o[nd][0]; lo[1] = o[nd][1];
    hi[0] = o[nd][2]; hi[1] = o[nd][3];
  }
  if (t == 0) {
    mm[warp * 16 + g] = m_lo; mm[warp * 16 + g + 8] = m_hi;
    ml[warp * 16 + g] = l_lo; ml[warp * 16 + g + 8] = l_hi;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 16 * DH; idx += kWarps * 32) {
    const int rr = idx / DH, c = idx % DH;
    const int row = tile * kRows + rr;
    if (row >= Sq) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < KS; ++w) mx = fmaxf(mx, mm[w * 16 + rr]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < KS; ++w) {
      const float mw = mm[w * 16 + rr];
      const float wgt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      l += ml[w * 16 + rr] * wgt;
      acc += mo[(w * 16 + rr) * DH + c] * wgt;
    }
    obase[row * os.s + c] = __float2bfloat16(acc / l);
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

// The tensor-core form. Few query rows (text queries over video keys, text
// self-attention): 16 rows a block, the warps split the keys. Many: 64 rows a
// block.
template <int DH>
int launch_mma(const void* q, const void* k, const void* v, const float* bias,
               void* out, int B, int H, int Sq, int Sk, Strides qs, Strides ks,
               Strides vs, Strides os, int64_t bias_b, int64_t bias_h,
               float scale, cudaStream_t stream) {
  const bool few = Sq <= 32;
  const int rows = few ? 16 : 16 * mma::kWarps;
  const int tiles = (Sq + rows - 1) / rows;
  const int64_t blocks = (int64_t)B * H * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (few) {
    mma::fused_fwd_kernel<DH, mma::kWarps>
        <<<(unsigned)blocks, mma::kWarps * 32, 0, stream>>>(
            qp, kp, vp, bias, op, H, Sq, Sk, qs, ks, vs, os, bias_b, bias_h,
            tiles, scale);
  } else {
    mma::fused_fwd_kernel<DH, 1>
        <<<(unsigned)blocks, mma::kWarps * 32, 0, stream>>>(
            qp, kp, vp, bias, op, H, Sq, Sk, qs, ks, vs, os, bias_b, bias_h,
            tiles, scale);
  }
  return static_cast<int>(cudaGetLastError());
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
// alignment.
int fused_attention_fwd(const void* q, const void* k, const void* v,
                        const void* bias, void* out, int dtype, int B, int H,
                        int Sq, int Sk, int Dh, int64_t q_b, int64_t q_h,
                        int64_t q_s, int64_t k_b, int64_t k_h, int64_t k_s,
                        int64_t v_b, int64_t v_h, int64_t v_s, int64_t o_b,
                        int64_t o_h, int64_t o_s, int64_t bias_b,
                        int64_t bias_h, float scale, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_b, q_h, q_s}, ks{k_b, k_h, k_s}, vs{v_b, v_h, v_s},
      os{o_b, o_h, o_s};
  const float* bias_f = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_group<float>(q, k, v, bias_f, out, B, H, Sq, Sk, Dh, qs,
                                 ks, vs, os, bias_b, bias_h, scale, s);
  }
  if (dtype == 1) {
    // bf16 at the models' head dims runs on the tensor cores.
#define EGOVLP_MMA(DH)                                                      \
  return launch_mma<DH>(q, k, v, bias_f, out, B, H, Sq, Sk, qs, ks, vs, os, \
                        bias_b, bias_h, scale, s)
    if (Dh == 32) EGOVLP_MMA(32);
    if (Dh == 64) EGOVLP_MMA(64);
    if (Dh == 128) EGOVLP_MMA(128);
#undef EGOVLP_MMA
    return dispatch_group<__nv_bfloat16>(q, k, v, bias_f, out, B, H, Sq, Sk,
                                         Dh, qs, ks, vs, os, bias_b, bias_h,
                                         scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
