// Forward of divided space-time attention for Hopper (sm_90a), read
// straight from the qkv projection output.
//
// Layout. `qkv` is the [B, S, 3*H*Dh] output of the qkv Linear, row-major:
// for sequence row r of batch b, q of head h starts at element
// (b*S + r)*3*H*Dh + h*Dh, k at + H*Dh, v at + 2*H*Dh. `out` is
// [B, S, H*Dh]. Row 0 is the CLS token; row 1 + f*N + n is patch n of frame
// f (S = 1 + F*N). No transpose is made on either side: each kernel reads
// q, k and v by stride, as the packed TPU kernel kept transposes out of
// memory.
//
// Semantics (those of `_divided_xla`, egovlpv2_tpu/ops/divided.py):
//   * space: patch query (f, n) attends the N keys of frame f plus the CLS
//     key, in one softmax;
//   * time: patch query (f, n) attends the F keys of patch column n plus
//     the CLS key;
//   * CLS row (both axes): row 0 attends all S keys.
// space_attention_fwd / time_attention_fwd write rows 1..S-1 and
// cls_row_attention_fwd writes row 0.
//
// Work split. K1 in bf16 with Dh a multiple of 16 (the slice) runs on the
// tensor cores (mma::space_fwd_kernel, described there). Everything else
// runs on the CUDA cores: a group of G threads owns one query row of one
// head; each thread holds 8 consecutive elements of the head dim (16 B of
// bf16), so G = Dh/8 rounded up to a power of two (G <= 16 for Dh <= 128;
// lanes past Dh/8 idle). A q.k dot is 8 FMAs a thread plus a log2(G)
// shuffle reduction inside the group. K1/K2 take keys kChunk at a time
// with an online softmax (one rescale a chunk); K3 splits the CLS row's
// keys into runs, one block a run (described at its kernels). Logits,
// softmax and P.V are f32; the output is stored in the input dtype.

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 8;      // keys scored between softmax rescales

// Online-softmax state of one query row: running max, running sum and the
// unnormalised output slice this thread owns.
struct RowState {
  float m = -INFINITY;
  float l = 0.f;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
};

// Attends the keys i = 0 .. n_valid-1 of one query row. Key i lives at
// sequence row `first + i*step`; with `cls_first` key 0 is row 0 (CLS) and
// key i >= 1 is row `first + (i-1)*step`. `n_loop` >= n_valid must be the
// same across the warp, so every lane reaches every shuffle.
template <typename T, int G>
__device__ __forceinline__ void attend_keys(const HeadView<T>& hv,
                                            const float (&q)[kVec],
                                            bool cls_first, int first,
                                            int step, int n_valid, int n_loop,
                                            float scale, RowState& st) {
  for (int i0 = 0; i0 < n_loop; i0 += kChunk) {
    float s[kChunk];
    int64_t rows[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int i = i0 + c;
      const bool valid = i < n_valid;
      rows[c] = cls_first ? (i == 0 ? 0 : first + (int64_t)(i - 1) * step)
                          : first + (int64_t)i * step;
      float part = 0.f;
      if (hv.on && valid) {
        float k[kVec];
        load_vec(hv.k + rows[c] * hv.stride, k);
#pragma unroll
        for (int e = 0; e < kVec; ++e) part = fmaf(q[e], k[e], part);
      }
      part = group_sum<G>(part);
      s[c] = valid ? part * scale : -INFINITY;
      cmax = fmaxf(cmax, s[c]);
    }
    const float m_new = fmaxf(st.m, cmax);
    // Branch-free for a chunk with no valid key yet (m_new = -inf).
    const float corr = st.m == -INFINITY ? 0.f : expf(st.m - m_new);
    st.l *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) st.acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float p = s[c] == -INFINITY ? 0.f : expf(s[c] - m_new);
      st.l += p;
      if (hv.on && i0 + c < n_valid) {
        float v[kVec];
        load_vec(hv.v + rows[c] * hv.stride, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) st.acc[e] = fmaf(p, v[e], st.acc[e]);
      }
    }
    st.m = m_new;
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* out, const RowState& st, int b,
                                          int h, int S, int H, int Dh,
                                          int lane, int64_t row) {
  float o[kVec];
  const float inv = 1.f / st.l;
#pragma unroll
  for (int e = 0; e < kVec; ++e) o[e] = st.acc[e] * inv;
  store_vec(out + ((int64_t)b * S + row) * H * Dh + (int64_t)h * Dh +
                (int64_t)lane * kVec,
            o);
}

// K1. Replaces the frame-block space branch of the packed TPU kernel
// (`_packed_fwd_kernel` egovlpv2_tpu/ops/divided.py:774-788, with
// `_space_fb_fwd` and `_tile_attend`).
// Bound: each query row loads its frame's N+1 keys and values, 2 x 197 x
// 128 B = 50 KB at N=196, Dh=64 in bf16, for 4*Dh flops a key, so the
// loads from L1 and L2 bound it; device memory need see the qkv tensor only
// once (289 MB at B=20, S=3137: 86 us at 3.35 TB/s). One frame's K/V
// (50 KB in bf16, 100 KB in f32) exceeds the 48 KB of static shared memory.
// Design: no shared memory and no limit on N. Consecutive rows of a block
// are consecutive patches of one frame, so the row groups of a warp read
// the same key at the same time (one broadcast load), the block's 8 warps
// reuse it from L1, and the ~6 blocks of a frame meet in L2. The online
// softmax over key chunks takes any N.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    space_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S,
                     int H, int Dh, int N, float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int row = 1 + blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool row_ok = row < S;
  const int r = row_ok ? row : S - 1;  // idle groups still join shuffles
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  float q[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, r, q);
  RowState st;
  const int first = 1 + ((r - 1) / N) * N;
  attend_keys<T, G>(hv, q, true, first, 1, N + 1, N + 1, scale, st);
  if (row_ok && hv.on) store_row(out, st, b, h, S, H, Dh, lane, r);
}

// K1 on the tensor cores: the bf16 form of space_fwd_kernel, for Dh a
// multiple of 16 (the slice: Dh = 64).
// Bound: the kernel above spends ~14 warp instructions on each (row, key)
// pair on the CUDA cores; here QK^T and PV are mma.sync m16n8k16 products
// (bf16 in, f32 accumulate), 38 GFLOP at the 16-frame shape, so loads of
// K/V into shared memory and the softmax bound it instead.
// Design: a block owns 64 query rows of one frame of one (b, h), 16 rows a
// warp, Q held in registers as mma A fragments. It walks the frame's keys
// (CLS first, then the N patches) in chunks of 64 staged in shared memory:
// K row-major and V transposed, both padded by 8 so the fragment loads
// spread over the banks (2 x 9 KB at Dh=64, any N). Each chunk: S = QK^T
// in registers, scale, mask past the last key, online softmax (FA2 style:
// row max over the 4 threads of a row, per-thread partial sums), P rounded
// to bf16 as the A operand of P.V, as the plain version rounds it.
namespace mma {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kKeys = 64;           // keys a chunk
constexpr int kPad = 8;             // bf16 of padding a shared-memory row
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    space_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                     __nv_bfloat16* __restrict__ out, int S, int H, int N,
                     float scale) {
  __shared__ __align__(16) __nv_bfloat16 sk[kKeys][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 svt[DH][kKeys + kPad];
  const int tiles = (N + kRows - 1) / kRows;
  const int f = blockIdx.x / tiles, qt = blockIdx.x % tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int64_t stride = 3LL * H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const __nv_bfloat16* kbase = qbase + (int64_t)H * DH;
  const __nv_bfloat16* vbase = qbase + 2LL * H * DH;
  const int first = 1 + f * N;  // sequence row of patch 0 of frame f
  // This thread's two query rows (fragment rows g and g + 8).
  const int p_lo = qt * kRows + warp * 16 + g, p_hi = p_lo + 8;
  const bool ok_lo = p_lo < N, ok_hi = p_hi < N;

  uint32_t qa[DH / 16][4];
  {
    const __nv_bfloat16* q_lo = qbase + (int64_t)(first + p_lo) * stride;
    const __nv_bfloat16* q_hi = qbase + (int64_t)(first + p_hi) * stride;
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

  for (int c0 = 0; c0 <= N; c0 += kKeys) {  // keys 0..N: CLS, then patches
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kKeys * (DH / 8); i += kWarps * 32) {
      const int j = i / (DH / 8), d8 = (i % (DH / 8)) * 8;
      const int key = c0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key <= N) {
        const int64_t row = key == 0 ? 0 : first + key - 1;
        kv = __ldg(reinterpret_cast<const uint4*>(kbase + row * stride + d8));
        vv = __ldg(reinterpret_cast<const uint4*>(vbase + row * stride + d8));
      }
      *reinterpret_cast<uint4*>(&sk[j][d8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) svt[d8 + e][j] = ve[e];
    }
    __syncthreads();

    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const __nv_bfloat16* kr = &sk[nt * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = c0 + nt * 8 + 2 * t + (e & 1) <= N;
        s[nt][e] = valid ? s[nt][e] * sl2 : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Every chunk holds a valid key (chunk 0 the CLS key), so the new
    // maxima are finite and exp2(-inf - m) = 0 handles the first chunk.
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
      // The C fragments of key tiles 2kc, 2kc+1 are the A fragment of P.
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const __nv_bfloat16* vr = &svt[nd * 8 + g][kc * 16 + 2 * t];
        mma_bf16(o[nd], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int64_t width = (int64_t)H * DH;
  __nv_bfloat16* o_lo = out + ((int64_t)b * S + first + p_lo) * width + h * DH;
  __nv_bfloat16* o_hi = out + ((int64_t)b * S + first + p_hi) * width + h * DH;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(o_lo + c) =
          pack_bf16(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(o_hi + c) =
          pack_bf16(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
    }
  }
}

}  // namespace mma

// K2. Replaces the time branches of the packed TPU kernel: the frame-pair
// branch (divided.py:811-830, `_time_fp_attend_mxu`) and the patch-major
// window branch (divided.py:789-810, with its row permutes and the
// permute hoist of models/video.py:175-192).
// Bound: memory. Each row has only F+1 logits (17 at F=16), so the kernel
// is a gather of F+1 keys and values per row at stride N rows; compute is
// negligible.
// Design: no permute. Row groups enumerate rows column-major (group
// g -> patch n = g / F, frame f = g % F), so the F queries of one patch
// column sit side by side in a block and share each key load, read at
// stride N straight from the qkv output. Any F works (online softmax).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    time_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S,
                    int H, int Dh, int N, int F, float scale) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int g = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool row_ok = g < S - 1;
  const int gg = row_ok ? g : S - 2;
  const int n = gg / F, f = gg % F;
  const int64_t r = 1 + (int64_t)f * N + n;
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  float q[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, r, q);
  RowState st;
  attend_keys<T, G>(hv, q, true, 1 + n, N, F + 1, F + 1, scale, st);
  if (row_ok && hv.on) store_row(out, st, b, h, S, H, Dh, lane, r);
}

// K3. Replaces the all-heads CLS-row pass `_cls_row_fwd_allh`
// (divided.py:359-374), which both axes share: row 0 of the output, the
// CLS query over all S keys, and its log-sum-exp `lse0` [B, H] (f32, for
// K6).
// Bound: memory. Each (b, h) reads S keys and values once for S logits
// (S=6273, Dh=64, bf16: 1.6 MB; 154 MB at B=8, H=12, 46 us at 3.35 TB/s).
// The card has to keep a few MB of loads in flight to reach its rate, so
// the (b, h) pairs alone (96 at B=8) are too few blocks.
// Design: two launches on the geometry of `cls_row_geometry`
// (ops/_kernels.py), which the entry point launches as given.
//   1. cls_row_part_kernel, grid (H, parts, B): a block owns a run of
//      kClsKeys * kThreads / G keys. Each row group issues the loads of all
//      its kClsKeys keys' k and v rows first (16 B a lane a row in bf16),
//      then scores them against q0 in f32, takes the block's max, and sums
//      exp(s - max) and exp(s - max) v. No rescale within a run. It writes
//      the f32 partial (m, l, acc[Dh]) to [B, H, parts, Dh + 2]. The heads
//      are the grid's fastest axis, so blocks that run side by side read
//      the neighbouring bytes of one sequence row (its K and V of all H
//      heads) rather than rows 3 H Dh elements apart.
//   2. cls_row_merge_kernel, grid (H, B): the partials merged into output
//      row 0 and lse0, the parts split over the block's slices.
// Sums across lanes, groups, warps, parts and slices run in a fixed order
// and nothing is added atomically, so a run gives the same bits every time.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    cls_row_part_kernel(const T* __restrict__ qkv, float* __restrict__ partials,
                        int S, int H, int Dh, float scale) {
  constexpr int kGroups = kThreads / G;
  constexpr int kKeys = kClsKeys;
  constexpr int kWarps = kThreads / 32;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ __align__(16) float sm_acc[kWarps][G * kVec];
  const int h = blockIdx.x, part = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int warp = threadIdx.x / 32;
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  // key c of this group: row first + c * kGroups (neighbouring groups on
  // neighbouring rows)
  const int first = part * kKeys * kGroups + grp;
  Raw<T> kr[kKeys], vr[kKeys];
#pragma unroll
  for (int c = 0; c < kKeys; ++c) {
    const int64_t j = first + c * kGroups;
    if (hv.on && j < S) {
      load_raw(hv.k + j * hv.stride, kr[c]);
      load_raw(hv.v + j * hv.stride, vr[c]);
    } else {
      zero_raw(kr[c]);
      zero_raw(vr[c]);
    }
  }
  float q[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, 0, q);
  float s[kKeys];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < kKeys; ++c) {
    float k[kVec];
    to_float(kr[c], k);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) dot = fmaf(q[e], k[e], dot);
    dot = group_sum<G>(dot);
    s[c] = first + c * kGroups < S ? dot * scale : -INFINITY;
    mx = fmaxf(mx, s[c]);
  }
  // the block's max: over the warp, then over the warps (every run holds a
  // key, so it is finite)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (threadIdx.x % 32 == 0) sm_m[warp] = mx;
  __syncthreads();
  mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float l = 0.f;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < kKeys; ++c) {
    const float p = expf(s[c] - mx);  // 0 past S
    float v[kVec];
    to_float(vr[c], v);
    l += p;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = fmaf(p, v[e], acc[e]);
  }
  // l is the same on a group's lanes: count it once a group
  l = lane == 0 ? l : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  warp_groups_sum<G>(acc);
  if (threadIdx.x % 32 == 0) sm_l[warp] = l;
  if (threadIdx.x % 32 < G) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[warp][lane * kVec + e] = acc[e];
  }
  __syncthreads();
  float* dst = partials +
               (((int64_t)b * H + h) * gridDim.y + part) * (Dh + 2);
  for (int t = threadIdx.x; t < Dh; t += kThreads) {
    float o = sm_acc[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += sm_acc[w][t];
    dst[2 + t] = o;
  }
  if (threadIdx.x == 0) {
    float total = sm_l[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += sm_l[w];
    dst[0] = mx;
    dst[1] = total;
  }
}

// K3, second launch: output row 0 and lse0 from the parts' partials. Grid
// (H, B), kMergeThreads threads: column t of slice r merges parts r,
// r + kSlices, ... with its own running max (one pass, the loads of
// several parts in flight); the slices are merged in order.
template <typename T, int G>
__global__ void __launch_bounds__(kMergeThreads)
    cls_row_merge_kernel(const float* __restrict__ partials,
                         T* __restrict__ out, float* __restrict__ lse, int S,
                         int H, int Dh, int parts) {
  constexpr int kCols = G * kVec, kSlices = kMergeThreads / kCols;
  __shared__ float sm_m[kSlices];
  __shared__ float sm_l[kSlices];
  __shared__ float sm_o[kSlices][kCols];
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = (int64_t)b * H + h;
  const int ld = Dh + 2;
  const float* p = partials + bh * parts * ld;
  const int t = threadIdx.x % kCols, r = threadIdx.x / kCols;
  const int col = 2 + min(t, Dh - 1);  // idle columns repeat the last one
  float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll 8
  for (int x = r; x < parts; x += kSlices) {
    const float mx = p[x * ld], lx = p[x * ld + 1], ox = p[x * ld + col];
    const float m_new = fmaxf(m, mx);
    const float keep = expf(m - m_new), w = expf(mx - m_new);  // exp(-inf) = 0
    l = fmaf(l, keep, lx * w);
    o = fmaf(o, keep, ox * w);
    m = m_new;
  }
  sm_o[r][t] = o;
  if (t == 0) {
    sm_m[r] = m;
    sm_l[r] = l;
  }
  __syncthreads();
  if (r == 0) {
    for (int i = 1; i < kSlices; ++i) {
      const float mi = sm_m[i];
      if (mi == -INFINITY) break;  // slices past the parts are empty
      const float m_new = fmaxf(m, mi);
      const float keep = expf(m - m_new), w = expf(mi - m_new);
      l = fmaf(l, keep, sm_l[i] * w);
      o = fmaf(o, keep, sm_o[i][t] * w);
      m = m_new;
    }
    if (t < Dh) {
      store_one(out + (int64_t)b * S * H * Dh + (int64_t)h * Dh + t, o / l);
    }
    if (t == 0) lse[bh] = m + logf(l);
  }
}

// `run` and `parts` from `cls_row_geometry`: any run other than the
// compiled kClsKeys * kThreads / G, or parts that do not cover S with runs,
// is refused.
template <typename T, int G>
int launch_cls_row(const void* qkv, void* out, float* lse, float* partials,
                   int B, int S, int H, int Dh, int run, int parts,
                   float scale, cudaStream_t stream) {
  if (run != kClsKeys * (kThreads / G) || parts != (S + run - 1) / run) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cls_row_part_kernel<T, G><<<dim3(H, parts, B), kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), partials, S, H, Dh, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cls_row_merge_kernel<T, G><<<dim3(H, B), kMergeThreads, 0, stream>>>(
      partials, static_cast<T*>(out), lse, S, H, Dh, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cls_row(const void* qkv, void* out, float* lse, float* partials, int B,
            int S, int H, int Dh, int run, int parts, float scale,
            cudaStream_t st) {
  switch (group_size(Dh)) {
    case 1: return launch_cls_row<T, 1>(qkv, out, lse, partials, B, S, H, Dh, run, parts, scale, st);
    case 2: return launch_cls_row<T, 2>(qkv, out, lse, partials, B, S, H, Dh, run, parts, scale, st);
    case 4: return launch_cls_row<T, 4>(qkv, out, lse, partials, B, S, H, Dh, run, parts, scale, st);
    case 8: return launch_cls_row<T, 8>(qkv, out, lse, partials, B, S, H, Dh, run, parts, scale, st);
    case 16: return launch_cls_row<T, 16>(qkv, out, lse, partials, B, S, H, Dh, run, parts, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int G>
struct Space {
  static void run(const void* qkv, void* out, int B, int S, int H, int Dh,
                  int F, float scale, cudaStream_t stream) {
    const int rows = kThreads / G;
    const dim3 grid((S - 1 + rows - 1) / rows, H, B);
    space_fwd_kernel<T, G><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), S, H, Dh,
        (S - 1) / F, scale);
  }
};

template <typename T, int G>
struct Time {
  static void run(const void* qkv, void* out, int B, int S, int H, int Dh,
                  int F, float scale, cudaStream_t stream) {
    const int rows = kThreads / G;
    const dim3 grid((S - 1 + rows - 1) / rows, H, B);
    time_fwd_kernel<T, G><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(qkv), static_cast<T*>(out), S, H, Dh,
        (S - 1) / F, F, scale);
  }
};

template <typename T, template <typename, int> class Launch>
int dispatch_group(const void* qkv, void* out, int B, int S, int H, int Dh,
                   int F, float scale, cudaStream_t stream) {
  switch (group_size(Dh)) {
    case 1: Launch<T, 1>::run(qkv, out, B, S, H, Dh, F, scale, stream); break;
    case 2: Launch<T, 2>::run(qkv, out, B, S, H, Dh, F, scale, stream); break;
    case 4: Launch<T, 4>::run(qkv, out, B, S, H, Dh, F, scale, stream); break;
    case 8: Launch<T, 8>::run(qkv, out, B, S, H, Dh, F, scale, stream); break;
    case 16: Launch<T, 16>::run(qkv, out, B, S, H, Dh, F, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
void launch_space_mma(const void* qkv, void* out, int B, int S, int H, int F,
                      float scale, cudaStream_t stream) {
  const int N = (S - 1) / F;
  const dim3 grid(F * ((N + mma::kRows - 1) / mma::kRows), H, B);
  mma::space_fwd_kernel<DH><<<grid, mma::kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      S, H, N, scale);
}

int space_mma(const void* qkv, void* out, int B, int S, int H, int Dh, int F,
              float scale, cudaStream_t stream) {
  switch (Dh) {
    case 16: launch_space_mma<16>(qkv, out, B, S, H, F, scale, stream); break;
    case 32: launch_space_mma<32>(qkv, out, B, S, H, F, scale, stream); break;
    case 48: launch_space_mma<48>(qkv, out, B, S, H, F, scale, stream); break;
    case 64: launch_space_mma<64>(qkv, out, B, S, H, F, scale, stream); break;
    case 80: launch_space_mma<80>(qkv, out, B, S, H, F, scale, stream); break;
    case 96: launch_space_mma<96>(qkv, out, B, S, H, F, scale, stream); break;
    case 112: launch_space_mma<112>(qkv, out, B, S, H, F, scale, stream); break;
    case 128: launch_space_mma<128>(qkv, out, B, S, H, F, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16. The Python wrapper has checked the
// shapes, dtype, contiguity, alignment and Dh (a multiple of 8, <= 128).
template <template <typename, int> class Launch>
int dispatch(const void* qkv, void* out, int dtype, int B, int S, int H,
             int Dh, int F, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_group<float, Launch>(qkv, out, B, S, H, Dh, F, scale, s);
  }
  if (dtype == 1) {
    return dispatch_group<__nv_bfloat16, Launch>(qkv, out, B, S, H, Dh, F,
                                                 scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// bf16 with Dh a multiple of 16 runs on the tensor cores; the rest (f32,
// other head dims) on the CUDA cores.
int space_attention_fwd(const void* qkv, void* out, int dtype, int B, int S,
                        int H, int Dh, int F, float scale, void* stream) {
  if (dtype == 1 && Dh % 16 == 0) {
    return space_mma(qkv, out, B, S, H, Dh, F, scale,
                     static_cast<cudaStream_t>(stream));
  }
  return dispatch<Space>(qkv, out, dtype, B, S, H, Dh, F, scale, stream);
}

int time_attention_fwd(const void* qkv, void* out, int dtype, int B, int S,
                       int H, int Dh, int F, float scale, void* stream) {
  return dispatch<Time>(qkv, out, dtype, B, S, H, Dh, F, scale, stream);
}

// K3: row 0 of `out` and `lse` [B, H] (f32), two launches over the f32
// scratch `partials` [B, H, parts, Dh + 2]; `run` and `parts` come from
// `cls_row_geometry`, and any other is refused (cudaErrorInvalidValue).
int cls_row_attention_fwd(const void* qkv, void* out, void* lse,
                          void* partials, int dtype, int B, int S, int H,
                          int Dh, int run, int parts, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* p = static_cast<float*>(partials);
  if (dtype == 0) {
    return cls_row<float>(qkv, out, l, p, B, S, H, Dh, run, parts, scale, st);
  }
  if (dtype == 1) {
    return cls_row<__nv_bfloat16>(qkv, out, l, p, B, S, H, Dh, run, parts,
                                  scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
