// Backward of divided space-time attention for Hopper (sm_90a): from the
// packed qkv [B, S, 3*H*Dh] the forward read and the output's cotangent
// g [B, S, H*Dh], the gradient dqkv [B, S, 3*H*Dh], written by stride in the
// layout of qkv so it goes to the qkv Linear's backward as it is. Layout,
// semantics and the thread-group work split are those of
// divided_attention.cu.
//
// Replaces `_packed_bwd_kernel` (egovlpv2_tpu/ops/divided.py:871) with its
// space frame-block branch `_space_fb_bwd` (:623), its time frame-pair
// branch `_packed_bwd_time_fp_mxu` (:957) and the CLS query's dense pass
// `_cls_dense_bwd_allh` (:377). Nothing of the TPU tiling is carried over.
//
// Math, for a query row i over its key set: s_ij = scale q_i.k_j,
// p = softmax(s), dp_ij = g_i.v_j, delta_i = sum_j p_ij dp_ij,
// ds_ij = p_ij (dp_ij - delta_i); dq_i = scale sum_j ds_ij k_j,
// dk_j = scale sum_i ds_ij q_i, dv_j = sum_i p_ij g_i. The softmax is
// recomputed from qkv (the forward saves nothing but qkv), in f32; every
// sum is f32 and only the stores round to the input dtype.
//
// Three entry points:
//   K4 space_attention_bwd / K5 time_attention_bwd, two launches each:
//     1. query pass: a thread group owns one patch query row and walks its
//        keys once with an online softmax, keeping sum e, sum e dp,
//        sum e dp k and sum e k relative to the running max, so dq, delta
//        and the row's log-sum-exp come out of one pass. It writes dq, the
//        row statistics (lse, delta) to an f32 scratch [2, B, H, S], and the
//        block's share of the CLS key's dk/dv, summed over its rows in
//        shared memory, to an f32 scratch [B, H, blocks, 2, Dh].
//     2. key pass: a thread group owns one patch key row and walks the
//        queries of its frame (space) or patch column (time), rebuilding
//        p and ds from the row statistics; it writes dk and dv.
//     Neither touches sequence row 0 of dqkv.
//   K6 cls_row_attention_bwd, after K4 or K5 on the same stream: one block
//     per (batch, head). The CLS query walks all S keys (split over the
//     block's row groups, merged in shared memory) for dq_0 and its
//     statistics; then every key adds the CLS query's share to the dk/dv
//     rows K4/K5 wrote (read-modify-write, one thread per element, so no
//     atomics), and row 0 of dk/dv is that share plus the sum of the
//     blocks' partials.
// Blocks run in parallel on Hopper, where the TPU grid step saw the whole
// sequence: the CLS key's gradient therefore goes through the partials, a
// fixed-order sum, so the result is the same from run to run.
//
// Bound: operations. On the CUDA cores each (query, key) pair costs two
// dots and two axpys of Dh in each pass; K and V rows are read through L1
// as in the forward kernels. Device memory need see qkv and g once and
// write dqkv once. K4 in bf16 with Dh a multiple of 16 up to 64 (the
// slice) runs both passes on the tensor cores (namespace mma below); K5
// (F + 1 keys a row), K6 (one query) and f32 stay on the CUDA cores.

#include "attention_common.cuh"

namespace {

constexpr int kPairs = 4;  // (query, key) pairs scored between rescales

// One query row's sums over its keys, relative to the running max m:
// l = sum e, edp = sum e dp, a1 = sum e dp k, a2 = sum e k (e = exp(s - m)).
struct BwdRowState {
  float m = -INFINITY;
  float l = 0.f;
  float edp = 0.f;
  float a1[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float a2[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
};

// Walks the keys i = 0 .. n_valid-1 of one query row (addressing as in
// attend_keys of the forward). q and g are the row's query and cotangent
// slices. `s_first` and `dp_first` return the logit and dp of key 0.
// `n_loop` >= n_valid must be the same across the warp.
template <typename T, int G>
__device__ __forceinline__ void bwd_query_keys(
    const HeadView<T>& hv, const float (&q)[kVec], const float (&g)[kVec],
    bool cls_first, int first, int step, int n_valid, int n_loop, float scale,
    BwdRowState& st, float& s_first, float& dp_first) {
  for (int i0 = 0; i0 < n_loop; i0 += kPairs) {
    float s[kPairs], dp[kPairs], k[kPairs][kVec];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int i = i0 + c;
      const bool valid = i < n_valid;
      const int64_t row = cls_first
                              ? (i == 0 ? 0 : first + (int64_t)(i - 1) * step)
                              : first + (int64_t)i * step;
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) k[c][e] = 0.f;
      if (hv.on && valid) {
        float v[kVec];
        load_vec(hv.k + row * hv.stride, k[c]);
        load_vec(hv.v + row * hv.stride, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ps = fmaf(q[e], k[c][e], ps);
          pd = fmaf(g[e], v[e], pd);
        }
      }
      ps = group_sum<G>(ps);
      pd = group_sum<G>(pd);
      s[c] = valid ? ps * scale : -INFINITY;
      dp[c] = pd;
      cmax = fmaxf(cmax, s[c]);
    }
    if (i0 == 0) {
      s_first = s[0];
      dp_first = dp[0];
    }
    const float m_new = fmaxf(st.m, cmax);
    const float corr = st.m == -INFINITY ? 0.f : expf(st.m - m_new);
    st.l *= corr;
    st.edp *= corr;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      st.a1[e] *= corr;
      st.a2[e] *= corr;
    }
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const float ex = s[c] == -INFINITY ? 0.f : expf(s[c] - m_new);
      const float w = ex * dp[c];
      st.l += ex;
      st.edp += w;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        st.a1[e] = fmaf(w, k[c][e], st.a1[e]);
        st.a2[e] = fmaf(ex, k[c][e], st.a2[e]);
      }
    }
    st.m = m_new;
  }
}

template <typename T>
__device__ __forceinline__ void load_g(const T* gout, bool on, int b, int h,
                                       int S, int H, int Dh, int lane,
                                       int64_t row, float (&g)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) g[e] = 0.f;
  if (on) {
    load_vec(gout + ((int64_t)b * S + row) * H * Dh + (int64_t)h * Dh +
                 (int64_t)lane * kVec,
             g);
  }
}

// Plain (not read-only-cache) loads, for rows an earlier kernel wrote and
// this kernel overwrites.
__device__ __forceinline__ void load_vec_rw(const float* p, float (&o)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load_vec_rw(const __nv_bfloat16* p,
                                            float (&o)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// The patch row a thread group owns, and the rows it pairs with. Rows are
// enumerated frame-major for space (consecutive patches of a frame side by
// side, as K1) and column-major for time (the F rows of a patch column side
// by side, as K2), so the groups of a warp share their loads.
struct Pairing {
  int64_t row;  // sequence row of the group's own query (or key)
  int first;    // sequence row of the first patch row it pairs with
  int step;     // rows between them
  int count;    // how many patch rows it pairs with (without the CLS row)
};

template <bool kTime>
__device__ __forceinline__ Pairing pairing(int idx, int N, int F) {
  if (kTime) {
    const int n = idx / F, f = idx % F;
    return Pairing{1 + (int64_t)f * N + n, 1 + n, N, F};
  }
  return Pairing{1 + (int64_t)idx, 1 + (idx / N) * N, 1, N};
}

// K4/K5, launch 1: the query pass.
template <typename T, int G, bool kTime>
__global__ void __launch_bounds__(kThreads)
    grouped_bwd_query_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ gout, T* __restrict__ dqkv,
                             float* __restrict__ stats,
                             float* __restrict__ cls_part, int S, int H,
                             int Dh, int N, int F, float scale) {
  constexpr int kGroups = kThreads / G;
  __shared__ float sm_part[2][kGroups][G * kVec];
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int idx = blockIdx.x * kGroups + grp;
  const bool row_ok = idx < S - 1;  // idle groups still join shuffles
  const Pairing pair = pairing<kTime>(row_ok ? idx : S - 2, N, F);
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  float q[kVec], g[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, pair.row, q);
  load_g(gout, hv.on, b, h, S, H, Dh, lane, pair.row, g);
  BwdRowState st;
  float s0 = 0.f, dp0 = 0.f;
  bwd_query_keys<T, G>(hv, q, g, true, pair.first, pair.step, pair.count + 1,
                       pair.count + 1, scale, st, s0, dp0);
  const float inv_l = 1.f / st.l;
  const float delta = st.edp * inv_l;
  if (row_ok && hv.on) {
    float dq[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      dq[e] = scale * (st.a1[e] - delta * st.a2[e]) * inv_l;
    }
    store_vec(dqkv + ((int64_t)b * S + pair.row) * hv.stride + (int64_t)h * Dh +
                  (int64_t)lane * kVec,
              dq);
  }
  if (row_ok && lane == 0) {
    const int64_t at = ((int64_t)b * H + h) * S + pair.row;
    stats[at] = st.m + logf(st.l);
    stats[(int64_t)gridDim.z * H * S + at] = delta;
  }
  // This row's share of the CLS key's dk and dv, summed over the block.
  const float p0 = row_ok ? expf(s0 - st.m) * inv_l : 0.f;
  const float ds0 = p0 * (dp0 - delta) * scale;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    sm_part[0][grp][lane * kVec + e] = ds0 * q[e];
    sm_part[1][grp][lane * kVec + e] = p0 * g[e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * Dh; t += kThreads) {
    const int which = t / Dh, d = t % Dh;
    float sum = 0.f;
    for (int i = 0; i < kGroups; ++i) sum += sm_part[which][i][d];
    cls_part[((((int64_t)b * H + h) * gridDim.x + blockIdx.x) * 2 + which) *
                 Dh + d] = sum;
  }
}

// K4/K5, launch 2: the key pass.
template <typename T, int G, bool kTime>
__global__ void __launch_bounds__(kThreads)
    grouped_bwd_key_kernel(const T* __restrict__ qkv,
                           const T* __restrict__ gout, T* __restrict__ dqkv,
                           const float* __restrict__ stats, int S, int H,
                           int Dh, int N, int F, float scale) {
  constexpr int kGroups = kThreads / G;
  const int b = blockIdx.z, h = blockIdx.y;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int idx = blockIdx.x * kGroups + grp;
  const bool row_ok = idx < S - 1;
  const Pairing pair = pairing<kTime>(row_ok ? idx : S - 2, N, F);
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  float k[kVec], v[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) k[e] = v[e] = 0.f;
  if (hv.on) {
    load_vec(hv.k + pair.row * hv.stride, k);
    load_vec(hv.v + pair.row * hv.stride, v);
  }
  const float* lse = stats + ((int64_t)b * H + h) * S;
  const float* dlt = lse + (int64_t)gridDim.z * H * S;
  float dk[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float dv[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < pair.count; i0 += kPairs) {
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int i = i0 + c;
      const bool valid = i < pair.count;
      const int64_t row = pair.first + (int64_t)(valid ? i : 0) * pair.step;
      float qi[kVec], gi[kVec];
      load_q(qkv, hv, b, h, S, H, Dh, lane, row, qi);
      load_g(gout, hv.on, b, h, S, H, Dh, lane, row, gi);
      float ps = 0.f, pd = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        ps = fmaf(qi[e], k[e], ps);
        pd = fmaf(gi[e], v[e], pd);
      }
      ps = group_sum<G>(ps);
      pd = group_sum<G>(pd);
      const float p = valid ? expf(ps * scale - lse[row]) : 0.f;
      const float ds = p * (pd - dlt[row]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        dk[e] = fmaf(ds, qi[e], dk[e]);
        dv[e] = fmaf(p, gi[e], dv[e]);
      }
    }
  }
  if (row_ok && hv.on) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dk[e] *= scale;
    T* dkp = dqkv + ((int64_t)b * S + pair.row) * hv.stride + (int64_t)H * Dh +
             (int64_t)h * Dh + (int64_t)lane * kVec;
    store_vec(dkp, dk);
    store_vec(dkp + (int64_t)H * Dh, dv);
  }
}

// K6: the CLS query's row, and the CLS key's row of dk/dv.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    cls_row_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ gout,
                       T* __restrict__ dqkv,
                       const float* __restrict__ cls_part, int parts, int S,
                       int H, int Dh, float scale) {
  constexpr int kGroups = kThreads / G;
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_edp[kGroups];
  __shared__ float sm_a1[kGroups * G * kVec];
  __shared__ float sm_a2[kGroups * G * kVec];
  const int b = blockIdx.y, h = blockIdx.x;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  float q[kVec], g[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, 0, q);
  load_g(gout, hv.on, b, h, S, H, Dh, lane, 0, g);
  const int n_valid = grp < S ? (S - grp + kGroups - 1) / kGroups : 0;
  const int n_loop = (S + kGroups - 1) / kGroups;
  {
    BwdRowState st;
    float unused_s = 0.f, unused_dp = 0.f;
    bwd_query_keys<T, G>(hv, q, g, false, grp, kGroups, n_valid, n_loop, scale,
                         st, unused_s, unused_dp);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sm_a1[grp * G * kVec + lane * kVec + e] = st.a1[e];
      sm_a2[grp * G * kVec + lane * kVec + e] = st.a2[e];
    }
    if (lane == 0) {
      sm_m[grp] = st.m;
      sm_l[grp] = st.l;
      sm_edp[grp] = st.edp;
    }
  }
  __syncthreads();
  // Merge the groups' partial sums; every thread needs lse and delta.
  float m = -INFINITY;
  for (int i = 0; i < kGroups; ++i) m = fmaxf(m, sm_m[i]);
  float l = 0.f, edp = 0.f;
  for (int i = 0; i < kGroups; ++i) {
    const float w = sm_m[i] == -INFINITY ? 0.f : expf(sm_m[i] - m);
    l += sm_l[i] * w;
    edp += sm_edp[i] * w;
  }
  const float inv_l = 1.f / l;
  const float delta = edp * inv_l;
  const float lse = m + logf(l);
  const int t = threadIdx.x;  // element t of the head dim
  if (t < Dh) {
    float a1 = 0.f, a2 = 0.f;
    for (int i = 0; i < kGroups; ++i) {
      const float w = sm_m[i] == -INFINITY ? 0.f : expf(sm_m[i] - m);
      a1 += sm_a1[i * G * kVec + t] * w;
      a2 += sm_a2[i * G * kVec + t] * w;
    }
    store_one(dqkv + (int64_t)b * S * hv.stride + (int64_t)h * Dh + t,
              scale * (a1 - delta * a2) * inv_l);
  }
  // The CLS query's share of every key's dk and dv.
  for (int j0 = 0; j0 < n_loop; ++j0) {
    const int j = grp + j0 * kGroups;
    const bool valid = j < S;
    float k[kVec], v[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) k[e] = v[e] = 0.f;
    if (hv.on && valid) {
      load_vec(hv.k + (int64_t)j * hv.stride, k);
      load_vec(hv.v + (int64_t)j * hv.stride, v);
    }
    float ps = 0.f, pd = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ps = fmaf(q[e], k[e], ps);
      pd = fmaf(g[e], v[e], pd);
    }
    ps = group_sum<G>(ps);
    pd = group_sum<G>(pd);
    if (!(hv.on && valid)) continue;
    const float p = expf(ps * scale - lse);
    const float ds = p * (pd - delta) * scale;
    T* dkp = dqkv + ((int64_t)b * S + j) * hv.stride + (int64_t)H * Dh +
             (int64_t)h * Dh + (int64_t)lane * kVec;
    T* dvp = dkp + (int64_t)H * Dh;
    float ak[kVec], av[kVec];
    if (j == 0) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) ak[e] = av[e] = 0.f;
      const float* part = cls_part + ((int64_t)b * H + h) * parts * 2 * Dh +
                          lane * kVec;
      for (int i = 0; i < parts; ++i) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ak[e] += part[(2 * i) * Dh + e];
          av[e] += part[(2 * i + 1) * Dh + e];
        }
      }
    } else {
      load_vec_rw(dkp, ak);
      load_vec_rw(dvp, av);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ak[e] = fmaf(ds, q[e], ak[e]);
      av[e] = fmaf(p, g[e], av[e]);
    }
    store_vec(dkp, ak);
    store_vec(dvp, av);
  }
}

// K4 on the tensor cores: the bf16 form of the two passes above for the
// space axis, for Dh a multiple of 16 up to 64 (the slice: Dh = 64; larger
// head dims would need more than the 48 KB of static shared memory and take
// the CUDA-core passes).
// Bound: the CUDA-core passes spend two dots and two axpys of Dh, with
// their shuffles, on each (query, key) pair in each pass: 4.8 ms at B=16,
// S=785 on an H100. Here every product is an mma.sync m16n8k16 (bf16 in,
// f32 accumulate), so the loads into shared memory and the exponentials
// bound it instead.
// Design, as K1's tensor-core kernel: a block owns 64 rows of one frame of
// one (b, h), 16 rows a warp, its own rows held in registers as mma A
// fragments, and walks the other side of the frame in chunks of 64 staged in
// shared memory, row-major for the products that contract over the head
// dim and transposed for those that contract over the chunk.
//   Query pass, rows = queries, chunks = keys (CLS first), two sweeps:
//   sweep 1 takes S = Q K^T and dP = dO V^T for the row's log-sum-exp and
//   delta = sum P dP (online, as K1's softmax); sweep 2 rebuilds them,
//   forms dS = P (dP - delta), rounds it to bf16 as the A operand of
//   dQ += dS K (as the plain version's autograd rounds it), and takes this
//   block's share of the CLS key's dk and dv from column 0.
//   Key pass, rows = patch keys, chunks = queries: S^T = K Q^T and
//   dP^T = V dO^T against the statistics of the query pass, then
//   dK += dS^T Q and dV += P^T dO.
// The statistics are kept in the base-2 domain (lse2 = log2 sum 2^(s log2e)).
namespace mma {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // rows a block owns
constexpr int kChunk = 64;          // rows of the other side a chunk
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

// A fragments of two rows (`lo`, `hi`; null = a row past the frame: zeros).
template <int DH>
__device__ __forceinline__ void load_a(const __nv_bfloat16* lo,
                                       const __nv_bfloat16* hi, int t,
                                       uint32_t (&a)[DH / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = lo ? ld32(lo + c) : 0u;
    a[kk][1] = hi ? ld32(hi + c) : 0u;
    a[kk][2] = lo ? ld32(lo + c + 8) : 0u;
    a[kk][3] = hi ? ld32(hi + c + 8) : 0u;
  }
}

// Stages `kChunk` rows of `src` (row i of the chunk at src + rows[i]*stride;
// i >= n_valid gives zeros) into `rm` row-major and, if `tr`, transposed.
// rows: i -> sequence row, by `first + i` with row 0 mapped to `row0` when
// `cls_first` (the CLS key leads chunk 0 of the keys).
template <int DH>
__device__ __forceinline__ void stage(
    const __nv_bfloat16* src, int64_t stride, int c0, int n_total,
    bool cls_first, int first, __nv_bfloat16 (*rm)[DH + kPad],
    __nv_bfloat16 (*tr)[kChunk + kPad]) {
  for (int i = threadIdx.x; i < kChunk * (DH / 8); i += kWarps * 32) {
    const int j = i / (DH / 8), d8 = (i % (DH / 8)) * 8;
    const int idx = c0 + j;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (idx < n_total) {
      const int64_t row = cls_first ? (idx == 0 ? 0 : first + idx - 1)
                                    : first + idx;
      val = __ldg(reinterpret_cast<const uint4*>(src + row * stride + d8));
    }
    *reinterpret_cast<uint4*>(&rm[j][d8]) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[d8 + e][j] = ve[e];
    }
  }
}

// c[nt] += A (16 x DH, registers) . B^T, B = 64 rows x DH row-major in smem.
template <int DH>
__device__ __forceinline__ void product_over_dh(
    float (&c)[kChunk / 8][4], const uint32_t (&a)[DH / 16][4],
    __nv_bfloat16 (*b)[DH + kPad], int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const __nv_bfloat16* br = &b[nt * 8 + g][kk * 16 + 2 * t];
      mma_bf16(c[nt], a[kk], ld32(br), ld32(br + 8));
    }
  }
}

// acc += A (16 x 64, the C fragments `a` rounded to bf16) . B, B given
// transposed in smem as [DH][64].
template <int DH>
__device__ __forceinline__ void product_over_chunk(
    float (&acc)[DH / 8][4], const float (&a)[kChunk / 8][4],
    __nv_bfloat16 (*bt)[kChunk + kPad], int g, int t) {
#pragma unroll
  for (int kc = 0; kc < kChunk / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(a[2 * kc][0], a[2 * kc][1]),
                            pack_bf16(a[2 * kc][2], a[2 * kc][3]),
                            pack_bf16(a[2 * kc + 1][0], a[2 * kc + 1][1]),
                            pack_bf16(a[2 * kc + 1][2], a[2 * kc + 1][3])};
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const __nv_bfloat16* br = &bt[nd * 8 + g][kc * 16 + 2 * t];
      mma_bf16(acc[nd], pa, ld32(br), ld32(br + 8));
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    space_bwd_query_kernel(const __nv_bfloat16* __restrict__ qkv,
                           const __nv_bfloat16* __restrict__ gout,
                           __nv_bfloat16* __restrict__ dqkv,
                           float* __restrict__ stats,
                           float* __restrict__ cls_part, int S, int H, int N,
                           float scale) {
  __shared__ __align__(16) __nv_bfloat16 sk[kChunk][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 sv[kChunk][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 skt[DH][kChunk + kPad];
  __shared__ float s_ds0[kRows];
  __shared__ float s_p0[kRows];
  const int tiles = (N + kRows - 1) / kRows;
  const int f = blockIdx.x / tiles, qt = blockIdx.x % tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const __nv_bfloat16* kbase = qbase + width;
  const __nv_bfloat16* vbase = qbase + 2 * width;
  const __nv_bfloat16* gbase = gout + (int64_t)b * S * width + (int64_t)h * DH;
  const int first = 1 + f * N;
  const int p_lo = qt * kRows + warp * 16 + g, p_hi = p_lo + 8;
  const bool ok_lo = p_lo < N, ok_hi = p_hi < N;
  const int64_t r_lo = first + p_lo, r_hi = first + p_hi;

  uint32_t qa[DH / 16][4], ga[DH / 16][4];
  load_a<DH>(ok_lo ? qbase + r_lo * stride : nullptr,
             ok_hi ? qbase + r_hi * stride : nullptr, t, qa);
  load_a<DH>(ok_lo ? gbase + r_lo * width : nullptr,
             ok_hi ? gbase + r_hi * width : nullptr, t, ga);
  const float sl2 = scale * kLog2e;
  float s[kChunk / 8][4], dp[kChunk / 8][4];

  // Scores of one staged chunk: s in the base-2 domain, -inf past key N.
  auto scores = [&](int c0) {
    product_over_dh<DH>(s, qa, sk, g, t);
    product_over_dh<DH>(dp, ga, sv, g, t);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = c0 + nt * 8 + 2 * t + (e & 1) <= N;
        s[nt][e] = valid ? s[nt][e] * sl2 : -INFINITY;
      }
    }
  };

  // Sweep 1: the rows' log-sum-exp and delta.
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float e_lo = 0.f, e_hi = 0.f;  // sum 2^(s - m) dp
  for (int c0 = 0; c0 <= N; c0 += kChunk) {
    __syncthreads();
    stage<DH>(kbase, stride, c0, N + 1, true, first, sk, nullptr);
    stage<DH>(vbase, stride, c0, N + 1, true, first, sv, nullptr);
    __syncthreads();
    scores(c0);
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Every chunk holds a valid key, so the new maxima are finite.
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float corr_lo = exp2f(m_lo - mn_lo), corr_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= corr_lo; e_lo *= corr_lo;
    l_hi *= corr_hi; e_hi *= corr_hi;
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const float x0 = exp2f(s[nt][0] - mn_lo), x1 = exp2f(s[nt][1] - mn_lo);
      const float x2 = exp2f(s[nt][2] - mn_hi), x3 = exp2f(s[nt][3] - mn_hi);
      l_lo += x0 + x1;
      l_hi += x2 + x3;
      e_lo += x0 * dp[nt][0] + x1 * dp[nt][1];
      e_hi += x2 * dp[nt][2] + x3 * dp[nt][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    e_lo += __shfl_xor_sync(0xffffffffu, e_lo, off);
    e_hi += __shfl_xor_sync(0xffffffffu, e_hi, off);
  }
  const float lse_lo = m_lo + log2f(l_lo), lse_hi = m_hi + log2f(l_hi);
  const float delta_lo = e_lo / l_lo, delta_hi = e_hi / l_hi;
  if (t == 0) {
    const int64_t at = ((int64_t)b * H + h) * S;
    const int64_t plane = (int64_t)gridDim.z * H * S;
    if (ok_lo) { stats[at + r_lo] = lse_lo; stats[plane + at + r_lo] = delta_lo; }
    if (ok_hi) { stats[at + r_hi] = lse_hi; stats[plane + at + r_hi] = delta_hi; }
  }

  // Sweep 2: dS, dQ and the CLS key's share.
  float dq[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
  for (int c0 = 0; c0 <= N; c0 += kChunk) {
    __syncthreads();
    stage<DH>(kbase, stride, c0, N + 1, true, first, sk, skt);
    stage<DH>(vbase, stride, c0, N + 1, true, first, sv, nullptr);
    __syncthreads();
    scores(c0);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - lse_lo), p1 = exp2f(s[nt][1] - lse_lo);
      const float p2 = exp2f(s[nt][2] - lse_hi), p3 = exp2f(s[nt][3] - lse_hi);
      if (c0 == 0 && nt == 0 && t == 0) {  // column 0: the CLS key
        s_p0[warp * 16 + g] = ok_lo ? p0 : 0.f;
        s_p0[warp * 16 + g + 8] = ok_hi ? p2 : 0.f;
        s_ds0[warp * 16 + g] = ok_lo ? p0 * (dp[0][0] - delta_lo) : 0.f;
        s_ds0[warp * 16 + g + 8] = ok_hi ? p2 * (dp[0][2] - delta_hi) : 0.f;
      }
      s[nt][0] = p0 * (dp[nt][0] - delta_lo);
      s[nt][1] = p1 * (dp[nt][1] - delta_lo);
      s[nt][2] = p2 * (dp[nt][2] - delta_hi);
      s[nt][3] = p3 * (dp[nt][3] - delta_hi);
    }
    product_over_chunk<DH>(dq, s, skt, g, t);
  }
  __nv_bfloat16* d_lo = dqkv + ((int64_t)b * S + r_lo) * stride + h * DH;
  __nv_bfloat16* d_hi = dqkv + ((int64_t)b * S + r_hi) * stride + h * DH;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(d_lo + c) =
          pack_bf16(dq[nd][0] * scale, dq[nd][1] * scale);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(d_hi + c) =
          pack_bf16(dq[nd][2] * scale, dq[nd][3] * scale);
    }
  }
  // This block's share of the CLS key's dk (threads 0..DH-1) and dv
  // (DH..2DH-1): a sum over its rows, which are read again (L1/L2).
  __syncthreads();
  if (threadIdx.x < 2 * DH) {
    const int which = threadIdx.x / DH, d = threadIdx.x % DH;
    const int rows = min(kRows, N - qt * kRows);
    float sum = 0.f;
    for (int i = 0; i < rows; ++i) {
      const int64_t r = first + qt * kRows + i;
      sum += which == 0
                 ? s_ds0[i] * __bfloat162float(qbase[r * stride + d])
                 : s_p0[i] * __bfloat162float(gbase[r * width + d]);
    }
    cls_part[((((int64_t)b * H + h) * gridDim.x + blockIdx.x) * 2 + which) *
                 DH + d] = which == 0 ? sum * scale : sum;
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
    space_bwd_key_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ gout,
                         __nv_bfloat16* __restrict__ dqkv,
                         const float* __restrict__ stats, int S, int H, int N,
                         float scale) {
  __shared__ __align__(16) __nv_bfloat16 sq[kChunk][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 sg[kChunk][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 sqt[DH][kChunk + kPad];
  __shared__ __align__(16) __nv_bfloat16 sgt[DH][kChunk + kPad];
  __shared__ float s_lse[kChunk];
  __shared__ float s_delta[kChunk];
  const int tiles = (N + kRows - 1) / kRows;
  const int f = blockIdx.x / tiles, kt = blockIdx.x % tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const __nv_bfloat16* kbase = qbase + width;
  const __nv_bfloat16* vbase = qbase + 2 * width;
  const __nv_bfloat16* gbase = gout + (int64_t)b * S * width + (int64_t)h * DH;
  const int first = 1 + f * N;
  const int p_lo = kt * kRows + warp * 16 + g, p_hi = p_lo + 8;
  const bool ok_lo = p_lo < N, ok_hi = p_hi < N;
  const int64_t r_lo = first + p_lo, r_hi = first + p_hi;

  uint32_t ka[DH / 16][4], va[DH / 16][4];
  load_a<DH>(ok_lo ? kbase + r_lo * stride : nullptr,
             ok_hi ? kbase + r_hi * stride : nullptr, t, ka);
  load_a<DH>(ok_lo ? vbase + r_lo * stride : nullptr,
             ok_hi ? vbase + r_hi * stride : nullptr, t, va);
  const float sl2 = scale * kLog2e;
  const float* lse = stats + ((int64_t)b * H + h) * S;
  const float* dlt = lse + (int64_t)gridDim.z * H * S;
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }
  float st[kChunk / 8][4], dpt[kChunk / 8][4];
  for (int q0 = 0; q0 < N; q0 += kChunk) {
    __syncthreads();
    stage<DH>(qbase, stride, q0, N, false, first, sq, sqt);
    stage<DH>(gbase, width, q0, N, false, first, sg, sgt);
    if (threadIdx.x < kChunk) {
      const bool valid = q0 + threadIdx.x < N;
      // +inf turns a query past the frame into p = 0
      s_lse[threadIdx.x] = valid ? lse[first + q0 + threadIdx.x] : INFINITY;
      s_delta[threadIdx.x] = valid ? dlt[first + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    product_over_dh<DH>(st, ka, sq, g, t);
    product_over_dh<DH>(dpt, va, sg, g, t);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = exp2f(st[nt][e] * sl2 - s_lse[col]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - s_delta[col]);
      }
    }
    product_over_chunk<DH>(dv, st, sgt, g, t);
    product_over_chunk<DH>(dk, dpt, sqt, g, t);
  }
  __nv_bfloat16* k_lo = dqkv + ((int64_t)b * S + r_lo) * stride + width + h * DH;
  __nv_bfloat16* k_hi = dqkv + ((int64_t)b * S + r_hi) * stride + width + h * DH;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(k_lo + c) =
          pack_bf16(dk[nd][0] * scale, dk[nd][1] * scale);
      *reinterpret_cast<uint32_t*>(k_lo + width + c) =
          pack_bf16(dv[nd][0], dv[nd][1]);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(k_hi + c) =
          pack_bf16(dk[nd][2] * scale, dk[nd][3] * scale);
      *reinterpret_cast<uint32_t*>(k_hi + width + c) =
          pack_bf16(dv[nd][2], dv[nd][3]);
    }
  }
}

inline int parts(int S, int F) {
  const int N = (S - 1) / F;
  return F * ((N + kRows - 1) / kRows);
}

template <int DH>
int launch(const void* qkv, const void* gout, void* dqkv, float* stats,
           float* cls_part, int B, int S, int H, int F, float scale,
           cudaStream_t stream) {
  const int N = (S - 1) / F;
  const dim3 grid(parts(S, F), H, B);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(gout);
  __nv_bfloat16* d = static_cast<__nv_bfloat16*>(dqkv);
  space_bwd_query_kernel<DH><<<grid, kWarps * 32, 0, stream>>>(
      q, g, d, stats, cls_part, S, H, N, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  space_bwd_key_kernel<DH><<<grid, kWarps * 32, 0, stream>>>(
      q, g, d, stats, S, H, N, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// bf16 with Dh in {16, 32, 48, 64} on the space axis takes the tensor cores.
inline bool space_on_tensor_cores(int dtype, int Dh) {
  return dtype == 1 && Dh % 16 == 0 && Dh <= 64;
}

int space_mma(const void* qkv, const void* gout, void* dqkv, float* stats,
              float* cls_part, int B, int S, int H, int Dh, int F, float scale,
              cudaStream_t st) {
  switch (Dh) {
    case 16: return mma::launch<16>(qkv, gout, dqkv, stats, cls_part, B, S, H, F, scale, st);
    case 32: return mma::launch<32>(qkv, gout, dqkv, stats, cls_part, B, S, H, F, scale, st);
    case 48: return mma::launch<48>(qkv, gout, dqkv, stats, cls_part, B, S, H, F, scale, st);
    case 64: return mma::launch<64>(qkv, gout, dqkv, stats, cls_part, B, S, H, F, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int G>
int launch_grouped(bool time, const void* qkv, const void* gout, void* dqkv,
                   float* stats, float* cls_part, int B, int S, int H, int Dh,
                   int F, float scale, cudaStream_t stream) {
  const int rows = kThreads / G;
  const dim3 grid((S - 1 + rows - 1) / rows, H, B);
  const int N = (S - 1) / F;
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(gout);
  T* d = static_cast<T*>(dqkv);
  if (time) {
    grouped_bwd_query_kernel<T, G, true><<<grid, kThreads, 0, stream>>>(
        q, g, d, stats, cls_part, S, H, Dh, N, F, scale);
  } else {
    grouped_bwd_query_kernel<T, G, false><<<grid, kThreads, 0, stream>>>(
        q, g, d, stats, cls_part, S, H, Dh, N, F, scale);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (time) {
    grouped_bwd_key_kernel<T, G, true><<<grid, kThreads, 0, stream>>>(
        q, g, d, stats, S, H, Dh, N, F, scale);
  } else {
    grouped_bwd_key_kernel<T, G, false><<<grid, kThreads, 0, stream>>>(
        q, g, d, stats, S, H, Dh, N, F, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int launch_cls_row(const void* qkv, const void* gout, void* dqkv,
                   const float* cls_part, int parts, int B, int S, int H,
                   int Dh, float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  cls_row_bwd_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(gout),
      static_cast<T*>(dqkv), cls_part, parts, S, H, Dh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grouped_bwd(bool time, const void* qkv, const void* gout, void* dqkv,
                float* stats, float* cls_part, int B, int S, int H, int Dh,
                int F, float scale, cudaStream_t st) {
  switch (group_size(Dh)) {
    case 1: return launch_grouped<T, 1>(time, qkv, gout, dqkv, stats, cls_part, B, S, H, Dh, F, scale, st);
    case 2: return launch_grouped<T, 2>(time, qkv, gout, dqkv, stats, cls_part, B, S, H, Dh, F, scale, st);
    case 4: return launch_grouped<T, 4>(time, qkv, gout, dqkv, stats, cls_part, B, S, H, Dh, F, scale, st);
    case 8: return launch_grouped<T, 8>(time, qkv, gout, dqkv, stats, cls_part, B, S, H, Dh, F, scale, st);
    case 16: return launch_grouped<T, 16>(time, qkv, gout, dqkv, stats, cls_part, B, S, H, Dh, F, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int cls_row_bwd(const void* qkv, const void* gout, void* dqkv,
                const float* cls_part, int parts, int B, int S, int H, int Dh,
                float scale, cudaStream_t st) {
  switch (group_size(Dh)) {
    case 1: return launch_cls_row<T, 1>(qkv, gout, dqkv, cls_part, parts, B, S, H, Dh, scale, st);
    case 2: return launch_cls_row<T, 2>(qkv, gout, dqkv, cls_part, parts, B, S, H, Dh, scale, st);
    case 4: return launch_cls_row<T, 4>(qkv, gout, dqkv, cls_part, parts, B, S, H, Dh, scale, st);
    case 8: return launch_cls_row<T, 8>(qkv, gout, dqkv, cls_part, parts, B, S, H, Dh, scale, st);
    case 16: return launch_cls_row<T, 16>(qkv, gout, dqkv, cls_part, parts, B, S, H, Dh, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype: 0 = float32, 1 = bfloat16. The Python wrapper has checked the
// shapes, dtypes, contiguity, alignment and Dh, and sized the scratch.
int grouped_bwd_any(bool time, const void* qkv, const void* gout, void* dqkv,
                    void* stats, void* cls_part, int dtype, int B, int S,
                    int H, int Dh, int F, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  float* cp = static_cast<float*>(cls_part);
  if (dtype == 0) {
    return grouped_bwd<float>(time, qkv, gout, dqkv, sp, cp, B, S, H, Dh, F,
                              scale, st);
  }
  if (dtype == 1) {
    return grouped_bwd<__nv_bfloat16>(time, qkv, gout, dqkv, sp, cp, B, S, H,
                                      Dh, F, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// How many CLS-key partials a grouped backward (time != 0: K5, else K4)
// writes for each (batch, head): the blocks of its query pass. The wrapper
// sizes `cls_part` [B, H, parts, 2, Dh] (f32) with it; `stats` is
// [2, B, H, S] (f32).
int attention_bwd_parts(int time, int dtype, int S, int Dh, int F) {
  if (!time && space_on_tensor_cores(dtype, Dh)) return mma::parts(S, F);
  const int rows = kThreads / group_size(Dh);
  return (S - 1 + rows - 1) / rows;
}

int space_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                        void* stats, void* cls_part, int dtype, int B, int S,
                        int H, int Dh, int F, float scale, void* stream) {
  if (space_on_tensor_cores(dtype, Dh)) {
    return space_mma(qkv, gout, dqkv, static_cast<float*>(stats),
                     static_cast<float*>(cls_part), B, S, H, Dh, F, scale,
                     static_cast<cudaStream_t>(stream));
  }
  return grouped_bwd_any(false, qkv, gout, dqkv, stats, cls_part, dtype, B, S,
                         H, Dh, F, scale, stream);
}

int time_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                       void* stats, void* cls_part, int dtype, int B, int S,
                       int H, int Dh, int F, float scale, void* stream) {
  return grouped_bwd_any(true, qkv, gout, dqkv, stats, cls_part, dtype, B, S,
                         H, Dh, F, scale, stream);
}

int cls_row_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                          const void* cls_part, int parts, int dtype, int B,
                          int S, int H, int Dh, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(cls_part);
  if (dtype == 0) {
    return cls_row_bwd<float>(qkv, gout, dqkv, cp, parts, B, S, H, Dh, scale,
                              st);
  }
  if (dtype == 1) {
    return cls_row_bwd<__nv_bfloat16>(qkv, gout, dqkv, cp, parts, B, S, H, Dh,
                                      scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
