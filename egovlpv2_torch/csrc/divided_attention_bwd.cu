// Backward of divided space-time attention for Hopper (sm_90a): from the
// packed qkv [B, S, 3*H*Dh] the forward read and the output's cotangent
// g [B, S, H*Dh], the gradient dqkv [B, S, 3*H*Dh], written by stride in the
// layout of qkv so it goes to the qkv Linear's backward as it is. Layout,
// semantics and the thread-group work split are those of
// divided_attention.cu.
//
// Replaces `_packed_bwd_kernel` (egovlpv2_tpu/ops/divided.py:871) with its
// space frame-block branch `_space_fb_bwd` (:623), its time frame-pair
// branch `_packed_bwd_time_fp_mxu` (:957), its patch-major time window
// branch (:874-903) and the CLS query's dense pass `_cls_dense_bwd_allh`
// (:377). Nothing of the TPU tiling is carried over.
//
// Math, for a query row i over its key set: s_ij = scale q_i.k_j,
// p = softmax(s), dp_ij = g_i.v_j, delta_i = sum_j p_ij dp_ij,
// ds_ij = p_ij (dp_ij - delta_i); dq_i = scale sum_j ds_ij k_j,
// dk_j = scale sum_i ds_ij q_i, dv_j = sum_i p_ij g_i. The softmax is
// recomputed from qkv for the patch rows (K4, K5); the CLS row's comes
// from the log-sum-exp K3 saved (K6). Every sum is f32; the tensor-core
// forms round P and dS to bf16 before their products, as the reference
// does, and the stores round to the input dtype.
//
// Three entry points:
//   K4 space_attention_bwd, the grouped form that `space_bwd_geometry`
//     names for f32, the head dims other than 16, 32, 48 and 64 and frames
//     of more than 208 keys (its frame form, one launch on the tensor
//     cores, is in space_attention.cu), two launches:
//     1. query pass: a thread group owns one patch query row and walks its
//        keys once with an online softmax, keeping sum e, sum e dp,
//        sum e dp k and sum e k relative to the running max, so dq, delta
//        and the row's log-sum-exp come out of one pass. It writes dq, the
//        row statistics (lse, delta) to an f32 scratch [2, B, H, S], and the
//        block's share of the CLS key's dk/dv, summed over its rows in
//        shared memory, to an f32 scratch [B, H, blocks, 2, Dh].
//     2. key pass: a thread group owns one patch key row and walks the
//        queries of its frame, rebuilding p and ds from the row statistics;
//        it writes dk and dv.
//   K5 time_attention_bwd: in bf16 (Dh a multiple of 16 up to 64, F <= 63)
//     one launch, a warp a run of patch columns, both passes of a column
//     on the tensor cores from shared memory (namespace mma, at
//     time_bwd_kernel); otherwise the two grouped launches above with the
//     keys of a patch column in place of a frame.
//   Neither touches sequence row 0 of dqkv.
//   K6 cls_row_attention_bwd, after K4 or K5 on the same stream, two
//     launches (described at its kernels): one pass over runs of keys that
//     adds the CLS query's share to the dk/dv rows K4/K5 wrote
//     (read-modify-write, one thread per element, so no atomics) and
//     writes each run's partial of dq_0, then the merge of row 0: dq_0,
//     and dk/dv of the CLS key as that share plus the sum of K4/K5's
//     partials.
// Blocks run in parallel on Hopper, where the TPU grid step saw the whole
// sequence: the CLS key's gradient therefore goes through the partials, a
// fixed-order sum, so the result is the same from run to run.
//
// Bound: bytes for the function (qkv and g read once, dqkv written once).
// On the CUDA cores each (query, key) pair costs two dots and two axpys of
// Dh in each pass; K and V rows are read through L1 as in the forward
// kernels. In bf16 with Dh a multiple of 16 up to 64 K5 runs both passes
// on the tensor cores where F + 1 keys fit four 16-row tiles (namespace mma
// below); f32 stays on the CUDA cores. K6 (one query) is bound by memory,
// and is described at its kernels.

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

// K6, the CLS query's row and the CLS key's row of dk/dv, after K4 or K5
// on the same stream. Replaces `_cls_dense_bwd_allh` (divided.py:377).
// Bound: memory. Each (b, h) reads its S keys and values once, and reads
// and writes back the dk/dv rows K4/K5 wrote (at B=8, S=6273, H=12,
// Dh=64, bf16: 154 MB of k and v, 308 MB of dk/dv, 138 us at 3.35 TB/s).
// Design: no forward recomputed. K3 saved lse0 (f32 [B, H]); the output's
// row 0 gives delta0 = g0.o0 (in bf16 the rounded output). Two launches on
// K3's geometry (`cls_row_geometry`):
//   1. cls_row_bwd_part_kernel, grid (H, parts, B) as K3's: a block owns
//      K3's run of keys; each row group takes its kClsKeys keys in two
//      batches (in one batch the registers allow fewer blocks an SM),
//      issuing the k, v, dk and dv loads of a batch together. For key j:
//      p = exp(scale q0.kj - lse0), dp = g0.vj, ds = p (dp - delta0); it
//      adds scale ds q0 and p g0 to the dk/dv row j >= 1 (read-modify-write,
//      one thread an element, no atomics). It writes to the f32 scratch
//      [B, H, parts, 3, Dh] its partial of sum ds_j k_j and its share of the
//      CLS key's dk and dv: the sum of a slice of K4/K5's `cls_part` rows,
//      plus, in part 0, key 0's own share.
//   2. cls_row_bwd_merge_kernel, grid (H, B): row 0 of dq (scale times the
//      sum of the parts' partials), dk and dv (the sums of their shares),
//      each sum in a fixed order.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    cls_row_bwd_part_kernel(const T* __restrict__ qkv,
                            const T* __restrict__ gout,
                            const T* __restrict__ out,
                            const float* __restrict__ lse,
                            T* __restrict__ dqkv,
                            const float* __restrict__ cls_part,
                            float* __restrict__ scratch, int cls_parts, int S,
                            int H, int Dh, float scale) {
  constexpr int kGroups = kThreads / G;
  constexpr int kKeys = kClsKeys;
  constexpr int kBatch = kKeys / 2;
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(16) float sm_acc[kWarps][G * kVec];
  __shared__ __align__(16) float sm_share[2][G * kVec];  // key 0's dk, dv
  const int h = blockIdx.x, part = blockIdx.y, b = blockIdx.z;
  const int parts = gridDim.y;
  const int64_t bh = (int64_t)b * H + h;
  // This block's slice of K4/K5's partials of the CLS key's dk/dv, rows
  // [x0, x1) of `cls_part`: thread u < 2 Dh sums column u of [dk | dv].
  const int per = (cls_parts + parts - 1) / parts;
  const int x0 = min(part * per, cls_parts), x1 = min(x0 + per, cls_parts);
  float cls_sum = 0.f;
  if (threadIdx.x < 2 * Dh) {
    const float* cp = cls_part + bh * cls_parts * 2 * Dh + threadIdx.x;
    for (int x = x0; x < x1; ++x) cls_sum += cp[(int64_t)x * 2 * Dh];
  }
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int warp = threadIdx.x / 32;
  const HeadView<T> hv = head_view(qkv, b, h, S, H, Dh, lane);
  const int64_t dk_off = (int64_t)H * Dh;  // dk of a row: its k's offset
  T* dk_base = dqkv + (hv.k - qkv);        // dk of row 0, this lane's slice
  float q[kVec], g[kVec], o[kVec];
  load_q(qkv, hv, b, h, S, H, Dh, lane, 0, q);
  load_g(gout, hv.on, b, h, S, H, Dh, lane, 0, g);
  load_g(out, hv.on, b, h, S, H, Dh, lane, 0, o);
  float delta = 0.f;
#pragma unroll
  for (int e = 0; e < kVec; ++e) delta = fmaf(g[e], o[e], delta);
  delta = group_sum<G>(delta);
  const float lse0 = lse[bh];
  // key c: first + c * kGroups, as K3
  const int first = part * kKeys * kGroups + grp;
  float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    Raw<T> kr[kBatch], vr[kBatch], dkr[kBatch], dvr[kBatch];
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const int64_t j = first + (half * kBatch + c) * kGroups;
      zero_raw(dkr[c]);
      zero_raw(dvr[c]);
      if (hv.on && j < S) {
        load_raw(hv.k + j * hv.stride, kr[c]);
        load_raw(hv.v + j * hv.stride, vr[c]);
        if (j > 0) {
          load_raw_rw(dk_base + j * hv.stride, dkr[c]);
          load_raw_rw(dk_base + j * hv.stride + dk_off, dvr[c]);
        }
      } else {
        zero_raw(kr[c]);
        zero_raw(vr[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kBatch; ++c) {
      const int64_t j = first + (half * kBatch + c) * kGroups;
      float k[kVec], v[kVec];
      to_float(kr[c], k);
      to_float(vr[c], v);
      float dot = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        dot = fmaf(q[e], k[e], dot);
        dp = fmaf(g[e], v[e], dp);
      }
      dot = group_sum<G>(dot);
      dp = group_sum<G>(dp);
      const float p = j < S ? expf(dot * scale - lse0) : 0.f;
      const float ds = p * (dp - delta);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(ds, k[e], acc[e]);
      if (!(hv.on && j < S)) continue;
      float dk[kVec], dv[kVec];
      to_float(dkr[c], dk);  // zero for key 0
      to_float(dvr[c], dv);
      const float dsq = ds * scale;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        dk[e] = fmaf(dsq, q[e], dk[e]);
        dv[e] = fmaf(p, g[e], dv[e]);
      }
      if (j == 0) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          sm_share[0][lane * kVec + e] = dk[e];
          sm_share[1][lane * kVec + e] = dv[e];
        }
      } else {
        store_vec(dk_base + j * hv.stride, dk);
        store_vec(dk_base + j * hv.stride + dk_off, dv);
      }
    }
  }
  warp_groups_sum<G>(acc);
  if (threadIdx.x % 32 < G) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) sm_acc[warp][lane * kVec + e] = acc[e];
  }
  __syncthreads();
  // [3, Dh]: this part's dq0 / scale, and its dk, dv of the CLS key
  float* dst = scratch + (bh * parts + part) * 3 * Dh;
  for (int t = threadIdx.x; t < Dh; t += kThreads) {
    float x = sm_acc[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += sm_acc[w][t];
    dst[t] = x;
  }
  if (threadIdx.x < 2 * Dh) {
    const int u = threadIdx.x;
    if (part == 0) cls_sum += sm_share[u / Dh][u % Dh];
    dst[Dh + u] = cls_sum;
  }
}

// K6, second launch: row 0 of dq, dk and dv from the parts' [3, Dh]. Grid
// (H, B), kMergeThreads threads: column t of slice r sums parts r,
// r + kSlices, ...; the slices are summed in order.
template <typename T, int G>
__global__ void __launch_bounds__(kMergeThreads)
    cls_row_bwd_merge_kernel(const float* __restrict__ scratch,
                             T* __restrict__ dqkv, int S, int H, int Dh,
                             int parts, float scale) {
  constexpr int kCols = G * kVec, kSlices = kMergeThreads / kCols;
  __shared__ float sm[3][kSlices][kCols];
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = (int64_t)b * H + h;
  const float* sc = scratch + bh * parts * 3 * Dh;
  const int t = threadIdx.x % kCols, r = threadIdx.x / kCols;
  float sum[3] = {0.f, 0.f, 0.f};
  if (t < Dh) {
#pragma unroll 8
    for (int x = r; x < parts; x += kSlices) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sum[i] += sc[(x * 3 + i) * Dh + t];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) sm[i][r][t] = sum[i];
  __syncthreads();
  if (r == 0 && t < Dh) {
    for (int j = 1; j < kSlices; ++j) {
#pragma unroll
      for (int i = 0; i < 3; ++i) sum[i] += sm[i][j][t];
    }
    T* row0 = dqkv + (int64_t)b * S * 3 * H * Dh + (int64_t)h * Dh;
    store_one(row0 + t, sum[0] * scale);
    store_one(row0 + (int64_t)H * Dh + t, sum[1]);
    store_one(row0 + 2LL * H * Dh + t, sum[2]);
  }
}

// The tensor-core form of K5 (K4's is space_bwd_frame_kernel, in
// space_attention.cu).
namespace mma {

constexpr int kPad = 8;  // bf16 of padding a shared-memory row
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

// K5 on the tensor cores: the bf16 time axis for Dh a multiple of 16 up to
// 64 and F <= 63, so that a column's F + 1 keys fit one tile of 64.
// Replaces `_packed_bwd_time_fp_mxu` (egovlpv2_tpu/ops/divided.py:957) at
// F <= 8 and, at F > 8, the patch-major window branch of
// `_packed_bwd_kernel` (:874-903: `_space_fb_bwd` :623 on rows that
// `_to_patch_major` :237 made contiguous, in windows of `_pm_window` :206).
// Here a warp gathers a column's rows by stride instead of a permute.
// Bound: bytes. qkv and g are read once and dqkv written once, 540 MB at
// B=8, S=6273 (0.161 ms on an H100). The grouped CUDA-core passes walked a
// column's keys one at a time, twice (a query and a key pass), each step
// waiting on its loads and on two shuffle sums.
// Design: a block is one warp and owns `cols` patch columns of one (b, h),
// one after another. For a column it stages with 16-byte cp.async the CLS
// key and the F frames' k and v rows (KP rows, keys past F zero-filled) and
// the F q and g rows (QP rows), then, on the tensor cores, 16 query rows at
// a time:
//   S = Q K^T and dP = G V^T; the exact row softmax P in f32 (all F + 1
//   keys are in the tile, so no running max); delta = sum P dP in f32;
//   dS = P (dP - delta); dQ = scale dS K, dS rounded to bf16 in registers;
//   P and dS, rounded to bf16, go to shared memory;
// and 16 keys at a time dK = scale dS^T Q and dV = P^T G, the transposed
// operands read with ldmatrix.trans. The reference rounds P and dS the same
// way (`p_c`, `ds_c`, divided.py:696,710). Rows 1..S-1 of dq, dk and dv are
// stored; the CLS key's row of dK and dV is added, column after column, to
// the block's f32 sum in shared memory, which goes to `cls_part` [B, H,
// parts, 2, Dh] at the end: the same order, so the same bits, every run.
// Nothing else leaves the block, and no score is computed twice.
constexpr int kTimeThreads = 32;

// The 16-row tiles of a column: KP = 16 * kt keys (the CLS key, then the F
// frames), QP = 16 * qt queries.
__host__ __device__ __forceinline__ int time_key_tiles(int F) {
  return (F + 16) / 16;
}
__host__ __device__ __forceinline__ int time_query_tiles(int F) {
  return (F + 15) / 16;
}

// Shared memory of a block: K, V (KP rows) and Q, G (QP rows) at a pitch of
// Dh + 8 bf16, P and dS (QP rows) at KP + 8, all bf16; the f32 [2, Dh]
// sum of the CLS key's dk and dv.
inline int time_shared_bytes(int Dh, int F) {
  const int kp = 16 * time_key_tiles(F), qp = 16 * time_query_tiles(F);
  return 2 * ((2 * kp + 2 * qp) * (Dh + kPad) + 2 * qp * (kp + kPad)) +
         2 * Dh * 4;
}

template <int DH, int KT>
__global__ void __launch_bounds__(kTimeThreads)
    time_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ gout,
                    __nv_bfloat16* __restrict__ dqkv,
                    float* __restrict__ cls_part, int S, int H, int N, int F,
                    int cols, float scale) {
  constexpr int KP = 16 * KT, LD = DH + kPad, LDP = KP + kPad;
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int qt = time_query_tiles(F), QP = 16 * qt;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + KP * LD;
  __nv_bfloat16* sQ = sV + KP * LD;
  __nv_bfloat16* sG = sQ + QP * LD;
  __nv_bfloat16* sP = sG + QP * LD;
  __nv_bfloat16* sD = sP + QP * LDP;
  float* sCls = reinterpret_cast<float*>(sD + QP * LDP);  // [2][DH]
  const int h = blockIdx.x, part = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const __nv_bfloat16* gbase = gout + (int64_t)b * S * width + (int64_t)h * DH;
  __nv_bfloat16* dbase = dqkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const float sl2 = scale * kLog2e;
  for (int i = lane; i < 2 * DH; i += kTimeThreads) sCls[i] = 0.f;
  const int n_end = min(N, (part + 1) * cols);
  for (int n = part * cols; n < n_end; ++n) {
    // Stage the column: tile rows 0..KP-1 keys (k), KP..2KP-1 keys (v),
    // then QP queries (q) and QP (g); sV, sQ and sG follow sK.
    const int total = (2 * KP + 2 * QP) * kChunks;
    for (int i = lane; i < total; i += kTimeThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const __nv_bfloat16* src;
      bool live;
      if (r < 2 * KP) {
        const int j = r % KP;  // key j: the CLS key, then frame j - 1
        live = j <= F;
        const int64_t row = live && j > 0 ? 1 + (int64_t)(j - 1) * N + n : 0;
        src = qbase + row * stride + (r < KP ? width : 2 * width) + c;
      } else {
        const int rq = r - 2 * KP, i_q = rq % QP;  // query i_q: frame i_q
        live = i_q < F;
        const int64_t row = 1 + (int64_t)(live ? i_q : 0) * N + n;
        src = rq < QP ? qbase + row * stride + c : gbase + row * width + c;
      }
      cp_async16(sK + r * LD + c, src, live);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();

    // 16 queries at a time: rows lo = m0 + g and hi = lo + 8 of the tile.
    for (int m0 = 0; m0 < QP; m0 += 16) {
      float s[2 * KT][4], dp[2 * KT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < DH; k0 += 16) {
        uint32_t qa[4], ga[4];
        ldsm4<false>(qa, sQ + rows16(LD, m0, k0, lane));
        ldsm4<false>(ga, sG + rows16(LD, m0, k0, lane));
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t kb[4], vb[4];
          ldsm4<false>(kb, sK + cols16(LD, np * 16, k0, lane));
          ldsm4<false>(vb, sV + cols16(LD, np * 16, k0, lane));
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
      // The exact softmax of each row over keys 0..F, in the base-2 domain.
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = nt * 8 + 2 * t + (e & 1) <= F;
          s[nt][e] = valid ? s[nt][e] * sl2 : -INFINITY;
        }
        m_lo = fmaxf(m_lo, fmaxf(s[nt][0], s[nt][1]));
        m_hi = fmaxf(m_hi, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
      }
      float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - m_lo);
        s[nt][1] = exp2f(s[nt][1] - m_lo);
        s[nt][2] = exp2f(s[nt][2] - m_hi);
        s[nt][3] = exp2f(s[nt][3] - m_hi);
        l_lo += s[nt][0] + s[nt][1];
        l_hi += s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      // Rows past F (zero q and g) get P = dS = 0.
      const bool ok_lo = m0 + g < F, ok_hi = m0 + g + 8 < F;
      const float inv_lo = ok_lo ? 1.f / l_lo : 0.f;
      const float inv_hi = ok_hi ? 1.f / l_hi : 0.f;
      float d_lo = 0.f, d_hi = 0.f;  // delta = sum P dP
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] *= inv_lo;
        s[nt][1] *= inv_lo;
        s[nt][2] *= inv_hi;
        s[nt][3] *= inv_hi;
        d_lo += s[nt][0] * dp[nt][0] + s[nt][1] * dp[nt][1];
        d_hi += s[nt][2] * dp[nt][2] + s[nt][3] * dp[nt][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
      }
      // dS into dp; P and dS, rounded, to shared memory for the key tiles
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        dp[nt][0] = s[nt][0] * (dp[nt][0] - d_lo);
        dp[nt][1] = s[nt][1] * (dp[nt][1] - d_lo);
        dp[nt][2] = s[nt][2] * (dp[nt][2] - d_hi);
        dp[nt][3] = s[nt][3] * (dp[nt][3] - d_hi);
        const int at = (m0 + g) * LDP + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(sP + at) = pack_bf16(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(sP + at + 8 * LDP) =
            pack_bf16(s[nt][2], s[nt][3]);
        *reinterpret_cast<uint32_t*>(sD + at) =
            pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(sD + at + 8 * LDP) =
            pack_bf16(dp[nt][2], dp[nt][3]);
      }
      // dQ = scale dS K: dS's C fragments are the A fragments of the keys'
      // 16-wide steps; K read transposed.
      float dq[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        const uint32_t a[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                               pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                               pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                               pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
        for (int d0 = 0; d0 < DH; d0 += 16) {
          uint32_t kb[4];
          ldsm4<true>(kb, sK + rows16(LD, kc * 16, d0, lane));
          mma_bf16(dq[d0 / 8], a, kb[0], kb[1]);
          mma_bf16(dq[d0 / 8 + 1], a, kb[2], kb[3]);
        }
      }
      __nv_bfloat16* q_lo = dbase + (1 + (int64_t)(m0 + g) * N + n) * stride;
      __nv_bfloat16* q_hi = q_lo + 8LL * N * stride;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const int c = nd * 8 + 2 * t;
        if (ok_lo) {
          *reinterpret_cast<uint32_t*>(q_lo + c) =
              pack_bf16(dq[nd][0] * scale, dq[nd][1] * scale);
        }
        if (ok_hi) {
          *reinterpret_cast<uint32_t*>(q_hi + c) =
              pack_bf16(dq[nd][2] * scale, dq[nd][3] * scale);
        }
      }
    }
    __syncwarp();

    // 16 keys at a time: dK = scale dS^T Q and dV = P^T G over the queries.
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
        dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
      }
      for (int q0 = 0; q0 < QP; q0 += 16) {
        uint32_t da[4], pa[4];
        ldsm4<true>(da, sD + cols16(LDP, q0, kt * 16, lane));
        ldsm4<true>(pa, sP + cols16(LDP, q0, kt * 16, lane));
#pragma unroll
        for (int d0 = 0; d0 < DH; d0 += 16) {
          uint32_t qb[4], gb[4];
          ldsm4<true>(qb, sQ + rows16(LD, q0, d0, lane));
          ldsm4<true>(gb, sG + rows16(LD, q0, d0, lane));
          mma_bf16(dk[d0 / 8], da, qb[0], qb[1]);
          mma_bf16(dk[d0 / 8 + 1], da, qb[2], qb[3]);
          mma_bf16(dv[d0 / 8], pa, gb[0], gb[1]);
          mma_bf16(dv[d0 / 8 + 1], pa, gb[2], gb[3]);
        }
      }
      // key j_lo = kt * 16 + g and j_hi = j_lo + 8; key 0 is the CLS key
      const int j_lo = kt * 16 + g, j_hi = j_lo + 8;
      __nv_bfloat16* k_lo =
          dbase + (1 + (int64_t)(j_lo - 1) * N + n) * stride + width;
      __nv_bfloat16* k_hi = k_lo + 8LL * N * stride;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const int c = nd * 8 + 2 * t;
        if (j_lo == 0) {
          sCls[c] += dk[nd][0] * scale;
          sCls[c + 1] += dk[nd][1] * scale;
          sCls[DH + c] += dv[nd][0];
          sCls[DH + c + 1] += dv[nd][1];
        } else if (j_lo <= F) {
          *reinterpret_cast<uint32_t*>(k_lo + c) =
              pack_bf16(dk[nd][0] * scale, dk[nd][1] * scale);
          *reinterpret_cast<uint32_t*>(k_lo + width + c) =
              pack_bf16(dv[nd][0], dv[nd][1]);
        }
        if (j_hi <= F) {
          *reinterpret_cast<uint32_t*>(k_hi + c) =
              pack_bf16(dk[nd][2] * scale, dk[nd][3] * scale);
          *reinterpret_cast<uint32_t*>(k_hi + width + c) =
              pack_bf16(dv[nd][2], dv[nd][3]);
        }
      }
    }
    __syncwarp();  // before the next column is staged over these tiles
  }
  float* dst = cls_part + (((int64_t)b * H + h) * gridDim.y + part) * 2 * DH;
  for (int i = lane; i < 2 * DH; i += kTimeThreads) dst[i] = sCls[i];
}

template <int DH, int KT>
int launch_time_tiles(const void* qkv, const void* gout, void* dqkv,
                      float* cls_part, int B, int S, int H, int F, int cols,
                      int parts, int shared_bytes, float scale,
                      cudaStream_t stream) {
  auto kernel = time_bwd_kernel<DH, KT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, parts, B), kTimeThreads, shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), cls_part, S, H, (S - 1) / F, F, cols,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_time(const void* qkv, const void* gout, void* dqkv,
                float* cls_part, int B, int S, int H, int F, int cols,
                int parts, int shared_bytes, float scale, cudaStream_t st) {
  switch (time_key_tiles(F)) {
    case 1: return launch_time_tiles<DH, 1>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 2: return launch_time_tiles<DH, 2>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 3: return launch_time_tiles<DH, 3>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 4: return launch_time_tiles<DH, 4>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mma

// K5's tensor-core form: bf16 with Dh in {16, 32, 48, 64} and F + 1 keys
// in at most four 16-row tiles.
inline bool time_on_tensor_cores(int dtype, int Dh, int F) {
  return dtype == 1 && Dh % 16 == 0 && Dh <= 64 && F >= 1 && F <= 63;
}

int time_mma(const void* qkv, const void* gout, void* dqkv, float* cls_part,
             int B, int S, int H, int Dh, int F, int cols, int parts,
             int shared_bytes, float scale, cudaStream_t st) {
  switch (Dh) {
    case 16: return mma::launch_time<16>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 32: return mma::launch_time<32>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 48: return mma::launch_time<48>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 64: return mma::launch_time<64>(qkv, gout, dqkv, cls_part, B, S, H, F, cols, parts, shared_bytes, scale, st);
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

// K3's geometry: any run other than the compiled kClsKeys * kThreads / G,
// or parts that do not cover S with runs, is refused.
template <typename T, int G>
int launch_cls_row(const void* qkv, const void* gout, const void* out,
                   const float* lse, void* dqkv, const float* cls_part,
                   int cls_parts, float* scratch, int B, int S, int H, int Dh,
                   int run, int parts, float scale, cudaStream_t stream) {
  if (run != kClsKeys * (kThreads / G) || parts != (S + run - 1) / run) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cls_row_bwd_part_kernel<T, G><<<dim3(H, parts, B), kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(gout),
      static_cast<const T*>(out), lse, static_cast<T*>(dqkv), cls_part,
      scratch, cls_parts, S, H, Dh, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cls_row_bwd_merge_kernel<T, G><<<dim3(H, B), kMergeThreads, 0, stream>>>(
      scratch, static_cast<T*>(dqkv), S, H, Dh, parts, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cls_row_bwd(const void* qkv, const void* gout, const void* out,
                const float* lse, void* dqkv, const float* cls_part,
                int cls_parts, float* scratch, int B, int S, int H, int Dh,
                int run, int parts, float scale, cudaStream_t st) {
  switch (group_size(Dh)) {
    case 1: return launch_cls_row<T, 1>(qkv, gout, out, lse, dqkv, cls_part, cls_parts, scratch, B, S, H, Dh, run, parts, scale, st);
    case 2: return launch_cls_row<T, 2>(qkv, gout, out, lse, dqkv, cls_part, cls_parts, scratch, B, S, H, Dh, run, parts, scale, st);
    case 4: return launch_cls_row<T, 4>(qkv, gout, out, lse, dqkv, cls_part, cls_parts, scratch, B, S, H, Dh, run, parts, scale, st);
    case 8: return launch_cls_row<T, 8>(qkv, gout, out, lse, dqkv, cls_part, cls_parts, scratch, B, S, H, Dh, run, parts, scale, st);
    case 16: return launch_cls_row<T, 16>(qkv, gout, out, lse, dqkv, cls_part, cls_parts, scratch, B, S, H, Dh, run, parts, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of a grouped query pass: kThreads / G patch rows a block.
inline int grouped_parts(int S, int Dh) {
  const int rows = kThreads / group_size(Dh);
  return (S - 1 + rows - 1) / rows;
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

// K4's grouped form on `space_bwd_geometry`: `parts` the blocks of its
// query pass a (b, h), the parts axis of `cls_part` [B, H, parts, 2, Dh]
// (f32); `stats` is [2, B, H, S] (f32). Any other geometry is refused. The
// frame form is space_attention_bwd_frame, in space_attention.cu.
int space_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                        void* stats, void* cls_part, int dtype, int B, int S,
                        int H, int Dh, int F, float scale, int parts,
                        void* stream) {
  if (parts != grouped_parts(S, Dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return grouped_bwd_any(false, qkv, gout, dqkv, stats, cls_part, dtype, B, S,
                         H, Dh, F, scale, stream);
}

// K5 on `time_bwd_geometry` (ops/_kernels.py): `tensor_cores` picks the
// tensor-core form (one warp a block, `cols` columns a block, `parts`
// blocks a (b, h), `shared_bytes` of dynamic shared memory) or the grouped
// form (`parts` its query pass's blocks); any geometry other than the one
// this file computes for that form is refused. The tensor-core form writes
// no `stats`.
int time_attention_bwd(const void* qkv, const void* gout, void* dqkv,
                       void* stats, void* cls_part, int dtype, int B, int S,
                       int H, int Dh, int F, float scale, int tensor_cores,
                       int cols, int parts, int shared_bytes, void* stream) {
  const int N = (S - 1) / F;
  if (tensor_cores) {
    if (!time_on_tensor_cores(dtype, Dh, F) || cols < 1 ||
        parts != (N + cols - 1) / cols ||
        shared_bytes != mma::time_shared_bytes(Dh, F)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return time_mma(qkv, gout, dqkv, static_cast<float*>(cls_part), B, S, H,
                    Dh, F, cols, parts, shared_bytes, scale,
                    static_cast<cudaStream_t>(stream));
  }
  if (parts != grouped_parts(S, Dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return grouped_bwd_any(true, qkv, gout, dqkv, stats, cls_part, dtype, B, S,
                         H, Dh, F, scale, stream);
}

// K6: from K3's output row 0 and lse0 [B, H] (f32), row 0 of dq and the
// CLS query's share added to every dk/dv row K4/K5 wrote, with row 0 of
// dk/dv, over the f32 `scratch` [B, H, parts, 3, Dh]; `run` and `parts`
// are K3's (`cls_row_geometry`), and any other is refused.
int cls_row_attention_bwd(const void* qkv, const void* gout, const void* out,
                          const void* lse, void* dqkv, const void* cls_part,
                          int cls_parts, void* scratch, int dtype, int B,
                          int S, int H, int Dh, int run, int parts,
                          float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* cp = static_cast<const float*>(cls_part);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) {
    return cls_row_bwd<float>(qkv, gout, out, l, dqkv, cp, cls_parts, sc, B,
                              S, H, Dh, run, parts, scale, st);
  }
  if (dtype == 1) {
    return cls_row_bwd<__nv_bfloat16>(qkv, gout, out, l, dqkv, cp, cls_parts,
                                      sc, B, S, H, Dh, run, parts, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
