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
// Work split. K1 in bf16 with Dh a multiple of 16 and at most 208 keys a
// frame (every path) runs on the tensor cores (space_fwd_frame_kernel, in
// space_attention.cu), where `space_fwd_geometry` names it, and so does K2
// in bf16 with Dh a multiple of 16 up to 64 and F <= 63 (time_fwd_tc_kernel,
// in time_attention.cu), where `time_fwd_geometry` names it. Everything else
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
// This is K1's grouped form, which `space_fwd_geometry` names for f32, for
// the head dims the frame form (space_attention.cu) does not take and for
// frames of more than 208 keys.
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

// K2. Replaces the time branches of the packed TPU kernel: the frame-pair
// branch (divided.py:811-830, `_time_fp_attend_mxu`) and the patch-major
// window branch (divided.py:789-810, with its row permutes and the
// permute hoist of models/video.py:175-192).
// Bound: memory. Each row has only F+1 logits (17 at F=16), so the kernel
// is a gather of F+1 keys and values per row at stride N rows; compute is
// negligible.
// This is K2's grouped form, which `time_fwd_geometry` names for f32, for
// the head dims the tensor-core form (time_attention.cu) does not take and
// for F > 63. Design: no permute. Row groups enumerate rows column-major
// (group g -> patch n = g / F, frame f = g % F), so the F queries of one patch
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

// K1's grouped form on `space_fwd_geometry`: `rows` patch rows a block
// (kThreads / G) and `parts` blocks a (b, h) covering the S - 1 patch rows;
// any other geometry is refused. The frame form is
// space_attention_fwd_frame, in space_attention.cu.
int space_attention_fwd(const void* qkv, void* out, int dtype, int B, int S,
                        int H, int Dh, int F, float scale, int rows, int parts,
                        void* stream) {
  if (rows != kThreads / group_size(Dh) || parts != (S - 1 + rows - 1) / rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<Space>(qkv, out, dtype, B, S, H, Dh, F, scale, stream);
}

// K2's grouped form on `time_fwd_geometry`: `rows` patch rows a block
// (kThreads / G) and `parts` blocks a (b, h) covering the S - 1 patch rows;
// any other geometry is refused. The tensor-core form is
// time_attention_fwd_tc, in time_attention.cu.
int time_attention_fwd(const void* qkv, void* out, int dtype, int B, int S,
                       int H, int Dh, int F, float scale, int rows, int parts,
                       void* stream) {
  if (rows != kThreads / group_size(Dh) || parts != (S - 1 + rows - 1) / rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
