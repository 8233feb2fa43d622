// Divided space-time attention for every CUDA input that K1-K6 do not take,
// for Hopper (sm_90a): float32 or bf16, any head dim up to 256, and q, k, v,
// the output, the cotangent and dqkv each read or written by its own strides.
//
// K10 `general_attention_fwd` and K11 `general_attention_bwd` replace three
// TPU kernels of egovlpv2_tpu/ops/divided.py that compute one function on
// two layouts:
//   * row 1d: the dense masked branch of `_packed_fwd_kernel` (:855-868)
//     and `_packed_bwd_kernel` (:915-954), with `_mask_bias` (:80) and
//     `_tile_attend` (:482), on the packed [B, S, 3*H*Dh] projection;
//   * rows 3 and 4: `_fwd_kernel` (:544, through `_fwd_pallas` :1204) and
//     `_bwd_kernel` (:565, through `_bwd_pallas` :1226) on the transposed
//     [3, B, H, S, Dh] copy, dense or frame-block (`_space_fb_fwd` :512,
//     `_space_fb_bwd` :623).
// Here q, k and v are read by stride (element strides per component, batch,
// row, head and head-dim element), so one pair reads either layout, and any
// strided view, without a copy.
//
// Function (`_divided_xla`): row 0, the CLS query, attends all S keys; a
// patch row i attends the CLS key and the keys j of its group:
// (i-1)/N == (j-1)/N on the space axis, (i-1)%N == (j-1)%N on the time axis
// (S = 1 + F*N). The TPU kernels add -1e9 to every other logit, whose exp
// is exactly 0 in f32 beside a live logit; so these kernels visit only the
// live keys, as the frame-block branch does: 1 + N keys a space row, 1 + F
// a time row, S for row 0. Products in f32 (a bf16 input is widened
// exactly), softmax in f32, outputs stored in the input type.
//
// Bound on this card (H100 SXM: 3.35 TB/s; 67 TFLOP/s in f32 outside the
// tensor cores), at the EgoTaskQA shape, f32, B=8, S=785, H=12, Dh=64. The
// forward reads qkv (57.9 MB) and writes the output (19.3 MB): 77 MB, 0.023
// ms; its work is 4*Dh flops a (row, live key) pair, 3.8 GFLOP on the space
// axis (0.057 ms at the f32 rate, which bounds it) and 0.2 GFLOP on the
// time axis. The backward reads qkv and the cotangent and writes dqkv: 135
// MB, 0.040 ms, with 2.5 times the forward's work (0.14 ms on the space
// axis).
//
// Design: simple and right first; bf16 on the tensor cores stays K1-K6's.
// One warp owns one row of one (batch, head); lane l holds the head-dim
// elements l, l+32, ... (E = ceil(Dh/32) of them), so any head dim and any
// alignment is taken and neighbouring lanes read neighbouring addresses
// when the head dim is contiguous; a q.k dot is E FMAs and a 5-step shuffle
// sum. Keys go kChunk at a time through an online softmax. The rows of a
// block are consecutive, so on the space axis its warps share their keys
// in L1. The backward is two launches and no atomics: a query pass (dq,
// each row's log-sum-exp and delta, and each block's f32 share of the CLS
// key's dk and dv: every row attends the CLS key, the one reduction across
// blocks), then a key pass (dk and dv of each patch key from the rows that
// attend it, its group and row 0; the CLS key's as the sum of the blocks'
// shares, in block order). The softmax is recomputed from qkv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;                // warps a block, one row each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 4;                // keys scored between rescales
constexpr int kRowsPerWarp = 8;          // rows a warp of the query pass
constexpr int kRowsPerPart = kWarps * kRowsPerWarp;  // rows of one share
constexpr int kMaxDh = 256;

// Element strides of a [(3,) B, S, H, Dh] view: component, batch, row,
// head, head-dim element.
struct View {
  int64_t c, b, r, h, d;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int E>
__device__ __forceinline__ void load_row(const T* p, int64_t sd, int Dh,
                                         int lane, float (&x)[E]) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    x[e] = d < Dh ? widen(p[d * sd]) : 0.f;
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_row(T* p, int64_t sd, int Dh, int lane,
                                          const float (&x)[E], float mul) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = lane + 32 * e;
    if (d < Dh) put(p + d * sd, x[e] * mul);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Every lane of the warp must call it.
template <int E>
__device__ __forceinline__ float dot(const float (&a)[E], const float (&b)[E]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s = fmaf(a[e], b[e], s);
  return warp_sum(s);
}

// The rows that row `row` attends as a query, which are also the rows that
// attend it as a key: member 0 is row 0 (the CLS token), member t >= 1 is
// row first + (t-1)*step, for t < count.
struct Group {
  int first, step, count;
};

__device__ __forceinline__ Group group_of(int row, int S, int N, int F,
                                          bool time_axis) {
  if (row == 0) return Group{1, 1, S};
  if (time_axis) return Group{1 + (row - 1) % N, N, F + 1};
  return Group{1 + ((row - 1) / N) * N, 1, N + 1};
}

__device__ __forceinline__ int64_t member(const Group& g, int t) {
  return t == 0 ? 0 : g.first + (int64_t)(t - 1) * g.step;
}

// One query row q over the keys of group g: running max m, sum l and the
// unnormalised output acc.
template <typename T, int E>
__device__ __forceinline__ void attend(const T* kb, const T* vb,
                                       const View& in, int Dh, int lane,
                                       const float (&q)[E], const Group& g,
                                       float scale, float& m, float& l,
                                       float (&acc)[E]) {
  m = -INFINITY;
  l = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int t0 = 0; t0 < g.count; t0 += kChunk) {
    float s[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float k[E];
      const bool live = t0 + c < g.count;  // the same across the warp
      if (live) {
        load_row(kb + member(g, t0 + c) * in.r, in.d, Dh, lane, k);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) k[e] = 0.f;
      }
      s[c] = live ? dot(q, k) * scale : -INFINITY;
      cmax = fmaxf(cmax, s[c]);
    }
    const float m_new = fmaxf(m, cmax);  // finite: t0 < count
    const float corr = expf(m - m_new);  // 0 on the first chunk
    l *= corr;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < g.count) {
        const float p = expf(s[c] - m_new);
        float v[E];
        load_row(vb + member(g, t0 + c) * in.r, in.d, Dh, lane, v);
        l += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p, v[e], acc[e]);
      }
    }
    m = m_new;
  }
}

// K10. Grid (ceil(S / kWarps), H, B); warp w of block x owns row x*kWarps+w.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    general_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                       View in, View os, int S, int Dh, int N, int F,
                       int time_axis, float scale) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= S) return;  // the whole warp
  const int h = blockIdx.y, b = blockIdx.z;
  const T* base = qkv + b * in.b + h * in.h;
  float q[E], acc[E], m, l;
  load_row(base + row * in.r, in.d, Dh, lane, q);
  attend<T, E>(base + in.c, base + 2 * in.c, in, Dh, lane, q,
               group_of(row, S, N, F, time_axis != 0), scale, m, l, acc);
  store_row(out + b * os.b + row * os.r + h * os.h, os.d, Dh, lane, acc,
            1.f / l);
}

// K11, first launch: the query pass. Grid (parts, H, B), parts =
// ceil(S / kRowsPerPart); warp w of block x owns the rows
// x*kRowsPerPart + k*kWarps + w, k < kRowsPerWarp. Writes dq of its rows,
// their log-sum-exp and delta (stats [2, B, H, S]), and the block's share
// of the CLS key's dk / scale and dv (share [B, H, parts, 2, Dh]).
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    general_bwd_query_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ g, T* __restrict__ dqkv,
                             float* __restrict__ stats,
                             float* __restrict__ share, View in, View gs,
                             View ds, int S, int Dh, int N, int F,
                             int time_axis, float scale) {
  __shared__ float warp_share[kWarps][2][kMaxDh];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, B = gridDim.z, parts = gridDim.x;
  const T* base = qkv + b * in.b + h * in.h;
  const T* kb = base + in.c;
  const T* vb = base + 2 * in.c;
  float cdk[E], cdv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) cdk[e] = cdv[e] = 0.f;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int row = part * kRowsPerPart + k * kWarps + warp;
    if (row >= S) break;  // the whole warp
    float q[E], go[E], acc[E], dq[E], m, l;
    load_row(base + row * in.r, in.d, Dh, lane, q);
    load_row(g + b * gs.b + row * gs.r + h * gs.h, gs.d, Dh, lane, go);
    const Group grp = group_of(row, S, N, F, time_axis != 0);
    attend<T, E>(kb, vb, in, Dh, lane, q, grp, scale, m, l, acc);
    const float inv = 1.f / l;
    float part_delta = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) part_delta = fmaf(go[e], acc[e] * inv, part_delta);
    const float delta = warp_sum(part_delta);  // sum_j P_ij dP_ij = g.o
    const float lse = m + logf(l);
#pragma unroll
    for (int e = 0; e < E; ++e) dq[e] = 0.f;
    for (int t = 0; t < grp.count; ++t) {
      const int64_t j = member(grp, t);
      float kk[E], vv[E];
      load_row(kb + j * in.r, in.d, Dh, lane, kk);
      load_row(vb + j * in.r, in.d, Dh, lane, vv);
      const float s = dot(q, kk) * scale;
      const float dp = dot(go, vv);
      const float p = expf(s - lse);
      const float dsv = p * (dp - delta);
#pragma unroll
      for (int e = 0; e < E; ++e) dq[e] = fmaf(dsv, kk[e], dq[e]);
      if (t == 0) {  // the CLS key
#pragma unroll
        for (int e = 0; e < E; ++e) {
          cdk[e] = fmaf(dsv, q[e], cdk[e]);
          cdv[e] = fmaf(p, go[e], cdv[e]);
        }
      }
    }
    store_row(dqkv + b * ds.b + row * ds.r + h * ds.h, ds.d, Dh, lane, dq,
              scale);
    if (lane == 0) {
      stats[((int64_t)b * H + h) * S + row] = lse;
      stats[(((int64_t)B + b) * H + h) * S + row] = delta;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    warp_share[warp][0][lane + 32 * e] = cdk[e];
    warp_share[warp][1][lane + 32 * e] = cdv[e];
  }
  __syncthreads();
  float* out = share + (((int64_t)b * H + h) * parts + part) * 2 * Dh;
  for (int i = threadIdx.x; i < 2 * Dh; i += kThreads) {
    const int which = i / Dh, d = i % Dh;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_share[w][which][d];
    out[i] = sum;
  }
}

// K11, second launch: the key pass. Grid (ceil(S / kWarps), H, B); warp w
// of block x owns key row j = x*kWarps + w. A patch key gathers dk and dv
// from the rows that attend it; the CLS key (j = 0) sums the blocks'
// shares of the query pass.
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    general_bwd_key_kernel(const T* __restrict__ qkv,
                           const T* __restrict__ g, T* __restrict__ dqkv,
                           const float* __restrict__ stats,
                           const float* __restrict__ share, View in, View gs,
                           View ds, int S, int Dh, int N, int F,
                           int time_axis, float scale, int parts) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + threadIdx.x / 32;
  if (j >= S) return;  // the whole warp
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, B = gridDim.z;
  T* dbase = dqkv + b * ds.b + j * ds.r + h * ds.h;
  float dk[E], dv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) dk[e] = dv[e] = 0.f;
  if (j == 0) {
    const float* p = share + ((int64_t)b * H + h) * parts * 2 * Dh;
    for (int x = 0; x < parts; ++x, p += 2 * Dh) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = lane + 32 * e;
        if (d < Dh) {
          dk[e] += p[d];
          dv[e] += p[Dh + d];
        }
      }
    }
  } else {
    const T* base = qkv + b * in.b + h * in.h;
    const T* gb = g + b * gs.b + h * gs.h;
    const float* lse = stats + ((int64_t)b * H + h) * S;
    const float* delta = stats + (((int64_t)B + b) * H + h) * S;
    float kk[E], vv[E];
    load_row(base + in.c + j * in.r, in.d, Dh, lane, kk);
    load_row(base + 2 * in.c + j * in.r, in.d, Dh, lane, vv);
    const Group grp = group_of(j, S, N, F, time_axis != 0);
    for (int t = 0; t < grp.count; ++t) {
      const int64_t i = member(grp, t);
      float q[E], go[E];
      load_row(base + i * in.r, in.d, Dh, lane, q);
      load_row(gb + i * gs.r, gs.d, Dh, lane, go);
      const float s = dot(q, kk) * scale;
      const float dp = dot(go, vv);
      const float p = expf(s - lse[i]);
      const float dsv = p * (dp - delta[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dk[e] = fmaf(dsv, q[e], dk[e]);
        dv[e] = fmaf(p, go[e], dv[e]);
      }
    }
  }
  store_row(dbase + ds.c, ds.d, Dh, lane, dk, scale);
  store_row(dbase + 2 * ds.c, ds.d, Dh, lane, dv, 1.f);
}

int parts_of(int S) { return (S + kRowsPerPart - 1) / kRowsPerPart; }

struct Shape {
  int B, S, H, Dh, N, F, time_axis;
  float scale;
};

template <typename T, int E>
int launch_fwd(const void* qkv, void* out, const View& in, const View& os,
               const Shape& sh, cudaStream_t stream) {
  const dim3 grid((sh.S + kWarps - 1) / kWarps, sh.H, sh.B);
  general_fwd_kernel<T, E><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), in, os, sh.S, sh.Dh,
      sh.N, sh.F, sh.time_axis, sh.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int launch_bwd(const void* qkv, const void* g, void* dqkv, float* stats,
               float* share, const View& in, const View& gs, const View& ds,
               const Shape& sh, cudaStream_t stream) {
  const int parts = parts_of(sh.S);
  general_bwd_query_kernel<T, E><<<dim3(parts, sh.H, sh.B), kThreads, 0,
                                   stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), stats, share, in, gs, ds, sh.S, sh.Dh, sh.N,
      sh.F, sh.time_axis, sh.scale);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  general_bwd_key_kernel<T, E><<<dim3((sh.S + kWarps - 1) / kWarps, sh.H,
                                      sh.B),
                                 kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), stats, share, in, gs, ds, sh.S, sh.Dh, sh.N,
      sh.F, sh.time_axis, sh.scale, parts);
  return static_cast<int>(cudaGetLastError());
}

// E = 1, 2, 4 or 8 head-dim elements a lane, by head dim.
template <typename Fn>
int by_head_dim(int Dh, Fn&& fn) {
  if (Dh <= 32) return fn(std::integral_constant<int, 1>());
  if (Dh <= 64) return fn(std::integral_constant<int, 2>());
  if (Dh <= 128) return fn(std::integral_constant<int, 4>());
  if (Dh <= kMaxDh) return fn(std::integral_constant<int, 8>());
  return static_cast<int>(cudaErrorInvalidValue);
}

View view_of(const int64_t* s) { return View{s[0], s[1], s[2], s[3], s[4]}; }

}  // namespace

extern "C" {

// strides: [5] each, in elements, (component, batch, row, head, element);
// the component stride of `out` and `g` is not read.
int general_attention_fwd(const void* qkv, void* out, int dtype, int B, int S,
                          int H, int Dh, int F, int time_axis, float scale,
                          const int64_t* qkv_strides,
                          const int64_t* out_strides, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || F < 1 || S < 2 || (S - 1) % F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh{B, S, H, Dh, (S - 1) / F, F, time_axis, scale};
  const View in = view_of(qkv_strides), os = view_of(out_strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return by_head_dim(Dh, [&](auto e) {
      return launch_fwd<__nv_bfloat16, decltype(e)::value>(qkv, out, in, os,
                                                           sh, st);
    });
  }
  return by_head_dim(Dh, [&](auto e) {
    return launch_fwd<float, decltype(e)::value>(qkv, out, in, os, sh, st);
  });
}

// The number of query-pass blocks a (batch, head): the `parts` axis of the
// f32 scratch `share` [B, H, parts, 2, Dh]; `stats` is f32 [2, B, H, S].
int general_attention_bwd_parts(int S) { return parts_of(S); }

int general_attention_bwd(const void* qkv, const void* g, void* dqkv,
                          void* stats, void* share, int dtype, int B, int S,
                          int H, int Dh, int F, int time_axis, float scale,
                          const int64_t* qkv_strides,
                          const int64_t* g_strides,
                          const int64_t* dqkv_strides, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || F < 1 || S < 2 || (S - 1) % F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh{B, S, H, Dh, (S - 1) / F, F, time_axis, scale};
  const View in = view_of(qkv_strides), gs = view_of(g_strides),
             ds = view_of(dqkv_strides);
  float* st_ = static_cast<float*>(stats);
  float* sh_ = static_cast<float*>(share);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return by_head_dim(Dh, [&](auto e) {
      return launch_bwd<__nv_bfloat16, decltype(e)::value>(
          qkv, g, dqkv, st_, sh_, in, gs, ds, sh, st);
    });
  }
  return by_head_dim(Dh, [&](auto e) {
    return launch_bwd<float, decltype(e)::value>(qkv, g, dqkv, st_, sh_, in,
                                                 gs, ds, sh, st);
  });
}

}  // extern "C"
