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
// keys of the query's group: 1 + N keys a space row, 1 + F a time row (K10
// masks the other columns inside its time tile), S for row 0 (K10 splits
// it across the groups). Products in f32 (a bf16 input is widened
// exactly), softmax in f32, outputs stored in the input type.
//
// Bound on this card (H100 SXM: 3.35 TB/s; 67 TFLOP/s in f32 outside the
// tensor cores), at the EgoTaskQA shape, f32, B=8, S=785, H=12, Dh=64. The
// forward reads qkv (57.9 MB) and writes the output (19.3 MB): 77 MB, 0.023
// ms; its work is 4*Dh flops a (row, live key) pair, 3.8 GFLOP on the space
// axis (0.057 ms at the f32 rate, which bounds it) and 0.2 GFLOP on the
// time axis (bound by its 77 MB). The backward reads qkv and the cotangent
// and writes dqkv: 135 MB, 0.040 ms, with 2.5 times the forward's work (0.14
// ms on the space axis).
//
// K10, the forward, is tiled for Hopper's CUDA cores. A block owns a tile
// of kBQ = 64 query rows of one group of one (batch, head); grid (query
// tiles x groups, H, B). A group is a frame on the space axis (its N
// patch rows; keys: the CLS row and those rows), and on the time axis a
// run of `cols` patch columns over all F frames (F*cols <= 63 query rows,
// keys: the CLS row and the same rows, a query attending its own column's
// F + 1), so the keys of a block are staged once and the byte-bound time
// axis reads each row about once. Each group's list of rows is "unit 0 =
// the CLS row, unit 1 + t = its t-th row", cut into 64-row tiles:
//   * the Q tile is loaded once, times scale * log2(e); K and V tiles of
//     kBK = 64 rows go through a two-stage cp.async ring (one stage where
//     a group has one key tile, as on the time axis; 16-byte
//     cp.async.cg where the head dim is contiguous and every row 16-byte
//     aligned, 4-byte cp.async.ca for other f32 views; bf16 is widened
//     exactly into f32 by plain loads). Rows are padded to an odd number of
//     16-byte words, so the float4 reads of 8 rows hit 8 bank groups;
//   * 256 threads as 16 x 16: thread (ty, tx) scores rows ty + 16i and keys
//     tx + 16j (i, j < 4) with float4 reads from shared memory and FMAs,
//     no shuffle inside a product; the row max goes by 4 shuffles among
//     the 16 threads of a row, P to shared memory, and O += P.V keeps 4
//     rows x 4 columns (of each 64) a thread. Tiles that end part-way skip
//     the empty 16-row quarters;
//   * the CLS query row is split across the groups: the first query tile of
//     each group carries unit 0, which scores that group's rows (group 0
//     also the CLS key) and writes an f32 partial (m, l, acc[Dh]) to
//     [B, H, parts, Dh + 2]; a second launch merges the partials in group
//     order into output row 0. No atomics: every run gives the same bits.
// At Dh=64, f32, a block holds 105 KB of shared memory, two an SM. The
// tensor cores are not used: the f32 path runs with TF32 off and is held to
// 1e-4, which would need three TF32 products (a split of each operand) a
// product; that is a later step if this form stays above half its bound.
// The launch geometry (columns a time group, parts, query tiles, stages,
// the padded row stride, shared bytes) is computed in one place,
// `ops/_kernels.py::general_fwd_geometry`, and launched as given; the
// entry point only refuses tile rows other than the kBQ and kBK compiled
// here.
//
// K11, the backward, is simple and right first: one warp owns one row of
// one (batch, head); lane l holds the head-dim elements l, l+32, ... (E =
// ceil(Dh/32) of them), so any head dim and any alignment is taken; a q.k
// dot is E FMAs and a 5-step shuffle sum. Keys go kChunk at a time through
// an online softmax. It is two launches and no atomics: a query pass (dq,
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

// ---------------- K10: the tiled forward ----------------

constexpr int kBQ = 64;            // query rows (units) a block
constexpr int kBK = 64;            // key rows a tile
constexpr int kPLd = kBK + 16;     // P row stride: two rows 16 banks apart
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 256 && kBQ == 64 && kBK == 64,
              "K10 lays 256 threads out as 16 x 16 over 64 x 64 tiles");

// The geometry of one launch, from `general_fwd_geometry`.
struct Tiles {
  int N, F, time_axis;
  int cols;         // patch columns a time group (N on the space axis)
  int parts;        // groups: the grid's groups and the partials' parts
  int query_tiles;  // 64-row query tiles a group
  int stages;       // K/V ring stages, 1 or 2
  int dp;           // head dim padded to a multiple of 4
  int ld;           // Q/K/V row stride in floats: an odd number of float4s
};

// The rows of one group: unit 0 is the CLS row, unit 1 + t its t-th row,
// t < count, in frame-major order: row 1 + (t / nc) * N + c0 + t % nc.
struct Geo {
  int c0, nc, N;
};

__device__ __forceinline__ int64_t unit_row(int u, const Geo& g) {
  if (u == 0) return 0;
  const int t = u - 1;
  return 1 + (int64_t)(t / g.nc) * g.N + g.c0 + t % g.nc;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Units u0 .. u0 + 63 of a group, component `src` (q, k or v of one
// (batch, head)), into dst [64][ld] in f32 times `mul`; units from `valid`
// on and columns from Dh on are zero. kAsync: by cp.async (f32 and mul 1
// only; the caller commits and waits); else plain loads, visible after the
// caller's __syncthreads.
template <typename T, bool kAsync>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           const View& in, int Dh,
                                           const Tiles& tl, int u0, int valid,
                                           const Geo& g, float mul, bool vec) {
  if (vec) {  // the head dim contiguous, every row 16-byte aligned
    constexpr int kE = 16 / sizeof(T);
    const int per_row = tl.dp / kE;
    for (int i = threadIdx.x; i < kBQ * per_row; i += kThreads) {
      const int r = i / per_row, d = (i - r * per_row) * kE;
      const bool live = r < valid;
      const T* p = live ? src + unit_row(u0 + r, g) * in.r + d : src;
      float* s = dst + r * tl.ld + d;
      if constexpr (kAsync && std::is_same<T, float>::value) {
        cp_async16(s, p, live ? 16 : 0);
      } else if constexpr (std::is_same<T, float>::value) {
        float4 x = live ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
        *reinterpret_cast<float4*>(s) = x;
      } else {
        float f[8];
        widen8(live ? __ldg(reinterpret_cast<const uint4*>(p))
                    : make_uint4(0, 0, 0, 0), f);
        *reinterpret_cast<float4*>(s) =
            make_float4(f[0] * mul, f[1] * mul, f[2] * mul, f[3] * mul);
        *reinterpret_cast<float4*>(s + 4) =
            make_float4(f[4] * mul, f[5] * mul, f[6] * mul, f[7] * mul);
      }
    }
  } else {  // any strides: element by element
    for (int i = threadIdx.x; i < kBQ * tl.dp; i += kThreads) {
      const int r = i / tl.dp, d = i - r * tl.dp;
      const bool live = r < valid && d < Dh;
      const T* p = live ? src + unit_row(u0 + r, g) * in.r + d * in.d : src;
      float* s = dst + r * tl.ld + d;
      if constexpr (kAsync && std::is_same<T, float>::value) {
        cp_async4(s, p, live ? 4 : 0);
      } else {
        *s = live ? widen(*p) * mul : 0.f;
      }
    }
  }
}

// K10, first launch. Grid (query_tiles * parts, H, B), kThreads threads,
// dynamic shared memory Q [64][ld], K and V [stages][64][ld], P [64][kPLd].
// NC4: column groups of 4 of each 64 head-dim columns a thread keeps,
// ceil(dp / 64).
template <typename T, int NC4>
__global__ void __launch_bounds__(kThreads, NC4 <= 2 ? 2 : 1)
    general_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                       float* __restrict__ partials, View in, View os, int Dh,
                       Tiles tl, float qmul, int vec) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * tl.ld;
  float* Vs = Ks + tl.stages * kBK * tl.ld;
  float* Ps = Vs + tl.stages * kBK * tl.ld;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x % tl.query_tiles;
  const int grp = blockIdx.x / tl.query_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  Geo g;
  g.N = tl.N;
  g.c0 = grp * tl.cols;
  g.nc = tl.time_axis ? min(tl.cols, tl.N - g.c0) : tl.N;
  const int units = 1 + (tl.time_axis ? tl.F * g.nc : tl.N);
  const int q0 = qt * kBQ;
  if (q0 >= units) return;  // the whole block, before any barrier
  const int nq = min(kBQ, units - q0);
  const int imax = (nq + 15) >> 4;  // 16-row quarters that hold a unit
  const bool time_axis = tl.time_axis != 0;
  const T* base = qkv + b * in.b + h * in.h;
  const T* kb = base + in.c;
  const T* vb = base + 2 * in.c;
  const int ktiles = (units + kBK - 1) / kBK;

  stage_tile<T, false>(Qs, base, in, Dh, tl, q0, nq, g, qmul, vec != 0);
  auto load_tile = [&](int kt, int st) {
    const int valid = min(kBK, units - kt * kBK);
    stage_tile<T, true>(Ks + st * kBK * tl.ld, kb, in, Dh, tl, kt * kBK,
                        valid, g, 1.f, vec != 0);
    stage_tile<T, true>(Vs + st * kBK * tl.ld, vb, in, Dh, tl, kt * kBK,
                        valid, g, 1.f, vec != 0);
    cp_async_commit();
  };
  load_tile(0, 0);

  float m[4], lsum[4], acc[4][NC4][4];
  int qcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
    const int u = q0 + ty + 16 * i;
    qcol[i] = u >= 1 ? (u - 1) % g.nc : -1;
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }
  bool col_on[NC4];
#pragma unroll
  for (int c = 0; c < NC4; ++c) col_on[c] = tx * 4 + 64 * c < tl.dp;

  // One K/V tile; kFull: all 64 units of the query tile and of the key
  // tile hold a row, else the empty 16-row quarters are skipped.
  auto tile = [&](auto full_t, const float* K, const float* V, int w0,
                  int jmax) {
    constexpr bool kFull = decltype(full_t)::value;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int d = 0; d < tl.dp; d += 4) {
      float4 a[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kFull || i < imax)
          a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * tl.ld + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kFull || j < jmax)
          k[j] = *reinterpret_cast<const float4*>(K + (tx + 16 * j) * tl.ld + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (kFull || (i < imax && j < jmax)) {
            float x = s[i][j];
            x = fmaf(a[i].x, k[j].x, x);
            x = fmaf(a[i].y, k[j].y, x);
            x = fmaf(a[i].z, k[j].z, x);
            x = fmaf(a[i].w, k[j].w, x);
            s[i][j] = x;
          }
        }
      }
    }
    // mask, online softmax (log2 units), P to shared memory
    int kcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + tx + 16 * j;
      kcol[j] = w >= 1 ? (w - 1) % g.nc : -1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && i >= imax) continue;  // the same across the block
      const int u = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = w0 + tx + 16 * j;
        bool live = (kFull || j < jmax) && w < units;
        if (u == 0) {
          live = live && (w > 0 || grp == 0);  // the CLS key once
        } else if (time_axis && w > 0) {
          live = live && qcol[i] == kcol[j];
        }
        s[i][j] = live ? s[i][j] : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      // finite: the first tile holds a live key of every row
      const float m_new = fmaxf(m[i], mt);
      const float corr = exp2f(m[i] - m_new);  // 0 on the first tile
      m[i] = m_new;
      lsum[i] *= corr;
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kFull || j < jmax) {
          const float p = exp2f(s[i][j] - m_new);
          lsum[i] += p;
          Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        }
      }
    }
    __syncthreads();
    // O += P.V over the tile's keys (P is 0 past the last live key)
    const int wend = kFull ? kBK : 16 * jmax;
    for (int w = 0; w < wend; w += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kFull || i < imax)
          p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kPLd + w);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          if (!col_on[c]) continue;
          const float4 v = *reinterpret_cast<const float4*>(
              V + (w + kk) * tl.ld + tx * 4 + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (kFull || i < imax) {
              const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y
                               : kk == 2 ? p[i].z : p[i].w;
              acc[i][c][0] = fmaf(pk, v.x, acc[i][c][0]);
              acc[i][c][1] = fmaf(pk, v.y, acc[i][c][1]);
              acc[i][c][2] = fmaf(pk, v.z, acc[i][c][2]);
              acc[i][c][3] = fmaf(pk, v.w, acc[i][c][3]);
            }
          }
        }
      }
    }
  };

  for (int kt = 0; kt < ktiles; ++kt) {
    if (tl.stages == 2 && kt + 1 < ktiles) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, at kt = 0, Q) in shared memory
    const int st = tl.stages == 2 ? (kt & 1) : 0;
    const float* K = Ks + st * kBK * tl.ld;
    const float* V = Vs + st * kBK * tl.ld;
    const int nk = min(kBK, units - kt * kBK);
    const int jmax = (nk + 15) >> 4;
    if (nq == kBQ && nk == kBK) {
      tile(std::true_type(), K, V, kt * kBK, jmax);
    } else {
      tile(std::false_type(), K, V, kt * kBK, jmax);
    }
    __syncthreads();  // done with this stage and with P
    if (tl.stages == 1 && kt + 1 < ktiles) load_tile(kt + 1, 0);
  }

  // the row sums, then the output rows and unit 0's partial
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= imax) continue;  // the same across the block
    float l = lsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    const int u = q0 + ty + 16 * i;
    if (u == 0) {  // m back to natural units: the partial as the plain version has it
      float* p = partials +
                 (((int64_t)b * gridDim.y + h) * tl.parts + grp) * (Dh + 2);
      if (tx == 0) {
        p[0] = m[i] / kLog2e;
        p[1] = l;
      }
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 64 * c + e;
          if (d < Dh) p[2 + d] = acc[i][c][e];
        }
      }
    } else if (u < units) {
      const float inv = 1.f / l;
      T* o = out + b * os.b + unit_row(u, g) * os.r + h * os.h;
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = tx * 4 + 64 * c + e;
          if (d < Dh) put(o + d * os.d, acc[i][c][e] * inv);
        }
      }
    }
  }
}

// K10, second launch: output row 0 from the groups' partials, merged in
// group order. Grid (H, B), 64 threads.
template <typename T>
__global__ void __launch_bounds__(64)
    general_fwd_merge_kernel(const float* __restrict__ partials,
                             T* __restrict__ out, View os, int Dh, int parts) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* p = partials + ((int64_t)b * gridDim.x + h) * parts * (Dh + 2);
  float mx = -INFINITY;
  for (int x = 0; x < parts; ++x) mx = fmaxf(mx, p[x * (Dh + 2)]);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float l = 0.f, o = 0.f;
    for (int x = 0; x < parts; ++x) {
      const float* q = p + x * (Dh + 2);
      const float w = expf(q[0] - mx);
      l = fmaf(q[1], w, l);
      o = fmaf(q[2 + d], w, o);
    }
    put(out + b * os.b + h * os.h + d * os.d, o / l);
  }
}

template <typename T, int NC4>
int launch_fwd(const void* qkv, void* out, float* partials, const View& in,
               const View& os, const Shape& sh, const Tiles& tl,
               int shared_bytes, cudaStream_t stream) {
  constexpr int64_t kE = 16 / sizeof(T);
  const bool vec = in.d == 1 && sh.Dh % kE == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                   in.c % kE == 0 && in.b % kE == 0 && in.r % kE == 0 &&
                   in.h % kE == 0;
  auto kernel = general_fwd_kernel<T, NC4>;
  int code = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes));
  if (code != 0) return code;
  kernel<<<dim3(tl.query_tiles * tl.parts, sh.H, sh.B), kThreads,
           shared_bytes, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), partials, in, os,
      sh.Dh, tl, sh.scale * kLog2e, vec ? 1 : 0);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  general_fwd_merge_kernel<T><<<dim3(sh.H, sh.B), 64, 0, stream>>>(
      partials, static_cast<T*>(out), os, sh.Dh, tl.parts);
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

// NC4 = ceil(dp / 64) column groups a thread, by padded head dim.
template <typename Fn>
int by_columns(int dp, Fn&& fn) {
  if (dp <= 64) return fn(std::integral_constant<int, 1>());
  if (dp <= 128) return fn(std::integral_constant<int, 2>());
  if (dp <= 192) return fn(std::integral_constant<int, 3>());
  if (dp <= kMaxDh) return fn(std::integral_constant<int, 4>());
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// strides: [5] each, in elements, (component, batch, row, head, element);
// the component stride of `out` and `g` is not read.
//
// K10: two launches, the tiles then the merge of row 0; `partials` is f32
// scratch [B, H, parts, Dh + 2]. The geometry (block_q, block_k, cols,
// stages, query_tiles, parts, ld, shared_bytes) is `general_fwd_geometry`'s
// and is launched as given.
int general_attention_fwd(const void* qkv, void* out, void* partials,
                          int dtype, int B, int S, int H, int Dh, int F,
                          int time_axis, float scale,
                          const int64_t* qkv_strides,
                          const int64_t* out_strides, int block_q,
                          int block_k, int cols, int stages, int query_tiles,
                          int parts, int ld, int shared_bytes, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || F < 1 || S < 2 || (S - 1) % F ||
      block_q != kBQ || block_k != kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = (S - 1) / F;
  const int dp = (Dh + 3) / 4 * 4;
  const Shape sh{B, S, H, Dh, N, F, time_axis, scale};
  const Tiles tl{N, F, time_axis, cols, parts, query_tiles, stages, dp, ld};
  const View in = view_of(qkv_strides), os = view_of(out_strides);
  float* part = static_cast<float*>(partials);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return by_columns(dp, [&](auto c) {
      return launch_fwd<__nv_bfloat16, decltype(c)::value>(
          qkv, out, part, in, os, sh, tl, shared_bytes, st);
    });
  }
  return by_columns(dp, [&](auto c) {
    return launch_fwd<float, decltype(c)::value>(qkv, out, part, in, os, sh,
                                                 tl, shared_bytes, st);
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
