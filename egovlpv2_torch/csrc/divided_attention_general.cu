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
// keys of the query's group: 1 + N keys a space row, 1 + F a time row (the
// time tiles mask the other columns inside them), S for row 0 (split
// across the groups). Products in f32 (a bf16 input is widened exactly),
// softmax in f32, outputs stored in the input type.
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
// Both are tiled for Hopper's CUDA cores in one layout. A block owns a
// resident tile of kBQ = 64 units of one group of one (batch, head) and
// streams the group's other tiles through shared memory; grid (resident
// tiles x groups, H, B). A group is a frame on the space axis (its N patch
// rows), and on the time axis a run of `cols` patch columns over all F
// frames (F*cols <= 63 rows, so a group is one tile and the byte-bound time
// axis reads each row about once; a query attends its own column's F + 1
// keys, the tile masks the rest). Each group's list of rows is "unit 0 =
// the CLS row, unit 1 + t = its t-th row":
//   * resident tiles are loaded once by plain loads; streamed tiles of 64
//     (or 32, where 64 do not fit at a wide head dim) rows go through a
//     cp.async ring of one or two stages (16-byte cp.async.cg where the
//     head dim is contiguous and every row 16-byte aligned, 4-byte
//     cp.async.ca for other f32 views; bf16 is widened exactly into f32 by
//     plain loads). Rows are padded to an odd number of 16-byte words, so
//     the float4 reads of 8 rows hit 8 bank groups; tails are zero-filled;
//   * 256 threads as 16 x 16: thread (ty, tx) takes resident rows ty + 16i
//     (i < 4) and streamed rows tx + 16j, with float4 reads from shared
//     memory and FMAs, no shuffle inside a product (`tile_dots`); products
//     into the head dim go through a score tile in shared memory, 4 rows x
//     4 columns (of each 64) a thread (`tile_accumulate`). Tiles that end
//     part-way skip the empty 16-row quarters;
//   * the CLS row is unit 0 of each group's first tile and sees only that
//     group's rows (group 0 also the CLS row itself): each group writes an
//     f32 partial, and a last small launch merges the partials in group
//     order into row 0. No atomics: every run gives the same bits.
// The launch geometry (columns a group, parts, tiles, streamed rows,
// stages, the padded row stride, shared bytes of each pass) is computed in
// one place, `ops/_kernels.py::general_fwd_geometry` and
// `general_bwd_geometry`, and launched as given; the entry points only
// refuse tile rows they were not compiled for.
//
// K10, the forward: Q resident (times scale * log2(e)), K and V streamed;
// online softmax in log2 units; unit 0's partial is (m, l, acc[Dh]). It
// also writes each row's log-sum-exp lse [B, H, S] (f32, natural log):
// the tiles the patch rows', the merge row 0's. At Dh=64, f32, a block
// holds 105 KB of shared memory, two an SM.
//
// K11, the backward, reads K10's output and lse and does not recompute the
// forward: P = exp(S - lse), dP = G V^T, delta = g.o per row, dS = P (dP -
// delta); dq = scale dS K, dk = scale dS^T Q, dv = P^T G. Three launches:
//   * the query pass: Q and G resident (each row's delta from the stored
//     output, written to f32 scratch [B, H, S] for the key pass), K and V
//     streamed; per tile S, P, dP, dS, then dQ += dS K. Patch rows' dq is
//     stored; unit 0 writes its group's partial of dq0;
//   * the key pass: K and V resident, Q and G streamed (with their rows'
//     lse and delta; row 0's are global); per tile S^T, P^T, dP^T, dS^T,
//     then dV += P^T G and dK += dS^T Q. Patch keys are stored; key unit
//     0, the CLS key every row attends, writes its group's share of (dk0,
//     dv0);
//   * the merge: grid (H, B), sums the partials and shares in group order
//     into row 0 of dqkv.
// Seven 64 x 64 x Dh products a pair of tiles (K10 does two): two score
// products and one accumulation in the query pass, two and two (in one
// loop, `tile_accumulate2`) in the key pass. At Dh=64, f32, a query-pass
// block holds 88 KB and a key-pass block 108.5 KB of shared memory: one
// stage each, two blocks an SM (two stages would leave one). The tensor cores are not used: the f32 path runs with TF32 off and
// is held to 1e-4, which would need three TF32 products a product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDh = 256;
constexpr int kBQ = 64;  // resident units a block
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 256 && kBQ == 64,
              "256 threads lie as 16 x 16 over 64-row resident tiles");

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

// The geometry of one launch, from `general_fwd_geometry` or
// `general_bwd_geometry`.
struct Tiles {
  int N, F, time_axis;
  int cols;    // patch columns a time group (N on the space axis)
  int parts;   // groups: the grid's groups and the partials' parts
  int tiles;   // 64-unit resident tiles a group
  int stages;  // streamed-tile ring stages, 1 or 2
  int dp;      // head dim padded to a multiple of 4
  int ld;      // row stride in floats: an odd number of float4s
};

// The rows of one group: unit 0 is the CLS row, unit 1 + t its t-th row,
// t < count, in frame-major order: row 1 + (t / nc) * N + c0 + t % nc.
struct Geo {
  int c0, nc, N;
};

__device__ __forceinline__ Geo group_geo(const Tiles& tl, int grp) {
  Geo g;
  g.N = tl.N;
  g.c0 = grp * tl.cols;
  g.nc = tl.time_axis ? min(tl.cols, tl.N - g.c0) : tl.N;
  return g;
}

__device__ __forceinline__ int group_units(const Tiles& tl, const Geo& g) {
  return 1 + (tl.time_axis ? tl.F * g.nc : tl.N);
}

__device__ __forceinline__ int64_t unit_row(int u, const Geo& g) {
  if (u == 0) return 0;
  const int t = u - 1;
  return 1 + (int64_t)(t / g.nc) * g.N + g.c0 + t % g.nc;
}

// A unit's patch column inside its group (-1 for the CLS row).
__device__ __forceinline__ int unit_col(int u, const Geo& g) {
  return u >= 1 ? (u - 1) % g.nc : -1;
}

// Whether query unit u (column qc) attends key unit w (column kc) of group
// grp: row 0 every key of the group, the CLS key in group 0 only (so once);
// a patch row the CLS key and, on the time axis, its own column's rows.
__device__ __forceinline__ bool attends(int u, int w, int units, int grp,
                                        bool time_axis, int qc, int kc) {
  if (w >= units) return false;
  if (u == 0) return w > 0 || grp == 0;
  return !time_axis || w == 0 || qc == kc;
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

// Units u0 .. u0 + rows - 1 of a group, from `src` (q, k, v of one (batch,
// head), or the cotangent), into dst [rows][ld] in f32 times `mul`; units
// from `valid` on and columns from Dh on are zero. kAsync: by cp.async
// (f32 and mul 1 only; the caller commits and waits); else plain loads,
// visible after the caller's __syncthreads.
template <typename T, bool kAsync>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           const View& in, int Dh,
                                           const Tiles& tl, int rows, int u0,
                                           int valid, const Geo& g, float mul,
                                           bool vec) {
  if (vec) {  // the head dim contiguous, every row 16-byte aligned
    constexpr int kE = 16 / sizeof(T);
    const int per_row = tl.dp / kE;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
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
    for (int i = threadIdx.x; i < rows * tl.dp; i += kThreads) {
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

// s[i][j] = sum over d < dp of A[ty + 16i][d] * B[tx + 16j][d]: a 64-row
// resident tile A against a streamed tile B of 16 * JT rows, both [.][ld].
// Only i < imax and j < jmax unless kFull.
template <int JT, bool kFull>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          int ld, int dp, int imax, int jmax,
                                          float (&s)[4][JT]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < JT; ++j) s[i][j] = 0.f;
  }
  for (int d = 0; d < dp; d += 4) {
    float4 a[4], k[JT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kFull || i < imax)
        a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      if (kFull || j < jmax)
        k[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < JT; ++j) {
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
}

// acc[i][c][e] += sum over w < wend of X[ty + 16i][w] * Y[w][4tx + 64c + e]:
// a score tile X [64][xld] (0 past the last live column) times a streamed
// tile Y [.][ld], into 4 rows x 4 columns of each 64 a thread. Only i <
// imax unless kFull.
template <int NC4, bool kFull>
__device__ __forceinline__ void tile_accumulate(const float* X, int xld,
                                                const float* Y, int ld,
                                                int wend, int imax,
                                                const bool (&col_on)[NC4],
                                                float (&acc)[4][NC4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int w = 0; w < wend; w += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kFull || i < imax)
        p[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * xld + w);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        if (!col_on[c]) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            Y + (w + kk) * ld + tx * 4 + 64 * c);
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
}

// tile_accumulate of two products in one loop: a1 += X1 Y1 and a2 += X2
// Y2, X1 and X2 [64][xld]: the key pass's dV and dK. On the H100 one loop
// ran faster than two calls of tile_accumulate, and a form generic in the
// number of products spilled registers.
template <int NC4, bool kFull>
__device__ __forceinline__ void tile_accumulate2(
    const float* X1, const float* X2, int xld, const float* Y1,
    const float* Y2, int ld, int wend, int imax, const bool (&col_on)[NC4],
    float (&a1)[4][NC4][4], float (&a2)[4][NC4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int w = 0; w < wend; w += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kFull || i < imax) {
        p[i] = *reinterpret_cast<const float4*>(X1 + (ty + 16 * i) * xld + w);
        q[i] = *reinterpret_cast<const float4*>(X2 + (ty + 16 * i) * xld + w);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        if (!col_on[c]) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            Y1 + (w + kk) * ld + tx * 4 + 64 * c);
        const float4 u = *reinterpret_cast<const float4*>(
            Y2 + (w + kk) * ld + tx * 4 + 64 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kFull || i < imax) {
            const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y
                             : kk == 2 ? p[i].z : p[i].w;
            const float qk = kk == 0 ? q[i].x : kk == 1 ? q[i].y
                             : kk == 2 ? q[i].z : q[i].w;
            a1[i][c][0] = fmaf(pk, v.x, a1[i][c][0]);
            a1[i][c][1] = fmaf(pk, v.y, a1[i][c][1]);
            a1[i][c][2] = fmaf(pk, v.z, a1[i][c][2]);
            a1[i][c][3] = fmaf(pk, v.w, a1[i][c][3]);
            a2[i][c][0] = fmaf(qk, u.x, a2[i][c][0]);
            a2[i][c][1] = fmaf(qk, u.y, a2[i][c][1]);
            a2[i][c][2] = fmaf(qk, u.z, a2[i][c][2]);
            a2[i][c][3] = fmaf(qk, u.w, a2[i][c][3]);
          }
        }
      }
    }
  }
}

template <int NC4>
__device__ __forceinline__ void zero_acc(float (&acc)[4][NC4][4],
                                         bool (&col_on)[NC4], int dp) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < NC4; ++c) col_on[c] = tx * 4 + 64 * c < dp;
}

// Row `acc` (4 columns of each 64 a thread) times `mul` to p[d * sd], d < Dh.
template <typename T, int NC4>
__device__ __forceinline__ void store_cols(T* p, int64_t sd, int Dh,
                                           const float (&acc)[NC4][4],
                                           float mul) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int c = 0; c < NC4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = tx * 4 + 64 * c + e;
      if (d < Dh) put(p + d * sd, acc[c][e] * mul);
    }
  }
}

// The streamed tiles of a group through the ring: `load(t, stage)` issues
// tile t's copies and commits them, `body(t, stage)` uses it between the
// barriers. Tile 0 must have been issued.
template <typename Load, typename Body>
__device__ __forceinline__ void stream_tiles(int ntiles, int stages,
                                             Load&& load, Body&& body) {
  for (int t = 0; t < ntiles; ++t) {
    if (stages == 2 && t + 1 < ntiles) {
      load(t + 1, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and, at t = 0, the resident tiles)
    body(t, stages == 2 ? (t & 1) : 0);
    __syncthreads();  // done with this stage and the score tile
    if (stages == 1 && t + 1 < ntiles) load(t + 1, 0);
  }
}

// ---------------- K10: the forward ----------------

constexpr int kBK = 64;         // K10's key rows a streamed tile
constexpr int kPLd = kBK + 16;  // P row stride: two rows 16 banks apart

// K10, first launch. Grid (tiles * parts, H, B), kThreads threads, dynamic
// shared memory Q [64][ld], K and V [stages][64][ld], P [64][kPLd]. NC4:
// column groups of 4 of each 64 head-dim columns a thread keeps, ceil(dp /
// 64).
template <typename T, int NC4>
__global__ void __launch_bounds__(kThreads, NC4 <= 2 ? 2 : 1)
    general_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                       float* __restrict__ lse, float* __restrict__ partials,
                       View in, View os, int Dh, Tiles tl, float qmul,
                       int vec) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * tl.ld;
  float* Vs = Ks + tl.stages * kBK * tl.ld;
  float* Ps = Vs + tl.stages * kBK * tl.ld;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x % tl.tiles;
  const int grp = blockIdx.x / tl.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const Geo g = group_geo(tl, grp);
  const int units = group_units(tl, g);
  const int q0 = qt * kBQ;
  if (q0 >= units) return;  // the whole block, before any barrier
  const int nq = min(kBQ, units - q0);
  const int imax = (nq + 15) >> 4;  // 16-row quarters that hold a unit
  const bool time_axis = tl.time_axis != 0;
  const T* base = qkv + b * in.b + h * in.h;
  const T* kb = base + in.c;
  const T* vb = base + 2 * in.c;
  const int ktiles = (units + kBK - 1) / kBK;

  stage_tile<T, false>(Qs, base, in, Dh, tl, kBQ, q0, nq, g, qmul, vec != 0);
  auto load_tile = [&](int kt, int st) {
    const int valid = min(kBK, units - kt * kBK);
    stage_tile<T, true>(Ks + st * kBK * tl.ld, kb, in, Dh, tl, kBK, kt * kBK,
                        valid, g, 1.f, vec != 0);
    stage_tile<T, true>(Vs + st * kBK * tl.ld, vb, in, Dh, tl, kBK, kt * kBK,
                        valid, g, 1.f, vec != 0);
    cp_async_commit();
  };
  load_tile(0, 0);

  float m[4], lsum[4], acc[4][NC4][4];
  bool col_on[NC4];
  int qcol[4];
  zero_acc<NC4>(acc, col_on, tl.dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
    qcol[i] = unit_col(q0 + ty + 16 * i, g);
  }

  // One K/V tile; kFull: all 64 units of the query tile and of the key
  // tile hold a row, else the empty 16-row quarters are skipped.
  auto tile = [&](auto full_t, const float* K, const float* V, int w0,
                  int jmax) {
    constexpr bool kFull = decltype(full_t)::value;
    float s[4][4];
    tile_dots<4, kFull>(Qs, K, tl.ld, tl.dp, imax, jmax, s);
    // mask, online softmax (log2 units), P to shared memory
    int kcol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) kcol[j] = unit_col(w0 + tx + 16 * j, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && i >= imax) continue;  // the same across the block
      const int u = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = (kFull || j < jmax) &&
                          attends(u, w0 + tx + 16 * j, units, grp, time_axis,
                                  qcol[i], kcol[j]);
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
    tile_accumulate<NC4, kFull>(Ps, kPLd, V, tl.ld, kFull ? kBK : 16 * jmax,
                                imax, col_on, acc);
  };

  stream_tiles(ktiles, tl.stages, load_tile, [&](int kt, int st) {
    const float* K = Ks + st * kBK * tl.ld;
    const float* V = Vs + st * kBK * tl.ld;
    const int nk = min(kBK, units - kt * kBK);
    const int jmax = (nk + 15) >> 4;
    if (nq == kBQ && nk == kBK) {
      tile(std::true_type(), K, V, kt * kBK, jmax);
    } else {
      tile(std::false_type(), K, V, kt * kBK, jmax);
    }
  });

  // the row sums, then the output rows and their lse, and unit 0's partial
  const int64_t bh = (int64_t)b * gridDim.y + h;
  const int S = 1 + tl.F * tl.N;
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
      float* p = partials + (bh * tl.parts + grp) * (Dh + 2);
      if (tx == 0) {
        p[0] = m[i] / kLog2e;
        p[1] = l;
      }
      store_cols<float, NC4>(p + 2, 1, Dh, acc[i], 1.f);
    } else if (u < units) {
      const int64_t row = unit_row(u, g);
      if (tx == 0) lse[bh * S + row] = (m[i] + log2f(l)) / kLog2e;
      store_cols<T, NC4>(out + b * os.b + row * os.r + h * os.h, os.d, Dh,
                         acc[i], 1.f / l);
    }
  }
}

// K10, second launch: output row 0 and its lse from the groups' partials,
// merged in group order. Grid (H, B), 64 threads.
template <typename T>
__global__ void __launch_bounds__(64)
    general_fwd_merge_kernel(const float* __restrict__ partials,
                             T* __restrict__ out, float* __restrict__ lse,
                             View os, int S, int Dh, int parts) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = (int64_t)b * gridDim.x + h;
  const float* p = partials + bh * parts * (Dh + 2);
  float mx = -INFINITY;
  for (int x = 0; x < parts; ++x) mx = fmaxf(mx, p[x * (Dh + 2)]);
  float l = 0.f;
  for (int x = 0; x < parts; ++x) {
    const float* q = p + x * (Dh + 2);
    l = fmaf(q[1], expf(q[0] - mx), l);
  }
  if (threadIdx.x == 0) lse[bh * S] = mx + logf(l);
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float o = 0.f;
    for (int x = 0; x < parts; ++x) {
      const float* q = p + x * (Dh + 2);
      o = fmaf(q[2 + d], expf(q[0] - mx), o);
    }
    put(out + b * os.b + h * os.h + d * os.d, o / l);
  }
}

// ---------------- K11: the backward ----------------

// K11, first launch: the query pass. Grid (tiles * parts, H, B), kThreads
// threads, dynamic shared memory Q and G [64][ld], K and V [stages][16
// JT][ld], dS [64][16 JT + 16]. Writes dq of the patch rows, each row's
// delta to `delta` [B, H, S] (row 0's from group 0), and unit 0's partial
// of dq0 / scale to slot 0 of `cls` [B, H, parts, 3, Dh].
template <typename T, int NC4, int JT>
__global__ void __launch_bounds__(kThreads, NC4 <= 2 ? 2 : 1)
    general_bwd_query_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ out,
                             const float* __restrict__ lse,
                             const T* __restrict__ g, T* __restrict__ dqkv,
                             float* __restrict__ delta,
                             float* __restrict__ cls, View in, View os,
                             View gs, View ds, int Dh, Tiles tl, float qmul,
                             float scale, int vec_in, int vec_g) {
  constexpr int kRows = 16 * JT;   // key units a streamed tile
  constexpr int kSLd = kRows + 16;  // dS row stride: two rows 16 banks apart
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBQ * tl.ld;
  float* Ks = Gs + kBQ * tl.ld;
  float* Vs = Ks + tl.stages * kRows * tl.ld;
  float* DSs = Vs + tl.stages * kRows * tl.ld;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = blockIdx.x % tl.tiles;
  const int grp = blockIdx.x / tl.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const Geo geo = group_geo(tl, grp);
  const int units = group_units(tl, geo);
  const int q0 = qt * kBQ;
  if (q0 >= units) return;  // the whole block, before any barrier
  const int nq = min(kBQ, units - q0);
  const int imax = (nq + 15) >> 4;
  const bool time_axis = tl.time_axis != 0;
  const int S = 1 + tl.F * tl.N;
  const int64_t bh = (int64_t)b * gridDim.y + h;
  const T* base = qkv + b * in.b + h * in.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const int ktiles = (units + kRows - 1) / kRows;

  stage_tile<T, false>(Qs, base, in, Dh, tl, kBQ, q0, nq, geo, qmul,
                       vec_in != 0);
  stage_tile<T, false>(Gs, gb, gs, Dh, tl, kBQ, q0, nq, geo, 1.f,
                       vec_g != 0);
  auto load_tile = [&](int kt, int st) {
    const int valid = min(kRows, units - kt * kRows);
    stage_tile<T, true>(Ks + st * kRows * tl.ld, base + in.c, in, Dh, tl,
                        kRows, kt * kRows, valid, geo, 1.f, vec_in != 0);
    stage_tile<T, true>(Vs + st * kRows * tl.ld, base + 2 * in.c, in, Dh, tl,
                        kRows, kt * kRows, valid, geo, 1.f, vec_in != 0);
    cp_async_commit();
  };
  load_tile(0, 0);
  __syncthreads();  // Q and G

  // each row's lse (log2 units) and delta = g.o, from the stored output
  float lse2[4], dlt[4];
  int qcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = q0 + ty + 16 * i;
    qcol[i] = unit_col(u, geo);
    lse2[i] = dlt[i] = 0.f;
    if (i >= imax) continue;  // the same across the block
    float part = 0.f;
    const int64_t row = u < units ? unit_row(u, geo) : 0;
    if (u < units) {
      lse2[i] = lse[bh * S + row] * kLog2e;
      const T* o = out + b * os.b + row * os.r + h * os.h;
      for (int d = tx; d < Dh; d += 16) {
        part = fmaf(Gs[(ty + 16 * i) * tl.ld + d], widen(o[d * os.d]), part);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    dlt[i] = part;
    if (tx == 0 && u < units && (u > 0 || grp == 0)) delta[bh * S + row] = part;
  }

  float acc[4][NC4][4];
  bool col_on[NC4];
  zero_acc<NC4>(acc, col_on, tl.dp);

  auto tile = [&](auto full_t, const float* K, const float* V, int w0,
                  int jmax) {
    constexpr bool kFull = decltype(full_t)::value;
    float s[4][JT], dp[4][JT];
    tile_dots<JT, kFull>(Qs, K, tl.ld, tl.dp, imax, jmax, s);
    tile_dots<JT, kFull>(Gs, V, tl.ld, tl.dp, imax, jmax, dp);
    int kcol[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) kcol[j] = unit_col(w0 + tx + 16 * j, geo);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && i >= imax) continue;  // the same across the block
      const int u = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (kFull || j < jmax) {
          const bool live = u < units &&
                            attends(u, w0 + tx + 16 * j, units, grp,
                                    time_axis, qcol[i], kcol[j]);
          const float p = live ? exp2f(s[i][j] - lse2[i]) : 0.f;
          DSs[(ty + 16 * i) * kSLd + tx + 16 * j] = p * (dp[i][j] - dlt[i]);
        }
      }
    }
    __syncthreads();
    // dQ += dS.K over the tile's keys (dS is 0 past the last live key)
    tile_accumulate<NC4, kFull>(DSs, kSLd, K, tl.ld,
                                kFull ? kRows : 16 * jmax, imax, col_on, acc);
  };

  stream_tiles(ktiles, tl.stages, load_tile, [&](int kt, int st) {
    const float* K = Ks + st * kRows * tl.ld;
    const float* V = Vs + st * kRows * tl.ld;
    const int nk = min(kRows, units - kt * kRows);
    const int jmax = (nk + 15) >> 4;
    if (nq == kBQ && nk == kRows) {
      tile(std::true_type(), K, V, kt * kRows, jmax);
    } else {
      tile(std::false_type(), K, V, kt * kRows, jmax);
    }
  });

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= imax) continue;
    const int u = q0 + ty + 16 * i;
    if (u == 0) {
      store_cols<float, NC4>(cls + (bh * tl.parts + grp) * 3 * Dh, 1, Dh,
                             acc[i], 1.f);
    } else if (u < units) {
      store_cols<T, NC4>(dqkv + b * ds.b + unit_row(u, geo) * ds.r + h * ds.h,
                         ds.d, Dh, acc[i], scale);
    }
  }
}

// K11, second launch: the key pass. Grid (tiles * parts, H, B), kThreads
// threads, dynamic shared memory K and V [64][ld], Q and G [stages][16
// JT][ld], P^T and dS^T [64][16 JT + 16], and the streamed rows' lse and
// delta [stages][16 JT] each (copied with their tile, off the products'
// path). Writes dk and dv of the patch keys, and key unit 0's share of
// dk0 / scale and dv0 to slots 1 and 2 of `cls`.
template <typename T, int NC4, int JT>
__global__ void __launch_bounds__(kThreads, NC4 == 1 ? 2 : 1)
    general_bwd_key_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const T* __restrict__ g, T* __restrict__ dqkv,
                           float* __restrict__ cls, View in, View gs, View ds,
                           int Dh, Tiles tl, float qmul, float scale,
                           int vec_in, int vec_g) {
  constexpr int kRows = 16 * JT;    // query units a streamed tile
  constexpr int kSLd = kRows + 16;  // score row stride
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBQ * tl.ld;
  float* Qs = Vs + kBQ * tl.ld;
  float* Gs = Qs + tl.stages * kRows * tl.ld;
  float* PTs = Gs + tl.stages * kRows * tl.ld;
  float* DSTs = PTs + kBQ * kSLd;
  float* Ls = DSTs + kBQ * kSLd;
  float* Dls = Ls + tl.stages * kRows;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x % tl.tiles;
  const int grp = blockIdx.x / tl.tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const Geo geo = group_geo(tl, grp);
  const int units = group_units(tl, geo);
  const int k0 = kt * kBQ;
  if (k0 >= units) return;  // the whole block, before any barrier
  const int nk = min(kBQ, units - k0);
  const int imax = (nk + 15) >> 4;
  const bool time_axis = tl.time_axis != 0;
  const int S = 1 + tl.F * tl.N;
  const int64_t bh = (int64_t)b * gridDim.y + h;
  const T* base = qkv + b * in.b + h * in.h;
  const T* gb = g + b * gs.b + h * gs.h;
  const int qtiles = (units + kRows - 1) / kRows;

  stage_tile<T, false>(Ks, base + in.c, in, Dh, tl, kBQ, k0, nk, geo, qmul,
                       vec_in != 0);
  stage_tile<T, false>(Vs, base + 2 * in.c, in, Dh, tl, kBQ, k0, nk, geo,
                       1.f, vec_in != 0);
  auto load_tile = [&](int qt, int st) {
    const int valid = min(kRows, units - qt * kRows);
    stage_tile<T, true>(Qs + st * kRows * tl.ld, base, in, Dh, tl, kRows,
                        qt * kRows, valid, geo, 1.f, vec_in != 0);
    stage_tile<T, true>(Gs + st * kRows * tl.ld, gb, gs, Dh, tl, kRows,
                        qt * kRows, valid, geo, 1.f, vec_g != 0);
    if (tid < kRows) {  // unit 0's: row 0's, global
      const bool live = tid < valid;
      const int64_t at = bh * S + (live ? unit_row(qt * kRows + tid, geo) : 0);
      cp_async4(Ls + st * kRows + tid, lse + at, live ? 4 : 0);
      cp_async4(Dls + st * kRows + tid, delta + at, live ? 4 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  float dk[4][NC4][4], dv[4][NC4][4];
  bool col_on[NC4];
  zero_acc<NC4>(dk, col_on, tl.dp);
  zero_acc<NC4>(dv, col_on, tl.dp);
  int kcol[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kcol[i] = unit_col(k0 + ty + 16 * i, geo);

  auto tile = [&](auto full_t, const float* Q, const float* G, const float* L,
                  const float* D, int u0, int jmax) {
    constexpr bool kFull = decltype(full_t)::value;
    int qcol[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) qcol[j] = unit_col(u0 + tx + 16 * j, geo);
    float s[4][JT], dp[4][JT];
    tile_dots<JT, kFull>(Ks, Q, tl.ld, tl.dp, imax, jmax, s);
    tile_dots<JT, kFull>(Vs, G, tl.ld, tl.dp, imax, jmax, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!kFull && i >= imax) continue;  // the same across the block
      const int w = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (kFull || j < jmax) {
          const int u = u0 + tx + 16 * j;
          const bool live = u < units && attends(u, w, units, grp, time_axis,
                                                 qcol[j], kcol[i]);
          // lse in log2 units; 0 past the last streamed row
          const float p = live
              ? exp2f(s[i][j] - L[tx + 16 * j] * kLog2e) : 0.f;
          PTs[(ty + 16 * i) * kSLd + tx + 16 * j] = p;
          DSTs[(ty + 16 * i) * kSLd + tx + 16 * j] =
              p * (dp[i][j] - D[tx + 16 * j]);
        }
      }
    }
    __syncthreads();
    // dV += P^T.G and dK += dS^T.Q over the tile's queries
    tile_accumulate2<NC4, kFull>(PTs, DSTs, kSLd, G, Q, tl.ld,
                                 kFull ? kRows : 16 * jmax, imax, col_on, dv,
                                 dk);
  };

  stream_tiles(qtiles, tl.stages, load_tile, [&](int qt, int st) {
    const float* Q = Qs + st * kRows * tl.ld;
    const float* G = Gs + st * kRows * tl.ld;
    const float* L = Ls + st * kRows;
    const float* D = Dls + st * kRows;
    const int nq = min(kRows, units - qt * kRows);
    const int jmax = (nq + 15) >> 4;
    if (nk == kBQ && nq == kRows) {
      tile(std::true_type(), Q, G, L, D, qt * kRows, jmax);
    } else {
      tile(std::false_type(), Q, G, L, D, qt * kRows, jmax);
    }
  });

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= imax) continue;
    const int w = k0 + ty + 16 * i;
    if (w == 0) {
      float* p = cls + (bh * tl.parts + grp) * 3 * Dh;
      store_cols<float, NC4>(p + Dh, 1, Dh, dk[i], 1.f);
      store_cols<float, NC4>(p + 2 * Dh, 1, Dh, dv[i], 1.f);
    } else if (w < units) {
      T* o = dqkv + b * ds.b + unit_row(w, geo) * ds.r + h * ds.h;
      store_cols<T, NC4>(o + ds.c, ds.d, Dh, dk[i], scale);
      store_cols<T, NC4>(o + 2 * ds.c, ds.d, Dh, dv[i], 1.f);
    }
  }
}

// K11, third launch: row 0 of dq, dk and dv from the groups' partials
// [B, H, parts, 3, Dh], summed in group order; dq and dk times scale. Grid
// (H, B), 64 threads.
template <typename T>
__global__ void __launch_bounds__(64)
    general_bwd_merge_kernel(const float* __restrict__ cls,
                             T* __restrict__ dqkv, View ds, int Dh, int parts,
                             float scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* p = cls + ((int64_t)b * gridDim.x + h) * parts * 3 * Dh;
  T* row0 = dqkv + b * ds.b + h * ds.h;
  for (int i = threadIdx.x; i < 3 * Dh; i += blockDim.x) {
    float sum = 0.f;
    for (int x = 0; x < parts; ++x) sum += p[x * 3 * Dh + i];
    const int which = i / Dh, d = i - which * Dh;
    put(row0 + which * ds.c + d * ds.d, which == 2 ? sum : sum * scale);
  }
}

// ---------------- launches ----------------

struct Shape {
  int B, S, H, Dh;
  float scale;
};

// Whether the 16-byte staging route reads `p` by view `v`: the head dim
// contiguous and every row 16-byte aligned.
template <typename T>
bool vec_route(const void* p, const View& v, int Dh) {
  constexpr int64_t kE = 16 / sizeof(T);
  return v.d == 1 && Dh % kE == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0
         && v.c % kE == 0 && v.b % kE == 0 && v.r % kE == 0 && v.h % kE == 0;
}

template <typename K>
int opt_in(K kernel, int shared_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes));
}

template <typename T, int NC4>
int launch_fwd(const void* qkv, void* out, float* lse, float* partials,
               const View& in, const View& os, const Shape& sh,
               const Tiles& tl, int shared_bytes, cudaStream_t stream) {
  auto kernel = general_fwd_kernel<T, NC4>;
  int code = opt_in(kernel, shared_bytes);
  if (code != 0) return code;
  kernel<<<dim3(tl.tiles * tl.parts, sh.H, sh.B), kThreads, shared_bytes,
           stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), lse,
                     partials, in, os, sh.Dh, tl, sh.scale * kLog2e,
                     vec_route<T>(qkv, in, sh.Dh) ? 1 : 0);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  general_fwd_merge_kernel<T><<<dim3(sh.H, sh.B), 64, 0, stream>>>(
      partials, static_cast<T*>(out), lse, os, sh.S, sh.Dh, tl.parts);
  return static_cast<int>(cudaGetLastError());
}

// JT = rows / 16 for a streamed tile of `rows` rows: 64, or 32 at the head
// dims (NC4 >= 3) where 64 do not fit.
template <int NC4, typename Fn>
int by_stream_rows(int rows, Fn&& fn) {
  if (rows == 64) return fn(std::integral_constant<int, 4>());
  if constexpr (NC4 >= 3) {
    if (rows == 32) return fn(std::integral_constant<int, 2>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

struct BwdArgs {
  const void *qkv, *out, *g;
  const float* lse;
  void* dqkv;
  float *delta, *cls;
  View in, os, gs, ds;
};

template <typename T, int NC4>
int launch_bwd(const BwdArgs& a, const Shape& sh, const Tiles& query,
               int query_rows, int query_shared, const Tiles& key,
               int key_rows, int key_shared, cudaStream_t stream) {
  const int vin = vec_route<T>(a.qkv, a.in, sh.Dh) ? 1 : 0;
  const int vg = vec_route<T>(a.g, a.gs, sh.Dh) ? 1 : 0;
  const float qmul = sh.scale * kLog2e;
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* g = static_cast<const T*>(a.g);
  T* dqkv = static_cast<T*>(a.dqkv);
  int code = by_stream_rows<NC4>(query_rows, [&](auto jt) {
    auto kernel = general_bwd_query_kernel<T, NC4, decltype(jt)::value>;
    int c = opt_in(kernel, query_shared);
    if (c != 0) return c;
    kernel<<<dim3(query.tiles * query.parts, sh.H, sh.B), kThreads,
             query_shared, stream>>>(
        qkv, static_cast<const T*>(a.out), a.lse, g, dqkv, a.delta, a.cls,
        a.in, a.os, a.gs, a.ds, sh.Dh, query, qmul, sh.scale, vin, vg);
    return static_cast<int>(cudaGetLastError());
  });
  if (code != 0) return code;
  code = by_stream_rows<NC4>(key_rows, [&](auto jt) {
    auto kernel = general_bwd_key_kernel<T, NC4, decltype(jt)::value>;
    int c = opt_in(kernel, key_shared);
    if (c != 0) return c;
    kernel<<<dim3(key.tiles * key.parts, sh.H, sh.B), kThreads, key_shared,
             stream>>>(qkv, a.lse, a.delta, g, dqkv, a.cls, a.in, a.gs, a.ds,
                       sh.Dh, key, qmul, sh.scale, vin, vg);
    return static_cast<int>(cudaGetLastError());
  });
  if (code != 0) return code;
  general_bwd_merge_kernel<T><<<dim3(sh.H, sh.B), 64, 0, stream>>>(
      a.cls, dqkv, a.ds, sh.Dh, query.parts, sh.scale);
  return static_cast<int>(cudaGetLastError());
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

bool shape_ok(int Dh, int F, int S) {
  return Dh >= 1 && Dh <= kMaxDh && F >= 1 && S >= 2 && (S - 1) % F == 0;
}

}  // namespace

extern "C" {

// strides: [5] each, in elements, (component, batch, row, head, element);
// the component stride of `out` and `g` is not read. `lse` is f32 [B, H,
// S], contiguous.
//
// K10: two launches, the tiles then the merge of row 0; `partials` is f32
// scratch [B, H, parts, Dh + 2]. The geometry (block_q, block_k, cols,
// stages, query_tiles, parts, ld, shared_bytes) is `general_fwd_geometry`'s
// and is launched as given.
int general_attention_fwd(const void* qkv, void* out, void* lse,
                          void* partials, int dtype, int B, int S, int H,
                          int Dh, int F, int time_axis, float scale,
                          const int64_t* qkv_strides,
                          const int64_t* out_strides, int block_q,
                          int block_k, int cols, int stages, int query_tiles,
                          int parts, int ld, int shared_bytes, void* stream) {
  if (!shape_ok(Dh, F, S) || block_q != kBQ || block_k != kBK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = (S - 1) / F;
  const int dp = (Dh + 3) / 4 * 4;
  const Shape sh{B, S, H, Dh, scale};
  const Tiles tl{N, F, time_axis, cols, parts, query_tiles, stages, dp, ld};
  const View in = view_of(qkv_strides), os = view_of(out_strides);
  float* l = static_cast<float*>(lse);
  float* part = static_cast<float*>(partials);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_columns(dp, [&](auto c) {
    constexpr int kNC4 = decltype(c)::value;
    return dtype == 1
               ? launch_fwd<__nv_bfloat16, kNC4>(qkv, out, l, part, in, os,
                                                  sh, tl, shared_bytes, st)
               : launch_fwd<float, kNC4>(qkv, out, l, part, in, os, sh, tl,
                                         shared_bytes, st);
  });
}

// K11: three launches, the query pass, the key pass and the merge of row
// 0. Reads K10's `out` and `lse`; `delta` is f32 scratch [B, H, S] and
// `cls` f32 scratch [B, H, parts, 3, Dh]. The geometry (block_q, cols,
// tiles, parts, ld, and of each pass the streamed rows, stages and shared
// bytes) is `general_bwd_geometry`'s and is launched as given.
int general_attention_bwd(const void* qkv, const void* out, const void* lse,
                          const void* g, void* dqkv, void* delta, void* cls,
                          int dtype, int B, int S, int H, int Dh, int F,
                          int time_axis, float scale,
                          const int64_t* qkv_strides,
                          const int64_t* out_strides,
                          const int64_t* g_strides,
                          const int64_t* dqkv_strides, int block_q, int cols,
                          int tiles, int parts, int ld, int query_rows,
                          int query_stages, int query_shared, int key_rows,
                          int key_stages, int key_shared, void* stream) {
  if (!shape_ok(Dh, F, S) || block_q != kBQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int N = (S - 1) / F;
  const int dp = (Dh + 3) / 4 * 4;
  const Shape sh{B, S, H, Dh, scale};
  const Tiles query{N, F, time_axis, cols, parts, tiles, query_stages, dp, ld};
  const Tiles key{N, F, time_axis, cols, parts, tiles, key_stages, dp, ld};
  const BwdArgs a{qkv, out, g, static_cast<const float*>(lse), dqkv,
                  static_cast<float*>(delta), static_cast<float*>(cls),
                  view_of(qkv_strides), view_of(out_strides),
                  view_of(g_strides), view_of(dqkv_strides)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_columns(dp, [&](auto c) {
    constexpr int kNC4 = decltype(c)::value;
    return dtype == 1
               ? launch_bwd<__nv_bfloat16, kNC4>(a, sh, query, query_rows,
                                                  query_shared, key, key_rows,
                                                  key_shared, st)
               : launch_bwd<float, kNC4>(a, sh, query, query_rows,
                                         query_shared, key, key_rows,
                                         key_shared, st);
  });
}

}  // extern "C"
