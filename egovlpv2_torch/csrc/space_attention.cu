// K1 and K4 in their frame form: the bf16 forward and backward of divided
// SPACE attention for the patch rows (rows 1..S-1), a block one frame of one
// (b, h), for a frame of at most kMaxKeyTiles * 16 keys (the CLS key and N
// <= 207 patches; every path has N = 196). Layout and semantics are those of
// divided_attention.cu, which keeps K1's grouped CUDA-core form
// (space_fwd_kernel) for f32, the other head dims and larger frames, as
// divided_attention_bwd.cu keeps K4's (its grouped query and key passes).
// `space_fwd_geometry` and `space_bwd_geometry` (ops/_kernels.py) name the
// form, and each entry point refuses a geometry that is not its own.
//
// Replaces the space frame-block branches of the packed TPU kernels:
// `_space_fb_fwd` (egovlpv2_tpu/ops/divided.py:512) in `_packed_fwd_kernel`
// (:771-788) and `_space_fb_bwd` (:623) in `_packed_bwd_kernel` (:871).
//
// Bound. The forward reads q, k and v and writes the output once, 4 S H Dh
// elements (0.115 ms at B=20, S=3137 on an H100), against 4 Dh operations a
// (query, key) pair, 197 pairs a row: 42 GFLOP at that shape, 0.04 ms at the
// tensor cores' peak, so bytes bound the function; the backward moves 7 S H
// Dh elements for 10 Dh operations a pair (0.161 ms of bytes at B=8, S=6273,
// 0.12 ms of operations). The forms they replace held 64 query rows a block,
// so a frame's 196 rows took 4 blocks that each staged the frame's keys again
// in chunks of 64, synchronously, with scalar transposes of V; the backward
// was two launches that computed Q K^T and dO V^T three times and passed
// each row's log-sum-exp and delta through device memory.
//
// Design: a block owns a frame of one (b, h); the heads are the grid's
// fastest axis, so blocks that run side by side read neighbouring bytes of
// the same sequence rows. The frame's rows are staged once into dynamic
// shared memory by 16-byte cp.async (zero-filled past the frame), key row 0
// the CLS key; every shared fragment comes through ldmatrix (trans for the
// operands that contract over rows) at per-lane offsets computed once; all
// products are mma.sync m16n8k16, bf16 in, f32 accumulate, and exponentials
// ex2.approx. Warps take 16-row tiles in turn.
//   K1 (4 warps, three blocks an SM at Dh = 64): K and V (the frame's N + 1
//   keys) at a pitch of Dh + 8, K in a first cp.async group and V in a
//   second, so the first tiles' Q K^T runs while V is in flight. A warp
//   takes two query tiles at once (Q fragments read from device memory), so
//   every K and V fragment serves 32 rows, and their keys two 16-key tiles
//   at a time with an online softmax in f32 (the CLS key is live in every
//   row, so the first step's max is finite); the numerator rounded to bf16
//   as the A operand of P V, the output divided by the f32 sum and stored.
//   K4 (6 warps, two blocks an SM): Q, K, V and dO (the
//   cotangent) of the frame, 16-byte chunks XOR swizzled without padding
//   (106 KB at Dh = 64; Dh = 48 padded), K and Q in a first group, V and dO
//   in a second.
//     Phase A, query tiles: S = Q K^T over all keys in registers, its exact
//     log-sum-exp and P = softmax(S), kept in f32; dP = dO V^T in f32 a key
//     tile at a time, twice (no room for it beside P): first delta = sum P
//     dP, then dS = P (dP - delta), rounded to bf16 as the A operand of dQ =
//     scale dS K, stored. Each row's log-sum-exp and delta stay in shared
//     memory. P, dP, delta and dS are the TPU kernel's, in f32; it rounds
//     only P before dV and dS before dQ and dK.
//     Phase B, key tiles: S^T = K Q^T and dP^T = V dO^T again, 16 queries a
//     step, P from the shared log-sum-exp and dS in f32, each rounded as the
//     A operand of dV = P^T dO and dK = scale dS^T Q. Key rows 1..N are stored; key row 0, the
//     CLS key, goes out in f32 as this frame's row of `cls_part` [B, H, F,
//     2, Dh], which K6 sums over the frames in order.
//   So the scores are computed twice, not three times, and qkv and dO leave
//   device memory once.
// What bounds them on an H100 (PERF.md section 6): the issue of mma.sync
// (a B fragment read from shared memory for every 16 rows), the
// shared-memory reads and the per-score softmax work, not device memory;
// `wgmma`, which reads B once for 64 rows, is the next lever.

#include "attention_common.cuh"

namespace {

// The geometry below was the fastest of those PERF.md section 6 records on
// an H100 (a sweep of warps a block, query tiles a warp, key tiles a
// softmax step and blocks an SM, in one call).
// A frame of at most 208 keys (N <= 207): K4 holds a tile's scores over
// them in registers; K1 takes the same frames.
constexpr int kMaxKeyTiles = 13;
constexpr int kPad = 8;           // bf16 of padding a padded row
constexpr int kFwdWarps = 4;      // K1's warps a block
constexpr int kFwdChunk = 2;      // K1's 16-key tiles a softmax step
constexpr int kBwdWarps = 6;      // K4's warps a block: two blocks an SM
// K1's query tiles a warp takes at once, and the blocks an SM should hold
// (which caps its registers a thread), by head dim: two tiles share each K
// and V fragment up to Dh = 64, three blocks an SM (163 registers at 64).
template <int DH>
__host__ __device__ constexpr int fwd_tiles() {
  return DH <= 64 ? 2 : 1;
}
template <int DH>
__host__ __device__ constexpr int fwd_min_blocks() {
  return DH <= 64 ? 3 : 2;
}
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

// 2^x on the MUFU alone (ex2.approx.ftz: about 2 ulp; a result under
// 2^-126 flushed to zero, a weight of nothing beside the row's largest,
// which is 1). 5-7% faster than exp2f in both kernels on an H100.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Waits for this thread's cp.async groups but the last one, or for all.
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The 16-row tiles of a frame: N + 1 keys (the CLS key first), N queries.
__host__ __device__ __forceinline__ int key_tiles(int N) {
  return (N + 16) / 16;
}
__host__ __device__ __forceinline__ int query_tiles(int N) {
  return (N + 15) / 16;
}

// The layout of a staged tile of Dh bf16 a row. Swizzled (kSwz, for Dh/8 a
// power of two): no padding, 16-byte chunk c of row r at chunk c ^ mask(r),
// mask(r) depending on r % 8 alone, so that the eight rows an ldmatrix reads
// at one column fall on eight distinct 16-byte bank groups. Else padded to a
// pitch of Dh + kPad (Dh/8 + 1 16-byte chunks, an odd number).
template <int DH, bool kSwz>
struct Layout {
  static constexpr int kLd = kSwz ? DH : DH + kPad;  // bf16 a row
  static constexpr int kChunks = DH / 8;
  static_assert(!kSwz || (kChunks & (kChunks - 1)) == 0, "swizzle needs 2^k");
  __device__ __forceinline__ static int at(int row, int chunk) {
    const int mask = kChunks >= 8 ? (row & 7)
                     : kChunks == 4 ? ((row >> 1) & 3) : ((row >> 2) & 1);
    return row * kLd + ((kSwz ? chunk ^ mask : chunk) << 3);
  }
};

// A lane's ldmatrix offsets in a Layout tile, for the 16 x 16 blocks at
// column 16 kk of a block of rows that starts at a multiple of 8 (add
// row0 * kLd): `rows` in the rows16 order of attention_common.cuh, `cols`
// in its cols16 order. The swizzle depends on the row's remainder mod 8,
// so they hold for every such block.
template <class L, int DH>
struct LaneOffsets {
  int rows[DH / 16], cols[DH / 16];
  __device__ __forceinline__ explicit LaneOffsets(int lane) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      rows[kk] = L::at(lane & 15, 2 * kk + (lane >> 4));
      cols[kk] = L::at(((lane >> 4) << 3) + (lane & 7),
                       2 * kk + ((lane >> 3) & 1));
    }
  }
};

// K1's layout (padded: every head dim it takes), K4's (swizzled where
// Dh/8 is a power of two, so that two blocks share an SM at Dh = 64).
template <int DH>
using FwdLayout = Layout<DH, false>;
template <int DH>
using BwdLayout = Layout<DH, (DH & (DH - 1)) == 0>;

// K1's dynamic shared memory: K and V.
inline int fwd_shared_bytes(int Dh, int N) {
  return 2 * 2 * 16 * key_tiles(N) * (Dh + kPad);
}

// K4's: K and V (16 key_tiles rows), Q and dO (16 query_tiles rows), Dh bf16
// a row (Dh + kPad at Dh = 48), then each query row's log-sum-exp and delta
// in f32.
inline int bwd_shared_bytes(int Dh, int N) {
  const int kp = 16 * key_tiles(N), qp = 16 * query_tiles(N);
  const int ld = (Dh & (Dh - 1)) == 0 ? Dh : Dh + kPad;
  return 2 * (2 * kp + 2 * qp) * ld + 2 * 4 * qp;
}

// Stages `rows` tile rows of one (b, h): row j of a key tile is the CLS key
// (j = 0) or patch j - 1 of the frame, row j of a query tile patch j;
// rows past the frame are zero-filled. `src` is the tensor's element of
// sequence row 0 for this head, `ld` its row stride.
template <class L>
__device__ __forceinline__ void stage(__nv_bfloat16* tile,
                                      const __nv_bfloat16* src, int64_t ld,
                                      int rows, int N, int first, bool keys) {
  for (int i = threadIdx.x; i < rows * L::kChunks; i += blockDim.x) {
    const int j = i / L::kChunks, c = i % L::kChunks;
    const bool live = keys ? j <= N : j < N;
    const int64_t row = !live ? 0 : keys ? (j == 0 ? 0 : first + j - 1)
                                         : first + j;
    cp_async16(tile + L::at(j, c), src + row * ld + c * 8, live);
  }
}

// K1's A fragments of one 16-row query tile, patches p_lo and p_lo + 8 of
// the frame, read from device memory (zeros past the frame).
template <int DH>
__device__ __forceinline__ void load_q(const __nv_bfloat16* qbase,
                                       int64_t stride, int first, int p_lo,
                                       int N, int t,
                                       uint32_t (&qa)[DH / 16][4]) {
  const bool ok_lo = p_lo < N, ok_hi = p_lo + 8 < N;
  const __nv_bfloat16* q_lo = qbase + (int64_t)(first + p_lo) * stride;
  const __nv_bfloat16* q_hi = q_lo + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ok_lo ? ld32(q_lo + c) : 0u;
    qa[kk][1] = ok_hi ? ld32(q_hi + c) : 0u;
    qa[kk][2] = ok_lo ? ld32(q_lo + c + 8) : 0u;
    qa[kk][3] = ok_hi ? ld32(q_hi + c + 8) : 0u;
  }
}

// K1. grid (H, F, B), 32 kFwdWarps threads, fwd_shared_bytes. A warp takes
// fwd_tiles 16-row query tiles at once, so that every K and V fragment it
// loads from shared memory serves them all, and their keys kFwdChunk 16-key
// tiles at a time with an online softmax (FA2's: the running max and sum
// of a row, the output rescaled a step).
template <int DH>
__global__ void __launch_bounds__(32 * kFwdWarps, fwd_min_blocks<DH>())
    space_fwd_frame_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out, int S, int H,
                           int N, float scale) {
  constexpr int KC = kFwdChunk, R = fwd_tiles<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = key_tiles(N), qt = query_tiles(N);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  using L = FwdLayout<DH>;
  __nv_bfloat16* sV = sK + 16 * kt * L::kLd;
  const LaneOffsets<L, DH> lo(threadIdx.x % 32);
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  __nv_bfloat16* obase = out + (int64_t)b * S * width + (int64_t)h * DH;
  const int first = 1 + f * N;  // sequence row of patch 0 of the frame
  stage<L>(sK, qbase + width, stride, 16 * kt, N, first, true);
  cp_async_commit();
  stage<L>(sV, qbase + 2 * width, stride, 16 * kt, N, first, true);
  cp_async_commit();
  const float sl2 = scale * kLog2e;

  const int groups = (qt + R - 1) / R;  // groups of R query tiles
  const int iters = (groups + kFwdWarps - 1) / kFwdWarps;  // every warp's
  for (int it = 0; it < iters; ++it) {
    const int grp = it * kFwdWarps + warp;
    // tiles of this group that hold queries (warp-uniform)
    const int live = grp < groups ? min(R, qt - grp * R) : 0;
    uint32_t qa[R][DH / 16][4];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      load_q<DH>(qbase, stride, first, (grp * R + u) * 16 + g,
                 u < live ? N : 0, t, qa[u]);
    }
    if (it == 0) {  // K has landed
      cp_async_wait_but_last();
      __syncthreads();
    }
    float o[R][DH / 8][4];
    float m[R][2], l[R][2];  // rows g and g + 8 of each tile, raw logits
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        o[u][nd][0] = o[u][nd][1] = o[u][nd][2] = o[u][nd][3] = 0.f;
      }
      m[u][0] = m[u][1] = -INFINITY;
      l[u][0] = l[u][1] = 0.f;
    }
    for (int c0 = 0; c0 < kt; c0 += KC) {  // the same for every warp
      float s[R][2 * KC][4];
      if (live) {
#pragma unroll
        for (int u = 0; u < R; ++u) {
#pragma unroll
          for (int nt = 0; nt < 2 * KC; ++nt) {
            s[u][nt][0] = s[u][nt][1] = s[u][nt][2] = s[u][nt][3] = 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (c0 + j < kt) {
#pragma unroll
            for (int kk = 0; kk < DH / 16; ++kk) {
              uint32_t kb[4];
              ldsm4<false>(kb, sK + (c0 + j) * 16 * L::kLd + lo.cols[kk]);
#pragma unroll
              for (int u = 0; u < R; ++u) {
                if (u < live) {
                  mma_bf16(s[u][2 * j], qa[u][kk], kb[0], kb[1]);
                  mma_bf16(s[u][2 * j + 1], qa[u][kk], kb[2], kb[3]);
                }
              }
            }
          }
        }
        // Online softmax, base 2 (exp2 of scale log2(e) (s - max)). Keys
        // past N get -inf; every chunk holds a live key, so the new max
        // is finite and exp2(-inf) = 0 clears the first chunk's rescale.
        const bool edge = (c0 + KC) * 16 > N;  // the chunk passes key N
#pragma unroll
        for (int u = 0; u < R; ++u) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int nt = 0; nt < 2 * KC; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (edge && c0 * 16 + nt * 8 + 2 * t + (e & 1) > N) {
                s[u][nt][e] = -INFINITY;
              }
              mx[e >> 1] = fmaxf(mx[e >> 1], s[u][nt][e]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
            }
            const float mn = fmaxf(m[u][r], mx[r]);
            const float corr = exp2_approx((m[u][r] - mn) * sl2);
            m[u][r] = mn;
            l[u][r] *= corr;
            mx[r] = -mn * sl2;  // the exponent's offset from here on
#pragma unroll
            for (int nd = 0; nd < DH / 8; ++nd) {
              o[u][nd][2 * r] *= corr;
              o[u][nd][2 * r + 1] *= corr;
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2 * KC; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[u][nt][e] = exp2_approx(fmaf(s[u][nt][e], sl2, mx[e >> 1]));
              l[u][e >> 1] += s[u][nt][e];
            }
          }
        }
      }
      if (it == 0 && c0 == 0) {  // V has landed
        cp_async_wait_all();
        __syncthreads();
      }
      if (live) {
        // O += P V: S's C fragments are P's A fragments; V read transposed.
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (c0 + j < kt) {
            uint32_t pa[R][4];
#pragma unroll
            for (int u = 0; u < R; ++u) {
              pa[u][0] = pack_bf16(s[u][2 * j][0], s[u][2 * j][1]);
              pa[u][1] = pack_bf16(s[u][2 * j][2], s[u][2 * j][3]);
              pa[u][2] = pack_bf16(s[u][2 * j + 1][0], s[u][2 * j + 1][1]);
              pa[u][3] = pack_bf16(s[u][2 * j + 1][2], s[u][2 * j + 1][3]);
            }
#pragma unroll
            for (int d0 = 0; d0 < DH; d0 += 16) {
              uint32_t vb[4];
              ldsm4<true>(vb, sV + (c0 + j) * 16 * L::kLd + lo.rows[d0 / 16]);
#pragma unroll
              for (int u = 0; u < R; ++u) {
                if (u < live) {
                  mma_bf16(o[u][d0 / 8], pa[u], vb[0], vb[1]);
                  mma_bf16(o[u][d0 / 8 + 1], pa[u], vb[2], vb[3]);
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int p_lo = (grp * R + u) * 16 + g, p_hi = p_lo + 8;
      if (u < live) {
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            l[u][r] += __shfl_xor_sync(0xffffffffu, l[u][r], off);
          }
          inv[r] = 1.f / l[u][r];
        }
        __nv_bfloat16* o_lo = obase + (int64_t)(first + p_lo) * width;
        __nv_bfloat16* o_hi = o_lo + 8 * width;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          const int c = nd * 8 + 2 * t;
          if (p_lo < N) {
            *reinterpret_cast<uint32_t*>(o_lo + c) =
                pack_bf16(o[u][nd][0] * inv[0], o[u][nd][1] * inv[0]);
          }
          if (p_hi < N) {
            *reinterpret_cast<uint32_t*>(o_hi + c) =
                pack_bf16(o[u][nd][2] * inv[1], o[u][nd][3] * inv[1]);
          }
        }
      }
    }
  }
}

// dP = dO V^T over one 16-key tile, in f32: `ga` the A fragments of the
// query tile's dO, `sv` the tile's first V row.
template <class L, int DH>
__device__ __forceinline__ void dp_tile(float (&dp)[2][4],
                                        const uint32_t (&ga)[DH / 16][4],
                                        const __nv_bfloat16* sv,
                                        const LaneOffsets<L, DH>& lo) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t vb[4];
    ldsm4<false>(vb, sv + lo.cols[kk]);
    mma_bf16(dp[0], ga[kk], vb[0], vb[1]);
    mma_bf16(dp[1], ga[kk], vb[2], vb[3]);
  }
}

// K4. grid (H, F, B), 32 kBwdWarps threads, bwd_shared_bytes. Two blocks
// an SM cap a thread at 168 registers: at Dh = 64 nvcc spills 108 bytes of
// the f32 P and dP, and K4 runs 1.5x faster than with the 214 registers it
// takes uncapped (one block an SM; PERF.md section 6).
template <int DH>
__global__ void __launch_bounds__(32 * kBwdWarps, 2)
    space_bwd_frame_kernel(const __nv_bfloat16* __restrict__ qkv,
                           const __nv_bfloat16* __restrict__ gout,
                           __nv_bfloat16* __restrict__ dqkv,
                           float* __restrict__ cls_part, int S, int H, int N,
                           float scale) {
  constexpr int KT = kMaxKeyTiles;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kt = key_tiles(N), qt = query_tiles(N);
  const int KP = 16 * kt, QP = 16 * qt;
  using L = BwdLayout<DH>;
  constexpr int LD = L::kLd;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + KP * LD;
  __nv_bfloat16* sQ = sV + KP * LD;
  __nv_bfloat16* sG = sQ + QP * LD;
  float* sLse = reinterpret_cast<float*>(sG + QP * LD);
  const LaneOffsets<L, DH> lo(threadIdx.x % 32);
  float* sDelta = sLse + QP;
  const int h = blockIdx.x, f = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const __nv_bfloat16* gbase = gout + (int64_t)b * S * width + (int64_t)h * DH;
  __nv_bfloat16* dbase = dqkv + (int64_t)b * S * stride + (int64_t)h * DH;
  const int first = 1 + f * N;
  stage<L>(sK, qbase + width, stride, KP, N, first, true);
  stage<L>(sQ, qbase, stride, QP, N, first, false);
  cp_async_commit();
  stage<L>(sV, qbase + 2 * width, stride, KP, N, first, true);
  stage<L>(sG, gbase, width, QP, N, first, false);
  cp_async_commit();
  const float sl2 = scale * kLog2e;

  // Phase A: query tiles.
  const int q_iters = (qt + kBwdWarps - 1) / kBwdWarps;  // every warp's
  for (int it = 0; it < q_iters; ++it) {
    const int tile = it * kBwdWarps + warp;
    const bool live = tile < qt;
    const int m0 = tile * 16;
    const bool ok_lo = live && m0 + g < N, ok_hi = live && m0 + g + 8 < N;
    if (it == 0) {  // K and Q have landed
      cp_async_wait_but_last();
      __syncthreads();
    }
    float p[2 * KT][4];  // P in f32: rows g, g + 8 of n-tile nt
    float lse_lo = 0.f, lse_hi = 0.f;
    if (live) {
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t qa[4];
        ldsm4<false>(qa, sQ + m0 * LD + lo.rows[kk]);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          if (np < kt) {
            uint32_t kb[4];
            ldsm4<false>(kb, sK + np * 16 * LD + lo.cols[kk]);
            mma_bf16(p[2 * np], qa, kb[0], kb[1]);
            mma_bf16(p[2 * np + 1], qa, kb[2], kb[3]);
          }
        }
      }
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = nt * 8 + 2 * t + (e & 1) <= N;
          p[nt][e] = valid ? p[nt][e] * sl2 : -INFINITY;
        }
        m_lo = fmaxf(m_lo, fmaxf(p[nt][0], p[nt][1]));
        m_hi = fmaxf(m_hi, fmaxf(p[nt][2], p[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
      }
      float l_lo = 0.f, l_hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        if (nt < 2 * kt) {
          p[nt][0] = exp2_approx(p[nt][0] - m_lo);
          p[nt][1] = exp2_approx(p[nt][1] - m_lo);
          p[nt][2] = exp2_approx(p[nt][2] - m_hi);
          p[nt][3] = exp2_approx(p[nt][3] - m_hi);
          l_lo += p[nt][0] + p[nt][1];
          l_hi += p[nt][2] + p[nt][3];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      lse_lo = m_lo + log2f(l_lo);
      lse_hi = m_hi + log2f(l_hi);
      const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        p[nt][0] = nt < 2 * kt ? p[nt][0] * inv_lo : 0.f;
        p[nt][1] = nt < 2 * kt ? p[nt][1] * inv_lo : 0.f;
        p[nt][2] = nt < 2 * kt ? p[nt][2] * inv_hi : 0.f;
        p[nt][3] = nt < 2 * kt ? p[nt][3] * inv_hi : 0.f;
      }
    }
    if (it == 0) {  // V and dO have landed
      cp_async_wait_all();
      __syncthreads();
    }
    if (live) {
      uint32_t ga[DH / 16][4];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        ldsm4<false>(ga[kk], sG + m0 * LD + lo.rows[kk]);
      }
      // dP = dO V^T in f32, a key tile at a time: twice, since the tile
      // holds P's 208 scores in f32 and has no room for dP's beside them.
      // First delta = sum P dP, then dS = P (dP - delta).
      float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        if (np < kt) {
          float dp[2][4];
          dp_tile<L, DH>(dp, ga, sV + np * 16 * LD, lo);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int nt = 2 * np + j;
            d_lo += p[nt][0] * dp[j][0] + p[nt][1] * dp[j][1];
            d_hi += p[nt][2] * dp[j][2] + p[nt][3] * dp[j][3];
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
      }
      // dQ = dS K: dS's C fragments, rounded, are the A fragments of the
      // keys' 16-wide steps; K read transposed.
      float dq[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        if (kc < kt) {
          float dp[2][4];
          dp_tile<L, DH>(dp, ga, sV + kc * 16 * LD, lo);
          uint32_t a[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int nt = 2 * kc + j;
            a[2 * j] = pack_bf16(p[nt][0] * (dp[j][0] - d_lo),
                                 p[nt][1] * (dp[j][1] - d_lo));
            a[2 * j + 1] = pack_bf16(p[nt][2] * (dp[j][2] - d_hi),
                                     p[nt][3] * (dp[j][3] - d_hi));
          }
#pragma unroll
          for (int d0 = 0; d0 < DH; d0 += 16) {
            uint32_t kb[4];
            ldsm4<true>(kb, sK + kc * 16 * LD + lo.rows[d0 / 16]);
            mma_bf16(dq[d0 / 8], a, kb[0], kb[1]);
            mma_bf16(dq[d0 / 8 + 1], a, kb[2], kb[3]);
          }
        }
      }
      __nv_bfloat16* q_lo = dbase + (int64_t)(first + m0 + g) * stride;
      __nv_bfloat16* q_hi = q_lo + 8 * stride;
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
      // +inf turns a query past the frame into P = 0 in phase B
      if (t == 0) {
        sLse[m0 + g] = ok_lo ? lse_lo : INFINITY;
        sLse[m0 + g + 8] = ok_hi ? lse_hi : INFINITY;
        sDelta[m0 + g] = ok_lo ? d_lo : 0.f;
        sDelta[m0 + g + 8] = ok_hi ? d_hi : 0.f;
      }
    }
  }
  __syncthreads();  // every query row's log-sum-exp and delta

  // Phase B: key tiles, 16 queries a step (more held more registers and
  // lost on an H100).
  for (int tile = warp; tile < kt; tile += kBwdWarps) {
    const int j0 = tile * 16;
    uint32_t ka[DH / 16][4], va[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      ldsm4<false>(ka[kk], sK + j0 * LD + lo.rows[kk]);
      ldsm4<false>(va[kk], sV + j0 * LD + lo.rows[kk]);
    }
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
      dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
    }
    for (int q0 = 0; q0 < QP; q0 += 16) {
      float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t qb[4], gb[4];
        ldsm4<false>(qb, sQ + q0 * LD + lo.cols[kk]);
        ldsm4<false>(gb, sG + q0 * LD + lo.cols[kk]);
        mma_bf16(st[0], ka[kk], qb[0], qb[1]);
        mma_bf16(st[1], ka[kk], qb[2], qb[3]);
        mma_bf16(dt[0], va[kk], gb[0], gb[1]);
        mma_bf16(dt[1], va[kk], gb[2], gb[3]);
      }
      // rows: keys g, g + 8; columns: queries q and q + 1
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int q = q0 + nt * 8 + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(sLse + q);
        const float2 dl = *reinterpret_cast<const float2*>(sDelta + q);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_approx(st[nt][e] * sl2 - ((e & 1) ? ls.y : ls.x));
          st[nt][e] = p;
          dt[nt][e] = p * (dt[nt][e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q: the C fragments (keys x queries) are the
      // A fragments; dO and Q read transposed.
      const uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]),
                              pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]),
                              pack_bf16(st[1][2], st[1][3])};
      const uint32_t da[4] = {pack_bf16(dt[0][0], dt[0][1]),
                              pack_bf16(dt[0][2], dt[0][3]),
                              pack_bf16(dt[1][0], dt[1][1]),
                              pack_bf16(dt[1][2], dt[1][3])};
#pragma unroll
      for (int d0 = 0; d0 < DH; d0 += 16) {
        uint32_t gb[4], qb[4];
        ldsm4<true>(gb, sG + q0 * LD + lo.rows[d0 / 16]);
        ldsm4<true>(qb, sQ + q0 * LD + lo.rows[d0 / 16]);
        mma_bf16(dv[d0 / 8], pa, gb[0], gb[1]);
        mma_bf16(dv[d0 / 8 + 1], pa, gb[2], gb[3]);
        mma_bf16(dk[d0 / 8], da, qb[0], qb[1]);
        mma_bf16(dk[d0 / 8 + 1], da, qb[2], qb[3]);
      }
    }
    // key j_lo = j0 + g and j_hi = j_lo + 8; key 0 is the CLS key
    const int j_lo = j0 + g, j_hi = j_lo + 8;
    __nv_bfloat16* k_lo = dbase + (int64_t)(first + j_lo - 1) * stride + width;
    __nv_bfloat16* k_hi = k_lo + 8 * stride;
    float* cls = cls_part + (((int64_t)b * H + h) * gridDim.y + f) * 2 * DH;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      if (j_lo == 0) {
        cls[c] = dk[nd][0] * scale;
        cls[c + 1] = dk[nd][1] * scale;
        cls[DH + c] = dv[nd][0];
        cls[DH + c + 1] = dv[nd][1];
      } else if (j_lo <= N) {
        *reinterpret_cast<uint32_t*>(k_lo + c) =
            pack_bf16(dk[nd][0] * scale, dk[nd][1] * scale);
        *reinterpret_cast<uint32_t*>(k_lo + width + c) =
            pack_bf16(dv[nd][0], dv[nd][1]);
      }
      if (j_hi <= N) {
        *reinterpret_cast<uint32_t*>(k_hi + c) =
            pack_bf16(dk[nd][2] * scale, dk[nd][3] * scale);
        *reinterpret_cast<uint32_t*>(k_hi + width + c) =
            pack_bf16(dv[nd][2], dv[nd][3]);
      }
    }
  }
}

template <int DH>
int launch_fwd(const void* qkv, void* out, int B, int S, int H, int F,
               int shared_bytes, float scale, cudaStream_t stream) {
  auto kernel = space_fwd_frame_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, F, B), 32 * kFwdWarps, shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), S, H, (S - 1) / F, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bwd(const void* qkv, const void* gout, void* dqkv, float* cls_part,
               int B, int S, int H, int F, int shared_bytes, float scale,
               cudaStream_t stream) {
  auto kernel = space_bwd_frame_kernel<DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, F, B), 32 * kBwdWarps, shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<const __nv_bfloat16*>(gout),
      static_cast<__nv_bfloat16*>(dqkv), cls_part, S, H, (S - 1) / F, scale);
  return static_cast<int>(cudaGetLastError());
}

// The shapes the frame forms take: bf16, S = 1 + F N with N + 1 keys in
// kMaxKeyTiles tiles, and a grid within CUDA's limits.
inline bool frame_shape(int dtype, int B, int S, int F) {
  return dtype == 1 && F >= 1 && S >= 2 && (S - 1) % F == 0 &&
         key_tiles((S - 1) / F) <= kMaxKeyTiles && F <= 65535 && B <= 65535;
}

}  // namespace

extern "C" {

// K1's frame form on `space_fwd_geometry`: `parts` blocks a (b, h), one a
// frame (F), `shared_bytes` of dynamic shared memory. Any other geometry, or
// a shape off this form (bf16, Dh a multiple of 16 up to 128), is refused
// (cudaErrorInvalidValue).
int space_attention_fwd_frame(const void* qkv, void* out, int dtype, int B,
                              int S, int H, int Dh, int F, float scale,
                              int parts, int shared_bytes, void* stream) {
  if (!frame_shape(dtype, B, S, F) || Dh < 16 || Dh > 128 || Dh % 16 ||
      parts != F || shared_bytes != fwd_shared_bytes(Dh, (S - 1) / F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch_fwd<16>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 32: return launch_fwd<32>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 48: return launch_fwd<48>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 64: return launch_fwd<64>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 80: return launch_fwd<80>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 96: return launch_fwd<96>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 112: return launch_fwd<112>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    case 128: return launch_fwd<128>(qkv, out, B, S, H, F, shared_bytes, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4's frame form on `space_bwd_geometry`: rows 1..S-1 of dq, dk and dv into
// dqkv, and the CLS key's dk and dv of each frame into `cls_part` [B, H,
// parts, 2, Dh] (f32); `parts` = F blocks a (b, h), `shared_bytes` of
// dynamic shared memory. Any other geometry, or a shape off this form
// (bf16, Dh 16, 32, 48 or 64), is refused (cudaErrorInvalidValue).
int space_attention_bwd_frame(const void* qkv, const void* gout, void* dqkv,
                              void* cls_part, int dtype, int B, int S, int H,
                              int Dh, int F, float scale, int parts,
                              int shared_bytes, void* stream) {
  if (!frame_shape(dtype, B, S, F) || Dh < 16 || Dh > 64 || Dh % 16 ||
      parts != F || shared_bytes != bwd_shared_bytes(Dh, (S - 1) / F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cp = static_cast<float*>(cls_part);
  switch (Dh) {
    case 16: return launch_bwd<16>(qkv, gout, dqkv, cp, B, S, H, F, shared_bytes, scale, st);
    case 32: return launch_bwd<32>(qkv, gout, dqkv, cp, B, S, H, F, shared_bytes, scale, st);
    case 48: return launch_bwd<48>(qkv, gout, dqkv, cp, B, S, H, F, shared_bytes, scale, st);
    case 64: return launch_bwd<64>(qkv, gout, dqkv, cp, B, S, H, F, shared_bytes, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
