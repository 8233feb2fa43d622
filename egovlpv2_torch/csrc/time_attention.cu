// K2 on the tensor cores: the bf16 forward of divided TIME attention for
// the patch rows (rows 1..S-1), for Dh a multiple of 16 up to 64 and
// F <= 63, so that a patch column's F + 1 keys (the CLS key, then its F
// frames) fit at most four 16-row tiles. Layout and semantics are those of
// divided_attention.cu, which keeps K2's grouped CUDA-core form
// (time_fwd_kernel) for f32, the other head dims and F > 63; the geometry
// `time_fwd_geometry` (ops/_kernels.py) names the form, and each entry
// point refuses a geometry that is not its own.
//
// Replaces the time branches of the packed TPU kernel, as K2's grouped form
// does: the frame-pair branch (`_packed_fwd_kernel`,
// egovlpv2_tpu/ops/divided.py:811-830, `_time_fp_attend_mxu`) and the
// patch-major window branch (:789-810, with its row permutes).
//
// Bound: bytes. Each patch row has F + 1 logits (17 at F = 16), so the
// function is a gather: q, k and v read once and the output written once,
// 4 S H Dh elements (0.115 ms at B = 20, S = 3137 on an H100), against
// 4 (F + 1) Dh operations a row. The grouped form gives a query row to 8
// lanes that walk its keys 8 at a time, two dependent round trips to
// memory a chunk (the k loads, then the v loads after the softmax), and
// reads a column's key rows once for each warp that holds its queries.
//
// Design (that of K5's tensor-core form, time_bwd_kernel in
// divided_attention_bwd.cu, for the forward): a block is one warp that owns
// `cols` = ceil(16 / F) patch columns of one (b, h), so that the rows it
// stages once (the CLS key and value, the zeros past F) serve at least 16
// queries: 4 columns at F = 4 and 5, one from F = 16. The heads are the
// grid's fastest axis, so blocks that run side by side read neighbouring
// 128 bytes of the same sequence rows. For a column the warp stages with
// 16-byte cp.async the F frames' k and v rows (tile rows 1..F; row 0 holds
// the CLS key and value and the rows past F + 1 zeros, both staged once)
// and the F q rows into its one buffer, then, 16 query rows at a time:
//   S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate), scaled, keys
//   past F + 1 set to -inf; the exact softmax of each row in f32 (all its
//   keys are in the tile: no running max; the CLS key is live in every
//   row, so the max is finite); P = exp(S - max) rounded to bf16 as the A
//   operand of P V, V read through ldmatrix.trans, as K1's tensor-core form
//   rounds it; the output divided by the row sum and stored.
// Memory in flight. A column stages 3 F rows of 128 B (6 KB at F = 16, 12
// KB at F = 32); the card needs roughly 20-25 KB of loads in flight on each
// SM to reach its memory rate (3.35 TB/s x ~0.8 us / 132). A block's buffer
// is 11.5 KB at F = 16, so an SM holds up to 19 blocks and as many columns
// in flight (over 100 KB). On an H100 this was the fastest of the
// geometries PERF.md records for this kernel: a ring of two buffers a warp
// halves the warps an SM holds for the same bytes in flight and lost at
// every shape, as did blocks of more warps.

#include "attention_common.cuh"

namespace {

constexpr int kPad = 8;  // bf16 of padding a staged row
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

// The 16-row tiles of a column: KP = 16 * kt keys (the CLS key, then the F
// frames), QP = 16 * qt queries.
__host__ __device__ __forceinline__ int key_tiles(int F) {
  return (F + 16) / 16;
}
__host__ __device__ __forceinline__ int query_tiles(int F) {
  return (F + 15) / 16;
}

// A block's one buffer: K and V (KP rows each), then Q (QP rows), at a
// pitch of Dh + kPad bf16.
inline int64_t shared_bytes_of(int Dh, int F) {
  return 2LL * (2 * 16 * key_tiles(F) + 16 * query_tiles(F)) * (Dh + kPad);
}

// Patch columns a block: ceil(16 / F).
inline int cols_of(int F) { return (16 + F - 1) / F; }

template <int DH, int KT>
__global__ void __launch_bounds__(32)
    time_fwd_tc_kernel(const __nv_bfloat16* __restrict__ qkv,
                       __nv_bfloat16* __restrict__ out, int S, int H, int N,
                       int F, int cols, float scale) {
  constexpr int KP = 16 * KT, LD = DH + kPad;
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int QP = 16 * query_tiles(F);
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, part = blockIdx.y, b = blockIdx.z;
  const int n0 = part * cols, n_end = min(N, n0 + cols);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + KP * LD;
  __nv_bfloat16* sQ = sV + KP * LD;
  const int64_t stride = 3LL * H * DH, width = (int64_t)H * DH;
  const __nv_bfloat16* qbase = qkv + (int64_t)b * S * stride + (int64_t)h * DH;
  __nv_bfloat16* obase = out + (int64_t)b * S * width + (int64_t)h * DH;
  const float sl2 = scale * kLog2e;

  // The rows every column shares, once: row 0 of K and V the CLS key and
  // value; K and V rows F + 1.. and Q rows F.. zero.
  const int kfix = KP - F, fixed = 2 * kfix + QP - F;
  for (int i = lane; i < fixed * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    int at;
    bool live = false;
    if (r < 2 * kfix) {  // K (r < kfix), then V
      const int j = r % kfix, v = r / kfix;
      live = j == 0;
      at = (v * KP + (j == 0 ? 0 : F + j)) * LD;
    } else {
      at = (2 * KP + F + r - 2 * kfix) * LD;
    }
    const __nv_bfloat16* src =
        qbase + (r >= kfix && r < 2 * kfix ? 2 : 1) * width + c;
    cp_async16(sK + at + c, src, live);
  }

  for (int n = n0; n < n_end; ++n) {
    // The column's own rows: k and v of its F frames into K and V rows
    // 1..F, its F queries into Q rows 0..F-1; 8 lanes a row.
    for (int i = lane; i < 3 * F * kChunks; i += 32) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int which = r / F, f = r % F;  // 0: k, 1: v, 2: q
      const __nv_bfloat16* src = qbase + (1 + (int64_t)f * N + n) * stride +
                                 (which == 2 ? 0 : (which + 1) * width) + c;
      const int row = which == 2 ? 2 * KP + f : which * KP + 1 + f;
      cp_async16(sK + row * LD + c, src, true);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();  // every lane's copies of this column have landed
    // 16 queries at a time: frames f_lo = m0 + g and f_hi = f_lo + 8.
    for (int m0 = 0; m0 < QP; m0 += 16) {
      float s[2 * KT][4];
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < DH; k0 += 16) {
        uint32_t qa[4];
        ldsm4<false>(qa, sQ + rows16(LD, m0, k0, lane));
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t kb[4];
          ldsm4<false>(kb, sK + cols16(LD, np * 16, k0, lane));
          mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      // The exact softmax of each row over keys 0..F, base 2.
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
      // O = P V: S's C fragments are P's A fragments; V read transposed.
      float o[DH / 8][4];
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int d0 = 0; d0 < DH; d0 += 16) {
          uint32_t vb[4];
          ldsm4<true>(vb, sV + rows16(LD, kc * 16, d0, lane));
          mma_bf16(o[d0 / 8], pa, vb[0], vb[1]);
          mma_bf16(o[d0 / 8 + 1], pa, vb[2], vb[3]);
        }
      }
      const int f_lo = m0 + g, f_hi = f_lo + 8;
      const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
      __nv_bfloat16* o_lo = obase + (1 + (int64_t)f_lo * N + n) * width;
      __nv_bfloat16* o_hi = o_lo + 8LL * N * width;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const int c = nd * 8 + 2 * t;
        if (f_lo < F) {
          *reinterpret_cast<uint32_t*>(o_lo + c) =
              pack_bf16(o[nd][0] * inv_lo, o[nd][1] * inv_lo);
        }
        if (f_hi < F) {
          *reinterpret_cast<uint32_t*>(o_hi + c) =
              pack_bf16(o[nd][2] * inv_hi, o[nd][3] * inv_hi);
        }
      }
    }
    __syncwarp();  // the buffer is read before the next column is staged
  }
}

template <int DH, int KT>
int launch_tiles(const void* qkv, void* out, int B, int S, int H, int F,
                 int cols, int parts, int shared_bytes, float scale,
                 cudaStream_t stream) {
  auto kernel = time_fwd_tc_kernel<DH, KT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, parts, B), 32, shared_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv),
      static_cast<__nv_bfloat16*>(out), S, H, (S - 1) / F, F, cols, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(const void* qkv, void* out, int B, int S, int H, int F, int cols,
           int parts, int shared_bytes, float scale, cudaStream_t st) {
  switch (key_tiles(F)) {
    case 1: return launch_tiles<DH, 1>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 2: return launch_tiles<DH, 2>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 3: return launch_tiles<DH, 3>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 4: return launch_tiles<DH, 4>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K2's tensor-core form on `time_fwd_geometry`: a block is one warp,
// `cols` = ceil(16 / F) patch columns a block, `parts` blocks a (b, h)
// (ceil(N / cols)), `shared_bytes` of dynamic shared memory (one buffer).
// Any other geometry, or a shape off this form (dtype 1, bf16, only), is
// refused (cudaErrorInvalidValue).
int time_attention_fwd_tc(const void* qkv, void* out, int dtype, int B, int S,
                          int H, int Dh, int F, float scale, int cols,
                          int parts, int shared_bytes, void* stream) {
  if (dtype != 1 || Dh < 16 || Dh > 64 || Dh % 16 || F < 1 || F > 63 ||
      S < 2 || (S - 1) % F || cols != cols_of(F) ||
      parts != ((S - 1) / F + cols - 1) / cols || parts > 65535 ||
      B > 65535 || shared_bytes != shared_bytes_of(Dh, F)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return launch<16>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 32: return launch<32>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 48: return launch<48>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    case 64: return launch<64>(qkv, out, B, S, H, F, cols, parts, shared_bytes, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
