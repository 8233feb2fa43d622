// Helpers shared by the divided-attention kernels (forward and backward)
// and the fused attention: vector loads and stores of the 8 head-dim
// elements a thread owns, the sum over the G lanes of a row group, the view
// of one (batch, head) of the packed qkv tensor, and the cp.async and
// ldmatrix helpers of the kernels that stage with cp.async. Layout and work
// split are described in divided_attention.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;        // head-dim elements a thread owns
constexpr int kThreads = 256;  // threads a block

__device__ __forceinline__ void load_vec(const float* p, float (&o)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The 8 elements a lane owns of one row, as loaded: a load is issued now and
// converted to f32 only where it is used, so a thread can keep many rows'
// loads in flight in few registers.
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw<float> {
  float4 a, b;
};

// Read-only rows (q, k, v, the cotangent, the output) through the
// non-coherent cache.
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p,
                                         Raw<__nv_bfloat16>& r) {
  r.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_raw(const float* p, Raw<float>& r) {
  r.a = __ldg(reinterpret_cast<const float4*>(p));
  r.b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
// Rows an earlier kernel wrote and this one overwrites: plain loads.
__device__ __forceinline__ void load_raw_rw(const __nv_bfloat16* p,
                                            Raw<__nv_bfloat16>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw_rw(const float* p, Raw<float>& r) {
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void zero_raw(Raw<__nv_bfloat16>& r) {
  r.u = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void zero_raw(Raw<float>& r) {
  r.a = r.b = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void to_float(const Raw<__nv_bfloat16>& r,
                                         float (&o)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_float(const Raw<float>& r,
                                         float (&o)[kVec]) {
  o[0] = r.a.x; o[1] = r.a.y; o[2] = r.a.z; o[3] = r.a.w;
  o[4] = r.b.x; o[5] = r.b.y; o[6] = r.b.z; o[7] = r.b.w;
}

// Sum over the G lanes of a row group. Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off, G);
  }
  return x;
}

// Sum over the row groups of a warp, lane by lane of a group: afterwards
// every lane holds the sum of its own slice over the warp's 32 / G groups,
// the same bits on each (a butterfly in a fixed order). All lanes call it.
template <int G>
__device__ __forceinline__ void warp_groups_sum(float (&x)[kVec]) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      x[e] += __shfl_xor_sync(0xffffffffu, x[e], off);
    }
  }
}

// Keys a row group of the CLS-row kernels (K3, K6) takes in one block; a
// block's run of keys is this times its row groups. `cls_row_geometry`
// (ops/_kernels.py) states the same, and the entry points refuse any other
// run.
constexpr int kClsKeys = 4;

// The CLS-row kernels' merge launches (K3, K6): a block a (batch, head),
// its threads as slices of G * kVec columns, each slice summing every
// kMergeThreads / (G * kVec)-th part, then the slices summed in order.
constexpr int kMergeThreads = 512;

// What a thread needs to read the keys and values of its (batch, head).
template <typename T>
struct HeadView {
  const T* k;      // k of sequence row 0, offset to this thread's slice
  const T* v;      // v likewise
  int64_t stride;  // elements between sequence rows (3*H*Dh)
  bool on;         // the thread owns a slice (false on padding lanes)
};

template <typename T>
__device__ __forceinline__ HeadView<T> head_view(const T* qkv, int b, int h,
                                                 int S, int H, int Dh,
                                                 int lane) {
  const int64_t stride = 3LL * H * Dh;
  const T* base = qkv + (int64_t)b * S * stride + (int64_t)h * Dh +
                  (int64_t)lane * kVec;
  return HeadView<T>{base + (int64_t)H * Dh, base + 2LL * H * Dh, stride,
                     lane * kVec < Dh};
}

template <typename T>
__device__ __forceinline__ void load_q(const T* qkv, const HeadView<T>& hv,
                                       int b, int h, int S, int H, int Dh,
                                       int lane, int64_t row,
                                       float (&q)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) q[e] = 0.f;
  if (hv.on) {
    load_vec(qkv + ((int64_t)b * S + row) * hv.stride + (int64_t)h * Dh +
                 (int64_t)lane * kVec,
             q);
  }
}

// Lanes a row group needs for head dim Dh: Dh/8 rounded up to a power of 2.
inline int group_size(int Dh) {
  int g = 1;
  while (g * kVec < Dh) g <<= 1;
  return g;
}

// Asynchronous staging and tensor-core operand loads of the bf16 kernels
// that stage their tiles with cp.async (K5's tensor-core form in
// divided_attention_bwd.cu, K9's few-query form in fused_attention.cu).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where `live` is false.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, each transposed if kTrans.
template <bool kTrans>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4],
                                      const __nv_bfloat16* p) {
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  }
}

// A lane's row address for ldsm4 of the 16 x 16 block at (r0, c0) of a
// row-major tile with row pitch `ld`, in two matrix orders:
//   `rows16`: lanes 0-15 rows r0.., cols c0; 16-31 cols c0 + 8. Plain: the
//     A fragment of an [M][K] tile. Transposed: the B fragments of n-tiles
//     c0 and c0 + 8 of a [K][N] tile.
//   `cols16`: lanes 0-7 rows r0.., 8-15 the same rows at c0 + 8, 16-31 rows
//     r0 + 8... Plain: the B fragments of n-tiles r0 and r0 + 8 of an [N][K]
//     tile. Transposed: the A fragment of a [K][M] tile.
__device__ __forceinline__ int rows16(int ld, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ int cols16(int ld, int r0, int c0, int lane) {
  return (r0 + ((lane >> 4) << 3) + (lane & 7)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

}  // namespace
