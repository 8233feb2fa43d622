// Helpers shared by the divided-attention kernels (forward and backward):
// vector loads and stores of the 8 head-dim elements a thread owns, the sum
// over the G lanes of a row group, and the view of one (batch, head) of the
// packed qkv tensor. Layout and work split are described in
// divided_attention.cu.
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

// Sum over the G lanes of a row group. Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off, G);
  }
  return x;
}

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

}  // namespace
