// Fused LayerNorm over the last axis for Hopper (sm_90a): forward (K7,
// layernorm_fwd) and backward (K8, layernorm_bwd). They replace the TPU
// kernels `_fwd_kernel` and `_bwd_kernel` of egovlpv2_tpu/ops/layernorm.py.
//
// Function. x is [R, D] row-major, float32 or bfloat16; scale and bias are
// float32 [D]. All arithmetic is float32, in the reference's form:
//   mean = sum(x)/D,  var = max(sum(x*x)/D - mean*mean, 0),
//   rstd = rsqrt(var + eps),  xhat = (x - mean)*rstd,
//   y  = xhat*scale + bias                       (stored in x's type)
//   dx = rstd*(gs - mean(gs) - xhat*mean(gs*xhat)),  gs = g*scale
//   dscale = sum over rows of g*xhat,  dbias = sum over rows of g  (float32)
// The forward saves nothing; the backward recomputes mean and rstd from x.
//
// Bound. Both kernels are bound by bytes: the forward reads x and writes y
// once (2 R D b bytes), the backward reads x and g and writes dx once
// (3 R D b bytes). So a row is read from memory once and kept in registers
// as the 16-byte pieces it arrived in: a group of TPR threads (32, 64, 128
// or 256, the smallest that holds the row with 32 elements a thread) owns
// one row, thread t of the group holds pieces t, t + TPR, ..., so that
// neighbouring threads load neighbouring 16 bytes. Row sums go through warp
// shuffles, and through shared memory where a group spans several warps.
// D must be a multiple of 8, at most 8192.
//
// The column sums of the backward. Blocks run in no order, so nothing is
// carried from one block to the next as the TPU kernel's ordered grid
// carries dscale and dbias. Each block takes a strip of consecutive rows,
// every thread keeps the sums of the columns it holds in registers over
// the strip, the row groups of a block add theirs through shared memory in
// a fixed order, and the block writes one float32 partial [2, D].
// layernorm_bwd_sum_kernel then adds the partials in a fixed order. There
// are no atomics: the same inputs give the same bits from run to run. The
// split, the blocks and their strips, is `layernorm_bwd_geometry`'s
// (ops/_kernels.py), which the entry point launches as given.
//
// Few rows. At a few hundred rows (R = 240, D = 768: 1.1 MB) both launches
// are latency. One launch in place of the two lost on an H100 at every row
// count tried, from 8 to 6,280 (PERF.md, section 6): one thread-block cluster
// of 8 blocks cannot spread 240 rows of arithmetic, and clusters whose last
// block adds their partials (an atomic ticket after __threadfence()) pay
// more for the fence, the ticket and the re-read than the second launch
// costs. Nor did blocks of 256 threads (fewer partials) or a prefetch of
// scale into L1 beat the split below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kBlock and kHeld must match `_LN_BLOCK` and `_LN_HELD` of ops/_kernels.py,
// from which `layernorm_bwd_geometry` cuts the backward's strips.
constexpr int kBlock = 128;     // threads a block while a row takes <= 128
constexpr int kMaxGroup = 256;  // most threads one row is spread over
constexpr int kHeld = 32;       // elements of a row one thread holds
constexpr int kMaxD = kMaxGroup * kHeld;
constexpr int kSumCols = 32;    // layernorm_bwd_sum_kernel: columns a block
constexpr int kSumSlices = 8;   // and the slices it cuts the partials into

// How a thread holds 16 bytes of a row of T.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kVec = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void unpack(const Raw& r,
                                                float (&o)[kVec]) {
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[kVec]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  static __device__ __forceinline__ void unpack(const Raw& r,
                                                float (&o)[kVec]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[kVec]) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    return r;
  }
};

// N consecutive float32 parameters (N a multiple of 4, p 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_params(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    o[4 * i] = f.x; o[4 * i + 1] = f.y; o[4 * i + 2] = f.z; o[4 * i + 3] = f.w;
  }
}

// Sums a and b over the TPR threads of a row group. Every thread of the
// block must call it: a group of several warps synchronises the block.
// `red` holds one float2 a warp.
template <int TPR>
__device__ __forceinline__ void group_sum2(float& a, float& b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // the sums of the call before have been read
    if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    const int first = (warp / kWarps) * kWarps;
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[first + w].x;
      b += red[first + w].y;
    }
  }
}

template <int TPR>
struct Shape {
  static constexpr int kThreads = TPR > kBlock ? TPR : kBlock;
  static constexpr int kRows = kThreads / TPR;  // rows a block takes at once
};

__device__ __forceinline__ float row_rstd(float s, float ss, float inv_d,
                                          float eps, float& mean) {
  mean = s * inv_d;
  const float var = fmaxf(ss * inv_d - mean * mean, 0.f);
  return rsqrtf(var + eps);
}

// K7. One row a group; a block takes kRows rows.
template <typename T, int TPR>
__global__ void __launch_bounds__(Shape<TPR>::kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int rows, int d, float eps) {
  using P = Piece<T>;
  constexpr int kVec = P::kVec;
  constexpr int kSlots = kHeld / kVec;
  __shared__ float2 red[Shape<TPR>::kThreads / 32];
  const int lane = threadIdx.x % TPR;
  const int64_t row =
      (int64_t)blockIdx.x * Shape<TPR>::kRows + threadIdx.x / TPR;
  const bool live = row < rows;
  const int nv = d / kVec;

  typename P::Raw raw[kSlots];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int v = lane + c * TPR;
    raw[c] = P::zero();
    if (live && v < nv) {
      raw[c] = *(reinterpret_cast<const typename P::Raw*>(x + row * d) + v);
      float f[kVec];
      P::unpack(raw[c], f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        s += f[e];
        ss = fmaf(f[e], f[e], ss);
      }
    }
  }
  group_sum2<TPR>(s, ss, red);
  float mean;
  const float rstd = row_rstd(s, ss, 1.f / (float)d, eps, mean);

#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int v = lane + c * TPR;
    if (live && v < nv) {
      float f[kVec], sc[kVec], bi[kVec];
      P::unpack(raw[c], f);
      load_params<kVec>(scale + v * kVec, sc);
      load_params<kVec>(bias + v * kVec, bi);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        f[e] = (f[e] - mean) * rstd * sc[e] + bi[e];
      }
      *(reinterpret_cast<typename P::Raw*>(y + row * d) + v) = P::pack(f);
    }
  }
}

// K8, the pass over the rows. Block b takes rows [b*strip, (b+1)*strip),
// kRows at a time (strip is a multiple of kRows), writes their dx and
// writes the strip's column sums to partials[b] = [2, d]: g*xhat, then g.
template <typename T, int TPR>
__global__ void __launch_bounds__(Shape<TPR>::kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const T* __restrict__ g, T* __restrict__ dx,
                     float* __restrict__ partials, int rows, int d, int strip,
                     float eps) {
  using P = Piece<T>;
  constexpr int kVec = P::kVec;
  constexpr int kSlots = kHeld / kVec;
  constexpr int kRows = Shape<TPR>::kRows;
  constexpr int kThreads = Shape<TPR>::kThreads;
  extern __shared__ float cols[];  // [kRows, 2, d] when kRows > 1
  __shared__ float2 red[kThreads / 32];
  const int lane = threadIdx.x % TPR;
  const int grp = threadIdx.x / TPR;
  const int nv = d / kVec;
  const float inv_d = 1.f / (float)d;
  const int64_t first = (int64_t)blockIdx.x * strip;
  const int64_t last = first + strip < rows ? first + strip : (int64_t)rows;

  float ds[kSlots][kVec], db[kSlots][kVec];
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      ds[c][e] = 0.f;
      db[c][e] = 0.f;
    }
  }

  // Every thread of the block walks the same r0, so that all reach the
  // block's synchronisations; a group past the last row holds zeros.
  for (int64_t r0 = first; r0 < last; r0 += kRows) {
    const int64_t row = r0 + grp;
    const bool live = row < last;
    typename P::Raw xraw[kSlots], graw[kSlots];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int v = lane + c * TPR;
      xraw[c] = P::zero();
      graw[c] = P::zero();
      if (live && v < nv) {
        xraw[c] = *(reinterpret_cast<const typename P::Raw*>(x + row * d) + v);
        graw[c] = *(reinterpret_cast<const typename P::Raw*>(g + row * d) + v);
        float f[kVec];
        P::unpack(xraw[c], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          s += f[e];
          ss = fmaf(f[e], f[e], ss);
        }
      }
    }
    group_sum2<TPR>(s, ss, red);
    float mean;
    const float rstd = row_rstd(s, ss, inv_d, eps, mean);

    float a = 0.f, b = 0.f;  // sum of gs, sum of gs*xhat
#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int v = lane + c * TPR;
      if (live && v < nv) {
        float xf[kVec], gf[kVec], sc[kVec];
        P::unpack(xraw[c], xf);
        P::unpack(graw[c], gf);
        load_params<kVec>(scale + v * kVec, sc);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float gs = gf[e] * sc[e];
          a += gs;
          b = fmaf(gs, (xf[e] - mean) * rstd, b);
        }
      }
    }
    group_sum2<TPR>(a, b, red);
    const float m1 = a * inv_d;
    const float m2 = b * inv_d;

#pragma unroll
    for (int c = 0; c < kSlots; ++c) {
      const int v = lane + c * TPR;
      if (live && v < nv) {
        float xf[kVec], gf[kVec], sc[kVec], o[kVec];
        P::unpack(xraw[c], xf);
        P::unpack(graw[c], gf);
        load_params<kVec>(scale + v * kVec, sc);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xhat = (xf[e] - mean) * rstd;
          const float gs = gf[e] * sc[e];
          o[e] = rstd * (gs - m1 - xhat * m2);
          ds[c][e] = fmaf(gf[e], xhat, ds[c][e]);
          db[c][e] += gf[e];
        }
        *(reinterpret_cast<typename P::Raw*>(dx + row * d) + v) = P::pack(o);
      }
    }
  }

  // The strip's column sums: the groups' registers, added in group order.
  float* out = partials + (int64_t)blockIdx.x * 2 * d;
  float* mine = kRows == 1 ? out : cols + (int64_t)grp * 2 * d;
#pragma unroll
  for (int c = 0; c < kSlots; ++c) {
    const int v = lane + c * TPR;
    if (v < nv) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        mine[v * kVec + e] = ds[c][e];
        mine[d + v * kVec + e] = db[c][e];
      }
    }
  }
  if constexpr (kRows > 1) {
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * d; j += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum += cols[r * 2 * d + j];
      out[j] = sum;
    }
  }
}

// K8, the sum of the blocks' partials [parts, 2, d] into dscale and dbias.
// A block owns kSumCols columns of the 2*d; its kSumSlices thread rows each
// add every kSumSlices-th partial, and thread row 0 adds the slices: a
// fixed order.
__global__ void __launch_bounds__(kSumCols * kSumSlices)
layernorm_bwd_sum_kernel(const float* __restrict__ partials,
                         float* __restrict__ dscale, float* __restrict__ dbias,
                         int parts, int d) {
  __shared__ float slices[kSumSlices][kSumCols];
  const int j = blockIdx.x * kSumCols + threadIdx.x;
  float sum = 0.f;
  if (j < 2 * d) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += kSumSlices) {
      sum += partials[(int64_t)p * 2 * d + j];
    }
  }
  slices[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && j < 2 * d) {
    sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSumSlices; ++s) sum += slices[s][threadIdx.x];
    if (j < d) {
      dscale[j] = sum;
    } else {
      dbias[j - d] = sum;
    }
  }
}

// ---------------- host side ----------------

// Threads a row of d elements is spread over: the smallest of 32, 64, 128,
// 256 that holds it with kHeld elements a thread.
inline int group_threads(int d) {
  int t = 32;
  while (t * kHeld < d) t <<= 1;
  return t;
}

inline bool shape_ok(int rows, int d, int dtype) {
  return rows >= 1 && d >= 8 && d % 8 == 0 && d <= kMaxD &&
         (dtype == 0 || dtype == 1);
}

template <typename T, int TPR>
void launch_fwd(const void* x, const float* scale, const float* bias, void* y,
                int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kRows = Shape<TPR>::kRows;
  const int grid = (rows + kRows - 1) / kRows;
  layernorm_fwd_kernel<T, TPR><<<grid, Shape<TPR>::kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, d, eps);
}

// K8's pass over the rows on the geometry of `layernorm_bwd_geometry`,
// which alone decides the split (and how many blocks at most): `parts`
// strips of `strip` rows, a whole number of the rows a block takes at once,
// that cover the rows with a row for each. A geometry that does not hold is
// refused.
template <typename T, int TPR>
int launch_bwd(const void* x, const float* scale, const void* g, void* dx,
               float* partials, int rows, int d, int strip, int parts,
               float eps, cudaStream_t stream) {
  constexpr int kRows = Shape<TPR>::kRows;
  if (parts < 1 || strip < kRows || strip % kRows ||
      (int64_t)(parts - 1) * strip >= rows || (int64_t)parts * strip < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kRows > 1 ? sizeof(float) * kRows * 2 * d : 0;
  layernorm_bwd_kernel<T, TPR>
      <<<parts, Shape<TPR>::kThreads, smem, stream>>>(
          static_cast<const T*>(x), scale, static_cast<const T*>(g),
          static_cast<T*>(dx), partials, rows, d, strip, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_fwd(const void* x, const float* scale, const float* bias, void* y,
            int rows, int d, float eps, cudaStream_t stream) {
  switch (group_threads(d)) {
    case 32: launch_fwd<T, 32>(x, scale, bias, y, rows, d, eps, stream); break;
    case 64: launch_fwd<T, 64>(x, scale, bias, y, rows, d, eps, stream); break;
    case 128: launch_fwd<T, 128>(x, scale, bias, y, rows, d, eps, stream); break;
    case 256: launch_fwd<T, 256>(x, scale, bias, y, rows, d, eps, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_bwd(const void* x, const float* scale, const void* g, void* dx,
            float* partials, int rows, int d, int strip, int parts, float eps,
            cudaStream_t s) {
  switch (group_threads(d)) {
    case 32: return launch_bwd<T, 32>(x, scale, g, dx, partials, rows, d, strip, parts, eps, s);
    case 64: return launch_bwd<T, 64>(x, scale, g, dx, partials, rows, d, strip, parts, eps, s);
    case 128: return launch_bwd<T, 128>(x, scale, g, dx, partials, rows, d, strip, parts, eps, s);
    case 256: return launch_bwd<T, 256>(x, scale, g, dx, partials, rows, d, strip, parts, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x, y, g and dx; scale, bias, dscale,
// dbias and partials are float32). The Python wrapper has checked devices,
// types, shapes, contiguity and 16-byte alignment.

int layernorm_fwd(const void* x, const float* scale, const float* bias,
                  void* y, int rows, int d, float eps, int dtype,
                  void* stream) {
  if (!shape_ok(rows, d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? run_fwd<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, s)
             : run_fwd<float>(x, scale, bias, y, rows, d, eps, s);
}

// `strip` and `parts` come from `layernorm_bwd_geometry`; `partials` is
// its f32 scratch [parts, 2, d].
int layernorm_bwd(const void* x, const float* scale, const void* g, void* dx,
                  float* dscale, float* dbias, float* partials, int rows, int d,
                  float eps, int dtype, int strip, int parts, void* stream) {
  if (!shape_ok(rows, d, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code =
      dtype == 1 ? run_bwd<__nv_bfloat16>(x, scale, g, dx, partials, rows, d,
                                          strip, parts, eps, s)
                 : run_bwd<float>(x, scale, g, dx, partials, rows, d, strip,
                                  parts, eps, s);
  if (code != 0) return code;
  const int grid = (2 * d + kSumCols - 1) / kSumCols;
  layernorm_bwd_sum_kernel<<<grid, dim3(kSumCols, kSumSlices), 0, s>>>(
      partials, dscale, dbias, parts, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
