// Fused ReLU + 2x2/stride-2 max pool over NHWC with a per-cell argmax code,
// and the index-routed backward.
//
// Replaces the TPU kernels hawkeye_tpu/ops/pallas_pool.py pool_fwd
// (_fwd_kernel) and pool_bwd (_bwd_kernel).
//
// Bound on Hopper: device-memory bytes. The forward reads N input values and
// writes N/4 pooled values plus N/4 one-byte codes; the backward reads N/4
// values of dp and p plus N/4 codes and writes N values of dx. There is no
// reuse to exploit, so the design is one pass that touches each byte once:
// one thread per pooled cell and VEC consecutive channels (16-byte loads and
// stores when C allows), channels innermost so a warp reads contiguous
// memory, compare in f32 (exact for bf16), 64-bit offsets (the 448x448x64
// map at batch 128 has 1.6e9 elements).
//
// Semantics (bit-exact with the plain PyTorch version in ops/pool.py):
//   m0 = max(c00, c01), m1 = max(c10, c11), m = max(m0, m1)  (NaN propagates,
//   as torch.maximum and jnp.maximum do)
//   code: first max wins in row-major window order, strict > at each merge:
//   i0 = c01 > c00 ? 1 : 0; i1 = c11 > c10 ? 3 : 2; idx = m1 > m0 ? i1 : i0
//   p = max(m, 0)
//   backward: dx[window pos k] = (idx == k && p > 0) ? dp : 0, written for
//   every element of every window (zeros included), so no memset and no
//   atomics: windows do not overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: every value came from a bf16
}

// torch.maximum semantics: NaN in either operand gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <int V>
struct alignas(V) Codes {
  uint8_t v[V];
};

// Decompose the vector index t over (b, h2, w2, c/V) and return the offset of
// the window's top-left element in the full-resolution NHWC map. The pooled
// offset is t * V.
__device__ __forceinline__ int64_t window_base(int64_t t, int H2, int W2,
                                               int C, int V) {
  const int cv_count = C / V;
  const int cv = (int)(t % cv_count);
  int64_t r = t / cv_count;
  const int w2 = (int)(r % W2);
  r /= W2;
  const int h2 = (int)(r % H2);
  const int64_t b = r / H2;
  const int64_t W = 2 * (int64_t)W2;
  return ((b * 2 * H2 + 2 * h2) * W + 2 * w2) * C + (int64_t)cv * V;
}

template <typename T, int V>
__global__ void pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ p,
                                uint8_t* __restrict__ idx, int64_t n_vec,
                                int H2, int W2, int C) {
  const int64_t row = 2 * (int64_t)W2 * C;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n_vec;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t base = window_base(t, H2, W2, C, V);
    const Vec<T, V> a00 = *reinterpret_cast<const Vec<T, V>*>(x + base);
    const Vec<T, V> a01 = *reinterpret_cast<const Vec<T, V>*>(x + base + C);
    const Vec<T, V> a10 = *reinterpret_cast<const Vec<T, V>*>(x + base + row);
    const Vec<T, V> a11 =
        *reinterpret_cast<const Vec<T, V>*>(x + base + row + C);
    Vec<T, V> out;
    Codes<V> code;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float c00 = to_f(a00.v[k]), c01 = to_f(a01.v[k]);
      const float c10 = to_f(a10.v[k]), c11 = to_f(a11.v[k]);
      const float m0 = nan_max(c00, c01);
      const float m1 = nan_max(c10, c11);
      const float m = nan_max(m0, m1);
      const uint8_t i0 = c01 > c00 ? 1 : 0;
      const uint8_t i1 = c11 > c10 ? 3 : 2;
      code.v[k] = m1 > m0 ? i1 : i0;
      out.v[k] = from_f<T>(nan_max(m, 0.0f));
    }
    *reinterpret_cast<Vec<T, V>*>(p + t * V) = out;
    *reinterpret_cast<Codes<V>*>(idx + t * V) = code;
  }
}

template <typename T, int V>
__global__ void pool_bwd_kernel(const T* __restrict__ dp,
                                const uint8_t* __restrict__ idx,
                                const T* __restrict__ p, T* __restrict__ dx,
                                int64_t n_vec, int H2, int W2, int C) {
  const int64_t row = 2 * (int64_t)W2 * C;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; t < n_vec;
       t += (int64_t)gridDim.x * blockDim.x) {
    const Vec<T, V> g = *reinterpret_cast<const Vec<T, V>*>(dp + t * V);
    const Vec<T, V> pv = *reinterpret_cast<const Vec<T, V>*>(p + t * V);
    const Codes<V> code = *reinterpret_cast<const Codes<V>*>(idx + t * V);
    Vec<T, V> o00, o01, o10, o11;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float gk = to_f(pv.v[k]) > 0.0f ? to_f(g.v[k]) : 0.0f;
      const uint8_t c = code.v[k];
      o00.v[k] = from_f<T>(c == 0 ? gk : 0.0f);
      o01.v[k] = from_f<T>(c == 1 ? gk : 0.0f);
      o10.v[k] = from_f<T>(c == 2 ? gk : 0.0f);
      o11.v[k] = from_f<T>(c == 3 ? gk : 0.0f);
    }
    const int64_t base = window_base(t, H2, W2, C, V);
    *reinterpret_cast<Vec<T, V>*>(dx + base) = o00;
    *reinterpret_cast<Vec<T, V>*>(dx + base + C) = o01;
    *reinterpret_cast<Vec<T, V>*>(dx + base + row) = o10;
    *reinterpret_cast<Vec<T, V>*>(dx + base + row + C) = o11;
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // grid-stride beyond this

inline bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

inline int grid_for(int64_t n_vec) {
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : (int)blocks;
}

template <typename T, int V>
void launch_fwd(const void* x, void* p, void* idx, int B, int H, int W, int C,
                cudaStream_t s) {
  const int64_t n_vec = (int64_t)B * (H / 2) * (W / 2) * C / V;
  pool_fwd_kernel<T, V><<<grid_for(n_vec), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(p),
      static_cast<uint8_t*>(idx), n_vec, H / 2, W / 2, C);
}

template <typename T, int V>
void launch_bwd(const void* dp, const void* idx, const void* p, void* dx,
                int B, int H2, int W2, int C, cudaStream_t s) {
  const int64_t n_vec = (int64_t)B * H2 * W2 * C / V;
  pool_bwd_kernel<T, V><<<grid_for(n_vec), kThreads, 0, s>>>(
      static_cast<const T*>(dp), static_cast<const uint8_t*>(idx),
      static_cast<const T*>(p), static_cast<T*>(dx), n_vec, H2, W2, C);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int hk_pool_fwd(int dtype, const void* x, void* p, void* idx,
                           int B, int H, int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned(x, 16) && aligned(p, 16);
  if (dtype == 1) {
    if (C % 8 == 0 && al && aligned(idx, 8))
      launch_fwd<__nv_bfloat16, 8>(x, p, idx, B, H, W, C, s);
    else
      launch_fwd<__nv_bfloat16, 1>(x, p, idx, B, H, W, C, s);
  } else if (dtype == 0) {
    if (C % 4 == 0 && al && aligned(idx, 4))
      launch_fwd<float, 4>(x, p, idx, B, H, W, C, s);
    else
      launch_fwd<float, 1>(x, p, idx, B, H, W, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hk_pool_bwd(int dtype, const void* dp, const void* idx,
                           const void* p, void* dx, int B, int H2, int W2,
                           int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned(dp, 16) && aligned(p, 16) && aligned(dx, 16);
  if (dtype == 1) {
    if (C % 8 == 0 && al && aligned(idx, 8))
      launch_bwd<__nv_bfloat16, 8>(dp, idx, p, dx, B, H2, W2, C, s);
    else
      launch_bwd<__nv_bfloat16, 1>(dp, idx, p, dx, B, H2, W2, C, s);
  } else if (dtype == 0) {
    if (C % 4 == 0 && al && aligned(idx, 4))
      launch_bwd<float, 4>(dp, idx, p, dx, B, H2, W2, C, s);
    else
      launch_bwd<float, 1>(dp, idx, p, dx, B, H2, W2, C, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
