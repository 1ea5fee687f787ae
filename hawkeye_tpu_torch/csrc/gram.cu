// Per-image Gram matrix with the signed-sqrt epilogue fused in:
//   out[b, i, j] = sign(g) * sqrt(|g| + eps),  g = sum_k x[b,k,i] x[b,k,j] / HW
// x is [B, HW, C] contiguous (bf16 or f32), out is [B, C, C] float32.
//
// Replaces the TPU kernel hawkeye_tpu/ops/pallas_bilinear.py
// gram_signed_sqrt (_fwd_impl). As there, the raw Gram never reaches device
// memory: the epilogue runs in registers before the single store.
//
// Bound on Hopper: at the BCNN shape (HW = 196, C = 512, bf16) the kernel
// reads 0.2 MB of x and writes 1 MB of f32 output per image for 0.1 GFLOP,
// so device memory bounds it (the output store dominates). The design is the simple
// tiled product: one block per (image, 64x64 output tile), the HW axis walked
// in chunks of 32 rows staged in shared memory as f32, each of 256 threads
// holding a 4x4 block of f32 accumulators in registers (FMA, no tensor
// cores). Tensor cores (mma.sync / wgmma), TMA and the Gram's symmetry are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 32;    // HW rows per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_signed_sqrt_kernel(const T* __restrict__ x, float* __restrict__ out,
                        int HW, int C, float eps) {
  __shared__ __align__(16) float si[kChunk][kTile];
  __shared__ __align__(16) float sj[kChunk][kTile];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16;  // column group: j = j0 + 4 tx + s
  const int ty = threadIdx.x / 16;  // row group:    i = i0 + 4 ty + r
  const T* xb = x + (int64_t)b * HW * C;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;

  for (int k0 = 0; k0 < HW; k0 += kChunk) {
    // stage x[k0:k0+32, i0:i0+64] and x[k0:k0+32, j0:j0+64]; consecutive
    // threads read consecutive channels (coalesced)
    for (int e = threadIdx.x; e < kChunk * kTile; e += kThreads) {
      const int kk = e / kTile;
      const int cc = e % kTile;
      const int k = k0 + kk;
      const int64_t row = (int64_t)k * C;
      si[kk][cc] = (k < HW && i0 + cc < C) ? to_f(xb[row + i0 + cc]) : 0.0f;
      sj[kk][cc] = (k < HW && j0 + cc < C) ? to_f(xb[row + j0 + cc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&si[kk][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&sj[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], cv[s], acc[r][s]);
    }
    __syncthreads();
  }

  const float hw = (float)HW;
  float* ob = out + (int64_t)b * C * C;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= C) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + 4 * tx + s;
      if (j >= C) continue;
      const float g = acc[r][s] / hw;
      const float sg = g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : 0.0f);
      ob[(int64_t)i * C + j] = sg * sqrtf(fabsf(g) + eps);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int hk_gram_signed_sqrt(int dtype, const void* x, void* out, int B,
                                   int HW, int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (C + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  if (dtype == 1) {
    gram_signed_sqrt_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), HW, C,
        eps);
  } else if (dtype == 0) {
    gram_signed_sqrt_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), HW, C, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
