// Train-mode BatchNorm over the global batch of several processes: the
// per-channel sums of a rank's rows, the normalisation with the all-reduced
// statistics, and the two passes of its backward. Four kernels over the rows
// view [M, C] (M = N*H*W) of a channels-last NCHW map or of a 2-D [M, C]
// tensor, in bfloat16 or float32, with float32 sums and arithmetic:
//
//   batch_norm_stats_kernel            stats[0:C] = sum x, stats[C:2C] =
//                                      sum x^2, stats[2C] = M
//   batch_norm_apply_kernel            y = (x - mean) * (invstd * w) + b
//                                      with mean = S/n, var = max(Q/n -
//                                      mean^2, 0) (flax's fast variance),
//                                      invstd = 1/sqrt(var + eps) from the
//                                      reduced stats; also writes mean,
//                                      var, invstd
//   batch_norm_backward_reduce_kernel  sums[0:C] = sum dy, sums[C:2C] =
//                                      sum dy * (x - mean) * invstd, each
//                                      written a second time as the rank's
//                                      dbias and dweight
//   batch_norm_backward_apply_kernel   dx = w * invstd * (dy - G0/n
//                                      - (x - mean) * invstd * G1/n), G the
//                                      all-reduced sums, n the global count
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses the statistics and the normalisation of its cross-replica
// BatchNorm by itself. The port's composite (float32 copies of x, a dozen
// pointwise and reduction kernels each way, and autograd's float32
// intermediates) moved some 70 bytes an element; these move the 16 a bf16
// element needs: the forward reads x twice and writes y, the backward reads
// x and dy twice and writes dx.
//
// Bound on Hopper: device-memory bytes (a handful of float32 operations an
// element). So every pass reads each element once, 16 bytes a thread
// (8 bf16 or 4 float32 channels) with neighbouring threads on neighbouring
// channels, four rows in flight a thread; a block is 512 threads, `tx`
// vectors of channels wide (a power of two up to 64) and 512 / tx rows
// tall, and the grid is channel tiles x row chunks, enough blocks to fill
// the 132 SMs even for a 64-channel map (one tile).
//
// The two reductions finish without a second launch and deterministically:
// each block sums its rows in a fixed order and writes its partial sums to
// a scratch [chunks, 2C]; the last block of a channel tile to arrive
// (counted by an atomic on a per-tile counter) adds the partials in chunk
// order and writes the totals, then sets the counter back to 0, so the
// counters need no reset between launches on one stream. The results do
// not depend on the order the blocks ran in.
//
// The wrapper (ops/batch_norm.py) allocates every output and the scratch,
// passes the counters (zeroed once, kept per device and stream), and checks
// dtype and layout. Vector loads need C % V == 0 and 16-byte aligned
// pointers; otherwise each thread takes one channel (V = 1).

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
  return __float2bfloat16(v);  // round to nearest even
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// The pointwise arithmetic rounds after every operation, in the plain
// versions' order, with no fused multiply-add: (x - mean) * scale + bias and
// a * ((dy - k1) - (x - mean) * k2), as PyTorch's separate kernels compute
// them, so the kernels and the plain versions agree bit for bit given the
// same statistics.
__device__ __forceinline__ float normalise(float x, float mean, float scale,
                                          float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), bias);
}

__device__ __forceinline__ float grad_input(float dy, float x, float mean,
                                            float a, float k1, float k2) {
  return __fmul_rn(a, __fsub_rn(__fsub_rn(dy, k1), __fmul_rn(__fsub_rn(x, mean), k2)));
}

constexpr int kThreads = 512;
constexpr int kMaxTx = 64;             // vectors of channels a block spans
constexpr int kReduceBlocks = 2 * 132; // two blocks of 512 threads an SM
constexpr int kApplyBlocks = 4 * 132;
constexpr int kUnroll = 4;             // rows in flight a thread

// Where the totals of a reduction go.
struct Totals {
  float* out0;           // [C] sum of the first quantity
  float* out1;           // [C] sum of the second
  float* copy0;          // nullable: a second copy of out0
  float* copy1;          // nullable: a second copy of out1
  const float* scale1;   // nullable: out1[c] multiplied by scale1[c]
  float* count;          // nullable: M goes here
};

// Per-channel sums over the block's chunk of rows of (x, x^2) or, with
// kGrad, of (dy, dy * (x - mean)); then the last block of the tile finishes.
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void channel_sums(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mean, int64_t M, int C, int tx, int ty,
    int64_t rows_per_chunk, float* __restrict__ partial,
    unsigned int* __restrict__ arrived, Totals out) {
  __shared__ float red[kThreads * 2 * V];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int vx = tid % tx, vy = tid / tx;
  const int tile = blockIdx.x, chunk = blockIdx.y, chunks = gridDim.y;
  const int c0 = (tile * tx + vx) * V;
  const bool live = c0 < C;

  float s0[V], s1[V], mu[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s0[k] = 0.0f;
    s1[k] = 0.0f;
    if constexpr (kGrad) mu[k] = live ? mean[c0 + k] : 0.0f;
    else mu[k] = 0.0f;
  }
  const int64_t r_begin = chunk * rows_per_chunk;
  const int64_t r_end = r_begin + rows_per_chunk < M ? r_begin + rows_per_chunk : M;
  if (live) {
    int64_t r = r_begin + vy;
    for (; r + (kUnroll - 1) * (int64_t)ty < r_end; r += kUnroll * (int64_t)ty) {
      Vec<T, V> va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t off = (r + u * (int64_t)ty) * C + c0;
        va[u] = load<T, V>(a + off);
        if constexpr (kGrad) vb[u] = load<T, V>(b + off);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float p = to_f(va[u].v[k]);
          s0[k] += p;
          if constexpr (kGrad) s1[k] += p * (to_f(vb[u].v[k]) - mu[k]);
          else s1[k] += p * p;
        }
    }
    for (; r < r_end; r += ty) {
      const int64_t off = r * C + c0;
      const Vec<T, V> va = load<T, V>(a + off);
      Vec<T, V> vb;
      if constexpr (kGrad) vb = load<T, V>(b + off);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float p = to_f(va.v[k]);
        s0[k] += p;
        if constexpr (kGrad) s1[k] += p * (to_f(vb.v[k]) - mu[k]);
        else s1[k] += p * p;
      }
    }
  }

  // the block's rows: a tree over vy in shared memory, in a fixed order
  float* mine = red + tid * 2 * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mine[k] = s0[k];
    mine[V + k] = s1[k];
  }
  for (int h = ty / 2; h >= 1; h /= 2) {
    __syncthreads();
    if (vy < h) {
      const float* other = red + (tid + h * tx) * 2 * V;
#pragma unroll
      for (int k = 0; k < 2 * V; ++k) mine[k] += other[k];
    }
  }
  __syncthreads();
  if (vy == 0 && live) {
    float* p = partial + (int64_t)chunk * 2 * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      p[c0 + k] = mine[k];
      p[C + c0 + k] = mine[V + k];
    }
    __threadfence();  // the partials before the ticket
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&arrived[tile], 1u) == (unsigned int)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of the tile: the chunks' partials in chunk order. Value
  // j of the tile is channel tile_c0 + j % n_ch of sum j / n_ch. A pass
  // covers `per` values; with fewer values than threads, `groups` threads
  // share a value over strided chunks and then add their sums in order.
  const int tile_c0 = tile * tx * V;
  const int n_ch = C - tile_c0 < tx * V ? C - tile_c0 : tx * V;
  const int nval = 2 * n_ch;
  const int per = nval < kThreads ? nval : kThreads;
  const int groups = kThreads / per;
  const int64_t stride = 2 * (int64_t)C;
  for (int j0 = 0; j0 < nval; j0 += per) {
    const int q = tid / per, j = j0 + tid % per;
    float acc = 0.0f;
    if (q < groups && j < nval) {
      const float* src = partial + (j / n_ch) * C + tile_c0 + j % n_ch;
      int g = q;
      for (; g + 3 * groups < chunks; g += 4 * groups) {
        const float v0 = __ldcg(src + g * stride);
        const float v1 = __ldcg(src + (g + groups) * stride);
        const float v2 = __ldcg(src + (g + 2 * groups) * stride);
        const float v3 = __ldcg(src + (g + 3 * groups) * stride);
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
      }
      for (; g < chunks; g += groups) acc += __ldcg(src + g * stride);
    }
    if (groups > 1) {  // one pass: nval < kThreads
      __syncthreads();  // red is reused
      red[tid] = acc;
      __syncthreads();
      acc = 0.0f;
      if (tid < per)
        for (int k = 0; k < groups; ++k) acc += red[k * per + tid];
    }
    const int jj = j0 + tid;
    if (tid < per && jj < nval) {
      const int c = tile_c0 + jj % n_ch;
      if (jj < n_ch) {
        out.out0[c] = acc;
        if (out.copy0) out.copy0[c] = acc;
      } else {
        if (out.scale1) acc *= out.scale1[c];
        out.out1[c] = acc;
        if (out.copy1) out.copy1[c] = acc;
      }
    }
  }
  if (tid == 0) {
    if (out.count && tile == 0) *out.count = (float)M;
    arrived[tile] = 0u;  // ready for the next launch on this stream
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_stats_kernel(const T* __restrict__ x, int64_t M, int C, int tx,
                        int ty, int64_t rows_per_chunk, float* __restrict__ stats,
                        float* __restrict__ partial,
                        unsigned int* __restrict__ arrived) {
  channel_sums<T, V, false>(x, nullptr, nullptr, M, C, tx, ty, rows_per_chunk,
                            partial, arrived,
                            Totals{stats, stats + C, nullptr, nullptr, nullptr,
                                   stats + 2 * C});
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_backward_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    int64_t M, int C, int tx, int ty, int64_t rows_per_chunk,
    float* __restrict__ sums, float* __restrict__ dweight,
    float* __restrict__ dbias, float* __restrict__ partial,
    unsigned int* __restrict__ arrived) {
  channel_sums<T, V, true>(dy, x, mean, M, C, tx, ty, rows_per_chunk, partial,
                           arrived,
                           Totals{sums, sums + C, dbias, dweight, invstd, nullptr});
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                        const float* __restrict__ weight,
                        const float* __restrict__ bias, float eps, int64_t M,
                        int C, int tx, int ty, int64_t rows_per_chunk,
                        T* __restrict__ y, float* __restrict__ mean_out,
                        float* __restrict__ var_out,
                        float* __restrict__ invstd_out) {
  const int tid = threadIdx.x;
  const int vx = tid % tx, vy = tid / tx;
  const int c0 = (blockIdx.x * tx + vx) * V;
  if (c0 >= C) return;
  const float n = stats[2 * C];
  float mu[V], sc[V], sh[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = c0 + k;
    const float mean = stats[c] / n;
    const float var = fmaxf(__fsub_rn(stats[C + c] / n, __fmul_rn(mean, mean)), 0.0f);
    const float inv = 1.0f / sqrtf(__fadd_rn(var, eps));
    mu[k] = mean;
    sc[k] = __fmul_rn(inv, weight[c]);
    sh[k] = bias[c];
    if (blockIdx.y == 0 && vy == 0) {
      mean_out[c] = mean;
      var_out[c] = var;
      invstd_out[c] = inv;
    }
  }
  const int64_t r_begin = blockIdx.y * rows_per_chunk;
  const int64_t r_end = r_begin + rows_per_chunk < M ? r_begin + rows_per_chunk : M;
  int64_t r = r_begin + vy;
  for (; r + (kUnroll - 1) * (int64_t)ty < r_end; r += kUnroll * (int64_t)ty) {
    Vec<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load<T, V>(x + (r + u * (int64_t)ty) * C + c0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Vec<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = from_f<T>(normalise(to_f(v[u].v[k]), mu[k], sc[k], sh[k]));
      *reinterpret_cast<Vec<T, V>*>(y + (r + u * (int64_t)ty) * C + c0) = o;
    }
  }
  for (; r < r_end; r += ty) {
    const Vec<T, V> v = load<T, V>(x + r * C + c0);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) o.v[k] = from_f<T>(normalise(to_f(v.v[k]), mu[k], sc[k], sh[k]));
    *reinterpret_cast<Vec<T, V>*>(y + r * C + c0) = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
batch_norm_backward_apply_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, const float* __restrict__ invstd,
    const float* __restrict__ weight, const float* __restrict__ sums,
    const float* __restrict__ count, int64_t M, int C, int tx, int ty,
    int64_t rows_per_chunk, T* __restrict__ dx) {
  const int tid = threadIdx.x;
  const int vx = tid % tx, vy = tid / tx;
  const int c0 = (blockIdx.x * tx + vx) * V;
  if (c0 >= C) return;
  const float n = count[0];
  float mu[V], a[V], k1[V], k2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = c0 + k;
    const float inv = invstd[c];
    mu[k] = mean[c];
    a[k] = __fmul_rn(weight[c], inv);
    k1[k] = sums[c] / n;
    k2[k] = __fmul_rn(inv, sums[C + c] / n);
  }
  const int64_t r_begin = blockIdx.y * rows_per_chunk;
  const int64_t r_end = r_begin + rows_per_chunk < M ? r_begin + rows_per_chunk : M;
  int64_t r = r_begin + vy;
  for (; r + (kUnroll - 1) * (int64_t)ty < r_end; r += kUnroll * (int64_t)ty) {
    Vec<T, V> g[kUnroll], v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t off = (r + u * (int64_t)ty) * C + c0;
      g[u] = load<T, V>(dy + off);
      v[u] = load<T, V>(x + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Vec<T, V> o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = from_f<T>(grad_input(to_f(g[u].v[k]), to_f(v[u].v[k]), mu[k], a[k],
                                      k1[k], k2[k]));
      *reinterpret_cast<Vec<T, V>*>(dx + (r + u * (int64_t)ty) * C + c0) = o;
    }
  }
  for (; r < r_end; r += ty) {
    const int64_t off = r * C + c0;
    const Vec<T, V> g = load<T, V>(dy + off);
    const Vec<T, V> v = load<T, V>(x + off);
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k)
      o.v[k] = from_f<T>(grad_input(to_f(g.v[k]), to_f(v.v[k]), mu[k], a[k], k1[k], k2[k]));
    *reinterpret_cast<Vec<T, V>*>(dx + off) = o;
  }
}

// The block shape and grid for [M, C] rows at vector width V.
struct Geometry {
  int tx, ty, tiles, chunks;
  int64_t rows_per_chunk;
};

Geometry geometry(int64_t M, int C, int V, int target_blocks) {
  Geometry g;
  const int nv = C / V;
  g.tx = 1;
  while (g.tx < nv && g.tx < kMaxTx) g.tx *= 2;
  g.ty = kThreads / g.tx;
  g.tiles = (nv + g.tx - 1) / g.tx;
  int64_t chunks = target_blocks / g.tiles;
  const int64_t most = (M + g.ty - 1) / g.ty;  // a row for each thread row
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  g.chunks = (int)chunks;
  g.rows_per_chunk = (M + chunks - 1) / chunks;
  return g;
}

inline bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The vector width for dtype (0 float32, 1 bfloat16): 16 bytes where C and
// every pointer allow, else 1; 0 for an unknown dtype.
inline int vector_width(int dtype, int C, const void* p0, const void* p1,
                        const void* p2) {
  const int v = dtype == 1 ? 8 : (dtype == 0 ? 4 : 0);
  if (v == 0) return 0;
  return (C % v == 0 && aligned(p0) && aligned(p1) && aligned(p2)) ? v : 1;
}

template <typename T, int V>
struct Kind {
  using type = T;
  static constexpr int width = V;
};

// Call launch(Kind<T, V>{}) for the dtype and width; the launch's error.
template <typename F>
int dispatch(int dtype, int v, F&& launch) {
  if (dtype == 1 && v == 8) launch(Kind<__nv_bfloat16, 8>{});
  else if (dtype == 1 && v == 1) launch(Kind<__nv_bfloat16, 1>{});
  else if (dtype == 0 && v == 4) launch(Kind<float, 4>{});
  else if (dtype == 0 && v == 1) launch(Kind<float, 1>{});
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The scratch and counters a reduction needs must fit what the wrapper gave.
inline bool fits(const Geometry& g, int C, int64_t partial_floats, int n_arrived) {
  return (int64_t)g.chunks * 2 * C <= partial_floats && g.tiles <= n_arrived;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int hk_batch_norm_stats(int dtype, const void* x, int64_t M, int C,
                                   void* stats, void* partial,
                                   int64_t partial_floats, void* arrived,
                                   int n_arrived, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vector_width(dtype, C, x, nullptr, nullptr);
  if (v == 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(M, C, v, kReduceBlocks);
  if (!fits(g, C, partial_floats, n_arrived)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, v, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int V = decltype(kind)::width;
    batch_norm_stats_kernel<T, V><<<dim3(g.tiles, g.chunks), kThreads, 0, s>>>(
        static_cast<const T*>(x), M, C, g.tx, g.ty, g.rows_per_chunk,
        static_cast<float*>(stats), static_cast<float*>(partial),
        static_cast<unsigned int*>(arrived));
  });
}

extern "C" int hk_batch_norm_apply(int dtype, const void* x, const void* stats,
                                   const void* weight, const void* bias,
                                   float eps, void* y, void* mean, void* var,
                                   void* invstd, int64_t M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vector_width(dtype, C, x, y, nullptr);
  if (v == 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(M, C, v, kApplyBlocks);
  return dispatch(dtype, v, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int V = decltype(kind)::width;
    batch_norm_apply_kernel<T, V><<<dim3(g.tiles, g.chunks), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(stats),
        static_cast<const float*>(weight), static_cast<const float*>(bias), eps,
        M, C, g.tx, g.ty, g.rows_per_chunk, static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(var),
        static_cast<float*>(invstd));
  });
}

extern "C" int hk_batch_norm_backward_reduce(
    int dtype, const void* dy, const void* x, const void* mean,
    const void* invstd, int64_t M, int C, void* sums, void* dweight,
    void* dbias, void* partial, int64_t partial_floats, void* arrived,
    int n_arrived, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vector_width(dtype, C, dy, x, nullptr);
  if (v == 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(M, C, v, kReduceBlocks);
  if (!fits(g, C, partial_floats, n_arrived)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, v, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int V = decltype(kind)::width;
    batch_norm_backward_reduce_kernel<T, V>
        <<<dim3(g.tiles, g.chunks), kThreads, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const float*>(mean), static_cast<const float*>(invstd),
            M, C, g.tx, g.ty, g.rows_per_chunk, static_cast<float*>(sums),
            static_cast<float*>(dweight), static_cast<float*>(dbias),
            static_cast<float*>(partial), static_cast<unsigned int*>(arrived));
  });
}

extern "C" int hk_batch_norm_backward_apply(
    int dtype, const void* dy, const void* x, const void* mean,
    const void* invstd, const void* weight, const void* sums,
    const void* count, void* dx, int64_t M, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = vector_width(dtype, C, dy, x, dx);
  if (v == 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(M, C, v, kApplyBlocks);
  return dispatch(dtype, v, [&](auto kind) {
    using T = typename decltype(kind)::type;
    constexpr int V = decltype(kind)::width;
    batch_norm_backward_apply_kernel<T, V>
        <<<dim3(g.tiles, g.chunks), kThreads, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const float*>(mean), static_cast<const float*>(invstd),
            static_cast<const float*>(weight), static_cast<const float*>(sums),
            static_cast<const float*>(count), M, C, g.tx, g.ty,
            g.rows_per_chunk, static_cast<T*>(dx));
  });
}
