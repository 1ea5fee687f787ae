// Per-image Gram matrix with the signed-sqrt epilogue fused in:
//   out[b, i, j] = sign(g) * sqrt(|g| + eps),  g = sum_k x[b,k,i] x[b,k,j] / HW
// x is [B, HW, C] contiguous (bf16 or f32), out is [B, C, C] float32.
//
// Replaces the TPU kernel hawkeye_tpu/ops/pallas_bilinear.py
// gram_signed_sqrt (_fwd_impl). As there, the raw Gram never reaches device
// memory: the epilogue runs in registers before the single store.
//
// Bound on Hopper: the float32 store. At the BCNN shape (HW = 196, C = 512,
// bf16) an image reads 0.2 MB of x and writes 1 MB of output, so the store
// is 84% of the bytes; the 0.1 GFLOP per image take a quarter of the bytes'
// time on the bf16 tensor cores. So the product runs on the tensor cores,
// out of the store's way, and the store has to run at the HBM rate.
//
// bfloat16 (the main path), gram_signed_sqrt_bf16_wgmma: a persistent
// kernel, as many blocks as fit on the card, each walking 128x128 output
// tiles (image-major, so the tiles in flight share a few images' x in L2).
// A block is one producer warp and two consumer warpgroups of 64 rows each.
// - Operands by TMA: one 3-D tensor map over x, boxes of 32 HW rows x 64
//   channels (128 bytes) with the 128-byte swizzle. A stage holds four boxes
//   (A rows i0.., i0+64.., B columns j0.., j0+64..); a ring of 8 stages is
//   guarded by mbarriers ("full": the TMA bytes arrived; "empty": both
//   warpgroups' products on the stage are done). The producer streams every
//   (tile, chunk) of the block through the ring, across tile boundaries, so
//   the next tile's operands arrive during this tile's epilogue. 8 stages
//   keep 128 KB of loads in flight per SM, which the L2's latency needs
//   (``python -m hawkeye_tpu_torch.gram_variants base stages4 stages6``
//   times shallower rings). TMA zero-fills rows past HW and channels past
//   C, so K pads to the chunk and a ragged C needs no branch.
// - Products by wgmma m64n128k16 from shared memory, f32 accumulators in
//   registers. The channel axis is the contiguous one in x, so both A =
//   X^T[i-tile] and B = X[j-tile] are MN-major: the transpose immediates are
//   set, and the descriptors describe the swizzled TMA boxes (SBO = 8 rows of
//   128 bytes, LBO = the distance between B's two 64-channel boxes).
// - The epilogue: g = acc / HW as a multiply by 1/HW and the hardware square
//   root (relative error below 2^-22); with the IEEE division and square
//   root (the ``ieee`` variant) the 64 outputs a thread cost far more time.
// - The store: each warpgroup writes its 64x128 f32 tile to its own 32 KB of
//   staging, in the 128-byte-swizzled order that a TMA store reads (two
//   passes of shared memory, no bank conflicts), and one thread writes it
//   out as four 64x32 TMA stores, which clip at C's edge. The store drains
//   while the warpgroup computes its next tile; the staging is written again
//   only after the store has read it.
// - TMA needs a row pitch of a multiple of 16 bytes: C % 8 == 0. The wrapper
//   raises otherwise; there is no fallback.
//
// float32 (only the float32 card-vs-CPU reference), gram_signed_sqrt_f32_fma:
// the simple tiled product on the FMA units, one block per (image, 64x64
// tile), HW walked in 32-row stages, IEEE epilogue. TF32 tensor cores keep
// about three decimal digits, which would break that reference's 1e-4
// tolerance, and float32 is not on the main path.
//
// The Gram's symmetry is left out on purpose. It saves none of the store,
// which is 84% of the bytes. It would save 3/8 of the operand reads and of
// the tensor work, but the operand side does not set the pace alone: the
// kernel without its stores and the kernel without its operand loads each
// take most of the full kernel's time (the ``nostore`` and ``noload``
// variants of gram_variants), so the two share the L2 and removing 3/8 of
// one side gains far less than 3/8. It would cost a second, transposed
// store per off-diagonal tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float signed_sqrt(float acc, float hw, float eps) {
  const float g = acc / hw;
  const float sg = g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : 0.0f);
  return sg * sqrtf(fabsf(g) + eps);
}

// the same with g = acc * (1 / HW) and the hardware square root (relative
// error below 2^-22): a handful of instructions where the IEEE division and
// square root take dozens, which at 64 outputs a thread cost as much time as
// the store. The sign is copied bitwise; g == 0 gives 0, as sign(0) = 0.
__device__ __forceinline__ float signed_sqrt_fast(float acc, float inv_hw,
                                                  float eps) {
  const float g = acc * inv_hw;
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(fabsf(g) + eps));
  return g == 0.0f ? 0.0f : copysignf(r, g);
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------
constexpr int kFmaTile = 64;     // output tile edge
constexpr int kFmaChunk = 32;    // HW rows per shared-memory stage
constexpr int kFmaThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFmaThreads)
gram_signed_sqrt_f32_fma(const float* __restrict__ x, float* __restrict__ out,
                         int HW, int C, float eps) {
  __shared__ __align__(16) float si[kFmaChunk][kFmaTile];
  __shared__ __align__(16) float sj[kFmaChunk][kFmaTile];

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kFmaTile;
  const int j0 = blockIdx.x * kFmaTile;
  const int tx = threadIdx.x % 16;  // column group: j = j0 + 4 tx + s
  const int ty = threadIdx.x / 16;  // row group:    i = i0 + 4 ty + r
  const float* xb = x + (int64_t)b * HW * C;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;

  for (int k0 = 0; k0 < HW; k0 += kFmaChunk) {
    // stage x[k0:k0+32, i0:i0+64] and x[k0:k0+32, j0:j0+64]; consecutive
    // threads read consecutive channels (coalesced)
    for (int e = threadIdx.x; e < kFmaChunk * kFmaTile; e += kFmaThreads) {
      const int kk = e / kFmaTile;
      const int cc = e % kFmaTile;
      const int k = k0 + kk;
      const int64_t row = (int64_t)k * C;
      si[kk][cc] = (k < HW && i0 + cc < C) ? xb[row + i0 + cc] : 0.0f;
      sj[kk][cc] = (k < HW && j0 + cc < C) ? xb[row + j0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFmaChunk; ++kk) {
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
      ob[(int64_t)i * C + j] = signed_sqrt(acc[r][s], hw, eps);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma
// ---------------------------------------------------------------------------
constexpr int kTile = 128;                       // output tile edge
constexpr int kHalf = 64;                        // channels per TMA box = rows per warpgroup
constexpr int kChunk = 32;                       // HW rows per ring stage
constexpr int kStages = 8;
constexpr int kConsumers = 256;                  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;        // and one producer warp
constexpr int kBoxBytes = kChunk * kHalf * 2;    // 4 KB
constexpr int kStageBytes = 4 * kBoxBytes;       // A0 A1 B0 B1: 16 KB
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kOutCols = 32;                     // f32 columns per TMA store box (128 bytes)
constexpr int kOutBoxBytes = kHalf * kOutCols * 4;  // 8 KB
constexpr int kOutBoxes = kTile / kOutCols;      // 4 per warpgroup
constexpr int kStagingBytes = 2 * kOutBoxes * kOutBoxBytes;  // 64 KB
constexpr int kSmemBytes = 1024 + kRingBytes + kStagingBytes + 2 * kStages * 8;
static_assert(kChunk % 16 == 0, "wgmma takes K in steps of 16");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the completion of the barrier's phase of this parity; a wait
// that lasts 2 s (a fault in the pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t start, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - start > 2000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of an MN-major operand in TMA's 128-byte
// swizzle: rows of 128 bytes (64 bf16 along M or N), 8-row groups 1024 bytes
// apart (SBO), 64-wide groups along M or N ``lbo`` bytes apart (LBO)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = A[64 x 16] B[16 x 128] (+ d if accumulate), both operands
// MN-major in shared memory (transpose immediates 1, 1)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
gram_signed_sqrt_bf16_wgmma(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap omap, int B,
                            int HW, int C, float eps) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring_s = (raw_s + 1023) & ~1023u;
  uint8_t* ring = smem_raw + (ring_s - raw_s);
  uint8_t* staging = ring + kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStagingBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int tiles = (C + kTile - 1) / kTile;
  const int ntiles = B * tiles * tiles;
  const int nchunks = (HW + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warp: one thread streams every (tile, chunk) of this block
    // through the ring, as far ahead as the ring allows
    if (tid != kConsumers) return;
    int n = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = t / (tiles * tiles);
      const int i0 = (t / tiles) % tiles * kTile;
      const int j0 = t % tiles * kTile;
      for (int c = 0; c < nchunks; ++c, ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(smem_u32(&empty[s]), (n / kStages - 1) & 1);
        const uint32_t st = ring_s + s * kStageBytes;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, kStageBytes);
        tma_load(st, &xmap, bar, i0, c * kChunk, b);
        tma_load(st + kBoxBytes, &xmap, bar, i0 + kHalf, c * kChunk, b);
        tma_load(st + 2 * kBoxBytes, &xmap, bar, j0, c * kChunk, b);
        tma_load(st + 3 * kBoxBytes, &xmap, bar, j0 + kHalf, c * kChunk, b);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const bool leader = tid % 128 == 0;
  uint8_t* stage_out = staging + wg * kOutBoxes * kOutBoxBytes;
  const float inv_hw = 1.0f / (float)HW;
  const int lane = tid % 32;
  const int warp = (tid % 128) / 32;
  // no zero-fill: each tile's first wgmma overwrites (a non-wgmma write to
  // the accumulators would serialise the wgmmas)
  float acc[64];
  int n = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles * tiles);
    const int i0 = (t / tiles) % tiles * kTile;
    const int j0 = t % tiles * kTile;
    for (int c = 0; c < nchunks; ++c, ++n) {
      const int s = n % kStages;
      mbar_wait(smem_u32(&full[s]), (n / kStages) & 1);
      const uint32_t a = ring_s + s * kStageBytes + wg * kBoxBytes;
      const uint32_t bb = ring_s + s * kStageBytes + 2 * kBoxBytes;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
        // 16 HW rows further down both operands: 16 rows of 128 bytes
        wgmma_m64n128k16(acc, sw128_desc(a + k * 2048, kBoxBytes),
                         sw128_desc(bb + k * 2048, kBoxBytes), c > 0 || k > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // keep this chunk's products in flight; release the previous chunk's
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (c > 0 && leader) mbar_arrive(smem_u32(&empty[(n - 1) % kStages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(acc);
    if (leader) {
      mbar_arrive(smem_u32(&empty[(n - 1) % kStages]));
      // the previous tile's store must have read the staging
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");

    // epilogue: signed sqrt in registers, then the warpgroup's 64x128 tile
    // as four 64x32 boxes in the TMA store's 128-byte swizzle. Accumulator
    // acc[4q + 2h + e] of lane l in warp w holds row 16w + 8h + l/4 and
    // column 8q + 2(l%4) + e of the warpgroup's tile.
#pragma unroll
    for (int q = 0; q < 16; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + 8 * h + lane / 4;
        const int col = 8 * q + 2 * (lane & 3);
        const int chunk16 = (col % kOutCols) / 4;  // 16-byte unit in the row
        float2 v;
        v.x = signed_sqrt_fast(acc[4 * q + 2 * h], inv_hw, eps);
        v.y = signed_sqrt_fast(acc[4 * q + 2 * h + 1], inv_hw, eps);
        *reinterpret_cast<float2*>(stage_out + (col / kOutCols) * kOutBoxBytes +
                                   r * 128 + ((chunk16 ^ (r & 7)) * 16) +
                                   (col % 4) * 4) = v;
      }
    }
    // make the generic-proxy writes visible to the TMA (async proxy), then
    // wait for the warpgroup's 128 threads; the store runs on while the
    // warpgroup computes its next tile
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (leader) {
      const int row0 = i0 + wg * kHalf;
      if (row0 < C) {
        for (int bx = 0; bx < kOutBoxes; ++bx) {
          const int col0 = j0 + bx * kOutCols;
          if (col0 < C)
            tma_store(&omap, smem_u32(stage_out + bx * kOutBoxBytes), col0, row0, b);
        }
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  // shared memory must stay valid until the TMA has read it
  if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 3-D map over a [B, rows, cols] row-major tensor with the 128-byte swizzle
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
               const void* ptr, int B, int rows, int cols, int box_cols,
               int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* x, void* out, int B, int HW, int C, float eps,
                cudaStream_t s) {
  if (B <= 0 || HW <= 0 || C <= 0 || C % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap xmap, omap;
  if (!encode_3d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, HW, C,
                 kHalf, kChunk) ||
      !encode_3d(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, B, C, C,
                 kOutCols, kHalf))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory, and the persistent grid: as many
  // blocks as fit on the card at once; once per device, outside any graph
  // capture that follows
  static int grid_of[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int grid = dev < 64 ? grid_of[dev] : 0;
  if (grid == 0) {
    e = cudaFuncSetAttribute(gram_signed_sqrt_bf16_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gram_signed_sqrt_bf16_wgmma, kThreads, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = sms * per_sm;
    if (dev < 64) grid_of[dev] = grid;
  }
  const int tiles = (C + kTile - 1) / kTile;
  const long long ntiles = (long long)B * tiles * tiles;
  if (ntiles < grid) grid = (int)ntiles;
  gram_signed_sqrt_bf16_wgmma<<<grid, kThreads, kSmemBytes, s>>>(
      xmap, omap, B, HW, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (TMA + wgmma kernel, needs
// C % 8 == 0 and 16-byte aligned pointers). One launch per call. Returns a
// cudaError_t code: cudaGetLastError() after the launch, or the reason it
// was refused.
extern "C" int hk_gram_signed_sqrt(int dtype, const void* x, void* out, int B,
                                   int HW, int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(x, out, B, HW, C, eps, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int tiles = (C + kFmaTile - 1) / kFmaTile;
  gram_signed_sqrt_f32_fma<<<dim3(tiles, tiles, B), kFmaThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out), HW, C, eps);
  return (int)cudaGetLastError();
}
