// Shared helpers of the port's CUDA kernels.
//
// bf16 path (sm_90a): TMA tensor copies with mbarriers (windows zero-filled
// outside the image, weights, output tiles), a 128-byte swizzled pixel-row
// layout, ldmatrix A fragments, and wgmma products with f32 accumulators
// that the kernels' epilogues use in place (no shared-memory round trip).
//
// f32 path (the parity path, plain FMA, never TF32): a 16x64 warp
// accumulator tile and cooperative NHWC window loads.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (no driver library linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unetdc {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (shared::cta): TMA copies complete their transaction bytes on
// one; threads wait on a phase parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// TMA tensor copies (one thread issues; tiled mode, out-of-bounds boxes
// zero-filled on load and clipped on store).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The committed stores have read their shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Host: a bf16 tensor map with 128-byte swizzle (the layout `swz` names, on
// 1024-byte aligned shared buffers). cuTensorMapEncodeTiled is a driver
// function; it is reached through the runtime's entry-point query, so the
// library needs no link against the driver.
inline cudaError_t encode_map(CUtensorMap* m, const void* base, int rank,
                              const cuuint64_t* dims,
                              const cuuint64_t* strides,
                              const cuuint32_t* box) {
  using Fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                          void*, const cuuint64_t*, const cuuint64_t*,
                          const cuuint32_t*, const cuuint32_t*,
                          CUtensorMapInterleave, CUtensorMapSwizzle,
                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Fn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    fn = reinterpret_cast<Fn>(p);
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
         const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
// NHWC (B, H, W, C) bf16, boxes of 64 channels x bw x bh pixels.
inline cudaError_t nhwc_map(CUtensorMap* m, const void* p, int B, int H, int W,
                            int C, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return encode_map(m, p, 4, dims, strides, box);
}
// Weight rows of 64 bf16 (rows x 64 row-major), boxes of 64 rows.
inline cudaError_t rows_map(CUtensorMap* m, const void* p, int rows) {
  const cuuint64_t dims[2] = {64, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {128};
  const cuuint32_t box[2] = {64, 64};
  return encode_map(m, p, 2, dims, strides, box);
}

// Swizzled pixel-row layout (TMA's 128-byte swizzle on a 1024-byte aligned
// buffer): pixel (or weight row) p of 128 bytes keeps its 16-byte chunk c at
// p * 128 + ((c ^ (p & 7)) << 4), so the 8 rows an ldmatrix phase reads from
// 8 consecutive pixels hit 8 distinct bank groups at any pixel offset.
__device__ __forceinline__ uint32_t swz(int p, int c) {
  return (uint32_t)(p * 128 + ((c ^ (p & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// Warpgroup products (wgmma, sm_90a) with A from registers (each warp's
// m16k16 fragment as ldmatrix.x4 returns it: a warp names its own pixel
// rows, so an m64 tile is any four m16 tiles) and B from shared memory
// through a descriptor: a 64-column (128-byte) weight block, rows k, in the
// `swz` layout (1024-byte aligned), N contiguous ("MN-major", transposed
// B), 8-row groups 1024 bytes apart. A start address inside the 128-byte
// row selects columns (n32 halves).
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator registers across async
// products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Make this thread's generic-proxy shared writes (st.shared) visible to the
// async proxy (TMA stores, wgmma descriptor reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64 f32; per warp 16 rows, d[4 j + e] for n8 tile j: e = 0, 1 at
// row lane / 4, columns 8 j + 2 (lane % 4) + e; e = 2, 3 eight rows down)
// += A (64 x 16 bf16, registers) * B (16 x 64 bf16, descriptor).
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// The same with N = 32 (d[4 j + e] for 4 n8 tiles).
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// A fragment address: an A tile (16 pixels x 16 channels) of a swizzled
// pixel region; lane l names pixel `pix` = the tile's row l & 15, and reads
// the k16 step `ks` (chunk 2 ks + l / 16).
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int pix, int ks,
                                           int lane) {
  return base + swz(pix, 2 * ks + (lane >> 4));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Number of SMs of the current device (cached).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// ----------------------------------------------------------------- f32 --

// Shared-memory pixel stride (floats) for C channels: 32-byte aligned rows,
// padded off the 128-byte bank period.
__host__ __device__ constexpr int ld_f32(int c) { return c + 8; }

__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A warp's 16 x 64 f32 accumulator: C += A (16 x 16) * B (16 x 64), A and B
// row-major, plain FMA (never TF32). Lane l owns row l/2, columns
// 8*(l&1) .. +8 of each 16-wide block n.
struct TileF32 {
  float c[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[n][j] = 0.0f;
  }
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b,
                                      int ldb) {
    const int lane = threadIdx.x & 31;
    const float* ar = a + (lane >> 1) * lda;
    const float* bc = b + (lane & 1) * 8;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = ar[k];
      const float* bk = bc + k * ldb;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) c[n][j] = fmaf(av, bk[16 * n + j], c[n][j]);
    }
  }
};

// Copy the rows x cols pixel window at global (gy0, gx0) of one NHWC f32
// image (H x W x C) into shared memory at channel offset c_off (pixel
// p = r * cols + c at s + p * ld), zero outside the image.
template <int C>
__device__ __forceinline__ void load_window_f32(float* s, int ld, int c_off,
                                                const float* __restrict__ img,
                                                int H, int W, int gy0, int gx0,
                                                int rows, int cols) {
  constexpr int NV = C / 4;
  const int total = rows * cols * NV;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % NV;
    const int p = i / NV;
    const int r = p / cols, c = p - (p / cols) * cols;
    const int gy = gy0 + r, gx = gx0 + c;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = __ldg(reinterpret_cast<const float4*>(
          img + ((size_t)gy * W + gx) * C + v * 4));
    *reinterpret_cast<float4*>(s + (size_t)p * ld + c_off + v * 4) = val;
  }
}

// Zero channels [0, C) of shared-memory pixels [p0, p1).
template <int C>
__device__ __forceinline__ void zero_pixels_f32(float* s, int ld, int p0,
                                                int p1) {
  constexpr int NV = C / 4;
  const int total = (p1 - p0) * NV;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = p0 + i / NV, v = i % NV;
    *reinterpret_cast<float4*>(s + (size_t)p * ld + v * 4) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// 3x3 implicit-GEMM convolution of a flat shared-memory region (pixel
// p = r * rw + c, stride ldin) with weights w [9][K][64], taps outermost:
// for each tap the block stages W[tap] in shared memory (sw, K x
// ld_f32(64)), then each warp adds the tap to its output fragments
// f = warp + i * NWARPS (i < NF, f < nfrags; fragment f covers output
// pixels 16f .. 16f+15, which read input pixels m + ky * rw + kx).
// Begins with a __syncthreads, so the caller's region writes are visible.
template <int K, int NF, int NWARPS>
__device__ __forceinline__ void conv3x3_tiles_f32(TileF32 (&acc)[NF],
                                                  const float* in, int ldin,
                                                  int rw, int nfrags,
                                                  const float* __restrict__ w,
                                                  float* sw) {
  constexpr int LDW = ld_f32(64);
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i].zero();
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are consumed
    const float* g = w + (size_t)tap * K * 64;
    for (int i = threadIdx.x; i < K * 16; i += blockDim.x) {
      const int r = i / 16, v = i % 16;
      *reinterpret_cast<float4*>(sw + (size_t)r * LDW + v * 4) =
          __ldg(reinterpret_cast<const float4*>(g + (size_t)r * 64 + v * 4));
    }
    __syncthreads();
    const int off = (tap / 3) * rw + tap % 3;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + i * NWARPS;
      if (f < nfrags) {
        const float* a = in + (size_t)(f * 16 + off) * ldin;
#pragma unroll
        for (int k0 = 0; k0 < K; k0 += 16)
          acc[i].mma(a + k0, ldin, sw + k0 * LDW, LDW);
      }
    }
  }
}

}  // namespace unetdc
