// Shared helpers of the port's CUDA kernels: storage-type conversions, a
// 16x64 warp accumulator tile (tensor cores for bf16, plain FMA for f32),
// and cooperative NHWC window loads into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace unetdc {

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Shared-memory pixel stride (elements) for C channels: rows stay 32-byte
// aligned (WMMA's pointer rule) and are padded off the 128-byte bank period.
template <typename T>
__host__ __device__ constexpr int ld_for(int c) {
  return c + 32 / (int)sizeof(T);
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Round 8 f32 values to T and store them (16-byte aligned destination).
__device__ __forceinline__ void store8(bf16* dst, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  h[2] = __floats2bfloat162_rn(v[4], v[5]);
  h[3] = __floats2bfloat162_rn(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = u;
}
__device__ __forceinline__ void store8(float* dst, const float v[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A warp's 16 x 64 f32 accumulator: C += A (16 x 16) * B (16 x 64), A and
// B row-major. Lane l owns row l/2, columns 8*(l&1) .. +8 of each 16-wide
// block n, as returned by get().
template <typename T> struct Tile4;

template <> struct Tile4<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 4; ++n) nvcuda::wmma::fill_fragment(c[n], 0.0f);
  }
  __device__ __forceinline__ void mma(const bf16* a, int lda, const bf16* b,
                                      int ldb) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a, lda);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + 16 * n, ldb);
      wmma::mma_sync(c[n], fa, fb, c[n]);
    }
  }
  // scratch: this warp's 256 floats (32-byte aligned)
  __device__ __forceinline__ void get(int n, float* scratch, float v[8]) {
    nvcuda::wmma::store_matrix_sync(scratch, c[n], 16,
                                    nvcuda::wmma::mem_row_major);
    __syncwarp();
    const int lane = threadIdx.x & 31;
    const float* s = scratch + (lane >> 1) * 16 + (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = s[j];
    __syncwarp();
  }
};

template <> struct Tile4<float> {
  float c[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) c[n][j] = 0.0f;
  }
  // plain f32 FMA, never TF32
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
  __device__ __forceinline__ void get(int n, float*, float v[8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = c[n][j];
  }
};

// Copy the rows x cols pixel window at global (gy0, gx0) of one NHWC image
// (H x W x C) into shared memory at channel offset c_off (pixel p = r * cols
// + c at s + p * ld), zero outside the image. 16-byte vectors.
template <typename T, int C>
__device__ __forceinline__ void load_window(T* s, int ld, int c_off,
                                            const T* __restrict__ img, int H,
                                            int W, int gy0, int gx0, int rows,
                                            int cols) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int NV = C / VEC;
  const int total = rows * cols * NV;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int v = i % NV;
    const int p = i / NV;
    const int r = p / cols, c = p - (p / cols) * cols;
    const int gy = gy0 + r, gx = gx0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      val = __ldg(reinterpret_cast<const uint4*>(
          img + ((size_t)gy * W + gx) * C + v * VEC));
    *reinterpret_cast<uint4*>(s + (size_t)p * ld + c_off + v * VEC) = val;
  }
}

// Zero channels [0, C) of shared-memory pixels [p0, p1).
template <typename T, int C>
__device__ __forceinline__ void zero_pixels(T* s, int ld, int p0, int p1) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int NV = C / VEC;
  const int total = (p1 - p0) * NV;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = p0 + i / NV, v = i % NV;
    *reinterpret_cast<uint4*>(s + (size_t)p * ld + v * VEC) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Copy `rows` rows of 64 elements (contiguous in global memory) into
// shared memory with row stride ld.
template <typename T>
__device__ __forceinline__ void load_rows64(T* s, int ld,
                                            const T* __restrict__ g,
                                            int rows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int NV = 64 / VEC;
  for (int i = threadIdx.x; i < rows * NV; i += blockDim.x) {
    const int r = i / NV, v = i % NV;
    *reinterpret_cast<uint4*>(s + (size_t)r * ld + v * VEC) =
        __ldg(reinterpret_cast<const uint4*>(g + (size_t)r * 64 + v * VEC));
  }
}

// 3x3 implicit-GEMM convolution of a flat shared-memory region (pixel
// p = r * rw + c, stride ldin) with weights w [9][K][64], taps outermost:
// for each tap the block stages W[tap] in shared memory (sw, K x
// ld_for<T>(64)), then each warp adds the tap to its output fragments
// f = warp + i * NWARPS (i < NF, f < nfrags; fragment f covers output
// pixels 16f .. 16f+15, which read input pixels m + ky * rw + kx).
// Begins with a __syncthreads, so the caller's region writes are visible.
template <typename T, int K, int NF, int NWARPS>
__device__ __forceinline__ void conv3x3_tiles(Tile4<T> (&acc)[NF],
                                              const T* in, int ldin, int rw,
                                              int nfrags,
                                              const T* __restrict__ w,
                                              T* sw) {
  constexpr int LDW = ld_for<T>(64);
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i].zero();
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the previous tap's weights are consumed
    load_rows64<T>(sw, LDW, w + (size_t)tap * K * 64, K);
    __syncthreads();
    const int off = (tap / 3) * rw + tap % 3;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + i * NWARPS;
      if (f < nfrags) {
        const T* a = in + (size_t)(f * 16 + off) * ldin;
#pragma unroll
        for (int k0 = 0; k0 < K; k0 += 16)
          acc[i].mma(a + k0, ldin, sw + k0 * LDW, LDW);
      }
    }
  }
}

}  // namespace unetdc
