// K3 k3_component_tables: per-label [pixel count, sum((row >> s) & m),
// sum((col >> s) & m) for each shift s of the plan] in exact int32, for
// labels 0 <= k < cap; other labels are dropped. Output (B, cap, 1 + 2k).
//
// Replaces the TPU kernel unetdc_tpu/ops/pallas_props.py::component_tables
// (body _props_kernel), which recast the sums as one-hot MXU matmuls and
// so needed per-dot f32 exactness limits (table_kernel_is_exact,
// MAX_CHUNK). Int32 atomics are exact at any size, so none of those apply.
//
// Bound on the H100: the kernel must read the labels once (4 B a pixel:
// 15.4 MB at batch 8 x 600x800, 8.4 MB at 512^2, ~3-5 us at 3.35 TB/s) and
// do 5 atomic adds per foreground pixel; the atomics, not the bytes, bound
// it. Design: each block builds a private table in shared memory (102 KB
// at cap 5120 x 5 features) with shared-memory atomics, then adds its
// non-zero entries to the output with global atomics. Background pixels
// (label 0, most of an image) accumulate in registers and reach the table
// once per warp, so the hottest address is never contended. Tables larger
// than shared memory (the engine's overflow re-run at cap 8192+) use
// global atomics directly.

#include "common.cuh"

namespace unetdc {

constexpr int K3_MAXK = 8;
constexpr int K3_THREADS = 512;
constexpr int K3_PIX_PER_BLOCK = 32768;
constexpr size_t K3_MAX_SMEM = 200 * 1024;

struct Plan {
  int k;
  int bits;
  int shifts[K3_MAXK];
};

template <bool SMEM>
__global__ void __launch_bounds__(K3_THREADS)
k3_kernel(const int* __restrict__ labels, int* __restrict__ out, int H, int W,
          int cap, Plan plan) {
  extern __shared__ int stab[];
  const int nfeat = 1 + 2 * plan.k;
  const int b = blockIdx.y;
  const int npix = H * W;
  int* gout = out + (size_t)b * cap * nfeat;
  int* tab = SMEM ? stab : gout;
  if (SMEM) {
    for (int i = threadIdx.x; i < cap * nfeat; i += blockDim.x) stab[i] = 0;
    __syncthreads();
  }
  const int m = (1 << plan.bits) - 1;
  int bg[1 + 2 * K3_MAXK];
#pragma unroll
  for (int i = 0; i < 1 + 2 * K3_MAXK; ++i) bg[i] = 0;

  const int* lab = labels + (size_t)b * npix;
  const int p0 = blockIdx.x * K3_PIX_PER_BLOCK;
  const int p1 = min(npix, p0 + K3_PIX_PER_BLOCK);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int l = __ldg(lab + p);
    if (l < 0 || l >= cap) continue;
    const int row = p / W, col = p - (p / W) * W;
    if (l == 0) {
      bg[0] += 1;
#pragma unroll
      for (int c = 0; c < K3_MAXK; ++c)
        if (c < plan.k) {
          bg[1 + c] += (row >> plan.shifts[c]) & m;
          bg[1 + K3_MAXK + c] += (col >> plan.shifts[c]) & m;
        }
    } else {
      int* e = tab + (size_t)l * nfeat;
      atomicAdd(e, 1);
#pragma unroll
      for (int c = 0; c < K3_MAXK; ++c)
        if (c < plan.k) {
          atomicAdd(e + 1 + c, (row >> plan.shifts[c]) & m);
          atomicAdd(e + 1 + plan.k + c, (col >> plan.shifts[c]) & m);
        }
    }
  }
  // background row: one atomic per warp and feature
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int s0 = __reduce_add_sync(full, bg[0]);
  if (lane == 0 && s0) atomicAdd(tab, s0);
#pragma unroll
  for (int c = 0; c < K3_MAXK; ++c)
    if (c < plan.k) {
      const int sr = __reduce_add_sync(full, bg[1 + c]);
      const int sc = __reduce_add_sync(full, bg[1 + K3_MAXK + c]);
      if (lane == 0) {
        if (sr) atomicAdd(tab + 1 + c, sr);
        if (sc) atomicAdd(tab + 1 + plan.k + c, sc);
      }
    }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < cap * nfeat; i += blockDim.x) {
      const int v = stab[i];
      if (v) atomicAdd(gout + i, v);
    }
  }
}

}  // namespace unetdc

extern "C" int k3_component_tables(const void* labels, void* out, int B, int H,
                                   int W, int cap, const void* shifts, int k,
                                   int bits, void* stream) {
  using namespace unetdc;
  if (k < 1 || k > K3_MAXK || bits < 1 || bits > 8 || cap < 1)
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.k = k;
  plan.bits = bits;
  for (int i = 0; i < K3_MAXK; ++i)
    plan.shifts[i] = i < k ? static_cast<const int*>(shifts)[i] : 0;
  const int nfeat = 1 + 2 * k;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)B * cap * nfeat * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const long long npix = (long long)H * W;
  if (npix == 0 || B == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((npix + K3_PIX_PER_BLOCK - 1) / K3_PIX_PER_BLOCK), B);
  const size_t smem = (size_t)cap * nfeat * sizeof(int);
  if (smem <= K3_MAX_SMEM) {
    e = cudaFuncSetAttribute(k3_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    k3_kernel<true><<<grid, K3_THREADS, smem, st>>>(
        (const int*)labels, (int*)out, H, W, cap, plan);
  } else {
    k3_kernel<false><<<grid, K3_THREADS, 0, st>>>(
        (const int*)labels, (int*)out, H, W, cap, plan);
  }
  return (int)cudaGetLastError();
}
