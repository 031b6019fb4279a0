// rb_rolling_ball: the rolling-ball background correction of uint8 planes
// (..., H, W): a grey opening with cv2's MORPH_ELLIPSE footprint (erode,
// then dilate, cv2's borders: erosion pads 255, dilation pads 0), the
// saturating subtract max(x - background, 0), then NORM_MINMAX to [0, 255]
// per plane. Bit-equal to the plain version
// `ops/rolling_ball.py::rolling_ball_correction_plain`.
//
// Replaces no TPU kernel: the JAX package runs the same shifts through XLA
// (`unetdc_tpu/ops/rolling_ball.py`, `ops/morphology.py`). The plain
// PyTorch chain builds the footprint from one shifted copy and one
// min/max a column or row of it: at ksize 50, 49 horizontal and 49
// vertical shifts an erosion, each a fill, a strided copy and a min/max
// over float32 planes, 588 launches an opening, ~37.6 GiB moved for a
// batch of 8 1024x1024 planes (8 MiB of uint8). Each launch ran near HBM
// speed; the chain itself was the cost (~12.9 ms a batch on the H100).
//
// Bound on the H100: operations. A pass does one min/max a pixel for each
// column the widest run adds (left + right) and one for each footprint row
// past the first: at ksize 50, 98 a pixel, 1.64 G for two passes over
// 8 x 1024 x 1024, against 16.8 MB read and written once (5 us at
// 3.35 TB/s). So the planes stay in shared memory between the operations
// and device memory sees each plane a few times:
// - A block owns a strip of `tw` output columns and `rb` output rows of
//   one plane, and streams the input rows that reach them, top to bottom.
//   Each input row is loaded once into a shared row buffer with the
//   footprint's halo columns (pad outside the image; rows outside it are
//   skipped, since the pad changes no min/max). Two row buffers, one
//   barrier a row.
// - A thread owns RB_CPT columns, nt apart (bank-conflict-free bytes).
//   For each footprint row, in the order in which their runs nest, it
//   widens its running min/max by the columns the run adds, then folds it
//   into the accumulator of the output row that footprint row serves:
//   output r = input s - dy. The accumulators are a ring of `ring` (a
//   power of two >= the footprint's height) rows of the strip in shared
//   memory (16 KB at ksize 50; ksize up to 16384 fits a block); each
//   thread touches only its own columns there, so the ring needs no
//   barrier.
// - The kernel is bound by latency, not by instruction throughput: at
//   ksize 50 on (8, 1, 1024, 1024), 32 output rows a block (2.5 input
//   rows streamed for each) beat 16 and 64, the halo's work against the
//   blocks in flight. Two columns a 32-bit word (16-bit lanes,
//   VIMNMX.U16x2 on sm_90) cut the instructions but doubled the ring's
//   bytes, so fewer blocks fit an SM: 2.3x slower there, so the ring
//   keeps bytes.
// - An output row is written when its last input row is in (s = r +
//   dy_max) and its slot is reset to the pad.
// - Erode writes the eroded plane (uint8); dilate fuses the subtract,
//   writes the corrected plane (uint8) and reduces its min and max (warp
//   reduce, one atomic a warp into a per-plane int32 pair that erode
//   initialises); a third kernel normalises in place in the plain
//   version's float32 order (reciprocal, multiply, subtract, multiply,
//   round half to even: correctly rounded intrinsics, no contraction).
// - Strided input (the trainer's permuted (B, 3, H, W) view of HWC images)
//   is read through its strides; the footprint table (dy, lo, hi per row)
//   is uploaded once per (ksize, device) by the wrapper and read from
//   shared memory. The host launches three kernels and never waits.

#include "common.cuh"

namespace unetdc {

constexpr int RB_CPT = 4;  // columns a thread owns
constexpr int RB_MAX_SMEM = 232448;

// A (nb, nc, H, W) uint8 view by element strides; plane n is (n / nc,
// n % nc).
struct RbPlanes {
  long long sb, sc, sh, sw;
  int nc;
};

struct RbGeom {
  int H, W, n_planes;
  int nrows;           // footprint rows in the table
  int dy_min, dy_max;  // their offsets from the anchor row
  int left, right;     // the widest run's reach beside the anchor column
  int ring;            // accumulator rows: a power of two >= the height
  int tw, rb;          // a block's output columns and rows
};

__device__ __forceinline__ const uint8_t* rb_plane(const uint8_t* base,
                                                   const RbPlanes& p, int n) {
  return base + (long long)(n / p.nc) * p.sb + (long long)(n % p.nc) * p.sc;
}

template <bool ERODE>
__device__ __forceinline__ int rb_op(int a, int b) {
  return ERODE ? min(a, b) : max(a, b);
}

// table[e] = (dy, lo | hi << 16): footprint row e covers columns
// [c - lo, c + hi] of input row r + dy for output (r, c); rows in nested
// order (lo and hi never decrease).
template <bool ERODE>
__global__ void rb_morph_kernel(const uint8_t* __restrict__ src, RbPlanes sp,
                                const int2* __restrict__ table, RbGeom g,
                                uint8_t* __restrict__ dst,
                                const uint8_t* __restrict__ orig, RbPlanes op,
                                int* __restrict__ minmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = ERODE ? 255 : 0;
  const int t = threadIdx.x, nt = blockDim.x;
  const int n = blockIdx.z;
  const int c0 = blockIdx.x * g.tw;
  const int r0 = blockIdx.y * g.rb;
  const int r1 = min(r0 + g.rb, g.H);
  const int bw = g.tw + g.left + g.right;
  const int mask = g.ring * g.tw - 1;
  int2* tab = reinterpret_cast<int2*>(smem);
  uint8_t* acc = smem + ((g.nrows * 8 + 15) & ~15);
  uint8_t* rows = acc + g.ring * g.tw;  // two row buffers of bw bytes

  for (int i = t; i < g.nrows; i += nt) tab[i] = table[i];
  for (int i = t; i < g.ring * g.tw; i += nt) acc[i] = PAD;
  if (ERODE && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    for (int i = t; i < g.n_planes; i += nt) {
      minmax[2 * i] = 255;
      minmax[2 * i + 1] = 0;
    }
  __syncthreads();

  const uint8_t* src_n = rb_plane(src, sp, n);
  int lo_v = 255, hi_v = 0;  // dilate: range of the corrected values
  int buf = 0;
  for (int s = r0 + g.dy_min; s < r1 + g.dy_max; ++s) {
    if (s >= 0 && s < g.H) {  // block-uniform
      uint8_t* xb = rows + buf * bw;
      buf ^= 1;
      const uint8_t* srow = src_n + (long long)s * sp.sh;
      for (int j = t; j < bw; j += nt) {
        const int c = c0 - g.left + j;
        xb[j] = (c >= 0 && c < g.W) ? srow[(long long)c * sp.sw]
                                    : (uint8_t)PAD;
      }
      __syncthreads();
      const uint8_t* xc = xb + g.left + t;  // the anchor of column q = 0
      int m[RB_CPT];
#pragma unroll
      for (int q = 0; q < RB_CPT; ++q) m[q] = xc[q * nt];
      int clo = 0, chi = 0;
      for (int e = 0; e < g.nrows; ++e) {
        const int2 en = tab[e];
        const int lo = en.y & 0xffff, hi = en.y >> 16;
        for (; clo < lo; ++clo)
#pragma unroll
          for (int q = 0; q < RB_CPT; ++q)
            m[q] = rb_op<ERODE>(m[q], xc[q * nt - clo - 1]);
        for (; chi < hi; ++chi)
#pragma unroll
          for (int q = 0; q < RB_CPT; ++q)
            m[q] = rb_op<ERODE>(m[q], xc[q * nt + chi + 1]);
        const int r = s - en.x;
        if (r >= r0 && r < r1) {
          uint8_t* a = acc + ((r * g.tw) & mask) + t;
#pragma unroll
          for (int q = 0; q < RB_CPT; ++q)
            a[q * nt] = (uint8_t)rb_op<ERODE>(a[q * nt], m[q]);
        }
      }
    }
    const int r = s - g.dy_max;  // its last input row is in
    if (r >= r0 && r < r1) {
      uint8_t* a = acc + ((r * g.tw) & mask) + t;
      uint8_t* drow = dst + ((long long)n * g.H + r) * g.W;
      const uint8_t* orow =
          ERODE ? nullptr : rb_plane(orig, op, n) + (long long)r * op.sh;
#pragma unroll
      for (int q = 0; q < RB_CPT; ++q) {
        const int c = c0 + t + q * nt;
        if (c < g.W) {
          int v = a[q * nt];
          if (!ERODE) {
            v = max((int)orow[(long long)c * op.sw] - v, 0);
            lo_v = min(lo_v, v);
            hi_v = max(hi_v, v);
          }
          drow[c] = (uint8_t)v;
        }
        a[q * nt] = (uint8_t)PAD;
      }
    }
  }
  if (!ERODE) {
    const unsigned lanes = __activemask();
    lo_v = __reduce_min_sync(lanes, lo_v);
    hi_v = __reduce_max_sync(lanes, hi_v);
    if ((t & 31) == 0) {
      atomicMin(minmax + 2 * n, lo_v);
      atomicMax(minmax + 2 * n + 1, hi_v);
    }
  }
}

__device__ __forceinline__ uint8_t rb_norm(int v, float mn, float scale) {
  const float y = rintf(__fmul_rn(__fsub_rn((float)v, mn), scale));
  return (uint8_t)(int)fminf(fmaxf(y, 0.0f), 255.0f);
}

// NORM_MINMAX in place: plane n = blockIdx.y of hw bytes.
__global__ void rb_normalize_kernel(uint8_t* __restrict__ out,
                                    const int* __restrict__ minmax,
                                    long long hw) {
  const int n = blockIdx.y;
  const float mn = (float)minmax[2 * n];
  const float span = __fsub_rn((float)minmax[2 * n + 1], mn);
  // the plain version: where(span > 1e-12, 255 / span, 0), and PyTorch
  // computes 255 / span as reciprocal(span) * 255 (Tensor.__rtruediv__)
  const float scale =
      span > 1e-12f ? __fmul_rn(__frcp_rn(span), 255.0f) : 0.0f;
  uint8_t* p = out + (long long)n * hw;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (hw % 4 == 0) {  // planes start 4-byte aligned (fresh allocation)
    uchar4* p4 = reinterpret_cast<uchar4*>(p);
    for (long long i = i0; i < hw / 4; i += step) {
      uchar4 v = p4[i];
      v.x = rb_norm(v.x, mn, scale);
      v.y = rb_norm(v.y, mn, scale);
      v.z = rb_norm(v.z, mn, scale);
      v.w = rb_norm(v.w, mn, scale);
      p4[i] = v;
    }
  } else {
    for (long long i = i0; i < hw; i += step) p[i] = rb_norm(p[i], mn, scale);
  }
}

static int rb_smem_bytes(int nrows, int ring, int tw, int left, int right) {
  return ((nrows * 8 + 15) & ~15) + ring * tw + 2 * (tw + left + right);
}

}  // namespace unetdc

// src: (nb, nc, H, W) uint8 by element strides; table: nrows int2 (device);
// ero: (nb * nc, H, W) uint8 scratch; out: (nb * nc, H, W) uint8; minmax:
// (nb * nc, 2) int32 scratch. ring, tw and rb are the wrapper's tile.
extern "C" int rb_rolling_ball(const void* src, int nb, int nc, int H, int W,
                               long long sb, long long sc, long long sh,
                               long long sw, const void* table, int nrows,
                               int dy_min, int dy_max, int left, int right,
                               int ring, int tw, int rb, void* ero, void* out,
                               void* minmax, void* stream) {
  using namespace unetdc;
  const long long n_planes = (long long)nb * nc;
  const bool pow2 = ring > 0 && (ring & (ring - 1)) == 0 && tw > 0 &&
                    (tw & (tw - 1)) == 0;
  if (nb < 1 || nc < 1 || H < 1 || W < 1 || n_planes > 65535 || nrows < 1 ||
      dy_min > dy_max || ring < dy_max - dy_min + 1 || !pow2 ||
      tw < RB_CPT || tw > 1024 * RB_CPT || rb < 1 || left < 0 || right < 0 ||
      left > 0xffff || right > 0xffff)
    return (int)cudaErrorInvalidValue;
  const int smem = rb_smem_bytes(nrows, ring, tw, left, right);
  if (smem > RB_MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rb_morph_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rb_morph_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
  RbGeom g{H, W, (int)n_planes, nrows, dy_min, dy_max, left, right,
           ring, tw, rb};
  const RbPlanes in{sb, sc, sh, sw, nc};
  const RbPlanes mid{(long long)H * W, 0, W, 1, 1};
  const dim3 grid((W + tw - 1) / tw, (H + rb - 1) / rb, (unsigned)n_planes);
  const int threads = tw / RB_CPT;
  const uint8_t* x = static_cast<const uint8_t*>(src);
  const int2* tab = static_cast<const int2*>(table);
  uint8_t* e8 = static_cast<uint8_t*>(ero);
  uint8_t* o8 = static_cast<uint8_t*>(out);
  int* mm = static_cast<int*>(minmax);
  rb_morph_kernel<true><<<grid, threads, smem, st>>>(x, in, tab, g, e8,
                                                     nullptr, in, mm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rb_morph_kernel<false><<<grid, threads, smem, st>>>(e8, mid, tab, g, o8, x,
                                                      in, mm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long hw = (long long)H * W;
  const long long units = hw % 4 == 0 ? hw / 4 : hw;
  const unsigned bx = (unsigned)((units + 255) / 256 < 65535
                                     ? (units + 255) / 256 : 65535);
  rb_normalize_kernel<<<dim3(bx, (unsigned)n_planes), 256, 0, st>>>(o8, mm,
                                                                   hw);
  return (int)cudaGetLastError();
}
