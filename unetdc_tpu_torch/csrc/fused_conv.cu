// Fused convolution kernels of the UNetDC forward, for sm_90a.
//
// K1 k1_conv3x3_relu_pool: y = ReLU(conv3x3(x; 64->64, SAME) + b) and
//    pool = maxpool2x2(y), NHWC, f32 accumulation, y rounded once.
//    Replaces the TPU kernel unetdc_tpu/ops/pallas_conv.py::pair_conv_pool
//    (body _kernel_a).
//    Bound on the H100 at batch 8 x 512^2 (bf16): it must read x (268 MB)
//    and write y (268 MB) and pool (67 MB), ~604 MB, ~0.18 ms at 3.35 TB/s,
//    against 19 GFLOP (~0.02 ms of bf16 tensor-core time): memory-bound.
//    Design: one block per 16x16 output tile loads its 18x18x64 input
//    window once into shared memory; warps run an implicit GEMM over the
//    9 taps on tensor cores (WMMA bf16, f32 accumulate), taps outermost,
//    each tap's 64x64 weights staged once per block in shared memory; the
//    pool runs from shared memory in the epilogue, so y is never re-read
//    from HBM. Measured ~10x the bound (PERF.md): wgmma/TMA come later.
//
// K2 k2_dec1_head: upconv1 (ConvTranspose2d 128->64, k2 s2, + bias) ->
//    concat [up, enc1] -> conv3x3 128->64 + ReLU -> conv3x3 64->64 + ReLU
//    -> 1x1 64->1 + bias -> sigmoid, f32 probabilities.
//    Replaces unetdc_tpu/ops/pallas_conv.py::dec1_head (body _kernel_b).
//    Bound at batch 8 x 512^2 (bf16): ~0.50 TFLOP (conv0 309 G, conv1
//    155 G, upconv 34 G) against ~410 MB (dec2 134 MB, enc1 268 MB, out
//    8 MB): tensor-core-bound, ~0.50 ms at 989 TFLOP/s.
//    Design: one block per 8x16 output tile keeps up, the concat and h in
//    shared memory (halo recomputed per tile), so only dec2, enc1 and the
//    probabilities touch HBM. The convolutions are implicit GEMMs on tensor
//    cores with each tap's weights staged in shared memory (~20x the bound,
//    PERF.md; one 154 KB block per SM limits it). Edge rules of the TPU
//    kernel: up is zeroed outside the image after its bias; h is zeroed
//    outside the image in rows AND columns, so conv1 sees zero padding and
//    not conv0 of zeros (relu(bias)).
//
// Implicit GEMM layout: a region of R rows x RW columns is stored flat in
// shared memory (pixel p = r * RW + c); output pixel m of a 3x3 conv reads
// input pixel m + ky * RW + kx, a uniform stride, so a 16-row WMMA A tile
// is 16 consecutive m. The last columns of each row are computed and
// discarded.
//
// The f32 instantiations use plain FMA (never TF32) with the same layout.

#include "common.cuh"

namespace unetdc {

// ------------------------------------------------------------------ K1 --
constexpr int K1_TH = 16, K1_TW = 16;
constexpr int K1_RW = K1_TW + 2, K1_RR = K1_TH + 2;
constexpr int K1_OF = (K1_TH * K1_RW + 15) / 16;  // output fragments
constexpr int K1_INP = round16(cmax(K1_RR * K1_RW, K1_OF * 16 + 2 * K1_RW + 2));
constexpr int K1_WARPS = 6;

template <typename T> struct K1Smem {
  static constexpr int LD = ld_for<T>(64);
  static constexpr size_t in_bytes = (size_t)K1_INP * LD * sizeof(T);
  static constexpr size_t y_bytes = (size_t)K1_TH * K1_TW * 64 * sizeof(T);
  static constexpr size_t w_bytes = (size_t)64 * LD * sizeof(T);
  static constexpr size_t total =
      in_bytes + y_bytes + w_bytes + K1_WARPS * 256 * 4;
};

template <typename T>
__global__ void __launch_bounds__(K1_WARPS * 32)
k1_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ bias, T* __restrict__ y,
          T* __restrict__ pool, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S = K1Smem<T>;
  constexpr int LD = S::LD;
  T* sin = reinterpret_cast<T*>(smem);
  T* sy = reinterpret_cast<T*>(smem + S::in_bytes);
  T* sw = reinterpret_cast<T*>(smem + S::in_bytes + S::y_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = reinterpret_cast<float*>(smem + S::in_bytes + S::y_bytes +
                                            S::w_bytes) + warp * 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * K1_TH, x0 = blockIdx.x * K1_TW;

  load_window<T, 64>(sin, LD, 0, x + (size_t)b * H * W * 64, H, W, y0 - 1,
                     x0 - 1, K1_RR, K1_RW);
  zero_pixels<T, 64>(sin, LD, K1_RR * K1_RW, K1_INP);
  __syncthreads();

  constexpr int NF = (K1_OF + K1_WARPS - 1) / K1_WARPS;
  Tile4<T> accs[NF];
  conv3x3_tiles<T, 64, NF, K1_WARPS>(accs, sin, LD, K1_RW, K1_OF, w, sw);
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + i * K1_WARPS;
    if (f >= K1_OF) continue;
    Tile4<T>& acc = accs[i];
    const int m0 = f * 16;
    const int m = m0 + (lane >> 1);
    const int r = m / K1_RW, c = m % K1_RW;
    const bool keep = r < K1_TH && c < K1_TW;
    const int gy = y0 + r, gx = x0 + c;
    const bool inimg = keep && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      acc.get(n, scratch, v);
      const int o0 = 16 * n + 8 * (lane & 1);
      if (keep) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaxf(v[j] + bias[o0 + j], 0.0f);
        store8(sy + (size_t)(r * K1_TW + c) * 64 + o0, v);
        if (inimg) store8(y + (((size_t)b * H + gy) * W + gx) * 64 + o0, v);
      }
    }
  }
  __syncthreads();

  // 2x2 max pool of the rounded tile (rounding is monotonic, so this is
  // the pool of y as stored)
  constexpr int PH = K1_TH / 2, PW = K1_TW / 2;
  const int H2 = H / 2, W2 = W / 2;
  for (int i = threadIdx.x; i < PH * PW * 64; i += blockDim.x) {
    const int o = i % 64, p = i / 64;
    const int pr = p / PW, pc = p % PW;
    const int gy = y0 / 2 + pr, gx = x0 / 2 + pc;
    if (gy >= H2 || gx >= W2) continue;
    const T* s = sy + (size_t)(2 * pr * K1_TW + 2 * pc) * 64 + o;
    const float mx = fmaxf(fmaxf(to_f(s[0]), to_f(s[64])),
                           fmaxf(to_f(s[K1_TW * 64]), to_f(s[K1_TW * 64 + 64])));
    pool[(((size_t)b * H2 + gy) * W2 + gx) * 64 + o] = from_f<T>(mx);
  }
}

template <typename T>
int launch_k1(const void* x, const void* w, const void* bias, void* y,
              void* pool, int B, int H, int W, void* stream) {
  const size_t smem = K1Smem<T>::total;
  cudaError_t e = cudaFuncSetAttribute(
      k1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + K1_TW - 1) / K1_TW, (H + K1_TH - 1) / K1_TH, B);
  k1_kernel<T><<<grid, K1_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const float*)bias, (T*)y, (T*)pool, H, W);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K2 --
constexpr int K2_TW = 16, K2_RW = K2_TW + 4, K2_WARPS = 8;

template <int TH> struct K2Dims {
  static constexpr int CR = TH + 4;                          // concat rows
  static constexpr int DR = TH / 2 + 2, DW = K2_TW / 2 + 2;  // dec2 window
  static constexpr int DF = (DR * DW + 15) / 16;             // upconv frags
  static constexpr int DP = DF * 16;
  static constexpr int HR = TH + 2;                          // h rows
  static constexpr int HF = (HR * K2_RW + 15) / 16;          // conv0 frags
  static constexpr int OF = (TH * K2_RW + 15) / 16;          // conv1 frags
  static constexpr int CATP = round16(cmax(CR * K2_RW, HF * 16 + 2 * K2_RW + 2));
  static constexpr int HP = round16(cmax(HF * 16, OF * 16 + 2 * K2_RW + 2));
};

// tile height: 8 rows for bf16; 4 for f32, whose tiles are twice the bytes
template <typename T> struct K2Tile { static constexpr int TH = 8; };
template <> struct K2Tile<float> { static constexpr int TH = 4; };

template <typename T> struct K2Smem {
  using D = K2Dims<K2Tile<T>::TH>;
  static constexpr int LDC = ld_for<T>(128), LDH = ld_for<T>(64);
  static constexpr size_t cat_bytes = (size_t)D::CATP * LDC * sizeof(T);
  static constexpr size_t h_bytes = (size_t)D::HP * LDH * sizeof(T);
  static constexpr size_t d_bytes = (size_t)D::DP * LDC * sizeof(T);
  static constexpr size_t w_bytes = (size_t)128 * LDH * sizeof(T);
  static constexpr size_t total =
      cat_bytes + h_bytes + d_bytes + w_bytes + K2_WARPS * 256 * 4;
};

template <typename T>
__global__ void __launch_bounds__(K2_WARPS * 32)
k2_kernel(const T* __restrict__ dec2, const T* __restrict__ enc1,
          const T* __restrict__ w_up, const float* __restrict__ b_up,
          const T* __restrict__ w0, const float* __restrict__ b0,
          const T* __restrict__ w1, const float* __restrict__ b1,
          const T* __restrict__ w_oc, const float* __restrict__ b_oc,
          float* __restrict__ out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TH = K2Tile<T>::TH;
  using D = K2Dims<TH>;
  using S = K2Smem<T>;
  constexpr int LDC = S::LDC, LDH = S::LDH;
  T* sc = reinterpret_cast<T*>(smem);
  T* sh = reinterpret_cast<T*>(smem + S::cat_bytes);
  T* sd = reinterpret_cast<T*>(smem + S::cat_bytes + S::h_bytes);
  T* sw = reinterpret_cast<T*>(smem + S::cat_bytes + S::h_bytes + S::d_bytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = reinterpret_cast<float*>(smem + S::cat_bytes + S::h_bytes +
                                            S::d_bytes + S::w_bytes) +
                   warp * 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * K2_TW;
  const int H2 = H / 2, W2 = W / 2;

  // dec2 window (rows y0/2-1.., cols x0/2-1..) and the enc1 half of the
  // concat window (rows y0-2.., cols x0-2..), zero outside the image
  load_window<T, 128>(sd, LDC, 0, dec2 + (size_t)b * H2 * W2 * 128, H2, W2,
                      y0 / 2 - 1, x0 / 2 - 1, D::DR, D::DW);
  zero_pixels<T, 128>(sd, LDC, D::DR * D::DW, D::DP);
  load_window<T, 64>(sc, LDC, 64, enc1 + (size_t)b * H * W * 64, H, W,
                     y0 - 2, x0 - 2, D::CR, K2_RW);
  zero_pixels<T, 128>(sc, LDC, D::CR * K2_RW, D::CATP);
  __syncthreads();

  // upconv1: out[2h+p, 2w+q, o] = sum_i dec2[h, w, i] W[p, q, i, o] + b[o];
  // one work item = 16 dec2 pixels x one (p, q) x 64 outputs
  for (int it = warp; it < D::DF * 4; it += K2_WARPS) {
    const int f = it >> 2, pq = it & 3;
    Tile4<T> acc;
    acc.zero();
    const T* a = sd + (size_t)f * 16 * LDC;
    const T* bw = w_up + (size_t)pq * 128 * 64;
#pragma unroll
    for (int k0 = 0; k0 < 128; k0 += 16) acc.mma(a + k0, LDC, bw + k0 * 64, 64);
    const int m = f * 16 + (lane >> 1);
    const int dr = m / D::DW, dc = m % D::DW;
    const int ry = 2 * dr + (pq >> 1), rx = 2 * dc + (pq & 1);
    const int gy = y0 - 2 + ry, gx = x0 - 2 + rx;
    const bool valid = m < D::DR * D::DW;
    const bool inimg = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      acc.get(n, scratch, v);
      const int o0 = 16 * n + 8 * (lane & 1);
      if (valid) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = inimg ? v[j] + b_up[o0 + j] : 0.0f;
        store8(sc + (size_t)(ry * K2_RW + rx) * LDC + o0, v);
      }
    }
  }
  __syncthreads();

  // conv0 over the (TH+2) x (16+2) h region: 3x3, 128 -> 64, + ReLU
  constexpr int NF0 = (D::HF + K2_WARPS - 1) / K2_WARPS;
  Tile4<T> acc0[NF0];
  conv3x3_tiles<T, 128, NF0, K2_WARPS>(acc0, sc, LDC, K2_RW, D::HF, w0, sw);
#pragma unroll
  for (int i = 0; i < NF0; ++i) {
    const int f = warp + i * K2_WARPS;
    if (f >= D::HF) continue;
    Tile4<T>& acc = acc0[i];
    const int m0 = f * 16;
    const int m = m0 + (lane >> 1);
    const int r = m / K2_RW, c = m % K2_RW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool inimg = r < D::HR && c < K2_TW + 2 && gy >= 0 && gy < H &&
                       gx >= 0 && gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      acc.get(n, scratch, v);
      const int o0 = 16 * n + 8 * (lane & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = inimg ? fmaxf(v[j] + b0[o0 + j], 0.0f) : 0.0f;
      store8(sh + (size_t)m * LDH + o0, v);
    }
  }
  __syncthreads();

  // conv1 (3x3, 64 -> 64, + ReLU, rounded) -> 1x1 head -> sigmoid
  const float boc = b_oc[0];
  constexpr int NF1 = (D::OF + K2_WARPS - 1) / K2_WARPS;
  Tile4<T> acc1[NF1];
  conv3x3_tiles<T, 64, NF1, K2_WARPS>(acc1, sh, LDH, K2_RW, D::OF, w1, sw);
#pragma unroll
  for (int i = 0; i < NF1; ++i) {
    const int f = warp + i * K2_WARPS;
    if (f >= D::OF) continue;
    Tile4<T>& acc = acc1[i];
    const int m0 = f * 16;
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      acc.get(n, scratch, v);
      const int o0 = 16 * n + 8 * (lane & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d1 = to_f(from_f<T>(fmaxf(v[j] + b1[o0 + j], 0.0f)));
        part = fmaf(d1, to_f(w_oc[o0 + j]), part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const int m = m0 + (lane >> 1);
    const int r = m / K2_RW, c = m % K2_RW;
    const int gy = y0 + r, gx = x0 + c;
    if ((lane & 1) == 0 && r < TH && c < K2_TW && gy < H && gx < W)
      out[((size_t)b * H + gy) * W + gx] = 1.0f / (1.0f + expf(-(part + boc)));
  }
}

template <typename T>
int launch_k2(const void* dec2, const void* enc1, const void* w_up,
              const void* b_up, const void* w0, const void* b0, const void* w1,
              const void* b1, const void* w_oc, const void* b_oc, void* out,
              int B, int H, int W, void* stream) {
  const size_t smem = K2Smem<T>::total;
  cudaError_t e = cudaFuncSetAttribute(
      k2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int TH = K2Tile<T>::TH;
  dim3 grid((W + K2_TW - 1) / K2_TW, (H + TH - 1) / TH, B);
  k2_kernel<T><<<grid, K2_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const T*)dec2, (const T*)enc1, (const T*)w_up, (const float*)b_up,
      (const T*)w0, (const float*)b0, (const T*)w1, (const float*)b1,
      (const T*)w_oc, (const float*)b_oc, (float*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace unetdc

extern "C" {

int k1_conv3x3_relu_pool_bf16(const void* x, const void* w, const void* b,
                              void* y, void* pool, int B, int H, int W,
                              void* stream) {
  return unetdc::launch_k1<unetdc::bf16>(x, w, b, y, pool, B, H, W, stream);
}

int k1_conv3x3_relu_pool_f32(const void* x, const void* w, const void* b,
                             void* y, void* pool, int B, int H, int W,
                             void* stream) {
  return unetdc::launch_k1<float>(x, w, b, y, pool, B, H, W, stream);
}

int k2_dec1_head_bf16(const void* dec2, const void* enc1, const void* w_up,
                      const void* b_up, const void* w0, const void* b0,
                      const void* w1, const void* b1, const void* w_oc,
                      const void* b_oc, void* out, int B, int H, int W,
                      void* stream) {
  return unetdc::launch_k2<unetdc::bf16>(dec2, enc1, w_up, b_up, w0, b0, w1,
                                         b1, w_oc, b_oc, out, B, H, W, stream);
}

int k2_dec1_head_f32(const void* dec2, const void* enc1, const void* w_up,
                     const void* b_up, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* w_oc,
                     const void* b_oc, void* out, int B, int H, int W,
                     void* stream) {
  return unetdc::launch_k2<float>(dec2, enc1, w_up, b_up, w0, b0, w1, b1, w_oc,
                                  b_oc, out, B, H, W, stream);
}

}  // extern "C"
