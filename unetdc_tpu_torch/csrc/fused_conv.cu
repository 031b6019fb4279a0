// Fused convolution kernels of the UNetDC forward, for sm_90a.
//
// K1 conv3x3_relu_pool: y = ReLU(conv3x3(x; 64->64, SAME) + b) and
//    pool = maxpool2x2(y), NHWC, f32 accumulation, y rounded once and the
//    pool taken of the rounded y.
//    Replaces the TPU kernel unetdc_tpu/ops/pallas_conv.py::pair_conv_pool
//    (body _kernel_a).
//    Bound on the H100 at batch 8 x 512^2 (bf16): it must read x (268 MB)
//    and write y (268 MB) and pool (67 MB), ~604 MB, 0.180 ms at 3.35 TB/s,
//    against 155 GFLOP, 0.156 ms of bf16 tensor-core time: bytes bound it,
//    with the operations close behind.
//    Design (bf16): a persistent grid, one 8-warp block per SM walking 16x16
//    output tiles. All nine taps' weights (73.7 KB) are loaded into shared
//    memory once per block by TMA, so weights cost 9.7 MB of L2 reads per
//    launch (132 blocks) instead of a restaging per tile; HBM reads them
//    once. The 18x18x64 input window of the next tile arrives by one TMA
//    tensor copy (out-of-bounds zero fill is the SAME padding) into the
//    other of two buffers while the current tile computes. Each warpgroup
//    issues two wgmma m64n64k16 per k16 step (36 steps): A from registers,
//    loaded by ldmatrix from the window at the tap's pixel offset (warp w
//    owns output rows 2w, 2w+1), B from the resident weights. The epilogue
//    applies bias and ReLU in the accumulator layout, rounds, pools rows in
//    registers and columns by one shuffle, writes the y and pool tiles to
//    shared memory, and one thread stores both by TMA (clipped at the image
//    edge). Recompute factor 1.0 (only output pixels are computed).
//    Shared memory: 73.7 + 2 x 41 + 32 + 8 KB = 198.7 KB.
//
// K2 dec1_head: upconv1 (ConvTranspose2d 128->64, k2 s2, + bias) ->
//    concat [up, enc1] -> conv3x3 128->64 + ReLU -> conv3x3 64->64 + ReLU
//    -> 1x1 64->1 + bias -> sigmoid, f32 probabilities.
//    Replaces unetdc_tpu/ops/pallas_conv.py::dec1_head (body _kernel_b).
//    Bound at batch 8 x 512^2 (bf16): 0.498 TFLOP (conv0 309 G, conv1
//    155 G, upconv 34 G) against ~410 MB (dec2 134 MB, enc1 268 MB, out
//    8 MB): tensor-core-bound, 0.504 ms at 989 TFLOP/s.
//    Design (bf16): a persistent grid, one 16-warp block (four warpgroups)
//    per SM walking 32x12 output tiles. Per tile:
//      1. upconv from the 18x8x128 dec2 window into the 36x16 `up` region:
//         warpgroup g computes sub-position (p, q) = (g/2, g%2) as three
//         m64 tiles of dec2 pixels x 64 channels over K = 128;
//      2. conv0 over `up` (K = 64 per tap), then
//      3. conv0 over the 36x16x64 enc1 window (K = 64 per tap), so the
//         concat is never held at 128 channels; h (34x14 = 476 pixels in
//         32 m16 tiles, two per warp, 64 channels) is written from the
//         accumulators;
//      4. conv1 over h (24 m16 tiles x 2 channel halves: each warpgroup
//         three m64n32 tiles), d1 dotted with the head in registers, a
//         quad shuffle and one shared-memory pair sum per pixel, sigmoid.
//    All products are wgmma with A from registers (ldmatrix, any pixel
//    rows) and B from the weight ring by descriptor. Regions alias by
//    lifetime: up/h share one, dec2/enc1 the other; the enc1 window arrives
//    by TMA during stage 2, the next tile's dec2 window during stage 4.
//    Weights stream through a 9-slot ring of 64x64 blocks (35 per tile,
//    TMA, one mbarrier per slot), continuous across stages and tiles; the
//    last warp to release a slot refills it, so no warp waits for another
//    between stage boundaries (five block barriers per tile). Every stage's
//    work divides evenly over the warps. Recompute factor, issued rows over
//    output pixels: upconv 768/384 = 2.0 (576 real), conv0 512/384 = 1.33
//    (476 real), conv1 1.0; 1.28 weighted by FLOPs, 1.18 without the
//    padding rows (the first design's 8x16 tile: 1.53).
//    Weight traffic: 287 KB per tile of 384 pixels, 0.75 KB per output
//    pixel from L2 (1.6 GB per batch of 8 x 512^2; the first design read
//    3.6 GB); HBM reads the 287 KB once (they stay in L2).
//    Shared memory: 72 + 72 + 72 (ring) + 3 KB = 219 KB.
//    Edge rules of the TPU kernel: up is zeroed outside the image after its
//    bias; h is zeroed outside the image in rows AND columns, so conv1 sees
//    zero padding and not relu(bias) of conv0 over zeros.
//
// Fragment addressing: every lane names its own pixel row for ldmatrix, so
// an m16 tile is any 16 pixels (an output row segment, or 16 consecutive
// pixels of a region in row-major order) and a 3x3 tap is a pixel offset;
// nothing outside the region is computed and dropped. Shared regions keep
// 128-byte pixel rows in TMA's 128-byte swizzle (common.cuh), so ldmatrix
// reads are free of bank conflicts at any tap offset.
//
// The f32 instantiations (the parity path: --precision f32) keep the first
// design's tiling with plain FMA, never TF32.

#include "common.cuh"

namespace unetdc {

// -------------------------------------------------------------- K1 bf16 --
namespace k1 {
constexpr int TH = 16, TW = 16, RR = TH + 2, RW = TW + 2, WARPS = 8;
constexpr int WIN_TX = RR * RW * 128;                 // 41,472 B per window
constexpr int WIN = (WIN_TX + 1023) / 1024 * 1024;    // 1024-aligned buffers
constexpr int WB = 9 * 64 * 128;                      // 73,728 B: nine taps
constexpr int YB = TH * TW * 128;                     // 32,768 B: y tile
constexpr int PB = (TH / 2) * (TW / 2) * 128;         // 8,192 B: pool tile
constexpr int BAR = WB + 2 * WIN + YB + PB;           // window 0, 1, weights
constexpr int SMEM = BAR + 3 * 8;                     // 198,680 B
static_assert(TH == 2 * WARPS, "each warp owns two output rows");
}  // namespace k1

__global__ void __launch_bounds__(k1::WARPS * 32, 1)
k1_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap ymap,
               const __grid_constant__ CUtensorMap pmap,
               const float* __restrict__ bias, int tiles_x, int tiles_y,
               int ntiles) {
  using namespace k1;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t s_w = smem_u32(smem), s_win = s_w + WB;
  const uint32_t s_y = s_win + 2 * WIN, s_p = s_y + YB, bar = s_p + PB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int per_img = tiles_x * tiles_y;

  float bv[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    bv[nt][0] = __ldg(bias + 8 * nt + 2 * q);
    bv[nt][1] = __ldg(bias + 8 * nt + 2 * q + 1);
  }
  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_img;
    const int r = t % per_img;
    y0 = (r / tiles_x) * TH;
    x0 = (r % tiles_x) * TW;
  };
  auto load_window = [&](int t, int buf) {  // one thread
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(bar + 8 * buf, WIN_TX);
    tma_load_4d(s_win + buf * WIN, &xmap, bar + 8 * buf, 0, x0 - 1, y0 - 1,
                b);
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init(bar + 16, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, WB);
    for (int tap = 0; tap < 9; ++tap)
      tma_load_2d(s_w + tap * 8192, &wmap, bar + 16, 0, 64 * tap);
    load_window(blockIdx.x, 0);
  }
  mbar_wait(bar + 16, 0);

  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    if (tid == 0) {
      // the other buffer was last read by the previous tile, which every
      // warp finished before the barrier ahead of its stores
      if (tile + (int)gridDim.x < ntiles)
        load_window(tile + gridDim.x, (it + 1) & 1);
      bulk_wait_read();  // the previous tile's stores have read y and pool
    }
    __syncthreads();
    mbar_wait(bar + 8 * (it & 1), (it >> 1) & 1);

    const uint32_t win = s_win + (it & 1) * WIN;
    // Warpgroup wg issues two m64n64 products per k16 step; its m64 tile mt
    // is output rows 2 warp + mt of its four warps (lane's A row: column
    // lane & 15). 36 steps (9 taps x 4), A triple-buffered in registers so
    // two steps' products stay in flight.
    float acc[2][32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
    const int pix0 = (2 * warp) * RW + (lane & 15);
    uint32_t a[3][2][4];
    auto load_a = [&](int i, uint32_t(&dst)[2][4]) {
      const int tap = i >> 2, off = (tap / 3) * RW + tap % 3;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a_addr(win, pix0 + mt * RW + off, i & 3, lane), dst[mt]);
    };
    load_a(0, a[0]);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll
    for (int i = 0; i < 36; ++i) {
      const uint64_t d = wg_desc(s_w + (i >> 2) * 8192 + (i & 3) * 2048);
      wg_fence();
      wgmma_n64(acc[0], a[i % 3][0], d);
      wgmma_n64(acc[1], a[i % 3][1], d);
      wg_commit();
      if (i + 1 < 36) {
        wg_wait<2>();  // step i-2's products no longer read a[(i+1) % 3]
        load_a(i + 1, a[(i + 1) % 3]);
      }
    }
    wg_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);

    // epilogue: bias + ReLU in the accumulator layout; y rounded once; the
    // pool of rows (2 warp, 2 warp + 1) in registers, of columns (g, g ^ 1)
    // by one shuffle (rounding is monotonic, so pooling before or after it
    // gives the pool of y as stored)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float v[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[mt][e] = fmaxf(acc[mt][4 * nt + e] + bv[nt][e & 1], 0.0f);
        const int p0 = (2 * warp + mt) * TW + g;
        sts32(s_y + swz(p0, nt) + 4 * q, pack_bf16(v[mt][0], v[mt][1]));
        sts32(s_y + swz(p0 + 8, nt) + 4 * q,
              pack_bf16(v[mt][2], v[mt][3]));
      }
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = fmaxf(v[0][e], v[1][e]);
        m[e] = fmaxf(m[e], __shfl_xor_sync(0xffffffffu, m[e], 4));
      }
      if ((g & 1) == 0) {
        const int pp = warp * (TW / 2) + (g >> 1);
        sts32(s_p + swz(pp, nt) + 4 * q, pack_bf16(m[0], m[1]));
        sts32(s_p + swz(pp + 4, nt) + 4 * q, pack_bf16(m[2], m[3]));
      }
    }
    fence_async_smem();
    __syncthreads();  // y and pool tiles complete; every warp done computing
    if (tid == 0) {   // TMA stores clip the parts outside the image
      int b, y0, x0;
      origin(tile, b, y0, x0);
      tma_store_4d(&ymap, s_y, 0, x0, y0, b);
      tma_store_4d(&pmap, s_p, 0, x0 / 2, y0 / 2, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

int launch_k1_bf16(const void* x, const void* w, const void* bias, void* y,
                   void* pool, int B, int H, int W, void* stream) {
  using namespace k1;
  CUtensorMap xm, wm, ym, pm;
  cudaError_t e = nhwc_map(&xm, x, B, H, W, 64, RW, RR);
  if (e == cudaSuccess) e = rows_map(&wm, w, 9 * 64);
  if (e == cudaSuccess) e = nhwc_map(&ym, y, B, H, W, 64, TW, TH);
  if (e == cudaSuccess)
    e = nhwc_map(&pm, pool, B, H / 2, W / 2, 64, TW / 2, TH / 2);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k1_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  if (ntiles == 0) return 0;
  const int grid = ntiles < sm_count() ? ntiles : sm_count();
  k1_bf16_kernel<<<grid, WARPS * 32, SMEM, (cudaStream_t)stream>>>(
      xm, wm, ym, pm, (const float*)bias, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- K2 bf16 --
namespace k2 {
constexpr int TH = 32, TW = 12, WARPS = 16, STAGES = 9;
constexpr int CR = TH + 4, CW = TW + 4, NCAT = CR * CW;  // 36 x 16 up/enc1
constexpr int HR = TH + 2, HW = TW + 2, NH = HR * HW;    // 34 x 14 h
constexpr int DR = CR / 2, DW = CW / 2, ND = DR * DW;    // 18 x 8 dec2
constexpr int MT_UP = ND / 16, MT0 = 32, MT1 = TH * TW / 16;  // 9, 32, 24
constexpr int NOUT = TH * TW;
// weight blocks per tile: upconv 8 ((p,q) x 2 K halves), conv0 over up 9,
// conv0 over enc1 9, conv1 9
constexpr int S_C0 = 8, S_C0E = 17, S_C1 = 26, STEPS = 35;
constexpr int REG = NCAT * 128;   // 73,728 B: one 64-channel 36x16 region
constexpr int DPLANE = ND * 128;  // 18,432 B: 64 channels of the dec2 window
constexpr int WBLK = 64 * 128;    // 8,192 B: one 64x64 weight block
// mbarriers full[STAGES], release counters[STAGES], dec2 and enc1 windows
constexpr int BAR = 2 * REG + STAGES * WBLK + 2 * NOUT * 4;
constexpr int SMEM = BAR + (2 * STAGES + 2) * 8;  // 224,416 B
static_assert(MT_UP * 16 == ND && ND <= 192, "dec2 window in 3 m64 tiles");
static_assert(WARPS == 16, "four warpgroups: one upconv sub-position each");
static_assert(MT0 * 16 >= NH && MT0 % WARPS == 0, "conv0 tiles per warp");
static_assert(NOUT % 16 == 0 && MT1 == 3 * WARPS / 2, "conv1 split");
static_assert(2 * DPLANE <= REG && MT0 * 16 * 128 <= REG, "region aliasing");
}  // namespace k2

__global__ void __launch_bounds__(k2::WARPS * 32, 1)
k2_bf16_kernel(const __grid_constant__ CUtensorMap dmap,
               const __grid_constant__ CUtensorMap emap,
               const __grid_constant__ CUtensorMap upmap,
               const __grid_constant__ CUtensorMap w0map,
               const __grid_constant__ CUtensorMap w1map,
               const float* __restrict__ b_up, const float* __restrict__ b0,
               const float* __restrict__ b1, const bf16* __restrict__ w_oc,
               const float* __restrict__ b_oc, float* __restrict__ out, int H,
               int W, int tiles_x, int tiles_y, int ntiles) {
  using namespace k2;
  extern __shared__ __align__(1024) unsigned char smem[];
  // r0: up (stages 1-2), then h (3-4); r1: dec2 (1), then enc1 (3)
  const uint32_t s_r0 = smem_u32(smem), s_r1 = s_r0 + REG;
  const uint32_t s_ring = s_r1 + REG, bar = s_r0 + BAR;
  float* part = reinterpret_cast<float*>(smem + 2 * REG + STAGES * WBLK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int per_img = tiles_x * tiles_y;
  const int nsteps = ((ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1) * STEPS;
  auto full = [&](int slot) { return bar + 8 * slot; };
  int* released = reinterpret_cast<int*>(smem + BAR + 8 * STAGES);
  const uint32_t dbar = bar + 16 * STAGES, ebar = dbar + 8;

  auto origin = [&](int t, int& b, int& y0, int& x0) {
    b = t / per_img;
    const int r = t % per_img;
    y0 = (r / tiles_x) * TH;
    x0 = (r % tiles_x) * TW;
  };
  // one thread issues each copy
  auto load_block = [&](int jn) {
    const int slot = jn % STAGES, s = jn % STEPS;
    const CUtensorMap* m = s < S_C0 ? &upmap : s < S_C1 ? &w0map : &w1map;
    const int row = s < S_C0    ? 64 * s                  // (p,q) = s/2
                    : s < S_C0E ? 128 * (s - S_C0)         // w0 rows: up
                    : s < S_C1  ? 128 * (s - S_C0E) + 64   // w0 rows: enc1
                                : 64 * (s - S_C1);
    mbar_expect_tx(full(slot), WBLK);
    tma_load_2d(s_ring + slot * WBLK, m, full(slot), 0, row);
  };
  auto load_dec2 = [&](int t) {  // two 64-channel planes
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(dbar, 2 * DPLANE);
    tma_load_4d(s_r1, &dmap, dbar, 0, x0 / 2 - 1, y0 / 2 - 1, b);
    tma_load_4d(s_r1 + DPLANE, &dmap, dbar, 64, x0 / 2 - 1, y0 / 2 - 1, b);
  };
  auto load_enc1 = [&](int t) {
    int b, y0, x0;
    origin(t, b, y0, x0);
    mbar_expect_tx(ebar, REG);
    tma_load_4d(s_r1, &emap, ebar, 0, x0 - 2, y0 - 2, b);
  };
  // Weight ring: step j reads slot j % STAGES once block j has landed.
  // Once its warpgroup's products of step j have completed, each warp
  // releases the slot, and the last warp to release it refills it with
  // block j + STAGES, so no warp ever waits for another to free a slot
  // (the readers' products are complete, so no fence is needed).
  auto wait_block = [&](int j) {
    mbar_wait(full(j % STAGES), (j / STAGES) & 1);
    return s_ring + (j % STAGES) * WBLK;
  };
  auto release = [&](int j) {
    wg_wait<0>();
    const int slot = j % STAGES;
    if (lane == 0 && atomicAdd(&released[2 * slot], 1) == WARPS - 1) {
      released[2 * slot] = 0;
      if (j + STAGES < nsteps) load_block(j + STAGES);
    }
    __syncwarp();  // reconverge before the next .aligned instruction
  };

  // lane's A rows (pixel indices) that do not depend on the tile
  int c0pix[2];  // conv0: h pixel 16 (2 warp + mt) + (lane & 15) -> concat
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = min(16 * (2 * warp + mt) + (lane & 15), NH - 1);
    c0pix[mt] = (m / HW) * CW + m % HW;
  }
  // conv1: warpgroup w >> 2 computes channels 32 half .. +32 of m16 tiles
  // 12 (w >> 3) .. +11; its warp w & 3 holds m16 tiles mt1 .. mt1 + 2
  const int half = (warp >> 2) & 1, mt1 = 12 * (warp >> 3) + 3 * (warp & 3);
  int c1pix[3];  // output pixel 16 (mt1 + i) + (lane & 15) -> h
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int m = 16 * (mt1 + i) + (lane & 15);
    c1pix[i] = (m / TW) * HW + m % TW;
  }

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      released[2 * i] = 0;
    }
    mbar_init(dbar, 1);
    mbar_init(ebar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int jn = 0; jn < STAGES; ++jn) load_block(jn);
    load_dec2(blockIdx.x);
  }

  int j = 0, k = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++k) {
    int b, y0, x0;
    origin(t, b, y0, x0);

    // 1. upconv: up[2h+p, 2w+q, o] = sum_i dec2[h, w, i] W[p, q, i, o] + b[o].
    // Warpgroup g computes sub-position (p, q) = (g / 2, g % 2) from weight
    // blocks 2g, 2g + 1 (K halves): three m64 tiles of dec2 pixels (the
    // ring holds all eight blocks at once), one m64n64 product per k16.
    mbar_wait(dbar, k & 1);
    {
      const int wg = warp >> 2, wl = warp & 3;
      const uint32_t wb0 = wait_block(j + 2 * wg);
      const uint32_t wb1 = wait_block(j + 2 * wg + 1);
      const int p = wg >> 1, qq = wg & 1;
      float u[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        u[nt][0] = __ldg(b_up + 8 * nt + 2 * q);
        u[nt][1] = __ldg(b_up + 8 * nt + 2 * q + 1);
      }
      for (int i = 0; i < 3; ++i) {
        const int d0 = 16 * (4 * i + wl);  // this warp's m16 tile
        const int da = min(d0 + (lane & 15), ND - 1);
        float acc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
        fence_regs(acc);
        uint32_t a[2][4];
        ldsm_x4(a_addr(s_r1, da, 0, lane), a[0]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // K = 128: plane kk / 4, k16 kk % 4
          const uint64_t d = wg_desc((kk < 4 ? wb0 : wb1) + (kk & 3) * 2048);
          wg_fence();
          wgmma_n64(acc, a[kk & 1], d);
          wg_commit();
          if (kk < 7) {
            const int kn = kk + 1;
            wg_wait<1>();
            ldsm_x4(a_addr(s_r1 + (kn >> 2) * DPLANE, da, kn & 3, lane),
                    a[kn & 1]);
          }
        }
        wg_wait<0>();
        fence_regs(acc);
        // bias, edge mask (0 outside the image), round, into the up region
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int dd = d0 + g + 8 * hh;
          if (dd >= ND) continue;
          const int ry = 2 * (dd / DW) + p, rx = 2 * (dd % DW) + qq;
          const int gy = y0 - 2 + ry, gx = x0 - 2 + rx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            sts32(s_r0 + swz(ry * CW + rx, nt) + 4 * q,
                  in ? pack_bf16(acc[4 * nt + 2 * hh] + u[nt][0],
                                 acc[4 * nt + 2 * hh + 1] + u[nt][1])
                     : 0u);
        }
      }
      for (int s = 0; s < S_C0; ++s, ++j) release(j);
    }
    __syncthreads();  // up complete; every warp done with the dec2 window
    if (tid == 0) load_enc1(t);

    // 2-3. conv0 over [up, enc1] on the 34x14 h region, + ReLU -> h.
    // Warpgroup w >> 2 issues two m64n64 products per k16 step; its m64
    // tile mt is h rows 16 (2 warp + mt) .. +15 of its four warps.
    {
      float acc[2][32];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[mt][i] = 0.0f;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      for (int s = S_C0; s < S_C1; ++s, ++j) {
        if (s == S_C0E) mbar_wait(ebar, k & 1);
        const uint32_t wb = wait_block(j);
        const uint32_t src = s < S_C0E ? s_r0 : s_r1;
        const int tap = s < S_C0E ? s - S_C0 : s - S_C0E;
        const int off = (tap / 3) * CW + tap % 3;
        uint32_t a[2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a_addr(src, c0pix[mt] + off, 0, lane), a[0][mt]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t d = wg_desc(wb + ks * 2048);
          wg_fence();
          wgmma_n64(acc[0], a[ks & 1][0], d);
          wgmma_n64(acc[1], a[ks & 1][1], d);
          wg_commit();
          if (ks < 3) {
            wg_wait<1>();  // step ks-1 no longer reads a[(ks+1) & 1]
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4(a_addr(src, c0pix[mt] + off, ks + 1, lane),
                      a[(ks + 1) & 1][mt]);
          }
        }
        release(j);
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      __syncthreads();  // every warp done reading `up` before h replaces it
      // h = round(relu(conv0 + b0)) inside the image, 0 outside (rows and
      // columns)
      float c[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        c[nt][0] = __ldg(b0 + 8 * nt + 2 * q);
        c[nt][1] = __ldg(b0 + 8 * nt + 2 * q + 1);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = 16 * (2 * warp + mt) + g + 8 * hh;
          if (m >= NH) continue;
          const int gy = y0 - 1 + m / HW, gx = x0 - 1 + m % HW;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            sts32(s_r0 + swz(m, nt) + 4 * q,
                  in ? pack_bf16(
                           fmaxf(acc[mt][4 * nt + 2 * hh] + c[nt][0], 0.0f),
                           fmaxf(acc[mt][4 * nt + 2 * hh + 1] + c[nt][1], 0.0f))
                     : 0u);
        }
    }
    __syncthreads();  // h complete; every warp done with the enc1 window
    if (tid == 0 && t + (int)gridDim.x < ntiles) load_dec2(t + gridDim.x);

    // 4. conv1 over h + ReLU (d1 rounded) -> 1x1 head -> sigmoid
    {
      float acc[3][16];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[i][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) fence_regs(acc[i]);
      for (int s = S_C1; s < STEPS; ++s, ++j) {
        const uint32_t wb = wait_block(j) + 64 * half;
        const int tap = s - S_C1;
        const int off = (tap / 3) * HW + tap % 3;
        uint32_t a[2][3][4];
#pragma unroll
        for (int i = 0; i < 3; ++i)
          ldsm_x4(a_addr(s_r0, c1pix[i] + off, 0, lane), a[0][i]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t d = wg_desc(wb + ks * 2048);
          wg_fence();
#pragma unroll
          for (int i = 0; i < 3; ++i) wgmma_n32(acc[i], a[ks & 1][i], d);
          wg_commit();
          if (ks < 3) {
            wg_wait<1>();
#pragma unroll
            for (int i = 0; i < 3; ++i)
              ldsm_x4(a_addr(s_r0, c1pix[i] + off, ks + 1, lane),
                      a[(ks + 1) & 1][i]);
          }
        }
        release(j);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) fence_regs(acc[i]);
      float bw[4][2][2];  // (b1, w_oc) of this lane's 8 channels
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = 8 * (4 * half + nt) + 2 * q + e;
          bw[nt][e][0] = __ldg(b1 + ch);
          bw[nt][e][1] = __bfloat162float(w_oc[ch]);
        }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float sum = 0.0f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d1 = __bfloat162float(__float2bfloat16_rn(
                  fmaxf(acc[i][4 * nt + 2 * hh + e] + bw[nt][e][0], 0.0f)));
              sum = fmaf(d1, bw[nt][e][1], sum);
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (q == 0) part[half * NOUT + 16 * (mt1 + i) + g + 8 * hh] = sum;
        }
    }
    __syncthreads();  // both channel halves of every pixel are in `part`;
                      // every warp done reading h
    const float boc = __ldg(b_oc);
    for (int m = tid; m < NOUT; m += blockDim.x) {
      const int gy = y0 + m / TW, gx = x0 + m % TW;
      if (gy < H && gx < W)
        out[((size_t)b * H + gy) * W + gx] =
            __frcp_rn(1.0f + __expf(-(part[m] + part[NOUT + m] + boc)));
    }
  }
}

int launch_k2_bf16(const void* dec2, const void* enc1, const void* w_up,
                   const void* b_up, const void* w0, const void* b0,
                   const void* w1, const void* b1, const void* w_oc,
                   const void* b_oc, void* out, int B, int H, int W,
                   void* stream) {
  using namespace k2;
  CUtensorMap dm, em, um, w0m, w1m;
  cudaError_t e = nhwc_map(&dm, dec2, B, H / 2, W / 2, 128, DW, DR);
  if (e == cudaSuccess) e = nhwc_map(&em, enc1, B, H, W, 64, CW, CR);
  if (e == cudaSuccess) e = rows_map(&um, w_up, 4 * 128);
  if (e == cudaSuccess) e = rows_map(&w0m, w0, 9 * 128);
  if (e == cudaSuccess) e = rows_map(&w1m, w1, 9 * 64);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k2_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k2_bf16_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_x * tiles_y;
  if (ntiles == 0) return 0;
  const int grid = ntiles < sm_count() ? ntiles : sm_count();
  k2_bf16_kernel<<<grid, WARPS * 32, SMEM, (cudaStream_t)stream>>>(
      dm, em, um, w0m, w1m, (const float*)b_up, (const float*)b0,
      (const float*)b1, (const bf16*)w_oc, (const float*)b_oc, (float*)out, H,
      W, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- K1 f32 --
namespace k1f {
constexpr int TH = 16, TW = 16, RW = TW + 2, RR = TH + 2, WARPS = 6;
constexpr int OF = (TH * RW + 15) / 16;  // output fragments
constexpr int INP = round16(cmax(RR * RW, OF * 16 + 2 * RW + 2));
constexpr int LD = ld_f32(64);
constexpr size_t IN_BYTES = (size_t)INP * LD * 4;
constexpr size_t Y_BYTES = (size_t)TH * TW * 64 * 4;
constexpr size_t SMEM = IN_BYTES + Y_BYTES + (size_t)64 * LD * 4;
}  // namespace k1f

// One block per 16x16 tile: the flat 18x18 window (output pixel m reads
// m + ky * RW + kx, the last two columns of each row computed and dropped),
// taps outermost with each tap's weights staged in shared memory, and the
// pool from the y tile in shared memory.
__global__ void __launch_bounds__(k1f::WARPS * 32)
k1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y,
              float* __restrict__ pool, int H, int W) {
  using namespace k1f;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sin = reinterpret_cast<float*>(smem);
  float* sy = reinterpret_cast<float*>(smem + IN_BYTES);
  float* sw = reinterpret_cast<float*>(smem + IN_BYTES + Y_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  load_window_f32<64>(sin, LD, 0, x + (size_t)b * H * W * 64, H, W, y0 - 1,
                      x0 - 1, RR, RW);
  zero_pixels_f32<64>(sin, LD, RR * RW, INP);

  constexpr int NF = (OF + WARPS - 1) / WARPS;
  TileF32 accs[NF];
  conv3x3_tiles_f32<64, NF, WARPS>(accs, sin, LD, RW, OF, w, sw);
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + i * WARPS;
    if (f >= OF) continue;
    const int m = f * 16 + (lane >> 1);
    const int r = m / RW, c = m % RW;
    const bool keep = r < TH && c < TW;
    const int gy = y0 + r, gx = x0 + c;
    const bool inimg = keep && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      const int o0 = 16 * n + 8 * (lane & 1);
      if (keep) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = fmaxf(accs[i].c[n][j] + bias[o0 + j], 0.0f);
        store8(sy + (size_t)(r * TW + c) * 64 + o0, v);
        if (inimg) store8(y + (((size_t)b * H + gy) * W + gx) * 64 + o0, v);
      }
    }
  }
  __syncthreads();

  constexpr int PH = TH / 2, PW = TW / 2;
  const int H2 = H / 2, W2 = W / 2;
  for (int i = threadIdx.x; i < PH * PW * 64; i += blockDim.x) {
    const int o = i % 64, p = i / 64;
    const int pr = p / PW, pc = p % PW;
    const int gy = y0 / 2 + pr, gx = x0 / 2 + pc;
    if (gy >= H2 || gx >= W2) continue;
    const float* s = sy + (size_t)(2 * pr * TW + 2 * pc) * 64 + o;
    pool[(((size_t)b * H2 + gy) * W2 + gx) * 64 + o] =
        fmaxf(fmaxf(s[0], s[64]), fmaxf(s[TW * 64], s[TW * 64 + 64]));
  }
}

int launch_k1_f32(const void* x, const void* w, const void* bias, void* y,
                  void* pool, int B, int H, int W, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      k1_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k1f::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + k1f::TW - 1) / k1f::TW, (H + k1f::TH - 1) / k1f::TH, B);
  k1_f32_kernel<<<grid, k1f::WARPS * 32, k1f::SMEM, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y,
      (float*)pool, H, W);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- K2 f32 --
namespace k2f {
constexpr int TH = 4, TW = 16, RW = TW + 4, WARPS = 8;
constexpr int CR = TH + 4;                          // concat rows
constexpr int DR = TH / 2 + 2, DW = TW / 2 + 2;     // dec2 window
constexpr int DF = (DR * DW + 15) / 16;             // upconv frags
constexpr int DP = DF * 16;
constexpr int HR = TH + 2;                          // h rows
constexpr int HF = (HR * RW + 15) / 16;             // conv0 frags
constexpr int OF = (TH * RW + 15) / 16;             // conv1 frags
constexpr int CATP = round16(cmax(CR * RW, HF * 16 + 2 * RW + 2));
constexpr int HP = round16(cmax(HF * 16, OF * 16 + 2 * RW + 2));
constexpr int LDC = ld_f32(128), LDH = ld_f32(64);
constexpr size_t CAT_BYTES = (size_t)CATP * LDC * 4;
constexpr size_t H_BYTES = (size_t)HP * LDH * 4;
constexpr size_t D_BYTES = (size_t)DP * LDC * 4;
constexpr size_t SMEM = CAT_BYTES + H_BYTES + D_BYTES + (size_t)128 * LDH * 4;
}  // namespace k2f

// One block per 4x16 output tile: up, the concat and h in shared memory
// (halo recomputed per tile), implicit GEMMs on flat regions as in K1 f32.
__global__ void __launch_bounds__(k2f::WARPS * 32)
k2_f32_kernel(const float* __restrict__ dec2, const float* __restrict__ enc1,
              const float* __restrict__ w_up, const float* __restrict__ b_up,
              const float* __restrict__ w0, const float* __restrict__ b0,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w_oc, const float* __restrict__ b_oc,
              float* __restrict__ out, int H, int W) {
  using namespace k2f;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  float* sh = reinterpret_cast<float*>(smem + CAT_BYTES);
  float* sd = reinterpret_cast<float*>(smem + CAT_BYTES + H_BYTES);
  float* sw = reinterpret_cast<float*>(smem + CAT_BYTES + H_BYTES + D_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int H2 = H / 2, W2 = W / 2;

  // dec2 window (rows y0/2-1.., cols x0/2-1..) and the enc1 half of the
  // concat window (rows y0-2.., cols x0-2..), zero outside the image
  load_window_f32<128>(sd, LDC, 0, dec2 + (size_t)b * H2 * W2 * 128, H2, W2,
                       y0 / 2 - 1, x0 / 2 - 1, DR, DW);
  zero_pixels_f32<128>(sd, LDC, DR * DW, DP);
  load_window_f32<64>(sc, LDC, 64, enc1 + (size_t)b * H * W * 64, H, W,
                      y0 - 2, x0 - 2, CR, RW);
  zero_pixels_f32<128>(sc, LDC, CR * RW, CATP);
  __syncthreads();

  // upconv1; one work item = 16 dec2 pixels x one (p, q) x 64 outputs
  for (int it = warp; it < DF * 4; it += WARPS) {
    const int f = it >> 2, pq = it & 3;
    TileF32 acc;
    acc.zero();
    const float* a = sd + (size_t)f * 16 * LDC;
    const float* bw = w_up + (size_t)pq * 128 * 64;
#pragma unroll
    for (int k0 = 0; k0 < 128; k0 += 16) acc.mma(a + k0, LDC, bw + k0 * 64, 64);
    const int m = f * 16 + (lane >> 1);
    const int dr = m / DW, dc = m % DW;
    const int ry = 2 * dr + (pq >> 1), rx = 2 * dc + (pq & 1);
    const int gy = y0 - 2 + ry, gx = x0 - 2 + rx;
    const bool valid = m < DR * DW;
    const bool inimg = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      const int o0 = 16 * n + 8 * (lane & 1);
      if (valid) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = inimg ? acc.c[n][j] + b_up[o0 + j] : 0.0f;
        store8(sc + (size_t)(ry * RW + rx) * LDC + o0, v);
      }
    }
  }

  // conv0 over the (TH+2) x (16+2) h region: 3x3, 128 -> 64, + ReLU
  constexpr int NF0 = (HF + WARPS - 1) / WARPS;
  TileF32 acc0[NF0];
  conv3x3_tiles_f32<128, NF0, WARPS>(acc0, sc, LDC, RW, HF, w0, sw);
#pragma unroll
  for (int i = 0; i < NF0; ++i) {
    const int f = warp + i * WARPS;
    if (f >= HF) continue;
    const int m = f * 16 + (lane >> 1);
    const int r = m / RW, c = m % RW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool inimg = r < HR && c < TW + 2 && gy >= 0 && gy < H && gx >= 0 &&
                       gx < W;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v[8];
      const int o0 = 16 * n + 8 * (lane & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = inimg ? fmaxf(acc0[i].c[n][j] + b0[o0 + j], 0.0f) : 0.0f;
      store8(sh + (size_t)m * LDH + o0, v);
    }
  }

  // conv1 (3x3, 64 -> 64, + ReLU) -> 1x1 head -> sigmoid
  const float boc = b_oc[0];
  constexpr int NF1 = (OF + WARPS - 1) / WARPS;
  TileF32 acc1[NF1];
  conv3x3_tiles_f32<64, NF1, WARPS>(acc1, sh, LDH, RW, OF, w1, sw);
#pragma unroll
  for (int i = 0; i < NF1; ++i) {
    const int f = warp + i * WARPS;
    if (f >= OF) continue;
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int o0 = 16 * n + 8 * (lane & 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part = fmaf(fmaxf(acc1[i].c[n][j] + b1[o0 + j], 0.0f), w_oc[o0 + j],
                    part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const int m = f * 16 + (lane >> 1);
    const int r = m / RW, c = m % RW;
    const int gy = y0 + r, gx = x0 + c;
    if ((lane & 1) == 0 && r < TH && c < TW && gy < H && gx < W)
      out[((size_t)b * H + gy) * W + gx] = 1.0f / (1.0f + expf(-(part + boc)));
  }
}

int launch_k2_f32(const void* dec2, const void* enc1, const void* w_up,
                  const void* b_up, const void* w0, const void* b0,
                  const void* w1, const void* b1, const void* w_oc,
                  const void* b_oc, void* out, int B, int H, int W,
                  void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      k2_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)k2f::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + k2f::TW - 1) / k2f::TW, (H + k2f::TH - 1) / k2f::TH, B);
  k2_f32_kernel<<<grid, k2f::WARPS * 32, k2f::SMEM, (cudaStream_t)stream>>>(
      (const float*)dec2, (const float*)enc1, (const float*)w_up,
      (const float*)b_up, (const float*)w0, (const float*)b0, (const float*)w1,
      (const float*)b1, (const float*)w_oc, (const float*)b_oc, (float*)out, H,
      W);
  return (int)cudaGetLastError();
}

}  // namespace unetdc

extern "C" {

int k1_conv3x3_relu_pool_bf16(const void* x, const void* w, const void* b,
                              void* y, void* pool, int B, int H, int W,
                              void* stream) {
  return unetdc::launch_k1_bf16(x, w, b, y, pool, B, H, W, stream);
}

int k1_conv3x3_relu_pool_f32(const void* x, const void* w, const void* b,
                             void* y, void* pool, int B, int H, int W,
                             void* stream) {
  return unetdc::launch_k1_f32(x, w, b, y, pool, B, H, W, stream);
}

int k2_dec1_head_bf16(const void* dec2, const void* enc1, const void* w_up,
                      const void* b_up, const void* w0, const void* b0,
                      const void* w1, const void* b1, const void* w_oc,
                      const void* b_oc, void* out, int B, int H, int W,
                      void* stream) {
  return unetdc::launch_k2_bf16(dec2, enc1, w_up, b_up, w0, b0, w1, b1, w_oc,
                                b_oc, out, B, H, W, stream);
}

int k2_dec1_head_f32(const void* dec2, const void* enc1, const void* w_up,
                     const void* b_up, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* w_oc,
                     const void* b_oc, void* out, int B, int H, int W,
                     void* stream) {
  return unetdc::launch_k2_f32(dec2, enc1, w_up, b_up, w0, b0, w1, b1, w_oc,
                               b_oc, out, B, H, W, stream);
}

}  // extern "C"
