// K3 k3_component_tables: per-label [pixel count, sum((row >> s) & m) for
// each shift s of the plan, sum((col >> s) & m) for each s] in exact int32,
// for labels 0 <= k < cap; other labels are dropped. Output (B, cap, 1+2k).
//
// Replaces the TPU kernel unetdc_tpu/ops/pallas_props.py::component_tables
// (body _props_kernel), which recast the sums as one-hot MXU matmuls and
// so needed per-dot f32 exactness limits (table_kernel_is_exact,
// MAX_CHUNK). Int32 atomics are exact and order-independent at any size,
// so none of those apply.
//
// Bound on the H100: bytes. The labels are read once (4 B a pixel: 15.36 MB
// at batch 8 x 600x800, 8.39 MB at 512x512) and the table written once
// (0.82 MB at cap 5120 x 5 features): 4.8 us and 2.8 us at 3.35 TB/s.
//
// A table per block that is large against the pixels it covers (zeroing,
// read-back, a flush with global atomics and a memset), one atomic a pixel
// on addresses that a droplet's lanes share, scalar loads with a division
// a pixel, and host work on every call would each cost more than reading
// the labels. So:
// - One thread-block cluster of 16 CTAs per image owns that image's table
//   in distributed shared memory. Labels are interleaved over the ranks
//   (label l is row l / 16 of rank l % 16's slice: ceil(cap / 16) rows,
//   6.4 KB at cap 5120), so the adds of an image's few labels spread over
//   its 16 SMs. Adds are red.shared::cluster on the owner's slice. After
//   cluster.sync() every CTA stores its own rows with plain stores: each
//   output word is written once, so there is no memset, no global atomic
//   and no read-back pass. At B = 8 that is 128 CTAs in one wave (two fit
//   on an SM; only 7 GPCs of an H100 take 16 CTAs at one per SM, so one
//   image's cluster shares its SMs with another's).
// - CTA r walks rows [r H / 16, (r + 1) H / 16) of its image in warp
//   steps of 512 pixels of one row: lane l scans 16 contiguous pixels
//   (four 16-byte loads where the chunk lies in the row, scalar loads at a
//   ragged head or tail, so any width and base alignment work). The row
//   is known per step and columns are a running index: no division per
//   pixel. The next step's loads are issued before the current step is
//   scanned.
// - Work only where labels are non-zero:
//   * background (label 0, most of a droplet image) by complement: the
//     CTA's band is added once in closed form (count, row and column chunk
//     sums), and every non-zero run is taken off, so a step of background
//     costs one vote;
//   * a lane finds its runs from a bit mask of run starts (no branch per
//     pixel) and turns each run [c0, c1) into a record in closed form:
//     count c1 - c0, row chunks times the count, and column chunk sums
//     from prefix sums, or, when spans start on multiples of 16 and every
//     shift is 0 or >= 4 (the engine's plans on 16-byte aligned rows), from
//     one multiply;
//   * records of one label gather in a per-lane pending record that goes
//     to the table only when the lane meets another label, and at the end
//     lanes holding the same label add once (__match_any_sync,
//     __reduce_add_sync). A large component costs a few adds per lane,
//     not one per pixel.
// - Host: the function attributes are set once per device; the plan is
//   passed by value (shifts packed into one 64-bit word).
// Tables larger than the cluster holds (cap above k3_cluster_max_cap:
// 72,080 labels at 5 features, beyond the engine's overflow re-runs at cap
// 8193 ... 65537) take the same walk with global atomics after a memset.
// The path is chosen by the table's size only; a refused launch is
// returned as an error.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace unetdc {

constexpr int K3_MAXK = 8;
constexpr int K3_THREADS = 512;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_CLUSTER = 16;  // CTAs per image (non-portable size)
constexpr int K3_SPAN = 16;     // pixels a lane scans per step
constexpr int K3_SEG = 32 * K3_SPAN / 4;  // 16-byte chunks per warp step
// Per-CTA slice limit: two CTAs fit on one SM, so a cluster needs only 8
// SMs of a GPC.
constexpr int K3_MAX_SLICE_BYTES = 88 * 1024;

struct Plan {
  int bits;
  int shifts[K3_MAXK];
};

static_assert((K3_CLUSTER & (K3_CLUSTER - 1)) == 0, "power of two");

// Label l's table row: in distributed shared memory, row l / 16 of the
// slice of cluster rank l % 16 (labels interleaved over the ranks, so the
// few labels of an image with few droplets do not all land on one SM); or
// row l of the image's table in global memory.
struct ClusterRow {
  uint32_t addr;  // shared::cluster address
  __device__ void add(int f, int v) const {
    asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(addr + 4 * f),
                 "r"(v)
                 : "memory");
  }
};
struct GlobalRow {
  int* p;
  __device__ void add(int f, int v) const { atomicAdd(p + f, v); }
};

template <bool CLUSTER>
struct Table;

template <>
struct Table<true> {
  uint32_t slice;  // shared::cta address of this CTA's slice
  int nfeat;
  __device__ ClusterRow row(int l) const {
    const uint32_t local = slice + (uint32_t)((unsigned)l / K3_CLUSTER) *
                                       (uint32_t)nfeat * 4u;
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(local), "r"((unsigned)l % K3_CLUSTER));
    return {remote};
  }
};

template <>
struct Table<false> {
  int* gout;  // the image's table (global memory)
  int nfeat;
  __device__ GlobalRow row(int l) const {
    return {gout + (size_t)l * nfeat};
  }
};

// sum over 0 <= t < x of (t >> s) & m, m = 2^bits - 1 (closed form)
__device__ __forceinline__ int chunk_prefix(int x, int s, int bits, int m) {
  const int q = x >> s, r = x & (int)((1u << s) - 1);
  const int rem = q & m;
  const int g = (q >> bits) * (m * (m + 1) / 2) + rem * (rem - 1) / 2;
  return (g << s) + r * rem;
}

// A record: n pixels of one label, their row and column chunk sums.
template <int K>
struct Rec {
  int n, r[K], c[K];
};

// Where records go: the table (label 0 < l < cap; other labels are
// dropped). A record is also taken off the background, which starts as
// every pixel of the image.
template <int K, class T>
struct Sink {
  T tab;
  int cap;

  __device__ __forceinline__ void put(int l, const Rec<K>& a,
                                      Rec<K>& bg) const {
    if (l > 0 && l < cap) {
      const auto e = tab.row(l);
      e.add(0, a.n);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (a.r[c]) e.add(1 + c, a.r[c]);
        if (a.c[c]) e.add(1 + K + c, a.c[c]);
      }
    }
    bg.n -= a.n;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      bg.r[c] -= a.r[c];
      bg.c[c] -= a.c[c];
    }
  }
};

// The pixels of one warp step: row `row`, columns [a0, a0 + 512) on the
// row's 16-byte chunk grid; lane l scans [a0 + 16 l, a0 + 16 l + 16).
struct Step {
  int row, a0;
  const int* prow;
};

__device__ __forceinline__ Step step_at(const int* img, int W, int segs,
                                        int it) {
  Step st;
  st.row = it / segs;
  const int seg = it - st.row * segs;
  st.prow = img + (size_t)st.row * W;
  st.a0 = 4 * seg * K3_SEG -
          (int)((reinterpret_cast<uintptr_t>(st.prow) >> 2) & 3);
  return st;
}

// The lane's 16 labels (0 outside the row): 16-byte loads where a chunk
// lies in the row, scalar loads at a ragged head or tail.
__device__ __forceinline__ void load_span(const Step& st, int W, int lane,
                                          int (&v)[K3_SPAN]) {
#pragma unroll
  for (int u = 0; u < K3_SPAN / 4; ++u) {
    const int e0 = st.a0 + K3_SPAN * lane + 4 * u;
    if (e0 >= 0 && e0 + 4 <= W) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(st.prow + e0));
      v[4 * u] = q.x;
      v[4 * u + 1] = q.y;
      v[4 * u + 2] = q.z;
      v[4 * u + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * u + j] =
            (e0 + j >= 0 && e0 + j < W) ? __ldg(st.prow + e0 + j) : 0;
    }
  }
}

template <int K>
struct Walk {
  int W, bits, m, lane;
  int sh[K];
  // Every lane span starts on a multiple of 16 and each shift is 0 or at
  // least 4 (with bits >= 4): then inside a span (col >> s) & m is constant
  // for s >= 4 and (col & m) = (span start & m) + offset for s = 0, so a
  // run's column sums take a multiply each instead of two prefix sums.
  bool spans16;

  // the record of the run [c0, c1) of a row with chunks rc, in the lane
  // span starting at column a
  __device__ __forceinline__ Rec<K> run(int a, int c0, int c1,
                                        const int (&rc)[K]) const {
    Rec<K> r;
    r.n = c1 - c0;
    const int tri = ((c0 + c1 - 1 - 2 * a) * r.n) >> 1;  // sum of offsets
#pragma unroll
    for (int c = 0; c < K; ++c) {
      r.r[c] = r.n * rc[c];
      r.c[c] = spans16
                   ? r.n * ((a >> sh[c]) & m) + (sh[c] == 0 ? tri : 0)
                   : chunk_prefix(c1, sh[c], bits, m) -
                         chunk_prefix(c0, sh[c], bits, m);
    }
    return r;
  }

  // A run [c0, c1) of label l (non-zero) joins the lane's pending record
  // when it holds the same label; otherwise the pending record goes to the
  // table and the run takes its place. A lane inside a large or ragged
  // component so adds to the table only when its label changes.
  template <class S>
  __device__ __forceinline__ void add_run(const S& sink, int l, int a, int c0,
                                          int c1, const int (&rc)[K],
                                          Rec<K>& bg, int& pl,
                                          Rec<K>& pr) const {
    const Rec<K> r = run(a, c0, c1, rc);
    if (l == pl) {
      pr.n += r.n;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        pr.r[c] += r.r[c];
        pr.c[c] += r.c[c];
      }
    } else {
      if (pl != 0) sink.put(pl, pr, bg);
      pl = l;
      pr = r;
    }
  }

  // One warp step. Background is counted by complement (the band's
  // pixels are added once in closed form; every non-zero run is taken
  // off), so only runs of non-zero labels cost anything: a step of
  // background costs one vote. A lane holds its first run [0, e), its last
  // run [s, 16) and, rarely, runs between them.
  template <class S>
  __device__ __forceinline__ void step(const S& sink, const Step& st,
                                       const int (&v)[K3_SPAN], Rec<K>& bg,
                                       int& pl, Rec<K>& pr) const {
    int any = 0;
#pragma unroll
    for (int p = 0; p < K3_SPAN; ++p) any |= v[p];
    if (!__any_sync(0xffffffffu, any != 0) || any == 0) return;
    int rc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) rc[c] = (st.row >> sh[c]) & m;
    unsigned starts = 1;  // bit p: a run starts at pixel p
#pragma unroll
    for (int p = 1; p < K3_SPAN; ++p)
      if (v[p] != v[p - 1]) starts |= 1u << p;
    const int a = st.a0 + K3_SPAN * lane;
    const int e = starts == 1 ? K3_SPAN : __ffs(starts & ~1u) - 1;
    if (v[0] != 0) add_run(sink, v[0], a, a, a + e, rc, bg, pl, pr);
    if (starts == 1) return;
    const int s = 31 - __clz(starts);
    for (unsigned mid = starts & ~1u & ~(1u << s); mid; mid &= mid - 1) {
      const int b = __ffs(mid) - 1;
      const int nb = __ffs(starts & ~((2u << b) - 1)) - 1;
      int l = 0;
#pragma unroll
      for (int r = 0; r < K3_SPAN; ++r) l = r == b ? v[r] : l;
      if (l != 0) add_run(sink, l, a, a + b, a + nb, rc, bg, pl, pr);
    }
    if (v[K3_SPAN - 1] != 0)
      add_run(sink, v[K3_SPAN - 1], a, a + s, a + K3_SPAN, rc, bg, pl, pr);
  }
};

template <int K, bool CLUSTER>
__global__ void __launch_bounds__(K3_THREADS, 2)
k3_kernel(const int* __restrict__ labels, int* __restrict__ out, int H, int W,
          int cap, int per, int segs, bool spans16, Plan plan) {
  constexpr int NF = 1 + 2 * K;
  extern __shared__ int slice[];
  __shared__ int bg_cta[NF];
  const int b = blockIdx.y;
  const int rank = blockIdx.x;  // == the CTA's rank in its cluster
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned full = 0xffffffffu;
  int* gout = out + (size_t)b * cap * NF;
  const int* img = labels + (size_t)b * H * W;
  // CTA r walks rows [r0, r1), segs warp steps a row
  const int r0 = (int)((long long)H * rank / gridDim.x);
  const int r1 = (int)((long long)H * (rank + 1) / gridDim.x);
  const int i0 = r0 * segs, i1 = r1 * segs;

  // the first step's loads go out before the table is set up
  int va[K3_SPAN], vb[K3_SPAN];
  int it = i0 + warp;
  if (it < i1) load_span(step_at(img, W, segs, it), W, lane, va);

  const int bits = plan.bits, m = (1 << bits) - 1;
  if (threadIdx.x == 0) {  // the band's pixels, all counted as background
    bg_cta[0] = (r1 - r0) * W;
    for (int c = 0; c < K; ++c) {
      const int s = plan.shifts[c];
      bg_cta[1 + c] = W * (chunk_prefix(r1, s, bits, m) -
                           chunk_prefix(r0, s, bits, m));
      bg_cta[1 + K + c] = (r1 - r0) * chunk_prefix(W, s, bits, m);
    }
  }
  Table<CLUSTER> tab;
  if constexpr (CLUSTER) {
    for (int i = threadIdx.x; i < per * NF; i += K3_THREADS) slice[i] = 0;
    tab.slice = smem_u32(slice);
    tab.nfeat = NF;
    cg::this_cluster().sync();  // every slice is zeroed before any add
  } else {
    tab.gout = gout;
    tab.nfeat = NF;
    __syncthreads();
  }

  const Sink<K, Table<CLUSTER>> sink = {tab, cap};
  Walk<K> wk;
  wk.W = W;
  wk.bits = bits;
  wk.m = m;
  wk.spans16 = spans16;
  wk.lane = lane;
#pragma unroll
  for (int c = 0; c < K; ++c) wk.sh[c] = plan.shifts[c];
  // Background (label 0) by complement: what the lane's runs take off.
  Rec<K> bg = {};
  int pl = 0;  // the lane's pending record: label (0: none) and sums
  Rec<K> pr = {};

  // two steps in flight: the next step's loads go out before this one is
  // scanned
  while (it < i1) {
    const int nx = it + K3_WARPS;
    if (nx < i1) load_span(step_at(img, W, segs, nx), W, lane, vb);
    wk.step(sink, step_at(img, W, segs, it), va, bg, pl, pr);
    if (nx >= i1) break;
    it = nx + K3_WARPS;
    if (it < i1) load_span(step_at(img, W, segs, it), W, lane, va);
    wk.step(sink, step_at(img, W, segs, nx), vb, bg, pl, pr);
  }

  // pending records: lanes holding the same label add once, together
  const unsigned has = __ballot_sync(full, pl != 0);
  if (pl != 0) {
    const unsigned grp = __match_any_sync(has, pl);
    Rec<K> a;
    a.n = __reduce_add_sync(grp, pr.n);
#pragma unroll
    for (int c = 0; c < K; ++c) {
      a.r[c] = __reduce_add_sync(grp, pr.r[c]);
      a.c[c] = __reduce_add_sync(grp, pr.c[c]);
    }
    if (lane == __ffs(grp) - 1) sink.put(pl, a, bg);
  }

  // background: warp sums into the CTA's row, then one add per feature
  const int wn = __reduce_add_sync(full, bg.n);
  if (lane == 0 && wn) atomicAdd(&bg_cta[0], wn);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int wr = __reduce_add_sync(full, bg.r[c]);
    const int wc = __reduce_add_sync(full, bg.c[c]);
    if (lane == 0) {
      if (wr) atomicAdd(&bg_cta[1 + c], wr);
      if (wc) atomicAdd(&bg_cta[1 + K + c], wc);
    }
  }
  __syncthreads();
  if (threadIdx.x < NF && bg_cta[threadIdx.x])
    tab.row(0).add(threadIdx.x, bg_cta[threadIdx.x]);

  if constexpr (CLUSTER) {
    // every add has landed; each CTA stores its own rows (labels
    // r, r + 16, ...): plain stores, no CTA reads another's slice
    cg::this_cluster().sync();
    const int rows = min(per, (cap - rank + K3_CLUSTER - 1) / K3_CLUSTER);
    for (int i = threadIdx.x; i < rows * NF; i += K3_THREADS) {
      const int q = i / NF;
      gout[(size_t)(q * K3_CLUSTER + rank) * NF + (i - q * NF)] = slice[i];
    }
  }
}

// Labels a cluster's table holds at 1 + 2k features.
inline int cluster_max_cap(int k) {
  return K3_MAX_SLICE_BYTES / (int)((1 + 2 * k) * sizeof(int)) * K3_CLUSTER;
}

template <int K>
cudaError_t set_attributes() {
  cudaError_t e = cudaFuncSetAttribute(
      k3_kernel<K, true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(k3_kernel<K, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              K3_MAX_SLICE_BYTES);
}

template <int K>
cudaError_t launch(const int* labels, int* out, int B, int H, int W, int cap,
                   int segs, bool spans16, const Plan& plan,
                   cudaStream_t st) {
  constexpr int NF = 1 + 2 * K;
  // set once per device (a bit each for up to 64 devices)
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(__atomic_load_n(&ready, __ATOMIC_ACQUIRE) >> dev & 1)) {
    e = set_attributes<K>();
    if (e != cudaSuccess) return e;
    __atomic_fetch_or(&ready, 1ull << dev, __ATOMIC_RELEASE);
  }
  const dim3 grid(K3_CLUSTER, B);
  if (cap <= cluster_max_cap(K)) {
    const int per = (cap + K3_CLUSTER - 1) / K3_CLUSTER;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(K3_THREADS);
    cfg.dynamicSmemBytes = (size_t)per * NF * sizeof(int);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K3_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, k3_kernel<K, true>, labels, out, H, W, cap,
                           per, segs, spans16, plan);
    if (e != cudaSuccess) return e;
  } else {
    e = cudaMemsetAsync(out, 0, (size_t)B * cap * NF * sizeof(int), st);
    if (e != cudaSuccess) return e;
    k3_kernel<K, false><<<grid, K3_THREADS, 0, st>>>(
        labels, out, H, W, cap, 0, segs, spans16, plan);
  }
  return cudaGetLastError();
}

}  // namespace unetdc

extern "C" int k3_cluster_max_cap(int k) {
  return k < 1 || k > unetdc::K3_MAXK ? 0 : unetdc::cluster_max_cap(k);
}

// shifts: shift c of the plan in bits 8c .. 8c+7.
extern "C" int k3_component_tables(const void* labels, void* out, int B, int H,
                                   int W, int cap, unsigned long long shifts,
                                   int k, int bits, void* stream) {
  using namespace unetdc;
  if (k < 1 || k > K3_MAXK || bits < 1 || bits > 8 || cap < 1 || B < 0 ||
      H < 0 || W < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  Plan plan;
  plan.bits = bits;
  for (int i = 0; i < K3_MAXK; ++i)
    plan.shifts[i] = i < k ? (int)(shifts >> (8 * i) & 0xff) : 0;
  // 16-byte chunks a row can overlap: W / 4 when every row starts on a
  // 16-byte boundary, else one more for a ragged head
  const bool aligned =
      reinterpret_cast<uintptr_t>(labels) % 16 == 0 && W % 4 == 0;
  const int chunks = aligned ? W / 4 : (W + 3) / 4 + 1;
  const int segs = (chunks + K3_SEG - 1) / K3_SEG;
  bool spans16 = aligned && bits >= 4;
  for (int i = 0; i < k; ++i)
    spans16 = spans16 && (plan.shifts[i] == 0 || plan.shifts[i] >= 4);
  const int* lab = static_cast<const int*>(labels);
  int* o = static_cast<int*>(out);
  switch (k) {
#define K3_CASE(KK) \
  case KK:          \
    return (int)launch<KK>(lab, o, B, H, W, cap, segs, spans16, plan, st);
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4)
    K3_CASE(5) K3_CASE(6) K3_CASE(7) K3_CASE(8)
#undef K3_CASE
  }
  return (int)cudaErrorInvalidValue;
}
