// K4: filter gradient of a stride-1 SAME depthwise conv with an odd K x K
// filter (K = 3 or 5), bf16 or fp32 in, fp32 out:
//
//   dw[c, dr, dc] = sum_{b,h,w} x_pad[b, c, h+dr, w+dc] * g[b, c, h, w]
//
// Replaces the TPU kernel occdepth_tpu/ops/dw_conv.py
// `dw_filter_grad_pallas` (body `_dwgrad_kernel`), the encoder backward's
// depthwise filter gradient under dw_conv_grad=pallas.
//
// What bounds it on Hopper: device-memory bytes, and, at these sizes, a
// launch's fixed cost.  Each element of g costs 2*K*K flops against one
// read of x and one of g, 4.5 (K=3) to 12.5 (K=5) flops per byte in bf16,
// below the ~20 where fp32 arithmetic would bound it.  The flagship
// encoder's 22 convs move 0.0465 ms of bytes in all, 16 of them less than
// 2 us each, so the fixed costs of a launch and of a block decide most of
// them.  What the design does about the
// previous kernel's five costs:
//
//   1. One launch per conv, no scratch buffer, no atomics (the previous
//      kernel wrote partials and summed them in a second launch).  A
//      channel whose plane is split over blocks has them in one
//      thread-block cluster (2, 4 or 8 blocks); after a cluster barrier
//      block rank 0 sums the others' K*K partials from distributed shared
//      memory in rank order.  Every sum is taken in a fixed order, so the
//      result is the same on every run.
//   2. Work sized to the plane (the previous kernel gave each channel of
//      every plane 256 threads).  A unit is (batch, channel, band of rows);
//      the wrapper's plan (`ops/dw_conv.py::dw_plan`) gives a block a warp
//      per 64 columns and a whole plane, and splits planes over a
//      cluster only while the grid is under two blocks per SM (a cluster's
//      launch and barriers cost more than the 24x77 and 12x39 planes'
//      work): the 185x610 planes go to clusters of 8, the 93x305 ones to
//      pairs, each block taking two bands.
//   3. Staging by bulk copies, filled ahead (the previous kernel loaded,
//      then computed).  In NCHW a band's rows, halo rows included, are one
//      contiguous span; one thread stages it with one `cp.async.bulk` per
//      operand (start rounded down, end rounded up to 16 bytes, completion
//      on an mbarrier) into a ring of slots, all of a block's bands at
//      once where they fit.  Rows and planes are not 16-byte aligned
//      (flagship row strides of 1220, 610, 306, 154 and 78 bytes), so a
//      span is copied as it lies and indexed at its offset; the rounding
//      never reaches outside the tensor: where it would, the few ragged
//      elements are copied by threads.  bf16 stays bf16 in shared memory.
//   4. No per-element index arithmetic (the previous kernel divided by W
//      per element): a lane owns a strip of V = 2 adjacent columns and
//      walks down its band.
//   5. Taps from registers (the previous kernel read K*K + 1 values per K*K
//      fmas): each x row's V + K - 1 values are read once and multiplied
//      by the K rows of g that use them, kept in a ring of K x V registers
//      that the unrolled loop indexes at compile time, K*K*V fmas for
//      V + K - 1 + V shared loads.  Zero padding: only the first and last
//      K - 1 steps of a walk can reach rows outside the band or the plane,
//      so only they are checked; only the column groups that touch an edge
//      mask their columns.
//
// Layout contract: x and g are contiguous NCHW; the wrapper copies
// anything else and counts the copy.  The K*K partials are reduced across
// a warp with shuffles, across warps in shared memory, across the cluster
// in distributed shared memory, all in a fixed order.
//
// Output: (C, K*K) float32, i.e. the (C, 1, K, K) weight layout.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxStages = 4;
constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
constexpr int kCols = 2;  // adjacent output columns a lane owns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}


// mbarriers, the per-warp partials and the cluster partial, then the slots
__host__ __device__ constexpr int header_bytes(int K) {
  return (8 * kMaxStages + 4 * (kMaxWarps + 1) * K * K + 127) / 128 * 128;
}

// The bytes [s, e) of one operand's band staged into a slot whose byte 0
// holds global byte `base` (s rounded down to 16).  [lo, hi) is the bulk
// copy: 16-byte aligned and inside the tensor's bytes [t0, t1); the rest of
// [s, e) is the ragged part, copied by threads.  Mirrored by
// `ops/dw_conv.py::staged_span`, which the CPU tests hold to these rules.
struct Span {
  uint64_t s, e, base, lo, hi;
};

__device__ __forceinline__ Span make_span(uint64_t s, uint64_t e, uint64_t t0,
                                          uint64_t t1) {
  Span sp;
  sp.s = s;
  sp.e = e;
  sp.base = s & ~15ull;
  sp.lo = sp.base >= t0 ? sp.base : (s + 15) & ~15ull;
  const uint64_t up = (e + 15) & ~15ull;
  sp.hi = up <= t1 ? up : e & ~15ull;
  if (sp.hi <= sp.lo) sp.lo = sp.hi = e;  // no aligned run: all ragged
  return sp;
}

// one lane's strip of V columns [w, w + V), walked down rows [h0, h1) of
// g (from `gs`, row h0) with the staged x rows [xa, xb) (from `xs`, row
// xa).  Step n (n = 0 .. h1 - h0 + K - 2) loads g row h0 + n into the ring
// gr[n % K] and reads x row h0 - P + n, which meets g rows h0 + n - dr for
// dr = 0 .. K-1.  The first K - 1 steps and the last ones may reach rows
// outside the band (g: zeros) or the plane (x: no fmas); the steps between
// run in unrolled groups of K with no checks, the ring indexed at compile
// time, so their loads can run ahead.
template <typename T, int K, int V, bool kEdge>
__device__ __forceinline__ void walk_strip(const T* xs, const T* gs, int xa,
                                           int xb, int h0, int h1, int W,
                                           int w, float (&acc)[K * K]) {
  constexpr int P = (K - 1) / 2;
  constexpr int NX = V + K - 1;
  bool okx[NX], okg[V];
#pragma unroll
  for (int j = 0; j < NX; ++j)
    okx[j] = !kEdge || (unsigned)(w + j - P) < (unsigned)W;
#pragma unroll
  for (int v = 0; v < V; ++v) okg[v] = !kEdge || w + v < W;
  float gr[K][V];
#pragma unroll
  for (int u = 0; u < K; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) gr[u][v] = 0.f;

  auto load_g = [&](int u, const T* grow) {
#pragma unroll
    for (int v = 0; v < V; ++v) gr[u][v] = okg[v] ? to_f32(grow[v]) : 0.f;
  };
  // the x row at `xrow` (column w - P) times the ring, gr[u] the newest
  auto fma_x = [&](int u, const T* xrow) {
    float xv[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) xv[j] = okx[j] ? to_f32(xrow[j]) : 0.f;
#pragma unroll
    for (int dr = 0; dr < K; ++dr)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gv = gr[(u - dr + K) % K][v];
#pragma unroll
        for (int dc = 0; dc < K; ++dc)
          acc[dr * K + dc] = fmaf(xv[v + dc], gv, acc[dr * K + dc]);
      }
  };
  const int R = h1 - h0;
  auto checked = [&](int u, int n) {
    if (n < R) {
      load_g(u, gs + n * W + w);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) gr[u][v] = 0.f;
    }
    const int xr = h0 - P + n;
    if (xr >= xa && xr < xb) fma_x(u, xs + (xr - xa) * W + (w - P));
  };

#pragma unroll
  for (int u = 0; u < K - 1; ++u) checked(u, u);
  // steps K-1 .. R-1: x rows h0 + P .. h1 - P - 1 and g rows h0 + K - 1 ..
  // h1 - 1 all lie in the band and the plane
  int n = K - 1;
  const T* gp = gs + n * W + w;
  const T* xp = xs + (h0 - P + n - xa) * W + (w - P);
  for (; n + K <= R; n += K, gp += K * W, xp += K * W) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      load_g((K - 1 + u) % K, gp + u * W);
      fma_x((K - 1 + u) % K, xp + u * W);
    }
  }
  // at most 2K - 2 steps remain, n % K == K - 1 still
  const int steps = R + K - 1;
#pragma unroll
  for (int u = 0; u < 2 * K - 2; ++u)
    if (n + u < steps) checked((K - 1 + u) % K, n + u);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
dw_filter_grad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ out, int B, int C, int H, int W,
                      int band_rows, int cluster, int stages, int x_slot,
                      int g_slot) {
  constexpr int P = (K - 1) / 2;
  constexpr int KK = K * K;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + 8 * kMaxStages);  // [warp][KK]
  float* part = red + kMaxWarps * KK;                           // [KK]
  unsigned char* slots = smem + header_bytes(K);

  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x / cluster;
  const int rank = blockIdx.x - c * cluster;
  const int n_bands = (H + band_rows - 1) / band_rows;
  const int total = B * n_bands;
  // this block's bands: rank, rank + cluster, ... of the B * n_bands
  const int mine = rank < total ? (total - rank + cluster - 1) / cluster : 0;
  const uint64_t row_bytes = (uint64_t)W * sizeof(T);
  const uint64_t plane_bytes = (uint64_t)H * row_bytes;
  const uint64_t x0 = reinterpret_cast<uint64_t>(x);
  const uint64_t g0 = reinterpret_cast<uint64_t>(g);
  const uint64_t size = (uint64_t)B * C * plane_bytes;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(hopper::smem_u32(bars + s), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  struct Band {
    int h0, h1, xa, xb;
    Span x, g;
  };
  auto band = [&](int i) {
    const int j = rank + i * cluster;
    const int b = j / n_bands;
    Band bd;
    bd.h0 = (j - b * n_bands) * band_rows;
    bd.h1 = min(bd.h0 + band_rows, H);
    bd.xa = max(bd.h0 - P, 0);
    bd.xb = min(bd.h1 + P, H);
    const uint64_t pl = ((uint64_t)b * C + c) * plane_bytes;
    bd.x = make_span(x0 + pl + bd.xa * row_bytes, x0 + pl + bd.xb * row_bytes,
                     x0, x0 + size);
    bd.g = make_span(g0 + pl + bd.h0 * row_bytes, g0 + pl + bd.h1 * row_bytes,
                     g0, g0 + size);
    return bd;
  };
  auto ragged = [&](const Span& sp, unsigned char* slot) {
    const int nh = sp.lo > sp.s ? (int)((sp.lo - sp.s) / sizeof(T)) : 0;
    const int nt = sp.hi < sp.e ? (int)((sp.e - sp.hi) / sizeof(T)) : 0;
    for (int t = threadIdx.x; t < nh + nt; t += blockDim.x) {
      const uint64_t a = t < nh ? sp.s + t * sizeof(T)
                                : sp.hi + (t - nh) * sizeof(T);
      *reinterpret_cast<T*>(slot + (a - sp.base)) =
          *reinterpret_cast<const T*>(a);
    }
  };
  // stage this block's i-th band into slot i % stages
  auto issue = [&](int i) {
    const Band bd = band(i);
    unsigned char* sx = slots + (size_t)(i % stages) * (x_slot + g_slot);
    unsigned char* sg = sx + x_slot;
    if (threadIdx.x == 0) {
      const uint32_t bar = hopper::smem_u32(bars + i % stages);
      // the slot's last readers were generic loads; order the copy after
      hopper::fence_async_shared();
      hopper::mbar_expect_tx(
          bar, (uint32_t)((bd.x.hi - bd.x.lo) + (bd.g.hi - bd.g.lo)));
      if (bd.x.hi > bd.x.lo)
        hopper::bulk_load_1d(hopper::smem_u32(sx + (bd.x.lo - bd.x.base)),
                             reinterpret_cast<const void*>(bd.x.lo),
                             (uint32_t)(bd.x.hi - bd.x.lo), bar);
      if (bd.g.hi > bd.g.lo)
        hopper::bulk_load_1d(hopper::smem_u32(sg + (bd.g.lo - bd.g.base)),
                             reinterpret_cast<const void*>(bd.g.lo),
                             (uint32_t)(bd.g.hi - bd.g.lo), bar);
    }
    ragged(bd.x, sx);
    ragged(bd.g, sg);
  };

  for (int i = 0; i < min(stages, mine); ++i) issue(i);

  float acc[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = 0.f;
  constexpr int V = kCols;
  constexpr int SW = 32 * V;  // columns of a warp's strip group
  const int ncg = (W + SW - 1) / SW;
  for (int i = 0; i < mine; ++i) {
    hopper::mbar_wait(hopper::smem_u32(bars + i % stages), (i / stages) & 1);
    __syncthreads();  // the ragged elements, stored by threads, are in
    const Band bd = band(i);
    const unsigned char* sx = slots + (size_t)(i % stages) * (x_slot + g_slot);
    const T* xs = reinterpret_cast<const T*>(sx + (bd.x.s - bd.x.base));
    const T* gs = reinterpret_cast<const T*>(sx + x_slot + (bd.g.s - bd.g.base));
    for (int grp = warp; grp < ncg; grp += nw) {
      const int w = grp * SW + lane * V;
      if (w >= W) continue;
      if (grp * SW < P || grp * SW + SW - 1 + P >= W)
        walk_strip<T, K, V, true>(xs, gs, bd.xa, bd.xb, bd.h0, bd.h1, W, w,
                                  acc);
      else
        walk_strip<T, K, V, false>(xs, gs, bd.xa, bd.xb, bd.h0, bd.h1, W, w,
                                   acc);
    }
    __syncthreads();  // every thread is done with the slot
    if (i + stages < mine) issue(i + stages);
  }

#pragma unroll
  for (int t = 0; t < KK; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * KK + t] = v;
  }
  __syncthreads();
  if (threadIdx.x < KK) {
    float s = 0.f;
    for (int i = 0; i < nw; ++i) s += red[i * KK + threadIdx.x];
    if (cluster == 1) {
      out[(size_t)c * KK + threadIdx.x] = s;
      return;
    }
    part[threadIdx.x] = s;
  }
  if (cluster == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every block's partial is in its shared memory
  if (rank == 0 && threadIdx.x < KK) {
    float s = 0.f;
    for (int r = 0; r < cluster; ++r)
      s += cl.map_shared_rank(part, r)[threadIdx.x];
    out[(size_t)c * KK + threadIdx.x] = s;
  }
  cl.sync();  // no block leaves while rank 0 reads its shared memory
}

// a block's dynamic shared memory: header, `stages` slots
long long smem_bytes(int K, int stages, int x_slot, int g_slot) {
  return header_bytes(K) + (long long)stages * (x_slot + g_slot);
}

cudaLaunchConfig_t launch_config(long long blocks, int warps, int cluster,
                                 long long smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)(32 * warps));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

template <typename T, int K>
int launch(const void* x, const void* g, float* out, long long B, long long C,
           long long H, long long W, int warps, int cluster, int band_rows,
           int stages, int x_slot, int g_slot, cudaStream_t stream) {
  auto kernel = dw_filter_grad_kernel<T, K>;
  const long long smem = smem_bytes(K, stages, x_slot, g_slot);
  const long long need_x = (long long)(band_rows + K - 1) * W * sizeof(T) + 32;
  const long long need_g = (long long)band_rows * W * sizeof(T) + 32;
  if (smem > kMaxSmem || x_slot < need_x || g_slot < need_g ||
      x_slot % 16 || g_slot % 16)
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(C * cluster, warps, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const T*>(g), out, (int)B, (int)C,
                           (int)H, (int)W, band_rows, cluster, stages, x_slot,
                           g_slot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int K>
struct Kind {
  using type = T;
  static constexpr int k = K;
};

// f(Kind<T, K>{}) for the dtype code and filter size
template <typename F>
int dispatch(int dtype, int k, F&& f) {
  using bf16 = __nv_bfloat16;
  if (dtype == 0) return k == 3 ? f(Kind<float, 3>{}) : f(Kind<float, 5>{});
  return k == 3 ? f(Kind<bf16, 3>{}) : f(Kind<bf16, 5>{});
}

bool valid(int dtype, int k, int warps, int cluster, int stages) {
  return (dtype == 0 || dtype == 1) && (k == 3 || k == 5) && warps >= 1 &&
         warps <= kMaxWarps && stages >= 1 && stages <= kMaxStages &&
         (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8);
}

}  // namespace

// x and g: contiguous (B, C, H, W), dtype 0 = float32, 1 = bfloat16; out:
// (C, k*k) float32.  The plan (ops/dw_conv.py::dw_plan): `warps` per
// block, `cluster` blocks per channel, bands of `band_rows` rows, a ring of
// `stages` slots of `x_slot` + `g_slot` bytes.
// Returns the CUDA error of the launch, -1 for an unsupported dtype, filter
// size or plan, -2 for slots that do not hold a band or exceed shared
// memory, -3 for a grid the hardware cannot launch.
extern "C" int occ_dw_filter_grad(const void* x, const void* g, float* out,
                                  int dtype, int k, long long B, long long C,
                                  long long H, long long W, int warps,
                                  int cluster, int band_rows, int stages,
                                  int x_slot, int g_slot,
                                  cudaStream_t stream) {
  if (!valid(dtype, k, warps, cluster, stages) || band_rows < 1) return -1;
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  if (C * cluster > 0x7fffffffLL || B * H > 0x7fffffffLL ||
      H * W > 0x7fffffffLL)
    return -3;
  return dispatch(dtype, k, [&](auto kind) {
    using Kd = decltype(kind);
    return launch<typename Kd::type, Kd::k>(
        x, g, out, B, C, H, W, warps, cluster, band_rows, stages, x_slot,
        g_slot, stream);
  });
}

