// Stereo-SFA cosine fusion of two views (K1), standalone and fused into
// the FLoSP lift.
//
// Replaces the TPU kernel occdepth_tpu/ops/pallas_kernels.py:118
// `stereo_cosine_fuse` (body `_fuse_kernel`).  Per voxel row:
//   cos  = <f0,f1> / (max(|f0|,eps) * max(|f1|,eps)) * m0 * m1
//   w0   = cos + [m0 > m1],   w1 = cos + [m1 > m0]
//   out  = (w0 * f0 + w1 * f1) / 2
// The formula lives once, in `fuse_row`, which both kernels call.
//
// `flosp_stereo_lift_kernel` also replaces what feeds and follows the TPU
// kernel: the FLoSP gather (occdepth_tpu/ops/flosp_gather.py:48
// `flosp_gather_flat`) and the sum over scales (occdepth_tpu/models/sfa.py
// :23 `sfa_lift`).  For each voxel it reads its pattern points' pixel
// coordinates and FOV masks in both views, gathers each in-FOV point's row
// of every scale's map, takes the mean over the in-FOV points, fuses the
// two views and sums the scales in registers, and writes the (B, N, C)
// fp32 grid once.  Nothing per view or per scale reaches device memory.
//
// What bounds both on Hopper: bytes.  The fusion is ~6 C flops per row
// against 4 C bytes of output alone; the lift moves the coordinates and
// masks once, each gathered row, and the output once.  Its index
// arithmetic is kept to shifts and multiply-adds (a 64-bit division is
// ~100 instructions, and there would be several per point and scale).
// Design (K6's pattern, csrc/row_gather.cu):
//   * a group of G threads (a power of two, at most 32) owns a voxel row;
//     each thread moves 16 bytes at a time (8 bf16 or 4 fp32 channels: a
//     64-byte bf16 row at C = 32 is four threads) and keeps its channels
//     in registers; a warp holds 32 / G rows;
//   * the three row sums are reduced across the group with __shfl_xor_sync,
//     never through memory;
//   * a row whose bytes are not a multiple of 16 (or a map whose strides
//     are not) is moved one element per thread instead (E = 1);
//   * an out-of-FOV point reads nothing (its row is the zero sentinel of
//     the plain version); table reads and coordinate reads go through the
//     read-only path, and every thread of a group reads the same
//     coordinates (one broadcast transaction);
//   * in the lift a group walks the scales in order, and for each loads
//     both views' masks and coordinates together and then both rows
//     before summing either: three dependent reads per scale become two
//     (the coordinates hit L1 after the first scale).  Keeping more rows
//     in flight per thread (two or four scales at once) read 1.2x and 2.2x
//     slower on the card: the registers it takes cut the warps an SM
//     holds, and occupancy is what hides the gathers' latency here (so
//     the kernel caps its registers for four blocks an SM);
//   * the maps are read through their strides with unit channel stride:
//     a channels-last map is read in place, an NCHW one is packed to
//     channels-last by the wrapper first (K3's packing kernel).
// Semantics of the lift are flosp_gather_flat's: coordinates at a scale s
// > 1 are floor-divided by s, the flat index y * w + x picks the row, the
// mean over P points sums in fp32 in point order and divides by the count,
// `valid` is count > 0, and the scales are summed in `project_res` order.
// An in-FOV point whose flat index falls outside the map reads NaN
// (jnp.take's fill in the JAX package; the plain version's index_select
// raises instead).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SCALES = 8;

// ---- moves of E channels, widened to fp32 ----

template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __ldg(p + e);
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[E]) {
  if constexpr (E == 8) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[q]));
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = __bfloat162float(p[e]);
  }
}

template <int E>
__device__ __forceinline__ void store_row(float* p, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}

// ---- the fusion of one row, held by a group of `group` lanes ----

// a, b: this thread's K channels of the two views (0 where it holds none);
// every lane of the warp calls it (the shuffles span the warp).
template <int K>
__device__ __forceinline__ void fuse_row(const float (&a)[K],
                                         const float (&b)[K], float m0,
                                         float m1, float eps, int group,
                                         float (&out)[K]) {
  float s00 = 0.f, s11 = 0.f, s01 = 0.f;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    s00 = fmaf(a[e], a[e], s00);
    s11 = fmaf(b[e], b[e], s11);
    s01 = fmaf(a[e], b[e], s01);
  }
  for (int off = group >> 1; off > 0; off >>= 1) {
    s00 += __shfl_xor_sync(0xffffffffu, s00, off);
    s11 += __shfl_xor_sync(0xffffffffu, s11, off);
    s01 += __shfl_xor_sync(0xffffffffu, s01, off);
  }
  const float n0 = fmaxf(sqrtf(s00), eps);
  const float n1 = fmaxf(sqrtf(s11), eps);
  const float cosv = s01 / (n0 * n1) * (m0 * m1);
  const float w0 = cosv + (m0 - m1 > 0.f ? 1.f : 0.f);
  const float w1 = cosv + (m1 - m0 > 0.f ? 1.f : 0.f);
#pragma unroll
  for (int e = 0; e < K; ++e) out[e] = (w0 * a[e] + w1 * b[e]) * 0.5f;
}

// the lane's place: row slot lane / group of the warp's 32 / group rows,
// moves slot + group * i (i < MPT) of its row
struct Lanes {
  int group, slot, row_in_warp, rows_per_warp;
  __device__ explicit Lanes(int g)
      : group(g), slot((threadIdx.x & 31) % g),
        row_in_warp((threadIdx.x & 31) / g), rows_per_warp(32 / g) {}
};

// ---- standalone K1: two strided fp32 views of per-voxel features ----

template <int E, int MPT>
__global__ void __launch_bounds__(THREADS)
stereo_cosine_fuse_kernel(const float* __restrict__ f0,
                          const float* __restrict__ f1,
                          const float* __restrict__ m0,
                          const float* __restrict__ m1,
                          float* __restrict__ out, long long rows,
                          long long n_per_batch, int C, long long f_sb,
                          long long f_sn, long long m_sb, long long m_sn,
                          float eps, int group) {
  const Lanes ln(group);
  const int moves = C / E;
  const long long warp0 = (long long)blockIdx.x * (THREADS / 32) +
                          (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * (THREADS / 32) *
                         ln.rows_per_warp;
  // warp-uniform trip count: every lane reaches the shuffles
  for (long long base = warp0 * ln.rows_per_warp; base < rows;
       base += step) {
    const long long r = base + ln.row_in_warp;
    float a[MPT * E], v[MPT * E], o[MPT * E];
#pragma unroll
    for (int i = 0; i < MPT * E; ++i) a[i] = v[i] = 0.f;
    float mk0 = 0.f, mk1 = 0.f;
    const long long bb = r / n_per_batch, n = r - bb * n_per_batch;
    const long long off = bb * f_sb + n * f_sn;
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + group * i;
        if (j < moves) {
          float t[E];
          load_row<E>(f0 + off + j * E, t);
#pragma unroll
          for (int e = 0; e < E; ++e) a[i * E + e] = t[e];
          load_row<E>(f1 + off + j * E, t);
#pragma unroll
          for (int e = 0; e < E; ++e) v[i * E + e] = t[e];
        }
      }
      mk0 = __ldg(m0 + bb * m_sb + n * m_sn);
      mk1 = __ldg(m1 + bb * m_sb + n * m_sn);
    }
    fuse_row<MPT * E>(a, v, mk0, mk1, eps, group, o);
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + group * i;
        if (j < moves) {
          float t[E];
#pragma unroll
          for (int e = 0; e < E; ++e) t[e] = o[i * E + e];
          store_row<E>(out + r * C + j * E, t);
        }
      }
    }
  }
}

// ---- the fused lift ----

struct LiftScale {
  const void* map;             // (B, 2, C, h, w) through the strides below
  long long sb, sv, sh, sw;    // in elements; the channel stride is 1
  int h, w, s;
  int log2s;                   // s = 2^log2s, or -1 when s is no power of 2
};

struct LiftArgs {
  LiftScale sc[MAX_SCALES];
  int ns;
};

__device__ __forceinline__ int floor_div(int x, int s) {
  const int q = x / s;
  return (q * s != x && (x < 0) != (s < 0)) ? q - 1 : q;
}

// The map row a point names at scale `sc`: its coordinates floor-divided
// by the scale (a shift for powers of two), then the flat index y * w + x;
// (y, x) themselves when x is in the row, else the division (a point off
// the image's sides).  False when the flat index falls off the map.
__device__ __forceinline__ bool point_row(const LiftScale& sc, int2 xy,
                                          long long* yy, long long* xx) {
  const int x = sc.log2s >= 0 ? xy.x >> sc.log2s : floor_div(xy.x, sc.s);
  const int y = sc.log2s >= 0 ? xy.y >> sc.log2s : floor_div(xy.y, sc.s);
  bool inside = x >= 0 && x < sc.w && y >= 0 && y < sc.h;
  *yy = y;
  *xx = x;
  if (x < 0 || x >= sc.w) {
    const long long idx = (long long)y * sc.w + x;
    inside = idx >= 0 && idx < (long long)sc.h * sc.w;
    *yy = inside ? idx / sc.w : 0;
    *xx = inside ? idx - *yy * sc.w : 0;
  }
  return inside;
}

// Both views' mean over the in-FOV points of voxel (bb, n) at scale `sc`:
// f[v] this lane's K channels (fp32 sums in point order, divided by the
// count; NaN where an in-FOV point falls off the map), count[v] the
// in-FOV points.  The forward and the backward gather through this.
template <typename T, int E, int MPT>
__device__ __forceinline__ void gather_views(
    const LiftScale& sc, const int2* __restrict__ pix,
    const bool* __restrict__ fov, long long bb, long long n, long long N,
    int P, bool live, const Lanes& ln, int moves, float (&f)[2][MPT * E],
    int (&count)[2]) {
  constexpr int K = MPT * E;
  const float qnan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    count[v] = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) f[v][i] = 0.f;
  }
  for (int p = 0; live && p < P; ++p) {
    // both views' point p (the mask and coordinates together; from the
    // second scale on they come from L1), then both rows, then sums
    float t[2][K];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const long long pt = ((bb * 2 + v) * N + n) * P + p;
      const bool in = __ldg(reinterpret_cast<const unsigned char*>(fov) + pt);
      count[v] += in;
      long long yy, xx;
      const bool inside = point_row(sc, __ldg(pix + pt), &yy, &xx);
      const T* row = static_cast<const T*>(sc.map) + bb * sc.sb + v * sc.sv +
                     yy * sc.sh + xx * sc.sw;
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + ln.group * i;
        const bool mine = j < moves && in;
        float u[E];
        if (mine && inside) {
          load_row<E>(row + j * E, u);
        } else {  // NaN for an in-FOV point off the map, else 0
#pragma unroll
          for (int e = 0; e < E; ++e) u[e] = mine ? qnan : 0.f;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) t[v][i * E + e] = u[e];
      }
    }
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int i = 0; i < K; ++i) f[v][i] += t[v][i];
  }
#pragma unroll
  for (int v = 0; v < 2; ++v)
    if (count[v] > 1) {
      const float c = (float)count[v];
#pragma unroll
      for (int i = 0; i < K; ++i) f[v][i] = f[v][i] / c;
    }
}

// four blocks an SM at one move a thread: registers capped at 64 (76
// uncapped, three blocks) read 1.2x faster on the card
template <typename T, int E, int MPT>
__global__ void __launch_bounds__(THREADS, MPT == 1 ? 4 : MPT == 2 ? 2 : 1)
flosp_stereo_lift_kernel(const __grid_constant__ LiftArgs args,
                         const int2* __restrict__ pix,
                         const bool* __restrict__ fov,
                         float* __restrict__ out, long long B, long long N,
                         int P, int C, float eps, int group) {
  constexpr int K = MPT * E;  // channels a thread holds
  const Lanes ln(group);
  const int moves = C / E;
  const long long rows = B * N;
  const long long warp0 = (long long)blockIdx.x * (THREADS / 32) +
                          (threadIdx.x >> 5);
  const long long step =
      (long long)gridDim.x * (THREADS / 32) * ln.rows_per_warp;
  // every lane runs every loop below the same number of times (shuffles)
  for (long long base = warp0 * ln.rows_per_warp; base < rows;
       base += step) {
    const long long r = base + ln.row_in_warp;
    const bool live = r < rows;
    // 32-bit division where it fits (64-bit division is ~100 instructions)
    const long long bb = !live ? 0
                         : rows <= 0x7fffffffLL
                             ? (long long)((unsigned)r / (unsigned)N)
                             : r / N;
    const long long n = live ? r - bb * N : 0;
    float acc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = 0.f;
    for (int si = 0; si < args.ns; ++si) {
      float f[2][K];
      int count[2];
      gather_views<T, E, MPT>(args.sc[si], pix, fov, bb, n, N, P, live, ln,
                              moves, f, count);
      float o[K];
      fuse_row<K>(f[0], f[1], count[0] > 0 ? 1.f : 0.f,
                  count[1] > 0 ? 1.f : 0.f, eps, group, o);
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] = si == 0 ? o[i] : acc[i] + o[i];
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + group * i;
        if (j < moves) {
          float u[E];
#pragma unroll
          for (int e = 0; e < E; ++e) u[e] = acc[i * E + e];
          store_row<E>(out + r * C + j * E, u);
        }
      }
    }
  }
}

// ---- the fused lift's backward ----
//
// Replaces no TPU kernel: the JAX package differentiates `sfa_lift` with
// XLA (the VJP of jnp.take is a scatter-add, the fusion's VJP comes from
// its jnp formula).  Per batch b, voxel n and scale s, with g = grad_out[b,
// n], f_v view v's mean over its in-FOV points, m_v = [count_v > 0], k_v =
// max(|f_v|, eps), c = (f0.f1) / (k0 k1) m0 m1 and w_v = c + [m_v >
// m_other] (the forward's out = (w0 f0 + w1 f1) / 2):
//   df_v = w_v g / 2 + a m0 m1 (f_o / (k_v k_o)
//                               - [|f_v| > eps] (f0.f1) f_v / (k_v^3 k_o)),
//   a    = (g.f0 + g.f1) / 2,
// and each in-FOV point of view v adds df_v / count_v to the map row it
// names at scale s (an in-FOV point whose flat index falls off the map adds
// nothing; its view's mean, and so the voxel's df, is NaN as in the
// forward).  Sums run in fp32 and are rounded once to the map's dtype.
//
// Deterministic by construction, with no floating-point atomics:
//   1. keys: every (b, v, s, n, p) slot, in that order, gets the global row
//      its point names (rows numbered scale-major, then batch, view, pixel)
//      or a sentinel past the last row (out of FOV, or off the map);
//   2. a stable LSD radix sort of the slots by key, 8 bits a pass (per
//      block digit histograms; per digit a scan over the blocks; a
//      scatter that ranks each tile's entries in order with
//      __match_any_sync): within a row, the slots stay in ascending (n, p);
//   3. bounds: each nonempty row's first and one-past-last sorted position;
//   4. windows: a group of lanes walks each fixed window of L sorted
//      entries in order; per entry it gathers both views' means as the
//      forward does (gather_views), forms df_v from five group-reduced dot
//      products, and adds df_v / count_v in fp32 registers.  A row wholly
//      inside the window is written at once; the parts of a row that spans
//      windows are kept per window (`tail` where it starts, `head` where it
//      goes on);
//   5. rows: every map row is written once, zero where no point lands, and
//      a spanning row as tail[w0] + head[w0 + 1] + ... + head[w1] in order.
// The same inputs therefore give the same bits whatever the scheduling.
// What bounds it: bytes (grad_out and the coordinates read once, every map
// row read and written once); the gathers of the window pass, and the
// sort's 3 passes over the slots, are what it pays above that.

constexpr int RADIX_ITEMS = 8;  // keys a thread ranks per radix block
static_assert(THREADS == 256, "one radix digit a thread");
constexpr int RADIX_TILE = THREADS * RADIX_ITEMS;
constexpr int BWD_WINDOW = 32;  // sorted entries a group walks in order

struct GradArgs {
  void* grad[MAX_SCALES];      // scale s's (B, 2, h, w, C) gradient, dense
  unsigned base[MAX_SCALES];   // its first global row
  unsigned total_rows;         // also the sentinel key
};

__device__ __forceinline__ unsigned group_mask(const Lanes& ln) {
  return ln.group == 32 ? 0xffffffffu
                        : ((1u << ln.group) - 1u)
                              << (ln.row_in_warp * ln.group);
}

__device__ __forceinline__ float group_sum(float x, int group,
                                           unsigned mask) {
  for (int off = group >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(mask, x, off);
  return x;
}

// E channels of a gradient row, rounded once: 16 bytes at a time when
// `vec`, else one element at a time
template <int E>
__device__ __forceinline__ void store_grad(float* p, bool vec,
                                           const float (&v)[E]) {
  if (vec && E == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = v[e];
  }
}

template <int E>
__device__ __forceinline__ void store_grad(__nv_bfloat16* p, bool vec,
                                           const float (&v)[E]) {
  if (vec && E == 8) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// Write global row q (its K channels in this lane's moves) to its map's
// gradient.  A scale's rows are numbered batch, view, then y * w + x: the
// order of its dense channels-last gradient's rows.
template <typename T, int E, int MPT>
__device__ __forceinline__ void write_row(const GradArgs& gargs, int ns,
                                          unsigned q, const Lanes& ln,
                                          int moves, int C, bool vec,
                                          const float (&acc)[MPT * E]) {
  int s = 0;
  while (s + 1 < ns && q >= gargs.base[s + 1]) ++s;
  T* row = static_cast<T*>(gargs.grad[s]) +
           (long long)(q - gargs.base[s]) * C;
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    const int j = ln.slot + ln.group * i;
    if (j < moves) {
      float u[E];
#pragma unroll
      for (int e = 0; e < E; ++e) u[e] = acc[i * E + e];
      store_grad<E>(row + j * E, vec, u);
    }
  }
}

// 1. one key per (b, v, s, n, p) slot
__global__ void __launch_bounds__(THREADS)
lift_bwd_keys_kernel(const __grid_constant__ LiftArgs args,
                     const __grid_constant__ GradArgs gargs,
                     const int2* __restrict__ pix,
                     const bool* __restrict__ fov, unsigned* __restrict__ keys,
                     long long slots, unsigned N, unsigned P) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < slots; e += (long long)gridDim.x * THREADS) {
    const unsigned u = (unsigned)e, t = u / P, p = u - t * P;
    const unsigned t2 = t / N, n = t - t2 * N;
    const unsigned bv = t2 / (unsigned)args.ns, s = t2 - bv * args.ns;
    const long long pt = ((long long)bv * N + n) * P + p;
    unsigned key = gargs.total_rows;
    if (__ldg(reinterpret_cast<const unsigned char*>(fov) + pt)) {
      long long yy, xx;
      const LiftScale& sc = args.sc[s];
      if (point_row(sc, __ldg(pix + pt), &yy, &xx))
        key = gargs.base[s] + bv * (unsigned)sc.h * (unsigned)sc.w +
              (unsigned)(yy * sc.w + xx);
    }
    keys[e] = key;
  }
}

// 2a. per block, the counts of each 8-bit digit: hist[digit * nblk + block]
__global__ void __launch_bounds__(THREADS)
lift_bwd_radix_hist_kernel(const unsigned* __restrict__ keys, long long n,
                           int shift, unsigned* __restrict__ hist, int nblk) {
  __shared__ unsigned h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long e = base + it * THREADS + threadIdx.x;
    if (e < n) atomicAdd(&h[(__ldg(keys + e) >> shift) & 255u], 1u);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * nblk + blockIdx.x] = h[threadIdx.x];
}

// exclusive scan of one value a thread over the block; returns the total
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned x,
                                                         unsigned* excl) {
  __shared__ unsigned warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = x;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  unsigned before = 0, total = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    const unsigned ws = warp_sums[w];
    before += w < warp ? ws : 0u;
    total += ws;
  }
  __syncthreads();  // warp_sums is reused by the next call
  *excl = before + inc - x;
  return total;
}

// 2b. block d scans digit d's counts over the blocks (exclusive, in place)
// and writes the digit's total
__global__ void __launch_bounds__(THREADS)
lift_bwd_radix_scan_kernel(unsigned* __restrict__ hist, int nblk,
                           unsigned* __restrict__ totals) {
  unsigned* row = hist + (long long)blockIdx.x * nblk;
  unsigned carry = 0;
  for (int base = 0; base < nblk; base += THREADS) {
    const int i = base + threadIdx.x;
    const unsigned x = i < nblk ? row[i] : 0u;
    unsigned excl;
    const unsigned total = block_exclusive_scan(x, &excl);
    if (i < nblk) row[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// 2c. stable scatter: entry e of block b goes to the digit's start, plus the
// entries of that digit in earlier blocks, plus those before it in its own
// tile (sub-tiles in order, warps in order, lanes in order).  The tile is
// first ordered by digit in shared memory, so that the writes to device
// memory come out as runs of consecutive addresses, one run per digit.
__global__ void __launch_bounds__(THREADS)
lift_bwd_radix_scatter_kernel(const unsigned* __restrict__ kin,
                              const unsigned* __restrict__ vin,
                              unsigned* __restrict__ kout,
                              unsigned* __restrict__ vout, long long n,
                              int shift, const unsigned* __restrict__ hist,
                              const unsigned* __restrict__ totals, int nblk) {
  constexpr int WARPS = THREADS / 32;
  __shared__ unsigned running[256];  // this tile's entries of each digit
  __shared__ unsigned wcount[WARPS][256];
  __shared__ unsigned woff[WARPS][256];
  __shared__ unsigned local_start[256], global_start[256];
  __shared__ unsigned skey[RADIX_TILE], sval[RADIX_TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned digit_start;
  block_exclusive_scan(__ldg(totals + tid), &digit_start);
  global_start[tid] = digit_start + hist[(long long)tid * nblk + blockIdx.x];
  running[tid] = 0;
  for (int w = 0; w < WARPS; ++w) wcount[w][tid] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  unsigned key[RADIX_ITEMS], val[RADIX_ITEMS], rank[RADIX_ITEMS];
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long e = base + it * THREADS + tid;
    const bool valid = e < n;
    key[it] = valid ? __ldg(kin + e) : 0u;
    val[it] = !valid ? 0u : vin != nullptr ? __ldg(vin + e) : (unsigned)e;
    const unsigned d = valid ? (key[it] >> shift) & 255u : 256u;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned r = __popc(peers & ((1u << lane) - 1u));
    if (valid && r == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    unsigned run = running[tid];
    for (int w = 0; w < WARPS; ++w) {
      const unsigned c = wcount[w][tid];
      woff[w][tid] = run;
      run += c;
      wcount[w][tid] = 0;
    }
    running[tid] = run;
    __syncthreads();
    rank[it] = valid ? woff[warp][d] + r : 0xffffffffu;  // within the digit
  }
  unsigned start;
  block_exclusive_scan(running[tid], &start);
  local_start[tid] = start;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it)
    if (rank[it] != 0xffffffffu) {
      const unsigned d = (key[it] >> shift) & 255u;
      skey[local_start[d] + rank[it]] = key[it];
      sval[local_start[d] + rank[it]] = val[it];
    }
  __syncthreads();
  const int count = n - base < RADIX_TILE ? (int)(n - base) : RADIX_TILE;
  for (int i = tid; i < count; i += THREADS) {
    const unsigned k = skey[i], d = (k >> shift) & 255u;
    const unsigned pos = global_start[d] + (i - local_start[d]);
    kout[pos] = k;
    vout[pos] = sval[i];
  }
}

// 3. each nonempty row's sorted positions [start, end)
__global__ void __launch_bounds__(THREADS)
lift_bwd_bounds_kernel(const unsigned* __restrict__ keys, long long n,
                       unsigned sentinel, unsigned* __restrict__ start,
                       unsigned* __restrict__ end) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const unsigned q = keys[i];
    if (q == sentinel) continue;
    if (i == 0 || keys[i - 1] != q) start[q] = (unsigned)i;
    if (i == n - 1 || keys[i + 1] != q) end[q] = (unsigned)(i + 1);
  }
}

// 4. a group of lanes per window of BWD_WINDOW sorted entries.  The walk
// is a chain of dependent gathers, so occupancy is what hides its latency:
// registers are capped as in the forward (four blocks an SM at one move a
// lane)
template <typename T, int E, int MPT>
__global__ void __launch_bounds__(THREADS, MPT == 1 ? 4 : MPT == 2 ? 2 : 1)
lift_bwd_window_kernel(const __grid_constant__ LiftArgs args,
                       const __grid_constant__ GradArgs gargs,
                       const int2* __restrict__ pix,
                       const bool* __restrict__ fov,
                       const float* __restrict__ gout,
                       const unsigned* __restrict__ keys,
                       const unsigned* __restrict__ vals, long long n,
                       float* __restrict__ head, float* __restrict__ tail,
                       unsigned N, unsigned P, int C, float eps, int group,
                       bool vec_out, bool vec_g) {
  constexpr int K = MPT * E;
  const Lanes ln(group);
  const unsigned gmask = group_mask(ln);
  const int moves = C / E;
  const unsigned sentinel = gargs.total_rows;
  const long long nwin = (n + BWD_WINDOW - 1) / BWD_WINDOW;
  const long long groups = (long long)gridDim.x * (THREADS / 32) *
                           ln.rows_per_warp;
  for (long long w = ((long long)blockIdx.x * (THREADS / 32) +
                      (threadIdx.x >> 5)) * ln.rows_per_warp +
                     ln.row_in_warp;
       w < nwin; w += groups) {
    const long long lo = w * BWD_WINDOW;
    const long long hi = lo + BWD_WINDOW < n ? lo + BWD_WINDOW : n;
    unsigned cur = keys[lo];
    if (cur == sentinel) continue;
    const bool head_open = lo > 0 && keys[lo - 1] == cur;
    bool first = true;
    float acc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = 0.f;
    // a row's sum goes to the map when it lies wholly in the window, else
    // to head[w] (it began before) or tail[w] (it goes on after)
    auto flush = [&](bool began_before, bool goes_on) {
      if (!began_before && !goes_on) {
        write_row<T, E, MPT>(gargs, args.ns, cur, ln, moves, C, vec_out,
                             acc);
        return;
      }
      float* part = (began_before ? head : tail) + w * C;
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + group * i;
        if (j < moves)
#pragma unroll
          for (int e = 0; e < E; ++e) part[j * E + e] = acc[i * E + e];
      }
    };
    long long i = lo;
    unsigned q = cur, slot = vals[lo];
    for (; i < hi; ++i) {
      if (q == sentinel) break;
      if (q != cur) {
        flush(first && head_open, false);
        first = false;
        cur = q;
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = 0.f;
      }
      // the next entry's key and slot load while this one is summed
      const unsigned this_slot = slot;
      if (i + 1 < hi) {
        q = keys[i + 1];
        slot = vals[i + 1];
      } else {
        q = sentinel;
      }
      // the slot's (b, v, s, n): slots run (b, v, s, n, p)
      const unsigned t = this_slot / P, t2 = t / N, nn = t - t2 * N;
      const unsigned bv = t2 / (unsigned)args.ns, s = t2 - bv * args.ns;
      const int v = bv & 1;
      const long long bb = bv >> 1;
      float f[2][K];
      int count[2];
      gather_views<T, E, MPT>(args.sc[s], pix, fov, bb, nn, N, P, true, ln,
                              moves, f, count);
      float g[K];
#pragma unroll
      for (int k = 0; k < MPT; ++k) {
        const int j = ln.slot + group * k;
        float u[E];
        const float* gp = gout + (bb * N + nn) * C + j * E;
        if (j < moves && vec_g) {
          load_row<E>(gp, u);
        } else if (j < moves) {
#pragma unroll
          for (int e = 0; e < E; ++e) u[e] = __ldg(gp + e);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) u[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) g[k * E + e] = u[e];
      }
      float s00 = 0.f, s11 = 0.f, s01 = 0.f, g0 = 0.f, g1 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        s00 = fmaf(f[0][k], f[0][k], s00);
        s11 = fmaf(f[1][k], f[1][k], s11);
        s01 = fmaf(f[0][k], f[1][k], s01);
        g0 = fmaf(g[k], f[0][k], g0);
        g1 = fmaf(g[k], f[1][k], g1);
      }
      s00 = group_sum(s00, group, gmask);
      s11 = group_sum(s11, group, gmask);
      s01 = group_sum(s01, group, gmask);
      g0 = group_sum(g0, group, gmask);
      g1 = group_sum(g1, group, gmask);
      // the forward's fusion (fuse_row), then its derivative for view v
      const float m0 = count[0] > 0 ? 1.f : 0.f;
      const float m1 = count[1] > 0 ? 1.f : 0.f;
      const float n0 = sqrtf(s00), n1 = sqrtf(s11);
      const float k0 = fmaxf(n0, eps), k1 = fmaxf(n1, eps);
      const float cosv = s01 / (k0 * k1) * (m0 * m1);
      const float mv = v ? m1 : m0, mo = v ? m0 : m1;
      const float kv = v ? k1 : k0, ko = v ? k0 : k1;
      const float nv = v ? n1 : n0;
      const float alpha = 0.5f * (cosv + (mv - mo > 0.f ? 1.f : 0.f));
      const float a = 0.5f * (g0 + g1) * (m0 * m1);
      const float gamma = a / (kv * ko);
      const float beta = nv > eps ? -a * s01 / (kv * kv * kv * ko) : 0.f;
      const float cnt = (float)(v ? count[1] : count[0]);
      // f[v] by selects: a register array indexed at run time would live
      // in local memory
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float fv = v ? f[1][k] : f[0][k], fo = v ? f[0][k] : f[1][k];
        acc[k] += (alpha * g[k] + beta * fv + gamma * fo) / cnt;
      }
    }
    flush(first && head_open, i == hi && hi < n && keys[hi] == cur);
  }
}

// 5. every map row once: zero, written in step 4, or its parts summed
template <typename T, int E, int MPT>
__global__ void __launch_bounds__(THREADS)
lift_bwd_rows_kernel(const __grid_constant__ LiftArgs args,
                     const __grid_constant__ GradArgs gargs,
                     const unsigned* __restrict__ start,
                     const unsigned* __restrict__ end,
                     const float* __restrict__ head,
                     const float* __restrict__ tail, int C, int group,
                     bool vec_out) {
  constexpr int K = MPT * E;
  const Lanes ln(group);
  const int moves = C / E;
  const long long rows = gargs.total_rows;
  const long long groups = (long long)gridDim.x * (THREADS / 32) *
                           ln.rows_per_warp;
  for (long long q = ((long long)blockIdx.x * (THREADS / 32) +
                      (threadIdx.x >> 5)) * ln.rows_per_warp +
                     ln.row_in_warp;
       q < rows; q += groups) {
    const unsigned a = start[q], b = end[q];
    const unsigned w0 = a / BWD_WINDOW, w1 = (b - 1) / BWD_WINDOW;
    if (a != b && w0 == w1) continue;  // written by its window
    float acc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i] = 0.f;
    if (a != b) {
      for (unsigned w = w0; w <= w1; ++w) {
        const float* part = (w == w0 ? tail : head) + (long long)w * C;
#pragma unroll
        for (int i = 0; i < MPT; ++i) {
          const int j = ln.slot + group * i;
          if (j < moves)
#pragma unroll
            for (int e = 0; e < E; ++e) acc[i * E + e] += part[j * E + e];
        }
      }
    }
    write_row<T, E, MPT>(gargs, args.ns, (unsigned)q, ln, moves, C, vec_out,
                         acc);
  }
}

// the group size and moves per thread for `moves` moves per row, or
// false when a row needs more than 4 moves per lane of a warp
bool plan(int moves, int* group, int* mpt) {
  int g = 1;
  while (g < moves && g < 32) g *= 2;
  const int m = (moves + g - 1) / g;
  if (m > 4) return false;
  *group = g;
  *mpt = m <= 1 ? 1 : m <= 2 ? 2 : 4;
  return true;
}

long long grid_for(long long rows, int group) {
  const long long rows_per_block = (long long)(THREADS / 32) * (32 / group);
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  return blocks < 132LL * 16 ? blocks : 132LL * 16;  // the loop takes the rest
}

template <int E, int MPT>
int launch_fuse(const float* f0, const float* f1, const float* m0,
                const float* m1, float* out, long long rows, long long npb,
                int C, long long f_sb, long long f_sn, long long m_sb,
                long long m_sn, float eps, int group, cudaStream_t stream) {
  stereo_cosine_fuse_kernel<E, MPT>
      <<<(unsigned)grid_for(rows, group), THREADS, 0, stream>>>(
          f0, f1, m0, m1, out, rows, npb, C, f_sb, f_sn, m_sb, m_sn, eps,
          group);
  return (int)cudaGetLastError();
}

template <typename T, int E, int MPT>
int launch_lift(const LiftArgs& args, const int2* pix, const bool* fov,
                float* out, long long B, long long N, int P, int C, float eps,
                int group, cudaStream_t stream) {
  flosp_stereo_lift_kernel<T, E, MPT>
      <<<(unsigned)grid_for(B * N, group), THREADS, 0, stream>>>(
          args, pix, fov, out, B, N, P, C, eps, group);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int dispatch_lift(const LiftArgs& args, const int2* pix, const bool* fov,
                  float* out, long long B, long long N, int P, int C,
                  float eps, cudaStream_t stream) {
  int group, mpt;
  if (!plan(C / E, &group, &mpt)) return -3;
  if (mpt == 1)
    return launch_lift<T, E, 1>(args, pix, fov, out, B, N, P, C, eps, group,
                                stream);
  if (mpt == 2)
    return launch_lift<T, E, 2>(args, pix, fov, out, B, N, P, C, eps, group,
                                stream);
  return launch_lift<T, E, 4>(args, pix, fov, out, B, N, P, C, eps, group,
                              stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the scales' maps and geometry (see occ_flosp_stereo_lift) as LiftArgs;
// *vec stays true only when every row can move 16 bytes at a time.
// Returns 0 or -3 for sizes the kernels cannot take.
int lift_args(const void* const* maps, const long long* geom, int ns,
              int es, LiftArgs* args, bool* vec) {
  args->ns = ns;
  for (int s = 0; s < ns; ++s) {
    const long long* g = geom + 7 * s;
    if (g[4] * g[5] > 0x7fffffffLL || g[6] < 1 || g[6] > (1 << 30))
      return -3;
    const int sdiv = (int)g[6];
    int log2s = 0;
    while ((1 << log2s) < sdiv) ++log2s;
    args->sc[s] = LiftScale{maps[s], g[0], g[1], g[2], g[3], (int)g[4],
                            (int)g[5], sdiv,
                            (1 << log2s) == sdiv ? log2s : -1};
    for (int i = 0; i < 4; ++i) *vec = *vec && (g[i] * es) % 16 == 0;
    *vec = *vec && aligned16(maps[s]);
  }
  return 0;
}

// the backward's scratch, carved from one buffer (256-byte aligned parts)
struct BwdWork {
  unsigned *keys[2], *vals[2], *hist, *totals, *start, *end;
  float *head, *tail;
  long long bytes;
};

BwdWork bwd_work(char* base, long long slots, long long rows, int C) {
  const long long nblk = (slots + RADIX_TILE - 1) / RADIX_TILE;
  const long long nwin = (slots + BWD_WINDOW - 1) / BWD_WINDOW;
  BwdWork w{};
  long long off = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  for (int i = 0; i < 2; ++i) {
    w.keys[i] = reinterpret_cast<unsigned*>(take(slots * 4));
    w.vals[i] = reinterpret_cast<unsigned*>(take(slots * 4));
  }
  w.hist = reinterpret_cast<unsigned*>(take(256 * nblk * 4));
  w.totals = reinterpret_cast<unsigned*>(take(256 * 4));
  w.start = reinterpret_cast<unsigned*>(take(rows * 4));
  w.end = reinterpret_cast<unsigned*>(take(rows * 4));
  w.head = reinterpret_cast<float*>(take(nwin * C * 4));
  w.tail = reinterpret_cast<float*>(take(nwin * C * 4));
  w.bytes = off;
  return w;
}

template <typename T, int E, int MPT>
int launch_lift_backward_rows(const LiftArgs& args, const GradArgs& gargs,
                              const int2* pix, const bool* fov,
                              const float* gout, const BwdWork& w,
                              const unsigned* keys, const unsigned* vals,
                              long long slots, long long N, int P, int C,
                              float eps, int group, bool vec_out, bool vec_g,
                              cudaStream_t stream) {
  const long long nwin = (slots + BWD_WINDOW - 1) / BWD_WINDOW;
  if (nwin > 0)
    lift_bwd_window_kernel<T, E, MPT>
        <<<(unsigned)grid_for(nwin, group), THREADS, 0, stream>>>(
            args, gargs, pix, fov, gout, keys, vals, slots, w.head, w.tail,
            (unsigned)N, (unsigned)P, C, eps, group, vec_out, vec_g);
  lift_bwd_rows_kernel<T, E, MPT>
      <<<(unsigned)grid_for(gargs.total_rows, group), THREADS, 0, stream>>>(
          args, gargs, w.start, w.end, w.head, w.tail, C, group, vec_out);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int dispatch_lift_backward(const LiftArgs& args, const GradArgs& gargs,
                           const int2* pix, const bool* fov,
                           const float* gout, const BwdWork& w,
                           const unsigned* keys, const unsigned* vals,
                           long long slots, long long N, int P, int C,
                           float eps, bool vec_out, bool vec_g,
                           cudaStream_t stream) {
  int group, mpt;
  if (!plan(C / E, &group, &mpt)) return -3;
#define OCC_BWD(M_)                                                         \
  if (mpt == M_)                                                            \
    return launch_lift_backward_rows<T, E, M_>(                             \
        args, gargs, pix, fov, gout, w, keys, vals, slots, N, P, C, eps,    \
        group, vec_out, vec_g, stream);
  OCC_BWD(1) OCC_BWD(2) OCC_BWD(4)
#undef OCC_BWD
  return -3;
}

}  // namespace

// f0, f1: (batch, n_per_batch, C) fp32 with unit channel stride and the
// batch and row strides given (in elements); masks likewise; out
// (batch * n_per_batch, C) contiguous.  Returns the CUDA error code of the
// launch, -3 for a row the kernel cannot take (C > 128 not a multiple of
// 4, or C > 512).
extern "C" int occ_stereo_cosine_fuse(const float* f0, const float* f1,
                                      const float* m0, const float* m1,
                                      float* out, long long batch,
                                      long long n_per_batch, int C,
                                      long long f_sb, long long f_sn,
                                      long long m_sb, long long m_sn,
                                      float eps, cudaStream_t stream) {
  const long long rows = batch * n_per_batch;
  if (rows == 0 || C == 0) return 0;
  const bool vec = C % 4 == 0 && f_sb % 4 == 0 && f_sn % 4 == 0 &&
                   aligned16(f0) && aligned16(f1) && aligned16(out);
  const int E = vec ? 4 : 1;
  int group, mpt;
  if (!plan(C / E, &group, &mpt)) return -3;
#define OCC_FUSE(E_, M_)                                                    \
  if (E == E_ && mpt == M_)                                                 \
    return launch_fuse<E_, M_>(f0, f1, m0, m1, out, rows, n_per_batch, C,   \
                               f_sb, f_sn, m_sb, m_sn, eps, group, stream);
  OCC_FUSE(4, 1) OCC_FUSE(4, 2) OCC_FUSE(4, 4)
  OCC_FUSE(1, 1) OCC_FUSE(1, 2) OCC_FUSE(1, 4)
#undef OCC_FUSE
  return -3;
}

// The fused lift.  maps[s]: scale s's (B, 2, C, h, w) map, unit channel
// stride; geom[7 s ..]: its batch, view, row and column strides in
// elements, h, w and the scale divisor.  pix (B, 2, N, P, 2) int32 and
// fov (B, 2, N, P) bool contiguous; out (B, N, C) fp32 contiguous.
// dtype: 0 = float32 maps, 1 = bfloat16.  Returns the CUDA error code of
// the launch, -1 for an unknown dtype, -3 for sizes the kernel cannot take.
extern "C" int occ_flosp_stereo_lift(const void* const* maps,
                                     const long long* geom, int ns,
                                     const int* pix, const bool* fov,
                                     float* out, int dtype, long long B,
                                     long long N, int P, int C, float eps,
                                     cudaStream_t stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  if (ns < 1 || ns > MAX_SCALES || P < 1) return -3;
  if (dtype != 0 && dtype != 1) return -1;
  const int es = dtype == 0 ? 4 : 2;
  LiftArgs args{};
  bool vec = (C * es) % 16 == 0 && aligned16(out);
  if (lift_args(maps, geom, ns, es, &args, &vec) != 0) return -3;
  if (reinterpret_cast<uintptr_t>(pix) % 8 != 0) return -3;
  const int2* p2 = reinterpret_cast<const int2*>(pix);
  if (dtype == 0)
    return vec ? dispatch_lift<float, 4>(args, p2, fov, out, B, N, P, C, eps,
                                         stream)
               : dispatch_lift<float, 1>(args, p2, fov, out, B, N, P, C, eps,
                                         stream);
  return vec ? dispatch_lift<__nv_bfloat16, 8>(args, p2, fov, out, B, N, P, C,
                                               eps, stream)
             : dispatch_lift<__nv_bfloat16, 1>(args, p2, fov, out, B, N, P, C,
                                               eps, stream);
}

// Bytes of scratch occ_flosp_stereo_lift_backward needs for B * 2 * ns * N
// * P point slots, `rows` map rows over all scales, batch items and views,
// and C channels.
extern "C" long long occ_flosp_stereo_lift_backward_workspace(
    long long slots, long long rows, int C) {
  return bwd_work(nullptr, slots, rows, C).bytes;
}

// The fused lift's backward: every map's gradient, deterministic (see the
// comment above lift_bwd_keys_kernel).  maps, geom, ns, pix, fov, dtype,
// B, N, P, C and eps as occ_flosp_stereo_lift (maps read with unit channel
// stride); grads[s]: scale s's gradient in the map's dtype, a contiguous
// (B, 2, h, w, C) buffer; gout (B, N, C) fp32 contiguous; work: the bytes
// that occ_flosp_stereo_lift_backward_workspace gives, 256-byte aligned.
// Returns the CUDA error code of the launches, -1 for an unknown dtype, -3
// for sizes the kernels cannot take.
extern "C" int occ_flosp_stereo_lift_backward(
    const void* const* maps, const long long* geom, void* const* grads,
    int ns, const int* pix, const bool* fov,
    const float* gout, void* work, int dtype, long long B, long long N,
    int P, int C, float eps, cudaStream_t stream) {
  if (ns < 1 || ns > MAX_SCALES || P < 1) return -3;
  if (dtype != 0 && dtype != 1) return -1;
  const int es = dtype == 0 ? 4 : 2;
  LiftArgs args{};
  bool vec = (C * es) % 16 == 0;
  if (lift_args(maps, geom, ns, es, &args, &vec) != 0) return -3;
  GradArgs gargs{};
  long long rows = 0;
  bool vec_out = (C * es) % 16 == 0;
  for (int s = 0; s < ns; ++s) {
    gargs.grad[s] = grads[s];
    gargs.base[s] = (unsigned)rows;
    rows += B * 2 * (long long)args.sc[s].h * args.sc[s].w;
    vec_out = vec_out && aligned16(grads[s]);
  }
  const long long slots = B * 2 * ns * N * P;
  // keys, slots and rows in 32 bits, the sentinel key past the last row
  if (rows >= 0x7fffffffLL || slots >= 0x7fffffffLL) return -3;
  if (reinterpret_cast<uintptr_t>(pix) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return -3;
  gargs.total_rows = (unsigned)rows;
  if (rows == 0 || C == 0) return 0;
  const BwdWork w = bwd_work(static_cast<char*>(work), slots, rows, C);
  const int2* p2 = reinterpret_cast<const int2*>(pix);
  // enough 8-bit digits for the sentinel key; the sorted keys and slots end
  // in buffer (passes & 1)
  int passes = 1;
  while (passes < 4 && (rows >> (8 * passes)) != 0) ++passes;
  cudaMemsetAsync(w.start, 0, rows * 4, stream);
  cudaMemsetAsync(w.end, 0, rows * 4, stream);
  if (slots > 0) {
    const long long kb = (slots + THREADS - 1) / THREADS;
    const unsigned grid = (unsigned)(kb < 132LL * 16 ? kb : 132LL * 16);
    lift_bwd_keys_kernel<<<grid, THREADS, 0, stream>>>(
        args, gargs, p2, fov, w.keys[0], slots, (unsigned)N, (unsigned)P);
    const int nblk = (int)((slots + RADIX_TILE - 1) / RADIX_TILE);
    for (int pass = 0; pass < passes; ++pass) {
      const int in = pass & 1, out = in ^ 1;
      lift_bwd_radix_hist_kernel<<<nblk, THREADS, 0, stream>>>(
          w.keys[in], slots, 8 * pass, w.hist, nblk);
      lift_bwd_radix_scan_kernel<<<256, THREADS, 0, stream>>>(w.hist, nblk,
                                                              w.totals);
      lift_bwd_radix_scatter_kernel<<<nblk, THREADS, 0, stream>>>(
          w.keys[in], pass == 0 ? nullptr : w.vals[in], w.keys[out],
          w.vals[out], slots, 8 * pass, w.hist, w.totals, nblk);
    }
    lift_bwd_bounds_kernel<<<grid, THREADS, 0, stream>>>(
        w.keys[passes & 1], slots, gargs.total_rows, w.start, w.end);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const unsigned* keys = w.keys[passes & 1];
  const unsigned* vals = w.vals[passes & 1];
  const bool vec_g = C % 4 == 0 && aligned16(gout);
  if (dtype == 0)
    return vec ? dispatch_lift_backward<float, 4>(
                     args, gargs, p2, fov, gout, w, keys, vals, slots, N, P,
                     C, eps, vec_out, vec_g, stream)
               : dispatch_lift_backward<float, 1>(
                     args, gargs, p2, fov, gout, w, keys, vals, slots, N, P,
                     C, eps, vec_out, vec_g, stream);
  return vec ? dispatch_lift_backward<__nv_bfloat16, 8>(
                   args, gargs, p2, fov, gout, w, keys, vals, slots, N, P, C,
                   eps, vec_out, vec_g, stream)
             : dispatch_lift_backward<__nv_bfloat16, 1>(
                   args, gargs, p2, fov, gout, w, keys, vals, slots, N, P, C,
                   eps, vec_out, vec_g, stream);
}
