// Stereo-SFA cosine fusion of two views (K1), standalone and fused into
// the FLoSP lift, with both backwards.
//
// Replaces the TPU kernel occdepth_tpu/ops/pallas_kernels.py:118
// `stereo_cosine_fuse` (body `_fuse_kernel`).  Per voxel row:
//   cos  = <f0,f1> / (max(|f0|,eps) * max(|f1|,eps)) * m0 * m1
//   w0   = cos + [m0 > m1],   w1 = cos + [m1 > m0]
//   out  = (w0 * f0 + w1 * f1) / 2
// The formula lives once, in `fuse_weights`, and its derivative once, in
// `fuse_grad`; every kernel below calls them.
//
// `lift_vector_kernel` also replaces what feeds and follows the TPU
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
// masks once, each gathered row, and the output once.  Measured on the
// card (NVIDIA H100 80GB HBM3, 700 W), what holds the lift above that bound
// is the work of each lane and the latency of each gather, not DRAM
// locality (voxels sorted by pixel ran no faster): the lift's time grew
// with the lanes a row takes.  The design:
//   * a group of G lanes (a power of two, at most 32) owns a voxel row;
//     each lane moves 16-byte chunks (8 bf16 or 4 fp32 channels) and keeps
//     its channels in registers; the row sums are reduced across the group
//     with __shfl_xor_sync, never through memory;
//   * a padded row (K3's packing pads C to a multiple of 8) moves whole, Cp
//     channels, the pad channels dropped in registers: NYU's C = 100 in
//     bf16 is thirteen 16-byte chunks, not 100 one-element moves;
//   * the voxel's coordinates and masks are read once for all scales, and
//     with one point a voxel the next scale's rows are loaded, still
//     packed (4 registers a chunk), while the current scale is fused: a
//     voxel waits for one gather, not one a scale; the registers stay
//     capped for four resident blocks an SM (a staged variant that kept
//     whole tiles of rows in shared memory by cp.async held too many
//     registers per lane and ran slower at C = 32 and 64);
//   * the maps are read through their strides with unit channel stride,
//     every stride a multiple of 16 bytes (the caller packs any other map
//     to padded channels-last rows first).
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
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = __bfloat162float(p[e]);
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

// a 16-byte chunk of a row (8 bf16 or 4 fp32 channels), widened to fp32
__device__ __forceinline__ void chunk_to_f32(const uint4& x, float (&u)[4]) {
  u[0] = __uint_as_float(x.x); u[1] = __uint_as_float(x.y);
  u[2] = __uint_as_float(x.z); u[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void chunk_to_f32(const uint4& x, float (&u)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[q]));
    u[2 * q] = f.x;
    u[2 * q + 1] = f.y;
  }
}

// ---- the fusion of one row and its derivative, held by `group` lanes ----

// sum over the lanes of a group (every lane of the warp calls it: the
// shuffles span the warp)
__device__ __forceinline__ float group_sum(float x, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the weights of fuse_row's two views from the dot products s00 = a.a,
// s11 = b.b and s01 = a.b of this thread's channels, reduced over the group
__device__ __forceinline__ void fuse_weights(float s00, float s11, float s01,
                                             float m0, float m1, float eps,
                                             int group, float* w0,
                                             float* w1) {
  s00 = group_sum(s00, group);
  s11 = group_sum(s11, group);
  s01 = group_sum(s01, group);
  const float n0 = fmaxf(sqrtf(s00), eps);
  const float n1 = fmaxf(sqrtf(s11), eps);
  const float cosv = s01 / (n0 * n1) * (m0 * m1);
  *w0 = cosv + (m0 - m1 > 0.f ? 1.f : 0.f);
  *w1 = cosv + (m1 - m0 > 0.f ? 1.f : 0.f);
}

template <int K>
__device__ __forceinline__ void fuse_weights(const float (&a)[K],
                                             const float (&b)[K], float m0,
                                             float m1, float eps, int group,
                                             float* w0, float* w1) {
  float s00 = 0.f, s11 = 0.f, s01 = 0.f;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    s00 = fmaf(a[e], a[e], s00);
    s11 = fmaf(b[e], b[e], s11);
    s01 = fmaf(a[e], b[e], s01);
  }
  fuse_weights(s00, s11, s01, m0, m1, eps, group, w0, w1);
}

template <int K>
__device__ __forceinline__ void fuse_row(const float (&a)[K],
                                         const float (&b)[K], float m0,
                                         float m1, float eps, int group,
                                         float (&out)[K]) {
  float w0, w1;
  fuse_weights<K>(a, b, m0, m1, eps, group, &w0, &w1);
#pragma unroll
  for (int e = 0; e < K; ++e) out[e] = (w0 * a[e] + w1 * b[e]) * 0.5f;
}

// The gradient of fuse_row given the output's gradient g, from five
// group-reduced dot products.  With k_v = max(|f_v|, eps), c = (f0.f1) /
// (k0 k1), a = (g.f0 + g.f1) / 2 and w_v as in fuse_row:
//   df_v = w_v g / 2 + a m0 m1 (f_o / (k_v k_o)
//                               - [|f_v| > eps] (f0.f1) f_v / (k_v^3 k_o))
//        = alpha_v g + beta_v f_v + gamma f_o,
//   dm0 = a c m1,  dm1 = a c m0   (ac = a c).
struct FuseGrad {
  float alpha0, alpha1, beta0, beta1, gamma, ac;
};

// from the dot products s00 = f0.f0, s11 = f1.f1, s01 = f0.f1, g0 = g.f0
// and g1 = g.f1 of this thread's channels, reduced over the group
__device__ __forceinline__ FuseGrad fuse_grad(float s00, float s11,
                                              float s01, float g0, float g1,
                                              float m0, float m1, float eps,
                                              int group) {
  s00 = group_sum(s00, group);
  s11 = group_sum(s11, group);
  s01 = group_sum(s01, group);
  g0 = group_sum(g0, group);
  g1 = group_sum(g1, group);
  const float n0 = sqrtf(s00), n1 = sqrtf(s11);
  const float k0 = fmaxf(n0, eps), k1 = fmaxf(n1, eps);
  const float c = s01 / (k0 * k1);
  const float cosv = c * (m0 * m1);
  const float a = 0.5f * (g0 + g1);
  const float am = a * (m0 * m1);
  FuseGrad r;
  r.alpha0 = 0.5f * (cosv + (m0 - m1 > 0.f ? 1.f : 0.f));
  r.alpha1 = 0.5f * (cosv + (m1 - m0 > 0.f ? 1.f : 0.f));
  r.gamma = am / (k0 * k1);
  r.beta0 = n0 > eps ? -am * s01 / (k0 * k0 * k0 * k1) : 0.f;
  r.beta1 = n1 > eps ? -am * s01 / (k1 * k1 * k1 * k0) : 0.f;
  r.ac = a * c;
  return r;
}

template <int K>
__device__ __forceinline__ FuseGrad fuse_grad(const float (&f0)[K],
                                              const float (&f1)[K],
                                              const float (&g)[K], float m0,
                                              float m1, float eps,
                                              int group) {
  float s00 = 0.f, s11 = 0.f, s01 = 0.f, g0 = 0.f, g1 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s00 = fmaf(f0[k], f0[k], s00);
    s11 = fmaf(f1[k], f1[k], s11);
    s01 = fmaf(f0[k], f1[k], s01);
    g0 = fmaf(g[k], f0[k], g0);
    g1 = fmaf(g[k], f1[k], g1);
  }
  return fuse_grad(s00, s11, s01, g0, g1, m0, m1, eps, group);
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

// K1's backward: per row the features' and masks' gradients
// (fuse_grad), rows independent, so no sort and no atomics.  Replaces
// no TPU kernel (the JAX package differentiates the jnp formula); it is
// bound by bytes as the forward is: f0, f1 and the output's gradient
// read once, df0 and df1 written once.
template <int E, int MPT>
__global__ void __launch_bounds__(THREADS)
stereo_cosine_fuse_backward_kernel(
    const float* __restrict__ f0, const float* __restrict__ f1,
    const float* __restrict__ m0, const float* __restrict__ m1,
    const float* __restrict__ gout, float* __restrict__ df0,
    float* __restrict__ df1, float* __restrict__ dm0,
    float* __restrict__ dm1, long long rows, long long n_per_batch, int C,
    long long f_sb, long long f_sn, long long m_sb, long long m_sn,
    float eps, int group) {
  constexpr int K = MPT * E;
  const Lanes ln(group);
  const int moves = C / E;
  const long long warp0 = (long long)blockIdx.x * (THREADS / 32) +
                          (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * (THREADS / 32) *
                         ln.rows_per_warp;
  for (long long base = warp0 * ln.rows_per_warp; base < rows;
       base += step) {
    const long long r = base + ln.row_in_warp;
    float a[K], b[K], g[K], d0[K], d1[K];
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = b[i] = g[i] = 0.f;
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
          for (int e = 0; e < E; ++e) b[i * E + e] = t[e];
          load_row<E>(gout + r * C + j * E, t);
#pragma unroll
          for (int e = 0; e < E; ++e) g[i * E + e] = t[e];
        }
      }
      mk0 = __ldg(m0 + bb * m_sb + n * m_sn);
      mk1 = __ldg(m1 + bb * m_sb + n * m_sn);
    }
    const FuseGrad fg = fuse_grad<K>(a, b, g, mk0, mk1, eps, group);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      d0[k] = fg.alpha0 * g[k] + fg.beta0 * a[k] + fg.gamma * b[k];
      d1[k] = fg.alpha1 * g[k] + fg.beta1 * b[k] + fg.gamma * a[k];
    }
    if (r < rows) {
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        const int j = ln.slot + group * i;
        if (j < moves) {
          float t[E];
#pragma unroll
          for (int e = 0; e < E; ++e) t[e] = d0[i * E + e];
          store_row<E>(df0 + r * C + j * E, t);
#pragma unroll
          for (int e = 0; e < E; ++e) t[e] = d1[i * E + e];
          store_row<E>(df1 + r * C + j * E, t);
        }
      }
      if (ln.slot == 0 && dm0 != nullptr) dm0[r] = fg.ac * mk1;
      if (ln.slot == 0 && dm1 != nullptr) dm1[r] = fg.ac * mk0;
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

// ---- the vector path: 16-byte moves, the next scale in flight ----

// resident blocks an SM (registers capped to match): at one chunk a lane
// four for the forward and three for the backward, whose lanes also hold
// grad_out; at two chunks three and two; at four one
__host__ __device__ constexpr int vector_blocks(bool bwd, int mpt) {
  return mpt == 1 ? (bwd ? 3 : 4) : mpt == 2 ? (bwd ? 2 : 3) : 1;
}

// Rows of voxel (bb, n) at scale s: each view's point p's row, this lane's
// MPT chunks (chunk slot + group * m), zero where the point is out of FOV
// or the chunk past the row, NaN where the point is in FOV but off the map;
// state[v] 0 (out of FOV), 1 (row read) or 2 (off the map).
template <int MPT>
__device__ __forceinline__ void load_rows(const LiftScale& sc, int es,
                                          const int2 (&xy)[2],
                                          const bool (&in)[2], long long bb,
                                          const Lanes& ln, int Q,
                                          uint4 (&r)[2][MPT],
                                          int (&state)[2]) {
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    long long yy = 0, xx = 0;
    const bool inside = in[v] && point_row(sc, xy[v], &yy, &xx);
    state[v] = in[v] ? (inside ? 1 : 2) : 0;
    const char* row = static_cast<const char*>(sc.map) +
                      (bb * sc.sb + v * sc.sv + yy * sc.sh + xx * sc.sw) * es;
#pragma unroll
    for (int m = 0; m < MPT; ++m) {
      const int j = ln.slot + ln.group * m;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (j < Q && inside)
        x = __ldg(reinterpret_cast<const uint4*>(row) + j);
      else if (j < Q && in[v])
        x = es == 2 ? make_uint4(0x7fc07fc0u, 0x7fc07fc0u, 0x7fc07fc0u,
                                 0x7fc07fc0u)
                    : make_uint4(0x7fc00000u, 0x7fc00000u, 0x7fc00000u,
                                 0x7fc00000u);
      r[v][m] = x;
    }
  }
}

// the fp32 channels of both views' packed chunks r, the pad channels past
// C zero
template <typename T, int MPT>
__device__ __forceinline__ void widen_rows(const uint4 (&r)[2][MPT],
                                           const Lanes& ln, int C,
                                           float (&f)[2][MPT * (16 /
                                                                sizeof(T))]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int m = 0; m < MPT; ++m) {
      float u[VEC];
      chunk_to_f32(r[v][m], u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[v][m * VEC + e] = u[e];
    }
  if (C % VEC != 0)  // uniform: only the last chunk holds pad channels
#pragma unroll
    for (int v = 0; v < 2; ++v)
#pragma unroll
      for (int m = 0; m < MPT; ++m)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if ((ln.slot + ln.group * m) * VEC + e >= C) f[v][m * VEC + e] = 0.f;
}

struct VectorArgs {
  LiftArgs lift;
  const int2* pix;
  const bool* fov;
  float* out;            // forward: (B, N, C) fp32
  const float* gout;     // backward: (B, N, C) fp32
  const unsigned* pos;   // backward: slot -> sorted position
  float* contrib;        // backward: (positions, Cg) fp32
  long long B, N;
  int P, C, Q, Cg, group;
  float eps;
};

// A group of G lanes owns a voxel row and walks the scales in order, MPT
// 16-byte chunks of each row a lane.  The voxel's coordinates and masks
// are read once; with one point a voxel (P = 1) the next scale's rows are
// loaded, still packed, while the current scale is fused, so a voxel
// waits for one gather instead of one a scale.  Forward: the fusions are
// summed in registers and the row written once.  Backward: each in-FOV
// on-map point's df_v / count_v is written in fp32 at its sorted position,
// the group's lanes writing one row together.
template <typename T, int MPT, bool BWD>
__global__ void __launch_bounds__(THREADS, vector_blocks(BWD, MPT))
lift_vector_kernel(const __grid_constant__ VectorArgs a) {
  constexpr int VEC = 16 / sizeof(T), K = MPT * VEC;
  constexpr int es = sizeof(T);
  const Lanes ln(a.group);
  const long long rows = a.B * a.N;
  const int ns = a.lift.ns;
  const long long warp0 = (long long)blockIdx.x * (THREADS / 32) +
                          (threadIdx.x >> 5);
  const long long step =
      (long long)gridDim.x * (THREADS / 32) * ln.rows_per_warp;
  // every lane runs every loop below the same number of times (shuffles)
  for (long long base = warp0 * ln.rows_per_warp; base < rows;
       base += step) {
    const long long r = base + ln.row_in_warp;
    const bool live = r < rows;
    const long long bb = !live ? 0
                         : rows <= 0x7fffffffLL
                             ? (long long)((unsigned)r / (unsigned)a.N)
                             : r / a.N;
    const long long n = live ? r - bb * a.N : 0;
    float acc[K], g[K];
    if constexpr (BWD) {
#pragma unroll
      for (int m = 0; m < MPT; ++m)
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const int ch = (ln.slot + a.group * m) * VEC + e;
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          const float* gp = a.gout + r * a.C + ch;
          if (live && a.C % 4 == 0 && ch < a.C) {
            x = __ldg(reinterpret_cast<const float4*>(gp));
          } else if (live) {
            float* u = &x.x;
            for (int k = 0; k < 4 && ch + k < a.C; ++k) u[k] = __ldg(gp + k);
          }
          g[m * VEC + e] = x.x; g[m * VEC + e + 1] = x.y;
          g[m * VEC + e + 2] = x.z; g[m * VEC + e + 3] = x.w;
        }
    }
    if (a.P == 1) {
      int2 xy[2];
      bool in[2];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const long long pt = (bb * 2 + v) * a.N + n;
        in[v] = live && __ldg(reinterpret_cast<const unsigned char*>(a.fov) +
                              pt);
        xy[v] = live ? __ldg(a.pix + pt) : make_int2(0, 0);
      }
      const float m0 = in[0] ? 1.f : 0.f, m1 = in[1] ? 1.f : 0.f;
      uint4 cur[2][MPT], nxt[2][MPT];
      int st_cur[2], st_nxt[2];
      unsigned at_cur[2] = {0u, 0u}, at_nxt[2] = {0u, 0u};
      // the backward's sorted positions of the voxel's slots at scale s,
      // loaded with the rows
      auto load_pos = [&](int s, const int (&st)[2], unsigned (&at)[2]) {
        if constexpr (BWD) {
#pragma unroll
          for (int v = 0; v < 2; ++v)
            if (st[v] == 1)
              at[v] = __ldg(a.pos + ((bb * 2 + v) * ns + s) * a.N + n);
        }
      };
      load_rows<MPT>(a.lift.sc[0], es, xy, in, bb, ln, a.Q, cur, st_cur);
      load_pos(0, st_cur, at_cur);
      for (int s = 0; s < ns; ++s) {
        if (s + 1 < ns) {
          load_rows<MPT>(a.lift.sc[s + 1], es, xy, in, bb, ln, a.Q, nxt,
                         st_nxt);
          load_pos(s + 1, st_nxt, at_nxt);
        }
        float f[2][K];
        widen_rows<T, MPT>(cur, ln, a.C, f);
        if constexpr (!BWD) {
          float w0, w1;
          fuse_weights<K>(f[0], f[1], m0, m1, a.eps, a.group, &w0, &w1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float o = (w0 * f[0][k] + w1 * f[1][k]) * 0.5f;
            acc[k] = s == 0 ? o : acc[k] + o;
          }
        } else {
          const FuseGrad fg =
              fuse_grad<K>(f[0], f[1], g, m0, m1, a.eps, a.group);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if (st_cur[v] != 1) continue;
            const float alpha = v ? fg.alpha1 : fg.alpha0;
            const float beta = v ? fg.beta1 : fg.beta0;
            float* dst = a.contrib + (long long)at_cur[v] * a.Cg;
#pragma unroll
            for (int m = 0; m < MPT; ++m)
#pragma unroll
              for (int e = 0; e < VEC; e += 4) {
                const int ch = (ln.slot + a.group * m) * VEC + e;
                if (ch >= a.Cg) continue;
                float d[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const int i = m * VEC + e + k;
                  const float fv = v ? f[1][i] : f[0][i];
                  const float fo = v ? f[0][i] : f[1][i];
                  d[k] = alpha * g[i] + beta * fv + fg.gamma * fo;
                }
                *reinterpret_cast<float4*>(dst + ch) =
                    make_float4(d[0], d[1], d[2], d[3]);
              }
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          st_cur[v] = st_nxt[v];
          at_cur[v] = at_nxt[v];
#pragma unroll
          for (int m = 0; m < MPT; ++m) cur[v][m] = nxt[v][m];
        }
      }
    } else {
      // P points a voxel: per scale, each view's mean over its in-FOV
      // points (fp32 sums in point order, divided by the count)
      int count[2] = {0, 0};
      for (int p = 0; live && p < a.P; ++p)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          count[v] += __ldg(reinterpret_cast<const unsigned char*>(a.fov) +
                            ((bb * 2 + v) * a.N + n) * a.P + p) != 0;
      const float m0 = count[0] > 0 ? 1.f : 0.f, m1 = count[1] > 0 ? 1.f : 0.f;
      for (int s = 0; s < ns; ++s) {
        float f[2][K];
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int k = 0; k < K; ++k) f[v][k] = 0.f;
        for (int p = 0; live && p < a.P; ++p) {
          int2 xy[2];
          bool in[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const long long pt = ((bb * 2 + v) * a.N + n) * a.P + p;
            in[v] = __ldg(reinterpret_cast<const unsigned char*>(a.fov) + pt);
            xy[v] = __ldg(a.pix + pt);
          }
          uint4 rr[2][MPT];
          int st[2];
          load_rows<MPT>(a.lift.sc[s], es, xy, in, bb, ln, a.Q, rr, st);
          float u[2][K];
          widen_rows<T, MPT>(rr, ln, a.C, u);
#pragma unroll
          for (int v = 0; v < 2; ++v)
#pragma unroll
            for (int k = 0; k < K; ++k) f[v][k] += u[v][k];
        }
#pragma unroll
        for (int v = 0; v < 2; ++v)
          if (count[v] > 1) {
            const float c = (float)count[v];
#pragma unroll
            for (int k = 0; k < K; ++k) f[v][k] = f[v][k] / c;
          }
        if constexpr (!BWD) {
          float w0, w1;
          fuse_weights<K>(f[0], f[1], m0, m1, a.eps, a.group, &w0, &w1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float o = (w0 * f[0][k] + w1 * f[1][k]) * 0.5f;
            acc[k] = s == 0 ? o : acc[k] + o;
          }
        } else {
          const FuseGrad fg =
              fuse_grad<K>(f[0], f[1], g, m0, m1, a.eps, a.group);
          for (int p = 0; live && p < a.P; ++p)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const long long pt = ((bb * 2 + v) * a.N + n) * a.P + p;
              if (!__ldg(reinterpret_cast<const unsigned char*>(a.fov) + pt))
                continue;
              long long yy, xx;
              if (!point_row(a.lift.sc[s], __ldg(a.pix + pt), &yy, &xx))
                continue;
              const float cnt = (float)count[v];
              const float alpha = v ? fg.alpha1 : fg.alpha0;
              const float beta = v ? fg.beta1 : fg.beta0;
              const unsigned at = __ldg(
                  a.pos + (((bb * 2 + v) * ns + s) * a.N + n) * a.P + p);
              float* dst = a.contrib + (long long)at * a.Cg;
#pragma unroll
              for (int m = 0; m < MPT; ++m)
#pragma unroll
                for (int e = 0; e < VEC; e += 4) {
                  const int ch = (ln.slot + a.group * m) * VEC + e;
                  if (ch >= a.Cg) continue;
                  float d[4];
#pragma unroll
                  for (int k = 0; k < 4; ++k) {
                    const int i = m * VEC + e + k;
                    const float fv = v ? f[1][i] : f[0][i];
                    const float fo = v ? f[0][i] : f[1][i];
                    d[k] = (alpha * g[i] + beta * fv + fg.gamma * fo) / cnt;
                  }
                  *reinterpret_cast<float4*>(dst + ch) =
                      make_float4(d[0], d[1], d[2], d[3]);
                }
            }
        }
      }
    }
    if (!BWD && live) {
      float* row = a.out + r * a.C;
#pragma unroll
      for (int m = 0; m < MPT; ++m)
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const int ch = (ln.slot + a.group * m) * VEC + e;
          const float* u = acc + m * VEC + e;
          if (a.C % 4 == 0 && ch < a.C) {
            *reinterpret_cast<float4*>(row + ch) =
                make_float4(u[0], u[1], u[2], u[3]);
          } else {
            for (int k = 0; k < 4 && ch + k < a.C; ++k) row[ch + k] = u[k];
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
// n] and f_v view v's mean over its in-FOV points, fuse_grad gives
// df_v, and each in-FOV point of view v adds df_v / count_v to the map row
// it names at scale s (an in-FOV point whose flat index falls off the map
// adds nothing; its view's mean, and so the voxel's df, is NaN as in the
// forward).  Sums run in fp32 and are rounded once to the map's dtype.
//
// Deterministic by construction, with no floating-point atomics:
//   1. keys: every (b, v, s, n, p) slot, in that order, gets the global row
//      its point names (rows numbered scale-major, then batch, view,
//      pixel), or NO_KEY (out of FOV, or off the map);
//   2. a stable LSD radix sort by key, 8 bits a pass and only the passes
//      the largest row needs (per block digit histograms; per digit a scan
//      over the blocks; a scatter that ranks each tile's entries in order
//      with __match_any_sync); the first pass drops the NO_KEY slots, so
//      the later passes and everything downstream see only the slots that
//      name a row; within a row the slots stay in ascending (n, p); the
//      last pass writes each slot's sorted position;
//   3. bounds: each nonempty row's first and one-past-last sorted position;
//   4. contributions, in voxel order: the vector kernel above reads each
//      voxel's grad_out row once and gathers its rows as the forward does,
//      forms both views' df_v per scale, and writes each slot's df_v /
//      count_v in fp32 at its sorted position (the group's lanes write a
//      row together; the positions load with the rows);
//   5. rows: every map row is written once, the sum of its contiguous run
//      of contributions in sorted order (zero where no point lands).
// The same inputs therefore give the same bits whatever the scheduling.
// What bounds it: bytes (grad_out and the coordinates read once, every
// named map row read once, every map row of the gradient written once);
// above that it pays the sort's passes over the keys and one fp32 row a
// point written and read back.

constexpr int RADIX_ITEMS = 8;  // keys a thread ranks per radix block
static_assert(THREADS == 256, "one radix digit a thread");
constexpr int RADIX_TILE = THREADS * RADIX_ITEMS;
constexpr unsigned NO_KEY = 0xffffffffu;

struct GradArgs {
  void* grad[MAX_SCALES];      // scale s's (B, 2, h, w, C) gradient, dense
  unsigned base[MAX_SCALES];   // its first global row
  unsigned total_rows;
};

// the global row slot e names, or NO_KEY (out of FOV, or off the map)
__device__ __forceinline__ unsigned slot_key(const LiftArgs& args,
                                             const GradArgs& gargs,
                                             const int2* __restrict__ pix,
                                             const bool* __restrict__ fov,
                                             unsigned e, unsigned N,
                                             unsigned P) {
  const unsigned t = e / P, p = e - t * P;
  const unsigned t2 = t / N, n = t - t2 * N;
  const unsigned bv = t2 / (unsigned)args.ns, s = t2 - bv * args.ns;
  const long long pt = ((long long)bv * N + n) * P + p;
  if (!__ldg(reinterpret_cast<const unsigned char*>(fov) + pt)) return NO_KEY;
  long long yy, xx;
  const LiftScale& sc = args.sc[s];
  if (!point_row(sc, __ldg(pix + pt), &yy, &xx)) return NO_KEY;
  return gargs.base[s] + bv * (unsigned)sc.h * (unsigned)sc.w +
         (unsigned)(yy * sc.w + xx);
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

// 1. one key per (b, v, s, n, p) slot: the row it names, or NO_KEY
__global__ void __launch_bounds__(THREADS)
lift_bwd_keys_kernel(const __grid_constant__ LiftArgs args,
                     const __grid_constant__ GradArgs gargs,
                     const int2* __restrict__ pix,
                     const bool* __restrict__ fov, unsigned* __restrict__ keys,
                     long long slots, unsigned N, unsigned P) {
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < slots; e += (long long)gridDim.x * THREADS)
    keys[e] = slot_key(args, gargs, pix, fov, (unsigned)e, N, P);
}

// 2a. per block, the counts of each 8-bit digit: hist[digit * nblk + block]
// (the first pass reads all `n_max` slots and counts the keys that name a
// row; later passes the n_valid sorted entries)
__global__ void __launch_bounds__(THREADS)
lift_bwd_radix_hist_kernel(const unsigned* __restrict__ keys,
                           long long n_max,
                           const unsigned* __restrict__ n_valid, int shift,
                           unsigned* __restrict__ hist, int nblk) {
  __shared__ unsigned h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const long long n = n_valid != nullptr ? *n_valid : n_max;
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long e = base + it * THREADS + threadIdx.x;
    const unsigned k = e < n ? __ldg(keys + e) : NO_KEY;
    if (k != NO_KEY) atomicAdd(&h[(k >> shift) & 255u], 1u);
  }
  __syncthreads();
  hist[(long long)threadIdx.x * nblk + blockIdx.x] = h[threadIdx.x];
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
// The first pass reads every slot (vin null: the slot is its index),
// drops the keys that name no row and writes how many remain (n_valid);
// the last pass writes each slot's sorted position (`pos`) instead of the
// sorted slots.
__global__ void __launch_bounds__(THREADS)
lift_bwd_radix_scatter_kernel(const unsigned* __restrict__ kin,
                              const unsigned* __restrict__ vin,
                              unsigned* __restrict__ kout,
                              unsigned* __restrict__ vout,
                              unsigned* __restrict__ pos, long long n_max,
                              unsigned* __restrict__ n_valid, int shift,
                              const unsigned* __restrict__ hist,
                              const unsigned* __restrict__ totals, int nblk) {
  constexpr int WARPS = THREADS / 32;
  __shared__ unsigned running[256];  // this tile's entries of each digit
  __shared__ unsigned wcount[WARPS][256];
  __shared__ unsigned woff[WARPS][256];
  __shared__ unsigned local_start[256], global_start[256];
  __shared__ unsigned skey[RADIX_TILE], sval[RADIX_TILE];
  const bool first = vin == nullptr;
  const long long n = first ? n_max : *n_valid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * RADIX_TILE;
  unsigned digit_start;
  const unsigned kept = block_exclusive_scan(__ldg(totals + tid),
                                             &digit_start);
  if (first && blockIdx.x == 0 && tid == 0) *n_valid = kept;
  if (base >= n) return;  // block-uniform
  global_start[tid] = digit_start + hist[(long long)tid * nblk + blockIdx.x];
  running[tid] = 0;
  for (int w = 0; w < WARPS; ++w) wcount[w][tid] = 0;
  __syncthreads();
  unsigned key[RADIX_ITEMS], val[RADIX_ITEMS], rank[RADIX_ITEMS];
#pragma unroll
  for (int it = 0; it < RADIX_ITEMS; ++it) {
    const long long e = base + it * THREADS + tid;
    key[it] = e < n ? __ldg(kin + e) : NO_KEY;
    const bool valid = key[it] != NO_KEY;
    val[it] = first ? (unsigned)e : valid ? __ldg(vin + e) : 0u;
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
  const unsigned count = block_exclusive_scan(running[tid], &start);
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
  for (unsigned i = tid; i < count; i += THREADS) {
    const unsigned k = skey[i], d = (k >> shift) & 255u;
    const unsigned at = global_start[d] + (i - local_start[d]);
    kout[at] = k;
    if (pos != nullptr)
      pos[sval[i]] = at;
    else
      vout[at] = sval[i];
  }
}

// 3. each nonempty row's sorted positions [start, end)
__global__ void __launch_bounds__(THREADS)
lift_bwd_bounds_kernel(const unsigned* __restrict__ keys,
                       const unsigned* __restrict__ n_valid,
                       unsigned* __restrict__ start,
                       unsigned* __restrict__ end) {
  const long long n = *n_valid;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const unsigned q = keys[i];
    if (i == 0 || keys[i - 1] != q) start[q] = (unsigned)i;
    if (i == n - 1 || keys[i + 1] != q) end[q] = (unsigned)(i + 1);
  }
}

// four channels of a gradient row, rounded once: one 16-byte (fp32) or
// 8-byte (bf16) store when `vec`, else element by element below C
__device__ __forceinline__ void store_grad4(float* p, int c, int C, bool vec,
                                            float4 v) {
  if (vec) {
    *reinterpret_cast<float4*>(p + c) = v;
    return;
  }
  const float u[4] = {v.x, v.y, v.z, v.w};
  for (int e = 0; e < 4 && c + e < C; ++e) p[c + e] = u[e];
}

__device__ __forceinline__ void store_grad4(__nv_bfloat16* p, int c, int C,
                                            bool vec, float4 v) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + c) = w;
    return;
  }
  const float u[4] = {v.x, v.y, v.z, v.w};
  for (int e = 0; e < 4 && c + e < C; ++e) p[c + e] = __float2bfloat16_rn(u[e]);
}

// the sum, in order from zero, of contributions [a, b) of four channels
// (chunk c4); `first` is contribution a, already loaded when a < b
__device__ __forceinline__ float4 sum_run(const float* __restrict__ contrib,
                                          int chunks, int c4, unsigned a,
                                          unsigned b, float4 first) {
  const float4* src = reinterpret_cast<const float4*>(contrib) + c4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (a >= b) return s;
  s.x += first.x; s.y += first.y; s.z += first.z; s.w += first.w;
  unsigned i = a + 1;
  // four rows in flight, summed in order
  for (; i + 4 <= b; i += 4) {
    float4 x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = __ldg(src + (long long)(i + k) * chunks);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s.x += x[k].x; s.y += x[k].y; s.z += x[k].z; s.w += x[k].w;
    }
  }
  for (; i < b; ++i) {
    const float4 x = __ldg(src + (long long)i * chunks);
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  }
  return s;
}

// 5. every map row once: the sum of its run of contributions, in sorted
// order, four channels a lane (a group of lanes a row, reading the run's
// contiguous fp32 rows; two rows a group at a time, so that both rows'
// bounds and first contributions are in flight together)
template <typename T>
__global__ void __launch_bounds__(THREADS)
lift_bwd_rows_kernel(const __grid_constant__ GradArgs gargs, int ns,
                     const unsigned* __restrict__ start,
                     const unsigned* __restrict__ end,
                     const float* __restrict__ contrib, int C, int Cg,
                     int group, bool vec_out) {
  const Lanes ln(group);
  const int chunks = Cg / 4;
  const long long rows = gargs.total_rows;
  const long long groups = (long long)gridDim.x * (THREADS / 32) *
                           ln.rows_per_warp;
  for (long long q0 = ((long long)blockIdx.x * (THREADS / 32) +
                       (threadIdx.x >> 5)) * ln.rows_per_warp +
                      ln.row_in_warp;
       q0 < rows; q0 += 2 * groups) {
    const long long q1 = q0 + groups;
    const unsigned a0 = start[q0], b0 = end[q0];
    const unsigned a1 = q1 < rows ? start[q1] : 0u;
    const unsigned b1 = q1 < rows ? end[q1] : 0u;
    for (int c4 = ln.slot; c4 < chunks; c4 += group) {
      const float4* src = reinterpret_cast<const float4*>(contrib) + c4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      // both rows' first contributions in flight together
      const float4 x0 = a0 < b0 ? __ldg(src + (long long)a0 * chunks) : zero;
      const float4 x1 = a1 < b1 ? __ldg(src + (long long)a1 * chunks) : zero;
      const float4 acc0 = sum_run(contrib, chunks, c4, a0, b0, x0);
      const float4 acc1 = sum_run(contrib, chunks, c4, a1, b1, x1);
      for (int k = 0; k < 2; ++k) {
        const long long q = k ? q1 : q0;
        if (q >= rows) continue;
        int s = 0;
        while (s + 1 < ns && q >= gargs.base[s + 1]) ++s;
        T* row = static_cast<T*>(gargs.grad[s]) +
                 (long long)(q - gargs.base[s]) * C;
        store_grad4(row, 4 * c4, C, vec_out, k ? acc1 : acc0);
      }
    }
  }
}

// ---- host side ----

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

template <int E, int MPT>
int launch_fuse_backward(const float* f0, const float* f1, const float* m0,
                         const float* m1, const float* gout, float* df0,
                         float* df1, float* dm0, float* dm1, long long rows,
                         long long npb, int C, long long f_sb,
                         long long f_sn, long long m_sb, long long m_sn,
                         float eps, int group, cudaStream_t stream) {
  stereo_cosine_fuse_backward_kernel<E, MPT>
      <<<(unsigned)grid_for(rows, group), THREADS, 0, stream>>>(
          f0, f1, m0, m1, gout, df0, df1, dm0, dm1, rows, npb, C, f_sb, f_sn,
          m_sb, m_sn, eps, group);
  return (int)cudaGetLastError();
}

// The vector kernel's group (a power of two, at most 32 lanes) and chunks
// a lane for rows of Q 16-byte chunks.  Measured on the card (NVIDIA H100
// 80GB HBM3, 700 W) over the five train rigs: the forward runs fastest at
// one chunk a lane up to Q = 8 (C = 64 in bf16) and at four beyond (NYU's
// C = 100 and 200), the backward, whose lanes also hold grad_out, at two
// once Q > 4: fewer lanes a row repeat less of each voxel's scalar work.
bool vector_plan(int Q, bool bwd, int* group, int* mpt) {
  const int least = bwd ? (Q > 4 ? 2 : 1) : (Q > 8 ? 4 : 1);
  int g = 1;
  while (g * least < Q && g < 32) g *= 2;
  const int m = (Q + g - 1) / g;
  if (m > 4) return false;
  *group = g;
  *mpt = m <= 1 ? 1 : m <= 2 ? 2 : 4;
  return true;
}

template <typename T, bool BWD>
int launch_vector(VectorArgs a, cudaStream_t stream) {
  int mpt;
  if (!vector_plan(a.Q, BWD, &a.group, &mpt)) return -3;
  const unsigned grid = (unsigned)grid_for(a.B * a.N, a.group);
  if (mpt == 1)
    lift_vector_kernel<T, 1, BWD><<<grid, THREADS, 0, stream>>>(a);
  else if (mpt == 2)
    lift_vector_kernel<T, 2, BWD><<<grid, THREADS, 0, stream>>>(a);
  else
    lift_vector_kernel<T, 4, BWD><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

VectorArgs vector_args(const LiftArgs& args, const int2* pix,
                       const bool* fov, long long B, long long N, int P,
                       int C, int es, float eps) {
  VectorArgs a{};
  a.lift = args;
  a.pix = pix;
  a.fov = fov;
  a.B = B;
  a.N = N;
  a.P = P;
  a.C = C;
  a.Q = (C * es + 15) / 16;
  a.Cg = (C + 3) / 4 * 4;
  a.eps = eps;
  return a;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the scales' maps and geometry (see occ_flosp_stereo_lift) as LiftArgs;
// *vec stays true only when every row can move in 16-byte chunks (every
// stride a multiple of 16 bytes, every map 16-byte aligned).  Returns 0 or
// -3 for sizes the kernels cannot take.
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
  unsigned *keys[2], *vals[2], *n_valid, *hist, *totals, *pos, *start,
      *end;
  float* contrib;
  long long bytes;
};

BwdWork bwd_work(char* base, long long slots, long long rows, int C) {
  const long long nblk = (slots + RADIX_TILE - 1) / RADIX_TILE;
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
  w.n_valid = reinterpret_cast<unsigned*>(take(4));
  w.hist = reinterpret_cast<unsigned*>(take(256 * nblk * 4));
  w.totals = reinterpret_cast<unsigned*>(take(256 * 4));
  w.pos = reinterpret_cast<unsigned*>(take(slots * 4));
  w.start = reinterpret_cast<unsigned*>(take(rows * 4));
  w.end = reinterpret_cast<unsigned*>(take(rows * 4));
  w.contrib = reinterpret_cast<float*>(take(slots * ((C + 3) / 4 * 4) * 4LL));
  w.bytes = off;
  return w;
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

// K1's backward.  f0, f1, m0, m1, the strides and sizes as
// occ_stereo_cosine_fuse; gout, df0, df1 (batch * n_per_batch, C) fp32
// contiguous; dm0, dm1 (batch * n_per_batch) fp32 contiguous, or null
// when that gradient is not wanted.  Returns the CUDA error code of the
// launch, -3 for a row the kernel cannot take (as occ_stereo_cosine_fuse).
extern "C" int occ_stereo_cosine_fuse_backward(
    const float* f0, const float* f1, const float* m0, const float* m1,
    const float* gout, float* df0, float* df1, float* dm0, float* dm1,
    long long batch, long long n_per_batch, int C, long long f_sb,
    long long f_sn, long long m_sb, long long m_sn, float eps,
    cudaStream_t stream) {
  const long long rows = batch * n_per_batch;
  if (rows == 0 || C == 0) return 0;
  const bool vec = C % 4 == 0 && f_sb % 4 == 0 && f_sn % 4 == 0 &&
                   aligned16(f0) && aligned16(f1) && aligned16(gout) &&
                   aligned16(df0) && aligned16(df1);
  const int E = vec ? 4 : 1;
  int group, mpt;
  if (!plan(C / E, &group, &mpt)) return -3;
#define OCC_FUSE_BWD(E_, M_)                                                \
  if (E == E_ && mpt == M_)                                                 \
    return launch_fuse_backward<E_, M_>(                                    \
        f0, f1, m0, m1, gout, df0, df1, dm0, dm1, rows, n_per_batch, C,     \
        f_sb, f_sn, m_sb, m_sn, eps, group, stream);
  OCC_FUSE_BWD(4, 1) OCC_FUSE_BWD(4, 2) OCC_FUSE_BWD(4, 4)
  OCC_FUSE_BWD(1, 1) OCC_FUSE_BWD(1, 2) OCC_FUSE_BWD(1, 4)
#undef OCC_FUSE_BWD
  return -3;
}

// The fused lift.  maps[s]: scale s's (B, 2, C, h, w) map, unit channel
// stride, 16-byte aligned, every stride a multiple of 16 bytes and its
// storage holding each row's channels rounded up to 16 bytes (a row at
// most 128 chunks); geom[7 s ..]: its batch, view, row and column strides
// in elements, h, w and the scale divisor.  pix (B, 2, N, P, 2) int32 and
// fov (B, 2, N, P) bool contiguous; out (B, N, C) fp32 contiguous, 16-byte
// aligned.  dtype: 0 = float32 maps, 1 = bfloat16.  Returns the CUDA error
// code of the launch, -1 for an unknown dtype, -3 for sizes or strides the
// kernel cannot take.
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
  bool vec = aligned16(out);
  if (lift_args(maps, geom, ns, es, &args, &vec) != 0) return -3;
  if (reinterpret_cast<uintptr_t>(pix) % 8 != 0 || !vec) return -3;
  VectorArgs a = vector_args(args, reinterpret_cast<const int2*>(pix), fov,
                             B, N, P, C, es, eps);
  a.out = out;
  return dtype == 0 ? launch_vector<float, false>(a, stream)
                    : launch_vector<__nv_bfloat16, false>(a, stream);
}

// Bytes of scratch occ_flosp_stereo_lift_backward needs for B * 2 * ns * N
// * P point slots, `rows` map rows over all scales, batch items and views,
// and C channels.
extern "C" long long occ_flosp_stereo_lift_backward_workspace(
    long long slots, long long rows, int C) {
  return bwd_work(nullptr, slots, rows, C).bytes;
}

// The fused lift's backward: every map's gradient, deterministic (see the
// comment above GradArgs).  maps, geom, ns, pix, fov, dtype, B, N, P, C
// and eps as occ_flosp_stereo_lift, the maps as its vector kernel takes
// them; grads[s]: scale s's gradient in the map's dtype, a contiguous
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
  bool vec = true;
  if (lift_args(maps, geom, ns, es, &args, &vec) != 0) return -3;
  GradArgs gargs{};
  long long rows = 0;
  bool vec_out = C % 4 == 0;
  for (int s = 0; s < ns; ++s) {
    gargs.grad[s] = grads[s];
    gargs.base[s] = (unsigned)rows;
    rows += B * 2 * (long long)args.sc[s].h * args.sc[s].w;
    vec_out = vec_out && aligned16(grads[s]);
  }
  const long long slots = B * 2 * ns * N * P;
  // keys, slots and rows in 32 bits, NO_KEY past the last row
  if (rows >= 0x7fffffffLL || slots >= 0x7fffffffLL) return -3;
  if (reinterpret_cast<uintptr_t>(pix) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(fov) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(work) % 256 != 0 || !vec)
    return -3;
  int vgroup, vmpt;
  if (C > 0 && !vector_plan((C * es + 15) / 16, true, &vgroup, &vmpt))
    return -3;
  gargs.total_rows = (unsigned)rows;
  if (rows == 0 || C == 0) return 0;
  const BwdWork w = bwd_work(static_cast<char*>(work), slots, rows, C);
  const int2* p2 = reinterpret_cast<const int2*>(pix);
  // enough 8-bit digits for the largest row; the sorted keys end in
  // buffer (passes & 1).  Pass 0 also drops the slots that name no row.
  int passes = 1;
  while (passes < 4 && ((rows - 1) >> (8 * passes)) != 0) ++passes;
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
      const bool last = pass == passes - 1;
      lift_bwd_radix_hist_kernel<<<nblk, THREADS, 0, stream>>>(
          w.keys[in], slots, pass == 0 ? nullptr : w.n_valid, 8 * pass,
          w.hist, nblk);
      lift_bwd_radix_scan_kernel<<<256, THREADS, 0, stream>>>(w.hist, nblk,
                                                              w.totals);
      lift_bwd_radix_scatter_kernel<<<nblk, THREADS, 0, stream>>>(
          w.keys[in], pass == 0 ? nullptr : w.vals[in], w.keys[out],
          last ? nullptr : w.vals[out], last ? w.pos : nullptr, slots,
          w.n_valid, 8 * pass, w.hist, w.totals, nblk);
    }
    lift_bwd_bounds_kernel<<<grid, THREADS, 0, stream>>>(
        w.keys[passes & 1], w.n_valid, w.start, w.end);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    VectorArgs a = vector_args(args, p2, fov, B, N, P, C, es, eps);
    a.gout = gout;
    a.pos = w.pos;
    a.contrib = w.contrib;
    err = dtype == 0 ? launch_vector<float, true>(a, stream)
                     : launch_vector<__nv_bfloat16, true>(a, stream);
    if (err != 0) return err;
  }
  const int Cg = (C + 3) / 4 * 4;
  int group, mpt;
  if (!plan(Cg / 4, &group, &mpt)) group = 32;
  if (dtype == 0)
    lift_bwd_rows_kernel<float>
        <<<(unsigned)grid_for(rows, group), THREADS, 0, stream>>>(
            gargs, ns, w.start, w.end, w.contrib, C, Cg, group, vec_out);
  else
    lift_bwd_rows_kernel<__nv_bfloat16>
        <<<(unsigned)grid_for(rows, group), THREADS, 0, stream>>>(
            gargs, ns, w.start, w.end, w.contrib, C, Cg, group, vec_out);
  return (int)cudaGetLastError();
}
