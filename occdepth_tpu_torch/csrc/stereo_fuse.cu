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
  if constexpr (E == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
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
  const float qnan = __int_as_float(0x7fc00000);
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
      const LiftScale& sc = args.sc[si];
      float f[2][K];
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int i = 0; i < K; ++i) f[v][i] = 0.f;
      int count[2] = {0, 0};
      for (int p = 0; live && p < P; ++p) {
        // both views' point p (the mask and coordinates together; from the
        // second scale on they come from L1), then both rows, then sums
        float t[2][K];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const long long pt = ((bb * 2 + v) * N + n) * P + p;
          const bool in =
              __ldg(reinterpret_cast<const unsigned char*>(fov) + pt);
          const int2 xy = __ldg(pix + pt);
          count[v] += in;
          // floor division by the scale: a shift for powers of two
          const int x = sc.log2s >= 0 ? xy.x >> sc.log2s
                                      : floor_div(xy.x, sc.s);
          const int y = sc.log2s >= 0 ? xy.y >> sc.log2s
                                      : floor_div(xy.y, sc.s);
          // the flat index y * w + x; (y, x) themselves when x is in the
          // row, else the division (a point off the image's sides)
          bool inside = x >= 0 && x < sc.w && y >= 0 && y < sc.h;
          long long yy = y, xx = x;
          if (x < 0 || x >= sc.w) {
            const long long idx = (long long)y * sc.w + x;
            inside = idx >= 0 && idx < (long long)sc.h * sc.w;
            yy = inside ? idx / sc.w : 0;
            xx = inside ? idx - yy * sc.w : 0;
          }
          const T* row = static_cast<const T*>(sc.map) + bb * sc.sb +
                         v * sc.sv + yy * sc.sh + xx * sc.sw;
#pragma unroll
          for (int i = 0; i < MPT; ++i) {
            const int j = ln.slot + group * i;
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
  args.ns = ns;
  bool vec = (C * es) % 16 == 0 && aligned16(out);
  for (int s = 0; s < ns; ++s) {
    const long long* g = geom + 7 * s;
    if (g[4] * g[5] > 0x7fffffffLL || g[6] < 1 || g[6] > (1 << 30))
      return -3;
    const int sdiv = (int)g[6];
    int log2s = 0;
    while ((1 << log2s) < sdiv) ++log2s;
    args.sc[s] = LiftScale{maps[s], g[0], g[1], g[2], g[3], (int)g[4],
                           (int)g[5], sdiv, (1 << log2s) == sdiv ? log2s : -1};
    for (int i = 0; i < 4; ++i) vec = vec && (g[i] * es) % 16 == 0;
    vec = vec && aligned16(maps[s]);
  }
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
