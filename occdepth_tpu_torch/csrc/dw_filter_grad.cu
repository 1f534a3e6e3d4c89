// Filter gradient of a stride-1 SAME depthwise conv with an odd K x K filter:
//
//   dw[c, dr, dc] = sum_{b,h,w} x_pad[b, c, h+dr, w+dc] * g[b, c, h, w]
//
// Replaces the TPU kernel occdepth_tpu/ops/dw_conv.py
// `dw_filter_grad_pallas` (body `_dwgrad_kernel`), the encoder backward's
// depthwise filter gradient under dw_conv_grad=pallas.
//
// What bounds it on Hopper: device-memory bytes.  The work is 2*K*K flops
// per element of g against one read of x and one of g, about K*K/2 flops
// per byte in bf16 (4.5 at K=3, 12.5 at K=5), far below the ~20 flop/byte
// where fp32 arithmetic would start to matter.  So the design reads x and
// g once:
//   * one block per (row tile, channel, batch); the block stages its x rows
//     plus the K-1 halo rows, zero-padded by (K-1)/2 columns on each side,
//     as an fp32 slab in shared memory (at most 46 KB, so tiles are ~17
//     rows at the flagship's 610-wide first stage; halo rows are the only
//     bytes read twice, ~(K-1)/rows of x);
//   * each thread walks the tile's g elements (consecutive threads on
//     consecutive columns, so global loads coalesce), reads g once and the
//     K*K shifted x values from the slab, and keeps K*K fp32 partial sums
//     in registers;
//   * the block reduces each tap with warp shuffles, then across warps in
//     shared memory in a fixed order, and writes its K*K partials to a
//     scratch buffer;
//   * a second small kernel sums each (channel, tap) over the blocks in a
//     fixed order.  No atomics: the result is the same on every run, as
//     the TPU kernel's sequential grid gives.
// The TPU kernel's pltpu.roll column shifts become plain slab offsets.
// Tensor cores, TMA and multi-stage pipelining are not used.
//
// Layouts: x and g are addressed through (batch, channel, row, column)
// strides, so NCHW and channels-last tensors both work (coalesced when the
// column stride is 1).  Partials are (C, B * n_tiles, K*K); the output is
// (C, K*K) float32, i.e. the (C, 1, K, K) weight layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the slab's cap: with the K*K x 8-warp reduction buffer the block stays
// under the 48 KB a launch may use without an opt-in attribute
constexpr int kSlabBytes = 46 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_filter_grad_partial_kernel(const T* __restrict__ x,
                              const T* __restrict__ g,
                              float* __restrict__ partial, int H, int W,
                              int tile_h, int n_tiles, long long x_sb,
                              long long x_sc, long long x_sh, long long x_sw,
                              long long g_sb, long long g_sc, long long g_sh,
                              long long g_sw) {
  extern __shared__ float slab[];  // (rows + K - 1) x (W + K - 1)
  __shared__ float red[kWarps][K * K];
  constexpr int P = (K - 1) / 2;
  const int tile = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int h0 = tile * tile_h;
  const int rows = min(tile_h, H - h0);
  const int sw = W + K - 1;
  const T* xb = x + b * x_sb + c * x_sc;
  const T* gb = g + b * g_sb + c * g_sc;

  // x rows [h0 - P, h0 + rows + P), columns [-P, W + P), zeros outside
  const int slab_n = (rows + K - 1) * sw;
  for (int e = threadIdx.x; e < slab_n; e += kThreads) {
    const int r = e / sw;
    const int h = h0 + r - P;
    const int w = e - r * sw - P;
    float v = 0.f;
    if (h >= 0 && h < H && w >= 0 && w < W) v = to_f32(xb[h * x_sh + w * x_sw]);
    slab[e] = v;
  }
  __syncthreads();

  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;
  const int n = rows * W;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / W;
    const int w = e - r * W;
    const float gv = to_f32(gb[(h0 + r) * g_sh + w * g_sw]);
    const float* s = slab + r * sw + w;  // x_pad[h0 + r][w], tap (0, 0)
#pragma unroll
    for (int dr = 0; dr < K; ++dr)
#pragma unroll
      for (int dc = 0; dc < K; ++dc)
        acc[dr * K + dc] = fmaf(s[dr * sw + dc], gv, acc[dr * K + dc]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < K * K) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += red[i][threadIdx.x];
    const long long row = (long long)c * gridDim.z * n_tiles +
                          (long long)b * n_tiles + tile;
    partial[row * (K * K) + threadIdx.x] = s;
  }
}

// out[c * KK + t] = sum_j partial[(c * n_part + j) * KK + t], j in order
__global__ void dw_filter_grad_sum_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int C,
                                          int KK, int n_part) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * KK) return;
  const int c = i / KK;
  const int t = i - c * KK;
  const float* p = partial + (long long)c * n_part * KK + t;
  float s = 0.f;
  for (int j = 0; j < n_part; ++j) s += p[(long long)j * KK];
  out[i] = s;
}

template <typename T, int K>
int launch(const void* x, const void* g, float* partial, float* out,
           long long B, long long C, long long H, long long W,
           long long tile_h, long long n_tiles, const long long* xs,
           const long long* gs, cudaStream_t stream) {
  const size_t smem = (size_t)(tile_h + K - 1) * (W + K - 1) * sizeof(float);
  if (smem > (size_t)kSlabBytes) return -2;
  const dim3 grid((unsigned)n_tiles, (unsigned)C, (unsigned)B);
  dw_filter_grad_partial_kernel<T, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, (int)H,
      (int)W, (int)tile_h, (int)n_tiles, xs[0], xs[1], xs[2], xs[3], gs[0],
      gs[1], gs[2], gs[3]);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int KK = K * K;
  const int total = (int)C * KK;
  dw_filter_grad_sum_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, out, (int)C, KK, (int)(B * n_tiles));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(int k, const void* x, const void* g, float* partial,
               float* out, long long B, long long C, long long H, long long W,
               long long tile_h, long long n_tiles, const long long* xs,
               const long long* gs, cudaStream_t stream) {
  switch (k) {
    case 3:
      return launch<T, 3>(x, g, partial, out, B, C, H, W, tile_h, n_tiles,
                          xs, gs, stream);
    case 5:
      return launch<T, 5>(x, g, partial, out, B, C, H, W, tile_h, n_tiles,
                          xs, gs, stream);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and g alike; partials and output are
// float32).  tile_h rows of g per block, n_tiles = ceil(H / tile_h); the
// partial buffer holds C * B * n_tiles * k * k floats.  Returns the CUDA
// error code of the launches, -1 for an unsupported dtype or filter size,
// -2 for a slab above 46 KB, -3 for a grid the hardware cannot launch.
extern "C" int occ_dw_filter_grad(
    const void* x, const void* g, float* partial, float* out, int dtype,
    int k, long long B, long long C, long long H, long long W,
    long long tile_h, long long n_tiles, long long x_sb, long long x_sc,
    long long x_sh, long long x_sw, long long g_sb, long long g_sc,
    long long g_sh, long long g_sw, cudaStream_t stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return 0;
  if (C > 65535 || B > 65535 || tile_h < 1 || n_tiles * tile_h < H) return -3;
  const long long xs[4] = {x_sb, x_sc, x_sh, x_sw};
  const long long gs[4] = {g_sb, g_sc, g_sh, g_sw};
  if (dtype == 0)
    return dispatch_k<float>(k, x, g, partial, out, B, C, H, W, tile_h,
                             n_tiles, xs, gs, stream);
  if (dtype == 1)
    return dispatch_k<__nv_bfloat16>(k, x, g, partial, out, B, C, H, W,
                                     tile_h, n_tiles, xs, gs, stream);
  return -1;
}
