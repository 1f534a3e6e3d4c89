// 3x3 stride-1 SAME convolution + bias, NCHW in and out:
//
//   out[b, o, h, w] = bias[o] + sum_{c, dr, dc} x[b, c, h+dr-1, w+dc-1] * w[o, c, dr, dc]
//
// (zero outside the image), products summed in fp32, the fp32 bias added
// in the epilogue and one rounding to the output dtype.
//
// Replaces the TPU kernels occdepth_tpu/ops/conv2d_shift.py:102
// `conv3x3_pallas` (body `_conv_kernel`) and :251 `conv3x3_pallas_x3`
// (body `_conv_x3_kernel`), which compute the same function: the 2D
// decoder's ten 3x3 convs under decoder_conv_impl=pallas.  The TPU kernels
// pad the image in device memory, flatten its rows and compute two garbage
// columns per row so that every tap is a contiguous slice of one VMEM
// tile; here the halo is masked while it is staged, nothing padded is
// written, and no column is computed twice.
//
// What bounds it on Hopper: arithmetic.  The flagship decoder does ~300
// GFLOP per 370x1220 view against ~0.5 GB in and out (bf16), so every conv
// but the 48-channel ones at full resolution sits far above the ~295
// flop/byte ridge of the bf16 tensor cores.  The design is a direct
// implicit GEMM, M = B*H*W output pixels, N = Co, K = 9*Ci:
//   * a block owns TM = 64 output pixels of one image row x TN = 64 output
//     channels and loops over the input channels in chunks;
//   * per chunk it stages the 3-row x (TM+2)-column input halo into shared
//     memory, zero-masked at the image border and past Ci, and the chunk's
//     9 x KC x TN weights, so the input is read from device memory about
//     once per Co tile (the halo adds 2 columns in 64, the 3 rows are L2
//     hits of the neighbouring rows' blocks);
//   * bf16 runs the nine tap products on the tensor cores through WMMA
//     (m16n16k16, fp32 accumulators; 4 warps, a 32x32 tile each); the
//     epilogue goes through shared memory so the NCHW stores walk pixels;
//   * fp32 runs SIMT fmaf (16x16 threads, a 4x4 register tile each), so it
//     matches the plain version with TF32 off.
// Not used yet: wgmma, TMA, multi-stage pipelining, 16-byte loads,
// a persistent schedule (later work; the chip_smoke numbers say how far
// this stays from the bound).
//
// Layouts: x is read through (batch, channel, row, column) strides, so
// NCHW and channels-last inputs both work (coalesced when the column
// stride is 1).  w must be contiguous (Co, Ci, 3, 3), the port's OIHW
// parameter layout, read as it is: no permuted copy.  out is contiguous
// NCHW, allocated by the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int TM = 64;        // output pixels per block, along one row
constexpr int TN = 64;        // output channels per block
constexpr int HALO = TM + 2;  // staged input columns

// ---- bf16: tensor cores through WMMA ----
constexpr int KC16 = 16;  // input channels per chunk: one WMMA k-step
constexpr int THREADS16 = 128;
constexpr int IN16_BYTES = 3 * HALO * KC16 * 2;  // s_in[3][HALO][KC16]
constexpr int W16_BYTES = TN * 9 * KC16 * 2;     // s_w[TN][9][KC16]
constexpr int LDO = TM + 4;                       // s_out[TN][LDO] fp32
constexpr int OUT_BYTES = TN * LDO * 4;
constexpr int SMEM16 = IN16_BYTES + W16_BYTES > OUT_BYTES
                           ? IN16_BYTES + W16_BYTES
                           : OUT_BYTES;

__global__ void __launch_bounds__(THREADS16)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int Ci, int Co, int H,
                    int W, int n_wtiles, long long x_sb, long long x_sc,
                    long long x_sh, long long x_sw) {
  // WMMA wants 32-byte aligned tile pointers: every row below is 32 bytes
  __shared__ __align__(128) unsigned char smem[SMEM16];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem + IN16_BYTES);
  float* s_out = reinterpret_cast<float*>(smem);  // after the last chunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp & 1) * 32;   // the warp's pixel offset in the tile
  const int wn = (warp >> 1) * 32;  // the warp's channel offset
  const int row = blockIdx.x / n_wtiles;
  const int w0 = (blockIdx.x - row * n_wtiles) * TM;
  const int co0 = blockIdx.y * TN;
  const long long b = blockIdx.z;
  const __nv_bfloat16* xb = x + b * x_sb;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < Ci; c0 += KC16) {
    // s_in[dr][col][ci] = x[c0 + ci, row + dr - 1, w0 + col - 1]; the
    // column runs fastest so the global loads coalesce
    for (int e = tid; e < 3 * KC16 * HALO; e += THREADS16) {
      const int col = e % HALO;
      const int r = e / HALO;
      const int ci = r % KC16;
      const int dr = r / KC16;
      const int h = row + dr - 1;
      const int ww = w0 + col - 1;
      const int c = c0 + ci;
      __nv_bfloat16 v = zero;
      if (h >= 0 && h < H && ww >= 0 && ww < W && c < Ci)
        v = xb[c * x_sc + h * x_sh + ww * x_sw];
      s_in[(dr * HALO + col) * KC16 + ci] = v;
    }
    // s_w[n][tap][ci] = w[co0 + n, c0 + ci, tap], read in OIHW order
    for (int e = tid; e < TN * KC16 * 9; e += THREADS16) {
      const int n = e / (KC16 * 9);
      const int rr = e - n * (KC16 * 9);
      const int ci = rr / 9;
      const int tap = rr - ci * 9;
      const int co = co0 + n;
      const int c = c0 + ci;
      __nv_bfloat16 v = zero;
      if (co < Co && c < Ci) v = w[((long long)co * Ci + c) * 9 + tap];
      s_w[(n * 9 + tap) * KC16 + ci] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3;
      const int dc = tap - 3 * dr;
      // A (pixels x channels): row-major rows of s_in shifted by dc
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      // B (channels x out-channels): column n is s_w[n][tap][:]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> g[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(
            a[i], s_in + (dr * HALO + wm + 16 * i + dc) * KC16, KC16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(
            g[j], s_w + ((wn + 16 * j) * 9 + tap) * KC16, 9 * KC16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }

  // s_out[n][m], so consecutive threads store consecutive output pixels
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s_out + (wn + 16 * j) * LDO + wm + 16 * i,
                              acc[i][j], LDO, wmma::mem_col_major);
  __syncthreads();
  const long long HW = (long long)H * W;
  __nv_bfloat16* ob = out + b * Co * HW + (long long)row * W;
  for (int e = tid; e < TM * TN; e += THREADS16) {
    const int n = e / TM;
    const int m = e - n * TM;
    const int co = co0 + n;
    const int ww = w0 + m;
    if (co < Co && ww < W) {
      float v = s_out[n * LDO + m];
      if (bias != nullptr) v += bias[co];
      ob[co * HW + ww] = __float2bfloat16(v);
    }
  }
}

// ---- fp32: SIMT fmaf ----
constexpr int KC32 = 8;
constexpr int THREADS32 = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int LDW = KC32 * 9 + 1;  // s_w row per out-channel, padded

__global__ void __launch_bounds__(THREADS32)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int Ci, int Co, int H, int W, int n_wtiles, long long x_sb,
                   long long x_sc, long long x_sh, long long x_sw) {
  __shared__ float s_in[3][KC32][HALO];
  __shared__ float s_w[TN * LDW];  // [n][ci * 9 + tap], OIHW order

  const int tid = threadIdx.x;
  const int tm = tid & 15;  // pixels tm + 16 i
  const int tn = tid >> 4;  // out-channels tn + 16 j
  const int row = blockIdx.x / n_wtiles;
  const int w0 = (blockIdx.x - row * n_wtiles) * TM;
  const int co0 = blockIdx.y * TN;
  const long long b = blockIdx.z;
  const float* xb = x + b * x_sb;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Ci; c0 += KC32) {
    for (int e = tid; e < 3 * KC32 * HALO; e += THREADS32) {
      const int col = e % HALO;
      const int r = e / HALO;
      const int ci = r % KC32;
      const int dr = r / KC32;
      const int h = row + dr - 1;
      const int ww = w0 + col - 1;
      const int c = c0 + ci;
      float v = 0.f;
      if (h >= 0 && h < H && ww >= 0 && ww < W && c < Ci)
        v = xb[c * x_sc + h * x_sh + ww * x_sw];
      s_in[dr][ci][col] = v;
    }
    for (int e = tid; e < TN * KC32 * 9; e += THREADS32) {
      const int n = e / (KC32 * 9);
      const int rr = e - n * (KC32 * 9);
      const int co = co0 + n;
      const int c = c0 + rr / 9;
      float v = 0.f;
      if (co < Co && c < Ci) v = w[((long long)co * Ci + c0) * 9 + rr];
      s_w[n * LDW + rr] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3;
      const int dc = tap - 3 * dr;
#pragma unroll
      for (int k = 0; k < KC32; ++k) {
        float a[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_in[dr][k][tm + 16 * i + dc];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = s_w[(tn + 16 * j) * LDW + k * 9 + tap];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const long long HW = (long long)H * W;
  float* ob = out + b * Co * HW + (long long)row * W;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tn + 16 * j;
    if (co >= Co) continue;
    const float bv = bias != nullptr ? bias[co] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ww = w0 + tm + 16 * i;
      if (ww < W) ob[co * HW + ww] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike; bias float32 or
// null).  Returns the CUDA error code of the launch, -1 for an unknown
// dtype, -3 for a grid the hardware cannot launch.
extern "C" int occ_conv3x3(const void* x, const void* w, const float* bias,
                           void* out, int dtype, long long B, long long Ci,
                           long long Co, long long H, long long W,
                           long long x_sb, long long x_sc, long long x_sh,
                           long long x_sw, cudaStream_t stream) {
  if (B == 0 || Co == 0 || H == 0 || W == 0) return 0;
  const long long n_wtiles = (W + TM - 1) / TM;
  const long long n_ctiles = (Co + TN - 1) / TN;
  if (H * n_wtiles > 0x7fffffffLL || n_ctiles > 65535 || B > 65535 ||
      Ci > 0x7fffffffLL)
    return -3;
  const dim3 grid((unsigned)(H * n_wtiles), (unsigned)n_ctiles, (unsigned)B);
  if (dtype == 0) {
    conv3x3_f32_kernel<<<grid, THREADS32, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(out), (int)Ci, (int)Co, (int)H, (int)W,
        (int)n_wtiles, x_sb, x_sc, x_sh, x_sw);
  } else if (dtype == 1) {
    conv3x3_bf16_kernel<<<grid, THREADS16, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<__nv_bfloat16*>(out), (int)Ci, (int)Co, (int)H, (int)W,
        (int)n_wtiles, x_sb, x_sc, x_sh, x_sw);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
