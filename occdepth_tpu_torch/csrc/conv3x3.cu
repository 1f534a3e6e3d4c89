// 3x3 stride-1 SAME convolution + bias, channels-last (NHWC) in and out:
//
//   out[b, h, w, o] = bias[o] + sum_{dr, dc, c} x[b, h+dr-1, w+dc-1, c]
//                                               * w[o, dr, dc, c]
//
// (zero outside the image), products summed in fp32, the fp32 bias added
// in the epilogue and one rounding to the output dtype.  x is (B, H, W, Cp)
// and w (Co, 3, 3, Cp), both with Cp a multiple of 8 and the channels past
// the true Ci zero (the wrapper packs them: ops/conv2d_shift.py).
//
// Replaces the TPU kernels occdepth_tpu/ops/conv2d_shift.py:102
// `conv3x3_pallas` (body `_conv_kernel`) and :251 `conv3x3_pallas_x3`
// (body `_conv_x3_kernel`), which compute the same function: the 2D
// decoder's ten 3x3 convs under decoder_conv_impl=pallas.  The TPU kernels
// pad the image in device memory, flatten its rows and compute two garbage
// columns per row so that every tap is a contiguous slice of one VMEM
// tile; here TMA fills the border with zeros as it loads, nothing padded
// is written, and no column is computed twice.
//
// What bounds it on Hopper: arithmetic.  The flagship decoder does ~300
// GFLOP per 370x1220 view against ~0.5 GB in and out (bf16), so every conv
// but the 48-channel ones at full resolution sits far above the ~295
// flop/byte ridge of the bf16 tensor cores; what a tile must move from L2
// into shared memory per flop decides how close it gets.  The design is
// an implicit GEMM, M = B*H*W output pixels, N = Co, K = 9*Cp:
//   * a block owns a 2D tile of 8 rows x 16 columns = 128 output pixels
//     (ragged W = 77, 153, 305 waste at most 5% of the columns) and TN
//     output channels;
//   * bf16: per 64-channel chunk one TMA 4D load brings the tile's halo,
//     box (64 ch, 24 columns, 10 rows, 1) at (c0, w0-1, h0-1, b): the SAME
//     border and the channel overhang past Cp arrive as zeros, no masking
//     code.  The nine taps read that one halo through shifted wgmma
//     descriptors: with 24 (a multiple of 8) halo columns, every 8-pixel
//     row of a tap starts dr * 24 + dc rows into the halo in the same
//     swizzle phase, so a descriptor with a 3072-byte group stride walks
//     it (checked by hopper_selftest.cu).  Per tap one TMA 3D load brings
//     the weights, box (64 ch, 1 tap, TN).  Two rings of stages in dynamic
//     shared memory (2 halos, up to 12 weight taps), filled by one
//     producer thread (warpgroup 0) and drained by two consumer
//     warpgroups, each 8 rows x 8 columns = 64 pixels x TN channels on
//     wgmma m64nTNk16 with fp32 accumulators in registers; full/empty
//     mbarriers hand the stages over, so loads run ahead of the math.
//     TN = 48, 96 or 192 by Co, so the decoder's Co = 48 and 96 need no
//     padded columns.  Where all of a block's weights fit (Co <= 48, Cp
//     <= 128: the full-resolution convs, whose per-tile work is small)
//     they are loaded once and stay resident, only halos stream, three
//     deep, and the grid is persistent: each block walks many tiles, its
//     producer loading the next while the consumers store the last;
//   * fp32: per (32-channel chunk, tap) one TMA load of the tile's pixels
//     shifted by the tap, box (32 ch, 16, 8, 1), and one of the weights,
//     three stages, SIMT fmaf on CUDA cores (TF32 would break the fp32
//     path's role as the exact one): 256 threads, an 8 x 8 (8 x 4 for Co
//     <= 64) register tile each over 128 pixels x 128 (64) channels,
//     16-byte shared loads that the 128B swizzle keeps free of bank
//     conflicts;
//   * the epilogue adds the bias and stores straight from the accumulators
//     into the NHWC output, masked at the image edge and past Co.
// The wrapper's packing of an input that is not channels-last already is
// the transposing copy `occ_pack_nhwc` at the end of this file.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TH = 8, TW = 16;          // output pixel tile
constexpr int TPIX = TH * TW;           // 128 pixels: two wgmma M = 64

// ---- bf16: wgmma, warp-specialised, one halo load per channel chunk ----
constexpr int KC16 = 64;                 // channels per chunk (128 bytes)
constexpr int HALO_W = 24;               // TW + 2 rounded up to 8 rows
constexpr int HALO_H = TH + 2;
constexpr int HALO_BYTES = HALO_H * HALO_W * 128;  // 30 KB, 1024-aligned

// RES: all the weights a block needs (one column tile, at most two
// chunks: Co <= 48 and Cp <= 128, the decoder's full-resolution convs)
// stay resident in shared memory, loaded once; only halos stream, three
// deep.  Otherwise the nine taps' weights stream through a ring beside
// two halo stages.
template <int TN, bool RES>
struct Bf16Cfg {
  static constexpr int B_BYTES = TN * 128;  // one tap's weights
  static constexpr int SA = RES ? 3 : 2;    // halo stages
  // TN <= 96 streaming: two blocks per SM (so one tile's halo load and
  // epilogue overlap the other's math) in ~108 KB each; otherwise one
  // block with ~200 KB.  Weight stages: 18 resident taps, or what the
  // budget holds beside the halos, at most 12.
  static constexpr int BLOCKS = !RES && TN <= 96 ? 2 : 1;
  static constexpr int BUDGET = BLOCKS == 2 ? 108 * 1024 : 200 * 1024;
  static constexpr int SB_FIT = (BUDGET - SA * HALO_BYTES) / B_BYTES;
  static constexpr int SB = RES ? 2 * 9 : SB_FIT < 12 ? SB_FIT : 12;
  static constexpr int SMEM =
      1024 + SA * HALO_BYTES + SB * B_BYTES + 2 * (SA + SB) * 8;
};

// A block walks tiles blockIdx.x, + gridDim.x, ... (one tile, unless the
// grid is persistent): tile t is pixel tile t % n_mtiles of column tile
// t / n_mtiles; the producer loads the next tile while the consumers store
// the last, and the rings' stage indices and phases run on over the tiles.
template <int TN, bool RES>
__global__ void __launch_bounds__(384, (Bf16Cfg<TN, RES>::BLOCKS))
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int Cp, int Co, int H,
                    int W, int n_htiles, int n_wtiles, int n_mtiles,
                    int n_tiles) {
  using Cfg = Bf16Cfg<TN, RES>;
  constexpr int SA = Cfg::SA, SB = Cfg::SB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_halo = smem_u32(smem);              // SA halos
  const uint32_t s_w = s_halo + SA * HALO_BYTES;       // SB weight taps
  const uint32_t full_a = s_w + SB * Cfg::B_BYTES;     // SA, then SA empty
  const uint32_t empty_a = full_a + 8 * SA;
  const uint32_t full_b = empty_a + 8 * SA;            // SB, then SB empty
  const uint32_t empty_b = full_b + 8 * SB;

  const int n_chunks = (Cp + KC16 - 1) / KC16;
  struct Tile {
    int w0, h0, b, co0;
  };
  auto tile_at = [&](int t) {
    Tile r;
    const int mt = t % n_mtiles;
    r.co0 = (t / n_mtiles) * TN;
    r.w0 = (mt % n_wtiles) * TW;
    r.h0 = (mt / n_wtiles % n_htiles) * TH;
    r.b = mt / n_wtiles / n_htiles;
    return r;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread; per chunk the (10 x 24)-pixel halo, then (not
    // RES) the nine taps' weights, each into the next free stage of its
    // ring
    if (threadIdx.x == 0) {
      if constexpr (RES) {
        mbar_expect_tx(full_b, 9 * n_chunks * Cfg::B_BYTES);
        for (int k = 0; k < 9 * n_chunks; ++k)
          tma_load_3d(s_w + k * Cfg::B_BYTES, &tm_w, full_b, k / 9 * KC16,
                      k % 9, 0);
      }
      int cg = 0, it = 0;  // chunks and taps loaded so far
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_at(t);
        for (int c = 0; c < n_chunks; ++c, ++cg) {
          const int sa = cg % SA;
          mbar_wait(empty_a + 8 * sa, ((cg / SA) & 1) ^ 1);
          mbar_expect_tx(full_a + 8 * sa, HALO_BYTES);
          tma_load_4d(s_halo + sa * HALO_BYTES, &tm_x, full_a + 8 * sa,
                      c * KC16, tl.w0 - 1, tl.h0 - 1, tl.b);
          if constexpr (!RES) {
            for (int tap = 0; tap < 9; ++tap, ++it) {
              const int sb = it % SB;
              mbar_wait(empty_b + 8 * sb, ((it / SB) & 1) ^ 1);
              mbar_expect_tx(full_b + 8 * sb, Cfg::B_BYTES);
              tma_load_3d(s_w + sb * Cfg::B_BYTES, &tm_w, full_b + 8 * sb,
                          c * KC16, tap, tl.co0);
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup q takes tile columns 8q .. 8q + 7 of all 8 rows;
  // its wgmma row m is pixel (m / 8, 8q + m % 8), which for tap (dr, dc)
  // is halo row (m / 8 + dr) * 24 + 8q + dc + m % 8: 8-row groups 24
  // rows apart, starting dr * 24 + dc + 8q rows into the halo
  const int q = wg - 1;
  const bool signal = (threadIdx.x & 127) == 0;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int m0 = (tid >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  const bool pairs = (Co & 1) == 0;
  if constexpr (RES) mbar_wait(full_b, 0);
  int cg = 0, it = 0;  // chunks and taps consumed so far
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t);
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c, ++cg) {
      const int sa = cg % SA;
      mbar_wait(full_a + 8 * sa, (cg / SA) & 1);
      const uint32_t halo = s_halo + sa * HALO_BYTES + 8 * q * 128;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++it) {
        uint32_t bw;
        if constexpr (RES) {
          bw = s_w + (c * 9 + tap) * Cfg::B_BYTES;
        } else {
          const int sb = it % SB;
          mbar_wait(full_b + 8 * sb, (it / SB) & 1);
          bw = s_w + sb * Cfg::B_BYTES;
        }
        const uint32_t a = halo + ((tap / 3) * HALO_W + tap % 3) * 128;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KC16 / 16; ++j)
          wgmma_bf16(acc, desc_sw128(a + 32 * j, HALO_W * 128),
                     desc_sw128(bw + 32 * j), 1);
        wgmma_commit();
        // the previous step's products are done: release its stages
        wgmma_wait<1>();
        if (signal && it > 0) {
          if constexpr (!RES) mbar_arrive(empty_b + 8 * ((it - 1) % SB));
          if (tap == 0) mbar_arrive(empty_a + 8 * ((cg - 1) % SA));
        }
      }
    }
    wgmma_wait<0>();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 8 * hh;
      const int h = tl.h0 + m / 8;
      const int w = tl.w0 + 8 * q + m % 8;
      if (h >= H || w >= W) continue;
      __nv_bfloat16* o = out + (((long long)tl.b * H + h) * W + w) * Co;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int co = tl.co0 + 8 * j + cq;
        if (co >= Co) continue;
        float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
        if (bias != nullptr) {
          v0 += bias[co];
          if (co + 1 < Co) v1 += bias[co + 1];
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          o[co] = __float2bfloat16(v0);
          if (co + 1 < Co) o[co + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---- fp32: SIMT fmaf on TMA-staged tiles ----
constexpr int KC32 = 32;                 // channels per K step (128 bytes)
constexpr int THREADS32 = 256;           // 16 x 16 threads, 8 x JN outputs
constexpr int S32 = 3;
constexpr int A32_BYTES = TPIX * 128;

// TN = 16 JN output channels per block: 128, or 64 for Co <= 64
template <int JN>
struct F32Cfg {
  static constexpr int TN = 16 * JN;
  static constexpr int STAGE = A32_BYTES + TN * 128;
  static constexpr int SMEM = 1024 + S32 * STAGE + S32 * 8;
};

template <int JN>
__global__ void __launch_bounds__(THREADS32, 2)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int Cp, int Co, int H, int W, int n_htiles, int n_wtiles) {
  using Cfg = F32Cfg<JN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full = smem_u32(smem + S32 * Cfg::STAGE);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // out-channels tx + 16 j
  const int ty = tid >> 4;  // pixels ty + 16 i: tile row i, column ty
  const int co0 = blockIdx.y * Cfg::TN;
  int t = blockIdx.x;
  const int w0 = (t % n_wtiles) * TW;
  t /= n_wtiles;
  const int h0 = (t % n_htiles) * TH;
  const int b = t / n_htiles;
  const int n_iters = 9 * ((Cp + KC32 - 1) / KC32);

  auto issue = [&](int it) {
    const int s = it % S32;
    const int c0 = (it / 9) * KC32;
    const int tap = it % 9;
    const uint32_t st = smem_u32(smem + s * Cfg::STAGE);
    mbar_expect_tx(full + 8 * s, Cfg::STAGE);
    tma_load_4d(st, &tm_x, full + 8 * s, c0, w0 + tap % 3 - 1,
                h0 + tap / 3 - 1, b);
    tma_load_3d(st + A32_BYTES, &tm_w, full + 8 * s, c0, tap, co0);
  };

  if (tid == 0) {
    for (int s = 0; s < S32; ++s) mbar_init(full + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < S32 - 1 && it < n_iters; ++it) issue(it);

  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;

  // row r's 16-byte chunk q sits at r * 128 + ((q ^ (r % 8)) * 16); the
  // rows this thread reads are ty + 16 i and tx + 16 j, so r % 8 is fixed
  const int a_sw = ty & 7, b_sw = tx & 7;
  for (int it = 0; it < n_iters; ++it) {
    // every thread is past iteration it - 1: its stage may be refilled
    if (tid == 0 && it + S32 - 1 < n_iters) issue(it + S32 - 1);
    const int s = it % S32;
    mbar_wait(full + 8 * s, (it / S32) & 1);
    const unsigned char* sa = smem + s * Cfg::STAGE;
    const unsigned char* sb = sa + A32_BYTES;
#pragma unroll 1
    for (int q = 0; q < KC32 / 4; ++q) {
      float4 bv[JN];
#pragma unroll
      for (int j = 0; j < JN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(
            sb + (tx + 16 * j) * 128 + ((q ^ b_sw) << 4));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            sa + (ty + 16 * i) * 128 + ((q ^ a_sw) << 4));
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int w = w0 + ty;
  if (w >= W) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int h = h0 + i;
    if (h >= H) continue;
    float* o = out + (((long long)b * H + h) * W + w) * Co;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < Co) o[co] = acc[i][j] + (bias != nullptr ? bias[co] : 0.f);
    }
  }
}

// ---- packing: (B, C, H, W) at any strides -> (B, H, W, Cp) ----
// A block moves 64 pixels x 64 channels through shared memory: reads run
// along the pixels (NCHW) or the channels (channels-last), writes along the
// channels in 16-byte vectors; channels C .. Cp - 1 are written as zeros.  T is the
// element's bits (uint16_t for bf16, uint32_t for fp32): a pure copy.
constexpr int PACK_P = 64, PACK_C = 64, PACK_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(PACK_THREADS)
pack_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int Cp,
                 int H, int W, long long sb, long long sc, long long sh,
                 long long sw) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ T tile[PACK_C][PACK_P + 1];
  const int HW = H * W;  // < 2^31 (checked by the launcher)
  const int p0 = blockIdx.x * PACK_P;
  const int c0 = blockIdx.y * PACK_C;
  const T* xb = x + blockIdx.z * sb;
  // neighbouring threads read neighbouring addresses: along the channels
  // when they are x's innermost dim (channels-last), else along the pixels
  if (sc == 1) {
    const int cl = threadIdx.x % PACK_C, c = c0 + cl;
    for (int pl = threadIdx.x / PACK_C; pl < PACK_P;
         pl += PACK_THREADS / PACK_C) {
      const int p = p0 + pl;
      T v = 0;
      if (c < C && p < HW) {
        const int h = p / W;
        v = xb[c + h * sh + (long long)(p - h * W) * sw];
      }
      tile[cl][pl] = v;
    }
  } else {
    const int pl = threadIdx.x % PACK_P, p = p0 + pl;
    long long p_off = 0;
    if (p < HW) {
      const int h = p / W;
      p_off = h * sh + (long long)(p - h * W) * sw;
    }
    for (int cl = threadIdx.x / PACK_P; cl < PACK_C;
         cl += PACK_THREADS / PACK_P) {
      const int c = c0 + cl;
      tile[cl][pl] = (c < C && p < HW) ? xb[c * sc + p_off] : T(0);
    }
  }
  __syncthreads();
  T* ob = out + (long long)blockIdx.z * HW * Cp;
  for (int e = threadIdx.x; e < PACK_P * (PACK_C / VEC); e += PACK_THREADS) {
    const int pl = e / (PACK_C / VEC), cv = (e % (PACK_C / VEC)) * VEC;
    const long long p = p0 + pl;
    if (p >= HW || c0 + cv >= Cp) continue;  // Cp % VEC == 0
    union {
      uint4 u;
      T v[VEC];
    } pack;
#pragma unroll
    for (int k = 0; k < VEC; ++k) pack.v[k] = tile[cv + k][pl];
    *reinterpret_cast<uint4*>(ob + p * Cp + c0 + cv) = pack.u;
  }
}

template <int JN>
int launch_f32(dim3 grid, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
               const float* bias, void* out, int Cp, int Co, int H, int W,
               int n_htiles, int n_wtiles, cudaStream_t stream) {
  auto kernel = conv3x3_f32_kernel<JN>;
  constexpr int smem = F32Cfg<JN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS32, smem, stream>>>(tm_x, tm_w, bias,
                                            static_cast<float*>(out), Cp, Co,
                                            H, W, n_htiles, n_wtiles);
  return (int)cudaGetLastError();
}

// RES: persistent, as many blocks as are resident at once (each loads the
// weights once); otherwise a block per tile, which the hardware balances
// better (a persistent grid read 2-5% slower at the streaming convs)
template <int TN, bool RES>
int launch_bf16(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                const float* bias, void* out, int Cp, int Co, int H, int W,
                int n_htiles, int n_wtiles, int n_mtiles, int n_tiles,
                cudaStream_t stream) {
  auto kernel = conv3x3_bf16_kernel<TN, RES>;
  constexpr int smem = Bf16Cfg<TN, RES>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = n_tiles;
  if constexpr (RES) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 384,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return -3;
    if (blocks > sms * per_sm) blocks = sms * per_sm;
  }
  kernel<<<blocks, 384, smem, stream>>>(
      tm_x, tm_w, bias, static_cast<__nv_bfloat16*>(out), Cp, Co, H, W,
      n_htiles, n_wtiles, n_mtiles, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, Cp) and w (Co, 3, 3, Cp) contiguous, channels past the true
// Ci zero, Cp a multiple of 8, 16-byte aligned; out (B, H, W, Co)
// contiguous.  dtype: 0 = float32, 1 = bfloat16 (x, w and out alike; bias
// float32 or null).  Returns the CUDA error code of the launch, -1 for an
// unknown dtype, -2 for Cp not a multiple of 8, -3 for a grid the hardware
// cannot launch, -4/-5 if no tensor map could be made (see hopper.cuh).
extern "C" int occ_conv3x3(const void* x, const void* w, const float* bias,
                           void* out, int dtype, long long B, long long Cp,
                           long long Co, long long H, long long W,
                           cudaStream_t stream) {
  if (B == 0 || Co == 0 || H == 0 || W == 0) return 0;
  if (Cp % 8 != 0 || Cp == 0) return -2;
  const long long n_htiles = (H + TH - 1) / TH;
  const long long n_wtiles = (W + TW - 1) / TW;
  if (B * n_htiles * n_wtiles > 0x7fffffffLL || Co > 0x7fffffffLL ||
      Cp > 0x7fffffffLL || H > 0x7fffffffLL || W > 0x7fffffffLL)
    return -3;
  const int es = dtype == 0 ? 4 : 2;
  const CUtensorMapDataType tdt = dtype == 0
                                      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t kc = dtype == 0 ? KC32 : KC16;
  const uint64_t x_dims[4] = {(uint64_t)Cp, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
  const uint64_t x_strides[3] = {(uint64_t)(Cp * es), (uint64_t)(W * Cp * es),
                                 (uint64_t)(H * W * Cp * es)};
  // bf16: the (TH + 2) x HALO_W halo of a tile per chunk; fp32: the tile
  // itself, shifted per tap
  const uint32_t x_box[4] = {kc, dtype == 0 ? (uint32_t)TW : HALO_W,
                             dtype == 0 ? (uint32_t)TH : HALO_H, 1};
  CUtensorMap tm_x, tm_w;
  int rc = make_tensor_map(&tm_x, tdt, 4, x, x_dims, x_strides, x_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const uint64_t w_dims[3] = {(uint64_t)Cp, 9, (uint64_t)Co};
  const uint64_t w_strides[2] = {(uint64_t)(Cp * es), (uint64_t)(9 * Cp * es)};
  const int m_tiles = (int)(B * n_htiles * n_wtiles);
  const int iCp = (int)Cp, iCo = (int)Co, iH = (int)H, iW = (int)W;
  const int nh = (int)n_htiles, nw = (int)n_wtiles;
  // TN output channels per block, by Co: 64 or 128 (fp32), 48, 96 or 192
  // (bf16)
  const int tn = dtype == 0 ? (Co <= 64 ? 64 : 128)
                            : Co <= 48 ? 48 : Co <= 96 ? 96 : 192;
  const long long n_ctiles = (Co + tn - 1) / tn;
  if (m_tiles * n_ctiles > 0x7fffffffLL) return -3;
  const int n_tiles = (int)(m_tiles * n_ctiles);
  const uint32_t w_box[3] = {kc, 1, (uint32_t)tn};
  if ((rc = make_tensor_map(&tm_w, tdt, 3, w, w_dims, w_strides, w_box,
                            CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return rc;
  if (dtype == 0) {
    const dim3 grid((unsigned)m_tiles, (unsigned)n_ctiles);
    return tn == 64 ? launch_f32<4>(grid, tm_x, tm_w, bias, out, iCp, iCo,
                                    iH, iW, nh, nw, stream)
                    : launch_f32<8>(grid, tm_x, tm_w, bias, out, iCp, iCo,
                                    iH, iW, nh, nw, stream);
  }
  if (dtype != 1) return -1;
  if (tn == 48 && Cp <= 2 * KC16)  // the weights fit: keep them resident
    return launch_bf16<48, true>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW, nh,
                                 nw, m_tiles, n_tiles, stream);
  if (tn == 48)
    return launch_bf16<48, false>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW,
                                  nh, nw, m_tiles, n_tiles, stream);
  if (tn == 96)
    return launch_bf16<96, false>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW,
                                  nh, nw, m_tiles, n_tiles, stream);
  return launch_bf16<192, false>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW, nh,
                                 nw, m_tiles, n_tiles, stream);
}

// x (B, C, H, W) at strides (sb, sc, sh, sw) in elements -> out (B, H, W,
// Cp) contiguous, 16-byte aligned, channels past C zero; Cp a multiple of
// 8 and >= C.  dtype as occ_conv3x3.  Returns the CUDA error code of the
// launch, -1 for an unknown dtype, -2 for a bad Cp, -3 for a grid the
// hardware cannot launch.
extern "C" int occ_pack_nhwc(const void* x, void* out, int dtype, long long B,
                             long long C, long long Cp, long long H,
                             long long W, long long sb, long long sc,
                             long long sh, long long sw,
                             cudaStream_t stream) {
  if (B == 0 || H == 0 || W == 0 || Cp == 0) return 0;
  if (Cp % 8 != 0 || Cp < C) return -2;
  const long long p_tiles = (H * W + PACK_P - 1) / PACK_P;
  const long long c_tiles = (Cp + PACK_C - 1) / PACK_C;
  if (H * W > 0x7fffffffLL || c_tiles > 65535 || B > 65535 ||
      Cp > 0x7fffffffLL || H > 0x7fffffffLL || W > 0x7fffffffLL)
    return -3;
  const dim3 grid((unsigned)p_tiles, (unsigned)c_tiles, (unsigned)B);
  if (dtype == 0) {
    pack_nhwc_kernel<uint32_t><<<grid, PACK_THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), (int)C,
        (int)Cp, (int)H, (int)W, sb, sc, sh, sw);
  } else if (dtype == 1) {
    pack_nhwc_kernel<uint16_t><<<grid, PACK_THREADS, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), (int)C,
        (int)Cp, (int)H, (int)W, sb, sc, sh, sw);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
