// 3x3 stride-1 SAME convolution + bias, channels-last (NHWC) in and out:
//
//   out[b, h, w, o] = bias[o] + sum_{dr, dc, c} x[b, h+dr-1, w+dc-1, c]
//                                               * w[o, dr, dc, c]
//
// (zero outside the image), products summed in fp32, the fp32 bias added
// in the epilogue and one rounding to the output dtype.  x is (B, H, W, Cp)
// and w (Co, 3, 3, Cp) (in fp32 its TF32 hi/lo split, (2, Co, 3, 3, Cp)),
// both with Cp a multiple of 8 and the channels past the true Ci zero (the
// wrapper packs them: ops/conv2d_shift.py).
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
//   * fp32: 3xTF32 on wgmma.  The flagship decoder's ~600 GFLOP per
//     frame in fp32 take 3.6 ms at 165 TFLOP/s (three TF32 products at
//     495) against 9.0 ms on the CUDA cores (67 TFLOP/s): arithmetic bounds
//     it again, on the tensor cores.  Per 32-channel chunk the same TMA
//     halo as bf16 (128 bytes of channels a pixel: box (32 ch, 24, 10,
//     1)).  A goes through registers (the RS form): per tap each consumer
//     thread reads its fragments from the halo with 32-bit shared loads
//     (no ldmatrix for 32-bit elements; the swizzle keeps them free of
//     bank conflicts) and splits them into TF32 hi and lo (round to
//     nearest), so nothing is written back to shared memory (the SS form
//     would need hi and lo copies of each halo, 60 KB more a stage) at
//     the cost of redoing the split per tap.  B, the weights, is split
//     once per call by the wrapper into a (2, Co, 9, Cp) hi/lo buffer
//     (tf32_split.cu),
//     and per tap one TMA load brings hi and lo, box (32 ch, 1, TN, 1).
//     Three wgmmas m64nTNk8 per 8-channel step (lo.hi, hi.lo, hi.hi), TN =
//     48, 96 or 128, whichever pads Co the least.  The tensor cores round
//     each accumulation toward zero: over KITTI's 9 x 1,672-channel conv
//     that bias reached 1.1e-4 of max|out|, so each chunk accumulates
//     apart and is added into a second, round-to-nearest set of fp32
//     registers (hence TN <= 128).  Measured error against fp32 with TF32
//     off, at the decoders' thirty convs: at most 2.6e-6 of max|out| (NVIDIA
//     H100 80GB HBM3, 700 W), where one TF32 product would be ~3e-4;
//   * the epilogue adds the bias and stores straight from the accumulators
//     into the NHWC output, masked at the image edge and past Co.
// The wrapper's packing of an input that is not channels-last already is
// the transposing copy `occ_pack_nhwc` at the end of this file.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TH = 8, TW = 16;          // output pixel tile

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

// ---- fp32: 3xTF32 wgmma, A from the halo through registers ----
constexpr int KC32 = 32;  // channels per chunk (128 bytes)

// Per tile: halos of 32 channels stream two deep (30 KB each); the taps'
// weights, TF32 hi and lo (TN x 128 bytes each), stream through a ring of
// SB stages beside them, one block of ~210-221 KB per SM.  TN = 48, 96 or
// 128: a consumer thread holds TN / 2 accumulators twice (see
// conv_tf32_consume) and 64 registers of split A fragments.
template <int TN>
struct Tf32Cfg {
  static constexpr int B_BYTES = TN * 128;  // one tap's weights, hi or lo
  static constexpr int SA = 2;              // halo stages
  static constexpr int BUDGET = 220 * 1024;
  static constexpr int SB_FIT = (BUDGET - SA * HALO_BYTES) / (2 * B_BYTES);
  static constexpr int SB = SB_FIT < 12 ? SB_FIT : 12;
  static constexpr int SMEM =
      1024 + SA * HALO_BYTES + 2 * SB * B_BYTES + 2 * (SA + SB) * 8;
};

// element (halo row p, channel ch) of a 128B-swizzled fp32 halo
__device__ __forceinline__ float halo_at(const unsigned char* halo, int p,
                                         int ch) {
  return *reinterpret_cast<const float*>(
      halo + p * 128 + (((ch >> 2) ^ (p & 7)) << 4) + (ch & 3) * 4);
}

// The consumer warpgroup q of the fp32 kernel: for each (chunk, tap) its
// A fragments come from the halo by 32-bit shared loads (the 8 lanes of a
// k column read 8 consecutive halo rows, whose swizzle puts them in 8
// distinct 16-byte chunks: no bank conflicts), are split into TF32 hi and
// lo in registers, and multiply the tap's weights hi and lo in three
// wgmmas per 8-channel step.  Row m of the warpgroup's 64 is pixel (m / 8,
// 8 q + m % 8) of the tile, as in bf16.
//
// The tensor cores add each step into their fp32 accumulator rounding
// toward zero, a bias of up to an ulp per step that grows with the number
// of steps: over 9 x 1,672 channels (KITTI's 1_16 conv, 5,643 steps) it
// reached 1.1e-4 of max|out| (measured on the H100), past the fp32 path's
// 1e-4.  So the wgmmas accumulate one 32-channel chunk (108 steps) into
// `part`, which is then added into `acc` with round-to-nearest fp32 adds
// and restarted (scale_d = 0).
template <int TN>
__device__ __forceinline__ void conv_tf32_consume(
    const unsigned char* smem, uint32_t s_w, uint32_t full_a,
    uint32_t empty_a, uint32_t full_b, uint32_t empty_b, int n_chunks, int q,
    int tid, const float* __restrict__ bias, float* __restrict__ out, int b,
    int h0, int w0, int co0, int Co, int H, int W) {
  using Cfg = Tf32Cfg<TN>;
  constexpr int SA = Cfg::SA, SB = Cfg::SB;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool signal = tid == 0;
  const int n_it = 9 * n_chunks;  // (chunk, tap) steps
  float acc[TN / 2], part[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = part[i] = 0.f;

  auto prep = [&](int it, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const int c = it / 9, tap = it % 9, sa = c % SA;
    if (tap == 0) mbar_wait(full_a + 8 * sa, (c / SA) & 1);
    const unsigned char* halo = smem + sa * HALO_BYTES;
    const int p0 = (2 * warp + tap / 3) * HALO_W + 8 * q + tap % 3 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(halo_at(halo, p0, 8 * j + t), hi[j][0], lo[j][0]);
      split_tf32(halo_at(halo, p0 + HALO_W, 8 * j + t), hi[j][1], lo[j][1]);
      split_tf32(halo_at(halo, p0, 8 * j + t + 4), hi[j][2], lo[j][2]);
      split_tf32(halo_at(halo, p0 + HALO_W, 8 * j + t + 4), hi[j][3],
                 lo[j][3]);
    }
    if (tap == 8) {  // the chunk's last reads: its halo goes back
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_a + 8 * sa);
    }
  };
  // a chunk's first step restarts `part`
  auto mma = [&](int it, const uint32_t (&hi)[4][4],
                 const uint32_t (&lo)[4][4]) {
    const int sb = it % SB;
    mbar_wait(full_b + 8 * sb, (it / SB) & 1);
    const uint32_t w_hi = s_w + sb * 2 * Cfg::B_BYTES;
    const uint32_t w_lo = w_hi + Cfg::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dh = desc_sw128(w_hi + 32 * j);
      const uint64_t dl = desc_sw128(w_lo + 32 * j);
      wgmma_tf32_rs(part, lo[j], dh, j > 0 || it % 9 != 0);
      wgmma_tf32_rs(part, hi[j], dl, 1);
      wgmma_tf32_rs(part, hi[j], dh, 1);
    }
    wgmma_commit();
  };
  // after step it is issued: step it - 1 has completed and its weights go
  // back; at a chunk's last step everything has, and `part` joins `acc`
  auto retire = [&](int it) {
    if (it % 9 == 8) {
      wgmma_wait<0>();
      if (signal) {
        if (it > 0) mbar_arrive(empty_b + 8 * ((it - 1) % SB));
        mbar_arrive(empty_b + 8 * (it % SB));
      }
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] += part[i];
    } else {
      wgmma_wait<1>();
      if (signal && it % 9 != 0) mbar_arrive(empty_b + 8 * ((it - 1) % SB));
    }
  };
  // two register sets: step it + 1's loads and splits run under step it's
  // wgmmas, once step it - 1 (the set they overwrite) has completed
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
  prep(0, hi0, lo0);
  for (int it = 0; it < n_it; it += 2) {
    mma(it, hi0, lo0);
    retire(it);
    if (it + 1 >= n_it) break;
    prep(it + 1, hi1, lo1);
    mma(it + 1, hi1, lo1);
    retire(it + 1);
    if (it + 2 < n_it) prep(it + 2, hi0, lo0);
  }

  const int m0 = warp * 16 + g;
  const bool pairs = (Co & 1) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = m0 + 8 * hh;
    const int h = h0 + m / 8;
    const int w = w0 + 8 * q + m % 8;
    if (h >= H || w >= W) continue;
    float* o = out + (((long long)b * H + h) * W + w) * Co;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * t;
      if (co >= Co) continue;
      float v0 = acc[4 * j + 2 * hh], v1 = acc[4 * j + 2 * hh + 1];
      if (bias != nullptr) {
        v0 += bias[co];
        if (co + 1 < Co) v1 += bias[co + 1];
      }
      if (pairs) {
        *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
      } else {
        o[co] = v0;
        if (co + 1 < Co) o[co + 1] = v1;
      }
    }
  }
}

// One tile per block: tile blockIdx.x is pixel tile blockIdx.x % n_mtiles
// of column tile blockIdx.x / n_mtiles.  A producer warpgroup (one thread
// issuing, 40 registers) and two consumer warpgroups (232 registers:
// twice TN / 2 accumulators and two sets of 32 for split A fragments).
template <int TN>
__global__ void __launch_bounds__(384, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int Cp, int Co, int H, int W, int n_htiles, int n_wtiles,
                    int n_mtiles) {
  using Cfg = Tf32Cfg<TN>;
  constexpr int SA = Cfg::SA, SB = Cfg::SB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_halo = smem_u32(smem);              // SA halos
  const uint32_t s_w = s_halo + SA * HALO_BYTES;       // SB (hi, lo) taps
  const uint32_t full_a = s_w + 2 * SB * Cfg::B_BYTES;  // SA, then SA empty
  const uint32_t empty_a = full_a + 8 * SA;
  const uint32_t full_b = empty_a + 8 * SA;  // SB, then SB empty
  const uint32_t empty_b = full_b + 8 * SB;

  const int n_chunks = (Cp + KC32 - 1) / KC32;
  const int mt = blockIdx.x % n_mtiles;
  const int co0 = (blockIdx.x / n_mtiles) * TN;
  const int w0 = (mt % n_wtiles) * TW;
  const int h0 = (mt / n_wtiles % n_htiles) * TH;
  const int b = mt / n_wtiles / n_htiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < SB; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 2);  // one per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: per chunk the (10 x 24)-pixel halo, then the nine taps'
    // weights hi and lo, each into the next free stage of its ring
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int c = 0, it = 0; c < n_chunks; ++c) {
        const int sa = c % SA;
        mbar_wait(empty_a + 8 * sa, ((c / SA) & 1) ^ 1);
        mbar_expect_tx(full_a + 8 * sa, HALO_BYTES);
        tma_load_4d(s_halo + sa * HALO_BYTES, &tm_x, full_a + 8 * sa,
                    c * KC32, w0 - 1, h0 - 1, b);
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int sb = it % SB;
          mbar_wait(empty_b + 8 * sb, ((it / SB) & 1) ^ 1);
          mbar_expect_tx(full_b + 8 * sb, 2 * Cfg::B_BYTES);
          for (int h = 0; h < 2; ++h)
            tma_load_4d(s_w + (2 * sb + h) * Cfg::B_BYTES, &tm_w,
                        full_b + 8 * sb, c * KC32, tap, co0, h);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int q = (threadIdx.x >> 7) - 1;
    conv_tf32_consume<TN>(smem, s_w, full_a, empty_a, full_b, empty_b,
                          n_chunks, q, threadIdx.x & 127, bias, out, b, h0,
                          w0, co0, Co, H, W);
  }
}

// ---- packing: (B, C, H, W) at any strides -> (B, H, W, Cp) ----
// It is bound by bytes: C * H * W elements read once, Cp * H * W written
// once.  Channels C .. Cp - 1 are written as zeros.  T is the element's
// bits (uint16_t for bf16, uint32_t for fp32): a pure copy.
//
// `pack_planes_kernel` takes the usual input, whose (b, c) planes are
// contiguous (NCHW and its channel or batch slices): a thread moves one
// VEC x VEC block (VEC = 16 / sizeof(T): 8 bf16 or 4 fp32), reading VEC
// channels' VEC pixels as 16-byte vectors (narrower where the planes'
// offsets are not 16-byte aligned: a 185 x 610 bf16 plane is 225,700
// bytes), transposing them in registers (byte permutes for bf16), and
// writing VEC pixels' VEC channels as 16-byte vectors.  Neighbouring
// threads take neighbouring channel vectors of one pixel block, so a
// warp's reads are runs along the pixels of a few channels and its writes
// whole padded pixel rows.  No shared memory: the transpose of a block
// never leaves the thread.
// `pack_nhwc_kernel` moves a tile of PACK_ELEMS elements through shared
// memory, 64 pixels x 64 channels or, for rows of at most 32 channels
// (KITTI's C = 32), 128 pixels x 32 (so that no thread idles on pad
// channels and a block keeps twice the bytes in flight): reads along the
// pixels (NCHW) or the channels (channels-last), writes along the
// channels in 16-byte vectors.  It takes any strides, and every row width
// whose padded channels are 32 or a multiple of 64; the register kernel
// the other rows of contiguous planes (NYU's C = 100 and 200, whose last
// 64-channel tile would be partly idle).
constexpr int PACK_ELEMS = 4096, PACK_THREADS = 256;

union Vec16 {
  uint4 v;
  uint32_t w[4];
  uint16_t h[8];
};

// VEC elements at p, read `VR` bytes at a time (p aligned to VR)
template <typename T, int VR>
__device__ __forceinline__ uint4 load_vec(const T* p) {
  Vec16 r;
  if constexpr (VR == 16) {
    r.v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (VR == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 b = __ldg(reinterpret_cast<const uint2*>(p) + 1);
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = b.x; r.w[3] = b.y;
  } else if constexpr (VR == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r.w[k] = __ldg(reinterpret_cast<const uint32_t*>(p) + k);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r.h[k] = __ldg(reinterpret_cast<const unsigned short*>(p) + k);
  }
  return r.v;
}

// rows a[k] (channel k of the block, its VEC pixels) -> o[k] (pixel k of
// the block, its VEC channels)
__device__ __forceinline__ void transpose_block(const Vec16 (&a)[4],
                                                Vec16 (&o)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[p].w[j] = a[j].w[p];
}

__device__ __forceinline__ void transpose_block(const Vec16 (&a)[8],
                                                Vec16 (&o)[8]) {
  // word j of pixel p: channels 2j and 2j + 1, each the low or high half
  // of word p / 2 of its row
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[p].w[j] = __byte_perm(a[2 * j].w[p / 2], a[2 * j + 1].w[p / 2],
                              p % 2 ? 0x7632 : 0x5410);
}

template <typename T, int VR>
__global__ void __launch_bounds__(PACK_THREADS)
pack_planes_kernel(const T* __restrict__ x, T* __restrict__ out, int C,
                   int Cp, unsigned HW, long long sb, long long sc,
                   unsigned items, unsigned pvecs, unsigned cvecs) {
  constexpr int VEC = 16 / sizeof(T);
  for (unsigned i = blockIdx.x * PACK_THREADS + threadIdx.x; i < items;
       i += gridDim.x * PACK_THREADS) {
    const unsigned cv = i % cvecs, r = i / cvecs;
    const unsigned pv = r % pvecs, b = r / pvecs;
    const unsigned p0 = pv * VEC;
    const bool full = p0 + VEC <= HW;
    Vec16 a[VEC], o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = cv * VEC + k;
      a[k].v = make_uint4(0u, 0u, 0u, 0u);
      if (c >= C) continue;
      const T* src = x + b * sb + c * sc + p0;
      if (full) {
        a[k].v = load_vec<T, VR>(src);
      } else {
        T* e = reinterpret_cast<T*>(&a[k]);
        for (unsigned q = 0; p0 + q < HW; ++q) e[q] = src[q];
      }
    }
    transpose_block(a, o);
    T* dst = out + ((long long)b * HW + p0) * Cp + cv * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (p0 + k < HW)
        *reinterpret_cast<uint4*>(dst + (long long)k * Cp) = o[k].v;
  }
}

template <typename T, int PACK_C>
__global__ void __launch_bounds__(PACK_THREADS)
pack_nhwc_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int Cp,
                 int H, int W, long long sb, long long sc, long long sh,
                 long long sw) {
  constexpr int VEC = 16 / sizeof(T), PACK_P = PACK_ELEMS / PACK_C;
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

template <int TN>
int launch_tf32(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                const float* bias, void* out, int Cp, int Co, int H, int W,
                int n_htiles, int n_wtiles, int n_mtiles, int n_tiles,
                cudaStream_t stream) {
  auto kernel = conv3x3_tf32_kernel<TN>;
  constexpr int smem = Tf32Cfg<TN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_tiles, 384, smem, stream>>>(tm_x, tm_w, bias,
                                         static_cast<float*>(out), Cp, Co, H,
                                         W, n_htiles, n_wtiles, n_mtiles);
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

// x (B, H, W, Cp) contiguous, channels past the true Ci zero, Cp a
// multiple of 8, 16-byte aligned; out (B, H, W, Co) contiguous.  w: in
// bfloat16 (Co, 3, 3, Cp) contiguous, channels past Ci zero; in float32
// the (2, Co, 3, 3, Cp) TF32 hi/lo split of those weights (tf32_split.cu).
// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike; bias float32 or
// null).  Returns the CUDA error code of the launch, -1 for an unknown
// dtype, -2 for Cp not a multiple of 8, -3 for a grid the hardware cannot
// launch, -4/-5 if no tensor map could be made (see hopper.cuh).
extern "C" int occ_conv3x3(const void* x, const void* w, const float* bias,
                           void* out, int dtype, long long B, long long Cp,
                           long long Co, long long H, long long W,
                           cudaStream_t stream) {
  if (B == 0 || Co == 0 || H == 0 || W == 0) return 0;
  if (Cp % 8 != 0 || Cp == 0) return -2;
  if (dtype != 0 && dtype != 1) return -1;
  const long long n_htiles = (H + TH - 1) / TH;
  const long long n_wtiles = (W + TW - 1) / TW;
  if (B * n_htiles * n_wtiles > 0x7fffffffLL || Co > 0x7fffffffLL ||
      Cp > 0x7fffffffLL || H > 0x7fffffffLL || W > 0x7fffffffLL)
    return -3;
  const bool f32 = dtype == 0;
  const int es = f32 ? 4 : 2;
  const CUtensorMapDataType tdt = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t kc = f32 ? KC32 : KC16;  // 128 bytes of channels
  const uint64_t x_dims[4] = {(uint64_t)Cp, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
  const uint64_t x_strides[3] = {(uint64_t)(Cp * es), (uint64_t)(W * Cp * es),
                                 (uint64_t)(H * W * Cp * es)};
  // the (TH + 2) x HALO_W halo of a tile per chunk
  const uint32_t x_box[4] = {kc, HALO_W, HALO_H, 1};
  CUtensorMap tm_x, tm_w;
  int rc = make_tensor_map(&tm_x, tdt, 4, x, x_dims, x_strides, x_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  // w as (Cp, 9, Co[, 2]) innermost first; fp32 adds the hi/lo dim
  const uint64_t w_dims[4] = {(uint64_t)Cp, 9, (uint64_t)Co, 2};
  const uint64_t w_strides[3] = {(uint64_t)(Cp * es), (uint64_t)(9 * Cp * es),
                                 (uint64_t)(Co * 9 * Cp * es)};
  const int m_tiles = (int)(B * n_htiles * n_wtiles);
  const int iCp = (int)Cp, iCo = (int)Co, iH = (int)H, iW = (int)W;
  const int nh = (int)n_htiles, nw = (int)n_wtiles;
  // TN output channels per block, by Co.  bf16: 48, 96 or 192.  fp32:
  // 128, 96 or 48, whichever pads Co the least (the larger on a tie)
  int tn = Co <= 48 ? 48 : Co <= 96 ? 96 : 192;
  if (f32) {
    const long long pad128 = (Co + 127) / 128 * 128;
    const long long pad96 = (Co + 95) / 96 * 96, pad48 = (Co + 47) / 48 * 48;
    tn = pad128 <= pad96 && pad128 <= pad48 ? 128 : pad96 <= pad48 ? 96 : 48;
  }
  const long long n_ctiles = (Co + tn - 1) / tn;
  if (m_tiles * n_ctiles > 0x7fffffffLL) return -3;
  const int n_tiles = (int)(m_tiles * n_ctiles);
  const uint32_t w_box[4] = {kc, 1, (uint32_t)tn, 1};
  if ((rc = make_tensor_map(&tm_w, tdt, f32 ? 4 : 3, w, w_dims, w_strides,
                            w_box, CU_TENSOR_MAP_SWIZZLE_128B)) != 0)
    return rc;
  if (f32) {
    if (tn == 48)
      return launch_tf32<48>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW, nh, nw,
                             m_tiles, n_tiles, stream);
    if (tn == 96)
      return launch_tf32<96>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW, nh, nw,
                             m_tiles, n_tiles, stream);
    return launch_tf32<128>(tm_x, tm_w, bias, out, iCp, iCo, iH, iW, nh, nw,
                            m_tiles, n_tiles, stream);
  }
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
  if (dtype != 0 && dtype != 1) return -1;
  const int es = dtype == 0 ? 4 : 2, vec = 16 / es;
  // contiguous (b, c) planes whose rows the shared-memory tiles would
  // leave partly idle: the register kernel, reading as wide as the planes'
  // offsets allow
  const long long pvecs = (H * W + vec - 1) / vec, cvecs = Cp / vec;
  if (Cp > 32 && Cp % 64 != 0 && sw == 1 && (H == 1 || sh == W) &&
      H * W <= 0x7fffffffLL && B * pvecs * cvecs <= 0x7fffffffLL) {
    int vr = 16;
    auto fits = [&](long long bytes) {
      return bytes % vr == 0;
    };
    while (vr > es && !(reinterpret_cast<uintptr_t>(x) % vr == 0 &&
                        (B == 1 || fits(sb * es)) &&
                        (C == 1 || fits(sc * es))))
      vr /= 2;
    const long long items = B * pvecs * cvecs;
    const long long blocks = (items + PACK_THREADS - 1) / PACK_THREADS;
    const unsigned grid = (unsigned)(blocks < 132LL * 32 ? blocks : 132LL * 32);
#define OCC_PACK(T_, VR_)                                                    \
  pack_planes_kernel<T_, VR_><<<grid, PACK_THREADS, 0, stream>>>(            \
      static_cast<const T_*>(x), static_cast<T_*>(out), (int)C, (int)Cp,     \
      (unsigned)(H * W), sb, sc, (unsigned)items, (unsigned)pvecs,           \
      (unsigned)cvecs)
    if (dtype == 0) {
      if (vr == 16) OCC_PACK(uint32_t, 16);
      else if (vr == 8) OCC_PACK(uint32_t, 8);
      else OCC_PACK(uint32_t, 4);
    } else {
      if (vr == 16) OCC_PACK(uint16_t, 16);
      else if (vr == 8) OCC_PACK(uint16_t, 8);
      else if (vr == 4) OCC_PACK(uint16_t, 4);
      else OCC_PACK(uint16_t, 2);
    }
#undef OCC_PACK
    return (int)cudaGetLastError();
  }
  const int pack_c = Cp <= 32 ? 32 : 64, pack_p = PACK_ELEMS / pack_c;
  const long long p_tiles = (H * W + pack_p - 1) / pack_p;
  const long long c_tiles = (Cp + pack_c - 1) / pack_c;
  if (H * W > 0x7fffffffLL || c_tiles > 65535 || B > 65535 ||
      Cp > 0x7fffffffLL || H > 0x7fffffffLL || W > 0x7fffffffLL)
    return -3;
  const dim3 grid((unsigned)p_tiles, (unsigned)c_tiles, (unsigned)B);
#define OCC_TILE(T_, C_)                                                     \
  pack_nhwc_kernel<T_, C_><<<grid, PACK_THREADS, 0, stream>>>(               \
      static_cast<const T_*>(x), static_cast<T_*>(out), (int)C, (int)Cp,     \
      (int)H, (int)W, sb, sc, sh, sw)
  if (dtype == 0) {
    if (pack_c == 32) OCC_TILE(uint32_t, 32);
    else OCC_TILE(uint32_t, 64);
  } else {
    if (pack_c == 32) OCC_TILE(uint16_t, 32);
    else OCC_TILE(uint16_t, 64);
  }
#undef OCC_TILE
  return (int)cudaGetLastError();
}
