// CRP relation product: out[b, r] = sigmoid(P[b, r]) @ mega[b], fp32
// accumulation, for every batch item b and relation r in one launch.
//
// Replaces the TPU kernel occdepth_tpu/ops/pallas_kernels.py:61
// `crp_relation_matmul` (body `_crp_kernel`): the sigmoid is applied to
// each logits tile on its way into the product, so the (N, M) probability
// matrix is never written to device memory.
//
// What bounds it on Hopper.  At the flagship KITTI shape (N = 4096 voxels,
// M = 512 mega-voxels, C = 256 channels, R = 4 relations, B = 2) the bf16
// logits (33.5 MB) and the fp32 output (33.5 MB) are the bytes; the
// product is 8.6 GFLOP, doubled to 17.2 by the split below: ~0.020 ms of
// bytes against ~0.017 ms of bf16 tensor-core work, so both matter.
//
// bf16 operands, the layout the model passes (logits N-contiguous, mega
// M-contiguous): `crp_wgmma_kernel`.
//   * out (N x C) = S (N x M) . mega (M x C) with mega the wgmma B operand:
//     mega's (C, M) memory is K-major, so TMA lands 64-mega-voxel chunks of
//     all 256 channels 128B-swizzled and `desc_sw128` reads them as is.
//   * A = S comes from registers (the RS form): the logits chunk lands by
//     TMA with voxels contiguous (rows are mega-voxels),
//     `ldmatrix_x4_trans` brings it into the A-fragment layout, and every
//     logit passes through registers for its sigmoid anyway.  (The SS form
//     would write the sigmoid back to shared memory and read it again: two
//     more passes over A for nothing.)
//   * Accuracy: the JAX kernel multiplies an fp32 sigmoid; one bf16
//     rounding of it would cost 2^-9 per term.  s = sigmoid(x) in fp32 is
//     split into s_hi = bf16(s) and s_lo = bf16(s - s_hi), and each k-step
//     issues two wgmmas on the same B tile: |s - s_hi - s_lo| <= 2^-18 |s|,
//     and mega is exact in bf16.
//   * A CTA owns 128 voxels (two consumer warpgroups of 64 rows each, one
//     m64n256 fp32 accumulator apiece) and 256 channels, for one (b, r);
//     a producer warpgroup (one thread issuing, 40 registers a thread)
//     keeps a 4-stage ring of 48 KB (two logits boxes and one mega box) in
//     flight; a consumer warp frees its stage once its wgmmas have
//     completed.  The consumers take 232 registers a thread (setmaxnreg):
//     128 accumulators and two sets of 32 for split A fragments, so that
//     the next chunk's sigmoid runs while this chunk's wgmmas do.  Grid: 32
//     voxel tiles x R x B = 256 CTAs at the flagship shape.
//   * Epilogue: fragments go straight to the (C, N) output: one store of a
//     register across a warp covers 4 channels x 8 voxels, four whole
//     32-byte sectors, so no staging is needed.
// (The wrapper hands mega that TMA cannot read, e.g. TartanAir's M = 1,350
// with a 2,700-byte stride, as a copy padded to M rounded up to 8.)
// Any other logits layout or fp32 operands: `crp_relation_matmul_kernel`, a
// shared-memory tiled GEMM on the CUDA cores (64x64 output tiles, k-steps
// of 16, a 4x4 register micro-tile per thread, sigmoid folded into the
// LHS staging), which computes the exact fp32 product as the JAX kernel
// does.  Every operand is addressed through (batch, relation, row, col)
// strides; mega's relation stride is 0 (shared by the relations).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---- the SIMT path: fp32 operands, or layouts TMA cannot read ----

constexpr int BM = 64;   // output rows (voxels) per block
constexpr int BN = 64;   // output cols (channels) per block
constexpr int BK = 16;   // reduction (mega-voxel) step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// strides of one operand set, in elements; blockIdx.z = b * R + r
struct Strides {
  long long p_sb, p_sr, p_sn, p_sm;
  long long g_sb, g_sm, g_sc;
  long long o_sb, o_sr, o_sn, o_sc;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
crp_relation_matmul_kernel(const T* __restrict__ P, const T* __restrict__ G,
                           float* __restrict__ out, long long N, long long M,
                           long long C, int R, Strides st) {
  // +1 padding keeps the column-major staging stores off one bank
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tn = tid % 16;  // lanes walk output rows: coalesced when o_sn == 1
  const int tc = tid / 16;
  const long long b = blockIdx.z / R;
  const long long r = blockIdx.z % R;
  const long long n0 = (long long)blockIdx.x * BM;
  const long long c0 = (long long)blockIdx.y * BN;
  const T* Pb = P + b * st.p_sb + r * st.p_sr;
  const T* Gb = G + b * st.g_sb;
  const bool p_rows_fast = (st.p_sn == 1);
  const bool g_k_fast = (st.g_sm == 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int rr = p_rows_fast ? e % BM : e / BK;
      const int k = p_rows_fast ? e / BM : e % BK;
      const long long n = n0 + rr;
      const long long m = k0 + k;
      float v = 0.f;  // padding must stay 0, not sigmoid(0)
      if (n < N && m < M) {
        const float x = to_f32(Pb[n * st.p_sn + m * st.p_sm]);
        v = 1.f / (1.f + expf(-x));
      }
      As[k][rr] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = g_k_fast ? e % BK : e / BN;
      const int c = g_k_fast ? e / BK : e % BN;
      const long long m = k0 + k;
      const long long cc = c0 + c;
      Bs[k][c] =
          (m < M && cc < C) ? to_f32(Gb[m * st.g_sm + cc * st.g_sc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tn + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = Bs[k][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + b * st.o_sb + r * st.o_sr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long n = n0 + tn + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = c0 + tc + 16 * j;
      if (c < C) ob[n * st.o_sn + c * st.o_sc] = acc[i][j];
    }
  }
}

template <typename T>
int launch_simt(const void* p, const void* g, float* out, long long B, int R,
                long long N, long long M, long long C, const Strides& st,
                cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)((C + BN - 1) / BN),
                  (unsigned)(B * R));
  crp_relation_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g), out, N, M, C, R,
      st);
  return (int)cudaGetLastError();
}

// ---- the wgmma path: bf16, logits N-contiguous, mega M-contiguous ----

constexpr int WG_ROWS = 64;           // voxels per consumer warpgroup
constexpr int TILE_N = 2 * WG_ROWS;   // voxels per CTA
constexpr int TILE_C = 256;           // channels per CTA: one m64n256
constexpr int KCH = 64;               // mega-voxels per chunk (128 bytes)
constexpr int STAGES = 4;
constexpr int A_BYTES = KCH * WG_ROWS * 2;      // one warpgroup's logits
constexpr int B_BYTES = TILE_C * KCH * 2;       // the chunk of mega
constexpr int STAGE_BYTES = 2 * A_BYTES + B_BYTES;
constexpr int WG_THREADS = 384;  // a producer and two consumer warpgroups
constexpr int WG_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));  // == 1 / (1 + e^-x), correctly rounded
}

// the sigmoid of a bf16 pair, split into hi and lo bf16 pairs
__device__ __forceinline__ void sigmoid_split(uint32_t x, uint32_t& hi,
                                              uint32_t& lo) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x));
  const float s0 = sigmoid(f.x), s1 = sigmoid(f.y);
  const __nv_bfloat162 h = __floats2bfloat162_rn(s0, s1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(s0 - hf.x, s1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the consumer warpgroups: for each k-chunk, A fragments from the logits
// tile through ldmatrix.trans and the split sigmoid, two wgmmas per k16
// step on the chunk's mega tile, then the epilogue; ctid is the thread's
// index among the 256 consumers, ob the (b, r) output
__device__ __forceinline__ void consume(const unsigned char* smem,
                                        uint32_t bars, int kc_total,
                                        int ctid, int n0, int c0, int N,
                                        int C, float* __restrict__ ob,
                                        long long o_sn, long long o_sc) {
  const int wg = ctid >> 7, warp = (ctid >> 5) & 3, lane = ctid & 31;
  // ldmatrix: thread `lane` addresses row lane % 8 of matrix lane / 8,
  // matrices (k 0-7, n 0-7), (k 0-7, n 8-15), (k 8-15, n 0-7), (k 8-15,
  // n 8-15) of this warp's 16 voxels; n is the 16-byte chunk in a row
  const int mat = lane >> 3;
  const int chunk = 2 * warp + (mat & 1);
  const int krow = 8 * (mat >> 1) + (lane & 7);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // chunk kc's A fragments: ldmatrix.trans of its logits, the split sigmoid
  auto prep = [&](int kc, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const int s = kc % STAGES;
    mbar_wait(bars + 8 * s, (kc / STAGES) & 1);
    const uint32_t a_s = smem_u32(smem + s * STAGE_BYTES + wg * A_BYTES);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * j + krow;
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, a_s + k * 128 + ((chunk ^ (k & 7)) << 4));
#pragma unroll
      for (int q = 0; q < 4; ++q) sigmoid_split(raw[q], hi[j][q], lo[j][q]);
    }
  };
  // chunk kc's eight wgmmas (hi and lo per k16 step, one B tile)
  auto mma = [&](int kc, const uint32_t (&hi)[4][4],
                 const uint32_t (&lo)[4][4]) {
    const uint32_t b_s =
        smem_u32(smem + (kc % STAGES) * STAGE_BYTES + 2 * A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t db = desc_sw128(b_s + 32 * j);
      wgmma_bf16_rs(acc, hi[j], db, 1);
      wgmma_bf16_rs(acc, lo[j], db, 1);
    }
    wgmma_commit();
  };
  // once chunk kc's wgmmas are done, its stage goes back to the producer
  auto release = [&](int kc) {
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + kc % STAGES));
  };
  // two register sets: the next chunk's sigmoid runs under this chunk's
  // wgmmas
  uint32_t hi0[4][4], lo0[4][4], hi1[4][4], lo1[4][4];
  if (kc_total > 0) prep(0, hi0, lo0);
  for (int kc = 0; kc < kc_total; kc += 2) {
    mma(kc, hi0, lo0);
    if (kc + 1 < kc_total) prep(kc + 1, hi1, lo1);
    release(kc);
    if (kc + 1 >= kc_total) break;
    mma(kc + 1, hi1, lo1);
    if (kc + 2 < kc_total) prep(kc + 2, hi0, lo0);
    release(kc + 1);
  }

  // rows n and n + 8, columns c0 + 8 j + 2 (lane % 4) + {0, 1}
  const long long n = n0 + wg * WG_ROWS + 16 * warp + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = c0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long nn = n + 8 * h;
      if (nn >= N) continue;
      if (c < C) ob[nn * o_sn + c * o_sc] = acc[4 * j + 2 * h];
      if (c + 1 < C) ob[nn * o_sn + (c + 1) * o_sc] = acc[4 * j + 2 * h + 1];
    }
  }
}

__global__ void __launch_bounds__(WG_THREADS, 1)
crp_wgmma_kernel(const __grid_constant__ CUtensorMap tm_p,
                 const __grid_constant__ CUtensorMap tm_g,
                 float* __restrict__ out, int N, int M, int C, int R,
                 long long o_sb, long long o_sr, long long o_sn,
                 long long o_sc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + STAGES * STAGE_BYTES);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s)
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE_N;
  const int r = blockIdx.y % R;
  const int c0 = (blockIdx.y / R) * TILE_C;
  const int b = blockIdx.z;
  const int kc_total = (M + KCH - 1) / KCH;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one branch per role, never reconverging (setmaxnreg needs it)
  if (tid < 128) {  // the producer warpgroup: one thread issues
    setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kc = 0; kc < kc_total; ++kc) {
        const int s = kc % STAGES;
        if (kc >= STAGES)
          mbar_wait(bars + 8 * (STAGES + s), ((kc / STAGES) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load_4d(st, &tm_p, full, n0, kc * KCH, r, b);
        tma_load_4d(st + A_BYTES, &tm_p, full, n0 + WG_ROWS, kc * KCH, r, b);
        tma_load_3d(st + 2 * A_BYTES, &tm_g, full, kc * KCH, c0, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consume(smem, bars, kc_total, tid - 128, n0, c0, N, C,
            out + (long long)b * o_sb + (long long)r * o_sr, o_sn, o_sc);
  }
}

int launch_wgmma(const void* p, const void* g, float* out, long long B,
                 int R, long long N, long long M, long long C,
                 const Strides& st, cudaStream_t stream) {
  if (N > 0x7fffffffLL || M > 0x7fffffffLL || C > 0x7fffffffLL ||
      B > 65535 || (long long)R * ((C + TILE_C - 1) / TILE_C) > 65535)
    return -3;
  CUtensorMap tm_p, tm_g;
  // logits (B, R, M, N), N innermost; mega (B, C, M), M innermost
  const uint64_t p_dims[4] = {(uint64_t)N, (uint64_t)M, (uint64_t)R,
                              (uint64_t)B};
  const uint64_t p_strides[3] = {(uint64_t)st.p_sm * 2,
                                 (uint64_t)st.p_sr * 2,
                                 (uint64_t)st.p_sb * 2};
  const uint32_t p_box[4] = {WG_ROWS, KCH, 1, 1};
  const uint64_t g_dims[3] = {(uint64_t)M, (uint64_t)C, (uint64_t)B};
  const uint64_t g_strides[2] = {(uint64_t)st.g_sc * 2,
                                 (uint64_t)st.g_sb * 2};
  const uint32_t g_box[3] = {KCH, TILE_C, 1};
  int rc = make_tensor_map(&tm_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p,
                           p_dims, p_strides, p_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_tensor_map(&tm_g, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, g,
                         g_dims, g_strides, g_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      crp_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + TILE_N - 1) / TILE_N),
                  (unsigned)(R * ((C + TILE_C - 1) / TILE_C)), (unsigned)B);
  crp_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tm_p, tm_g, out, (int)N, (int)M, (int)C, R, st.o_sb, st.o_sr, st.o_sn,
      st.o_sc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands (output always fp32).
// path: 0 = the SIMT kernel (any strides), 1 = the wgmma kernel (bf16;
// p_sn == 1 and g_sm == 1, every other stride a multiple of 8 elements,
// both operands 16-byte aligned: the caller checks).  Logits are
// (B, R, N, M), mega (B, M, C) shared by the R relations, out
// (B, R, N, C), all through strides in elements.  Returns the CUDA error
// code of the launch; -1 for an unknown dtype or path, -3 for sizes the
// kernel cannot take, -4/-5 if no tensor map could be made.
extern "C" int occ_crp_relation_matmul(
    const void* p, const void* g, float* out, int dtype, int path,
    long long B, long long R, long long N, long long M, long long C,
    long long p_sb, long long p_sr, long long p_sn, long long p_sm,
    long long g_sb, long long g_sm, long long g_sc, long long o_sb,
    long long o_sr, long long o_sn, long long o_sc, cudaStream_t stream) {
  if (B == 0 || R == 0 || N == 0 || C == 0) return 0;
  if (R > 65535 || B * R > 0x7fffffffLL) return -3;
  const Strides st{p_sb, p_sr, p_sn, p_sm, g_sb, g_sm, g_sc,
                   o_sb, o_sr, o_sn, o_sc};
  if (path == 1) {
    if (dtype != 1) return -1;
    return launch_wgmma(p, g, out, B, (int)R, N, M, C, st, stream);
  }
  if (path != 0) return -1;
  if (dtype == 0)
    return launch_simt<float>(p, g, out, B, (int)R, N, M, C, st, stream);
  if (dtype == 1)
    return launch_simt<__nv_bfloat16>(p, g, out, B, (int)R, N, M, C, st,
                                      stream);
  return -1;
}
