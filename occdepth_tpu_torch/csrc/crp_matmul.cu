// CRP relation product: out[b] = sigmoid(P[b]) @ mega[b], fp32 accumulation.
//
// Replaces the TPU kernel occdepth_tpu/ops/pallas_kernels.py
// `crp_relation_matmul` (body `_crp_kernel`): the sigmoid is applied to
// each LHS tile as it is loaded, so the (N, M) probability matrix is never
// written to device memory.
//
// What bounds it on Hopper: arithmetic.  At the flagship KITTI shape
// (N=4096 voxels, M=512 mega-voxels, C=256 channels) one relation is
// 1.07 GFLOP against ~6 MB of operands, ~180 flop/byte.  This first
// version is a classic shared-memory tiled GEMM on the CUDA cores: a
// 64x64 output tile per 256-thread block, K-steps of 16, each thread
// accumulating a 4x4 register micro-tile in fp32.  Operands are staged in
// shared memory once per tile (sigmoid folded into the LHS staging), so
// device traffic is ~(N*M + M*C) * (tiles along the other side) and the
// inner loop runs from shared memory and registers.  Tensor cores (wgmma),
// TMA and multi-stage pipelining are not used yet.
//
// Layouts: every operand is addressed through (batch, row, col) strides.
// The model produces P as (B, M, N) and mega as (B, C, M) (NCDHW 1x1 conv
// outputs), i.e. transposed views; staging picks the unit-stride axis for
// consecutive threads so loads stay coalesced either way.  The output is
// written through strides too, so the caller can have it land in the
// channels-first (B, C, N) layout the next 3D conv reads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output rows (voxels) per block
constexpr int BN = 64;   // output cols (channels) per block
constexpr int BK = 16;   // reduction (mega-voxel) step
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
crp_relation_matmul_kernel(const T* __restrict__ P, const T* __restrict__ G,
                           float* __restrict__ out, long long N, long long M,
                           long long C, long long p_sb, long long p_sn,
                           long long p_sm, long long g_sb, long long g_sm,
                           long long g_sc, long long o_sb, long long o_sn,
                           long long o_sc) {
  // +1 padding keeps the column-major staging stores off one bank
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tn = tid % 16;  // lanes walk output rows: coalesced when o_sn == 1
  const int tc = tid / 16;
  const long long b = blockIdx.z;
  const long long n0 = (long long)blockIdx.x * BM;
  const long long c0 = (long long)blockIdx.y * BN;
  const T* Pb = P + b * p_sb;
  const T* Gb = G + b * g_sb;
  const bool p_rows_fast = (p_sn == 1);
  const bool g_k_fast = (g_sm == 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = 0; k0 < M; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = p_rows_fast ? e % BM : e / BK;
      const int k = p_rows_fast ? e / BM : e % BK;
      const long long n = n0 + r;
      const long long m = k0 + k;
      float v = 0.f;  // padding must stay 0, not sigmoid(0)
      if (n < N && m < M) {
        const float x = to_f32(Pb[n * p_sn + m * p_sm]);
        v = 1.f / (1.f + expf(-x));
      }
      As[k][r] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = g_k_fast ? e % BK : e / BN;
      const int c = g_k_fast ? e / BK : e % BN;
      const long long m = k0 + k;
      const long long cc = c0 + c;
      Bs[k][c] = (m < M && cc < C) ? to_f32(Gb[m * g_sm + cc * g_sc]) : 0.f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long n = n0 + tn + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = c0 + tc + 16 * j;
      if (c < C) out[b * o_sb + n * o_sn + c * o_sc] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* p, const void* g, float* out, long long B, long long N,
           long long M, long long C, long long p_sb, long long p_sn,
           long long p_sm, long long g_sb, long long g_sm, long long g_sc,
           long long o_sb, long long o_sn, long long o_sc,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BM - 1) / BM), (unsigned)((C + BN - 1) / BN),
                  (unsigned)B);
  crp_relation_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(g), out, N, M, C, p_sb,
      p_sn, p_sm, g_sb, g_sm, g_sc, o_sb, o_sn, o_sc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 operands, 1 = bfloat16 operands (output always fp32).
// Returns the CUDA error code of the launch; -1 for an unknown dtype.
extern "C" int occ_crp_relation_matmul(const void* p, const void* g,
                                       float* out, int dtype, long long B,
                                       long long N, long long M, long long C,
                                       long long p_sb, long long p_sn,
                                       long long p_sm, long long g_sb,
                                       long long g_sm, long long g_sc,
                                       long long o_sb, long long o_sn,
                                       long long o_sc, cudaStream_t stream) {
  if (B == 0 || N == 0 || C == 0) return 0;
  if (dtype == 0)
    return launch<float>(p, g, out, B, N, M, C, p_sb, p_sn, p_sm, g_sb, g_sm,
                         g_sc, o_sb, o_sn, o_sc, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, out, B, N, M, C, p_sb, p_sn, p_sm,
                                 g_sb, g_sm, g_sc, o_sb, o_sn, o_sc, stream);
  return -1;
}
