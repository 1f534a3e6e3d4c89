// Resident-operand matmul probe: out[s] = bf16(p[0] @ w) for every step s
// of n_steps, with p (1, m, k), w (k, n) and out (n_steps, m, n) bf16, the
// products summed in fp32 and rounded once.
//
// Replaces the TPU kernel occdepth_tpu/scripts/bench_head_pallas.py:55
// `pallas_matmul_probe` (body `_matmul_kernel`), which pins the p block in
// VMEM with a constant index map and runs one (m, k) @ (k, n) MXU product
// per grid step: the compute ceiling of a fused full-grid SSC-head kernel
// whose patches cost nothing to build.  The three probe shapes are im2col
// (8192, 432) @ (432, 16), dzpack (8192, 144) @ (144, 48) and lanefold
// (2048, 512) @ (512, 512), 256 to 2304 steps per call.
//
// What bounds it on Hopper: the tensor cores at im2col and lanefold (2 m k
// n flops per step against 2 m n output bytes), the output bytes at dzpack
// (its k is short).  The inputs are read once.  Design:
//   * a block of one warpgroup owns a 64-row tile of p and a panel of NP
//     columns of w (NP = 128, 64, 48 or 16, whichever divides n first);
//     one TMA load per 64-element k-chunk brings each into shared memory
//     once, 128B-swizzled and K-major (w arrives transposed: the wrapper
//     passes w^T (n, k)), where they stay for all of the block's steps;
//   * the blocks of one tile split the steps among them (grid z), as many
//     as fill every SM once;
//   * two consumer warpgroups share the tiles and take the block's steps
//     in turn.  Each step is one chain of k/16 wgmma m64nNPk16 into the
//     warpgroup's fp32 registers, operands read by the tensor cores
//     straight from the swizzled tiles, then its epilogue: round to bf16,
//     stage in the warpgroup's shared buffer, one TMA store.  While one
//     warpgroup is in its epilogue the other's chain keeps the tensor
//     cores busy, and the stores run behind both;
//   * the operands do not change between steps, so a compiler could hoist
//     the product out of the step loop and leave a kernel that only
//     stores.  wgmma is `asm volatile`, which the compiler may neither move
//     out of the loop nor delete; chip_smoke.py also fails if a run reads
//     under the operations bound.
// Staging: the output tile goes through a 128B-swizzled buffer when NP is
// a multiple of 64 (conflict-free 4-byte writes from the fragments), a
// plain row-major one otherwise.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;  // rows of p per block: one wgmma M
constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int MAX_SMEM = 232448;  // a Hopper block's dynamic shared memory
constexpr int P_CHUNK = TM * 128;  // one 64-element k-chunk of the p tile

template <int NP>
struct Tile {
  static constexpr bool SW_OUT = NP % 64 == 0;
  static constexpr int W_CHUNK = NP * 128;
  static constexpr int OUT_BYTES = TM * NP * 2;
  static int smem(int kc) {
    return 1024 + kc * (P_CHUNK + W_CHUNK) + 2 * OUT_BYTES + 16;
  }
};

// round a warpgroup's accumulators to bf16 into its staging buffer `buf`
// and store them as step s's (64 x NP) tile; wg_tid is the thread's index
// in the warpgroup, `bar` the warpgroup's named barrier
template <int NP>
__device__ __forceinline__ void store_step(const float (&acc)[NP / 2],
                                           unsigned char* buf,
                                           const CUtensorMap* tm_o, int col0,
                                           int row0, int s, int wg_tid,
                                           int bar) {
  // the warpgroup's previous store has finished reading the buffer
  if (wg_tid == 0) bulk_wait_read<0>();
  named_barrier(bar, 128);
  const int lane = wg_tid & 31;
  const int r0 = (wg_tid >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int c = 8 * j + cq;
      int off;
      if constexpr (Tile<NP>::SW_OUT) {
        off = (c >> 6) * (TM * 128) + r * 128 +
              ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
      } else {
        off = (r * NP + c) * 2;
      }
      *reinterpret_cast<__nv_bfloat162*>(buf + off) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_async_shared();
  named_barrier(bar, 128);
  if (wg_tid == 0) {
    if constexpr (Tile<NP>::SW_OUT) {
#pragma unroll
      for (int c = 0; c < NP / 64; ++c)
        tma_store_3d(tm_o, smem_u32(buf + c * TM * 128), col0 + 64 * c, row0,
                     s);
    } else {
      tma_store_3d(tm_o, smem_u32(buf), col0, row0, s);
    }
    bulk_commit();
  }
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
matmul_probe_kernel(const __grid_constant__ CUtensorMap tm_p,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_o, int k,
                    int n_steps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kc = (k + 63) / 64;
  unsigned char* s_p = smem;                          // [kc][TM rows][128 B]
  unsigned char* s_w = s_p + kc * P_CHUNK;            // [kc][NP rows][128 B]
  unsigned char* s_o = s_w + kc * Tile<NP>::W_CHUNK;  // an out tile per wg
  const uint32_t bar = smem_u32(s_o + 2 * Tile<NP>::OUT_BYTES);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * NP;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, kc * (P_CHUNK + Tile<NP>::W_CHUNK));
    for (int c = 0; c < kc; ++c) {
      tma_load_2d(smem_u32(s_p + c * P_CHUNK), &tm_p, bar, 64 * c, row0);
      tma_load_2d(smem_u32(s_w + c * Tile<NP>::W_CHUNK), &tm_w, bar, 64 * c,
                  col0);
    }
  }
  mbar_wait(bar, 0);

  const uint32_t p_s = smem_u32(s_p), w_s = smem_u32(s_w);
  const int ks = k / 16;
  const int wg = tid >> 7, wg_tid = tid & 127;
  unsigned char* buf = s_o + wg * Tile<NP>::OUT_BYTES;
  // the block's steps are blockIdx.z + i * gridDim.z; warpgroup wg takes
  // i = wg, wg + 2, ...
  float acc[NP / 2];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
  for (int s = blockIdx.z + wg * gridDim.z; s < n_steps;
       s += 2 * gridDim.z) {
    wgmma_fence();
    for (int i = 0; i < ks; ++i) {
      const uint32_t off = (i & 3) * 32;  // 16 bf16 within the chunk
      wgmma_bf16(acc, desc_sw128(p_s + (i >> 2) * P_CHUNK + off),
                 desc_sw128(w_s + (i >> 2) * Tile<NP>::W_CHUNK + off), i > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    store_step<NP>(acc, buf, &tm_o, col0, row0, s, wg_tid, 1 + wg);
  }
  if (wg_tid == 0) bulk_wait<0>();
}

template <int NP>
int launch(const void* p, const void* wt, void* out, int m, int k, int n,
           int n_steps, cudaStream_t stream) {
  const int kc = (k + 63) / 64;
  const int smem = Tile<NP>::smem(kc);
  if (smem > MAX_SMEM) return -3;
  CUtensorMap tm_p, tm_w, tm_o;
  const uint64_t p_dims[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t w_dims[2] = {(uint64_t)k, (uint64_t)n};
  const uint64_t k_stride[1] = {(uint64_t)k * 2};
  const uint32_t p_box[2] = {64, TM};
  const uint32_t w_box[2] = {64, NP};
  const uint64_t o_dims[3] = {(uint64_t)n, (uint64_t)m, (uint64_t)n_steps};
  const uint64_t o_strides[2] = {(uint64_t)n * 2, (uint64_t)m * n * 2};
  const uint32_t o_box[3] = {Tile<NP>::SW_OUT ? 64u : (uint32_t)NP, TM, 1};
  int rc = make_tensor_map(&tm_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p,
                           p_dims, k_stride, p_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt,
                         w_dims, k_stride, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_tensor_map(&tm_o, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out,
                         o_dims, o_strides, o_box,
                         Tile<NP>::SW_OUT ? CU_TENSOR_MAP_SWIZZLE_128B
                                          : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  auto kernel = matmul_probe_kernel<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return -3;
  const long long tiles = (long long)((m + TM - 1) / TM) * (n / NP);
  // one wave of resident blocks, each looping over its share of the steps
  long long splits = (long long)sms * per_sm / tiles;
  if (splits < 1) splits = 1;
  if (splits > n_steps) splits = n_steps;
  if (splits > 65535) splits = 65535;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)(n / NP),
                  (unsigned)splits);
  kernel<<<grid, THREADS, smem, stream>>>(tm_p, tm_w, tm_o, k, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// p (1, m, k), wt = w^T (n, k) and out (n_steps, m, n): contiguous
// bfloat16, 16-byte aligned; m, k and n multiples of 16.  Returns the CUDA
// error code of the launch, -2 for dimensions that are not multiples of
// 16, -3 for sizes the kernel cannot take, -4/-5 if no tensor map could be
// made (see hopper.cuh).
extern "C" int occ_matmul_probe(const void* p, const void* wt, void* out,
                                long long m, long long k, long long n,
                                long long n_steps, cudaStream_t stream) {
  if (m % 16 || k % 16 || n % 16) return -2;
  if (m == 0 || k == 0 || n == 0 || n_steps == 0) return 0;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL || n > 0x7fffffffLL ||
      n_steps > 0x7fffffffLL || (m + TM - 1) / TM > 0x7fffffffLL ||
      n / 16 > 65535)
    return -3;
  const int mi = (int)m, ki = (int)k, ni = (int)n, si = (int)n_steps;
  if (n % 128 == 0) return launch<128>(p, wt, out, mi, ki, ni, si, stream);
  if (n % 64 == 0) return launch<64>(p, wt, out, mi, ki, ni, si, stream);
  if (n % 48 == 0) return launch<48>(p, wt, out, mi, ki, ni, si, stream);
  return launch<16>(p, wt, out, mi, ki, ni, si, stream);
}
