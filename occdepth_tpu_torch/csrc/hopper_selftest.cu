// Self-test of the Hopper building blocks in hopper.cuh, for the `cuda`
// tests: one TMA load of an (8 g + 8) x 64 bf16 tile and of a 16 x 64 one
// with the 128-byte swizzle, the first 64 rows' shared-memory bytes copied
// out as they landed, and one wgmma product (4 k16 slices of m64n16k16)
// whose A operand starts `shift` rows into the tile and takes its 8-row
// groups g rows apart (the layout of conv3x3.cu's shifted halo reads):
//
//   dump (64, 64) = the tile's first 64 rows in shared memory, row r's
//                   16-byte chunk c at chunk c ^ (r % 8);
//   d (64, 16) fp32 = a[rows] @ b (16, 64)^T, rows[m] = (m / 8) g + shift
//                     + m % 8.
//
// A second entry point checks the register-A form that crp_matmul.cu uses:
// a 64 x 64 bf16 tile of A^T (rows k, m contiguous) lands by TMA, 128B-
// swizzled, `ldmatrix_x4_trans` turns it into A fragments, and four
// `wgmma_bf16_rs` (m64n256k16) multiply them by a K-major (256, 64) B:
//
//   d (64, 256) fp32 = at^T @ b^T.
//
// Not a port of a TPU kernel: it isolates the layouts that the wgmma
// kernels (conv3x3.cu, matmul_probe.cu, crp_matmul.cu) depend on.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int MAX_ROWS = 8 * 24 + 8;

__global__ void __launch_bounds__(128)
hopper_selftest_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b, int rows,
                       int shift, int group_rows, uint16_t* __restrict__ dump,
                       float* __restrict__ d) {
  __shared__ __align__(1024) unsigned char s_a[MAX_ROWS * 128];
  __shared__ __align__(1024) unsigned char s_b[16 * 128];
  __shared__ __align__(8) uint64_t s_bar;
  const uint32_t bar = smem_u32(&s_bar);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, rows * 128 + sizeof(s_b));
    tma_load_2d(smem_u32(s_a), &tm_a, bar, 0, 0);
    tma_load_2d(smem_u32(s_b), &tm_b, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  for (int i = tid; i < 64 * 64; i += 128)
    dump[i] = reinterpret_cast<const uint16_t*>(s_a)[i];

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const uint32_t a0 = smem_u32(s_a) + shift * 128;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_bf16(acc, desc_sw128(a0 + 32 * j, group_rows * 128),
               desc_sw128(smem_u32(s_b) + 32 * j), j > 0);
  wgmma_commit();
  wgmma_wait<0>();
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[(r + 8 * h) * 16 + 8 * j + c] = acc[4 * j + 2 * h];
      d[(r + 8 * h) * 16 + 8 * j + c + 1] = acc[4 * j + 2 * h + 1];
    }
}

}  // namespace

// a (8 group_rows + 8, 64) and b (16, 64) contiguous bf16, 16-byte
// aligned; dump (64, 64) bf16 and d (64, 16) fp32 contiguous; 0 <= shift
// < 8, 8 <= group_rows <= 24.  Returns the CUDA error code of the launch,
// -2 for arguments out of range, -4/-5 if no tensor map could be made.
extern "C" int occ_hopper_selftest(const void* a, const void* b, void* dump,
                                   float* d, int shift, int group_rows,
                                   cudaStream_t stream) {
  if (shift < 0 || shift > 7 || group_rows < 8 || group_rows > 24) return -2;
  const int rows = 8 * group_rows + 8;
  CUtensorMap tm_a, tm_b;
  const uint64_t a_dims[2] = {64, (uint64_t)rows}, b_dims[2] = {64, 16};
  const uint64_t stride[1] = {128};
  const uint32_t a_box[2] = {64, (uint32_t)rows}, b_box[2] = {64, 16};
  int rc = make_tensor_map(&tm_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a,
                           a_dims, stride, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_tensor_map(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b,
                         b_dims, stride, b_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  hopper_selftest_kernel<<<1, 128, 0, stream>>>(
      tm_a, tm_b, rows, shift, group_rows, static_cast<uint16_t*>(dump), d);
  return (int)cudaGetLastError();
}

namespace {

__global__ void __launch_bounds__(128)
hopper_selftest_rs_kernel(const __grid_constant__ CUtensorMap tm_at,
                          const __grid_constant__ CUtensorMap tm_b,
                          float* __restrict__ d) {
  __shared__ __align__(1024) unsigned char s_at[64 * 128];
  __shared__ __align__(1024) unsigned char s_b[256 * 128];
  __shared__ __align__(8) uint64_t s_bar;
  const uint32_t bar = smem_u32(&s_bar);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, sizeof(s_at) + sizeof(s_b));
    tma_load_2d(smem_u32(s_at), &tm_at, bar, 0, 0);
    tma_load_2d(smem_u32(s_b), &tm_b, bar, 0, 0);
  }
  mbar_wait(bar, 0);

  const int warp = tid >> 5, lane = tid & 31;
  // thread `lane` addresses row lane % 8 of matrix lane / 8: matrices 0-3
  // are (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
  // of the warp's 16 rows of m
  const int mat = lane >> 3;
  const int chunk = 2 * warp + (mat & 1);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 16 * j + 8 * (mat >> 1) + (lane & 7);
    ldmatrix_x4_trans(a[j], smem_u32(s_at) + k * 128 +
                                ((chunk ^ (k & 7)) << 4));
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_bf16_rs(acc, a[j], desc_sw128(smem_u32(s_b) + 32 * j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  const int r = warp * 16 + (lane >> 2);
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      d[(r + 8 * h) * 256 + 8 * j + c] = acc[4 * j + 2 * h];
      d[(r + 8 * h) * 256 + 8 * j + c + 1] = acc[4 * j + 2 * h + 1];
    }
}

}  // namespace

// at (64, 64) and b (256, 64) contiguous bf16, 16-byte aligned; d (64,
// 256) fp32 contiguous.  Returns the CUDA error code of the launch, -4/-5
// if no tensor map could be made.
extern "C" int occ_hopper_selftest_rs(const void* at, const void* b,
                                      float* d, cudaStream_t stream) {
  CUtensorMap tm_at, tm_b;
  const uint64_t at_dims[2] = {64, 64}, b_dims[2] = {64, 256};
  const uint64_t stride[1] = {128};
  const uint32_t at_box[2] = {64, 64}, b_box[2] = {64, 256};
  int rc = make_tensor_map(&tm_at, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, at,
                           at_dims, stride, at_box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_tensor_map(&tm_b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b,
                         b_dims, stride, b_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  hopper_selftest_rs_kernel<<<1, 128, 0, stream>>>(tm_at, tm_b, d);
  return (int)cudaGetLastError();
}
