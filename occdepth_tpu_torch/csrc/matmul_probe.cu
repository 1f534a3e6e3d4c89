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
//   * a block owns a 64-row tile of p and a panel of NP <= 64 columns of w,
//     stages both in shared memory once (p as is, w transposed so that its
//     columns are contiguous; rows padded by 16 bytes so ldmatrix's eight
//     row addresses fall in distinct banks), and keeps them for all its
//     steps: no operand traffic after the first touch;
//   * the blocks of one tile split the steps among them (grid z), enough
//     blocks to fill every SM;
//   * each of the 4 warps computes 16 rows x NP columns per step on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulators),
//     operands from shared memory through ldmatrix, and stores the rounded
//     bf16 pairs straight from the accumulators;
//   * the operands do not change between steps, so a compiler could hoist
//     the product out of the step loop and leave a kernel that only
//     stores.  ldmatrix and mma are `asm volatile`, which the compiler may
//     neither move out of the loop nor delete; chip_smoke.py also fails if
//     a run reads under the operations bound.
// Not used yet: wgmma (the only path to the full bf16 rate), TMA, stores
// through shared memory (later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // rows of p per block: 4 warps x 16
constexpr int THREADS = 128;
constexpr int PAD = 8;        // bf16 of padding per shared row
constexpr int MAX_SMEM = 232448;  // a Hopper block's dynamic shared memory

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT n8-tiles per block: NP = 8 * NT output columns
template <int NT>
__global__ void __launch_bounds__(THREADS)
matmul_probe_kernel(const __nv_bfloat16* __restrict__ p,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int m, int k, int n,
                    int n_steps) {
  constexpr int NP = NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = k + PAD;  // shared row stride, in bf16
  __nv_bfloat16* s_p = reinterpret_cast<__nv_bfloat16*>(smem);  // [TM][lds]
  __nv_bfloat16* s_w = s_p + TM * lds;  // [NP][lds]: w's panel, transposed
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * NP;

  // p's tile, 16 bytes a thread (k % 16 == 0: rows are whole vectors)
  const int kv = k / 8;
  for (int e = tid; e < TM * kv; e += THREADS) {
    const int r = e / kv;
    const int c = e - r * kv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < m)
      v = *reinterpret_cast<const uint4*>(p + (long long)(row0 + r) * k +
                                          c * 8);
    *reinterpret_cast<uint4*>(s_p + r * lds + c * 8) = v;
  }
  // s_w[j][kk] = w[kk][col0 + j]: coalesced reads along the columns
  for (int e = tid; e < k * NP; e += THREADS) {
    const int kk = e / NP;
    const int j = e - kk * NP;
    s_w[j * lds + kk] = w[(long long)kk * n + col0 + j];
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = row0 + warp * 16;
  if (wrow >= m) return;  // m % 16 == 0: a warp's rows are all in or out
  // ldmatrix.x4 row addresses: A's four 8x8 pieces are (rows 0-7 | 8-15) x
  // (k 0-7 | 8-15); B's are (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k
  // 0-7), (n 8-15, k 8-15) of a pair of n8-tiles
  const unsigned a_addr =
      smem_u32(s_p + (warp * 16 + (lane & 15)) * lds + (lane >> 4) * 8);
  const unsigned b_addr = smem_u32(
      s_w + ((lane & 7) + (lane >> 4) * 8) * lds + ((lane >> 3) & 1) * 8);
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int tg = lane & 3;  // accumulator columns 2 tg and 2 tg + 1

#pragma unroll 1
  for (int s = blockIdx.z; s < n_steps; s += gridDim.z) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < k; k0 += 16) {
      unsigned a[4];
      unsigned b[NT / 2][4];
      ldmatrix_x4(a, a_addr + k0 * 2);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4(b[j], b_addr + (j * 16 * lds + k0) * 2);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        mma_bf16(acc[2 * j], a, b[j][0], b[j][1]);
        mma_bf16(acc[2 * j + 1], a, b[j][2], b[j][3]);
      }
    }
    __nv_bfloat16* o = out + ((long long)s * m + wrow + g) * n + col0 + tg * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(o + 8LL * n + j * 8) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

template <int NT>
int launch(const void* p, const void* w, void* out, int m, int k, int n,
           int n_steps, cudaStream_t stream) {
  constexpr int NP = NT * 8;
  const int smem = (TM + NP) * (k + PAD) * 2;
  if (smem > MAX_SMEM) return -3;
  auto kernel = matmul_probe_kernel<NT>;
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
  // two waves of resident blocks, each block looping over its steps
  long long splits = (2LL * sms * per_sm + tiles - 1) / tiles;
  if (splits > n_steps) splits = n_steps;
  if (splits > 65535) splits = 65535;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)(n / NP),
                  (unsigned)splits);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(p),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      m, k, n, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// p (1, m, k), w (k, n) and out (n_steps, m, n): contiguous bfloat16, p
// 16-byte aligned; m, k and n multiples of 16.  Returns the CUDA error code
// of the launch, -2 for dimensions that are not multiples of 16, -3 for
// sizes the kernel cannot take.
extern "C" int occ_matmul_probe(const void* p, const void* w, void* out,
                                long long m, long long k, long long n,
                                long long n_steps, cudaStream_t stream) {
  if (m % 16 || k % 16 || n % 16) return -2;
  if (m == 0 || k == 0 || n == 0 || n_steps == 0) return 0;
  if (m > 0x7fffffffLL || k > 0x7fffffffLL || n > 0x7fffffffLL ||
      n_steps > 0x7fffffffLL || m * n_steps > 0x7fffffffffffLL ||
      n / 16 > 65535)
    return -3;
  const int mi = (int)m, ki = (int)k, ni = (int)n, si = (int)n_steps;
  // 64- or 48-column panels at the probes' n (512, 48), else 16 columns
  if (n % 64 == 0) return launch<8>(p, w, out, mi, ki, ni, si, stream);
  if (n % 48 == 0) return launch<6>(p, w, out, mi, ki, ni, si, stream);
  return launch<2>(p, w, out, mi, ki, ni, si, stream);
}
