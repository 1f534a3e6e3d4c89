// Stereo-SFA cosine fusion of two views, one voxel row per warp.
//
// Replaces the TPU kernel occdepth_tpu/ops/pallas_kernels.py
// `stereo_cosine_fuse` (body `_fuse_kernel`).  Per voxel row r:
//   cos  = <f0,f1> / (max(|f0|,eps) * max(|f1|,eps)) * m0 * m1
//   w0   = cos + [m0 > m1],   w1 = cos + [m1 > m0]
//   out  = (w0 * f0 + w1 * f1) / 2
//
// What bounds it on Hopper: device-memory bytes.  Each row reads 2*C floats
// and two masks and writes C floats for ~6*C flops, far below the ~20
// flop/byte an H100 needs before arithmetic matters.  The design therefore
// reads every input byte once and writes every output byte once: a warp
// owns a row, each lane owns channels c = lane, lane+32, ... (one channel
// per lane at the flagship C=32, so a warp's load is one 128-byte line),
// and the three row sums (|f0|^2, |f1|^2, <f0,f1>) are reduced with warp
// shuffles, never through shared or device memory.  The second pass over
// the row re-reads the channels a lane already touched, which L1 serves.
//
// The two views arrive as strided views of one (B, V, N, C) tensor, so the
// kernel takes a batch stride and a row stride (channels are unit-stride)
// instead of requiring contiguous copies.  Output is (B*N, C) contiguous.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stereo_cosine_fuse_kernel(const float* __restrict__ f0,
                          const float* __restrict__ f1,
                          const float* __restrict__ m0,
                          const float* __restrict__ m1,
                          float* __restrict__ out,
                          long long rows, long long n_per_batch, int C,
                          long long f_sb, long long f_sn,
                          long long m_sb, long long m_sn, float eps) {
  const int lane = threadIdx.x & 31;
  const long long warp_global =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarpsPerBlock;
  for (long long r = warp_global; r < rows; r += n_warps) {
    const long long b = r / n_per_batch;
    const long long n = r - b * n_per_batch;
    const float* a_row = f0 + b * f_sb + n * f_sn;
    const float* b_row = f1 + b * f_sb + n * f_sn;
    float s00 = 0.f, s11 = 0.f, s01 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float a = a_row[c];
      const float v = b_row[c];
      s00 = fmaf(a, a, s00);
      s11 = fmaf(v, v, s11);
      s01 = fmaf(a, v, s01);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s00 += __shfl_xor_sync(0xffffffffu, s00, off);
      s11 += __shfl_xor_sync(0xffffffffu, s11, off);
      s01 += __shfl_xor_sync(0xffffffffu, s01, off);
    }
    const float mk0 = m0[b * m_sb + n * m_sn];
    const float mk1 = m1[b * m_sb + n * m_sn];
    const float n0 = fmaxf(sqrtf(s00), eps);
    const float n1 = fmaxf(sqrtf(s11), eps);
    const float cosv = s01 / (n0 * n1) * (mk0 * mk1);
    const float w0 = cosv + (mk0 - mk1 > 0.f ? 1.f : 0.f);
    const float w1 = cosv + (mk1 - mk0 > 0.f ? 1.f : 0.f);
    float* o_row = out + r * C;
    for (int c = lane; c < C; c += 32) {
      o_row[c] = (w0 * a_row[c] + w1 * b_row[c]) * 0.5f;
    }
  }
}

}  // namespace

extern "C" int occ_stereo_cosine_fuse(const float* f0, const float* f1,
                                      const float* m0, const float* m1,
                                      float* out, long long batch,
                                      long long n_per_batch, int C,
                                      long long f_sb, long long f_sn,
                                      long long m_sb, long long m_sn,
                                      float eps, cudaStream_t stream) {
  const long long rows = batch * n_per_batch;
  if (rows == 0 || C == 0) return 0;
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 1048576) blocks = 1048576;  // the row loop covers the rest
  stereo_cosine_fuse_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                              stream>>>(f0, f1, m0, m1, out, rows,
                                        n_per_batch, C, f_sb, f_sn, m_sb,
                                        m_sn, eps);
  return (int)cudaGetLastError();
}
