// The two-term TF32 form of an fp32 operand, for the 3xTF32 products of
// crp_matmul.cu (mega) and conv3x3.cu (the weights):
//
//   out[0, i0, i1, i2] = hi,  out[1, i0, i1, i2] = lo,
//   x[i0, i1, i2] = hi + lo + e,  |e| <= 2^-22 |x|   (hopper.cuh split_tf32)
//
// for i2 < D2, and zeros for D2 <= i2 < D2p: the padding that makes the
// rows of a K-major operand a multiple of 16 bytes for TMA.  x is read at
// any strides; out is contiguous (2, D0, D1, D2p).
//
// Not a port of a TPU kernel: the JAX kernels multiply fp32 operands as
// they are, and this pass prepares the B operand of the tensor-core
// kernels that replace them, packing it on the way (the conv's OIHW
// weights come out (2, Co, 9, Cp)).  It runs once per call: bound by its
// bytes (mega: 1 MB in, 2 MB out at the KITTI shape; the largest decoder
// weights, KITTI's 1_16 conv: 49 MB in, 98 MB out, ~44 us at 3.35 TB/s
// beside that conv's ~0.55 ms of fp32 work), one thread per output pair,
// consecutive threads on consecutive i2.
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

__global__ void split_tf32_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, long long D1,
                                  long long D2, long long D2p, long long s0,
                                  long long s1, long long s2, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long i2 = i % D2p;
    const long long r = i / D2p;
    const long long i1 = r % D1, i0 = r / D1;
    uint32_t hi = 0, lo = 0;
    if (i2 < D2) hopper::split_tf32(x[i0 * s0 + i1 * s1 + i2 * s2], hi, lo);
    out[i] = __uint_as_float(hi);
    out[n + i] = __uint_as_float(lo);
  }
}

}  // namespace

// x (D0, D1, D2) fp32 at strides (s0, s1, s2) in elements -> out (2, D0,
// D1, D2p) fp32 contiguous, D2p >= D2.  Returns the CUDA error code of the
// launch, -2 for D2p < D2.
extern "C" int occ_split_tf32(const float* x, float* out, long long D0,
                              long long D1, long long D2, long long D2p,
                              long long s0, long long s1, long long s2,
                              cudaStream_t stream) {
  if (D2p < D2) return -2;
  const long long n = D0 * D1 * D2p;
  if (n == 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65536) blocks = 65536;
  split_tf32_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      x, out, D1, D2, D2p, s0, s1, s2, n);
  return (int)cudaGetLastError();
}
