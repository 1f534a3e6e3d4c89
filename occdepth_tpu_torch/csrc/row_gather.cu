// Row gather: out[t, :] = table[idx[t], :] for a (R, C) table and T int32
// indices, with the index contract of jnp.take (the JAX probe's
// `xla_take`): an index in [-R, 0) counts from the end (idx + R), and an
// index outside [-R, R) reads nothing and writes a row of NaN.
//
// Replaces the TPU kernel occdepth_tpu/scripts/bench_gather.py:111
// `pallas_gather`, a probe of the per-voxel row gathers of the FLoSP lift
// and the OAD frustum resample (tables of 7,191 to 451,401 rows of 32 or
// 104 values, 262,144 indices).  The TPU kernel keeps the whole table in
// VMEM and gathers with a lane-wise take_along_axis per 4096-index tile,
// which is why its script only ran it for tables under 12 MB.  A Hopper
// block has at most 227 KB of shared memory and every probe table but one
// is larger, so nothing is kept resident here: the table stays in device
// memory, and the 50 MB L2 holds every bf16 probe table (and all fp32 ones
// but the 57.8 MB sfa_1_1) after the first touches.
//
// What bounds it on Hopper: bytes.  It does no arithmetic; the least it
// must move is the output (T*C*size) plus the indices (4T) plus each
// distinct table row that the indices name, once.  Design:
//   * each thread moves 16 bytes: a 64-byte row (32 bf16) is four threads,
//     so a warp reads 8 whole rows and writes 512 contiguous output bytes
//     per instruction;
//   * the threads of one row read the same index, so a warp's index loads
//     are 32 / (threads per row) consecutive int32: coalesced;
//   * table reads go through the read-only path (__ldg), output stores are
//     coalesced 16-byte stores; a grid-stride loop covers any T;
//   * a row whose width is not a multiple of 16 bytes (C = 33 in bf16) is
//     not 16-byte aligned in the table, so such tables are gathered one
//     element per thread instead (same contract, 2- or 4-byte moves).
// Not used yet: TMA gathers, prefetch of the next index block, L2
// persistence hints (later work; chip_smoke prints the share of the bound).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// one V-wide move per thread: V = uint4 (16 bytes) or one element
template <typename V>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const V* __restrict__ table, const int* __restrict__ idx,
                  V* __restrict__ out, long long n_moves, int moves_per_row,
                  int rows, V fill) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n_moves; i += stride) {
    const long long t = i / moves_per_row;
    const int v = (int)(i - t * moves_per_row);
    int r = __ldg(idx + t);
    if (r < 0) r += rows;  // numpy-style negative index
    V val = fill;
    if (r >= 0 && r < rows)
      val = __ldg(table + (long long)r * moves_per_row + v);
    out[i] = val;
  }
}

template <typename V>
int launch(const void* table, const int* idx, void* out, long long T,
           int moves_per_row, int rows, V fill, cudaStream_t stream) {
  const long long n_moves = T * moves_per_row;
  // enough blocks for every SM several times over; the loop takes the rest
  const long long blocks =
      (n_moves + THREADS - 1) / THREADS < 132LL * 16
          ? (n_moves + THREADS - 1) / THREADS
          : 132LL * 16;
  row_gather_kernel<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const V*>(table), idx, static_cast<V*>(out), n_moves,
      moves_per_row, rows, fill);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 (bfloat16) or 4 (float32); table (R, C) and out (T, C)
// contiguous, idx (T,) int32.  Returns the CUDA error code of the launch,
// -1 for an unsupported element size, -3 for sizes the kernel cannot take.
extern "C" int occ_row_gather(const void* table, const int* idx, void* out,
                              long long R, long long C, long long T,
                              int elem_bytes, cudaStream_t stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return -1;
  if (T == 0 || C == 0) return 0;
  if (R > 0x7fffffffLL || C * elem_bytes > 0x7fffffffLL) return -3;
  const long long row_bytes = C * elem_bytes;
  if (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    // NaN in every element of the 16 bytes: 0x7fc0 per bf16, 0x7fc00000
    // per float32
    const unsigned w = elem_bytes == 2 ? 0x7fc07fc0u : 0x7fc00000u;
    return launch<uint4>(table, idx, out, T, (int)(row_bytes / 16), (int)R,
                         make_uint4(w, w, w, w), stream);
  }
  if (elem_bytes == 2)
    return launch<unsigned short>(table, idx, out, T, (int)C, (int)R,
                                  (unsigned short)0x7fc0u, stream);
  return launch<unsigned int>(table, idx, out, T, (int)C, (int)R,
                              0x7fc00000u, stream);
}
