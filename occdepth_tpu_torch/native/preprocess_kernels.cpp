// Native preprocessing kernels of occdepth_tpu_torch: the port's copy of
// occdepth_tpu/native/preprocess_kernels.cpp, with the same entry points.
//
// These replace the reference's numba-jitted host loops with C++:
//   * downsample_label_u8  — majority label pooling with empty/invalid
//     thresholding (reference: occdepth/data/NYU/preprocess.py:102-143,
//     also used by the KITTI preprocess CLI for the 1_8 labels)
//   * rle_decode_u8        — NYU RLE voxel-label decoding with class remap
//     (reference: occdepth/data/NYU/preprocess.py:49-77)
//   * voxel_vote_u8        — per-voxel class majority vote from unprojected
//     depth points (reference: occdepth/data/tartanair/export_voxels.py:
//     110-168 depth2voxel scatter passes)
//   * unpack_bits_u8 / pack_bits_u8 — SemanticKITTI voxel bitmaps
//     (reference: occdepth/data/semantic_kitti/io_data.py:10-42)
//   * frustum_class_dists_i32 — per-image-tile class histograms of the
//     frustum-proportion loss
//
// Built as a plain shared library with g++ at first use; Python binds it
// with ctypes (occdepth_tpu_torch/native_ext.py), which raises when the
// library cannot be built and keeps a plain NumPy version of each entry.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Majority-pool a (X, Y, Z) uint8 label grid by factor `ds`.
// Per ds^3 block: if (#zeros + #255s) > 0.95 * ds^3 the block is 0 or 255
// (whichever count is larger; ties -> 255); otherwise the most frequent
// label in (0, 255) exclusive, ties -> smallest label (numpy
// argmax-of-bincount semantics).
void downsample_label_u8(const uint8_t* label, int64_t X, int64_t Y,
                         int64_t Z, int64_t ds, uint8_t* out) {
  const int64_t sx = X / ds, sy = Y / ds, sz = Z / ds;
  const double empty_t = 0.95 * (double)(ds * ds * ds);
  int64_t counts[256];
  for (int64_t x = 0; x < sx; ++x) {
    for (int64_t y = 0; y < sy; ++y) {
      for (int64_t z = 0; z < sz; ++z) {
        std::memset(counts, 0, sizeof(counts));
        for (int64_t dx = 0; dx < ds; ++dx) {
          const int64_t xi = x * ds + dx;
          for (int64_t dy = 0; dy < ds; ++dy) {
            const int64_t yi = y * ds + dy;
            const uint8_t* row = label + (xi * Y + yi) * Z + z * ds;
            for (int64_t dz = 0; dz < ds; ++dz) counts[row[dz]]++;
          }
        }
        const int64_t zero_count = counts[0] + counts[255];
        uint8_t val;
        if ((double)zero_count > empty_t) {
          val = counts[0] > counts[255] ? 0 : 255;
        } else {
          int64_t best = -1;
          int best_lab = 0;
          for (int lab = 1; lab < 255; ++lab) {
            if (counts[lab] > best) {
              best = counts[lab];
              best_lab = lab;
            }
          }
          val = (uint8_t)best_lab;
        }
        out[(x * sy + y) * sz + z] = val;
      }
    }
  }
}

// Decode (value, run_length) uint32 RLE pairs into a flat uint8 label
// array, remapping values < map_len through class_map; value 255 stays 255.
// Returns the number of voxels written (caller checks == out_len).
int64_t rle_decode_u8(const uint32_t* rle, int64_t n_entries,
                      const uint8_t* class_map, int64_t map_len,
                      uint8_t* out, int64_t out_len) {
  int64_t idx = 0;
  for (int64_t i = 0; i + 1 < n_entries; i += 2) {
    const uint32_t val = rle[i];
    const uint32_t run = rle[i + 1];
    uint8_t lab;
    if (val == 255) {
      lab = 255;
    } else if ((int64_t)val < map_len) {
      lab = class_map[val];
    } else {
      lab = 255;  // out-of-map values treated as invalid
    }
    const int64_t end = idx + (int64_t)run;
    const int64_t stop = end < out_len ? end : out_len;
    for (; idx < stop; ++idx) out[idx] = lab;
    if (end > out_len) return end;  // overflow reported to caller
  }
  return idx;
}

// Per-voxel majority vote: scatter N points with precomputed voxel indices
// (vox_idx, shape N x 3, int32, already rounded) and remapped class ids
// into a (X, Y, Z) grid. counts is caller-allocated (X*Y*Z*n_classes)
// int32 scratch, zeroed here. Outputs voxel_binary and voxel_cls
// (argmax of counts; all-zero counts -> 0).
void voxel_vote_u8(const int32_t* vox_idx, const int32_t* cls, int64_t n,
                   int64_t X, int64_t Y, int64_t Z, int64_t n_classes,
                   int32_t* counts, uint8_t* voxel_binary,
                   uint8_t* voxel_cls) {
  std::memset(counts, 0, sizeof(int32_t) * X * Y * Z * n_classes);
  std::memset(voxel_binary, 0, X * Y * Z);
  std::memset(voxel_cls, 0, X * Y * Z);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t x = vox_idx[i * 3], y = vox_idx[i * 3 + 1],
                  z = vox_idx[i * 3 + 2];
    if (x < 0 || x >= X || y < 0 || y >= Y || z < 0 || z >= Z) continue;
    const int64_t v = (int64_t)(x * Y + y) * Z + z;
    voxel_binary[v] = 1;
    const int32_t c = cls[i];
    if (c >= 0 && c < n_classes) counts[v * n_classes + c]++;
  }
  const int64_t nvox = X * Y * Z;
  for (int64_t v = 0; v < nvox; ++v) {
    if (!voxel_binary[v]) continue;
    const int32_t* cnt = counts + v * n_classes;
    int32_t best = cnt[0];
    int64_t best_c = 0;
    for (int64_t c = 1; c < n_classes; ++c) {
      if (cnt[c] > best) {
        best = cnt[c];
        best_c = c;
      }
    }
    voxel_cls[v] = (uint8_t)best_c;
  }
}

// SemanticKITTI bit-packed voxel masks: 1 byte -> 8 voxels, MSB first.
void unpack_bits_u8(const uint8_t* packed, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t b = packed[i];
    uint8_t* o = out + i * 8;
    o[0] = (b >> 7) & 1;
    o[1] = (b >> 6) & 1;
    o[2] = (b >> 5) & 1;
    o[3] = (b >> 4) & 1;
    o[4] = (b >> 3) & 1;
    o[5] = (b >> 2) & 1;
    o[6] = (b >> 1) & 1;
    o[7] = b & 1;
  }
}

void pack_bits_u8(const uint8_t* bits, int64_t n_bytes, uint8_t* out) {
  for (int64_t i = 0; i < n_bytes; ++i) {
    const uint8_t* b = bits + i * 8;
    out[i] = (uint8_t)((b[0] << 7) | (b[1] << 6) | (b[2] << 5) | (b[3] << 4) |
                       (b[4] << 3) | (b[5] << 2) | (b[6] << 1) | b[7]);
  }
}

// Per-image-tile GT class histograms for the frustum-proportion loss
// (reference helpers.compute_local_frustums histogram output,
// occdepth/data/utils/helpers.py:183-260) in ONE pass over the voxels —
// no (size^2, N) mask tensor, no float64 temporaries.  A voxel seen by
// several views in the SAME tile counts once (OR semantics across views,
// matching the reference's per-view mask union).
// px/py/pz are (V, N) row-major; cls is (N,) with 255 = ignore;
// out is (size*size*n_classes) int64, caller-zeroed.  V <= 8.
void frustum_class_dists_i32(const int32_t* px, const int32_t* py,
                             const float* pz, const int32_t* cls, int64_t V,
                             int64_t N, int64_t size, int64_t img_W,
                             int64_t img_H, int64_t n_classes, int64_t* out) {
  int32_t tiles[8];
  if (V > 8) return;
  for (int64_t n = 0; n < N; ++n) {
    const int32_t c = cls[n];
    const bool cv = (c >= 0) && (c < (int32_t)n_classes);
    for (int64_t v = 0; v < V; ++v) {
      const int64_t x = px[v * N + n];
      const int64_t y = py[v * N + n];
      const float z = pz[v * N + n];
      int32_t t = -1;
      if (x >= 0 && x < img_W && y >= 0 && y < img_H && z > 0.f)
        t = (int32_t)(((y * size) / img_H) * size + (x * size) / img_W);
      tiles[v] = t;
      if (t >= 0 && cv) {
        bool fresh = true;
        for (int64_t u = 0; u < v; ++u) fresh &= (tiles[u] != t);
        if (fresh) out[(int64_t)t * n_classes + c] += 1;
      }
    }
  }
}

}  // extern "C"
