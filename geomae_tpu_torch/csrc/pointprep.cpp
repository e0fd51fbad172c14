// Native point-cloud preparation core: host C++, the port's copy of
// geomae_tpu/csrc/pointprep.cpp, built by geomae_tpu_torch/data/_native.py.
//
// The reference delegates this to per-op CUDA/torch kernels plus python
// loops in the dataset pipeline (mmdet3d/datasets/pipelines/*).  Here the
// whole host-side sample preparation is one fused C++ pass per sweep:
//
//   sensor->lidar rigid transform  (LoadPointsFromMultiSweeps)
//   remove_close ego-return filter
//   global rotate/scale/translate  (GlobalRotScaleTrans, order R->S->T)
//   BEV flips                      (RandomFlip3D)
//   range filter                   (PointsRangeFilter)
//   write into the fixed-capacity output buffer
//
// Compiled as a plain shared object; Python binds via ctypes (calls release
// the GIL, so the prefetch loader's worker threads overlap real work).
//
// All buffers are float32, points are rows of `dims` floats, xyz first,
// channel 4 (if present) receives the time lag.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of points written (<= cap - written_before).
// out is the big [cap, dims] buffer; writing starts at *cursor rows.
int64_t prep_sweep(
    const float* pts, int64_t n, int32_t dims,
    const float* R,            // 3x3 row-major sensor->lidar, or null
    const float* t,            // 3 translation, or null
    float time_lag,            // written to channel 4 when dims >= 5
    float remove_close_radius, // <= 0 disables
    float rot_cos, float rot_sin,  // global z-rotation (points @ Rz)
    float scale,
    int32_t flip_y, int32_t flip_x,
    const float* pc_range,     // [6] xmin ymin zmin xmax ymax zmax; null = off
    float* out, int64_t cap, int64_t* cursor) {
  int64_t written = 0;
  int64_t base = *cursor;
  for (int64_t i = 0; i < n; ++i) {
    if (base + written >= cap) break;
    const float* p = pts + i * dims;
    float x = p[0], y = p[1], z = p[2];
    if (R != nullptr) {
      float nx = R[0] * x + R[1] * y + R[2] * z;
      float ny = R[3] * x + R[4] * y + R[5] * z;
      float nz = R[6] * x + R[7] * y + R[8] * z;
      x = nx + t[0];
      y = ny + t[1];
      z = nz + t[2];
    }
    if (remove_close_radius > 0 &&
        std::fabs(p[0]) < remove_close_radius &&
        std::fabs(p[1]) < remove_close_radius) {
      continue;  // test is on the *sensor-frame* coords like the reference
    }
    // global augmentation: rotate about +z (points @ Rz with
    // Rz = [[c, s], [-s, c]] like mmdet3d), scale, then flips
    float rx = rot_cos * x - rot_sin * y;
    float ry = rot_sin * x + rot_cos * y;
    x = rx * scale;
    y = ry * scale;
    z = z * scale;
    if (flip_y) y = -y;
    if (flip_x) x = -x;
    if (pc_range != nullptr) {
      if (x < pc_range[0] || x >= pc_range[3] || y < pc_range[1] ||
          y >= pc_range[4] || z < pc_range[2] || z >= pc_range[5]) {
        continue;
      }
    }
    float* o = out + (base + written) * dims;
    o[0] = x;
    o[1] = y;
    o[2] = z;
    for (int32_t c = 3; c < dims; ++c) o[c] = p[c];
    if (dims >= 5) o[4] = time_lag;
    ++written;
  }
  *cursor = base + written;
  return written;
}

// Build the canonical sorted scene on the host (see
// geomae_tpu_torch/ops/voxelize.py for the device-side equivalent and the
// layout contract).  Points are radix-sorted by pillar_key * s_low +
// slot_low (two 13-bit counting passes); outputs are the sorted points,
// per-point sub-voxel slots, ascending point->pillar row ids, and the
// canonical pillar table.  Returns the number of pillars found.
//
// Caller guarantees n <= p_cap and zero-initialized outputs; trailing rows
// stay zero, p2v for them is set to v_cap (trash row).
int64_t build_scene(
    const float* pts, int64_t n, int32_t dims,
    float ox, float oy, float oz,        // point_cloud_range minimums
    float low_sx, float low_sy, float low_sz,  // low sub-voxel sizes
    int32_t nx, int32_t ny,              // pillar grid (x, y)
    int32_t rx, int32_t ry, int32_t rz,  // low ratios per pillar (x, y, z)
    int32_t mx, int32_t my, int32_t mz,  // med ratios per pillar
    int64_t p_cap, int32_t v_cap,
    float* out_pts, int32_t* slot_low, int32_t* slot_med,
    int32_t* slot_sort, int32_t* p2v,
    int32_t* coords, uint8_t* tvalid) {
  const int32_t s_low = rz * ry * rx;
  const int32_t fz = rz / mz, fy = ry / my, fx = rx / mx;

  // pass 0: keys (med-major slot_sort layout; see ops/voxelize.py)
  int32_t* keys = new int32_t[n];
  int32_t* slow = new int32_t[n];
  int32_t* smed = new int32_t[n];
  int32_t* ssrt = new int32_t[n];
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * dims;
    auto clampi = [](int64_t v, int64_t lo, int64_t hi) {
      return v < lo ? lo : (v > hi ? hi : v);
    };
    int64_t lx = clampi((int64_t)std::floor((p[0] - ox) / low_sx), 0,
                        (int64_t)nx * rx - 1);
    int64_t ly = clampi((int64_t)std::floor((p[1] - oy) / low_sy), 0,
                        (int64_t)ny * ry - 1);
    int64_t lz = clampi((int64_t)std::floor((p[2] - oz) / low_sz), 0,
                        (int64_t)rz - 1);
    int32_t sl = (int32_t)((lz % rz) * (ry * rx) + (ly % ry) * rx + (lx % rx));
    int32_t sm = (int32_t)(((lz / fz) % mz) * (my * mx) +
                           ((ly / fy) % my) * mx + ((lx / fx) % mx));
    int32_t intra = (int32_t)(((lz % rz) % fz) * (fy * fx) +
                              ((ly % ry) % fy) * fx + ((lx % rx) % fx));
    int32_t ss = sm * (fz * fy * fx) + intra;
    slow[i] = sl;
    smed[i] = sm;
    ssrt[i] = ss;
    keys[i] = (int32_t)((ly / ry) * nx + (lx / rx)) * s_low + ss;
  }

  // two-pass LSD radix sort (13 bits each) of indices by key
  const int32_t RB = 13, RS = 1 << RB, MASK = RS - 1;
  int64_t* idx0 = new int64_t[n];
  int64_t* idx1 = new int64_t[n];
  int64_t hist[1 << 13];
  for (int64_t i = 0; i < n; ++i) idx0[i] = i;
  for (int pass = 0; pass < 2; ++pass) {
    const int shift = pass * RB;
    std::memset(hist, 0, sizeof(hist));
    for (int64_t i = 0; i < n; ++i)
      ++hist[(keys[idx0[i]] >> shift) & MASK];
    int64_t acc = 0;
    for (int32_t b = 0; b < RS; ++b) {
      int64_t c = hist[b];
      hist[b] = acc;
      acc += c;
    }
    for (int64_t i = 0; i < n; ++i)
      idx1[hist[(keys[idx0[i]] >> shift) & MASK]++] = idx0[i];
    std::swap(idx0, idx1);
  }

  // walk sorted order: emit outputs + pillar table
  int64_t nv = 0;
  int32_t prev_pillar = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t src = idx0[i];
    std::memcpy(out_pts + i * dims, pts + src * dims,
                sizeof(float) * dims);
    slot_low[i] = slow[src];
    slot_med[i] = smed[src];
    slot_sort[i] = ssrt[src];
    int32_t pillar = keys[src] / s_low;
    if (pillar != prev_pillar) {
      if (nv < v_cap) {
        coords[nv * 2] = pillar / nx;      // y
        coords[nv * 2 + 1] = pillar % nx;  // x
        tvalid[nv] = 1;
      }
      prev_pillar = pillar;
      ++nv;
    }
    p2v[i] = (nv - 1) < v_cap ? (int32_t)(nv - 1) : v_cap;
  }
  for (int64_t i = n; i < p_cap; ++i) p2v[i] = v_cap;

  delete[] keys;
  delete[] slow;
  delete[] smed;
  delete[] ssrt;
  delete[] idx0;
  delete[] idx1;
  return nv;
}

// Fisher-Yates shuffle of [n, dims] float rows with xorshift64 PRNG.
void shuffle_rows(float* pts, int64_t n, int32_t dims, uint64_t seed) {
  uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
  float tmp[16];
  for (int64_t i = n - 1; i > 0; --i) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    int64_t j = (int64_t)(s % (uint64_t)(i + 1));
    if (j == i) continue;
    std::memcpy(tmp, pts + i * dims, sizeof(float) * dims);
    std::memcpy(pts + i * dims, pts + j * dims, sizeof(float) * dims);
    std::memcpy(pts + j * dims, tmp, sizeof(float) * dims);
  }
}

}  // extern "C"
