// K1 segment_reduce, K2 segment_broadcast and the K1 gather over sorted
// dense segment ids.
//
// Replaces geomae_tpu/ops/pallas_segreduce.py: segment_reduce_pallas (K1,
// with its channel-major twin pallas_segreduce_t.segment_reduce_t),
// segment_broadcast_pallas (K2, twin segment_broadcast_t) and
// segment_gather_pallas (K1's backward on the TPU, twin
// pallas_segreduce_t.segment_gather_t).
//
// Contract (the one the voxelizer's point2voxel meets): per batch row the
// ids ascend and are dense ranks; rows with seg >= V (the sentinel of
// invalid points and of capacity overflow) form a suffix.
//
// Bound: memory.  K1 reads the [P, C] rows of the points in segments once
// and writes [V, C] f32; K2 reads those rows and writes all of [P, C].
// The TPU kernels route rows through one-hot matmuls because the MXU is
// the TPU's only fast gather.  Here the work is split by points, so a
// skewed frame (pillars of 1 to hundreds of points) gives every SM the
// same bytes, no search stands before the loads, and every byte moves in
// 16-byte vectors:
//
// * a block owns R consecutive points: it stages their ids in shared
//   memory, then the rows of those in segments (a prefix: the sentinel
//   rows are a suffix), one contiguous range, with 16-byte cp.async, all
//   in flight at once (rows of at most 16 bytes go with the ids, sentinel
//   rows and all: one round trip);
// * rows wider than 4 channels: a group of L lanes walks kRowsPerGroup of
//   them there, each lane VEC channels of a row (8 bf16 or 4 f32, one
//   16-byte access; other widths one channel a lane; bf16 max as packed
//   bf16 pairs, exact), and starts a new sum where the id changes.
//   kRowsPerGroup is odd, so the groups of a warp read rows in different
//   banks;
// * rows of at most 4 channels (K2 mean's 12-byte xyz): one lane a row, a
//   warp 32 rows at once, each segment's sums from a segmented scan over
//   the lanes (segment_scan_kernel), so no lane walks alone;
// * a segment that ends inside a group (warp) is done: K1 writes its row
//   from registers, K2 writes its value into the staged rows of its
//   points; the partials of a segment cut by a group's (warp's) edge are
//   combined in shared memory in group order and written the same way;
// * K2 then copies all of its rows back out with 16-byte stores, 0 for
//   the sentinel rows, so the whole grid zeroes the suffix;
// * a segment cut by a block's edge leaves the block's partial in the
//   workspace, and a second kernel (a warp per block edge, launched while
//   the first runs) combines the partials in block order and writes the
//   segment: K1 its row, K2 its points in that block, so a long pillar
//   costs each block it touches what any other segment would.  K1's
//   second kernel also fills the empty rows after the last segment with
//   the whole grid.
//
// The only searches read ids already in shared memory (the block's first
// sentinel row; the groups that hold a cut segment).  Every sum is taken
// in a fixed order without atomics, so two launches agree bit for bit,
// and max is exact in f32 as well as bf16 (the TPU kept f32 max off its
// kernel because the MXU truncates it).
//
// The gather out[t] = table[seg[t]] (0 where seg >= S) routes rows through
// a one-hot matmul on the TPU; here it is a copy of whole rows in 16-byte
// (or 4- or 2-byte) units, so it is exact in any dtype and reads each
// table row from L2 once per point that maps to it.
#include "common.cuh"

namespace geomae {
namespace {

enum Op : int { kSum = 0, kMean = 1, kMax = 2 };
constexpr float kNegFill = -3.0e38f;  // empty max rows, as on the TPU
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerGroup = 11;     // points of a lane group (odd)
// rows a lane scans (rows of at most 4 channels)
constexpr int kScanSteps = 4;
// the first and last id of a group (warp) without points
constexpr int kNone = kInt32Max;

__device__ __forceinline__ float identity(int op) {
  return op == kMax ? -INFINITY : 0.f;
}

__device__ __forceinline__ float combine(float a, float b, int op) {
  return op == kMax ? fmaxf(a, b) : a + b;
}

// f[i] = channel i of a lane's VEC channels at p; one 16-byte access
// where VEC values of T fill 16 bytes (p is then 16-byte aligned)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f<T>(t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_f<T>(p[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) t[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<T>(f[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = f[i];
  }
}

// How a launch splits the rows: VEC channels a lane, L lanes a group
// (lanes past C / VEC loop over channel chunks), G groups a block, R
// points a block, nblk blocks a batch row.  Rows of at most 4 channels
// (one lane a row) go to the scan kernel, kScanSteps rows a lane.
struct Plan {
  int L, G, R, nblk;
};

__host__ __device__ inline Plan make_plan(int vec, int P, int C) {
  Plan pl;
  const int nv = C / vec;
  pl.L = nv < kThreads ? nv : kThreads;
  pl.G = kThreads / pl.L;
  pl.R = vec == C && vec <= 4 ? kThreads * kScanSteps : pl.G * kRowsPerGroup;
  pl.nblk = (P + pl.R - 1) / pl.R;
  return pl;
}

// The workspace: per (batch row, block) the partials of the block's first
// and last segments where a block edge cuts them (f32 [2][C]), the ids of
// its first and last points, their partials' point counts, and per batch
// row the first empty row after the last segment.
struct Work {
  float* part;   // [B][nblk][2][C]
  int* fid;      // [B][nblk]
  int* lid;      // [B][nblk]
  int* cnt;      // [B][nblk][2]
  int* trail;    // [B]
};

inline size_t work_bytes(const Plan& pl, int B, int C) {
  const size_t n = (size_t)B * pl.nblk;
  return n * 2 * C * sizeof(float) + (4 * n + B) * sizeof(int);
}

inline Work work_at(void* base, const Plan& pl, int B, int C) {
  const size_t n = (size_t)B * pl.nblk;
  Work w;
  w.part = static_cast<float*>(base);
  w.fid = reinterpret_cast<int*>(w.part + n * 2 * C);
  w.lid = w.fid + n;
  w.cnt = w.lid + n;
  w.trail = w.cnt + 2 * n;
  return w;
}

// Copy n elements of T from global src to shared dst (both contiguous,
// dst 16-byte aligned), with every thread of the block: 16-byte cp.async
// where src and n allow, else 4-byte cp.async or plain copies.  The
// caller waits (cp_async_wait) and synchronises.
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, size_t n) {
  const size_t bytes = n * sizeof(T);
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const char* s = reinterpret_cast<const char*>(src);
  if (((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0) {
    for (size_t e = threadIdx.x; e < bytes / 16; e += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       d + (uint32_t)(e * 16)), "l"(s + e * 16));
  } else if (sizeof(T) == 4) {
    for (size_t e = threadIdx.x; e < n; e += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + (uint32_t)(e * 4)), "l"(s + e * 4));
  } else {
    for (size_t e = threadIdx.x; e < n; e += kThreads) dst[e] = src[e];
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// out[e] = src[e] for e < n_src, 0 for n_src <= e < n: the block writes
// its staged rows back, 16 bytes a thread where both ends allow.
template <typename T>
__device__ __forceinline__ void copy_out(T* out, const T* src, size_t n_src,
                                         size_t n) {
  if ((((reinterpret_cast<uintptr_t>(out)) | (n * sizeof(T)) |
        (n_src * sizeof(T))) & 15) == 0) {
    const size_t n16 = n * sizeof(T) / 16, s16 = n_src * sizeof(T) / 16;
    for (size_t e = threadIdx.x; e < n16; e += kThreads)
      reinterpret_cast<uint4*>(out)[e] =
          e < s16 ? reinterpret_cast<const uint4*>(src)[e]
                  : make_uint4(0, 0, 0, 0);
  } else {
    for (size_t e = threadIdx.x; e < n; e += kThreads)
      out[e] = e < n_src ? src[e] : from_f<T>(0.f);
  }
}

// Stage a block's ids sid[-1 .. n] (-1 beyond the row) and the rows of
// its points in segments (a prefix: the sentinel rows are a suffix) in
// shared memory; returns how many rows are in segments.  Rows no wider
// than 16 bytes go with the ids, sentinel rows and all (their reads cost
// little more than the ids', and it saves a round trip); wider rows once
// the ids say which are in segments.  The caller waits (cp_async_wait)
// and synchronises before reading the rows.
template <typename T>
__device__ __forceinline__ int stage(T* tile, int* sid, const T* xb,
                                     const int* sb, int p0, int n, int P,
                                     int C, int V) {
  copy_in(sid, sb + p0, n);
  if (threadIdx.x == 0) sid[-1] = p0 > 0 ? sb[p0 - 1] : -1;
  if (threadIdx.x == kThreads - 1) sid[n] = p0 + n < P ? sb[p0 + n] : -1;
  const bool eager = C * sizeof(T) <= 16;
  if (eager) copy_in(tile, xb, (size_t)n * C);
  cp_async_wait();
  __syncthreads();
  // the first sentinel row: a search of the staged ids in shared memory
  // (log2 R steps, each thread alone; faster than a pass comparing each
  // id with the one before and a barrier, probe_segment)
  const int nvalid = lower_bound_i32(sid, n, V);
  if (!eager) copy_in(tile, xb, (size_t)nvalid * C);
  return nvalid;
}

// K1's empty rows: those between two segments (ids that no point carries)
// are filled by the thread at the next segment's first point; those after
// the last segment by the second kernel, from trail.
__device__ __forceinline__ void fill_gaps(float* out, Work w, const int* sid,
                                          int b, int p0, int n, int P, int C,
                                          int V, int op) {
  out += (size_t)b * V * C;
  const float fill = op == kMax ? kNegFill : 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = sid[i], prev = sid[i - 1];
    if (s < V && prev < s - 1)
      for (size_t e = (size_t)(prev + 1) * C; e < (size_t)s * C; ++e)
        out[e] = fill;
    if ((s >= V && prev < V) || (p0 + i == P - 1 && s < V))
      w.trail[b] = s >= V ? prev + 1 : s + 1;
  }
}

// The first-pass kernel: one block per R points of a batch row.  K1
// (kBroadcast false) writes out [B, V, C] f32, K2 out [B, P, C] in T.
// The block stages the rows of its points in segments in shared memory
// (one contiguous copy, 16 bytes a thread), walks them there, and K2
// writes its results into the same rows and copies them all back out,
// zeros for the sentinel suffix.
template <typename T, int VEC, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                    void* __restrict__ out_, Work w, int P, int C, int V,
                    int op, int L, int G, int nblk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the second kernel may launch now (it waits for this one's results)
  asm volatile("griddepcontrol.launch_dependents;\n");
  const int b = blockIdx.y, k = blockIdx.x;
  const int R = G * kRowsPerGroup;
  const int p0 = k * R, n = min(R, P - p0);
  const int NV = C / VEC;
  const size_t tile_bytes = ((size_t)R * C * sizeof(T) + 15) & ~(size_t)15;
  const size_t part_bytes = ((size_t)G * 2 * L * VEC * sizeof(float) + 15) &
                            ~(size_t)15;
  T* tile = reinterpret_cast<T*>(smem_raw);               // [R][C]
  float* gpart = reinterpret_cast<float*>(smem_raw + tile_bytes);
  int* sid = reinterpret_cast<int*>(smem_raw + tile_bytes + part_bytes) + 4;
  int* fid = sid + R + 4;                                 // [G]
  int* lid = fid + G;                                     // [G]
  int* gcnt = lid + G;                                    // [G][2]
  int* gtot = gcnt + 2 * G;                               // [G][2]
  const int* sb = seg + (size_t)b * P;
  const T* xb = x + ((size_t)b * P + p0) * C;

  const int nvalid = stage(tile, sid, xb, sb, p0, n, P, C, V);

  const int g = threadIdx.x / L, l = threadIdx.x - g * L;
  const bool in_group = g < G;
  const int a0 = g * kRowsPerGroup, a1 = min(a0 + kRowsPerGroup, nvalid);
  const bool has_points = in_group && a0 < a1;

  if (!kBroadcast)
    fill_gaps(static_cast<float*>(out_), w, sid, b, p0, n, P, C, V, op);
  if (in_group && l == 0) {
    fid[g] = has_points ? sid[a0] : kNone;
    lid[g] = has_points ? sid[a1 - 1] : kNone;
  }
  cp_async_wait();
  __syncthreads();

  for (int v0 = 0; v0 < NV; v0 += L) {
    const int vec = v0 + l;
    const bool lane_on = vec < NV;
    const size_t col = (size_t)vec * VEC;
    // phase 1: walk the group's points; finish the segments that end in
    // it, leave the partials of the ones its edges cut
    int head_cnt = 0, tail_cnt = 0;   // this group's points of its cut segments
    if (has_points) {
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = identity(op);
      // bf16 max needs no f32: a row's 8 channels in 4 packed maxima
      constexpr bool kPacked = sizeof(T) == 2 && VEC == 8;
      const bool packed = kPacked && op == kMax;
      const __nv_bfloat162 lowest = __bfloat162bfloat162(
          __float2bfloat16(-INFINITY));
      __nv_bfloat162 m2[kPacked ? 4 : 1];
#pragma unroll
      for (int j = 0; j < (kPacked ? 4 : 1); ++j) m2[j] = lowest;
      int start = a0;
      for (int i = a0; i < a1; ++i) {
        const int s = sid[i];
        if (lane_on) {
          if (packed) {
            if constexpr (kPacked) {
              const uint4 row =
                  *reinterpret_cast<const uint4*>(tile + (size_t)i * C + col);
              const __nv_bfloat162* h =
                  reinterpret_cast<const __nv_bfloat162*>(&row);
#pragma unroll
              for (int j = 0; j < 4; ++j) m2[j] = __hmax2(m2[j], h[j]);
            }
          } else {
            float f[VEC];
            load_vec<T, VEC>(tile + (size_t)i * C + col, f);
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = combine(acc[j], f[j], op);
          }
        }
        if (i + 1 < a1 && sid[i + 1] == s) continue;
        if constexpr (kPacked) {
          if (packed) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[2 * j] = __low2float(m2[j]);
              acc[2 * j + 1] = __high2float(m2[j]);
              m2[j] = lowest;
            }
          }
        }
        // the run [start, i] of id s ends in this group
        const bool head = start == a0 && sid[a0 - 1] == s;
        const bool tail = i == a1 - 1 && sid[a1] == s;
        const int cnt = i - start + 1;
        if (!head && !tail) {
          if (op == kMean) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] /= (float)cnt;
          }
          if (lane_on) {
            if (kBroadcast) {
              for (int r = start; r <= i; ++r)
                store_vec<T, VEC>(tile + (size_t)r * C + col, acc);
            } else {
              store_f32<VEC>(static_cast<float*>(out_) +
                             ((size_t)b * V + s) * C + col, acc);
            }
          }
        } else {
          for (int side = 0; side < 2; ++side) {
            if (!(side ? tail : head)) continue;
            if (lane_on) {
              float* gp = gpart + ((size_t)(g * 2 + side) * L + l) * VEC;
#pragma unroll
              for (int j = 0; j < VEC; ++j) gp[j] = acc[j];
            }
            if (l == 0) gcnt[g * 2 + side] = cnt;
            (side ? tail_cnt : head_cnt) = cnt;
          }
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = identity(op);
        start = i + 1;
      }
    }
    __syncthreads();

    // phase 2: the segments cut by a group's edge.  side 0: a group's
    // first segment, if it began before the group; side 1: its last, if
    // it goes on after it (once, where it is also side 0's).  The group
    // where such a segment begins in the block (its owner) combines the
    // groups' partials in group order: where the block's edge cuts the
    // segment too, into the workspace for the second kernel; else K1
    // writes its row, and K2 leaves the total in the owner's slot, from
    // which, after a barrier, every group that holds part of the segment
    // writes its points.
    for (int pass = 0; pass < (kBroadcast ? 2 : 1); ++pass) {
      for (int side = 0; has_points && side < 2; ++side) {
        const int s = side ? lid[g] : fid[g];
        const bool before = sid[a0 - 1] == s;
        if (!(side ? sid[a1] == s : before) ||
            (side && fid[g] == s && before))
          continue;
        const int ga = lower_bound_i32(lid, G, s);
        const bool from_prev = sid[-1] == s && sid[0] == s;
        const bool to_next = sid[n] == s && sid[n - 1] == s;
        const int own = ga * 2 + (from_prev ? 0 : 1);
        float* total = gpart + ((size_t)own * L + l) * VEC;
        if (pass == 0) {
          if (g != ga) continue;
          const int gb = lower_bound_i32(fid, G, s + 1) - 1;
          float val[VEC];
          int cnt = 0;
#pragma unroll
          for (int j = 0; j < VEC; ++j) val[j] = identity(op);
          for (int gx = ga; gx <= gb; ++gx) {
            const int slot = (gx == gb && (gx > ga || from_prev)) ? 0 : 1;
            cnt += gcnt[gx * 2 + slot];
            if (lane_on) {
              const float* gp =
                  gpart + ((size_t)(gx * 2 + slot) * L + l) * VEC;
#pragma unroll
              for (int j = 0; j < VEC; ++j) val[j] = combine(val[j], gp[j], op);
            }
          }
          if (from_prev || to_next) {
            // cut by the block's edge: the block's partial, for the second
            // kernel
            const size_t blk = (size_t)b * nblk + k;
            for (int bs = 0; bs < 2; ++bs) {
              if (!(bs ? to_next : from_prev)) continue;
              if (lane_on) {
                float* bp = w.part + (blk * 2 + bs) * C + col;
#pragma unroll
                for (int j = 0; j < VEC; ++j) bp[j] = val[j];
              }
              if (l == 0) w.cnt[blk * 2 + bs] = cnt;
            }
            continue;
          }
          if (kBroadcast) {           // for the groups that hold it
            if (lane_on) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) total[j] = val[j];
            }
            if (l == 0) gtot[own] = cnt;
          } else if (lane_on) {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              val[j] = op == kMean ? val[j] / (float)cnt : val[j];
            store_f32<VEC>(static_cast<float*>(out_) +
                           ((size_t)b * V + s) * C + col, val);
          }
          continue;
        }
        // pass 1 (K2): this group's points of s
        if (from_prev || to_next || !lane_on) continue;
        const int cnt = gtot[own];
        float val[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          val[j] = op == kMean ? total[j] / (float)cnt : total[j];
        const int c = side ? tail_cnt : head_cnt;
        const int r0 = side ? a1 - c : a0;
        for (int r = r0; r < r0 + c; ++r)
          store_vec<T, VEC>(tile + (size_t)r * C + col, val);
      }
      __syncthreads();
    }
  }
  if (kBroadcast)
    copy_out(static_cast<T*>(out_) + ((size_t)b * P + p0) * C, tile,
             (size_t)nvalid * C, (size_t)n * C);
  if (threadIdx.x == 0) {
    w.fid[(size_t)b * nblk + k] = sid[0];
    w.lid[(size_t)b * nblk + k] = sid[n - 1];
  }
}

// shared memory of the scan kernel: its tile, then its ids
template <typename T, int VEC>
__host__ __device__ constexpr int scan_tile_bytes() {
  return (kThreads * kScanSteps * VEC * (int)sizeof(T) + 15) & ~15;
}

// The first-pass kernel for rows of at most 4 channels (K2 mean's 12-byte
// xyz rows): one lane a row.  Warp u of the block owns S x 32 consecutive
// rows; at step t lane i takes row 32 t + i, so a warp reads 32 rows of
// the staged tile at once, and every segment's sums come from a segmented
// scan over the lanes (shuffles in a fixed tree order, the segments' starts
// a ballot's bits) plus the carry of the step before: no lane walks alone
// and no branch splits the warp.  The inclusive sums stay in registers;
// the warps' partials of the segments their edges cut are combined in
// warp order; a second sweep, last step first, hands each row its
// segment's total (one shuffle from the segment's last row, found by a
// ballot), which K2 writes into the tile and copies out and K1 writes
// once per segment.
template <typename T, int VEC, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                    void* __restrict__ out_, Work w, int P, int V, int op,
                    int nblk) {
  constexpr int S = kScanSteps;
  constexpr int R = kWarps * 32 * S;
  constexpr int C = VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);               // [R][C]
  int* sid = reinterpret_cast<int*>(smem_raw + scan_tile_bytes<T, VEC>()) + 4;
  __shared__ float uval[kWarps][2][VEC];                 // warps' partials
  __shared__ int ucnt[kWarps][2], ufirst[kWarps], ulast[kWarps];
  // the second kernel may launch now (it waits for this one's results)
  asm volatile("griddepcontrol.launch_dependents;\n");
  const int b = blockIdx.y, k = blockIdx.x;
  const int p0 = k * R, n = min(R, P - p0);
  const int nvalid = stage(tile, sid, x + ((size_t)b * P + p0) * C,
                           seg + (size_t)b * P, p0, n, P, C, V);
  if (!kBroadcast)
    fill_gaps(static_cast<float*>(out_), w, sid, b, p0, n, P, C, V, op);
  cp_async_wait();
  __syncthreads();

  const int u = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = u * 32 * S, we = max(w0, min(w0 + 32 * S, nvalid));
  const bool has = w0 < we;
  // forward sweep: v[t] = the sum (max) of row 32 t + i's segment from
  // its first row in this warp, c[t] its rows
  float v[S][VEC];
  int c[S];
  float cv[VEC];
  int cc = 0, cid = has ? sid[w0 - 1] : -1;
#pragma unroll
  for (int j = 0; j < VEC; ++j) cv[j] = identity(op);
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int r = w0 + 32 * t + lane;
    const bool valid = r < we;
    const int s = valid ? sid[r] : kNone;
    float xv[VEC];
    if (valid) {
      load_vec<T, VEC>(tile + (size_t)r * C, xv);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[j] = identity(op);
    }
    int ps = __shfl_up_sync(~0u, s, 1);
    if (lane == 0) ps = cid;
    // the lanes that start a segment; at offset d lane i adds lane i - d's
    // sum when no segment starts in (i - d, i]
    const unsigned H = __ballot_sync(~0u, s != ps);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float y[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) y[j] = __shfl_up_sync(~0u, xv[j], d);
      if (lane >= d && !((H >> (lane - d + 1)) & ((1u << d) - 1))) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) xv[j] = combine(y[j], xv[j], op);
      }
    }
    const unsigned upto = H & (0xffffffffu >> (31 - lane));
    int cn;
    if (!upto) {          // the segment the step before carried in
#pragma unroll
      for (int j = 0; j < VEC; ++j) xv[j] = combine(cv[j], xv[j], op);
      cn = lane + 1 + cc;
    } else {
      cn = lane - (31 - __clz(upto)) + 1;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[t][j] = xv[j];
      cv[j] = __shfl_sync(~0u, xv[j], 31);
    }
    c[t] = cn;
    cc = __shfl_sync(~0u, cn, 31);
    cid = __shfl_sync(~0u, s, 31);
  }

  // the warp's first segment, if it began before the warp (head), and its
  // last, if it goes on after it (tail): their partials for the others
  const int sf = has ? sid[w0] : kNone, sl = has ? sid[we - 1] : kNone;
  const bool hcut = has && sid[w0 - 1] == sf, tcut = has && sid[we] == sl;
  const int e1 = hcut ? w0 + lower_bound_i32(sid + w0, we - w0, sf + 1) - 1
                      : -1;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int r = w0 + 32 * t + lane;
    for (int side = 0; side < 2; ++side) {
      if (r != (side ? (tcut ? we - 1 : -1) : e1)) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j) uval[u][side][j] = v[t][j];
      ucnt[u][side] = c[t];
    }
  }
  if (lane == 0) {
    ufirst[u] = sf;
    ulast[u] = sl;
  }
  __syncthreads();

  // the totals of the cut segments, over the warps that hold them in warp
  // order; where the block's edge cuts one too, the block's partial goes
  // to the workspace for the second kernel (span: this block writes none
  // of its rows)
  float fin[2][VEC];
  bool span[2] = {false, false};
  for (int side = 0; side < 2; ++side) {
    const int s = side ? sl : sf;
    if (!(side ? tcut : hcut)) continue;
    int ua = u, ub = u;
    while (ua > 0 && ulast[ua - 1] == s) --ua;
    while (ub < kWarps - 1 && ufirst[ub + 1] == s) ++ub;
    const bool from_prev = sid[-1] == s && sid[0] == s;
    const bool to_next = sid[n] == s && sid[n - 1] == s;
    float tot[VEC];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) tot[j] = identity(op);
    for (int ux = ua; ux <= ub; ++ux) {
      const int slot = (ux == ub && (ux > ua || from_prev)) ? 0 : 1;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        tot[j] = combine(tot[j], uval[ux][slot][j], op);
      cnt += ucnt[ux][slot];
    }
    span[side] = from_prev || to_next;
    if (span[side]) {
      const size_t blk = (size_t)b * nblk + k;
      for (int bs = 0; bs < 2; ++bs) {
        if (lane != 0 || !(bs ? to_next && u == ub : from_prev && u == ua))
          continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j) w.part[(blk * 2 + bs) * C + j] = tot[j];
        w.cnt[blk * 2 + bs] = cnt;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      fin[side][j] = op == kMean ? tot[j] / (float)cnt : tot[j];
    if (!kBroadcast && !span[side] && u == ua && lane == 0)
      store_f32<VEC>(static_cast<float*>(out_) + ((size_t)b * V + s) * C,
                     fin[side]);
  }

  // reverse sweep: each row takes its segment's total from the segment's
  // last row in the step, or from the step after (the carry)
  float carry[VEC];
  bool carry_span = false;
#pragma unroll
  for (int j = 0; j < VEC; ++j) carry[j] = 0.f;
#pragma unroll
  for (int t = S - 1; t >= 0; --t) {
    const int r = w0 + 32 * t + lane;
    const bool valid = r < we;
    const int s = valid ? sid[r] : kNone;
    const bool end = valid && sid[r + 1] != s;
    float val[VEC];
    int have = 0, sp = 0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) val[j] = 0.f;
    if (end && hcut && s == sf) {                  // the head, cut
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[j] = fin[0][j];
      have = 1;
      sp = span[0];
    } else if (end) {                              // whole in this warp
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        val[j] = op == kMean ? v[t][j] / (float)c[t] : v[t][j];
      have = 1;
      if (!kBroadcast)
        store_f32<VEC>(static_cast<float*>(out_) + ((size_t)b * V + s) * C,
                       val);
    } else if (valid && r == we - 1) {             // the tail, cut
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[j] = fin[1][j];
      have = 1;
      sp = span[1];
    } else if (valid && lane == 31) {              // from the next step
#pragma unroll
      for (int j = 0; j < VEC; ++j) val[j] = carry[j];
      have = 1;
      sp = carry_span;
    }
    // each lane takes the total from the first lane at or after it that
    // holds one: its segment's last row here, or lane 31 with the carry
    const unsigned E = __ballot_sync(~0u, have) & (0xffffffffu << lane);
    const int from = E ? __ffs(E) - 1 : lane;
#pragma unroll
    for (int j = 0; j < VEC; ++j) val[j] = __shfl_sync(~0u, val[j], from);
    sp = __shfl_sync(~0u, sp, from);
#pragma unroll
    for (int j = 0; j < VEC; ++j) carry[j] = __shfl_sync(~0u, val[j], 0);
    carry_span = __shfl_sync(~0u, sp, 0);
    if (kBroadcast && valid && !sp)
      store_vec<T, VEC>(tile + (size_t)r * C, val);
  }
  __syncthreads();
  if (kBroadcast)
    copy_out(static_cast<T*>(out_) + ((size_t)b * P + p0) * C, tile,
             (size_t)nvalid * C, (size_t)n * C);
  if (threadIdx.x == 0) {
    w.fid[(size_t)b * nblk + k] = sid[0];
    w.lid[(size_t)b * nblk + k] = sid[n - 1];
  }
}

// The run of blocks around block k whose last (first) id is s, from the
// 32 blocks before (after) k that the caller's lanes already read (hit:
// the ballot of those), then 32 blocks at a time: the first (last) block
// that holds segment s.
__device__ __forceinline__ int first_block(const int* lid, int k, int s,
                                           unsigned hit) {
  const int lane = threadIdx.x & 31;
  for (int n = __popc(hit);; n = __popc(hit)) {
    k -= n;
    if (n < 32) return k;
    const int j = k - 1 - lane;
    hit = __ballot_sync(~0u, j >= 0 && lid[j] == s);
  }
}

__device__ __forceinline__ int last_block(const int* fid, int k, int s,
                                          int nblk, unsigned hit) {
  const int lane = threadIdx.x & 31;
  for (int n = __popc(hit);; n = __popc(hit)) {
    k += n;
    if (n < 32) return k;
    const int j = k + 1 + lane;
    hit = __ballot_sync(~0u, j < nblk && fid[j] == s);
  }
}

// The second kernel: a warp per (first-pass block, edge) finishes the
// segment that the edge cuts, combining the blocks' partials in block
// order; K1 also fills the rows after each batch row's last segment.
template <typename T, int VEC, bool kBroadcast>
__global__ void __launch_bounds__(kThreads)
segment_span_kernel(void* __restrict__ out_, Work w, int P, int C, int V,
                    int op, int R, int nblk) {
  extern __shared__ float rows[];                        // [kWarps][C]
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the first's results
  if (!kBroadcast) {
    const int t0 = w.trail[b];
    float* o = static_cast<float*>(out_) + ((size_t)b * V + t0) * C;
    const size_t n = (size_t)(V - t0) * C;
    const float fill = op == kMax ? kNegFill : 0.f;
    for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
         e += (size_t)gridDim.x * kThreads)
      o[e] = fill;
  }
  const int job = blockIdx.x * kWarps + warp;
  const int k = job >> 1, side = job & 1;
  if (k >= nblk) return;
  const int* fid = w.fid + (size_t)b * nblk;
  const int* lid = w.lid + (size_t)b * nblk;
  // side 0: the block's first segment, if it began in an earlier block;
  // side 1: its last, if it goes on in a later one (once, where it is
  // also side 0's)
  // one round of loads: this block's ids, and the last (first) ids of the
  // 32 blocks before (after) it
  const int jb = k - 1 - lane, jf = k + 1 + lane;
  const int lb = jb >= 0 ? lid[jb] : -1, ff = jf < nblk ? fid[jf] : -1;
  const int f = fid[k], last = lid[k];
  const int prev = __shfl_sync(~0u, lb, 0), next = __shfl_sync(~0u, ff, 0);
  const int s = side ? last : f;
  if (s >= V || !(side ? next == s : prev == s) ||
      (side && f == s && prev == s))
    return;
  // K1 writes the row once, from the block where the segment begins
  if (!kBroadcast && side == 0) return;
  const int ka = kBroadcast
                     ? first_block(lid, k, s, __ballot_sync(~0u, lb == s))
                     : k;
  const int kb = last_block(fid, k, s, nblk, __ballot_sync(~0u, ff == s));
  // block kx's piece: its last segment's partial, or (kb) its first's;
  // a lane loads kU blocks x kM channels at a time, combined in block
  // order
  constexpr int kU = 16, kM = 4;
  const float* part = w.part + (size_t)b * nblk * 2 * C;
  const int* cnts = w.cnt + (size_t)b * nblk * 2;
  int cnt = 0;
  if (op == kMean)
    for (int kx = ka + lane; kx <= kb; kx += 32)
      cnt += cnts[kx * 2 + (kx == kb ? 0 : 1)];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(~0u, cnt, o);
  float* row = rows + (size_t)warp * C;
  for (int c0 = lane; c0 < C; c0 += 32 * kM) {
    float v[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) v[m] = identity(op);
    for (int k0 = ka; k0 <= kb; k0 += kU) {
      float t[kU][kM];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int kx = k0 + u;
        const float* pk = part + ((size_t)kx * 2 + (kx == kb ? 0 : 1)) * C;
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (kx <= kb && c0 + 32 * m < C) t[u][m] = pk[c0 + 32 * m];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int m = 0; m < kM; ++m)
          if (k0 + u <= kb) v[m] = combine(v[m], t[u][m], op);
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
      if (c0 + 32 * m < C)
        row[c0 + 32 * m] = op == kMean ? v[m] / (float)cnt : v[m];
  }
  __syncwarp();
  if (!kBroadcast) {
    float* o = static_cast<float*>(out_) + ((size_t)b * V + s) * C;
    for (int c = lane; c < C; c += 32) o[c] = row[c];
    return;
  }
  const int NV = C / VEC;
  const int c = w.cnt[((size_t)b * nblk + k) * 2 + side];
  const int r0 = side ? min(k * R + R, P) - c : k * R;
  T* o = static_cast<T*>(out_) + ((size_t)b * P + r0) * C;
  for (int e = lane; e < c * NV; e += 32) {
    const int r = e / NV, v = e - r * NV;
    float val[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) val[j] = row[v * VEC + j];
    store_vec<T, VEC>(o + (size_t)r * C + v * VEC, val);
  }
}

// out[b, t] = table[b, seg[b, t]] row by row, in units of U (row_units
// units per row); rows with seg outside [0, S) are 0.
template <typename U>
__global__ void __launch_bounds__(kThreads)
segment_gather_kernel(const U* __restrict__ table, const int* __restrict__ seg,
                      U* __restrict__ out, int S, int P, int row_units) {
  const int b = blockIdx.y;
  const size_t n = (size_t)P * row_units;
  const U* tb = table + (size_t)b * S * row_units;
  const int* sb = seg + (size_t)b * P;
  U* ob = out + (size_t)b * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t p = i / row_units;
    const int s = sb[p];
    ob[i] = (s >= 0 && s < S)
                ? tb[(size_t)s * row_units + (i - p * row_units)] : U{};
  }
}

template <typename U>
cudaError_t launch_gather(const void* table, const int* seg, void* out,
                          int B, int S, int P, int row_bytes,
                          cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(U);
  const size_t blocks = ((size_t)P * units + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < 8192 ? blocks : 8192), B);
  segment_gather_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(table), seg, static_cast<U*>(out), S, P, units);
  return cudaGetLastError();
}

// The channels a lane takes: a 16-byte vector where rows are whole
// vectors, else a whole row of at most 4 channels, else one channel.
template <typename T>
int lane_vec(int C) {
  constexpr int kVec = 16 / sizeof(T);
  return C % kVec == 0 ? kVec : C <= 4 ? C : 1;
}

template <typename T, int VEC, bool kBroadcast>
cudaError_t launch_segment(const T* x, const int* seg, void* out, void* work,
                           int B, int P, int C, int V, int op,
                           cudaStream_t stream) {
  const Plan pl = make_plan(VEC, P, C);
  const Work w = work_at(work, pl, B, C);
  cudaError_t e;
  if constexpr (VEC <= 4) {
    if (C == VEC) {             // rows of at most 4 channels: the scan
      const int smem = scan_tile_bytes<T, VEC>() + (pl.R + 8) * sizeof(int);
      if ((e = allow_smem(segment_scan_kernel<T, VEC, kBroadcast>, smem)) !=
          cudaSuccess)
        return e;
      segment_scan_kernel<T, VEC, kBroadcast>
          <<<dim3(pl.nblk, B), kThreads, smem, stream>>>(
              x, seg, out, w, P, V, op, pl.nblk);
    }
  }
  if (C != VEC || VEC > 4) {
    const int smem =
        (((size_t)pl.R * C * sizeof(T) + 15) & ~(size_t)15) +
        ((pl.G * 2 * pl.L * VEC * sizeof(float) + 15) & ~15) +
        (pl.R + 8 + 6 * pl.G) * sizeof(int);
    if ((e = allow_smem(segment_rows_kernel<T, VEC, kBroadcast>, smem)) !=
        cudaSuccess)
      return e;
    segment_rows_kernel<T, VEC, kBroadcast>
        <<<dim3(pl.nblk, B), kThreads, smem, stream>>>(
            x, seg, out, w, P, C, V, op, pl.L, pl.G, pl.nblk);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // the second kernel may launch while the first runs (programmatic
  // dependent launch): its blocks wait for the first's results at their
  // start, so its launch costs the stream nothing
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * pl.nblk + kWarps - 1) / kWarps, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kWarps * C * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  if ((e = allow_smem(segment_span_kernel<T, VEC, kBroadcast>,
                      (int)cfg.dynamicSmemBytes)) != cudaSuccess)
    return e;
  return cudaLaunchKernelEx(&cfg, segment_span_kernel<T, VEC, kBroadcast>,
                            out, w, P, C, V, op, pl.R, pl.nblk);
}

template <typename T, bool kBroadcast>
cudaError_t dispatch(const void* x_, const int* seg, void* out, void* work,
                     int B, int P, int C, int V, int op,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  switch (lane_vec<T>(C)) {
    case 1:
      return launch_segment<T, 1, kBroadcast>(x, seg, out, work, B, P, C, V,
                                              op, stream);
    case 2:
      return launch_segment<T, 2, kBroadcast>(x, seg, out, work, B, P, C, V,
                                              op, stream);
    case 3:
      return launch_segment<T, 3, kBroadcast>(x, seg, out, work, B, P, C, V,
                                              op, stream);
    case 4:
      return launch_segment<T, 4, kBroadcast>(x, seg, out, work, B, P, C, V,
                                              op, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_segment<T, 8, kBroadcast>(x, seg, out, work, B, P, C,
                                                V, op, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool kBroadcast>
int run(int dtype, const void* x, const int* seg, void* out, void* work,
        int B, int P, int C, int V, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op < kSum || op > kMax) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return dispatch<float, kBroadcast>(x, seg, out, work, B, P, C, V, op, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16, kBroadcast>(x, seg, out, work, B, P, C, V,
                                               op, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace geomae

extern "C" {

// Bytes of the workspace that geomae_segment_reduce and
// geomae_segment_broadcast take for x [B, P, C] of either dtype.
long long geomae_segment_work_bytes(int B, int P, int C) {
  using namespace geomae;
  const size_t f = work_bytes(make_plan(lane_vec<float>(C), P, C), B, C);
  const size_t h =
      work_bytes(make_plan(lane_vec<__nv_bfloat16>(C), P, C), B, C);
  return (long long)(f > h ? f : h);
}

// x [B, P, C] (dtype), seg [B, P] int32 -> out [B, V, C] float32.
// op: 0 sum, 2 max.  Empty rows: 0 (sum) or -3e38 (max).  work: a device
// buffer of geomae_segment_work_bytes(B, P, C) bytes, 16-byte aligned.
// A block stages kRowsPerGroup x G rows of x in shared memory, so C is
// at most about 3,500 (f32) or 7,000 (bf16); wider rows fail to launch.
int geomae_segment_reduce(int dtype, const void* x, const int* seg,
                          float* out, int B, int P, int C, int V, int op,
                          void* work, void* stream) {
  return geomae::run<false>(dtype, x, seg, out, work, B, P, C, V, op, stream);
}

// x [B, P, C] (dtype), seg [B, P] int32 -> out [B, P, C] (dtype).
// op: 0 sum, 1 mean, 2 max.  Rows with seg >= V give 0.  work as above.
int geomae_segment_broadcast(int dtype, const void* x, const int* seg,
                             void* out, int B, int P, int C, int V, int op,
                             void* work, void* stream) {
  return geomae::run<true>(dtype, x, seg, out, work, B, P, C, V, op, stream);
}

// table [B, S, row_bytes] (any dtype), seg [B, P] int32 -> out [B, P,
// row_bytes]; rows with seg outside [0, S) are 0.  row_bytes must be even;
// table and out 16-byte aligned.
int geomae_segment_gather(const void* table, const int* seg, void* out,
                          int B, int S, int P, int row_bytes, void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0)
    return launch_gather<uint4>(table, seg, out, B, S, P, row_bytes, s);
  if (row_bytes % 4 == 0)
    return launch_gather<uint32_t>(table, seg, out, B, S, P, row_bytes, s);
  if (row_bytes % 2 == 0)
    return launch_gather<uint16_t>(table, seg, out, B, S, P, row_bytes, s);
  return cudaErrorInvalidValue;
}

const char* geomae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
