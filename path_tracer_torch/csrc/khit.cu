// Each ray's K nearest transparent hits in one launch: the producer of the
// dense transparent walks (models/integrator.py, ``_dense_tr_hits``).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_intersect.py::
// _khit_kernel (launched by _khit_launch, entry k_nearest_tr_hits).
// Contract (the plain version, ops/cuda_khit.py, is held to it on every
// lane):
//   - a lane is live when its encoded t_max is > 0 (the wrapper writes -1
//     on inactive lanes); a dead lane reports t = +inf, column 0 in every
//     row;
//   - the transparent MT rows come in groups of 128 columns with one AABB
//     each (gbox, rows min.xyz, max.xyz; an all-padding group holds the
//     1e30 sentinel and only zero rows), and in sub-groups of 32 columns
//     with one AABB each (sbox, likewise); a live lane tests a column only
//     when its own segment reaches both the column's group box and its
//     sub-group box, each widened by flat_common.cuh's pad_box
//     (flat_common.cuh khit_reach: slab entry tn and exit tf with IEEE
//     1/d, a NaN bound opened to all t, the interval widened by pad_slab,
//     tf >= max(tn, 0) and tn <= t_max). On an exact box a ray through a
//     card's vertex or edge on the box's face can fail the group whose
//     triangle its rounded MT test hits; widened, no hit within t_max is
//     lost (the Pallas kernel decided per 512-ray tile on the groups alone,
//     whose union hid most such lanes). Beyond t_max a lane keeps only what
//     its own gate admits;
//   - Moller-Trumbore as the Pallas kernel writes it: |det| >= 1e-6,
//     u >= 0, v >= 0, u + v <= 1, t >= 1e-6 (no t_max test: the walks mask
//     with their own bound);
//   - output rows k = 0..K-1: the K smallest DISTINCT hit distances in
//     ascending order, each with the lowest column that reaches it (the
//     Pallas extraction takes the minimum and knocks out every t <= it,
//     so a duplicate t, a shared foliage-card edge, is visited once);
//     +inf and column 0 past the end.
//
// Bound on the card: arithmetic, about 45 flops per MT test over the
// columns a lane's gate admits, and 22 per slab test.
//
// Design. The table (at most 4,096 columns: 192 KB as 48-byte records,
// v0.xyz e1.x | e1.yz e2.xy | e2.z, and the widened group and sub-group
// boxes) is staged once per persistent CTA of 32 warps (64 registers a
// thread), its only barrier;
// then each warp takes units of 32 consecutive lanes on its own, the next
// unit from a counter the wrapper zeroes (a warp that finishes early takes
// more: the units' costs vary with the scene). A lane keeps its K (<= 8)
// nearest (t, column) pairs sorted in registers (klist.cuh) and builds its
// own group mask (one bit per group, G <= 32). The warp takes, in
// ascending order, the groups some lane admits; in each, every needing
// lane gates the group's four sub-groups, and the warp takes, in
// ascending order, the sub-groups some lane admits: each lane whose own
// gate admits it tests its 32 columns in ascending order, kWide = 4 at a
// time with no branch (independent chains the warp interleaves; every lane
// reads the same record, a broadcast), and inserts the hits;
// the other lanes idle. So the columns reach each lane's list in ascending
// order, and the result is the plain version's. The sub-group gate is
// what makes this design faster than the one it replaced (a 128-ray CTA
// staging each group some lane reaches; PERF.md §6): on the textured
// showcase's camera lanes it needs 0.44 of the group gate's MT tests, on
// its first-bounce shadow lanes 0.38. A second layout, each needing ray
// served in turn by the whole warp (a column of each of its sub-groups a
// lane, the warp's (t, column) minimum merged into its list), was timed
// and was slower than lane per ray on every set measured (PERF.md), so it
// is not kept.
//
// Inputs:  o, d [R,3] f32; t_max [R] f32 (<= 0: dead); tris [9,T] f32
//          (v0.xyz, e1.xyz, e2.xyz, T a multiple of 128, at most 4,096,
//          zero rows for padding); gbox [6,G] f32 with G = T / 128; sbox
//          [6, T/32] f32; next: a zeroed counter of units.
// Outputs: tout [K,R] f32; iout [K,R] i32 (column in the transparent
//          slice).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "flat_common.cuh"
#include "klist.cuh"

namespace {

using ptt::kFullMask;

constexpr int kThreads = 1024;  // 32 warps a CTA, one CTA an SM
constexpr int kWide = 4;        // columns a lane tests at once
constexpr int kGroup = 128;
constexpr int kSub = 32;              // columns of a sub-group
constexpr int kSubs = kGroup / kSub;  // sub-groups of a group
constexpr int kMaxK = 8;
constexpr int kMaxColumns = 4096;  // 32 groups: one bit each of a mask
constexpr int kRec = 12;           // floats per staged column record
constexpr int kGrpRec = 8;         // floats per staged group box

// Dynamic shared memory (floats) of a table of T columns: the records,
// the group boxes and the sub-group boxes.
__host__ __device__ constexpr size_t table_floats(int T) {
  return (size_t)T * kRec + (size_t)(T / kGroup + T / kSub) * kGrpRec;
}

struct KRay {
  float ox, oy, oz, dx, dy, dz;
};

// Moller-Trumbore of one ray against a staged record, in the plain
// version's expressions (ops/intersect.py mt_rows): t, or +inf where a test
// fails. Every expression is evaluated, with no branch, so the tests of
// several columns are independent chains the warp interleaves.
__device__ __forceinline__ float mt_t(const float* rec, const KRay& r) {
  const float4 a = reinterpret_cast<const float4*>(rec)[0];
  const float4 b = reinterpret_cast<const float4*>(rec)[1];
  const float e2z = rec[8];
  const float e1x = a.w, e1y = b.x, e1z = b.y, e2x = b.z, e2y = b.w;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float invdet = 1.0f / det;
  const float tvx = r.ox - a.x, tvy = r.oy - a.y, tvz = r.oz - a.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * invdet;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
  const bool ok = fabsf(det) >= ptt::kDetEps && u >= 0.f && v >= 0.f &&
                  u + v <= 1.f && t >= ptt::kTMin;
  return ok ? t : CUDART_INF_F;
}

// Bit g set when the lane's segment (0, tm] reaches box g of the n staged
// widened boxes at s_box (kGrpRec floats each); i = the IEEE reciprocals.
__device__ __forceinline__ unsigned reach_mask(const float* s_box, int n,
                                               const KRay& r, float ix,
                                               float iy, float iz, float tm) {
  unsigned m = 0u;
  for (int g = 0; g < n; ++g) {
    const float* b = s_box + g * kGrpRec;
    if (ptt::khit_reach(ptt::Box{b[0], b[1], b[2], b[3], b[4], b[5]}, r.ox,
                        r.oy, r.oz, ix, iy, iz, tm))
      m |= 1u << g;
  }
  return m;
}

// Stages n boxes of a [6, n] table widened (pad_box) as kGrpRec records.
__device__ __forceinline__ void stage_boxes(const float* __restrict__ box,
                                            int n, float* s_box) {
  for (int g = threadIdx.x; g < n; g += kThreads) {
    const ptt::Box w = ptt::pad_box(ptt::load_box(box, n, g));
    float* b = s_box + g * kGrpRec;
    b[0] = w.x0; b[1] = w.y0; b[2] = w.z0;
    b[3] = w.x1; b[4] = w.y1; b[5] = w.z1;
    b[6] = b[7] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
khit_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, const float* __restrict__ tris,
            const float* __restrict__ gbox, const float* __restrict__ sbox,
            int R, int T, int K, unsigned* __restrict__ next,
            float* __restrict__ tout, int* __restrict__ iout) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);  // [T][kRec]
  float* s_grp = s_rec + (size_t)T * kRec;        // [G][kGrpRec]
  float* s_sub = s_grp + (size_t)(T / kGroup) * kGrpRec;  // [T/32][kGrpRec]
  const int G = T / kGroup;
  for (int idx = threadIdx.x; idx < kRec * T; idx += kThreads) {
    const int r = idx / T, c = idx - r * T;
    s_rec[c * kRec + r] = r < 9 ? tris[idx] : 0.f;
  }
  stage_boxes(gbox, G, s_grp);
  stage_boxes(sbox, T / kSub, s_sub);
  __syncthreads();  // the only barrier: the table stays resident

  const int lane = threadIdx.x & 31;
  const int n_units = (R + 31) / 32;
  for (;;) {
    // Units of 32 lanes in ascending order, the next one to whichever warp
    // is free (the zeroed counter 'next').
    int unit = 0;
    if (lane == 0) unit = (int)atomicAdd(next, 1u);
    unit = __shfl_sync(kFullMask, unit, 0);
    if (unit >= n_units) break;
    const int i = unit * 32 + lane;
    KRay r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    float tm = -1.f;
    if (i < R) {
      r = KRay{o[3 * i], o[3 * i + 1], o[3 * i + 2],
               d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      tm = t_max[i];
    }
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    float kt[kMaxK];
    int kc[kMaxK];
    ptt::list_clear(K, kt, kc, 0);
    const unsigned gmask =
        tm > 0.f ? reach_mask(s_grp, G, r, ix, iy, iz, tm) : 0u;
    for (unsigned gs = __reduce_or_sync(kFullMask, gmask); gs;
         gs &= gs - 1) {
      const int g = __ffs(gs) - 1;
      const bool needs = (gmask >> g) & 1u;
      // The lane's sub-groups of g its segment reaches (bit q: columns
      // [32q, 32q + 32) of the group).
      const unsigned sub =
          needs ? reach_mask(s_sub + g * kSubs * kGrpRec, kSubs, r, ix, iy,
                             iz, tm)
                : 0u;
      // Lane per ray: each needing lane tests the columns of its
      // sub-groups in ascending order, every lane reading the same record.
      for (unsigned ss = __reduce_or_sync(kFullMask, sub); ss; ss &= ss - 1) {
        const int q = __ffs(ss) - 1;
        if (!((sub >> q) & 1u)) continue;
        const int c0 = g * kGroup + q * kSub;
#pragma unroll 1
        for (int j = 0; j < kSub; j += kWide) {
          float t[kWide];  // kWide independent tests, then in order
#pragma unroll
          for (int w = 0; w < kWide; ++w)
            t[w] = mt_t(s_rec + (size_t)(c0 + j + w) * kRec, r);
#pragma unroll
          for (int w = 0; w < kWide; ++w)
            if (t[w] < CUDART_INF_F)
              ptt::list_insert(t[w], c0 + j + w, kt, kc);
        }
      }
    }
    if (i < R) {
#pragma unroll
      for (int q = 0; q < kMaxK; ++q) {
        if (q < K) {
          tout[(size_t)q * R + i] = kt[q];
          iout[(size_t)q * R + i] = kc[q];
        }
      }
    }
  }
}

}  // namespace

extern "C" int ptt_khit(const float* o, const float* d, const float* t_max,
                        const float* tris, const float* gbox,
                        const float* sbox, int R, int T, int K,
                        unsigned* next, float* tout, int* iout, int device,
                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  if (K > kMaxK || T <= 0 || T % kGroup || T > kMaxColumns)
    return (int)cudaErrorInvalidValue;
  const size_t smem = table_floats(T) * sizeof(float);
  int blocks;
  err = ptt::resident_launch_shape(khit_kernel, smem, kThreads,
                                   (R + 31) / 32, device, blocks);
  if (err != cudaSuccess) return (int)err;
  khit_kernel<<<blocks, kThreads, smem, stream>>>(
      o, d, t_max, tris, gbox, sbox, R, T, K, next, tout, iout);
  return (int)cudaGetLastError();
}
