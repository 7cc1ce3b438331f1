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
//     1e30 sentinel); a live lane tests the columns of a group only when
//     its own segment reaches the box: slab entry tn and exit tf with IEEE
//     1/d (inf on a zero component, a NaN interval bound guarded to -inf
//     and +inf), tf >= max(tn, 0) and tn <= t_max. The Pallas kernel made
//     that decision per 512-ray tile; per lane, entries within t_max are
//     the same, and beyond it a lane keeps only what its own segment
//     reaches;
//   - Moller-Trumbore as the Pallas kernel writes it: |det| >= 1e-6,
//     u >= 0, v >= 0, u + v <= 1, t >= 1e-6 (no t_max test: the walks mask
//     with their own bound);
//   - output rows k = 0..K-1: the K smallest DISTINCT hit distances in
//     ascending order, each with the lowest column that reaches it (the
//     Pallas extraction takes the minimum and knocks out every t <= it,
//     so a duplicate t, a shared foliage-card edge, is visited once);
//     +inf and column 0 past the end.
//
// Bound: arithmetic, about 45 flops per MT test over the columns of the
// groups a lane reaches. Design: one thread per ray and its K (<= 8)
// nearest (t, column) pairs in registers, kept sorted by insertion, which
// replaces the TPU's [tile, T] matrix of t. A CTA of 128 rays stages one
// group's 9 x 128 MT rows in shared memory (4.5 KB), and only when one of
// its lanes reaches the group; every thread then reads the same column at
// once (a broadcast). Columns are visited in ascending order, so an equal
// t found later never displaces the earlier (lower) column.
//
// Inputs:  o, d [R,3] f32; t_max [R] f32 (<= 0: dead); tris [9,T] f32
//          (v0.xyz, e1.xyz, e2.xyz, T a multiple of 128, zero rows for
//          padding); gbox [6,G] f32 with G = T / 128.
// Outputs: tout [K,R] f32; iout [K,R] i32 (column in the transparent
//          slice).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "klist.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 128;
constexpr int kMaxK = 8;
constexpr float kDetEps = 1e-6f;
constexpr float kTMin = 1e-6f;

// One axis of the group slab with IEEE reciprocals: a NaN bound (0 * inf
// when the origin lies on a box plane) widens the interval to all t.
__device__ __forceinline__ void axis_interval(float bmin, float bmax,
                                              float o, float inv, float& tn,
                                              float& tf) {
  const float lo = (bmin - o) * inv;
  const float hi = (bmax - o) * inv;
  const bool nan = isnan(lo) || isnan(hi);
  tn = nan ? -CUDART_INF_F : fminf(lo, hi);
  tf = nan ? CUDART_INF_F : fmaxf(lo, hi);
}

__global__ void __launch_bounds__(kThreads)
khit_kernel(const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ t_max, const float* __restrict__ tris,
            const float* __restrict__ gbox, int R, int T, int G, int K,
            float* __restrict__ tout, int* __restrict__ iout) {
  __shared__ float s[9][kGroup];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (i < R) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = t_max[i];
  }
  const bool live = tm > 0.f;
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;

  float kt[kMaxK];
  int kc[kMaxK];
  ptt::list_clear(K, kt, kc, 0);

  for (int g = 0; g < G; ++g) {
    bool reach = false;
    if (live) {
      float tnx, tfx, tny, tfy, tnz, tfz;
      axis_interval(gbox[g], gbox[3 * G + g], ox, ivx, tnx, tfx);
      axis_interval(gbox[G + g], gbox[4 * G + g], oy, ivy, tny, tfy);
      axis_interval(gbox[2 * G + g], gbox[5 * G + g], oz, ivz, tnz, tfz);
      const float tn = fmaxf(fmaxf(tnx, tny), tnz);
      const float tf = fminf(fminf(tfx, tfy), tfz);
      reach = tf >= fmaxf(tn, 0.f) && tn <= tm;
    }
    if (!__syncthreads_or(reach)) continue;  // no lane of the CTA reaches it
    const int base = g * kGroup;
#pragma unroll
    for (int r = 0; r < 9; ++r)
      s[r][threadIdx.x] = tris[(size_t)r * T + base + threadIdx.x];
    __syncthreads();
    if (reach) {
      for (int j = 0; j < kGroup; ++j) {
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
        // pvec = d x e2; det = e1 . pvec
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        if (!(fabsf(det) >= kDetEps)) continue;
        const float invdet = 1.0f / det;
        // tvec = o - v0
        const float tvx = ox - s[0][j], tvy = oy - s[1][j],
                    tvz = oz - s[2][j];
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
        if (!(u >= 0.f)) continue;
        // qvec = tvec x e1
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
        if (!(v >= 0.f && u + v <= 1.f)) continue;
        float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
        if (t >= kTMin) ptt::list_insert(t, base + j, kt, kc);
      }
    }
    __syncthreads();  // the group is read before the next one is staged
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

}  // namespace

extern "C" int ptt_khit(const float* o, const float* d, const float* t_max,
                        const float* tris, const float* gbox, int R, int T,
                        int K, float* tout, int* iout, int device,
                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  if (K > kMaxK || T <= 0 || T % kGroup) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kThreads - 1) / kThreads;
  khit_kernel<<<blocks, kThreads, 0, stream>>>(o, d, t_max, tris, gbox, R, T,
                                               T / kGroup, K, tout, iout);
  return (int)cudaGetLastError();
}
