// Brute-force Moller-Trumbore closest hit, one thread per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_intersect.py::_kernel
// (launched by _launch, entry closest_hit_triangles_pallas). Contract kept:
//   - |det| >= 1e-6, no culling, backface = det < 0;
//   - u >= 0, v >= 0, u + v <= 1 (u <= 1 is implied by the last two);
//   - t >= 1e-6 and t > t_prev; a dead lane is t_prev = +inf (or NaN);
//   - ties keep the LOWEST triangle index (strict < over ascending index),
//     the global-argmin rule of ops/intersect.py::closest_hit_triangles.
//
// Bound: arithmetic. Every ray meets every triangle — about 30 flops and
// one IEEE reciprocal per test, R*N tests — and the triangle table is a
// read shared by every ray. Design: each block stages the [9, N] table in
// shared memory 256 columns (9 KB) at a time with coalesced row loads;
// every thread then reads the same column at once (a broadcast, no bank
// conflicts) and keeps its running best in registers, so nothing but the
// final record touches device memory. Tests exit at the first failed
// condition, so most triangles cost the determinant and one or two dot
// products. The ragged edge of R is masked, not padded.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; tris [9,N] f32 rows
//          (v0.xyz, e1.xyz, e2.xyz), component-major.
// Outputs: fout [4,R] f32 rows (t, u, v, backface 0/1); iout [R] i32 prim
//          (-1 on a miss, with t = +inf).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;
constexpr float kDetEps = 1e-6f;
constexpr float kTMin = 1e-6f;

__global__ void __launch_bounds__(kThreads)
mt_closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_prev,
                      const float* __restrict__ tris, int R, int N,
                      float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float s[9][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tp = CUDART_INF_F;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  // A dead lane (t_prev = +inf or NaN) can pass no t > t_prev test.
  const bool live = tp < CUDART_INF_F;

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base);
    __syncthreads();  // the previous chunk is fully read
    for (int c = threadIdx.x; c < n; c += kThreads) {
#pragma unroll
      for (int r = 0; r < 9; ++r) s[r][c] = tris[(size_t)r * N + base + c];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
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
      const float tvx = ox - s[0][j], tvy = oy - s[1][j], tvz = oz - s[2][j];
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
      if (!(u >= 0.f)) continue;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
      if (!(v >= 0.f && u + v <= 1.f)) continue;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
      if (!(t >= kTMin && t > tp)) continue;
      if (t < bt) {
        bt = t; bu = u; bv = v; bb = det < 0.f ? 1.f : 0.f; bi = base + j;
      }
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bu;
    fout[2 * (size_t)R + i] = bv;
    fout[3 * (size_t)R + i] = bb;
    iout[i] = bi;
  }
}

}  // namespace

extern "C" int ptt_mt_closest_hit(const float* o, const float* d,
                                  const float* t_prev, const float* tris,
                                  int R, int N, float* fout, int* iout,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const int blocks = (R + kThreads - 1) / kThreads;
  mt_closest_hit_kernel<<<blocks, kThreads, 0, stream>>>(o, d, t_prev, tris,
                                                        R, N, fout, iout);
  return (int)cudaGetLastError();
}
