// Dense sphere closest hit, one thread per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_spheres.py::_kernel
// (launched by _launch, entry closest_hit_spheres_pallas). Contract kept:
//   - the reference's centered quadratic, oc = o - c (never the expanded
//     |o|^2 - 2 o.c + |c|^2 form, which cancels catastrophically for rays
//     that start on a sphere);
//   - each root is valid iff it is >= 0 and > t_prev; the near root wins,
//     a valid far root alone is an inside hit (backface = 1);
//   - ties keep the LOWEST sphere index; an all-miss lane reports prim 0,
//     t = +inf, backface 0, exactly like the argmin of the jnp path;
//   - the roots DIVIDE by 2a, as the jnp path (ops/intersect.py) does (the
//     TPU kernel multiplies by 1/(2a)); with the library built -fmad=false
//     every operation rounds as in the plain PyTorch version;
//   - padding spheres (center 1e30, radius 0) overflow the quadratic to
//     inf/NaN in IEEE arithmetic and never hit.
//
// Bound: arithmetic, R*S quadratic solves (about 25 flops, a sqrt and two
// IEEE divisions per valid discriminant). The [4, S] table is staged in
// shared memory 512 columns (8 KB) at a time and read as a broadcast; the
// running best stays in registers.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; sph [4,S] f32 rows (cx, cy, cz, r).
// Outputs: fout [2,R] f32 rows (t, backface 0/1); iout [R] i32 prim.

#include "flat_common.cuh"  // sphere_nearest: the root rules, shared with
                             // the fused sphere pass of flat_closest_hit.cu

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;

__global__ void __launch_bounds__(kThreads)
sphere_closest_hit_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_prev,
                          const float* __restrict__ sph, int R, int S,
                          float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float s[4][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tp = CUDART_INF_F;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  const bool live = tp < CUDART_INF_F;
  const float a = dx * dx + dy * dy + dz * dz;
  const float two_a = 2.0f * a;

  float bt = CUDART_INF_F, bb = 0.f;
  int bi = 0;
  for (int base = 0; base < S; base += kChunk) {
    const int n = min(kChunk, S - base);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += kThreads) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][c] = sph[(size_t)r * S + base + c];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      bool far;
      const float t_near = ptt::sphere_nearest(ox, oy, oz, dx, dy, dz, a,
                                               two_a, tp, s[0][j], s[1][j],
                                               s[2][j], s[3][j], far);
      if (t_near < bt) {
        bt = t_near; bb = far ? 1.f : 0.f; bi = base + j;
      }
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bb;
    iout[i] = bi;
  }
}

}  // namespace

extern "C" int ptt_sphere_closest_hit(const float* o, const float* d,
                                      const float* t_prev, const float* sph,
                                      int R, int S, float* fout, int* iout,
                                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const int blocks = (R + kThreads - 1) / kThreads;
  sphere_closest_hit_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_prev, sph, R, S, fout, iout);
  return (int)cudaGetLastError();
}
