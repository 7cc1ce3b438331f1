// Dense sphere closest hit, one thread per ray, writing the final hit
// record; an optional triangle record is merged in the same launch.
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
// The record is ops/intersect.py's HitRecord, field by field: t, kind (2 on
// a hit, 0 on a miss), prim, u = v = 0, backface as a byte of the bool
// tensor. With a triangle record (t, kind, prim, u, v, backface) the lane
// keeps the triangle's fields unless the sphere's t is strictly smaller:
// closest_hit's merge (ops/intersect.py merge_hits), the triangle winning
// ties, as the fused sphere pass of flat_closest_hit.cu merges.
//
// Bound on the card: arithmetic, R*S quadratic solves (about 25 flops, a
// sqrt and two IEEE divisions per valid discriminant), or at few spheres
// the bytes of the rays and the records (about 70 B a lane with a
// triangle record). Design: the [4, S] table is read through the
// read-only cache, every lane of the CTA reading the same column (a
// broadcast, as flat_closest_hit.cu's sphere pass reads it): no shared
// memory and no barrier. The running best stays in registers. Writing the
// record in the launch spares the caller the ATen ops that built it and
// merged it with the triangle record (5 small launches a call, 12 with a
// triangle record).
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; sph [4,S] f32 rows (cx, cy, cz,
//          r); optional triangle record tri_t, tri_u, tri_v [R] f32,
//          tri_kind, tri_prim [R] i32, tri_back [R] u8 (all null for none).
// Outputs: fout [3,R] f32 rows (t, u, v); iout [2,R] i32 rows (kind,
//          prim); bout [R] u8 backface.

#include "flat_common.cuh"  // sphere_nearest: the root rules, shared with
                             // the fused sphere pass of flat_closest_hit.cu;
                             // write_sphere_record: the record and merge,
                             // shared with sph_walk.cu

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sphere_closest_hit_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_prev,
                          const float* __restrict__ sph, int R, int S,
                          ptt::TriRecord tri, float* __restrict__ fout,
                          int* __restrict__ iout,
                          unsigned char* __restrict__ bout) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tp = t_prev[i];
  float bt = CUDART_INF_F;
  bool bb = false;
  int bi = 0;
  if (tp < CUDART_INF_F) {
    const float a = dx * dx + dy * dy + dz * dz;
    const float two_a = 2.0f * a;
    for (int j = 0; j < S; ++j) {
      bool far;
      const float t = ptt::sphere_nearest(
          ox, oy, oz, dx, dy, dz, a, two_a, tp, __ldg(sph + j),
          __ldg(sph + S + j), __ldg(sph + 2 * S + j), __ldg(sph + 3 * S + j),
          far);
      if (t < bt) { bt = t; bb = far; bi = j; }
    }
  }
  ptt::write_sphere_record(tri, i, R, bt, bi, bb, fout, iout, bout);
}

}  // namespace

extern "C" int ptt_sphere_closest_hit(
    const float* o, const float* d, const float* t_prev, const float* sph,
    const float* tri_t, const float* tri_u, const float* tri_v,
    const int* tri_kind, const int* tri_prim, const unsigned char* tri_back,
    int R, int S, float* fout, int* iout, unsigned char* bout, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const ptt::TriRecord tri{tri_t, tri_u, tri_v, tri_kind, tri_prim, tri_back};
  const int blocks = (R + kThreads - 1) / kThreads;
  sphere_closest_hit_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_prev, sph, R, S, tri, fout, iout, bout);
  return (int)cudaGetLastError();
}
