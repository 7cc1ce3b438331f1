// Sphere block walk closest hit over SAH blocks of 128 spheres, one thread
// per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_spheres.py::
// _sph_walk_kernel (launched by _sph_walk_launch, entry
// closest_hit_spheres_pallas with sph_use_blocks), which serves scenes of
// more than 512 spheres. Contract kept (with the plain version,
// ops/cuda_spheres.py):
//   - block gate on the [8, sbpad] AABB table: tf >= max(tn, 0),
//     tf > t_prev and block id >= 0, zero direction components inverted to
//     1e30; a block's spheres are the 128 sorted slots of its id;
//   - per sphere the TPU walk's naive quadratic, NOT the dense kernel's
//     form: oc = o - c, a = |d|^2, b = 2 oc.d, c = |oc|^2 - r^2,
//     disc = b^2 - 4ac, has = disc >= 0, sq = sqrt(has ? disc : 0),
//     inv2a = 1 / (2a), t1 = (-b - sq) inv2a, t2 = (-b + sq) inv2a; a root
//     is valid iff has, >= 0 and > t_prev; t = t1 if valid, else t2 if
//     valid, else +inf; backface = the far root alone is valid;
//   - TIE RULE: the lexicographic (t, sorted slot) minimum, so the visit
//     order decides nothing; a miss is t = +inf, slot -1;
//   - pad slots (center 1e30, radius 0) overflow: b^2 and c are inf and
//     disc NaN, so has is false. IEEE semantics are kept: no fast math,
//     IEEE division and sqrt, and -fmad=false for the plain version's
//     rounding;
//   - a dead lane is t_prev = +inf; a CTA of dead lanes skips the walk.
//
// Bound on the card: arithmetic, about 25 flops per (ray, sphere) solve of
// each admitted block plus a slab test per block (62 blocks for 4,900
// spheres). Design: the flat kernel's CTA walk over the block AABBs. A CTA
// of 128 Morton-consecutive rays keys each block by its nearest slab entry
// over its live lanes, visits blocks nearest first while some lane
// slab-passes one no farther than its best t, stages the block's [4, 128]
// spheres in shared memory (2 KB, read as broadcasts), and stops exactly
// when the nearest remaining entry lies beyond every lane's best t.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; blk [8,sbpad] f32; blkid
//          [sbpad] i32; sph [4, n_slots] f32 (block b = columns
//          [b*128, (b+1)*128)).
// Outputs: fout [2, R] f32 rows (t, backface 0/1); iout [R] i32 sorted
//          slot.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kSlots = 128;  // spheres per block

__global__ void __launch_bounds__(kCtaRays)
sph_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_prev,
                const float* __restrict__ blk, const int* __restrict__ blkid,
                const float* __restrict__ sph, int R, int sbpad, int n_slots,
                float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float smem[];
  float* s_sph = smem;                // [4][kSlots]
  float* s_key = s_sph + 4 * kSlots;  // [sbpad]
  float* s_ray = s_key + sbpad;       // [kRayRows][kCtaRays]
  __shared__ float s_red[3 * (kCtaRays / 32)];

  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tp = CUDART_INF_F;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  const ptt::ClosestGate gate;
  const bool live = gate.live(tp);

  float bt = CUDART_INF_F, bb = 0.f;
  int bi = -1;
  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv2a = 1.0f / (2.0f * a);
    const float four_a = 4.0f * a;
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tp);
    ptt::column_keys(blk, blkid, sbpad, sbpad, s_ray, s_key, gate);
    while (true) {
      float key, reach = live ? bt : -CUDART_INF_F;
      int col;
      ptt::next_column(s_key, sbpad, key, col, reach, s_red);
      if (col >= sbpad || !(key <= reach)) break;
      bool need = false;
      if (live) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, sbpad, col), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tp) && tn <= bt;
      }
      if (!__syncthreads_or(need)) continue;
      const int start = blkid[col] * kSlots;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s_sph[r * kSlots + threadIdx.x] =
            sph[(size_t)r * n_slots + start + threadIdx.x];
      __syncthreads();
      if (need) {
        for (int j = 0; j < kSlots; ++j) {
          const float ocx = ox - s_sph[j];
          const float ocy = oy - s_sph[kSlots + j];
          const float ocz = oz - s_sph[2 * kSlots + j];
          const float rad = s_sph[3 * kSlots + j];
          const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
          const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
          const float disc = b * b - four_a * cc;
          const bool has = disc >= 0.f;
          const float sq = sqrtf(has ? disc : 0.f);
          const float t1 = (-b - sq) * inv2a;
          const float t2 = (-b + sq) * inv2a;
          const bool v1 = has && t1 >= 0.f && t1 > tp;
          const bool v2 = has && t2 >= 0.f && t2 > tp;
          const float t = v1 ? t1 : (v2 ? t2 : CUDART_INF_F);
          const int slot = start + j;
          if (t < bt || (t == bt && slot < bi)) {  // lower slot on a tie
            bt = t; bb = (!v1 && v2) ? 1.f : 0.f; bi = slot;
          }
        }
      }
      __syncthreads();  // s_sph is restaged by the next visit
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bb;
    iout[i] = bi;
  }
}

}  // namespace

extern "C" int ptt_sph_walk(const float* o, const float* d,
                            const float* t_prev, const float* blk,
                            const int* blkid, const float* sph, int R,
                            int sbpad, int n_slots, float* fout, int* iout,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(sph_walk_kernel, 4 * kSlots, sbpad, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  sph_walk_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, blk, blkid, sph, R, sbpad, n_slots, fout, iout);
  return (int)cudaGetLastError();
}
