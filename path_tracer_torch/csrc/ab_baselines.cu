// The designs the sphere block walk (sph_walk.cu) and the dense sphere
// any-hit (sph_occ.cu) replaced, kept unchanged under their own symbols only
// to be timed against the new designs in turns on the same card; no wrapper
// of the main path reaches them (chip_smoke.py's phase 3m and two card
// tests call them through ops/ab_baselines.py).
//
// ptt_sph_walk_cta takes (o, d, t_prev, blk, blkid, sph, R, sbpad, n_slots,
// fout, iout): a CTA of 128 rays shares one cursor over the block columns,
// nearest entry first; each visit costs CTA reductions and barriers and
// stages the block's [4, 128] spheres in shared memory for the whole CTA;
// a lane serves a block when its gate admits it and its slab entry is no
// farther than its best t. It writes fout [2,R] (t, backface 0/1) and
// iout [R] sorted slot, which its wrapper maps to a HitRecord (prim
// through sph_smap) and merges with ATen ops.
//
// ptt_sph_occluded_chunked takes (o, d, t_max, sph, R, L, S, ld, out): one
// thread per (ray, set), blockIdx.y the set; the [4, S] table streams
// through shared memory 512 columns at a time behind two CTA barriers while
// some lane of the CTA is open. It writes out [L,R] f32 (1 = occluded, dead
// lanes 0), which its wrapper compares with 0 and ORs with the triangle
// result in ATen.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kChunk = 512;  // spheres staged per pass of the dense kernel
constexpr int kSlots = 128;  // spheres per walk block

__global__ void __launch_bounds__(kCtaRays)
sph_walk_cta_kernel(const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ t_prev,
                    const float* __restrict__ blk,
                    const int* __restrict__ blkid,
                    const float* __restrict__ sph, int R, int sbpad,
                    int n_slots, float* __restrict__ fout,
                    int* __restrict__ iout) {
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

// Whether one of the n spheres staged in s (rows x, y, z, r with row stride
// ld) has a root in [0, tm].
__device__ __forceinline__ bool any_root(const float* s, int ld, int n,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float four_a, float inv2a,
                                         float tm) {
  for (int j = 0; j < n; ++j) {
    const float ocx = ox - s[j];
    const float ocy = oy - s[ld + j];
    const float ocz = oz - s[2 * ld + j];
    const float rad = s[3 * ld + j];
    const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - four_a * cc;
    if (!(disc >= 0.f)) continue;
    const float sq = sqrtf(disc);
    const float t1 = (-b - sq) * inv2a;
    if (t1 >= 0.f && t1 <= tm) return true;
    const float t2 = (-b + sq) * inv2a;
    if (t2 >= 0.f && t2 <= tm) return true;
  }
  return false;
}

// The lane's ray and t_max of set blockIdx.y; a ray past R is dead.
struct Lane {
  size_t idx;
  bool in_range;
  float ox, oy, oz, dx, dy, dz, tm;
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ t_max,
                                          int R) {
  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  Lane l{(size_t)blockIdx.y * R + i, i < R, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f,
         -1.f};
  if (l.in_range) {
    l.ox = o[3 * i]; l.oy = o[3 * i + 1]; l.oz = o[3 * i + 2];
    l.dx = d[3 * l.idx]; l.dy = d[3 * l.idx + 1]; l.dz = d[3 * l.idx + 2];
    l.tm = t_max[l.idx];
  }
  return l;
}

__global__ void __launch_bounds__(kCtaRays)
sph_occ_chunked_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ t_max,
                       const float* __restrict__ sph, int R, int S, int ld,
                       float* __restrict__ out) {
  __shared__ float s_sph[4 * kChunk];
  const Lane l = load_lane(o, d, t_max, R);
  const bool live = l.tm >= 0.f;  // a dead lane has no root in [0, t_max]
  const float a = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  const float inv2a = 1.0f / (2.0f * a);
  const float four_a = 4.0f * a;
  bool occ = false;
  for (int c0 = 0; c0 < S; c0 += kChunk) {
    // Also the barrier before s_sph is restaged.
    if (!__syncthreads_or(live && !occ)) break;
    const int n = min(kChunk, S - c0);
    for (int idx = threadIdx.x; idx < 4 * kChunk; idx += kCtaRays) {
      const int r = idx / kChunk, c = idx - r * kChunk;
      if (c < n) s_sph[idx] = sph[(size_t)r * ld + c0 + c];
    }
    __syncthreads();
    if (live && !occ)
      occ = any_root(s_sph, kChunk, n, l.ox, l.oy, l.oz, l.dx, l.dy, l.dz,
                     four_a, inv2a, l.tm);
  }
  if (l.in_range) out[l.idx] = occ ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptt_sph_walk_cta(const float* o, const float* d,
                                const float* t_prev, const float* blk,
                                const int* blkid, const float* sph, int R,
                                int sbpad, int n_slots, float* fout,
                                int* iout, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(sph_walk_cta_kernel, 4 * kSlots, sbpad, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  sph_walk_cta_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, blk, blkid, sph, R, sbpad, n_slots, fout, iout);
  return (int)cudaGetLastError();
}

extern "C" int ptt_sph_occluded_chunked(const float* o, const float* d,
                                        const float* t_max, const float* sph,
                                        int R, int L, int S, int ld,
                                        float* out, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  sph_occ_chunked_kernel<<<grid, kCtaRays, 0, stream>>>(o, d, t_max, sph, R,
                                                        S, ld, out);
  return (int)cudaGetLastError();
}
