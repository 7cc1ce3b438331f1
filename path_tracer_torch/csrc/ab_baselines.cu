// The design row 6 (the sphere any-hit walk, sph_occ.cu) replaced, kept
// under its own symbol only to be timed against the new design in turns on
// the same card and to hold the new design to it; no wrapper of the main
// path reaches it (chip_smoke.py's phase 3q and tests/test_torch_cuda.py
// call it through ops/ab_baselines.py).
//
// ptt_sph_occ_walk_cta, row 6's first port: blockIdx.y picks the set, a CTA
// is 128 consecutive rays of it sharing one walk (flat_common.cuh's CTA
// walk): the nearest slab entry of each block column over the CTA's live
// lanes, then the columns nearest first while some lane is unoccluded and
// its gate admits one, each block's [4, 128] spheres staged in shared
// memory behind CTA barriers and tested by the lanes whose gate admits it.
// Its gate is the widened one: the wrapper passes the block boxes widened
// (slab.pad_boxes) and WidenedOccludedGate widens each lane's interval, so
// it equals the new design and the plain version on every lane. It writes
// f32 (1 = occluded, 0 = not occluded or dead); the wrapper ORs a prior in
// ATen. Arguments (o, d, t_max, blk, blkid, sph, R, L, sbpad, n_slots,
// out).

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kSlots = 128;  // spheres per walk block

__global__ void __launch_bounds__(kCtaRays)
sph_occ_walk_cta_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_max,
                        const float* __restrict__ blk,
                        const int* __restrict__ blkid,
                        const float* __restrict__ sph, int R, int sbpad,
                        int n_slots, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_sph = smem;                // [4][kSlots]
  float* s_key = s_sph + 4 * kSlots;  // [sbpad]
  float* s_ray = s_key + sbpad;       // [kRayRows][kCtaRays]
  __shared__ float s_red[3 * (kCtaRays / 32)];

  // The lane's ray and t_max of set blockIdx.y; a ray past R is dead.
  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  const size_t idx = (size_t)blockIdx.y * R + i;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * idx]; dy = d[3 * idx + 1]; dz = d[3 * idx + 2];
    tm = t_max[idx];
  }
  const ptt::WidenedOccludedGate gate;
  const bool live = gate.live(tm);
  bool occ = false;  // dead lanes report not occluded
  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv2a = 1.0f / (2.0f * a);
    const float four_a = 4.0f * a;
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tm);
    ptt::column_keys(blk, blkid, sbpad, sbpad, s_ray, s_key, gate);
    while (true) {
      float key, open = (live && !occ) ? 1.f : 0.f;  // any lane still open?
      int col;
      ptt::next_column(s_key, sbpad, key, col, open, s_red);
      if (col >= sbpad || open == 0.f) break;
      bool need = false;
      if (live && !occ) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, sbpad, col), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tm);
      }
      if (!__syncthreads_or(need)) continue;
      const int start = blkid[col] * kSlots;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s_sph[r * kSlots + threadIdx.x] =
            sph[(size_t)r * n_slots + start + threadIdx.x];
      __syncthreads();
      for (int j = 0; need && !occ && j < kSlots; ++j)
        occ = ptt::sphere_occludes(ox, oy, oz, dx, dy, dz, four_a, inv2a, tm,
                                   s_sph[j], s_sph[kSlots + j],
                                   s_sph[2 * kSlots + j],
                                   s_sph[3 * kSlots + j]);
      __syncthreads();  // s_sph is restaged by the next visit
    }
  }
  if (in_range) out[idx] = occ ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptt_sph_occ_walk_cta(const float* o, const float* d,
                                    const float* t_max, const float* blk,
                                    const int* blkid, const float* sph, int R,
                                    int L, int sbpad, int n_slots, float* out,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(sph_occ_walk_cta_kernel, 4 * kSlots, sbpad, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  sph_occ_walk_cta_kernel<<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, blk, blkid, sph, R, sbpad, n_slots, out);
  return (int)cudaGetLastError();
}
