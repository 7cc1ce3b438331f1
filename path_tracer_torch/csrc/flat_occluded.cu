// Flat block-walk any-hit for L direction sets that share one origin set
// (a bounce's shadow casts toward L lights), one thread per (ray, set).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat_occ_kernel
// and its per-set body flat_occ_set (launched by _flat_occ_launch, entries
// occluded_triangles_flat and occluded_triangles_flat_multi). Contract kept
// (with the plain version, ops/cuda_bvh.py):
//   - a ray is occluded when some triangle hit has 1e-6 <= t <= t_max, by
//     the Baldwin-Weber test of flat_closest_hit.cu (same rounding);
//   - block slab gate tf >= max(tn, 0), tn <= t_max and t_max >= 0, zero
//     direction components inverted to 1e30, pad columns excluded by id;
//   - a dead lane is t_max < 0 and reports occluded (the caller masks it);
//     a CTA with no lane of t_max >= 0 skips the walk;
//   - the result does not depend on the visit order (any hit counts).
//
// Bound on the card: arithmetic in the dense block visits, as for the
// closest hit, but each lane stops at its first occluder. Design: blockIdx.y
// picks the set, so one launch serves all L lights and each CTA is 128
// consecutive rays of one set; the per-set walk is flat_common.cuh's
// flat_occ_set, which fused_shadow.cu shares.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; blkflat [8,bpad];
//          blkid [bpad] i32; bw [16, n_cols] f32.
// Output:  out [L,R] f32, 1 = occluded (or dead), 0 = not occluded.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

__global__ void __launch_bounds__(kCtaRays)
flat_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, ptt::FlatTable ft,
                     int R, float* __restrict__ out) {
  extern __shared__ float smem[];  // sized by ptt::walk_smem
  __shared__ float s_red[3 * (kCtaRays / 32)];

  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  const size_t lane = (size_t)blockIdx.y * R + i;  // (set, ray)
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * lane]; dy = d[3 * lane + 1]; dz = d[3 * lane + 2];
    tm = t_max[lane];
  }
  const bool occ = ptt::flat_occ_set(ft, ox, oy, oz, dx, dy, dz, tm, smem,
                                     s_red);
  if (in_range) out[lane] = occ ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptt_flat_occluded(const float* o, const float* d,
                                 const float* t_max, const float* blk,
                                 const int* blkid, const float* bw, int R,
                                 int L, int bpad, int block, int n_cols,
                                 float* out, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat_occluded_kernel, 12 * block, bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  flat_occluded_kernel<<<grid, kCtaRays, smem, stream>>>(o, d, t_max, ft, R,
                                                         out);
  return (int)cudaGetLastError();
}
