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
// consecutive rays of one set. The CTA computes the nearest slab entry of
// each block column over its lanes, then visits columns nearest first: a
// column is staged in shared memory (12 BW rows) only while some lane of
// the CTA is still unoccluded and slab-passes it, and a lane leaves the
// block's slot loop at its first hit. The walk ends when every lane is
// occluded or no column is left.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; blkflat [8,bpad];
//          blkid [bpad] i32; bw [16, n_cols] f32.
// Output:  out [L,R] f32, 1 = occluded (or dead), 0 = not occluded.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

__global__ void __launch_bounds__(kCtaRays)
flat_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const float* __restrict__ blk,
                     const int* __restrict__ blkid,
                     const float* __restrict__ bw, int R, int bpad, int block,
                     int n_cols, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_bw = smem;                // [12][block]
  float* s_key = s_bw + 12 * block;  // [bpad]
  float* s_ray = s_key + bpad;       // [kRayRows][kCtaRays]
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
  const ptt::OccludedGate gate;
  const bool live = gate.live(tm);  // lanes that may be occluded
  bool occ = tm < 0.f;              // dead lanes report occluded

  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tm);
    ptt::column_keys(blk, blkid, bpad, bpad, s_ray, s_key, gate);
    while (true) {
      float key, open = (live && !occ) ? 1.f : 0.f;  // any lane still open?
      int col;
      ptt::next_column(s_key, bpad, key, col, open, s_red);
      if (col >= bpad || open == 0.f) break;
      bool need = false;
      if (live && !occ) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, bpad, col), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tm);
      }
      if (!__syncthreads_or(need)) continue;
      ptt::stage_block(bw, blkid[col], block, n_cols, s_bw);
      if (need)
        occ = ptt::occluded_block(s_bw, block, ox, oy, oz, dx, dy, dz, tm);
      __syncthreads();  // s_bw is restaged by the next visit
    }
  }
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
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  flat_occluded_kernel<<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, blk, blkid, bw, R, bpad, block, n_cols, out);
  return (int)cudaGetLastError();
}
