// Two-level flat walk any-hit for L direction sets that share one origin set
// (a bounce's shadow casts toward L lights), one thread per (ray, set).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat2_occ_kernel
// (launched by _flat2_occ_launch, entries occluded_triangles_flat2 and
// occluded_triangles_flat2_multi). Contract kept (with the plain version,
// ops/cuda_bvh.py):
//   - superblock gate tf >= max(tn, 0), tn <= t_max, t_max >= 0 and id >= 0,
//     then the same block gate on the superblock's 128 block columns;
//     rows addressed by block id; zero direction components inverted to
//     1e30;
//   - a ray is occluded when some triangle hit has 1e-6 <= t <= t_max, by
//     the Baldwin-Weber test of flat_closest_hit.cu (same rounding);
//   - a dead lane is t_max < 0 and reports occluded (the caller masks it);
//     a CTA with no lane of t_max >= 0 skips the walk;
//   - the result does not depend on the visit order (any hit counts).
//
// Bound on the card: arithmetic in the dense block visits and, at 1M
// triangles, the HBM reads of the visited blocks' rows; each lane stops at
// its first occluder. Design: blockIdx.y picks the set; each CTA is 128
// consecutive rays of one set and runs flat2_closest_hit.cu's two-level
// walk. A superblock, and inside it a block, is visited only while some
// lane of the CTA is still unoccluded and slab-passes it; an occluded lane
// leaves the CTA's vote. The walk ends when every lane is occluded or no
// superblock is left.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; sbflat, sbid,
//          blkflat, blkid, bw as in flat2_closest_hit.cu.
// Output:  out [L,R] f32, 1 = occluded (or dead), 0 = not occluded.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kGroup = 128;  // block columns per superblock

__global__ void __launch_bounds__(kCtaRays)
flat2_occluded_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ t_max,
                      const float* __restrict__ sb,
                      const int* __restrict__ sbid,
                      const float* __restrict__ blk,
                      const int* __restrict__ blkid,
                      const float* __restrict__ bw, int R, int sbpad, int bpad,
                      int block, int n_cols, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_bw = smem;                  // [12][block]
  float* s_sbkey = s_bw + 12 * block;  // [sbpad]
  float* s_key = s_sbkey + sbpad;      // [kGroup]
  float* s_ray = s_key + kGroup;       // [kRayRows][kCtaRays]
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
  const bool live = gate.live(tm);
  bool occ = tm < 0.f;  // dead lanes report occluded
  const int n_groups = min(sbpad, bpad / kGroup);

  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tm);
    ptt::column_keys(sb, sbid, sbpad, n_groups, s_ray, s_sbkey, gate);
    while (true) {
      float key, open = (live && !occ) ? 1.f : 0.f;  // any lane still open?
      int g;
      ptt::next_column(s_sbkey, n_groups, key, g, open, s_red);
      if (g >= n_groups || open == 0.f) break;
      bool need = false;
      if (live && !occ) {
        float tn, tf;
        ptt::slab(ptt::load_box(sb, sbpad, g), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tm);
      }
      if (!__syncthreads_or(need)) continue;
      const int w = g * kGroup;
      ptt::column_keys(blk + w, blkid + w, bpad, kGroup, s_ray, s_key, gate);
      while (true) {
        float key2, open2 = (live && !occ) ? 1.f : 0.f;
        int col;
        ptt::next_column(s_key, kGroup, key2, col, open2, s_red);
        if (col >= kGroup || open2 == 0.f) break;
        bool need2 = false;
        if (live && !occ) {
          float tn, tf;
          ptt::slab(ptt::load_box(blk, bpad, w + col), ox, oy, oz, ix, iy, iz,
                    tn, tf);
          need2 = gate.pass(tn, tf, tm);
        }
        if (!__syncthreads_or(need2)) continue;
        ptt::stage_block(bw, blkid[w + col], block, n_cols, s_bw);
        if (need2)
          occ = ptt::occluded_block(s_bw, block, ox, oy, oz, dx, dy, dz, tm);
        __syncthreads();  // s_bw is restaged by the next visit
      }
    }
  }
  if (in_range) out[lane] = occ ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptt_flat2_occluded(const float* o, const float* d,
                                  const float* t_max, const float* sb,
                                  const int* sbid, const float* blk,
                                  const int* blkid, const float* bw, int R,
                                  int L, int sbpad, int bpad, int block,
                                  int n_cols, float* out, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat2_occluded_kernel, 12 * block, sbpad + kGroup,
                       smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  flat2_occluded_kernel<<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      out);
  return (int)cudaGetLastError();
}
