// Two-level flat walk closest hit over the superleaf tables (superblocks of
// 128 block columns, then blocks, then slots), one thread per ray.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat2_kernel
// (launched by _flat2_launch, entry closest_hit_triangles_flat2), which
// serves scenes of more than FLAT_MAX_BLOCKS = 2,048 blocks (about 1M
// triangles). Contract kept (with the plain version, ops/cuda_bvh.py):
//   - superblock gate on the [8, sbpad] union table: tf >= max(tn, 0),
//     tf > t_prev and superblock id >= 0; then the same block gate on the
//     superblock's 128 columns of the [8, bpad] block table (block id >= 0),
//     zero direction components inverted to 1e30;
//   - a block's BW rows are those of its id (blkid), never of its column:
//     the opacity partition leaves gaps between the column ranges;
//   - the Baldwin-Weber test of flat_closest_hit.cu per slot, with its tie
//     rule (the lexicographic (t, packed slot) minimum, so the visit order
//     decides nothing: on the same tables this kernel gives the flat
//     kernel's record); a miss is t = +inf, slot -1;
//   - a dead lane is t_prev = +inf; a CTA of dead lanes skips the walk.
//
// Bound on the card: arithmetic in the dense block visits, and at 1M
// triangles the HBM reads of each visited block's 12 used BW rows (the
// 90.4 MB table of the 991,834-triangle textured showcase does not stay in
// the 50 MB L2). Design: the flat kernel's CTA walk with one more level. A CTA of 128
// Morton-consecutive rays keys each superblock by its nearest slab entry
// over the CTA's live lanes (one thread per superblock column) and visits
// superblocks nearest first while some lane slab-passes one with an entry
// no farther than its best t. Inside a superblock it keys the 128 block
// columns the same way (one thread per column), visits blocks nearest
// first, and stages a block's 12 used BW rows in shared memory (12 KB at
// 256 slots) while some lane needs it. Both walks exit exactly when the
// nearest remaining entry lies beyond every lane's best t.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; sbflat [8,sbpad] f32; sbid
//          [sbpad] i32; blkflat [8,bpad] f32 (bpad = 128 x the superblock
//          columns in use); blkid [bpad] i32; bw [16, n_cols] f32 (block b
//          = columns [b*block, (b+1)*block)).
// Outputs: fout [4, R] f32 rows (t, u, v, backface 0/1); iout [R] i32
//          packed slot.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kGroup = 128;  // block columns per superblock

__global__ void __launch_bounds__(kCtaRays)
flat2_closest_hit_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_prev,
                         const float* __restrict__ sb,
                         const int* __restrict__ sbid,
                         const float* __restrict__ blk,
                         const int* __restrict__ blkid,
                         const float* __restrict__ bw, int R, int sbpad,
                         int bpad, int block, int n_cols,
                         float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float smem[];
  float* s_bw = smem;                  // [12][block]
  float* s_sbkey = s_bw + 12 * block;  // [sbpad]
  float* s_key = s_sbkey + sbpad;      // [kGroup]
  float* s_ray = s_key + kGroup;       // [kRayRows][kCtaRays]
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
  const int n_groups = min(sbpad, bpad / kGroup);

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tp);
    ptt::column_keys(sb, sbid, sbpad, n_groups, s_ray, s_sbkey, gate);
    while (true) {
      float key, reach = live ? bt : -CUDART_INF_F;
      int g;
      ptt::next_column(s_sbkey, n_groups, key, g, reach, s_red);
      if (g >= n_groups || !(key <= reach)) break;
      bool need = false;
      if (live) {
        float tn, tf;
        ptt::slab(ptt::load_box(sb, sbpad, g), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tp) && tn <= bt;
      }
      if (!__syncthreads_or(need)) continue;
      const int w = g * kGroup;
      ptt::column_keys(blk + w, blkid + w, bpad, kGroup, s_ray, s_key, gate);
      while (true) {
        float key2, reach2 = live ? bt : -CUDART_INF_F;
        int col;
        ptt::next_column(s_key, kGroup, key2, col, reach2, s_red);
        if (col >= kGroup || !(key2 <= reach2)) break;
        bool need2 = false;
        if (live) {
          float tn, tf;
          ptt::slab(ptt::load_box(blk, bpad, w + col), ox, oy, oz, ix, iy, iz,
                    tn, tf);
          need2 = gate.pass(tn, tf, tp) && tn <= bt;
        }
        if (!__syncthreads_or(need2)) continue;
        const int b = blkid[w + col];
        ptt::stage_block(bw, b, block, n_cols, s_bw);
        if (need2)
          ptt::closest_block(s_bw, b, block, ox, oy, oz, dx, dy, dz, tp, bt,
                             bu, bv, bb, bi);
        __syncthreads();  // s_bw is restaged by the next visit
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

extern "C" int ptt_flat2_closest_hit(const float* o, const float* d,
                                     const float* t_prev, const float* sb,
                                     const int* sbid, const float* blk,
                                     const int* blkid, const float* bw, int R,
                                     int sbpad, int bpad, int block,
                                     int n_cols, float* fout, int* iout,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat2_closest_hit_kernel, 12 * block, sbpad + kGroup,
                       smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  flat2_closest_hit_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      fout, iout);
  return (int)cudaGetLastError();
}
