// The designs the flat any-hit (flat_occluded.cu) and the flat2 closest
// hit (flat2_closest_hit.cu) replaced, kept unchanged under their own
// symbols only to be timed against the new designs in turns on the same
// card; no wrapper of the main path reaches them (chip_smoke.py's phase 3j
// and two card tests call them through ops/ab_baselines.py).
//
// ptt_flat_occluded_cta: the CTA walk of flat_common.cuh's flat_occ_set
// (which fused_shadow.cu keeps): a CTA of 128 consecutive rays of one set
// (blockIdx.y the set) shares one walk: per block column the nearest slab
// entry over its lanes, then repeatedly the unvisited column of nearest
// entry; when some lane still open slab-passes it (__syncthreads_or) the
// CTA stages its 12 used Baldwin-Weber rows in shared memory and every
// needing lane runs the block's slots until its first hit. Its output is
// the new kernel's, bit for bit (any hit counts).
//
// ptt_flat2_closest_hit_cta: the same walk with one more level. A CTA of
// 128 Morton-consecutive rays keys each superblock by its nearest slab
// entry over the CTA's live lanes and visits superblocks nearest first
// while some lane slab-passes one with an entry no farther than its best
// t; inside a superblock it keys the 128 block columns the same way and
// visits blocks nearest first, staging a block's rows while some lane
// needs it. That cut of whole blocks at a lane's best t is not exact:
// where rounding puts a hit a few ulps before its block's slab entry (a
// ray through a vertex or an edge of the box) the visit order decides
// between equal-t copies, and the record can part from the plain
// version's there.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

__global__ void __launch_bounds__(kCtaRays)
flat_occluded_cta_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
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

// The arguments of ptt_flat_occluded.
extern "C" int ptt_flat_occluded_cta(const float* o, const float* d,
                                     const float* t_max, const float* blk,
                                     const int* blkid, const float* bw,
                                     int R, int L, int bpad, int block,
                                     int n_cols, float* out, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat_occluded_cta_kernel, 12 * block, bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  flat_occluded_cta_kernel<<<grid, kCtaRays, smem, stream>>>(o, d, t_max,
                                                             ft, R, out);
  return (int)cudaGetLastError();
}

namespace {

constexpr int kGroup = 128;  // block columns per superblock

__global__ void __launch_bounds__(kCtaRays)
flat2_closest_hit_cta_kernel(const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ t_prev,
                             const float* __restrict__ sb,
                             const int* __restrict__ sbid,
                             const float* __restrict__ blk,
                             const int* __restrict__ blkid,
                             const float* __restrict__ bw, int R, int sbpad,
                             int bpad, int block, int n_cols,
                             float* __restrict__ fout,
                             int* __restrict__ iout) {
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

extern "C" int ptt_flat2_closest_hit_cta(const float* o, const float* d,
                                         const float* t_prev, const float* sb,
                                         const int* sbid, const float* blk,
                                         const int* blkid, const float* bw,
                                         int R, int sbpad, int bpad,
                                         int block, int n_cols, float* fout,
                                         int* iout, int device,
                                         cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat2_closest_hit_cta_kernel, 12 * block,
                       sbpad + kGroup, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  flat2_closest_hit_cta_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      fout, iout);
  return (int)cudaGetLastError();
}
