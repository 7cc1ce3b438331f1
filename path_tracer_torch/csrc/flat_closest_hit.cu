// Flat block-walk closest hit over the superleaf tables, one thread per ray,
// with an optional dense sphere pass merged in the same launch.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat_kernel
// (launched by _flat_launch, entry closest_hit_triangles_flat). Contract
// kept (with the plain version, ops/cuda_bvh.py):
//   - block slab gate tf >= max(tn, 0) and tf > t_prev on the [8, bpad]
//     AABB table, zero direction components inverted to 1e30; pad columns
//     (block id < 0) are excluded by id (their bounds may slab-pass);
//   - Baldwin-Weber test per slot: |d.n| >= 1e-6, t = (c - o.n) * 1/(d.n),
//     t >= 1e-6 and t > t_prev, u = Au.h + au >= 0, v = Av.h + av >= 0,
//     u + v <= 1; backface = d.n > 0 (MT det = -d.n);
//   - TIE RULE: the smallest t wins, and among equal t the lowest packed
//     slot (a lexicographic (t, slot) minimum, so the visit order does not
//     decide it); a miss reports t = +inf, slot -1;
//   - a dead lane is t_prev = +inf; a CTA whose lanes are all dead skips
//     the walk and writes the all-miss record;
//   - sphere pass (S > 0): the root rules of sphere_closest_hit.cu over the
//     dense [4, S] table, lowest index among equal t; the sphere wins only
//     on sph_t < tri_t (the triangle wins ties) and then reports kind 2,
//     slot = sph_row_base + index, u = v = 0.
//
// Bound on the card: arithmetic in the dense block visits (about 25 flops
// per ray-slot test, sl_block slots per visited block); the tables (8.5 MB
// for the 100k-triangle showcase) stay in L2. Design: a CTA of 128 rays,
// consecutive in the Morton-ordered wavefront, shares one walk. It first
// computes, per block column, the nearest slab entry over its lanes
// (thread c loops over the CTA's 128 rays staged in shared memory), then
// repeatedly takes the unvisited column with the nearest entry. Each lane
// re-tests that block's slab against its current best t; when any lane of
// the CTA still needs the block (__syncthreads_or), the CTA stages the
// block's 12 used BW rows in shared memory (12 KB at sl_block = 256) and
// every needing lane tests all its slots, reading them as broadcasts. The
// walk ends when no column is left or the nearest remaining entry lies
// beyond every lane's best t, which is exact (no lane could still improve).
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; blkflat [8,bpad] f32;
//          blkid [bpad] i32; bw [16, n_cols] f32 (block b = columns
//          [b*block, (b+1)*block)); sph [4,S] f32 (unused when S == 0).
// Outputs: fout [4 or 5, R] f32 rows (t, u, v, backface 0/1[, kind 0/1/2]);
//          iout [R] i32 packed slot.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

__global__ void __launch_bounds__(kCtaRays)
flat_closest_hit_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_prev,
                        const float* __restrict__ blk,
                        const int* __restrict__ blkid,
                        const float* __restrict__ bw,
                        const float* __restrict__ sph, int R, int bpad,
                        int block, int n_cols, int S, int sph_row_base,
                        float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float smem[];
  float* s_bw = smem;                 // [12][block]; sphere chunks reuse it
  float* s_key = s_bw + 12 * block;   // [bpad]
  float* s_ray = s_key + bpad;        // [kRayRows][kCtaRays]
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
  const bool live = gate.live(tp);  // +inf (or NaN) marks a dead lane
  const int n_rows = S > 0 ? 5 : 4;

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
                iz = ptt::safe_inv(dz);
    ptt::stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tp);
    ptt::column_keys(blk, blkid, bpad, bpad, s_ray, s_key, gate);
    while (true) {
      float key, reach = live ? bt : -CUDART_INF_F;  // farthest best t
      int col;
      ptt::next_column(s_key, bpad, key, col, reach, s_red);
      // Exact stop: every remaining entry lies beyond every lane's best t.
      if (col >= bpad || !(key <= reach)) break;
      bool need = false;
      if (live) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, bpad, col), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need = gate.pass(tn, tf, tp) && tn <= bt;
      }
      if (!__syncthreads_or(need)) continue;
      const int b = blkid[col];
      ptt::stage_block(bw, b, block, n_cols, s_bw);
      if (need)
        ptt::closest_block(s_bw, b, block, ox, oy, oz, dx, dy, dz, tp, bt, bu,
                           bv, bb, bi);
      __syncthreads();  // s_bw is restaged by the next visit
    }
  }

  float kind = bt < CUDART_INF_F ? 1.f : 0.f;
  if (S > 0 && __syncthreads_or(live)) {
    const float a = dx * dx + dy * dy + dz * dz;
    const float two_a = 2.0f * a;
    const int chunk = 3 * block;  // [4][chunk] fits in the [12][block] area
    float st = CUDART_INF_F, sb = 0.f;
    int si = 0;
    for (int base = 0; base < S; base += chunk) {
      const int n = min(chunk, S - base);
      for (int c = threadIdx.x; c < n; c += kCtaRays) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s_bw[r * chunk + c] = sph[(size_t)r * S + base + c];
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < n; ++j) {
          bool far;
          const float t = ptt::sphere_nearest(
              ox, oy, oz, dx, dy, dz, a, two_a, tp, s_bw[j],
              s_bw[chunk + j], s_bw[2 * chunk + j], s_bw[3 * chunk + j], far);
          if (t < st) { st = t; sb = far ? 1.f : 0.f; si = base + j; }
        }
      }
      __syncthreads();
    }
    if (st < bt) {  // the triangle wins ties
      bt = st; bu = 0.f; bv = 0.f; bb = sb; bi = sph_row_base + si;
      kind = 2.f;
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bu;
    fout[2 * (size_t)R + i] = bv;
    fout[3 * (size_t)R + i] = bb;
    if (n_rows == 5) fout[4 * (size_t)R + i] = kind;
    iout[i] = bi;
  }
}

}  // namespace

extern "C" int ptt_flat_closest_hit(const float* o, const float* d,
                                    const float* t_prev, const float* blk,
                                    const int* blkid, const float* bw,
                                    const float* sph, int R, int bpad,
                                    int block, int n_cols, int S,
                                    int sph_row_base, float* fout, int* iout,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat_closest_hit_kernel, 12 * block, bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  flat_closest_hit_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, blk, blkid, bw, sph, R, bpad, block, n_cols, S,
      sph_row_base, fout, iout);
  return (int)cudaGetLastError();
}
