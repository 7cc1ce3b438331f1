// The designs the flat2 any-hit (flat2_occluded.cu) and the dense sphere
// closest hit (sphere_closest_hit.cu) replaced, kept unchanged under their
// own symbols only to be timed against the new designs in turns on the same
// card; no wrapper of the main path reaches them (chip_smoke.py's phase 3l
// and two card tests call them through ops/ab_baselines.py).
//
// ptt_flat2_occluded_cta takes ptt_flat2_occluded's arguments: a CTA of 128
// consecutive rays of one set shares one cursor over the superblocks and,
// inside each, over its 128 block columns, nearest entry first; every step
// costs CTA barriers, and each visit stages the block's 12 BW rows in shared
// memory for the whole CTA while some lane still needs it.
//
// ptt_sphere_closest_hit_chunked takes (o, d, t_prev, sph, R, S, fout,
// iout): it writes fout [2,R] (t, backface 0/1) and iout [R] prim, which
// its wrapper maps to a HitRecord with ATen ops; the [4, S] table streams
// through shared memory 512 columns at a time behind two CTA barriers.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kGroup = 128;  // block columns per superblock

__global__ void __launch_bounds__(kCtaRays)
flat2_occluded_cta_kernel(const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ t_max,
                          const float* __restrict__ sb,
                          const int* __restrict__ sbid,
                          const float* __restrict__ blk,
                          const int* __restrict__ blkid,
                          const float* __restrict__ bw, int R, int sbpad,
                          int bpad, int block, int n_cols,
                          float* __restrict__ out) {
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

constexpr int kSphThreads = 256;
constexpr int kSphChunk = 512;

__global__ void __launch_bounds__(kSphThreads)
sphere_closest_hit_chunked_kernel(const float* __restrict__ o,
                                  const float* __restrict__ d,
                                  const float* __restrict__ t_prev,
                                  const float* __restrict__ sph, int R, int S,
                                  float* __restrict__ fout,
                                  int* __restrict__ iout) {
  __shared__ float s[4][kSphChunk];
  const int i = blockIdx.x * kSphThreads + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tp = CUDART_INF_F;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  const bool live = tp < CUDART_INF_F;
  const float a = dx * dx + dy * dy + dz * dz;
  const float two_a = 2.0f * a;

  float bt = CUDART_INF_F, bb = 0.f;
  int bi = 0;
  for (int base = 0; base < S; base += kSphChunk) {
    const int n = min(kSphChunk, S - base);
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += kSphThreads) {
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][c] = sph[(size_t)r * S + base + c];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      bool far;
      const float t_near = ptt::sphere_nearest(ox, oy, oz, dx, dy, dz, a,
                                               two_a, tp, s[0][j], s[1][j],
                                               s[2][j], s[3][j], far);
      if (t_near < bt) {
        bt = t_near; bb = far ? 1.f : 0.f; bi = base + j;
      }
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bb;
    iout[i] = bi;
  }
}

}  // namespace

// The arguments of ptt_flat2_occluded.
extern "C" int ptt_flat2_occluded_cta(const float* o, const float* d,
                                      const float* t_max, const float* sb,
                                      const int* sbid, const float* blk,
                                      const int* blkid, const float* bw,
                                      int R, int L, int sbpad, int bpad,
                                      int block, int n_cols, float* out,
                                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(flat2_occluded_cta_kernel, 12 * block, sbpad + kGroup,
                       smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  flat2_occluded_cta_kernel<<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      out);
  return (int)cudaGetLastError();
}

// The arguments of ptt_mt_closest_hit: (o, d, t_prev, table, R, N, fout,
// iout, device, stream).
extern "C" int ptt_sphere_closest_hit_chunked(const float* o, const float* d,
                                              const float* t_prev,
                                              const float* sph, int R, int S,
                                              float* fout, int* iout,
                                              int device,
                                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const int blocks = (R + kSphThreads - 1) / kSphThreads;
  sphere_closest_hit_chunked_kernel<<<blocks, kSphThreads, 0, stream>>>(
      o, d, t_prev, sph, R, S, fout, iout);
  return (int)cudaGetLastError();
}
