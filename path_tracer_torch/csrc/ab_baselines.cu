// The two designs the flat closest hit (flat_closest_hit.cu) and the
// brute-force Moller-Trumbore closest hit (mt_closest_hit.cu) replaced,
// kept unchanged under their own symbols only to be timed against the new
// designs in turns on the same card; no wrapper of the main path reaches
// them (chip_smoke.py's phase 3i and one card test call them through
// ops/ab_baselines.py). Their contracts and outputs are those of the new
// kernels, bit for bit.
//
// ptt_flat_closest_hit_cta: the CTA walk. A CTA of 128 rays, consecutive in
// the Morton-ordered wavefront, shares one walk: per block column the
// nearest slab entry over its lanes (thread c loops over the CTA's rays
// staged in shared memory), then repeatedly the unvisited column of nearest
// entry; when any lane still needs that block (__syncthreads_or) the CTA
// stages its 12 used Baldwin-Weber rows in shared memory and every needing
// lane tests all its slots, reading them as broadcasts. The walk ends when
// no column is left or the nearest remaining entry lies beyond every lane's
// best t. The fused sphere pass stages the sphere table in chunks.
//
// ptt_mt_closest_hit_chunked: one thread per ray, 256-thread CTAs; each CTA
// stages the [9, N] table in shared memory 256 columns at a time (two
// barriers a chunk) and every thread reads each column as a broadcast;
// tests leave at the first failed condition.

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

__global__ void __launch_bounds__(kCtaRays)
flat_closest_hit_cta_kernel(const float* __restrict__ o,
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

extern "C" int ptt_flat_closest_hit_cta(const float* o, const float* d,
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
  err = ptt::walk_smem(flat_closest_hit_cta_kernel, 12 * block, bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + kCtaRays - 1) / kCtaRays;
  flat_closest_hit_cta_kernel<<<blocks, kCtaRays, smem, stream>>>(
      o, d, t_prev, blk, blkid, bw, sph, R, bpad, block, n_cols, S,
      sph_row_base, fout, iout);
  return (int)cudaGetLastError();
}

namespace {

constexpr int kMtThreads = 256;
constexpr int kMtChunk = 256;

__global__ void __launch_bounds__(kMtThreads)
mt_closest_hit_chunked_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_prev,
                      const float* __restrict__ tris, int R, int N,
                      float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float s[9][kMtChunk];
  const int i = blockIdx.x * kMtThreads + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tp = CUDART_INF_F;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  // A dead lane (t_prev = +inf or NaN) can pass no t > t_prev test.
  const bool live = tp < CUDART_INF_F;

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  for (int base = 0; base < N; base += kMtChunk) {
    const int n = min(kMtChunk, N - base);
    __syncthreads();  // the previous chunk is fully read
    for (int c = threadIdx.x; c < n; c += kMtThreads) {
#pragma unroll
      for (int r = 0; r < 9; ++r) s[r][c] = tris[(size_t)r * N + base + c];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
      const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
      // pvec = d x e2; det = e1 . pvec
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      if (!(fabsf(det) >= ptt::kDetEps)) continue;
      const float invdet = 1.0f / det;
      // tvec = o - v0
      const float tvx = ox - s[0][j], tvy = oy - s[1][j], tvz = oz - s[2][j];
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
      if (!(u >= 0.f)) continue;
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
      if (!(v >= 0.f && u + v <= 1.f)) continue;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
      if (!(t >= ptt::kTMin && t > tp)) continue;
      if (t < bt) {
        bt = t; bu = u; bv = v; bb = det < 0.f ? 1.f : 0.f; bi = base + j;
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

extern "C" int ptt_mt_closest_hit_chunked(const float* o, const float* d,
                                  const float* t_prev, const float* tris,
                                  int R, int N, float* fout, int* iout,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const int blocks = (R + kMtThreads - 1) / kMtThreads;
  mt_closest_hit_chunked_kernel<<<blocks, kMtThreads, 0, stream>>>(o, d, t_prev, tris,
                                                        R, N, fout, iout);
  return (int)cudaGetLastError();
}
