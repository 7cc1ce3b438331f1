// The designs the alpha walk (alpha_walk.cu) and the transmittance walk
// (trans_walk.cu) replaced, kept unchanged under their own symbols only to
// be timed against the new designs in turns on the same card; no wrapper of
// the main path reaches them (chip_smoke.py's phase 3k and two card tests
// call them through ops/ab_baselines.py). Each takes its kernel's
// arguments; the group table (grp, gp) goes unread.
//
// The CTA walk (trwalk_common.cuh's for_each_chunk, next_candidate and
// trans_lane_cta): a CTA of 128 lanes shares each step. While any of its
// lanes still walks, the table's 12 used Baldwin-Weber rows stream through
// shared memory in 256-column chunks behind two CTA barriers each, and each
// walking lane tests every column for its nearest candidate past t_prev:
// the CTA pays (its lanes' most steps + 1) passes over the whole table.
// Point lanes of the transmittance walk make two passes, the cut and the
// product. Row 15 (fused_shadow.cu) still runs trans_lane_cta.

#include "trwalk_common.cuh"

namespace {

using ptt::kTrChunk;
using ptt::kTrCta;

template <class Texel>
__global__ void __launch_bounds__(kTrCta)
alpha_walk_cta_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ t_op,
                      const float* __restrict__ rnd, ptt::TrTable<Texel> tb,
                      int R, int steps_cap, int textured,
                      float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float s_bw[12 * kTrChunk];
  __shared__ float s_lut[256];
  ptt::stage_lut(tb.lut, s_lut);

  const int i = blockIdx.x * kTrCta + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float top = -1.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    top = t_op[i];
  }
  const float t_hi = top < 0.f ? -1.f : top;
  bool active = top >= 0.f, seen = false, accepted = false;
  float sel_t = CUDART_INF_F, sel_u = 0.f, sel_v = 0.f, sel_dn = 0.f;
  float t_prev = -1.f;
  int sel_col = -1;

  for (int k = 0; k < steps_cap; ++k) {
    if (!__syncthreads_or(active)) break;
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, active, ox, oy, oz, dx, dy, dz, t_hi,
                        t_prev, t, col, u, v, dn);
    if (!active) continue;
    if (col < 0) {
      active = false;
      continue;
    }
    const float fac = tb.rows[6 * tb.T + col];
    float op = fac;
    if (textured) {
      float uvx, uvy;
      ptt::column_uv(tb, col, u, v, uvx, uvy);
      const float tex = ptt::page_texel(tb, s_lut, uvx, uvy,
                                        (int)tb.rows[8 * tb.T + col]);
      if (tb.rows[7 * tb.T + col] > 0.f) op = tex * fac;
    }
    const bool accept =
        op >= 1.f || (op > 0.001f && rnd[(size_t)k * R + i] < op);
    sel_t = t;
    sel_col = col;
    sel_u = u;
    sel_v = v;
    sel_dn = dn;
    seen = true;
    accepted = accepted || accept;
    active = !accept;
    if (active) t_prev = t;
  }
  if (steps_cap == 0) {  // no step taken: only a lane with a candidate walks on
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, active, ox, oy, oz, dx, dy, dz, t_hi,
                        t_prev, t, col, u, v, dn);
    active = active && col >= 0;
  }
  if (in_range) {
    fout[i] = sel_t;
    fout[R + i] = sel_u;
    fout[2 * R + i] = sel_v;
    fout[3 * R + i] = sel_dn;
    fout[4 * R + i] = seen ? 1.f : 0.f;
    fout[5 * R + i] = accepted ? 1.f : 0.f;
    fout[6 * R + i] = active ? 1.f : 0.f;
    fout[7 * R + i] = t_prev;
    iout[i] = sel_col;
  }
}

template <class Texel>
__global__ void __launch_bounds__(kTrCta)
trans_walk_cta_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ aux, ptt::TrTable<Texel> tb,
                      int R, int steps_cap, int textured,
                      float* __restrict__ fout) {
  __shared__ float s_bw[12 * kTrChunk];
  __shared__ float s_lut[256];
  ptt::stage_lut(tb.lut, s_lut);

  const int i = blockIdx.x * kTrCta + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float pd = -1.f, spx = 0.f, spy = 0.f, spz = 0.f, ouvx = 0.f, ouvy = 0.f;
  bool is_pt = false, osimple = false;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    pd = aux[i];
    is_pt = aux[R + i] > 0.f;
    spx = aux[2 * R + i]; spy = aux[3 * R + i]; spz = aux[4 * R + i];
    ouvx = aux[5 * R + i]; ouvy = aux[6 * R + i];
    osimple = aux[7 * R + i] > 0.f;
  }
  float trans, t_prev;
  bool walking;
  ptt::trans_lane_cta(tb, s_bw, s_lut, steps_cap, textured != 0, ox, oy, oz,
                      dx, dy, dz, pd, is_pt, spx, spy, spz, ouvx, ouvy,
                      osimple, trans, t_prev, walking);
  if (in_range) {
    fout[i] = trans;
    fout[R + i] = t_prev;
    fout[2 * R + i] = walking ? 1.f : 0.f;
  }
}

}  // namespace

// The arguments of ptt_alpha_walk.
extern "C" int ptt_alpha_walk_cta(const float* o, const float* d,
                                  const float* t_op, const float* rnd,
                                  const float* bw, const float* rows,
                                  const void* tex, const float* lut,
                                  const int* pages, const float* /*grp*/,
                                  int R, int T, int /*gp*/, int wp,
                                  int steps_cap, int textured, int live,
                                  float* fout, int* iout, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const dim3 grid((R + kTrCta - 1) / kTrCta);
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    alpha_walk_cta_kernel<float><<<grid, kTrCta, 0, stream>>>(
        o, d, t_op, rnd, tb, R, steps_cap, textured, fout, iout);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    alpha_walk_cta_kernel<unsigned char><<<grid, kTrCta, 0, stream>>>(
        o, d, t_op, rnd, tb, R, steps_cap, textured, fout, iout);
  }
  return (int)cudaGetLastError();
}

// The arguments of ptt_trans_walk.
extern "C" int ptt_trans_walk_cta(const float* o, const float* d,
                                  const float* aux, const float* bw,
                                  const float* rows, const void* tex,
                                  const float* lut, const int* pages,
                                  const float* /*grp*/, int R, int T,
                                  int /*gp*/, int wp, int steps_cap,
                                  int textured, int live, float* fout,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const dim3 grid((R + kTrCta - 1) / kTrCta);
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    trans_walk_cta_kernel<float><<<grid, kTrCta, 0, stream>>>(
        o, d, aux, tb, R, steps_cap, textured, fout);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    trans_walk_cta_kernel<unsigned char><<<grid, kTrCta, 0, stream>>>(
        o, d, aux, tb, R, steps_cap, textured, fout);
  }
  return (int)cudaGetLastError();
}
