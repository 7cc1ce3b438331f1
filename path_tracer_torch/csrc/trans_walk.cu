// Shadow transmittance over the compact transparent table, one thread per
// lane of the stacked [L*R] shadow lanes (all lights of a bounce).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_trwalk.py::_trans_kernel
// and its tile body trans_tile (launched by trans_walk_kernel). Contract kept
// (with the plain version, ops/trwalk.py trans_walk_plain):
//   - a lane is dead when pd < 0 (pd: distance to the light, +inf for a
//     directional light); it reports trans 1;
//   - in a scene with opacity textures, a directional lane walks in
//     ascending t with the strict t > t_prev advance (ties to the lowest
//     column), trans *= 1 - op at each candidate's own uv and page, until
//     trans == 0 or steps_cap steps; lanes still walking go on outside;
//   - every other lane takes the loop-free product: cut = the least t of
//     candidates farther than pd from the surface point (point lanes), and
//     trans = product of (1 - op) over the candidates with t < cut, equal-t
//     duplicates included, in ascending column order; point lanes sample
//     the ORIGINAL hit's uv with the occluder's page, and the factor alone
//     where the original hit was a sphere.
// The Pallas kernel chose the form per 256-lane tile (the product when all
// live lanes of the tile were point lanes). The stacked lanes hold one
// light per tile, so this per-lane rule gives the same result.
//
// Bound on the card: arithmetic, the Baldwin-Weber test of every column per
// pass for each live lane (two passes for point lanes, one per step for
// walking lanes). Design as alpha_walk.cu: 128 lanes per CTA, the table's
// BW rows streamed through shared memory in 256-column chunks only while
// some lane of the CTA needs them, attribute rows and texel codes read from
// device memory, the LUT in shared memory. The product multiplies in
// ascending column order where the Pallas kernel used a butterfly.
//
// Inputs:  o, d [R,3] f32; aux [8,R] f32: pd (-1 dead), is point (0/1),
//          surface point xyz, original uv, original is sphere (0/1); the
//          table (trwalk_common.cuh).
// Output:  fout [3,R] f32: trans, t_prev, still walking (0/1).

#include "trwalk_common.cuh"

namespace {

using ptt::kTrChunk;
using ptt::kTrCta;

__global__ void __launch_bounds__(kTrCta)
trans_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ aux, ptt::TrTable tb, int R,
                  int steps_cap, int textured, float* __restrict__ fout) {
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
  const bool live = pd >= 0.f;
  const bool loop = live && textured && !is_pt;
  const bool dense = live && !loop;
  const float inf = CUDART_INF_F;
  float trans = 1.f, t_prev = -1.f;

  if (__syncthreads_or(dense)) {
    // Pass 1 (point lanes): the first candidate behind the light.
    float cut = inf;
    const bool need_cut = dense && is_pt;
    if (__syncthreads_or(need_cut)) {
      ptt::for_each_chunk(tb, s_bw, [&](int c0, int n) {
        if (!need_cut) return;
        for (int c = 0; c < n; ++c) {
          float t, u, v, dn;
          if (!ptt::tr_candidate(s_bw + c, ox, oy, oz, dx, dy, dz, inf, t, u,
                                 v, dn))
            continue;
          const float ocx = ox + t * dx - spx;
          const float ocy = oy + t * dy - spy;
          const float ocz = oz + t * dz - spz;
          const float occ = sqrtf(ocx * ocx + ocy * ocy + ocz * ocz);
          if (occ > pd) cut = fminf(cut, t);
        }
      });
    }
    // Pass 2: the product over the candidates in front of the cut.
    ptt::for_each_chunk(tb, s_bw, [&](int c0, int n) {
      if (!dense) return;
      for (int c = 0; c < n; ++c) {
        float t, u, v, dn;
        if (!ptt::tr_candidate(s_bw + c, ox, oy, oz, dx, dy, dz, inf, t, u, v,
                               dn) ||
            !(t < cut))
          continue;
        const int col = c0 + c;
        const float fac = tb.rows[6 * tb.T + col];
        float op = fac;
        if (textured && !osimple && tb.rows[7 * tb.T + col] > 0.f)
          op = ptt::page_texel(tb, s_lut, ouvx, ouvy,
                               (int)tb.rows[8 * tb.T + col]) * fac;
        trans = trans * (1.f - op);
      }
    });
  }

  // Directional lanes of a textured scene: the sequential walk.
  bool walking = loop;
  for (int k = 0; k < steps_cap; ++k) {
    if (!__syncthreads_or(walking)) break;
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, walking, ox, oy, oz, dx, dy, dz, inf,
                        t_prev, t, col, u, v, dn);
    if (!walking) continue;
    if (col < 0) {
      walking = false;
      continue;
    }
    const float fac = tb.rows[6 * tb.T + col];
    float uvx, uvy;
    ptt::column_uv(tb, col, u, v, uvx, uvy);
    const float tex = ptt::page_texel(tb, s_lut, uvx, uvy,
                                      (int)tb.rows[8 * tb.T + col]);
    const float op = tb.rows[7 * tb.T + col] <= 0.f ? fac : tex * fac;
    trans = trans * (1.f - op);
    walking = trans != 0.f;
    if (walking) t_prev = t;
  }
  if (steps_cap == 0) {  // no step taken: only a lane with a candidate walks on
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, walking, ox, oy, oz, dx, dy, dz, inf,
                        t_prev, t, col, u, v, dn);
    walking = walking && col >= 0;
  }
  if (in_range) {
    fout[i] = trans;
    fout[R + i] = t_prev;
    fout[2 * R + i] = walking ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int ptt_trans_walk(const float* o, const float* d, const float* aux,
                              const float* bw, const float* rows,
                              const unsigned char* tex, const float* lut,
                              const int* pages, int R, int T, int wp,
                              int steps_cap, int textured, float* fout,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const ptt::TrTable tb{bw, rows, tex, lut, pages, T, wp};
  trans_walk_kernel<<<(R + kTrCta - 1) / kTrCta, kTrCta, 0, stream>>>(
      o, d, aux, tb, R, steps_cap, textured, fout);
  return (int)cudaGetLastError();
}
