// Shadow transmittance over the compact transparent table, one thread per
// lane of the stacked [L*R] shadow lanes (all lights of a bounce).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_trwalk.py::_trans_kernel
// and its tile body trans_tile (launched by trans_walk_kernel), in both its
// variants: live=False (u8 texel codes through the LUT) and live=True
// (live_factor=: the live opacity-factor row and an f32 plane of live texel
// values), a template on the plane's texel type (trwalk_common.cuh). Contract
// kept (with the plain version, ops/trwalk.py trans_walk_plain, on the same
// tables):
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
// walking lanes). The per-lane body is trwalk_common.cuh's trans_lane,
// which fused_shadow.cu shares. Design as alpha_walk.cu: 128 lanes per CTA, the table's
// BW rows streamed through shared memory in 256-column chunks only while
// some lane of the CTA needs them, attribute rows and texel codes read from
// device memory, the LUT in shared memory. The product multiplies in
// ascending column order where the Pallas kernel used a butterfly.
//
// Inputs:  o, d [R,3] f32; aux [8,R] f32: pd (-1 dead), is point (0/1),
//          surface point xyz, original uv, original is sphere (0/1); the
//          table (trwalk_common.cuh), its plane u8 codes (live 0) or f32
//          values (live 1).
// Output:  fout [3,R] f32: trans, t_prev, still walking (0/1).

#include "trwalk_common.cuh"

namespace {

using ptt::kTrChunk;
using ptt::kTrCta;

template <class Texel>
__global__ void __launch_bounds__(kTrCta)
trans_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ aux, ptt::TrTable<Texel> tb, int R,
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
  float trans, t_prev;
  bool walking;
  ptt::trans_lane(tb, s_bw, s_lut, steps_cap, textured != 0, ox, oy, oz, dx,
                  dy, dz, pd, is_pt, spx, spy, spz, ouvx, ouvy, osimple,
                  trans, t_prev, walking);
  if (in_range) {
    fout[i] = trans;
    fout[R + i] = t_prev;
    fout[2 * R + i] = walking ? 1.f : 0.f;
  }
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_trans_walk(const float* o, const float* d, const float* aux,
                              const float* bw, const float* rows,
                              const void* tex, const float* lut,
                              const int* pages, int R, int T, int wp,
                              int steps_cap, int textured, int live,
                              float* fout, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const dim3 grid((R + kTrCta - 1) / kTrCta);
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    trans_walk_kernel<float><<<grid, kTrCta, 0, stream>>>(
        o, d, aux, tb, R, steps_cap, textured, fout);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    trans_walk_kernel<unsigned char><<<grid, kTrCta, 0, stream>>>(
        o, d, aux, tb, R, steps_cap, textured, fout);
  }
  return (int)cudaGetLastError();
}
