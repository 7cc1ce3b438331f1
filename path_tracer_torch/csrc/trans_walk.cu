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
// Bound on the card: arithmetic, the Baldwin-Weber test of the columns in
// the 128-column groups each live lane's unbounded segment enters, once a
// lane (bytes are the lanes' 64 bytes in and 12 out, and the table read
// once); this design tests a point lane's columns twice. Design: trwalk_common.cuh's
// resident walk, as alpha_walk.cu: a persistent CTA of 256 threads stages
// the table, the group boxes and the LUT in shared memory once; each warp
// takes units of 32 lanes on its own with no barrier. The per-lane body is
// trwalk_common.cuh's trans_lane: a lane gates the groups with tr_grp (on
// the widening alpha_walk.cu describes); a
// point lane makes the cut pass and the product pass over the admitted
// columns; a directional lane of a textured scene collects its K =
// min(steps_cap, 8) nearest distinct candidates in one pass and steps
// through them. The product multiplies in ascending column order where the
// Pallas kernel used a butterfly. Row 15 (fused_shadow.cu) runs the same
// trans_lane after its any-hit.
//
// Inputs:  o, d [R,3] f32; aux [8,R] f32: pd (-1 dead), is point (0/1),
//          surface point xyz, original uv, original is sphere (0/1); the
//          table (trwalk_common.cuh) with its group boxes grp [7, gp], its
//          plane u8 codes (live 0) or f32 values (live 1).
// Output:  fout [3,R] f32: trans, t_prev, still walking (0/1).

#include "trwalk_common.cuh"

namespace {

using ptt::kResThreads;

template <class Texel>
__global__ void __launch_bounds__(kResThreads, 2)
trans_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ aux, ptt::TrTable<Texel> tb,
                  const float* __restrict__ grp, int gp, int R,
                  int steps_cap, int textured, float* __restrict__ fout) {
  extern __shared__ float4 smem4[];
  const ptt::Resident rs =
      ptt::stage_resident(tb, grp, gp, reinterpret_cast<float*>(smem4));
  const int n_units = (R + 31) / 32, warps = kResThreads / 32;
  for (int unit = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       unit < n_units; unit += gridDim.x * warps) {
    const int i = unit * 32 + (threadIdx.x & 31);
    ptt::TrRay r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    float pd = -1.f, spx = 0.f, spy = 0.f, spz = 0.f, ouvx = 0.f, ouvy = 0.f;
    bool is_pt = false, osimple = false;
    if (i < R) {
      r = ptt::TrRay{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                     d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      pd = aux[i];
      is_pt = aux[R + i] > 0.f;
      spx = aux[2 * R + i]; spy = aux[3 * R + i]; spz = aux[4 * R + i];
      ouvx = aux[5 * R + i]; ouvy = aux[6 * R + i];
      osimple = aux[7 * R + i] > 0.f;
    }
    float trans = 1.f, t_prev = -1.f;
    bool walking = false;
    if (__any_sync(0xffffffffu, pd >= 0.f))
      ptt::trans_lane(tb, rs, steps_cap, textured != 0, r, pd, is_pt, spx,
                      spy, spz, ouvx, ouvy, osimple, trans, t_prev, walking);
    if (i < R) {
      fout[i] = trans;
      fout[R + i] = t_prev;
      fout[2 * R + i] = walking ? 1.f : 0.f;
    }
  }
}

template <class Texel>
cudaError_t launch(const float* o, const float* d, const float* aux,
                   const ptt::TrTable<Texel>& tb, const float* grp, int gp,
                   int R, int steps_cap, int textured, float* fout,
                   int device, cudaStream_t stream) {
  size_t smem;
  int blocks;
  const cudaError_t err = ptt::resident_walk_shape(
      trans_walk_kernel<Texel>, tb.T, R, device, smem, blocks);
  if (err != cudaSuccess) return err;
  trans_walk_kernel<Texel><<<blocks, kResThreads, smem, stream>>>(
      o, d, aux, tb, grp, gp, R, steps_cap, textured, fout);
  return cudaGetLastError();
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_trans_walk(const float* o, const float* d, const float* aux,
                              const float* bw, const float* rows,
                              const void* tex, const float* lut,
                              const int* pages, const float* grp, int R,
                              int T, int gp, int wp, int steps_cap,
                              int textured, int live, float* fout,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (!ptt::resident_table_ok(T, gp)) return (int)cudaErrorInvalidValue;
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    err = launch(o, d, aux, tb, grp, gp, R, steps_cap, textured, fout,
                 device, stream);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    err = launch(o, d, aux, tb, grp, gp, R, steps_cap, textured, fout,
                 device, stream);
  }
  return (int)err;
}
