// Fused shadow: the flat any-hit over the opaque partition and the
// transmittance walk over the transparent table, for all L lights of a
// bounce in one launch, one thread per (ray, light).
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_shadow.py::
// _shadow_kernel (launched by _shadow_launch, entry fused_shadow), which
// runs pallas_bvh.flat_occ_set and pallas_trwalk.trans_tile per tile and
// light, in both its variants: live=False (u8 texel codes through the LUT)
// and live=True (training: the live opacity-factor row and an f32 plane of
// live texel values in the walk phase), a template on the plane's texel
// type as trans_walk.cu is. Contract kept (with the plain version,
// ops/cuda_shadow.py fused_shadow_plain, on the same tables): per lane of
// light li,
//   - occ = the flat any-hit of flat_occluded.cu on the opaque view's block
//     tables with the lane's t_max (a dead lane, t_max < 0, is occluded);
//   - the transmittance walk of trans_walk.cu with pd_eff = -1 where occ,
//     else pd (-1 marks a lane that does not walk, +inf a directional
//     light), as a point lane when bit li of is_pt_mask is set;
//   - out rows 3 li + 0, 1, 2: trans_eff = 0 where occ, else the walk's
//     trans; its t_prev; still walking (0/1).
// Both phases are CTA walks: flat_common.cuh's flat_occ_set and
// trwalk_common.cuh's trans_lane_cta, the designs flat_occluded.cu and
// trans_walk.cu replaced; each keeps its kernel's contract, so the fused
// kernel equals flat_occluded + trans_walk on every lane.
//
// Bound on the card: arithmetic, the sum of the two kernels' (the slab and
// Baldwin-Weber tests of the opaque blocks a lane enters, then the
// Baldwin-Weber test of every transparent column per walk pass of each lane
// the any-hit left open). Design: blockIdx.y picks the light, a CTA is 128
// consecutive rays of it, as in both kernels; what fusing saves is the
// second launch, the [L*R] stacked copies of the origins, surface points
// and uvs the two-launch caller builds, and the [L,R] blocked mask between
// the two. The two phases reuse one dynamic shared buffer, sized for the
// larger: the any-hit's staged block, column keys and rays, or the walk's
// 256-column chunk and the LUT.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max, pd [L,R] f32; aux [6,R] f32
//          (surface point xyz, original uv, original is sphere 0/1); the
//          opaque view's flat tables; the transparent table
//          (trwalk_common.cuh), its plane u8 codes (live 0) or f32 values
//          (live 1).
// Output:  out [3L,R] f32.

#include "trwalk_common.cuh"

namespace {

using ptt::kCtaRays;
static_assert(ptt::kTrCta == kCtaRays, "one CTA shape for both phases");

template <class Texel>
__global__ void __launch_bounds__(kCtaRays)
fused_shadow_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ pd,
                    const float* __restrict__ aux, unsigned long long is_pt,
                    ptt::FlatTable ft, ptt::TrTable<Texel> tb, int R,
                    int steps_cap, int textured, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_red[3 * (kCtaRays / 32)];

  const int li = blockIdx.y;
  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  const size_t lane = (size_t)li * R + i;  // (light, ray)
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f, pdv = -1.f, spx = 0.f, spy = 0.f, spz = 0.f, ouvx = 0.f,
        ouvy = 0.f;
  bool osimple = false;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * lane]; dy = d[3 * lane + 1]; dz = d[3 * lane + 2];
    tm = t_max[lane];
    pdv = pd[lane];
    spx = aux[i]; spy = aux[R + i]; spz = aux[2 * R + i];
    ouvx = aux[3 * R + i]; ouvy = aux[4 * R + i];
    osimple = aux[5 * R + i] > 0.f;
  }
  const bool occ =
      ptt::flat_occ_set(ft, ox, oy, oz, dx, dy, dz, tm, smem, s_red);

  float* s_bw = smem;                          // [12][kTrChunk]
  float* s_lut = smem + 12 * ptt::kTrChunk;    // [256]
  ptt::stage_lut(tb.lut, s_lut);
  float trans, t_prev;
  bool walking;
  ptt::trans_lane_cta(tb, s_bw, s_lut, steps_cap, textured != 0, ox, oy, oz,
                      dx, dy, dz, occ ? -1.f : pdv, (is_pt >> li) & 1ull,
                      spx, spy, spz, ouvx, ouvy, osimple, trans, t_prev,
                      walking);
  if (in_range) {
    const size_t row = (size_t)3 * li * R + i;
    out[row] = occ ? 0.f : trans;
    out[row + R] = t_prev;
    out[row + 2 * (size_t)R] = walking ? 1.f : 0.f;
  }
}

template <class Texel>
int launch(const float* o, const float* d, const float* t_max,
           const float* pd, const float* aux, unsigned long long is_pt_mask,
           const ptt::FlatTable& ft, const ptt::TrTable<Texel>& tb, int R,
           int L, int steps_cap, int textured, float* out,
           cudaStream_t stream) {
  // One buffer for both phases: the any-hit's block, keys and rays, or
  // the walk's chunk and LUT.
  const int staged = 12 * ft.block > ptt::kTransSmemFloats
                         ? 12 * ft.block : ptt::kTransSmemFloats;
  size_t smem;
  cudaError_t err = ptt::walk_smem(fused_shadow_kernel<Texel>, staged,
                                   ft.bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  fused_shadow_kernel<Texel><<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, steps_cap, textured, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_fused_shadow(const float* o, const float* d,
                                const float* t_max, const float* pd,
                                const float* aux,
                                unsigned long long is_pt_mask,
                                const float* blk, const int* blkid,
                                const float* bw, int bpad, int block,
                                int n_cols, const float* tr_bw,
                                const float* tr_rows, const void* tex,
                                const float* lut, const int* pages, int T,
                                int wp, int R, int L, int steps_cap,
                                int textured, int live, float* out,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  if (live) {
    const ptt::TrTable<float> tb{tr_bw, tr_rows,
                                 static_cast<const float*>(tex), lut, pages,
                                 T, wp};
    return launch(o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, L, steps_cap,
                  textured, out, stream);
  }
  const ptt::TrTable<unsigned char> tb{
      tr_bw, tr_rows, static_cast<const unsigned char*>(tex), lut, pages, T,
      wp};
  return launch(o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, L, steps_cap,
                textured, out, stream);
}
