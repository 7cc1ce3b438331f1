// Fused shadow: the flat any-hit over the opaque partition and the
// transmittance walk over the transparent table, for all L lights of a
// bounce in one launch.
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
// Each phase is its kernel's own code (flat_common.cuh's warp walk as
// flat_occluded.cu runs it, trwalk_common.cuh's trans_lane), so the fused
// kernel equals flat_occluded + trans_walk launched apart on every lane.
//
// Bound on the card: arithmetic, the sum of the two kernels' (the slab and
// Baldwin-Weber tests of the opaque blocks a lane enters, then the
// Baldwin-Weber test of the transparent columns in the groups each lane
// the any-hit left open enters). What fusing saves is the second launch,
// the [L*R] stacked copies of the origins, surface points and uvs the
// two-launch caller builds, and the [L,R] blocked mask between the two.
//
// Design: trans_walk.cu's persistent CTA, which stages the transparent
// table, its widened group boxes and the LUT in shared memory once
// (trwalk_common.cuh's stage_resident: the kernel's only barrier); beside
// the table, each warp has its own slice for its staged rays (1.25 KB: at
// most 4,096 columns, the whole always fits). Each warp then takes units
// of 32 consecutive rays of one light on its own, the next unit from a
// counter the wrapper zeroes (a warp that finishes early takes more: the
// walk's cost varies widely from unit to unit; handing units out in a
// fixed stride made the kernel 1.16x slower on the textured showcase's
// first-bounce shadow lanes):
//   1. any-hit, flat_occluded.cu's warp packet without its list: the warp
//      stages its rays, gates 32 block columns of the opaque view at a
//      time against the rays still open (flat_common.cuh warp_gate_mask,
//      on widened boxes; lane c one column) and visits each admitted
//      column at once, in column order, with warp_any_block; it stops as
//      soon as no ray is open, so no column is gated after that. The
//      result does not depend on the visit order, so it equals
//      flat_occluded.cu's, which lists every admitted column first;
//   2. walk, trans_walk.cu's per-lane trans_lane on the resident table,
//      with pd = -1 for the lanes found occluded.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max, pd [L,R] f32; aux [6,R] f32
//          (surface point xyz, original uv, original is sphere 0/1); the
//          opaque view's flat tables; the transparent table
//          (trwalk_common.cuh) with its group boxes grp [7, gp], its plane
//          u8 codes (live 0) or f32 values (live 1); next: a zeroed
//          counter of units.
// Output:  out [3L,R] f32.

#include "trwalk_common.cuh"

namespace {

using ptt::kFullMask;
using ptt::kResThreads;

template <class Texel>
__global__ void __launch_bounds__(kResThreads, 2)
fused_shadow_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ pd,
                    const float* __restrict__ aux, unsigned long long is_pt,
                    ptt::FlatTable ft, ptt::TrTable<Texel> tb,
                    const float* __restrict__ grp, int gp, int R, int L,
                    int steps_cap, int textured, unsigned* __restrict__ next,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const ptt::Resident rs = ptt::stage_resident(tb, grp, gp, smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bpad = ft.bpad;
  float* s_ray = smem + ptt::resident_smem(tb.T) / sizeof(float) +
                 warp * ptt::kWarpRayRows * 32;

  const int per_light = (R + 31) / 32;
  for (;;) {
    // Units of 32 rays of one light in ascending order, the next one to
    // whichever warp is free (the zeroed counter 'next').
    int unit = 0;
    if (lane == 0) unit = (int)atomicAdd(next, 1u);
    unit = __shfl_sync(kFullMask, unit, 0);
    if (unit >= per_light * L) break;
    const int li = unit / per_light;
    const int i = (unit - li * per_light) * 32 + lane;
    const size_t lane_idx = (size_t)li * R + i;  // (light, ray)
    ptt::TrRay r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    float tm = -1.f, pdv = -1.f, spx = 0.f, spy = 0.f, spz = 0.f,
          ouvx = 0.f, ouvy = 0.f;
    bool osimple = false;
    if (i < R) {
      r = ptt::TrRay{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                     d[3 * lane_idx], d[3 * lane_idx + 1],
                     d[3 * lane_idx + 2]};
      tm = t_max[lane_idx];
      pdv = pd[lane_idx];
      spx = aux[i]; spy = aux[R + i]; spz = aux[2 * R + i];
      ouvx = aux[3 * R + i]; ouvy = aux[4 * R + i];
      osimple = aux[5 * R + i] > 0.f;
    }

    // 1. The any-hit: the rays not yet found occluded; a dead lane
    //    (t_max < 0) is never open and reports occluded. The block columns
    //    are gated 32 at a time against the open rays, and each admitted
    //    column is visited at once, in column order, until no ray is open.
    const ptt::OccludedGate gate;
    unsigned open = __ballot_sync(kFullMask, gate.live(tm));
    if (open) {
      ptt::stage_warp_rays(s_ray, lane, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                           tm);
      for (int c0 = 0; c0 < bpad && open; c0 += 32) {
        const int c = c0 + lane;
        unsigned mask = 0u;
        if (c < bpad && ft.blkid[c] >= 0)
          mask = ptt::warp_gate_mask(ptt::load_box(ft.blk, bpad, c), s_ray,
                                     gate) & open;
        for (unsigned cols = __ballot_sync(kFullMask, mask != 0u);
             cols && open; cols &= cols - 1) {
          const int p = __ffs(cols) - 1;
          const unsigned need = __shfl_sync(kFullMask, mask, p) & open;
          if (need)
            open &= ~ptt::warp_any_block(ft.bw, ft.blkid[c0 + p], ft.block,
                                         ft.n_cols, need, s_ray, lane);
        }
      }
      __syncwarp();  // the next unit restages s_ray
    }
    const bool occ = !((open >> lane) & 1u);

    // 2. The walk, for the lanes the any-hit left open.
    const float pd_eff = occ ? -1.f : pdv;
    float trans = 1.f, t_prev = -1.f;
    bool walking = false;
    if (__any_sync(kFullMask, pd_eff >= 0.f))
      ptt::trans_lane(tb, rs, steps_cap, textured != 0, r, pd_eff,
                      (is_pt >> li) & 1ull, spx, spy, spz, ouvx, ouvy,
                      osimple, trans, t_prev, walking);
    if (i < R) {
      const size_t row = (size_t)3 * li * R + i;
      out[row] = occ ? 0.f : trans;
      out[row + R] = t_prev;
      out[row + 2 * (size_t)R] = walking ? 1.f : 0.f;
    }
  }
}

template <class Texel>
int launch(const float* o, const float* d, const float* t_max,
           const float* pd, const float* aux, unsigned long long is_pt_mask,
           const ptt::FlatTable& ft, const ptt::TrTable<Texel>& tb,
           const float* grp, int gp, int R, int L, int steps_cap,
           int textured, unsigned* next, float* out, int device,
           cudaStream_t stream) {
  // The table, then each warp's staged rays.
  const size_t smem = ptt::resident_smem(tb.T) + kResThreads *
                      ptt::kWarpRayRows * sizeof(float);
  int blocks;
  cudaError_t err = ptt::resident_launch_shape(
      fused_shadow_kernel<Texel>, smem, kResThreads, L * ((R + 31) / 32),
      device, blocks);
  if (err != cudaSuccess) return (int)err;
  fused_shadow_kernel<Texel><<<blocks, kResThreads, smem, stream>>>(
      o, d, t_max, pd, aux, is_pt_mask, ft, tb, grp, gp, R, L, steps_cap,
      textured, next, out);
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
                                const float* lut, const int* pages,
                                const float* grp, int T, int gp, int wp,
                                int R, int L, int steps_cap, int textured,
                                int live, unsigned* next, float* out,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  if (block <= 0 || block % ptt::kWarpChunk ||
      !ptt::resident_table_ok(T, gp))
    return (int)cudaErrorInvalidValue;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  if (live) {
    const ptt::TrTable<float> tb{tr_bw, tr_rows,
                                 static_cast<const float*>(tex), lut, pages,
                                 T, wp};
    return launch(o, d, t_max, pd, aux, is_pt_mask, ft, tb, grp, gp, R, L,
                  steps_cap, textured, next, out, device, stream);
  }
  const ptt::TrTable<unsigned char> tb{
      tr_bw, tr_rows, static_cast<const unsigned char*>(tex), lut, pages, T,
      wp};
  return launch(o, d, t_max, pd, aux, is_pt_mask, ft, tb, grp, gp, R, L,
                steps_cap, textured, next, out, device, stream);
}
