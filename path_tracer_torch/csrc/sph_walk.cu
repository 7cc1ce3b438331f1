// Sphere block walk closest hit over SAH blocks of 128 spheres: every warp
// is an independent packet of 32 rays, and its launch writes the whole hit
// record, merging an optional triangle record.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_spheres.py::
// _sph_walk_kernel (launched by _sph_walk_launch, entry
// closest_hit_spheres_pallas with sph_use_blocks), which serves scenes of
// more than 512 spheres. Contract kept (with the plain version,
// ops/cuda_spheres.py):
//   - block gate on the [8, sbpad] AABB table: tf >= max(tn, 0),
//     tf > t_prev and block id >= 0, zero direction components inverted to
//     1e30; a block's spheres are the 128 sorted slots of its id;
//   - per sphere the TPU walk's naive quadratic, NOT the dense kernel's
//     form: oc = o - c, a = |d|^2, b = 2 oc.d, c = |oc|^2 - r^2,
//     disc = b^2 - 4ac, has = disc >= 0, sq = sqrt(has ? disc : 0),
//     inv2a = 1 / (2a), t1 = (-b - sq) inv2a, t2 = (-b + sq) inv2a; a root
//     is valid iff has, >= 0 and > t_prev; t = t1 if valid, else t2 if
//     valid, else +inf; backface = the far root alone is valid;
//   - TIE RULE: the lexicographic (t, sorted slot) minimum, so the visit
//     order decides nothing; a miss is t = +inf;
//   - pad slots (center 1e30, radius 0) overflow: b^2 and c are inf and
//     disc NaN, so has is false. IEEE semantics are kept: no fast math,
//     IEEE division and sqrt, and -fmad=false for the plain version's
//     rounding;
//   - a dead lane is t_prev = +inf; a warp of dead lanes skips the walk.
// The record is ops/intersect.py's HitRecord (write_sphere_record, shared
// with sphere_closest_hit.cu): t, kind 2 on a hit and 0 on a miss, prim =
// sph_smap[slot] on a hit and 0 on a miss, u = v = 0, backface; with a
// triangle record the lane keeps the triangle's fields unless the sphere's
// t is strictly smaller (merge_hits: the triangle wins ties).
//
// Bound on the card: arithmetic, about 25 flops per (ray, sphere) solve of
// each block a ray enters before its hit, plus a slab test (22 flops) per
// ray and block (62 blocks for 4,900 spheres); at few blocks the bytes of
// the rays and the records.
//
// Design: flat_common.cuh's warp walk; a CTA holds four warps that share
// nothing but the launch, and no CTA barrier sits anywhere in the kernel.
//   1. Gate: the warp stages its rays (with 1/(2a) and 4a) in its slice of
//      shared memory; lane c slab-tests block columns c, c + 32, ...
//      against the warp's 32 rays (unrolled), keeps the mask of the live
//      rays the column admits and, as its key, their nearest slab entry
//      clamped at 0. Admitted columns go into the warp's list with mask
//      and key (12 bytes a column).
//   2. Visit nearest key first (a warp argmin over the list, lowest entry
//      on equal keys), while the key is no farther than some open ray's
//      best t. A block is served to the rays of its mask whose own slab
//      entry is no farther than their best t, the cut widened by the
//      factor cut_widen (native.SPH_WALK_CUT_WIDEN, 1 + 2^-8): a root
//      rounds up to 2^-11.5 of t ahead of the true one on a grazing ray
//      (b^2 - 4ac cancels), so a lower-slot equal-t copy in a block whose
//      slab entry rounds past the lane's best t is still served. Widening
//      only adds visits, which cannot change a lexicographic minimum.
//   3. Inside a block, by the number k of rays served:
//      (A) k >= lane_wise (native.SPH_WALK_LANE_WISE): lane per ray,
//          each served lane solving the block's spheres in slot order,
//          the table read through the read-only cache with every lane on
//          the same column (a broadcast); 32 x 128 lane slots whatever k;
//      (B) fewer: the block over the warp, lane l holding spheres l,
//          l + 32, l + 64, l + 96 in registers (16 floats, coalesced); the
//          served rays one after another, each lane testing its four
//          spheres, a ballot of the lanes whose (t, slot) beats the served
//          ray's best, a warp (t, slot) minimum when several do, the served
//          lane taking the winner: 128 lane slots and a reduction a ray.
//      Both give the lexicographic (t, slot) minimum over the served rays,
//      so the choice decides nothing but the time. Both stop at the
//      block's last real sphere (a ballot over its slots): the pads after
//      it (center 1e30, radius 0) overflow and never hit, and scene B's
//      blocks hold 79 real spheres on average.
//   4. Each lane writes its record, prim through sph_smap, merging the
//      triangle record (no ATen op after the launch).
// The design it replaced, a CTA of 128 rays sharing one cursor behind CTA
// barriers, each visit staging the block in shared memory for the whole
// CTA, was timed against it in turns (PERF.md §6).
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; blk [8,sbpad] f32; blkid
//          [sbpad] i32; sph [4, n_slots] f32 (block b = columns
//          [b*128, (b+1)*128)); smap [n_slots] i32; optional triangle
//          record tri_t, tri_u, tri_v [R] f32, tri_kind, tri_prim [R] i32,
//          tri_back [R] u8 (all null for none); lane_wise, the rays of
//          need from which a block is served lane per ray (step 3; 33
//          serves every block over the warp); cut_widen, step 2's factor.
// Outputs: fout [3,R] f32 rows (t, u, v); iout [2,R] i32 rows (kind,
//          prim); bout [R] u8 backface.

#include "flat_common.cuh"

namespace {

using ptt::kFullMask;

constexpr int kWarps = 4;      // warps (packets) per CTA
constexpr int kSlots = 128;    // spheres per block
constexpr float kPadCenter = 1e30f;  // a pad slot's center coordinates
// The warp's staged rays: flat_common's rows, then 1/(2a) and 4a.
constexpr int kRows = ptt::kWarpRayRows + 2;
constexpr int kRowInv2a = ptt::kWarpRayRows * 32;
constexpr int kRowFourA = kRowInv2a + 32;

// Shared memory of one warp: its staged rays, then the listed columns,
// their ray masks and their keys.
__host__ __device__ constexpr size_t warp_floats(int sbpad) {
  return (size_t)kRows * 32 + 3 * (size_t)sbpad;
}

// The walk's root of one sphere (the naive quadratic above): t, +inf on a
// miss, and *far when the far root alone is valid.
__device__ __forceinline__ float walk_root(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float four_a, float inv2a,
                                           float tp, float cx, float cy,
                                           float cz, float rad, bool& far) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - four_a * cc;
  far = false;
  if (!(disc >= 0.f)) return CUDART_INF_F;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * inv2a;
  const float t2 = (-b + sq) * inv2a;
  const bool v1 = t1 >= 0.f && t1 > tp;
  const bool v2 = t2 >= 0.f && t2 > tp;
  far = !v1 && v2;
  return v1 ? t1 : (v2 ? t2 : CUDART_INF_F);
}

__global__ void __launch_bounds__(32 * kWarps, 4)
sph_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_prev,
                const float* __restrict__ blk, const int* __restrict__ blkid,
                const float* __restrict__ sph, const int* __restrict__ smap,
                int R, int sbpad, int n_slots, int lane_wise,
                float cut_widen, ptt::TriRecord tri,
                float* __restrict__ fout, int* __restrict__ iout,
                unsigned char* __restrict__ bout) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_ray = smem + warp * warp_floats(sbpad);  // [kRows][32]
  int* s_col = reinterpret_cast<int*>(s_ray + kRows * 32);       // [sbpad]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + sbpad);  // [sbpad]
  float* s_key = reinterpret_cast<float*>(s_mask + sbpad);        // [sbpad]

  const int i = (blockIdx.x * (blockDim.x >> 5) + warp) * 32 + lane;
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

  float bt = CUDART_INF_F;
  bool bb = false;
  int bi = -1;
  if (__ballot_sync(kFullMask, live)) {
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv2a = 1.0f / (2.0f * a);
    const float four_a = 4.0f * a;
    s_ray[kRowInv2a + lane] = inv2a;
    s_ray[kRowFourA + lane] = four_a;
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tp);
    const float ix = s_ray[96 + lane], iy = s_ray[128 + lane],
                iz = s_ray[160 + lane];

    // 1. The columns some live ray's gate admits (a dead ray's t_prev
    //    fails it), with their masks and keys.
    int m = 0;
    for (int c0 = 0; c0 < sbpad; c0 += 32) {
      const int c = c0 + lane;
      unsigned mask = 0u;
      float key = CUDART_INF_F;
      if (c < sbpad && blkid[c] >= 0)
        mask = ptt::warp_gate_mask_key(ptt::load_box(blk, sbpad, c), s_ray,
                                       gate, key);
      const unsigned any = __ballot_sync(kFullMask, mask != 0u);
      if (mask) {
        const int p = m + __popc(any & ((1u << lane) - 1u));
        s_col[p] = c;
        s_mask[p] = mask;
        s_key[p] = key;
      }
      m += __popc(any);
    }
    __syncwarp();

    // 2. The visits, nearest key first; a visited entry's key becomes NaN,
    //    which no comparison selects again.
    while (true) {
      float key = CUDART_INF_F;
      int p = INT_MAX;
      for (int q = lane; q < m; q += 32) {
        const float k = s_key[q];
        if (k < key || (k == key && q < p)) { key = k; p = q; }
      }
      float reach = live ? bt * cut_widen : -CUDART_INF_F;
      for (int off = 16; off > 0; off >>= 1) {
        const float k2 = __shfl_xor_sync(kFullMask, key, off);
        const int p2 = __shfl_xor_sync(kFullMask, p, off);
        if (k2 < key || (k2 == key && p2 < p)) { key = k2; p = p2; }
        reach = fmaxf(reach, __shfl_xor_sync(kFullMask, reach, off));
      }
      if (p == INT_MAX || !(key <= reach)) break;
      __syncwarp();  // every lane has read s_key before it changes
      if (lane == 0) s_key[p] = CUDART_NAN_F;
      const int c = s_col[p];
      bool need_l = false;
      if ((s_mask[p] >> lane) & 1u) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, sbpad, c), ox, oy, oz, ix, iy, iz, tn,
                  tf);
        need_l = tn <= bt * cut_widen;
      }
      __syncwarp();  // lane 0's mark is seen by the next argmin
      const unsigned need = __ballot_sync(kFullMask, need_l);
      if (!need) continue;
      const int start = blkid[c] * kSlots;
      const float* src = sph + start;
      // The block, lane l holding slots l + 32 q (3B's registers). Its
      // slots past the last real sphere are pads (center 1e30, radius 0),
      // whose solve overflows to a NaN discriminant and never hits: both
      // layouts stop at n_real.
      float cx[4], cy[4], cz[4], cr[4];
      int n_real = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* s = src + q * 32 + lane;
        cx[q] = __ldg(s);
        cy[q] = __ldg(s + n_slots);
        cz[q] = __ldg(s + 2 * (size_t)n_slots);
        cr[q] = __ldg(s + 3 * (size_t)n_slots);
        const unsigned real = __ballot_sync(
            kFullMask, !(cx[q] == kPadCenter && cy[q] == kPadCenter &&
                         cz[q] == kPadCenter && cr[q] == 0.f));
        if (real) n_real = q * 32 + 32 - __clz(real);
      }
      if (__popc(need) >= lane_wise) {
        // 3A. Lane per ray: every lane reads the same column; the sphere
        // loop unrolled, so the solves of four spheres overlap.
        if (need_l) {
#pragma unroll 4
          for (int j = 0; j < n_real; ++j) {
            bool far;
            const float t = walk_root(
                ox, oy, oz, dx, dy, dz, four_a, inv2a, tp, __ldg(src + j),
                __ldg(src + n_slots + j), __ldg(src + 2 * (size_t)n_slots + j),
                __ldg(src + 3 * (size_t)n_slots + j), far);
            if (t < bt || (t == bt && start + j < bi)) {
              bt = t; bb = far; bi = start + j;
            }
          }
        }
        continue;
      }
      // 3B. The block over the warp.
      for (unsigned mm = need; mm; mm &= mm - 1) {
        const int s = __ffs(mm) - 1;  // the served ray
        const float sox = s_ray[s], soy = s_ray[32 + s], soz = s_ray[64 + s],
                    stp = s_ray[ptt::kRowG + s],
                    sdx = s_ray[ptt::kRowD + s],
                    sdy = s_ray[ptt::kRowD + 32 + s],
                    sdz = s_ray[ptt::kRowD + 64 + s],
                    sinv2a = s_ray[kRowInv2a + s],
                    sfour_a = s_ray[kRowFourA + s];
        const float sbt = __shfl_sync(kFullMask, bt, s);
        const int sbi = __shfl_sync(kFullMask, bi, s);
        float lt = CUDART_INF_F;
        bool lf = false;
        int ls = INT_MAX;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q * 32 >= n_real) break;  // pads only from here
          bool far;
          const float t = walk_root(sox, soy, soz, sdx, sdy, sdz, sfour_a,
                                    sinv2a, stp, cx[q], cy[q], cz[q], cr[q],
                                    far);
          if (t < lt) {  // slots rise with q: the lower slot keeps ties
            lt = t; lf = far; ls = start + q * 32 + lane;
          }
        }
        // A candidate beats the served ray's best (t, slot).
        const bool cand = lt < sbt || (lt == sbt && lt < CUDART_INF_F &&
                                       ls < sbi);
        const unsigned hm = __ballot_sync(kFullMask, cand);
        if (!hm) continue;
        int from = __ffs(hm) - 1;
        if (hm & (hm - 1)) {  // several candidate lanes: the (t, slot) min
          float wt = cand ? lt : CUDART_INF_F;
          int ws = cand ? ls : INT_MAX, wl = lane;
          ptt::warp_min_hit(wt, ws, wl);
          from = wl;
        }
        const float wt = __shfl_sync(kFullMask, lt, from);
        const int ws = __shfl_sync(kFullMask, ls, from);
        const int wf = __shfl_sync(kFullMask, (int)lf, from);
        if (lane == s) { bt = wt; bb = wf != 0; bi = ws; }
      }
    }
  }
  if (in_range) {
    const bool hit = bt < CUDART_INF_F;
    ptt::write_sphere_record(tri, i, R, bt, hit ? smap[bi] : 0, hit && bb,
                             fout, iout, bout);
  }
}

}  // namespace

extern "C" int ptt_sph_walk(const float* o, const float* d,
                            const float* t_prev, const float* blk,
                            const int* blkid, const float* sph,
                            const int* smap, const float* tri_t,
                            const float* tri_u, const float* tri_v,
                            const int* tri_kind, const int* tri_prim,
                            const unsigned char* tri_back, int R, int sbpad,
                            int n_slots, int lane_wise, float cut_widen,
                            float* fout, int* iout,
                            unsigned char* bout, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  int warps = kWarps;
  size_t smem;
  err = ptt::warp_walk_smem(sph_walk_kernel,
                            warp_floats(sbpad) * sizeof(float), warps, smem);
  if (err != cudaSuccess) return (int)err;
  const ptt::TriRecord tri{tri_t, tri_u, tri_v, tri_kind, tri_prim, tri_back};
  const int rays = 32 * warps;
  const int blocks = (R + rays - 1) / rays;
  sph_walk_kernel<<<blocks, rays, smem, stream>>>(
      o, d, t_prev, blk, blkid, sph, smap, R, sbpad, n_slots, lane_wise,
      cut_widen, tri, fout, iout, bout);
  return (int)cudaGetLastError();
}
