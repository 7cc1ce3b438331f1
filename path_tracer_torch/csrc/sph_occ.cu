// Sphere any-hit for L direction sets that share one origin set (a bounce's
// shadow casts toward L lights): a dense pass over every sphere, one thread
// per ray for all L sets, and a block walk over SAH blocks of 128 spheres
// in warp packets of 32 (ray, set) lanes.
//
// Replaces the TPU kernels path_tracer_tpu/ops/pallas_spheres.py::
// _occ_kernel (the dense any-hit, launched by _occ_launch) and
// _sph_occ_walk_kernel (the block walk, launched by _sph_occ_walk_launch),
// both behind occluded_spheres_pallas; the walk serves scenes of more than
// 512 spheres (sph_use_blocks). Contract kept (with the plain version,
// ops/cuda_spheres.py occluded_spheres_plain):
//   - a ray is occluded when some sphere has a root t with 0 <= t <= t_max,
//     in the TPU kernels' naive quadratic: oc = o - c, a = |d|^2,
//     b = 2 oc.d, c = |oc|^2 - r^2, disc = b^2 - 4ac, has = disc >= 0,
//     sq = sqrt(disc), inv2a = 1 / (2a), t1 = (-b - sq) inv2a,
//     t2 = (-b + sq) inv2a. IEEE semantics are kept: no fast math, IEEE
//     division and sqrt, and -fmad=false for the plain version's rounding;
//   - pad slots (center 1e30, radius 0) overflow: disc is NaN or -inf, so
//     has is false;
//   - a dead lane is t_max < 0 and is NOT occluded by a sphere on both
//     kernels (pallas_spheres.py:532-536), unlike the triangle any-hit;
//   - walk block gate on the [8, sbpad] AABB table: tf >= max(tn, 0),
//     tn <= t_max, t_max >= 0 and block id >= 0, zero direction components
//     inverted to 1e30, each box widened by pad_box and each lane's
//     interval by pad_slab (flat_common.cuh WidenedOccludedGate; the plain
//     version's slab.padded_slab). On the exact boxes a ray aimed where a
//     sphere touches a face of its block's box can round its entry tn past
//     the root's t, and a lane that tests only the blocks its own gate
//     admits then loses that occluder; the Pallas kernel hides it, since
//     it tests every lane of its 128-ray tile against every block some
//     lane admits. A root in [0, t_max] occludes whichever block holds it,
//     so widening only adds tests and changes no correct result. A block's
//     spheres are the 128 sorted slots of its id;
//   - the result does not depend on the visit order (any root counts).
// Both kernels fold in the triangle any-hit's result: with a prior [L,R]
// (1 = occluded), a set's output is prior | spheres, and a set whose prior
// is set costs no sphere test. A dead lane writes its prior (the triangle
// any-hit reports dead lanes occluded), or 0 without one; the caller masks
// dead lanes.
//
// Bound on the card: arithmetic, about 25 flops per (ray, sphere) test (a
// sqrt and one multiply by the lane's 1/(2a) per valid discriminant), each
// lane stopping at its first occluder; the walk adds a slab test per block.
// Design of the dense kernel: one thread per ray runs all L sets (L up to
// kMaxSets, a template parameter, so the sets' directions, t_max, 4a and
// 1/(2a) stay in registers; the wrapper launches once per kMaxSets sets). Per
// sphere, oc and cc = |oc|^2 - r^2, which depend on the shared origin alone,
// are computed once; b, disc and the roots per set still open. A set is closed
// when it is occluded, dead or set in prior (no sphere test), and the lane
// stops when none is open. The [4, S] table is read through the read-only
// cache, every lane of a warp on the same column (a broadcast): no shared
// memory and no barrier. The design it replaced (one thread per (ray, set),
// the table staged 512 columns at a time behind CTA barriers) was timed
// against it in turns (PERF.md §6).
// Design of the walk: flat_common.cuh's warp walk, as sph_walk.cu's; a CTA
// holds four warps that share nothing but the launch (blockIdx.y picks the
// set), and no CTA barrier sits anywhere in the kernel. A lane is open
// while it is live (t_max >= 0), its prior is not set and no occluder is
// found.
//   1. Gate: the warp stages its rays (with 1/(2a) and 4a) in its slice of
//      shared memory; lane c slab-tests block columns c, c + 32, ...
//      against the warp's 32 rays on the widened boxes and intervals,
//      keeps the mask of the open rays the column admits and, as its key,
//      the nearest slab entry clamped at 0. Admitted columns go into the
//      warp's list with mask and key (12 bytes a column).
//   2. Visit the listed columns nearest key first (lowest entry on equal
//      keys) while some lane of a column's mask is open; a block is served
//      to the open lanes of its mask alone.
//   3. Inside a block, by the number k of lanes served: from lane_wise
//      (native.SPH_OCC_WALK_LANE_WISE) lane per ray, each served lane
//      solving the block's spheres in slot order up to its first root in
//      [0, t_max], the table read as broadcasts through the read-only
//      cache; fewer, the block over the warp, lane l holding spheres l,
//      l + 32, l + 64, l + 96 in registers and the served rays tested one
//      after another, an __any_sync closing each. Both stop at the block's
//      last real sphere (a ballot over its slots: the pads after it never
//      occlude) and give one result.
//   4. A lane closes at its first root in [0, t_max]; the warp stops when
//      no lane is open, and each lane writes prior | occluded as a byte (no
//      ATen op after the launch).
// The design it replaced, a CTA of 128 rays sharing one cursor behind CTA
// barriers, each visit staging the block in shared memory for the whole
// CTA, f32 output and the prior ORed in ATen, was timed against it in turns
// (PERF.md §6) and then removed.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; prior [L,R] u8 or
//          null; dense: sph [4, ld] f32 of which the first S columns are
//          tested; walk: blk [8,sbpad] f32, blkid [sbpad] i32, sph
//          [4, n_slots] f32 sorted (block b = columns [b*128, (b+1)*128)),
//          lane_wise (1 to 33; 33 serves every block over the warp).
// Output:  out [L,R] u8 (a bool tensor's bytes), 1 = occluded.

#include "flat_common.cuh"

namespace {

using ptt::kFullMask;

constexpr int kMaxSets = 8;          // sets the dense kernel takes
constexpr int kDenseThreads = 256;   // rays per CTA of the dense kernel

template <int L>
__global__ void __launch_bounds__(kDenseThreads)
sph_occ_dense_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const unsigned char* __restrict__ prior,
                     const float* __restrict__ sph, int R, int S, int ld,
                     unsigned char* __restrict__ out) {
  const int i = blockIdx.x * kDenseThreads + threadIdx.x;
  if (i >= R) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  float dx[L], dy[L], dz[L], tm[L], four_a[L], inv2a[L];
  unsigned open = 0u, occ = 0u;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const size_t idx = (size_t)k * R + i;
    dx[k] = d[3 * idx]; dy[k] = d[3 * idx + 1]; dz[k] = d[3 * idx + 2];
    tm[k] = t_max[idx];
    const float a = dx[k] * dx[k] + dy[k] * dy[k] + dz[k] * dz[k];
    inv2a[k] = 1.0f / (2.0f * a);
    four_a[k] = 4.0f * a;
    if (prior && prior[idx])
      occ |= 1u << k;
    else if (tm[k] >= 0.f)  // a dead lane has no root in [0, t_max]
      open |= 1u << k;
  }
  for (int j = 0; j < S && open; ++j) {
    const float ocx = ox - __ldg(sph + j);
    const float ocy = oy - __ldg(sph + ld + j);
    const float ocz = oz - __ldg(sph + 2 * ld + j);
    const float rad = __ldg(sph + 3 * ld + j);
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      if (!((open >> k) & 1u)) continue;
      const float b = 2.0f * (ocx * dx[k] + ocy * dy[k] + ocz * dz[k]);
      const float disc = b * b - four_a[k] * cc;
      if (!(disc >= 0.f)) continue;
      const float sq = sqrtf(disc);
      const float t1 = (-b - sq) * inv2a[k];
      const float t2 = (-b + sq) * inv2a[k];
      if ((t1 >= 0.f && t1 <= tm[k]) || (t2 >= 0.f && t2 <= tm[k])) {
        occ |= 1u << k;
        open &= ~(1u << k);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < L; ++k) out[(size_t)k * R + i] = (occ >> k) & 1u;
}

template <int L>
cudaError_t launch_dense(const float* o, const float* d, const float* t_max,
                         const unsigned char* prior, const float* sph, int R,
                         int S, int ld, unsigned char* out,
                         cudaStream_t stream) {
  const int blocks = (R + kDenseThreads - 1) / kDenseThreads;
  sph_occ_dense_kernel<L><<<blocks, kDenseThreads, 0, stream>>>(
      o, d, t_max, prior, sph, R, S, ld, out);
  return cudaGetLastError();
}

constexpr int kSlots = 128;          // spheres per walk block
constexpr int kWalkWarps = 4;        // warps (packets) per CTA of the walk
constexpr float kPadCenter = 1e30f;  // a pad slot's center coordinates
// The warp's staged rays: flat_common's rows, then 1/(2a) and 4a.
constexpr int kWalkRows = ptt::kWarpRayRows + 2;
constexpr int kRowInv2a = ptt::kWarpRayRows * 32;
constexpr int kRowFourA = kRowInv2a + 32;

// Shared memory of one warp of the walk: its staged rays, then the listed
// columns, their ray masks and their keys.
__host__ __device__ constexpr size_t walk_warp_floats(int sbpad) {
  return (size_t)kWalkRows * 32 + 3 * (size_t)sbpad;
}

__global__ void __launch_bounds__(32 * kWalkWarps, 4)
sph_occ_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const unsigned char* __restrict__ prior,
                    const float* __restrict__ blk,
                    const int* __restrict__ blkid,
                    const float* __restrict__ sph, int R, int sbpad,
                    int n_slots, int lane_wise,
                    unsigned char* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_ray = smem + warp * walk_warp_floats(sbpad);  // [kWalkRows][32]
  int* s_col = reinterpret_cast<int*>(s_ray + kWalkRows * 32);    // [sbpad]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + sbpad);  // [sbpad]
  float* s_key = reinterpret_cast<float*>(s_mask + sbpad);        // [sbpad]

  const int i = (blockIdx.x * (blockDim.x >> 5) + warp) * 32 + lane;
  const size_t idx = (size_t)blockIdx.y * R + i;  // (set, ray)
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  bool pri = false;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * idx]; dy = d[3 * idx + 1]; dz = d[3 * idx + 2];
    tm = t_max[idx];
    pri = prior && prior[idx];
  }
  const ptt::WidenedOccludedGate gate;
  // The open lanes: live, prior not set, no occluder found yet.
  const unsigned opened = __ballot_sync(kFullMask, gate.live(tm) && !pri);
  unsigned open = opened;
  if (open) {
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv2a = 1.0f / (2.0f * a);
    const float four_a = 4.0f * a;
    s_ray[kRowInv2a + lane] = inv2a;
    s_ray[kRowFourA + lane] = four_a;
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tm);

    // 1. The columns the gate of some open ray admits (a closed ray may
    //    slab-pass: masked out), with their masks and keys.
    int m = 0;
    for (int c0 = 0; c0 < sbpad; c0 += 32) {
      const int c = c0 + lane;
      unsigned mask = 0u;
      float key = CUDART_INF_F;
      if (c < sbpad && blkid[c] >= 0)
        mask = ptt::warp_gate_mask_key(
                   ptt::pad_box(ptt::load_box(blk, sbpad, c)), s_ray, gate,
                   key) & open;
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

    // 2. The visits, nearest key first, of the entries whose mask holds an
    //    open lane; a visited entry's key becomes NaN, which no comparison
    //    selects again.
    while (open) {
      float key = CUDART_INF_F;
      int p = INT_MAX;
      for (int q = lane; q < m; q += 32) {
        const float k = s_key[q];
        if ((s_mask[q] & open) && (k < key || (k == key && q < p))) {
          key = k; p = q;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float k2 = __shfl_xor_sync(kFullMask, key, off);
        const int p2 = __shfl_xor_sync(kFullMask, p, off);
        if (k2 < key || (k2 == key && p2 < p)) { key = k2; p = p2; }
      }
      if (p == INT_MAX) break;
      const unsigned need = s_mask[p] & open;
      const int start = blkid[s_col[p]] * kSlots;
      __syncwarp();  // every lane has read s_key and entry p
      if (lane == 0) s_key[p] = CUDART_NAN_F;
      __syncwarp();  // lane 0's mark is seen by the next argmin
      const float* src = sph + start;
      // The block, lane l holding slots l + 32 q (the registers of the
      // block-over-the-warp layout), and its last real sphere: the pad
      // slots after it never occlude.
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
      unsigned occ = 0u;
      if (__popc(need) >= lane_wise) {
        // 3. Lane per ray: every lane reads the same column.
        bool hit = false;
        if ((need >> lane) & 1u) {
          for (int j = 0; j < n_real && !hit; ++j)
            hit = ptt::sphere_occludes(
                ox, oy, oz, dx, dy, dz, four_a, inv2a, tm, __ldg(src + j),
                __ldg(src + n_slots + j), __ldg(src + 2 * (size_t)n_slots + j),
                __ldg(src + 3 * (size_t)n_slots + j));
        }
        occ = __ballot_sync(kFullMask, hit);
      } else {
        // 3. The block over the warp, the served rays one after another.
        for (unsigned mm = need; mm; mm &= mm - 1) {
          const int s = __ffs(mm) - 1;  // the served ray
          const float sox = s_ray[s], soy = s_ray[32 + s],
                      soz = s_ray[64 + s], stm = s_ray[ptt::kRowG + s],
                      sdx = s_ray[ptt::kRowD + s],
                      sdy = s_ray[ptt::kRowD + 32 + s],
                      sdz = s_ray[ptt::kRowD + 64 + s],
                      sinv2a = s_ray[kRowInv2a + s],
                      sfour_a = s_ray[kRowFourA + s];
          bool hit = false;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q * 32 >= n_real) break;  // pads only from here
            hit = hit || ptt::sphere_occludes(sox, soy, soz, sdx, sdy, sdz,
                                              sfour_a, sinv2a, stm, cx[q],
                                              cy[q], cz[q], cr[q]);
          }
          if (__any_sync(kFullMask, hit)) occ |= 1u << s;
        }
      }
      open &= ~occ;
    }
  }
  // 4. prior | occluded by a sphere.
  if (in_range) out[idx] = (pri || ((opened & ~open) >> lane) & 1u) ? 1 : 0;
}

}  // namespace

extern "C" int ptt_sph_occluded(const float* o, const float* d,
                                const float* t_max, const unsigned char* prior,
                                const float* sph, int R, int L, int S,
                                int ld, unsigned char* out, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  static_assert(kMaxSets == 8, "the cases below instantiate L = 1..8");
  switch (L) {
    case 1: return (int)launch_dense<1>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 2: return (int)launch_dense<2>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 3: return (int)launch_dense<3>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 4: return (int)launch_dense<4>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 5: return (int)launch_dense<5>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 6: return (int)launch_dense<6>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 7: return (int)launch_dense<7>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    case 8: return (int)launch_dense<8>(o, d, t_max, prior, sph, R, S, ld,
                                        out, stream);
    default: return (int)cudaErrorInvalidValue;  // above kMaxSets
  }
}

extern "C" int ptt_sph_occ_walk(const float* o, const float* d,
                                const float* t_max, const unsigned char* prior,
                                const float* blk, const int* blkid,
                                const float* sph, int R, int L, int sbpad,
                                int n_slots, int lane_wise, unsigned char* out,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  if (L > 65535 || lane_wise < 1 || lane_wise > 33)
    return (int)cudaErrorInvalidValue;
  // Four warps a CTA, fewer where their lists outgrow shared memory.
  int warps = kWalkWarps;
  size_t smem;
  err = ptt::warp_walk_smem(sph_occ_walk_kernel,
                            walk_warp_floats(sbpad) * sizeof(float), warps,
                            smem);
  if (err != cudaSuccess) return (int)err;
  const int rays = 32 * warps;
  const dim3 grid((R + rays - 1) / rays, L);
  sph_occ_walk_kernel<<<grid, rays, smem, stream>>>(
      o, d, t_max, prior, blk, blkid, sph, R, sbpad, n_slots, lane_wise,
      out);
  return (int)cudaGetLastError();
}
