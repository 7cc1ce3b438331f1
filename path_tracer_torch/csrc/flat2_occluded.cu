// Two-level flat walk any-hit for L direction sets that share one origin set
// (a bounce's shadow casts toward L lights): every warp is an independent
// packet of 32 consecutive rays of one set, and each block it visits is
// spread over the warp.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat2_occ_kernel
// (launched by _flat2_occ_launch, entries occluded_triangles_flat2 and
// occluded_triangles_flat2_multi). Contract kept (with the plain version,
// ops/cuda_bvh.py):
//   - superblock gate tf >= max(tn, 0), tn <= t_max, t_max >= 0 and id >= 0,
//     then the same block gate on the superblock's 128 block columns;
//     rows addressed by block id; zero direction components inverted to
//     1e30; both on widened boxes and intervals, as flat_closest_hit.cu's;
//   - a ray is occluded when some triangle hit has 1e-6 <= t <= t_max, by
//     the Baldwin-Weber test of flat_closest_hit.cu (same rounding);
//   - a dead lane is t_max < 0 and reports occluded (the caller masks it);
//     a warp with no lane of t_max >= 0 skips the walk;
//   - the result does not depend on the visit order (any hit counts), so
//     it equals the plain version's on every lane, and the flat any-hit's
//     (flat_occluded.cu) on the same tables: a block's widened box lies
//     inside its superblock's and slab rounding is monotone.
//
// Bound on the card: arithmetic in the block visits (32 operations per
// ray-slot Baldwin-Weber test, each ray stopping at its first occluder)
// and the slab tests (22 operations per ray and column), and at 1M
// triangles the HBM reads of each visited block's 12 used BW rows (the
// 90.4 MB table of the 991,834-triangle textured showcase does not stay in
// the 50 MB L2); a chunk's reads are coalesced 128-byte rows.
//
// Design, flat2_closest_hit.cu's two-level warp walk with flat_occluded.cu's
// any-hit visit (no CTA barrier anywhere; blockIdx.y picks the set; a CTA
// holds four warps that share nothing but the launch):
//   1. Superblock gate: the warp stages its rays; lane c slab-tests
//      superblock columns c, c + 32, ... against the warp's 32 rays
//      (unrolled), keeps the mask of the live rays it admits, and the
//      admitted superblocks are compacted with their masks into the
//      warp's list.
//   2. For each listed superblock, in column order, need = its mask and the
//      rays still open (skipped when empty; the warp stops once no ray is
//      open): its 128 block columns, 4 a lane held in registers, are gated
//      against each needing ray in turn (an occluded ray costs no slab
//      test), compacted into a list of at most 128 entries, and each listed
//      block is visited for its mask and the rays still open: the block is
//      spread over the warp 128 slots at a time, the needing rays served one
//      after another, and an __any_sync over the lanes' slot tests closes a
//      served ray.
// A warp holds 3.3 KB of shared memory at scene A's 128 superblock columns.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; sbflat [8,sbpad]
//          f32; sbid [sbpad] i32; blkflat [8,bpad] f32 (bpad = 128 x the
//          superblock columns in use); blkid [bpad] i32; bw [16, n_cols]
//          f32 (block b = columns [b*block, (b+1)*block), block a multiple
//          of 128).
// Output:  out [L,R] u8 (a bool tensor's bytes), 1 = occluded (or dead),
//          0 = not occluded.

#include "flat_common.cuh"

namespace {

using ptt::kFullMask;

constexpr int kWarps = 4;    // warps (packets) per CTA
constexpr int kGroup = 128;  // block columns per superblock

// Shared memory of one warp: its staged rays, the listed superblocks and
// their ray masks, then one superblock's listed blocks and masks.
__host__ __device__ constexpr size_t warp_floats(int sbpad) {
  return (size_t)ptt::kWarpRayRows * 32 + 2 * (size_t)sbpad + 2 * kGroup;
}

__global__ void __launch_bounds__(32 * kWarps, 4)
flat2_occluded_kernel(const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ t_max,
                      const float* __restrict__ sb,
                      const int* __restrict__ sbid,
                      const float* __restrict__ blk,
                      const int* __restrict__ blkid,
                      const float* __restrict__ bw, int R, int sbpad, int bpad,
                      int block, int n_cols, unsigned char* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_ray = smem + warp * warp_floats(sbpad);  // [kWarpRayRows][32]
  int* s_sb = reinterpret_cast<int*>(s_ray + ptt::kWarpRayRows * 32);
  unsigned* s_sbmask = reinterpret_cast<unsigned*>(s_sb + sbpad);
  int* s_col = reinterpret_cast<int*>(s_sbmask + sbpad);           // [128]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + kGroup);  // [128]

  const int i = (blockIdx.x * (blockDim.x >> 5) + warp) * 32 + lane;
  const size_t idx = (size_t)blockIdx.y * R + i;  // (set, ray)
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * idx]; dy = d[3 * idx + 1]; dz = d[3 * idx + 2];
    tm = t_max[idx];
  }
  const ptt::OccludedGate gate;
  // The rays not yet found occluded; a dead lane (t_max < 0) is never open
  // and reports occluded.
  unsigned open = __ballot_sync(kFullMask, gate.live(tm));
  const int n_groups = min(sbpad, bpad / kGroup);
  if (open) {
    const unsigned live_mask = open;
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tm);

    // 1. The superblocks some live ray's gate admits, with their masks (a
    //    dead ray may slab-pass: masked out).
    int ms = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      const int g = g0 + lane;
      unsigned mask = 0u;
      if (g < n_groups && sbid[g] >= 0)
        mask = ptt::warp_gate_mask(ptt::load_box(sb, sbpad, g), s_ray,
                                   gate) & live_mask;
      ms = ptt::warp_append(s_sb, s_sbmask, ms, lane, g, mask);
    }
    __syncwarp();

    // 2. Each listed superblock's blocks, gated for the rays it admits that
    //    are still open, listed and visited until no ray is open.
    for (int e = 0; e < ms && open; ++e) {
      const unsigned sb_need = s_sbmask[e] & open;
      if (!sb_need) continue;
      const int w = s_sb[e] * kGroup;
      // Lane l gates columns w + l + 32q, q < 4, against each needing ray
      // in turn (four independent chains a ray).
      ptt::Box box[kGroup / 32];
      unsigned mask[kGroup / 32];
#pragma unroll
      for (int q = 0; q < kGroup / 32; ++q) {
        box[q] = ptt::pad_box(ptt::load_box(blk, bpad, w + 32 * q + lane));
        mask[q] = 0u;
      }
      for (unsigned mm = sb_need; mm; mm &= mm - 1) {
        const int k = __ffs(mm) - 1;
        const float kox = s_ray[k], koy = s_ray[32 + k], koz = s_ray[64 + k],
                    kix = s_ray[96 + k], kiy = s_ray[128 + k],
                    kiz = s_ray[160 + k], ktm = s_ray[ptt::kRowG + k];
#pragma unroll
        for (int q = 0; q < kGroup / 32; ++q) {
          float tn, tf;
          ptt::slab(box[q], kox, koy, koz, kix, kiy, kiz, tn, tf);
          ptt::pad_slab(tn, tf);
          if (gate.pass(tn, tf, ktm)) mask[q] |= 1u << k;
        }
      }
      int m = 0;
#pragma unroll
      for (int q = 0; q < kGroup / 32; ++q) {
        const int c = w + 32 * q + lane;
        m = ptt::warp_append(s_col, s_mask, m, lane, c,
                             blkid[c] >= 0 ? mask[q] : 0u);
      }
      __syncwarp();
      for (int p = 0; p < m && open; ++p) {
        const unsigned need = s_mask[p] & open;
        if (need)
          open &= ~ptt::warp_any_block(bw, blkid[s_col[p]], block, n_cols,
                                       need, s_ray, lane);
      }
      __syncwarp();  // the next superblock's list overwrites s_col, s_mask
    }
  }
  if (in_range) out[idx] = (open >> lane) & 1u ? 0 : 1;
}

}  // namespace

extern "C" int ptt_flat2_occluded(const float* o, const float* d,
                                  const float* t_max, const float* sb,
                                  const int* sbid, const float* blk,
                                  const int* blkid, const float* bw, int R,
                                  int L, int sbpad, int bpad, int block,
                                  int n_cols, unsigned char* out, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  if (block <= 0 || block % ptt::kWarpChunk)
    return (int)cudaErrorInvalidValue;
  int warps = kWarps;
  size_t smem;
  err = ptt::warp_walk_smem(flat2_occluded_kernel,
                            warp_floats(sbpad) * sizeof(float), warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int rays = 32 * warps;
  const dim3 grid((R + rays - 1) / rays, L);
  flat2_occluded_kernel<<<grid, rays, smem, stream>>>(
      o, d, t_max, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      out);
  return (int)cudaGetLastError();
}
