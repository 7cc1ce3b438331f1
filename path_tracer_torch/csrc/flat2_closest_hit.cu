// Two-level flat walk closest hit over the superleaf tables (superblocks of
// 128 block columns, then blocks, then slots): every warp is an independent
// packet of 32 rays, and each block it visits is spread over the warp.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat2_kernel
// (launched by _flat2_launch, entry closest_hit_triangles_flat2), which
// serves scenes of more than FLAT_MAX_BLOCKS = 2,048 blocks (about 1M
// triangles). Contract kept (with the plain version, ops/cuda_bvh.py):
//   - superblock gate on the [8, sbpad] union table: tf >= max(tn, 0),
//     tf > t_prev and superblock id >= 0; then the same block gate on the
//     superblock's 128 columns of the [8, bpad] block table (block id >= 0),
//     zero direction components inverted to 1e30; both on boxes widened by
//     flat_common.cuh's pad_box and intervals by its pad_slab, as
//     flat_closest_hit.cu's (a widened block box lies inside its widened
//     superblock box);
//   - a block's BW rows are those of its id (blkid), never of its column:
//     the opacity partition leaves gaps between the column ranges;
//   - the Baldwin-Weber test of flat_closest_hit.cu per slot, with its tie
//     rule (the lexicographic (t, packed slot) minimum); a miss is
//     t = +inf, slot -1;
//   - a dead lane is t_prev = +inf; a warp of dead lanes skips the walk;
//   - every block the two gates admit is tested, with no cut of blocks or
//     superblocks at a ray's best t, so the visit order decides nothing and
//     the record equals the plain version's (and the flat kernel's on the
//     same tables) on every lane. A cut there is not exact: rounding can put
//     a hit a few ulps before its block's slab entry (a ray through a
//     vertex or an edge on the block's box), and the cut then lets the visit
//     order decide between equal-t copies, as the design this one replaced
//     did.
//
// Bound on the card: arithmetic in the block visits (32 operations per
// ray-slot Baldwin-Weber test) and the slab tests (22 per ray and column),
// and at 1M triangles the HBM reads of each visited block's 12 used BW rows
// (the 90.4 MB table of the 991,834-triangle textured showcase does not stay
// in the 50 MB L2); a chunk's reads are coalesced 128-byte rows.
//
// Design, the warp walk of flat_closest_hit.cu with one more level (no CTA
// barrier anywhere; a CTA holds four warps that share nothing but the
// launch; a warp is 32 Morton-consecutive rays):
//   1. Superblock gate: lane c slab-tests superblock columns c, c + 32, ...
//      against the warp's 32 staged rays (unrolled; a dead ray's t_prev
//      fails the gate); the admitted superblocks are compacted with their
//      ray masks into the warp's list.
//   2. For each admitted superblock, in column order: its 128 block
//      columns, 4 a lane held in registers, gated against each ray the
//      superblock admits in turn (the four columns' slab tests independent
//      chains, the work proportional to the admitted rays), compacted into
//      a list of at most 128 entries (1 KB a warp), then every listed block
//      visited as flat_closest_hit.cu visits it (served rays, a ballot, a
//      warp (t, slot) minimum, the tie-rule merge into the served lane).
// A warp thus holds 3.3 KB of shared memory at scene A's 128 superblock
// columns, where the one-level warp walk listed 5,632 columns (45 KB).
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; sbflat [8,sbpad] f32; sbid
//          [sbpad] i32; blkflat [8,bpad] f32 (bpad = 128 x the superblock
//          columns in use); blkid [bpad] i32; bw [16, n_cols] f32 (block b
//          = columns [b*block, (b+1)*block), block a multiple of 128).
// Outputs: fout [4, R] f32 rows (t, u, v, backface 0/1); iout [R] i32
//          packed slot.

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
flat2_closest_hit_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_prev,
                         const float* __restrict__ sb,
                         const int* __restrict__ sbid,
                         const float* __restrict__ blk,
                         const int* __restrict__ blkid,
                         const float* __restrict__ bw, int R, int sbpad,
                         int bpad, int block, int n_cols,
                         float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_ray = smem + warp * warp_floats(sbpad);  // [kWarpRayRows][32]
  int* s_sb = reinterpret_cast<int*>(s_ray + ptt::kWarpRayRows * 32);
  unsigned* s_sbmask = reinterpret_cast<unsigned*>(s_sb + sbpad);
  int* s_col = reinterpret_cast<int*>(s_sbmask + sbpad);           // [128]
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + kGroup);  // [128]

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
  const unsigned live_mask = __ballot_sync(kFullMask, gate.live(tp));
  const int n_groups = min(sbpad, bpad / kGroup);

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  if (live_mask) {
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tp);

    // 1. The superblocks some live ray's gate admits, with their masks.
    int ms = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      const int g = g0 + lane;
      unsigned mask = 0u;
      if (g < n_groups && sbid[g] >= 0)
        mask = ptt::warp_gate_mask(ptt::load_box(sb, sbpad, g), s_ray, gate);
      ms = ptt::warp_append(s_sb, s_sbmask, ms, lane, g, mask);
    }
    __syncwarp();

    // 2. Each admitted superblock's blocks: gated for the rays it admits,
    //    listed, and every listed block visited.
    for (int e = 0; e < ms; ++e) {
      const int w = s_sb[e] * kGroup;
      const unsigned sb_mask = s_sbmask[e];
      // Lane l gates columns w + l + 32q, q < 4, against each ray the
      // superblock admits in turn (four independent chains a ray).
      ptt::Box box[kGroup / 32];
      unsigned mask[kGroup / 32];
#pragma unroll
      for (int q = 0; q < kGroup / 32; ++q) {
        box[q] = ptt::pad_box(ptt::load_box(blk, bpad, w + 32 * q + lane));
        mask[q] = 0u;
      }
      for (unsigned mm = sb_mask; mm; mm &= mm - 1) {
        const int k = __ffs(mm) - 1;
        const float kox = s_ray[k], koy = s_ray[32 + k], koz = s_ray[64 + k],
                    kix = s_ray[96 + k], kiy = s_ray[128 + k],
                    kiz = s_ray[160 + k], ktp = s_ray[ptt::kRowG + k];
#pragma unroll
        for (int q = 0; q < kGroup / 32; ++q) {
          float tn, tf;
          ptt::slab(box[q], kox, koy, koz, kix, kiy, kiz, tn, tf);
          ptt::pad_slab(tn, tf);
          if (gate.pass(tn, tf, ktp)) mask[q] |= 1u << k;
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
      for (int p = 0; p < m; ++p)
        ptt::warp_closest_block(bw, blkid[s_col[p]], block, n_cols,
                                s_mask[p], s_ray, lane, bt, bu, bv, bb, bi);
      __syncwarp();  // the next superblock's list overwrites s_col, s_mask
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

extern "C" int ptt_flat2_closest_hit(const float* o, const float* d,
                                     const float* t_prev, const float* sb,
                                     const int* sbid, const float* blk,
                                     const int* blkid, const float* bw, int R,
                                     int sbpad, int bpad, int block,
                                     int n_cols, float* fout, int* iout,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (block <= 0 || block % ptt::kWarpChunk)
    return (int)cudaErrorInvalidValue;
  int warps = kWarps;
  size_t smem;
  err = ptt::warp_walk_smem(flat2_closest_hit_kernel,
                            warp_floats(sbpad) * sizeof(float), warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int rays = 32 * warps;
  const int blocks = (R + rays - 1) / rays;
  flat2_closest_hit_kernel<<<blocks, rays, smem, stream>>>(
      o, d, t_prev, sb, sbid, blk, blkid, bw, R, sbpad, bpad, block, n_cols,
      fout, iout);
  return (int)cudaGetLastError();
}
