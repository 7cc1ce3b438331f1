// Flat block-walk closest hit over the superleaf tables: every warp is an
// independent packet of 32 rays, and each block it visits is spread over
// the warp. An optional dense sphere pass is merged in the same launch.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat_kernel
// (launched by _flat_launch, entry closest_hit_triangles_flat). Contract
// kept (with the plain version, ops/cuda_bvh.py):
//   - block slab gate tf >= max(tn, 0) and tf > t_prev on the [8, bpad]
//     AABB table, zero direction components inverted to 1e30; pad columns
//     (block id < 0) are excluded by id (their bounds may slab-pass). The
//     box is widened by flat_common.cuh's pad_box and the interval by its
//     pad_slab (ops/slab.py): on the exact box a ray through a vertex or an
//     edge lying on the box can fail the block whose triangle its rounded
//     test hits (the Pallas kernel gated the union of a tile's rays, which
//     hid most such lanes);
//   - Baldwin-Weber test per slot: |d.n| >= 1e-6, t = (c - o.n) * 1/(d.n),
//     t >= 1e-6 and t > t_prev, u = Au.h + au >= 0, v = Av.h + av >= 0,
//     u + v <= 1; backface = d.n > 0 (MT det = -d.n);
//   - TIE RULE: the smallest t wins, and among equal t the lowest packed
//     slot (a lexicographic (t, slot) minimum, so neither the visit order
//     nor which lane tests a slot decides it); a miss reports t = +inf,
//     slot -1;
//   - a dead lane is t_prev = +inf; a warp whose lanes are all dead skips
//     the walk and writes the all-miss record;
//   - every block the gate admits is tested (no cut at a ray's best t), so
//     the record equals the plain version's on every lane;
//   - sphere pass (S > 0): the root rules of sphere_closest_hit.cu over the
//     dense [4, S] table, lowest index among equal t; the sphere wins only
//     on sph_t < tri_t (the triangle wins ties) and then reports kind 2,
//     slot = sph_row_base + index, u = v = 0.
//
// Bound on the card: arithmetic in the block visits (32 operations per
// ray-slot Baldwin-Weber test, sl_block slots per block a lane's gate
// admits) and the slab tests (22 operations per ray and block column); the
// tables (8.5 MB for the 100k-triangle showcase) stay in L2.
//
// Design. A CTA holds four warps that share nothing but the launch; a warp
// is a packet of 32 consecutive rays of the Morton-ordered wavefront, and
// no CTA barrier sits anywhere in the kernel (__ballot_sync, __shfl_sync
// and __syncwarp only).
//   1. Gate: the warp stages its rays in its slice of shared memory; lane c
//      slab-tests columns c, c + 32, ... against the warp's 32 rays (the
//      loop unrolled: 32 independent chains; a dead ray fails the gate) and
//      keeps the mask of the rays whose gate admits the column. Columns
//      some ray is admitted to are compacted, with their masks, into the
//      warp's list (8 bytes a column: 16 KB at the flat route's 2,048
//      blocks; fewer warps per CTA where the list outgrows shared memory).
//   2. Visit, every listed column in column order, spread over the warp:
//      the block is taken 128 slots at a time; lane l loads slots l, l + 32,
//      l + 64, l + 96 of the chunk (12 rows each, coalesced) into
//      registers. The admitted rays are served one after another: the
//      served ray is read from the warp's staged rays, its best t by
//      shuffle, and every lane tests its four slots against it (four
//      independent tests). A ballot finds the lanes with a candidate (t no
//      farther than the served ray's best); one candidate lane is read
//      directly, several take a warp (t, slot) minimum. The served lane
//      merges the winner by the tie rule. A block thus costs one test per
//      slot per admitted ray, where the CTA walk ran every slot on all 32
//      lanes of each warp with a needing ray.
//   3. The sphere pass reads the sphere table through the read-only cache
//      (every lane reads the same column: a broadcast).
// Why the order decides nothing: every ray tests every block its gate
// admits, as the plain version does, and its record is the lexicographic
// (t, slot) minimum of those hits; candidates are cut only at the served
// ray's current best t, which cannot change that minimum. There is no cut
// of whole blocks at a ray's best t: rounding can put a hit a few ulps
// before its block's slab entry (a ray through a vertex or edge on the
// block's box), so such a cut lets the visit order decide ties between
// copies in different blocks, as it did in this kernel's former CTA walk
// and in flat2's.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; blkflat [8,bpad] f32;
//          blkid [bpad] i32; bw [16, n_cols] f32 (block b = columns
//          [b*block, (b+1)*block), block a multiple of 128); sph [4,S] f32
//          (unused when S == 0).
// Outputs: fout [4 or 5, R] f32 rows (t, u, v, backface 0/1[, kind 0/1/2]);
//          iout [R] i32 packed slot.

#include "flat_common.cuh"

namespace {

using ptt::kFullMask;

constexpr int kWarps = 4;  // warps (packets) per CTA

// Shared memory of one warp: its staged rays, then the listed columns and
// their ray masks.
__host__ __device__ constexpr size_t warp_floats(int bpad) {
  return (size_t)ptt::kWarpRayRows * 32 + 2 * (size_t)bpad;
}

__global__ void __launch_bounds__(32 * kWarps, 4)
flat_closest_hit_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_prev,
                        const float* __restrict__ blk,
                        const int* __restrict__ blkid,
                        const float* __restrict__ bw,
                        const float* __restrict__ sph, int R, int bpad,
                        int block, int n_cols, int S, int sph_row_base,
                        float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_ray = smem + warp * warp_floats(bpad);  // [kWarpRayRows][32]
  int* s_col = reinterpret_cast<int*>(s_ray + ptt::kWarpRayRows * 32);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + bpad);  // [bpad]

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
  const unsigned live_mask = __ballot_sync(kFullMask, live);

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  if (live_mask) {
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tp);

    // 1. The columns some live ray's gate admits (a dead ray's t_prev,
    //    +inf or NaN, fails it), compacted with the mask of the rays they
    //    admit.
    int m = 0;
    for (int c0 = 0; c0 < bpad; c0 += 32) {
      const int c = c0 + lane;
      unsigned mask = 0u;
      if (c < bpad && blkid[c] >= 0)
        mask = ptt::warp_gate_mask(ptt::load_box(blk, bpad, c), s_ray, gate);
      m = ptt::warp_append(s_col, s_mask, m, lane, c, mask);
    }
    __syncwarp();

    // 2. The walk: every listed column in column order, each visit spread
    //    over the warp.
    for (int p = 0; p < m; ++p)
      ptt::warp_closest_block(bw, blkid[s_col[p]], block, n_cols, s_mask[p],
                              s_ray, lane, bt, bu, bv, bb, bi);
  }

  float kind = bt < CUDART_INF_F ? 1.f : 0.f;
  if (S > 0 && live) {
    // 3. The sphere pass: every lane reads the same column, a broadcast.
    const float a = dx * dx + dy * dy + dz * dz;
    const float two_a = 2.0f * a;
    float st = CUDART_INF_F, sb = 0.f;
    int si = 0;
    for (int j = 0; j < S; ++j) {
      bool far;
      const float t = ptt::sphere_nearest(
          ox, oy, oz, dx, dy, dz, a, two_a, tp, __ldg(sph + j),
          __ldg(sph + S + j), __ldg(sph + 2 * S + j), __ldg(sph + 3 * S + j),
          far);
      if (t < st) { st = t; sb = far ? 1.f : 0.f; si = j; }
    }
    if (st < bt) {  // the triangle wins ties
      bt = st; bu = 0.f; bv = 0.f; bb = sb; bi = sph_row_base + si;
      kind = 2.f;
    }
  }
  if (in_range) {
    fout[i] = bt;
    fout[(size_t)R + i] = bu;
    fout[2 * (size_t)R + i] = bv;
    fout[3 * (size_t)R + i] = bb;
    if (S > 0) fout[4 * (size_t)R + i] = kind;
    iout[i] = bi;
  }
}

}  // namespace

extern "C" int ptt_flat_closest_hit(const float* o, const float* d,
                                    const float* t_prev, const float* blk,
                                    const int* blkid, const float* bw,
                                    const float* sph, int R, int bpad,
                                    int block, int n_cols, int S,
                                    int sph_row_base, float* fout, int* iout,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (block <= 0 || block % ptt::kWarpChunk)
    return (int)cudaErrorInvalidValue;
  // Four warps a CTA, fewer where their lists outgrow shared memory.
  int warps = kWarps;
  size_t smem;
  err = ptt::warp_walk_smem(flat_closest_hit_kernel,
                            warp_floats(bpad) * sizeof(float), warps, smem);
  if (err != cudaSuccess) return (int)err;
  const int rays = 32 * warps;
  const int blocks = (R + rays - 1) / rays;
  flat_closest_hit_kernel<<<blocks, rays, smem, stream>>>(
      o, d, t_prev, blk, blkid, bw, sph, R, bpad, block, n_cols, S,
      sph_row_base, fout, iout);
  return (int)cudaGetLastError();
}
