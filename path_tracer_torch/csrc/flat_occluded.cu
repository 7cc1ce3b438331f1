// Flat block-walk any-hit for L direction sets that share one origin set
// (a bounce's shadow casts toward L lights): every warp is an independent
// packet of 32 consecutive rays of one set, and each block it visits is
// spread over the warp.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_bvh.py::_flat_occ_kernel
// and its per-set body flat_occ_set (launched by _flat_occ_launch, entries
// occluded_triangles_flat and occluded_triangles_flat_multi). Contract kept
// (with the plain version, ops/cuda_bvh.py):
//   - a ray is occluded when some triangle hit has 1e-6 <= t <= t_max, by
//     the Baldwin-Weber test of flat_closest_hit.cu (same rounding);
//   - block slab gate tf >= max(tn, 0), tn <= t_max and t_max >= 0, zero
//     direction components inverted to 1e30, pad columns excluded by id.
//     The box is widened by flat_common.cuh's pad_box and the interval by
//     its pad_slab (ops/slab.py): on the exact box a ray through a vertex
//     or an edge lying on the box can fail the block whose triangle its
//     rounded test hits (the Pallas kernel gated the union of a tile's
//     rays, which hid most such lanes);
//   - a dead lane is t_max < 0 and reports occluded (the caller masks it);
//     a warp with no lane of t_max >= 0 skips the walk;
//   - the result does not depend on the visit order (any hit counts), so
//     it equals the plain version's on every lane.
//
// Bound on the card: arithmetic in the block visits (32 operations per
// ray-slot Baldwin-Weber test, each ray stopping at its first occluder)
// and the slab tests (22 operations per ray and block column); the tables
// (8.5 MB for the 100k-triangle showcase) stay in L2.
//
// Design, that of flat_closest_hit.cu (flat_common.cuh's warp walk):
// blockIdx.y picks the set, so one launch serves all L lights; a CTA holds
// four warps that share nothing but the launch, and no CTA barrier sits
// anywhere in the kernel.
//   1. Gate: the warp stages its rays in its slice of shared memory; lane c
//      slab-tests columns c, c + 32, ... against the warp's 32 rays (the
//      loop unrolled: 32 independent chains), keeps the mask of the live
//      rays whose gate admits the column, and the columns some ray is
//      admitted to are compacted with their masks into the warp's list
//      (8 bytes a column).
//   2. Visit, the listed columns in column order, each with need = its
//      mask and the rays still open: the block is spread over the warp 128
//      slots at a time, the needing rays served one after another, and an
//      __any_sync over the lanes' slot tests closes a served ray. The warp
//      stops as soon as no ray is open.
// The fused shadow kernel (fused_shadow.cu) runs this any-hit as its first
// phase.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; blkflat [8,bpad];
//          blkid [bpad] i32; bw [16, n_cols] f32 (block b = columns
//          [b*block, (b+1)*block), block a multiple of 128).
// Output:  out [L,R] u8 (a bool tensor's bytes), 1 = occluded (or dead),
//          0 = not occluded.

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
flat_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max, ptt::FlatTable ft,
                     int R, unsigned char* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bpad = ft.bpad;
  float* s_ray = smem + warp * warp_floats(bpad);
  int* s_col = reinterpret_cast<int*>(s_ray + ptt::kWarpRayRows * 32);
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_col + bpad);

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
  if (open) {
    const unsigned live_mask = open;
    ptt::stage_warp_rays(s_ray, lane, ox, oy, oz, dx, dy, dz, tm);

    // 1. The columns some live ray's gate admits, compacted with the mask
    //    of the rays they admit (a dead ray may slab-pass: masked out).
    int m = 0;
    for (int c0 = 0; c0 < bpad; c0 += 32) {
      const int c = c0 + lane;
      unsigned mask = 0u;
      if (c < bpad && ft.blkid[c] >= 0)
        mask = ptt::warp_gate_mask(ptt::load_box(ft.blk, bpad, c), s_ray,
                                   gate) & live_mask;
      m = ptt::warp_append(s_col, s_mask, m, lane, c, mask);
    }
    __syncwarp();

    // 2. The walk: the listed columns in column order, each visit spread
    //    over the warp, until no ray is open.
    for (int p = 0; p < m && open; ++p) {
      const unsigned need = s_mask[p] & open;
      if (need)
        open &= ~ptt::warp_any_block(ft.bw, ft.blkid[s_col[p]], ft.block,
                                     ft.n_cols, need, s_ray, lane);
    }
  }
  if (in_range) out[idx] = (open >> lane) & 1u ? 0 : 1;
}

}  // namespace

extern "C" int ptt_flat_occluded(const float* o, const float* d,
                                 const float* t_max, const float* blk,
                                 const int* blkid, const float* bw, int R,
                                 int L, int bpad, int block, int n_cols,
                                 unsigned char* out, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  if (block <= 0 || block % ptt::kWarpChunk)
    return (int)cudaErrorInvalidValue;
  // Four warps a CTA, fewer where their lists outgrow shared memory.
  int warps = kWarps;
  size_t smem;
  err = ptt::warp_walk_smem(flat_occluded_kernel,
                            warp_floats(bpad) * sizeof(float), warps, smem);
  if (err != cudaSuccess) return (int)err;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  const int rays = 32 * warps;
  const dim3 grid((R + rays - 1) / rays, L);
  flat_occluded_kernel<<<grid, rays, smem, stream>>>(o, d, t_max, ft, R,
                                                      out);
  return (int)cudaGetLastError();
}
