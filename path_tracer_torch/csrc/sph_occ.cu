// Sphere any-hit for L direction sets that share one origin set (a bounce's
// shadow casts toward L lights): a dense pass over every sphere, one thread
// per ray for all L sets, and a block walk over SAH blocks of 128 spheres,
// one thread per (ray, set).
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
//   - a dead lane is t_max < 0 and reports NOT occluded on both kernels
//     (pallas_spheres.py:532-536), unlike the triangle any-hit;
//   - walk block gate on the [8, sbpad] AABB table: tf >= max(tn, 0),
//     tn <= t_max, t_max >= 0 and block id >= 0, zero direction components
//     inverted to 1e30; a block's spheres are the 128 sorted slots of its
//     id;
//   - the result does not depend on the visit order (any root counts).
// The dense kernel also folds in the triangle any-hit's result: with a
// prior [L,R] (1 = occluded), a set's output is prior | spheres, so a
// dead lane whose prior is set (the triangle any-hit reports dead lanes
// occluded) still comes out occluded; the caller masks dead lanes.
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
// against it in turns (PERF.md §6). The walk is the CTA walk of
// flat_common.cuh with the any-hit gate (blockIdx.y picks the set): blocks
// keyed by their nearest slab entry over the CTA's live lanes, visited nearest
// first while some lane is unoccluded and slab-passes one, its [4, 128]
// spheres staged in shared memory.
//
// Inputs:  o [R,3] f32; d [L,R,3] f32; t_max [L,R] f32; dense: sph [4, ld]
//          f32 of which the first S columns are tested, prior [L,R] u8 or
//          null; walk: blk [8,sbpad] f32, blkid [sbpad] i32, sph
//          [4, n_slots] f32 sorted (block b = columns [b*128, (b+1)*128)).
// Output:  dense: out [L,R] u8 (a bool tensor's bytes), 1 = occluded;
//          walk: out [L,R] f32, 1 = occluded, 0 = not occluded (or dead).

#include "flat_common.cuh"

namespace {

using ptt::kCtaRays;

constexpr int kSlots = 128;  // spheres per walk block

// Whether one of the n spheres staged in s (rows x, y, z, r with row stride
// ld) has a root in [0, tm].
__device__ __forceinline__ bool any_root(const float* s, int ld, int n,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float four_a, float inv2a,
                                         float tm) {
  for (int j = 0; j < n; ++j) {
    const float ocx = ox - s[j];
    const float ocy = oy - s[ld + j];
    const float ocz = oz - s[2 * ld + j];
    const float rad = s[3 * ld + j];
    const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = b * b - four_a * cc;
    if (!(disc >= 0.f)) continue;
    const float sq = sqrtf(disc);
    const float t1 = (-b - sq) * inv2a;
    if (t1 >= 0.f && t1 <= tm) return true;
    const float t2 = (-b + sq) * inv2a;
    if (t2 >= 0.f && t2 <= tm) return true;
  }
  return false;
}

// The lane's ray and t_max of set blockIdx.y; a ray past R is dead.
struct Lane {
  size_t idx;
  bool in_range;
  float ox, oy, oz, dx, dy, dz, tm;
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ t_max,
                                          int R) {
  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  Lane l{(size_t)blockIdx.y * R + i, i < R, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f,
         -1.f};
  if (l.in_range) {
    l.ox = o[3 * i]; l.oy = o[3 * i + 1]; l.oz = o[3 * i + 2];
    l.dx = d[3 * l.idx]; l.dy = d[3 * l.idx + 1]; l.dz = d[3 * l.idx + 2];
    l.tm = t_max[l.idx];
  }
  return l;
}

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

__global__ void __launch_bounds__(kCtaRays)
sph_occ_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const float* __restrict__ blk,
                    const int* __restrict__ blkid,
                    const float* __restrict__ sph, int R, int sbpad,
                    int n_slots, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_sph = smem;                // [4][kSlots]
  float* s_key = s_sph + 4 * kSlots;  // [sbpad]
  float* s_ray = s_key + sbpad;       // [kRayRows][kCtaRays]
  __shared__ float s_red[3 * (kCtaRays / 32)];

  const Lane l = load_lane(o, d, t_max, R);
  const ptt::OccludedGate gate;
  const bool live = gate.live(l.tm);
  bool occ = false;  // dead lanes report not occluded
  if (__syncthreads_or(live)) {
    const float ix = ptt::safe_inv(l.dx), iy = ptt::safe_inv(l.dy),
                iz = ptt::safe_inv(l.dz);
    const float a = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
    const float inv2a = 1.0f / (2.0f * a);
    const float four_a = 4.0f * a;
    ptt::stage_ray(s_ray, l.ox, l.oy, l.oz, ix, iy, iz, l.tm);
    ptt::column_keys(blk, blkid, sbpad, sbpad, s_ray, s_key, gate);
    while (true) {
      float key, open = (live && !occ) ? 1.f : 0.f;  // any lane still open?
      int col;
      ptt::next_column(s_key, sbpad, key, col, open, s_red);
      if (col >= sbpad || open == 0.f) break;
      bool need = false;
      if (live && !occ) {
        float tn, tf;
        ptt::slab(ptt::load_box(blk, sbpad, col), l.ox, l.oy, l.oz, ix, iy,
                  iz, tn, tf);
        need = gate.pass(tn, tf, l.tm);
      }
      if (!__syncthreads_or(need)) continue;
      const int start = blkid[col] * kSlots;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        s_sph[r * kSlots + threadIdx.x] =
            sph[(size_t)r * n_slots + start + threadIdx.x];
      __syncthreads();
      if (need)
        occ = any_root(s_sph, kSlots, kSlots, l.ox, l.oy, l.oz, l.dx, l.dy,
                       l.dz, four_a, inv2a, l.tm);
      __syncthreads();  // s_sph is restaged by the next visit
    }
  }
  if (l.in_range) out[l.idx] = occ ? 1.f : 0.f;
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
                                const float* t_max, const float* blk,
                                const int* blkid, const float* sph, int R,
                                int L, int sbpad, int n_slots, float* out,
                                int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  size_t smem;
  err = ptt::walk_smem(sph_occ_walk_kernel, 4 * kSlots, sbpad, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  sph_occ_walk_kernel<<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, blk, blkid, sph, R, sbpad, n_slots, out);
  return (int)cudaGetLastError();
}
