// Superleaf tree walk, closest hit and any-hit: every warp walks its 32
// rays with its own cursor, and a lane tests only the leaves its own gate
// admits.
//
// Replaces the TPU kernels path_tracer_tpu/ops/pallas_bvh.py::_kernel
// (launched by _launch, entry closest_hit_triangles_packet) and
// ::_occ_kernel (_occ_launch, entry occluded_triangles_packet). Contract
// (the plain versions in ops/cuda_bvh.py are held to it on every lane):
//   - rays come in groups of 128 consecutive rays (one CTA); rays past R
//     are padding with o = 0, d = (1, 1, 1), as the Pallas wrappers pad,
//     and a dead gate value (t_prev = +inf, t_max = -1);
//   - the group picks one of six direction-ordered layouts of the
//     superleaf forest (sl_nodes6, sl_meta6): 2 * axis + (sum < 0) from the
//     per-axis sums of its 128 directions (the axis of the largest |sum|,
//     x before y before z on ties), each sum a pairwise tree over the
//     lanes (lane j += lane j + w, w = 64, 32, ..., 1), so every lane meets
//     its leaves in the Pallas packet's order. That pick holds the CTA's
//     only barriers;
//   - slab entry tn and exit tf of a node box widened as flat_common.cuh's
//     pad_box, the interval widened as its pad_slab (zero direction
//     components inverted to 1e30, NaN-propagating min/max): on the exact
//     box the rounded slab test rejects rays through a vertex or an edge
//     lying on a leaf's box, whose hit only a leaf past the lane's own
//     gate would then test. A lane's gate passes when tf >= max(tn, 0),
//     tf > t_prev and tn <= its best t times cut_widen (closest hit), or
//     when it is not yet occluded, tf >= max(tn, 0) and tn <= t_max
//     (any-hit);
//   - each warp's cursor steps into an internal node some lane's gate
//     admits (i + 1) and otherwise takes the escape index; at a leaf, the
//     lanes whose own gate admits it test it. A child's widened box lies
//     inside its parent's and slab rounding is monotone, so a lane whose
//     gate admits a node admitted its ancestors when the cursor met them:
//     each lane's result is that of its own walk, whatever its warp;
//   - cut_widen (native.TREE_WALK_CUT_WIDEN, 1 + 2^-8): rounding can put a
//     hit before its box's slab entry, and a leaf holding a strictly
//     nearer copy must not be cut;
//   - a visit is Moller-Trumbore over the leaf's block of packed slots
//     (sl_tris_t rows v0, e1, e2): |det| >= 1e-6, u >= 0, v >= 0,
//     u + v <= 1, t >= 1e-6 and t > t_prev (closest hit; backface =
//     det < 0; within a leaf the lowest slot wins equal t, a later leaf
//     only a strictly smaller t) or t <= t_max (any-hit);
//   - a dead lane (t_prev = +inf; t_max < 0) passes no gate; the any-hit
//     reports it occluded (callers mask), and a warp stops once every lane
//     is occluded.
//
// Bound: arithmetic, about 45 flops per MT test a lane's own gate admits,
// 22 per slab test of a node its cursor meets (the widening not counted); on scene A (50.9 MB of MT
// rows beyond the 50 MB L2) the leaves' rows come from HBM.
//
// Design: no CTA barrier after the layout pick; the warp reads each node
// as a broadcast and ballots its lanes' gates. A leaf is taken 128 slots at
// a time, lane l loading slots l, l + 32, l + 64, l + 96 into registers
// (coalesced), and served by the number k of rays whose gate admits it:
//   (A) k >= lane_wise (native.TREE_WALK_LANE_WISE): lane per ray. The
//       warp stages the chunk's nine MT rows in its own slice of shared
//       memory (__syncwarp only), and each needing lane tests the slots in
//       order with its record in registers, every lane reading the same
//       slot (a broadcast). Reading the rows straight through the
//       read-only cache instead took 1.11x the replaced design's time on
//       the showcase's camera lanes (PERF.md §6);
//   (B) fewer: the leaf spread over the warp: the needing rays one after
//       another (read from the warp's staged rays), each lane testing its
//       four slots, a ballot of the lanes with a candidate nearer than the
//       ray's best t, a warp (t, slot) minimum (flat_common's
//       warp_min_hit) when several have one, the ray's lane keeping the
//       winner. The any-hit closes a ray by one __any_sync.
// Both give the lane's own visit of the leaf, so the choice decides only
// the time; a ray closed by the any-hit leaves the later chunks. The
// design it replaced, one 128-ray CTA with one cursor behind a
// __syncthreads_or at every node, every lane testing every leaf any lane
// admits, was timed against it in turns (PERF.md §6).
//
// Inputs:  o [R,3] f32; closest hit d [R,3] f32, t_prev [R] f32; any-hit
//          d [L,R,3] f32, t_max [L,R] f32 (L sets sharing o: blockIdx.y);
//          nodes6 [6,8,npad] f32; meta6 [6,2,npad] i32; tris [9,n_slots]
//          f32; lane_wise (1 to 33; 33 spreads every leaf); cut_widen.
// Outputs: closest hit fout [4,R] f32 rows (t, u, v, backface 0/1), iout
//          [R] i32 packed slot (-1 on a miss, t = +inf); any-hit out [L,R]
//          u8 (1 = occluded or dead).

#include "flat_common.cuh"

namespace {

using ptt::kFullMask;

constexpr int kGroup = 128;                  // rays of a layout group = CTA
constexpr int kWarps = kGroup / 32;
constexpr int kRayRows = 7;                  // o.xyz, d.xyz, gate value
constexpr int kLaneSlots = 4;                // slots a lane loads a chunk
constexpr int kChunk = 32 * kLaneSlots;      // slots of a chunk

// The group's layout: 2 * axis + (sum along axis < 0) from the pairwise
// sums of its directions.
__device__ int pick_layout(float dx, float dy, float dz,
                           float (*red)[kGroup]) {
  const int tid = threadIdx.x;
  red[0][tid] = dx;
  red[1][tid] = dy;
  red[2][tid] = dz;
  __syncthreads();
  for (int w = kGroup / 2; w >= 1; w >>= 1) {
    if (tid < w) {
      red[0][tid] += red[0][tid + w];
      red[1][tid] += red[1][tid + w];
      red[2][tid] += red[2][tid + w];
    }
    __syncthreads();
  }
  const float sx = red[0][0], sy = red[1][0], sz = red[2][0];
  const float ax = fabsf(sx), ay = fabsf(sy), az = fabsf(sz);
  const int axis = ax >= fmaxf(ay, az) ? 0 : (ay >= az ? 1 : 2);
  const float s = axis == 0 ? sx : (axis == 1 ? sy : sz);
  return 2 * axis + (s < 0.f ? 1 : 0);
}

struct Node {
  ptt::Box box;
  int skip, leaf;  // escape index; global block id + 1, 0 inside
};

__device__ __forceinline__ Node load_node(const float* __restrict__ nodes6,
                                          const int* __restrict__ meta6,
                                          int npad, int layout, int i) {
  const float* nb = nodes6 + (size_t)layout * 8 * npad + i;
  const int* mb = meta6 + (size_t)layout * 2 * npad + i;
  return Node{ptt::Box{__ldg(nb), __ldg(nb + npad), __ldg(nb + 2 * npad),
                       __ldg(nb + 3 * npad), __ldg(nb + 4 * npad),
                       __ldg(nb + 5 * npad)},
              __ldg(mb), __ldg(mb + npad)};
}

// The nine MT rows of one packed slot: v0, e1, e2.
struct Slot {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

__device__ __forceinline__ Slot load_slot(const float* __restrict__ tris,
                                          int n_slots, int j) {
  const float* s = tris + j;
  const size_t n = n_slots;
  return Slot{__ldg(s),         __ldg(s + n),     __ldg(s + 2 * n),
              __ldg(s + 3 * n), __ldg(s + 4 * n), __ldg(s + 5 * n),
              __ldg(s + 6 * n), __ldg(s + 7 * n), __ldg(s + 8 * n)};
}

// Stages a chunk's slots, held four a lane (slot q * 32 + lane in sl[q]),
// in the warp's slice of shared memory: row r of slot j at
// s_leaf[r * kChunk + j].
__device__ __forceinline__ void stage_chunk(float* s_leaf, const Slot* sl,
                                            int lane) {
  __syncwarp();  // the previous chunk has been read
#pragma unroll
  for (int q = 0; q < kLaneSlots; ++q) {
    float* s = s_leaf + q * 32 + lane;
    s[0] = sl[q].v0x; s[kChunk] = sl[q].v0y; s[2 * kChunk] = sl[q].v0z;
    s[3 * kChunk] = sl[q].e1x; s[4 * kChunk] = sl[q].e1y;
    s[5 * kChunk] = sl[q].e1z; s[6 * kChunk] = sl[q].e2x;
    s[7 * kChunk] = sl[q].e2y; s[8 * kChunk] = sl[q].e2z;
  }
  __syncwarp();
}

__device__ __forceinline__ Slot staged_slot(const float* s_leaf, int j) {
  const float* s = s_leaf + j;
  return Slot{s[0],          s[kChunk],     s[2 * kChunk],
              s[3 * kChunk], s[4 * kChunk], s[5 * kChunk],
              s[6 * kChunk], s[7 * kChunk], s[8 * kChunk]};
}

// Moller-Trumbore of one ray against one slot, in the Pallas kernel's
// expressions (ops/intersect.py's mt_rows): false when a test before the
// caller's t range fails; else t, u, v and det.
__device__ __forceinline__ bool mt(const Slot& s, float ox, float oy,
                                   float oz, float dx, float dy, float dz,
                                   float& t, float& u, float& v,
                                   float& det) {
  const float pvx = dy * s.e2z - dz * s.e2y;
  const float pvy = dz * s.e2x - dx * s.e2z;
  const float pvz = dx * s.e2y - dy * s.e2x;
  det = s.e1x * pvx + s.e1y * pvy + s.e1z * pvz;
  if (!(fabsf(det) >= ptt::kDetEps)) return false;
  const float invdet = 1.0f / det;
  const float tvx = ox - s.v0x, tvy = oy - s.v0y, tvz = oz - s.v0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
  if (!(u >= 0.f)) return false;
  const float qvx = tvy * s.e1z - tvz * s.e1y;
  const float qvy = tvz * s.e1x - tvx * s.e1z;
  const float qvz = tvx * s.e1y - tvy * s.e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
  if (!(v >= 0.f && u + v <= 1.f)) return false;
  t = (s.e2x * qvx + s.e2y * qvy + s.e2z * qvz) * invdet;
  return t >= ptt::kTMin;
}

// This thread's ray of the group: (o, d, gate value g) of ray i, or the
// padding lane's (o = 0, d = 1, g = pad_g) past R. Returns the layout.
__device__ __forceinline__ int load_group_ray(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ g, int i, int R, float pad_g,
    float (*red)[kGroup], float* r) {
  r[0] = r[1] = r[2] = 0.f;
  r[3] = r[4] = r[5] = 1.f;
  r[6] = pad_g;
  if (i < R) {
    r[0] = o[3 * (size_t)i]; r[1] = o[3 * (size_t)i + 1];
    r[2] = o[3 * (size_t)i + 2];
    r[3] = d[3 * (size_t)i]; r[4] = d[3 * (size_t)i + 1];
    r[5] = d[3 * (size_t)i + 2];
    r[6] = g[i];
  }
  return pick_layout(r[3], r[4], r[5], red);
}

// Stages the warp's rays, row k lane l = ray l's value k, for (B).
__device__ __forceinline__ void stage_rays(float* s_ray, int lane,
                                           const float* r) {
#pragma unroll
  for (int k = 0; k < kRayRows; ++k) s_ray[k * 32 + lane] = r[k];
  __syncwarp();
}

__global__ void __launch_bounds__(kGroup)
tree_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_prev,
                    const float* __restrict__ nodes6,
                    const int* __restrict__ meta6,
                    const float* __restrict__ tris, int R, int npad,
                    int n_nodes, int block, int n_slots, int lane_wise,
                    float cut_widen, float* __restrict__ fout,
                    int* __restrict__ iout) {
  __shared__ float red[3][kGroup];
  __shared__ float s_rays[kWarps][kRayRows * 32];
  __shared__ float s_leaves[kWarps][9 * kChunk];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kGroup + threadIdx.x;
  float r[kRayRows];
  const int layout = load_group_ray(o, d, t_prev, i, R, CUDART_INF_F, red,
                                    r);
  const float ox = r[0], oy = r[1], oz = r[2], dx = r[3], dy = r[4],
              dz = r[5], tp = r[6];
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
              iz = ptt::safe_inv(dz);
  float* s_ray = s_rays[threadIdx.x >> 5];
  float* s_leaf = s_leaves[threadIdx.x >> 5];
  stage_rays(s_ray, lane, r);

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  // A warp of dead lanes (t_prev = +inf) passes no gate: it skips the walk.
  int node = __any_sync(kFullMask, tp < CUDART_INF_F) ? 0 : n_nodes;
  while (node < n_nodes) {
    const Node nd = load_node(nodes6, meta6, npad, layout, node);
    float tn, tf;
    ptt::slab(ptt::pad_box(nd.box), ox, oy, oz, ix, iy, iz, tn, tf);
    ptt::pad_slab(tn, tf);
    const bool pass = tf >= ptt::max_nan(tn, 0.f) && tf > tp &&
                      tn <= bt * cut_widen;
    const unsigned need = __ballot_sync(kFullMask, pass);
    if (need && nd.leaf > 0) {
      const int start = (nd.leaf - 1) * block;
      const bool lane_per_ray = __popc(need) >= lane_wise;
      // The leaf a chunk at a time, its slots four a lane.
      for (int c0 = 0; c0 < block; c0 += kChunk) {
        Slot sl[kLaneSlots];
#pragma unroll
        for (int q = 0; q < kLaneSlots; ++q)
          sl[q] = load_slot(tris, n_slots, start + c0 + q * 32 + lane);
        if (lane_per_ray) {
          // (A) Lane per ray over the staged chunk; slots rise with j.
          stage_chunk(s_leaf, sl, lane);
          if (pass) {
#pragma unroll 4
            for (int j = 0; j < kChunk; ++j) {
              float t, u, v, det;
              if (mt(staged_slot(s_leaf, j), ox, oy, oz, dx, dy, dz, t, u,
                     v, det) &&
                  t > tp && t < bt) {
                bt = t; bu = u; bv = v; bb = det < 0.f ? 1.f : 0.f;
                bi = start + c0 + j;
              }
            }
          }
          continue;
        }
        // (B) The leaf over the warp.
        for (unsigned mm = need; mm; mm &= mm - 1) {
          const int s = __ffs(mm) - 1;  // the served ray
          const float sox = s_ray[s], soy = s_ray[32 + s],
                      soz = s_ray[64 + s], sdx = s_ray[96 + s],
                      sdy = s_ray[128 + s], sdz = s_ray[160 + s],
                      stp = s_ray[192 + s];
          const float sbt = __shfl_sync(kFullMask, bt, s);
          float lt = CUDART_INF_F, lu = 0.f, lv = 0.f, ldet = 0.f;
          int ls = INT_MAX;
#pragma unroll
          for (int q = 0; q < kLaneSlots; ++q) {
            float t, u, v, det;
            if (mt(sl[q], sox, soy, soz, sdx, sdy, sdz, t, u, v, det) &&
                t > stp && t < sbt && t < lt) {  // q rising: lower slot
              lt = t; lu = u; lv = v; ldet = det;
              ls = start + c0 + q * 32 + lane;
            }
          }
          const unsigned hm = __ballot_sync(kFullMask, lt < CUDART_INF_F);
          if (!hm) continue;
          int from = __ffs(hm) - 1;
          if (hm & (hm - 1)) {  // several candidate lanes: the (t, slot)
            float wt = lt;      // minimum
            int ws = ls, wl = lane;
            ptt::warp_min_hit(wt, ws, wl);
            from = wl;
          }
          const float wt = __shfl_sync(kFullMask, lt, from);
          const float wu = __shfl_sync(kFullMask, lu, from);
          const float wv = __shfl_sync(kFullMask, lv, from);
          const float wdet = __shfl_sync(kFullMask, ldet, from);
          const int ws = __shfl_sync(kFullMask, ls, from);
          if (lane == s) {
            bt = wt; bu = wu; bv = wv; bb = wdet < 0.f ? 1.f : 0.f;
            bi = ws;
          }
        }
      }
    }
    node = need && nd.leaf == 0 ? node + 1 : nd.skip;
  }
  if (i < R) {
    fout[i] = bt;
    fout[(size_t)R + i] = bu;
    fout[2 * (size_t)R + i] = bv;
    fout[3 * (size_t)R + i] = bb;
    iout[i] = bi;
  }
}

__global__ void __launch_bounds__(kGroup)
tree_occluded_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_max,
                     const float* __restrict__ nodes6,
                     const int* __restrict__ meta6,
                     const float* __restrict__ tris, int R, int npad,
                     int n_nodes, int block, int n_slots, int lane_wise,
                     unsigned char* __restrict__ out) {
  __shared__ float red[3][kGroup];
  __shared__ float s_rays[kWarps][kRayRows * 32];
  __shared__ float s_leaves[kWarps][9 * kChunk];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kGroup + threadIdx.x;
  const size_t set = blockIdx.y;
  float r[kRayRows];
  const int layout = load_group_ray(o, d + set * 3 * R, t_max + set * R, i,
                                    R, -1.f, red, r);
  const float ox = r[0], oy = r[1], oz = r[2], dx = r[3], dy = r[4],
              dz = r[5], tm = r[6];
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
              iz = ptt::safe_inv(dz);
  float* s_ray = s_rays[threadIdx.x >> 5];
  float* s_leaf = s_leaves[threadIdx.x >> 5];
  stage_rays(s_ray, lane, r);

  bool occ = tm < 0.f;  // dead and padding lanes start occluded
  int node = 0;
  while (node < n_nodes && __any_sync(kFullMask, !occ)) {
    const Node nd = load_node(nodes6, meta6, npad, layout, node);
    float tn, tf;
    ptt::slab(ptt::pad_box(nd.box), ox, oy, oz, ix, iy, iz, tn, tf);
    ptt::pad_slab(tn, tf);
    const bool pass = !occ && tf >= ptt::max_nan(tn, 0.f) && tn <= tm;
    unsigned need = __ballot_sync(kFullMask, pass);
    if (need && nd.leaf > 0) {
      const int start = (nd.leaf - 1) * block;
      const bool lane_per_ray = __popc(need) >= lane_wise;
      // The leaf a chunk at a time; a closed ray leaves the later chunks.
      for (int c0 = 0; c0 < block && need; c0 += kChunk) {
        Slot sl[kLaneSlots];
#pragma unroll
        for (int q = 0; q < kLaneSlots; ++q)
          sl[q] = load_slot(tris, n_slots, start + c0 + q * 32 + lane);
        if (lane_per_ray) {
          // (A) Lane per ray over the staged chunk, to its first hit.
          stage_chunk(s_leaf, sl, lane);
          if ((need >> lane) & 1u) {
            for (int j = 0; j < kChunk && !occ; ++j) {
              float t, u, v, det;
              occ = mt(staged_slot(s_leaf, j), ox, oy, oz, dx, dy, dz, t,
                       u, v, det) &&
                    t <= tm;
            }
          }
          need &= ~__ballot_sync(kFullMask, occ);
          continue;
        }
        // (B) The leaf over the warp.
        unsigned closed = 0u;
        for (unsigned mm = need; mm; mm &= mm - 1) {
          const int s = __ffs(mm) - 1;  // the served ray
          const float sox = s_ray[s], soy = s_ray[32 + s],
                      soz = s_ray[64 + s], sdx = s_ray[96 + s],
                      sdy = s_ray[128 + s], sdz = s_ray[160 + s],
                      stm = s_ray[192 + s];
          bool hit = false;
#pragma unroll
          for (int q = 0; q < kLaneSlots; ++q) {
            float t, u, v, det;
            hit = hit || (mt(sl[q], sox, soy, soz, sdx, sdy, sdz, t, u, v,
                             det) &&
                          t <= stm);
          }
          if (__any_sync(kFullMask, hit)) closed |= 1u << s;
        }
        need &= ~closed;
        occ = occ || ((closed >> lane) & 1u);
      }
    }
    node = need && nd.leaf == 0 ? node + 1 : nd.skip;
  }
  if (i < R) out[set * R + i] = occ ? 1 : 0;
}

}  // namespace

extern "C" int ptt_tree_closest_hit(const float* o, const float* d,
                                    const float* t_prev, const float* nodes6,
                                    const int* meta6, const float* tris,
                                    int R, int npad, int n_nodes, int block,
                                    int n_slots, int lane_wise,
                                    float cut_widen, float* fout, int* iout,
                                    int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (block <= 0 || block % kChunk) return (int)cudaErrorInvalidValue;
  const int groups = (R + kGroup - 1) / kGroup;
  tree_closest_kernel<<<groups, kGroup, 0, stream>>>(
      o, d, t_prev, nodes6, meta6, tris, R, npad, n_nodes, block, n_slots,
      lane_wise, cut_widen, fout, iout);
  return (int)cudaGetLastError();
}

extern "C" int ptt_tree_occluded(const float* o, const float* d,
                                 const float* t_max, const float* nodes6,
                                 const int* meta6, const float* tris, int R,
                                 int L, int npad, int n_nodes, int block,
                                 int n_slots, int lane_wise,
                                 unsigned char* out, int device,
                                 cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  if (block <= 0 || block % kChunk) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kGroup - 1) / kGroup, L);
  tree_occluded_kernel<<<grid, kGroup, 0, stream>>>(
      o, d, t_max, nodes6, meta6, tris, R, npad, n_nodes, block, n_slots,
      lane_wise, out);
  return (int)cudaGetLastError();
}
