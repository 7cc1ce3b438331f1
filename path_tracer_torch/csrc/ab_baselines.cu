// The design the superleaf tree walk (tree_walk.cu, rows 7 and 8)
// replaced, kept unchanged under its own symbols only to be timed against
// the new design in turns on the same card and to log where the two
// differ; no wrapper of the main path reaches it (chip_smoke.py's phase 3n
// calls it through ops/ab_baselines.py).
//
// The Pallas packet carried over: one CTA of 128 rays per packet with one
// node cursor, a __syncthreads_or at every node; a leaf some lane's gate
// admits (closest hit: tf >= max(tn, 0), tn <= its best t, unwidened,
// and tf > t_prev; any-hit: not yet occluded, tf >= max(tn, 0) and
// tn <= t_max) is tested by EVERY lane, staged in shared memory 128 slots
// at a time behind two barriers. Padding lanes are as the Pallas wrappers
// pad (t_prev 0, so they take part in the closest-hit cursor; t_max -1).
//
// ptt_tree_closest_hit_cta takes (o, d, t_prev, nodes6, meta6, tris, R,
// npad, n_nodes, block, n_slots, fout, iout) and writes fout [4,R] (t, u,
// v, backface 0/1) and iout [R] packed slot; ptt_tree_occluded_cta takes
// (o, d, t_max, ..., n_slots, out) for one set and writes out [R] f32
// (1 = occluded or dead).

#include "flat_common.cuh"

namespace {

constexpr int kTile = 128;  // rays per packet = threads per CTA
constexpr int kChunk = 128;  // slots staged at a time (one per thread)

// The packet's layout: 2 * axis + (sum along axis < 0) from the pairwise
// sums of its directions.
__device__ int pick_layout(float dx, float dy, float dz,
                           float (*red)[kTile]) {
  const int tid = threadIdx.x;
  red[0][tid] = dx;
  red[1][tid] = dy;
  red[2][tid] = dz;
  __syncthreads();
  for (int w = kTile / 2; w >= 1; w >>= 1) {
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
  const float* nb = nodes6 + (size_t)layout * 8 * npad;
  const int* mb = meta6 + (size_t)layout * 2 * npad;
  return Node{ptt::Box{nb[i], nb[npad + i], nb[2 * npad + i],
                       nb[3 * npad + i], nb[4 * npad + i], nb[5 * npad + i]},
              mb[i], mb[npad + i]};
}

// Stage slots [first, first + kChunk) of the MT rows (one per thread).
__device__ __forceinline__ void stage(const float* __restrict__ tris,
                                      int n_slots, int first,
                                      float (*s)[kChunk]) {
#pragma unroll
  for (int r = 0; r < 9; ++r)
    s[r][threadIdx.x] = tris[(size_t)r * n_slots + first + threadIdx.x];
}

// Moller-Trumbore of one ray against staged slot j, in the Pallas
// kernel's expressions: false when a test before the caller's t range
// fails; else t, u, v and det.
__device__ __forceinline__ bool mt(float (*s)[kChunk], int j, float ox,
                                   float oy, float oz, float dx, float dy,
                                   float dz, float& t, float& u, float& v,
                                   float& det) {
  const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
  const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) >= ptt::kDetEps)) return false;
  const float invdet = 1.0f / det;
  const float tvx = ox - s[0][j], tvy = oy - s[1][j], tvz = oz - s[2][j];
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
  if (!(u >= 0.f)) return false;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
  if (!(v >= 0.f && u + v <= 1.f)) return false;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
  return t >= ptt::kTMin;
}

__global__ void __launch_bounds__(kTile)
tree_closest_cta_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_prev,
                        const float* __restrict__ nodes6,
                        const int* __restrict__ meta6,
                        const float* __restrict__ tris, int R, int npad,
                        int n_nodes, int block, int n_slots,
                        float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float red[3][kTile];
  __shared__ float s[9][kChunk];
  const int i = blockIdx.x * kTile + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tp = 0.f;
  if (i < R) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tp = t_prev[i];
  }
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
              iz = ptt::safe_inv(dz);
  const int layout = pick_layout(dx, dy, dz, red);

  float bt = CUDART_INF_F, bu = 0.f, bv = 0.f, bb = 0.f;
  int bi = -1;
  int node = 0;
  while (node < n_nodes) {
    const Node nd = load_node(nodes6, meta6, npad, layout, node);
    float tn, tf;
    ptt::slab(nd.box, ox, oy, oz, ix, iy, iz, tn, tf);
    const bool lane = tf >= ptt::max_nan(tn, 0.f) && tn <= bt && tf > tp;
    const bool any = __syncthreads_or(lane);
    if (any && nd.leaf > 0) {
      // Every lane tests the block; its nearest slot (the lowest among
      // equal t) replaces the record only on a strictly smaller t.
      const int start = (nd.leaf - 1) * block;
      float lt = CUDART_INF_F, lu = 0.f, lv = 0.f, ldet = 0.f;
      int lc = 0;
      for (int c0 = 0; c0 < block; c0 += kChunk) {
        stage(tris, n_slots, start + c0, s);
        __syncthreads();
        for (int j = 0; j < kChunk; ++j) {
          float t, u, v, det;
          if (mt(s, j, ox, oy, oz, dx, dy, dz, t, u, v, det) && t > tp &&
              t < lt) {
            lt = t; lu = u; lv = v; ldet = det; lc = c0 + j;
          }
        }
        __syncthreads();  // the chunk is read before the next is staged
      }
      if (lt < bt) {
        bt = lt; bu = lu; bv = lv; bb = ldet < 0.f ? 1.f : 0.f;
        bi = start + lc;
      }
    }
    node = any && nd.leaf == 0 ? node + 1 : nd.skip;
  }
  if (i < R) {
    fout[i] = bt;
    fout[(size_t)R + i] = bu;
    fout[2 * (size_t)R + i] = bv;
    fout[3 * (size_t)R + i] = bb;
    iout[i] = bi;
  }
}

__global__ void __launch_bounds__(kTile)
tree_occluded_cta_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_max,
                         const float* __restrict__ nodes6,
                         const int* __restrict__ meta6,
                         const float* __restrict__ tris, int R, int npad,
                         int n_nodes, int block, int n_slots,
                         float* __restrict__ out) {
  __shared__ float red[3][kTile];
  __shared__ float s[9][kChunk];
  const int i = blockIdx.x * kTile + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (i < R) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = t_max[i];
  }
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy),
              iz = ptt::safe_inv(dz);
  const int layout = pick_layout(dx, dy, dz, red);

  bool occ = tm < 0.f;  // dead and padding lanes start occluded
  int node = 0;
  while (node < n_nodes && __syncthreads_or(!occ)) {
    const Node nd = load_node(nodes6, meta6, npad, layout, node);
    float tn, tf;
    ptt::slab(nd.box, ox, oy, oz, ix, iy, iz, tn, tf);
    const bool lane = !occ && tf >= ptt::max_nan(tn, 0.f) && tn <= tm;
    const bool any = __syncthreads_or(lane);
    if (any && nd.leaf > 0) {
      const int start = (nd.leaf - 1) * block;
      for (int c0 = 0; c0 < block; c0 += kChunk) {
        stage(tris, n_slots, start + c0, s);
        __syncthreads();
        for (int j = 0; j < kChunk && !occ; ++j) {
          float t, u, v, det;
          occ = mt(s, j, ox, oy, oz, dx, dy, dz, t, u, v, det) && t <= tm;
        }
        __syncthreads();
      }
    }
    node = any && nd.leaf == 0 ? node + 1 : nd.skip;
  }
  if (i < R) out[i] = occ ? 1.f : 0.f;
}

}  // namespace

extern "C" int ptt_tree_closest_hit_cta(const float* o, const float* d,
                                        const float* t_prev,
                                        const float* nodes6, const int* meta6,
                                        const float* tris, int R, int npad,
                                        int n_nodes, int block, int n_slots,
                                        float* fout, int* iout, int device,
                                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (block <= 0 || block % kChunk) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kTile - 1) / kTile;
  tree_closest_cta_kernel<<<blocks, kTile, 0, stream>>>(
      o, d, t_prev, nodes6, meta6, tris, R, npad, n_nodes, block, n_slots,
      fout, iout);
  return (int)cudaGetLastError();
}

extern "C" int ptt_tree_occluded_cta(const float* o, const float* d,
                                     const float* t_max, const float* nodes6,
                                     const int* meta6, const float* tris,
                                     int R, int npad, int n_nodes, int block,
                                     int n_slots, float* out, int device,
                                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (block <= 0 || block % kChunk) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kTile - 1) / kTile;
  tree_occluded_cta_kernel<<<blocks, kTile, 0, stream>>>(
      o, d, t_max, nodes6, meta6, tris, R, npad, n_nodes, block, n_slots,
      out);
  return (int)cudaGetLastError();
}
