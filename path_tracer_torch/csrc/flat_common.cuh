// Device helpers shared by the flat and flat2 block-walk kernels, the dense
// sphere kernel and the sphere block walk: the one place where the block
// slab test, the block walks, the Baldwin-Weber (BW) triangle test and the
// sphere root rules are written.
//
// The warp walk (kFullMask to warp_walk_smem) serves
// flat_closest_hit.cu, flat_occluded.cu, flat2_closest_hit.cu,
// flat2_occluded.cu, fused_shadow.cu, sph_walk.cu and sph_occ.cu's walk:
// each warp is its own packet, with no CTA barrier; its gate admits block
// columns with the mask of the rays they admit, and each admitted block is
// spread over the warp (or, in the sphere walks, served lane per ray when
// most of the warp needs it). safe_inv, Box, load_box, slab, the gates,
// sphere_nearest and sphere_occludes serve it and the dense kernels; the
// warp walk's bw_slot_closest and bw_slot_any repeat bw_plane's and bw_inside's
// arithmetic on a slot held in registers. pad_box and pad_slab widen the
// gates of the resident transparent walk (trwalk_common.cuh), the tree
// walk (tree_walk.cu), the flat and flat2 walks, row 3 (khit.cu) and the
// sphere any-hit walk (WidenedOccludedGate); the sphere closest-hit walk
// (sph_walk.cu) gates on exact boxes, its cut widened instead.
// TriRecord and write_sphere_record are the sphere closest hits' record
// and merge (sphere_closest_hit.cu, sph_walk.cu).
//
// Every expression is written in the order of the plain PyTorch versions
// (ops/cuda_bvh.py, ops/intersect.py), and the library is built -fmad=false,
// so each operation rounds as it does there.
#pragma once

#include <climits>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace ptt {

constexpr float kDetEps = 1e-6f;  // |d.n| (= |MT det|) cutoff
constexpr float kTMin = 1e-6f;    // triangle hits need t >= kTMin

// min/max that return NaN when either operand is NaN, as torch.minimum,
// torch.maximum and jnp.minimum do (fminf would drop the NaN).
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Reciprocal of a direction component; a zero component gives 1e30, not
// inf: (bound - o) * inf is NaN when the origin lies on a block plane,
// which would drop the block (pallas_bvh.py:582-590).
__device__ __forceinline__ float safe_inv(float x) {
  return x == 0.f ? 1e30f : 1.0f / x;
}

// One block AABB: column c of an [8, bpad] table (rows min.xyz, max.xyz).
struct Box {
  float x0, y0, z0, x1, y1, z1;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ blk,
                                        int bpad, int c) {
  return Box{blk[c], blk[bpad + c], blk[2 * bpad + c],
             blk[3 * bpad + c], blk[4 * bpad + c], blk[5 * bpad + c]};
}

// Slab entry tn and exit tf of one ray (origin o, inverted direction i)
// against one box.
__device__ __forceinline__ void slab(const Box& b, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float& tn, float& tf) {
  const float t0x = (b.x0 - ox) * ix;
  const float t1x = (b.x1 - ox) * ix;
  const float t0y = (b.y0 - oy) * iy;
  const float t1y = (b.y1 - oy) * iy;
  const float t0z = (b.z0 - oz) * iz;
  const float t1z = (b.z1 - oz) * iz;
  tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)),
               min_nan(t0z, t1z));
  tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)),
               max_nan(t0z, t1z));
}

// The widened boxes and slab intervals of the walks that gate a lane by its
// own slab test (trwalk_common.cuh's resident walk, tree_walk.cu, the flat
// and flat2 walks' warp_gate_mask and block gates, khit.cu, sph_occ.cu's
// walk). A box
// holds its triangles' vertices exactly, but a hit's rounded t and
// barycentrics can place a grazing hit (a ray through a vertex or an edge
// lying on the box) outside the rounded slab interval: by about 2^-24 of
// the coordinates' magnitude over the ray's direction component, far more
// than an ulp of t where that component is small. So each box is widened
// on every side by ext * 2^-12 + mag * 2^-16 (ext its largest side, mag its
// largest coordinate magnitude), and each lane's interval to
// tn - |tn| * 2^-16, tf + |tf| * 2^-16, which grows with the origin's
// distance from the box as a hit's rounding does. A widened box only
// admits more, and a child's widened box stays inside its parent's (every
// step is monotone). ops/slab.py pad_boxes and pad_slab are the same
// expressions.
constexpr float kPadExt = 0x1p-12f;
constexpr float kPadMag = 0x1p-16f;
constexpr float kPadT = 0x1p-16f;

__device__ __forceinline__ Box pad_box(const Box& b) {
  const float ext = fmaxf(fmaxf(b.x1 - b.x0, b.y1 - b.y0), b.z1 - b.z0);
  const float mag = fmaxf(fmaxf(fmaxf(fabsf(b.x0), fabsf(b.x1)),
                                fmaxf(fabsf(b.y0), fabsf(b.y1))),
                          fmaxf(fabsf(b.z0), fabsf(b.z1)));
  const float pad = ext * kPadExt + mag * kPadMag;
  return Box{b.x0 - pad, b.y0 - pad, b.z0 - pad,
             b.x1 + pad, b.y1 + pad, b.z1 + pad};
}

__device__ __forceinline__ void pad_slab(float& tn, float& tf) {
  tn = tn - fabsf(tn) * kPadT;
  tf = tf + fabsf(tf) * kPadT;
}

// Row 3's group gate (khit.cu):
// whether a lane's segment (0, tm] reaches box w, already widened by
// pad_box. Its own slab, as the Pallas kernel's: IEEE reciprocals i (inf on
// a zero component), a NaN bound on an axis (0 * inf, the origin on a box
// plane) opening that axis to all t; the interval widened by pad_slab.
// ops/cuda_khit.py _group_reach is the same expressions.
__device__ __forceinline__ void ieee_axis(float bmin, float bmax, float o,
                                          float inv, float& tn, float& tf) {
  const float lo = (bmin - o) * inv;
  const float hi = (bmax - o) * inv;
  const bool nan = isnan(lo) || isnan(hi);
  tn = nan ? -CUDART_INF_F : fminf(lo, hi);
  tf = nan ? CUDART_INF_F : fmaxf(lo, hi);
}

__device__ __forceinline__ bool khit_reach(const Box& w, float ox, float oy,
                                           float oz, float ix, float iy,
                                           float iz, float tm) {
  float tnx, tfx, tny, tfy, tnz, tfz;
  ieee_axis(w.x0, w.x1, ox, ix, tnx, tfx);
  ieee_axis(w.y0, w.y1, oy, iy, tny, tfy);
  ieee_axis(w.z0, w.z1, oz, iz, tnz, tfz);
  float tn = fmaxf(fmaxf(tnx, tny), tnz);
  float tf = fminf(fminf(tfx, tfy), tfz);
  pad_slab(tn, tf);
  return tf >= fmaxf(tn, 0.f) && tn <= tm;
}

// BW plane test of one triangle (rows n.xyz, c of the BW table at s[0..3]
// with row stride ld): returns t = (c - o.n) / (d.n) through the
// reciprocal, and d.n in dn; *ok is false when |d.n| < kDetEps.
__device__ __forceinline__ float bw_plane(const float* s, int ld, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float& dn,
                                          bool& ok) {
  const float n0 = s[0], n1 = s[ld], n2 = s[2 * ld];
  dn = dx * n0 + dy * n1 + dz * n2;
  ok = fabsf(dn) >= kDetEps;
  if (!ok) return 0.f;
  const float invdn = 1.0f / dn;
  const float on = ox * n0 + oy * n1 + oz * n2;
  return (s[3 * ld] - on) * invdn;
}

// BW barycentrics at the hit point h = o + t d (rows Au.xyz, au at s[4..7],
// Av.xyz, av at s[8..11]); true when u >= 0, v >= 0 and u + v <= 1.
__device__ __forceinline__ bool bw_inside(const float* s, int ld, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t,
                                          float& u, float& v) {
  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;
  u = hx * s[4 * ld] + hy * s[5 * ld] + hz * s[6 * ld] + s[7 * ld];
  if (!(u >= 0.f)) return false;
  v = hx * s[8 * ld] + hy * s[9 * ld] + hz * s[10 * ld] + s[11 * ld];
  return v >= 0.f && u + v <= 1.f;
}

// Nearest valid root of one sphere in the reference's centered form
// oc = o - c (never the expanded |o|^2 - 2 o.c + |c|^2, which cancels for
// rays that start on a sphere). A root is valid iff >= 0 and > tp; the
// near root wins, a valid far root alone is an inside hit (*far = true).
// The roots DIVIDE by 2a, as the plain version does. Returns +inf on a
// miss; padding spheres (center 1e30, radius 0) overflow to inf/NaN and
// never hit.
__device__ __forceinline__ float sphere_nearest(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float a, float two_a,
                                                float tp, float cx, float cy,
                                                float cz, float rad,
                                                bool& far) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - 4.0f * a * cc;
  far = false;
  if (!(disc >= 0.f)) return CUDART_INF_F;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) / two_a;
  const float t2 = (-b + sq) / two_a;
  const bool v1 = t1 >= 0.f && t1 > tp;
  const bool v2 = t2 >= 0.f && t2 > tp;
  far = !v1;
  return v1 ? t1 : (v2 ? t2 : CUDART_INF_F);
}

// Whether one sphere has a root t with 0 <= t <= tm, in the TPU any-hit
// kernels' naive quadratic (oc = o - c, b = 2 oc.d, c = |oc|^2 - r^2,
// disc = b^2 - 4ac, roots (-b -+ sqrt(disc)) inv2a, inv2a = 1 / (2a)), in
// the order of ops/cuda_spheres.py _any_root. Pad slots (center 1e30,
// radius 0) overflow to a NaN or -inf discriminant and never occlude.
__device__ __forceinline__ bool sphere_occludes(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float four_a, float inv2a,
                                                float tm, float cx, float cy,
                                                float cz, float rad) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float b = 2.0f * (ocx * dx + ocy * dy + ocz * dz);
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = b * b - four_a * cc;
  if (!(disc >= 0.f)) return false;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * inv2a;
  if (t1 >= 0.f && t1 <= tm) return true;
  const float t2 = (-b + sq) * inv2a;
  return t2 >= 0.f && t2 <= tm;
}

// A triangle HitRecord to merge into a sphere closest hit's record, field
// by field ([R] each): null pointers for none.
struct TriRecord {
  const float* t;
  const float* u;
  const float* v;
  const int* kind;
  const int* prim;
  const unsigned char* back;
};

constexpr int kKindSphere = 2;

// Writes lane i's HitRecord (ops/intersect.py), fout [3,R] rows t, u, v,
// iout [2,R] rows kind, prim and bout [R] backface: the sphere hit (t,
// prim, back; kind 2 and u = v = 0; the caller passes prim 0 on a miss,
// t = +inf), unless tri holds a record whose t is no larger. That is
// closest_hit's merge (merge_hits): the triangle wins ties and, both t
// +inf, keeps its miss record.
__device__ __forceinline__ void write_sphere_record(
    const TriRecord& tri, int i, int R, float t, int prim, bool back,
    float* __restrict__ fout, int* __restrict__ iout,
    unsigned char* __restrict__ bout) {
  float u = 0.f, v = 0.f;
  int kind = t < CUDART_INF_F ? kKindSphere : 0;
  if (tri.t) {
    const float tt = tri.t[i];
    if (tt <= t) {
      t = tt; u = tri.u[i]; v = tri.v[i]; kind = tri.kind[i];
      prim = tri.prim[i]; back = tri.back[i] != 0;
    }
  }
  fout[i] = t;
  fout[(size_t)R + i] = u;
  fout[2 * (size_t)R + i] = v;
  iout[i] = kind;
  iout[(size_t)R + i] = prim;
  bout[i] = back ? 1 : 0;
}

// Slab gates of a live lane. Closest hit (g = t_prev, live while < +inf):
// the box lies ahead of the ray and beyond t_prev. Any-hit (g = t_max, live
// while >= 0): the box lies ahead and its entry no farther than t_max.
struct ClosestGate {
  __device__ bool live(float tp) const { return tp < CUDART_INF_F; }
  __device__ bool pass(float tn, float tf, float tp) const {
    return tf >= max_nan(tn, 0.f) && tf > tp;
  }
};

struct OccludedGate {
  __device__ bool live(float tm) const { return tm >= 0.f; }
  __device__ bool pass(float tn, float tf, float tm) const {
    return tf >= max_nan(tn, 0.f) && tn <= tm;
  }
};

// The any-hit gate of the sphere any-hit walk (sph_occ.cu), on boxes
// widened by pad_box: each
// lane's interval widened by pad_slab, then OccludedGate's test
// (ops/slab.py padded_slab, then occluded_gate).
struct WidenedOccludedGate {
  __device__ bool live(float tm) const { return tm >= 0.f; }
  __device__ bool pass(float tn, float tf, float tm) const {
    pad_slab(tn, tf);
    return OccludedGate().pass(tn, tf, tm);
  }
};

// The flat block tables of one walk: blk [8, bpad] AABBs, blkid [bpad],
// bw [16, n_cols] Baldwin-Weber rows in blocks of 'block' slots.
struct FlatTable {
  const float* blk;
  const int* blkid;
  const float* bw;
  int bpad;
  int block;
  int n_cols;
};

// ---- The warp walk (flat_closest_hit.cu, flat_occluded.cu,
// flat2_closest_hit.cu and flat2_occluded.cu) ----

constexpr unsigned kFullMask = 0xffffffffu;

// Warp-wide lexicographic minimum of (t, slot), carrying the lane that
// holds it; every lane gets the result.
__device__ __forceinline__ void warp_min_hit(float& t, int& slot,
                                             int& lane) {
  for (int off = 16; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(kFullMask, t, off);
    const int s2 = __shfl_xor_sync(kFullMask, slot, off);
    const int l2 = __shfl_xor_sync(kFullMask, lane, off);
    if (t2 < t || (t2 == t && s2 < slot)) { t = t2; slot = s2; lane = l2; }
  }
}

// The 12 used BW rows of one packed slot, held in registers: n.xyz, c,
// Au.xyz, au, Av.xyz, av.
struct BwSlot {
  float n0, n1, n2, c, a0, a1, a2, a3, b0, b1, b2, b3;
};

// Slot rows at src[r * ld], r < 12, read through the read-only cache.
__device__ __forceinline__ BwSlot load_bw_slot(const float* __restrict__ src,
                                               int ld) {
  return BwSlot{__ldg(src),          __ldg(src + ld),
                __ldg(src + 2 * ld), __ldg(src + 3 * ld),
                __ldg(src + 4 * ld), __ldg(src + 5 * ld),
                __ldg(src + 6 * ld), __ldg(src + 7 * ld),
                __ldg(src + 8 * ld), __ldg(src + 9 * ld),
                __ldg(src + 10 * ld), __ldg(src + 11 * ld)};
}

// Closest-hit BW test of one ray against one slot in registers, in the
// arithmetic and order of bw_plane and bw_inside: t when |d.n| >= kDetEps,
// t >= kTMin, tp < t <= hi and u >= 0, v >= 0, u + v <= 1 (u, v and d.n
// beside it); +inf otherwise. An accepted t is finite: t = +inf makes u + v
// infinite or NaN.
__device__ __forceinline__ float bw_slot_closest(const BwSlot& s, float ox,
                                                 float oy, float oz, float dx,
                                                 float dy, float dz, float tp,
                                                 float hi, float& u, float& v,
                                                 float& dn) {
  dn = dx * s.n0 + dy * s.n1 + dz * s.n2;
  if (!(fabsf(dn) >= kDetEps)) return CUDART_INF_F;
  const float invdn = 1.0f / dn;
  const float on = ox * s.n0 + oy * s.n1 + oz * s.n2;
  const float t = (s.c - on) * invdn;
  if (!(t >= kTMin && t > tp && t <= hi)) return CUDART_INF_F;
  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;
  u = hx * s.a0 + hy * s.a1 + hz * s.a2 + s.a3;
  if (!(u >= 0.f)) return CUDART_INF_F;
  v = hx * s.b0 + hy * s.b1 + hz * s.b2 + s.b3;
  if (!(v >= 0.f && u + v <= 1.f)) return CUDART_INF_F;
  return t;
}

// Any-hit BW test of one ray against one slot in registers, in the
// arithmetic and order of bw_plane and bw_inside (as occluded_block): true
// when |d.n| >= kDetEps, kTMin <= t <= tm and u >= 0, v >= 0, u + v <= 1.
__device__ __forceinline__ bool bw_slot_any(const BwSlot& s, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float tm) {
  const float dn = dx * s.n0 + dy * s.n1 + dz * s.n2;
  if (!(fabsf(dn) >= kDetEps)) return false;
  const float invdn = 1.0f / dn;
  const float on = ox * s.n0 + oy * s.n1 + oz * s.n2;
  const float t = (s.c - on) * invdn;
  if (!(t >= kTMin && t <= tm)) return false;
  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;
  const float u = hx * s.a0 + hy * s.a1 + hz * s.a2 + s.a3;
  if (!(u >= 0.f)) return false;
  const float v = hx * s.b0 + hy * s.b1 + hz * s.b2 + s.b3;
  return v >= 0.f && u + v <= 1.f;
}

// A warp's staged rays: kWarpRayRows rows of 32 floats in its slice of
// shared memory, lane k's ray in column k: o.xyz, 1/d.xyz, the gate value
// g (t_prev for the closest hit, t_max for the any-hit), d.xyz.
constexpr int kWarpRayRows = 10;
constexpr int kRowG = 6 * 32;  // offsets of g and d.xyz in the rows
constexpr int kRowD = 7 * 32;
constexpr int kWarpSlots = 4;                   // slots a lane holds
constexpr int kWarpChunk = 32 * kWarpSlots;     // slots of a block chunk
constexpr size_t kMaxSmem = 232448;  // shared memory a CTA may use (H100)

__device__ __forceinline__ void stage_warp_rays(float* s_ray, int lane,
                                                float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float g) {
  const float row[kWarpRayRows] = {ox, oy, oz, safe_inv(dx), safe_inv(dy),
                                   safe_inv(dz), g, dx, dy, dz};
#pragma unroll
  for (int r = 0; r < kWarpRayRows; ++r) s_ray[r * 32 + lane] = row[r];
  __syncwarp();
}

// The mask of the warp's staged rays whose gate admits box, widened by
// pad_box, each ray's interval widened by pad_slab (all 32 rays unrolled:
// independent chains): the flat and flat2 walks' block and superblock gate.
// A dead ray's g must fail the gate, or the caller masks it out.
template <class Gate>
__device__ __forceinline__ unsigned warp_gate_mask(const Box& box,
                                                   const float* s_ray,
                                                   Gate gate) {
  const Box w = pad_box(box);
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    float tn, tf;
    slab(w, s_ray[k], s_ray[32 + k], s_ray[64 + k], s_ray[96 + k],
         s_ray[128 + k], s_ray[160 + k], tn, tf);
    pad_slab(tn, tf);
    if (gate.pass(tn, tf, s_ray[kRowG + k])) mask |= 1u << k;
  }
  return mask;
}

// The mask of the warp's staged rays whose gate admits box as given (no
// widening here: sph_walk.cu gates on exact boxes, sph_occ.cu's walk
// passes a pad_box box and WidenedOccludedGate), and in key the nearest
// slab entry, clamped at 0, over the rays it admits (+inf for none).
template <class Gate>
__device__ __forceinline__ unsigned warp_gate_mask_key(const Box& box,
                                                       const float* s_ray,
                                                       Gate gate,
                                                       float& key) {
  unsigned mask = 0u;
  key = CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    float tn, tf;
    slab(box, s_ray[k], s_ray[32 + k], s_ray[64 + k], s_ray[96 + k],
         s_ray[128 + k], s_ray[160 + k], tn, tf);
    if (gate.pass(tn, tf, s_ray[kRowG + k])) {
      mask |= 1u << k;
      key = fminf(key, max_nan(tn, 0.f));
    }
  }
  return mask;
}

// Appends (c, mask) at entry m of the warp's list where mask is not 0;
// every lane calls it, and each gets the list's new length.
__device__ __forceinline__ int warp_append(int* s_col, unsigned* s_mask,
                                           int m, int lane, int c,
                                           unsigned mask) {
  const unsigned any = __ballot_sync(kFullMask, mask != 0u);
  if (mask) {
    const int p = m + __popc(any & ((1u << lane) - 1u));
    s_col[p] = c;
    s_mask[p] = mask;
  }
  return m + __popc(any);
}

// The closest-hit visit of block b (bw columns [b * block, (b + 1) *
// block), block a multiple of kWarpChunk) by the warp: the block is taken
// kWarpChunk slots at a time, lane l holding slots l, l + 32, l + 64,
// l + 96 of the chunk in registers (12 rows each, coalesced). The rays of
// need are served one after another: every lane tests its slots against
// the served ray (read from s_ray, its best t by shuffle), a ballot finds
// the lanes with a candidate no farther than that best t, one candidate
// lane is read directly and several take a warp (t, slot) minimum, and the
// served lane merges the winner into (bt, bu, bv, bb, bi) by the tie rule:
// the lexicographic (t, packed slot) minimum, so neither the visit order
// nor which lane tests a slot decides it.
__device__ __forceinline__ void warp_closest_block(
    const float* __restrict__ bw, int b, int block, int n_cols,
    unsigned need, const float* s_ray, int lane, float& bt, float& bu,
    float& bv, float& bb, int& bi) {
  const float* src = bw + (size_t)b * block;
  for (int ch = 0; ch < block; ch += kWarpChunk) {
    BwSlot sl[kWarpSlots];
#pragma unroll
    for (int q = 0; q < kWarpSlots; ++q)
      sl[q] = load_bw_slot(src + ch + q * 32 + lane, n_cols);
    for (unsigned mm = need; mm; mm &= mm - 1) {
      const int s = __ffs(mm) - 1;  // the served ray
      const float sox = s_ray[s], soy = s_ray[32 + s], soz = s_ray[64 + s],
                  stp = s_ray[kRowG + s], sdx = s_ray[kRowD + s],
                  sdy = s_ray[kRowD + 32 + s], sdz = s_ray[kRowD + 64 + s];
      const float sbt = __shfl_sync(kFullMask, bt, s);
      float lt = CUDART_INF_F, lu = 0.f, lv = 0.f, ldn = 0.f;
      int ls = INT_MAX;
#pragma unroll
      for (int q = 0; q < kWarpSlots; ++q) {
        float u, v, dn;
        const float t = bw_slot_closest(sl[q], sox, soy, soz, sdx, sdy, sdz,
                                        stp, sbt, u, v, dn);
        if (t < lt) {  // slots rise with q: the lower slot keeps ties
          lt = t; lu = u; lv = v; ldn = dn;
          ls = b * block + ch + q * 32 + lane;
        }
      }
      const unsigned hm = __ballot_sync(kFullMask, lt < CUDART_INF_F);
      if (!hm) continue;
      int from = __ffs(hm) - 1;
      if (hm & (hm - 1)) {  // several candidate lanes: the (t, slot) min
        float wt = lt;
        int ws = ls, wl = lane;
        warp_min_hit(wt, ws, wl);
        from = wl;
      }
      const float wt = __shfl_sync(kFullMask, lt, from);
      const float wu = __shfl_sync(kFullMask, lu, from);
      const float wv = __shfl_sync(kFullMask, lv, from);
      const float wdn = __shfl_sync(kFullMask, ldn, from);
      const int ws = __shfl_sync(kFullMask, ls, from);
      if (lane == s && (wt < bt || (wt == bt && ws < bi))) {
        bt = wt; bu = wu; bv = wv; bb = wdn > 0.f ? 1.f : 0.f; bi = ws;
      }
    }
  }
}

// The any-hit visit of block b by the warp, spread as warp_closest_block
// spreads it: the rays of need are served one after another, and a served
// ray is occluded when any lane's slots hold a hit with kTMin <= t <= its
// t_max (an __any_sync); an occluded ray leaves the later chunks. Returns
// the rays of need found occluded.
__device__ __forceinline__ unsigned warp_any_block(
    const float* __restrict__ bw, int b, int block, int n_cols,
    unsigned need, const float* s_ray, int lane) {
  const float* src = bw + (size_t)b * block;
  unsigned occ = 0u;
  for (int ch = 0; ch < block && need; ch += kWarpChunk) {
    BwSlot sl[kWarpSlots];
#pragma unroll
    for (int q = 0; q < kWarpSlots; ++q)
      sl[q] = load_bw_slot(src + ch + q * 32 + lane, n_cols);
    for (unsigned mm = need; mm; mm &= mm - 1) {
      const int s = __ffs(mm) - 1;  // the served ray
      const float sox = s_ray[s], soy = s_ray[32 + s], soz = s_ray[64 + s],
                  stm = s_ray[kRowG + s], sdx = s_ray[kRowD + s],
                  sdy = s_ray[kRowD + 32 + s], sdz = s_ray[kRowD + 64 + s];
      bool hit = false;
#pragma unroll
      for (int q = 0; q < kWarpSlots; ++q)
        hit = hit || bw_slot_any(sl[q], sox, soy, soz, sdx, sdy, sdz, stm);
      if (__any_sync(kFullMask, hit)) occ |= 1u << s;
    }
    need &= ~occ;
  }
  return occ;
}

// Dynamic shared memory of a warp-walk kernel whose warps take per_warp
// bytes each: the number of warps a CTA holds (up to 'warps', fewer where
// they outgrow shared memory; 0 when one does not fit) and the bytes,
// with the kernel's limit raised above the default 48 KB.
template <class Kernel>
inline cudaError_t warp_walk_smem(Kernel kernel, size_t per_warp,
                                  int& warps, size_t& bytes) {
  while (warps > 1 && warps * per_warp > kMaxSmem) --warps;
  if (warps * per_warp > kMaxSmem) return cudaErrorInvalidValue;
  bytes = warps * per_warp;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The host queries behind a persistent kernel's launch shape, made once per
// (kernel, device, threads, shared memory size): the render launches such
// kernels hundreds of times a sample, and the answers change with none of
// the launch's other arguments. The first size past 48 KB raises the
// (kernel, device)'s dynamic shared memory limit to kMaxSmem, so every
// later size fits.
struct ResidentShape {
  const void* kernel;
  int device, threads;
  size_t smem;
  int sms, per_sm;
};

// Launch shape of a persistent kernel of 'threads' threads a CTA and 'smem'
// bytes of dynamic shared memory over 'units' warp units (32 lanes each):
// as many CTAs as fit on the card, never more than the units fill.
template <class Kernel>
inline cudaError_t resident_launch_shape(Kernel kernel, size_t smem,
                                         int threads, int units, int device,
                                         int& blocks) {
  static std::mutex mu;
  static std::vector<ResidentShape> known;
  const void* key = reinterpret_cast<const void*>(kernel);
  ResidentShape shape{key, device, threads, smem, 0, 0};
  {
    std::lock_guard<std::mutex> lock(mu);
    bool raised = false, found = false;
    for (const ResidentShape& k : known) {
      if (k.kernel != key || k.device != device) continue;
      raised |= k.smem > 48 * 1024;
      if (k.smem == smem && k.threads == threads) {
        shape = k;
        found = true;
        break;
      }
    }
    if (!found) {
      cudaError_t err = cudaSuccess;
      if (smem > 48 * 1024 && !raised)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kMaxSmem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&shape.sms,
                                     cudaDevAttrMultiProcessorCount, device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &shape.per_sm, kernel, threads, smem);
      if (err != cudaSuccess) return err;
      known.push_back(shape);
    }
  }
  const int warps = threads / 32;
  const int work = (units + warps - 1) / warps;
  blocks = min(work, max(shape.per_sm, 1) * shape.sms);
  return cudaSuccess;
}

}  // namespace ptt
