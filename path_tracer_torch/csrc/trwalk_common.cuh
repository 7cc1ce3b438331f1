// Device helpers shared by the transparent-walk kernels: the compact
// transparent table, the candidate test and the opacity texel fetch, and
// the resident walk over the table (alpha_walk.cu, trans_walk.cu and the
// walk phase of fused_shadow.cu): each CTA stages the table's 12 used
// Baldwin-Weber rows, the 128-column groups' boxes and the LUT in shared
// memory once, and every lane then walks on its own, with no barrier: one
// pass over the groups its segment enters collects its nearest candidates,
// sorted in registers, and the steps consume that list.
//
// Every helper is a template on the page plane's texel type: unsigned char
// codes through the LUT (forward rendering, the JAX package's live=False),
// or float values read directly (the live variant of a differentiable
// render, live=True: the wrapper passes the plane rebuilt from the live
// atlas and the rows with the live opacity factors). The walk is the same
// code in both; only the texel fetch differs. The f32 plane stays in device
// memory (L2-resident for the showcase's pages), as the u8 plane does.
//
// The candidate test is flat_common.cuh's Baldwin-Weber test (which is the
// Pallas kernels' _eval_cols expression for expression); every expression
// keeps the order of the plain versions (ops/trwalk.py), and the library is
// built -fmad=false, so each operation rounds as it does there.
#pragma once

#include "flat_common.cuh"
#include "klist.cuh"

namespace ptt {

// The compact transparent table and the opacity pages, all in device
// memory: bw [16, T] (rows n.xyz, c, Au.xyz, au, Av.xyz, av, 4 zero), rows
// [9, T] (uv0.xy, (uv1-uv0).xy, (uv2-uv0).xy, factor, has texture, page),
// tex [Hp, wp] texels (u8 codes or f32 values), lut [256] code -> value,
// pages [P, 3] (w, h, first row). T is a multiple of 128.
template <class Texel>
struct TrTable {
  const float* bw;
  const float* rows;
  const Texel* tex;
  const float* lut;
  const int* pages;
  int T;
  int wp;
};

// Euclidean remainder of i by n > 0.
__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// A texel's value: a u8 code through the LUT in s_lut, or an f32 value as
// it is (the live plane).
__device__ __forceinline__ float texel_value(unsigned char code,
                                             const float* s_lut) {
  return s_lut[code];
}
__device__ __forceinline__ float texel_value(float value, const float*) {
  return value;
}

// Nearest texel of page 'page' at (uvx, uvy): uv * size truncated toward
// zero to int32 (cvt.rzi: saturating, NaN -> 0), wrapped, offset by the
// page's first row; its value (texel_value).
template <class Texel>
__device__ __forceinline__ float page_texel(const TrTable<Texel>& tb,
                                            const float* s_lut, float uvx,
                                            float uvy, int page) {
  const int w = tb.pages[3 * page], h = tb.pages[3 * page + 1];
  const int ix = wrap(__float2int_rz(uvx * (float)w), w);
  const int iy = wrap(__float2int_rz(uvy * (float)h), h) + tb.pages[3 * page + 2];
  return texel_value(tb.tex[(size_t)iy * tb.wp + ix], s_lut);
}

// The candidate's own texture coordinates: uv0 + u (uv1-uv0) + v (uv2-uv0).
template <class Texel>
__device__ __forceinline__ void column_uv(const TrTable<Texel>& tb, int col,
                                          float u,
                                          float v, float& uvx, float& uvy) {
  const float* r = tb.rows + col;
  const int T = tb.T;
  uvx = r[0] + u * r[2 * T] + v * r[4 * T];
  uvy = r[T] + u * r[3 * T] + v * r[5 * T];
}

// ---------------------------------------------------------------------------
// The resident walk
// ---------------------------------------------------------------------------

constexpr int kResThreads = 256;   // threads per CTA: 8 warps
constexpr int kRec = 12;           // floats per column record in shared memory
constexpr int kGroup = 128;        // columns per gate group
constexpr int kGrpRec = 8;         // floats per group record
constexpr int kMaxColumns = 4096;  // 32 groups: one bit each of a lane's mask
constexpr int kMaxList = 8;        // the sorted list's length at most

// Each group's box is widened as it is staged, and each lane's slab
// interval with it (flat_common.cuh's pad_box and pad_slab): a candidate's
// rounded t and barycentrics can place a grazing hit outside the rounded
// slab interval of its group's exact box. The widening only admits more
// groups; every admitted group is tested column by column, so it changes
// no result (ops/trwalk.py resident_gate; tests/test_torch_walk_gate.py
// holds both widenings on rays from 10^2 to 10^3 group extents away).

// Bytes of shared memory the resident table of T columns takes.
__host__ __device__ constexpr size_t resident_smem(int T) {
  return (size_t)(T * kRec + (T / kGroup) * kGrpRec + 256) * sizeof(float);
}

// The table staged in shared memory: bw [T][kRec] (each column's 12 used
// Baldwin-Weber rows as one 48-byte record), grp [G][kGrpRec] (the padded
// box min.xyz, max.xyz, the valid flag, 0) and the LUT [256].
struct Resident {
  const float* bw;
  const float* grp;
  const float* lut;
  int G;
};

// Stages the table (tr_grp [7, gp]: min.xyz, max.xyz, valid) in smem and
// waits for the CTA: the kernel's only barrier.
template <class Texel>
__device__ __forceinline__ Resident stage_resident(const TrTable<Texel>& tb,
                                                   const float* grp, int gp,
                                                   float* smem) {
  const int T = tb.T, G = T / kGroup;
  float* s_bw = smem;
  float* s_grp = s_bw + T * kRec;
  float* s_lut = s_grp + G * kGrpRec;
  for (int idx = threadIdx.x; idx < kRec * T; idx += blockDim.x) {
    const int r = idx / T, c = idx - r * T;
    s_bw[c * kRec + r] = tb.bw[idx];
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const Box w = pad_box(load_box(grp, gp, g));
    float* b = s_grp + g * kGrpRec;
    b[0] = w.x0; b[1] = w.y0; b[2] = w.z0;
    b[3] = w.x1; b[4] = w.y1; b[5] = w.z1;
    b[6] = grp[6 * gp + g];
    b[7] = 0.f;
  }
  for (int k = threadIdx.x; k < 256; k += blockDim.x) s_lut[k] = tb.lut[k];
  __syncthreads();
  return Resident{s_bw, s_grp, s_lut, G};
}

struct TrRay {
  float ox, oy, oz, dx, dy, dz;
};

// Bit g set when the lane's segment [0, t_hi] enters group g's (padded)
// box: pallas_trwalk._slab_groups per lane, with the guarded reciprocals,
// the slab interval widened by kPadT.
__device__ __forceinline__ unsigned group_mask(const Resident& rs,
                                               const TrRay& r, float t_hi) {
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  unsigned m = 0u;
  for (int g = 0; g < rs.G; ++g) {
    const float4 a = reinterpret_cast<const float4*>(rs.grp + g * kGrpRec)[0];
    const float4 b = reinterpret_cast<const float4*>(rs.grp + g * kGrpRec)[1];
    float tn, tf;
    slab(Box{a.x, a.y, a.z, a.w, b.x, b.y}, r.ox, r.oy, r.oz, ix, iy, iz, tn,
         tf);
    pad_slab(tn, tf);
    if (tf >= max_nan(tn, 0.f) && tn <= t_hi && t_hi >= 0.f && b.z > 0.f)
      m |= 1u << g;
  }
  return m;
}

// tr_candidate on a column record of the resident table: the same
// bw_plane and bw_inside on the record's 12 values.
__device__ __forceinline__ bool res_candidate(const float* rec,
                                              const TrRay& r, float t_hi,
                                              float& t, float& u, float& v,
                                              float& dn) {
  const float4 a = reinterpret_cast<const float4*>(rec)[0];
  const float4 b = reinterpret_cast<const float4*>(rec)[1];
  const float4 c = reinterpret_cast<const float4*>(rec)[2];
  const float s[kRec] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
  bool ok;
  t = bw_plane(s, 1, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, dn, ok);
  if (!ok || !(t >= kTMin) || !(t < t_hi)) return false;
  return bw_inside(s, 1, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t, u, v);
}

// Calls visit(col, t, u, v, dn) for every candidate (t < t_hi) in the
// groups of gmask, in ascending column order.
template <class Visit>
__device__ __forceinline__ void for_each_candidate(const Resident& rs,
                                                   const TrRay& r,
                                                   unsigned gmask, float t_hi,
                                                   Visit visit) {
  for (int g = 0; g < rs.G; ++g) {
    if (!((gmask >> g) & 1u)) continue;
    const float* rec = rs.bw + g * kGroup * kRec;
    for (int j = 0; j < kGroup; ++j, rec += kRec) {
      float t, u, v, dn;
      if (res_candidate(rec, r, t_hi, t, u, v, dn))
        visit(g * kGroup + j, t, u, v, dn);
    }
  }
}

// The lane's K (<= kMaxList) smallest DISTINCT candidate t with
// t_lo < t < t_hi, ascending in kt, each with the lowest column that
// reaches it in kc (klist.cuh, over ascending groups and columns). Returns
// how many were found.
__device__ __forceinline__ int collect(const Resident& rs, const TrRay& r,
                                       unsigned gmask, float t_hi,
                                       float t_lo, int K,
                                       float (&kt)[kMaxList],
                                       int (&kc)[kMaxList]) {
  list_clear(K, kt, kc, -1);
  for_each_candidate(rs, r, gmask, t_hi,
                     [&](int col, float t, float, float, float) {
    if (t > t_lo) list_insert(t, col, kt, kc);
  });
  return list_size(kt);
}

// The lane's walk in ascending t from t_prev (the plain versions' strict
// t > t_prev advance, ties to the lowest column), at most steps_cap steps
// while 'walking': one pass collects the K = min(steps_cap, kMaxList)
// nearest candidates; a lane that uses them all and walks on refills the
// list by another pass from its last t. Each step recomputes the column's
// u, v and d.n (the same expression, so the same values) and calls
// step(k, t, col, u, v, dn), which returns whether the lane walks on; then
// t_prev = t while it does. A lane with no candidate stops walking, so at
// steps_cap 0 'walking' ends true only where a candidate exists.
template <class Step>
__device__ __forceinline__ void list_walk(const Resident& rs, const TrRay& r,
                                          unsigned gmask, float t_hi,
                                          int steps_cap, bool& walking,
                                          float& t_prev, Step step) {
  const int K = max(1, min(steps_cap, kMaxList));
  float kt[kMaxList];
  int kc[kMaxList];
  int n = 0, pos = 0;
  if (walking) {
    n = collect(rs, r, gmask, t_hi, t_prev, K, kt, kc);
    walking = n > 0;
  }
  for (int k = 0; k < steps_cap && walking; ++k) {
    if (pos == n) {
      if (n < K) {  // the list held every candidate left
        walking = false;
        break;
      }
      n = collect(rs, r, gmask, t_hi, t_prev, K, kt, kc);
      pos = 0;
      if (n == 0) {
        walking = false;
        break;
      }
    }
    float t = CUDART_INF_F;
    int col = -1;
#pragma unroll
    for (int q = 0; q < kMaxList; ++q) {
      if (q == pos) {
        t = kt[q];
        col = kc[q];
      }
    }
    ++pos;
    float tc, u, v, dn;
    res_candidate(rs.bw + col * kRec, r, t_hi, tc, u, v, dn);
    walking = step(k, t, col, u, v, dn);
    if (walking) t_prev = t;
  }
}

// The per-lane body of the resident transmittance walk (trans_walk.cu, and
// fused_shadow.cu after its any-hit): trans, t_prev and whether the lane
// would walk on past steps_cap (contract in trans_walk.cu; a lane is dead
// when pd < 0), over the groups the lane's unbounded segment enters.
// Point lanes (and every live lane of a factor-only scene) make the cut
// pass and the product pass in ascending column order, equal-t duplicates
// included; directional lanes of a textured scene walk the sorted list.
template <class Texel>
__device__ __forceinline__ void trans_lane(
    const TrTable<Texel>& tb, const Resident& rs, int steps_cap,
    bool textured, const TrRay& r, float pd, bool is_pt, float spx,
    float spy, float spz, float ouvx, float ouvy, bool osimple, float& trans,
    float& t_prev, bool& walking) {
  const bool live = pd >= 0.f;
  const bool loop = live && textured && !is_pt;
  const bool dense = live && !loop;
  const float inf = CUDART_INF_F;
  trans = 1.f;
  t_prev = -1.f;
  const unsigned gmask = live ? group_mask(rs, r, inf) : 0u;
  if (dense) {
    // Pass 1 (point lanes): the first candidate behind the light.
    float cut = inf;
    if (is_pt) {
      for_each_candidate(rs, r, gmask, inf,
                         [&](int, float t, float, float, float) {
        const float ocx = r.ox + t * r.dx - spx;
        const float ocy = r.oy + t * r.dy - spy;
        const float ocz = r.oz + t * r.dz - spz;
        const float occ = sqrtf(ocx * ocx + ocy * ocy + ocz * ocz);
        if (occ > pd) cut = fminf(cut, t);
      });
    }
    // Pass 2: the product over the candidates in front of the cut.
    for_each_candidate(rs, r, gmask, inf,
                       [&](int col, float t, float, float, float) {
      if (!(t < cut)) return;
      const float fac = tb.rows[6 * tb.T + col];
      float op = fac;
      if (textured && !osimple && tb.rows[7 * tb.T + col] > 0.f)
        op = page_texel(tb, rs.lut, ouvx, ouvy,
                        (int)tb.rows[8 * tb.T + col]) * fac;
      trans = trans * (1.f - op);
    });
  }
  walking = loop;
  list_walk(rs, r, gmask, inf, steps_cap, walking, t_prev,
            [&](int, float, int col, float u, float v, float) {
    const float fac = tb.rows[6 * tb.T + col];
    float uvx, uvy;
    column_uv(tb, col, u, v, uvx, uvy);
    const float tex =
        page_texel(tb, rs.lut, uvx, uvy, (int)tb.rows[8 * tb.T + col]);
    const float op = tb.rows[7 * tb.T + col] <= 0.f ? fac : tex * fac;
    trans = trans * (1.f - op);
    return trans != 0.f;
  });
}

// Launch shape of a resident-walk kernel over R lanes: its shared memory,
// and a persistent grid of kResThreads-thread CTAs (flat_common.cuh's
// resident_launch_shape).
template <class Kernel>
inline cudaError_t resident_walk_shape(Kernel kernel, int T, int R,
                                         int device, size_t& smem,
                                         int& blocks) {
  smem = resident_smem(T);
  return resident_launch_shape(kernel, smem, kResThreads, (R + 31) / 32,
                               device, blocks);
}

// The tables a resident walk takes: whole 128-column groups, at most
// kMaxColumns, and a group table that covers them.
inline bool resident_table_ok(int T, int gp) {
  return T > 0 && T % kGroup == 0 && T <= kMaxColumns && gp * kGroup >= T;
}

}  // namespace ptt
