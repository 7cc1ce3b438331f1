// Device helpers shared by the two transparent-walk kernels (alpha_walk.cu,
// trans_walk.cu): the staged column chunks of the compact transparent
// table, the candidate test and the opacity texel fetch.
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

namespace ptt {

constexpr int kTrCta = 128;    // lanes (threads) per CTA
constexpr int kTrChunk = 256;  // table columns staged per pass: 12 KB

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

// Calls visit(c0, n) once per chunk of columns [c0, c0 + n) after staging
// their 12 used BW rows in s_bw [12][kTrChunk]. Every thread of the CTA
// must call it; it contains two __syncthreads() per chunk.
template <class Texel, class Visit>
__device__ __forceinline__ void for_each_chunk(const TrTable<Texel>& tb,
                                               float* s_bw, Visit visit) {
  for (int c0 = 0; c0 < tb.T; c0 += kTrChunk) {
    const int n = min(kTrChunk, tb.T - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < 12 * kTrChunk; idx += kTrCta) {
      const int r = idx / kTrChunk, c = idx - r * kTrChunk;
      s_bw[idx] = c < n ? tb.bw[(size_t)r * tb.T + c0 + c] : 0.f;
    }
    __syncthreads();
    visit(c0, n);
  }
}

// Column s (of a staged chunk) is a candidate of the ray: t within
// [kTMin, t_hi) and the hit inside the triangle. Returns t, u, v, d.n.
__device__ __forceinline__ bool tr_candidate(const float* s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float t_hi,
                                             float& t, float& u, float& v,
                                             float& dn) {
  bool ok;
  t = bw_plane(s, kTrChunk, ox, oy, oz, dx, dy, dz, dn, ok);
  if (!ok || !(t >= kTMin) || !(t < t_hi)) return false;
  return bw_inside(s, kTrChunk, ox, oy, oz, dx, dy, dz, t, u, v);
}

// The nearest candidate with t > t_prev over the whole table, ties to the
// lowest column (a strict < in ascending column order): col = -1 when
// there is none. Every thread of the CTA must call it; only lanes with
// 'want' search.
template <class Texel>
__device__ __forceinline__ void next_candidate(
    const TrTable<Texel>& tb, float* s_bw, bool want, float ox, float oy,
    float oz,
    float dx, float dy, float dz, float t_hi, float t_prev, float& best_t,
    int& best_col, float& best_u, float& best_v, float& best_dn) {
  best_t = CUDART_INF_F;
  best_col = -1;
  best_u = best_v = best_dn = 0.f;
  for_each_chunk(tb, s_bw, [&](int c0, int n) {
    if (!want) return;
    for (int c = 0; c < n; ++c) {
      float t, u, v, dn;
      if (!tr_candidate(s_bw + c, ox, oy, oz, dx, dy, dz, t_hi, t, u, v, dn))
        continue;
      if (t > t_prev && t < best_t) {
        best_t = t;
        best_col = c0 + c;
        best_u = u;
        best_v = v;
        best_dn = dn;
      }
    }
  });
}

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

// Loads the LUT into s_lut [256] and waits for the CTA.
__device__ __forceinline__ void stage_lut(const float* lut, float* s_lut) {
  for (int i = threadIdx.x; i < 256; i += kTrCta) s_lut[i] = lut[i];
  __syncthreads();
}

// Shared memory (floats) of trans_lane: the staged chunk s_bw [12][kTrChunk]
// and the LUT s_lut [256] beside it.
constexpr int kTransSmemFloats = 12 * kTrChunk + 256;

// The per-lane body of the transmittance walk (trans_walk.cu;
// fused_shadow.cu runs it after the any-hit): trans, t_prev and whether the
// lane would walk on past steps_cap (contract in trans_walk.cu). A lane is
// dead when pd < 0. s_bw holds 12 * kTrChunk floats; s_lut the LUT, staged
// by the caller. Every thread of the CTA must call it.
template <class Texel>
__device__ __forceinline__ void trans_lane(
    const TrTable<Texel>& tb, float* s_bw, const float* s_lut, int steps_cap,
    bool textured, float ox, float oy, float oz, float dx, float dy, float dz,
    float pd, bool is_pt, float spx, float spy, float spz, float ouvx,
    float ouvy, bool osimple, float& trans, float& t_prev, bool& walking) {
  const bool live = pd >= 0.f;
  const bool loop = live && textured && !is_pt;
  const bool dense = live && !loop;
  const float inf = CUDART_INF_F;
  trans = 1.f;
  t_prev = -1.f;

  if (__syncthreads_or(dense)) {
    // Pass 1 (point lanes): the first candidate behind the light.
    float cut = inf;
    const bool need_cut = dense && is_pt;
    if (__syncthreads_or(need_cut)) {
      for_each_chunk(tb, s_bw, [&](int c0, int n) {
        if (!need_cut) return;
        for (int c = 0; c < n; ++c) {
          float t, u, v, dn;
          if (!tr_candidate(s_bw + c, ox, oy, oz, dx, dy, dz, inf, t, u, v,
                            dn))
            continue;
          const float ocx = ox + t * dx - spx;
          const float ocy = oy + t * dy - spy;
          const float ocz = oz + t * dz - spz;
          const float occ = sqrtf(ocx * ocx + ocy * ocy + ocz * ocz);
          if (occ > pd) cut = fminf(cut, t);
        }
      });
    }
    // Pass 2: the product over the candidates in front of the cut.
    for_each_chunk(tb, s_bw, [&](int c0, int n) {
      if (!dense) return;
      for (int c = 0; c < n; ++c) {
        float t, u, v, dn;
        if (!tr_candidate(s_bw + c, ox, oy, oz, dx, dy, dz, inf, t, u, v,
                          dn) ||
            !(t < cut))
          continue;
        const int col = c0 + c;
        const float fac = tb.rows[6 * tb.T + col];
        float op = fac;
        if (textured && !osimple && tb.rows[7 * tb.T + col] > 0.f)
          op = page_texel(tb, s_lut, ouvx, ouvy,
                          (int)tb.rows[8 * tb.T + col]) * fac;
        trans = trans * (1.f - op);
      }
    });
  }

  // Directional lanes of a textured scene: the sequential walk.
  walking = loop;
  for (int k = 0; k < steps_cap; ++k) {
    if (!__syncthreads_or(walking)) break;
    float t, u, v, dn;
    int col;
    next_candidate(tb, s_bw, walking, ox, oy, oz, dx, dy, dz, inf, t_prev, t,
                   col, u, v, dn);
    if (!walking) continue;
    if (col < 0) {
      walking = false;
      continue;
    }
    const float fac = tb.rows[6 * tb.T + col];
    float uvx, uvy;
    column_uv(tb, col, u, v, uvx, uvy);
    const float tex =
        page_texel(tb, s_lut, uvx, uvy, (int)tb.rows[8 * tb.T + col]);
    const float op = tb.rows[7 * tb.T + col] <= 0.f ? fac : tex * fac;
    trans = trans * (1.f - op);
    walking = trans != 0.f;
    if (walking) t_prev = t;
  }
  if (steps_cap == 0) {  // no step taken: only a lane with a candidate walks on
    float t, u, v, dn;
    int col;
    next_candidate(tb, s_bw, walking, ox, oy, oz, dx, dy, dz, inf, t_prev, t,
                   col, u, v, dn);
    walking = walking && col >= 0;
  }
}

}  // namespace ptt
