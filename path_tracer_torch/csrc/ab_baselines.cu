// The designs rows 15 and 3 replaced, kept under their own symbols only to
// be timed against the new designs in turns on the same card and to hold
// the new designs to them; no wrapper of the main path reaches them
// (chip_smoke.py's phase 3o and tests/test_torch_cuda.py call them through
// ops/ab_baselines.py).
//
// - ptt_fused_shadow_cta, row 15's first port: blockIdx.y picks the light,
//   a CTA is 128 consecutive rays of it. The any-hit phase is the CTA flat
//   walk (flat_occ_set): the nearest slab entry of each block column over
//   the CTA's lanes, then the columns nearest first, each staged in shared
//   memory behind CTA barriers while some lane still needs it. The walk
//   phase is the CTA transmittance walk (trans_lane_cta): the table
//   streamed through shared memory in 256-column chunks behind CTA
//   barriers, every live lane testing every column. Its gate is the
//   widened one: the wrapper passes the block boxes widened
//   (slab.pad_boxes) and the gate widens each lane's interval (pad_slab),
//   so it equals the new design on every lane. Arguments as the first
//   port's: (o, d, t_max, pd, aux, is_pt_mask, blk, blkid, bw, bpad,
//   block, n_cols, tr_bw, tr_rows, tex, lut, pages, T, wp, R, L, steps_cap,
//   textured, live, out).
// - ptt_khit_cta, row 3's first port: one thread per ray, a CTA of 128
//   rays staging a group's 9 x 128 MT rows in shared memory behind two
//   barriers whenever one of its lanes reaches the group, every lane
//   reading the same column; its gate the widened one (flat_common.cuh
//   khit_reach on the widened box). Arguments (o, d, t_max, tris, gbox, R,
//   T, K, tout, iout).

#include "trwalk_common.cuh"

namespace {

using namespace ptt;

// ---- Row 15's CTA any-hit ----

// The any-hit gate on boxes the wrapper widened: each lane's interval
// widened by pad_slab, then OccludedGate's test.
struct WidenedOccludedGate {
  __device__ bool live(float tm) const { return tm >= 0.f; }
  __device__ bool pass(float tn, float tf, float tm) const {
    pad_slab(tn, tf);
    return OccludedGate().pass(tn, tf, tm);
  }
};

// Stages the 12 used BW rows of block b (columns [b*block, (b+1)*block) of
// the [16, n_cols] table) into s_bw, then waits for the whole CTA.
__device__ __forceinline__ void stage_block(const float* __restrict__ bw,
                                            int b, int block, int n_cols,
                                            float* s_bw) {
  const float* src = bw + (size_t)b * block;
  for (int idx = threadIdx.x; idx < 12 * block; idx += kCtaRays) {
    const int r = idx / block;
    s_bw[idx] = src[(size_t)r * n_cols + (idx - r * block)];
  }
  __syncthreads();
}

// Any-hit BW test of one lane against the block staged in s_bw: true at the
// first hit with kTMin <= t <= tm.
__device__ __forceinline__ bool occluded_block(const float* s_bw, int block,
                                               float ox, float oy, float oz,
                                               float dx, float dy, float dz,
                                               float tm) {
  for (int j = 0; j < block; ++j) {
    float dn;
    bool ok;
    const float t = bw_plane(s_bw + j, block, ox, oy, oz, dx, dy, dz, dn, ok);
    if (!(ok && t >= kTMin && t <= tm)) continue;
    float u, v;
    if (bw_inside(s_bw + j, block, ox, oy, oz, dx, dy, dz, t, u, v))
      return true;
  }
  return false;
}

// The per-set body of the CTA flat any-hit (the first port's any-hit
// phase, and the design flat_occluded.cu replaced): whether this lane is
// occluded,
// a dead lane (tm < 0) reporting occluded. The CTA's lanes share one walk:
// the nearest slab entry of each block column over the lanes, then the
// columns nearest first, each staged in shared memory (12 BW rows) only
// while some lane of the CTA is still unoccluded and slab-passes it; a lane
// leaves the block's slot loop at its first hit. The walk ends when every
// lane is occluded or no column is left. smem holds the floats
// walk_smem(kernel, 12 * block, bpad, ...) sizes, red 3 * warps. Every
// thread of the CTA must call it; smem is free again when it returns.
__device__ __forceinline__ bool flat_occ_set(const FlatTable& ft, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float tm,
                                             float* smem, float* red) {
  float* s_bw = smem;                   // [12][block]
  float* s_key = s_bw + 12 * ft.block;  // [bpad]
  float* s_ray = s_key + ft.bpad;       // [kRayRows][kCtaRays]
  const WidenedOccludedGate gate;
  const bool live = gate.live(tm);  // lanes that may be occluded
  bool occ = tm < 0.f;              // dead lanes report occluded
  if (__syncthreads_or(live)) {
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    stage_ray(s_ray, ox, oy, oz, ix, iy, iz, tm);
    column_keys(ft.blk, ft.blkid, ft.bpad, ft.bpad, s_ray, s_key, gate);
    while (true) {
      float key, open = (live && !occ) ? 1.f : 0.f;  // any lane still open?
      int col;
      next_column(s_key, ft.bpad, key, col, open, red);
      if (col >= ft.bpad || open == 0.f) break;
      bool need = false;
      if (live && !occ) {
        float tn, tf;
        slab(load_box(ft.blk, ft.bpad, col), ox, oy, oz, ix, iy, iz, tn, tf);
        need = gate.pass(tn, tf, tm);
      }
      if (!__syncthreads_or(need)) continue;
      stage_block(ft.bw, ft.blkid[col], ft.block, ft.n_cols, s_bw);
      if (need)
        occ = occluded_block(s_bw, ft.block, ox, oy, oz, dx, dy, dz, tm);
      __syncthreads();  // s_bw is restaged by the next visit
    }
  }
  __syncthreads();  // next_column's last write to s_key is done
  return occ;
}

// ---- Row 15's CTA transmittance walk ----

constexpr int kTrCta = 128;    // lanes (threads) per CTA
constexpr int kTrChunk = 256;  // table columns staged per pass: 12 KB

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

// Loads the LUT into s_lut [256] and waits for the CTA.
__device__ __forceinline__ void stage_lut(const float* lut, float* s_lut) {
  for (int i = threadIdx.x; i < 256; i += kTrCta) s_lut[i] = lut[i];
  __syncthreads();
}

// Shared memory (floats) of trans_lane_cta: the staged chunk s_bw
// [12][kTrChunk] and the LUT s_lut [256] beside it.
constexpr int kTransSmemFloats = 12 * kTrChunk + 256;

// The per-lane body of the CTA transmittance walk (the first port runs it
// after the any-hit): trans, t_prev and whether the lane would walk on past
// steps_cap (contract in trans_walk.cu). A lane is dead when pd < 0. s_bw
// holds 12 * kTrChunk floats; s_lut the LUT, staged by the caller. Every
// thread of the CTA must call it.
template <class Texel>
__device__ __forceinline__ void trans_lane_cta(
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

// ---- Row 15's CTA kernel ----

static_assert(kTrCta == kCtaRays, "one CTA shape for both phases");

template <class Texel>
__global__ void __launch_bounds__(kCtaRays)
fused_shadow_cta_kernel(const float* __restrict__ o,
                        const float* __restrict__ d,
                        const float* __restrict__ t_max,
                        const float* __restrict__ pd,
                        const float* __restrict__ aux,
                        unsigned long long is_pt, FlatTable ft,
                        TrTable<Texel> tb, int R, int steps_cap, int textured,
                        float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_red[3 * (kCtaRays / 32)];

  const int li = blockIdx.y;
  const int i = blockIdx.x * kCtaRays + threadIdx.x;
  const size_t lane = (size_t)li * R + i;  // (light, ray)
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f, pdv = -1.f, spx = 0.f, spy = 0.f, spz = 0.f, ouvx = 0.f,
        ouvy = 0.f;
  bool osimple = false;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * lane]; dy = d[3 * lane + 1]; dz = d[3 * lane + 2];
    tm = t_max[lane];
    pdv = pd[lane];
    spx = aux[i]; spy = aux[R + i]; spz = aux[2 * R + i];
    ouvx = aux[3 * R + i]; ouvy = aux[4 * R + i];
    osimple = aux[5 * R + i] > 0.f;
  }
  const bool occ = flat_occ_set(ft, ox, oy, oz, dx, dy, dz, tm, smem, s_red);

  float* s_bw = smem;                  // [12][kTrChunk]
  float* s_lut = smem + 12 * kTrChunk;  // [256]
  stage_lut(tb.lut, s_lut);
  float trans, t_prev;
  bool walking;
  trans_lane_cta(tb, s_bw, s_lut, steps_cap, textured != 0, ox, oy, oz, dx,
                 dy, dz, occ ? -1.f : pdv, (is_pt >> li) & 1ull, spx, spy,
                 spz, ouvx, ouvy, osimple, trans, t_prev, walking);
  if (in_range) {
    const size_t row = (size_t)3 * li * R + i;
    out[row] = occ ? 0.f : trans;
    out[row + R] = t_prev;
    out[row + 2 * (size_t)R] = walking ? 1.f : 0.f;
  }
}

template <class Texel>
int launch_fused_cta(const float* o, const float* d, const float* t_max,
                     const float* pd, const float* aux,
                     unsigned long long is_pt_mask, const FlatTable& ft,
                     const TrTable<Texel>& tb, int R, int L, int steps_cap,
                     int textured, float* out, cudaStream_t stream) {
  // One buffer for both phases: the any-hit's block, keys and rays, or
  // the walk's chunk and LUT.
  const int staged = 12 * ft.block > kTransSmemFloats
                         ? 12 * ft.block : kTransSmemFloats;
  size_t smem;
  cudaError_t err =
      walk_smem(fused_shadow_cta_kernel<Texel>, staged, ft.bpad, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + kCtaRays - 1) / kCtaRays, L);
  fused_shadow_cta_kernel<Texel><<<grid, kCtaRays, smem, stream>>>(
      o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, steps_cap, textured, out);
  return (int)cudaGetLastError();
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_fused_shadow_cta(
    const float* o, const float* d, const float* t_max, const float* pd,
    const float* aux, unsigned long long is_pt_mask, const float* blk,
    const int* blkid, const float* bw, int bpad, int block, int n_cols,
    const float* tr_bw, const float* tr_rows, const void* tex,
    const float* lut, const int* pages, int T, int wp, int R, int L,
    int steps_cap, int textured, int live, float* out, int device,
    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || L <= 0) return 0;
  const ptt::FlatTable ft{blk, blkid, bw, bpad, block, n_cols};
  if (live) {
    const ptt::TrTable<float> tb{tr_bw, tr_rows,
                                 static_cast<const float*>(tex), lut, pages,
                                 T, wp};
    return launch_fused_cta(o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, L,
                            steps_cap, textured, out, stream);
  }
  const ptt::TrTable<unsigned char> tb{
      tr_bw, tr_rows, static_cast<const unsigned char*>(tex), lut, pages, T,
      wp};
  return launch_fused_cta(o, d, t_max, pd, aux, is_pt_mask, ft, tb, R, L,
                          steps_cap, textured, out, stream);
}

namespace {

// ---- Row 3's CTA kernel ----

constexpr int kKhitThreads = 128;
constexpr int kKhitGroup = 128;
constexpr int kKhitMaxK = 8;

__global__ void __launch_bounds__(kKhitThreads)
khit_cta_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t_max,
                const float* __restrict__ tris,
                const float* __restrict__ gbox, int R, int T, int G, int K,
                float* __restrict__ tout, int* __restrict__ iout) {
  __shared__ float s[9][kKhitGroup];
  const int i = blockIdx.x * kKhitThreads + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float tm = -1.f;
  if (i < R) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    tm = t_max[i];
  }
  const bool live = tm > 0.f;
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;

  float kt[kKhitMaxK];
  int kc[kKhitMaxK];
  list_clear(K, kt, kc, 0);

  for (int g = 0; g < G; ++g) {
    bool reach = false;
    if (live) {
      const Box w = pad_box(load_box(gbox, G, g));
      reach = khit_reach(w, ox, oy, oz, ivx, ivy, ivz, tm);
    }
    if (!__syncthreads_or(reach)) continue;  // no lane of the CTA reaches it
    const int base = g * kKhitGroup;
#pragma unroll
    for (int r = 0; r < 9; ++r)
      s[r][threadIdx.x] = tris[(size_t)r * T + base + threadIdx.x];
    __syncthreads();
    if (reach) {
      for (int j = 0; j < kKhitGroup; ++j) {
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
        // pvec = d x e2; det = e1 . pvec
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        if (!(fabsf(det) >= kDetEps)) continue;
        const float invdet = 1.0f / det;
        // tvec = o - v0
        const float tvx = ox - s[0][j], tvy = oy - s[1][j],
                    tvz = oz - s[2][j];
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
        if (!(u >= 0.f)) continue;
        // qvec = tvec x e1
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * invdet;
        if (!(v >= 0.f && u + v <= 1.f)) continue;
        float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
        if (t >= kTMin) list_insert(t, base + j, kt, kc);
      }
    }
    __syncthreads();  // the group is read before the next one is staged
  }
  if (i < R) {
#pragma unroll
    for (int q = 0; q < kKhitMaxK; ++q) {
      if (q < K) {
        tout[(size_t)q * R + i] = kt[q];
        iout[(size_t)q * R + i] = kc[q];
      }
    }
  }
}

}  // namespace

extern "C" int ptt_khit_cta(const float* o, const float* d,
                            const float* t_max, const float* tris,
                            const float* gbox, int R, int T, int K,
                            float* tout, int* iout, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || K <= 0) return 0;
  if (K > kKhitMaxK || T <= 0 || T % kKhitGroup)
    return (int)cudaErrorInvalidValue;
  const int blocks = (R + kKhitThreads - 1) / kKhitThreads;
  khit_cta_kernel<<<blocks, kKhitThreads, 0, stream>>>(
      o, d, t_max, tris, gbox, R, T, T / kKhitGroup, K, tout, iout);
  return (int)cudaGetLastError();
}
