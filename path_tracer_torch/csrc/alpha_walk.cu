// Stochastic-alpha walk over the compact transparent table, one thread per
// lane.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_trwalk.py::_alpha_kernel
// (launched by alpha_walk_kernel) in both its variants: live=False (forward
// rendering: u8 texel codes through the LUT) and live=True (live_factor=,
// training: the live opacity-factor row and an f32 plane of live texel
// values, read directly; pallas_trwalk._texel). The kernel is a template on
// the plane's texel type; the walk is the same. It is the transparent half
// of the partitioned alpha walk, whose opaque terminator t_op comes from the
// flat cast. Contract kept (with the plain version, ops/trwalk.py
// alpha_walk_plain, on the same tables):
//   - a lane is dead when t_op < 0; else its candidates have t < t_op;
//   - step k takes the nearest candidate with t > t_prev (t_prev from -1),
//     ties to the lowest compact column; its opacity is texel * factor where
//     the column has a texture (uv = uv0 + u du1 + v du2, its page), else the
//     factor; it accepts when op >= 1 or (op > 0.001 and rnd[k] < op);
//   - a lane walks on while it rejects, for at most steps_cap steps, and
//     reports the last candidate it took.
//
// Bound on the card: arithmetic, the Baldwin-Weber test of every column per
// step for each walking lane (the table is a few hundred to 4,096 columns;
// bytes are the lanes' 48 bytes in and 36 out). Design: the CTA's 128 lanes
// share each step; the table's 12 used BW rows stream through shared memory
// in 256-column chunks (12 KB, broadcast reads) only while some lane of the
// CTA still walks; a lane reads the chosen column's attribute rows and its
// texel code from device memory (the page plane is L2-resident) and the
// code's value from the LUT in shared memory. The Pallas kernel evaluated
// the whole table once per tile into VMEM matrices and extracted one
// candidate per step; here each step re-evaluates, which keeps the state in
// registers and lifts any cap on the table and page sizes.
//
// Inputs:  o, d [R,3] f32; t_op [R] f32; rnd [steps_cap, R] f32; the table
//          (trwalk_common.cuh), its plane u8 codes (live 0) or f32 values
//          (live 1).
// Outputs: fout [8,R] f32: t, u, v, d.n, seen, accepted, still walking,
//          t_prev; iout [R] i32: compact column (-1 for none).

#include "trwalk_common.cuh"

namespace {

using ptt::kTrChunk;
using ptt::kTrCta;

template <class Texel>
__global__ void __launch_bounds__(kTrCta)
alpha_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_op,
                  const float* __restrict__ rnd, ptt::TrTable<Texel> tb, int R,
                  int steps_cap, int textured, float* __restrict__ fout,
                  int* __restrict__ iout) {
  __shared__ float s_bw[12 * kTrChunk];
  __shared__ float s_lut[256];
  ptt::stage_lut(tb.lut, s_lut);

  const int i = blockIdx.x * kTrCta + threadIdx.x;
  const bool in_range = i < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  float top = -1.f;
  if (in_range) {
    ox = o[3 * i]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
    top = t_op[i];
  }
  const float t_hi = top < 0.f ? -1.f : top;
  bool active = top >= 0.f, seen = false, accepted = false;
  float sel_t = CUDART_INF_F, sel_u = 0.f, sel_v = 0.f, sel_dn = 0.f;
  float t_prev = -1.f;
  int sel_col = -1;

  for (int k = 0; k < steps_cap; ++k) {
    if (!__syncthreads_or(active)) break;
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, active, ox, oy, oz, dx, dy, dz, t_hi,
                        t_prev, t, col, u, v, dn);
    if (!active) continue;
    if (col < 0) {
      active = false;
      continue;
    }
    const float fac = tb.rows[6 * tb.T + col];
    float op = fac;
    if (textured) {
      float uvx, uvy;
      ptt::column_uv(tb, col, u, v, uvx, uvy);
      const float tex = ptt::page_texel(tb, s_lut, uvx, uvy,
                                        (int)tb.rows[8 * tb.T + col]);
      if (tb.rows[7 * tb.T + col] > 0.f) op = tex * fac;
    }
    const bool accept =
        op >= 1.f || (op > 0.001f && rnd[(size_t)k * R + i] < op);
    sel_t = t;
    sel_col = col;
    sel_u = u;
    sel_v = v;
    sel_dn = dn;
    seen = true;
    accepted = accepted || accept;
    active = !accept;
    if (active) t_prev = t;
  }
  if (steps_cap == 0) {  // no step taken: only a lane with a candidate walks on
    float t, u, v, dn;
    int col;
    ptt::next_candidate(tb, s_bw, active, ox, oy, oz, dx, dy, dz, t_hi,
                        t_prev, t, col, u, v, dn);
    active = active && col >= 0;
  }
  if (in_range) {
    fout[i] = sel_t;
    fout[R + i] = sel_u;
    fout[2 * R + i] = sel_v;
    fout[3 * R + i] = sel_dn;
    fout[4 * R + i] = seen ? 1.f : 0.f;
    fout[5 * R + i] = accepted ? 1.f : 0.f;
    fout[6 * R + i] = active ? 1.f : 0.f;
    fout[7 * R + i] = t_prev;
    iout[i] = sel_col;
  }
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_alpha_walk(const float* o, const float* d,
                              const float* t_op, const float* rnd,
                              const float* bw, const float* rows,
                              const void* tex, const float* lut,
                              const int* pages, int R, int T, int wp,
                              int steps_cap, int textured, int live,
                              float* fout, int* iout, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  const dim3 grid((R + kTrCta - 1) / kTrCta);
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    alpha_walk_kernel<float><<<grid, kTrCta, 0, stream>>>(
        o, d, t_op, rnd, tb, R, steps_cap, textured, fout, iout);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    alpha_walk_kernel<unsigned char><<<grid, kTrCta, 0, stream>>>(
        o, d, t_op, rnd, tb, R, steps_cap, textured, fout, iout);
  }
  return (int)cudaGetLastError();
}
