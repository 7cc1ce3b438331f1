// Stochastic-alpha walk over the compact transparent table, one thread per
// lane, the table resident in shared memory.
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
// Bound on the card: arithmetic, the Baldwin-Weber test of the columns in
// the 128-column groups each live lane's segment [0, t_op] enters (bytes
// are the lanes' 48 bytes in and 36 out, and the table read once). Design
// (trwalk_common.cuh's resident walk): the Pallas kernel evaluated the
// whole table once per tile into VMEM matrices and then extracted one
// candidate per step; here a persistent CTA of 256 threads (each SM holds
// as many as its shared memory allows) stages the table once (48 bytes a
// column, the group boxes and the LUT: 196 KB at 4,096 columns), and each
// warp takes units of 32 lanes on its own, unit u going to CTA u % G, so
// the clustered live lanes of a later bounce spread over the SMs. A lane
// gates the groups with tr_grp (_slab_groups per lane, on boxes widened by
// a few parts in 2^16 as they are staged, and its slab interval by 2^-16
// of its ends: on the exact boxes the rounded slab test drops candidates
// of rays that graze a card's vertex or edge on a box face, and a
// candidate's t rounds with the origin's distance; see
// trwalk_common.cuh), makes one pass over the admitted
// columns collecting its K = min(steps_cap, 8) nearest
// distinct candidates sorted in registers, then steps through that list
// with no barrier, refilling it by another pass only if it uses all K and
// walks on. A step reads the column's attribute rows and its texel from
// device memory (the page plane is L2-resident) and the code's value from
// the LUT in shared memory. It replaced a CTA design that streamed the
// table through shared memory once per step behind CTA barriers.
//
// Inputs:  o, d [R,3] f32; t_op [R] f32; rnd [steps_cap, R] f32; the table
//          (trwalk_common.cuh) with its group boxes grp [7, gp] (min.xyz,
//          max.xyz, valid), its plane u8 codes (live 0) or f32 values
//          (live 1).
// Outputs: fout [8,R] f32: t, u, v, d.n, seen, accepted, still walking,
//          t_prev; iout [R] i32: compact column (-1 for none).

#include "trwalk_common.cuh"

namespace {

using ptt::kResThreads;

template <class Texel>
__global__ void __launch_bounds__(kResThreads, 2)
alpha_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t_op,
                  const float* __restrict__ rnd, ptt::TrTable<Texel> tb,
                  const float* __restrict__ grp, int gp, int R,
                  int steps_cap, int textured, float* __restrict__ fout,
                  int* __restrict__ iout) {
  extern __shared__ float4 smem4[];
  const ptt::Resident rs =
      ptt::stage_resident(tb, grp, gp, reinterpret_cast<float*>(smem4));
  const int n_units = (R + 31) / 32, warps = kResThreads / 32;
  for (int unit = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       unit < n_units; unit += gridDim.x * warps) {
    const int i = unit * 32 + (threadIdx.x & 31);
    ptt::TrRay r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    float top = -1.f;
    if (i < R) {
      r = ptt::TrRay{o[3 * i], o[3 * i + 1], o[3 * i + 2],
                     d[3 * i], d[3 * i + 1], d[3 * i + 2]};
      top = t_op[i];
    }
    bool active = top >= 0.f, seen = false, accepted = false;
    float sel_t = CUDART_INF_F, sel_u = 0.f, sel_v = 0.f, sel_dn = 0.f;
    float t_prev = -1.f;
    int sel_col = -1;
    if (__any_sync(0xffffffffu, active)) {
      const unsigned gmask = active ? ptt::group_mask(rs, r, top) : 0u;
      ptt::list_walk(rs, r, gmask, top, steps_cap, active, t_prev,
                     [&](int k, float t, int col, float u, float v,
                         float dn) {
        const float fac = tb.rows[6 * tb.T + col];
        float op = fac;
        if (textured) {
          float uvx, uvy;
          ptt::column_uv(tb, col, u, v, uvx, uvy);
          const float tex = ptt::page_texel(tb, rs.lut, uvx, uvy,
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
        return !accept;
      });
    }
    if (i < R) {
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
}

template <class Texel>
cudaError_t launch(const float* o, const float* d, const float* t_op,
                   const float* rnd, const ptt::TrTable<Texel>& tb,
                   const float* grp, int gp, int R, int steps_cap,
                   int textured, float* fout, int* iout, int device,
                   cudaStream_t stream) {
  size_t smem;
  int blocks;
  const cudaError_t err = ptt::resident_walk_shape(
      alpha_walk_kernel<Texel>, tb.T, R, device, smem, blocks);
  if (err != cudaSuccess) return err;
  alpha_walk_kernel<Texel><<<blocks, kResThreads, smem, stream>>>(
      o, d, t_op, rnd, tb, grp, gp, R, steps_cap, textured, fout, iout);
  return cudaGetLastError();
}

}  // namespace

// tex: [Hp, wp] u8 codes when live is 0, f32 values when live is 1.
extern "C" int ptt_alpha_walk(const float* o, const float* d,
                              const float* t_op, const float* rnd,
                              const float* bw, const float* rows,
                              const void* tex, const float* lut,
                              const int* pages, const float* grp, int R,
                              int T, int gp, int wp, int steps_cap,
                              int textured, int live, float* fout, int* iout,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (!ptt::resident_table_ok(T, gp)) return (int)cudaErrorInvalidValue;
  if (live) {
    const ptt::TrTable<float> tb{bw, rows, static_cast<const float*>(tex),
                                 lut, pages, T, wp};
    err = launch(o, d, t_op, rnd, tb, grp, gp, R, steps_cap, textured, fout,
                 iout, device, stream);
  } else {
    const ptt::TrTable<unsigned char> tb{
        bw, rows, static_cast<const unsigned char*>(tex), lut, pages, T, wp};
    err = launch(o, d, t_op, rnd, tb, grp, gp, R, steps_cap, textured, fout,
                 iout, device, stream);
  }
  return (int)err;
}
