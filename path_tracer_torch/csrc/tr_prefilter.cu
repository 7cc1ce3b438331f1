// The partitioned walks' segment prefilter: can the segment o + t d,
// t in [0, t_max], enter any of the scene's tr_prefilter boxes? One thread
// a lane, the boxes staged once a CTA in shared memory.
//
// Replaces no TPU kernel: the JAX package computes the same test as one
// fused XLA loop (path_tracer_tpu/models/integrator.py
// _hits_transparent_bounds). In eager PyTorch its plain version
// (ops/trwalk.py hits_transparent_bounds) writes and reads about a dozen
// [R, P, 3] f32 intermediates, gigabytes a call on a stacked shadow
// wavefront; this kernel keeps every intermediate in registers. Contract
// kept, bit for bit (a boolean of the same arithmetic, built -fmad=false):
//   - inv = 1 / d with IEEE division (a zero component inverts to +-inf);
//   - t0 = (bmin - o) * inv, t1 = (bmax - o) * inv per axis;
//   - lo = minimum(t0, t1), hi = maximum(t0, t1), NaN-propagating as
//     torch.minimum and torch.maximum are; a NaN lo counts as -inf and a
//     NaN hi as +inf (0 * inf on a slab plane leaves the slab open);
//   - tn = the largest lo, tf = the least hi over the axes;
//   - a box passes when tf >= max(tn, 0) and tn <= t_max (a NaN t_max
//     fails); the lane's result is whether any of the P boxes passes, the
//     1e30 padding boxes tested like the others;
//   - with an active mask, a lane off it writes false and reads nothing
//     else.
//
// Bound on the card: memory. A lane reads its mask byte, and where live
// its 28 bytes of o, d and t_max, and writes one byte; at most P slab
// tests of 22 FP32 operations follow (about 700 at P = 32), so a
// wavefront of a few million lanes is worth tens of microseconds. Design:
// 256 threads a CTA, one lane a thread, the P x 6 floats (768 bytes at P
// = 32) staged once a CTA, every thread then reading the same box (a
// shared-memory broadcast); a lane leaves at its first passing box. The
// lanes of a warp run the tests in step, so a warp takes as long as its
// busiest live lane: on lanes whose live ones are scattered at random
// (PERF.md) the kernel is bound by those warps' instructions, not by
// memory; a render's live lanes cluster in the Morton order.
//
// Inputs:  o, d [R,3] f32; t_max [R] f32; active [R] bool or null;
//          boxes [P,6] f32 (min xyz, max xyz), P <= kMaxBoxes.
// Outputs: out [R] bool.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = 32;

// torch.minimum / torch.maximum on floats: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : (a < b ? a : b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? CUDART_NAN_F : (a > b ? a : b);
}

__global__ void __launch_bounds__(kThreads)
tr_prefilter_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ boxes, int R, int P,
                    unsigned char* __restrict__ out) {
  __shared__ float box[kMaxBoxes * 6];
  for (int k = threadIdx.x; k < P * 6; k += kThreads) box[k] = boxes[k];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  bool hit = false;
  if (active == nullptr || active[i]) {
    const float org[3] = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
    const float inv[3] = {1.0f / d[3 * i], 1.0f / d[3 * i + 1],
                          1.0f / d[3 * i + 2]};
    const float tm = t_max[i];
    for (int p = 0; p < P && !hit; ++p) {
      const float* b = box + 6 * p;
      float tn = -CUDART_INF_F, tf = CUDART_INF_F;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = (b[a] - org[a]) * inv[a];
        const float t1 = (b[3 + a] - org[a]) * inv[a];
        const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
        // amax over the axes of where(isnan(lo), -inf, lo), amin likewise.
        if (!isnan(lo) && lo > tn) tn = lo;
        if (!isnan(hi) && hi < tf) tf = hi;
      }
      hit = tf >= (tn > 0.0f ? tn : 0.0f) && tn <= tm;
    }
  }
  out[i] = hit;
}

}  // namespace

extern "C" int ptt_tr_prefilter(const float* o, const float* d,
                                const float* t_max,
                                const unsigned char* active,
                                const float* boxes, int R, int P,
                                unsigned char* out, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  if (P < 0 || P > kMaxBoxes) return (int)cudaErrorInvalidValue;
  tr_prefilter_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(o, d, t_max, active, boxes, R, P, out);
  return (int)cudaGetLastError();
}
