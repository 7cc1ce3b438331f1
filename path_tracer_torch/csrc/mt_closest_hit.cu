// Brute-force Moller-Trumbore closest hit: the triangle table staged once
// per CTA in shared memory, one 1,024-thread CTA an SM.
//
// Replaces the TPU kernel path_tracer_tpu/ops/pallas_intersect.py::_kernel
// (launched by _launch, entry closest_hit_triangles_pallas). Contract kept:
//   - |det| >= 1e-6, no culling, backface = det < 0;
//   - u >= 0, v >= 0, u + v <= 1 (u <= 1 is implied by the last two);
//   - t >= 1e-6 and t > t_prev; a dead lane is t_prev = +inf (or NaN);
//   - ties keep the LOWEST triangle index (strict < over ascending index),
//     the global-argmin rule of ops/intersect.py::closest_hit_triangles.
//
// Bound: arithmetic. Every ray meets every triangle, R*N tests of about 30
// multiplies and adds and one IEEE reciprocal each; built -fmad=false,
// nothing fuses, so the card executes at most one of them per lane and
// clock.
//
// Design. The table is held in shared memory, and a CTA is made as large
// as the card allows (1,024 threads, 32 warps, one ray a thread) so that
// one copy of the table serves a whole SM; a grid of persistent CTAs, one
// an SM (never more than the rays fill). The table lives in shared memory
// as one 48-byte record per triangle (v0.xyz, e1.x | e1.yz, e2.xy | e2.z),
// so a triangle is three 16-byte broadcast reads. Each test leaves at its
// first failed condition, as the plain version's order allows; the
// reciprocal follows the det cutoff and is not deferred further: the sign
// of (tvec . pvec) * det decides u >= 0 only away from underflow (a u that
// underflows to -0.0 passes). Two rays a thread were no faster on full
// wavefronts and slower on the sparse lanes of later bounces (PERF.md).
//   - N <= kResidentMax (4,096: 192 KB): the whole table is staged once per
//     CTA and stays resident; then each warp works alone on units of 32
//     consecutive rays, unit u going to CTA u % G and warp (u / G) % 32 of
//     the G CTAs. Consecutive units land on different SMs, so the live
//     lanes of a later bounce, clustered in the Morton order, spread over
//     the card, and a warp whose rays are all dead moves on at once.
//   - N > kResidentMax (the brute-force casts over whole showcases): tiles
//     of 1,024 rays, and the table streams through two 1,024-triangle
//     buffers (96 KB) with cp.async, the next chunk landing while the
//     current one is tested; the CTA's (tile, chunk) steps form one
//     pipeline, so a tile's first chunk is in flight while the previous
//     tile's last one is tested.
// The ragged edge of R is masked, not padded; a dead ray skips the tests.
//
// Inputs:  o, d [R,3] f32; t_prev [R] f32; tris [9,N] f32 rows
//          (v0.xyz, e1.xyz, e2.xyz), component-major.
// Outputs: fout [4,R] f32 rows (t, u, v, backface 0/1); iout [R] i32 prim
//          (-1 on a miss, with t = +inf).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 1024;      // one CTA an SM, one ray a thread
constexpr int kResidentMax = 4096;  // triangles held whole
constexpr int kChunk = 1024;        // triangles per streamed chunk
constexpr int kRec = 12;            // floats per staged triangle
constexpr float kDetEps = 1e-6f;
constexpr float kTMin = 1e-6f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, tp;
  float bt, bu, bv, bb;
  int bi;
};

__device__ __forceinline__ void load_ray(Ray& r, const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ t_prev,
                                         int i, int R) {
  r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.f;
  r.tp = CUDART_INF_F;  // out of range: dead
  if (i < R) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    r.tp = t_prev[i];
  }
  r.bt = CUDART_INF_F; r.bu = 0.f; r.bv = 0.f; r.bb = 0.f; r.bi = -1;
}

__device__ __forceinline__ void store_ray(const Ray& r,
                                          float* __restrict__ fout,
                                          int* __restrict__ iout, int i,
                                          int R) {
  if (i >= R) return;
  fout[i] = r.bt;
  fout[(size_t)R + i] = r.bu;
  fout[2 * (size_t)R + i] = r.bv;
  fout[3 * (size_t)R + i] = r.bb;
  iout[i] = r.bi;
}

// Tests the n staged triangles at s (first index base) against one live
// ray, in the plain version's arithmetic and order; each test leaves at its
// first failed condition, and the reciprocal follows the det cutoff.
__device__ __forceinline__ void test_chunk(const float* s, int n, int base,
                                           Ray& r) {
  for (int j = 0; j < n; ++j) {
    const float4 q0 = reinterpret_cast<const float4*>(s + j * kRec)[0];
    const float4 q1 = reinterpret_cast<const float4*>(s + j * kRec)[1];
    const float4 q2 = reinterpret_cast<const float4*>(s + j * kRec)[2];
    const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
    const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
    const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
    // pvec = d x e2; det = e1 . pvec
    const float pvx = r.dy * e2z - r.dz * e2y;
    const float pvy = r.dz * e2x - r.dx * e2z;
    const float pvz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    if (!(fabsf(det) >= kDetEps)) continue;
    const float invdet = 1.0f / det;
    // tvec = o - v0
    const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * invdet;
    if (!(u >= 0.f)) continue;
    // qvec = tvec x e1
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * invdet;
    if (!(v >= 0.f && u + v <= 1.f)) continue;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * invdet;
    if (!(t >= kTMin && t > r.tp)) continue;
    if (t < r.bt) {
      r.bt = t; r.bu = u; r.bv = v; r.bb = det < 0.f ? 1.f : 0.f;
      r.bi = base + j;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src));
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
mt_closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ t_prev,
                      const float* __restrict__ tris, int R, int N,
                      float* __restrict__ fout, int* __restrict__ iout) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  Ray ray;
  if (kResident) {
    for (int c = threadIdx.x; c < N; c += kThreads) {
#pragma unroll
      for (int r = 0; r < 9; ++r) s[c * kRec + r] = tris[(size_t)r * N + c];
    }
    __syncthreads();
    // Each warp on its own from here: unit u (32 rays) goes to CTA u % G,
    // warp (u / G) % 32, so consecutive units land on different SMs.
    const int g = gridDim.x, warps = kThreads / 32;
    const int n_units = (R + 31) / 32;
    for (int u = (threadIdx.x >> 5) * g + blockIdx.x; u < n_units;
         u += g * warps) {
      const int i = u * 32 + (threadIdx.x & 31);
      load_ray(ray, o, d, t_prev, i, R);
      if (ray.tp < CUDART_INF_F) test_chunk(s, N, 0, ray);
      store_ray(ray, fout, iout, i, R);
    }
    return;
  }
  // Streamed: step = (tile, chunk), chunk fastest; buffer step & 1.
  const int n_tiles = (R + kThreads - 1) / kThreads;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const int my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_tiles * n_chunks;
  auto stage = [&](int step) {
    if (step < steps) {
      float* buf = s + (step & 1) * kChunk * kRec;
      const int base = (step % n_chunks) * kChunk;
      const int n = min(kChunk, N - base);
      for (int c = threadIdx.x; c < n; c += kThreads) {
#pragma unroll
        for (int r = 0; r < 9; ++r)
          cp_async4(buf + c * kRec + r, tris + (size_t)r * N + base + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the end
  };
  stage(0);
  for (int step = 0; step < steps; ++step) {
    const int chunk = step % n_chunks;
    const int i = (blockIdx.x + (step / n_chunks) * gridDim.x) * kThreads +
                  threadIdx.x;
    if (chunk == 0) load_ray(ray, o, d, t_prev, i, R);
    stage(step + 1);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this step's copies
    __syncthreads();                               // ... and every thread's
    const int base = chunk * kChunk;
    if (ray.tp < CUDART_INF_F)
      test_chunk(s + (step & 1) * kChunk * kRec, min(kChunk, N - base), base,
                 ray);
    __syncthreads();  // the buffer is restaged at step + 2
    if (chunk == n_chunks - 1) store_ray(ray, fout, iout, i, R);
  }
}

template <bool kResident>
cudaError_t launch(const float* o, const float* d, const float* t_prev,
                   const float* tris, int R, int N, float* fout, int* iout,
                   int device, cudaStream_t stream) {
  auto kernel = mt_closest_hit_kernel<kResident>;
  const size_t smem =
      (size_t)(kResident ? N : 2 * kChunk) * kRec * sizeof(float);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int work = (R + kThreads - 1) / kThreads;  // CTAs the rays fill
  const int blocks = min(work, max(per_sm, 1) * sms);
  kernel<<<blocks, kThreads, smem, stream>>>(o, d, t_prev, tris, R, N, fout,
                                             iout);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_mt_closest_hit(const float* o, const float* d,
                                  const float* t_prev, const float* tris,
                                  int R, int N, float* fout, int* iout,
                                  int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0) return 0;
  err = N <= kResidentMax
            ? launch<true>(o, d, t_prev, tris, R, N, fout, iout, device,
                           stream)
            : launch<false>(o, d, t_prev, tris, R, N, fout, iout, device,
                            stream);
  return (int)err;
}
