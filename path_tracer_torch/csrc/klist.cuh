// A lane's K nearest DISTINCT hits, sorted in registers by insertion: the
// list row 3 (khit.cu) returns and the resident transparent walks
// (trwalk_common.cuh, collect) step through. One copy, so both keep the tie
// rule the walks depend on.
#pragma once

#include <math_constants.h>

namespace ptt {

// An empty list of K (<= N) slots: +inf in the first K, -inf past them, so
// that no t is ever inserted there.
template <int N>
__device__ __forceinline__ void list_clear(int K, float (&kt)[N],
                                           int (&kc)[N], int none) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    kt[q] = q < K ? CUDART_INF_F : -CUDART_INF_F;
    kc[q] = none;
  }
}

// Inserts a finite t with its column into the ascending list. Columns come
// in ascending order, so a t already held came with a lower column and the
// new one is dropped: an equal t never displaces. A t beyond the K-th is
// dropped too.
template <int N>
__device__ __forceinline__ void list_insert(float t, int col, float (&kt)[N],
                                            int (&kc)[N]) {
  bool dup = false;
#pragma unroll
  for (int q = 0; q < N; ++q) dup |= kt[q] == t;
  if (dup) return;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (t < kt[q]) {
      const float ft = kt[q];
      const int fc = kc[q];
      kt[q] = t;
      kc[q] = col;
      t = ft;
      col = fc;
    }
  }
}

// The K-th slot's t (K <= N): +inf while the list is not full. A t no
// smaller is never inserted.
template <int N>
__device__ __forceinline__ float list_bound(const float (&kt)[N], int K) {
  float w = CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q == K - 1) w = kt[q];
  return w;
}

// How many slots hold a hit.
template <int N>
__device__ __forceinline__ int list_size(const float (&kt)[N]) {
  int n = 0;
#pragma unroll
  for (int q = 0; q < N; ++q)
    n += kt[q] > -CUDART_INF_F && kt[q] < CUDART_INF_F;
  return n;
}

}  // namespace ptt
