// The per-row arithmetic of the categorical Bellman projection, shared by
// projection.cu and projection_ce.cu so the two kernels compute the same
// projected target and cannot drift apart.
//
//   tz_i  = clip(r + d * z_i, v_min, v_max),  z_i = v_min + i * delta
//   b_i   = (tz_i - v_min) / delta
//   out_j = sum_i p_i * max(0, 1 - |b_i - j|)
//
// A kernel stages a row's p_i and b_i in shared memory (bin_position),
// then one thread per output atom j sums over the source atoms i in a
// fixed order (projected_atom): no atomics, the same bits every run.

#pragma once

#include <cuda_runtime.h>

namespace d4pg {

// b_i of source atom i in a row with reward r and discount d.
__device__ __forceinline__ float bin_position(float r, float d, int i,
                                              float v_min, float v_max,
                                              float delta) {
  const float z = v_min + delta * static_cast<float>(i);
  const float tz = fminf(fmaxf(r + d * z, v_min), v_max);
  return (tz - v_min) / delta;
}

// Projected mass on atom j of one row from its staged sp[i] = p_i and
// sb[i] = b_i.
__device__ __forceinline__ float projected_atom(const float* sp,
                                                const float* sb, int atoms,
                                                int j) {
  const float fj = static_cast<float>(j);
  float acc = 0.0f;
  for (int i = 0; i < atoms; ++i) {
    acc += sp[i] * fmaxf(0.0f, 1.0f - fabsf(sb[i] - fj));
  }
  return acc;
}

}  // namespace d4pg
