// The per-row arithmetic of the categorical Bellman projection, shared by
// projection.cu and projection_ce.cu so the two kernels compute the same
// projected target and cannot drift apart.
//
//   tz_i  = clip(r + d * z_i, v_min, v_max),  z_i the support's atom i
//   b_i   = (tz_i - v_min) / delta
//   out_j = sum_i p_i * max(0, 1 - |b_i - j|)
//
// All three kernels give one row of the batch to one block, one thread
// per atom (row_threads). The block stages its row's (p_i, b_i) pairs in
// shared memory (bin_position), then one thread per output atom j sums
// over the source atoms i in a fixed order (projected_atom): no atomics,
// the same bits every run. One row per block keeps the index arithmetic
// to blockIdx.x and threadIdx.x, needs no mask for rows past the batch
// (the grid is the batch), and measured fastest at the learner's shape
// (PERF.md).

#pragma once

#include <cuda_runtime.h>

namespace d4pg {

constexpr int kMaxThreads = 1024;  // threads per block on the card

// Threads of a block that owns one row of `atoms`: one per atom in whole
// warps, at most kMaxThreads (past that a thread loops over the row).
inline int row_threads(int atoms) {
  return atoms < kMaxThreads ? (atoms + 31) / 32 * 32 : kMaxThreads;
}

// The support's float32 step as torch.linspace(v_min, v_max, atoms)
// computes it, (v_max - v_min) / (atoms - 1). A launch computes it once on
// the host (IEEE float32, as on the card) and passes it to its kernel.
inline float support_step(int atoms, float v_min, float v_max) {
  return (v_max - v_min) / static_cast<float>(atoms - 1);
}

// z_i of the support as torch.linspace gives it in float32: v_min +
// step * i for the first half of the atoms and v_max - step * (atoms - 1
// - i) for the rest, each with one rounding (an FMA). A spacing that
// float32 does not hold exactly (0.2 on [-10, 0] at 51 atoms) gives other
// bits than v_min + delta * i.
__device__ __forceinline__ float support_atom(int i, int atoms, float v_min,
                                              float v_max, float step) {
  return i < atoms / 2
             ? __fmaf_rn(step, static_cast<float>(i), v_min)
             : __fmaf_rn(-step, static_cast<float>(atoms - 1 - i), v_max);
}

// b_i of source atom i in a row with reward r and discount d. The
// Bellman map rounds its product and its sum on their own (__fmul_rn and
// __fadd_rn are never contracted into an FMA), as the plain version's
// separate tensor ops round them: an FMA's single rounding moves tz, and
// so b, by an ulp, which at 101 atoms moved proj_j by up to ~2e-5 of
// itself.
__device__ __forceinline__ float bin_position(float r, float d, int i,
                                              int atoms, float v_min,
                                              float v_max, float step,
                                              float delta) {
  const float z = support_atom(i, atoms, v_min, v_max, step);
  const float tz = fminf(fmaxf(__fadd_rn(r, __fmul_rn(d, z)), v_min), v_max);
  return (tz - v_min) / delta;
}

// Projected mass on atom j of one row from its staged pairs row[i] =
// (p_i, b_i), row 16-byte aligned: the terms in increasing i, each one
// multiply-add into acc. One 16-byte shared load brings two atoms, where
// separate p and b arrays take two loads per atom; the sum is issued once
// per warp, so its instructions are what a block's warps queue on.
__device__ __forceinline__ float projected_atom(const float2* row,
                                                int atoms, int j) {
  const float fj = static_cast<float>(j);
  const float4* two = reinterpret_cast<const float4*>(row);
  float acc = 0.0f;
  for (int k = 0; k < atoms / 2; ++k) {
    const float4 v = two[k];  // (p_2k, b_2k, p_2k+1, b_2k+1)
    acc += v.x * fmaxf(0.0f, 1.0f - fabsf(v.y - fj));
    acc += v.z * fmaxf(0.0f, 1.0f - fabsf(v.w - fj));
  }
  if (atoms % 2) {
    const float2 v = row[atoms - 1];
    acc += v.x * fmaxf(0.0f, 1.0f - fabsf(v.y - fj));
  }
  return acc;
}

}  // namespace d4pg
