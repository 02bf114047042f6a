// Categorical Bellman projection, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel d4pg_tpu/ops/projection.py::projection_pallas
// (body _projection_kernel). Same function:
//   tz_i  = clip(r + d * z_i, v_min, v_max),  z_i the support's atom i
//   b_i   = (tz_i - v_min) / delta
//   out_j = sum_i p_i * max(0, 1 - |b_i - j|)
// with z_i as torch.linspace rounds it (projection_common.cuh).
//
// What bounds it on an H100: the function needs ~10 operations per source
// atom (each atom's mass lands on at most two bins), so at the learner's
// shape (B = 256 rows, A = 51 atoms) its floor is the ~106 KB of traffic
// (p and out, B * A float32 each, plus r and d), ~0.03 us at HBM rate.
// In practice the launch bounds it: on this card a launch takes ~1.8 us
// and the first global access of a launch ~0.9 us more (PERF.md), so a
// kernel that reads its input pays ~2.7 us before its body runs. Above
// that, the serial A-term sum of each output atom is issued once per warp,
// and the warps of an SM queue on their instructions.
//
// Design: one pass, one row per block (projection_common.cuh). Each
// thread loads its p_bj, stages (p_bj, b_bj) in shared memory, and after
// the block's one barrier sums out_bj over i in a fixed order from the
// pairs, two atoms per 16-byte shared load. No atomics and no cross-block
// reduction, so the result is deterministic run to run. The [A, A] weight
// matrix of the einsum formulation never exists, and the batch is never
// padded. Past 1,024 atoms a thread loops over the row. Terminal rows
// (d = 0) need no branch: every tz_i equals clip(r), so the sum collapses
// to a delta at clip(r) (two neighbouring bins when clip(r) falls between
// atoms). Summing each bin over only the source atoms with non-zero
// weight (found by marks after a second barrier) was slower (PERF.md).
//
// Rounding: b_i is rounded as in the plain version: the support's atoms as
// torch.linspace rounds them, and the Bellman map r + d * z with its
// product and sum rounded separately (projection_common.cuh). nvcc
// contracts the accumulation p_i * w + acc into FMAs, and the plain torch
// einsum rounds each product and sums in another order. The difference
// stays within the port's bar (max abs error 1e-5 against the plain
// version). The per-row arithmetic lives in projection_common.cuh, shared
// with the fused projection + cross-entropy kernels of projection_ce.cu.

#include <cuda_runtime.h>

#include "projection_common.cuh"

namespace {

// Block b owns row b; its (p_i, b_i) pairs are staged in shared memory.
__global__ void __launch_bounds__(d4pg::kMaxThreads)
projection_kernel(const float* __restrict__ p, const float* __restrict__ r,
                  const float* __restrict__ d, float* __restrict__ out,
                  int atoms, float v_min, float v_max, float step,
                  float delta) {
  extern __shared__ float4 smem[];
  float2* sv = reinterpret_cast<float2*>(smem);
  const long base = static_cast<long>(blockIdx.x) * atoms;
  const float rb = r[blockIdx.x], db = d[blockIdx.x];
  for (int i = threadIdx.x; i < atoms; i += blockDim.x) {
    sv[i] = make_float2(p[base + i], d4pg::bin_position(rb, db, i, atoms,
                                                        v_min, v_max, step,
                                                        delta));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < atoms; j += blockDim.x) {
    out[base + j] = d4pg::projected_atom(sv, atoms, j);
  }
}

}  // namespace

// p, out: [batch, atoms] float32, row-major; r, d: [batch] float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when a row's staging exceeds
// the 48 KB of shared memory a block gets without opting in (past 6,144
// atoms).
extern "C" int d4pg_projection(const float* p, const float* r, const float* d,
                               float* out, int batch, int atoms, float v_min,
                               float v_max, float delta, cudaStream_t stream) {
  const long smem = static_cast<long>(atoms) * sizeof(float2);
  if (atoms <= 0 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  projection_kernel<<<batch, d4pg::row_threads(atoms),
                      static_cast<size_t>(smem), stream>>>(
      p, r, d, out, atoms, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* d4pg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
