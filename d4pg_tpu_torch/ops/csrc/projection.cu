// Categorical Bellman projection, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel d4pg_tpu/ops/projection.py::projection_pallas
// (body _projection_kernel). Same function:
//   tz_i  = clip(r + d * z_i, v_min, v_max),  z_i = v_min + i * delta
//   b_i   = (tz_i - v_min) / delta
//   out_j = sum_i p_i * max(0, 1 - |b_i - j|)
//
// What bounds it on an H100: the function needs ~10 operations per source
// atom (each atom's mass lands on at most two bins), so at the learner's
// shape (B = 256 rows, A = 51 atoms) its floor is the ~106 KB of traffic
// (p and out, B * A float32 each, plus r and d), ~0.03 us at HBM rate.
// This kernel evaluates all B * A * A = 0.67 M interpolation terms (the
// gather form, one output atom per thread); that too is far below a
// microsecond, so the launch itself and one round trip to device memory
// bound it in practice. The design keeps it to one
// pass: each block owns kRows whole rows, stages their p_i and b_i in
// shared memory (one global read of each input), and one thread per
// output atom j sums over i in a fixed order. No atomics and no
// cross-block reduction, so the result is deterministic run to run. The
// [A, A] weight matrix of the einsum formulation never exists. A ragged
// last block masks its missing rows instead of padding the batch.
// Terminal rows (d = 0) need no branch: every tz_i equals clip(r), so the
// sum collapses to a delta at clip(r) (two neighbouring bins when clip(r)
// falls between atoms).
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

constexpr int kRows = 4;       // rows of the batch per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
projection_kernel(const float* __restrict__ p, const float* __restrict__ r,
                  const float* __restrict__ d, float* __restrict__ out,
                  int batch, int atoms, float v_min, float v_max,
                  float step, float delta) {
  extern __shared__ float smem[];
  float* sp = smem;                 // [kRows][atoms] source probabilities
  float* sb = smem + kRows * atoms; // [kRows][atoms] source bin positions
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int n = rows * atoms;

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int rr = t / atoms;
    const int i = t - rr * atoms;
    const int row = row0 + rr;
    sp[t] = p[static_cast<long>(row) * atoms + i];
    sb[t] = d4pg::bin_position(r[row], d[row], i, atoms, v_min, v_max,
                                  step, delta);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int rr = t / atoms;
    const int j = t - rr * atoms;
    out[static_cast<long>(row0 + rr) * atoms + j] =
        d4pg::projected_atom(sp + rr * atoms, sb + rr * atoms, atoms, j);
  }
}

}  // namespace

// p, out: [batch, atoms] float32, row-major; r, d: [batch] float32.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching when the atoms' staging exceeds
// the 48 KB of shared memory a block gets without opting in.
extern "C" int d4pg_projection(const float* p, const float* r, const float* d,
                               float* out, int batch, int atoms, float v_min,
                               float v_max, float delta, cudaStream_t stream) {
  const long smem = 2L * kRows * atoms * static_cast<long>(sizeof(float));
  if (atoms <= 0 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (batch + kRows - 1) / kRows;
  projection_kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      p, r, d, out, batch, atoms, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* d4pg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
