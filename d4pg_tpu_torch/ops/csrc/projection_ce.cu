// Categorical Bellman projection fused into the cross-entropy critic loss,
// forward and backward, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of d4pg_tpu/ops/projection_ce.py::
// projection_ce_pallas: the forward pallas_call (body _fwd_kernel) with
// ce_forward_kernel and the backward one (body _bwd_kernel) with
// ce_backward_kernel. Same functions:
//   proj_bj = sum_i p_bi * max(0, 1 - |b_bi - j|)    (projection_common.cuh)
//   forward:  td_b  = -sum_j proj_bj * log(q_bj + 1e-10)
//   backward: dq_bj = -g_b * proj_bj / (q_bj + 1e-10)
// The projected target is a constant of the loss (the learner stops the
// gradient there), so the backward has no cotangent for p, r or d.
//
// What bounds it on an H100: at the learner's shape (B = 256 rows,
// A = 51 atoms) the forward reads p and q (104,448 B) plus r and d
// (2,048 B) and writes td (1,024 B): 107,520 B, 0.032 us at 3.35 TB/s.
// The backward reads the same 107,520 B (g in place of td) and writes dq
// (52,224 B): 159,744 B, 0.048 us. The function needs ~13 operations per
// atom (~170 k per call), 0.0025 us at 67 TFLOP/s float32, so bytes set
// the bound. In practice each kernel is bound by its launch: on this card
// a launch takes ~1.8 us and the first global access of a launch ~0.9 us
// more (PERF.md), ~2.7 us before a body runs. Above that floor the time
// is the kernel's critical path: the global round trips a thread waits on
// one after the other, then the serial A-term sum of proj_j, then (the
// forward) the row sum of td.
//
// Both kernels give one row to one block, one thread per element (b, j)
// (projection_common.cuh): B = 256 gives 256 blocks of 64 threads, about
// two per SM. Every global operand a thread needs is loaded before the
// block's first barrier, so the thread waits on one round trip to
// memory; after the barrier it sums proj_bj from the row's (p_i, b_i)
// pairs staged in shared memory. proj_j comes from projection_common.cuh,
// so both kernels carry the bits of the projection kernel's proj.
//
// Forward design: the thread loads p_bj, r_b, d_b and q_bj and computes
// log(q_bj + 1e-10) before the barrier, while the other threads' loads
// are still in flight; after it, it writes proj_bj * log(q_bj + 1e-10) to
// shared memory. After a second barrier the block's first warp reduces
// the row in a fixed order: lane l sums the products l, l + 32, ..., then
// a fixed xor-shuffle tree adds the lanes' sums. td is the same bits run
// to run (no atomics, no step across blocks). proj never reaches device
// memory, and no [A, A] weight matrix exists (the Pallas kernel builds a
// [64, A, A] weight tile in VMEM); the batch is never padded (the Pallas
// kernel pads it to a multiple of 64 with q = 1).
//
// Backward design: after the barrier the thread divides, dq_bj = -g_b *
// proj_bj / (q_bj + 1e-10), so dq carries the bits that -g * projection
// kernel(p, r, d) / (q + 1e-10) gives.
//
// Rounding: logf and the division are the IEEE-accurate versions (no
// fast math); the row sum runs in another order than the plain torch
// sum, well inside the reference's bar (atol 1e-4, rtol 1e-5 on td).

#include <cuda_runtime.h>

#include "projection_common.cuh"

namespace {

constexpr float kLogEps = 1e-10f;  // the reference's log(q + 1e-10)

// Block b owns row b, thread j its atom j; shared memory holds the row's
// (p_i, b_i) pairs, then (forward) its products.
__global__ void __launch_bounds__(d4pg::kMaxThreads)
ce_forward_kernel(const float* __restrict__ p, const float* __restrict__ r,
                  const float* __restrict__ d, const float* __restrict__ q,
                  float* __restrict__ td, int atoms, float v_min,
                  float v_max, float step, float delta) {
  extern __shared__ float4 smem[];
  float2* sv = reinterpret_cast<float2*>(smem);
  float* sc = reinterpret_cast<float*>(sv + atoms);
  const int j = threadIdx.x;
  const bool live = j < atoms;
  const long e = static_cast<long>(blockIdx.x) * atoms + j;
  // every global load of the thread, issued before the barrier
  const float rb = r[blockIdx.x], db = d[blockIdx.x];
  float qj = 1.0f;
  if (live) {
    qj = q[e];
    sv[j] = make_float2(p[e], d4pg::bin_position(rb, db, j, atoms, v_min,
                                                 v_max, step, delta));
  }
  const float logq = logf(qj + kLogEps);
  __syncthreads();
  if (live) sc[j] = d4pg::projected_atom(sv, atoms, j) * logq;
  __syncthreads();
  if (j >= 32) return;
  // the first warp sums the row: lane sums, then a fixed tree
  float acc = 0.0f;
  for (int k = j; k < atoms; k += 32) acc += sc[k];
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (j == 0) td[blockIdx.x] = -acc;
}

__global__ void __launch_bounds__(d4pg::kMaxThreads)
ce_backward_kernel(const float* __restrict__ p, const float* __restrict__ r,
                   const float* __restrict__ d, const float* __restrict__ q,
                   const float* __restrict__ g, float* __restrict__ dq,
                   int atoms, float v_min, float v_max, float step,
                   float delta) {
  extern __shared__ float4 smem[];
  float2* sv = reinterpret_cast<float2*>(smem);
  const int j = threadIdx.x;
  const bool live = j < atoms;
  const long e = static_cast<long>(blockIdx.x) * atoms + j;
  // every global load of the thread, issued before the barrier
  const float rb = r[blockIdx.x], db = d[blockIdx.x], gb = g[blockIdx.x];
  float qj = 1.0f;
  if (live) {
    qj = q[e];
    sv[j] = make_float2(p[e], d4pg::bin_position(rb, db, j, atoms, v_min,
                                                 v_max, step, delta));
  }
  __syncthreads();
  if (!live) return;
  dq[e] = -gb * d4pg::projected_atom(sv, atoms, j) / (qj + kLogEps);
}

}  // namespace

// p, q: [batch, atoms] float32, row-major; r, d: [batch] float32;
// td: [batch] float32 out. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue without launching when a row
// exceeds a block's 1,024 threads.
extern "C" int d4pg_projection_ce_fwd(const float* p, const float* r,
                                      const float* d, const float* q,
                                      float* td, int batch, int atoms,
                                      float v_min, float v_max, float delta,
                                      cudaStream_t stream) {
  if (atoms <= 0 || atoms > d4pg::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = atoms * (sizeof(float2) + sizeof(float));  // <= 12 KB
  ce_forward_kernel<<<batch, d4pg::row_threads(atoms), smem, stream>>>(
      p, r, d, q, td, atoms, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}

// As d4pg_projection_ce_fwd, with g: [batch] float32 (the cotangent of
// td) in and dq: [batch, atoms] float32 out.
extern "C" int d4pg_projection_ce_bwd(const float* p, const float* r,
                                      const float* d, const float* q,
                                      const float* g, float* dq, int batch,
                                      int atoms, float v_min, float v_max,
                                      float delta, cudaStream_t stream) {
  if (atoms <= 0 || atoms > d4pg::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = atoms * sizeof(float2);  // <= 8 KB
  ce_backward_kernel<<<batch, d4pg::row_threads(atoms), smem, stream>>>(
      p, r, d, q, g, dq, atoms, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}
