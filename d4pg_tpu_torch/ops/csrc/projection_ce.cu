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
// the bound. In practice each kernel is bound by its launch (~2 us) and
// by its critical path: the global round trips a thread waits on one
// after the other, then the 51-term serial sum of proj_j.
//
// Forward design: proj never reaches device memory, and no [A, A] weight
// matrix exists (the Pallas kernel builds a [64, A, A] weight tile in
// VMEM). One warp owns one row: its lanes stage the row's p_i and b_i in
// shared memory, then each lane computes proj_j for the atoms j = lane,
// lane + 32, ... by the shared fixed-order sum over i. The forward
// reduces its lane partials of proj_j * log(q_j + 1e-10) with warp
// shuffles in a fixed tree, so td is the same bits run to run (no
// atomics, no cross-warp step). A warp whose row lies past the batch
// returns at once, which masks a ragged last block; the batch is never
// padded (the Pallas kernel pads it to a multiple of 64 with q = 1).
//
// Backward design: one thread per output element dq_bj, in blocks of
// kBwdRows whole rows laid out flat over (row, atom) (B = 256 at
// kBwdRows = 2 gives 128 blocks, about one per SM; a warp per row would
// fill 32 SMs and give a lane up to two serial sums). Every global
// operand a thread needs (its p_bj to stage, r_b, d_b, q_bj and g_b) is
// loaded before the block's one barrier, so the thread waits on one round
// trip to memory; after the barrier it sums proj_j from shared memory and
// divides. proj_j comes from projection_common.cuh, so dq carries the
// bits that -g * projection_kernel(p, r, d) / (q + 1e-10) gives.
//
// Rounding: logf and the division are the IEEE-accurate versions (no
// fast math); the row sum runs in another order than the plain torch
// sum, well inside the reference's bar (atol 1e-4, rtol 1e-5 on td).

#include <cuda_runtime.h>

#include "projection_common.cuh"

namespace {

constexpr int kWarps = 8;  // forward: rows per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kBwdRows = 2;  // backward: rows per block (PERF.md)
constexpr int kMaxThreads = 1024;
constexpr float kLogEps = 1e-10f;  // the reference's log(q + 1e-10)

// Stage row `row`'s p_i and b_i into this warp's slice of shared memory.
__device__ __forceinline__ void stage_row(const float* __restrict__ p,
                                          const float* __restrict__ r,
                                          const float* __restrict__ d,
                                          int row, int atoms, float v_min,
                                          float v_max, float step, float delta,
                                          float* sp, float* sb, int lane) {
  const float rr = r[row], dd = d[row];
  const float* prow = p + static_cast<long>(row) * atoms;
  for (int i = lane; i < atoms; i += 32) {
    sp[i] = prow[i];
    sb[i] = d4pg::bin_position(rr, dd, i, atoms, v_min, v_max, step,
                               delta);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
ce_forward_kernel(const float* __restrict__ p, const float* __restrict__ r,
                  const float* __restrict__ d, const float* __restrict__ q,
                  float* __restrict__ td, int batch, int atoms, float v_min,
                  float v_max, float step, float delta) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= batch) return;  // the whole warp: no block-wide barrier below
  float* sp = smem + warp * 2 * atoms;
  float* sb = sp + atoms;
  stage_row(p, r, d, row, atoms, v_min, v_max, step, delta, sp, sb, lane);

  const float* qrow = q + static_cast<long>(row) * atoms;
  float acc = 0.0f;
  for (int j = lane; j < atoms; j += 32) {
    acc += d4pg::projected_atom(sp, sb, atoms, j) * logf(qrow[j] + kLogEps);
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) td[row] = -acc;
}

// Thread t of a block owns element (row0 + t / atoms, t % atoms) of dq;
// the block's `rows` rows are staged in shared memory as [rows][atoms]
// p_i, then [rows][atoms] b_i.
__global__ void __launch_bounds__(kMaxThreads)
ce_backward_kernel(const float* __restrict__ p, const float* __restrict__ r,
                   const float* __restrict__ d, const float* __restrict__ q,
                   const float* __restrict__ g, float* __restrict__ dq,
                   int batch, int atoms, int rows, float v_min, float v_max,
                   float step, float delta) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int local = t / atoms;
  const int j = t - local * atoms;
  const int row = blockIdx.x * rows + local;
  const bool live = local < rows && row < batch;
  const long e = static_cast<long>(row) * atoms + j;
  // every global load of the thread, issued before the barrier
  float pj = 0.0f, rb = 0.0f, db = 0.0f, qj = 1.0f, gb = 0.0f;
  if (live) {
    pj = p[e];
    rb = r[row];
    db = d[row];
    qj = q[e];
    gb = g[row];
  }
  float* sp = smem;
  float* sb = smem + rows * atoms;
  if (live) {
    sp[t] = pj;
    sb[t] = d4pg::bin_position(rb, db, j, atoms, v_min, v_max, step,
                               delta);
  }
  __syncthreads();
  if (!live) return;
  const int base = local * atoms;
  dq[e] = -gb * d4pg::projected_atom(sp + base, sb + base, atoms, j) /
          (qj + kLogEps);
}

// Dynamic shared memory of one forward block: p_i and b_i of kWarps
// rows. Returns -1 when it exceeds the 48 KB a block gets without opting
// in.
long shared_bytes(int atoms) {
  const long bytes = 2L * kWarps * atoms * static_cast<long>(sizeof(float));
  return (atoms <= 0 || bytes > 48 * 1024) ? -1 : bytes;
}

}  // namespace

// p, q: [batch, atoms] float32, row-major; r, d: [batch] float32;
// td: [batch] float32 out. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue without launching when the
// rows' staging does not fit a block's shared memory.
extern "C" int d4pg_projection_ce_fwd(const float* p, const float* r,
                                      const float* d, const float* q,
                                      float* td, int batch, int atoms,
                                      float v_min, float v_max, float delta,
                                      cudaStream_t stream) {
  const long smem = shared_bytes(atoms);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (batch + kWarps - 1) / kWarps;
  ce_forward_kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      p, r, d, q, td, batch, atoms, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}

// As d4pg_projection_ce_fwd, with g: [batch] float32 (the cotangent of
// td) in and dq: [batch, atoms] float32 out. A block holds kBwdRows rows,
// fewer when their elements exceed 1,024 threads; returns
// cudaErrorInvalidValue without launching when one row does.
extern "C" int d4pg_projection_ce_bwd(const float* p, const float* r,
                                      const float* d, const float* q,
                                      const float* g, float* dq, int batch,
                                      int atoms, float v_min, float v_max,
                                      float delta, cudaStream_t stream) {
  if (atoms <= 0 || atoms > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kBwdRows * atoms <= kMaxThreads ? kBwdRows
                                                   : kMaxThreads / atoms;
  const int threads = (rows * atoms + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(float) * rows * atoms;  // <= 8 KB
  const int blocks = (batch + rows - 1) / rows;
  ce_backward_kernel<<<blocks, threads, smem, stream>>>(
      p, r, d, q, g, dq, batch, atoms, rows, v_min, v_max,
      d4pg::support_step(atoms, v_min, v_max), delta);
  return static_cast<int>(cudaGetLastError());
}
