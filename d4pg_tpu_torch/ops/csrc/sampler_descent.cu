// PER prefix-sum descent through the device sum tree, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel d4pg_tpu/ops/sampler_descent.py::descend_pallas
// (body _descent_kernel). Same function: Q inverse-CDF descents of prefix
// masses through a sum tree of 2 * cap float32 nodes (root at 1, leaf i
// at cap + i) over log2(cap) levels. Tie rule: mass >= left_sum goes
// right and subtracts left_sum. Returns node - cap as int32.
//
// What bounds it on an H100: each query is a chain of log2(cap) dependent
// loads (18 at cap = 262,144), each of which must return before the next
// address is known, so latency, not bandwidth, bounds it: the bytes are
// 4 per level per query (plus mass in and slot out), a few tens of KB at
// Q = 256. The design gives each query its own thread and reads
// tree[2 * node] straight from global memory through the read-only path;
// the 2 MB tree stays resident in the 50 MB L2 across the chunk's steps,
// and the top levels are the same few nodes for every query. The Pallas
// kernel pins the whole tree in VMEM and turns each gather into a one-hot
// contraction over it, because TPU VMEM has no vector gather; that
// O(cap)-per-level work is not carried over. Fit rule of the port: the
// tree lives in device memory and uses no shared memory, so any capacity
// whose tree fits on the card works (cap <= 2^30 for int32 node ids).
//
// Bitwise equality with the plain version: the only arithmetic is one
// compare and one float32 subtraction per level, which no compiler
// contraction touches. The stratified masses are computed outside and
// passed in, as the Pallas kernel takes them, so no FMA can change them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries per block

__global__ void __launch_bounds__(kThreads)
descent_kernel(const float* __restrict__ tree, const float* __restrict__ mass,
               int* __restrict__ slot, int queries, int cap, int levels) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= queries) return;
  float p = mass[q];
  int node = 1;
  for (int level = 0; level < levels; ++level) {
    const int left = node << 1;
    const float left_sum = __ldg(tree + left);
    if (p >= left_sum) {
      p = p - left_sum;
      node = left | 1;
    } else {
      node = left;
    }
  }
  slot[q] = node - cap;
}

}  // namespace

// tree: [2 * cap] float32; mass: [queries] float32; slot: [queries] int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int d4pg_descend(const float* tree, const float* mass, int* slot,
                            int queries, int cap, int levels,
                            cudaStream_t stream) {
  const int blocks = (queries + kThreads - 1) / kThreads;
  descent_kernel<<<blocks, kThreads, 0, stream>>>(tree, mass, slot, queries,
                                                  cap, levels);
  return static_cast<int>(cudaGetLastError());
}
