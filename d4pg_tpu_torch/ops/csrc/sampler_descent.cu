// PER prefix-sum descent through the device sum tree, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel d4pg_tpu/ops/sampler_descent.py::descend_pallas
// (body _descent_kernel). Same function: Q inverse-CDF descents of prefix
// masses through a sum tree of 2 * cap float32 nodes (root at 1, leaf i
// at cap + i) over log2(cap) levels. Tie rule: mass >= left_sum goes
// right and subtracts left_sum. Returns node - cap as int32.
//
// What bounds it on an H100: a descent is a chain of log2(cap) decisions
// (18 at cap = 262,144), each needing the left child's sum of the node the
// previous decision chose. Bytes play no part (4 per level per query plus
// mass in and slot out, a few KB at Q = 256, a 0.004 us bound); the time
// is the launch plus the dependent round trips to L2 (~145 ns each on an
// H100, PERF.md). One thread per query, loading tree[2 * node] level by
// level, makes 18 such round trips.
//
// Design: cut the dependent round trips by resolving kLevels = 6 levels
// per round. A warp of kLanes = 2^(kLevels - 1) = 32 lanes serves one
// query. At the start of a round the warp sits at node n; in the heap
// layout the descendants of n at depth +t are the contiguous nodes
// [n * 2^t, (n + 1) * 2^t). Each lane takes one candidate path: its lane
// index gives the first kLevels - 1 decisions, and the kLevels left sums
// along that path depend on nothing the round computes, so the lane
// issues all its loads at once (one round trip; the warp's loads cover
// 2^kLevels - 1 nodes, coalesced). The lane then walks its path from
// registers with the reference's compare and float32 subtraction, taking
// the last decision freely, and notes whether every decision agreed with
// its path. Exactly the lane on the true path agrees everywhere (a lane
// off it diverges at its first differing bit, where it computes the true
// decision from the true mass); the warp finds that lane by ballot, takes
// its mass by shuffle and rebuilds its node from its lane index. The
// visited nodes and the arithmetic are the reference's, so the slot is
// bitwise the plain version's. cap = 262,144 takes 3 dependent round
// trips (the first overlaps the mass load, whose address needs nothing);
// a ragged last round (levels not a multiple of kLevels, or levels <
// kLevels) takes fewer candidate bits, and cap = 1 takes no round. On
// this card the launch (~1.8 us) and the first global access of a launch
// (~0.9 us) now outweigh the rounds (~0.15 us each; PERF.md).
//
// The Pallas kernel pins the whole tree in VMEM and turns each gather
// into a one-hot contraction over it, because TPU VMEM has no vector
// gather; that O(cap)-per-level work is not carried over. Fit rule of the
// port: the tree lives in device memory and the kernel uses no shared
// memory, so any capacity whose tree fits on the card works (cap <= 2^30
// for 32-bit node ids).
//
// Bitwise equality with the plain version: the only arithmetic is one
// compare and one float32 subtraction per level, which no compiler
// contraction touches. The stratified masses are computed outside and
// passed in, as the Pallas kernel takes them, so no FMA can change them.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lanes per query: one warp
constexpr int kLevels = 6;  // levels per round: 2^(kLevels - 1) = kLanes
constexpr int kThreads = 128;
constexpr int kQueriesPerBlock = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
descent_kernel(const float* __restrict__ tree, const float* __restrict__ mass,
               int* __restrict__ slot, int queries, int cap, int levels) {
  const int q = static_cast<int>(blockIdx.x) * kQueriesPerBlock +
                static_cast<int>(threadIdx.x) / kLanes;
  // a warp with no query returns whole, so the warp-wide ballot and
  // shuffles below always see all 32 lanes
  if (q >= queries) return;
  const unsigned cand = threadIdx.x % kLanes;  // this lane's path bits

  float p = mass[q];
  unsigned node = 1;
  for (int done = 0; done < levels; done += kLevels) {
    const int m = min(kLevels, levels - done);  // levels in this round
    const unsigned path = cand >> (kLevels - m);  // m - 1 decision bits
    float left_sum[kLevels];
#pragma unroll
    for (int t = 1; t <= kLevels; ++t) {
      // the left child at step t: its parent is fixed by the first t - 1
      // bits of the path
      if (t <= m) {
        left_sum[t - 1] = __ldg(tree + (static_cast<size_t>(node) << t) +
                                2u * (path >> (m - t)));
      }
    }
    bool agrees = true;
    bool last = false;
#pragma unroll
    for (int t = 1; t <= kLevels; ++t) {
      if (t <= m) {
        const bool right = p >= left_sum[t - 1];
        if (right) p = p - left_sum[t - 1];
        if (t < m) {
          const bool bit = (path >> (m - 1 - t)) & 1u;
          agrees = agrees && right == bit;
        } else {
          last = right;
        }
      }
    }
    // the first agreeing lane wins; its lane index gives its path, so the
    // next node needs no shuffle and the next loads wait on none
    const unsigned winners = __ballot_sync(0xffffffffu, agrees);
    const unsigned lasts = __ballot_sync(0xffffffffu, last);
    const int src = __ffs(static_cast<int>(winners)) - 1;
    const unsigned win_path = static_cast<unsigned>(src) >> (kLevels - m);
    node = (node << m) + 2u * win_path + ((lasts >> src) & 1u);
    p = __shfl_sync(0xffffffffu, p, src);
  }
  if (cand == 0) slot[q] = static_cast<int>(node) - cap;
}

}  // namespace

// tree: [2 * cap] float32; mass: [queries] float32; slot: [queries] int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int d4pg_descend(const float* tree, const float* mass, int* slot,
                            int queries, int cap, int levels,
                            cudaStream_t stream) {
  const int blocks = (queries + kQueriesPerBlock - 1) / kQueriesPerBlock;
  descent_kernel<<<blocks, kThreads, 0, stream>>>(tree, mass, slot, queries,
                                                  cap, levels);
  return static_cast<int>(cudaGetLastError());
}

// Levels the kernel resolves per dependent round trip: a descent of L
// levels takes ceil(L / this) rounds.
extern "C" int d4pg_descent_levels_per_round() { return kLevels; }
