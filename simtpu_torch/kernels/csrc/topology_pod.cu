// K2 topology_pod: the [Tc, N] term-row work of one pod.
//
// Replaces the [Tc, N] part of the JAX package's simtpu/engine/scan.py
// filter_and_score and score_pod (scan.py:755-763, 898-963, 646-699):
// topology_spread_filter and interpod_filter (simtpu/kernels/filters.py
// :78-155) and the raw parts of interpod_score, topology_spread_score and
// selector_spread_score (simtpu/kernels/scores.py). For the group's term
// rows (g_terms[g], -1 = pad) it reads the domain row
// node_dom[term_topo[t]], the count row cnt_match[t] and, through ip_of,
// the own-plane rows; it sets stage bits 6 (spread) and 7 (all) and writes
// the four raw [N] count vectors K3 normalizes.
//
// One block walks all N nodes: the hard-spread filter needs the per-term
// minimum over eligible nodes (a reduction over N, kept in shared memory
// with atomicMin on the bits of non-negative floats — min is order-free)
// before the per-node pass. The raw sums add integer-valued floats, exact
// in any order below 2^24.
//
// Bound: bytes — each touched [Tc, N] row is read once (domain, count and
// own rows), the raw rows written once; at N <= 1024 the launch latency
// dominates.
//
// The per-node work lives in topology.cuh (shared with K9/K10).
#include "topology.cuh"

__global__ void topology_pod_kernel(StepCtx x, int i) {
  extern __shared__ int min_bits[];  // [tc] per-term eligible minimum
  topology_block(x, i, min_bits);
}

extern "C" int simtpu_topology_pod(const StepCtx* ctx, int i, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(ctx->tc) * sizeof(int);
  topology_pod_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
