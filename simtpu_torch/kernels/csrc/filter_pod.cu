// K1 filter_pod: the per-node filter stages of one pod.
//
// Replaces the JAX package's simtpu/engine/scan.py filter_and_score
// per-node stages (scan.py:765-795), which call resources_fit,
// ports_conflict_free, volume_conflict_free and attach_limits_ok
// (simtpu/kernels/filters.py:23-76): static mask row AND pin AND
// node_valid, then ports, resources (with the _RES_EPS slack, one FMA as
// the compiled reference has it), exclusive volumes, attach limits and
// volume binding. Writes one byte of cumulative stage bits per node.
//
// Bound: bytes. Each thread owns one node and reads its rows of free
// [N,R], ports_used [N,P], vols_any/vols_rw [N,W] and attach_limits
// [N,C] once, plus the group's mask rows; no reduction, no reuse. At the
// serial path's sizes (N <= 1024) the launch latency dominates.
//
// The stages themselves live in node_stages.cuh (shared with K10).
#include "node_stages.cuh"

__global__ void filter_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  x.stage[n] = static_cast<uint8_t>(filter_bits(x, i, n));
}

__global__ void noop_kernel() {}

extern "C" int simtpu_filter_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 256;
  const int blocks = (ctx->n + threads - 1) / threads;
  filter_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}

// an empty launch: the floor every per-pod kernel pays
extern "C" int simtpu_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return launch_status();
}

extern "C" const char* simtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
