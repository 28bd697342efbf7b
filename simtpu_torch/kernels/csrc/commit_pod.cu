// K4 commit_pod: the state update of one placed pod, IN PLACE.
//
// Replaces the update block of the JAX package's simtpu/engine/scan.py
// schedule_step (scan.py:1059-1131) and the row scatter add_rows
// (simtpu/engine/state.py:62) it runs through. Reads chosen/placed from
// device memory (K3 wrote them); a pod that was not placed changes
// nothing. The thread of the chosen node subtracts the request from its
// free row, adds the group's ports and exclusive volumes, takes the pod's
// LVM allocation, exclusive devices and GPU shares x per-GPU memory at
// that node (K5/K6's plans; none for a pod that skipped them) out of
// vg_free, sdev_free and gpu_free and writes them to the pod's output
// rows, and bumps cnt_total; every node thread adds the group's incidence into its
// cnt_match and own-plane entries for each term whose domain it shares
// with the chosen node. Each (row, node) entry has one writer: no atomics,
// no order dependence.
//
// Bound: bytes — the group's Tc domain rows are read and the touched
// count/own-plane rows read and written once; at N <= 1024 the launch
// latency dominates.
//
// The per-node update lives in node_stages.cuh (shared with K9/K10).
#include "node_stages.cuh"

__global__ void commit_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  commit_node(x, i, n);
}

extern "C" int simtpu_commit_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 256;
  const int blocks = (ctx->n + threads - 1) / threads;
  commit_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
