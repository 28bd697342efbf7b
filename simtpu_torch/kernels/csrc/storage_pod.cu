// K5 storage_pod: the Open-Local storage plans of one pod over every node.
//
// Replaces the JAX package's simtpu/kernels/storage.py lvm_plan (:25),
// device_plan (:66) and open_local_score (:100), fused as the JAX
// package's fused cascade runs them in one branch
// (simtpu/engine/scan.py:811-835). One thread owns one node and walks the
// pod's claims in order:
//   LVM: a named claim takes its VG if it has room; an unnamed claim
//        binpacks into the smallest-free VG that fits (first index on
//        ties, as jnp.argmin); each claim debits the thread's copy of the
//        node's VG free row before the next claim looks;
//   devices: each claim takes the smallest adequate free device of its
//        media (first index on ties) and adds size/capacity to the
//        tightness;
//   raw score: mean per-VG usage/capacity x 10 plus tightness / n_dev x 10,
//        the device term contracted into the sum (one FMA) as the compiled
//        reference has it.
// Writes st_ok [N] (has_storage & LVM fits & devices fit), st_alloc [N,V],
// st_take [N,SD] and st_raw [N]. The host launches it only for pods that
// demand storage; K3/K4 use the skip constants for the others.
//
// Bound: bytes — vg_free/vg_cap/vg_name_id [N,V] and sdev_free/cap/media
// [N,SD] are read once and the plans written once; at N <= 1024 the
// launch latency dominates.
//
// The per-node plan lives in ext_plans.cuh (shared with K10).
#include "ext_plans.cuh"

__global__ void storage_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  storage_node(x, i, n);
}

extern "C" int simtpu_storage_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 128;
  const int blocks = (ctx->n + threads - 1) / threads;
  storage_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
