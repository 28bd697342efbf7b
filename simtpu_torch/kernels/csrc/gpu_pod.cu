// K6 gpu_pod: the GPU-share plan of one pod over every node.
//
// Replaces the JAX package's simtpu/kernels/gpushare.py gpu_plan (:25), as
// simtpu/engine/scan.py:874-896 runs it. One thread owns one node and
// walks its GD devices:
//   shares per device = floor(free / mem) where the device fits the
//        per-GPU request (missing devices count as free = -1);
//   multi-GPU pods stack shares greedily in device order (the running sum
//        is sequential in the thread; the values are integer-valued f32,
//        so it is exact);
//   1-GPU pods take the tightest fitting device, strict `<`, lowest index
//        on ties;
//   the node fits when its total GPU memory covers the request, it has a
//        device, the request names a count > 0 and the shares reach it;
//   a preset gpu-index annotation is honoured verbatim (no per-device
//        memory check), as AllocateGpuId's short-circuit.
// Writes gpu_ok [N] and gpu_sh [N,GD]. The host launches it only for pods
// with gpu_mem > 0; K3/K4 use the skip constants for the others.
//
// Bound: bytes — gpu_free and gpu_dev_exists [N,GD] and gpu_total [N]
// are read once and the shares written once; at N <= 1024 the launch
// latency dominates.
//
// The per-node plan lives in ext_plans.cuh (shared with K10).
#include "ext_plans.cuh"

__global__ void gpu_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  gpu_node(x, i, n);
}

extern "C" int simtpu_gpu_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 128;
  const int blocks = (ctx->n + threads - 1) / threads;
  gpu_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
