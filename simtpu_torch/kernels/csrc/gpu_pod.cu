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
#include "step_ctx.cuh"

__global__ void gpu_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  const int GD = x.gd;
  const size_t ng = static_cast<size_t>(n) * GD;
  const float mem = x.gpu_mem[i];
  const int count = x.gpu_count[i];
  const int* preset = x.gpu_preset + static_cast<size_t>(i) * GD;
  const bool is_gpu_pod = mem > 0.0f;
  const bool valid_req = count > 0;
  const float count_f = static_cast<float>(count);

  float fr[MAX_EXT];
  bool has_dev = false, any_fit = false;
  int tight_idx = 0;
  float tight_key = BIG;
  for (int d = 0; d < GD; ++d) {
    const bool exists = x.gpu_dev_exists[ng + d] != 0;
    has_dev = has_dev || exists;
    fr[d] = exists ? x.gpu_free[ng + d] : -1.0f;
    const bool fit1 = fr[d] >= mem;
    any_fit = any_fit || fit1;
    const float key = fit1 ? fr[d] : BIG;
    if (d == 0 || key < tight_key) { tight_key = key; tight_idx = d; }
  }
  float shares[MAX_EXT];
  float cum = 0.0f, total = 0.0f;
  for (int d = 0; d < GD; ++d) {
    const float per_dev = fr[d] >= mem ? floorf(__fdiv_rn(fr[d], fmaxf(mem, TINY))) : 0.0f;
    cum = cum + per_dev;
    const float prev = cum - per_dev;
    const float greedy = fminf(fmaxf(fminf(cum, count_f) - prev, 0.0f), per_dev);
    const float tight = (d == tight_idx && any_fit) ? 1.0f : 0.0f;
    shares[d] = count == 1 ? tight : greedy;
    total = total + shares[d];
  }
  const bool node_total_ok = x.gpu_total[n] >= mem;
  bool fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req && total >= count_f) : true;
  int preset_sum = 0;
  for (int d = 0; d < GD; ++d) preset_sum += preset[d];
  if (preset_sum > 0) {
    fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req) : true;
    for (int d = 0; d < GD; ++d)
      x.gpu_sh[ng + d] = (is_gpu_pod && fits) ? static_cast<float>(preset[d]) : 0.0f;
  } else {
    for (int d = 0; d < GD; ++d) x.gpu_sh[ng + d] = (is_gpu_pod && fits) ? shares[d] : 0.0f;
  }
  x.gpu_ok[n] = fits ? 1 : 0;
}

extern "C" int simtpu_gpu_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 128;
  const int blocks = (ctx->n + threads - 1) / threads;
  gpu_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
