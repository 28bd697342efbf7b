// K3 score_argmax_pod: score, first failing stage, argmax and reason.
//
// Replaces the JAX package's simtpu/engine/scan.py score_pod
// (scan.py:595-727), the Open-Local term of filter_and_score
// (scan.py:970-993), StepEval.fail_code (scan.py:583) and the argmax and
// reason at scan.py:1045-1057, with the plugin scores and normalizers of
// simtpu/kernels/scores.py. For a pod that ran K5 (K6) the storage (GPU)
// verdict is ANDed into the cascade after the bind stage, so the stages
// are static, ports, resources, volumes, attach, bind, storage, GPU,
// spread, all (FILTER_CASCADE). One block walks all N nodes twice:
//   pass 1 reduces the stage bits (OR) and the masked normalizers — Simon
//          share min/max, node-affinity min/max, taint max, inter-pod
//          max |raw|, soft-spread min/max, SelectorSpread host/zone max,
//          Open-Local raw min/max — over the feasible nodes (min/max are
//          order-free: bit-exact);
//   pass 2 forms each node's weighted score in the JAX package's term
//          order with the arithmetic of its compiled step, whose weights
//          are runtime values (the resource pair with two roundings, the
//          Simon numerator, the Simon term unless node affinity follows,
//          the static pair and every later term of the running sum as
//          FMAs — see simtpu_torch/kernels/scores.py;
//          each pruned StepFlags term is left out), the mask, then the
//          Open-Local term w10 * minmax(raw), then the argmax with the
//          lowest index on ties (all -inf gives 0).
// Thread 0 applies the forced-pod override and writes chosen, placed,
// reason and out_node for pod i.
//
// Bound: bytes — stage [N], raw [4,N], alloc and free [N,R], the group's
// four [N] score rows and the storage/GPU verdicts and raw score are read
// once, score [N] written once; at N <= 1024 the launch latency dominates.
//
// The score terms, the block passes and the argmax live in scores.cuh
// (shared with K9/K10).
#include "scores.cuh"

__global__ void score_argmax_pod_kernel(StepCtx x, int i) { score_argmax_block(x, i); }

extern "C" int simtpu_score_argmax_pod(const StepCtx* ctx, int i, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  score_argmax_pod_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
