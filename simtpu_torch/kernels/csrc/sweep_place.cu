// K19 sweep_place: the requeue of every scenario of a sweep chunk, one
// block per scenario, persistent over its pod list.
//
// Replaces the vmapped schedule_step scan of the JAX package's
// simtpu/faults/sweep.py _fault_sweep (:71-75) and of
// simtpu/parallel/sweep.py _sweep_scan (:65-67): per scenario, a
// lax.scan of simtpu/engine/scan.py schedule_step over the scenario's pods
// against statics whose node_valid is the scenario's surviving mask. The
// result is exactly what the serial chain K1->(K5)->(K6)->K2->K3->K4 gives
// pod by pod on the scenario's own state: the same per-node device code
// (node_stages.cuh, ext_plans.cuh, topology.cuh, scores.cuh) in the same
// order, as K10 wave_hard runs it.
//
// Design: the scenario axis is the grid. Block s takes the single-scenario
// StepCtx with every state plane moved to replica s (written by K18), its
// node_valid to row s of the surviving masks (base & ~failed), and its
// per-launch scratch (stage, raw, score, the storage and GPU plans) and
// per-pod outputs to block s's own copies (sweep_block_ctx). It then walks
// row s of SweepCtx.idx — rows into the whole batch's pod arrays, not
// per-scenario gathered copies — and stops at the first padded row: JAX
// puts its phantom rows after every real pod and masks their outputs on
// the host, so skipping them is exact. Threads stride over the N nodes;
// unlike K10 the group changes from pod to pod, so nothing is staged once
// per launch. Each step, separated by barriers:
//   1. the stage byte per node (K1's code), the Open-Local and GPU plans
//      for a pod that demands them (K5's, K6's code);
//   2. the hard-spread minimum per term (shared memory, tc ints) and the
//      spread and inter-pod filters and raw counts (K2's code);
//   3. the normalizers, score, argmax and reason (K3's code), written to
//      output row j of block s;
//   4. the commit into replica s (K4's code).
//
// Bound: latency — four block-wide passes over N nodes per pod step, with
// barriers; S blocks run side by side on the card's SMs.
#include "ext_plans.cuh"
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"

// the single-scenario block of scenario s: replica s of every state plane,
// row s of the surviving masks, block s's scratch and output rows
__device__ inline StepCtx sweep_block_ctx(StepCtx x, const SweepCtx& w, int s) {
  const size_t N = static_cast<size_t>(x.n);
  const size_t sz = static_cast<size_t>(s);
  x.free += sz * N * x.r;
  x.cnt_match += sz * w.t * N;
  x.cnt_total += sz * w.t;
  x.cnt_own_anti += sz * w.ti * N;
  x.cnt_own_aff += sz * w.ti * N;
  x.w_own_aff_pref += sz * w.ti * N;
  x.w_own_anti_pref += sz * w.ti * N;
  x.ports_used += sz * N * x.p_ports;
  x.vols_any += sz * N * x.w;
  x.vols_rw += sz * N * x.w;
  x.vg_free += sz * N * x.v;
  x.sdev_free += sz * N * x.sd;
  x.gpu_free += sz * N * x.gd;
  x.node_valid += sz * N;
  x.stage += sz * N;
  x.raw += sz * N * N_RAWS;
  x.score += sz * N;
  x.st_ok += sz * N;
  x.st_alloc += sz * N * x.v;
  x.st_take += sz * N * x.sd;
  x.st_raw += sz * N;
  x.gpu_ok += sz * N;
  x.gpu_sh += sz * N * x.gd;
  const size_t rows = sz * w.cols;
  x.chosen += rows;
  x.placed += rows;
  x.reason += rows;
  x.out_node += rows;
  x.out_lvm += rows * x.v;
  x.out_take += rows * x.sd;
  x.out_gpu += rows * x.gd;
  return x;
}

__global__ void __launch_bounds__(WAVE_THREADS) sweep_place_kernel(StepCtx x0, SweepCtx w) {
  extern __shared__ int min_bits[];  // [tc] per-term eligible minimum
  const StepCtx x = sweep_block_ctx(x0, w, blockIdx.x);
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* rows = w.idx + static_cast<size_t>(blockIdx.x) * w.cols;
  for (int j = 0; j < w.cols; ++j) {
    const int i = rows[j];
    if (i < 0) break;  // padding only trails
    const unsigned live = x.ext_live[i];
    // 1. the stage byte (bits 0-5) and the storage and GPU plans
    for (int n = tid; n < N; n += nt) {
      x.stage[n] = static_cast<uint8_t>(filter_bits(x, i, n));
      if (live & LIVE_STORAGE) storage_node(x, i, n);
      if (live & LIVE_GPU) gpu_node(x, i, n);
    }
    __syncthreads();
    // 2. spread and inter-pod filters, raw counts
    topology_block(x, i, min_bits);
    __syncthreads();
    // 3. score, argmax, reason at output row j
    score_argmax_block(x, i, j);
    __syncthreads();
    // 4. the commit into this scenario's replica
    for (int n = tid; n < N; n += nt) commit_node(x, i, n, j);
    __syncthreads();
  }
}

extern "C" int simtpu_sweep_place(const StepCtx* ctx, const SweepCtx* w, void* stream) {
  if (w->s == 0) return 0;
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > WAVE_THREADS ? WAVE_THREADS : threads);
  const size_t smem = static_cast<size_t>(ctx->tc) * sizeof(int);
  sweep_place_kernel<<<w->s, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *w);
  return launch_status();
}
