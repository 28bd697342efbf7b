// K20 explain_pass: the per-stage failure breakdown of a chunk of pods
// against one carried state, one block per pod.
//
// Replaces the JAX package's simtpu/explain/breakdown.py _explain_call
// (:94): vmapped over the chunk's pods, simtpu/engine/scan.py
// filter_and_score's ten cascade masks (FILTER_CASCADE) walked from
// statics.node_valid; per stage the count of alive nodes it eliminates
// and the lowest k such node indices (top_k on n - idx, -1 pad), the
// count that survive every stage, and StepEval.fail_code (scan.py:583).
// No output depends on the score, so none is computed.
//
// Design: the pods are the grid. Block p takes pod p of the chunk; every
// block reads the one state and writes none of it. K1's, K2's, K5's and
// K6's scratch (stage byte, raw rows, the storage and GPU plans) is per
// block: the StepCtx points at block 0's copies and explain_block_ctx
// moves them to block p's (the pattern of sweep_block_ctx in
// sweep_place.cu). Threads stride over the N nodes. Each block, with
// barriers between the steps:
//   1. the stage byte (K1's code, node_stages.cuh filter_bits) and, for a
//      pod that demands them, the Open-Local and GPU plans (K5's, K6's
//      code, ext_plans.cuh);
//   2. the hard-spread minimum per term over the pod's own eligible nodes
//      and the spread and inter-pod filters (K2's code, topology.cuh);
//   3. the ten cascade bits per node (scores.cuh cascade_bits, the one
//      map from the stage byte to StepEval's masks) walked from
//      node_valid: per stage, the nodes still alive that it eliminates.
//      Tile by tile in ascending node order, a warp ballot and a per-warp
//      prefix give each eliminated node its rank among the stage's
//      eliminations so far; ranks below k are written as witnesses, so
//      they come out lowest first and ascending. The counts are integer
//      sums, exact in any order;
//   4. thread 0 writes the feasible count (the nodes alive after the last
//      stage) and the fail code (scores.cuh fail_code on the OR of the
//      cascade bits, as K3 computes it).
//
// Bound: each block reads the state planes its stages touch once; at
// P <= 64 blocks and N <= 5000 nodes the launch and the block-wide
// barriers dominate.
#include "ext_plans.cuh"
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"

struct ExplainCtx {
  int p, k;        // pods in the chunk (the grid), witnesses per stage
  int* counts;     // [P, 10] nodes eliminated per cascade stage
  int* feasible;   // [P] nodes surviving every stage
  int* witnesses;  // [P, 10, k] lowest eliminated node indices, -1 pad
  int* fail_code;  // [P]
};

// block p's scratch: stage byte, raw rows, storage and GPU plans
__device__ inline StepCtx explain_block_ctx(StepCtx x, int p) {
  const size_t N = static_cast<size_t>(x.n);
  const size_t sp = static_cast<size_t>(p);
  x.stage += sp * N;
  x.raw += sp * N * N_RAWS;
  x.st_ok += sp * N;
  x.st_alloc += sp * N * x.v;
  x.st_fr += sp * N * x.v;
  x.st_take += sp * N * x.sd;
  x.st_raw += sp * N;
  x.gpu_ok += sp * N;
  x.gpu_sh += sp * N * x.gd;
  return x;
}

constexpr int MAX_WARPS = WAVE_THREADS / 32;

__global__ void __launch_bounds__(WAVE_THREADS) explain_pass_kernel(StepCtx x0, ExplainCtx e) {
  extern __shared__ int min_bits[];                // [tc] per-term eligible minimum
  __shared__ int warp_cnt[MAX_WARPS][N_CASCADE + 1];  // this tile's per-warp counts
  __shared__ int base[N_CASCADE + 1];              // counts over the tiles before
  __shared__ unsigned any_bits;
  const int p = blockIdx.x;
  const StepCtx x = explain_block_ctx(x0, p);
  const int i = p;  // the block's pod in the chunk's pod arrays
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int k = e.k;
  int* wit = e.witnesses + static_cast<size_t>(p) * N_CASCADE * k;
  for (int t = tid; t < N_CASCADE * k; t += nt) wit[t] = -1;
  if (tid <= N_CASCADE) base[tid] = 0;
  if (tid == 0) any_bits = 0u;
  const unsigned live = x.ext_live[i];
  // 1. the stage byte (bits 0-5) and the storage and GPU plans
  for (int n = tid; n < N; n += nt) {
    x.stage[n] = static_cast<uint8_t>(filter_bits(x, i, n));
    if (live & LIVE_STORAGE) storage_node(x, i, n);
    if (live & LIVE_GPU) gpu_node(x, i, n);
  }
  __syncthreads();
  // 2. spread and inter-pod filters (stage bits 6-7)
  topology_block(x, i, min_bits);
  __syncthreads();
  // 3. the cascade walk, tile by tile in ascending node order
  const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
  unsigned bits_or = 0u;
  for (int t0 = 0; t0 < N; t0 += nt) {
    const int n = t0 + tid;
    unsigned elim = 0u;
    bool alive = false;
    if (n < N) {
      const unsigned c = cascade_bits(x, n, st_live, gpu_live);
      bits_or |= c;
      alive = x.node_valid[n];
      for (int s = 0; s < N_CASCADE; ++s) {
        const bool m = (c >> s) & 1u;
        if (alive && !m) elim |= 1u << s;
        alive = alive && m;
      }
    }
    unsigned bal[N_CASCADE + 1];
    for (int s = 0; s < N_CASCADE; ++s) bal[s] = __ballot_sync(0xffffffffu, (elim >> s) & 1u);
    bal[N_CASCADE] = __ballot_sync(0xffffffffu, alive);
    if (lane == 0)
      for (int s = 0; s <= N_CASCADE; ++s) warp_cnt[warp][s] = __popc(bal[s]);
    __syncthreads();
    if (elim) {
      const unsigned below = (1u << lane) - 1u;
      for (int s = 0; s < N_CASCADE; ++s) {
        if (!((elim >> s) & 1u)) continue;
        int rank = base[s] + __popc(bal[s] & below);
        for (int w = 0; w < warp; ++w) rank += warp_cnt[w][s];
        if (rank < k) wit[s * k + rank] = n;
      }
    }
    __syncthreads();
    if (tid <= N_CASCADE) {
      int tot = 0;
      for (int w = 0; w < n_warps; ++w) tot += warp_cnt[w][tid];
      base[tid] += tot;
    }
    __syncthreads();
  }
  atomicOr(&any_bits, bits_or);
  __syncthreads();
  // 4. the outputs
  if (tid < N_CASCADE) e.counts[static_cast<size_t>(p) * N_CASCADE + tid] = base[tid];
  if (tid == 0) {
    e.feasible[p] = base[N_CASCADE];
    e.fail_code[p] = fail_code(any_bits);
  }
}

extern "C" int simtpu_explain_pass(const StepCtx* ctx, const ExplainCtx* e, void* stream) {
  if (e->p == 0) return 0;
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > WAVE_THREADS ? WAVE_THREADS : threads);
  const size_t smem = static_cast<size_t>(ctx->tc) * sizeof(int);
  explain_pass_kernel<<<e->p, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *e);
  return launch_status();
}
