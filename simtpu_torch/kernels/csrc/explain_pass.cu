// K20 explain_pass: the per-stage failure breakdown of a chunk of pods
// against one carried state, one thread-block cluster per pod.
//
// Replaces the JAX package's simtpu/explain/breakdown.py _explain_call
// (:94): vmapped over the chunk's pods, simtpu/engine/scan.py
// filter_and_score's ten cascade masks (FILTER_CASCADE) walked from
// statics.node_valid; per stage the count of alive nodes it eliminates
// and the lowest k such node indices (top_k on n - idx, -1 pad), the
// count that survive every stage, and StepEval.fail_code (scan.py:583).
// No output depends on the score, so none is computed.
//
// Design: one thread-block cluster per pod. The grid is (B, P) with a
// cluster of (B, 1, 1): block (b, p) takes node tile b of pod p of the
// chunk (the plan's tile, a multiple of 32 nodes, the last one ragged,
// none empty; kernels/cuda.py explain_plan). Every block reads the one
// state and writes none of it. K1's, K2's, K5's and K6's scratch (stage
// byte, raw rows, the storage and GPU plans) is per pod: the StepCtx
// points at pod 0's copies and explain_block_ctx moves them to pod p's
// (the pattern of sweep_block_ctx in sweep_place.cu); a block writes only
// its tile of them. Each block:
//   1. the stage byte (K1's code, node_stages.cuh filter_bits) and, for a
//      pod that demands them, the Open-Local and GPU plans (K5's, K6's
//      code, ext_plans.cuh) of its tile's nodes;
//   2. the spread and inter-pod filters (K2's code, topology.cuh
//      topology_cluster): the hard-spread minimum per term over the
//      tile's eligible nodes, folded over the cluster's ranks through
//      distributed shared memory across one cluster barrier (min is exact
//      in any order), then the verdicts of the tile's nodes;
//   3. the ten cascade bits per node (scores.cuh cascade_bits, the one
//      map from the stage byte to StepEval's masks) walked from
//      node_valid. Thread t owns a contiguous run of the tile's nodes and
//      counts, per stage, the nodes still alive that it eliminates, and
//      the nodes that survive every stage. A warp scan (shuffles) and one
//      block barrier give each thread its exclusive base within the
//      block and the block its tile totals and the OR of its cascade
//      bits, which it publishes in shared memory; after one cluster
//      barrier each block takes its base as the sum of the lower ranks'
//      totals. A thread whose first rank of some stage is below k walks
//      its nodes again and writes the witnesses of rank below k: lowest
//      first and ascending across the whole pod, since the ranks follow
//      (tile, thread, node) order, which is node order. The counts are
//      integer sums, exact in any order;
//   4. rank 0 writes the counts, the feasible count (the nodes alive
//      after the last stage), the -1 pad of the witness rows past each
//      stage's total, and the fail code (scores.cuh fail_code on the
//      cluster-wide OR of the cascade bits, as K3 computes it).
//
// Bound: each block reads the state planes its stages touch once (at 64
// pods x N = 5000 about 0.39 MB: 0.117 µs at 3.35 TB/s). The earlier
// kernel ran a pod on one SM (64 of 132 SMs at a full chunk), walked its
// nodes tile by tile with three barriers a tile and a loop over the warps
// below: one SM's issue rate. Here a pod spreads over up to 16 SMs with
// two block barriers and two or three cluster barriers in all.
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

// the launch plan (kernels/cuda.py explain_plan), passed by value
struct ExplainPlan {
  int blocks, threads, tile, smem;
};

// words a block publishes to its cluster: the ten stages' eliminations,
// the survivors, the OR of the cascade bits
constexpr int EX_WORDS = N_CASCADE + 2;
constexpr int EXPLAIN_CLUSTER_MAX = 16;
constexpr int EXPLAIN_THREADS = 1024;

__global__ void __launch_bounds__(EXPLAIN_THREADS) explain_pass_kernel(StepCtx x0, ExplainCtx e, ExplainPlan plan) {
  extern __shared__ int min_bits[];            // [2 tc] this tile's per-term eligible minima, the cluster's
  __shared__ int warp_tot[32][EX_WORDS];       // each warp's totals
  __shared__ int pub[EX_WORDS];                // this tile's totals, read by the cluster
  __shared__ int cbase[EX_WORDS], ctot[EX_WORDS];  // the lower ranks' totals, every rank's
  const int p = blockIdx.y, rank = blockIdx.x, B = plan.blocks;
  const StepCtx x = explain_block_ctx(x0, p);
  const int i = p;  // the cluster's pod in the chunk's pod arrays
  const int N = x.n;
  const int lo = rank * plan.tile, hi = min(N, lo + plan.tile), len = hi - lo;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int k = e.k;
  const unsigned live = x.ext_live[i];
  const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
  // 1. the stage byte (bits 0-5) and the storage and GPU plans of the tile
  for (int n = lo + tid; n < hi; n += nt) {
    x.stage[n] = static_cast<uint8_t>(filter_bits(x, i, n));
    if (st_live) storage_node(x, i, n);
    if (gpu_live) gpu_node(x, i, n);
  }
  __syncthreads();
  // 2. spread and inter-pod filters (stage bits 6-7), minima over the cluster
  topology_cluster(x, i, lo, hi, min_bits, B);
  __syncthreads();
  // 3. the cascade walk: thread t the nodes [a0, a1) of the tile
  const int per = (len + nt - 1) / nt;
  const int a0 = lo + min(len, tid * per), a1 = lo + min(len, (tid + 1) * per);
  // node n's cascade bits; the stages that eliminate it, whether it survives them all
  auto walk = [&](int n, unsigned& elim, bool& alive) {
    const unsigned c = cascade_bits(x, n, st_live, gpu_live);
    alive = x.node_valid[n];
    elim = 0u;
#pragma unroll
    for (int s = 0; s < N_CASCADE; ++s) {
      const bool m = (c >> s) & 1u;
      if (alive && !m) elim |= 1u << s;
      alive = alive && m;
    }
    return c;
  };
  int cnt[N_CASCADE + 1];
#pragma unroll
  for (int s = 0; s <= N_CASCADE; ++s) cnt[s] = 0;
  unsigned bits_or = 0u;
  for (int n = a0; n < a1; ++n) {
    unsigned elim;
    bool alive;
    bits_or |= walk(n, elim, alive);
#pragma unroll
    for (int s = 0; s < N_CASCADE; ++s) cnt[s] += (elim >> s) & 1u;
    cnt[N_CASCADE] += alive ? 1 : 0;
  }
  // the warp's inclusive scan of the counts, its totals into warp_tot
  int incl[N_CASCADE + 1];
#pragma unroll
  for (int s = 0; s <= N_CASCADE; ++s) {
    int v = cnt[s];
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    incl[s] = v;
  }
  const unsigned wor = __reduce_or_sync(0xffffffffu, bits_or);
  if (lane == 31) {
#pragma unroll
    for (int s = 0; s <= N_CASCADE; ++s) warp_tot[warp][s] = incl[s];
    warp_tot[warp][N_CASCADE + 1] = static_cast<int>(wor);
  }
  __syncthreads();
  // every warp scans the warps' totals: lane l holds warp l's; the thread's
  // exclusive base in the block, the block's totals and OR
  int tbase[N_CASCADE + 1];
#pragma unroll
  for (int s = 0; s <= N_CASCADE; ++s) {
    const int w = lane < n_warps ? warp_tot[lane][s] : 0;
    int v = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    tbase[s] = __shfl_sync(0xffffffffu, v - w, warp) + incl[s] - cnt[s];
    const int block_total = __shfl_sync(0xffffffffu, v, 31);
    if (tid == 0) pub[s] = block_total;
  }
  const unsigned bor = __reduce_or_sync(0xffffffffu, lane < n_warps ? static_cast<unsigned>(warp_tot[lane][N_CASCADE + 1]) : 0u);
  if (tid == 0) pub[N_CASCADE + 1] = static_cast<int>(bor);
  // the ranks' totals: after the barrier the lower ranks' sums and every rank's
  cluster_barrier();
  if (tid < EX_WORDS) {
    int below = 0, all = 0;
    for (int b = 0; b < B; ++b) {
      const int v = *cluster_peer(&pub[tid], b);
      if (tid == N_CASCADE + 1) {
        all |= v;
      } else {
        all += v;
        below += b < rank ? v : 0;
      }
    }
    cbase[tid] = below;
    ctot[tid] = all;
  }
  __syncthreads();
  cluster_arrive();  // the block's last remote read is done
  // the witnesses: rank below k, in node order
  int* wit = e.witnesses + static_cast<size_t>(p) * N_CASCADE * k;
  int rk[N_CASCADE];
  bool any = false;
#pragma unroll
  for (int s = 0; s < N_CASCADE; ++s) {
    rk[s] = cbase[s] + tbase[s];
    any = any || (cnt[s] > 0 && rk[s] < k);
  }
  if (any) {
    for (int n = a0; n < a1; ++n) {
      unsigned elim;
      bool alive;
      walk(n, elim, alive);
#pragma unroll
      for (int s = 0; s < N_CASCADE; ++s) {
        if (!((elim >> s) & 1u)) continue;
        if (rk[s] < k) wit[s * k + rk[s]] = n;
        ++rk[s];
      }
    }
  }
  // 4. the outputs (rank 0): counts, feasible, fail code, the witness pad
  if (rank == 0) {
    for (int q = tid; q < N_CASCADE * k; q += nt)
      if (q % k >= ctot[q / k]) wit[q] = -1;
    if (tid < N_CASCADE) e.counts[static_cast<size_t>(p) * N_CASCADE + tid] = ctot[tid];
    if (tid == 0) {
      e.feasible[p] = ctot[N_CASCADE];
      e.fail_code[p] = fail_code(static_cast<unsigned>(ctot[N_CASCADE + 1]));
    }
  }
  cluster_wait();
}

// the wrapper's plan (kernels/cuda.py explain_plan); refused where its
// tiles do not cover the nodes, every node of a tile on one thread, or its
// shared bytes are not the kernel's
extern "C" int simtpu_explain_pass(const StepCtx* ctx, const ExplainCtx* e, const ExplainPlan* plan, void* stream) {
  if (e->p == 0) return 0;
  const int n = ctx->n > 0 ? ctx->n : 1;
  const ExplainPlan& q = *plan;
  if (q.blocks < 1 || q.blocks > EXPLAIN_CLUSTER_MAX || q.tile < 1 || q.tile % 32 != 0 ||
      static_cast<long long>(q.blocks) * q.tile < n || static_cast<long long>(q.blocks - 1) * q.tile >= n ||
      q.threads < 32 || q.threads > EXPLAIN_THREADS || q.threads % 32 != 0 || q.threads > q.tile ||
      q.smem != 2 * ctx->tc * static_cast<int>(sizeof(int)) || e->p > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_clusters(explain_pass_kernel, q.blocks, e->p, q.threads, q.smem, static_cast<cudaStream_t>(stream),
                         *ctx, *e, q);
}
