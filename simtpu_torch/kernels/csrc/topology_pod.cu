// K2 topology_pod: the [Tc, N] term-row work of one pod.
//
// Replaces the [Tc, N] part of the JAX package's simtpu/engine/scan.py
// filter_and_score and score_pod (scan.py:755-763, 898-963, 646-699):
// topology_spread_filter and interpod_filter (simtpu/kernels/filters.py
// :78-155) and the raw parts of interpod_score, topology_spread_score and
// selector_spread_score (simtpu/kernels/scores.py). For the group's term
// columns (g_terms[g], -1 = pad) it reads the domain row
// node_dom[term_topo[t]], the count row cnt_match[t] and, through ip_of,
// the own-plane rows; it sets stage bits 6 (spread) and 7 (all) and writes
// the four raw [N] count vectors K3 normalizes.
//
// Design (launch plan kernels/cuda.py topology_plan):
//   1. the group's rows of the term columns' table (StepCtx g_cols, built
//      once per argument block on the host; the group comes from the
//      host) are staged in shared memory as one 32-byte record a column
//      (term, key row, interpod row, flag bits, w_aff - w_anti, the hard
//      and soft weights; topology.cuh StagedCols), each node's stage byte
//      loaded beside them: one round of loads, one barrier. Past the plan's
//      shared budget a segment lives in the block's slab of global scratch
//      (wave.cuh wave_seg): any Tc.
//   2. one thread a node (NPT 1): the node reads each column's record with
//      two 16-byte loads, the rows of TOPO_UNROLL columns loaded together,
//      and adds each column's verdicts and raw sums in column order
//      (topology.cuh TopoAcc, the arithmetic every caller shares) and the
//      pod's inter-pod scalars (topo_scalars' sums) as it goes; the first
//      TOPO_HREG hard-spread columns keep their (column, valid, count) in
//      registers.
//   3. only for a group with a hard-spread column: each warp's minimum of
//      each such column (one shared write a warp a column, no atomics), one
//      barrier, each warp folds the warps' minima (wave.cuh slot_min, as
//      K10's fold A), the nodes take their verdicts. Then the stage byte and
//      the raw rows are written.
//   The node pass is one SM's issue rate at one block of 1024 nodes (a
//   measured finding, PERF.md), so the nodes are spread over blocks:
//   up to TOPO_THREADS nodes a plain launch of several blocks in which
//   each block takes the minima over every node itself (its threads'
//   strided shares, TOPO_MIN_UNROLL nodes' rows loaded together): no block
//   waits on another. Past TOPO_THREADS nodes a thread-block cluster of up
//   to TOPO_CLUSTER_MAX blocks, one node tile a block, each block's minima
//   over its own tile traded through distributed shared memory across one
//   cluster barrier (min is exact in any order). Where a tile holds more
//   nodes than a block has threads (NPT 0: past TOPO_CLUSTER_MAX x
//   TOPO_THREADS nodes, or a plan asked for) the minima are taken column
//   by column first and every node then runs topology_node over the
//   staged columns. The raw sums add integer-valued floats in each node's
//   own column order, so any tiling gives the same bits.
//
// Bound: bytes — each touched [Tc, N] row is read once (domain, count and
// own rows), the raw rows and stage byte written once; at the main paths'
// sizes a launch is two dependent rounds of loads (the group's columns,
// the node rows), three with a hard-spread column (the minima), and one
// or two barriers.
#include "topology.cuh"
#include "wave.cuh"

constexpr int TOPO_THREADS = 1024;
constexpr int TOPO_CLUSTER_MAX = 16;
// columns whose node rows one thread loads together
constexpr int TOPO_UNROLL = 2;
// hard-spread columns whose (column, valid, count) a thread keeps in registers
constexpr int TOPO_HREG = 4;
// nodes whose rows one thread loads together in a minimum's pass
constexpr int TOPO_MIN_UNROLL = 4;

// the launch plan (kernels/cuda.py topology_plan), passed by value
struct TopoPlan {
  int blocks;       // blocks of the grid
  int threads;      // threads a block
  int tile;         // nodes a block (a multiple of 32; the last tile ragged)
  int npt;          // 1: one node a thread; 0: a thread walks tile / threads nodes
  int cluster;      // 1: one thread-block cluster, the minima traded through distributed shared memory;
                    // 0: a plain launch, each block takes the minima over every node itself
  int off_cols;     // the staged columns [tc][TOPO_REC_WORDS] (wave.cuh wave_seg)
  int off_bmin;     // the block's minima [tc] (keys), which its cluster peers read
  int off_mins;     // the per-warp minima [32][tc] (keys)
  int smem;         // dynamic shared bytes
  int slab_stride;  // bytes of a block's slab
  unsigned char* slab;  // global scratch past the shared budget, slab_stride bytes a block (null: none)
};

template <int NPT, bool SLAB>
__global__ void __launch_bounds__(TOPO_THREADS) topology_pod_kernel(StepCtx x, int g, TopoPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = x.n, TC = x.tc;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, n_warps = nt >> 5;
  const int rank = blockIdx.x, B = p.blocks;
  const bool cluster = p.cluster && B > 1;
  const int lo = rank * p.tile, hi = min(N, lo + p.tile);
  // the nodes a block takes its minima over: its tile (one block, or a
  // cluster), every node (a plain launch of several blocks)
  const int m_lo = cluster || B == 1 ? lo : 0, m_hi = cluster || B == 1 ? hi : N;
  unsigned char* slab = SLAB ? p.slab + static_cast<size_t>(rank) * p.slab_stride : nullptr;
  const StagedCols cols{wave_seg<int, SLAB>(smem, slab, p.off_cols)};
  unsigned* bmin = wave_seg<unsigned, SLAB>(smem, slab, p.off_bmin);
  unsigned* slots = wave_seg<unsigned, SLAB>(smem, slab, p.off_mins);
  const bool do_spread = (x.flags & F_SPREAD_HARD) && TC > 0;
  const bool do_ip = (x.flags & F_INTERPOD_REQ) && TC > 0;
  const int n1 = lo + tid;
  const bool active = NPT == 1 && n1 < hi;
  const unsigned st1 = active ? x.stage[n1] : 0u;

  // 1. the group's rows of the column table (one round of loads)
  const int* tab = x.g_cols + static_cast<size_t>(g) * TOPO_COL_WORDS * TC;
  for (int t = tid; t < TC; t += nt) cols.put(t, tab, TC);
  __syncthreads();

  // column c's minimum count over the eligible nodes (stage bit 0) of
  // [m_lo, m_hi) that carry its key, a thread's strided share, the rows of
  // TOPO_MIN_UNROLL nodes loaded together
  auto share_min = [&](const TopoCol& c) {
    const size_t kr = static_cast<size_t>(c.key) * N, tr = static_cast<size_t>(c.term) * N;
    float m = BIG;
    for (int n0 = m_lo + tid; n0 < m_hi; n0 += TOPO_MIN_UNROLL * nt) {
      unsigned st[TOPO_MIN_UNROLL];
      int d[TOPO_MIN_UNROLL];
      float v[TOPO_MIN_UNROLL];
#pragma unroll
      for (int u = 0; u < TOPO_MIN_UNROLL; ++u) {
        const int n = n0 + u * nt;
        const bool in = n < m_hi;
        st[u] = in ? x.stage[n] : 0u;
        d[u] = in ? x.node_dom[kr + n] : -1;
        v[u] = in ? x.cnt_match[tr + n] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < TOPO_MIN_UNROLL; ++u)
        if ((st[u] & 1u) && d[u] >= 0) m = fminf(m, v[u] + 0.0f);  // counts are >= 0 (+0.0f folds -0)
    }
    return m;
  };
  // a hard column's minimum as a key (wave.cuh fkey), in every lane of the
  // warp: after the barrier that follows the warp minima (a block alone),
  // or after the cluster barrier that follows the blocks' own minima (a
  // cluster: each lane reads one peer's, through distributed shared memory
  // or from its slab)
  auto fold_min = [&](int t) -> unsigned {
    if (!cluster) return __reduce_min_sync(0xffffffffu, lane < n_warps ? slots[lane * TC + t] : 0xffffffffu);
    unsigned k = 0xffffffffu;
    if (lane < B) {
      if (p.off_bmin >= 0)
        k = *cluster_peer(&bmin[t], lane);
      else
        k = __ldcg(reinterpret_cast<const unsigned*>(p.slab + static_cast<size_t>(lane) * p.slab_stride +
                                                     (-1 - static_cast<long long>(p.off_bmin))) + t);
    }
    return __reduce_min_sync(0xffffffffu, k);
  };
  // the block's minimum of each hard column over its warps' partials
  auto block_minima = [&]() {
    for (int t = tid; t < TC; t += nt) {
      const TopoCol c = cols(t);
      if (c.term < 0 || !(c.hard > 0.0f)) continue;
      unsigned m = 0xffffffffu;
      for (int w = 0; w < n_warps; ++w) m = min(m, slots[w * TC + t]);
      bmin[t] = m;
    }
  };

  if constexpr (NPT == 1) {
    // 2. the columns at the thread's node, TOPO_UNROLL at a time (their rows
    // loaded together), and the pod's inter-pod scalars (topo_scalars' sums,
    // in column order)
    const bool elig = active && (st1 & 1u);
    TopoAcc acc;
    TopoScalars sc{0.0f, false, true};
    int nh = 0;  // hard-spread columns, the first TOPO_HREG kept
    int ht[TOPO_HREG] = {};
    bool hv[TOPO_HREG] = {};
    float hc[TOPO_HREG] = {};
    for (int t0 = 0; t0 < TC; t0 += TOPO_UNROLL) {
      TopoCol col[TOPO_UNROLL];
      TopoNode v[TOPO_UNROLL];
      float tot[TOPO_UNROLL];
#pragma unroll
      for (int u = 0; u < TOPO_UNROLL; ++u) {
        col[u] = t0 + u < TC ? cols(t0 + u) : TopoCol{-1};
        v[u] = active && col[u].term >= 0 ? topo_load(x, col[u], n1) : TopoNode{};
        tot[u] = col[u].aff_req && col[u].term >= 0 ? x.cnt_total[col[u].term] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < TOPO_UNROLL; ++u) {
        if (t0 + u >= TC) break;
        const TopoCol& c = col[u];
        if (c.aff_req) {
          sc.any_aff = true;
          if (c.term >= 0) sc.total_match += tot[u];
          if (!c.s_match) sc.all_s = false;
        }
        if (c.term < 0) continue;  // the same column in every lane
        if (do_spread && c.hard > 0.0f) {
#pragma unroll
          for (int k = 0; k < TOPO_HREG; ++k)
            if (k == nh) {
              ht[k] = t0 + u;
              hv[k] = v[u].dom >= 0;
              hc[k] = v[u].c;
            }
          ++nh;
        }
        if (active) acc.add(c, v[u], v[u].c);
      }
    }
    // 3. the hard-spread verdicts: each hard column's warp minima (of the
    // thread's own node, or of its share of every node), one barrier, the
    // fold (and across a cluster barrier the peers'), the verdict. A hard
    // column past the first TOPO_HREG is found and read again.
    if (nh > 0) {  // the same in every thread
      const int t_more = nh > TOPO_HREG ? ht[TOPO_HREG - 1] + 1 : TC;
      auto hard_col = [&](int k, int t, bool& valid, float& cnt) {
        if (k < TOPO_HREG) {
#pragma unroll
          for (int j = 0; j < TOPO_HREG; ++j)
            if (j == k) {
              valid = hv[j];
              cnt = hc[j];
            }
        } else if (active) {
          const TopoCol c = cols(t);
          valid = x.node_dom[static_cast<size_t>(c.key) * N + n1] >= 0;
          cnt = x.cnt_match[static_cast<size_t>(c.term) * N + n1];
        }
      };
      auto each_hard = [&](auto&& fn) {
        for (int k = 0; k < min(nh, TOPO_HREG); ++k) {
          int t = 0;
#pragma unroll
          for (int j = 0; j < TOPO_HREG; ++j)
            if (j == k) t = ht[j];
          fn(k, t);
        }
        for (int t = t_more, k = TOPO_HREG; t < TC; ++t) {
          const TopoCol c = cols(t);
          if (c.term < 0 || !(c.hard > 0.0f)) continue;
          fn(k++, t);
        }
      };
      each_hard([&](int k, int t) {
        bool valid = false;
        float cnt = 0.0f;
        hard_col(k, t, valid, cnt);
        const float m = m_lo == lo && m_hi == hi ? (elig && valid ? cnt + 0.0f : BIG) : share_min(cols(t));
        warp_min_slot(m, slots + t, TC);
      });
      __syncthreads();
      if (cluster) {
        block_minima();
        cluster_barrier();
      }
      each_hard([&](int k, int t) {
        const float mn = fkey_value(fold_min(t));
        bool valid = false;
        float cnt = 0.0f;
        hard_col(k, t, valid, cnt);
        if (active) acc.spread(valid, cnt, mn, cols(t).hard);
      });
      if (cluster) cluster_arrive();  // the block's last remote read is done
    }
    if (active) {
      const unsigned s = st1 & 0x3Fu;
      const bool m6 = ((s >> 5) & 1u) && acc.spread_ok;
      const bool m7 = m6 && acc.ip_ok(do_ip, sc);
      x.stage[n1] = static_cast<uint8_t>(s | (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u));
      float raw[N_RAWS];
      acc.raws(raw);
#pragma unroll
      for (int k = 0; k < N_RAWS; ++k) x.raw[static_cast<size_t>(k) * N + n1] = raw[k];
    }
    if (nh > 0 && cluster) cluster_wait();  // no peer reads this block's minima any more
  } else {
    // 2'. the pod's scalars, the minima column by column over the thread's
    // share of the nodes, then the block's (and across one cluster barrier
    // every rank's) into the bits of floats (BIG: none eligible), which
    // topology_node reads
    TopoScalars sc{0.0f, false, true};
    bool any_hard = false;
    for (int t = 0; t < TC; ++t) {
      const TopoCol c = cols(t);
      if (c.aff_req) {
        sc.any_aff = true;
        if (c.term >= 0) sc.total_match += x.cnt_total[c.term];
        if (!c.s_match) sc.all_s = false;
      }
      any_hard = any_hard || (do_spread && c.term >= 0 && c.hard > 0.0f);
    }
    int* min_bits = reinterpret_cast<int*>(cluster ? slots : bmin);
    if (any_hard) {
      for (int t = 0; t < TC; ++t) {
        const TopoCol c = cols(t);
        if (c.term < 0 || !(c.hard > 0.0f)) continue;
        warp_min_slot(share_min(c), slots + t, TC);
      }
      __syncthreads();
      block_minima();
      if (cluster) {
        cluster_barrier();
        // every rank's minima into slots' first row (no block reads the
        // warp partials again)
        const int warp = tid >> 5;
        for (int t = 0; t < TC; ++t) {
          const TopoCol c = cols(t);
          if (c.term < 0 || !(c.hard > 0.0f)) continue;
          const unsigned k = fold_min(t);
          if (lane == 0 && warp == t % n_warps) min_bits[t] = __float_as_int(fkey_value(k));
        }
        cluster_arrive();
      } else {
        for (int t = tid; t < TC; t += nt) {
          const TopoCol c = cols(t);
          if (c.term >= 0 && c.hard > 0.0f) min_bits[t] = __float_as_int(fkey_value(bmin[t]));
        }
      }
      __syncthreads();
    }
    // 3'. every node of the tile over the staged columns
    for (int n = lo + tid; n < hi; n += nt) {
      bool spread_ok, ip_ok;
      float raw[N_RAWS];
      topology_node(x, cols, n, min_bits, do_spread, do_ip, sc, spread_ok, ip_ok, raw);
      const unsigned s = x.stage[n] & 0x3Fu;
      const bool m6 = ((s >> 5) & 1u) && spread_ok;
      const bool m7 = m6 && ip_ok;
      x.stage[n] = static_cast<uint8_t>(s | (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u));
      for (int k = 0; k < N_RAWS; ++k) x.raw[static_cast<size_t>(k) * N + n] = raw[k];
    }
    if (any_hard && cluster) cluster_wait();
  }
}

// One launch of an instance: its function attributes set at its first
// launch (the non-portable cluster size, the shared bytes the plans take
// at most), a plain launch, or a cluster.
template <int NPT, bool SLAB>
static int launch_topology(const StepCtx& x, int g, const TopoPlan& p, cudaStream_t s) {
  auto kernel = topology_pod_kernel<NPT, SLAB>;
  static int attrs = -1;
  if (attrs < 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WAVE_SMEM);
    attrs = static_cast<int>(e);
  }
  if (attrs) return attrs;
  if (!p.cluster) {
    topology_pod_kernel<NPT, SLAB><<<p.blocks, p.threads, p.smem, s>>>(x, g, p);
    return launch_status();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.blocks, 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, g, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_status();
}

// K2 for a pod of group g (the wrapper's host copy of the pod's group) on
// the wrapper's plan; refused where its tiles do not cover the nodes, a
// thread would own no node or (NPT 1) more than one, a cluster would pass
// TOPO_CLUSTER_MAX blocks, or its shared bytes pass the budget
extern "C" int simtpu_topology_pod(const StepCtx* ctx, int g, const TopoPlan* plan, void* stream) {
  const TopoPlan& q = *plan;
  const int n = ctx->n > 0 ? ctx->n : 1;
  if (q.blocks < 1 || (q.cluster && q.blocks > TOPO_CLUSTER_MAX) || q.tile < 32 || q.tile % 32 != 0 ||
      static_cast<long long>(q.blocks) * q.tile < n || static_cast<long long>(q.blocks - 1) * q.tile >= n ||
      q.threads < 32 || q.threads > TOPO_THREADS || q.threads % 32 != 0 || q.smem < 0 || q.smem > WAVE_SMEM ||
      (q.npt == 1 ? q.threads < q.tile : (q.npt != 0 || q.threads > q.tile)) || (q.slab == nullptr) != (q.slab_stride == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.npt == 1) return q.slab ? launch_topology<1, true>(*ctx, g, q, s) : launch_topology<1, false>(*ctx, g, q, s);
  return q.slab ? launch_topology<0, true>(*ctx, g, q, s) : launch_topology<0, false>(*ctx, g, q, s);
}
