// Per-node device code of the [Tc, N] term-row work (K2): the arithmetic of
// one term column at one node (TopoCol, topo_load, TopoAcc), which K2
// (topology_pod.cu, over columns staged in shared memory), the lean wave
// kernel wave_lean.cu (K9: the run-start raws and the run-constant
// inter-pod filter), the bulk round's re-score round_score.cu (K14) and the
// explain pass explain_pass.cu (K20, topology_cluster) run through
// topology_node; K15 round_pick.cu takes spread_min_pass; the hard wave
// kernel wave_hard.cu (K10) and the sweep's sweep_place.cu (K19) copy it.
//
// The JAX package's topology_spread_filter and interpod_filter
// (simtpu/kernels/filters.py :78-155) and the raw parts of interpod_score,
// topology_spread_score and selector_spread_score (simtpu/kernels/
// scores.py), over the group's term rows (g_terms[g], -1 = pad). The raw
// sums add integer-valued floats, exact in any order below 2^24.
#pragma once
#include <cooperative_groups.h>

#include "step_ctx.cuh"

// -- thread-block clusters (K14, K16: one a round; K20, K2: one a pod) ---------
// A block publishes in its own shared memory, passes a cluster barrier
// (release / acquire at cluster scope: it orders the blocks' global writes
// too) and reads its peers' copies; no block may exit while another may
// still read its shared memory.

__device__ inline void cluster_arrive() { asm volatile("barrier.cluster.arrive;\n" ::: "memory"); }
__device__ inline void cluster_wait() { asm volatile("barrier.cluster.wait;\n" ::: "memory"); }
__device__ inline void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// `p` (this block's shared memory) in block `rank` of the cluster
template <class T>
__device__ inline const T* cluster_peer(const T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(const_cast<T*>(p), rank);
}

// Launch `kernel` on a grid of `clusters` clusters (the grid's y axis) of
// `blocks` blocks each (the x axis: a block's rank is blockIdx.x), with
// `threads` threads and `smem` bytes of dynamic shared memory a block
// (above 8 blocks the non-portable cluster size); 0 or a CUDA error.
template <class... P, class... A>
inline int launch_clusters(void (*kernel)(P...), int blocks, int clusters, int threads, int smem, cudaStream_t s,
                           const A&... args) {
  cudaError_t e;
  if (blocks > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, clusters, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_status();
}

// per-pod scalars of the inter-pod first-pod-in-series escape
struct TopoScalars {
  float total_match;
  bool any_aff, all_s;
};

__device__ inline TopoScalars topo_scalars(const StepCtx& x, int g) {
  const int tc = x.tc;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  TopoScalars sc{0.0f, false, true};
  for (int t = 0; t < tc; ++t) {
    if (!x.a_aff_req[g0 + t]) continue;
    sc.any_aff = true;
    if (terms[t] >= 0) sc.total_match += x.cnt_total[terms[t]];
    if (!x.s_match[g0 + t]) sc.all_s = false;
  }
  return sc;
}

// The hard-spread minimum of each term over the eligible nodes (stage
// bit 0, m_static) of [lo, hi) (hi < 0: every node), in shared memory as
// the bits of non-negative floats (int order == float order; min is
// order-free). Block-wide, with the barriers before and after.
__device__ inline void spread_min_pass(const StepCtx& x, int g, int* min_bits, bool do_spread, int lo = 0,
                                       int hi = -1) {
  const int tc = x.tc;
  const int N = x.n;
  if (hi < 0) hi = N;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  for (int t = threadIdx.x; t < tc; t += blockDim.x) min_bits[t] = __float_as_int(BIG);
  __syncthreads();
  if (do_spread) {
    for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
      if (!(x.stage[n] & 1u)) continue;  // eligible = m_static
      for (int t = 0; t < tc; ++t) {
        const int term = terms[t];
        if (term < 0 || !(x.spread_hard[g0 + t] > 0.0f)) continue;
        if (x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + n] < 0) continue;
        // counts are >= 0: int order == float order (+0.0f folds -0)
        const float c = x.cnt_match[static_cast<size_t>(term) * N + n] + 0.0f;
        atomicMin(&min_bits[t], __float_as_int(c));
      }
    }
  }
  __syncthreads();
}

// -- one term column at one node: the arithmetic every caller shares ------------
// A term column of group g as the per-node code reads it: the term row
// (-1 = pad: zero row, all coefficients 0), its topology key's node_dom
// row, its interpod row (-1 none) and the column's [G, Tc] statics, the
// preferred inter-pod weight as w_aff_pref - w_anti_pref (the reference
// subtracts before it multiplies). Where the columns come from is the
// caller's: read in place (GlobalCols) or staged once per launch in shared
// memory (StagedCols, K2).
struct TopoCol {
  int term, key, ip;
  bool s_match, aff_req, anti_req, ss_host, ss_zone;
  float w_ipa, hard, soft;
};

// column t of group g read in place from the statics (K9, K14, K20)
struct GlobalCols {
  const StepCtx& x;
  size_t g0;
  __device__ GlobalCols(const StepCtx& x_, int g) : x(x_), g0(static_cast<size_t>(g) * x_.tc) {}
  __device__ TopoCol operator()(int t) const {
    TopoCol c{};
    c.term = x.g_terms[g0 + t];
    if (c.term < 0) return c;
    const size_t gt = g0 + t;
    c.key = x.term_topo[c.term];
    c.ip = x.ip_of[c.term];
    c.s_match = x.s_match[gt];
    c.aff_req = x.a_aff_req[gt];
    c.anti_req = x.a_anti_req[gt];
    c.ss_host = x.ss_host[gt];
    c.ss_zone = x.ss_zone[gt];
    c.w_ipa = x.w_aff_pref[gt] - x.w_anti_pref[gt];
    c.hard = x.spread_hard[gt];
    c.soft = x.spread_soft[gt];
    return c;
  }
};

// Columns staged in shared memory (or a global slab past the budget) as
// records of TOPO_REC_WORDS words, one 16-byte-aligned pair of int4 a
// column: term, key row, interpod row, flag bits (StepCtx's TOPO_*), then
// the bits of w_ipa, hard and soft (K2). put() stages a column from the
// table (StepCtx g_cols) row of its group.
constexpr int TOPO_REC_WORDS = 8;
enum : int { REC_TERM = 0, REC_KEY, REC_IP, REC_FLAGS, REC_W_IPA, REC_HARD, REC_SOFT };
struct StagedCols {
  int* w;  // [tc][TOPO_REC_WORDS]
  __device__ TopoCol operator()(int t) const {
    const int4 a = *reinterpret_cast<const int4*>(w + t * TOPO_REC_WORDS);
    const int4 b = *reinterpret_cast<const int4*>(w + t * TOPO_REC_WORDS + 4);
    TopoCol c;
    c.term = a.x;
    c.key = a.y;
    c.ip = a.z;
    c.s_match = a.w & TOPO_SMATCH;
    c.aff_req = a.w & TOPO_AFF;
    c.anti_req = a.w & TOPO_ANTI;
    c.ss_host = a.w & TOPO_SSHOST;
    c.ss_zone = a.w & TOPO_SSZONE;
    c.w_ipa = __int_as_float(b.x);
    c.hard = __int_as_float(b.y);
    c.soft = __int_as_float(b.z);
    return c;
  }
  // column t of the group's table rows `tab` ([TOPO_COL_WORDS][tc])
  __device__ void put(int t, const int* tab, int tc) const {
    int4 a, b;
    a.x = tab[COL_TERM * tc + t];
    a.y = tab[COL_KEY * tc + t];
    a.z = tab[COL_IP * tc + t];
    a.w = tab[COL_FLAGS * tc + t];
    b.x = __float_as_int(__int_as_float(tab[COL_W_AFF * tc + t]) - __int_as_float(tab[COL_W_ANTI * tc + t]));
    b.y = tab[COL_HARD * tc + t];
    b.z = tab[COL_SOFT * tc + t];
    b.w = 0;
    *reinterpret_cast<int4*>(w + t * TOPO_REC_WORDS) = a;
    *reinterpret_cast<int4*>(w + t * TOPO_REC_WORDS + 4) = b;
  }
};

// node n's rows of a live column (term >= 0): its domain on the column's
// key (-1: it misses the key), its count, and its own-plane entries (read
// only where the column's s_match and interpod row use them, else 0). Raw
// loaded values: nothing here waits on a load, so a caller's loads of
// several columns are in flight together.
struct TopoNode {
  int dom;
  float c, own_anti, own_aff, w_own_aff, w_own_anti;
};

__device__ inline TopoNode topo_load(const StepCtx& x, const TopoCol& col, int n) {
  const size_t N = static_cast<size_t>(x.n);
  TopoNode v{};
  v.dom = x.node_dom[static_cast<size_t>(col.key) * N + n];
  v.c = x.cnt_match[static_cast<size_t>(col.term) * N + n];
  if (col.s_match && col.ip >= 0) {
    const size_t ipn = static_cast<size_t>(col.ip) * N + n;
    v.own_anti = x.cnt_own_anti[ipn];
    v.own_aff = x.cnt_own_aff[ipn];
    v.w_own_aff = x.w_own_aff_pref[ipn];
    v.w_own_anti = x.w_own_anti_pref[ipn];
  }
  return v;
}

// A node's verdicts and raw sums over the columns, added in column order
// (the raw sums add integer-valued floats, exact in any order below 2^24)
struct TopoAcc {
  bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
  float ipa_in = 0.0f, ipa_sym = 0.0f, sp = 0.0f, ssh = 0.0f, ssz = 0.0f;

  // everything of a live column but its hard-spread verdict; c the node's count
  __device__ void add(const TopoCol& col, const TopoNode& v, float c) {
    if (col.anti_req && c > 0.0f) anti = true;
    const bool own = col.s_match && col.ip >= 0;
    if (own && v.own_anti > 0.0f) sym = true;
    if (col.aff_req) {
      const bool valid = v.dom >= 0;
      if (!(valid && c > 0.0f)) aff_ok = false;
      if (!valid) aff_keys = false;
    }
    ipa_in += col.w_ipa * c;
    if (own) ipa_sym += (v.w_own_aff - v.w_own_anti) + v.own_aff;
    sp += col.soft * c;
    if (col.ss_host) ssh += c;
    if (col.ss_zone) ssz += c;
  }
  // the hard-spread verdict of a column of max skew ms > 0, mn the minimum
  // count over the eligible nodes (BIG: none is eligible)
  __device__ void spread(bool valid, float c, float mn, float ms) {
    if (mn >= BIG) mn = 0.0f;
    if (!(valid && (c + 1.0f) - mn <= ms)) spread_ok = false;
  }
  __device__ bool ip_ok(bool do_ip, const TopoScalars& sc) const {
    if (!do_ip) return true;
    const bool self_ok = sc.total_match == 0.0f && sc.all_s && aff_keys;
    return (aff_ok || (sc.any_aff && self_ok)) && !anti && !sym;
  }
  __device__ void raws(float raw[N_RAWS]) const {
    raw[RAW_IPA] = ipa_in + ipa_sym;
    raw[RAW_SOFT] = sp;
    raw[RAW_SS_HOST] = ssh;
    raw[RAW_SS_ZONE] = ssz;
  }
};

// Node n's spread and inter-pod verdicts and its four raw counts (inter-
// pod, soft spread, SelectorSpread host, zone) over the columns `cols`;
// `min_bits` (the bits of each column's eligible minimum, BIG where none)
// is read only when `do_spread`. With `bump` every term row the group's
// pod matches counts one more pod where the node carries the key: the
// state one pod further on, which the bulk round's re-score reads (K14).
template <class Cols>
__device__ inline void topology_node(const StepCtx& x, const Cols& cols, int n, const int* min_bits,
                                     bool do_spread, bool do_ip, const TopoScalars& sc,
                                     bool& spread_ok_out, bool& ip_ok_out, float raw[N_RAWS],
                                     bool bump = false) {
  TopoAcc acc;
  for (int t = 0; t < x.tc; ++t) {
    const TopoCol col = cols(t);
    if (col.term < 0) continue;
    const TopoNode v = topo_load(x, col, n);
    float c = v.c;
    if (bump && v.dom >= 0 && col.s_match) c += 1.0f;
    if (do_spread && col.hard > 0.0f) acc.spread(v.dom >= 0, c, __int_as_float(min_bits[t]), col.hard);
    acc.add(col, v, c);
  }
  spread_ok_out = acc.spread_ok;
  ip_ok_out = acc.ip_ok(do_ip, sc);
  acc.raws(raw);
}

// the same over group g's columns read in place
__device__ inline void topology_node(const StepCtx& x, int g, int n, const int* min_bits, bool do_spread,
                                     bool do_ip, const TopoScalars& sc, bool& spread_ok_out, bool& ip_ok_out,
                                     float raw[N_RAWS], bool bump = false) {
  topology_node(x, GlobalCols(x, g), n, min_bits, do_spread, do_ip, sc, spread_ok_out, ip_ok_out, raw, bump);
}

// K2 for pod i on the node tile [lo, hi) of a block of a thread-block
// cluster whose `blocks` blocks tile the N nodes (K20): stage bits 6 and 7
// and the raw rows of the tile's nodes. Each block takes the per-term
// minimum over its own tile's eligible nodes into min_bits[0, tc); across
// one cluster barrier every block folds all ranks' minima (min is exact in
// any order) through distributed shared memory into min_bits[tc, 2 tc),
// the minimum over every node, which the verdicts read. `min_bits` holds
// 2 tc ints of shared memory; the peers read the first tc of them, so the
// caller passes another cluster barrier before the block exits. Every
// block takes the same branch (flags and tc, not data).
__device__ inline void topology_cluster(const StepCtx& x, int i, int lo, int hi, int* min_bits, int blocks) {
  const int g = x.group[i];
  const int tc = x.tc;
  const bool do_spread = (x.flags & F_SPREAD_HARD) && tc > 0;
  const bool do_ip = (x.flags & F_INTERPOD_REQ) && tc > 0;
  int* min_all = min_bits + tc;
  if (do_spread) {
    spread_min_pass(x, g, min_bits, true, lo, hi);
    cluster_barrier();
    for (int t = threadIdx.x; t < tc; t += blockDim.x) {
      int m = min_bits[t];
      for (int b = 0; b < blocks; ++b) m = min(m, *cluster_peer(&min_bits[t], b));
      min_all[t] = m;
    }
    __syncthreads();
  }
  const TopoScalars sc = topo_scalars(x, g);
  const int N = x.n;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    bool spread_ok, ip_ok;
    float raw[N_RAWS];
    topology_node(x, g, n, min_all, do_spread, do_ip, sc, spread_ok, ip_ok, raw);
    const unsigned s = x.stage[n] & 0x3Fu;
    const bool m6 = ((s >> 5) & 1u) && spread_ok;
    const bool m7 = m6 && ip_ok;
    x.stage[n] = static_cast<uint8_t>(s | (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u));
    for (int k = 0; k < N_RAWS; ++k) x.raw[static_cast<size_t>(k) * N + n] = raw[k];
  }
}
