// K13 compact_delta: signed placement-log entries folded straight into the
// compact carried state.
//
// Replaces the JAX package's simtpu/engine/state.py compact_delta_step
// (:1205), scanned by _apply_placement_deltas_compact_fn (:1300, jitted
// as apply_placement_deltas_compact :1312): K7's update (delta_apply.cu)
// retargeted at the compact layout, so preemption's evictions and
// restores need no expand -> K7 -> compress round trip. One launch applies
// a whole packed batch (w = +1 re-places, -1 evicts, 0 is padding).
//
// Two kinds of block in one grid:
// - node blocks: thread n owns node n's column and walks the entries in
//   order. At the entry's node it applies delta_rows.cuh's update (K7's
//   code: free, vg_free, gpu_free in f32, whose adds do not commute bit
//   for bit, sdev_free set or cleared by the sign, ports_used / vols_* in
//   int32). On the dense count rows it adds the entry's incidence where
//   node n shares the entry's node's domain (K7's same-domain compare),
//   through t_dense_of / ip_dense_of. One writer per element.
// - entry blocks: one thread per (entry, term slot). A tabular row is
//   constant within a domain, so the dense update collapses to one bucket
//   add at [t_tab_of[t], nds[key, node]] (cm_tab: s_match * w; the four
//   own planes through ip_tab_of: the incidence or preference weight
//   times w), and cnt_total gains s_match * w where the entry's node has
//   the key. These are int32 adds of state-independent integer values:
//   exact and commutative, so they use atomicAdd (the only atomics here),
//   in any order, beside the node blocks, which touch other planes.
//
// Bound: bytes — the entries, the touched rows, buckets and dense columns
// read and written once; a preemption wave applies a few hundred entries,
// so one launch's latency dominates.
#include "delta_rows.cuh"
#include "step_ctx.cuh"

__device__ inline void delta_buckets(const CompactCtx& x, int e, int t) {
  const float w = x.wgt[e];
  if (w == 0.0f) return;
  const int g = x.g[e];
  const int c = x.node[e] < 0 ? 0 : x.node[e];
  const size_t gt = static_cast<size_t>(g) * x.tc + t;
  const int term = x.g_terms[gt];
  if (term < 0) return;
  const size_t key_row = static_cast<size_t>(x.term_topo[term]) * x.n;
  if (x.node_dom[key_row + c] < 0) return;
  const int s = static_cast<int>((x.s_match[gt] ? 1.0f : 0.0f) * w);
  atomicAdd(&x.c_cnt_total[term], s);
  const int bucket = x.nds[key_row + c];
  if (bucket < 0) return;
  const int tr = x.t_tab_of[term];
  if (tr >= 0) atomicAdd(&x.cm_tab[static_cast<size_t>(tr) * x.d + bucket], s);
  const int ip = x.ip_of[term];
  if (ip < 0) return;
  const int ir = x.ip_tab_of[ip];
  if (ir < 0) return;
  const size_t b = static_cast<size_t>(ir) * x.d + bucket;
  atomicAdd(&x.oa_tab[b], static_cast<int>((x.a_anti_req[gt] ? 1.0f : 0.0f) * w));
  atomicAdd(&x.of_tab[b], static_cast<int>((x.a_aff_req[gt] ? 1.0f : 0.0f) * w));
  atomicAdd(&x.wa_tab[b], static_cast<int>(x.w_aff_pref[gt] * w));
  atomicAdd(&x.wn_tab[b], static_cast<int>(x.w_anti_pref[gt] * w));
}

__global__ void compact_delta_kernel(CompactCtx x, int node_blocks) {
  if (static_cast<int>(blockIdx.x) >= node_blocks) {
    const long long j = static_cast<long long>(blockIdx.x - node_blocks) * blockDim.x + threadIdx.x;
    if (j < static_cast<long long>(x.e) * x.tc) delta_buckets(x, static_cast<int>(j / x.tc),
                                                             static_cast<int>(j % x.tc));
    return;
  }
  const int N = x.n;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const DeltaRows<int> rows{x.r, x.p, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp,
                            x.ports_req, x.vol_rw_req, x.vol_ro_req, x.vol_att_req, x.c_free,
                            x.c_ports_used, x.c_vols_any, x.c_vols_rw, x.c_vg_free, x.c_sdev_free,
                            x.c_gpu_free};
  const bool dense_rows = x.rd > 0 || x.rdi > 0;
  for (int e = 0; e < x.e; ++e) {
    const float w = x.wgt[e];
    if (w == 0.0f) continue;
    const int g = x.g[e];
    const int c = x.node[e] < 0 ? 0 : x.node[e];
    if (n == c) delta_node_rows(rows, e, g, c, w);
    if (!dense_rows) continue;
    for (int t = 0; t < x.tc; ++t) {
      const size_t gt = static_cast<size_t>(g) * x.tc + t;
      const int term = x.g_terms[gt];
      if (term < 0) continue;
      const int* dom = x.node_dom + static_cast<size_t>(x.term_topo[term]) * N;
      const int dc = dom[c];
      if (dc < 0 || dom[n] != dc) continue;
      const int dr = x.t_dense_of[term];
      if (dr >= 0) {
        int& cm = x.cm_dense[static_cast<size_t>(dr) * N + n];
        cm = cm + static_cast<int>((x.s_match[gt] ? 1.0f : 0.0f) * w);
      }
      const int ip = x.ip_of[term];
      if (ip < 0) continue;
      const int ir = x.ip_dense_of[ip];
      if (ir < 0) continue;
      const size_t ipn = static_cast<size_t>(ir) * N + n;
      x.oa_dense[ipn] = x.oa_dense[ipn] + static_cast<int>((x.a_anti_req[gt] ? 1.0f : 0.0f) * w);
      x.of_dense[ipn] = x.of_dense[ipn] + static_cast<int>((x.a_aff_req[gt] ? 1.0f : 0.0f) * w);
      x.wa_dense[ipn] = x.wa_dense[ipn] + static_cast<int>(x.w_aff_pref[gt] * w);
      x.wn_dense[ipn] = x.wn_dense[ipn] + static_cast<int>(x.w_anti_pref[gt] * w);
    }
  }
}

extern "C" int simtpu_compact_delta(const CompactCtx* ctx, void* stream) {
  const int threads = 256;
  const int node_blocks = (ctx->n + threads - 1) / threads;
  const long long slots = static_cast<long long>(ctx->e) * ctx->tc;
  const int entry_blocks = static_cast<int>((slots + threads - 1) / threads);
  compact_delta_kernel<<<node_blocks + entry_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      *ctx, node_blocks);
  return launch_status();
}
