// K7 delta_apply: signed placement-log entries folded into the state.
//
// Replaces the JAX package's simtpu/engine/state.py placement_delta_step
// (:339), scanned by apply_placement_deltas (:405): each entry (group,
// node, w, request, LVM allocation, devices taken, GPU memory per device)
// is the commit step's state update with weight w — +1 re-places, -1
// evicts, 0 is padding and changes nothing. One launch applies a whole
// eviction (or its undo).
//
// The entries must be applied in order: f32 adds onto the same node row
// do not commute bit for bit (requests are large integers in f32). So the
// kernel is parallel over columns, not entries: thread n owns node n's
// column of every plane — its rows of free, ports_used, vols_any, vols_rw,
// vg_free, sdev_free and gpu_free, and its entry of every [T,N] count and
// own-plane row — and walks the entries in order. The [T] cnt_total is
// owned by thread 0 of one extra block, which walks the entries in order
// too. Each plane element has one writer: no atomics. The chosen node's
// rows take delta_rows.cuh's update (shared with K13 compact_delta).
// sdev_free is boolean: w > 0 clears the taken devices, w < 0 sets them.
//
// Bound: bytes — each entry's rows and the touched plane columns are read
// and written once; a preemption wave applies a few hundred entries, so
// one launch's latency dominates.
#include "delta_rows.cuh"
#include "step_ctx.cuh"

__global__ void delta_apply_kernel(DeltaCtx x) {
  const int N = x.n;
  const bool totals_block = blockIdx.x == gridDim.x - 1;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (totals_block) {
    if (threadIdx.x != 0 || x.tc == 0) return;
    for (int e = 0; e < x.e; ++e) {
      const float w = x.wgt[e];
      if (w == 0.0f) continue;
      const int g = x.g[e];
      const int c = x.node[e] < 0 ? 0 : x.node[e];
      for (int t = 0; t < x.tc; ++t) {
        const int term = x.g_terms[static_cast<size_t>(g) * x.tc + t];
        if (term < 0) continue;
        if (x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + c] < 0) continue;
        const float s = x.s_match[static_cast<size_t>(g) * x.tc + t] ? 1.0f : 0.0f;
        x.cnt_total[term] = x.cnt_total[term] + s * w;
      }
    }
    return;
  }
  if (n >= N) return;
  const DeltaRows<float> rows{x.r, x.p_ports, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp,
                              x.ports_req, x.vol_rw_req, x.vol_ro_req, x.vol_att_req, x.free,
                              x.ports_used, x.vols_any, x.vols_rw, x.vg_free, x.sdev_free,
                              x.gpu_free};
  for (int e = 0; e < x.e; ++e) {
    const float w = x.wgt[e];
    if (w == 0.0f) continue;
    const int g = x.g[e];
    const int c = x.node[e] < 0 ? 0 : x.node[e];
    if (n == c) delta_node_rows(rows, e, g, c, w);
    // same-domain counts: node n gains the entry's incidence on each of
    // the group's terms whose domain it shares with the entry's node
    for (int t = 0; t < x.tc; ++t) {
      const size_t gt = static_cast<size_t>(g) * x.tc + t;
      const int term = x.g_terms[gt];
      if (term < 0) continue;
      const int* dom = x.node_dom + static_cast<size_t>(x.term_topo[term]) * N;
      const int dc = dom[c];
      if (dc < 0 || dom[n] != dc) continue;
      float& cm = x.cnt_match[static_cast<size_t>(term) * N + n];
      cm = cm + (x.s_match[gt] ? 1.0f : 0.0f) * w;
      const int ip = x.ip_of[term];
      if (ip < 0) continue;
      const size_t ipn = static_cast<size_t>(ip) * N + n;
      x.cnt_own_anti[ipn] = x.cnt_own_anti[ipn] + (x.a_anti_req[gt] ? 1.0f : 0.0f) * w;
      x.cnt_own_aff[ipn] = x.cnt_own_aff[ipn] + (x.a_aff_req[gt] ? 1.0f : 0.0f) * w;
      x.w_own_aff_pref[ipn] = x.w_own_aff_pref[ipn] + x.w_aff_pref[gt] * w;
      x.w_own_anti_pref[ipn] = x.w_own_anti_pref[ipn] + x.w_anti_pref[gt] * w;
    }
  }
}

extern "C" int simtpu_delta_apply(const DeltaCtx* ctx, void* stream) {
  const int threads = 256;
  const int blocks = (ctx->n + threads - 1) / threads + 1;  // + the cnt_total block
  delta_apply_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
