// K18 sweep_drain: the drain of every scenario of a fault-sweep chunk, one
// block per scenario.
//
// Replaces the per-scenario delta scan inside the JAX package's
// simtpu/faults/sweep.py _fault_sweep (:68-70) — lax.scan of
// simtpu/engine/state.py placement_delta_step (:339) under jax.vmap —
// together with the broadcast of the shared base carry into the vmapped
// replicas. With no entries it is the broadcast alone, which the batched
// capacity sweep (simtpu/parallel/sweep.py _sweep_scan :49) needs.
//
// Design: the scenario axis is the grid, as it is the vmap axis in JAX.
// Block s
//   1. copies every plane of the base carry (read only) into replica s;
//   2. applies its scenario's entries (SweepCtx.idx row s: rows of the
//      whole placement log, packed once; -1 = padding, which only trails)
//      in log order, exactly as K7 delta_apply does for one state: thread
//      n owns node n's column of every plane and walks the entries in
//      order, the chosen node's rows through delta_rows.cuh (shared with
//      K7 and K13), and the block's last thread owns replica s's
//      cnt_total. A w = 0 entry is skipped (in JAX its device mask is
//      zeroed, so it is an exact no-op there too).
// Each plane element has one writer: no atomics, and the f32 adds onto a
// node row happen in log order, bit for bit JAX's sequential scan.
//
// Bound: bytes — S replicas of the dense carry written once and the base
// read S times; the entries' few rows are noise beside them.
#include "delta_rows.cuh"
#include "step_ctx.cuh"

constexpr int DRAIN_THREADS = 512;

template <typename T>
__device__ inline void copy_plane(T* dst, const T* src, size_t count) {
  for (size_t q = threadIdx.x; q < count; q += blockDim.x) dst[q] = src[q];
}

__global__ void __launch_bounds__(DRAIN_THREADS) sweep_drain_kernel(DeltaCtx x, SweepCtx w) {
  const int s = blockIdx.x;
  const int N = x.n;
  const size_t sn = static_cast<size_t>(s) * N;
  const size_t t_n = static_cast<size_t>(w.t) * N;
  const size_t ti_n = static_cast<size_t>(w.ti) * N;
  // replica s of every plane
  float* free = x.free + sn * x.r;
  float* cnt_match = x.cnt_match + static_cast<size_t>(s) * t_n;
  float* cnt_total = x.cnt_total + static_cast<size_t>(s) * w.t;
  float* own_anti = x.cnt_own_anti + static_cast<size_t>(s) * ti_n;
  float* own_aff = x.cnt_own_aff + static_cast<size_t>(s) * ti_n;
  float* aff_pref = x.w_own_aff_pref + static_cast<size_t>(s) * ti_n;
  float* anti_pref = x.w_own_anti_pref + static_cast<size_t>(s) * ti_n;
  float* vg_free = x.vg_free + sn * x.v;
  uint8_t* sdev_free = x.sdev_free + sn * x.sd;
  float* gpu_free = x.gpu_free + sn * x.gd;
  float* ports_used = x.ports_used + sn * x.p_ports;
  float* vols_any = x.vols_any + sn * x.w;
  float* vols_rw = x.vols_rw + sn * x.w;

  // 1. the broadcast of the base carry
  copy_plane(free, w.free, static_cast<size_t>(N) * x.r);
  copy_plane(cnt_match, w.cnt_match, t_n);
  copy_plane(cnt_total, w.cnt_total, static_cast<size_t>(w.t));
  copy_plane(own_anti, w.cnt_own_anti, ti_n);
  copy_plane(own_aff, w.cnt_own_aff, ti_n);
  copy_plane(aff_pref, w.w_own_aff_pref, ti_n);
  copy_plane(anti_pref, w.w_own_anti_pref, ti_n);
  copy_plane(vg_free, w.vg_free, static_cast<size_t>(N) * x.v);
  copy_plane(sdev_free, w.sdev_free, static_cast<size_t>(N) * x.sd);
  copy_plane(gpu_free, w.gpu_free, static_cast<size_t>(N) * x.gd);
  copy_plane(ports_used, w.ports_used, static_cast<size_t>(N) * x.p_ports);
  copy_plane(vols_any, w.vols_any, static_cast<size_t>(N) * x.w);
  copy_plane(vols_rw, w.vols_rw, static_cast<size_t>(N) * x.w);
  __syncthreads();

  // 2. the scenario's entries, in log order
  const int* idx = w.idx + static_cast<size_t>(s) * w.cols;
  const DeltaRows<float> rows{x.r, x.p_ports, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp,
                              x.ports_req, x.vol_rw_req, x.vol_ro_req, x.vol_att_req, free,
                              ports_used, vols_any, vols_rw, vg_free, sdev_free, gpu_free};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    for (int k = 0; k < w.cols; ++k) {
      const int e = idx[k];
      if (e < 0) break;
      const float wt = x.wgt[e];
      if (wt == 0.0f) continue;
      const int g = x.g[e];
      const int c = x.node[e] < 0 ? 0 : x.node[e];
      if (n == c) delta_node_rows(rows, e, g, c, wt);
      // same-domain counts: node n gains the entry's incidence on each of
      // the group's terms whose domain it shares with the entry's node
      for (int t = 0; t < x.tc; ++t) {
        const size_t gt = static_cast<size_t>(g) * x.tc + t;
        const int term = x.g_terms[gt];
        if (term < 0) continue;
        const int* dom = x.node_dom + static_cast<size_t>(x.term_topo[term]) * N;
        const int dc = dom[c];
        if (dc < 0 || dom[n] != dc) continue;
        float& cm = cnt_match[static_cast<size_t>(term) * N + n];
        cm = cm + (x.s_match[gt] ? 1.0f : 0.0f) * wt;
        const int ip = x.ip_of[term];
        if (ip < 0) continue;
        const size_t ipn = static_cast<size_t>(ip) * N + n;
        own_anti[ipn] = own_anti[ipn] + (x.a_anti_req[gt] ? 1.0f : 0.0f) * wt;
        own_aff[ipn] = own_aff[ipn] + (x.a_aff_req[gt] ? 1.0f : 0.0f) * wt;
        aff_pref[ipn] = aff_pref[ipn] + x.w_aff_pref[gt] * wt;
        anti_pref[ipn] = anti_pref[ipn] + x.w_anti_pref[gt] * wt;
      }
    }
  }
  // replica s's cnt_total: one thread walks the entries in order
  if (threadIdx.x != blockDim.x - 1 || x.tc == 0) return;
  for (int k = 0; k < w.cols; ++k) {
    const int e = idx[k];
    if (e < 0) break;
    const float wt = x.wgt[e];
    if (wt == 0.0f) continue;
    const int g = x.g[e];
    const int c = x.node[e] < 0 ? 0 : x.node[e];
    for (int t = 0; t < x.tc; ++t) {
      const int term = x.g_terms[static_cast<size_t>(g) * x.tc + t];
      if (term < 0) continue;
      if (x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + c] < 0) continue;
      const float sm = x.s_match[static_cast<size_t>(g) * x.tc + t] ? 1.0f : 0.0f;
      cnt_total[term] = cnt_total[term] + sm * wt;
    }
  }
}

extern "C" int simtpu_sweep_drain(const DeltaCtx* ctx, const SweepCtx* w, void* stream) {
  if (w->s == 0) return 0;
  sweep_drain_kernel<<<w->s, DRAIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, *w);
  return launch_status();
}
