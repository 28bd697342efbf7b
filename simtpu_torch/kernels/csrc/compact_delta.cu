// K13 compact_delta: signed placement-log entries folded straight into the
// compact carried state.
//
// Replaces the JAX package's simtpu/engine/state.py compact_delta_step
// (:1205), scanned by _apply_placement_deltas_compact_fn (:1300, jitted
// as apply_placement_deltas_compact :1312): K7's update (delta_apply.cu)
// retargeted at the compact layout, so preemption's evictions and
// restores need no expand -> K7 -> compress round trip. One call applies
// a whole packed batch (w = +1 re-places, -1 evicts, 0 is padding).
//
// What the reference scans in log order splits in two:
// - the chosen node's rows: delta_runs.cuh's grouping block and walk (the
//   design comment there), shared with K7 and instantiated here on the
//   compact rows (ports / vols counts in int32);
// - the count planes: int32 adds of state-independent integer values
//   (s_match, a_anti_req, a_aff_req, w_aff_pref, w_anti_pref times w,
//   truncated per entry as the reference casts them), exact and order-free.
//
// Design (launch plan kernels/cuda.py compact_delta_plan), two kernels a
// call: compact_delta_kernel's blocks 1.. ("pair blocks") take one thread
// per (entry, term slot), which resolves the slot's chain once — term, key
// row, the chosen node's domain and small bucket, the tabular and dense
// rows, the five values x w — and adds them with int32 atomics:
// cnt_total; a tabular row is constant within a domain, so its update is
// one bucket add at [row, small domain]; a dense row gains the value at
// every node of the chosen node's domain, read from the domain's node list
// (dom_start / dom_nodes, built once per node_dom map by the wrapper; a
// domain id names one key's value): one node for a per-node key, no walk
// over every node. Its block 0 is the grouping block, and
// compact_delta_walk_kernel the walk (delta_runs.cuh). Each carried
// element has one writer or exact integer adds.
//
// Bound: bytes — the entries, the touched rows, buckets and dense columns
// read and written once; a preemption wave applies a few hundred entries,
// so the launches' latency and the grouping block's passes dominate.
#include "delta_runs.cuh"
#include "step_ctx.cuh"

__device__ inline DeltaRows<int> delta_rows(const CompactCtx& x) {
  return {x.r, x.p, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp, x.ports_req, x.vol_rw_req, x.vol_ro_req,
          x.vol_att_req, x.c_free, x.c_ports_used, x.c_vols_any, x.c_vols_rw, x.c_vg_free, x.c_sdev_free,
          x.c_gpu_free};
}

// (entry e, slot t): the slot's term resolved once, its counts added
__device__ inline void delta_pair(const CompactCtx& x, int e, int t) {
  const float w = x.wgt[e];
  if (w == 0.0f) return;
  const int g = x.g[e];
  const int c = x.node[e] < 0 ? 0 : x.node[e];
  const size_t gt = static_cast<size_t>(g) * x.tc + t;
  const int term = x.g_terms[gt];
  if (term < 0) return;
  const size_t key_row = static_cast<size_t>(x.term_topo[term]) * x.n;
  const int dom = x.node_dom[key_row + c];
  if (dom < 0) return;
  const int s = static_cast<int>((x.s_match[gt] ? 1.0f : 0.0f) * w);
  atomicAdd(&x.c_cnt_total[term], s);
  const int ip = x.ip_of[term];
  int oa = 0, of = 0, wa = 0, wn = 0;
  if (ip >= 0) {
    oa = static_cast<int>((x.a_anti_req[gt] ? 1.0f : 0.0f) * w);
    of = static_cast<int>((x.a_aff_req[gt] ? 1.0f : 0.0f) * w);
    wa = static_cast<int>(x.w_aff_pref[gt] * w);
    wn = static_cast<int>(x.w_anti_pref[gt] * w);
  }
  // tabular rows: one bucket add at the chosen node's small domain
  const int bucket = x.nds[key_row + c];
  if (bucket >= 0) {
    const int tr = x.t_tab_of[term];
    if (tr >= 0) atomicAdd(&x.cm_tab[static_cast<size_t>(tr) * x.d + bucket], s);
    const int ir = ip >= 0 ? x.ip_tab_of[ip] : -1;
    if (ir >= 0) {
      const size_t b = static_cast<size_t>(ir) * x.d + bucket;
      atomicAdd(&x.oa_tab[b], oa);
      atomicAdd(&x.of_tab[b], of);
      atomicAdd(&x.wa_tab[b], wa);
      atomicAdd(&x.wn_tab[b], wn);
    }
  }
  // dense rows: every node of the chosen node's domain
  const int dr = x.t_dense_of[term];
  const int dir = ip >= 0 ? x.ip_dense_of[ip] : -1;
  if (dr < 0 && dir < 0) return;
  const int end = x.dom_start[dom + 1];
  for (int j = x.dom_start[dom]; j < end; ++j) {
    const size_t m = static_cast<size_t>(x.dom_nodes[j]);
    if (dr >= 0) atomicAdd(&x.cm_dense[static_cast<size_t>(dr) * x.n + m], s);
    if (dir >= 0) {
      const size_t b = static_cast<size_t>(dir) * x.n + m;
      atomicAdd(&x.oa_dense[b], oa);
      atomicAdd(&x.of_dense[b], of);
      atomicAdd(&x.wa_dense[b], wa);
      atomicAdd(&x.wn_dense[b], wn);
    }
  }
}

__global__ void __launch_bounds__(DELTA_MAX_THREADS) compact_delta_kernel(CompactCtx x, DeltaPlan p) {
  extern __shared__ __align__(16) int dsm[];
  if (blockIdx.x > 0) {
    const long long j = static_cast<long long>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
    if (j < static_cast<long long>(x.e) * x.tc) delta_pair(x, static_cast<int>(j / x.tc), static_cast<int>(j % x.tc));
    return;
  }
  delta_group_block(x, p, dsm);
}

// One thread per (element, run): delta_runs.cuh's walk on the compact rows
__global__ void __launch_bounds__(DELTA_WALK_THREADS) compact_delta_walk_kernel(CompactCtx x, DeltaPlan p) {
  delta_walk(delta_rows(x), p, x.e, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
}

// K13 on the wrapper's plan: the grouping and pair kernel, then the walk;
// refused where delta_plan_ok refuses the plan, it asks for preference
// blocks (K7's alone) or there are pairs but no domain lists
extern "C" int simtpu_compact_delta(const CompactCtx* ctx, const DeltaPlan* plan, void* stream) {
  const DeltaPlan& q = *plan;
  const CompactCtx& x = *ctx;
  const long long pairs = static_cast<long long>(x.e) * x.tc;
  const long long walkers = static_cast<long long>(x.e) * (x.r + x.p + 2 * x.w + x.v + x.sd + x.gd);
  if (!delta_plan_ok(q, x.n, x.e, pairs, walkers, 0) || (pairs > 0 && x.dom_start == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return delta_launch(compact_delta_kernel, compact_delta_walk_kernel, x, q, static_cast<cudaStream_t>(stream));
}
