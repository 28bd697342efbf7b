// K4 commit_pod: the state update of one placed pod, IN PLACE.
//
// Replaces the update block of the JAX package's simtpu/engine/scan.py
// schedule_step (scan.py:1059-1131) and the row scatter add_rows
// (simtpu/engine/state.py:62) it runs through. Reads chosen/placed from
// device memory (K3 wrote them); a pod that was not placed changes
// nothing. The chosen node's free row takes the request, its port and
// volume planes the group's ports and exclusive volumes, its vg_free,
// sdev_free and gpu_free the pod's LVM allocation, exclusive devices and
// GPU shares x per-GPU memory (K5/K6's plans; none for a pod that skipped
// them), which also go to the pod's output rows; cnt_total gains the
// pod's incidence on each term whose key the chosen node carries; every
// node adds the group's incidence into its cnt_match and own-plane
// entries for each term whose domain it shares with the chosen node.
//
// Design: ceil(N / COMMIT_THREADS) node blocks, one thread a node, and one
// block more for the chosen node. The group comes from the host, so the
// group's first COMMIT_COLS rows of the term columns' table (StepCtx
// g_cols: term, key row, interpod row, flags, weights) are loaded by the
// first lanes together with placed and chosen; an unplaced pod returns
// there. The node blocks walk the columns COMMIT_COLS at a time: the
// lanes stage them in shared memory; after one barrier they take the
// chosen node's domain of each column while every thread loads its
// node's domains, counts and own-plane entries of the same columns (their
// rows come from the table: no load waits on chosen); after a second
// barrier each thread writes the entries of the columns whose domain its
// node shares with the chosen node. In the last block each warp takes one
// family of the chosen node's rows over its lanes (node_stages.cuh
// commit_chosen_rows), and one thread adds the cnt_total increments in
// K4's term order. g_terms[g]
// lists distinct terms with distinct interpod rows (engine/scan.py
// _compact_terms, engine/state.py interpod_term_index), so each (row,
// node) entry has one writer: no atomics, no order dependence.
//
// Bound: bytes — the group's Tc domain rows are read and the touched
// count/own-plane rows read and written once; at the main paths' sizes a
// launch is two dependent rounds of loads (the table, then the node rows)
// and two barriers.
#include "node_stages.cuh"

constexpr int COMMIT_THREADS = 256;
// columns staged at a time, and the table words staged of each (COL_TERM
// ... COL_W_ANTI)
constexpr int COMMIT_COLS = 8;
constexpr int COMMIT_WORDS = COL_W_ANTI + 1;

__global__ void __launch_bounds__(COMMIT_THREADS) commit_pod_kernel(StepCtx x, int i, int g) {
  __shared__ int s_w[COMMIT_WORDS][COMMIT_COLS];
  __shared__ int s_dc[COMMIT_COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = x.n, TC = x.tc, f = x.flags;
  const bool terms = (f & F_TOPOLOGY) && TC > 0;
  const int* tab = x.g_cols + static_cast<size_t>(g) * TOPO_COL_WORDS * TC;
  const bool chosen_block = blockIdx.x == gridDim.x - 1;
  // the first columns' words in the same round as placed and chosen: a
  // node block's lanes one column each, the cnt_total thread all of them
  const int cnt0 = terms ? min(COMMIT_COLS, TC) : 0;
  const bool totals = chosen_block && warp == COMMIT_PARTS && lane == 0 && terms;
  int wv[COMMIT_WORDS];
  if (!chosen_block && tid < cnt0)
#pragma unroll
    for (int k = 0; k < COMMIT_WORDS; ++k) wv[k] = tab[k * TC + tid];
  int tt[COMMIT_COLS], tk[COMMIT_COLS], tf[COMMIT_COLS];
  if (totals)
#pragma unroll
    for (int u = 0; u < COMMIT_COLS; ++u) {
      tt[u] = u < cnt0 ? tab[COL_TERM * TC + u] : -1;
      tk[u] = u < cnt0 ? tab[COL_KEY * TC + u] : -1;
      tf[u] = u < cnt0 ? tab[COL_FLAGS * TC + u] : 0;
    }
  const bool placed = x.placed[i];
  const int c = x.chosen[i];
  if (!placed) return;

  if (chosen_block) {
    // the chosen node's rows, a family a warp, and cnt_total in K4's order
    if (warp < COMMIT_PARTS) {
      commit_chosen_rows(x, i, c, g, warp, lane, 32);
    } else if (totals) {
      for (int t0 = 0; t0 < TC; t0 += COMMIT_COLS) {
        const int cnt = min(COMMIT_COLS, TC - t0);
        if (t0 > 0)
#pragma unroll
          for (int u = 0; u < COMMIT_COLS; ++u) {
            tt[u] = u < cnt ? tab[COL_TERM * TC + t0 + u] : -1;
            tk[u] = u < cnt ? tab[COL_KEY * TC + t0 + u] : -1;
            tf[u] = u < cnt ? tab[COL_FLAGS * TC + t0 + u] : 0;
          }
        // the chosen node's domains beside the totals, then the writes
        int dc[COMMIT_COLS];
        float tot[COMMIT_COLS];
#pragma unroll
        for (int u = 0; u < COMMIT_COLS; ++u) {
          dc[u] = tt[u] >= 0 ? x.node_dom[static_cast<size_t>(tk[u]) * N + c] : -1;
          tot[u] = tt[u] >= 0 ? x.cnt_total[tt[u]] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < COMMIT_COLS; ++u)
          if (dc[u] >= 0) x.cnt_total[tt[u]] = tot[u] + ((tf[u] & TOPO_SMATCH) ? 1.0f : 0.0f);
      }
    }
    return;
  }
  if (!terms) return;
  const int n = blockIdx.x * COMMIT_THREADS + tid;
  const bool live = n < N;
  for (int t0 = 0; t0 < TC; t0 += COMMIT_COLS) {
    const int cnt = min(COMMIT_COLS, TC - t0);
    if (tid < cnt) {
      if (t0 > 0)
#pragma unroll
        for (int k = 0; k < COMMIT_WORDS; ++k) wv[k] = tab[k * TC + t0 + tid];
#pragma unroll
      for (int k = 0; k < COMMIT_WORDS; ++k) s_w[k][tid] = wv[k];
    }
    __syncthreads();
    // the chosen node's domains (the first lanes); beside them each node's
    // domains and its count and own-plane entries of the same columns (their
    // rows are known from the table: no load waits on chosen)
    if (tid < cnt) {
      const int key = s_w[COL_KEY][tid];
      s_dc[tid] = s_w[COL_TERM][tid] >= 0 ? x.node_dom[static_cast<size_t>(key) * N + c] : -1;
    }
    int dn[COMMIT_COLS];
    float cm[COMMIT_COLS], oa[COMMIT_COLS], of[COMMIT_COLS], wa[COMMIT_COLS], wn[COMMIT_COLS];
#pragma unroll
    for (int u = 0; u < COMMIT_COLS; ++u) {
      dn[u] = -1;
      cm[u] = oa[u] = of[u] = wa[u] = wn[u] = 0.0f;
      const int term = u < cnt ? s_w[COL_TERM][u] : -1;
      if (!live || term < 0) continue;
      dn[u] = x.node_dom[static_cast<size_t>(s_w[COL_KEY][u]) * N + n];
      cm[u] = x.cnt_match[static_cast<size_t>(term) * N + n];
      const int ip = s_w[COL_IP][u];
      if (ip < 0) continue;
      const size_t ipn = static_cast<size_t>(ip) * N + n;
      if (f & F_INTERPOD_REQ) {
        oa[u] = x.cnt_own_anti[ipn];
        of[u] = x.cnt_own_aff[ipn];
      }
      if (f & F_INTERPOD_PREF) {
        wa[u] = x.w_own_aff_pref[ipn];
        wn[u] = x.w_own_anti_pref[ipn];
      }
    }
    __syncthreads();
    // the entries of the columns whose domain the node shares with the
    // chosen node, written
#pragma unroll
    for (int u = 0; u < COMMIT_COLS; ++u) {
      const int dc = u < cnt ? s_dc[u] : -1;
      if (!(dc >= 0 && dn[u] == dc)) continue;
      const int fl = s_w[COL_FLAGS][u];
      x.cnt_match[static_cast<size_t>(s_w[COL_TERM][u]) * N + n] = cm[u] + ((fl & TOPO_SMATCH) ? 1.0f : 0.0f);
      const int ip = s_w[COL_IP][u];
      if (ip < 0) continue;
      const size_t ipn = static_cast<size_t>(ip) * N + n;
      if (f & F_INTERPOD_REQ) {
        x.cnt_own_anti[ipn] = oa[u] + ((fl & TOPO_ANTI) ? 1.0f : 0.0f);
        x.cnt_own_aff[ipn] = of[u] + ((fl & TOPO_AFF) ? 1.0f : 0.0f);
      }
      if (f & F_INTERPOD_PREF) {
        x.w_own_aff_pref[ipn] = wa[u] + __int_as_float(s_w[COL_W_AFF][u]);
        x.w_own_anti_pref[ipn] = wn[u] + __int_as_float(s_w[COL_W_ANTI][u]);
      }
    }
    if (t0 + COMMIT_COLS < TC) __syncthreads();  // before the next columns are staged
  }
}

// K4 for pod i of group g (the wrapper's host copy of the pod's group)
extern "C" int simtpu_commit_pod(const StepCtx* ctx, int i, int g, void* stream) {
  const int blocks = (ctx->n + COMMIT_THREADS - 1) / COMMIT_THREADS + 1;
  commit_pod_kernel<<<blocks, COMMIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i, g);
  return launch_status();
}
