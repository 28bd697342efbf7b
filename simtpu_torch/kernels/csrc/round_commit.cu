// K16 round_commit: the batched state update of one bulk round, IN PLACE,
// and the expansion of the per-node intake into per-slot placements.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core :565-748
// (with _unsort_take :149), and the chunk's row gather / scatter of
// rounds_scan_sliced :809 and scan.py _gather_rows_tuple :1197 /
// _scatter_rows :1205: the port carries full planes, so the group's term
// rows are addressed directly. One thread-block cluster (rounds.cuh
// `RoundPlan`, cuda.round_plan), block b owning a node tile:
//   phase 0: the group's term columns (term, key, route, own-plane row and
//            coefficients) staged in shared memory; where a column routes
//            to the [Tc, n_dom] fallback domain sums, those zeroed by every
//            block and one cluster barrier;
//   phase 1: per block, the per-domain totals of m_n over the group's term
//            rows, routed by key_kind as :576-614 do — a small key (<= 64
//            domains) sums into DOM_SMALL bins of the block's shared
//            memory through node_dom_small, a key unique per node is its
//            own sum, any other key sums into the fallback rows by global
//            atomics — every term's dot valid @ m_n (warp sums, then shared
//            atomics), and the tile's inclusive prefix of m_n (in shared
//            memory, tile-relative) and its total. One cluster barrier,
//            then each block adds every block's small-key bins, dots and
//            tile totals into its own, and one thread of block 0 adds the
//            dots into cnt_total, term by term. The sums add
//            integer-valued f32 below 2^24: exact in any order, so neither
//            the atomics' order nor the tiling can move a bit;
//   phase 2: per node: free -= m_n * req (one FMA, as the compiled round
//            contracts it), ports and volumes by min(m_n, 1), the count
//            rows and own planes by the domain totals, then vg_free /
//            sdev_free / gpu_free by the pods per container (_unsort_take
//            over K14's visit order; on a matrix round the multi-claim
//            plan, the multi-GPU share pool or the preset row);
//   phase 3: per slot j < k_cap: the node by a search over the prefix
//            (side="right") — each block expands the slots of its own
//            tile's nodes, [tile offset, tile offset + tile total), by a
//            search over its shared prefix; the slots past the total are
//            spread over the cluster — the slot's ordinal on its node, the
//            container picks, and on a matrix round the slot's LVM bytes
//            and GPU shares.
// Phase 3 reads only K14's rows and the prefix, never what phase 2 writes,
// so the two need no barrier between them; the last cluster barrier is
// split (arrive after the block's last remote read, wait before it exits).
//
// Where the group has many term columns (past cuda.round_plan's shared
// budget, from Tc = 512), each block's words before the prefix — the
// published bins, dots and tile total, their fold, the ranks' totals and
// the staged columns — move to the block's own row of a global scratch
// (RoundPlan.pub, the wrapper's torch.empty): the peers read a row with
// ld.global.cg after the cluster barrier, whose release / acquire at
// cluster scope orders global memory as it does shared. The sums stay
// integer-valued f32, so the fold is exact in either mode.
//
// Bound: bytes — each touched state row read and written once, the
// group's Tc domain rows read once, k_cap slots written (about 0.9 MB at
// the bulk problem's N = 5000: 0.27 µs at 3.35 TB/s). One block moves that
// at one SM's share of the device's rate and runs a block reduction per
// term column; the cluster spreads the nodes over up to 16 SMs for two
// barriers.
//
// The profile build (-DSIMTPU_ROUND_PROFILE) adds thread 0 of block 0's
// clock64() cycles per phase (COMMIT_PROF_PHASES) into
// `round_commit_prof`.
#include "rounds.cuh"

// profile slots, one per phase
enum : int { CP_ZERO = 0, CP_SUMS, CP_FOLD, CP_UPDATE, CP_SLOTS, CP_END, COMMIT_PROF_PHASES };

#ifdef SIMTPU_ROUND_PROFILE
__device__ unsigned long long round_commit_prof[ROUND_PROF_SLOTS];
#define COMMIT_FLUSH(c) (c).flush(round_commit_prof)
#else
#define COMMIT_FLUSH(c) ((void)0)
#endif

// The block's shared words: what it publishes to the cluster (the small
// bins [Tc, DOM_SMALL], the dots [Tc], the tile total), the same folded
// over the cluster, the ranks' tile totals, the group's term columns (term,
// key, route, own-plane row, and the s_match / required anti / required
// affinity / preferred weights, COMMIT_TERM_WORDS a column) and the tile's
// prefix of m_n (cuda.round_plan's shared_bytes)
constexpr int COMMIT_TERM_WORDS = 9;
// term columns whose domain totals a thread loads before it updates their
// rows (phase 2)
constexpr int COMMIT_TERM_BATCH = 8;
__host__ __device__ inline int commit_pub_words(int tc) { return tc * (DOM_SMALL + 1) + 1; }
__host__ __device__ inline int commit_smem_words(int tc, int tile) {
  return 2 * commit_pub_words(tc) + ROUND_CLUSTER_MAX + COMMIT_TERM_WORDS * tc + tile;
}
// the plan's global mode: the block's words before the tile's prefix in
// its own row of RoundPlan.pub (rows 16-byte aligned), the prefix alone in
// shared memory
__host__ __device__ inline int commit_row_words(int tc) { return (commit_smem_words(tc, 0) + 3) & ~3; }

// GPUB: the plan's global mode (RoundPlan.pub set); a build for each, so
// that shared mode's words stay shared-typed (a pointer to either space is
// generic, and generic atomics on shared memory are slower)
template <bool GPUB>
__global__ void __launch_bounds__(ROUND_CLUSTER_THREADS, 1) round_commit_kernel(StepCtx x, RoundCtx r, RoundPlan plan) {
  extern __shared__ float smem[];
  __shared__ BlockScratch sh;
  PhaseClock clk;
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int B = plan.blocks, rank = blockIdx.x;
  const int lo_n = rank * plan.tile;
  const int hi_n = min(N, lo_n + plan.tile);
  const int len = hi_n - lo_n;
  const RoundPod p = round_pod(x, r.i);
  const int g = p.g;
  const float* req = p.req;
  const int f = x.flags;
  const bool mats = r.mode & RV_MATS;
  const int tc = (uses_topology(f) && x.tc > 0) ? x.tc : 0;
  const int* terms = x.g_terms + static_cast<size_t>(g) * x.tc;
  const size_t g0 = static_cast<size_t>(g) * x.tc;
  const int V = x.v, SD = x.sd, GD = x.gd;
  const int pub = commit_pub_words(tc);
  // the block's words: shared memory, or its row of the global scratch
  // where a plan's term columns pass the shared budget (the peers then
  // read them from global memory, after the same cluster barrier)
  constexpr bool gmode = GPUB;
  float* words = gmode ? plan.pub + static_cast<size_t>(rank) * commit_row_words(x.tc) : smem;
  float* small = words;                      // [tc, DOM_SMALL] this block's bins
  float* dots = small + tc * DOM_SMALL;      // [tc]
  float* tile_total = dots + tc;             // [1]
  float* small_all = words + pub;            // the cluster's bins and dots, folded
  float* dots_all = small_all + tc * DOM_SMALL;
  float* tot = words + 2 * pub;              // [ROUND_CLUSTER_MAX] every rank's tile total
  int* c_term = reinterpret_cast<int*>(tot + ROUND_CLUSTER_MAX);  // [tc] -1 on a pad column
  int* c_key = c_term + tc;
  int* c_kind = c_key + tc;                  // key_kind, -1 on a pad column
  int* c_ip = c_kind + tc;
  float* c_sm = reinterpret_cast<float*>(c_ip + tc);
  float* c_anti = c_sm + tc;
  float* c_aff = c_anti + tc;
  float* c_waff = c_aff + tc;
  float* c_wanti = c_waff + tc;
  float* rel = gmode ? smem : c_wanti + tc;  // [tile] the tile's inclusive prefix of m_n

  // phase 0: the shared words zeroed, the term columns staged; the tile's
  // inclusive prefix (thread t owning a contiguous chunk) and its total;
  // where a column routes to the [Tc, n_dom] fallback domain sums, those
  // zeroed by every block and one cluster barrier
  for (int q = tid; q < 2 * pub; q += nt) words[q] = 0.0f;
  const int per = (len + nt - 1) / nt;
  const int c0 = tid * per, c1 = min(len, c0 + per);
  float run = 0.0f;
  for (int q = c0; q < c1; ++q) {
    run += r.m_n[lo_n + q];
    rel[q] = run;
  }
  for (int t = tid; t < tc; t += nt) {
    const int term = terms[t];
    const int key = term >= 0 ? x.term_topo[term] : -1;
    c_term[t] = term;
    c_key[t] = key;
    c_kind[t] = term >= 0 ? r.key_kind[key] : -1;
    c_ip[t] = term >= 0 ? x.ip_of[term] : -1;
    c_sm[t] = x.s_match[g0 + t] ? 1.0f : 0.0f;
    c_anti[t] = x.a_anti_req[g0 + t] ? 1.0f : 0.0f;
    c_aff[t] = x.a_aff_req[g0 + t] ? 1.0f : 0.0f;
    c_waff[t] = x.w_aff_pref[g0 + t];
    c_wanti[t] = x.w_anti_pref[g0 + t];
  }
  {
    // (its barriers also publish the staged columns to the block)
    const float before = block_exclusive(run, [](float a, float b) { return a + b; }, 0.0f, sh);
    for (int q = c0; q < c1; ++q) rel[q] = before + rel[q];
    if (c1 == len && c0 < c1) *tile_total = before + run;
  }
  bool any_fall = false;
  for (int t = 0; t < tc; ++t) any_fall = any_fall || (c_term[t] >= 0 && c_kind[t] != 1 && c_kind[t] != 2);
  if (any_fall) {
    const size_t n_fall = static_cast<size_t>(tc) * r.n_dom;
    for (size_t q = static_cast<size_t>(rank) * nt + tid; q < n_fall; q += static_cast<size_t>(B) * nt)
      r.dom_sums[q] = 0.0f;
    cluster_barrier();
  }
  clk.stamp(CP_ZERO);

  // phase 1: the tile's domain sums and dots
  for (int t = 0; t < tc; ++t) {
    if (c_term[t] < 0) continue;
    const int kind = c_kind[t];
    const int* dom = x.node_dom + static_cast<size_t>(c_key[t]) * N;
    const int* dsm = r.node_dom_small + static_cast<size_t>(c_key[t]) * N;
    float* fall = r.dom_sums + static_cast<size_t>(t) * r.n_dom;
    float dot = 0.0f;
    for (int n = lo_n + tid; n < hi_n; n += nt) {
      const int d = dom[n];
      if (d < 0) continue;
      const float m = r.m_n[n];
      dot += m;
      if (kind == 1) {
        const int ds = dsm[n];
        if (ds >= 0) atomicAdd(&small[t * DOM_SMALL + ds], m);
      } else if (kind != 2) {
        atomicAdd(&fall[d], m);
      }
    }
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) atomicAdd(&dots[t], dot);
  }
  clk.stamp(CP_SUMS);
  cluster_barrier();

  // the cluster's small-key bins, dots and tile totals: one word a thread
  // (the bins of the columns on a small key, then every dot and the
  // total), every rank's copy loaded at once and added in rank order
  // (integer-valued: exact in any order)
  for (int q = tid; q < pub; q += nt) {
    if (q < tc * DOM_SMALL && !(c_term[q / DOM_SMALL] >= 0 && c_kind[q / DOM_SMALL] == 1)) continue;
    float v[ROUND_CLUSTER_MAX];
#pragma unroll
    for (int b = 0; b < ROUND_CLUSTER_MAX; ++b)
      v[b] = b >= B ? 0.0f
             : gmode ? __ldcg(plan.pub + static_cast<size_t>(b) * commit_row_words(x.tc) + q)
                     : *cluster_peer(&words[q], b);
    if (q == pub - 1) {
#pragma unroll
      for (int b = 0; b < ROUND_CLUSTER_MAX; ++b)
        if (b < B) tot[b] = v[b];
    } else {
      float s = v[0];
#pragma unroll
      for (int b = 1; b < ROUND_CLUSTER_MAX; ++b)
        if (b < B) s += v[b];
      small_all[q] = s;
    }
  }
  __syncthreads();
  cluster_arrive();  // the block's last remote read is done
  if (rank == 0 && tid == 0) {
    for (int t = 0; t < tc; ++t) {
      const int term = c_term[t];
      if (term >= 0 && c_sm[t] != 0.0f) x.cnt_total[term] = x.cnt_total[term] + dots_all[t];
    }
  }
  clk.stamp(CP_FOLD);

  // phase 2: the per-node state update
  for (int n = lo_n + tid; n < hi_n; n += nt) {
    const float m = r.m_n[n];
    float* fr = x.free + static_cast<size_t>(n) * x.r;
    for (int q = 0; q < x.r; ++q) fr[q] = __fmaf_rn(-m, req[q], fr[q]);
    const float one = jmin(m, 1.0f);
    if (f & F_PORTS) {
      const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
      float* used = x.ports_used + static_cast<size_t>(n) * x.p_ports;
      for (int q = 0; q < x.p_ports; ++q) used[q] = used[q] + one * (want[q] ? 1.0f : 0.0f);
    }
    if (f & (F_VOLS | F_ATTACH)) {
      const size_t gw = static_cast<size_t>(g) * x.w, nw = static_cast<size_t>(n) * x.w;
      for (int q = 0; q < x.w; ++q) {
        const bool rw = x.vol_rw_req[gw + q];
        const bool present = rw || x.vol_ro_req[gw + q] || x.vol_att_req[gw + q];
        x.vols_any[nw + q] = x.vols_any[nw + q] + one * (present ? 1.0f : 0.0f);
        if (f & F_VOLS) x.vols_rw[nw + q] = x.vols_rw[nw + q] + one * (rw ? 1.0f : 0.0f);
      }
    }
    // COMMIT_TERM_BATCH columns at a time: their domain totals first (the
    // loads of one column do not wait on another's), then their rows in
    // column order
    for (int t0 = 0; t0 < tc; t0 += COMMIT_TERM_BATCH) {
      float add[COMMIT_TERM_BATCH];
#pragma unroll
      for (int u = 0; u < COMMIT_TERM_BATCH; ++u) {
        const int t = t0 + u;
        add[u] = 0.0f;
        if (t >= tc || c_term[t] < 0) continue;
        // the node's per-domain total of m_n for the column (0 off the key)
        const size_t kn = static_cast<size_t>(c_key[t]) * N + n;
        const int d = x.node_dom[kn];
        if (d < 0) continue;
        if (c_kind[t] == 2) {
          add[u] = m;
        } else if (c_kind[t] == 1) {
          const int ds = r.node_dom_small[kn];
          add[u] = ds >= 0 ? small_all[t * DOM_SMALL + ds] : 0.0f;
        } else {
          add[u] = r.dom_sums[static_cast<size_t>(t) * r.n_dom + d];
        }
      }
#pragma unroll
      for (int u = 0; u < COMMIT_TERM_BATCH; ++u) {
        const int t = t0 + u;
        if (t >= tc) break;
        const int term = c_term[t];
        if (term < 0) continue;
        const size_t tn = static_cast<size_t>(term) * N + n;
        x.cnt_match[tn] = x.cnt_match[tn] + c_sm[t] * add[u];
        const int ip = c_ip[t];
        if (ip < 0) continue;
        const size_t in = static_cast<size_t>(ip) * N + n;
        if (f & F_INTERPOD_REQ) {
          x.cnt_own_anti[in] = x.cnt_own_anti[in] + c_anti[t] * add[u];
          x.cnt_own_aff[in] = x.cnt_own_aff[in] + c_aff[t] * add[u];
        }
        if (f & F_INTERPOD_PREF) {
          x.w_own_aff_pref[in] = x.w_own_aff_pref[in] + c_waff[t] * add[u];
          x.w_own_anti_pref[in] = x.w_own_anti_pref[in] + c_wanti[t] * add[u];
        }
      }
    }
    if (f & F_STORAGE) {
      const size_t nv = static_cast<size_t>(n) * V, nsd = static_cast<size_t>(n) * SD;
      // each VG's row is updated once, from its own take: the visit order
      // does not matter
      if (mats && p.multi_lvm) {
        for (int v = 0; v < V; ++v) {
          float& vf = x.vg_free[nv + v];
          vf = vf - m * (p.st_live ? x.st_alloc[nv + v] : 0.0f);
        }
      } else {
        unsort_take(m, r.ord_vg + nv, r.cs_vg + nv, r.cum_vg + nv, V, [&](int v, float take) {
          float& vf = x.vg_free[nv + v];
          vf = mats ? vf - take * p.l_size : __fmaf_rn(-take, p.l_size, vf);
        });
      }
      unsort_take(m, r.ord_dev + nsd, r.cs_dev + nsd, r.cum_dev + nsd, SD, [&](int d, float take) {
        if (take > 0.0f) x.sdev_free[nsd + d] = 0;
      });
    }
    if (f & F_GPU) {
      const size_t ngd = static_cast<size_t>(n) * GD;
      const float gm = p.gpu_mem;
      const float count_f = fmaxf(static_cast<float>(p.gpu_count), 1.0f);
      if (mats && (p.has_preset || p.gpu_count > 1)) {
        for (int d = 0; d < GD; ++d) {
          float& gf = x.gpu_free[ngd + d];
          if (p.has_preset) {
            gf = gf - (m * static_cast<float>(p.preset[d])) * gm;
          } else {
            const float cg = r.c_gpu[ngd + d], cu = r.cum_gidx[ngd + d];
            const float pool_take = jclip(jmin(cu, m * count_f) - (cu - cg), 0.0f, cg);
            gf = gf - pool_take * gm;
          }
        }
      } else {
        // each device's row is updated once, from its own take
        unsort_take(m, r.ord_gpu + ngd, r.cs_gpu + ngd, r.cum_gpu + ngd, GD, [&](int d, float take) {
          float& gf = x.gpu_free[ngd + d];
          gf = mats ? gf - take * gm : __fmaf_rn(-take, gm, gf);
        });
      }
    }
  }
  clk.stamp(CP_UPDATE);

  // phase 3: the slots. Slot j < cum_slots[-1] goes to the node whose
  // prefix first passes it (searchsorted side="right"), which lies in the
  // tile whose prefix range [off, off + total) holds j: each block expands
  // its own tile's slots from its shared prefix; the slots past the total
  // (no node) are spread over the cluster.
  float off = 0.0f, total = 0.0f;  // the nodes before this tile; cum_slots[-1]
  for (int b = 0; b < B; ++b) {
    if (b == rank) off = total;
    total += tot[b];
  }
  const size_t row = static_cast<size_t>(r.row) * r.k_cap;
  const bool has_lvm = p.l_size > 0.0f, has_dev = p.d_size > 0.0f, is_gpu = p.gpu_mem > 0.0f;
  const float count_f = fmaxf(static_cast<float>(p.gpu_count), 1.0f);
  auto emit = [&](int j, bool valid, int a, float ordinal) {
    auto pick = [&](const int* ord, const float* cumx, int X) -> int {
      if (X == 0) return -1;
      int rank_x = 0;
      for (int v = 0; v < X; ++v) rank_x += cumx[static_cast<size_t>(a) * X + v] <= ordinal ? 1 : 0;
      rank_x = rank_x > X - 1 ? X - 1 : rank_x;
      return ord[static_cast<size_t>(a) * X + rank_x];
    };
    int vg = -1, dv = -1, gp = -1;
    if (f & F_STORAGE) {
      if (valid && has_lvm) vg = pick(r.ord_vg, r.cum_vg, V);
      if (valid && has_dev) dv = pick(r.ord_dev, r.cum_dev, SD);
    }
    if ((f & F_GPU) && valid && is_gpu) gp = pick(r.ord_gpu, r.cum_gpu, GD);
    r.assign[row + j] = valid ? a : -1;
    r.dev_idx[row + j] = dv;
    if (!mats) {
      r.vg_idx[row + j] = vg;
      r.gpu_idx[row + j] = gp;
      return;
    }
    if ((f & F_STORAGE) && V) {
      float* lm = r.lvm_mat + (row + j) * V;
      for (int v = 0; v < V; ++v) {
        float val;
        if (p.multi_lvm) val = p.st_live ? x.st_alloc[static_cast<size_t>(a) * V + v] : 0.0f;
        else val = (vg >= 0 && v == vg) ? p.l_size : 0.0f;
        lm[v] = (valid && has_lvm) ? val : 0.0f;
      }
    }
    if ((f & F_GPU) && GD) {
      float* gmat = r.gpu_mat + (row + j) * GD;
      const float start = ordinal * count_f;
      for (int d = 0; d < GD; ++d) {
        float val;
        if (p.has_preset) {
          val = static_cast<float>(p.preset[d]);
        } else if (p.gpu_count > 1) {
          const float cu = r.cum_gidx[static_cast<size_t>(a) * GD + d];
          const float per = r.c_gpu[static_cast<size_t>(a) * GD + d];
          val = jclip(jmin(cu, start + count_f) - jmax(cu - per, start), 0.0f, per);
        } else {
          val = (gp >= 0 && d == gp) ? 1.0f : 0.0f;
        }
        gmat[d] = (valid && is_gpu) ? val : 0.0f;
      }
    }
  };
  // the tile's slots [j0, j1): the prefix sums are integer-valued; none
  // where the total is NaN (slot < NaN holds for no slot)
  const float k_f = static_cast<float>(r.k_cap), hi_f = off + tot[rank];
  const int j0 = off < k_f ? static_cast<int>(off) : r.k_cap;
  const int j1 = total == total ? (hi_f < k_f ? static_cast<int>(hi_f) : r.k_cap) : j0;
  for (int j = j0 + tid; j < j1; j += nt) {
    const float slot = static_cast<float>(j);
    int q_lo = 0, q_hi = len;
    while (q_lo < q_hi) {
      const int mid = (q_lo + q_hi) >> 1;
      if (!(slot < off + rel[mid])) q_lo = mid + 1; else q_hi = mid;
    }
    const int a = lo_n + q_lo;
    emit(j, true, a, slot - ((off + rel[q_lo]) - r.m_n[a]));
  }
  // the slots past the total: no node (their ordinal is never read)
  const int jt = total < k_f ? static_cast<int>(total) : (total == total ? r.k_cap : 0);
  for (int j = jt + rank * nt + tid; j < r.k_cap; j += B * nt) emit(j, false, 0, 0.0f);
  clk.stamp(CP_SLOTS);
  cluster_wait();
  clk.stamp(CP_END);
  COMMIT_FLUSH(clk);
}

// the wrapper's plan (cuda.round_plan); refused only if it does not cover
// the nodes or its shared bytes are not the kernel's (sized for every
// term column of the batch; in global mode the tile's prefix alone, the
// rest in RoundPlan.pub, commit_row_words(tc) floats a block)
extern "C" int simtpu_round_commit(const StepCtx* ctx, const RoundCtx* r, const RoundPlan* plan, void* stream) {
  const int bad = check_plan(*plan, ctx->n);
  if (bad) return bad;
  if (plan->smem != (plan->pub ? plan->tile : commit_smem_words(ctx->tc, plan->tile)) * static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return plan->pub ? launch_cluster(round_commit_kernel<true>, *plan, s, *ctx, *r, *plan)
                   : launch_cluster(round_commit_kernel<false>, *plan, s, *ctx, *r, *plan);
}

#ifdef SIMTPU_ROUND_PROFILE
// the profile build's phase cycles (ROUND_PROF_SLOTS words) into `out`
// (host memory), then zeroed; synchronizes the device
extern "C" int simtpu_round_commit_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, round_commit_prof, sizeof(round_commit_prof));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[ROUND_PROF_SLOTS] = {};
  e = cudaMemcpyToSymbol(round_commit_prof, zero, sizeof(round_commit_prof));
  return static_cast<int>(e);
}
#endif
