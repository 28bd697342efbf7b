// K16 round_commit: the batched state update of one bulk round, IN PLACE,
// and the expansion of the per-node intake into per-slot placements.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core :565-748
// (with _unsort_take :149), and the chunk's row gather / scatter of
// rounds_scan_sliced :809 and scan.py _gather_rows_tuple :1197 /
// _scatter_rows :1205: the port carries full planes, so the group's term
// rows are addressed directly. One block of ROUND_THREADS threads:
//   phase 1: the per-domain totals of m_n over the group's term rows,
//            routed by key_kind as :576-614 do — a small key (<= 64
//            domains) sums into DOM_SMALL bins of shared memory through
//            node_dom_small, a key unique per node is its own sum, any
//            other key sums into the [Tc, n_dom] fallback rows — and the
//            per-term dot valid @ m_n for cnt_total. The sums add
//            integer-valued f32 below 2^24: f32 atomicAdd is exact in any
//            order there, so the order of the atomics cannot move a bit;
//   phase 2: per node: free -= m_n * req (one FMA, as the compiled round
//            contracts it), ports and volumes by min(m_n, 1), the count
//            rows and own planes by the domain totals, cnt_total, then
//            vg_free / sdev_free / gpu_free by the pods per container
//            (_unsort_take over K14's visit order; on a matrix round the
//            multi-claim plan, the multi-GPU share pool or the preset row),
//            and the inclusive prefix of m_n over the nodes;
//   phase 3: per slot j < k_cap: the node by a search over the prefix
//            (side="right"), the slot's ordinal on its node, the container
//            picks, and on a matrix round the slot's LVM bytes and GPU
//            shares.
//
// Bound: bytes — each touched state row is read and written once, the
// group's Tc domain rows read once, k_cap slots written; at N = 5000 a
// round moves well under a megabyte and the barriers dominate.
#include "rounds.cuh"

// node n's per-domain total of m_n for term row t (0 off the key)
__device__ inline float domain_total(const StepCtx& x, const RoundCtx& r, const float* small, int t,
                                     int term, int n) {
  const int N = x.n;
  const int key = x.term_topo[term];
  const int dom = x.node_dom[static_cast<size_t>(key) * N + n];
  if (dom < 0) return 0.0f;
  const int kind = r.key_kind[key];
  if (kind == 2) return r.m_n[n];
  if (kind == 1) {
    const int ds = r.node_dom_small[static_cast<size_t>(key) * N + n];
    return ds >= 0 ? small[t * DOM_SMALL + ds] : 0.0f;
  }
  return r.dom_sums[static_cast<size_t>(t) * r.n_dom + dom];
}

__global__ void __launch_bounds__(ROUND_THREADS) round_commit_kernel(StepCtx x, RoundCtx r) {
  extern __shared__ float small[];  // [Tc, DOM_SMALL] small-key domain totals
  __shared__ BlockScratch sh;
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const RoundPod p = round_pod(x, r.i);
  const int g = p.g;
  const float* req = p.req;
  const int f = x.flags;
  const bool mats = r.mode & RV_MATS;
  const int tc = (uses_topology(f) && x.tc > 0) ? x.tc : 0;
  const int* terms = x.g_terms + static_cast<size_t>(g) * x.tc;
  const size_t g0 = static_cast<size_t>(g) * x.tc;
  const int V = x.v, SD = x.sd, GD = x.gd;

  // phase 1: per-domain totals and the cnt_total dots
  for (int q = tid; q < tc * DOM_SMALL; q += nt) small[q] = 0.0f;
  for (size_t q = tid; q < static_cast<size_t>(tc) * r.n_dom; q += nt) r.dom_sums[q] = 0.0f;
  __syncthreads();
  for (int n = tid; n < N; n += nt) {
    const float m = r.m_n[n];
    for (int t = 0; t < tc; ++t) {
      const int term = terms[t];
      if (term < 0) continue;
      const int key = x.term_topo[term];
      const int dom = x.node_dom[static_cast<size_t>(key) * N + n];
      if (dom < 0) continue;
      const int kind = r.key_kind[key];
      if (kind == 1) {
        const int ds = r.node_dom_small[static_cast<size_t>(key) * N + n];
        if (ds >= 0) atomicAdd(&small[t * DOM_SMALL + ds], m);
      } else if (kind != 2) {
        atomicAdd(&r.dom_sums[static_cast<size_t>(t) * r.n_dom + dom], m);
      }
    }
  }
  for (int t = 0; t < tc; ++t) {
    const int term = terms[t];
    float dot = 0.0f;
    if (term >= 0) {
      const int* dom = x.node_dom + static_cast<size_t>(x.term_topo[term]) * N;
      for (int n = tid; n < N; n += nt)
        if (dom[n] >= 0) dot += r.m_n[n];
    }
    dot = block_sum(dot, sh);
    if (tid == 0 && term >= 0 && x.s_match[g0 + t]) x.cnt_total[term] = x.cnt_total[term] + dot;
  }
  __syncthreads();

  // phase 2: the per-node state update and the prefix of m_n
  float* cum = r.scr + static_cast<size_t>(SC_CUM) * N;
  for (int n = tid; n < N; n += nt) {
    const float m = r.m_n[n];
    cum[n] = m;
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
    for (int t = 0; t < tc; ++t) {
      const int term = terms[t];
      if (term < 0) continue;
      const float add = domain_total(x, r, small, t, term, n);
      const size_t tn = static_cast<size_t>(term) * N + n;
      x.cnt_match[tn] = x.cnt_match[tn] + (x.s_match[g0 + t] ? 1.0f : 0.0f) * add;
      const int ip = x.ip_of[term];
      if (ip < 0) continue;
      const size_t in = static_cast<size_t>(ip) * N + n;
      if (f & F_INTERPOD_REQ) {
        x.cnt_own_anti[in] = x.cnt_own_anti[in] + (x.a_anti_req[g0 + t] ? 1.0f : 0.0f) * add;
        x.cnt_own_aff[in] = x.cnt_own_aff[in] + (x.a_aff_req[g0 + t] ? 1.0f : 0.0f) * add;
      }
      if (f & F_INTERPOD_PREF) {
        x.w_own_aff_pref[in] = x.w_own_aff_pref[in] + x.w_aff_pref[g0 + t] * add;
        x.w_own_anti_pref[in] = x.w_own_anti_pref[in] + x.w_anti_pref[g0 + t] * add;
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
  __syncthreads();
  block_scan_array(cum, N, [](float a, float b) { return a + b; }, 0.0f, sh);
  const float total = cum[N - 1];  // cum_slots[-1]

  // phase 3: the slots
  const size_t row = static_cast<size_t>(r.row) * r.k_cap;
  const bool has_lvm = p.l_size > 0.0f, has_dev = p.d_size > 0.0f, is_gpu = p.gpu_mem > 0.0f;
  const float count_f = fmaxf(static_cast<float>(p.gpu_count), 1.0f);
  for (int j = tid; j < r.k_cap; j += nt) {
    const float slot = static_cast<float>(j);
    int a_lo = 0, a_hi = N;  // searchsorted(cum, slot, side="right")
    while (a_lo < a_hi) {
      const int mid = (a_lo + a_hi) >> 1;
      if (!(slot < cum[mid])) a_lo = mid + 1; else a_hi = mid;
    }
    const bool valid = slot < total;
    const int a = valid ? a_lo : 0;
    const float ordinal = slot - (cum[a] - r.m_n[a]);
    auto pick = [&](const int* ord, const float* cumx, int X) -> int {
      if (X == 0) return -1;
      int rank = 0;
      for (int v = 0; v < X; ++v) rank += cumx[static_cast<size_t>(a) * X + v] <= ordinal ? 1 : 0;
      rank = rank > X - 1 ? X - 1 : rank;
      return ord[static_cast<size_t>(a) * X + rank];
    };
    int vg = -1, dv = -1, gp = -1;
    if (f & F_STORAGE) {
      if (valid && has_lvm) vg = pick(r.ord_vg, r.cum_vg, V);
      if (valid && has_dev) dv = pick(r.ord_dev, r.cum_dev, SD);
    }
    if ((f & F_GPU) && valid && is_gpu) gp = pick(r.ord_gpu, r.cum_gpu, GD);
    r.assign[row + j] = valid ? a_lo : -1;
    r.dev_idx[row + j] = dv;
    if (!mats) {
      r.vg_idx[row + j] = vg;
      r.gpu_idx[row + j] = gp;
      continue;
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
  }
}

extern "C" int simtpu_round_commit(const StepCtx* ctx, const RoundCtx* r, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > ROUND_THREADS ? ROUND_THREADS : threads);
  const size_t smem = static_cast<size_t>(ctx->tc > 0 ? ctx->tc : 1) * DOM_SMALL * sizeof(float);
  round_commit_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *r);
  return launch_status();
}
