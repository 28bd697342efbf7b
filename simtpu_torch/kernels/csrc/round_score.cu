// K14 round_score: the per-node caps, s0 and score slope of one bulk round.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core
// :363-523 (with _floor_slots :114 and _fill_order :128) after the round
// pod's filter cascade and plans (K1, K5/K6, K2 — the launches that
// filter_and_score's device work became). One thread-block cluster
// (rounds.cuh `RoundPlan`, cuda.round_plan): block b owns a node tile,
// each thread up to ROUND_NPT of its nodes in registers.
//   pass 1: per node m_all, the Simon share, node affinity, taint, the
//           inter-pod / soft spread / SelectorSpread raw rows and the
//           Open-Local raw, kept for passes 2 and 4; outside a quota round
//           with topology also the group's raw count rows one pod further
//           on, which the re-score reads (K2's per-node code with the run's
//           own incidence bumped on valid nodes; they need nothing from
//           pass 2); the 17 masked normalizers over m_all (K3's pass 1 and
//           score_pod's fresh ones for the re-score)
//           folded by warp, by block, then across the cluster: each block
//           publishes its 17 partials in shared memory, one cluster
//           barrier, each block folds the ranks' partials in rank order
//           (min / max: the same value in any order);
//   pass 2: per node the score without and with the Open-Local term
//           (K3's pass 2), and the intake caps: resources with the
//           relative slack floor((free + slack) / req), the exclusive cap
//           for host ports and read-write volumes, the LVM / device / GPU
//           slot counts with their tightest-first visit orders (an
//           insertion sort in the node's order row; the JAX one-hot
//           einsums are exact permutations), and on a matrix round the
//           multi-claim LVM and multi-GPU caps. A quota round stops here:
//           K15 owns the rest;
//   then the self-affinity bootstrap (no matching pod cluster-wide): an
//           argmax of s0 over the nodes with a cap, lowest index on ties
//           (per block, then across the cluster by argmax_merge, which is
//           order-free), confines the round to that node's domain;
//   pass 4: the re-score at free - req, the slope clip(score_nostorage -
//           score1, 0, 1e6) on m_all (0 elsewhere) and s0 (NEG elsewhere).
// One cluster barrier a plain round, two with the bootstrap; the last is
// split (arrive after the block's last remote read, wait before it exits)
// so no block leaves while another still reads its shared memory.
//
// Bound: bytes — free/alloc [N,R], the VG, device and GPU rows, the
// group's Tc count and own-plane rows and the [G,N] score rows read once,
// the caps, fill orders, s0 and slope written once (about 1 MB at the
// bulk problem's N = 5000: 0.3 µs at 3.35 TB/s). One block reads at one
// SM's share of that rate and issues all the per-node work on one SM's
// schedulers; the cluster spreads both over up to 16 SMs for one
// barrier.
//
// The profile build (-DSIMTPU_ROUND_PROFILE) adds thread 0 of block 0's
// clock64() cycles per phase (SCORE_PROF_PHASES) into `round_score_prof`.
#include "rounds.cuh"

// profile slots, one per phase
enum : int { SP_PASS1 = 0, SP_FOLD, SP_PASS2, SP_BOOT, SP_PASS4, SP_END, SCORE_PROF_PHASES };

#ifdef SIMTPU_ROUND_PROFILE
__device__ unsigned long long round_score_prof[ROUND_PROF_SLOTS];
#define SCORE_FLUSH(c) (c).flush(round_score_prof)
#else
#define SCORE_FLUSH(c) ((void)0)
#endif

// the normalizers: N_MIN minima (Simon, node affinity, soft spread,
// Open-Local), N_MAX maxima (Simon, node affinity, taint, |inter-pod|,
// soft spread, SelectorSpread host / zone, Open-Local), then the five of
// the raw rows one pod further on (|inter-pod| max, soft min, soft max,
// SelectorSpread host / zone max)
constexpr int N_MIN = 4;
constexpr int N_MAX = 8;
constexpr int NQ_IPA1 = N_MIN + N_MAX, NQ_SOFT1_LO = NQ_IPA1 + 1, NQ_SOFT1_HI = NQ_IPA1 + 2,
              NQ_SSH1 = NQ_IPA1 + 3, NQ_SSZ1 = NQ_IPA1 + 4, N_NORM = NQ_IPA1 + 5;

__device__ constexpr bool norm_is_min(int q) { return q < N_MIN || q == NQ_SOFT1_LO; }
__device__ inline float norm_op(int q, float a, float b) { return norm_is_min(q) ? fminf(a, b) : fmaxf(a, b); }

// pass 1's per-node values, kept for passes 2 and 4
struct NodeVals {
  float share, np, ti, ipa, soft, ssh, ssz, ol;
  bool m_all;
};

__device__ inline NodeVals node_vals(const StepCtx& x, const RoundPod& p, size_t gn, int n) {
  const int N = x.n;
  NodeVals v;
  v.m_all = node_m_all(x, p, n);
  v.share = dominant_share(x, n, p.req);
  v.np = x.node_pref[gn + n];
  v.ti = x.taint_intol[gn + n];
  v.ipa = x.raw[n];
  v.soft = x.raw[N + n];
  v.ssh = x.raw[2 * N + n];
  v.ssz = x.raw[3 * N + n];
  v.ol = p.st_live ? x.st_raw[n] : 0.0f;
  return v;
}

template <int NPT>
__global__ void __launch_bounds__(ROUND_CLUSTER_THREADS, 1) round_score_kernel(StepCtx x, RoundCtx r, RoundPlan plan) {
  constexpr int S = NPT > 0 ? NPT : 1;
  __shared__ float sh_w[ROUND_CLUSTER_THREADS / 32][N_NORM];
  __shared__ float sh_x[N_NORM];                       // this block's partials, read by the cluster
  __shared__ float sh_all[ROUND_CLUSTER_MAX][N_NORM];  // every block's, gathered
  __shared__ float sh_fin[N_NORM];
  __shared__ float sh_bv[32], sh_gv[ROUND_CLUSTER_MAX];
  __shared__ int sh_bi[32], sh_gi[ROUND_CLUSTER_MAX];
  __shared__ float sh_xv;
  __shared__ int sh_xi;
  PhaseClock clk;
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int B = plan.blocks;
  const int lo_n = static_cast<int>(blockIdx.x) * plan.tile;
  const int hi_n = min(N, lo_n + plan.tile);
  const RoundPod p = round_pod(x, r.i);
  const int g = p.g;
  const float* req = p.req;
  const size_t gn = static_cast<size_t>(g) * N;
  const int f = x.flags;
  const float* w_ = x.score_w;
  const bool mats = r.mode & RV_MATS;
  const bool topo = uses_topology(f) && x.tc > 0;
  const bool stop2 = (r.mode & RV_QUOTA) && topo;
  const bool boot = !stop2 && (r.mode & RV_SELF_AFF) && topo;
  const bool raws1 = topo && !stop2;
  const int V = x.v, SD = x.sd, GD = x.gd;
  float* raw1g = r.scr + static_cast<size_t>(SC_RAW1) * N;  // pass 3's rows past the registers (NPT 0)

  NodeVals nv[S];
  float r1[S][N_RAWS], sns[S], s0v[S], capv[S];

  // pass 1: the node values, the raw rows one pod further on, and the
  // normalizers' partials
  float nq[N_NORM];
#pragma unroll
  for (int q = 0; q < N_NORM; ++q) nq[q] = norm_is_min(q) ? BIG : -BIG;
  nq[N_MIN + 2] = nq[N_MIN + 3] = nq[N_MIN + 5] = nq[N_MIN + 6] = 0.0f;
  nq[NQ_IPA1] = nq[NQ_SSH1] = nq[NQ_SSZ1] = 0.0f;
  TopoScalars sc;
  if (raws1) sc = topo_scalars(x, g);
  for_tile<NPT>(lo_n, hi_n, [&](int j, int n) {
    const NodeVals v = node_vals(x, p, gn, n);
    if (NPT > 0) nv[j] = v;
    float raw[N_RAWS];
    if (raws1 && v.m_all) {
      bool s_ok, i_ok;
      topology_node(x, g, n, nullptr, false, false, sc, s_ok, i_ok, raw, true);
      if (NPT > 0) {
#pragma unroll
        for (int k = 0; k < N_RAWS; ++k) r1[j][k] = raw[k];
      } else {
        for (int k = 0; k < N_RAWS; ++k) raw1g[static_cast<size_t>(k) * N + n] = raw[k];
      }
    }
    if (!v.m_all) return;
    const float sim = v.share * MAX_NODE_SCORE;
    nq[0] = fminf(nq[0], sim); nq[N_MIN + 0] = fmaxf(nq[N_MIN + 0], sim);
    nq[1] = fminf(nq[1], v.np); nq[N_MIN + 1] = fmaxf(nq[N_MIN + 1], v.np);
    nq[N_MIN + 2] = fmaxf(nq[N_MIN + 2], v.ti);
    nq[N_MIN + 3] = fmaxf(nq[N_MIN + 3], fabsf(v.ipa));
    nq[2] = fminf(nq[2], v.soft); nq[N_MIN + 4] = fmaxf(nq[N_MIN + 4], v.soft);
    nq[N_MIN + 5] = fmaxf(nq[N_MIN + 5], v.ssh);
    nq[N_MIN + 6] = fmaxf(nq[N_MIN + 6], v.ssz);
    nq[3] = fminf(nq[3], v.ol); nq[N_MIN + 7] = fmaxf(nq[N_MIN + 7], v.ol);
    if (raws1) {
      nq[NQ_IPA1] = fmaxf(nq[NQ_IPA1], fabsf(raw[RAW_IPA]));
      nq[NQ_SOFT1_LO] = fminf(nq[NQ_SOFT1_LO], raw[RAW_SOFT]);
      nq[NQ_SOFT1_HI] = fmaxf(nq[NQ_SOFT1_HI], raw[RAW_SOFT]);
      nq[NQ_SSH1] = fmaxf(nq[NQ_SSH1], raw[RAW_SS_HOST]);
      nq[NQ_SSZ1] = fmaxf(nq[NQ_SSZ1], raw[RAW_SS_ZONE]);
    }
  });
  clk.stamp(SP_PASS1);
#pragma unroll
  for (int q = 0; q < N_NORM; ++q)
    for (int off = 16; off > 0; off >>= 1) nq[q] = norm_op(q, nq[q], __shfl_xor_sync(0xffffffffu, nq[q], off));
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < N_NORM; ++q) sh_w[warp][q] = nq[q];
  __syncthreads();
  if (tid < N_NORM) {
    float v = sh_w[0][tid];
    for (int w = 1; w < n_warps; ++w) v = norm_op(tid, v, sh_w[w][tid]);
    sh_x[tid] = v;
  }
  cluster_barrier();
  for (int q = tid; q < B * N_NORM; q += nt) {
    const int b = q / N_NORM, k = q - b * N_NORM;
    sh_all[b][k] = *cluster_peer(&sh_x[k], b);
  }
  __syncthreads();
  if (!boot) cluster_arrive();  // the block's last remote read is done
  if (tid < N_NORM) {
    float v = sh_all[0][tid];
    for (int b = 1; b < B; ++b) v = norm_op(tid, v, sh_all[b][tid]);
    sh_fin[tid] = v;
  }
  __syncthreads();
  float lo[N_MIN], hi[N_MAX];
#pragma unroll
  for (int k = 0; k < N_MIN; ++k) lo[k] = sh_fin[k];
#pragma unroll
  for (int k = 0; k < N_MAX; ++k) hi[k] = sh_fin[N_MIN + k];
  const float h3 = sh_fin[NQ_IPA1], lo2 = sh_fin[NQ_SOFT1_LO], h4 = sh_fin[NQ_SOFT1_HI], h5 = sh_fin[NQ_SSH1],
              h6 = sh_fin[NQ_SSZ1];
  bool any_zone = false;
  for (int t = 0; t < x.tc; ++t) any_zone = any_zone || x.ss_zone[static_cast<size_t>(g) * x.tc + t];
  bool exclusive = false;
  if (f & F_PORTS)
    for (int q = 0; q < x.p_ports; ++q) exclusive = exclusive || x.ports_req[static_cast<size_t>(g) * x.p_ports + q];
  if (f & F_VOLS)
    for (int q = 0; q < x.w; ++q) exclusive = exclusive || x.vol_rw_req[static_cast<size_t>(g) * x.w + q];
  clk.stamp(SP_FOLD);

  // pass 2: the scores and the caps
  for_tile<NPT>(lo_n, hi_n, [&](int j, int n) {
    const NodeVals v = NPT > 0 ? nv[j] : node_vals(x, p, gn, n);
    float s = -INFINITY;
    if (v.m_all) {
      ScoreTerms t;
      t.simon = simon_term(v.share, lo[0], hi[0]);
      t.node_pref = minmax_norm(v.np, lo[1], hi[1]);
      t.taint = taint_term(v.ti, hi[2]);
      t.ipa = maxabs_term(v.ipa, hi[3]);
      t.soft = inv_minmax(v.soft, lo[2], hi[4]);
      t.ss = ss_term(v.ssh, v.ssz, hi[5], hi[6], any_zone);
      s = compose_score(w_, f, x.tc > 0, resource_base(x, n, req, w_[0], w_[1]), t, x.static_score[gn + n],
                        x.avoid_pen[gn + n]);
    }
    const float score_ns = s;
    if (f & F_STORAGE) s = __fmaf_rn(w_[10], minmax_norm(v.ol, lo[3], hi[7]), s);

    const float* fr = x.free + static_cast<size_t>(n) * x.r;
    float cap = BIG;
    for (int q = 0; q < x.r; ++q) {
      if (!(req[q] > 0.0f)) continue;
      const float slack_free = __fmaf_rn(1e-5f, fmaxf(fabsf(fr[q]), 1.0f), fr[q]);
      cap = jmin(cap, floorf(__fdiv_rn(slack_free, fmaxf(req[q], TINY))));
    }
    if (exclusive) cap = jmin(cap, 1.0f);
    if (f & F_STORAGE) {
      const size_t nv_ = static_cast<size_t>(n) * V, nsd = static_cast<size_t>(n) * SD;
      const bool has_lvm = p.l_size > 0.0f;
      // a VG's slots and sort key, from the node's rows
      auto c_vg = [&](int vg) {
        const int nid = x.vg_name_id[nv_ + vg];
        const float vf = x.vg_free[nv_ + vg];
        const bool elig = nid >= 0 && (p.l_vid < 0 || nid == p.l_vid);
        return (has_lvm && elig && vf >= p.l_size) ? floor_slots(vf, p.l_size) : 0.0f;
      };
      auto key_vg = [&](int vg) { return c_vg(vg) > 0.0f ? x.vg_free[nv_ + vg] : BIG; };
      float cap_lvm = 0.0f;
      for (int vg = 0; vg < V; ++vg) cap_lvm += c_vg(vg);
      if (mats && p.multi_lvm) {
        bool any_used = false;
        float m = BIG;
        for (int vg = 0; vg < V; ++vg) {
          const float a = p.st_live ? x.st_alloc[nv_ + vg] : 0.0f;
          if (!(a > 0.0f)) continue;
          any_used = true;
          m = jmin(m, floor_slots(x.vg_free[nv_ + vg], fmaxf(a, TINY)));
        }
        cap_lvm = any_used ? m : 0.0f;
      }
      if (has_lvm) cap = jmin(cap, cap_lvm);
      fill_order(c_vg, key_vg, V, r.ord_vg + nv_, r.cs_vg + nv_, r.cum_vg + nv_);
      const bool has_dev = p.d_size > 0.0f;
      auto dev_ok = [&](int d) {
        return has_dev && x.sdev_free[nsd + d] && x.sdev_media[nsd + d] == p.d_media &&
               x.sdev_cap[nsd + d] >= p.d_size;
      };
      auto c_dev = [&](int d) { return dev_ok(d) ? 1.0f : 0.0f; };
      auto dkey = [&](int d) { return dev_ok(d) ? x.sdev_cap[nsd + d] : BIG; };
      float n_dev = 0.0f;
      for (int d = 0; d < SD; ++d) n_dev += c_dev(d);
      if (has_dev) cap = jmin(cap, n_dev);
      fill_order(c_dev, dkey, SD, r.ord_dev + nsd, r.cs_dev + nsd, r.cum_dev + nsd);
    }
    if (f & F_GPU) {
      const size_t ngd = static_cast<size_t>(n) * GD;
      const float gm = p.gpu_mem;
      const bool is_gpu = gm > 0.0f;
      auto fg = [&](int d) { return x.gpu_dev_exists[ngd + d] ? x.gpu_free[ngd + d] : -1.0f; };
      auto c_gpu = [&](int d) { return (is_gpu && fg(d) >= gm) ? floor_slots(fg(d), gm) : 0.0f; };
      auto key_gpu = [&](int d) { return c_gpu(d) > 0.0f ? fg(d) : BIG; };
      float cap_gpu = 0.0f, run = 0.0f;
      for (int d = 0; d < GD; ++d) {
        const float cg = c_gpu(d);
        cap_gpu += cg;
        if (mats) {
          run += cg;
          r.c_gpu[ngd + d] = cg;
          r.cum_gidx[ngd + d] = run;
        }
      }
      if (mats) {
        if (p.gpu_count > 1) cap_gpu = floorf(__fdiv_rn(cap_gpu, static_cast<float>(p.gpu_count)));
        if (p.has_preset) cap_gpu = BIG;
      }
      if (is_gpu) cap = jmin(cap, cap_gpu);
      fill_order(c_gpu, key_gpu, GD, r.ord_gpu + ngd, r.cs_gpu + ngd, r.cum_gpu + ngd);
    }
    r.m_all[n] = v.m_all ? 1 : 0;
    if (stop2) {
      // K15 lifts t*'s filter and owns the rest
      r.cap[n] = cap;
      r.slope[n] = score_ns;
      r.s0[n] = s;
      return;
    }
    const float capm = v.m_all ? cap : 0.0f;
    r.cap[n] = capm;
    if (NPT > 0) {
      sns[j] = score_ns;
      s0v[j] = s;
      capv[j] = capm;
    } else {
      r.slope[n] = score_ns;
      r.s0[n] = s;
    }
  });
  clk.stamp(SP_PASS2);
  if (stop2) {
    cluster_wait();
    SCORE_FLUSH(clk);
    return;
  }

  if (boot) {
    // colocate-with-self bootstrap: no matching pod cluster-wide confines
    // the round to the domain of the best-scoring node with a cap
    const int tc = x.tc;
    const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
    const size_t g0 = static_cast<size_t>(g) * tc;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for_tile<NPT>(lo_n, hi_n, [&](int j, int n) {
      const float c = NPT > 0 ? capv[j] : r.cap[n];
      argmax_merge(bv, bi, c > 0.0f ? (NPT > 0 ? s0v[j] : r.s0[n]) : NEG, n);
    });
    block_argmax(bv, bi, sh_bv, sh_bi);
    if (tid == 0) {
      sh_xv = bv;
      sh_xi = bi;
    }
    cluster_barrier();
    if (tid < B) {
      sh_gv[tid] = *cluster_peer(&sh_xv, tid);
      sh_gi[tid] = *cluster_peer(&sh_xi, tid);
    }
    __syncthreads();
    cluster_arrive();  // the block's last remote read is done
    bv = sh_gv[0];
    bi = sh_gi[0];
    for (int b = 1; b < B; ++b) argmax_merge(bv, bi, sh_gv[b], sh_gi[b]);
    int t_star = 0;
    for (int t = tc - 1; t >= 0; --t)
      if (x.s_match[g0 + t] && x.a_aff_req[g0 + t] && terms[t] >= 0) t_star = t;
    float total = 0.0f;
    for (int t = 0; t < tc; ++t)
      if (x.a_aff_req[g0 + t] && terms[t] >= 0) total += x.cnt_total[terms[t]];
    if (total <= 0.0f) {
      const int term = terms[t_star];
      const int* dom = x.node_dom + static_cast<size_t>(term >= 0 ? x.term_topo[term] : 0) * N;
      const int d_star = term >= 0 ? dom[bi] : 0;
      for_tile<NPT>(lo_n, hi_n, [&](int, int n) {
        const int dn = term >= 0 ? dom[n] : 0;
        if (!(dn == d_star && dn >= 0)) r.cap[n] = 0.0f;
      });
    }
  }
  clk.stamp(SP_BOOT);

  // pass 4: the re-score at free - req, the slope and s0
  for_tile<NPT>(lo_n, hi_n, [&](int j, int n) {
    const NodeVals v = NPT > 0 ? nv[j] : node_vals(x, p, gn, n);
    if (!v.m_all) {
      r.slope[n] = 0.0f;
      r.s0[n] = NEG;
      return;
    }
    ScoreTerms t;
    t.simon = simon_term(v.share, lo[0], hi[0]);
    t.node_pref = minmax_norm(v.np, lo[1], hi[1]);
    t.taint = taint_term(v.ti, hi[2]);
    if (topo) {
      float rw[N_RAWS];
#pragma unroll
      for (int k = 0; k < N_RAWS; ++k) rw[k] = NPT > 0 ? r1[j][k] : raw1g[static_cast<size_t>(k) * N + n];
      t.ipa = maxabs_term(rw[RAW_IPA], h3);
      t.soft = inv_minmax(rw[RAW_SOFT], lo2, h4);
      t.ss = ss_term(rw[RAW_SS_HOST], rw[RAW_SS_ZONE], h5, h6, any_zone);
    } else {
      t.ipa = t.soft = t.ss = 0.0f;
    }
    const float* frow = x.free + static_cast<size_t>(n) * x.r;
    const float fr1[2] = {frow[RES_CPU] - req[RES_CPU], frow[RES_MEMORY] - req[RES_MEMORY]};
    const float s1 = compose_score(w_, f, x.tc > 0, resource_base_fr(x, n, req, fr1, w_[0], w_[1]), t,
                                   x.static_score[gn + n], x.avoid_pen[gn + n]);
    const float score_ns = NPT > 0 ? sns[j] : r.slope[n];
    r.slope[n] = jclip(score_ns - s1, 0.0f, 1e6f);
    if (NPT > 0) r.s0[n] = s0v[j];
  });
  clk.stamp(SP_PASS4);
  cluster_wait();
  clk.stamp(SP_END);
  SCORE_FLUSH(clk);
}

template <int NPT>
int launch_score(const StepCtx& x, const RoundCtx& r, const RoundPlan& plan, cudaStream_t s) {
  return launch_cluster(round_score_kernel<NPT>, plan, s, x, r, plan);
}

// the wrapper's plan (cuda.round_plan); refused only if it does not cover
// the nodes
extern "C" int simtpu_round_score(const StepCtx* ctx, const RoundCtx* r, const RoundPlan* plan, void* stream) {
  const int bad = check_plan(*plan, ctx->n);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (plan->npt) {
    case 1: return launch_score<1>(*ctx, *r, *plan, s);
    case 2: return launch_score<2>(*ctx, *r, *plan, s);
    case ROUND_NPT: return launch_score<ROUND_NPT>(*ctx, *r, *plan, s);
    default: return launch_score<0>(*ctx, *r, *plan, s);
  }
}

#ifdef SIMTPU_ROUND_PROFILE
// the profile build's phase cycles (ROUND_PROF_SLOTS words) into `out`
// (host memory), then zeroed; synchronizes the device
extern "C" int simtpu_round_score_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, round_score_prof, sizeof(round_score_prof));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[ROUND_PROF_SLOTS] = {};
  e = cudaMemcpyToSymbol(round_score_prof, zero, sizeof(round_score_prof));
  return static_cast<int>(e);
}
#endif
