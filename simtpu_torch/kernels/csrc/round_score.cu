// K14 round_score: the per-node caps, s0 and score slope of one bulk round.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core
// :363-523 (with _floor_slots :114 and _fill_order :128) after the round
// pod's filter cascade and plans (K1, K5/K6, K2 — the launches that
// filter_and_score's device work became). One block of ROUND_THREADS
// threads strides over the N nodes:
//   pass 1: the masked normalizers of the round-start score over m_all
//           (K3's pass 1: Simon share, node affinity, taint, inter-pod,
//           soft spread, SelectorSpread, Open-Local raw);
//   pass 2: per node the score without and with the Open-Local term
//           (K3's pass 2), and the intake caps: resources with the
//           relative slack floor((free + slack) / req), the exclusive cap
//           for host ports and read-write volumes, the LVM / device / GPU
//           slot counts with their tightest-first visit orders (X <= 32
//           containers in registers; the JAX one-hot einsums are exact
//           permutations, here an insertion sort), and on a matrix round
//           the multi-claim LVM and multi-GPU caps. A quota round stops
//           here: K15 owns the rest;
//   then the self-affinity bootstrap (no matching pod cluster-wide): an
//           argmax of s0 over the nodes with a cap, lowest index on ties,
//           confines the round to that node's domain;
//   pass 3: the group's raw count rows one pod further on (K2's per-node
//           code with the run's own incidence bumped on valid nodes) and
//           their normalizers over m_all, taken afresh as score_pod does;
//   pass 4: the re-score at free - req, the slope clip(score_nostorage -
//           score1, 0, 1e6) on m_all (0 elsewhere) and s0 (NEG elsewhere).
//
// Bound: bytes — free/alloc [N,R], the VG, device and GPU rows, the
// group's Tc count and own-plane rows and the [G,N] score rows are read
// once per pass that needs them, the caps, fill orders, s0 and slope
// written once; at N = 5000 the four passes are a few microseconds of
// traffic and the barriers between them dominate.
#include "rounds.cuh"

__global__ void __launch_bounds__(ROUND_THREADS) round_score_kernel(StepCtx x, RoundCtx r) {
  constexpr int N_MIN = 4;
  constexpr int N_MAX = 8;
  __shared__ float sh_min[32][N_MIN];
  __shared__ float sh_max[32][N_MAX];
  __shared__ float sh_bv[32];
  __shared__ int sh_bi[32];
  __shared__ BlockScratch sh;
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const RoundPod p = round_pod(x, r.i);
  const int g = p.g;
  const float* req = p.req;
  const size_t gn = static_cast<size_t>(g) * N;
  const int f = x.flags;
  const float* w_ = x.score_w;
  const bool mats = r.mode & RV_MATS;
  const bool topo = uses_topology(f) && x.tc > 0;
  const int V = x.v, SD = x.sd, GD = x.gd;

  // pass 1: the round-start normalizers over m_all (scores.cuh, K3)
  float lo[N_MIN], hi[N_MAX];
  for (int k = 0; k < N_MIN; ++k) lo[k] = BIG;
  hi[0] = -BIG; hi[1] = -BIG; hi[2] = 0.0f; hi[3] = 0.0f; hi[4] = -BIG; hi[5] = 0.0f; hi[6] = 0.0f;
  hi[7] = -BIG;
  for (int n = tid; n < N; n += nt) {
    if (!node_m_all(x, p, n)) continue;
    const float sim = dominant_share(x, n, req) * MAX_NODE_SCORE;
    lo[0] = fminf(lo[0], sim); hi[0] = fmaxf(hi[0], sim);
    const float np_ = x.node_pref[gn + n];
    lo[1] = fminf(lo[1], np_); hi[1] = fmaxf(hi[1], np_);
    hi[2] = fmaxf(hi[2], x.taint_intol[gn + n]);
    hi[3] = fmaxf(hi[3], fabsf(x.raw[n]));
    const float sp = x.raw[N + n];
    lo[2] = fminf(lo[2], sp); hi[4] = fmaxf(hi[4], sp);
    hi[5] = fmaxf(hi[5], x.raw[2 * N + n]);
    hi[6] = fmaxf(hi[6], x.raw[3 * N + n]);
    const float ol = p.st_live ? x.st_raw[n] : 0.0f;
    lo[3] = fminf(lo[3], ol); hi[7] = fmaxf(hi[7], ol);
  }
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < N_MIN; ++k) lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
    for (int k = 0; k < N_MAX; ++k) hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
  }
  if (lane == 0) {
    for (int k = 0; k < N_MIN; ++k) sh_min[warp][k] = lo[k];
    for (int k = 0; k < N_MAX; ++k) sh_max[warp][k] = hi[k];
  }
  __syncthreads();
  for (int k = 0; k < N_MIN; ++k) {
    lo[k] = sh_min[0][k];
    for (int w = 1; w < n_warps; ++w) lo[k] = fminf(lo[k], sh_min[w][k]);
  }
  for (int k = 0; k < N_MAX; ++k) {
    hi[k] = sh_max[0][k];
    for (int w = 1; w < n_warps; ++w) hi[k] = fmaxf(hi[k], sh_max[w][k]);
  }
  __syncthreads();
  bool any_zone = false;
  for (int t = 0; t < x.tc; ++t) any_zone = any_zone || x.ss_zone[static_cast<size_t>(g) * x.tc + t];
  bool exclusive = false;
  if (f & F_PORTS)
    for (int q = 0; q < x.p_ports; ++q) exclusive = exclusive || x.ports_req[static_cast<size_t>(g) * x.p_ports + q];
  if (f & F_VOLS)
    for (int q = 0; q < x.w; ++q) exclusive = exclusive || x.vol_rw_req[static_cast<size_t>(g) * x.w + q];

  // pass 2: the scores (score_nostorage parked in slope, score in s0) and
  // the caps
  for (int n = tid; n < N; n += nt) {
    const bool m_all = node_m_all(x, p, n);
    ScoreTerms t;
    t.simon = simon_term(dominant_share(x, n, req), lo[0], hi[0]);
    t.node_pref = minmax_norm(x.node_pref[gn + n], lo[1], hi[1]);
    t.taint = taint_term(x.taint_intol[gn + n], hi[2]);
    t.ipa = maxabs_term(x.raw[n], hi[3]);
    t.soft = inv_minmax(x.raw[N + n], lo[2], hi[4]);
    t.ss = ss_term(x.raw[2 * N + n], x.raw[3 * N + n], hi[5], hi[6], any_zone);
    float s = compose_score(w_, f, x.tc > 0, resource_base(x, n, req, w_[0], w_[1]), t,
                            x.static_score[gn + n], x.avoid_pen[gn + n]);
    if (!m_all) s = -INFINITY;
    r.slope[n] = s;
    if (f & F_STORAGE) s = __fmaf_rn(w_[10], minmax_norm(p.st_live ? x.st_raw[n] : 0.0f, lo[3], hi[7]), s);
    r.s0[n] = s;

    const float* fr = x.free + static_cast<size_t>(n) * x.r;
    float cap = BIG;
    for (int q = 0; q < x.r; ++q) {
      if (!(req[q] > 0.0f)) continue;
      const float slack_free = __fmaf_rn(1e-5f, fmaxf(fabsf(fr[q]), 1.0f), fr[q]);
      cap = jmin(cap, floorf(__fdiv_rn(slack_free, fmaxf(req[q], TINY))));
    }
    if (exclusive) cap = jmin(cap, 1.0f);
    if (f & F_STORAGE) {
      const size_t nv = static_cast<size_t>(n) * V, nsd = static_cast<size_t>(n) * SD;
      const bool has_lvm = p.l_size > 0.0f;
      // a VG's slots and sort key, from the node's rows
      auto c_vg = [&](int v) {
        const int nid = x.vg_name_id[nv + v];
        const float vf = x.vg_free[nv + v];
        const bool elig = nid >= 0 && (p.l_vid < 0 || nid == p.l_vid);
        return (has_lvm && elig && vf >= p.l_size) ? floor_slots(vf, p.l_size) : 0.0f;
      };
      auto key_vg = [&](int v) { return c_vg(v) > 0.0f ? x.vg_free[nv + v] : BIG; };
      float cap_lvm = 0.0f;
      for (int v = 0; v < V; ++v) cap_lvm += c_vg(v);
      if (mats && p.multi_lvm) {
        bool any_used = false;
        float m = BIG;
        for (int v = 0; v < V; ++v) {
          const float a = p.st_live ? x.st_alloc[nv + v] : 0.0f;
          if (!(a > 0.0f)) continue;
          any_used = true;
          m = jmin(m, floor_slots(x.vg_free[nv + v], fmaxf(a, TINY)));
        }
        cap_lvm = any_used ? m : 0.0f;
      }
      if (has_lvm) cap = jmin(cap, cap_lvm);
      fill_order(c_vg, key_vg, V, r.ord_vg + nv, r.cs_vg + nv, r.cum_vg + nv);
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
    r.m_all[n] = m_all ? 1 : 0;
    if ((r.mode & RV_QUOTA) && topo) {
      r.cap[n] = cap;  // K15 lifts t*'s filter and owns the rest
    } else {
      r.cap[n] = m_all ? cap : 0.0f;
    }
  }
  if ((r.mode & RV_QUOTA) && topo) return;
  __syncthreads();

  const int tc = x.tc;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  if ((r.mode & RV_SELF_AFF) && topo) {
    // colocate-with-self bootstrap: no matching pod cluster-wide confines
    // the round to the domain of the best-scoring node with a cap
    int t_star = 0;
    for (int t = tc - 1; t >= 0; --t)
      if (x.s_match[g0 + t] && x.a_aff_req[g0 + t] && terms[t] >= 0) t_star = t;
    float total = 0.0f;
    for (int t = 0; t < tc; ++t)
      if (x.a_aff_req[g0 + t] && terms[t] >= 0) total += x.cnt_total[terms[t]];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int n = tid; n < N; n += nt) argmax_merge(bv, bi, r.cap[n] > 0.0f ? r.s0[n] : NEG, n);
    block_argmax(bv, bi, sh_bv, sh_bi);
    if (total <= 0.0f) {
      const int term = terms[t_star];
      const int* dom = x.node_dom + static_cast<size_t>(term >= 0 ? x.term_topo[term] : 0) * N;
      const int d_star = term >= 0 ? dom[bi] : 0;
      for (int n = tid; n < N; n += nt) {
        const int dn = term >= 0 ? dom[n] : 0;
        if (!(dn == d_star && dn >= 0)) r.cap[n] = 0.0f;
      }
    }
    __syncthreads();
  }

  // pass 3: the raw count rows one pod further on, and their normalizers
  float* raw1 = r.scr + static_cast<size_t>(SC_RAW1) * N;
  float h3 = 0.0f, lo2 = BIG, h4 = -BIG, h5 = 0.0f, h6 = 0.0f;
  if (topo) {
    const TopoScalars sc = topo_scalars(x, g);
    for (int n = tid; n < N; n += nt) {
      bool s_ok, i_ok;
      float raw[N_RAWS];
      topology_node(x, g, n, nullptr, false, false, sc, s_ok, i_ok, raw, true);
      for (int k = 0; k < N_RAWS; ++k) raw1[static_cast<size_t>(k) * N + n] = raw[k];
      if (!r.m_all[n]) continue;
      h3 = fmaxf(h3, fabsf(raw[RAW_IPA]));
      lo2 = fminf(lo2, raw[RAW_SOFT]);
      h4 = fmaxf(h4, raw[RAW_SOFT]);
      h5 = fmaxf(h5, raw[RAW_SS_HOST]);
      h6 = fmaxf(h6, raw[RAW_SS_ZONE]);
    }
    h3 = block_reduce(h3, [](float a, float b) { return fmaxf(a, b); }, sh);
    lo2 = block_reduce(lo2, [](float a, float b) { return fminf(a, b); }, sh);
    h4 = block_reduce(h4, [](float a, float b) { return fmaxf(a, b); }, sh);
    h5 = block_reduce(h5, [](float a, float b) { return fmaxf(a, b); }, sh);
    h6 = block_reduce(h6, [](float a, float b) { return fmaxf(a, b); }, sh);
  }

  // pass 4: the re-score at free - req, the slope and s0
  for (int n = tid; n < N; n += nt) {
    const bool m_all = r.m_all[n];
    ScoreTerms t;
    t.simon = simon_term(dominant_share(x, n, req), lo[0], hi[0]);
    t.node_pref = minmax_norm(x.node_pref[gn + n], lo[1], hi[1]);
    t.taint = taint_term(x.taint_intol[gn + n], hi[2]);
    if (topo) {
      t.ipa = maxabs_term(raw1[n], h3);
      t.soft = inv_minmax(raw1[N + n], lo2, h4);
      t.ss = ss_term(raw1[2 * N + n], raw1[3 * N + n], h5, h6, any_zone);
    } else {
      t.ipa = t.soft = t.ss = 0.0f;
    }
    const float* frow = x.free + static_cast<size_t>(n) * x.r;
    const float fr1[2] = {frow[RES_CPU] - req[RES_CPU], frow[RES_MEMORY] - req[RES_MEMORY]};
    float s1 = compose_score(w_, f, x.tc > 0, resource_base_fr(x, n, req, fr1, w_[0], w_[1]), t,
                             x.static_score[gn + n], x.avoid_pen[gn + n]);
    const float score_ns = r.slope[n];
    r.slope[n] = m_all ? jclip(score_ns - s1, 0.0f, 1e6f) : 0.0f;
    if (!m_all) r.s0[n] = NEG;
  }
}

extern "C" int simtpu_round_score(const StepCtx* ctx, const RoundCtx* r, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > ROUND_THREADS ? ROUND_THREADS : threads);
  round_score_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, *r);
  return launch_status();
}
