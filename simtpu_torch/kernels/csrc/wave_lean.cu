// K9 wave_lean: one lean same-group run of pods [a, b), placed in one launch.
//
// Replaces the JAX package's simtpu/engine/scan.py wavefront_scan (:1796)
// with its lean verifier _wave_verify_lean (:2422-2790), jitted through
// _run_wavefront (:2794). The run owns no hard term (DoNotSchedule skew,
// required (anti-)affinity) and carries no heavy bits (ports, volumes,
// storage, GPU), so every stage but the resource fit is constant over the
// run, and the result is exactly what the serial chain K1->K2->K3->K4
// gives pod by pod (the serial step's arithmetic, scores.cuh).
//
// Design (wave.cuh's layout): one block of up to 1024 threads, one thread
// per node up to 1024 nodes, each node's carried state in its thread's
// registers for the whole run (WAVE_ROWS rows: the stage bits, the
// resource score pair, the normalized static terms, K2's four count raws,
// the static score pair, the run-constant Simon share and node-affinity
// and taint raws). Staged once per launch in shared memory: the group's
// per-key count coefficients and its distinct topology keys, the node_dom
// rows of those keys, the nodes' free rows and the run's request rows.
// As _wave_verify_lean carries them:
// - the fit bit and the resource score pair move only at the chosen node,
//   whose owner thread updates its free row and fit bit in the commit and
//   its resource score at its next score (whose divisions then overlap
//   the other nodes' scores rather than reduction B);
// - m_all and the normalized static terms are refreshed only when a
//   placement flips its node's fit row (one fused reduction);
// - the SelectorSpread masked maxima advance by a scalar max between flips;
// - the count raws: every thread compares its node's ids with the chosen
//   node's (read from the staged rows) and bumps its own raws by the
//   group's per-key coefficients. Counts and preference weights are small
//   integers, so every regrouped sum is float-exact.
// A step is two block-wide reductions, each one barrier (wave.cuh
// block_argmax_or / block_minmax_or: warp-reduce instructions on
// order-preserving keys, per-warp slots double-buffered across the two):
//   A. score, argmax (lowest index on ties), the OR of the cascade bits
//      for the reason and the feasibility bit;
//   B. after the commit: the next step's soft-spread min/max and inter-pod
//      max |raw| over m_all, the chosen node's SelectorSpread raws and the
//      flip flag; a flip adds the refresh's reduction (C).
// A pod that finds no node leaves the state as it was, so every later pod
// of the run fails alike: their outputs are written at once. The count
// planes (cnt_match, cnt_total and the own planes) are written once at the
// end: each thread replays the run's chosen nodes against its node's ids
// and adds each entry's increment as often as K4 would have, in K4's
// order, so the planes equal the serial commit's bit for bit; the free
// rows of the chosen nodes are written back.
//
// Bound: at the serial path's sizes (N <= 1024, runs of up to 1024 pods)
// a step is two barriers (77 cycles each at 1024 threads on the H100)
// around 32 warps' worth of per-node work on one SM's four schedulers:
// issue throughput and latency, not bytes — the bytes a run must move
// (the group's rows and the state planes it reads and writes once) take
// well under a microsecond at 3.35 TB/s.
#include <algorithm>

#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"
#include "wave.cuh"

namespace {

// stage bits per node (ROW_BITS)
enum : unsigned {
  B_STATIC = 1u, B_PORTS = 2u, B_VOL = 4u, B_ATT = 8u, B_VMASK = 16u, B_IP = 32u,
  B_FIT = 64u, B_ALL = 128u, B_TOUCHED = 256u, B_STALE = 512u,
};
constexpr unsigned B_NOFIT = B_PORTS | B_VOL | B_ATT | B_VMASK | B_IP;
// the feasibility bit of step reduction A (above the nine cascade bits)
constexpr unsigned A_FEASIBLE = 1u << 10;
// phases of a step in the profile build
enum : int {
  P_SCORE = 0, P_FOLD_A = 1, P_COMMIT = 2, P_FOLD_B = 3, P_REFRESH = 4, P_SETUP = 5, P_END = 6, P_REFRESHES = 7,
};

// the launch plan (wave.cuh SmemPlan): byte offsets into dynamic shared
// memory, -1 where the segment stays in global memory
struct LeanPlan {
  int kmax;      // key slots
  int off_misc;  // coef [N_RAWS][kmax] f32, keys [kmax] i32, chosen [b - a] i32
  int off_dom;   // node_dom rows of the key slots [kmax][N] i32
  int off_free;  // free rows, resource-major [R][N] f32
  int off_req;   // the run's request rows [b - a][R] f32
};

template <int NPT>
__global__ void __launch_bounds__(WAVE_BLOCK, 1) wave_lean_kernel(StepCtx x, WaveCtx w, LeanPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ArgOrSlot slots_a[32];
  // soft min | soft max, |ipa| max, the chosen node's SS host and zone raws; flip
  __shared__ unsigned slots_b[32 * MinMaxOr<1, 4>::WORDS];
  __shared__ unsigned slots_c[32 * MinMaxOr<2, 6>::WORDS];  // the refresh
  __shared__ int s_nk;
  __shared__ float wv[12];  // the score weights
  WAVE_STAMP_DECL
  const int N = x.n, R = x.r;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nj = NPT > 0 ? NPT : (N + nt - 1) / nt;
  const int g = x.group[w.a];
  const int f = x.flags;
  const int tc = (f & F_TOPOLOGY) ? x.tc : 0;
  const bool has_ss = tc > 0 && (f & F_SELECTOR_SPREAD);
  const bool has_soft = tc > 0 && (f & F_SPREAD_SOFT);
  const bool pref = w.mode & WAVE_PREF;
  const size_t g0 = static_cast<size_t>(g) * x.tc;
  const size_t gn0 = static_cast<size_t>(g) * N;
  const int kmax = p.kmax;
  float* coef = reinterpret_cast<float*>(smem + p.off_misc);  // [N_RAWS][kmax]
  int* skey = reinterpret_cast<int*>(coef + N_RAWS * kmax);   // [kmax]
  int* schosen = skey + kmax;                                  // [b - a]
  int* sdom = p.off_dom >= 0 ? reinterpret_cast<int*>(smem + p.off_dom) : nullptr;
  float* sfree = p.off_free >= 0 ? reinterpret_cast<float*>(smem + p.off_free) : nullptr;
  float* sreq = p.off_req >= 0 ? reinterpret_cast<float*>(smem + p.off_req) : nullptr;
  WaveRows<NPT> S(w, N);
#define FOR_NODES for (int j = 0; j < (NPT > 0 ? NPT : nj); ++j)
#define NODE const int n = tid + j * nt; if (n >= N) continue;
  auto bits_of = [&](int j, int n) { return __float_as_uint(S(ROW_BITS, j, n)); };
  auto set_bits = [&](int j, int n, unsigned b) { S(ROW_BITS, j, n) = __uint_as_float(b); };
  // node_dom of key slot kk at node n, the free row of node n (its stride)
  auto dom = [&](int kk, int n) {
    return sdom ? sdom[static_cast<size_t>(kk) * N + n] : x.node_dom[static_cast<size_t>(skey[kk]) * N + n];
  };
  auto free_row = [&](int n) { return sfree ? sfree + n : x.free + static_cast<size_t>(n) * R; };
  const int fs = sfree ? N : 1;
  auto req_row = [&](int i) {
    return sreq ? sreq + static_cast<size_t>(i - w.a) * R : x.req + static_cast<size_t>(i) * R;
  };

  // -- staged once per launch --------------------------------------------------
  if (tid == 0) {
    // the group's distinct topology keys and what one placement adds to a
    // node's raws per key it shares with the chosen node (an inter-pod
    // preference bumps the incoming count and the symmetric owner weight
    // alike: hence 2x)
    int nk = 0;
    for (int t = 0; t < x.tc; ++t) {
      const int term = x.g_terms[g0 + t];
      if (term < 0) continue;
      const int k = x.term_topo[term];
      int kk = 0;
      while (kk < nk && skey[kk] != k) ++kk;
      if (kk == nk) {
        skey[nk++] = k;
        for (int v = 0; v < N_RAWS; ++v) coef[v * kmax + kk] = 0.0f;
      }
      const float s = x.s_match[g0 + t] ? 1.0f : 0.0f;
      coef[RAW_IPA * kmax + kk] += 2.0f * (x.w_aff_pref[g0 + t] - x.w_anti_pref[g0 + t]) * s;
      coef[RAW_SOFT * kmax + kk] += x.spread_soft[g0 + t] * s;
      coef[RAW_SS_HOST * kmax + kk] += (x.ss_host[g0 + t] ? 1.0f : 0.0f) * s;
      coef[RAW_SS_ZONE * kmax + kk] += (x.ss_zone[g0 + t] ? 1.0f : 0.0f) * s;
    }
    s_nk = nk;
  }
  if (tid < 12) wv[tid] = x.score_w[tid];
  if (sreq)
    for (int q = tid; q < (w.b - w.a) * R; q += nt) sreq[q] = x.req[static_cast<size_t>(w.a) * R + q];
  if (sfree)
    for (int q = tid; q < N * R; q += nt) sfree[(q % R) * N + q / R] = x.free[q];
  __syncthreads();
  const int nk = s_nk;
  if (sdom)
    for (int q = tid; q < nk * N; q += nt) sdom[q] = x.node_dom[static_cast<size_t>(skey[q / N]) * N + q % N];
  bool any_zone = false;
  for (int t = 0; t < x.tc; ++t) any_zone = any_zone || x.ss_zone[g0 + t];
  {
    const float* req0 = req_row(w.a);
    const TopoScalars sc = topo_scalars(x, g);
    const bool do_ip = (f & F_INTERPOD_REQ) && x.tc > 0;
#pragma unroll
    FOR_NODES {
      NODE
      const size_t gn = gn0 + n;
      const bool st = x.static_mask[gn] && x.node_valid[n];
      const bool mp = st && (!(f & F_PORTS) || ports_free(x, g, n));
      const bool vol_ok = !(f & F_VOLS) || vols_free(x, g, n);
      const bool att = !(f & F_ATTACH) || attach_ok(x, g, n);
      bool spread_ok, ip_ok;
      float raw[N_RAWS];
      topology_node(x, g, n, nullptr, false, do_ip, sc, spread_ok, ip_ok, raw);
      const bool fit = res_fit(x, req0, n);
      unsigned b = (st ? B_STATIC : 0u) | (mp ? B_PORTS : 0u) | (vol_ok ? B_VOL : 0u) |
                   (att ? B_ATT : 0u) | (x.vol_mask[gn] ? B_VMASK : 0u) | (ip_ok ? B_IP : 0u) |
                   (fit ? B_FIT : 0u);
      if ((b & B_NOFIT) == B_NOFIT && fit) b |= B_ALL;
      set_bits(j, n, b);
      S(ROW_FSCORE, j, n) = resource_base(x, n, req0, wv[0], wv[1]);
      for (int v = 0; v < N_RAWS; ++v) S(ROW_RAW + v, j, n) = raw[v];
      S(ROW_STATIC, j, n) = x.static_score[gn];
      S(ROW_AVOID, j, n) = x.avoid_pen[gn];
      S(ROW_SHARE, j, n) = dominant_share(x, n, req0);
      S(ROW_PREF_RAW, j, n) = x.node_pref[gn];
      S(ROW_TAINT_RAW, j, n) = x.taint_intol[gn];
    }
  }
  __syncthreads();

  // the carries that depend on m_all alone: the normalized static terms,
  // the constant-raw inter-pod term and the SelectorSpread maxima (one
  // reduction)
  float max_h = 0.0f, max_z = 0.0f;
  // min: simon, node_pref; max: simon, node_pref, taint, |ipa|, ss host, ss zone
  const MinMaxOr<2, 6> ident_c{{BIG, BIG}, {-BIG, -BIG, 0.0f, 0.0f, 0.0f, 0.0f}, 0u};
  const unsigned live_c = has_ss ? 0xFFu : 0x3Fu;
  auto refresh = [&]() {
    MinMaxOr<2, 6> m = ident_c;
#pragma unroll
    FOR_NODES {
      NODE
      if (!(bits_of(j, n) & B_ALL)) continue;
      const float sim = S(ROW_SHARE, j, n) * MAX_NODE_SCORE;
      m.lo[0] = fminf(m.lo[0], sim); m.hi[0] = fmaxf(m.hi[0], sim);
      const float np_ = S(ROW_PREF_RAW, j, n);
      m.lo[1] = fminf(m.lo[1], np_); m.hi[1] = fmaxf(m.hi[1], np_);
      m.hi[2] = fmaxf(m.hi[2], S(ROW_TAINT_RAW, j, n));
      m.hi[3] = fmaxf(m.hi[3], fabsf(S(ROW_RAW + RAW_IPA, j, n)));
      if (has_ss) {
        m.hi[4] = fmaxf(m.hi[4], S(ROW_RAW + RAW_SS_HOST, j, n));
        m.hi[5] = fmaxf(m.hi[5], S(ROW_RAW + RAW_SS_ZONE, j, n));
      }
    }
    m = block_minmax_or(m, slots_c, live_c);
#pragma unroll
    FOR_NODES {
      NODE
      S(ROW_SIMON, j, n) = simon_term(S(ROW_SHARE, j, n), m.lo[0], m.hi[0]);
      S(ROW_NODE_PREF, j, n) = minmax_norm(S(ROW_PREF_RAW, j, n), m.lo[1], m.hi[1]);
      S(ROW_TAINT, j, n) = taint_term(S(ROW_TAINT_RAW, j, n), m.hi[2]);
      S(ROW_IPA, j, n) = maxabs_term(S(ROW_RAW + RAW_IPA, j, n), m.hi[3]);
    }
    max_h = m.hi[4];
    max_z = m.hi[5];
  };
  // reduction B: the extremes of the raws that move every step over
  // m_all, the chosen node's SelectorSpread raws (from its owner) and the
  // flip flag
  const MinMaxOr<1, 4> ident_b{{BIG}, {-BIG, 0.0f, -BIG, -BIG}, 0u};
  const unsigned live_b = (has_soft ? 3u : 0u) | (pref ? 4u : 0u) | (has_ss ? 24u : 0u);
  auto fold_b = [&](int c, bool flip) {
    MinMaxOr<1, 4> m = ident_b;
#pragma unroll
    FOR_NODES {
      NODE
      if (n == c) {
        m.hi[2] = S(ROW_RAW + RAW_SS_HOST, j, n);
        m.hi[3] = S(ROW_RAW + RAW_SS_ZONE, j, n);
      }
      if (!(bits_of(j, n) & B_ALL)) continue;
      const float sp = S(ROW_RAW + RAW_SOFT, j, n);
      m.lo[0] = fminf(m.lo[0], sp); m.hi[0] = fmaxf(m.hi[0], sp);
      m.hi[1] = fmaxf(m.hi[1], fabsf(S(ROW_RAW + RAW_IPA, j, n)));
    }
    m.bits = flip ? 1u : 0u;
    return block_minmax_or(m, slots_b, live_b);
  };
  refresh();
  MinMaxOr<1, 4> ext = fold_b(-1, false);
  WAVE_STAMP(P_SETUP);

  // -- the run, pod by pod -------------------------------------------------------
  int placed_n = 0;
  for (int i = w.a; i < w.b; ++i) {
    // A. the score, the argmax and the cascade bits (storage, GPU and
    // spread are the bind stage for a lean pod)
    ArgOr r = ArgOr::identity();
#pragma unroll
    FOR_NODES {
      NODE
      const unsigned b = bits_of(j, n);
      const bool st = b & B_STATIC, mp = b & B_PORTS;
      const bool res = mp && (b & B_FIT);
      const bool vol = res && (b & B_VOL);
      const bool att = vol && (b & B_ATT);
      const bool bind = att && (b & B_VMASK);
      r.bits |= (st ? 1u : 0u) | (mp ? 2u : 0u) | (res ? 4u : 0u) | (vol ? 8u : 0u) | (att ? 16u : 0u) |
                (bind ? 0x1E0u : 0u) | ((b & B_ALL) ? A_FEASIBLE : 0u);
      if (b & B_STALE) {
        // the previous pod's commit moved this node's free row
        S(ROW_FSCORE, j, n) = resource_base_row(x.alloc + static_cast<size_t>(n) * R, free_row(n), fs,
                                                req_row(i - 1), wv[0], wv[1]);
        set_bits(j, n, b & ~B_STALE);
      }
      ScoreTerms t;
      t.simon = S(ROW_SIMON, j, n);
      t.node_pref = S(ROW_NODE_PREF, j, n);
      t.taint = S(ROW_TAINT, j, n);
      t.ipa = pref ? maxabs_term(S(ROW_RAW + RAW_IPA, j, n), ext.hi[1]) : S(ROW_IPA, j, n);
      t.soft = has_soft ? inv_minmax(S(ROW_RAW + RAW_SOFT, j, n), ext.lo[0], ext.hi[0]) : 0.0f;
      t.ss = has_ss ? ss_term(S(ROW_RAW + RAW_SS_HOST, j, n), S(ROW_RAW + RAW_SS_ZONE, j, n), max_h, max_z,
                              any_zone)
                    : 0.0f;
      float s = compose_score(wv, f, x.tc > 0, S(ROW_FSCORE, j, n), t, S(ROW_STATIC, j, n),
                              S(ROW_AVOID, j, n));
      if (!(b & B_ALL)) s = -INFINITY;
      r.merge({s, n, 0u});
    }
    WAVE_STAMP(P_SCORE);
    r = block_argmax_or(r, slots_a);
    WAVE_STAMP(P_FOLD_A);
    const int c = r.bi;
    const bool placed = r.bits & A_FEASIBLE;
    if (!placed) {
      // nothing changes: this pod and every later one fail alike
      const int reason = fail_code(r.bits);
      for (int q = i + tid; q < w.b; q += nt) {
        x.chosen[q] = c;
        x.placed[q] = 0;
        x.reason[q] = reason;
        x.out_node[q] = -1;
      }
      break;
    }
    if (tid == 0) {
      x.chosen[i] = c;
      x.placed[i] = 1;
      x.reason[i] = OK;
      x.out_node[i] = c;
      schosen[placed_n] = c;
    }
    ++placed_n;
    // the commit: every node's raws on each key whose domain it shares
    // with the chosen node; the chosen node's free row, fit bit and score
    // at its owner
    const float* req = req_row(i);
    bool flip = false;
#pragma unroll
    FOR_NODES {
      NODE
      for (int kk = 0; kk < nk; ++kk) {
        const int dc = dom(kk, c);
        if (dc < 0 || dom(kk, n) != dc) continue;
        for (int v = 0; v < N_RAWS; ++v) S(ROW_RAW + v, j, n) += coef[v * kmax + kk];
      }
      if (n != c) continue;
      float* fr = free_row(n);
      for (int q = 0; q < R; ++q) fr[q * fs] = fr[q * fs] - req[q];
      const unsigned b = bits_of(j, n);
      const bool fit = fit_row(fr, fs, req, R);
      const bool all = (b & B_NOFIT) == B_NOFIT && fit;
      // the resource pair waits for the owner's next score (B_STALE): its
      // divisions then overlap the other nodes' scores, not reduction B
      set_bits(j, n, (b & ~(B_FIT | B_ALL)) | (fit ? B_FIT : 0u) | (all ? B_ALL : 0u) | B_TOUCHED | B_STALE);
      flip = fit != ((b & B_FIT) != 0u);
    }
    WAVE_STAMP(P_COMMIT);
    // B. the next step's extremes, the chosen node's SelectorSpread raws
    // and the flip
    ext = fold_b(c, flip);
    WAVE_STAMP(P_FOLD_B);
    if (ext.bits) {
      refresh();
      WAVE_STAMP(P_REFRESH);
      WAVE_COUNT(P_REFRESHES);
    } else if (has_ss) {
      max_h = fmaxf(max_h, ext.hi[2]);
      max_z = fmaxf(max_z, ext.hi[3]);
    }
    WAVE_STAMP_STEP();
  }

  // -- once at the end: the free rows of the chosen nodes and the count
  // planes, each entry bumped as often as K4's commits would have bumped it
  if (placed_n > 0) {
    const bool planes = (f & F_TOPOLOGY) && x.tc > 0;
#pragma unroll
    FOR_NODES {
      NODE
      if (sfree && (bits_of(j, n) & B_TOUCHED))
        for (int q = 0; q < R; ++q) x.free[static_cast<size_t>(n) * R + q] = sfree[q * N + n];
      if (!planes) continue;
      for (int t = 0; t < x.tc; ++t) {
        const int term = x.g_terms[g0 + t];
        if (term < 0) continue;
        int kk = 0;
        while (skey[kk] != x.term_topo[term]) ++kk;
        const int dn = dom(kk, n);
        int hits = 0;
        for (int q = 0; q < placed_n; ++q) {
          const int dc = dom(kk, schosen[q]);
          hits += (dc >= 0 && dn == dc) ? 1 : 0;
        }
        if (hits == 0) continue;
        const size_t gt = g0 + t;
        const float s = x.s_match[gt] ? 1.0f : 0.0f;
        float* cm = x.cnt_match + static_cast<size_t>(term) * N + n;
        float v = *cm;
        for (int h = 0; h < hits; ++h) v = v + s;
        *cm = v;
        const int ip = x.ip_of[term];
        if (ip < 0) continue;
        const size_t ipn = static_cast<size_t>(ip) * N + n;
        if (f & F_INTERPOD_REQ) {
          float oa = x.cnt_own_anti[ipn], of = x.cnt_own_aff[ipn];
          const float da = x.a_anti_req[gt] ? 1.0f : 0.0f, df = x.a_aff_req[gt] ? 1.0f : 0.0f;
          for (int h = 0; h < hits; ++h) { oa = oa + da; of = of + df; }
          x.cnt_own_anti[ipn] = oa;
          x.cnt_own_aff[ipn] = of;
        }
        if (f & F_INTERPOD_PREF) {
          float wa = x.w_own_aff_pref[ipn], wn = x.w_own_anti_pref[ipn];
          for (int h = 0; h < hits; ++h) { wa = wa + x.w_aff_pref[gt]; wn = wn + x.w_anti_pref[gt]; }
          x.w_own_aff_pref[ipn] = wa;
          x.w_own_anti_pref[ipn] = wn;
        }
      }
    }
    if (planes) {
      // cnt_total: one bump per placement whose node carries the key
      for (int t = tid; t < x.tc; t += nt) {
        const int term = x.g_terms[g0 + t];
        if (term < 0) continue;
        int kk = 0;
        while (skey[kk] != x.term_topo[term]) ++kk;
        const float s = x.s_match[g0 + t] ? 1.0f : 0.0f;
        float v = x.cnt_total[term];
        for (int q = 0; q < placed_n; ++q)
          if (dom(kk, schosen[q]) >= 0) v = v + s;
        x.cnt_total[term] = v;
      }
    }
  }
  WAVE_STAMP(P_END);
  WAVE_STAMP_FLUSH(w);
#undef FOR_NODES
#undef NODE
}

template <int NPT>
int launch_lean(const StepCtx& x, const WaveCtx& w, const LeanPlan& p, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(wave_lean_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wave_lean_kernel<NPT><<<1, wave_threads(x.n), smem, stream>>>(x, w, p);
  return launch_status();
}

}  // namespace

extern "C" int simtpu_wave_lean(const StepCtx* ctx, const WaveCtx* w, void* stream) {
  const int n = ctx->n, r = ctx->r, pods = w->b - w->a;
  LeanPlan p{};
  p.kmax = std::max(1, std::min(ctx->tc, w->k));
  SmemPlan plan;
  p.off_misc = plan.add(static_cast<size_t>(N_RAWS + 1) * p.kmax * 4 + static_cast<size_t>(pods) * 4, true);
  p.off_dom = plan.add(static_cast<size_t>(p.kmax) * n * 4);
  p.off_free = plan.add(static_cast<size_t>(r) * n * 4);
  p.off_req = plan.add(static_cast<size_t>(pods) * r * 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wave_npt(n)) {
    case 1: return launch_lean<1>(*ctx, *w, p, plan.used, s);
    case 2: return launch_lean<2>(*ctx, *w, p, plan.used, s);
    case WAVE_REG_NPT: return launch_lean<WAVE_REG_NPT>(*ctx, *w, p, plan.used, s);
    default: return launch_lean<WAVE_GLOBAL_NPT>(*ctx, *w, p, plan.used, s);
  }
}

#ifdef SIMTPU_WAVE_PROFILE
// The profile build's yardstick: the cycles of `iters` back-to-back block
// barriers in a block of `threads` threads (thread 0's clock64()).
__global__ void wave_barrier_kernel(int iters, long long* out) {
  __syncthreads();
  const long long t0 = clock64();
  for (int q = 0; q < iters; ++q) __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) *out = t1 - t0;
}

extern "C" int simtpu_wave_barrier_cycles(int threads, int iters, long long* out, void* stream) {
  wave_barrier_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(iters, out);
  return launch_status();
}
#endif
