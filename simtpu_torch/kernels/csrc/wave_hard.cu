// K10 wave_hard: one hard or heavy same-group run of pods [a, b), placed in
// one launch.
//
// Replaces the JAX package's simtpu/engine/scan.py wavefront_scan (:1796)
// with its hard verifier _wave_verify_hard (:2035-2420), jitted through
// _run_wavefront (:2794), for runs that own a hard term (DoNotSchedule
// skew, required (anti-)affinity) or carry heavy bits (host ports,
// volumes, Open-Local storage, GPU shares). The result is exactly what the
// serial chain K1->(K5)->(K6)->K2->K3->K4 gives pod by pod: the same
// arithmetic (node_stages.cuh, ext_plans.cuh, topology.cuh, scores.cuh) in
// the same order.
//
// Design (wave.cuh's layout): one block of up to 1024 threads, one thread
// per node up to 1024 nodes, each node's carried state in its thread's
// registers: the run-constant stage bits (static mask; ports, volume and
// attach verdicts of the families the run adds nothing to) and the heavy
// families' verdicts, recomputed only at the chosen node after its commit;
// the Simon share and the resource score pair (recomputed where the pod's
// request or the node's free row moved); the Open-Local and GPU verdicts
// and scores (K5's and K6's code reruns at the chosen node only while
// consecutive pods claim alike, whose rows the commit moved); the step's
// raw counts and cascade bits. Staged once per launch in shared memory and written back at the
// end: the group's term columns (term, key slot, interpod row, statics),
// the count rows of the group's terms at every node ([tc, N] cnt_match and
// the four [tc, N] own planes), the node_dom rows of the group's keys, the
// free rows and the run's request rows (each segment where it fits in
// the plan's 200 KB, kernels/cuda.py wave_hard_plan; past that the rest
// is read in place from global memory, through the same code). The
// block's own scratch (the staged columns, 8 words a term column, the
// per-warp minima, 64 a column, the key slots and the pod flags) is
// planned first and, past the budget, moves to a slab of global scratch
// (wave.cuh wave_seg): any number of term columns. g_terms[g] lists distinct terms with
// distinct interpod rows (engine/scan.py _compact_terms, engine/state.py
// interpod_term_index), so each staged row has one column. Each step,
// with one barrier per reduction:
//   A. (only with hard spread) the per-term minimum over the eligible
//      nodes, folded per warp after the previous step's commit;
//   B. the stage byte, the spread and inter-pod filters and raw counts
//      (K2's arithmetic over the staged rows), the cascade bits and every
//      normalizer of K3 (score_norms_block's extremes and the OR) in one
//      fused reduction;
//   C. the score (K3's node_score arithmetic) and the argmax;
// then the commit: the chosen node's owner thread takes the request into
// its free row and the ports, volume, storage and GPU planes (K4's
// arithmetic) and re-evaluates its verdicts; every thread bumps its
// node's staged count rows on each term whose domain it shares with the
// chosen node, in K4's order. cnt_total is written once at the end, one
// bump per placement whose node carries the key, in placement order.
//
// Bound: at the serial path's sizes (N <= 1024, runs of up to 1024 pods)
// a step is two or three barriers around 32 warps' worth of per-node
// stage, term-row and score work on one SM: issue throughput and latency,
// not bytes — the bytes a run must move take well under a microsecond at
// 3.35 TB/s.
#include <algorithm>

#include "ext_plans.cuh"
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"
#include "wave.cuh"

// the launch plan (kernels/cuda.py wave_hard_plan): the scratch segments
// (the columns, the minima, the key slots, the pod flags) in shared memory
// or, past the budget, in the slab (wave.cuh wave_seg); the staged copies
// of state rows at a byte offset into dynamic shared memory, -1 where the
// segment is read in place from global memory
struct HardPlan {
  int kmax;      // key slots
  int off_cols;  // columns: 8 arrays of [tc] words
  int off_mins;  // minima: [2][32][tc] words
  int off_keys;  // key slots [kmax]
  int off_flags; // pod flags [b - a]
  int off_dom;   // node_dom rows of the key slots [kmax][N] i32
  int off_cm;    // cnt_match rows of the columns [tc][N] f32
  int off_free;  // free rows, resource-major [R][N] f32
  int off_req;   // the run's request rows [b - a][R] f32
  int off_own;   // own planes [4][tc][N] f32: cnt_own_anti, cnt_own_aff, w_own_aff_pref, w_own_anti_pref
  int smem;      // dynamic shared bytes
  unsigned char* slab;    // global scratch for the segments past the budget
};

namespace {

// the carried rows of a node (wave.cuh WaveRows)
enum : int {
  H_BITS = 0, H_FSCORE = 1, H_SHARE = 2, H_PREF_RAW = 3, H_TAINT_RAW = 4, H_STATIC = 5, H_AVOID = 6,
  H_ST_OK = 7, H_ST_RAW = 8, H_GPU_OK = 9, H_RAW = 10,  // + N_RAWS
  H_CASCADE = 14,
};
static_assert(static_cast<int>(H_CASCADE) < static_cast<int>(WAVE_ROWS), "K10's rows fit WaveCtx.carry");
// H_BITS: the run-constant stage bits, the heavy families' verdicts,
// whether the node's free row moved in this run
enum : unsigned {
  B_STATIC = 1u, B_PORTS = 2u, B_VOL = 4u, B_ATT = 8u, B_VMASK = 16u,
  B_PORTS_H = 32u, B_VOL_H = 64u, B_ATT_H = 128u, B_TOUCHED = 256u,
};
using NormRed = MinMaxOr<ScoreNorms::N_MIN, ScoreNorms::N_MAX>;
// per-column flags
enum : int { C_SMATCH = 1, C_AFF = 2, C_ANTI = 4, C_SSHOST = 8, C_SSZONE = 16 };
// per-pod flags: the request / the storage claims / the GPU claims equal
// the previous pod's
enum : int { Q_REQ = 1, Q_ST = 2, Q_GPU = 4 };
// phases of a step in the profile build
enum : int {
  P_STAGE = 0, P_FOLD_B = 1, P_SCORE = 2, P_FOLD_C = 3, P_COMMIT = 4, P_FOLD_A = 5, P_SETUP = 6, P_END = 7,
};


template <int NPT, bool SLAB>
__global__ void __launch_bounds__(WAVE_BLOCK, 1) wave_hard_kernel(StepCtx x, WaveCtx w, HardPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned slots_b[32 * NormRed::WORDS];
  __shared__ ArgOrSlot slots_c[32];
  __shared__ float wv[12];
  __shared__ int s_nk;
  WAVE_STAMP_DECL
  const int N = x.n, R = x.r, TC = x.tc;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int nj = NPT > 0 ? NPT : (N + nt - 1) / nt;
  const int g = x.group[w.a];
  const int f = x.flags;
  const int heavy = w.mode >> WAVE_HEAVY_SHIFT;
  const bool heavy_ports = (heavy & HEAVY_PORTS) && (f & F_PORTS);
  const bool heavy_vols = (heavy & HEAVY_VOLS) && (f & (F_VOLS | F_ATTACH));
  const bool vols_live = heavy_vols && (f & F_VOLS);
  const bool att_live = heavy_vols && (f & F_ATTACH);
  const bool do_ip = (f & F_INTERPOD_REQ) && TC > 0;
  const bool planes = (f & F_TOPOLOGY) && TC > 0;
  const size_t g0 = static_cast<size_t>(g) * TC;
  const size_t gn0 = static_cast<size_t>(g) * N;
  const int kmax = p.kmax, pods = w.b - w.a;
  // the column segment
  int* cterm = wave_seg<int, SLAB>(smem, p.slab, p.off_cols);
  int* cip = cterm + TC;
  int* cslot = cip + TC;
  int* cflag = cslot + TC;
  float* cw_aff = reinterpret_cast<float*>(cflag + TC);
  float* cw_anti = cw_aff + TC;
  float* chard = cw_anti + TC;
  float* csoft = chard + TC;
  unsigned* slots_min = wave_seg<unsigned, SLAB>(smem, p.slab, p.off_mins);  // [32][tc] per-warp partial minima (keys)
  float* wmin = reinterpret_cast<float*>(slots_min + 32 * TC);           // [32][tc] each warp's copy of the minima
  int* skey = wave_seg<int, SLAB>(smem, p.slab, p.off_keys);
  int* qflag = wave_seg<int, SLAB>(smem, p.slab, p.off_flags);
  int* sdom = p.off_dom >= 0 ? reinterpret_cast<int*>(smem + p.off_dom) : nullptr;
  float* scm = p.off_cm >= 0 ? reinterpret_cast<float*>(smem + p.off_cm) : nullptr;
  float* sfree = p.off_free >= 0 ? reinterpret_cast<float*>(smem + p.off_free) : nullptr;
  float* sreq = p.off_req >= 0 ? reinterpret_cast<float*>(smem + p.off_req) : nullptr;
  float* sown = p.off_own >= 0 ? reinterpret_cast<float*>(smem + p.off_own) : nullptr;
  float* own_planes[4] = {x.cnt_own_anti, x.cnt_own_aff, x.w_own_aff_pref, x.w_own_anti_pref};
  WaveRows<NPT> S(w, N);
#define FOR_NODES for (int j = 0; j < (NPT > 0 ? NPT : nj); ++j)
#define NODE const int n = tid + j * nt; if (n >= N) continue;
  auto bits_of = [&](int j, int n) { return __float_as_uint(S(H_BITS, j, n)); };
  auto set_bits = [&](int j, int n, unsigned b) { S(H_BITS, j, n) = __uint_as_float(b); };
  auto dom = [&](int kk, int n) {
    return sdom ? sdom[static_cast<size_t>(kk) * N + n] : x.node_dom[static_cast<size_t>(skey[kk]) * N + n];
  };
  auto cm = [&](int t, int n) -> float& {
    return scm ? scm[static_cast<size_t>(t) * N + n] : x.cnt_match[static_cast<size_t>(cterm[t]) * N + n];
  };
  auto own = [&](int q, int t, int n) -> float& {
    return sown ? sown[(static_cast<size_t>(q) * TC + t) * N + n]
                : own_planes[q][static_cast<size_t>(cip[t]) * N + n];
  };
  auto free_row = [&](int n) { return sfree ? sfree + n : x.free + static_cast<size_t>(n) * R; };
  const int fs = sfree ? N : 1;
  auto req_row = [&](int i) {
    return sreq ? sreq + static_cast<size_t>(i - w.a) * R : x.req + static_cast<size_t>(i) * R;
  };

  // -- staged once per launch ----------------------------------------------------
  if (tid == 0) {
    int nk = 0;
    for (int t = 0; t < TC; ++t) {
      const size_t gt = g0 + t;
      const int term = x.g_terms[gt];
      cterm[t] = term;
      cip[t] = term >= 0 ? x.ip_of[term] : -1;
      int kk = -1;
      if (term >= 0) {
        const int k = x.term_topo[term];
        kk = 0;
        while (kk < nk && skey[kk] != k) ++kk;
        if (kk == nk) skey[nk++] = k;
      }
      cslot[t] = kk;
      cflag[t] = (x.s_match[gt] ? C_SMATCH : 0) | (x.a_aff_req[gt] ? C_AFF : 0) |
                 (x.a_anti_req[gt] ? C_ANTI : 0) | (x.ss_host[gt] ? C_SSHOST : 0) | (x.ss_zone[gt] ? C_SSZONE : 0);
      cw_aff[t] = x.w_aff_pref[gt];
      cw_anti[t] = x.w_anti_pref[gt];
      chard[t] = x.spread_hard[gt];
      csoft[t] = x.spread_soft[gt];
    }
    s_nk = nk;
  }
  if (tid < 12) wv[tid] = x.score_w[tid];
  if (sreq)
    for (int q = tid; q < pods * R; q += nt) sreq[q] = x.req[static_cast<size_t>(w.a) * R + q];
  if (sfree)
    for (int q = tid; q < N * R; q += nt) sfree[(q % R) * N + q / R] = x.free[q];
  // which pods claim like the one before them
  for (int q = tid; q < pods; q += nt) {
    const int i = w.a + q;
    int fl = 0;
    if (q > 0) {
      bool same = true;
      for (int r = 0; r < R && same; ++r)
        same = x.req[static_cast<size_t>(i) * R + r] == x.req[static_cast<size_t>(i - 1) * R + r];
      fl |= same ? Q_REQ : 0;
      const unsigned l0 = x.ext_live[i - 1], l1 = x.ext_live[i];
      same = (l0 & LIVE_STORAGE) == (l1 & LIVE_STORAGE);
      for (int c = 0; c < x.l && same; ++c)
        same = x.lvm_size[static_cast<size_t>(i) * x.l + c] == x.lvm_size[static_cast<size_t>(i - 1) * x.l + c] &&
               x.lvm_vg[static_cast<size_t>(i) * x.l + c] == x.lvm_vg[static_cast<size_t>(i - 1) * x.l + c];
      for (int c = 0; c < x.k && same; ++c)
        same = x.dev_size[static_cast<size_t>(i) * x.k + c] == x.dev_size[static_cast<size_t>(i - 1) * x.k + c] &&
               x.dev_media[static_cast<size_t>(i) * x.k + c] == x.dev_media[static_cast<size_t>(i - 1) * x.k + c];
      fl |= same ? Q_ST : 0;
      same = (l0 & LIVE_GPU) == (l1 & LIVE_GPU) && x.gpu_mem[i] == x.gpu_mem[i - 1] &&
             x.gpu_count[i] == x.gpu_count[i - 1];
      for (int d = 0; d < x.gd && same; ++d)
        same = x.gpu_preset[static_cast<size_t>(i) * x.gd + d] == x.gpu_preset[static_cast<size_t>(i - 1) * x.gd + d];
      fl |= same ? Q_GPU : 0;
    }
    qflag[q] = fl;
  }
  __syncthreads();
  const int nk = s_nk;
  if (sdom)
    for (int q = tid; q < nk * N; q += nt) sdom[q] = x.node_dom[static_cast<size_t>(skey[q / N]) * N + q % N];
  if (scm || sown) {
    for (int q = tid; q < TC * N; q += nt) {
      const int t = q / N, n = q % N;
      const int term = cterm[t];
      if (term < 0) continue;
      if (scm) scm[q] = x.cnt_match[static_cast<size_t>(term) * N + n];
      if (sown && cip[t] >= 0)
        for (int o = 0; o < 4; ++o)
          sown[static_cast<size_t>(o) * TC * N + q] = own_planes[o][static_cast<size_t>(cip[t]) * N + n];
    }
  }
  // the hard-spread filter, where the group has a DoNotSchedule column
  // (without one no minimum is read: fold A and its barrier are skipped)
  bool do_spread = false;
  if ((f & F_SPREAD_HARD) && TC > 0)
    for (int t = 0; t < TC; ++t) do_spread = do_spread || (cterm[t] >= 0 && chard[t] > 0.0f);
  // the inter-pod escape's run constants and the starting total
  TopoScalars sc = topo_scalars(x, g);
  bool any_zone = false;
  for (int t = 0; t < TC; ++t) any_zone = any_zone || (cflag[t] & C_SSZONE);
#pragma unroll
  FOR_NODES {
    NODE
    const size_t gn = gn0 + n;
    const bool st = x.static_mask[gn] && x.node_valid[n];
    const bool pok = !(f & F_PORTS) || heavy_ports || ports_free(x, g, n);
    const bool vok = !(f & F_VOLS) || heavy_vols || vols_free(x, g, n);
    const bool aok = !(f & F_ATTACH) || heavy_vols || attach_ok(x, g, n);
    unsigned b = (st ? B_STATIC : 0u) | (pok ? B_PORTS : 0u) | (vok ? B_VOL : 0u) | (aok ? B_ATT : 0u) |
                 (x.vol_mask[gn] ? B_VMASK : 0u);
    if (heavy_ports && ports_free(x, g, n)) b |= B_PORTS_H;
    if (vols_live && vols_free(x, g, n)) b |= B_VOL_H;
    if (att_live && attach_ok(x, g, n)) b |= B_ATT_H;
    set_bits(j, n, b);
    S(H_PREF_RAW, j, n) = x.node_pref[gn];
    S(H_TAINT_RAW, j, n) = x.taint_intol[gn];
    S(H_STATIC, j, n) = x.static_score[gn];
    S(H_AVOID, j, n) = x.avoid_pen[gn];
  }
  __syncthreads();  // the staged rows, before any thread reads another's
  // the hard-spread minimum per column over the eligible nodes (stage
  // bit 0), its warp partials into slots_min; A's barrier follows
  auto fold_min_partials = [&]() {
    for (int t = 0; t < TC; ++t) {
      if (cterm[t] < 0 || !(chard[t] > 0.0f)) continue;
      float v = BIG;
#pragma unroll
      FOR_NODES {
        NODE
        if (!(bits_of(j, n) & B_STATIC) || dom(cslot[t], n) < 0) continue;
        v = fminf(v, cm(t, n) + 0.0f);  // counts are >= 0 (+0.0f folds -0)
      }
      warp_min_slot(v, slots_min + t, TC);
    }
  };
  if (do_spread) {
    fold_min_partials();
    __syncthreads();
  }
  WAVE_STAMP(P_SETUP);

  // -- the run, pod by pod ---------------------------------------------------------
  // the normalizers the score reads (score_norms_block's order: lo simon,
  // node_pref, soft, open-local; hi simon, node_pref, taint, |ipa|, soft,
  // ss host, ss zone, open-local), by the flags
  const bool terms_on = TC > 0;
  const unsigned live_b = 0x11u | ((f & F_NODE_PREF) ? 0x22u : 0u) | ((f & F_TAINT_PREF) ? 0x40u : 0u) |
                          (terms_on && (f & (F_INTERPOD_PREF | F_INTERPOD_REQ)) ? 0x80u : 0u) |
                          (terms_on && (f & F_SPREAD_SOFT) ? 0x104u : 0u) |
                          (terms_on && (f & F_SELECTOR_SPREAD) ? 0x600u : 0u) | ((f & F_STORAGE) ? 0x808u : 0u);
  int prev_c = -1;  // the node the previous pod's commit moved (-1: none)
  for (int i = w.a; i < w.b; ++i) {
    const float* req = req_row(i);
    const unsigned live = x.ext_live[i];
    const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
    const int qf = i > w.a ? qflag[i - w.a] : 0;
    if (do_spread) {
      // A. every warp's copy of the minima
      for (int t = 0; t < TC; ++t) {
        if (cterm[t] < 0 || !(chard[t] > 0.0f)) continue;
        const float v = slot_min(slots_min + t, TC);
        if ((tid & 31) == 0) wmin[warp * TC + t] = v;
      }
      __syncwarp();
      WAVE_STAMP(P_FOLD_A);
    }
    // B. the stage byte, the plans, the term rows and the normalizers
    NormRed nm{{BIG, BIG, BIG, BIG}, {-BIG, -BIG, 0.0f, 0.0f, -BIG, 0.0f, 0.0f, -BIG}, 0u};
#pragma unroll
    FOR_NODES {
      NODE
      const unsigned b = bits_of(j, n);
      // K5 / K6 where the claims or the node's rows moved
      if (st_live && (!(qf & Q_ST) || n == prev_c)) {
        storage_node(x, i, n);
        S(H_ST_OK, j, n) = x.st_ok[n] ? 1.0f : 0.0f;
        S(H_ST_RAW, j, n) = x.st_raw[n];
      }
      if (gpu_live && (!(qf & Q_GPU) || n == prev_c)) {
        gpu_node(x, i, n);
        S(H_GPU_OK, j, n) = x.gpu_ok[n] ? 1.0f : 0.0f;
      }
      const float* fr = free_row(n);
      // the stage byte, bits 0-5 (cumulative)
      bool m = b & B_STATIC;
      unsigned s = m ? 1u : 0u;
      m = m && (b & B_PORTS) && (!heavy_ports || (b & B_PORTS_H));
      s |= (m ? 1u : 0u) << 1;
      m = m && fit_row(fr, fs, req, R);
      s |= (m ? 1u : 0u) << 2;
      m = m && (b & B_VOL) && (!vols_live || (b & B_VOL_H));
      s |= (m ? 1u : 0u) << 3;
      m = m && (b & B_ATT) && (!att_live || (b & B_ATT_H));
      s |= (m ? 1u : 0u) << 4;
      m = m && (b & B_VMASK);
      s |= (m ? 1u : 0u) << 5;
      // the share and the resource pair where the request or the free row moved
      if (!(qf & Q_REQ)) S(H_SHARE, j, n) = dominant_share(x, n, req);
      if (!(qf & Q_REQ) || n == prev_c)
        S(H_FSCORE, j, n) = resource_base_row(x.alloc + static_cast<size_t>(n) * R, fr, fs, req, wv[0], wv[1]);
      // K2 over the staged term rows (topology.cuh topology_node's arithmetic)
      bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
      float ipa_in = 0.0f, ipa_sym = 0.0f, sp = 0.0f, ssh = 0.0f, ssz = 0.0f;
      for (int t = 0; t < TC; ++t) {
        if (cterm[t] < 0) continue;
        const int cf = cflag[t];
        const bool valid = dom(cslot[t], n) >= 0;
        const float c = cm(t, n);
        const bool has_ip = cip[t] >= 0;
        const float ms = chard[t];
        if (do_spread && ms > 0.0f) {
          float mn = wmin[warp * TC + t];
          if (mn >= BIG) mn = 0.0f;
          if (!(valid && (c + 1.0f) - mn <= ms)) spread_ok = false;
        }
        if ((cf & C_ANTI) && c > 0.0f) anti = true;
        if ((cf & C_SMATCH) && has_ip && own(0, t, n) > 0.0f) sym = true;
        if (cf & C_AFF) {
          if (!(valid && c > 0.0f)) aff_ok = false;
          if (!valid) aff_keys = false;
        }
        ipa_in += (cw_aff[t] - cw_anti[t]) * c;
        if ((cf & C_SMATCH) && has_ip) ipa_sym += (own(2, t, n) - own(3, t, n)) + own(1, t, n);
        sp += csoft[t] * c;
        if (cf & C_SSHOST) ssh += c;
        if (cf & C_SSZONE) ssz += c;
      }
      bool ip_ok = true;
      if (do_ip) {
        const bool self_ok = sc.total_match == 0.0f && sc.all_s && aff_keys;
        ip_ok = (aff_ok || (sc.any_aff && self_ok)) && !anti && !sym;
      }
      const float raw_ipa = ipa_in + ipa_sym;
      S(H_RAW + RAW_IPA, j, n) = raw_ipa;
      S(H_RAW + RAW_SOFT, j, n) = sp;
      S(H_RAW + RAW_SS_HOST, j, n) = ssh;
      S(H_RAW + RAW_SS_ZONE, j, n) = ssz;
      // the cascade bits (scores.cuh cascade_bits over the node's verdicts)
      const bool m6 = ((s >> 5) & 1u) && spread_ok;
      const bool m7 = m6 && ip_ok;
      s |= (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u);
      const bool st_ok = S(H_ST_OK, j, n) != 0.0f, gp_ok = S(H_GPU_OK, j, n) != 0.0f;
      const bool ext_ok = (!st_live || st_ok) && (!gpu_live || gp_ok);
      const bool stg = ((s >> 5) & 1u) && (!st_live || st_ok);
      const bool gp = stg && (!gpu_live || gp_ok);
      const unsigned cas = (s & 0x3Fu) | (stg ? 1u << 6 : 0u) | (gp ? 1u << 7 : 0u) |
                           (((s >> 6) & 1u) && ext_ok ? 1u << 8 : 0u) | (((s >> 7) & 1u) && ext_ok ? 1u << 9 : 0u);
      S(H_CASCADE, j, n) = __uint_as_float(cas);
      nm.bits |= cas;
      if (!(cas & CASCADE_ALL)) continue;
      // score_norms_block's extremes
      const float sim = S(H_SHARE, j, n) * MAX_NODE_SCORE;
      nm.lo[0] = fminf(nm.lo[0], sim); nm.hi[0] = fmaxf(nm.hi[0], sim);
      const float np_ = S(H_PREF_RAW, j, n);
      nm.lo[1] = fminf(nm.lo[1], np_); nm.hi[1] = fmaxf(nm.hi[1], np_);
      nm.hi[2] = fmaxf(nm.hi[2], S(H_TAINT_RAW, j, n));
      nm.hi[3] = fmaxf(nm.hi[3], fabsf(raw_ipa));
      nm.lo[2] = fminf(nm.lo[2], sp); nm.hi[4] = fmaxf(nm.hi[4], sp);
      nm.hi[5] = fmaxf(nm.hi[5], ssh);
      nm.hi[6] = fmaxf(nm.hi[6], ssz);
      const float ol = st_live ? S(H_ST_RAW, j, n) : 0.0f;
      nm.lo[3] = fminf(nm.lo[3], ol); nm.hi[7] = fmaxf(nm.hi[7], ol);
    }
    WAVE_STAMP(P_STAGE);
    nm = block_minmax_or(nm, slots_b, live_b);
    WAVE_STAMP(P_FOLD_B);
    // C. the score (scores.cuh node_score's arithmetic) and the argmax
    ArgOr r = ArgOr::identity();
#pragma unroll
    FOR_NODES {
      NODE
      ScoreTerms t;
      t.simon = simon_term(S(H_SHARE, j, n), nm.lo[0], nm.hi[0]);
      t.node_pref = minmax_norm(S(H_PREF_RAW, j, n), nm.lo[1], nm.hi[1]);
      t.taint = taint_term(S(H_TAINT_RAW, j, n), nm.hi[2]);
      t.ipa = maxabs_term(S(H_RAW + RAW_IPA, j, n), nm.hi[3]);
      t.soft = inv_minmax(S(H_RAW + RAW_SOFT, j, n), nm.lo[2], nm.hi[4]);
      t.ss = ss_term(S(H_RAW + RAW_SS_HOST, j, n), S(H_RAW + RAW_SS_ZONE, j, n), nm.hi[5], nm.hi[6], any_zone);
      float s = compose_score(wv, f, TC > 0, S(H_FSCORE, j, n), t, S(H_STATIC, j, n), S(H_AVOID, j, n));
      if (!(__float_as_uint(S(H_CASCADE, j, n)) & CASCADE_ALL)) s = -INFINITY;
      if (f & F_STORAGE) s = __fmaf_rn(wv[10], minmax_norm(st_live ? S(H_ST_RAW, j, n) : 0.0f, nm.lo[3], nm.hi[7]), s);
      r.merge({s, n, 0u});
    }
    WAVE_STAMP(P_SCORE);
    r = block_argmax_or(r, slots_c);
    WAVE_STAMP(P_FOLD_C);
    const int c = r.bi;
    const bool placed = (nm.bits & CASCADE_ALL) != 0u;
    if (tid == 0) {
      x.chosen[i] = c;
      x.placed[i] = placed ? 1 : 0;
      x.reason[i] = placed ? OK : fail_code(nm.bits);
      x.out_node[i] = placed ? c : -1;
    }
    prev_c = placed ? c : -1;
    if (!placed) continue;  // nothing changes
    // the commit (node_stages.cuh commit_node's arithmetic)
#pragma unroll
    FOR_NODES {
      NODE
      if (n == c) {
        float* fr = free_row(n);
        for (int q = 0; q < R; ++q) fr[q * fs] = fr[q * fs] - req[q];
        // a family the run's group claims nothing of adds 0 to every entry
        // (the occupancy counts are never -0): its rows stay as they are
        if (heavy_ports) {
          const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
          float* used = x.ports_used + static_cast<size_t>(c) * x.p_ports;
          for (int q = 0; q < x.p_ports; ++q) used[q] = used[q] + (want[q] ? 1.0f : 0.0f);
        }
        if (heavy_vols) {
          const size_t gw = static_cast<size_t>(g) * x.w, cw = static_cast<size_t>(c) * x.w;
          for (int q = 0; q < x.w; ++q) {
            const bool rw = x.vol_rw_req[gw + q];
            const bool present = rw || x.vol_ro_req[gw + q] || x.vol_att_req[gw + q];
            x.vols_any[cw + q] = x.vols_any[cw + q] + (present ? 1.0f : 0.0f);
            if (f & F_VOLS) x.vols_rw[cw + q] = x.vols_rw[cw + q] + (rw ? 1.0f : 0.0f);
          }
        }
        if ((f & F_STORAGE) && st_live) {
          const size_t cv = static_cast<size_t>(c) * x.v, iv = static_cast<size_t>(i) * x.v;
          for (int v = 0; v < x.v; ++v) {
            const float a = x.st_alloc[cv + v];
            x.vg_free[cv + v] = x.vg_free[cv + v] + (-a);
            x.out_lvm[iv + v] = a;
          }
          const size_t cs = static_cast<size_t>(c) * x.sd, is = static_cast<size_t>(i) * x.sd;
          for (int d = 0; d < x.sd; ++d) {
            const uint8_t take = x.st_take[cs + d];
            x.sdev_free[cs + d] = (x.sdev_free[cs + d] && !take) ? 1 : 0;
            x.out_take[is + d] = take;
          }
        }
        if ((f & F_GPU) && gpu_live) {
          const float mem = x.gpu_mem[i];
          const size_t cg = static_cast<size_t>(c) * x.gd, ig = static_cast<size_t>(i) * x.gd;
          for (int d = 0; d < x.gd; ++d) {
            const float sh = x.gpu_sh[cg + d];
            x.gpu_free[cg + d] = x.gpu_free[cg + d] + (-sh) * mem;
            x.out_gpu[ig + d] = sh;
          }
        }
        // the heavy verdicts against the rows just moved
        unsigned b = bits_of(j, n) & ~(B_PORTS_H | B_VOL_H | B_ATT_H);
        if (heavy_ports && ports_free(x, g, n)) b |= B_PORTS_H;
        if (vols_live && vols_free(x, g, n)) b |= B_VOL_H;
        if (att_live && attach_ok(x, g, n)) b |= B_ATT_H;
        set_bits(j, n, b | B_TOUCHED);
      }
      if (!planes) continue;
      for (int t = 0; t < TC; ++t) {
        if (cterm[t] < 0) continue;
        const int dc = dom(cslot[t], c);
        if (dc < 0 || dom(cslot[t], n) != dc) continue;  // the chosen node misses the key / another domain
        const int cf = cflag[t];
        float& cv = cm(t, n);
        cv = cv + ((cf & C_SMATCH) ? 1.0f : 0.0f);
        if (cip[t] < 0) continue;
        if (f & F_INTERPOD_REQ) {
          own(0, t, n) = own(0, t, n) + ((cf & C_ANTI) ? 1.0f : 0.0f);
          own(1, t, n) = own(1, t, n) + ((cf & C_AFF) ? 1.0f : 0.0f);
        }
        if (f & F_INTERPOD_PREF) {
          own(2, t, n) = own(2, t, n) + cw_aff[t];
          own(3, t, n) = own(3, t, n) + cw_anti[t];
        }
      }
    }
    if (planes) {
      // the inter-pod escape's total (cnt_total itself is written at the end)
      for (int t = 0; t < TC; ++t) {
        if (cterm[t] < 0 || dom(cslot[t], c) < 0) continue;
        const float s = (cflag[t] & C_SMATCH) ? 1.0f : 0.0f;
        if (cflag[t] & C_AFF) sc.total_match += s;
      }
    }
    WAVE_STAMP(P_COMMIT);
    if (do_spread) {
      fold_min_partials();
      __syncthreads();
    }
    WAVE_STAMP_STEP();
  }

  // -- once at the end: the staged rows back to the state planes -------------------
  __syncthreads();
#pragma unroll
  FOR_NODES {
    NODE
    if (sfree && (bits_of(j, n) & B_TOUCHED))
      for (int q = 0; q < R; ++q) x.free[static_cast<size_t>(n) * R + q] = sfree[q * N + n];
    if (!planes) continue;
    for (int t = 0; t < TC; ++t) {
      if (cterm[t] < 0) continue;
      if (scm) x.cnt_match[static_cast<size_t>(cterm[t]) * N + n] = scm[static_cast<size_t>(t) * N + n];
      if (sown && cip[t] >= 0)
        for (int o = 0; o < 4; ++o) own_planes[o][static_cast<size_t>(cip[t]) * N + n] = own(o, t, n);
    }
  }
  if (planes) {
    // cnt_total: one bump per placement whose node carries the key, in
    // placement order (the chosen nodes from the run's outputs)
    for (int t = tid; t < TC; t += nt) {
      const int term = cterm[t];
      if (term < 0) continue;
      const float s = (cflag[t] & C_SMATCH) ? 1.0f : 0.0f;
      float v = x.cnt_total[term];
      for (int i = w.a; i < w.b; ++i) {
        const int c = x.out_node[i];
        if (c >= 0 && dom(cslot[t], c) >= 0) v = v + s;
      }
      x.cnt_total[term] = v;
    }
  }
  WAVE_STAMP(P_END);
  WAVE_STAMP_FLUSH(w);
#undef FOR_NODES
#undef NODE
}

template <int NPT, bool SLAB>
int launch_hard_with(const StepCtx& x, const WaveCtx& w, const HardPlan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(wave_hard_kernel<NPT, SLAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wave_hard_kernel<NPT, SLAB><<<1, wave_threads(x.n), p.smem, stream>>>(x, w, p);
  return launch_status();
}

template <int NPT>
int launch_hard(const StepCtx& x, const WaveCtx& w, const HardPlan& p, cudaStream_t stream) {
  return p.slab ? launch_hard_with<NPT, true>(x, w, p, stream) : launch_hard_with<NPT, false>(x, w, p, stream);
}

}  // namespace

// the wrapper's plan (kernels/cuda.py wave_hard_plan); refused where it
// does not hold every key slot, or a segment past the budget has no slab
extern "C" int simtpu_wave_hard(const StepCtx* ctx, const WaveCtx* w, const HardPlan* p, void* stream) {
  const int n = ctx->n;
  const bool slab_needed = p->off_cols < 0 || p->off_mins < 0 || p->off_keys < 0 || p->off_flags < 0;
  if (p->kmax < std::max(1, std::min(ctx->tc, w->k)) || p->smem < 0 || (slab_needed && !p->slab))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wave_npt(n)) {
    case 1: return launch_hard<1>(*ctx, *w, *p, s);
    case 2: return launch_hard<2>(*ctx, *w, *p, s);
    case WAVE_REG_NPT: return launch_hard<WAVE_REG_NPT>(*ctx, *w, *p, s);
    default: return launch_hard<WAVE_GLOBAL_NPT>(*ctx, *w, *p, s);
  }
}
