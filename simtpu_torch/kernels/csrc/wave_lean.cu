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
// Design: one block of up to WAVE_THREADS threads, persistent over the
// run's pods, threads striding over the nodes. Once per launch it stages
// the group's per-key count coefficients and the run-constant stage bits
// (static, ports, volumes, attach, bind, the run-constant inter-pod
// filter), the fit mask, the resource score pair and K2's four count raws
// of the run's start. It then carries, as _wave_verify_lean does:
// - the fit mask and the resource score pair, recomputed only at the node
//   the previous placement touched (the kernels are row-independent);
// - m_all and the normalized static terms (Simon, node affinity, taint and,
//   without the `pref` carry, the inter-pod term), refreshed only when a
//   placement flips its node's fit row;
// - the SelectorSpread masked maxima, advanced by a scalar max between
//   flips (the chosen node stays feasible; max is order-free);
// - the count raws: K2's four raw rows, bumped at each commit by the
//   group's per-key coefficients (dynamic shared memory, [N_RAWS][K]) on
//   every node that shares a key's domain with the chosen node. Counts and
//   preference weights are small integers, so every regrouped sum is
//   float-exact, for any number of keys of any kind.
// Each step: a masked min/max pass (soft spread, and the inter-pod max
// |raw| with `pref`), a score pass with the argmax (lowest index on
// ties) and the OR of the cascade bits for the reason, then the commit
// (node_stages.cuh commit_node: free and the count planes, in place), the
// chosen node's row update, and the refresh when its fit row flipped.
//
// Bound: at the serial path's sizes (N <= 1024, runs of up to 1024 pods)
// each step is a few block-wide passes over N nodes separated by
// barriers: latency, not bytes — the bytes a run must move (the group's
// rows and the state planes it reads and writes once) take well under a
// microsecond at 3.35 TB/s.
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"

namespace {

// bits of WaveCtx.bits per node
enum : unsigned {
  B_STATIC = 1u, B_PORTS = 2u, B_VOL = 4u, B_ATT = 8u, B_VMASK = 16u, B_IP = 32u,
  B_FIT = 64u, B_ALL = 128u,
};
constexpr unsigned B_NOFIT = B_PORTS | B_VOL | B_ATT | B_VMASK | B_IP;

// block-wide min over lo[NL] and max over hi[NH]; every thread gets the
// result; ends with a barrier
template <int NL, int NH>
__device__ void block_minmax(float (&lo)[NL], float (&hi)[NH]) {
  __shared__ float s_lo[32][NL];
  __shared__ float s_hi[32][NH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < NL; ++k) lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
    for (int k = 0; k < NH; ++k) hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
  }
  if (lane == 0) {
    for (int k = 0; k < NL; ++k) s_lo[warp][k] = lo[k];
    for (int k = 0; k < NH; ++k) s_hi[warp][k] = hi[k];
  }
  __syncthreads();
  for (int k = 0; k < NL; ++k) {
    lo[k] = s_lo[0][k];
    for (int w = 1; w < n_warps; ++w) lo[k] = fminf(lo[k], s_lo[w][k]);
  }
  for (int k = 0; k < NH; ++k) {
    hi[k] = s_hi[0][k];
    for (int w = 1; w < n_warps; ++w) hi[k] = fmaxf(hi[k], s_hi[w][k]);
  }
  __syncthreads();
}

// block-wide OR; every thread gets the result; ends with a barrier
__device__ unsigned block_or(unsigned v) {
  __shared__ unsigned s_or[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = __reduce_or_sync(0xffffffffu, v);
  if (lane == 0) s_or[warp] = v;
  __syncthreads();
  v = 0u;
  for (int w = 0; w < n_warps; ++w) v |= s_or[w];
  __syncthreads();
  return v;
}

}  // namespace

__global__ void __launch_bounds__(WAVE_THREADS) wave_lean_kernel(StepCtx x, WaveCtx w) {
  extern __shared__ float coef[];  // [N_RAWS][K] the group's per-key count coefficients
  __shared__ float sh_bv[32];
  __shared__ int sh_bi[32];
  __shared__ int s_feasible, s_chosen, s_placed, s_flip;
  __shared__ float s_max_h, s_max_z;
  const int N = x.n, K = w.k;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = x.group[w.a];
  const int f = x.flags;
  const int tc = (f & F_TOPOLOGY) ? x.tc : 0;
  const bool has_ss = tc > 0 && (f & F_SELECTOR_SPREAD);
  const bool has_soft = tc > 0 && (f & F_SPREAD_SOFT);
  const bool has_ip = tc > 0 && (f & (F_INTERPOD_REQ | F_INTERPOD_PREF));
  const bool pref = w.mode & WAVE_PREF;
  const float* w_ = x.score_w;
  const float* req0 = x.req + static_cast<size_t>(w.a) * x.r;
  const size_t g0 = static_cast<size_t>(g) * x.tc;
  const size_t gn0 = static_cast<size_t>(g) * N;
  float* carry = w.carry;
  auto row = [&](int r, int n) -> float& { return carry[static_cast<size_t>(r) * N + n]; };
  // raw v (K2's raw order) at node n, as the carry stands
  auto raw_at = [&](int v, int n) -> float { return row(ROW_RAW + v, n); };

  // -- staged once per launch ------------------------------------------------
  for (int j = tid; j < N_RAWS * K; j += nt) coef[j] = 0.0f;
  __syncthreads();
  if (tid == 0) {
    // what one placement adds to a node's raws per key it shares with the
    // chosen node (an inter-pod preference bumps the incoming count and
    // the symmetric owner weight alike: hence 2x)
    const int* terms = x.g_terms + g0;
    for (int t = 0; t < x.tc; ++t) {
      const int term = terms[t];
      if (term < 0) continue;
      const int k = x.term_topo[term];
      const float s = x.s_match[g0 + t] ? 1.0f : 0.0f;
      coef[RAW_IPA * K + k] += 2.0f * (x.w_aff_pref[g0 + t] - x.w_anti_pref[g0 + t]) * s;
      coef[RAW_SOFT * K + k] += x.spread_soft[g0 + t] * s;
      coef[RAW_SS_HOST * K + k] += (x.ss_host[g0 + t] ? 1.0f : 0.0f) * s;
      coef[RAW_SS_ZONE * K + k] += (x.ss_zone[g0 + t] ? 1.0f : 0.0f) * s;
    }
  }
  bool any_zone = false;
  for (int t = 0; t < x.tc; ++t) any_zone = any_zone || x.ss_zone[g0 + t];
  {
    const TopoScalars sc = topo_scalars(x, g);
    const bool do_ip = (f & F_INTERPOD_REQ) && x.tc > 0;
    for (int n = tid; n < N; n += nt) {
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
      w.bits[n] = static_cast<uint8_t>(b);
      row(ROW_FSCORE, n) = resource_base(x, n, req0, w_[0], w_[1]);
      for (int v = 0; v < N_RAWS; ++v) row(ROW_RAW + v, n) = raw[v];
    }
  }
  __syncthreads();

  // the carries that depend on m_all alone: the normalized static terms,
  // the constant-raw inter-pod term, feasibility, the SelectorSpread maxima
  auto refresh = [&]() {
    float lo[2] = {BIG, BIG};                          // simon, node_pref
    float hi[6] = {-BIG, -BIG, 0.0f, 0.0f, 0.0f, 0.0f};  // simon, node_pref, taint, |ipa|, ss host, ss zone
    unsigned any = 0u;
    for (int n = tid; n < N; n += nt) {
      if (!(w.bits[n] & B_ALL)) continue;
      any = 1u;
      const float sim = dominant_share(x, n, req0) * MAX_NODE_SCORE;
      lo[0] = fminf(lo[0], sim); hi[0] = fmaxf(hi[0], sim);
      const float np_ = x.node_pref[gn0 + n];
      lo[1] = fminf(lo[1], np_); hi[1] = fmaxf(hi[1], np_);
      hi[2] = fmaxf(hi[2], x.taint_intol[gn0 + n]);
      hi[3] = fmaxf(hi[3], fabsf(raw_at(RAW_IPA, n)));
      if (has_ss) {
        hi[4] = fmaxf(hi[4], raw_at(RAW_SS_HOST, n));
        hi[5] = fmaxf(hi[5], raw_at(RAW_SS_ZONE, n));
      }
    }
    block_minmax(lo, hi);
    any = block_or(any);
    for (int n = tid; n < N; n += nt) {
      row(ROW_SIMON, n) = simon_term(dominant_share(x, n, req0), lo[0], hi[0]);
      row(ROW_NODE_PREF, n) = minmax_norm(x.node_pref[gn0 + n], lo[1], hi[1]);
      row(ROW_TAINT, n) = taint_term(x.taint_intol[gn0 + n], hi[2]);
      row(ROW_IPA, n) = maxabs_term(raw_at(RAW_IPA, n), hi[3]);
    }
    if (tid == 0) {
      s_feasible = any != 0u;
      s_max_h = hi[4];
      s_max_z = hi[5];
    }
    __syncthreads();
  };
  refresh();

  // -- the run, pod by pod -------------------------------------------------------
  for (int i = w.a; i < w.b; ++i) {
    const float* req = x.req + static_cast<size_t>(i) * x.r;
    // the masked extremes of the raws that move every step
    float lo_s[1] = {BIG};
    float hi_s[2] = {-BIG, 0.0f};  // soft spread max, |ipa| max
    if (has_soft || (has_ip && pref)) {
      for (int n = tid; n < N; n += nt) {
        if (!(w.bits[n] & B_ALL)) continue;
        if (has_soft) {
          const float sp = raw_at(RAW_SOFT, n);
          lo_s[0] = fminf(lo_s[0], sp); hi_s[0] = fmaxf(hi_s[0], sp);
        }
        if (has_ip && pref) hi_s[1] = fmaxf(hi_s[1], fabsf(raw_at(RAW_IPA, n)));
      }
      block_minmax(lo_s, hi_s);
    }
    // the score, the argmax and the cascade bits (storage, GPU and spread
    // are the bind stage for a lean pod)
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    unsigned any = 0u;
    for (int n = tid; n < N; n += nt) {
      const unsigned b = w.bits[n];
      const bool st = b & B_STATIC, mp = b & B_PORTS;
      const bool res = mp && (b & B_FIT);
      const bool vol = res && (b & B_VOL);
      const bool att = vol && (b & B_ATT);
      const bool bind = att && (b & B_VMASK);
      any |= (st ? 1u : 0u) | (mp ? 2u : 0u) | (res ? 4u : 0u) | (vol ? 8u : 0u) | (att ? 16u : 0u) |
             (bind ? 0x1E0u : 0u);
      ScoreTerms t;
      t.simon = row(ROW_SIMON, n);
      t.node_pref = row(ROW_NODE_PREF, n);
      t.taint = row(ROW_TAINT, n);
      t.ipa = pref ? maxabs_term(raw_at(RAW_IPA, n), hi_s[1]) : row(ROW_IPA, n);
      t.soft = has_soft ? inv_minmax(raw_at(RAW_SOFT, n), lo_s[0], hi_s[0]) : 0.0f;
      t.ss = has_ss ? ss_term(raw_at(RAW_SS_HOST, n), raw_at(RAW_SS_ZONE, n),
                              s_max_h, s_max_z, any_zone)
                    : 0.0f;
      float s = compose_score(w_, f, x.tc > 0, row(ROW_FSCORE, n), t, x.static_score[gn0 + n],
                              x.avoid_pen[gn0 + n]);
      if (!(b & B_ALL)) s = -INFINITY;
      argmax_merge(bv, bi, s, n);
    }
    block_argmax(bv, bi, sh_bv, sh_bi);
    any = block_or(any);
    if (tid == 0) {
      const bool placed = s_feasible != 0;
      x.chosen[i] = bi;
      x.placed[i] = placed ? 1 : 0;
      x.reason[i] = placed ? OK : fail_code(any);
      x.out_node[i] = placed ? bi : -1;
      s_chosen = bi;
      s_placed = placed;
    }
    __syncthreads();
    if (!s_placed) continue;  // nothing changes: the next pod fails alike
    const int c = s_chosen;
    for (int n = tid; n < N; n += nt) {
      commit_node(x, i, n);
      // every raw advances by its coefficient on each key whose domain
      // node n shares with the chosen node
      for (int k = 0; k < K; ++k) {
        const int dc = x.node_dom[static_cast<size_t>(k) * N + c];
        if (dc < 0 || x.node_dom[static_cast<size_t>(k) * N + n] != dc) continue;
        for (int v = 0; v < N_RAWS; ++v) row(ROW_RAW + v, n) += coef[v * K + k];
      }
    }
    __syncthreads();
    if (tid == 0) {
      // the chosen node's row: its free row moved, nothing else did
      const unsigned b = w.bits[c];
      const bool fit_row = res_fit(x, req, c);
      const bool all = (b & B_NOFIT) == B_NOFIT && fit_row;
      w.bits[c] = static_cast<uint8_t>((b & ~(B_FIT | B_ALL)) | (fit_row ? B_FIT : 0u) | (all ? B_ALL : 0u));
      row(ROW_FSCORE, c) = resource_base(x, c, req, w_[0], w_[1]);
      s_flip = fit_row != ((b & B_FIT) != 0u);
      if (!s_flip && has_ss) {
        s_max_h = fmaxf(s_max_h, raw_at(RAW_SS_HOST, c));
        s_max_z = fmaxf(s_max_z, raw_at(RAW_SS_ZONE, c));
      }
    }
    __syncthreads();
    if (s_flip) refresh();
  }
}

extern "C" int simtpu_wave_lean(const StepCtx* ctx, const WaveCtx* w, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > WAVE_THREADS ? WAVE_THREADS : threads);
  const size_t smem = static_cast<size_t>(N_RAWS) * w->k * sizeof(float);
  if (smem > 48 * 1024) {
    // past the default dynamic shared memory (over 3 000 topology keys)
    const cudaError_t e = cudaFuncSetAttribute(wave_lean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wave_lean_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *w);
  return launch_status();
}
