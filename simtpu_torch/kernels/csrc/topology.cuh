// Per-node device code of the [Tc, N] term-row work (K2), shared by
// topology_pod.cu and the hard wave kernel wave_hard.cu (K10), and used by
// the lean wave kernel wave_lean.cu (K9) for the run-start raws and the
// run-constant inter-pod filter: one source for every path.
//
// The JAX package's topology_spread_filter and interpod_filter
// (simtpu/kernels/filters.py :78-155) and the raw parts of interpod_score,
// topology_spread_score and selector_spread_score (simtpu/kernels/
// scores.py), over the group's term rows (g_terms[g], -1 = pad). The raw
// sums add integer-valued floats, exact in any order below 2^24.
#pragma once
#include "step_ctx.cuh"

// per-pod scalars of the inter-pod first-pod-in-series escape
struct TopoScalars {
  float total_match;
  bool any_aff, all_s;
};

__device__ inline TopoScalars topo_scalars(const StepCtx& x, int g) {
  const int tc = x.tc;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  TopoScalars sc{0.0f, false, true};
  for (int t = 0; t < tc; ++t) {
    if (!x.a_aff_req[g0 + t]) continue;
    sc.any_aff = true;
    if (terms[t] >= 0) sc.total_match += x.cnt_total[terms[t]];
    if (!x.s_match[g0 + t]) sc.all_s = false;
  }
  return sc;
}

// The hard-spread minimum of each term over the eligible nodes (stage
// bit 0, m_static), in shared memory as the bits of non-negative floats
// (int order == float order; min is order-free). Block-wide, with the
// barriers before and after.
__device__ inline void spread_min_pass(const StepCtx& x, int g, int* min_bits, bool do_spread) {
  const int tc = x.tc;
  const int N = x.n;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  for (int t = threadIdx.x; t < tc; t += blockDim.x) min_bits[t] = __float_as_int(BIG);
  __syncthreads();
  if (do_spread) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      if (!(x.stage[n] & 1u)) continue;  // eligible = m_static
      for (int t = 0; t < tc; ++t) {
        const int term = terms[t];
        if (term < 0 || !(x.spread_hard[g0 + t] > 0.0f)) continue;
        if (x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + n] < 0) continue;
        // counts are >= 0: int order == float order (+0.0f folds -0)
        const float c = x.cnt_match[static_cast<size_t>(term) * N + n] + 0.0f;
        atomicMin(&min_bits[t], __float_as_int(c));
      }
    }
  }
  __syncthreads();
}

// Node n's spread and inter-pod verdicts and its four raw counts (inter-
// pod, soft spread, SelectorSpread host, zone) for group g; `min_bits` is
// read only when `do_spread`. With `bump` every term row the group's pod
// matches counts one more pod where the node carries the key: the state
// one pod further on, which the bulk round's re-score reads (K14).
__device__ inline void topology_node(const StepCtx& x, int g, int n, const int* min_bits,
                                     bool do_spread, bool do_ip, const TopoScalars& sc,
                                     bool& spread_ok_out, bool& ip_ok_out, float raw[N_RAWS],
                                     bool bump = false) {
  const int tc = x.tc;
  const int N = x.n;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
  float ipa_in = 0.0f, ipa_sym = 0.0f, sp = 0.0f, ssh = 0.0f, ssz = 0.0f;
  for (int t = 0; t < tc; ++t) {
    const int term = terms[t];
    if (term < 0) continue;  // pad column: zero row, all coefficients 0
    const size_t gt = g0 + t;
    const bool valid = x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + n] >= 0;
    float c = x.cnt_match[static_cast<size_t>(term) * N + n];
    if (bump && valid && x.s_match[gt]) c += 1.0f;
    const int ip = x.ip_of[term];
    const size_t ipn = static_cast<size_t>(ip) * N + n;
    const float ms = x.spread_hard[gt];
    if (do_spread && ms > 0.0f) {
      float mn = __int_as_float(min_bits[t]);
      if (mn >= BIG) mn = 0.0f;
      if (!(valid && (c + 1.0f) - mn <= ms)) spread_ok = false;
    }
    if (x.a_anti_req[gt] && c > 0.0f) anti = true;
    if (x.s_match[gt] && ip >= 0 && x.cnt_own_anti[ipn] > 0.0f) sym = true;
    if (x.a_aff_req[gt]) {
      if (!(valid && c > 0.0f)) aff_ok = false;
      if (!valid) aff_keys = false;
    }
    ipa_in += (x.w_aff_pref[gt] - x.w_anti_pref[gt]) * c;
    if (x.s_match[gt] && ip >= 0)
      ipa_sym += (x.w_own_aff_pref[ipn] - x.w_own_anti_pref[ipn]) + x.cnt_own_aff[ipn];
    sp += x.spread_soft[gt] * c;
    if (x.ss_host[gt]) ssh += c;
    if (x.ss_zone[gt]) ssz += c;
  }
  bool ip_ok = true;
  if (do_ip) {
    const bool self_ok = sc.total_match == 0.0f && sc.all_s && aff_keys;
    ip_ok = (aff_ok || (sc.any_aff && self_ok)) && !anti && !sym;
  }
  spread_ok_out = spread_ok;
  ip_ok_out = ip_ok;
  raw[RAW_IPA] = ipa_in + ipa_sym;
  raw[RAW_SOFT] = sp;
  raw[RAW_SS_HOST] = ssh;
  raw[RAW_SS_ZONE] = ssz;
}

// K2 for pod i, block-wide: stage bits 6 (spread) and 7 (all) and the raw
// rows. `min_bits` holds tc ints of shared memory.
__device__ inline void topology_block(const StepCtx& x, int i, int* min_bits) {
  const int g = x.group[i];
  const int N = x.n;
  const bool do_spread = (x.flags & F_SPREAD_HARD) && x.tc > 0;
  const bool do_ip = (x.flags & F_INTERPOD_REQ) && x.tc > 0;
  spread_min_pass(x, g, min_bits, do_spread);
  const TopoScalars sc = topo_scalars(x, g);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool spread_ok, ip_ok;
    float raw[N_RAWS];
    topology_node(x, g, n, min_bits, do_spread, do_ip, sc, spread_ok, ip_ok, raw);
    const unsigned s = x.stage[n] & 0x3Fu;
    const bool m6 = ((s >> 5) & 1u) && spread_ok;
    const bool m7 = m6 && ip_ok;
    x.stage[n] = static_cast<uint8_t>(s | (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u));
    for (int k = 0; k < N_RAWS; ++k) x.raw[static_cast<size_t>(k) * N + n] = raw[k];
  }
}
