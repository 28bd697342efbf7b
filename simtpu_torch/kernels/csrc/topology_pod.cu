// K2 topology_pod: the [Tc, N] term-row work of one pod.
//
// Replaces the [Tc, N] part of the JAX package's simtpu/engine/scan.py
// filter_and_score and score_pod (scan.py:755-763, 898-963, 646-699):
// topology_spread_filter and interpod_filter (simtpu/kernels/filters.py
// :78-155) and the raw parts of interpod_score, topology_spread_score and
// selector_spread_score (simtpu/kernels/scores.py). For the group's term
// rows (g_terms[g], -1 = pad) it reads the domain row
// node_dom[term_topo[t]], the count row cnt_match[t] and, through ip_of,
// the own-plane rows; it sets stage bits 6 (spread) and 7 (all) and writes
// the four raw [N] count vectors K3 normalizes.
//
// One block walks all N nodes: the hard-spread filter needs the per-term
// minimum over eligible nodes (a reduction over N, kept in shared memory
// with atomicMin on the bits of non-negative floats — min is order-free)
// before the per-node pass. The raw sums add integer-valued floats, exact
// in any order below 2^24.
//
// Bound: bytes — each touched [Tc, N] row is read once (domain, count and
// own rows), the raw rows written once; at N <= 1024 the launch latency
// dominates.
#include "step_ctx.cuh"

__global__ void topology_pod_kernel(StepCtx x, int i) {
  extern __shared__ int min_bits[];  // [tc] per-term eligible minimum
  const int g = x.group[i];
  const int tc = x.tc;
  const int N = x.n;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  const bool do_spread = (x.flags & F_SPREAD_HARD) && tc > 0;
  const bool do_ip = (x.flags & F_INTERPOD_REQ) && tc > 0;
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
  // per-pod scalars of the inter-pod first-pod-in-series escape
  float total_match = 0.0f;
  bool any_aff = false, all_s = true;
  for (int t = 0; t < tc; ++t) {
    if (!x.a_aff_req[g0 + t]) continue;
    any_aff = true;
    if (terms[t] >= 0) total_match += x.cnt_total[terms[t]];
    if (!x.s_match[g0 + t]) all_s = false;
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
    float ipa_in = 0.0f, ipa_sym = 0.0f, sp = 0.0f, ssh = 0.0f, ssz = 0.0f;
    for (int t = 0; t < tc; ++t) {
      const int term = terms[t];
      if (term < 0) continue;  // pad column: zero row, all coefficients 0
      const size_t gt = g0 + t;
      const bool valid = x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + n] >= 0;
      const float c = x.cnt_match[static_cast<size_t>(term) * N + n];
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
      const bool self_ok = total_match == 0.0f && all_s && aff_keys;
      ip_ok = (aff_ok || (any_aff && self_ok)) && !anti && !sym;
    }
    const unsigned s = x.stage[n] & 0x3Fu;
    const bool m6 = ((s >> 5) & 1u) && spread_ok;
    const bool m7 = m6 && ip_ok;
    x.stage[n] = static_cast<uint8_t>(s | (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u));
    x.raw[n] = ipa_in + ipa_sym;
    x.raw[N + n] = sp;
    x.raw[2 * N + n] = ssh;
    x.raw[3 * N + n] = ssz;
  }
}

extern "C" int simtpu_topology_pod(const StepCtx* ctx, int i, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = static_cast<size_t>(ctx->tc) * sizeof(int);
  topology_pod_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
