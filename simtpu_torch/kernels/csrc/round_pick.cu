// K15 round_pick: the per-node intake m_n of one bulk round.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core :525-563
// (the threshold search) and _quota_fill :158-288 (the domain-quota
// variant). One block of ROUND_THREADS threads:
//
// Threshold round (plain, self-affinity, matrix): kf = min(k, sum cap);
// the 40-step bisection between lo = min over m_all of
// s0 - slope * clip(cap - 1, 0, k), minus 1, and hi = max s0, each step a
// block sum of the per-node virtual-slot counts above mid; then m_n =
// counts(hi), its overshoot clamped by ascending node index
// (clip(kf - (cum - m), 0, m) over the block-wide prefix), and the tied
// slots of counts(lo) handed out in node-index order.
//
// Quota round (one self-matching hard term t*): the base feasibility with
// t*'s own filter lifted (the hard-spread minimum over the other terms,
// the inter-pod filter without t*'s anti and symmetry terms, and t*'s
// missing-key infeasibility for a spread term); the domain aggregates over
// t*'s key in global scratch (intake capacity by atomicAdd of integer-
// valued f32, current count and anti-owners by max, eligibility by OR);
// the level ladder as a bounded loop, each level a block min, a prefix of
// the pours over the domains and a block sum; then the JAX split formula
// itself — the nodes in order of (domain, index), a global prefix of their
// caps, its running maximum at domain starts, the difference — so `inf`
// and `inf - inf` from 3.4e38 caps come out as in the JAX package; and
// the run-length clamp by node index.
//
// Sums of integer-valued f32 below 2^24 are exact in any order, and the
// 3.4e38 / inf cases are order-free too (rounds.cuh), so the block-wide
// reductions and scans give the JAX package's values bit for bit.
//
// Bound: operations, not bytes — the [N] caps, s0 and slope are read 40
// times by the bisection; at N = 5000 that is ~200 000 reads from L1/L2,
// and the 40 block reductions with their barriers dominate.
#include "rounds.cuh"

// node n's base feasibility for the quota (rounds.py :208-227): every
// constraint except t*'s own filter; `min_bits` holds the hard-spread
// minima of every term over the eligible nodes
__device__ inline bool quota_base(const StepCtx& x, const RoundPod& p, int n, int t_star,
                                  const int* min_bits, bool use_skew) {
  const int N = x.n, tc = x.tc, g = p.g;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  bool base = node_m_gpu(x, p, n);
  bool valid_star = false;
  bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
  float total_match = 0.0f;
  bool any_aff = false, all_s = true;
  for (int t = 0; t < tc; ++t) {
    const int term = terms[t];
    const size_t gt = g0 + t;
    const bool a_aff = x.a_aff_req[gt];
    const bool s_m = x.s_match[gt] && t != t_star;
    if (a_aff) {
      any_aff = true;
      if (term >= 0) total_match += x.cnt_total[term];
      if (!s_m) all_s = false;
    }
    if (term < 0) {
      if (a_aff) { aff_ok = false; aff_keys = false; }
      continue;
    }
    const bool valid = x.node_dom[static_cast<size_t>(x.term_topo[term]) * N + n] >= 0;
    if (t == t_star) valid_star = valid;
    const float c = x.cnt_match[static_cast<size_t>(term) * N + n];
    const int ip = x.ip_of[term];
    const float ms = t == t_star ? 0.0f : x.spread_hard[gt];
    if ((x.flags & F_SPREAD_HARD) && ms > 0.0f) {
      float mn = __int_as_float(min_bits[t]);
      if (mn >= BIG) mn = 0.0f;
      if (!(valid && (c + 1.0f) - mn <= ms)) spread_ok = false;
    }
    if (x.a_anti_req[gt] && t != t_star && c > 0.0f) anti = true;
    if (s_m && ip >= 0 && x.cnt_own_anti[static_cast<size_t>(ip) * N + n] > 0.0f) sym = true;
    if (a_aff) {
      if (!(valid && c > 0.0f)) aff_ok = false;
      if (!valid) aff_keys = false;
    }
  }
  if (x.flags & F_SPREAD_HARD) base = base && spread_ok && (valid_star || !use_skew);
  if (x.flags & F_INTERPOD_REQ) {
    const bool self_ok = total_match == 0.0f && all_s && aff_keys;
    base = base && (aff_ok || (any_aff && self_ok)) && !anti && !sym;
  }
  return base;
}

__device__ void quota_fill(const StepCtx& x, const RoundCtx& r, const RoundPod& p, BlockScratch& sh,
                           int* min_bits) {
  const int N = x.n, tc = x.tc, g = p.g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  int t_star = 0;
  for (int t = tc - 1; t >= 0; --t)
    if (x.s_match[g0 + t] && (x.a_anti_req[g0 + t] || x.spread_hard[g0 + t] > 0.0f) && terms[t] >= 0)
      t_star = t;
  const float skew = x.spread_hard[g0 + t_star];
  const bool use_skew = skew > 0.0f;
  const bool anti = x.a_anti_req[g0 + t_star];
  const int term_s = terms[t_star];
  const int* dom_row = x.node_dom + static_cast<size_t>(term_s >= 0 ? x.term_topo[term_s] : 0) * N;
  const int ip_s = term_s >= 0 ? x.ip_of[term_s] : -1;
  const int D = r.n_dom;
  const int D1 = D + 1;
  float* k_dom = r.dscr + static_cast<size_t>(DS_K) * D1;
  float* c_dom = r.dscr + static_cast<size_t>(DS_C) * D1;
  float* own_dom = r.dscr + static_cast<size_t>(DS_OWN) * D1;
  float* elig_dom = r.dscr + static_cast<size_t>(DS_ELIG) * D1;
  float* x_dom = r.dscr + static_cast<size_t>(DS_X) * D1;
  float* pour = r.dscr + static_cast<size_t>(DS_POUR) * D1;
  int* pos = r.iscr + static_cast<size_t>(IS_POS) * N;
  int* key_o = r.iscr + static_cast<size_t>(IS_KEY) * N;
  int* off = r.iscr + 2 * static_cast<size_t>(N);  // [D + 2]
  float* cap_o = r.scr + static_cast<size_t>(SC_CAP_O) * N;
  float* excl = r.scr + static_cast<size_t>(SC_EXCL) * N;
  float* sbase = r.scr + static_cast<size_t>(SC_BASE) * N;
  float* cum_m = r.scr + static_cast<size_t>(SC_CUM) * N;

  // the hard-spread minima of every term (t*'s unused) over m_static
  spread_min_pass(x, g, min_bits, (x.flags & F_SPREAD_HARD) && tc > 0);
  for (int d = tid; d < D1; d += nt) {
    k_dom[d] = c_dom[d] = own_dom[d] = elig_dom[d] = x_dom[d] = 0.0f;
    off[d] = 0;
  }
  if (tid == 0) off[D1] = 0;
  __syncthreads();
  // base feasibility, the capped intake, the domain aggregates
  for (int n = tid; n < N; n += nt) {
    float cap = r.cap[n];
    if (!quota_base(x, p, n, t_star, min_bits, use_skew)) cap = 0.0f;
    r.m_n[n] = cap;  // the quota's capped intake, until the split
    const int dt = term_s >= 0 ? dom_row[n] : 0;
    if (dt < 0) continue;
    atomicAdd(&k_dom[dt], cap);
    const float ct = term_s >= 0 ? x.cnt_match[static_cast<size_t>(term_s) * N + n] : 0.0f;
    const float ot = ip_s >= 0 ? x.cnt_own_anti[static_cast<size_t>(ip_s) * N + n] : 0.0f;
    atomicMax(reinterpret_cast<int*>(&c_dom[dt]), __float_as_int(ct + 0.0f));
    atomicMax(reinterpret_cast<int*>(&own_dom[dt]), __float_as_int(ot + 0.0f));
    if (x.stage[n] & 1u) elig_dom[dt] = 1.0f;
  }
  __syncthreads();
  if (anti)
    for (int d = tid; d < D; d += nt)
      k_dom[d] = jmin(k_dom[d], (c_dom[d] <= 0.0f && own_dom[d] <= 0.0f) ? 1.0f : 0.0f);
  __syncthreads();

  // the level ladder: pour to (min + skew) until stuck or k exhausted
  float rem = static_cast<float>(r.k);
  bool go = true;
  while (go && rem > 0.0f) {
    float level = BIG;
    for (int d = tid; d < D; d += nt)
      if (elig_dom[d] > 0.0f) level = jmin(level, c_dom[d] + x_dom[d]);
    level = block_min(level, sh);
    if (level >= BIG) level = 0.0f;
    for (int d = tid; d < D; d += nt) {
      const float cc = c_dom[d] + x_dom[d];
      const float room = use_skew ? jclip(level + skew - cc, 0.0f, BIG) : BIG;
      pour[d] = jmin(room, k_dom[d] - x_dom[d]);
    }
    __syncthreads();
    // the partial pour by ascending domain id: clip(rem - (cum - pour), 0,
    // pour) over the inclusive prefix of the pours, in chunks per thread
    const int per = (D + nt - 1) / nt;
    const int lo_d = tid * per, hi_d = min(D, lo_d + per);
    float run = 0.0f;
    for (int d = lo_d; d < hi_d; ++d) run += pour[d];
    float cum = block_exclusive(run, [](float a, float b) { return a + b; }, 0.0f, sh);
    float tot_local = 0.0f;
    for (int d = lo_d; d < hi_d; ++d) {
      const float pd = pour[d];
      cum += pd;
      const float taken = jclip(rem - (cum - pd), 0.0f, pd);
      x_dom[d] += taken;
      tot_local += taken;
    }
    const float tot = block_sum(tot_local, sh);
    rem = rem - tot;
    go = tot > 0.0f;
  }

  // the split: the nodes in order of (key, index), key = t*'s domain for a
  // node on the key with a cap, D for the rest (a stable counting sort:
  // offsets per key, then ranks chunk by chunk in index order)
  for (int n = tid; n < N; n += nt) {
    const int dt = term_s >= 0 ? dom_row[n] : 0;
    const int key = (dt >= 0 && r.m_n[n] > 0.0f) ? dt : D;
    key_o[n] = key;
    atomicAdd(&off[key + 1], 1);
  }
  __syncthreads();
  if (tid == 0)
    for (int d = 1; d <= D1; ++d) off[d] += off[d - 1];
  __syncthreads();
  for (int c0 = 0; c0 < N; c0 += nt) {
    const int n = c0 + tid;
    const int last = min(N, c0 + nt);
    const int key = n < N ? key_o[n] : -1;
    int rank = 0;
    bool is_last = true;
    if (n < N) {
      for (int m = c0; m < n; ++m) rank += key_o[m] == key ? 1 : 0;
      for (int m = n + 1; m < last && is_last; ++m) is_last = key_o[m] != key;
      pos[n] = off[key] + rank;
    }
    __syncthreads();
    if (n < N && is_last) off[key] += rank + 1;  // one writer per key
    __syncthreads();
  }
  // sorted rows: the capped intake (0 off the key), the key
  for (int n = tid; n < N; n += nt) {
    const int q = pos[n];
    cap_o[q] = key_o[n] < D ? r.m_n[n] : 0.0f;
    excl[q] = cap_o[q];
    sbase[q] = static_cast<float>(key_o[n]);
  }
  __syncthreads();
  block_scan_array(excl, N, [](float a, float b) { return a + b; }, 0.0f, sh);  // cum_o
  for (int q = tid; q < N; q += nt) {
    excl[q] = excl[q] - cap_o[q];  // the global exclusive prefix
    cum_m[q] = (q == 0 || sbase[q] != sbase[q - 1]) ? excl[q] : 0.0f;
  }
  __syncthreads();
  // the segment base: the running max of the prefixes at domain starts
  block_scan_array(cum_m, N, [](float a, float b) { return jmax(a, b); }, -INFINITY, sh);
  float* m_tmp = r.scr + static_cast<size_t>(SC_RAW1) * N;
  for (int n = tid; n < N; n += nt) {
    const int q = pos[n];
    const int key = key_o[n];
    const float before = excl[q] - cum_m[q];
    const float x_o = key < D ? x_dom[key] : 0.0f;
    const float allow = jclip(x_o - before, 0.0f, cap_o[q]);
    const int dt = term_s >= 0 ? dom_row[n] : 0;
    m_tmp[n] = dt >= 0 ? allow : r.m_n[n];
  }
  __syncthreads();
  // the run-length clamp by ascending node index
  for (int n = tid; n < N; n += nt) cum_m[n] = m_tmp[n];
  __syncthreads();
  block_scan_array(cum_m, N, [](float a, float b) { return a + b; }, 0.0f, sh);
  const float kf = static_cast<float>(r.k);
  for (int n = tid; n < N; n += nt) {
    const float m = m_tmp[n];
    r.m_n[n] = jclip(kf - (cum_m[n] - m), 0.0f, m);
  }
}

__device__ inline float slot_count(float s0, float slope, float cap, float tau) {
  float c = 0.0f;
  if (s0 >= tau) c = slope > 0.0f ? floorf(__fdiv_rn(s0 - tau, fmaxf(slope, TINY))) + 1.0f : cap;
  return jmin(c, cap);
}

__device__ void threshold_pick(const StepCtx& x, const RoundCtx& r, BlockScratch& sh) {
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float kt = static_cast<float>(r.k);
  float cap_sum = 0.0f, hi = -INFINITY, lo = BIG;
  for (int n = tid; n < N; n += nt) {
    const float cap = r.cap[n], s0 = r.s0[n], slope = r.slope[n];
    cap_sum += cap;
    hi = jmax(hi, s0);
    if (r.m_all[n]) lo = jmin(lo, s0 - slope * jclip(cap - 1.0f, 0.0f, kt));
  }
  cap_sum = block_sum(cap_sum, sh);
  hi = block_max(hi, sh);
  lo = block_min(lo, sh) - 1.0f;
  const float kf = jmin(kt, cap_sum);
  for (int it = 0; it < BISECT_STEPS; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.0f;
    for (int n = tid; n < N; n += nt) cnt += slot_count(r.s0[n], r.slope[n], r.cap[n], mid);
    cnt = block_sum(cnt, sh);
    const bool over = cnt > kf;
    if (over) lo = mid; else hi = mid;
  }
  float* cum = r.scr + static_cast<size_t>(SC_CUM) * N;
  for (int n = tid; n < N; n += nt) {
    const float m = slot_count(r.s0[n], r.slope[n], r.cap[n], hi);
    r.m_n[n] = m;
    cum[n] = m;
  }
  __syncthreads();
  block_scan_array(cum, N, [](float a, float b) { return a + b; }, 0.0f, sh);
  float m_sum = 0.0f;
  for (int n = tid; n < N; n += nt) {
    const float m = r.m_n[n];
    const float mc = jclip(kf - (cum[n] - m), 0.0f, m);
    r.m_n[n] = mc;
    m_sum += mc;
  }
  m_sum = block_sum(m_sum, sh);
  for (int n = tid; n < N; n += nt)
    cum[n] = jmax(slot_count(r.s0[n], r.slope[n], r.cap[n], lo) - r.m_n[n], 0.0f);
  __syncthreads();
  block_scan_array(cum, N, [](float a, float b) { return a + b; }, 0.0f, sh);
  for (int n = tid; n < N; n += nt) {
    const float room = jmax(slot_count(r.s0[n], r.slope[n], r.cap[n], lo) - r.m_n[n], 0.0f);
    r.m_n[n] = r.m_n[n] + jclip(kf - m_sum - (cum[n] - room), 0.0f, room);
  }
}

__global__ void __launch_bounds__(ROUND_THREADS) round_pick_kernel(StepCtx x, RoundCtx r) {
  extern __shared__ int min_bits[];  // [tc]
  __shared__ BlockScratch sh;
  const RoundPod p = round_pod(x, r.i);
  if ((r.mode & RV_QUOTA) && uses_topology(x.flags) && x.tc > 0)
    quota_fill(x, r, p, sh, min_bits);
  else
    threshold_pick(x, r, sh);
}

extern "C" int simtpu_round_pick(const StepCtx* ctx, const RoundCtx* r, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > ROUND_THREADS ? ROUND_THREADS : threads);
  const size_t smem = static_cast<size_t>(ctx->tc > 0 ? ctx->tc : 1) * sizeof(int);
  round_pick_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *r);
  return launch_status();
}
