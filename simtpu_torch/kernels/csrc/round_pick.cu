// K15 round_pick: the per-node intake m_n of one bulk round.
//
// Replaces the JAX package's simtpu/engine/rounds.py _round_core :525-563
// (the threshold search) and _quota_fill :158-288 (the domain-quota
// variant). One block per round: the work is a chain of dependent
// reductions over a few thousand nodes, each link a block barrier; spread
// over SMs each link would be a grid-wide barrier. What bounds it is that
// chain, so the design keeps its links few and short: every block
// reduction and scan is one barrier (warp shuffles or redux.sync, the
// warps' partials in one of two alternating slot arrays, every warp
// folding them again), and no loop's barrier count grows with N.
//
// Threshold round (plain, self-affinity, matrix;
// `round_pick_threshold_kernel`): kf = min(k, sum cap); the 40-step
// bisection between lo = min over m_all of s0 - slope * clip(cap - 1, 0,
// k), minus 1, and hi = max s0, each step asking whether the virtual-slot
// counts above mid sum past kf; then m_n = counts(hi), its overshoot
// clamped by ascending node index, and the tied slots of counts(lo) handed
// out in node-index order. Thread t owns the contiguous nodes [t * per,
// t * per + per): up to PICK_REG_NPT of them their s0, slope and cap stay
// in registers (template NPT), above that they are re-read from global
// memory (NPT 0). A bisection step's counts are integers: each is
// saturated at kf + 1 and summed with redux.sync (the step only asks
// whether the sum exceeds kf, and a float sum of non-negative
// integer-valued counts exceeds kf in any order exactly when the integer
// sum does; a NaN count, which makes the float sum NaN, is carried as a
// flag). PICK_LEVELS levels are decided per reduction: the 2^L - 1
// midpoints of the next L steps, formed by the same float expressions the
// sequential steps form, are counted in one pass. The search stops at its
// fixed point: a step that leaves (lo, hi) unchanged bit for bit (and
// whose mid is not NaN) repeats itself to the 40th.
//
// Quota round (one self-matching hard term t*; `round_pick_quota_kernel`):
// the base feasibility with t*'s own filter lifted, the domain aggregates
// over t*'s key in global scratch (intake capacity by atomicAdd of
// integer-valued f32, current count and anti-owners by max, eligibility by
// OR); then
//   - the level ladder over the compacted list of domains that are
//     eligible or have k_dom != 0, in ascending id order: every other
//     domain pours exactly 0 at every level and never sets the level, so
//     the cumulative pours and the result are bit for bit those over all
//     n_dom domains (a NaN aggregate, which would spread through the
//     pours' prefix to every later domain, lists every domain). Up to 32
//     listed domains one warp runs the ladder, no block barrier inside the
//     loop: a level's minimum one redux.sync, its pours' prefix five
//     shuffles, its total min(rem, sum of the pours) (Ladder); above, each
//     level is two block barriers;
//   - the split's order of (domain, index) by a stable LSD radix sort,
//     8 bits a pass over the domains' ranks among those with a capped node
//     (one pass up to 255 such domains): each warp ranks its items with
//     __match_any_sync (the ranks kept in registers up to PICK_REG_NPT
//     items a lane), one block scan of the digit counts, a scatter; three
//     barriers a pass. Its buffers sit in shared memory up to
//     PICK_SORT_SMEM_N nodes, in RoundCtx.iscr above;
//   - the JAX split formula itself on that order — a global prefix of the
//     caps, its running maximum at domain starts, the difference — so
//     `inf` and `inf - inf` from 3.4e38 caps come out as in the JAX
//     package; and the run-length clamp by node index.
//
// Sums of integer-valued f32 below 2^24 are exact in any order, and the
// 3.4e38 / inf cases are order-free too (rounds.cuh), so the block-wide
// reductions and scans give the JAX package's values bit for bit.
//
// The profile build (-DSIMTPU_PICK_PROFILE, never the main path's) adds
// thread 0's clock64() cycles per phase into `pick_prof`, read by
// simtpu_round_pick_prof.
#include "rounds.cuh"

// nodes per thread kept in registers at most (N <= 8192 at 1024 threads)
constexpr int PICK_REG_NPT = 8;
// bisection levels decided per block reduction: a step's counts, not its
// barrier, bound it (on an H100 SXM two levels a reduction, three counts a
// node a pass, ran the bulk problem's plain round 17% slower than one)
constexpr int PICK_LEVELS = 1;
// the ranking's buffers sit in shared memory up to this many nodes
constexpr int PICK_SORT_SMEM_N = 8192;
constexpr int PICK_RADIX_BITS = 8;
constexpr int PICK_BUCKETS = 1 << PICK_RADIX_BITS;
// listed domains a one-warp ladder holds
constexpr int PICK_WARP_LADDER = 32;
// words per warp of a reduction slot
constexpr int PICK_SLOT_WORDS = 8;

// profile slots: cycles per phase, then the bisection steps and ladder levels run
enum : int {
  PP_LOAD = 0, PP_BISECT, PP_CLAMP, PP_BASE, PP_AGG, PP_LADDER, PP_RANK, PP_SPLIT, PP_STEPS, PP_LEVELS,
  PICK_PROF_SLOTS
};

#ifdef SIMTPU_PICK_PROFILE
__device__ unsigned long long pick_prof[PICK_PROF_SLOTS];
#define PICK_STAMP(b, phase)                     \
  do {                                           \
    const long long t_ = clock64();              \
    (b).acc[phase] += t_ - (b).t0;               \
    (b).t0 = t_;                                 \
  } while (0)
#define PICK_COUNT(b, slot, v) ((b).acc[slot] += (v))
#else
#define PICK_STAMP(b, phase) ((void)0)
#define PICK_COUNT(b, slot, v) ((void)0)
#endif

// -- one-barrier block reductions and scans ------------------------------------
// The warps' partials go to slot array `ph` (one of two); a slot array is
// written again only after a later reduction's barrier, which every reader
// of its previous contents has passed.

struct PickSlots {
  float f[2][32][PICK_SLOT_WORDS];
  unsigned u[2][32][PICK_SLOT_WORDS];
};

struct Blk {
  PickSlots* s;
  int ph, lane, warp, nw;
#ifdef SIMTPU_PICK_PROFILE
  long long t0;
  long long acc[PICK_PROF_SLOTS];
#endif
  __device__ explicit Blk(PickSlots* slots)
      : s(slots), ph(0), lane(threadIdx.x & 31), warp(threadIdx.x >> 5), nw(blockDim.x >> 5) {
#ifdef SIMTPU_PICK_PROFILE
    t0 = clock64();
    for (int q = 0; q < PICK_PROF_SLOTS; ++q) acc[q] = 0;
#endif
  }
  __device__ void flush() {
#ifdef SIMTPU_PICK_PROFILE
    if (threadIdx.x == 0)
      for (int q = 0; q < PICK_PROF_SLOTS; ++q)
        atomicAdd(&pick_prof[q], static_cast<unsigned long long>(acc[q]));
#endif
  }
};

constexpr unsigned FULL = 0xffffffffu;

struct FAdd {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct FMin {
  __device__ float operator()(float a, float b) const { return jmin(a, b); }
};
struct FMax {
  __device__ float operator()(float a, float b) const { return jmax(a, b); }
};

template <typename Op>
__device__ inline float warp_fold(float v, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// inclusive prefix over the warp's lanes
template <typename Op>
__device__ inline float warp_incl(float v, Op op, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = op(o, v);
  }
  return v;
}

// NV values folded block-wide with ops[k] (identity ids[k]); every thread
// gets the results
template <int NV, typename... Ops>
__device__ inline void block_fold(Blk& b, float (&v)[NV], const float (&ids)[NV], Ops... ops) {
  static_assert(sizeof...(Ops) == NV, "one op per value");
  int k = 0;
  ((v[k] = warp_fold(v[k], ops), ++k), ...);
  if (b.lane == 0)
    for (int q = 0; q < NV; ++q) b.s->f[b.ph][b.warp][q] = v[q];
  __syncthreads();
  for (int q = 0; q < NV; ++q) v[q] = b.lane < b.nw ? b.s->f[b.ph][b.lane][q] : ids[q];
  k = 0;
  ((v[k] = warp_fold(v[k], ops), ++k), ...);
  b.ph ^= 1;
}

// The exclusive prefix of `v` in thread order with `op` (identity `id`) and
// its block total; `*w`, where given, summed block-wide alongside. One
// barrier.
template <typename Op>
__device__ inline float block_excl(Blk& b, float v, Op op, float id, float& total, float* w = nullptr) {
  const float incl = warp_incl(v, op, b.lane);
  const float ws = w ? warp_fold(*w, FAdd()) : 0.0f;
  if (b.lane == 31) b.s->f[b.ph][b.warp][0] = incl;
  if (b.lane == 0) b.s->f[b.ph][b.warp][1] = ws;
  __syncthreads();
  const float t = b.lane < b.nw ? b.s->f[b.ph][b.lane][0] : id;
  if (w) *w = warp_fold(b.lane < b.nw ? b.s->f[b.ph][b.lane][1] : 0.0f, FAdd());
  const float ti = warp_incl(t, op, b.lane);
  total = __shfl_sync(FULL, ti, 31);
  const float wb = __shfl_sync(FULL, ti, b.warp > 0 ? b.warp - 1 : 0);
  const float el = __shfl_up_sync(FULL, incl, 1);
  b.ph ^= 1;
  if (b.warp == 0) return b.lane == 0 ? id : el;
  return b.lane == 0 ? wb : op(wb, el);
}

// exclusive prefixes of two counts in thread order, their totals and an
// OR of flags; one barrier
__device__ inline void block_excl_counts(Blk& b, unsigned& a, unsigned& c, unsigned& flag, unsigned& ta,
                                         unsigned& tc) {
  unsigned ia = a, ic = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned oa = __shfl_up_sync(FULL, ia, off), oc = __shfl_up_sync(FULL, ic, off);
    if (b.lane >= off) { ia += oa; ic += oc; }
  }
  const unsigned fl = __reduce_or_sync(FULL, flag);
  if (b.lane == 31) { b.s->u[b.ph][b.warp][0] = ia; b.s->u[b.ph][b.warp][1] = ic; }
  if (b.lane == 0) b.s->u[b.ph][b.warp][2] = fl;
  __syncthreads();
  unsigned wa = b.lane < b.nw ? b.s->u[b.ph][b.lane][0] : 0u;
  unsigned wc = b.lane < b.nw ? b.s->u[b.ph][b.lane][1] : 0u;
  flag = __reduce_or_sync(FULL, b.lane < b.nw ? b.s->u[b.ph][b.lane][2] : 0u);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned oa = __shfl_up_sync(FULL, wa, off), oc = __shfl_up_sync(FULL, wc, off);
    if (b.lane >= off) { wa += oa; wc += oc; }
  }
  ta = __shfl_sync(FULL, wa, 31);
  tc = __shfl_sync(FULL, wc, 31);
  const int src = b.warp > 0 ? b.warp - 1 : 0;
  const unsigned ba = b.warp > 0 ? __shfl_sync(FULL, wa, src) : 0u;
  const unsigned bc = b.warp > 0 ? __shfl_sync(FULL, wc, src) : 0u;
  a = ba + (ia - a);
  c = bc + (ic - c);
  b.ph ^= 1;
}

// the exclusive prefix of one count in thread order; one barrier
__device__ inline unsigned block_excl_u(Blk& b, unsigned v) {
  unsigned c = 0, f = 0, ta, tc;
  block_excl_counts(b, v, c, f, ta, tc);
  return v;
}

// -- the threshold round --------------------------------------------------------

__device__ inline float slot_count(float s0, float slope, float cap, float tau) {
  float c = 0.0f;
  if (s0 >= tau) c = slope > 0.0f ? floorf(__fdiv_rn(s0 - tau, fmaxf(slope, TINY))) + 1.0f : cap;
  return jmin(c, cap);
}

// the thread's nodes [base, base + cnt): s0, slope, cap and two kept
// values per node, in registers (NPT > 0) or in global memory (NPT 0:
// RoundCtx's rows, m_n and the SC_CUM scratch row for the kept values)
template <int NPT>
struct PickNodes {
  float s0_[NPT], slope_[NPT], cap_[NPT], k0_[NPT], k1_[NPT];
  __device__ PickNodes(const RoundCtx& r, int base, int cnt, int) {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const bool in = j < cnt;
      s0_[j] = in ? r.s0[base + j] : NEG;
      slope_[j] = in ? r.slope[base + j] : 0.0f;
      cap_[j] = in ? r.cap[base + j] : 0.0f;
    }
  }
  __device__ float s0(int j) const { return s0_[j]; }
  __device__ float slope(int j) const { return slope_[j]; }
  __device__ float cap(int j) const { return cap_[j]; }
  __device__ float count(int j, float tau) const { return slot_count(s0_[j], slope_[j], cap_[j], tau); }
  __device__ float& kept0(int j) { return k0_[j]; }
  __device__ float& kept1(int j) { return k1_[j]; }
};
template <>
struct PickNodes<0> {
  const float *s0p, *slopep, *capp;
  float *k0p, *k1p;
  __device__ PickNodes(const RoundCtx& r, int base, int, int n)
      : s0p(r.s0 + base), slopep(r.slope + base), capp(r.cap + base), k0p(r.m_n + base),
        k1p(r.scr + static_cast<size_t>(SC_CUM) * n + base) {}
  __device__ float s0(int j) const { return s0p[j]; }
  __device__ float slope(int j) const { return slopep[j]; }
  __device__ float cap(int j) const { return capp[j]; }
  __device__ float count(int j, float tau) const { return slot_count(s0p[j], slopep[j], capp[j], tau); }
  __device__ float& kept0(int j) { return k0p[j]; }
  __device__ float& kept1(int j) { return k1p[j]; }
};

// j over the thread's nodes: unrolled over NPT in registers
#define FOR_OWN(j)                                          \
  _Pragma("unroll") for (int j = 0; j < (NPT ? NPT : per); ++j) \
    if (j < cnt)

template <int NPT>
__device__ void threshold_pick(const StepCtx& x, const RoundCtx& r, Blk& b) {
  const int N = x.n, nt = blockDim.x;
  const int per = (N + nt - 1) / nt;
  const int base = threadIdx.x * per;
  const int cnt = max(0, min(per, N - base));
  const float kt = static_cast<float>(r.k);
  PickNodes<NPT> nd(r, base, cnt, N);

  // the caps' sum, the highest s0 and the lowest slot of m_all
  float agg[3] = {0.0f, -INFINITY, BIG};
  FOR_OWN(j) {
    agg[0] += nd.cap(j);
    agg[1] = jmax(agg[1], nd.s0(j));
    if (r.m_all[base + j]) agg[2] = jmin(agg[2], nd.s0(j) - nd.slope(j) * jclip(nd.cap(j) - 1.0f, 0.0f, kt));
  }
  const float ids[3] = {0.0f, -INFINITY, BIG};
  block_fold(b, agg, ids, FAdd(), FMax(), FMin());
  float hi = agg[1];
  float lo = agg[2] - 1.0f;
  const float kf = jmin(kt, agg[0]);
  PICK_STAMP(b, PP_LOAD);

  // the bisection, PICK_LEVELS steps per reduction, to its fixed point
  const bool kf_ok = kf == kf;
  const unsigned kf_u = kf_ok ? __float2uint_rz(kf) : 0u;
  const unsigned top = kf_u + 1u;
  constexpr int NQ = (1 << PICK_LEVELS) - 1;
  int it = 0;
  while (it < BISECT_STEPS) {
    // the midpoints of the next levels, heap order: child 2q + 1 takes
    // hi = tau[q] (not over), child 2q + 2 takes lo = tau[q] (over)
    float tau[NQ], tl[NQ], th[NQ];
    tl[0] = lo;
    th[0] = hi;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      tau[q] = 0.5f * (tl[q] + th[q]);
      if (2 * q + 2 < NQ) {
        tl[2 * q + 1] = tl[q];
        th[2 * q + 1] = tau[q];
        tl[2 * q + 2] = tau[q];
        th[2 * q + 2] = th[q];
      }
    }
    unsigned c[NQ];
    unsigned nanb = 0u;
#pragma unroll
    for (int q = 0; q < NQ; ++q) c[q] = 0u;
    FOR_OWN(j) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float v = nd.count(j, tau[q]);
        if (v != v) nanb |= 1u << q;
        const unsigned u = v > kf ? top : (v == v ? __float2uint_rz(v) : 0u);
        c[q] = min(c[q] + u, top);
      }
    }
    // one barrier: per warp redux.sync (32 partials of at most kf + 1 fit
    // in 32 bits), saturated again, then every warp folds the 32 partials
#pragma unroll
    for (int q = 0; q < NQ; ++q) c[q] = min(__reduce_add_sync(FULL, c[q]), top);
    nanb = __reduce_or_sync(FULL, nanb);
    if (b.lane == 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) b.s->u[b.ph][b.warp][q] = c[q];
      b.s->u[b.ph][b.warp][NQ] = nanb;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NQ; ++q) c[q] = __reduce_add_sync(FULL, b.lane < b.nw ? b.s->u[b.ph][b.lane][q] : 0u);
    nanb = __reduce_or_sync(FULL, b.lane < b.nw ? b.s->u[b.ph][b.lane][NQ] : 0u);
    b.ph ^= 1;
    int q = 0;
#pragma unroll
    for (int lev = 0; lev < PICK_LEVELS; ++lev) {
      if (it >= BISECT_STEPS) break;
      // tree node q's midpoint and count, selected without indexing the
      // register arrays by a runtime q
      float mid = tau[0];
      unsigned cq = c[0];
#pragma unroll
      for (int qq = 1; qq < NQ; ++qq)
        if (qq == q) {
          mid = tau[qq];
          cq = c[qq];
        }
      const bool over = kf_ok && !((nanb >> q) & 1u) && cq > kf_u;
      const float nlo = over ? mid : lo, nhi = over ? hi : mid;
      const bool fixed = mid == mid && __float_as_uint(nlo) == __float_as_uint(lo) &&
                         __float_as_uint(nhi) == __float_as_uint(hi);
      lo = nlo;
      hi = nhi;
      ++it;
      PICK_COUNT(b, PP_STEPS, 1);
      if (fixed) {
        it = BISECT_STEPS;
        break;
      }
      q = 2 * q + 1 + (over ? 1 : 0);
    }
  }
  PICK_STAMP(b, PP_BISECT);

  // m = counts(hi), its overshoot clamped by ascending node index; the
  // tied slots of counts(lo) handed out in node-index order
  float run = 0.0f;
  FOR_OWN(j) run += nd.count(j, hi);
  float total;
  const float before = block_excl(b, run, FAdd(), 0.0f, total);
  float loc = 0.0f, room_run = 0.0f;
  float m_sum = 0.0f;
  FOR_OWN(j) {
    const float m = nd.count(j, hi);
    loc += m;
    const float mc = jclip(kf - ((before + loc) - m), 0.0f, m);
    m_sum += mc;
    const float room = jmax(nd.count(j, lo) - mc, 0.0f);
    room_run += room;
    nd.kept0(j) = mc;
    nd.kept1(j) = room;
  }
  const float before2 = block_excl(b, room_run, FAdd(), 0.0f, total, &m_sum);
  float loc2 = 0.0f;
  FOR_OWN(j) {
    const float mc = nd.kept0(j), room = nd.kept1(j);
    loc2 += room;
    r.m_n[base + j] = mc + jclip(kf - m_sum - ((before2 + loc2) - room), 0.0f, room);
  }
  PICK_STAMP(b, PP_CLAMP);
}
#undef FOR_OWN

// -- the quota round ------------------------------------------------------------

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

// The ladder's arithmetic for one listed domain at a level. The levels,
// counts, intakes and pours are non-negative integer-valued floats (a
// domain's count and intake are never -0: both start at +0 and grow by
// non-negative amounts), so
//   - a warp's minimum is redux.sync on their bits (the order of
//     non-negative floats), NaN — which the JAX min propagates — voted
//     apart;
//   - a level's total intake, the sum of clip(rem - (cum - pour), 0,
//     pour) over the domains, is min(rem, sum of the pours) exactly (a
//     NaN pour makes both NaN).
struct Ladder {
  float skew;
  bool use_skew;
  __device__ float pour(float level, float c, float k, float x) const {
    const float room = use_skew ? jclip(level + skew - (c + x), 0.0f, BIG) : BIG;
    return jmin(room, k - x);
  }
  // the warp's minimum of cc over its eligible lanes (BIG if none)
  __device__ static float level(bool el, float cc) {
    if (__any_sync(FULL, el && cc != cc)) return __int_as_float(0x7fffffff);
    return __uint_as_float(__reduce_min_sync(FULL, __float_as_uint(el ? cc : BIG)));
  }
};

// dynamic shared memory of the quota kernel, in ints: the hard-spread
// minima (tc, rounded up to 4), the digit counts [PICK_BUCKETS, warps + 1],
// the ranking's two (key, node) buffers where N <= PICK_SORT_SMEM_N
__host__ __device__ inline int quota_smem_ints(int n, int tc, int threads) {
  return ((tc + 3) & ~3) + PICK_BUCKETS * (threads / 32 + 1) + (n <= PICK_SORT_SMEM_N ? 4 * n : 0);
}

__global__ void __launch_bounds__(ROUND_THREADS) round_pick_quota_kernel(StepCtx x, RoundCtx r) {
  extern __shared__ int dyn[];
  __shared__ PickSlots slots;
  Blk b(&slots);
  const RoundPod p = round_pod(x, r.i);
  const int N = x.n, tc = x.tc, g = p.g;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* terms = x.g_terms + static_cast<size_t>(g) * tc;
  const size_t g0 = static_cast<size_t>(g) * tc;
  int t_star = 0;
  for (int t = tc - 1; t >= 0; --t)
    if (x.s_match[g0 + t] && (x.a_anti_req[g0 + t] || x.spread_hard[g0 + t] > 0.0f) && terms[t] >= 0)
      t_star = t;
  const Ladder lad{x.spread_hard[g0 + t_star], x.spread_hard[g0 + t_star] > 0.0f};
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
  float* pour_l = r.dscr + static_cast<size_t>(DS_POUR) * D1;
  int* lst = r.iscr + static_cast<size_t>(IS_NODE_ROWS) * N;  // [D1] the ladder's domains
  int* srank = lst + D1;                                       // [D1] rank among capped domains
  float* m_tmp = r.scr + static_cast<size_t>(SC_RAW1) * N;
  int* min_bits = dyn;
  unsigned* hist = reinterpret_cast<unsigned*>(dyn + ((tc + 3) & ~3));  // [PICK_BUCKETS, warps + 1]
  int* sbuf = dyn + ((tc + 3) & ~3) + PICK_BUCKETS * (b.nw + 1);
  int *key_buf[2], *node_buf[2];
  if (N <= PICK_SORT_SMEM_N) {
    key_buf[0] = sbuf;
    node_buf[0] = sbuf + N;
    key_buf[1] = sbuf + 2 * N;
    node_buf[1] = sbuf + 3 * N;
  } else {
    key_buf[0] = r.iscr + static_cast<size_t>(IS_KEY_A) * N;
    node_buf[0] = r.iscr + static_cast<size_t>(IS_NODE_A) * N;
    key_buf[1] = r.iscr + static_cast<size_t>(IS_KEY_B) * N;
    node_buf[1] = r.iscr + static_cast<size_t>(IS_NODE_B) * N;
  }
  // node n's domain on t*'s key, -1 off it
  auto dom_of = [&](int n) { return term_s >= 0 ? dom_row[n] : -1; };

  // the aggregates' rows zeroed; the hard-spread minima of every term
  // (t*'s unused) over m_static (its barriers order the zeroing too)
  for (int d = tid; d < D1; d += nt) k_dom[d] = c_dom[d] = own_dom[d] = elig_dom[d] = x_dom[d] = 0.0f;
  spread_min_pass(x, g, min_bits, (x.flags & F_SPREAD_HARD) && tc > 0);
  // base feasibility, the capped intake, the domain aggregates
  for (int n = tid; n < N; n += nt) {
    float cap = r.cap[n];
    if (!quota_base(x, p, n, t_star, min_bits, lad.use_skew)) cap = 0.0f;
    r.m_n[n] = cap;  // the quota's capped intake, until the split
    const int dt = dom_of(n);
    if (dt < 0) continue;
    atomicAdd(&k_dom[dt], cap);
    const float ct = x.cnt_match[static_cast<size_t>(term_s) * N + n];
    const float ot = ip_s >= 0 ? x.cnt_own_anti[static_cast<size_t>(ip_s) * N + n] : 0.0f;
    atomicMax(reinterpret_cast<int*>(&c_dom[dt]), __float_as_int(ct + 0.0f));
    atomicMax(reinterpret_cast<int*>(&own_dom[dt]), __float_as_int(ot + 0.0f));
    if (x.stage[n] & 1u) elig_dom[dt] = 1.0f;
  }
  __syncthreads();
  PICK_STAMP(b, PP_BASE);


  // the anti clamp and the compaction, both lists in ascending id order:
  // the ladder's domains (eligible or k_dom != 0; every domain where an
  // aggregate is NaN) and each capped domain's rank (k_dom > 0 before the
  // clamp: a node of the domain has a cap); -1 for the others
  const int per_d = (D + nt - 1) / nt;
  const int d0 = min(D, tid * per_d), d1 = min(D, d0 + per_d);
  unsigned n_l = 0u, n_s = 0u, nan_f = 0u;
  for (int d = d0; d < d1; ++d) {
    float k = k_dom[d];
    const float c = c_dom[d];
    srank[d] = k > 0.0f ? 1 : 0;
    n_s += k > 0.0f ? 1u : 0u;
    if (anti) {
      k = jmin(k, (c <= 0.0f && own_dom[d] <= 0.0f) ? 1.0f : 0.0f);
      k_dom[d] = k;
    }
    n_l += (elig_dom[d] > 0.0f || k != 0.0f) ? 1u : 0u;
    if (c != c || k != k) nan_f = 1u;
  }
  unsigned m_l, m_s;
  block_excl_counts(b, n_l, n_s, nan_f, m_l, m_s);
  if (nan_f) m_l = static_cast<unsigned>(D);
  for (int d = d0; d < d1; ++d) {
    if (nan_f)
      lst[d] = d;
    else if (elig_dom[d] > 0.0f || k_dom[d] != 0.0f)
      lst[n_l++] = d;
    srank[d] = srank[d] ? static_cast<int>(n_s++) : -1;
  }
  __syncthreads();
  PICK_STAMP(b, PP_AGG);

  // the level ladder over the list: pour to (min + skew) until stuck or k
  // exhausted
  float rem = static_cast<float>(r.k);
  if (m_l <= static_cast<unsigned>(PICK_WARP_LADDER)) {
    if (b.warp == 0) {
      const bool in = b.lane < static_cast<int>(m_l);
      const int d = in ? lst[b.lane] : 0;
      const float c = in ? c_dom[d] : 0.0f, k = in ? k_dom[d] : 0.0f;
      const bool el = in && elig_dom[d] > 0.0f;
      float xd = 0.0f;
      bool go = true;
      while (go && rem > 0.0f) {
        float level = lad.level(el, c + xd);
        if (level >= BIG) level = 0.0f;
        const float pd = in ? lad.pour(level, c, k, xd) : 0.0f;
        const float cum = warp_incl(pd, FAdd(), b.lane);
        xd += in ? jclip(rem - (cum - pd), 0.0f, pd) : 0.0f;
        const float tot = jmin(rem, __shfl_sync(FULL, cum, 31));
        rem = rem - tot;
        go = tot > 0.0f;
        PICK_COUNT(b, PP_LEVELS, 1);
      }
      if (in) x_dom[d] = xd;
    }
  } else {
    const int ml = static_cast<int>(m_l);
    const int per_l = (ml + nt - 1) / nt;
    const int i0 = min(ml, tid * per_l), i1 = min(ml, i0 + per_l);
    float lv[1] = {BIG};
    for (int i = i0; i < i1; ++i) {
      const int d = lst[i];
      if (elig_dom[d] > 0.0f) lv[0] = jmin(lv[0], c_dom[d] + x_dom[d]);
    }
    const float id1[1] = {BIG};
    block_fold(b, lv, id1, FMin());
    float level = lv[0];
    bool go = true;
    while (go && rem > 0.0f) {
      if (level >= BIG) level = 0.0f;
      float run = 0.0f;
      for (int i = i0; i < i1; ++i) {
        const int d = lst[i];
        const float pd = lad.pour(level, c_dom[d], k_dom[d], x_dom[d]);
        pour_l[i] = pd;
        run += pd;
      }
      float total;
      const float before = block_excl(b, run, FAdd(), 0.0f, total);
      float loc = 0.0f;
      float nl[1] = {BIG};
      for (int i = i0; i < i1; ++i) {
        const int d = lst[i];
        const float pd = pour_l[i];
        loc += pd;
        const float xd = x_dom[d] + jclip(rem - ((before + loc) - pd), 0.0f, pd);
        x_dom[d] = xd;
        if (elig_dom[d] > 0.0f) nl[0] = jmin(nl[0], c_dom[d] + xd);
      }
      const float tot = jmin(rem, total);
      rem = rem - tot;
      go = tot > 0.0f;
      // the next level
      if (go && rem > 0.0f) block_fold(b, nl, id1, FMin());
      level = nl[0];
      PICK_COUNT(b, PP_LEVELS, 1);
    }
  }
  __syncthreads();
  PICK_STAMP(b, PP_LADDER);

  // the split's order: the nodes by (key, index), key = the rank of t*'s
  // domain for a node on the key with a cap, m_s for the rest; a stable LSD
  // radix sort from index order. Items are warp-striped: warp w holds
  // positions [w * 32 J, (w + 1) * 32 J), item j of lane l at position
  // w * 32 J + 32 j + l, so a warp's items in (j, lane) order are its range
  // in order and the match-any ranks keep the sort stable.
  const int J = (N + nt - 1) / nt;
  const int wbase = b.warp * 32 * J;
  const unsigned lt_mask = (1u << b.lane) - 1u;
  int bits = 0;
  while ((m_s >> bits) != 0u) ++bits;
  const int passes = (bits + PICK_RADIX_BITS - 1) / PICK_RADIX_BITS;
  // the keys in index order into buffer 1, which pass 0 reads
  for (int q = tid; q < N; q += nt) {
    const int dt = dom_of(q);
    key_buf[1][q] = (dt >= 0 && r.m_n[q] > 0.0f) ? srank[dt] : static_cast<int>(m_s);
    node_buf[1][q] = q;
  }
  __syncthreads();
  // the digit counts [digit][warps + 1]: a warp's counters of distinct
  // digits in distinct banks, a thread's run of the digit-major scan
  // contiguous
  const int hs = b.nw + 1;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * PICK_RADIX_BITS;
    const int* src_k = key_buf[(pass + 1) & 1];
    const int* src_n = node_buf[(pass + 1) & 1];
    int* dst_k = key_buf[pass & 1];
    int* dst_n = node_buf[pass & 1];
    for (int d = b.lane; d < PICK_BUCKETS; d += 32) hist[d * hs + b.warp] = 0u;
    __syncwarp();
    // the warp's digit counts and each item's rank among its warp's items
    // of its digit (kept in registers up to PICK_REG_NPT items a lane,
    // replayed in the scatter above)
    auto rank_walk = [&](int j, unsigned& dig) -> unsigned {
      const int q = wbase + 32 * j + b.lane;
      dig = q < N ? (static_cast<unsigned>(src_k[q]) >> shift) & (PICK_BUCKETS - 1) : 0x100u;
      const unsigned peers = __match_any_sync(FULL, dig);
      const unsigned at = q < N ? hist[dig * hs + b.warp] + __popc(peers & lt_mask) : 0u;
      __syncwarp();
      if (q < N && b.lane == __ffs(peers) - 1) hist[dig * hs + b.warp] += __popc(peers);
      __syncwarp();
      return at;
    };
    unsigned rk[PICK_REG_NPT], dg[PICK_REG_NPT];
    if (J <= PICK_REG_NPT) {
#pragma unroll
      for (int j = 0; j < PICK_REG_NPT; ++j)
        if (j < J) rk[j] = rank_walk(j, dg[j]);
    } else {
      unsigned dig;
      for (int j = 0; j < J; ++j) rank_walk(j, dig);
    }
    __syncthreads();
    // digit-major offsets: flat f = digit * warps + warp, 8 per thread
    // (PICK_BUCKETS * warps = 8 * threads), stepped without a division
    constexpr int PER_T = PICK_BUCKETS / 32;
    const int f0 = tid * PER_T;
    int fd = f0 / b.nw, fw = f0 - fd * b.nw;
    unsigned v[PER_T];
    unsigned run = 0u;
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      v[i] = hist[fd * hs + fw];
      run += v[i];
      if (++fw == b.nw) {
        fw = 0;
        ++fd;
      }
    }
    run = block_excl_u(b, run);
    fd = f0 / b.nw;
    fw = f0 - fd * b.nw;
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      hist[fd * hs + fw] = run;
      run += v[i];
      if (++fw == b.nw) {
        fw = 0;
        ++fd;
      }
    }
    __syncthreads();
    // the scatter: the digit's offset for the warp plus the item's rank
    if (J <= PICK_REG_NPT) {
#pragma unroll
      for (int j = 0; j < PICK_REG_NPT; ++j) {
        const int q = wbase + 32 * j + b.lane;
        if (j < J && q < N) {
          const unsigned at = hist[dg[j] * hs + b.warp] + rk[j];
          dst_k[at] = src_k[q];
          dst_n[at] = src_n[q];
        }
      }
    } else {
      for (int j = 0; j < J; ++j) {
        unsigned dig;
        const unsigned at = rank_walk(j, dig);
        const int q = wbase + 32 * j + b.lane;
        if (q < N) {
          dst_k[at] = src_k[q];
          dst_n[at] = src_n[q];
        }
      }
    }
    __syncthreads();
  }
  const int* key_o = key_buf[(passes + 1) & 1];
  const int* node_o = node_buf[(passes + 1) & 1];
  PICK_COUNT(b, PP_STEPS, passes);
  PICK_STAMP(b, PP_RANK);

  // the JAX split formula on that order: the global prefix of the capped
  // intake (0 off the key), its running maximum at domain starts, the
  // difference; position q's own key and node
  const int per = (N + nt - 1) / nt;
  const int q0 = min(N, tid * per), q1 = min(N, q0 + per);
  const int ks = static_cast<int>(m_s);
  auto sorted = [&](int q, int& key, int& node) {
    key = key_o[q];
    node = node_o[q];
  };
  float run = 0.0f;
  for (int q = q0; q < q1; ++q) {
    int key, node;
    sorted(q, key, node);
    run += key < ks ? r.m_n[node] : 0.0f;
  }
  float total;
  const float before = block_excl(b, run, FAdd(), 0.0f, total);
  float loc = 0.0f, smax = -INFINITY;
  int prev = -1;
  if (q0 > 0 && q0 < q1) {
    int pn;
    sorted(q0 - 1, prev, pn);
  }
  for (int q = q0; q < q1; ++q) {
    int key, node;
    sorted(q, key, node);
    const float cap_o = key < ks ? r.m_n[node] : 0.0f;
    loc += cap_o;
    const float excl = (before + loc) - cap_o;
    smax = jmax(smax, (q == 0 || key != prev) ? excl : 0.0f);
    prev = key;
  }
  const float smax_before = block_excl(b, smax, FMax(), -INFINITY, total);
  loc = 0.0f;
  float seg = smax_before;
  prev = -1;
  if (q0 > 0 && q0 < q1) {
    int pn;
    sorted(q0 - 1, prev, pn);
  }
  for (int q = q0; q < q1; ++q) {
    int key, node;
    sorted(q, key, node);
    const float cap_o = key < ks ? r.m_n[node] : 0.0f;
    loc += cap_o;
    const float excl = (before + loc) - cap_o;
    seg = jmax(seg, (q == 0 || key != prev) ? excl : 0.0f);
    prev = key;
    const int dt = dom_of(node);
    const float x_o = key < ks ? x_dom[dt] : 0.0f;
    const float allow = jclip(x_o - (excl - seg), 0.0f, cap_o);
    m_tmp[node] = dt >= 0 ? allow : r.m_n[node];
  }
  __syncthreads();
  // the run-length clamp by ascending node index
  run = 0.0f;
  for (int n = q0; n < q1; ++n) run += m_tmp[n];
  const float before_m = block_excl(b, run, FAdd(), 0.0f, total);
  const float kf = static_cast<float>(r.k);
  loc = 0.0f;
  for (int n = q0; n < q1; ++n) {
    const float m = m_tmp[n];
    loc += m;
    r.m_n[n] = jclip(kf - ((before_m + loc) - m), 0.0f, m);
  }
  PICK_STAMP(b, PP_SPLIT);
  b.flush();
}

template <int NPT>
__global__ void __launch_bounds__(ROUND_THREADS) round_pick_threshold_kernel(StepCtx x, RoundCtx r) {
  __shared__ PickSlots slots;
  Blk b(&slots);
  threshold_pick<NPT>(x, r, b);
  b.flush();
}

// threads of the round's block and the nodes per thread of the threshold
// template (0: the nodes' rows re-read from global memory)
__host__ inline int pick_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > ROUND_THREADS ? ROUND_THREADS : t);
}
__host__ inline int pick_npt(int n) {
  const int per = (n + pick_threads(n) - 1) / pick_threads(n);
  if (per <= 1) return 1;
  if (per <= 2) return 2;
  if (per <= 4) return 4;
  return per <= PICK_REG_NPT ? PICK_REG_NPT : 0;
}

template <int NPT>
int launch_threshold(const StepCtx& x, const RoundCtx& r, int threads, cudaStream_t s) {
  round_pick_threshold_kernel<NPT><<<1, threads, 0, s>>>(x, r);
  return launch_status();
}

extern "C" int simtpu_round_pick(const StepCtx* ctx, const RoundCtx* r, void* stream) {
  const int n = ctx->n;
  const int threads = pick_threads(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((r->mode & RV_QUOTA) && (ctx->flags & F_TOPOLOGY) && ctx->tc > 0) {
    const size_t smem = static_cast<size_t>(quota_smem_ints(n, ctx->tc, threads)) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(round_pick_quota_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    round_pick_quota_kernel<<<1, threads, smem, s>>>(*ctx, *r);
    return launch_status();
  }
  switch (pick_npt(n)) {
    case 1: return launch_threshold<1>(*ctx, *r, threads, s);
    case 2: return launch_threshold<2>(*ctx, *r, threads, s);
    case 4: return launch_threshold<4>(*ctx, *r, threads, s);
    case PICK_REG_NPT: return launch_threshold<PICK_REG_NPT>(*ctx, *r, threads, s);
    default: return launch_threshold<0>(*ctx, *r, threads, s);
  }
}

#ifdef SIMTPU_PICK_PROFILE
// the profile build's phase cycles (PICK_PROF_SLOTS words) into `out`
// (host memory), then zeroed; synchronizes the device
extern "C" int simtpu_round_pick_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pick_prof, sizeof(pick_prof));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[PICK_PROF_SLOTS] = {};
  e = cudaMemcpyToSymbol(pick_prof, zero, sizeof(pick_prof));
  return static_cast<int>(e);
}
#endif
