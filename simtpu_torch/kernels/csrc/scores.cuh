// Device code of the score sum (K3), shared by score_argmax_pod.cu and the
// wave kernels wave_lean.cu (K9) and wave_hard.cu (K10): the plugin
// scores, their normalizers and the running sum in the JAX package's term
// order with the arithmetic of its compiled step, whose weights are
// runtime values (simtpu_torch/kernels/scores.py, "the step's
// composition"): the resource pair with two roundings, the Simon
// numerator, the Simon term unless node affinity follows, every later
// term and the static pair as FMAs. One source for every path, so an FMA
// site cannot drift between the per-pod step and the waves.
//
// The JAX package's simtpu/engine/scan.py score_pod (scan.py:595-727),
// the Open-Local term of filter_and_score (scan.py:970-993),
// StepEval.fail_code (scan.py:583) and the argmax at scan.py:1045-1057,
// with simtpu/kernels/scores.py's plugin scores and normalizers.
#pragma once
#include "step_ctx.cuh"

constexpr float ZW = 0.666666687f;  // f32(2/3), SelectorSpread zone weighting

// Simon's dominant share before the x100 (scores.py _dominant_share)
__device__ inline float dominant_share(const StepCtx& x, int n, const float* req) {
  const float* al = x.alloc + static_cast<size_t>(n) * x.r;
  float best = -INFINITY;
  for (int r = 0; r < x.r; ++r) {
    const float a = al[r], q = req[r];
    const float denom = a - q;
    float share = denom == 0.0f ? (q == 0.0f ? 0.0f : 1.0f) : __fdiv_rn(q, denom);
    if (!(a > 0.0f)) share = 0.0f;
    best = fmaxf(best, share);
  }
  return fmaxf(best, 0.0f);
}

// w0 * least_allocated + w1 * balanced_allocation as the compiled
// reference computes it (scores.py resource_base_score):
// (frac_cpu + frac_mem) * (w0 * 50) + (1 - |bcpu - bmem|) * (w1 * 100),
// each product rounded
__device__ inline float resource_base(const StepCtx& x, int n, const float* req, float w0, float w1) {
  const float* al = x.alloc + static_cast<size_t>(n) * x.r;
  const float* fr = x.free + static_cast<size_t>(n) * x.r;
  float frac[2], bfrac[2];
  const int cols[2] = {RES_CPU, RES_MEMORY};
  for (int k = 0; k < 2; ++k) {
    const float a = al[cols[k]];
    const float fa = fr[cols[k]] - req[cols[k]];
    frac[k] = a > 0.0f ? __fdiv_rn(fmaxf(fa, 0.0f), fmaxf(a, TINY)) : 0.0f;
    const float used = (a - fr[cols[k]]) + req[cols[k]];
    bfrac[k] = a > 0.0f ? __fdiv_rn(used, fmaxf(a, TINY)) : 1.0f;
  }
  const float balanced = (1.0f - fabsf(bfrac[0] - bfrac[1])) * (w1 * MAX_NODE_SCORE);
  return (frac[0] + frac[1]) * (w0 * 50.0f) + balanced;
}

__device__ inline float minmax_norm(float v, float lo, float hi) {
  const float rng = hi - lo;
  return rng > 0.0f ? __fdiv_rn((v - lo) * MAX_NODE_SCORE, fmaxf(rng, TINY)) : 0.0f;
}

__device__ inline float inv_minmax(float v, float lo, float hi) {
  const float rng = hi - lo;
  return rng > 0.0f ? __fdiv_rn(MAX_NODE_SCORE * (hi - v), fmaxf(rng, TINY)) : MAX_NODE_SCORE;
}

__device__ inline float inv_max(float v, float hi) {
  return hi > 0.0f ? __fdiv_rn(MAX_NODE_SCORE * (hi - v), fmaxf(hi, TINY)) : MAX_NODE_SCORE;
}

// Simon min-max of a share (before the x100) over extremes of the x100
// shares, with the reference's contracted numerator share*100 - lo
__device__ inline float simon_term(float share, float lo, float hi) {
  const float rng = hi - lo;
  const float num = __fmaf_rn(share, MAX_NODE_SCORE, -lo);
  return rng > 0.0f ? __fdiv_rn(num * MAX_NODE_SCORE, fmaxf(rng, TINY)) : 0.0f;
}

// TaintToleration: reverse-normalized intolerable count
__device__ inline float taint_term(float v, float hi) {
  return hi > 0.0f ? MAX_NODE_SCORE * (1.0f - __fdiv_rn(v, fmaxf(hi, TINY))) : MAX_NODE_SCORE;
}

// InterPodAffinity: scaled by the masked max |raw|
__device__ inline float maxabs_term(float raw, float m) {
  return m > 0.0f ? __fdiv_rn(raw * MAX_NODE_SCORE, fmaxf(m, TINY)) : 0.0f;
}

// SelectorSpread from the host and zone counts and their masked maxima;
// the zone blend carries the compiled reference's FMA contraction
__device__ inline float ss_term(float host, float zone, float hi_host, float hi_zone, bool any_zone) {
  const float node_s = inv_max(host, hi_host);
  const float zone_s = inv_max(zone, hi_zone);
  return (any_zone && hi_zone > 0.0f) ? __fmaf_rn(ZW, zone_s, (1.0f - ZW) * node_s) : node_s;
}

// the normalized plugin terms of one node
struct ScoreTerms {
  float simon, node_pref, taint, ipa, soft, ss;
};

// The running score sum of one node before the mask: the resource pair
// `base`, then each term the flags keep, in the reference's order
// (`terms`: the pod's group has term rows)
__device__ inline float compose_score(const float* w_, int f, bool terms, float base,
                                      const ScoreTerms& t, float static_score, float avoid) {
  float s = base;
  // one FMA, except when the node-affinity term follows (scores.py)
  s = (f & F_NODE_PREF) ? s + (w_[2] + w_[3]) * t.simon : __fmaf_rn(w_[2] + w_[3], t.simon, s);
  if (f & F_NODE_PREF) s = __fmaf_rn(w_[4], t.node_pref, s);
  if (f & F_TAINT_PREF) s = __fmaf_rn(w_[5], t.taint, s);
  if (terms && (f & (F_INTERPOD_PREF | F_INTERPOD_REQ))) s = __fmaf_rn(w_[6], t.ipa, s);
  if (terms && (f & F_SPREAD_SOFT)) s = __fmaf_rn(w_[7], t.soft, s);
  if (terms && (f & F_SELECTOR_SPREAD)) s = __fmaf_rn(w_[8], t.ss, s);
  if (f & F_STATIC_SCORE) s = s + __fmaf_rn(w_[9], static_score, w_[11] * avoid);
  return s;
}

// the better of two (score, node) candidates: higher score, lowest index
// on ties (all -inf gives the lowest index)
__device__ inline void argmax_merge(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
}

// Block-wide argmax of per-thread (bv, bi); every thread gets the result.
// `sh_bv` / `sh_bi` hold one slot per warp; ends with a barrier, so the
// slots may be reused after it.
__device__ inline void block_argmax(float& bv, int& bi, float* sh_bv, int* sh_bi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    argmax_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off), __shfl_xor_sync(0xffffffffu, bi, off));
  }
  if (lane == 0) { sh_bv[warp] = bv; sh_bi[warp] = bi; }
  __syncthreads();
  bv = sh_bv[0];
  bi = sh_bi[0];
  for (int w = 1; w < n_warps; ++w) argmax_merge(bv, bi, sh_bv[w], sh_bi[w]);
  __syncthreads();
}

// First stage (FILTER_CASCADE order) that no node passes, from the OR of
// the nodes' cascade bits: 0 static, 1 ports, 2 resources, 3 volumes,
// 4 attach, 5 bind, 6 storage, 7 GPU, 8 spread; FAIL_INTERPOD when all
// of them have a node
__device__ inline int fail_code(unsigned any) {
  const int stage_code[9] = {FAIL_STATIC, FAIL_PORTS, FAIL_RESOURCES, FAIL_VOLUME, FAIL_ATTACH,
                             FAIL_VOLUME_BIND, FAIL_STORAGE, FAIL_GPU, FAIL_SPREAD};
  int fail = FAIL_INTERPOD;
  for (int k = 8; k >= 0; --k)
    if (!((any >> k) & 1u)) fail = stage_code[k];
  return fail;
}

// The ten cumulative cascade bits of node n, in FILTER_CASCADE order:
// 0 static, 1 ports, 2 resources, 3 volumes, 4 attach, 5 bind (the stage
// byte's bits 0-5), 6 storage, 7 GPU (bit 5 ANDed with the K5 / K6
// verdicts of a pod that ran them), 8 spread, 9 all (the byte's bits 6-7
// ANDed with both verdicts: AND commutes). The one map from the stage
// byte to StepEval's ten masks, shared by K3, K20 and K21.
constexpr unsigned CASCADE_ALL = 1u << 9;
constexpr int N_CASCADE = 10;

__device__ inline unsigned cascade_bits(const StepCtx& x, int n, bool st_live, bool gpu_live) {
  const unsigned s = x.stage[n];
  const bool ext_ok = (!st_live || x.st_ok[n]) && (!gpu_live || x.gpu_ok[n]);
  const bool st = ((s >> 5) & 1u) && (!st_live || x.st_ok[n]);
  const bool gp = st && (!gpu_live || x.gpu_ok[n]);
  return (s & 0x3Fu) | (st ? 1u << 6 : 0u) | (gp ? 1u << 7 : 0u) |
         (((s >> 6) & 1u) && ext_ok ? 1u << 8 : 0u) | (((s >> 7) & 1u) && ext_ok ? 1u << 9 : 0u);
}

// The masked normalizers of pod i's score over the feasible nodes and the
// OR of every node's cascade bits (score_norms_block).
struct ScoreNorms {
  static constexpr int N_MIN = 4;  // simon, node_pref, soft spread, open-local
  static constexpr int N_MAX = 8;  // simon, node_pref, taint, |ipa|, soft spread, ss host, ss zone, open-local
  float lo[N_MIN], hi[N_MAX];
  unsigned any;   // OR of the cascade bits of every node
  bool any_zone;  // the group has a SelectorSpread zone term
};

// Pass 1 of K3 for pod i, block-wide: the stage bits' OR and the masked
// normalizers — Simon share min/max, node-affinity min/max, taint max,
// inter-pod max |raw|, soft-spread min/max, SelectorSpread host/zone max,
// Open-Local raw min/max — over the feasible nodes (min/max are
// order-free: bit-exact). Every thread gets the result; ends with a
// barrier.
__device__ inline void score_norms_block(const StepCtx& x, int i, ScoreNorms& nm) {
  constexpr int N_MIN = ScoreNorms::N_MIN;
  constexpr int N_MAX = ScoreNorms::N_MAX;
  __shared__ float sh_min[32][N_MIN];
  __shared__ float sh_max[32][N_MAX];
  __shared__ unsigned any_bits;
  const int N = x.n;
  const int g = x.group[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned live = x.ext_live[i];
  const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
  if (threadIdx.x == 0) any_bits = 0u;
  __syncthreads();
  float* lo = nm.lo;
  float* hi = nm.hi;
  for (int k = 0; k < N_MIN; ++k) lo[k] = BIG;
  hi[0] = -BIG; hi[1] = -BIG; hi[2] = 0.0f; hi[3] = 0.0f; hi[4] = -BIG; hi[5] = 0.0f; hi[6] = 0.0f;
  hi[7] = -BIG;
  unsigned bits = 0u;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const unsigned s = cascade_bits(x, n, st_live, gpu_live);
    bits |= s;
    if (!(s & CASCADE_ALL)) continue;
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
    const float ol = st_live ? x.st_raw[n] : 0.0f;
    lo[3] = fminf(lo[3], ol); hi[7] = fmaxf(hi[7], ol);
  }
  atomicOr(&any_bits, bits);
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
  nm.any = any_bits;
  bool any_zone = false;
  for (int t = 0; t < x.tc; ++t) any_zone = any_zone || x.ss_zone[static_cast<size_t>(g) * x.tc + t];
  nm.any_zone = any_zone;
  __syncthreads();
}

// Pass 2 of K3 at node n for pod i: the weighted score in the reference's
// term order (compose_score), the mask, then the Open-Local term
// w10 * minmax(raw) (a pod that skipped K5 has raw 0, which normalizes to
// 0). `t_out` / `s_nos` (optional) receive the normalized terms and the
// score before the Open-Local term.
__device__ inline float node_score(const StepCtx& x, int i, int n, const ScoreNorms& nm,
                                   ScoreTerms* t_out = nullptr, float* s_nos = nullptr) {
  const int N = x.n;
  const int g = x.group[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * N;
  const unsigned live = x.ext_live[i];
  const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
  const float* lo = nm.lo;
  const float* hi = nm.hi;
  const float* w_ = x.score_w;
  const int f = x.flags;
  ScoreTerms t;
  t.simon = simon_term(dominant_share(x, n, req), lo[0], hi[0]);
  t.node_pref = minmax_norm(x.node_pref[gn + n], lo[1], hi[1]);
  t.taint = taint_term(x.taint_intol[gn + n], hi[2]);
  t.ipa = maxabs_term(x.raw[n], hi[3]);
  t.soft = inv_minmax(x.raw[N + n], lo[2], hi[4]);
  t.ss = ss_term(x.raw[2 * N + n], x.raw[3 * N + n], hi[5], hi[6], nm.any_zone);
  float s = compose_score(w_, f, x.tc > 0, resource_base(x, n, req, w_[0], w_[1]), t,
                          x.static_score[gn + n], x.avoid_pen[gn + n]);
  if (!(cascade_bits(x, n, st_live, gpu_live) & CASCADE_ALL)) s = -INFINITY;
  if (s_nos) *s_nos = s;
  if (t_out) *t_out = t;
  if (f & F_STORAGE) s = __fmaf_rn(w_[10], minmax_norm(st_live ? x.st_raw[n] : 0.0f, lo[3], hi[7]), s);
  return s;
}
