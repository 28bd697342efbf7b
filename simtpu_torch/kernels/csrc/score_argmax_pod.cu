// K3 score_argmax_pod: score, first failing stage, argmax and reason.
//
// Replaces the JAX package's simtpu/engine/scan.py score_pod
// (scan.py:595-727), the Open-Local term of filter_and_score
// (scan.py:970-993), StepEval.fail_code (scan.py:583) and the argmax and
// reason at scan.py:1045-1057, with the plugin scores and normalizers of
// simtpu/kernels/scores.py. For a pod that ran K5 (K6) the storage (GPU)
// verdict is ANDed into the cascade after the bind stage, so the stages
// are static, ports, resources, volumes, attach, bind, storage, GPU,
// spread, all (FILTER_CASCADE).
//
// Design: K9's step shape (wave.cuh). One block of up to SCORE_BLOCK
// threads, node n owned by thread n % threads as its (n / threads)-th
// node; the plan is the wrapper's (kernels/cuda.py score_plan): one node
// a thread, its inputs kept in registers, up to 1024 nodes, and past that
// several nodes a thread, their inputs read again in pass 2 (`global`; 2
// and 4 nodes a thread in registers measured no faster there on the card).
//   pass 1: each thread reads its nodes' inputs once into registers — the
//           cascade bits, and for a feasible node the dominant share, the
//           resource score pair (scores.cuh resource_base), node affinity,
//           taint, the four count raws, the static pair — and the
//           Open-Local raw; then one reduction (wave.cuh block_minmax_or,
//           one barrier) gives every thread the stage bits' OR and the
//           masked normalizers — Simon share min/max, node-affinity
//           min/max, taint max, inter-pod max |raw|, soft-spread min/max,
//           SelectorSpread host/zone max, Open-Local raw min/max (min/max
//           are order-free: bit-exact). Warp 0 takes the group's
//           SelectorSpread zone flag with one ballot meanwhile.
//   pass 2: each node's weighted score from its registers in the JAX
//           package's term order with the arithmetic of its compiled step
//           (scores.cuh compose_score, as node_score forms it: an
//           infeasible node's score is -inf whatever its terms), then the
//           Open-Local term w10 * minmax(raw), then the argmax with the
//           lowest index on ties (all -inf gives 0; block_argmax_or, one
//           barrier).
// Thread 0 applies the forced-pod override and writes chosen, placed,
// reason and out_node for pod i.
//
// Bound: bytes — stage [N], raw [4,N], alloc and free [N,R], the group's
// four [N] score rows and the storage/GPU verdicts and raw score are read
// once, score [N] written once; at N <= 1024 a few microseconds of
// dependent loads, divisions and two barriers on one SM.
#include "scores.cuh"
#include "wave.cuh"

constexpr int SCORE_BLOCK = 1024;
// the template's nodes a thread: 1 kept in registers, 0 = the inputs read
// again in pass 2
constexpr int SCORE_REG_NPT = 1;
constexpr int SCORE_GLOBAL_NPT = 0;

// Mirrored field for field by simtpu_torch/kernels/cuda.py ScorePlan.
struct ScorePlan {
  int threads, npt;
};

namespace {

// one node's inputs to the score (a feasible node's; an infeasible one
// keeps its Open-Local raw alone)
struct NodeIn {
  float share, pref, taint, ipa, soft, ss_host, ss_zone, ol, base, stat, avoid;
  bool all;
};

// normalizers: lo simon, node_pref, soft spread, open-local; hi simon,
// node_pref, taint, |ipa|, soft spread, ss host, ss zone, open-local
using Norms = MinMaxOr<ScoreNorms::N_MIN, ScoreNorms::N_MAX>;

template <int NPT>
__global__ void __launch_bounds__(SCORE_BLOCK) score_argmax_pod_kernel(StepCtx x, int i) {
  __shared__ unsigned slots_m[32 * Norms::WORDS];
  __shared__ ArgOrSlot slots_a[32];
  __shared__ bool sh_zone;
  const int N = x.n;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int nj = NPT > 0 ? NPT : (N + nt - 1) / nt;
  const int g = x.group[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * N;
  const unsigned live = x.ext_live[i];
  const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
  const float* w_ = x.score_w;
  const int f = x.flags;

  // the SelectorSpread zone flag of the group, one warp and a ballot
  if (tid < 32) {
    bool z = false;
    for (int t = tid; t < x.tc; t += 32) z = z || x.ss_zone[static_cast<size_t>(g) * x.tc + t];
    const bool any = __any_sync(0xffffffffu, z);
    if (tid == 0) sh_zone = any;
  }

  auto load = [&](int n, unsigned& bits) {
    NodeIn in{};
    const unsigned cb = cascade_bits(x, n, st_live, gpu_live);
    bits |= cb;
    in.all = (cb & CASCADE_ALL) != 0u;
    in.ol = st_live ? x.st_raw[n] : 0.0f;
    if (in.all) {
      in.share = dominant_share(x, n, req);
      in.pref = x.node_pref[gn + n];
      in.taint = x.taint_intol[gn + n];
      in.ipa = x.raw[n];
      in.soft = x.raw[N + n];
      in.ss_host = x.raw[2 * N + n];
      in.ss_zone = x.raw[3 * N + n];
      in.base = resource_base(x, n, req, w_[0], w_[1]);
      in.stat = x.static_score[gn + n];
      in.avoid = x.avoid_pen[gn + n];
    }
    return in;
  };

  // pass 1: the inputs, the stage bits' OR and the normalizers
  NodeIn reg[NPT > 0 ? NPT : 1];
  Norms m{{BIG, BIG, BIG, BIG}, {-BIG, -BIG, 0.0f, 0.0f, -BIG, 0.0f, 0.0f, -BIG}, 0u};
#pragma unroll
  for (int j = 0; j < (NPT > 0 ? NPT : nj); ++j) {
    const int n = tid + j * nt;
    if (n >= N) continue;
    const NodeIn in = load(n, m.bits);
    if (NPT > 0) reg[NPT > 0 ? j : 0] = in;
    if (!in.all) continue;
    const float sim = in.share * MAX_NODE_SCORE;
    m.lo[0] = fminf(m.lo[0], sim); m.hi[0] = fmaxf(m.hi[0], sim);
    m.lo[1] = fminf(m.lo[1], in.pref); m.hi[1] = fmaxf(m.hi[1], in.pref);
    m.hi[2] = fmaxf(m.hi[2], in.taint);
    m.hi[3] = fmaxf(m.hi[3], fabsf(in.ipa));
    m.lo[2] = fminf(m.lo[2], in.soft); m.hi[4] = fmaxf(m.hi[4], in.soft);
    m.hi[5] = fmaxf(m.hi[5], in.ss_host);
    m.hi[6] = fmaxf(m.hi[6], in.ss_zone);
    m.lo[3] = fminf(m.lo[3], in.ol); m.hi[7] = fmaxf(m.hi[7], in.ol);
  }
  m = block_minmax_or(m, slots_m);
  const bool any_zone = sh_zone;

  // pass 2: the scores from the registers and the argmax
  ArgOr r = ArgOr::identity();
#pragma unroll
  for (int j = 0; j < (NPT > 0 ? NPT : nj); ++j) {
    const int n = tid + j * nt;
    if (n >= N) continue;
    unsigned unused = 0u;
    const NodeIn in = NPT > 0 ? reg[NPT > 0 ? j : 0] : load(n, unused);
    float s = -INFINITY;
    if (in.all) {
      ScoreTerms t;
      t.simon = simon_term(in.share, m.lo[0], m.hi[0]);
      t.node_pref = minmax_norm(in.pref, m.lo[1], m.hi[1]);
      t.taint = taint_term(in.taint, m.hi[2]);
      t.ipa = maxabs_term(in.ipa, m.hi[3]);
      t.soft = inv_minmax(in.soft, m.lo[2], m.hi[4]);
      t.ss = ss_term(in.ss_host, in.ss_zone, m.hi[5], m.hi[6], any_zone);
      s = compose_score(w_, f, x.tc > 0, in.base, t, in.stat, in.avoid);
    }
    if (f & F_STORAGE) s = __fmaf_rn(w_[10], minmax_norm(in.ol, m.lo[3], m.hi[7]), s);
    x.score[n] = s;
    r.merge({s, n, 0u});
  }
  r = block_argmax_or(r, slots_a);
  if (tid != 0) return;
  const unsigned any = m.bits;
  const int fail = fail_code(any);
  const bool forced = x.forced[i];
  const int pin = x.pin[i];
  const int pin_c = pin < 0 ? 0 : (pin >= N ? N - 1 : pin);
  const int chosen = forced ? pin : r.bi;
  const bool placed = forced ? (pin >= 0 && x.node_valid[pin_c]) : ((any & CASCADE_ALL) != 0u);
  x.chosen[i] = chosen;
  x.placed[i] = placed ? 1 : 0;
  x.reason[i] = placed ? OK : (forced ? FAIL_NO_NODE : fail);
  x.out_node[i] = placed ? chosen : -1;
}

template <int NPT>
int launch_score(const StepCtx& x, int i, int threads, cudaStream_t st) {
  score_argmax_pod_kernel<NPT><<<1, threads, 0, st>>>(x, i);
  return launch_status();
}

}  // namespace

extern "C" int simtpu_score_argmax_pod(const StepCtx* ctx, int i, const ScorePlan* plan, void* stream) {
  // the launch follows the wrapper's plan (kernels/cuda.py score_plan);
  // one whose threads and register nodes do not cover the nodes is refused
  const int t = plan->threads, npt = plan->npt;
  if (t < 32 || t > SCORE_BLOCK || t % 32 != 0 || (npt > 0 && static_cast<long long>(t) * npt < ctx->n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case SCORE_REG_NPT: return launch_score<SCORE_REG_NPT>(*ctx, i, t, st);
    case SCORE_GLOBAL_NPT: return launch_score<SCORE_GLOBAL_NPT>(*ctx, i, t, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
