// K21 pod_terms: one pod's total score and its 12 raw plugin term rows.
//
// Replaces the JAX package's simtpu/explain/scores.py _eval_pod_terms
// (:95): the engine's total score vector (-inf outside m_all) and the raw
// (pre-weight) normalized term vectors in PLUGIN_TERMS order — least
// allocated, balanced allocation, Simon (twice: the Simon and the
// Open-Gpu-Share rows), node affinity, taint toleration, inter-pod
// affinity, topology spread, selector spread, image locality, avoid-pods,
// and Open-Local = (score - score_nostorage) / w[10] (0 where w[10] == 0).
//
// Runs after K1 -> (K5) -> (K6) -> K2 for the pod, in the place K3 takes
// in the serial step, and reuses K3's code (scores.cuh score_norms_block,
// node_score): its score is K3's bit for bit, so the recomputed argmax is
// the recorded landing node. The raw rows follow the JAX package's
// standalone plugin functions (simtpu_torch/kernels/scores.py), which
// compute least/balanced and the Simon min-max without the step's FMA
// contractions; they are held to a tolerance, not bit for bit. One block
// walks the nodes twice: pass 1 the normalizers, pass 2 each node's
// score, the score before the Open-Local term and the 12 terms.
//
// Bound: bytes — the stage byte, the raw rows, alloc and free, the
// group's score rows and the storage verdict and raw score are read once,
// score [N] and terms [12, N] written once.
#include "scores.cuh"

constexpr int N_TERMS = 12;

__global__ void pod_terms_kernel(StepCtx x, int i, float* terms) {
  const int N = x.n;
  const int g = x.group[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * N;
  const float w10 = x.score_w[10];
  ScoreNorms nm;
  score_norms_block(x, i, nm);
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    ScoreTerms t;
    float s_nos;
    const float s = node_score(x, i, n, nm, &t, &s_nos);
    x.score[n] = s;
    // least / balanced allocation as the standalone plugin functions
    const float* al = x.alloc + static_cast<size_t>(n) * x.r;
    const float* fr = x.free + static_cast<size_t>(n) * x.r;
    float frac[2], bfrac[2];
    const int cols[2] = {RES_CPU, RES_MEMORY};
    for (int c = 0; c < 2; ++c) {
      const float a = al[cols[c]];
      frac[c] = a > 0.0f ? __fdiv_rn(fmaxf(fr[cols[c]] - req[cols[c]], 0.0f), fmaxf(a, TINY)) : 0.0f;
      bfrac[c] = a > 0.0f ? __fdiv_rn((a - fr[cols[c]]) + req[cols[c]], fmaxf(a, TINY)) : 1.0f;
    }
    const float least = __fdiv_rn(frac[0] + frac[1], 2.0f) * MAX_NODE_SCORE;
    const float balanced = (1.0f - fabsf(bfrac[0] - bfrac[1])) * MAX_NODE_SCORE;
    const float simon = minmax_norm(dominant_share(x, n, req) * MAX_NODE_SCORE, nm.lo[0], nm.hi[0]);
    const float storage = w10 != 0.0f ? __fdiv_rn(s - s_nos, w10) : 0.0f;
    const float row[N_TERMS] = {least, balanced, simon, simon, t.node_pref, t.taint, t.ipa, t.soft, t.ss,
                                x.static_score[gn + n], x.avoid_pen[gn + n], storage};
    for (int r = 0; r < N_TERMS; ++r) terms[static_cast<size_t>(r) * N + n] = row[r];
  }
}

extern "C" int simtpu_pod_terms(const StepCtx* ctx, int i, float* terms, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  pod_terms_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i, terms);
  return launch_status();
}
