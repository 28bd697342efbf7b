// K10 wave_hard: one hard or heavy same-group run of pods [a, b), placed in
// one launch.
//
// Replaces the JAX package's simtpu/engine/scan.py wavefront_scan (:1796)
// with its hard verifier _wave_verify_hard (:2035-2420), jitted through
// _run_wavefront (:2794), for runs that own a hard term (DoNotSchedule
// skew, required (anti-)affinity) or carry heavy bits (host ports,
// volumes, Open-Local storage, GPU shares). The result is exactly what the
// serial chain K1->(K5)->(K6)->K2->K3->K4 gives pod by pod: the same
// per-node device code (node_stages.cuh, ext_plans.cuh, topology.cuh,
// scores.cuh) in the same order.
//
// Design: one block of up to WAVE_THREADS threads, persistent over the
// run's pods, threads striding over the nodes. Once per launch it stages
// the run-constant stage bits: the static mask row, and the ports, volume
// and attach verdicts of the families the run adds nothing to (a heavy
// family's stage is recomputed per step; a heavy bit takes effect only
// when its StepFlags flag is set too, as in the JAX package). Each step
// then, separated by barriers:
//   1. the stage byte per node: the staged bits, the resource fit and the
//      heavy stages against the occupancy planes as they stand; the
//      Open-Local plan (K5's code) and the GPU plan (K6's code) for a pod
//      that demands them, re-reading the planes the previous commit moved;
//   2. the hard-spread minimum per term (shared-memory atomicMin) and the
//      spread and inter-pod filters and raw counts over the group's term
//      rows (K2's code);
//   3. the normalizers, the score, the argmax and the reason (K3's code);
//   4. the commit at the chosen node and the count planes of its domains,
//      with the pod's extended plans written to its output rows (K4's code).
//
// Bound: at the serial path's sizes (N <= 1024, runs of up to 1024 pods)
// each step is four block-wide passes over N nodes with barriers between
// them: latency, not bytes — the bytes a run must move take well under a
// microsecond at 3.35 TB/s.
#include "ext_plans.cuh"
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"

__global__ void __launch_bounds__(WAVE_THREADS) wave_hard_kernel(StepCtx x, WaveCtx w) {
  extern __shared__ int min_bits[];  // [tc] per-term eligible minimum
  const int N = x.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int g = x.group[w.a];
  const int f = x.flags;
  const int heavy = w.mode >> WAVE_HEAVY_SHIFT;
  const bool heavy_ports = (heavy & HEAVY_PORTS) && (f & F_PORTS);
  const bool heavy_vols = (heavy & HEAVY_VOLS) && (f & (F_VOLS | F_ATTACH));
  const bool vols_live = heavy_vols && (f & F_VOLS);
  const bool att_live = heavy_vols && (f & F_ATTACH);
  const size_t gn0 = static_cast<size_t>(g) * N;

  // -- the run-constant stages, once per launch ----------------------------------
  for (int n = tid; n < N; n += nt) {
    const bool st = x.static_mask[gn0 + n] && x.node_valid[n];
    const bool pok = !(f & F_PORTS) || heavy_ports || ports_free(x, g, n);
    const bool vok = !(f & F_VOLS) || heavy_vols || vols_free(x, g, n);
    const bool aok = !(f & F_ATTACH) || heavy_vols || attach_ok(x, g, n);
    w.bits[n] = static_cast<uint8_t>((st ? 1u : 0u) | (pok ? 2u : 0u) | (vok ? 4u : 0u) |
                                     (aok ? 8u : 0u) | (x.vol_mask[gn0 + n] ? 16u : 0u));
  }
  __syncthreads();

  for (int i = w.a; i < w.b; ++i) {
    const float* req = x.req + static_cast<size_t>(i) * x.r;
    const unsigned live = x.ext_live[i];
    // 1. the stage byte (bits 0-5) and the storage and GPU plans
    for (int n = tid; n < N; n += nt) {
      const unsigned b = w.bits[n];
      bool m = b & 1u;
      unsigned s = m ? 1u : 0u;
      m = m && (b & 2u) && (!heavy_ports || ports_free(x, g, n));
      s |= (m ? 1u : 0u) << 1;
      m = m && res_fit(x, req, n);
      s |= (m ? 1u : 0u) << 2;
      m = m && (b & 4u) && (!vols_live || vols_free(x, g, n));
      s |= (m ? 1u : 0u) << 3;
      m = m && (b & 8u) && (!att_live || attach_ok(x, g, n));
      s |= (m ? 1u : 0u) << 4;
      m = m && (b & 16u);
      s |= (m ? 1u : 0u) << 5;
      x.stage[n] = static_cast<uint8_t>(s);
      if (live & LIVE_STORAGE) storage_node(x, i, n);
      if (live & LIVE_GPU) gpu_node(x, i, n);
    }
    __syncthreads();
    // 2. spread and inter-pod filters, raw counts
    topology_block(x, i, min_bits);
    __syncthreads();
    // 3. score, argmax, reason
    score_argmax_block(x, i);
    __syncthreads();
    // 4. the commit
    for (int n = tid; n < N; n += nt) commit_node(x, i, n);
    __syncthreads();
  }
}

extern "C" int simtpu_wave_hard(const StepCtx* ctx, const WaveCtx* w, void* stream) {
  int threads = ((ctx->n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > WAVE_THREADS ? WAVE_THREADS : threads);
  const size_t smem = static_cast<size_t>(ctx->tc) * sizeof(int);
  wave_hard_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(*ctx, *w);
  return launch_status();
}
