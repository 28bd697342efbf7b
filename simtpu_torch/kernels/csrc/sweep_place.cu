// K19 sweep_place: the requeue of every scenario of a sweep chunk, one
// block per scenario, persistent over its pod list.
//
// Replaces the vmapped schedule_step scan of the JAX package's
// simtpu/faults/sweep.py _fault_sweep (:71-75) and of
// simtpu/parallel/sweep.py _sweep_scan (:65-67): per scenario, a
// lax.scan of simtpu/engine/scan.py schedule_step over the scenario's pods
// against statics whose node_valid is the scenario's surviving mask. The
// result is exactly what the serial chain K1->(K5)->(K6)->K2->K3->K4 gives
// pod by pod on the scenario's own state: the same per-node device code
// (node_stages.cuh, ext_plans.cuh, topology.cuh, scores.cuh) in the same
// order, as K10 wave_hard runs it.
//
// Design: K10's layout (wave.cuh) with the scenario axis as the grid.
// Block s takes the single-scenario StepCtx with every state plane moved
// to replica s (written by K18), its node_valid to row s of the surviving
// masks (base & ~failed), K5/K6's scratch rows and the per-pod outputs to
// block s's own copies (sweep_block_ctx). It walks row s of SweepCtx.idx
// (rows into the whole batch's pod arrays) and stops at the first padded
// row: JAX puts its phantom rows after every real pod and masks their
// outputs on the host, so skipping them is exact.
//   - One block of up to 1024 threads, one thread per node up to 1024
//     nodes (2 or 4 per thread up to 4096, a template parameter; past
//     that the step rows live in SweepCtx.carry, global memory, through
//     the same code). The step's per-node values (stage bits, the four
//     raws, the cascade bits, the score) stay in registers; the Simon
//     share and the resource score pair are kept across steps and
//     recomputed only where the request or the node's free row moved, and
//     K5's and K6's verdicts and scores likewise (K10's rule: the plans
//     rerun at the chosen node only while consecutive pods claim alike).
//   - The staged pods and the minima below sit in shared memory up to
//     the plan's 200 KB and past it in the scenario's slab of global
//     scratch (wave.cuh wave_seg; kernels/cuda.py sweep_place_plan): any
//     number of term columns.
//   - The replica's free rows are staged once per launch in shared memory
//     (resource-major) and written back at the end; the other replica
//     rows a step reads (the count and own-plane rows of the pod's terms,
//     ports, volumes, storage, GPU) are read in place: the group changes
//     from pod to pod, so K10's once-per-launch staging of term columns
//     does not apply. What is staged per pod instead is the pod itself:
//     its row, group, pin, request and its group's term columns (term,
//     key, interpod row, flags, weights), written into one of two shared
//     buffers while the previous pod is scored and read by every thread
//     after that step's argmax barrier.
//   - Each step, one barrier per reduction (wave.cuh's redux.sync folds):
//       A. (only for a pod whose group has a DoNotSchedule column) the
//          per-term minimum over the eligible nodes;
//       B. the stage byte (K1), the storage and GPU plans where the pod
//          claims them (K5's and K6's code), the spread and
//          inter-pod filters and raw counts (K2), the cascade bits and
//          every normalizer of K3, with the OR of the bits;
//       C. the score (K3's node_score arithmetic) and the argmax;
//     then the commit at the owner threads in K4's order (the chosen
//     node's rows at its owner, each node's count rows at its owner,
//     cnt_total at thread 0), and a barrier where the next pod's
//     inter-pod escape reads cnt_total.
//
// Bound: at the sweeps' sizes (N <= 5000, lists of up to a few thousand
// pods) a step is two or three barriers around 32 warps' worth of
// per-node work on one SM: issue throughput and latency, not bytes (the
// replicas read once take tens of microseconds at 3.35 TB/s for a whole
// chunk). A chunk of S scenarios runs on S SMs.
#include "ext_plans.cuh"
#include "node_stages.cuh"
#include "scores.cuh"
#include "topology.cuh"
#include "wave.cuh"

namespace {

// the step rows of a node (wave.cuh WaveRows; SWEEP_ROWS of SweepCtx.carry
// per scenario past the register templates): the Simon share and the
// resource score pair, K5's verdict and raw score and K6's verdict, kept
// across steps; the cascade bits (as float bits) and K2's four raws of the
// current step
enum : int {
  S_SHARE = 0, S_FSCORE = 1, S_ST_RAW = 2, S_ST_OK = 3, S_GPU_OK = 4, S_CASCADE = 5, S_RAW = 6,
  SWEEP_ROWS = S_RAW + N_RAWS,
};
static_assert(static_cast<int>(SWEEP_ROWS) <= static_cast<int>(WAVE_ROWS), "K19's rows fit WaveRows");
using NormRed = MinMaxOr<ScoreNorms::N_MIN, ScoreNorms::N_MAX>;
// a staged pod: scalar words, then the request [R] and the group's columns
// (8 arrays of [tc]: term, key, interpod row, flags, w_aff, w_anti, hard,
// soft); SweepCtx.pod_words = POD_HEAD + R + 8 * tc
enum : int { P_I = 0, P_G = 1, P_PIN = 2, P_FORCED = 3, P_LIVE = 4, P_FLAGS = 5, POD_HEAD = 8 };
// P_FLAGS: a DoNotSchedule column, the request equals the previous pod's,
// a SelectorSpread zone column, the storage claims / the GPU claims equal
// the previous pod's (both claiming or both not)
enum : int { PF_SPREAD = 1, PF_SAME_REQ = 2, PF_ZONE = 4, PF_SAME_ST = 8, PF_SAME_GPU = 16 };
// per-column flags
enum : int { C_SMATCH = 1, C_AFF = 2, C_ANTI = 4, C_SSHOST = 8, C_SSZONE = 16 };

// the single-scenario block of scenario s: replica s of every state plane,
// row s of the surviving masks, block s's scratch and output rows
__device__ inline StepCtx sweep_block_ctx(StepCtx x, const SweepCtx& w, int s) {
  const size_t N = static_cast<size_t>(x.n);
  const size_t sz = static_cast<size_t>(s);
  x.free += sz * N * x.r;
  x.cnt_match += sz * w.t * N;
  x.cnt_total += sz * w.t;
  x.cnt_own_anti += sz * w.ti * N;
  x.cnt_own_aff += sz * w.ti * N;
  x.w_own_aff_pref += sz * w.ti * N;
  x.w_own_anti_pref += sz * w.ti * N;
  x.ports_used += sz * N * x.p_ports;
  x.vols_any += sz * N * x.w;
  x.vols_rw += sz * N * x.w;
  x.vg_free += sz * N * x.v;
  x.sdev_free += sz * N * x.sd;
  x.gpu_free += sz * N * x.gd;
  x.node_valid += sz * N;
  x.st_ok += sz * N;
  x.st_alloc += sz * N * x.v;
  x.st_fr += sz * N * x.v;
  x.st_take += sz * N * x.sd;
  x.st_raw += sz * N;
  x.gpu_ok += sz * N;
  x.gpu_sh += sz * N * x.gd;
  const size_t rows = sz * w.cols;
  x.chosen += rows;
  x.placed += rows;
  x.reason += rows;
  x.out_node += rows;
  x.out_lvm += rows * x.v;
  x.out_take += rows * x.sd;
  x.out_gpu += rows * x.gd;
  return x;
}

// the staged pod's views into its buffer
struct PodView {
  const int* head;
  const float* req;
  const int *term, *key, *ip, *flag;
  const float *w_aff, *w_anti, *hard, *soft;
  __device__ PodView(const int* pb, int r, int tc)
      : head(pb), req(reinterpret_cast<const float*>(pb + POD_HEAD)), term(pb + POD_HEAD + r), key(term + tc),
        ip(key + tc), flag(ip + tc), w_aff(reinterpret_cast<const float*>(flag + tc)), w_anti(w_aff + tc),
        hard(w_anti + tc), soft(hard + tc) {}
};

// Stage list entry `j` of `rows` (-1: past the list or padding) into the
// buffer `pb`, the block's threads together (no barrier: the caller's
// next one publishes it).
__device__ inline void stage_pod(const StepCtx& x, const int* rows, int cols, int j, int* pb) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = x.r, TC = x.tc;
  const int i = j < cols ? rows[j] : -1;
  if (i < 0) {
    if (tid == 0) pb[P_I] = -1;
    return;
  }
  const int g = x.group[i];
  const size_t g0 = static_cast<size_t>(g) * TC;
  float* req = reinterpret_cast<float*>(pb + POD_HEAD);
  int* term = pb + POD_HEAD + R;
  int* key = term + TC;
  int* ip = key + TC;
  int* flag = ip + TC;
  float* w_aff = reinterpret_cast<float*>(flag + TC);
  float* w_anti = w_aff + TC;
  float* hard = w_anti + TC;
  float* soft = hard + TC;
  for (int q = tid; q < R; q += nt) req[q] = x.req[static_cast<size_t>(i) * R + q];
  for (int t = tid; t < TC; t += nt) {
    const size_t gt = g0 + t;
    const int tm = x.g_terms[gt];
    term[t] = tm;
    key[t] = tm >= 0 ? x.term_topo[tm] : -1;
    ip[t] = tm >= 0 ? x.ip_of[tm] : -1;
    flag[t] = (x.s_match[gt] ? C_SMATCH : 0) | (x.a_aff_req[gt] ? C_AFF : 0) | (x.a_anti_req[gt] ? C_ANTI : 0) |
              (x.ss_host[gt] ? C_SSHOST : 0) | (x.ss_zone[gt] ? C_SSZONE : 0);
    w_aff[t] = x.w_aff_pref[gt];
    w_anti[t] = x.w_anti_pref[gt];
    hard[t] = x.spread_hard[gt];
    soft[t] = x.spread_soft[gt];
  }
  if (tid == 0) {
    int fl = 0;
    for (int t = 0; t < TC; ++t) {
      const size_t gt = g0 + t;
      if ((x.flags & F_SPREAD_HARD) && x.g_terms[gt] >= 0 && x.spread_hard[gt] > 0.0f) fl |= PF_SPREAD;
      if (x.ss_zone[gt]) fl |= PF_ZONE;
    }
    if (j > 0) {
      // which of the step's per-node values the previous pod's still hold
      // (K10's test between consecutive pods of a run)
      const int p = rows[j - 1];
      bool same = true;
      for (int r = 0; r < R && same; ++r)
        same = x.req[static_cast<size_t>(i) * R + r] == x.req[static_cast<size_t>(p) * R + r];
      fl |= same ? PF_SAME_REQ : 0;
      const unsigned l0 = x.ext_live[p], l1 = x.ext_live[i];
      same = (l0 & LIVE_STORAGE) == (l1 & LIVE_STORAGE);
      for (int c = 0; c < x.l && same; ++c)
        same = x.lvm_size[static_cast<size_t>(i) * x.l + c] == x.lvm_size[static_cast<size_t>(p) * x.l + c] &&
               x.lvm_vg[static_cast<size_t>(i) * x.l + c] == x.lvm_vg[static_cast<size_t>(p) * x.l + c];
      for (int c = 0; c < x.k && same; ++c)
        same = x.dev_size[static_cast<size_t>(i) * x.k + c] == x.dev_size[static_cast<size_t>(p) * x.k + c] &&
               x.dev_media[static_cast<size_t>(i) * x.k + c] == x.dev_media[static_cast<size_t>(p) * x.k + c];
      fl |= same ? PF_SAME_ST : 0;
      same = (l0 & LIVE_GPU) == (l1 & LIVE_GPU) && x.gpu_mem[i] == x.gpu_mem[p] && x.gpu_count[i] == x.gpu_count[p];
      for (int d = 0; d < x.gd && same; ++d)
        same = x.gpu_preset[static_cast<size_t>(i) * x.gd + d] == x.gpu_preset[static_cast<size_t>(p) * x.gd + d];
      fl |= same ? PF_SAME_GPU : 0;
    }
    pb[P_I] = i;
    pb[P_G] = g;
    pb[P_PIN] = x.pin[i];
    pb[P_FORCED] = x.forced[i] ? 1 : 0;
    pb[P_LIVE] = static_cast<int>(x.ext_live[i]);
    pb[P_FLAGS] = fl;
  }
}

template <int NPT, bool SLAB>
__global__ void __launch_bounds__(WAVE_BLOCK, 1) sweep_place_kernel(StepCtx x0, SweepCtx w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned slots_b[32 * NormRed::WORDS];
  __shared__ ArgOrSlot slots_c[32];
  __shared__ float wv[12];
  const int scen = blockIdx.x;
  const StepCtx x = sweep_block_ctx(x0, w, scen);
  const int N = x.n, R = x.r, TC = x.tc;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5;
  const int nj = NPT > 0 ? NPT : (N + nt - 1) / nt;
  const int f = x.flags;
  const int* rows = w.idx + static_cast<size_t>(scen) * w.cols;
  unsigned char* slab = SLAB ? w.slab + static_cast<size_t>(scen) * w.slab_stride : nullptr;
  int* pods = wave_seg<int, SLAB>(smem, slab, w.off_pod);                 // [2][pod_words]
  unsigned* slots_min = wave_seg<unsigned, SLAB>(smem, slab, w.off_min);  // [32][tc] warp partial minima (keys)
  float* wmin = reinterpret_cast<float*>(slots_min + 32 * TC);            // [32][tc] each warp's copy of the minima
  float* sfree = w.off_free >= 0 ? reinterpret_cast<float*>(smem + w.off_free) : nullptr;
  const int fs = sfree ? N : 1;
  auto free_row = [&](int n) { return sfree ? sfree + n : x.free + static_cast<size_t>(n) * R; };
  WaveCtx wc{};
  wc.carry = w.carry ? w.carry + static_cast<size_t>(scen) * SWEEP_ROWS * N : nullptr;
  WaveRows<NPT> S(wc, N);
  float* own_planes[4] = {x.cnt_own_anti, x.cnt_own_aff, x.w_own_aff_pref, x.w_own_anti_pref};
  auto dom = [&](int k, int n) { return x.node_dom[static_cast<size_t>(k) * N + n]; };
  auto cm = [&](int term, int n) -> float& { return x.cnt_match[static_cast<size_t>(term) * N + n]; };
  auto own = [&](int q, int ip, int n) -> float& { return own_planes[q][static_cast<size_t>(ip) * N + n]; };
#define FOR_NODES for (int q = 0; q < (NPT > 0 ? NPT : nj); ++q)
#define NODE const int n = tid + q * nt; if (n >= N) continue;
  const bool do_ip = (f & F_INTERPOD_REQ) && TC > 0;
  const bool planes = (f & F_TOPOLOGY) && TC > 0;
  // the normalizers the score reads (score_norms_block's order: lo simon,
  // node_pref, soft, open-local; hi simon, node_pref, taint, |ipa|, soft,
  // ss host, ss zone, open-local), by the flags
  const bool terms_on = TC > 0;
  const unsigned live_b = 0x11u | ((f & F_NODE_PREF) ? 0x22u : 0u) | ((f & F_TAINT_PREF) ? 0x40u : 0u) |
                          (terms_on && (f & (F_INTERPOD_PREF | F_INTERPOD_REQ)) ? 0x80u : 0u) |
                          (terms_on && (f & F_SPREAD_SOFT) ? 0x104u : 0u) |
                          (terms_on && (f & F_SELECTOR_SPREAD) ? 0x600u : 0u) | ((f & F_STORAGE) ? 0x808u : 0u);

  // -- once per launch: the weights, the free rows, the first pod ---------------
  if (tid < 12) wv[tid] = x.score_w[tid];
  if (sfree)
    for (int k = tid; k < N * R; k += nt) sfree[(k % R) * N + k / R] = x.free[k];
  stage_pod(x, rows, w.cols, 0, pods);
  __syncthreads();

  int prev_c = -1;  // the node the previous pod's commit moved (-1: none)
  for (int jp = 0; jp < w.cols; ++jp) {
    const PodView pv(pods + (jp & 1) * w.pod_words, R, TC);
    const int i = pv.head[P_I];
    if (i < 0) break;  // padding only trails
    const int g = pv.head[P_G], pin = pv.head[P_PIN];
    const bool forced = pv.head[P_FORCED] != 0;
    const unsigned live = static_cast<unsigned>(pv.head[P_LIVE]);
    const int pfl = pv.head[P_FLAGS];
    const bool st_live = live & LIVE_STORAGE, gpu_live = live & LIVE_GPU;
    const bool do_spread = pfl & PF_SPREAD, same_req = pfl & PF_SAME_REQ, any_zone = pfl & PF_ZONE;
    const bool same_st = pfl & PF_SAME_ST, same_gpu = pfl & PF_SAME_GPU;
    const float* req = pv.req;
    const size_t gn0 = static_cast<size_t>(g) * N;
    auto eligible = [&](int n) {  // stage bit 0 (m_static): the mask row, the pin, the scenario's node
      const bool pin_ok = pin >= 0 ? (n == pin) : (pin > -2);
      return x.static_mask[gn0 + n] && pin_ok && x.node_valid[n];
    };
    if (do_spread) {
      // A. the hard-spread minimum per DoNotSchedule column over the
      // eligible nodes; every warp keeps its copy
      for (int t = 0; t < TC; ++t) {
        if (pv.term[t] < 0 || !(pv.hard[t] > 0.0f)) continue;
        float v = BIG;
#pragma unroll
        FOR_NODES {
          NODE
          if (!eligible(n) || dom(pv.key[t], n) < 0) continue;
          v = fminf(v, cm(pv.term[t], n) + 0.0f);  // counts are >= 0 (+0.0f folds -0)
        }
        warp_min_slot(v, slots_min + t, TC);
      }
      __syncthreads();
      for (int t = 0; t < TC; ++t) {
        if (pv.term[t] < 0 || !(pv.hard[t] > 0.0f)) continue;
        const float v = slot_min(slots_min + t, TC);
        if ((tid & 31) == 0) wmin[warp * TC + t] = v;
      }
      __syncwarp();
    }
    // B. the stage byte, the plans, the term rows and the normalizers
    const TopoScalars sc = topo_scalars(x, g);
    NormRed nm{{BIG, BIG, BIG, BIG}, {-BIG, -BIG, 0.0f, 0.0f, -BIG, 0.0f, 0.0f, -BIG}, 0u};
#pragma unroll
    FOR_NODES {
      NODE
      const size_t gn = gn0 + n;
      const float* fr = free_row(n);
      // the stage byte, bits 0-5 (K1's filter_bits, cumulative)
      bool m = eligible(n);
      unsigned s = m ? 1u : 0u;
      if (m && (f & F_PORTS)) m = ports_free(x, g, n);
      s |= (m ? 1u : 0u) << 1;
      if (m) m = fit_row(fr, fs, req, R);
      s |= (m ? 1u : 0u) << 2;
      if (m && (f & F_VOLS)) m = vols_free(x, g, n);
      s |= (m ? 1u : 0u) << 3;
      if (m && (f & F_ATTACH)) m = attach_ok(x, g, n);
      s |= (m ? 1u : 0u) << 4;
      m = m && x.vol_mask[gn];
      s |= (m ? 1u : 0u) << 5;
      // K5 / K6 for a pod that claims them, where the claims or the node's
      // rows moved since the previous pod's plans (the scratch rows of the
      // other nodes hold this pod's plans already)
      bool st_ok = true, gp_ok = true;
      if (st_live) {
        if (!same_st || n == prev_c) {
          storage_node(x, i, n);
          S(S_ST_OK, q, n) = x.st_ok[n] ? 1.0f : 0.0f;
          S(S_ST_RAW, q, n) = x.st_raw[n];
        }
        st_ok = S(S_ST_OK, q, n) != 0.0f;
      }
      if (gpu_live) {
        if (!same_gpu || n == prev_c) {
          gpu_node(x, i, n);
          S(S_GPU_OK, q, n) = x.gpu_ok[n] ? 1.0f : 0.0f;
        }
        gp_ok = S(S_GPU_OK, q, n) != 0.0f;
      }
      // the share and the resource pair where the request or the free row moved
      if (!same_req) S(S_SHARE, q, n) = dominant_share(x, n, req);
      if (!same_req || n == prev_c)
        S(S_FSCORE, q, n) = resource_base_row(x.alloc + static_cast<size_t>(n) * R, fr, fs, req, wv[0], wv[1]);
      // K2 over the pod's term rows (topology.cuh topology_node's arithmetic)
      bool spread_ok = true, anti = false, sym = false, aff_ok = true, aff_keys = true;
      float ipa_in = 0.0f, ipa_sym = 0.0f, sp = 0.0f, ssh = 0.0f, ssz = 0.0f;
      for (int t = 0; t < TC; ++t) {
        const int term = pv.term[t];
        if (term < 0) continue;
        const int cf = pv.flag[t];
        const bool valid = dom(pv.key[t], n) >= 0;
        const float c = cm(term, n);
        const int ip = pv.ip[t];
        const float ms = pv.hard[t];
        if (do_spread && ms > 0.0f) {
          float mn = wmin[warp * TC + t];
          if (mn >= BIG) mn = 0.0f;
          if (!(valid && (c + 1.0f) - mn <= ms)) spread_ok = false;
        }
        if ((cf & C_ANTI) && c > 0.0f) anti = true;
        if ((cf & C_SMATCH) && ip >= 0 && own(0, ip, n) > 0.0f) sym = true;
        if (cf & C_AFF) {
          if (!(valid && c > 0.0f)) aff_ok = false;
          if (!valid) aff_keys = false;
        }
        ipa_in += (pv.w_aff[t] - pv.w_anti[t]) * c;
        if ((cf & C_SMATCH) && ip >= 0) ipa_sym += (own(2, ip, n) - own(3, ip, n)) + own(1, ip, n);
        sp += pv.soft[t] * c;
        if (cf & C_SSHOST) ssh += c;
        if (cf & C_SSZONE) ssz += c;
      }
      bool ip_ok = true;
      if (do_ip) {
        const bool self_ok = sc.total_match == 0.0f && sc.all_s && aff_keys;
        ip_ok = (aff_ok || (sc.any_aff && self_ok)) && !anti && !sym;
      }
      const float raw_ipa = ipa_in + ipa_sym;
      S(S_RAW + RAW_IPA, q, n) = raw_ipa;
      S(S_RAW + RAW_SOFT, q, n) = sp;
      S(S_RAW + RAW_SS_HOST, q, n) = ssh;
      S(S_RAW + RAW_SS_ZONE, q, n) = ssz;
      // the cascade bits (scores.cuh cascade_bits over the node's verdicts)
      const bool m6 = ((s >> 5) & 1u) && spread_ok;
      const bool m7 = m6 && ip_ok;
      s |= (m6 ? 0x40u : 0u) | (m7 ? 0x80u : 0u);
      const bool ext_ok = (!st_live || st_ok) && (!gpu_live || gp_ok);
      const bool stg = ((s >> 5) & 1u) && (!st_live || st_ok);
      const bool gp = stg && (!gpu_live || gp_ok);
      const unsigned cas = (s & 0x3Fu) | (stg ? 1u << 6 : 0u) | (gp ? 1u << 7 : 0u) |
                           (((s >> 6) & 1u) && ext_ok ? 1u << 8 : 0u) | (((s >> 7) & 1u) && ext_ok ? 1u << 9 : 0u);
      S(S_CASCADE, q, n) = __uint_as_float(cas);
      nm.bits |= cas;
      if (!(cas & CASCADE_ALL)) continue;
      // score_norms_block's extremes
      const float sim = S(S_SHARE, q, n) * MAX_NODE_SCORE;
      nm.lo[0] = fminf(nm.lo[0], sim); nm.hi[0] = fmaxf(nm.hi[0], sim);
      const float np_ = x.node_pref[gn];
      nm.lo[1] = fminf(nm.lo[1], np_); nm.hi[1] = fmaxf(nm.hi[1], np_);
      nm.hi[2] = fmaxf(nm.hi[2], x.taint_intol[gn]);
      nm.hi[3] = fmaxf(nm.hi[3], fabsf(raw_ipa));
      nm.lo[2] = fminf(nm.lo[2], sp); nm.hi[4] = fmaxf(nm.hi[4], sp);
      nm.hi[5] = fmaxf(nm.hi[5], ssh);
      nm.hi[6] = fmaxf(nm.hi[6], ssz);
      const float ol = st_live ? S(S_ST_RAW, q, n) : 0.0f;
      nm.lo[3] = fminf(nm.lo[3], ol); nm.hi[7] = fmaxf(nm.hi[7], ol);
    }
    nm = block_minmax_or(nm, slots_b, live_b);
    // C. the score (scores.cuh node_score's arithmetic) and the argmax;
    // the next pod staged meanwhile into the other buffer (every thread
    // has passed B's barrier, so none still reads it)
    ArgOr r = ArgOr::identity();
#pragma unroll
    FOR_NODES {
      NODE
      const size_t gn = gn0 + n;
      ScoreTerms t;
      t.simon = simon_term(S(S_SHARE, q, n), nm.lo[0], nm.hi[0]);
      t.node_pref = minmax_norm(x.node_pref[gn], nm.lo[1], nm.hi[1]);
      t.taint = taint_term(x.taint_intol[gn], nm.hi[2]);
      t.ipa = maxabs_term(S(S_RAW + RAW_IPA, q, n), nm.hi[3]);
      t.soft = inv_minmax(S(S_RAW + RAW_SOFT, q, n), nm.lo[2], nm.hi[4]);
      t.ss = ss_term(S(S_RAW + RAW_SS_HOST, q, n), S(S_RAW + RAW_SS_ZONE, q, n), nm.hi[5], nm.hi[6], any_zone);
      float s = compose_score(wv, f, TC > 0, S(S_FSCORE, q, n), t, x.static_score[gn], x.avoid_pen[gn]);
      if (!(__float_as_uint(S(S_CASCADE, q, n)) & CASCADE_ALL)) s = -INFINITY;
      if (f & F_STORAGE) s = __fmaf_rn(wv[10], minmax_norm(st_live ? S(S_ST_RAW, q, n) : 0.0f, nm.lo[3], nm.hi[7]), s);
      r.merge({s, n, 0u});
    }
    stage_pod(x, rows, w.cols, jp + 1, pods + ((jp + 1) & 1) * w.pod_words);
    r = block_argmax_or(r, slots_c);
    // K3's forced-pod override and outputs (row jp of this scenario)
    const int pin_c = pin < 0 ? 0 : (pin >= N ? N - 1 : pin);
    const int c = forced ? pin : r.bi;
    const bool placed = forced ? (pin >= 0 && x.node_valid[pin_c]) : ((nm.bits & CASCADE_ALL) != 0u);
    if (tid == 0) {
      x.chosen[jp] = c;
      x.placed[jp] = placed ? 1 : 0;
      x.reason[jp] = placed ? OK : (forced ? FAIL_NO_NODE : fail_code(nm.bits));
      x.out_node[jp] = placed ? c : -1;
    }
    prev_c = placed ? c : -1;
    if (!placed) continue;  // nothing changes
    // the commit (node_stages.cuh commit_node's arithmetic, K4's order)
#pragma unroll
    FOR_NODES {
      NODE
      if (n == c) {
        float* fr = free_row(n);
        for (int k = 0; k < R; ++k) fr[k * fs] = fr[k * fs] - req[k];
        if (f & F_PORTS) {
          const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
          float* used = x.ports_used + static_cast<size_t>(c) * x.p_ports;
          for (int p = 0; p < x.p_ports; ++p) used[p] = used[p] + (want[p] ? 1.0f : 0.0f);
        }
        if (f & (F_VOLS | F_ATTACH)) {
          const size_t gw = static_cast<size_t>(g) * x.w, cw = static_cast<size_t>(c) * x.w;
          for (int v = 0; v < x.w; ++v) {
            const bool rw = x.vol_rw_req[gw + v];
            const bool present = rw || x.vol_ro_req[gw + v] || x.vol_att_req[gw + v];
            x.vols_any[cw + v] = x.vols_any[cw + v] + (present ? 1.0f : 0.0f);
            if (f & F_VOLS) x.vols_rw[cw + v] = x.vols_rw[cw + v] + (rw ? 1.0f : 0.0f);
          }
        }
        if ((f & F_STORAGE) && st_live) {
          const size_t cv = static_cast<size_t>(c) * x.v, ov = static_cast<size_t>(jp) * x.v;
          for (int v = 0; v < x.v; ++v) {
            const float a = x.st_alloc[cv + v];
            x.vg_free[cv + v] = x.vg_free[cv + v] + (-a);
            x.out_lvm[ov + v] = a;
          }
          const size_t cs = static_cast<size_t>(c) * x.sd, os = static_cast<size_t>(jp) * x.sd;
          for (int d = 0; d < x.sd; ++d) {
            const uint8_t take = x.st_take[cs + d];
            x.sdev_free[cs + d] = (x.sdev_free[cs + d] && !take) ? 1 : 0;
            x.out_take[os + d] = take;
          }
        }
        if ((f & F_GPU) && gpu_live) {
          const float mem = x.gpu_mem[i];
          const size_t cg = static_cast<size_t>(c) * x.gd, og = static_cast<size_t>(jp) * x.gd;
          for (int d = 0; d < x.gd; ++d) {
            const float sh = x.gpu_sh[cg + d];
            x.gpu_free[cg + d] = x.gpu_free[cg + d] + (-sh) * mem;
            x.out_gpu[og + d] = sh;
          }
        }
      }
      if (!planes) continue;
      for (int t = 0; t < TC; ++t) {
        const int term = pv.term[t];
        if (term < 0) continue;
        const int dc = dom(pv.key[t], c);
        if (dc < 0 || dom(pv.key[t], n) != dc) continue;  // the chosen node misses the key / another domain
        const int cf = pv.flag[t];
        float& cv = cm(term, n);
        cv = cv + ((cf & C_SMATCH) ? 1.0f : 0.0f);
        const int ip = pv.ip[t];
        if (ip < 0) continue;
        if (f & F_INTERPOD_REQ) {
          own(0, ip, n) = own(0, ip, n) + ((cf & C_ANTI) ? 1.0f : 0.0f);
          own(1, ip, n) = own(1, ip, n) + ((cf & C_AFF) ? 1.0f : 0.0f);
        }
        if (f & F_INTERPOD_PREF) {
          own(2, ip, n) = own(2, ip, n) + pv.w_aff[t];
          own(3, ip, n) = own(3, ip, n) + pv.w_anti[t];
        }
      }
    }
    if (planes && tid == 0) {
      // cnt_total: one bump per term whose key the chosen node carries
      for (int t = 0; t < TC; ++t) {
        const int term = pv.term[t];
        if (term < 0 || dom(pv.key[t], c) < 0) continue;
        x.cnt_total[term] = x.cnt_total[term] + ((pv.flag[t] & C_SMATCH) ? 1.0f : 0.0f);
      }
    }
    if (do_ip) __syncthreads();  // the next pod's inter-pod escape reads cnt_total
  }

  // -- once at the end: the staged free rows back to the replica -------------------
  __syncthreads();
  if (sfree)
    for (int k = tid; k < N * R; k += nt) x.free[k] = sfree[(k % R) * N + k / R];
#undef FOR_NODES
#undef NODE
}

template <int NPT, bool SLAB>
int launch_place_with(const StepCtx& x, const SweepCtx& w, cudaStream_t stream) {
  if (w.smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(sweep_place_kernel<NPT, SLAB>, cudaFuncAttributeMaxDynamicSharedMemorySize, w.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sweep_place_kernel<NPT, SLAB><<<w.s, w.threads, w.smem, stream>>>(x, w);
  return launch_status();
}

template <int NPT>
int launch_place(const StepCtx& x, const SweepCtx& w, cudaStream_t stream) {
  return w.slab ? launch_place_with<NPT, true>(x, w, stream) : launch_place_with<NPT, false>(x, w, stream);
}

}  // namespace

extern "C" int simtpu_sweep_place(const StepCtx* ctx, const SweepCtx* w, void* stream) {
  if (w->s == 0) return 0;
  // the launch follows the wrapper's plan (kernels/cuda.py
  // sweep_place_plan); a plan that does not cover the nodes or the staged
  // pod is refused
  const bool reg = w->npt == 1 || w->npt == 2 || w->npt == WAVE_REG_NPT;
  if (w->threads < 32 || w->threads > WAVE_BLOCK || w->threads % 32 != 0 ||
      (reg ? w->threads * w->npt < ctx->n : (w->npt != WAVE_GLOBAL_NPT || !w->carry)) ||
      w->pod_words != POD_HEAD + ctx->r + 8 * ctx->tc || ((w->off_pod < 0 || w->off_min < 0) && !w->slab))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w->npt) {
    case 1: return launch_place<1>(*ctx, *w, s);
    case 2: return launch_place<2>(*ctx, *w, s);
    case WAVE_REG_NPT: return launch_place<WAVE_REG_NPT>(*ctx, *w, s);
    default: return launch_place<WAVE_GLOBAL_NPT>(*ctx, *w, s);
  }
}
