// K1 filter_pod: the per-node filter stages of one pod.
//
// Replaces the JAX package's simtpu/engine/scan.py filter_and_score
// per-node stages (scan.py:765-795), which call resources_fit,
// ports_conflict_free, volume_conflict_free and attach_limits_ok
// (simtpu/kernels/filters.py:23-76): static mask row AND pin AND
// node_valid, then ports, resources (with the _RES_EPS slack, one FMA as
// the compiled reference has it), exclusive volumes, attach limits and
// volume binding. Writes one byte of cumulative stage bits per node.
//
// Design (launch plan kernels/cuda.py filter_plan):
//   1. the pod's group and pin come from the host as arguments, so the
//      first round of loads is already the node's;
//   2. each node issues the loads of every live stage up front, none
//      waiting on an earlier verdict: its static mask and volume-binding
//      bytes, node_valid, its free row (16- or 8-byte loads where R and
//      the row's alignment allow), and as the flags ask its ports row,
//      volume rows and attach limits, into registers up to FILTER_REG
//      entries a row (template REG). The stages are pure predicates of
//      the state, so the cumulative bits are the AND-scan of the verdicts
//      (node_stages.cuh stage_bits, the arithmetic every caller shares);
//   3. where the ports, volume or attach stage is live each block stages
//      the group's rows once in shared memory (ports_req[g], vol_rw /
//      ro / att_req[g], and the volume classes: one byte of class bits a
//      volume for the register template's one pass over W, the class mask
//      [C, W] for the other), behind one barrier that the node's loads are
//      already in flight across; past FILTER_SMEM bytes they are read in
//      place. Rows wider than FILTER_REG are read in place, stage by
//      stage, as K20 reads them (template REG false): no width is refused.
//
// Bound: bytes. Each thread owns one node and reads its rows of free
// [N,R], ports_used [N,P], vols_any/vols_rw [N,W] and attach_limits
// [N,C] once, plus the group's mask rows; no reduction, no reuse. At the
// serial path's sizes (N <= 1024) one round of loads and the launch's
// latency are the time.
#include "node_stages.cuh"

// threads a block at most (the bound lets a thread keep its rows in
// registers without spilling)
constexpr int FILTER_MAX_THREADS = 512;
// entries of a node's row held in registers at most (template REG), and
// the attach classes of the one-pass count
constexpr int FILTER_REG = 8;
// shared bytes the group's staged rows may take
constexpr int FILTER_SMEM = 48 * 1024;

// The wrapper's launch plan (mirrored by kernels/cuda.py FilterPlan)
struct FilterPlan {
  int blocks, threads, regs, staged, smem;
};

// the shared bytes of the staged group rows: ports [P], rw, ro, att [W],
// then the class bits [W] (template REG) or the class mask [C, W]
__host__ __device__ inline long long filter_smem_bytes(int p, int w, int c, bool regs) {
  return static_cast<long long>(p) + 3LL * w + (regs ? static_cast<long long>(w) : static_cast<long long>(c) * w);
}

// The node's live rows in registers and the verdicts stage_bits asks for
struct RegStages {
  const StepCtx& x;
  GroupRows gr;
  bool st, bind_ok;
  float fr[FILTER_REG], rq[FILTER_REG], used[FILTER_REG], any[FILTER_REG], rwu[FILTER_REG], lim[FILTER_REG];
  __device__ explicit RegStages(const StepCtx& x_) : x(x_) {}
  __device__ void load(int i, int g, int pin, int n) {
    const size_t gn = static_cast<size_t>(g) * x.n + n;
    const int f = x.flags;
    // every byte loaded, none behind another's verdict
    const bool mask = __ldg(x.static_mask + gn), valid = __ldg(x.node_valid + n);
    st = mask & valid & pin_ok(pin, n);
    bind_ok = __ldg(x.vol_mask + gn);
    load_row(fr, x.free + static_cast<size_t>(n) * x.r, x.r);
    load_row(rq, x.req + static_cast<size_t>(i) * x.r, x.r);
    if (f & F_PORTS) load_row(used, x.ports_used + static_cast<size_t>(n) * x.p_ports, x.p_ports);
    if (f & (F_VOLS | F_ATTACH)) load_row(any, x.vols_any + static_cast<size_t>(n) * x.w, x.w);
    if (f & F_VOLS) load_row(rwu, x.vols_rw + static_cast<size_t>(n) * x.w, x.w);
    if (f & F_ATTACH) load_row(lim, x.attach_limits + static_cast<size_t>(n) * x.c, x.c);
  }
  __device__ bool static_ok() const { return st; }
  __device__ bool ports() const { return ports_free_rows<FILTER_REG>(gr.ports, used, x.p_ports); }
  __device__ bool res() const { return res_fit_rows<FILTER_REG>(fr, rq, x.r); }
  __device__ bool vols() const { return vols_free_rows<FILTER_REG>(gr, any, rwu, x.w); }
  __device__ bool attach() const {
    return attach_ok_bits<FILTER_REG, FILTER_REG>(gr.cmask, gr.att, any, lim, x.c, x.w);
  }
  __device__ bool bind() const { return bind_ok; }
};

// the group's rows copied into shared memory by the block (the caller's
// barrier publishes them): with BITS the class bits of each volume (bit c
// = vol_class_mask[c, w], c < FILTER_REG) in place of the class mask
template <bool BITS>
__device__ inline GroupRows stage_group(const StepCtx& x, int g, uint8_t* sm) {
  const int P = x.p_ports, W = x.w, C = x.c;
  const GroupRows src = group_rows(x, g);
  uint8_t* ports = sm;
  uint8_t* rw = ports + P;
  uint8_t* ro = rw + W;
  uint8_t* att = ro + W;
  uint8_t* cls = att + W;
  for (int k = threadIdx.x; k < P; k += blockDim.x) ports[k] = src.ports[k];
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    rw[k] = src.rw[k];
    ro[k] = src.ro[k];
    att[k] = src.att[k];
    if constexpr (BITS) {
      unsigned b = 0;
      for (int c = 0; c < C && c < FILTER_REG; ++c) b |= (src.cmask[static_cast<size_t>(c) * W + k] ? 1u : 0u) << c;
      cls[k] = static_cast<uint8_t>(b);
    }
  }
  if constexpr (!BITS)
    for (int k = threadIdx.x; k < C * W; k += blockDim.x) cls[k] = src.cmask[k];
  return {ports, rw, ro, att, cls};
}

template <bool REG, bool STAGED>
__global__ void __launch_bounds__(FILTER_MAX_THREADS) filter_pod_kernel(StepCtx x, int i, int g, int pin) {
  extern __shared__ __align__(16) uint8_t fsm[];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < x.n;
  // 2. every live stage's loads, before the staging barrier
  RegStages s(x);
  if constexpr (REG) {
    if (live) s.load(i, g, pin, n);
  }
  // 3. the group's rows
  GroupRows gr;
  if constexpr (STAGED) {
    gr = stage_group<REG>(x, g, fsm);
    __syncthreads();
  } else {
    gr = group_rows(x, g);
  }
  if (!live) return;
  unsigned bits;
  if constexpr (REG) {
    s.gr = gr;
    bits = stage_bits(x, s);
  } else {
    InPlaceStages st{x, gr, x.req + static_cast<size_t>(i) * x.r, g, pin, n};
    bits = stage_bits(x, st);
  }
  x.stage[n] = static_cast<uint8_t>(bits);
}

__global__ void noop_kernel() {}

template <bool REG, bool STAGED>
static int launch_filter(const StepCtx& x, int i, int g, int pin, const FilterPlan& p, cudaStream_t s) {
  filter_pod_kernel<REG, STAGED><<<p.blocks, p.threads, p.smem, s>>>(x, i, g, pin);
  return launch_status();
}

// K1 for pod i of group g with pin `pin` (the wrapper's host copies) on the
// wrapper's plan; refused where its blocks do not cover the nodes, the
// register template is narrower than a live row (or, for the one-pass
// attach count, than the classes), or the staged rows pass the plan's
// shared bytes or FILTER_SMEM
extern "C" int simtpu_filter_pod(const StepCtx* ctx, int i, int g, int pin, const FilterPlan* plan, void* stream) {
  const FilterPlan& q = *plan;
  const StepCtx& x = *ctx;
  const int n = x.n > 0 ? x.n : 1;
  const int f = x.flags;
  const bool narrow = x.r <= FILTER_REG && (!(f & F_PORTS) || x.p_ports <= FILTER_REG) &&
                      (!(f & (F_VOLS | F_ATTACH)) || x.w <= FILTER_REG) && (!(f & F_ATTACH) || x.c <= FILTER_REG);
  const long long need = q.staged ? filter_smem_bytes(x.p_ports, x.w, x.c, q.regs) : 0;
  if (q.threads < 32 || q.threads > FILTER_MAX_THREADS || q.threads % 32 != 0 || q.blocks < 1 ||
      static_cast<long long>(q.blocks) * q.threads < n || static_cast<long long>(q.blocks - 1) * q.threads >= n ||
      (q.regs && !narrow) || (q.regs && (f & (F_PORTS | F_VOLS | F_ATTACH)) && !q.staged) || q.smem < need ||
      q.smem > FILTER_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.regs) return q.staged ? launch_filter<true, true>(x, i, g, pin, q, s) : launch_filter<true, false>(x, i, g, pin, q, s);
  return q.staged ? launch_filter<false, true>(x, i, g, pin, q, s) : launch_filter<false, false>(x, i, g, pin, q, s);
}

// an empty launch: the floor every per-pod kernel pays
extern "C" int simtpu_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return launch_status();
}

extern "C" const char* simtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
