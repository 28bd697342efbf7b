// K5 storage_pod: the Open-Local storage plans of one pod over every node.
//
// Replaces the JAX package's simtpu/kernels/storage.py lvm_plan (:25),
// device_plan (:66) and open_local_score (:100), fused as the JAX
// package's fused cascade runs them in one branch
// (simtpu/engine/scan.py:811-835). One thread owns one node and walks the
// pod's claims in order (ext_plans.cuh storage_plan, the arithmetic every
// caller shares):
//   LVM: a named claim takes its VG if it has room; an unnamed claim
//        binpacks into the smallest-free VG that fits (first index on
//        ties, as jnp.argmin); each claim debits the node's running VG
//        free row before the next claim looks;
//   devices: each claim takes the smallest adequate free device of its
//        media (first index on ties) and adds size/capacity to the
//        tightness;
//   raw score: mean per-VG usage/capacity x 10 plus tightness / n_dev x 10,
//        the device term contracted into the sum (one FMA) as the compiled
//        reference has it.
// Writes st_ok [N] (has_storage & LVM fits & devices fit), st_alloc [N,V],
// st_take [N,SD] and st_raw [N]. The host launches it only for pods that
// demand storage; K3/K4 use the skip constants for the others.
//
// Design (launch plan kernels/cuda.py storage_plan):
//   1. each block stages the pod's claims (lvm_size, lvm_vg, dev_size,
//      dev_media of pod i) in shared memory once; past STORAGE_CLAIMS_SMEM
//      bytes they are read in place;
//   2. each node's rows (vg_free, vg_cap, vg_name_id, sdev_free, sdev_cap,
//      sdev_media) are loaded once, in one round issued before the
//      staging barrier, into registers up to STORAGE_REG VGs and devices
//      (the measured sweep: a template of 8 was slower at the extended
//      problem's 2 VGs and 3 devices, and no problem has 5 to 8); the
//      plan's running free space, allocation and take row stay in
//      registers, so no claim waits on a store of the one before;
//   3. wider nodes keep the running rows in shared memory ([row][thread],
//      the node's other rows read in place), and past the shared budget
//      in the StepCtx scratch rows (st_fr, st_alloc, st_take) as K10,
//      K19 and K20 do: no width is refused;
//   4. st_alloc, st_take, st_ok and st_raw are written once, at the end.
//
// Bound: bytes — vg_free/vg_cap/vg_name_id [N,V] and sdev_free/cap/media
// [N,SD] are read once and the plans written once; at N <= 1024 the
// launch latency dominates.
#include "ext_plans.cuh"
#include "wave.cuh"

// threads a block at most (the bound lets a thread keep its plan in
// registers without spilling)
constexpr int STORAGE_MAX_THREADS = 256;
// the register template: VGs and devices a node holds in registers at
// most (also its template code)
constexpr int STORAGE_REG = 4;
// template codes past the register width
constexpr int STORAGE_SHARED = 1;
constexpr int STORAGE_GLOBAL = 0;
// the pod's claims are staged while they take at most this many bytes
constexpr int STORAGE_CLAIMS_SMEM = 16 * 1024;

// The wrapper's launch plan (mirrored by kernels/cuda.py StoragePlan)
struct StoragePlan {
  int blocks, threads, tmpl, staged, smem, off_rows;
};

// the node's rows and its plan in registers, up to M VGs and M devices
template <int WIDTH>
struct RegPlanRows {
  static constexpr int M = WIDTH;
  Claims cl;
  int nm[M], md[M];
  float vf[M], cp[M], f[M], al[M], dc[M];
  bool df[M];
  uint8_t tk[M];
  __device__ void load(const StepCtx& x, int n) {
    const size_t nv = static_cast<size_t>(n) * x.v, nsd = static_cast<size_t>(n) * x.sd;
    each<M>(x.v, [&](int v) {
      nm[v] = __ldg(x.vg_name_id + nv + v);
      vf[v] = __ldg(x.vg_free + nv + v);
      cp[v] = __ldg(x.vg_cap + nv + v);
    });
    each<M>(x.sd, [&](int d) {
      df[d] = __ldg(x.sdev_free + nsd + d) != 0;
      dc[d] = __ldg(x.sdev_cap + nsd + d);
      md[d] = __ldg(x.sdev_media + nsd + d);
    });
  }
  __device__ int name(int v) const { return nm[v]; }
  __device__ float free0(int v) const { return vf[v]; }
  __device__ float cap(int v) const { return cp[v]; }
  __device__ float& fr(int v) { return f[v]; }
  __device__ float& alloc(int v) { return al[v]; }
  __device__ bool dev_free(int d) const { return df[d]; }
  __device__ float dev_cap(int d) const { return dc[d]; }
  __device__ int media(int d) const { return md[d]; }
  __device__ uint8_t& take(int d) { return tk[d]; }
  __device__ void flush(const StepCtx& x, int n) const {
    const size_t nv = static_cast<size_t>(n) * x.v, nsd = static_cast<size_t>(n) * x.sd;
    each<M>(x.v, [&](int v) { x.st_alloc[nv + v] = al[v]; });
    each<M>(x.sd, [&](int d) { x.st_take[nsd + d] = tk[d]; });
  }
};

// the node's rows read in place, the plan's running rows in shared memory
// ([row][thread]: thread t's VG v at v * threads + t)
struct SharedPlanRows {
  static constexpr int M = 0;
  const StepCtx& x;
  Claims cl;
  size_t nv, nsd;
  float* frs;     // [V][threads]
  float* als;     // [V][threads]
  uint8_t* tks;   // [SD][threads]
  int t, nt;
  __device__ int name(int v) const { return x.vg_name_id[nv + v]; }
  __device__ float free0(int v) const { return x.vg_free[nv + v]; }
  __device__ float cap(int v) const { return x.vg_cap[nv + v]; }
  __device__ float& fr(int v) const { return frs[v * nt + t]; }
  __device__ float& alloc(int v) const { return als[v * nt + t]; }
  __device__ bool dev_free(int d) const { return x.sdev_free[nsd + d] != 0; }
  __device__ float dev_cap(int d) const { return x.sdev_cap[nsd + d]; }
  __device__ int media(int d) const { return x.sdev_media[nsd + d]; }
  __device__ uint8_t& take(int d) const { return tks[d * nt + t]; }
  __device__ void flush() const {
    for (int v = 0; v < x.v; ++v) x.st_alloc[nv + v] = als[v * nt + t];
    for (int d = 0; d < x.sd; ++d) x.st_take[nsd + d] = tks[d * nt + t];
  }
};

// the pod's claims copied into shared memory by the block (the caller's
// barrier publishes them)
__device__ inline Claims stage_claims(const StepCtx& x, int i, unsigned char* smem) {
  const Claims src = claims_in_place(x, i);
  float* lsz = reinterpret_cast<float*>(smem);
  int* lvg = reinterpret_cast<int*>(lsz + x.l);
  float* dsz = reinterpret_cast<float*>(lvg + x.l);
  int* dmd = reinterpret_cast<int*>(dsz + x.k);
  for (int c = threadIdx.x; c < x.l; c += blockDim.x) {
    lsz[c] = src.lsz[c];
    lvg[c] = src.lvg[c];
  }
  for (int c = threadIdx.x; c < x.k; c += blockDim.x) {
    dsz[c] = src.dsz[c];
    dmd[c] = src.dmd[c];
  }
  return {lsz, lvg, dsz, dmd};
}

template <int TMPL, bool STAGED>
__global__ void __launch_bounds__(STORAGE_MAX_THREADS) storage_pod_kernel(StepCtx x, int i, StoragePlan p) {
  extern __shared__ __align__(16) unsigned char ssm[];
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < x.n;
  const size_t nv = static_cast<size_t>(live ? n : 0) * x.v, nsd = static_cast<size_t>(live ? n : 0) * x.sd;
  // 1. the node's rows, one round of loads, before the claims' barrier
  [[maybe_unused]] RegPlanRows<(TMPL > STORAGE_SHARED ? TMPL : 1)> regs;
  if constexpr (TMPL > STORAGE_SHARED) {
    if (live) regs.load(x, n);
  }
  // 2. the pod's claims
  Claims cl;
  if constexpr (STAGED) {
    cl = stage_claims(x, i, ssm);
    __syncthreads();
  } else {
    cl = claims_in_place(x, i);
  }
  if (!live) return;
  // 3. the plan; 4. its rows and verdicts, written once
  float raw;
  bool ok;
  if constexpr (TMPL > STORAGE_SHARED) {
    regs.cl = cl;
    ok = storage_plan(x, regs, raw);
    regs.flush(x, n);
  } else if constexpr (TMPL == STORAGE_SHARED) {
    float* frs = reinterpret_cast<float*>(ssm + p.off_rows);
    float* als = frs + static_cast<size_t>(x.v) * blockDim.x;
    uint8_t* tks = reinterpret_cast<uint8_t*>(als + static_cast<size_t>(x.v) * blockDim.x);
    SharedPlanRows s{x, cl, nv, nsd, frs, als, tks, static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)};
    ok = storage_plan(x, s, raw);
    s.flush();
  } else {
    ScratchPlanRows s{x, cl, nv, nsd};
    ok = storage_plan(x, s, raw);
  }
  x.st_ok[n] = (x.has_storage[n] && ok) ? 1 : 0;
  x.st_raw[n] = raw;
}

// One launch of an instance, its shared-memory attribute set at its first
// launch
template <int TMPL, bool STAGED>
static int launch_storage(const StepCtx& x, int i, const StoragePlan& p, cudaStream_t s) {
  auto kernel = storage_pod_kernel<TMPL, STAGED>;
  static int attrs = -1;
  if (attrs < 0) attrs = static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                               WAVE_SMEM));
  if (attrs) return attrs;
  kernel<<<p.blocks, p.threads, p.smem, s>>>(x, i, p);
  return launch_status();
}

// the shared bytes the plan's segments need: the staged claims, then
// (template shared) the running rows of every thread
static long long storage_smem_need(const StepCtx& x, const StoragePlan& q) {
  const long long claims = q.staged ? 8LL * (x.l + x.k) : 0;
  if (q.tmpl != STORAGE_SHARED) return claims;
  return static_cast<long long>(q.off_rows) + static_cast<long long>(q.threads) * (8LL * x.v + x.sd);
}

// K5 for pod i on the wrapper's plan; refused where its blocks do not
// cover the nodes, the register template is narrower than the rows, the
// claims' staging passes STORAGE_CLAIMS_SMEM or the shared bytes fall
// short of its segments or pass the budget
extern "C" int simtpu_storage_pod(const StepCtx* ctx, int i, const StoragePlan* plan, void* stream) {
  const StoragePlan& q = *plan;
  const StepCtx& x = *ctx;
  const int n = x.n > 0 ? x.n : 1;
  const int width = x.v > x.sd ? x.v : x.sd;
  const bool regs = q.tmpl == STORAGE_REG;
  if (q.threads < 32 || q.threads > STORAGE_MAX_THREADS || q.threads % 32 != 0 || q.blocks < 1 ||
      static_cast<long long>(q.blocks) * q.threads < n || static_cast<long long>(q.blocks - 1) * q.threads >= n ||
      !(regs || q.tmpl == STORAGE_SHARED || q.tmpl == STORAGE_GLOBAL) || (regs && width > q.tmpl) ||
      (q.staged && 8LL * (x.l + x.k) > STORAGE_CLAIMS_SMEM) || q.off_rows < 0 || q.off_rows % 16 != 0 ||
      (q.staged && q.tmpl == STORAGE_SHARED && q.off_rows < 8LL * (x.l + x.k)) || q.smem < storage_smem_need(x, q) ||
      q.smem > WAVE_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q.tmpl) {
    case STORAGE_REG:
      return q.staged ? launch_storage<STORAGE_REG, true>(x, i, q, s) : launch_storage<STORAGE_REG, false>(x, i, q, s);
    case STORAGE_SHARED:
      return q.staged ? launch_storage<STORAGE_SHARED, true>(x, i, q, s)
                      : launch_storage<STORAGE_SHARED, false>(x, i, q, s);
    default:
      return q.staged ? launch_storage<STORAGE_GLOBAL, true>(x, i, q, s)
                      : launch_storage<STORAGE_GLOBAL, false>(x, i, q, s);
  }
}
