// K6 gpu_pod: the GPU-share plan of one pod over every node.
//
// Replaces the JAX package's simtpu/kernels/gpushare.py gpu_plan (:25), as
// simtpu/engine/scan.py:874-896 runs it. One thread owns one node and
// walks its GD devices (ext_plans.cuh gpu_plan, the arithmetic every
// caller shares):
//   shares per device = floor(free / mem) where the device fits the
//        per-GPU request (missing devices count as free = -1);
//   multi-GPU pods stack shares greedily in device order (the running sum
//        is sequential in the thread; the values are integer-valued f32,
//        so it is exact);
//   1-GPU pods take the tightest fitting device, strict `<`, lowest index
//        on ties;
//   the node fits when its total GPU memory covers the request, it has a
//        device, the request names a count > 0 and the shares reach it;
//   a preset gpu-index annotation is honoured verbatim (no per-device
//        memory check), as AllocateGpuId's short-circuit.
// Writes gpu_ok [N] and gpu_sh [N,GD]. The host launches it only for pods
// with gpu_mem > 0; K3/K4 use the skip constants for the others.
//
// Design (launch plan kernels/cuda.py gpu_plan):
//   1. the pod's per-GPU memory, count and whether its preset row is set
//      come from the host as arguments (StepBuffers.gpu_host, read by the
//      entry from the plan's host array), so the first round of loads is
//      already the node's; only a set preset row is read on the card,
//      staged once per block in shared memory;
//   2. each node's gpu_dev_exists, gpu_free and gpu_total are loaded in
//      one round into registers up to GPU_REG devices (templates of 1, 2,
//      4 and 8; 16- or 8-byte loads where GD and the row's address allow);
//      wider rows are read in place, four devices' loads and divisions in
//      flight at once, as K10, K19 and K20 read them (the measured sweep:
//      the block's rows staged in shared memory were slower at GD = 9 and
//      40, PERF.md);
//   3. one pass builds the greedy stacking and the tightest fit; the
//      count-1 choice, the preset override and the final mask then write
//      each share once (registers: 16- or 8-byte stores), and gpu_ok once.
//
// Bound: bytes — gpu_free and gpu_dev_exists [N,GD] and gpu_total [N]
// are read once and the shares written once; at N <= 1024 the launch
// latency dominates.
#include "ext_plans.cuh"

// threads a block at most (the bound lets a thread keep its rows in
// registers without spilling)
constexpr int GPU_MAX_THREADS = 512;
// devices a node holds in registers at most (the widest register
// template)
constexpr int GPU_REG = 8;
// past the register templates the preset row is staged while it takes at
// most this many bytes (within the 48 KB a block has without opting in)
constexpr int GPU_PRESET_SMEM = 16 * 1024;

// A pod's GPU request as the host holds it (mirrored by kernels/cuda.py
// GpuRequest): the per-GPU memory, the count, whether its preset row is
// set (its sum > 0)
struct GpuRequest {
  float mem;
  int count, preset_set;
};

// The wrapper's launch plan (mirrored by kernels/cuda.py GpuPlan): `reg`
// the register template's width (its preset row in static shared memory),
// 0 the rows read in place (the preset row in `smem` bytes of dynamic
// shared memory where `staged`, else read in place); `reqs` the batch's
// requests on the host, which the entry reads (the kernel takes pod i's
// as arguments)
struct GpuPlan {
  int blocks, threads, reg, staged, smem;
  const GpuRequest* reqs;
};

// the node's rows and its shares in registers, up to M devices
template <int WIDTH>
struct RegGpuRows {
  static constexpr int M = WIDTH;
  bool ex[M];
  float fr[M], sh_[M];
  float tot;
  __device__ void load(const StepCtx& x, int n) {
    const size_t ng = static_cast<size_t>(n) * x.gd;
    tot = __ldg(x.gpu_total + n);
    load_flags(ex, x.gpu_dev_exists + ng, x.gd);
    load_row(fr, x.gpu_free + ng, x.gd);
  }
  __device__ bool exists(int d) const { return ex[d]; }
  __device__ float free(int d) const { return fr[d]; }
  __device__ float total() const { return tot; }
  __device__ float& sh(int d) { return sh_[d]; }
};

template <int M>
__global__ void __launch_bounds__(GPU_MAX_THREADS)
    gpu_pod_kernel(StepCtx x, int i, float mem, int count, int preset_set, GpuPlan p) {
  extern __shared__ __align__(16) int preset_smem[];
  const int GD = x.gd;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < x.n;
  // 1. the node's rows, one round of loads, before the preset's barrier
  [[maybe_unused]] RegGpuRows<(M > 0 ? M : 1)> regs;
  if constexpr (M > 0) {
    if (live) regs.load(x, n);
  }
  // 2. the pod's preset row, where one is set, staged
  const int* preset = nullptr;
  if (preset_set) {
    const int* src = x.gpu_preset + static_cast<size_t>(i) * GD;
    int* staged = preset_smem;
    if constexpr (M > 0) {
      __shared__ int reg_preset[GPU_REG];
      staged = reg_preset;
    }
    if (M > 0 || p.staged) {
      for (int d = threadIdx.x; d < GD; d += blockDim.x) staged[d] = src[d];
      __syncthreads();
      preset = staged;
    } else {
      preset = src;
    }
  }
  if (!live) return;
  // 3. the plan, each share and the verdict written once
  const GpuReq q{mem, count, preset};
  if constexpr (M > 0) {
    const bool ok = gpu_plan(q, regs, GD);
    store_row(x.gpu_sh + static_cast<size_t>(n) * GD, regs.sh_, GD);
    x.gpu_ok[n] = ok ? 1 : 0;
  } else {
    InPlaceGpuRows s{x, static_cast<size_t>(n) * GD, n};
    x.gpu_ok[n] = gpu_plan(q, s, GD) ? 1 : 0;
  }
}

template <int M>
static int launch_gpu(const StepCtx& x, int i, const GpuRequest& r, const GpuPlan& p, cudaStream_t s) {
  gpu_pod_kernel<M><<<p.blocks, p.threads, M > 0 ? 0 : p.smem, s>>>(x, i, r.mem, r.count, r.preset_set, p);
  return launch_status();
}

// K6 for pod i (its request plan->reqs[i]) on the wrapper's plan; refused
// where its blocks do not cover the nodes, the register template is
// narrower than GD or not one of 1, 2, 4, 8, or the preset's staging
// passes GPU_PRESET_SMEM or its dynamic shared bytes
extern "C" int simtpu_gpu_pod(const StepCtx* ctx, int i, const GpuPlan* plan, void* stream) {
  const GpuPlan& q = *plan;
  const StepCtx& x = *ctx;
  const int n = x.n > 0 ? x.n : 1;
  const long long preset_bytes = q.staged && !q.reg ? 4LL * x.gd : 0;
  if (q.threads < 32 || q.threads > GPU_MAX_THREADS || q.threads % 32 != 0 || q.blocks < 1 ||
      static_cast<long long>(q.blocks) * q.threads < n || static_cast<long long>(q.blocks - 1) * q.threads >= n ||
      !(q.reg == 0 || q.reg == 1 || q.reg == 2 || q.reg == 4 || q.reg == GPU_REG) || (q.reg && x.gd > q.reg) ||
      preset_bytes > GPU_PRESET_SMEM || q.smem != preset_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const GpuRequest& r = q.reqs[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q.reg) {
    case 1: return launch_gpu<1>(x, i, r, q, s);
    case 2: return launch_gpu<2>(x, i, r, q, s);
    case 4: return launch_gpu<4>(x, i, r, q, s);
    case GPU_REG: return launch_gpu<GPU_REG>(x, i, r, q, s);
    default: return launch_gpu<0>(x, i, r, q, s);
  }
}
