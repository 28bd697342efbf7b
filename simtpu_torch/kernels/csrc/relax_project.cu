// K23 relax_project: one projected-gradient step of every candidate's
// fractional assignment, one block per (class, candidate) row.
//
// Replaces the JAX package's simtpu/solve/relax.py _project_rows (:200)
// and the step of _relax_kernel (:218). For row (s, c) with mask
// f[n] = feas[c, n] & valid[s, n] and a = cnt[c]:
//   g[n] = sum_r over[s, n, r] * req[c, r]   (r ascending, f32)
//   v[n] = y[s, c, n] - lr * g[n]
// then the exact Euclidean projection onto {y >= 0, y = 0 off f,
// sum y = a}: the masked v (-inf off the mask and on the padding up to
// the next power of two) sorted descending by a bitonic sort in shared
// memory, the inclusive prefix sum of the finite entries (taken in f64,
// each thread a contiguous run, then a warp-shuffle scan of the runs, and
// rounded to f32), t[j] = (cs[j] - a) / (j + 1), rho = count(finite &
// u > t) - 1 clamped at 0 (the JAX package's count, not the last index
// where the condition holds), tau = t[rho], y = max(v - tau, 0) * f; rows
// with a <= 0 are zero. Init mode writes the start point cnt / max(nfeas,
// 1) on the mask and flags stuck[s] when a class with demand has no
// feasible valid node.
//
// Where the padded row does not fit in shared memory (np2 > 16 384: N >
// 16 384 nodes in all), the same code runs on a slab of global scratch:
// a persistent grid of RelaxCtx.slabs blocks (a few per SM), each owning
// one slab of np2 keys and prefix sums and looping over the (class,
// candidate) rows, so the scratch is slabs x np2 x 12 B (1.5 MB a slab at
// N = 100 000), not one slab per row. The arithmetic and its order are
// the shared-memory path's: the result does not depend on the path.
//
// Bound: bytes — y read and written once, over read once per class row
// (the same [N, R] slab for every class of a candidate, from L2). The
// sort's log^2 passes are shared-memory (or, on a wide row, L2) traffic,
// which makes this kernel far from its bound at one block per row: the
// redesign's work.
#include "relax.cuh"

__device__ __forceinline__ float step_value(const RelaxCtx& x, int s, int c, int n, float y) {
  const float* o = x.over + (static_cast<size_t>(s) * x.n + n) * x.r;
  float g = 0.0f;
  for (int r = 0; r < x.r; ++r) g = __fadd_rn(g, __fmul_rn(o[r], x.req[c * x.r + r]));
  return __fsub_rn(y, __fmul_rn(x.lr, g));
}

// one (class c, candidate s) row, the block's threads together; `keys`
// and `pre` hold np2 entries in shared memory or in the block's slab
// (inlined into each path, so the shared one keeps shared-memory loads)
__device__ __forceinline__ void project_row(const RelaxCtx& x, int s, int c, float* keys, double* pre, int* count_,
                            double* warp_sum) {
  int& count = *count_;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float a = x.cnt[c];
  const uint8_t* feas = x.feas + static_cast<size_t>(c) * x.n;
  const uint8_t* valid = x.valid + static_cast<size_t>(s) * x.n;
  float* y = x.y + (static_cast<size_t>(s) * x.c + c) * x.n;
  if (tid == 0) count = 0;
  __syncthreads();

  if (x.mode & RELAX_INIT) {
    int mine = 0;
    for (int n = tid; n < x.n; n += nt) mine += (feas[n] && valid[n]) ? 1 : 0;
    if (mine) atomicAdd(&count, mine);
    __syncthreads();
    const int nfeas = count;
    const float share = __fdiv_rn(a, static_cast<float>(nfeas > 1 ? nfeas : 1));
    for (int n = tid; n < x.n; n += nt) y[n] = (feas[n] && valid[n]) ? share : 0.0f;
    if (tid == 0 && nfeas == 0 && a > 0.0f) atomicOr(x.stuck + s, 1);
    return;
  }
  if (!(a > 0.0f)) {
    for (int n = tid; n < x.n; n += nt) y[n] = 0.0f;
    return;
  }

  for (int j = tid; j < x.np2; j += nt)
    keys[j] = (j < x.n && feas[j] && valid[j]) ? step_value(x, s, c, j, y[j]) : -INFINITY;
  __syncthreads();
  // bitonic sort, descending
  for (int k = 2; k <= x.np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < x.np2; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float u = keys[i], w = keys[ixj];
          if ((i & k) == 0 ? (u < w) : (u > w)) {
            keys[i] = w;
            keys[ixj] = u;
          }
        }
      }
      __syncthreads();
    }
  }
  // inclusive prefix sum of the finite keys, in f64: a contiguous run per
  // thread, then an exclusive scan of the runs' totals
  const int per = x.np2 / nt;
  const int base = tid * per;
  double run = 0.0;
  for (int e = 0; e < per; ++e) {
    const float u = keys[base + e];
    run += isfinite(u) ? static_cast<double>(u) : 0.0;
    pre[base + e] = run;
  }
  const int lane = tid & 31, warp = tid >> 5;
  double incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    double wv = lane < nw ? warp_sum[lane] : 0.0;
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, wv, off);
      if (lane >= off) wv += up;
    }
    if (lane < nw) warp_sum[lane] = wv;
  }
  __syncthreads();
  const double offset = (incl - run) + (warp > 0 ? warp_sum[warp - 1] : 0.0);
  int mine = 0;
  for (int e = 0; e < per; ++e) {
    const int j = base + e;
    const double p = pre[j] + offset;
    pre[j] = p;
    const float u = keys[j];
    const float t = __fdiv_rn(__fsub_rn(static_cast<float>(p), a), static_cast<float>(j + 1));
    mine += (isfinite(u) && u > t) ? 1 : 0;
  }
  if (mine) atomicAdd(&count, mine);
  __syncthreads();
  const int rho = count > 1 ? count - 1 : 0;
  const float tau = __fdiv_rn(__fsub_rn(static_cast<float>(pre[rho]), a), static_cast<float>(rho + 1));
  for (int n = tid; n < x.n; n += nt) {
    const bool f = feas[n] && valid[n];
    const float v = f ? step_value(x, s, c, n, y[n]) : 0.0f;
    y[n] = f ? fmaxf(__fsub_rn(v, tau), 0.0f) : 0.0f;
  }
}

__global__ void relax_project_kernel(RelaxCtx x) {
  // one row per block, its keys and prefix sums in shared memory
  extern __shared__ unsigned char smem[];
  __shared__ double warp_sum[32];
  __shared__ int count;
  double* pre = reinterpret_cast<double*>(smem);
  project_row(x, blockIdx.y, blockIdx.x, reinterpret_cast<float*>(pre + x.np2), pre, &count, warp_sum);
}

// the wide-row path (its own entry, so the shared-memory one keeps its
// shared-memory loads): this block's slab, rows strided over the grid; the
// barrier after a row keeps the next row's reset of `count` and of the
// slab behind every thread's last read
__global__ void relax_project_slab_kernel(RelaxCtx x) {
  __shared__ double warp_sum[32];
  __shared__ int count;
  double* pre = reinterpret_cast<double*>(x.scratch + static_cast<size_t>(blockIdx.x) * x.np2 *
                                                         (sizeof(double) + sizeof(float)));
  float* keys = reinterpret_cast<float*>(pre + x.np2);
  for (int row = blockIdx.x; row < x.s * x.c; row += gridDim.x) {
    project_row(x, row / x.c, row % x.c, keys, pre, &count, warp_sum);
    __syncthreads();
  }
}

extern "C" int simtpu_relax_project(const RelaxCtx* ctx, void* stream) {
  // np2 is a power of two >= 32 (the wrapper's), so every thread owns a
  // whole run of np2 / threads keys
  const int threads = ctx->np2 < 1024 ? ctx->np2 : 1024;
  if (ctx->slabs > 0) {
    relax_project_slab_kernel<<<ctx->slabs, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
    return launch_status();
  }
  const size_t shmem = static_cast<size_t>(ctx->np2) * (sizeof(double) + sizeof(float));
  // the dynamic shared memory beyond the default 48 KB (less the static
  // part) needs the opt-in; set it for every size
  const cudaError_t err = cudaFuncSetAttribute(relax_project_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ctx->c, ctx->s);
  relax_project_kernel<<<grid, threads, shmem, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
