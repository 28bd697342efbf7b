// K23 relax_project: one projected-gradient step of every candidate's
// fractional assignment, one block per (class, candidate) row.
//
// Replaces the JAX package's simtpu/solve/relax.py _project_rows (:200)
// and the step of _relax_kernel (:218). For row (s, c) with mask
// f[n] = feas[c, n] & valid[s, n] and a = cnt[c]:
//   g[n] = sum_r over[s, n, r] * req[c, r]   (r ascending, f32)
//   v[n] = y[s, c, n] - lr * g[n]
// then the exact Euclidean projection onto {y >= 0, y = 0 off f,
// sum y = a}: the masked v (-inf off the mask and on the padding) sorted
// descending, the inclusive prefix sum of the finite entries taken in f64
// and rounded to f32, t[j] = (cs[j] - a) / (j + 1), rho = count(finite &
// u > t) - 1 clamped at 0 (the JAX package's count over every position,
// not the last index where the condition holds), tau = t[rho], y =
// max(v - tau, 0) * f; rows with a <= 0 are zero. Init mode writes the
// start point cnt / max(nfeas, 1) on the mask and flags stuck[s] when a
// class with demand has no feasible valid node. Any correct descending
// order gives the same u and the same prefix sums (equal keys are equal
// values; -0 and +0 add alike), so the three paths below agree bit for bit
// with each other and with the plain version, whatever their sort.
//
// The register path (padded rows up to RELAX_REG_ROW = 4096 nodes, every
// relaxation the planners run): one block of RelaxCtx.threads threads per
// row, each thread holding kpt nodes (node n = e * threads + tid,
// coalesced): 4 nodes and at most 256 threads up to 1024 padded nodes, 8
// nodes and 256 or 512 threads above (kernels/cuda.py relax_project_plan;
// 16 nodes a thread spilled and ran slower at 4096). The step v is
// computed once per node, from one read of over[s, n, :], and kept in
// registers for the final write. The row's M finite keys (order-preserving
// 32-bit keys of v on the mask) are first compacted to positions [0, M)
// (a scan of the threads' counts, a scatter through shared memory: two
// barriers), so the sort runs over ws = the next power of two >= M, one
// warp's keys at least — a zone-bound class is feasible on a small part
// of the row — and the warps past ws sit out.
// The sort is a bitonic network over keys held in registers (position
// tid * kpt + e), unrolled for each width: exchanges within a thread are
// register moves, exchanges within a warp are shuffles, and only the
// exchanges across warps go through shared memory — one barrier each
// (double-buffered), at most 6 at 256 threads, against the shared-memory
// sort's log2(np2) * (log2(np2) + 1) / 2 = 55 barrier passes at np2 =
// 1024. Then a warp-shuffle f64 scan (one barrier for the warps' totals),
// t at every position into shared memory and the count folded per warp
// (one barrier): at most 10 barriers a row at 256 threads. With at most
// 512 threads and 2 x threads x kpt x 4 B of shared memory a row takes a
// fraction of an SM (simtpu_relax_project_rows_per_sm reports how many
// rows share one).
//
// The shared-memory path (4096 < np2 <= 16 384) and the wide-row path
// (np2 > 16 384) keep the one-block-per-row bitonic sort of the padded
// row in shared memory, or, past what shared memory holds, on a slab of
// global scratch: a persistent grid of RelaxCtx.slabs blocks (a few per
// SM), each owning one slab of np2 keys and prefix sums and looping over
// the rows, so the scratch is slabs x np2 x 12 B (1.5 MB a slab at
// N = 100 000), not one slab per row.
//
// Bound: bytes — y read and written once, over read once per class row
// (the same [N, R] slab for every class of a candidate, from L2). The
// register path's sort is register and shuffle work, a few hundred
// instructions a node; the other two paths' log^2 passes are
// shared-memory (or L2) traffic.
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

// -- the register path --------------------------------------------------------

// the order-preserving key of a float (-0 below +0; a NaN above +inf, first
// as torch.sort puts it) and back (a NaN key back to a NaN)
__device__ __forceinline__ unsigned sort_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ __forceinline__ unsigned key_max(unsigned a, unsigned b) { return a > b ? a : b; }
__device__ __forceinline__ unsigned key_min(unsigned a, unsigned b) { return a < b ? a : b; }

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// The bitonic network, descending, over the 2^LOG_WS keys at positions
// tid * KPT + e (every step unrolled; the threads past the sorted width
// only keep the barriers). An exchange between a thread's own keys is a
// register move, one within a warp a shuffle, one across warps a round
// trip through a shared-memory buffer (alternating between the two, so
// one barrier each).
template <int KPT, int LOG_WS>
__device__ __forceinline__ void sort_keys(unsigned (&key)[KPT], int base, unsigned* xch, int width, bool active) {
  int parity = 0;
#pragma unroll
  for (int lk = 1; lk <= LOG_WS; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int k = 1 << lk, j = 1 << lj;
      if (j < KPT) {
        if (!active) continue;
#pragma unroll
        for (int e = 0; e < KPT; ++e) {
          const int l = e ^ j;
          if (l > e) {
            // the pair descends where bit k of its position is clear
            const bool desc = ((k < KPT ? base + e : base) & k) == 0;
            const unsigned hi = key_max(key[e], key[l]), lo = key_min(key[e], key[l]);
            key[e] = desc ? hi : lo;
            key[l] = desc ? lo : hi;
          }
        }
        continue;
      }
      // the partner is the same e of thread tid ^ (j / KPT); the lower
      // position of a pair keeps the larger key where the pair descends
      const bool keep_max = ((base & j) == 0) == ((base & k) == 0);
      if (j < 32 * KPT) {
        if (!active) continue;
#pragma unroll
        for (int e = 0; e < KPT; ++e) {
          const unsigned o = __shfl_xor_sync(0xffffffffu, key[e], j / KPT);
          key[e] = keep_max ? key_max(key[e], o) : key_min(key[e], o);
        }
        continue;
      }
      unsigned* buf = xch + parity * width;
      parity ^= 1;
      if (active) {
        uint4* mine = reinterpret_cast<uint4*>(buf + base);
#pragma unroll
        for (int q = 0; q < KPT / 4; ++q)
          mine[q] = make_uint4(key[4 * q], key[4 * q + 1], key[4 * q + 2], key[4 * q + 3]);
      }
      __syncthreads();
      if (!active) continue;
      const uint4* other = reinterpret_cast<const uint4*>(buf + (base ^ j));
#pragma unroll
      for (int q = 0; q < KPT / 4; ++q) {
        const uint4 ov = other[q];
        const unsigned os[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * q + u;
          key[e] = keep_max ? key_max(key[e], os[u]) : key_min(key[e], os[u]);
        }
      }
    }
  }
}

// the sort over ws = 2^lw keys: the network unrolled for each width from
// one warp's keys (2^LOG) to RELAX_REG_ROW
template <int KPT, int LOG>
__device__ __forceinline__ void sort_width(int lw, unsigned (&key)[KPT], int base, unsigned* xch, int width,
                                           bool active) {
  if constexpr (LOG < ilog2(RELAX_REG_ROW)) {
    if (lw == LOG) sort_keys<KPT, LOG>(key, base, xch, width, active);
    else sort_width<KPT, LOG + 1>(lw, key, base, xch, width, active);
  } else {
    sort_keys<KPT, LOG>(key, base, xch, width, active);
  }
}

// the register budget: 32 registers a thread at 4 keys (eight rows of 256
// threads to an SM), 40 at 8 (three rows of 512)
template <int KPT>
__global__ void __launch_bounds__(RELAX_ROW_THREADS, KPT == 4 ? 4 : 3) relax_project_reg_kernel(RelaxCtx x) {
  static_assert(KPT == 4 || KPT == 8, "keys per thread: 4 or 8");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double warp_tot[RELAX_ROW_THREADS / 32];
  __shared__ int warp_cnt[RELAX_ROW_THREADS / 32];
  unsigned* xch = reinterpret_cast<unsigned*>(smem);  // [2][width] exchange keys; then t [width]
  const int nt = blockDim.x, width = nt * KPT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int c = blockIdx.x, s = blockIdx.y;
  const int N = x.n;
  const float a = x.cnt[c];
  const uint8_t* feas = x.feas + static_cast<size_t>(c) * N;
  const uint8_t* valid = x.valid + static_cast<size_t>(s) * N;
  float* y = x.y + (static_cast<size_t>(s) * x.c + c) * N;
  // thread tid's e-th node is e * nt + tid; bit e of fmask: it is on the mask
  unsigned fmask = 0u;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int n = e * nt + tid;
    if (n < N && feas[n] && valid[n]) fmask |= 1u << e;
  }
  if (x.mode & RELAX_INIT) {
    const int cnt = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(__popc(fmask))));
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    int nfeas = 0;
    for (int w = 0; w < nw; ++w) nfeas += warp_cnt[w];
    const float share = __fdiv_rn(a, static_cast<float>(nfeas > 1 ? nfeas : 1));
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int n = e * nt + tid;
      if (n < N) y[n] = ((fmask >> e) & 1u) ? share : 0.0f;
    }
    if (tid == 0 && nfeas == 0 && a > 0.0f) atomicOr(x.stuck + s, 1);
    return;
  }
  if (!(a > 0.0f)) {
#pragma unroll
    for (int e = 0; e < KPT; ++e) {
      const int n = e * nt + tid;
      if (n < N) y[n] = 0.0f;
    }
    return;
  }
  // the step, once per node (over[s, n, :] read once), kept for the write
  const float* req = x.req + static_cast<size_t>(c) * x.r;
  const float* over = x.over + static_cast<size_t>(s) * N * x.r;
  float v[KPT];
  unsigned key[KPT];
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    v[e] = 0.0f;
    key[e] = sort_key(-INFINITY);
    if ((fmask >> e) & 1u) {
      const int n = e * nt + tid;
      const float* o = over + static_cast<size_t>(n) * x.r;
      float g = 0.0f;
      for (int r = 0; r < x.r; ++r) g = __fadd_rn(g, __fmul_rn(o[r], req[r]));
      v[e] = __fsub_rn(y[n], __fmul_rn(x.lr, g));
      key[e] = sort_key(v[e]);
    }
  }
  // the finite keys compacted to positions [0, M) (the masked ones are
  // -inf and sort last): an exclusive scan of the threads' counts, then a
  // scatter into the second exchange buffer. The sorted width ws is the
  // next power of two >= M, one warp's keys at least; the warps past it
  // hold -inf and only keep the barriers.
  const int base = tid * KPT;
  const unsigned neg = sort_key(-INFINITY);
  int ws = 32 * KPT;
  {
    const int mine = __popc(fmask);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_cnt[warp] = incl;
    __syncthreads();
    int at = incl - mine, m_all = 0;
    for (int w = 0; w < nw; ++w) {
      at += w < warp ? warp_cnt[w] : 0;
      m_all += warp_cnt[w];
    }
    unsigned* cmp = xch + width;
#pragma unroll
    for (int e = 0; e < KPT; ++e)
      if ((fmask >> e) & 1u) cmp[at++] = key[e];
    __syncthreads();
    while (ws < m_all) ws <<= 1;
#pragma unroll
    for (int e = 0; e < KPT; ++e) key[e] = base + e < m_all ? cmp[base + e] : neg;
  }
  const bool active = base < ws;  // whole warps: ws is a multiple of 32 * KPT
  sort_width<KPT, ilog2(32 * KPT)>(31 - __clz(ws), key, base, xch, width, active);
  // the f64 prefix sum of the finite keys: the thread's run, then an
  // exclusive scan of the runs (warp shuffles, then the warps' totals)
  double tot = 0.0;
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const float u = key_value(key[e]);
    if (isfinite(u)) tot += static_cast<double>(u);
  }
  double incl = tot;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();  // after every thread's last exchange: xch is free for t
  double off = 0.0;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  off += excl;
  // t at every position (shared memory) and the count of finite u > t
  float4* tq = reinterpret_cast<float4*>(xch + base);
  double run = 0.0;
  int mine = 0;
  if (active) {  // past ws every key is -inf: no position there is read
#pragma unroll
    for (int q = 0; q < KPT / 4; ++q) {
      float t4[4];
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4) {
        const int e = 4 * q + u4;
        const float u = key_value(key[e]);
        const bool fin = isfinite(u);
        if (fin) run += static_cast<double>(u);
        const float cs = static_cast<float>(off + run);
        const float t = __fdiv_rn(__fsub_rn(cs, a), static_cast<float>(base + e + 1));
        t4[u4] = t;
        mine += (fin && u > t) ? 1 : 0;
      }
      tq[q] = make_float4(t4[0], t4[1], t4[2], t4[3]);
    }
  }
  const int cnt = static_cast<int>(__reduce_add_sync(0xffffffffu, static_cast<unsigned>(mine)));
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  int count = 0;
  for (int w = 0; w < nw; ++w) count += warp_cnt[w];
  const int rho = count > 1 ? count - 1 : 0;
  const float tau = reinterpret_cast<const float*>(xch)[rho];
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int n = e * nt + tid;
    if (n < N) y[n] = ((fmask >> e) & 1u) ? fmaxf(__fsub_rn(v[e], tau), 0.0f) : 0.0f;
  }
}

template <int KPT>
static size_t reg_smem(const RelaxCtx& x) {
  return 2 * static_cast<size_t>(x.threads) * KPT * sizeof(unsigned);
}

template <int KPT>
static int launch_reg(const RelaxCtx& x, cudaStream_t stream) {
  dim3 grid(x.c, x.s);
  relax_project_reg_kernel<KPT><<<grid, x.threads, reg_smem<KPT>(x), stream>>>(x);
  return launch_status();
}

// the register path's plan is whole: a warp multiple of at most 512
// threads whose kpt keys cover the padded row, at most RELAX_REG_ROW keys
static bool reg_plan_ok(const RelaxCtx& x) {
  const long keys = static_cast<long>(x.threads) * x.kpt;
  return x.threads >= 32 && x.threads <= RELAX_ROW_THREADS && x.threads % 32 == 0 && (x.kpt == 4 || x.kpt == 8) &&
         keys >= x.np2 && keys <= RELAX_REG_ROW;
}

extern "C" int simtpu_relax_project(const RelaxCtx* ctx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ctx->slabs > 0) {
    relax_project_slab_kernel<<<ctx->slabs, 1024, 0, st>>>(*ctx);
    return launch_status();
  }
  if (ctx->np2 <= RELAX_REG_ROW) {
    if (!reg_plan_ok(*ctx)) return static_cast<int>(cudaErrorInvalidValue);
    return ctx->kpt == 4 ? launch_reg<4>(*ctx, st) : launch_reg<8>(*ctx, st);
  }
  // np2 is a power of two > 4096, so every thread of the 1024 owns a whole
  // run of np2 / 1024 keys
  const size_t shmem = static_cast<size_t>(ctx->np2) * (sizeof(double) + sizeof(float));
  // the dynamic shared memory beyond the default 48 KB (less the static
  // part) needs the opt-in; set it for every size
  const cudaError_t err = cudaFuncSetAttribute(relax_project_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(ctx->c, ctx->s);
  relax_project_kernel<<<grid, 1024, shmem, st>>>(*ctx);
  return launch_status();
}

// rows of this launch plan resident on one SM at once (one row a block),
// from the occupancy calculator; -1 where the plan is not whole
extern "C" int simtpu_relax_project_rows_per_sm(const RelaxCtx* ctx) {
  int blocks = 0;
  cudaError_t err;
  if (ctx->slabs > 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, relax_project_slab_kernel, 1024, 0);
  } else if (ctx->np2 <= RELAX_REG_ROW) {
    if (!reg_plan_ok(*ctx)) return -1;
    err = ctx->kpt == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, relax_project_reg_kernel<4>,
                                                                        ctx->threads, reg_smem<4>(*ctx))
                        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, relax_project_reg_kernel<8>,
                                                                        ctx->threads, reg_smem<8>(*ctx));
  } else {
    const size_t shmem = static_cast<size_t>(ctx->np2) * (sizeof(double) + sizeof(float));
    err = cudaFuncSetAttribute(relax_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shmem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, relax_project_kernel, 1024, shmem);
  }
  return err == cudaSuccess ? blocks : -1;
}
