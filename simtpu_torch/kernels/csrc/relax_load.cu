// K22 relax_load: the load and overcommit of every candidate's current
// fractional assignment.
//
// Replaces the einsum half of the JAX package's simtpu/solve/relax.py
// _relax_kernel (:218, its body's `load` / `over` and the final residual):
// for candidate s and node n,
//   free[r]      = max((cap[n, r] - fixed[n, r]) * valid[s, n], 0)
//   load[r]      = sum_c y[s, c, n] * req[c, r]      (c ascending, f32)
//   over[s,n,r]  = max(load[r] - free[r], 0)
// and in residual mode residual[s] = max over (n, r) of over (0 at least),
// +inf when the init step flagged a class with demand but no feasible
// valid node.
//
// Bound: bytes — y [S, C, N] read once, over [S, N, R] written once (cap,
// fixed and req stay in cache). At the capacity relaxation's (S, C, N, R)
// = (100, 61, 999, 3) that is 25.7 MB, 7.67 µs at 3.35 TB/s.
//
// Design: the grid is (node tiles, S), each thread NPT nodes of one
// candidate (node tile start + t + j * threads: a warp's loads of one y
// row are one contiguous run). The class loop is outer and the R sums of
// each node stay in registers, so every element of y is read once (the
// earlier kernel looped r outer and re-read its column of y R times). The
// sums are a left fold over c (ascending, __fmul_rn / __fadd_rn, no FMA:
// bit for bit relax_load_plain), so no sum is split over threads; the loop
// is unrolled U classes deep, so U x NPT independent loads of y are in
// flight a thread. The block stages req's rows for its R sums in shared
// memory (RELAX_LOAD_REQ_ROWS classes at a time, zero-padded to RMAX
// columns), so the fold's inner loop reads its weights from shared memory
// without a guard per resource: the padded sums are computed and dropped.
// Threads past the last node load the last node's column and write
// nothing. (On the card a bare read of y with this layout is close to a
// contiguous stream of it; what held the earlier kernel back was its
// per-class global reads of req and its guard per resource, not its
// bytes. 4-byte cp.async copies into shared memory were slower than
// plain loads.) TMA bulk copies do not fit: y's rows are N x 4 bytes, 16-byte aligned only
// where 4 divides N, and padding them would move K23's indexing. RMAX (4
// or 8) bounds the sums a thread holds; above 8 resources the same loop
// runs once per chunk of 8 resources, re-reading y each time. The residual
// max is taken per block and folded into residual[s] by atomicMax on the
// bit pattern of a non-negative float, which orders like the float
// itself, so the result does not depend on the blocks' order. The launch
// plan (threads, NPT, U) is the wrapper's (kernels/cuda.py
// relax_load_plan), carried in RelaxCtx.
#include "relax.cuh"

template <int RMAX, int NPT, int U>
__global__ void __launch_bounds__(RELAX_LOAD_THREADS) relax_load_kernel(RelaxCtx x) {
  __shared__ float sreq[RELAX_LOAD_REQ_ROWS * RMAX];  // [classes][RMAX] of the resource chunk
  __shared__ float warp_peak[RELAX_LOAD_THREADS / 32];
  const int s = blockIdx.y;
  const int N = x.n, C = x.c, R = x.r;
  const int tid = threadIdx.x, nt = blockDim.x;
  int node[NPT];  // the thread's nodes, past N the last one (loaded, not written)
#pragma unroll
  for (int j = 0; j < NPT; ++j) node[j] = min(blockIdx.x * nt * NPT + tid + j * nt, N - 1);
  const float* ys = x.y + static_cast<size_t>(s) * C * N;
  float peak = 0.0f;
  for (int r0 = 0; N > 0 && r0 < R; r0 += RMAX) {
    const int rn = min(RMAX, R - r0);
    float load[NPT][RMAX];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
#pragma unroll
      for (int q = 0; q < RMAX; ++q) load[j][q] = 0.0f;
    for (int cb = 0; cb < C; cb += RELAX_LOAD_REQ_ROWS) {
      const int cn = min(RELAX_LOAD_REQ_ROWS, C - cb);
      __syncthreads();  // the previous rows' readers are done
      for (int i = tid; i < cn * RMAX; i += nt) {
        const int c = i / RMAX, q = i - c * RMAX;
        sreq[i] = q < rn ? x.req[static_cast<size_t>(cb + c) * R + r0 + q] : 0.0f;
      }
      __syncthreads();
      const float* yb = ys + static_cast<size_t>(cb) * N;
      auto fold = [&](int c, const float (&v)[NPT]) {
#pragma unroll
        for (int q = 0; q < RMAX; ++q) {
          const float w = sreq[c * RMAX + q];
#pragma unroll
          for (int j = 0; j < NPT; ++j) load[j][q] = __fadd_rn(load[j][q], __fmul_rn(v[j], w));
        }
      };
      int c = 0;
      for (; c + U <= cn; c += U) {
        float v[U][NPT];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < NPT; ++j) v[u][j] = __ldg(yb + static_cast<size_t>(c + u) * N + node[j]);
#pragma unroll
        for (int u = 0; u < U; ++u) fold(c + u, v[u]);
      }
      for (; c < cn; ++c) {
        float v[NPT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) v[j] = __ldg(yb + static_cast<size_t>(c) * N + node[j]);
        fold(c, v);
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = blockIdx.x * nt * NPT + tid + j * nt;
      if (n >= N) continue;
      const float member = x.valid[static_cast<size_t>(s) * N + n] ? 1.0f : 0.0f;
      float* out = x.over + (static_cast<size_t>(s) * N + n) * R + r0;
      const float* cap = x.cap + static_cast<size_t>(n) * R + r0;
      const float* fixed = x.fixed + static_cast<size_t>(n) * R + r0;
#pragma unroll
      for (int q = 0; q < RMAX; ++q) {
        if (q >= rn) break;
        const float room = fmaxf(__fmul_rn(__fsub_rn(cap[q], fixed[q]), member), 0.0f);
        const float o = fmaxf(__fsub_rn(load[j][q], room), 0.0f);
        out[q] = o;
        peak = fmaxf(peak, o);
      }
    }
  }
  if (!(x.mode & RELAX_RESIDUAL)) return;
  for (int off = 16; off > 0; off >>= 1) peak = fmaxf(peak, __shfl_down_sync(0xffffffffu, peak, off));
  if ((tid & 31) == 0) warp_peak[tid >> 5] = peak;
  __syncthreads();
  if (tid == 0) {
    float m = 0.0f;
    for (int w = 0; w < (nt >> 5); ++w) m = fmaxf(m, warp_peak[w]);
    const int bits = x.stuck[s] ? __float_as_int(INFINITY) : (m > 0.0f ? __float_as_int(m) : 0);
    atomicMax(reinterpret_cast<int*>(x.residual) + s, bits);
  }
}

namespace {

template <int RMAX, int NPT, int U>
int launch_load(const RelaxCtx& x, cudaStream_t stream) {
  const int per_block = x.load_threads * NPT;
  // one block at least: with no nodes it still writes residual[s]
  const dim3 grid(max(1, (x.n + per_block - 1) / per_block), x.s);
  relax_load_kernel<RMAX, NPT, U><<<grid, x.load_threads, 0, stream>>>(x);
  return launch_status();
}

template <int RMAX, int NPT>
int launch_load_u(const RelaxCtx& x, cudaStream_t stream) {
  switch (x.load_unroll) {
    case 4: return launch_load<RMAX, NPT, 4>(x, stream);
    case 8: return launch_load<RMAX, NPT, 8>(x, stream);
    case 16: return launch_load<RMAX, NPT, 16>(x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int RMAX>
int launch_load_r(const RelaxCtx& x, cudaStream_t stream) {
  switch (x.load_npt) {
    case 1: return launch_load_u<RMAX, 1>(x, stream);
    case 2: return launch_load_u<RMAX, 2>(x, stream);
    case 4: return launch_load_u<RMAX, 4>(x, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// the wrapper's plan (kernels/cuda.py relax_load_plan): threads a block,
// nodes a thread (1, 2, 4), classes unrolled (4, 8, 16); R <= 4 and R <= 8
// have their own templates, a wider R runs in chunks of 8
extern "C" int simtpu_relax_load(const RelaxCtx* ctx, void* stream) {
  if (ctx->s == 0) return 0;
  if (ctx->load_threads < 32 || ctx->load_threads > RELAX_LOAD_THREADS || ctx->load_threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ctx->r <= 4 ? launch_load_r<4>(*ctx, s) : launch_load_r<8>(*ctx, s);
}
