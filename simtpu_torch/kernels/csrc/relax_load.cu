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
// valid node. The grid is (node tiles, S), one thread per (s, n); each
// thread loops over r and, inside, over c in ascending order, as the plain
// version sums. The residual max is taken per block and folded into
// residual[s] by atomicMax on the bit pattern of a non-negative float,
// which orders like the float itself, so the result does not depend on
// the blocks' order.
//
// Bound: bytes — y [S, C, N] read once, over [S, N, R] written once (cap,
// fixed and req stay in cache).
#include "relax.cuh"

__global__ void relax_load_kernel(RelaxCtx x) {
  const int s = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float peak = 0.0f;
  if (n < x.n) {
    const float member = x.valid[static_cast<size_t>(s) * x.n + n] ? 1.0f : 0.0f;
    const float* ys = x.y + static_cast<size_t>(s) * x.c * x.n + n;
    float* out = x.over + (static_cast<size_t>(s) * x.n + n) * x.r;
    for (int r = 0; r < x.r; ++r) {
      float load = 0.0f;
      for (int c = 0; c < x.c; ++c)
        load = __fadd_rn(load, __fmul_rn(ys[static_cast<size_t>(c) * x.n], x.req[c * x.r + r]));
      const float room = fmaxf(__fmul_rn(__fsub_rn(x.cap[n * x.r + r], x.fixed[n * x.r + r]), member), 0.0f);
      const float o = fmaxf(__fsub_rn(load, room), 0.0f);
      out[r] = o;
      peak = fmaxf(peak, o);
    }
  }
  if (!(x.mode & RELAX_RESIDUAL)) return;
  __shared__ float warp_peak[32];
  for (int off = 16; off > 0; off >>= 1) peak = fmaxf(peak, __shfl_down_sync(0xffffffffu, peak, off));
  if ((threadIdx.x & 31) == 0) warp_peak[threadIdx.x >> 5] = peak;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmaxf(m, warp_peak[w]);
    const int bits = x.stuck[s] ? __float_as_int(INFINITY) : (m > 0.0f ? __float_as_int(m) : 0);
    atomicMax(reinterpret_cast<int*>(x.residual) + s, bits);
  }
}

extern "C" int simtpu_relax_load(const RelaxCtx* ctx, void* stream) {
  const int threads = 256;
  dim3 grid((ctx->n + threads - 1) / threads, ctx->s);
  relax_load_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
