// K24 grow_terms: a grow-mode carry's six term planes written into their
// power-of-two buckets.
//
// Replaces the JAX package's simtpu/engine/state.py _pad_terms_kernel
// (:517) and _extend_terms_kernel (:543). Into fresh planes:
//   cnt_match [t_cap, N] row j = old row j (zero at and above the old
//       rows) + appended row inv[j] when inv[j] >= 0,
//   cnt_total [t_cap]    the same with the appended totals,
//   the four own planes [ti_cap, N] row j = old row perm[j], or zero when
//       perm[j] = -1.
// The padding on entry is the same function with no appended rows and
// perm = 0..Ti-1, -1, ... The appended term ids are distinct, so each
// output element has exactly one writer: no atomics, no order to fix.
// Grid: (x blocks striding over a plane, 6 planes).
//
// Bound: bytes — each old plane read once, each appended row read once,
// each bucketed plane written once.
#include "step_ctx.cuh"

struct GrowTermsCtx {
  int n, t_old, t_cap, ti_old, ti_cap, pad_;
  const float* cm;      // [t_old, N]
  const float* ct;      // [t_old]
  const float* own[4];  // [ti_old, N] each
  const int* inv;       // [t_cap] appended row feeding bucket row j, -1 = none
  const float* rows;    // [M, N] appended count rows
  const float* tot;     // [M] appended totals
  const int* perm;      // [ti_cap] old own row feeding new row j, -1 = zero
  float* out_cm;        // [t_cap, N]
  float* out_ct;        // [t_cap]
  float* out_own[4];    // [ti_cap, N] each
};

__global__ void grow_terms_kernel(GrowTermsCtx x) {
  const int plane = blockIdx.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = x.n;
  if (plane == 0) {
    const long long total = static_cast<long long>(x.t_cap) * n;
    for (long long q = tid; q < total; q += stride) {
      const int j = static_cast<int>(q / n);
      const long long col = q - j * n;
      float v = j < x.t_old ? x.cm[q] : 0.0f;
      const int src = x.inv[j];
      if (src >= 0) v = __fadd_rn(v, x.rows[src * n + col]);
      x.out_cm[q] = v;
    }
  } else if (plane == 1) {
    for (long long j = tid; j < x.t_cap; j += stride) {
      float v = j < x.t_old ? x.ct[j] : 0.0f;
      const int src = x.inv[j];
      if (src >= 0) v = __fadd_rn(v, x.tot[src]);
      x.out_ct[j] = v;
    }
  } else {
    const int p = plane - 2;
    const long long total = static_cast<long long>(x.ti_cap) * n;
    for (long long q = tid; q < total; q += stride) {
      const int j = static_cast<int>(q / n);
      const long long col = q - j * n;
      const int src = x.perm[j];
      x.out_own[p][q] = (src >= 0 && src < x.ti_old) ? x.own[p][src * n + col] : 0.0f;
    }
  }
}

extern "C" int simtpu_grow_terms(const GrowTermsCtx* ctx, void* stream) {
  const long long widest = static_cast<long long>(ctx->t_cap > ctx->ti_cap ? ctx->t_cap : ctx->ti_cap) * ctx->n;
  if (widest == 0) return 0;
  const int threads = 256;
  long long blocks = (widest + threads - 1) / threads;
  if (blocks > 1056) blocks = 1056;
  dim3 grid(static_cast<unsigned>(blocks), 6);
  grow_terms_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
