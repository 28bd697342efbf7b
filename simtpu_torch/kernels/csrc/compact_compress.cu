// K11 compact_compress: the dense carried state in the compact layout.
//
// Replaces the JAX package's simtpu/engine/state.py _compress_state_fn
// (:1027, with _compress_rows :999), jitted as compress_state: at the end
// of each batch the engine stores its final state compressed.
//
// One launch writes every narrowed plane, one thread per output element,
// over the segments below in CompactState order:
// - a tabular element [r, d] of a count plane is the plane's row
//   ids_tab[r] at the domain's representative node rep[r, d] (0 where the
//   domain has no node): a gather, not a reduction, exact because a
//   tabular row is constant within a domain (every writer of the state —
//   K4, K7, K9/K10, K13 — updates all nodes of the domain);
// - a dense element [r, n] is the plane's row ids_dense[r] at node n;
// - cnt_total, ports_used, vols_any and vols_rw are cast to int32;
// - sdev_free is copied (bool).
// Casts truncate toward zero, as XLA's f32 -> s32 convert does; the
// values are integer counts and integer preference weights, so they are
// exact. free, vg_free and gpu_free move into the compact state without a
// copy (the wrapper hands over the dense tensors).
//
// Bound: bytes — each output element is written once and reads one input
// element (the tabular ones one of D per domain), so the launch moves the
// compact carry out and the dense rows in; a few microseconds at
// N = 1000, where one launch's latency dominates.
#include "step_ctx.cuh"

__device__ inline void compress_element(const CompactCtx& x, long long j) {
  const long long N = x.n;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const CountPlane c = count_plane(x, q);
    const long long nt = static_cast<long long>(c.rt) * x.d;
    if (j < nt) {
      const int rep = c.rep[j];
      const long long row = c.ids_tab[j / x.d];
      c.tab[j] = rep >= 0 ? static_cast<int>(c.full[row * N + rep]) : 0;
      return;
    }
    j -= nt;
    const long long nd = static_cast<long long>(c.rd) * N;
    if (j < nd) {
      c.dense[j] = static_cast<int>(c.full[static_cast<long long>(c.ids_dense[j / N]) * N + j % N]);
      return;
    }
    j -= nd;
  }
  if (j < x.t) {
    x.c_cnt_total[j] = static_cast<int>(x.cnt_total[j]);
    return;
  }
  j -= x.t;
  const long long np = N * x.p, nw = N * x.w;
  if (j < np) {
    x.c_ports_used[j] = static_cast<int>(x.ports_used[j]);
    return;
  }
  j -= np;
  if (j < nw) {
    x.c_vols_any[j] = static_cast<int>(x.vols_any[j]);
    return;
  }
  j -= nw;
  if (j < nw) {
    x.c_vols_rw[j] = static_cast<int>(x.vols_rw[j]);
    return;
  }
  j -= nw;
  x.c_sdev_free[j] = x.sdev_free[j];
}

__global__ void compact_compress_kernel(CompactCtx x, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    compress_element(x, j);
  }
}

extern "C" int simtpu_compact_compress(const CompactCtx* ctx, void* stream) {
  const CompactCtx& x = *ctx;
  const long long n = x.n;
  const long long total = static_cast<long long>(x.rt) * x.d + static_cast<long long>(x.rd) * n +
                          4 * (static_cast<long long>(x.rti) * x.d + static_cast<long long>(x.rdi) * n) +
                          x.t + n * (x.p + 2LL * x.w + x.sd);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  compact_compress_kernel<<<static_cast<int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, total);
  return launch_status();
}
