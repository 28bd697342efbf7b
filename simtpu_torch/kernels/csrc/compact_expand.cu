// K12 compact_expand: the dense SchedState of a compact carry.
//
// Replaces the JAX package's simtpu/engine/state.py _expand_state_fn
// (:1061, with _expand_rows :1009), jitted as expand_state: each batch that
// reuses the carried state expands it to the dense planes the scheduling
// kernels read.
//
// One launch writes every element of every dense plane exactly once, one
// thread per element, over the segments below in SchedState order:
// - a count-plane row with a tabular key: node n reads its domain's bucket
//   tab[r, nds[key[r], n]], 0 where the node misses the key;
// - a dense count-plane row: the int32 row cast to f32;
// - cnt_total, ports_used, vols_any and vols_rw: cast to f32;
// - free, vg_free, gpu_free and sdev_free: copied.
// The tabular and dense rows partition each count plane's rows, so no
// zero fill is needed. The continuous planes are copied too, not aliased:
// the scheduling kernels update the dense state in place, and a batch that
// fails part-way must leave the compact carry as it was.
//
// Bound: bytes — each dense element is written once and reads one compact
// element (plus its node_dom_small id on a tabular row).
#include "step_ctx.cuh"

__device__ inline void expand_element(const CompactCtx& x, long long j) {
  const long long N = x.n;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const CountPlane c = count_plane(x, q);
    const long long nt = static_cast<long long>(c.rt) * N;
    if (j < nt) {
      const long long r = j / N, n = j % N;
      const int idx = x.nds[static_cast<long long>(c.keys[r]) * N + n];
      c.full[static_cast<long long>(c.ids_tab[r]) * N + n] =
          idx >= 0 ? static_cast<float>(c.tab[r * x.d + idx]) : 0.0f;
      return;
    }
    j -= nt;
    const long long nd = static_cast<long long>(c.rd) * N;
    if (j < nd) {
      c.full[static_cast<long long>(c.ids_dense[j / N]) * N + j % N] = static_cast<float>(c.dense[j]);
      return;
    }
    j -= nd;
  }
  if (j < x.t) {
    x.cnt_total[j] = static_cast<float>(x.c_cnt_total[j]);
    return;
  }
  j -= x.t;
  const long long nr = N * x.r, nv = N * x.v, ng = N * x.gd, ns = N * x.sd;
  const long long np = N * x.p, nw = N * x.w;
  if (j < nr) {
    x.free[j] = x.c_free[j];
    return;
  }
  j -= nr;
  if (j < nv) {
    x.vg_free[j] = x.c_vg_free[j];
    return;
  }
  j -= nv;
  if (j < ns) {
    x.sdev_free[j] = x.c_sdev_free[j];
    return;
  }
  j -= ns;
  if (j < ng) {
    x.gpu_free[j] = x.c_gpu_free[j];
    return;
  }
  j -= ng;
  if (j < np) {
    x.ports_used[j] = static_cast<float>(x.c_ports_used[j]);
    return;
  }
  j -= np;
  if (j < nw) {
    x.vols_any[j] = static_cast<float>(x.c_vols_any[j]);
    return;
  }
  j -= nw;
  x.vols_rw[j] = static_cast<float>(x.c_vols_rw[j]);
}

__global__ void compact_expand_kernel(CompactCtx x, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    expand_element(x, j);
  }
}

extern "C" int simtpu_compact_expand(const CompactCtx* ctx, void* stream) {
  const CompactCtx& x = *ctx;
  const long long n = x.n;
  const long long total = static_cast<long long>(x.t) * n + 4LL * x.ti * n + x.t +
                          n * (x.r + x.v + x.sd + x.gd + x.p + 2LL * x.w);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : (blocks > 4096 ? 4096 : blocks);
  compact_expand_kernel<<<static_cast<int>(blocks), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, total);
  return launch_status();
}
