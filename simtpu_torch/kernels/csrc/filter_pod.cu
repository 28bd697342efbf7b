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
// Bound: bytes. Each thread owns one node and reads its rows of free
// [N,R], ports_used [N,P], vols_any/vols_rw [N,W] and attach_limits
// [N,C] once, plus the group's mask rows; no reduction, no reuse. At the
// serial path's sizes (N <= 1024) the launch latency dominates.
#include "step_ctx.cuh"

__global__ void filter_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
  const int g = x.group[i];
  const int pin = x.pin[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * x.n + n;
  // pin: -1 = unpinned, -2 = pinned to a nonexistent node (matches nothing)
  const bool pin_ok = pin >= 0 ? (n == pin) : (pin > -2);
  bool m = x.static_mask[gn] && pin_ok && x.node_valid[n];
  unsigned bits = m ? 1u : 0u;
  if (m && (x.flags & F_PORTS)) {
    const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
    const float* used = x.ports_used + static_cast<size_t>(n) * x.p_ports;
    for (int p = 0; p < x.p_ports; ++p) {
      if (want[p] && used[p] > 0.0f) { m = false; break; }
    }
  }
  bits |= (m ? 1u : 0u) << 1;
  if (m) {
    const float* fr = x.free + static_cast<size_t>(n) * x.r;
    for (int r = 0; r < x.r; ++r) {
      const float f = fr[r];
      // free + 1e-5 * max(|free|, 1), contracted as in the reference
      if (!(__fmaf_rn(1e-5f, fmaxf(fabsf(f), 1.0f), f) >= req[r])) { m = false; break; }
    }
  }
  bits |= (m ? 1u : 0u) << 2;
  if (m && (x.flags & F_VOLS)) {
    const size_t gw = static_cast<size_t>(g) * x.w;
    const size_t nw = static_cast<size_t>(n) * x.w;
    for (int w = 0; w < x.w; ++w) {
      if ((x.vol_rw_req[gw + w] && x.vols_any[nw + w] > 0.0f) ||
          (x.vol_ro_req[gw + w] && x.vols_rw[nw + w] > 0.0f)) { m = false; break; }
    }
  }
  bits |= (m ? 1u : 0u) << 3;
  if (m && (x.flags & F_ATTACH)) {
    const size_t gw = static_cast<size_t>(g) * x.w;
    const size_t nw = static_cast<size_t>(n) * x.w;
    for (int c = 0; c < x.c && m; ++c) {
      const uint8_t* cm = x.vol_class_mask + static_cast<size_t>(c) * x.w;
      float used = 0.0f, added = 0.0f;  // counts: exact in any order
      for (int w = 0; w < x.w; ++w) {
        if (!cm[w]) continue;
        if (x.vols_any[nw + w] > 0.0f) used += 1.0f;
        else if (x.vol_att_req[gw + w]) added += 1.0f;
      }
      if (!(added == 0.0f || used + added <= x.attach_limits[static_cast<size_t>(n) * x.c + c])) m = false;
    }
  }
  bits |= (m ? 1u : 0u) << 4;
  m = m && x.vol_mask[gn];
  bits |= (m ? 1u : 0u) << 5;
  x.stage[n] = static_cast<uint8_t>(bits);
}

__global__ void noop_kernel() {}

extern "C" int simtpu_filter_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 256;
  const int blocks = (ctx->n + threads - 1) / threads;
  filter_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}

// an empty launch: the floor every per-pod kernel pays
extern "C" int simtpu_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return launch_status();
}

extern "C" const char* simtpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
