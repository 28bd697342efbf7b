// K4 commit_pod: the state update of one placed pod, IN PLACE.
//
// Replaces the update block of the JAX package's simtpu/engine/scan.py
// schedule_step (scan.py:1059-1131) and the row scatter add_rows
// (simtpu/engine/state.py:62) it runs through. Reads chosen/placed from
// device memory (K3 wrote them); a pod that was not placed changes
// nothing. The thread of the chosen node subtracts the request from its
// free row, adds the group's ports and exclusive volumes, takes the pod's
// LVM allocation, exclusive devices and GPU shares x per-GPU memory at
// that node (K5/K6's plans; none for a pod that skipped them) out of
// vg_free, sdev_free and gpu_free and writes them to the pod's output
// rows, and bumps cnt_total; every node thread adds the group's incidence into its
// cnt_match and own-plane entries for each term whose domain it shares
// with the chosen node. Each (row, node) entry has one writer: no atomics,
// no order dependence.
//
// Bound: bytes — the group's Tc domain rows are read and the touched
// count/own-plane rows read and written once; at N <= 1024 the launch
// latency dominates.
#include "step_ctx.cuh"

__global__ void commit_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n || !x.placed[i]) return;
  const int N = x.n;
  const int c = x.chosen[i];
  const int g = x.group[i];
  const int f = x.flags;
  if (n == c) {
    const float* req = x.req + static_cast<size_t>(i) * x.r;
    float* fr = x.free + static_cast<size_t>(c) * x.r;
    for (int r = 0; r < x.r; ++r) fr[r] = fr[r] - req[r];
    if (f & F_PORTS) {
      const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
      float* used = x.ports_used + static_cast<size_t>(c) * x.p_ports;
      for (int p = 0; p < x.p_ports; ++p) used[p] = used[p] + (want[p] ? 1.0f : 0.0f);
    }
    if (f & (F_VOLS | F_ATTACH)) {
      const size_t gw = static_cast<size_t>(g) * x.w;
      const size_t cw = static_cast<size_t>(c) * x.w;
      for (int w = 0; w < x.w; ++w) {
        const bool rw = x.vol_rw_req[gw + w];
        const bool present = rw || x.vol_ro_req[gw + w] || x.vol_att_req[gw + w];
        x.vols_any[cw + w] = x.vols_any[cw + w] + (present ? 1.0f : 0.0f);
        if (f & F_VOLS) x.vols_rw[cw + w] = x.vols_rw[cw + w] + (rw ? 1.0f : 0.0f);
      }
    }
    const unsigned live = x.ext_live[i];
    if ((f & F_STORAGE) && (live & LIVE_STORAGE)) {
      const size_t cv = static_cast<size_t>(c) * x.v, iv = static_cast<size_t>(i) * x.v;
      for (int v = 0; v < x.v; ++v) {
        const float a = x.st_alloc[cv + v];
        x.vg_free[cv + v] = x.vg_free[cv + v] + (-a);
        x.out_lvm[iv + v] = a;
      }
      const size_t cs = static_cast<size_t>(c) * x.sd, is = static_cast<size_t>(i) * x.sd;
      for (int d = 0; d < x.sd; ++d) {
        const uint8_t take = x.st_take[cs + d];
        x.sdev_free[cs + d] = (x.sdev_free[cs + d] && !take) ? 1 : 0;
        x.out_take[is + d] = take;
      }
    }
    if ((f & F_GPU) && (live & LIVE_GPU)) {
      const float mem = x.gpu_mem[i];
      const size_t cg = static_cast<size_t>(c) * x.gd, ig = static_cast<size_t>(i) * x.gd;
      for (int d = 0; d < x.gd; ++d) {
        const float sh = x.gpu_sh[cg + d];
        x.gpu_free[cg + d] = x.gpu_free[cg + d] + (-sh) * mem;
        x.out_gpu[ig + d] = sh;
      }
    }
  }
  if (!(f & F_TOPOLOGY) || x.tc == 0) return;
  const int* terms = x.g_terms + static_cast<size_t>(g) * x.tc;
  for (int t = 0; t < x.tc; ++t) {
    const int term = terms[t];
    if (term < 0) continue;
    const size_t gt = static_cast<size_t>(g) * x.tc + t;
    const int* dom = x.node_dom + static_cast<size_t>(x.term_topo[term]) * N;
    const int dc = dom[c];
    if (dc < 0) continue;  // the chosen node misses this term's key
    const float s = x.s_match[gt] ? 1.0f : 0.0f;
    if (n == c) x.cnt_total[term] = x.cnt_total[term] + s;
    if (dom[n] != dc) continue;
    const size_t tn = static_cast<size_t>(term) * N + n;
    x.cnt_match[tn] = x.cnt_match[tn] + s;
    const int ip = x.ip_of[term];
    if (ip < 0) continue;
    const size_t ipn = static_cast<size_t>(ip) * N + n;
    if (f & F_INTERPOD_REQ) {
      x.cnt_own_anti[ipn] = x.cnt_own_anti[ipn] + (x.a_anti_req[gt] ? 1.0f : 0.0f);
      x.cnt_own_aff[ipn] = x.cnt_own_aff[ipn] + (x.a_aff_req[gt] ? 1.0f : 0.0f);
    }
    if (f & F_INTERPOD_PREF) {
      x.w_own_aff_pref[ipn] = x.w_own_aff_pref[ipn] + x.w_aff_pref[gt];
      x.w_own_anti_pref[ipn] = x.w_own_anti_pref[ipn] + x.w_anti_pref[gt];
    }
  }
}

extern "C" int simtpu_commit_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 256;
  const int blocks = (ctx->n + threads - 1) / threads;
  commit_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
