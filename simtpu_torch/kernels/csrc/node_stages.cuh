// Per-node device code of the filter stages (K1) and of the commit (K4),
// shared by filter_pod.cu, commit_pod.cu and the wave kernels
// wave_lean.cu (K9) and wave_hard.cu (K10): one source for every path,
// so a stage or an FMA site cannot drift between them.
//
// The stages are those of the JAX package's simtpu/kernels/filters.py
// :23-76 as simtpu/engine/scan.py filter_and_score runs them
// (scan.py:765-795); the commit is schedule_step's update block
// (scan.py:1059-1131) through simtpu/engine/state.py add_rows (:62).
#pragma once
#include "step_ctx.cuh"

// NodePorts: none of the group's host ports is in use on node n
__device__ inline bool ports_free(const StepCtx& x, int g, int n) {
  const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
  const float* used = x.ports_used + static_cast<size_t>(n) * x.p_ports;
  for (int p = 0; p < x.p_ports; ++p) {
    if (want[p] && used[p] > 0.0f) return false;
  }
  return true;
}

// NodeResourcesFit: free + 1e-5 * max(|free|, 1) >= req on every resource,
// the slack contracted as in the reference
__device__ inline bool res_fit(const StepCtx& x, const float* req, int n) {
  const float* fr = x.free + static_cast<size_t>(n) * x.r;
  for (int r = 0; r < x.r; ++r) {
    const float f = fr[r];
    if (!(__fmaf_rn(1e-5f, fmaxf(fabsf(f), 1.0f), f) >= req[r])) return false;
  }
  return true;
}

// VolumeRestrictions: no read-write claim on a used volume, no read-only
// claim on a volume with a read-write user
__device__ inline bool vols_free(const StepCtx& x, int g, int n) {
  const size_t gw = static_cast<size_t>(g) * x.w;
  const size_t nw = static_cast<size_t>(n) * x.w;
  for (int w = 0; w < x.w; ++w) {
    if ((x.vol_rw_req[gw + w] && x.vols_any[nw + w] > 0.0f) ||
        (x.vol_ro_req[gw + w] && x.vols_rw[nw + w] > 0.0f)) return false;
  }
  return true;
}

// NodeVolumeLimits: per attach class, the node's volumes plus the pod's
// new ones stay within the node's limit (counts: exact in any order)
__device__ inline bool attach_ok(const StepCtx& x, int g, int n) {
  const size_t gw = static_cast<size_t>(g) * x.w;
  const size_t nw = static_cast<size_t>(n) * x.w;
  for (int c = 0; c < x.c; ++c) {
    const uint8_t* cm = x.vol_class_mask + static_cast<size_t>(c) * x.w;
    float used = 0.0f, added = 0.0f;
    for (int w = 0; w < x.w; ++w) {
      if (!cm[w]) continue;
      if (x.vols_any[nw + w] > 0.0f) used += 1.0f;
      else if (x.vol_att_req[gw + w]) added += 1.0f;
    }
    if (!(added == 0.0f || used + added <= x.attach_limits[static_cast<size_t>(n) * x.c + c])) return false;
  }
  return true;
}

// K1's stage byte of pod i at node n: bits 0 static (mask row, pin,
// node_valid), 1 ports, 2 resources, 3 volumes, 4 attach, 5 bind
// (cumulative; bits 6-7 are K2's)
__device__ inline unsigned filter_bits(const StepCtx& x, int i, int n) {
  const int g = x.group[i];
  const int pin = x.pin[i];
  const float* req = x.req + static_cast<size_t>(i) * x.r;
  const size_t gn = static_cast<size_t>(g) * x.n + n;
  // pin: -1 = unpinned, -2 = pinned to a nonexistent node (matches nothing)
  const bool pin_ok = pin >= 0 ? (n == pin) : (pin > -2);
  bool m = x.static_mask[gn] && pin_ok && x.node_valid[n];
  unsigned bits = m ? 1u : 0u;
  if (m && (x.flags & F_PORTS)) m = ports_free(x, g, n);
  bits |= (m ? 1u : 0u) << 1;
  if (m) m = res_fit(x, req, n);
  bits |= (m ? 1u : 0u) << 2;
  if (m && (x.flags & F_VOLS)) m = vols_free(x, g, n);
  bits |= (m ? 1u : 0u) << 3;
  if (m && (x.flags & F_ATTACH)) m = attach_ok(x, g, n);
  bits |= (m ? 1u : 0u) << 4;
  m = m && x.vol_mask[gn];
  bits |= (m ? 1u : 0u) << 5;
  return bits;
}

// K4's update at node n for pod i (reads chosen/placed, which K3 wrote):
// the chosen node's thread takes the request, ports, volumes and the
// pod's extended allocations into its rows and bumps cnt_total; every
// node's thread adds the group's incidence into its count and own-plane
// entries of each term whose domain it shares with the chosen node. Each
// (row, node) entry has one writer. The per-pod outputs (chosen, placed
// and the extended allocations) are at row `o` (default: the pod's row i;
// the scenario sweep K19 writes row j of its requeue list).
__device__ inline void commit_node(const StepCtx& x, int i, int n, int o = -1) {
  if (o < 0) o = i;
  if (!x.placed[o]) return;
  const int N = x.n;
  const int c = x.chosen[o];
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
      const size_t cv = static_cast<size_t>(c) * x.v, iv = static_cast<size_t>(o) * x.v;
      for (int v = 0; v < x.v; ++v) {
        const float a = x.st_alloc[cv + v];
        x.vg_free[cv + v] = x.vg_free[cv + v] + (-a);
        x.out_lvm[iv + v] = a;
      }
      const size_t cs = static_cast<size_t>(c) * x.sd, is = static_cast<size_t>(o) * x.sd;
      for (int d = 0; d < x.sd; ++d) {
        const uint8_t take = x.st_take[cs + d];
        x.sdev_free[cs + d] = (x.sdev_free[cs + d] && !take) ? 1 : 0;
        x.out_take[is + d] = take;
      }
    }
    if ((f & F_GPU) && (live & LIVE_GPU)) {
      const float mem = x.gpu_mem[i];
      const size_t cg = static_cast<size_t>(c) * x.gd, ig = static_cast<size_t>(o) * x.gd;
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
