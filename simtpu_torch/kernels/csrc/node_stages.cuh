// Per-node device code of the filter stages (K1), shared by filter_pod.cu,
// the wave kernels wave_lean.cu (K9) and wave_hard.cu (K10), sweep_place.cu
// (K19) and explain_pass.cu (K20): one source for every path, so a stage
// or an FMA site cannot drift between them; and
// the commit's (K4, commit_pod.cu) update of the chosen node's own rows.
// K10 and K19 (sweep_place.cu) copy the commit's arithmetic — this
// function and commit_pod.cu's per-node update, which their comments call
// commit_node, the single-thread form the two were split from.
//
// The stages are those of the JAX package's simtpu/kernels/filters.py
// :23-76 as simtpu/engine/scan.py filter_and_score runs them
// (scan.py:765-795); the commit is schedule_step's update block
// (scan.py:1059-1131) through simtpu/engine/state.py add_rows (:62).
#pragma once
#include "step_ctx.cuh"

// -- the stage arithmetic, once for every caller --------------------------
//
// Each stage is a predicate of the state, written once here over the
// rows it reads: the group's rows (`GroupRows`: in place in the StepCtx,
// or K1's staged copy in shared memory) and the node's rows (pointers
// into the StepCtx, read in place, or K1's registers). `all_of<M>` walks
// a row: M = 0 a runtime loop that stops at the first failure (the
// callers that read the node's rows in place), M > 0 a loop unrolled to M
// over rows already in registers, every element up to n evaluated (a
// branch out past n, so a row costs its length and not M).

template <int M, class F>
__device__ __forceinline__ bool all_of(int n, F&& f) {
  if constexpr (M > 0) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j >= n) break;
      ok = f(j) && ok;
    }
    return ok;
  } else {
    for (int j = 0; j < n; ++j)
      if (!f(j)) return false;
    return true;
  }
}

// NodePorts: a wanted host port already in use
__device__ __forceinline__ bool port_clash(bool want, float used) { return want && used > 0.0f; }

// NodeResourcesFit: free + 1e-5 * max(|free|, 1) >= req, the slack
// contracted as in the reference
__device__ __forceinline__ bool res_fits(float f, float req) {
  return __fmaf_rn(1e-5f, fmaxf(fabsf(f), 1.0f), f) >= req;
}

// VolumeRestrictions: a read-write claim on a used volume, or a read-only
// claim on a volume with a read-write user
__device__ __forceinline__ bool vol_clash(bool rw, bool ro, float any, float rw_users) {
  return (rw && any > 0.0f) || (ro && rw_users > 0.0f);
}

// NodeVolumeLimits: a volume of the class counts as used where the node
// has it, as added where the pod attaches it and the node has not; the
// class passes where the pod adds nothing or the sum stays within the
// node's limit (counts: exact in any order)
__device__ __forceinline__ void attach_add(float any, bool att, float& used, float& added) {
  if (any > 0.0f) used += 1.0f;
  else if (att) added += 1.0f;
}
__device__ __forceinline__ bool attach_within(float used, float added, float limit) {
  return added == 0.0f || used + added <= limit;
}

// pin: -1 = unpinned, -2 = pinned to a nonexistent node (matches nothing)
__device__ __forceinline__ bool pin_ok(int pin, int n) { return pin >= 0 ? (n == pin) : (pin > -2); }

// The group's filter rows: ports_req[g] [P], vol_rw/ro/att_req[g] [W] and
// vol_class_mask [C, W]
struct GroupRows {
  const uint8_t* ports;
  const uint8_t* rw;
  const uint8_t* ro;
  const uint8_t* att;
  const uint8_t* cmask;
};

__device__ inline GroupRows group_rows(const StepCtx& x, int g) {
  const size_t gw = static_cast<size_t>(g) * x.w;
  return {x.ports_req + static_cast<size_t>(g) * x.p_ports, x.vol_rw_req + gw, x.vol_ro_req + gw,
          x.vol_att_req + gw, x.vol_class_mask};
}

template <int M>
__device__ inline bool ports_free_rows(const uint8_t* want, const float* used, int P) {
  return all_of<M>(P, [&](int p) { return !port_clash(want[p], used[p]); });
}

template <int M>
__device__ inline bool res_fit_rows(const float* fr, const float* req, int R) {
  return all_of<M>(R, [&](int r) { return res_fits(fr[r], req[r]); });
}

template <int M>
__device__ inline bool vols_free_rows(const GroupRows& gr, const float* any, const float* rw_users, int W) {
  return all_of<M>(W, [&](int w) { return !vol_clash(gr.rw[w], gr.ro[w], any[w], rw_users[w]); });
}

// attach limits class by class, one pass over W per class (the rows read
// in place)
__device__ inline bool attach_ok_rows(const GroupRows& gr, const float* any, const float* limits, int C, int W) {
  for (int c = 0; c < C; ++c) {
    const uint8_t* cm = gr.cmask + static_cast<size_t>(c) * W;
    float used = 0.0f, added = 0.0f;
    for (int w = 0; w < W; ++w)
      if (cm[w]) attach_add(any[w], gr.att[w], used, added);
    if (!attach_within(used, added, limits[c])) return false;
  }
  return true;
}

// attach limits of up to CM classes in one pass over W: `cbits[w]` holds
// bit c where volume w is of class c (K1 stages it); each class's counts
// add in the same order as attach_ok_rows'
template <int CM, int M>
__device__ inline bool attach_ok_bits(const uint8_t* cbits, const uint8_t* att, const float* any, const float* limits,
                                      int C, int W) {
  float used[CM], added[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) used[c] = added[c] = 0.0f;
#pragma unroll
  for (int w = 0; w < M; ++w) {
    if (w >= W) break;
    const unsigned b = cbits[w];
#pragma unroll
    for (int c = 0; c < CM; ++c)
      if ((b >> c) & 1u) attach_add(any[w], att[w], used[c], added[c]);
  }
  return all_of<CM>(C, [&](int c) { return attach_within(used[c], added[c], limits[c]); });
}

// The cumulative stage byte from the stages' verdicts: bits 0 static
// (mask row, pin, node_valid), 1 ports, 2 resources, 3 volumes, 4 attach,
// 5 bind; a stage whose flag is off passes (bits 6-7 are K2's). `Stages`
// gives each verdict; a caller that reads in place evaluates a stage only
// where every earlier one passed, K1 has them all at hand already.
template <class Stages>
__device__ inline unsigned stage_bits(const StepCtx& x, Stages& s) {
  bool m = s.static_ok();
  unsigned bits = m ? 1u : 0u;
  if (m && (x.flags & F_PORTS)) m = s.ports();
  bits |= (m ? 1u : 0u) << 1;
  if (m) m = s.res();
  bits |= (m ? 1u : 0u) << 2;
  if (m && (x.flags & F_VOLS)) m = s.vols();
  bits |= (m ? 1u : 0u) << 3;
  if (m && (x.flags & F_ATTACH)) m = s.attach();
  bits |= (m ? 1u : 0u) << 4;
  m = m && s.bind();
  bits |= (m ? 1u : 0u) << 5;
  return bits;
}

// the node's rows read in place, each stage on demand
struct InPlaceStages {
  const StepCtx& x;
  const GroupRows gr;
  const float* req;
  int g, pin, n;
  __device__ size_t gn() const { return static_cast<size_t>(g) * x.n + n; }
  __device__ bool static_ok() const { return x.static_mask[gn()] && pin_ok(pin, n) && x.node_valid[n]; }
  __device__ bool ports() const {
    return ports_free_rows<0>(gr.ports, x.ports_used + static_cast<size_t>(n) * x.p_ports, x.p_ports);
  }
  __device__ bool res() const { return res_fit_rows<0>(x.free + static_cast<size_t>(n) * x.r, req, x.r); }
  __device__ bool vols() const {
    const size_t nw = static_cast<size_t>(n) * x.w;
    return vols_free_rows<0>(gr, x.vols_any + nw, x.vols_rw + nw, x.w);
  }
  __device__ bool attach() const {
    return attach_ok_rows(gr, x.vols_any + static_cast<size_t>(n) * x.w,
                             x.attach_limits + static_cast<size_t>(n) * x.c, x.c, x.w);
  }
  __device__ bool bind() const { return x.vol_mask[gn()]; }
};

// the stages one at a time over the StepCtx rows in place (K9, K10, K19)
__device__ inline bool ports_free(const StepCtx& x, int g, int n) {
  return ports_free_rows<0>(x.ports_req + static_cast<size_t>(g) * x.p_ports,
                            x.ports_used + static_cast<size_t>(n) * x.p_ports, x.p_ports);
}
__device__ inline bool res_fit(const StepCtx& x, const float* req, int n) {
  return res_fit_rows<0>(x.free + static_cast<size_t>(n) * x.r, req, x.r);
}
__device__ inline bool vols_free(const StepCtx& x, int g, int n) {
  const size_t nw = static_cast<size_t>(n) * x.w;
  return vols_free_rows<0>(group_rows(x, g), x.vols_any + nw, x.vols_rw + nw, x.w);
}
__device__ inline bool attach_ok(const StepCtx& x, int g, int n) {
  return attach_ok_rows(group_rows(x, g), x.vols_any + static_cast<size_t>(n) * x.w,
                           x.attach_limits + static_cast<size_t>(n) * x.c, x.c, x.w);
}

// The stage byte of pod i at node n over the StepCtx rows in place (K20;
// K1 past its register widths reads the same way, with the pod's group,
// pin and group rows given)
__device__ inline unsigned filter_bits(const StepCtx& x, int i, int n) {
  const int g = x.group[i];
  InPlaceStages s{x, group_rows(x, g), x.req + static_cast<size_t>(i) * x.r, g, x.pin[i], n};
  return stage_bits(x, s);
}

// K4's update of the chosen node c's own rows for pod i (placed there),
// one family of rows (CommitPart) spread over `lanes` threads, this one
// `lane` of them: the request out of its free row, the group's ports and
// exclusive volumes into its planes, and the pod's LVM allocation,
// exclusive devices and GPU shares x per-GPU memory at c (K5/K6's plans;
// none for a pod that skipped them) out of vg_free, sdev_free and gpu_free
// and into the pod's output rows. Each entry has one writer.
enum CommitPart : int { COMMIT_FREE = 0, COMMIT_PORTS, COMMIT_VOLS, COMMIT_STORAGE, COMMIT_GPU, COMMIT_PARTS };

__device__ inline void commit_chosen_rows(const StepCtx& x, int i, int c, int g, int part, int lane, int lanes) {
  const int f = x.flags;
  if (part == COMMIT_FREE) {
    const float* req = x.req + static_cast<size_t>(i) * x.r;
    float* fr = x.free + static_cast<size_t>(c) * x.r;
    for (int r = lane; r < x.r; r += lanes) fr[r] = fr[r] - req[r];
  } else if (part == COMMIT_PORTS && (f & F_PORTS)) {
    const uint8_t* want = x.ports_req + static_cast<size_t>(g) * x.p_ports;
    float* used = x.ports_used + static_cast<size_t>(c) * x.p_ports;
    for (int p = lane; p < x.p_ports; p += lanes) used[p] = used[p] + (want[p] ? 1.0f : 0.0f);
  } else if (part == COMMIT_VOLS && (f & (F_VOLS | F_ATTACH))) {
    const size_t gw = static_cast<size_t>(g) * x.w;
    const size_t cw = static_cast<size_t>(c) * x.w;
    for (int w = lane; w < x.w; w += lanes) {
      const bool rw = x.vol_rw_req[gw + w];
      const bool present = rw || x.vol_ro_req[gw + w] || x.vol_att_req[gw + w];
      x.vols_any[cw + w] = x.vols_any[cw + w] + (present ? 1.0f : 0.0f);
      if (f & F_VOLS) x.vols_rw[cw + w] = x.vols_rw[cw + w] + (rw ? 1.0f : 0.0f);
    }
  } else if (part == COMMIT_STORAGE && (f & F_STORAGE) && (x.ext_live[i] & LIVE_STORAGE)) {
    const size_t cv = static_cast<size_t>(c) * x.v, iv = static_cast<size_t>(i) * x.v;
    for (int v = lane; v < x.v; v += lanes) {
      const float a = x.st_alloc[cv + v];
      x.vg_free[cv + v] = x.vg_free[cv + v] + (-a);
      x.out_lvm[iv + v] = a;
    }
    const size_t cs = static_cast<size_t>(c) * x.sd, is = static_cast<size_t>(i) * x.sd;
    for (int d = lane; d < x.sd; d += lanes) {
      const uint8_t take = x.st_take[cs + d];
      x.sdev_free[cs + d] = (x.sdev_free[cs + d] && !take) ? 1 : 0;
      x.out_take[is + d] = take;
    }
  } else if (part == COMMIT_GPU && (f & F_GPU) && (x.ext_live[i] & LIVE_GPU)) {
    const float mem = x.gpu_mem[i];
    const size_t cg = static_cast<size_t>(c) * x.gd, ig = static_cast<size_t>(i) * x.gd;
    for (int d = lane; d < x.gd; d += lanes) {
      const float sh = x.gpu_sh[cg + d];
      x.gpu_free[cg + d] = x.gpu_free[cg + d] + (-sh) * mem;
      x.out_gpu[ig + d] = sh;
    }
  }
}
