// Per-node device code of the Open-Local storage plan (K5) and the
// GPU-share plan (K6), shared by storage_pod.cu, gpu_pod.cu, the hard
// wave kernel wave_hard.cu (K10), sweep_place.cu (K19) and
// explain_pass.cu (K20): one source for every path.
//
// storage_plan: the JAX package's simtpu/kernels/storage.py lvm_plan
// (:25), device_plan (:66) and open_local_score (:100); gpu_plan:
// simtpu/kernels/gpushare.py gpu_plan (:25). The thread of node n walks
// the pod's claims in order and builds the node's plan: the VGs' running
// free space, the allocation and the take row, then the verdict and the
// raw score, whose per-VG usage is summed in XLA's order (xla_row_sum).
// Both plans are written once, as templates over where their rows live
// (a "rows" class): `ScratchPlanRows` reads the node's rows in place and
// builds the plan in the StepCtx scratch rows (st_fr, st_alloc, st_take:
// any width; K10, K19, K20, and K5 past its shared budget), K5's
// `RegPlanRows<M>` holds the node's rows and the plan in registers up to M
// VGs and devices, `SharedPlanRows` the plan's running rows in shared
// memory; `InPlaceGpuRows` reads a node's GPU rows in place and builds its
// shares in its gpu_sh row (gpu_node: K10, K19, K20, and K6 past its
// register templates), K6's `RegGpuRows<M>` holds them in registers. See
// the kernels' notes.
#pragma once
#include "step_ctx.cuh"

// f(j) for j in [0, n): M > 0 a loop unrolled to M (rows in registers)
// that branches out past n, 0 a runtime loop
template <int M, class F>
__device__ __forceinline__ void each(int n, F&& f) {
  if constexpr (M > 0) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (j >= n) break;
      f(j);
    }
  } else {
    for (int j = 0; j < n; ++j) f(j);
  }
}

// XLA's CPU backend sums a row of n floats (jnp.sum over the last axis)
// left to right up to XLA_ROW_PART columns; past that in k = ceil(n / 32)
// contiguous parts — with r = n - 32 (k - 2), a head of (r + 1) / 2
// columns, k - 2 parts of 32, a tail of r / 2 — each summed left to right
// from 0, then the parts left to right from 0 (kernels/storage.py
// xla_row_parts, which holds the evidence). f(j) is column j's value; M > 0
// (a row in registers, M <= XLA_ROW_PART) is the one-part loop.
constexpr int XLA_ROW_PART = 32;

template <int M, class F>
__device__ __forceinline__ float xla_row_sum(int n, F&& f) {
  float s = 0.0f;
  if constexpr (M > 0) {
    static_assert(M <= XLA_ROW_PART, "a register row is one part");
    each<M>(n, [&](int j) { s = s + f(j); });
  } else if (n <= XLA_ROW_PART) {
    for (int j = 0; j < n; ++j) s = s + f(j);
  } else {
    const int k = (n + XLA_ROW_PART - 1) / XLA_ROW_PART;
    const int r = n - XLA_ROW_PART * (k - 2);
    int j = 0;
    for (int p = 0; p < k; ++p) {
      const int len = p == 0 ? (r + 1) / 2 : p == k - 1 ? r / 2 : XLA_ROW_PART;
      float part = 0.0f;
      for (const int end = j + len; j < end; ++j) part = part + f(j);
      s = s + part;
    }
  }
  return s;
}

// the pod's claims: LVM sizes and VG ids [L], device sizes and media [K]
struct Claims {
  const float* lsz;
  const int* lvg;
  const float* dsz;
  const int* dmd;
};

__device__ inline Claims claims_in_place(const StepCtx& x, int i) {
  return {x.lvm_size + static_cast<size_t>(i) * x.l, x.lvm_vg + static_cast<size_t>(i) * x.l,
          x.dev_size + static_cast<size_t>(i) * x.k, x.dev_media + static_cast<size_t>(i) * x.k};
}

// The plan rows read in place and built in the StepCtx scratch rows of
// node n (st_fr, st_alloc, st_take): any width
struct ScratchPlanRows {
  static constexpr int M = 0;
  const StepCtx& x;
  Claims cl;
  size_t nv, nsd;
  __device__ int name(int v) const { return x.vg_name_id[nv + v]; }
  __device__ float free0(int v) const { return x.vg_free[nv + v]; }
  __device__ float cap(int v) const { return x.vg_cap[nv + v]; }
  __device__ float& fr(int v) const { return x.st_fr[nv + v]; }
  __device__ float& alloc(int v) const { return x.st_alloc[nv + v]; }
  __device__ bool dev_free(int d) const { return x.sdev_free[nsd + d] != 0; }
  __device__ float dev_cap(int d) const { return x.sdev_cap[nsd + d]; }
  __device__ int media(int d) const { return x.sdev_media[nsd + d]; }
  __device__ uint8_t& take(int d) const { return x.st_take[nsd + d]; }
  __device__ void flush() const {}
};

// The plan of one node through a plan rows class `S`: returns the LVM and
// device verdict (has_storage not yet ANDed) and sets the raw score; the
// allocation and the take row are left in S's rows.
template <class S>
__device__ inline bool storage_plan(const StepCtx& x, S& s, float& raw) {
  constexpr int M = S::M;
  const int V = x.v, SD = x.sd;
  const Claims& cl = s.cl;

  // -- LVM plan (storage.py lvm_plan): the running free space and the
  // allocation --
  bool has_any_vg = false;
  each<M>(V, [&](int v) {
    s.fr(v) = s.free0(v);
    s.alloc(v) = 0.0f;
    has_any_vg = has_any_vg || s.name(v) >= 0;
  });
  bool lvm_ok = true;
  int n_lvm = 0;
  for (int c = 0; c < x.l; ++c) {
    const float size = cl.lsz[c];
    const int vid = cl.lvg[c];
    const bool active = size > 0.0f;
    n_lvm += active ? 1 : 0;
    const bool named = vid >= 0;
    // one pass: the binpack choice (first index of the smallest eligible
    // free) and the named VG's slot and room (which need no binpack
    // choice; an unnamed claim's verdict is any_eligible)
    int best = 0;
    float best_key = BIG;
    bool any_eligible = false, any_slot = false, room = false;
    each<M>(V, [&](int v) {
      const bool eligible = s.name(v) >= 0 && s.fr(v) >= size;
      any_eligible = any_eligible || eligible;
      const float key = eligible ? s.fr(v) : BIG;
      if (v == 0 || key < best_key) { best_key = key; best = v; }
      const bool slot = s.name(v) >= 0 && s.name(v) == vid;
      any_slot = any_slot || slot;
      room = room || (slot && s.fr(v) >= size);
    });
    auto slot_of = [&](int v) {
      return named ? (s.name(v) >= 0 && s.name(v) == vid) : (v == best && any_eligible);
    };
    const bool ok = (named ? (any_slot && room) : any_eligible) && vid != -2 && has_any_vg;
    each<M>(V, [&](int v) {
      const float upd = (active && ok && slot_of(v) && s.fr(v) >= size) ? size : 0.0f;
      s.alloc(v) = s.alloc(v) + upd;
      s.fr(v) = s.fr(v) - upd;
    });
    if (active) lvm_ok = lvm_ok && ok;
  }

  // -- exclusive-device plan (storage.py device_plan): a device is still
  // free while free and not taken --
  each<M>(SD, [&](int d) { s.take(d) = 0; });
  bool dev_ok = true;
  float tight = 0.0f;
  int n_dev = 0;
  for (int c = 0; c < x.k; ++c) {
    const float size = cl.dsz[c];
    const int media = cl.dmd[c];
    const bool active = size > 0.0f;
    n_dev += active ? 1 : 0;
    int best = 0;
    float best_key = BIG;
    bool found = false;
    each<M>(SD, [&](int d) {
      const float cap = s.dev_cap(d);
      const bool dfree = s.dev_free(d) && !s.take(d);
      const bool eligible = dfree && s.media(d) == media && cap >= size;
      found = found || eligible;
      const float key = eligible ? cap : BIG;
      if (d == 0 || key < best_key) { best_key = key; best = d; }
    });
    float cap_chosen = 0.0f;
    each<M>(SD, [&](int d) {
      const bool sel = d == best && found && active;
      if (sel) s.take(d) = 1;
      cap_chosen = cap_chosen + (sel ? s.dev_cap(d) : 0.0f);
    });
    tight = tight + ((found && active) ? __fdiv_rn(size, fmaxf(cap_chosen, TINY)) : 0.0f);
    if (active) dev_ok = dev_ok && found;
  }

  // -- raw Open-Local score (storage.py open_local_score): the per-VG
  // usage summed in XLA's order --
  int vg_count = 0;
  const float per_sum = xla_row_sum<M>(V, [&](int v) {
    const bool used = s.alloc(v) > 0.0f;
    vg_count += used ? 1 : 0;
    return used ? __fdiv_rn(s.alloc(v), fmaxf(s.cap(v), TINY)) : 0.0f;
  });
  const float lvm_score = (n_lvm > 0 && vg_count > 0)
      ? __fdiv_rn(per_sum, static_cast<float>(vg_count)) * 10.0f : 0.0f;
  raw = n_dev > 0
      ? __fmaf_rn(__fdiv_rn(tight, static_cast<float>(n_dev)), 10.0f, lvm_score)
      : lvm_score + 0.0f;
  return lvm_ok && dev_ok;
}

// The storage plan of pod i at node n in the StepCtx scratch rows, and its
// verdict and raw score (K10, K19, K20)
__device__ inline void storage_node(const StepCtx& x, int i, int n) {
  ScratchPlanRows s{x, claims_in_place(x, i), static_cast<size_t>(n) * x.v, static_cast<size_t>(n) * x.sd};
  float raw;
  const bool ok = storage_plan(x, s, raw);
  x.st_ok[n] = (x.has_storage[n] && ok) ? 1 : 0;
  x.st_raw[n] = raw;
}

// The pod's GPU request (gpushare.py gpu_plan's mem, count and preset):
// the preset row where one is set (its sum > 0), else null
struct GpuReq {
  float mem;
  int count;
  const int* preset;
};

__device__ inline GpuReq gpu_req_in_place(const StepCtx& x, int i) {
  const int* preset = x.gpu_preset + static_cast<size_t>(i) * x.gd;
  int preset_sum = 0;
  for (int d = 0; d < x.gd; ++d) preset_sum += preset[d];
  return {x.gpu_mem[i], x.gpu_count[i], preset_sum > 0 ? preset : nullptr};
}

// Node n's GPU rows read in place, its shares built in its gpu_sh row: any
// width
struct InPlaceGpuRows {
  static constexpr int M = 0;
  const StepCtx& x;
  size_t ng;
  int n;
  __device__ bool exists(int d) const { return x.gpu_dev_exists[ng + d] != 0; }
  __device__ float free(int d) const { return x.gpu_free[ng + d]; }
  __device__ float total() const { return x.gpu_total[n]; }
  __device__ float& sh(int d) const { return x.gpu_sh[ng + d]; }
};

// The GPU plan of one node through a GPU rows class `S` (gpushare.py
// gpu_plan): one pass over the devices builds the greedy stacking (its
// running sum and shares in f32, the shares left in S's sh row) and the
// tightest fit (strict <, the lowest index on ties); the count-1 choice,
// the preset override and the final mask then write each share once, into
// the same row. Returns the verdict. A missing device counts as free = -1.
template <class S>
__device__ inline bool gpu_plan(const GpuReq& q, S& s, int GD) {
  constexpr int M = S::M;
  const bool is_gpu_pod = q.mem > 0.0f;
  const bool valid_req = q.count > 0;
  const float count_f = static_cast<float>(q.count);
  bool has_dev = false, any_fit = false;
  int tight_idx = 0;
  float tight_key = BIG, cum = 0.0f, total = 0.0f;
  auto pass = [&](int d) {
    const bool ex = s.exists(d);
    const float f = ex ? s.free(d) : -1.0f;
    has_dev = has_dev || ex;
    const bool fit1 = f >= q.mem;
    any_fit = any_fit || fit1;
    const float key = fit1 ? f : BIG;
    if (d == 0 || key < tight_key) { tight_key = key; tight_idx = d; }
    const float per_dev = fit1 ? floorf(__fdiv_rn(f, fmaxf(q.mem, TINY))) : 0.0f;
    cum = cum + per_dev;
    const float prev = cum - per_dev;
    const float greedy = fminf(fmaxf(fminf(cum, count_f) - prev, 0.0f), per_dev);
    s.sh(d) = greedy;
    total = total + greedy;
  };
  // rows read in place or from shared memory: four devices' loads and
  // divisions in flight at once
  if constexpr (M > 0) {
    each<M>(GD, pass);
  } else {
#pragma unroll 4
    for (int d = 0; d < GD; ++d) pass(d);
  }
  // a one-GPU pod's shares are the tightest fit's one-hot row: their sum
  // is 1 where a device fits, else 0
  const bool one = q.count == 1;
  if (one) total = any_fit ? 1.0f : 0.0f;
  const bool node_total_ok = s.total() >= q.mem;
  bool fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req && total >= count_f) : true;
  if (q.preset) fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req) : true;
  const bool keep = is_gpu_pod && fits;
  each<M>(GD, [&](int d) {
    const float share = q.preset ? static_cast<float>(q.preset[d])
                                 : one ? ((d == tight_idx && any_fit) ? 1.0f : 0.0f) : s.sh(d);
    s.sh(d) = keep ? share : 0.0f;
  });
  return fits;
}

// The GPU plan of pod i at node n in place (K10, K19, K20; K6 past its
// register templates reads its rows the same way)
__device__ inline void gpu_node(const StepCtx& x, int i, int n) {
  InPlaceGpuRows s{x, static_cast<size_t>(n) * x.gd, n};
  x.gpu_ok[n] = gpu_plan(gpu_req_in_place(x, i), s, x.gd) ? 1 : 0;
}
