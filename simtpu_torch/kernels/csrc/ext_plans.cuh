// Per-node device code of the Open-Local storage plan (K5) and the
// GPU-share plan (K6), shared by storage_pod.cu, gpu_pod.cu and the hard
// wave kernel wave_hard.cu (K10): one source for every path.
//
// storage_node: the JAX package's simtpu/kernels/storage.py lvm_plan
// (:25), device_plan (:66) and open_local_score (:100); gpu_node:
// simtpu/kernels/gpushare.py gpu_plan (:25). The thread of node n walks
// the pod's claims in order with the node's rows in registers, then
// writes the node's verdict and plan into the StepCtx scratch (st_ok,
// st_alloc, st_take, st_raw; gpu_ok, gpu_sh). See the two kernels' notes.
#pragma once
#include "step_ctx.cuh"

__device__ inline void storage_node(const StepCtx& x, int i, int n) {
  const int V = x.v, SD = x.sd;
  const float* lsz = x.lvm_size + static_cast<size_t>(i) * x.l;
  const int* lvg = x.lvm_vg + static_cast<size_t>(i) * x.l;
  const float* dsz = x.dev_size + static_cast<size_t>(i) * x.k;
  const int* dmd = x.dev_media + static_cast<size_t>(i) * x.k;
  const size_t nv = static_cast<size_t>(n) * V;
  const size_t nsd = static_cast<size_t>(n) * SD;

  // -- LVM plan (storage.py lvm_plan) --
  float fr[MAX_EXT], alloc[MAX_EXT];
  bool has_any_vg = false;
  for (int v = 0; v < V; ++v) {
    fr[v] = x.vg_free[nv + v];
    alloc[v] = 0.0f;
    has_any_vg = has_any_vg || x.vg_name_id[nv + v] >= 0;
  }
  bool lvm_ok = true;
  int n_lvm = 0;
  for (int c = 0; c < x.l; ++c) {
    const float size = lsz[c];
    const int vid = lvg[c];
    const bool active = size > 0.0f;
    n_lvm += active ? 1 : 0;
    const bool named = vid >= 0;
    // the binpack choice: first index of the smallest eligible free
    int best = 0;
    float best_key = BIG;
    bool any_eligible = false;
    for (int v = 0; v < V; ++v) {
      const bool eligible = x.vg_name_id[nv + v] >= 0 && fr[v] >= size;
      any_eligible = any_eligible || eligible;
      const float key = eligible ? fr[v] : BIG;
      if (v == 0 || key < best_key) { best_key = key; best = v; }
    }
    bool any_slot = false, room = false;
    for (int v = 0; v < V; ++v) {
      const bool slot = named ? (x.vg_name_id[nv + v] >= 0 && x.vg_name_id[nv + v] == vid)
                              : (v == best && any_eligible);
      any_slot = any_slot || slot;
      room = room || (slot && fr[v] >= size);
    }
    const bool ok = (named ? (any_slot && room) : any_eligible) && vid != -2 && has_any_vg;
    for (int v = 0; v < V; ++v) {
      const bool slot = named ? (x.vg_name_id[nv + v] >= 0 && x.vg_name_id[nv + v] == vid)
                              : (v == best && any_eligible);
      const float upd = (active && ok && slot && fr[v] >= size) ? size : 0.0f;
      alloc[v] = alloc[v] + upd;
      fr[v] = fr[v] - upd;
    }
    if (active) lvm_ok = lvm_ok && ok;
  }

  // -- exclusive-device plan (storage.py device_plan) --
  bool dfree[MAX_EXT], take[MAX_EXT];
  for (int d = 0; d < SD; ++d) { dfree[d] = x.sdev_free[nsd + d] != 0; take[d] = false; }
  bool dev_ok = true;
  float tight = 0.0f;
  int n_dev = 0;
  for (int c = 0; c < x.k; ++c) {
    const float size = dsz[c];
    const int media = dmd[c];
    const bool active = size > 0.0f;
    n_dev += active ? 1 : 0;
    int best = 0;
    float best_key = BIG;
    bool found = false;
    for (int d = 0; d < SD; ++d) {
      const float cap = x.sdev_cap[nsd + d];
      const bool eligible = dfree[d] && x.sdev_media[nsd + d] == media && cap >= size;
      found = found || eligible;
      const float key = eligible ? cap : BIG;
      if (d == 0 || key < best_key) { best_key = key; best = d; }
    }
    float cap_chosen = 0.0f;
    for (int d = 0; d < SD; ++d) {
      const bool sel = d == best && found && active;
      take[d] = take[d] || sel;
      dfree[d] = dfree[d] && !sel;
      cap_chosen = cap_chosen + (sel ? x.sdev_cap[nsd + d] : 0.0f);
    }
    tight = tight + ((found && active) ? __fdiv_rn(size, fmaxf(cap_chosen, TINY)) : 0.0f);
    if (active) dev_ok = dev_ok && found;
  }

  // -- raw Open-Local score (storage.py open_local_score) --
  float per_sum = 0.0f;
  int vg_count = 0;
  for (int v = 0; v < V; ++v) {
    const bool used = alloc[v] > 0.0f;
    per_sum = per_sum + (used ? __fdiv_rn(alloc[v], fmaxf(x.vg_cap[nv + v], TINY)) : 0.0f);
    vg_count += used ? 1 : 0;
  }
  const float lvm_score = (n_lvm > 0 && vg_count > 0)
      ? __fdiv_rn(per_sum, static_cast<float>(vg_count)) * 10.0f : 0.0f;
  const float raw = n_dev > 0
      ? __fmaf_rn(__fdiv_rn(tight, static_cast<float>(n_dev)), 10.0f, lvm_score)
      : lvm_score + 0.0f;

  x.st_ok[n] = (x.has_storage[n] && lvm_ok && dev_ok) ? 1 : 0;
  for (int v = 0; v < V; ++v) x.st_alloc[nv + v] = alloc[v];
  for (int d = 0; d < SD; ++d) x.st_take[nsd + d] = take[d] ? 1 : 0;
  x.st_raw[n] = raw;
}

__device__ inline void gpu_node(const StepCtx& x, int i, int n) {
  const int GD = x.gd;
  const size_t ng = static_cast<size_t>(n) * GD;
  const float mem = x.gpu_mem[i];
  const int count = x.gpu_count[i];
  const int* preset = x.gpu_preset + static_cast<size_t>(i) * GD;
  const bool is_gpu_pod = mem > 0.0f;
  const bool valid_req = count > 0;
  const float count_f = static_cast<float>(count);

  float fr[MAX_EXT];
  bool has_dev = false, any_fit = false;
  int tight_idx = 0;
  float tight_key = BIG;
  for (int d = 0; d < GD; ++d) {
    const bool exists = x.gpu_dev_exists[ng + d] != 0;
    has_dev = has_dev || exists;
    fr[d] = exists ? x.gpu_free[ng + d] : -1.0f;
    const bool fit1 = fr[d] >= mem;
    any_fit = any_fit || fit1;
    const float key = fit1 ? fr[d] : BIG;
    if (d == 0 || key < tight_key) { tight_key = key; tight_idx = d; }
  }
  float shares[MAX_EXT];
  float cum = 0.0f, total = 0.0f;
  for (int d = 0; d < GD; ++d) {
    const float per_dev = fr[d] >= mem ? floorf(__fdiv_rn(fr[d], fmaxf(mem, TINY))) : 0.0f;
    cum = cum + per_dev;
    const float prev = cum - per_dev;
    const float greedy = fminf(fmaxf(fminf(cum, count_f) - prev, 0.0f), per_dev);
    const float tight = (d == tight_idx && any_fit) ? 1.0f : 0.0f;
    shares[d] = count == 1 ? tight : greedy;
    total = total + shares[d];
  }
  const bool node_total_ok = x.gpu_total[n] >= mem;
  bool fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req && total >= count_f) : true;
  int preset_sum = 0;
  for (int d = 0; d < GD; ++d) preset_sum += preset[d];
  if (preset_sum > 0) {
    fits = is_gpu_pod ? (node_total_ok && has_dev && valid_req) : true;
    for (int d = 0; d < GD; ++d)
      x.gpu_sh[ng + d] = (is_gpu_pod && fits) ? static_cast<float>(preset[d]) : 0.0f;
  } else {
    for (int d = 0; d < GD; ++d) x.gpu_sh[ng + d] = (is_gpu_pod && fits) ? shares[d] : 0.0f;
  }
  x.gpu_ok[n] = fits ? 1 : 0;
}
