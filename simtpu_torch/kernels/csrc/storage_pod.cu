// K5 storage_pod: the Open-Local storage plans of one pod over every node.
//
// Replaces the JAX package's simtpu/kernels/storage.py lvm_plan (:25),
// device_plan (:66) and open_local_score (:100), fused as the JAX
// package's fused cascade runs them in one branch
// (simtpu/engine/scan.py:811-835). One thread owns one node and walks the
// pod's claims in order:
//   LVM: a named claim takes its VG if it has room; an unnamed claim
//        binpacks into the smallest-free VG that fits (first index on
//        ties, as jnp.argmin); each claim debits the thread's copy of the
//        node's VG free row before the next claim looks;
//   devices: each claim takes the smallest adequate free device of its
//        media (first index on ties) and adds size/capacity to the
//        tightness;
//   raw score: mean per-VG usage/capacity x 10 plus tightness / n_dev x 10,
//        the device term contracted into the sum (one FMA) as the compiled
//        reference has it.
// Writes st_ok [N] (has_storage & LVM fits & devices fit), st_alloc [N,V],
// st_take [N,SD] and st_raw [N]. The host launches it only for pods that
// demand storage; K3/K4 use the skip constants for the others.
//
// Bound: bytes — vg_free/vg_cap/vg_name_id [N,V] and sdev_free/cap/media
// [N,SD] are read once and the plans written once; at N <= 1024 the
// launch latency dominates.
#include "step_ctx.cuh"

__global__ void storage_pod_kernel(StepCtx x, int i) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= x.n) return;
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

extern "C" int simtpu_storage_pod(const StepCtx* ctx, int i, void* stream) {
  const int threads = 128;
  const int blocks = (ctx->n + threads - 1) / threads;
  storage_pod_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, i);
  return launch_status();
}
