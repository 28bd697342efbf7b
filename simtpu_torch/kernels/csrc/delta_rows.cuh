// The per-node part of a signed placement-log delta, shared by K7
// `delta_apply` (the dense carry, count planes in f32) and K13
// `compact_delta` (the compact carry, count planes in int32): one entry's
// update of the chosen node's rows of free, ports_used, vols_any, vols_rw,
// vg_free, sdev_free and gpu_free.
//
// The caller runs it on the one thread that owns node c and walks the
// entries in log order: f32 adds onto the same row do not commute bit for
// bit, and sdev_free's set/clear by sign depends on the order too.
// `C` is the count planes' type; a count delta (a 0/1 incidence times
// w = +-1) is exact in either.
#pragma once
#include <cstdint>

template <typename C>
struct DeltaRows {
  int r, p, w, v, sd, gd;
  // packed entries (engine/state.py pack_delta_entries)
  const float* req;        // [E, R]
  const float* vg;         // [E, V]
  const uint8_t* sd_take;  // [E, SD]
  const float* gp;         // [E, GD] GPU shares x per-GPU memory
  // the group planes the entry reads
  const uint8_t* ports_req;    // [G, P]
  const uint8_t* vol_rw_req;   // [G, W]
  const uint8_t* vol_ro_req;   // [G, W]
  const uint8_t* vol_att_req;  // [G, W]
  // the carried planes, updated in place
  float* free;        // [N, R]
  C* ports_used;      // [N, P]
  C* vols_any;        // [N, W]
  C* vols_rw;         // [N, W]
  float* vg_free;     // [N, V]
  uint8_t* sdev_free; // [N, SD]
  float* gpu_free;    // [N, GD]
};

template <typename C>
__device__ inline void delta_node_rows(const DeltaRows<C>& x, int e, int g, int c, float w) {
  const size_t er = static_cast<size_t>(e);
  const size_t cr = static_cast<size_t>(c);
  for (int r = 0; r < x.r; ++r) {
    float& f = x.free[cr * x.r + r];
    f = f + (-x.req[er * x.r + r]) * w;
  }
  for (int p = 0; p < x.p; ++p) {
    C& u = x.ports_used[cr * x.p + p];
    u = u + static_cast<C>((x.ports_req[static_cast<size_t>(g) * x.p + p] ? 1.0f : 0.0f) * w);
  }
  for (int v = 0; v < x.w; ++v) {
    const size_t gw = static_cast<size_t>(g) * x.w + v;
    const bool rw = x.vol_rw_req[gw];
    const bool present = rw || x.vol_ro_req[gw] || x.vol_att_req[gw];
    C& any = x.vols_any[cr * x.w + v];
    C& rws = x.vols_rw[cr * x.w + v];
    any = any + static_cast<C>((present ? 1.0f : 0.0f) * w);
    rws = rws + static_cast<C>((rw ? 1.0f : 0.0f) * w);
  }
  for (int v = 0; v < x.v; ++v) {
    float& f = x.vg_free[cr * x.v + v];
    f = f + (-x.vg[er * x.v + v]) * w;
  }
  // boolean devices: w > 0 consumes (clears), otherwise releases (sets)
  for (int d = 0; d < x.sd; ++d) {
    uint8_t& f = x.sdev_free[cr * x.sd + d];
    const bool take = x.sd_take[er * x.sd + d] != 0;
    f = (w > 0.0f ? (f && !take) : (f || take)) ? 1 : 0;
  }
  for (int d = 0; d < x.gd; ++d) {
    float& f = x.gpu_free[cr * x.gd + d];
    f = f + (-x.gp[er * x.gd + d]) * w;
  }
}
