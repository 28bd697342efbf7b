// The per-node part of a signed placement-log delta, shared by K7
// `delta_apply` (the dense carry, count planes in f32), K13
// `compact_delta` (the compact carry, count planes in int32) and K18
// `sweep_drain`: one entry's update of the chosen node's rows of free,
// ports_used, vols_any, vols_rw, vg_free, sdev_free and gpu_free, one
// element at a time.
//
// The caller adds a node's entries to an element in log order: f32 adds
// onto the same row do not commute bit for bit, and sdev_free's set/clear
// by sign depends on the order too. `C` is the count planes' type; a
// count delta (a 0/1 incidence times w = +-1) is exact in either.
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

// Element i of node c's rows (K7 and K18 on the dense carry, every plane
// f32 but the u8 sdev_free; K13 on the compact carry, its count planes
// int32), in the order free [R], ports_used [P], vols_any [W], vols_rw
// [W], vg_free [V], sdev_free [SD], gpu_free [GD], so that threads can
// share one node's rows and a thread can add a node's entries to element
// i in a register, in log order, between one read and one write. An entry's operand for element i is the
// product the reference adds (or, in sdev_free, 1 to clear the device,
// 2 to set it, 0 to leave it).
template <typename C>
__device__ inline int delta_node_width(const DeltaRows<C>& x) {
  return x.r + x.p + 2 * x.w + x.v + x.sd + x.gd;
}

// element i of node c's rows: a float (f) or, in sdev_free, a byte (b)
template <typename F, typename B>
__device__ inline void delta_node_at(F* free, F* ports, F* any, F* rws, F* vg, B* sdev, F* gpu,
                                     const DeltaRows<float>& x, int c, int i, F*& f, B*& b) {
  const size_t cr = static_cast<size_t>(c);
  f = nullptr;
  b = nullptr;
  if (i < x.r) { f = free + cr * x.r + i; return; }
  i -= x.r;
  if (i < x.p) { f = ports + cr * x.p + i; return; }
  i -= x.p;
  if (i < x.w) { f = any + cr * x.w + i; return; }
  i -= x.w;
  if (i < x.w) { f = rws + cr * x.w + i; return; }
  i -= x.w;
  if (i < x.v) { f = vg + cr * x.v + i; return; }
  i -= x.v;
  if (i < x.sd) { b = sdev + cr * x.sd + i; return; }
  i -= x.sd;
  f = gpu + cr * x.gd + i;
}

// entry e's (group g, weight w) operand for element i (a count plane of
// type C adds it cast to C)
template <typename C>
__device__ inline float delta_node_operand(const DeltaRows<C>& x, int e, int g, float w, int i) {
  const size_t er = static_cast<size_t>(e);
  if (i < x.r) return (-x.req[er * x.r + i]) * w;
  i -= x.r;
  if (i < x.p) return (x.ports_req[static_cast<size_t>(g) * x.p + i] ? 1.0f : 0.0f) * w;
  i -= x.p;
  if (i < 2 * x.w) {
    const size_t gw = static_cast<size_t>(g) * x.w + (i < x.w ? i : i - x.w);
    const bool rw = x.vol_rw_req[gw];
    const bool on = i < x.w ? (rw || x.vol_ro_req[gw] || x.vol_att_req[gw]) : rw;
    return (on ? 1.0f : 0.0f) * w;
  }
  i -= 2 * x.w;
  if (i < x.v) return (-x.vg[er * x.v + i]) * w;
  i -= x.v;
  if (i < x.sd) return x.sd_take[er * x.sd + i] != 0 ? (w > 0.0f ? 1.0f : 2.0f) : 0.0f;
  i -= x.sd;
  return (-x.gp[er * x.gd + i]) * w;
}
