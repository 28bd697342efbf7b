// The argument block shared by the four per-pod kernels (K1-K4) of the
// serial scheduling step. Mirrored field for field by the ctypes
// structure `StepCtx` in simtpu_torch/kernels/cuda.py; passed to every
// kernel by value.
//
// Numerics: built with -fmad=false and IEEE division, so every a*b+c is
// two roundings unless written as __fmaf_rn, which is used exactly where
// the JAX package's compiled reference contracts (the resource-fit slack
// and SelectorSpread's zone blend).
#pragma once
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

// bit i = field i of engine/scan.py StepFlags
enum : int {
  F_PORTS = 1 << 0,
  F_VOLS = 1 << 1,
  F_ATTACH = 1 << 2,
  F_SPREAD_HARD = 1 << 3,
  F_SPREAD_SOFT = 1 << 4,
  F_SELECTOR_SPREAD = 1 << 5,
  F_INTERPOD_REQ = 1 << 6,
  F_INTERPOD_PREF = 1 << 7,
  F_STORAGE = 1 << 8,
  F_GPU = 1 << 9,
  F_NODE_PREF = 1 << 10,
  F_TAINT_PREF = 1 << 11,
  F_STATIC_SCORE = 1 << 12,
};
constexpr int F_TOPOLOGY =
    F_SPREAD_HARD | F_SPREAD_SOFT | F_SELECTOR_SPREAD | F_INTERPOD_REQ | F_INTERPOD_PREF;

// failure-reason codes (engine/scan.py)
enum : int {
  OK = 0, FAIL_STATIC = 1, FAIL_RESOURCES = 2, FAIL_INTERPOD = 3, FAIL_NO_NODE = 4,
  FAIL_STORAGE = 5, FAIL_GPU = 6, FAIL_PORTS = 7, FAIL_SPREAD = 8, FAIL_VOLUME = 9,
  FAIL_ATTACH = 10, FAIL_VOLUME_BIND = 11,
};

// stage byte bits (cumulative): 0 static, 1 ports, 2 res, 3 vol, 4 att,
// 5 bind (= storage = gpu in this slice), 6 spread, 7 all
constexpr int RES_CPU = 0;
constexpr int RES_MEMORY = 1;
constexpr float BIG = 3.4e38f;
constexpr float TINY = 1e-30f;
constexpr float MAX_NODE_SCORE = 100.0f;

struct StepCtx {
  int n, r, p_ports, w, c, tc, flags, pad_;
  // the batch's pod arrays [P]
  const int* group;
  const float* req;  // [P, R]
  const int* pin;
  const uint8_t* forced;
  // statics
  const float* alloc;         // [N, R]
  const uint8_t* static_mask; // [G, N]
  const uint8_t* vol_mask;    // [G, N]
  const float* node_pref;     // [G, N]
  const float* taint_intol;   // [G, N]
  const float* static_score;  // [G, N]
  const float* avoid_pen;     // [G, N]
  const int* node_dom;        // [K, N]
  const int* term_topo;       // [T]
  const int* ip_of;           // [T]
  const int* g_terms;         // [G, Tc]
  const uint8_t* s_match;     // [G, Tc]
  const uint8_t* a_aff_req;   // [G, Tc]
  const uint8_t* a_anti_req;  // [G, Tc]
  const float* w_aff_pref;    // [G, Tc]
  const float* w_anti_pref;   // [G, Tc]
  const float* spread_hard;   // [G, Tc]
  const float* spread_soft;   // [G, Tc]
  const uint8_t* ss_host;     // [G, Tc]
  const uint8_t* ss_zone;     // [G, Tc]
  const uint8_t* ports_req;   // [G, P]
  const uint8_t* vol_rw_req;  // [G, W]
  const uint8_t* vol_ro_req;  // [G, W]
  const uint8_t* vol_att_req; // [G, W]
  const uint8_t* vol_class_mask; // [C, W]
  const float* attach_limits; // [N, C]
  const float* score_w;       // [12]
  const uint8_t* node_valid;  // [N]
  // state, updated in place by K4
  float* free;            // [N, R]
  float* cnt_match;       // [T, N]
  float* cnt_total;       // [T]
  float* cnt_own_anti;    // [Ti, N]
  float* cnt_own_aff;     // [Ti, N]
  float* w_own_aff_pref;  // [Ti, N]
  float* w_own_anti_pref; // [Ti, N]
  float* ports_used;      // [N, P]
  float* vols_any;        // [N, W]
  float* vols_rw;         // [N, W]
  // per-node scratch and per-pod outputs
  uint8_t* stage;  // [N]
  float* raw;      // [4, N]: inter-pod raw, soft-spread raw, SS host, SS zone
  float* score;    // [N]
  int* chosen;     // [P]
  uint8_t* placed; // [P]
  int* reason;     // [P]
  int* out_node;   // [P]
};

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
