// The argument blocks of the hand-written kernels: `StepCtx`, shared by
// the six per-pod kernels (K1-K6) of the serial scheduling step and the
// two wave kernels (K9, K10), `WaveCtx`, the wave kernels' run and
// scratch, `DeltaCtx`, the signed log-delta kernel's (K7), and
// `CompactCtx`, the compact carried state's kernels' (K11-K13). Mirrored
// field for field by the ctypes structures of the same names in
// simtpu_torch/kernels/cuda.py; passed to every kernel by value.
//
// Numerics: built with -fmad=false and IEEE division, so every a*b+c is
// two roundings unless written as __fmaf_rn, which is used exactly where
// the JAX package's compiled reference contracts (simtpu_torch/kernels/
// fp.py lists the sites).
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
// 5 bind, 6 bind & spread, 7 bind & spread & inter-pod; K3 ANDs the
// storage and GPU verdicts (K5, K6) into bits 5-7
constexpr int RES_CPU = 0;
constexpr int RES_MEMORY = 1;
constexpr float BIG = 3.4e38f;
constexpr float TINY = 1e-30f;
constexpr float MAX_NODE_SCORE = 100.0f;
// widest VG / exclusive-device / GPU-device axis a thread keeps in
// registers (checked by the wrapper)
constexpr int MAX_EXT = 32;
// ext_live bits: the pod ran K5 (storage) / K6 (GPU) this step
constexpr int LIVE_STORAGE = 1;
constexpr int LIVE_GPU = 2;

struct StepCtx {
  int n, r, p_ports, w, c, tc, flags, v, sd, gd, l, k;
  // the batch's pod arrays [P]
  const int* group;
  const float* req;  // [P, R]
  const int* pin;
  const uint8_t* forced;
  const float* lvm_size;   // [P, L] LVM claim sizes (0 = padding)
  const int* lvm_vg;       // [P, L] named VG (-1 unnamed, -2 missing)
  const float* dev_size;   // [P, K] exclusive-device claim sizes
  const int* dev_media;    // [P, K]
  const float* gpu_mem;    // [P] per-GPU memory request
  const int* gpu_count;    // [P] GPU shares requested
  const int* gpu_preset;   // [P, GD] shares of an existing gpu-index annotation
  const uint8_t* ext_live; // [P] LIVE_STORAGE | LIVE_GPU
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
  const uint8_t* has_storage; // [N]
  const float* vg_cap;        // [N, V]
  const int* vg_name_id;      // [N, V] (-1 pad)
  const float* sdev_cap;      // [N, SD]
  const int* sdev_media;      // [N, SD]
  const uint8_t* gpu_dev_exists; // [N, GD]
  const float* gpu_total;     // [N]
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
  float* vg_free;         // [N, V]
  uint8_t* sdev_free;     // [N, SD]
  float* gpu_free;        // [N, GD]
  // per-node scratch and per-pod outputs
  uint8_t* stage;  // [N]
  float* raw;      // [4, N]: inter-pod raw, soft-spread raw, SS host, SS zone
  float* score;    // [N]
  uint8_t* st_ok;  // [N] K5: storage verdict
  float* st_alloc; // [N, V] K5: LVM allocation
  uint8_t* st_take; // [N, SD] K5: exclusive devices taken
  float* st_raw;   // [N] K5: raw Open-Local score
  uint8_t* gpu_ok; // [N] K6: GPU verdict
  float* gpu_sh;   // [N, GD] K6: GPU shares per device
  int* chosen;     // [P]
  uint8_t* placed; // [P]
  int* reason;     // [P]
  int* out_node;   // [P]
  float* out_lvm;  // [P, V] the pod's LVM allocation at its node
  uint8_t* out_take; // [P, SD]
  float* out_gpu;  // [P, GD]
};

// K9's carried [N] rows in WaveCtx.carry: the resource score pair, the
// normalized static terms and K2's four count raws (bumped in place)
enum : int {
  ROW_FSCORE = 0, ROW_SIMON = 1, ROW_NODE_PREF = 2, ROW_TAINT = 3, ROW_IPA = 4,
  ROW_RAW = 5,  // + RAW_IPA, RAW_SOFT, RAW_SS_HOST, RAW_SS_ZONE (K2's raw order)
  WAVE_ROWS = 9,
};
enum : int { RAW_IPA = 0, RAW_SOFT = 1, RAW_SS_HOST = 2, RAW_SS_ZONE = 3, N_RAWS = 4 };
// WaveCtx.mode: K9's inter-pod preference carry; the run's heavy stage
// bits (engine/wavefront.py WAVE_HEAVY_*) shifted
constexpr int WAVE_PREF = 1;
constexpr int WAVE_HEAVY_SHIFT = 4;
enum : int { HEAVY_PORTS = 1, HEAVY_VOLS = 2, HEAVY_STORAGE = 4, HEAVY_GPU = 8 };
// threads of a wave block (fixed at the launch)
constexpr int WAVE_THREADS = 512;

struct WaveCtx {
  int a, b, mode, k;  // the run [a, b) of the batch, mode bits, topology keys
  uint8_t* bits;      // [N] the run-constant stage bits (+ K9's fit / all bits)
  float* carry;       // [WAVE_ROWS, N] K9's carried rows
};

struct DeltaCtx {
  int n, r, p_ports, w, v, sd, gd, tc, e, pad_;
  // packed log entries [E] (engine/state.py pack_delta_entries)
  const int* g;
  const int* node;
  const float* wgt;        // +1 re-place, -1 evict, 0 padding
  const float* req;        // [E, R]
  const float* vg;         // [E, V]
  const uint8_t* sd_take;  // [E, SD]
  const float* gp;         // [E, GD] GPU shares x per-GPU memory
  // statics
  const uint8_t* ports_req;   // [G, P]
  const uint8_t* vol_rw_req;  // [G, W]
  const uint8_t* vol_ro_req;  // [G, W]
  const uint8_t* vol_att_req; // [G, W]
  const int* node_dom;        // [K, N]
  const int* term_topo;       // [T]
  const int* ip_of;           // [T]
  const int* g_terms;         // [G, Tc]
  const uint8_t* s_match;     // [G, Tc]
  const uint8_t* a_aff_req;   // [G, Tc]
  const uint8_t* a_anti_req;  // [G, Tc]
  const float* w_aff_pref;    // [G, Tc]
  const float* w_anti_pref;   // [G, Tc]
  // state, updated in place
  float* free;            // [N, R]
  float* cnt_match;       // [T, N]
  float* cnt_total;       // [T]
  float* cnt_own_anti;    // [Ti, N]
  float* cnt_own_aff;     // [Ti, N]
  float* w_own_aff_pref;  // [Ti, N]
  float* w_own_anti_pref; // [Ti, N]
  float* vg_free;         // [N, V]
  uint8_t* sdev_free;     // [N, SD]
  float* gpu_free;        // [N, GD]
  float* ports_used;      // [N, P]
  float* vols_any;        // [N, W]
  float* vols_rw;         // [N, W]
};

// The scenario-batched sweep's kernels (K18 sweep_drain, K19 sweep_place):
// one block per scenario. Each passes the single-scenario block of its
// kernel family (DeltaCtx for K18, StepCtx for K19) with every state
// plane, per-block scratch and output pointing at replica / block / row 0;
// block s reads and writes replica s, s planes further on (sweep_replica,
// sweep_block_ctx below).
struct SweepCtx {
  int s;     // scenarios (the grid)
  int cols;  // columns of idx: K18 entries, K19 pod rows per scenario
  int t, ti; // term rows T of cnt_match / cnt_total, interpod rows Ti
  // [S, cols] K18: placement-log entries; K19: rows of the batch's pod
  // arrays; -1 = padding, which only trails
  const int* idx;
  // K18: the base carry every replica starts from (read only)
  const float* free;            // [N, R]
  const float* cnt_match;       // [T, N]
  const float* cnt_total;       // [T]
  const float* cnt_own_anti;    // [Ti, N]
  const float* cnt_own_aff;     // [Ti, N]
  const float* w_own_aff_pref;  // [Ti, N]
  const float* w_own_anti_pref; // [Ti, N]
  const float* vg_free;         // [N, V]
  const uint8_t* sdev_free;     // [N, SD]
  const float* gpu_free;        // [N, GD]
  const float* ports_used;      // [N, P]
  const float* vols_any;        // [N, W]
  const float* vols_rw;         // [N, W]
};

// The compact carried state's kernels (K11 compact_compress, K12
// compact_expand, K13 compact_delta): one block for the three, each
// reading the fields it needs (the others are null). The compact layout is
// engine/state.py CompactState: [Rt, D] histograms for the count rows of
// topology keys with at most DOM_SMALL domains, [Rd, N] rows for the rest,
// count planes in int32.
struct CompactCtx {
  int n, t, ti, rt, rd, rti, rdi, d, k, r, p, w, v, sd, gd, tc, e, pad_;
  // the row partition (engine/state.py CompactSpecDev) and node_dom_small
  const int* t_tab;     // [Rt] cnt_match rows with a tabular key
  const int* t_dense;   // [Rd] the other cnt_match rows
  const int* t_keys;    // [Rt] topology key per tabular row
  const int* t_rep;     // [Rt, D] representative node per domain, -1 none
  const int* ip_tab;    // [Rti] own-plane rows with a tabular key
  const int* ip_dense;  // [Rdi]
  const int* ip_keys;   // [Rti]
  const int* ip_rep;    // [Rti, D]
  const int* nds;       // [K, N] node_dom_small, -1 where the node misses the key
  // K13: the inverse row maps (CompactDeltaSpec) and node_dom
  const int* t_tab_of;     // [T] row in cm_tab, -1 if dense
  const int* t_dense_of;   // [T] row in cm_dense, -1 if tabular
  const int* ip_tab_of;    // [Ti]
  const int* ip_dense_of;  // [Ti]
  const int* node_dom;     // [K, N]
  // K13: packed log entries [E] and the group statics, as DeltaCtx
  const int* g;
  const int* node;
  const float* wgt;
  const float* req;           // [E, R]
  const float* vg;            // [E, V]
  const uint8_t* sd_take;     // [E, SD]
  const float* gp;            // [E, GD]
  const uint8_t* ports_req;   // [G, P]
  const uint8_t* vol_rw_req;  // [G, W]
  const uint8_t* vol_ro_req;  // [G, W]
  const uint8_t* vol_att_req; // [G, W]
  const int* term_topo;       // [T]
  const int* ip_of;           // [T]
  const int* g_terms;         // [G, Tc]
  const uint8_t* s_match;     // [G, Tc]
  const uint8_t* a_aff_req;   // [G, Tc]
  const uint8_t* a_anti_req;  // [G, Tc]
  const float* w_aff_pref;    // [G, Tc]
  const float* w_anti_pref;   // [G, Tc]
  // the dense planes (SchedState): K11 reads them, K12 writes them
  float* free;            // [N, R]
  float* cnt_match;       // [T, N]
  float* cnt_total;       // [T]
  float* cnt_own_anti;    // [Ti, N]
  float* cnt_own_aff;     // [Ti, N]
  float* w_own_aff_pref;  // [Ti, N]
  float* w_own_anti_pref; // [Ti, N]
  float* vg_free;         // [N, V]
  uint8_t* sdev_free;     // [N, SD]
  float* gpu_free;        // [N, GD]
  float* ports_used;      // [N, P]
  float* vols_any;        // [N, W]
  float* vols_rw;         // [N, W]
  // the compact planes (CompactState): K11 writes them, K12 reads them,
  // K13 updates them in place
  float* c_free;          // [N, R]
  int* cm_tab;            // [Rt, D]
  int* cm_dense;          // [Rd, N]
  int* c_cnt_total;       // [T]
  int* oa_tab;            // [Rti, D] cnt_own_anti
  int* oa_dense;          // [Rdi, N]
  int* of_tab;            // cnt_own_aff
  int* of_dense;
  int* wa_tab;            // w_own_aff_pref
  int* wa_dense;
  int* wn_tab;            // w_own_anti_pref
  int* wn_dense;
  float* c_vg_free;       // [N, V]
  uint8_t* c_sdev_free;   // [N, SD]
  float* c_gpu_free;      // [N, GD]
  int* c_ports_used;      // [N, P]
  int* c_vols_any;        // [N, W]
  int* c_vols_rw;         // [N, W]
};

// The five count planes of both layouts, in CompactState order (cnt_match,
// cnt_own_anti, cnt_own_aff, w_own_aff_pref, w_own_anti_pref), with the
// row partition each one follows.
struct CountPlane {
  float* full;
  int* tab;
  int* dense;
  int rt, rd;
  const int* ids_tab;
  const int* ids_dense;
  const int* keys;
  const int* rep;
};

__device__ inline CountPlane count_plane(const CompactCtx& x, int q) {
  float* full[5] = {x.cnt_match, x.cnt_own_anti, x.cnt_own_aff, x.w_own_aff_pref, x.w_own_anti_pref};
  int* tab[5] = {x.cm_tab, x.oa_tab, x.of_tab, x.wa_tab, x.wn_tab};
  int* dense[5] = {x.cm_dense, x.oa_dense, x.of_dense, x.wa_dense, x.wn_dense};
  if (q == 0) return {full[0], tab[0], dense[0], x.rt, x.rd, x.t_tab, x.t_dense, x.t_keys, x.t_rep};
  return {full[q], tab[q], dense[q], x.rti, x.rdi, x.ip_tab, x.ip_dense, x.ip_keys, x.ip_rep};
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
