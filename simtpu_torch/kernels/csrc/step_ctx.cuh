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
// ext_live bits: the pod ran K5 (storage) / K6 (GPU) this step
constexpr int LIVE_STORAGE = 1;
constexpr int LIVE_GPU = 2;

// The group's term columns as one table, built once per argument block
// from the statics (kernels/cuda.py column_table): word k of column t of
// group g at g_cols[(g * TOPO_COL_WORDS + k) * Tc + t] — the term (-1 =
// pad), its topology key's node_dom row, its interpod row (-1 none), the
// column's flag bits, and the bits of its four float weights. K2 and K4
// stage a group's rows of it with one round of loads.
constexpr int TOPO_COL_WORDS = 8;
enum : int {
  COL_TERM = 0, COL_KEY = 1, COL_IP = 2, COL_FLAGS = 3, COL_W_AFF = 4, COL_W_ANTI = 5, COL_HARD = 6, COL_SOFT = 7,
};
enum : int { TOPO_SMATCH = 1, TOPO_AFF = 2, TOPO_ANTI = 4, TOPO_SSHOST = 8, TOPO_SSZONE = 16 };

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
  const int* g_cols;          // [G, TOPO_COL_WORDS, Tc] the term columns' table (above)
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
  float* st_fr;    // [N, V] K5: the VGs' free space as the plan walks the claims
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

// K9's carried [N] rows per node (in registers; in WaveCtx.carry where
// the nodes per thread pass what registers hold, wave.cuh): the resource
// score pair, the normalized static terms, K2's four count raws (bumped
// in place), the static score pair, the run-constant Simon share, node
// affinity and taint raws, and the node's stage bits (as float bits)
enum : int {
  ROW_FSCORE = 0, ROW_SIMON = 1, ROW_NODE_PREF = 2, ROW_TAINT = 3, ROW_IPA = 4,
  ROW_RAW = 5,  // + RAW_IPA, RAW_SOFT, RAW_SS_HOST, RAW_SS_ZONE (K2's raw order)
  ROW_STATIC = 9, ROW_AVOID = 10, ROW_SHARE = 11, ROW_PREF_RAW = 12, ROW_TAINT_RAW = 13,
  ROW_BITS = 14,
  WAVE_ROWS = 15,
};
enum : int { RAW_IPA = 0, RAW_SOFT = 1, RAW_SS_HOST = 2, RAW_SS_ZONE = 3, N_RAWS = 4 };
// WaveCtx.mode: K9's inter-pod preference carry; the run's heavy stage
// bits (engine/wavefront.py WAVE_HEAVY_*) shifted
constexpr int WAVE_PREF = 1;
constexpr int WAVE_HEAVY_SHIFT = 4;
enum : int { HEAVY_PORTS = 1, HEAVY_VOLS = 2, HEAVY_STORAGE = 4, HEAVY_GPU = 8 };
// threads of an explain (K20) block (fixed at the launch; the wave
// kernels' and K19's blocks are planned in wave.cuh)
constexpr int WAVE_THREADS = 512;
// WaveCtx.prof: cycles per phase of a step, summed over the run's steps
// by the profile build of K9/K10 (wave.cuh); the last slot counts steps
constexpr int WAVE_PROF_SLOTS = 10;
constexpr int WAVE_PROF_STEPS = WAVE_PROF_SLOTS - 1;

struct WaveCtx {
  int a, b, mode, k;  // the run [a, b) of the batch, mode bits, topology keys
  float* carry;       // [WAVE_ROWS, N] the carried rows past the registers' nodes (wave.cuh)
  long long* prof;    // [WAVE_PROF_SLOTS] the profile build's phase cycles
};

struct DeltaCtx {
  // `ti` the own planes' rows; K7's `pref`, its preference-plane mode
  // (kernels/cuda.py pref_mode): -1 no preference weight in the statics,
  // 0 the adds in log order, > 0 atomic adds where every touched value is
  // an integer of magnitude below `pref` (2^24 - E x the largest |weight|)
  int n, r, p_ports, w, v, sd, gd, tc, e, ti, pref, pad_;
  // K7's pair threads: a thread per node of each (entry, slot) pair's domain
  long long work;
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
  // K7: the nodes of each node_dom domain (as CompactCtx's); each pair's
  // first thread (kernels/cuda.py pair_starts: pair i's threads are
  // pair_start[i] .. pair_start[i + 1] - 1, entry-major, work in all) and
  // the pair of every DELTA_PAIR_CHUNK-th thread, then the last pair
  // (pair_hints); and a word of the entries' upload, zero at the launch,
  // that takes the largest |preference value| the batch touches (the
  // float's bits)
  const int* dom_start;         // [domains + 1]
  const int* dom_nodes;
  const long long* pair_start;  // [E Tc + 1]
  const int* pair_hint;         // [ceil(work / DELTA_PAIR_CHUNK) + 1]
  int* pref_seen;               // [1]
};

// The scenario-batched sweep's kernels (K18 sweep_drain, K19 sweep_place):
// K19 one block per scenario, K18 one per scenario and node tile. Each
// passes the single-scenario block of its kernel family (DeltaCtx for K18,
// StepCtx for K19) with every state plane, per-block scratch and output
// pointing at replica / block / row 0; scenario s's blocks read and write
// replica s, s planes further on (sweep_replica, sweep_block_ctx below).
struct SweepCtx {
  int s;     // scenarios (the grid's first axis)
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
  // K19's launch plan (simtpu_torch/kernels/cuda.py sweep_place_plan):
  // threads, nodes per thread (0: the step rows in `carry`), dynamic
  // shared bytes, the words of one staged pod, and the byte offsets of the
  // segments (off_free -1: the free rows stay in global memory; off_pod,
  // off_min < 0: the segment past the budget, in the scenario's slab,
  // wave.cuh wave_seg).
  // K18's (sweep_drain_plan): threads a block, `npt` the nodes of a tile,
  // `pod_words` the entries staged at a time in `smem` shared bytes, or
  // with `slab` set in the block's slab (blocks in grid order); the other
  // fields unused
  int threads, npt, smem, pod_words, off_pod, off_min, off_free, slab_stride;
  float* carry;  // [S, SWEEP_ROWS, N] the step rows past what registers hold (npt 0), else null
  unsigned char* slab;  // global scratch past the shared budget, slab_stride bytes a block / scenario, else null
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
  // K13: the nodes of each node_dom domain, domain d's at
  // dom_nodes[dom_start[d] .. dom_start[d + 1]) (kernels/cuda.py
  // domain_nodes, built once per node_dom map)
  const int* dom_start;   // [domains + 1]
  const int* dom_nodes;   // [the nodes' domains over every key]
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

// a row of up to M floats into registers: 16-byte loads where M, its
// length and address allow, else 8-byte, else one float at a time
template <int M>
__device__ __forceinline__ void load_row(float (&dst)[M], const float* src, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if constexpr (M % 4 == 0) {
    if ((len & 3) == 0 && (a & 15) == 0) {
#pragma unroll
      for (int j = 0; j < M; j += 4)
        if (j < len) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src + j));
          dst[j] = v.x;
          dst[j + 1] = v.y;
          dst[j + 2] = v.z;
          dst[j + 3] = v.w;
        }
      return;
    }
  }
  if constexpr (M % 2 == 0) {
    if ((len & 1) == 0 && (a & 7) == 0) {
#pragma unroll
      for (int j = 0; j < M; j += 2)
        if (j < len) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(src + j));
          dst[j] = v.x;
          dst[j + 1] = v.y;
        }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < len) dst[j] = __ldg(src + j);
}

// a row of up to M bytes into registers as flags: 4-byte loads where M,
// its length and address allow, else one byte at a time
template <int M>
__device__ __forceinline__ void load_flags(bool (&dst)[M], const uint8_t* src, int len) {
  if constexpr (M % 4 == 0) {
    if ((len & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
#pragma unroll
      for (int j = 0; j < M; j += 4)
        if (j < len) {
          const unsigned int v = __ldg(reinterpret_cast<const unsigned int*>(src + j));
#pragma unroll
          for (int b = 0; b < 4; ++b) dst[j + b] = ((v >> (8 * b)) & 0xFFu) != 0;
        }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < len) dst[j] = __ldg(src + j) != 0;
}

// a row of up to M floats from registers: 16-byte stores where M, its
// length and address allow, else 8-byte, else one float at a time
template <int M>
__device__ __forceinline__ void store_row(float* dst, const float (&src)[M], int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if constexpr (M % 4 == 0) {
    if ((len & 3) == 0 && (a & 15) == 0) {
#pragma unroll
      for (int j = 0; j < M; j += 4)
        if (j < len) *reinterpret_cast<float4*>(dst + j) = make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]);
      return;
    }
  }
  if constexpr (M % 2 == 0) {
    if ((len & 1) == 0 && (a & 7) == 0) {
#pragma unroll
      for (int j = 0; j < M; j += 2)
        if (j < len) *reinterpret_cast<float2*>(dst + j) = make_float2(src[j], src[j + 1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < len) dst[j] = src[j];
}

static inline int launch_status() { return static_cast<int>(cudaGetLastError()); }
