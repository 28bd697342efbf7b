// Device code of the bulk rounds (K14 round_score, K15 round_pick, K16
// round_commit): the argument block `RoundCtx`, the NaN-propagating clip
// of the JAX formulas, the block reductions and scans, and the per-node
// helpers the three kernels share.
//
// One round places up to k identical pods (representative pod i of the
// batch) after K1, K5/K6 and K2 ran for it: K14 reads their stage byte,
// plans and raw count rows; K15 reads K14's caps, s0 and slope; K16 reads
// K15's per-node intake m_n. Each is one block striding over the nodes,
// so a phase that needs every node's value (a normalizer, a domain sum, a
// prefix) is a barrier away, not a second launch.
//
// Numerics: the formulas are the JAX package's simtpu/engine/rounds.py
// (and the port's plain versions in simtpu_torch/engine/rounds.py) term
// for term, with the FMA sites of the compiled round (the resource slack,
// `free - m_n * req`, the non-matrix `free - take * size`). Sums of
// integer-valued f32 (caps, counts, intakes) below 2^24 are exact in any
// order; a sum that meets one 3.4e38 cap is 3.4e38 and one that meets two
// is inf in any order, so reductions and scans may reassociate them.
// min/max/clip propagate NaN as XLA's do (`jmin` / `jmax`).
#pragma once
#include "scores.cuh"
#include "topology.cuh"

// RoundCtx.mode bits (engine/rounds.py V_*)
constexpr int RV_QUOTA = 1;
constexpr int RV_SELF_AFF = 2;
constexpr int RV_MATS = 4;
constexpr float NEG = -3.4e38f;
constexpr int ROUND_THREADS = 1024;
constexpr int DOM_SMALL = 64;
constexpr int BISECT_STEPS = 40;
// RoundCtx.scr rows [SCR_ROWS, N]
enum : int { SC_RAW1 = 0, SC_CUM = 4, SC_CAP_O = 5, SC_EXCL = 6, SC_BASE = 7, SCR_ROWS = 8 };
// RoundCtx.dscr rows [DSCR_ROWS, n_dom + 1]
enum : int { DS_K = 0, DS_C = 1, DS_OWN = 2, DS_ELIG = 3, DS_X = 4, DS_POUR = 5, DSCR_ROWS = 6 };
// RoundCtx.iscr: [N] sorted position, [N] sorted key, [n_dom + 2] key counts / offsets
enum : int { IS_POS = 0, IS_KEY = 1 };

struct RoundCtx {
  int i, k, mode, row, n_dom, k_cap;
  float* cap;      // [N] intake caps (K14 writes, K15 reads)
  float* s0;       // [N] round-start score, NEG outside m_all
  float* slope;    // [N] per-pod score drop, clipped to [0, 1e6]
  float* m_n;      // [N] intake (K15 writes, K16 reads)
  uint8_t* m_all;  // [N]
  int* ord_vg;     // [N, V] tightest-first visit order of the VGs
  float* cs_vg;    // [N, V] slots in visit order
  float* cum_vg;   // [N, V] their running sum
  int* ord_dev;    // [N, SD]
  float* cs_dev;
  float* cum_dev;
  int* ord_gpu;    // [N, GD]
  float* cs_gpu;
  float* cum_gpu;
  float* c_gpu;    // [N, GD] GPU slots in index order (matrix rounds)
  float* cum_gidx; // [N, GD] their running sum
  float* dom_sums; // [Tc, n_dom] K16's fallback-route domain sums
  const int* key_kind;        // [K] 0 fallback, 1 small, 2 unique per node
  const int* node_dom_small;  // [K, N] compact per-key domain id, -1 absent
  float* scr;      // [SCR_ROWS, N]
  float* dscr;     // [DSCR_ROWS, n_dom + 1]
  int* iscr;       // [2 N + n_dom + 2]
  int* assign;     // [rows, k_cap] node per slot, -1 past the placed count
  int* vg_idx;     // [rows, k_cap]
  int* dev_idx;    // [rows, k_cap]
  int* gpu_idx;    // [rows, k_cap]
  float* lvm_mat;  // [rows, k_cap, V]
  float* gpu_mat;  // [rows, k_cap, GD]
};

// XLA's max / min / clip: NaN in, NaN out
__device__ inline float jmax(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ inline float jmin(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }
__device__ inline float jclip(float x, float lo, float hi) { return jmin(jmax(x, lo), hi); }

// floor(free / size), one slot less where the division rounded up across
// an integer boundary (rounds.py _floor_slots)
__device__ inline float floor_slots(float free, float size) {
  const float c = floorf(__fdiv_rn(free, fmaxf(size, TINY)));
  return c * size > free ? c - 1.0f : c;
}

// -- block reductions and scans (blockDim.x a multiple of 32, <= 1024) ------

struct BlockScratch {
  float v[32];
};

// sum / min / max of one float per thread; every thread gets the result
template <typename Op>
__device__ inline float block_reduce(float v, Op op, BlockScratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) sh.v[warp] = v;
  __syncthreads();
  v = sh.v[0];
  for (int w = 1; w < n_warps; ++w) v = op(v, sh.v[w]);
  __syncthreads();
  return v;
}

__device__ inline float block_sum(float v, BlockScratch& sh) {
  return block_reduce(v, [](float a, float b) { return a + b; }, sh);
}
__device__ inline float block_min(float v, BlockScratch& sh) {
  return block_reduce(v, [](float a, float b) { return jmin(a, b); }, sh);
}
__device__ inline float block_max(float v, BlockScratch& sh) {
  return block_reduce(v, [](float a, float b) { return jmax(a, b); }, sh);
}

// the exclusive prefix of one float per thread in thread order, with `op`
// (a + b or jmax)
template <typename Op>
__device__ inline float block_exclusive(float v, Op op, float ident, BlockScratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = op(o, incl);
  }
  if (lane == 31) sh.v[warp] = incl;
  __syncthreads();
  float before = ident;
  for (int w = 0; w < warp; ++w) before = op(before, sh.v[w]);
  __syncthreads();
  const float excl_lane = __shfl_up_sync(0xffffffffu, incl, 1);
  return lane == 0 ? before : op(before, excl_lane);
}

// In-place inclusive scan of a[0..n) with `op`, block-wide: each thread
// owns a contiguous chunk, chunks combine by block_exclusive. Ends with a
// barrier.
template <typename Op>
__device__ inline void block_scan_array(float* a, int n, Op op, float ident, BlockScratch& sh) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per, hi = min(n, lo + per);
  float run = ident;
  for (int j = lo; j < hi; ++j) { run = op(run, a[j]); a[j] = run; }
  const float before = block_exclusive(run, op, ident, sh);
  for (int j = lo; j < hi; ++j) a[j] = op(before, a[j]);
  __syncthreads();
}

// -- the round's pod ------------------------------------------------------------

struct RoundPod {
  int g;
  const float* req;
  float l_size;
  int l_vid;
  bool multi_lvm;
  float d_size;
  int d_media;
  float gpu_mem;
  int gpu_count;
  bool has_preset;
  const int* preset;
  bool st_live, gpu_live;
};

// the heaviest LVM and device claims (first on ties, as torch.argmax), the
// GPU demand, the live plan bits (rounds.py _pod_scalars)
__device__ inline RoundPod round_pod(const StepCtx& x, int i) {
  RoundPod p;
  p.g = x.group[i];
  p.req = x.req + static_cast<size_t>(i) * x.r;
  const float* lsz = x.lvm_size + static_cast<size_t>(i) * x.l;
  int li = 0, n_lvm = 0;
  for (int c = 0; c < x.l; ++c) {
    if (lsz[c] > lsz[li]) li = c;
    n_lvm += lsz[c] > 0.0f ? 1 : 0;
  }
  p.l_size = x.l ? lsz[li] : 0.0f;
  p.l_vid = x.l ? x.lvm_vg[static_cast<size_t>(i) * x.l + li] : -1;
  p.multi_lvm = n_lvm > 1;
  const float* dsz = x.dev_size + static_cast<size_t>(i) * x.k;
  int di = 0;
  for (int c = 0; c < x.k; ++c)
    if (dsz[c] > dsz[di]) di = c;
  p.d_size = x.k ? dsz[di] : 0.0f;
  p.d_media = x.k ? x.dev_media[static_cast<size_t>(i) * x.k + di] : 0;
  p.gpu_mem = x.gpu_mem[i];
  p.gpu_count = x.gpu_count[i];
  p.preset = x.gpu_preset + static_cast<size_t>(i) * x.gd;
  int psum = 0;
  for (int d = 0; d < x.gd; ++d) psum += p.preset[d];
  p.has_preset = psum > 0;
  p.st_live = x.ext_live[i] & LIVE_STORAGE;
  p.gpu_live = x.ext_live[i] & LIVE_GPU;
  return p;
}

__device__ inline bool uses_topology(int f) { return (f & F_TOPOLOGY) != 0; }

// node n's m_all / m_gpu / m_static from K2's stage byte and K5/K6's verdicts
__device__ inline bool ext_ok(const StepCtx& x, const RoundPod& p, int n) {
  return (!p.st_live || x.st_ok[n]) && (!p.gpu_live || x.gpu_ok[n]);
}
__device__ inline bool node_m_all(const StepCtx& x, const RoundPod& p, int n) {
  return ((x.stage[n] >> 7) & 1u) && ext_ok(x, p, n);
}
__device__ inline bool node_m_gpu(const StepCtx& x, const RoundPod& p, int n) {
  return ((x.stage[n] >> 5) & 1u) && ext_ok(x, p, n);
}

// Tightest-first visit order of X containers (ascending key, ties by
// index: a stable insertion sort), their slots in that order and the
// running sum, written to the node's rows.
__device__ inline void fill_order(const float* c, const float* key, int X, int* ord, float* cs, float* cum) {
  int o[MAX_EXT];
  for (int v = 0; v < X; ++v) {
    int j = v;
    while (j > 0 && key[o[j - 1]] > key[v]) { o[j] = o[j - 1]; --j; }
    o[j] = v;
  }
  float run = 0.0f;
  for (int j = 0; j < X; ++j) {
    ord[j] = o[j];
    cs[j] = c[o[j]];
    run += c[o[j]];
    cum[j] = run;
  }
}

// pods per container of a node given m pods, back in container order
// (rounds.py _unsort_take)
__device__ inline void unsort_take(float m, const int* ord, const float* cs, const float* cum, int X,
                                   float* out) {
  for (int j = 0; j < X; ++j) out[ord[j]] = jclip(m - (cum[j] - cs[j]), 0.0f, cs[j]);
}

// `resource_base` of scores.cuh over an overriding free row `fr` [2]
// (cpu, memory): the re-score of a state one pod further on
__device__ inline float resource_base_fr(const StepCtx& x, int n, const float* req, const float* fr,
                                         float w0, float w1) {
  const float* al = x.alloc + static_cast<size_t>(n) * x.r;
  float frac[2], bfrac[2];
  const int cols[2] = {RES_CPU, RES_MEMORY};
  for (int k = 0; k < 2; ++k) {
    const float a = al[cols[k]];
    const float fa = fr[k] - req[cols[k]];
    frac[k] = a > 0.0f ? __fdiv_rn(fmaxf(fa, 0.0f), fmaxf(a, TINY)) : 0.0f;
    const float used = (a - fr[k]) + req[cols[k]];
    bfrac[k] = a > 0.0f ? __fdiv_rn(used, fmaxf(a, TINY)) : 1.0f;
  }
  const float balanced = (1.0f - fabsf(bfrac[0] - bfrac[1])) * (w1 * MAX_NODE_SCORE);
  return (frac[0] + frac[1]) * (w0 * 50.0f) + balanced;
}
