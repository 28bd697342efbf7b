// Device code of the kernels that keep one thread per node and the step's
// state on chip (K9 wave_lean.cu, K10 wave_hard.cu, and per scenario K19
// sweep_place.cu): the launch plan (threads, nodes per thread, what is
// staged in shared memory), the one-barrier block reductions and the
// phase stamps of the profile build. The per-node code these kernels
// share with the per-pod step (node_stages.cuh, topology.cuh, scores.cuh,
// ext_plans.cuh) is called from here unchanged.
//
// Layout: one block of up to WAVE_BLOCK threads, node n owned by thread
// n % threads as its (n / threads)-th node. Up to WAVE_BLOCK nodes each
// thread owns one node; above, ceil(N / WAVE_BLOCK) nodes, a template
// parameter (1, 2 or 4) chosen by N at the launch, with the nodes' carried
// state in registers. Above 4 * WAVE_BLOCK nodes the same step code runs
// with the carried rows in WaveCtx.carry (global memory, L1/L2-resident):
// `WAVE_GLOBAL_NPT`. What the block stages in dynamic shared memory (the
// run's request rows, the free rows, the node_dom rows of the group's
// keys, K10's count rows) is planned at the launch in the same priority
// order for every size; what does not fit is read from global memory,
// through the same code. K9/K10 plan here; K19's launch follows the plan
// its wrapper computes by the same rules (kernels/cuda.py
// sweep_place_plan).
#pragma once
#include "node_stages.cuh"
#include "step_ctx.cuh"

constexpr int WAVE_BLOCK = 1024;
// nodes per thread kept in registers at most; 0 in the template = rows in
// global memory
constexpr int WAVE_REG_NPT = 4;
constexpr int WAVE_GLOBAL_NPT = 0;
// dynamic shared memory a wave block plans with (of 227 KB, less the
// static reduction slots)
constexpr int WAVE_SMEM = 200 * 1024;

__host__ __device__ inline int wave_threads(int n) {
  int t = ((n + 31) / 32) * 32;
  return t < 32 ? 32 : (t > WAVE_BLOCK ? WAVE_BLOCK : t);
}

// nodes per thread of the template for N nodes (0: global rows)
__host__ inline int wave_npt(int n) {
  const int per = (n + WAVE_BLOCK - 1) / WAVE_BLOCK;
  if (per <= 1) return 1;
  if (per <= 2) return 2;
  if (per <= WAVE_REG_NPT) return WAVE_REG_NPT;
  return WAVE_GLOBAL_NPT;
}

// A dynamic shared-memory plan: segments added in priority order, each
// staged where it still fits in WAVE_SMEM (its byte offset), else -1.
struct SmemPlan {
  int used = 0;
  __host__ int add(size_t bytes, bool required = false) {
    const size_t at = (static_cast<size_t>(used) + 15) & ~static_cast<size_t>(15);
    if (!required && at + bytes > static_cast<size_t>(WAVE_SMEM)) return -1;
    used = static_cast<int>(at + bytes);
    return static_cast<int>(at);
  }
};

// Where a scratch segment of a plan lives (K10's term columns, minima, key
// slots and pod flags; K19's staged pods and minima): an offset >= 0 is a
// byte offset into dynamic shared memory; past the plan's budget the
// segment is read and written at byte -1 - off of the block's slab of
// global scratch (the wrapper's torch.empty; kernels/cuda.py
// wave_hard_plan, sweep_place_plan). The same code runs either way: a
// barrier publishes a global write to the block as it does a shared one.
// The kernels are built twice, SLAB false where the plan has no slab: a
// pointer that may point to either space is a generic one, and generic
// loads, stores and atomics on shared memory slowed the steps on the card.
template <class T, bool SLAB>
__device__ inline T* wave_seg(unsigned char* smem, unsigned char* slab, int off) {
  if constexpr (!SLAB)
    return reinterpret_cast<T*>(smem + off);
  else
    return reinterpret_cast<T*>(off >= 0 ? smem + off : slab + (-1 - static_cast<long long>(off)));
}

// a thread's nodes' carried rows: registers (NPT > 0), or the rows of
// WaveCtx.carry (WAVE_GLOBAL_NPT); (row, j, n) = row `row` of the thread's
// j-th node, node n
template <int NPT>
struct WaveRows {
  float v[WAVE_ROWS][NPT];
  __device__ WaveRows(const WaveCtx&, int) {}
  __device__ float& operator()(int r, int j, int) { return v[r][j]; }
};
template <>
struct WaveRows<WAVE_GLOBAL_NPT> {
  float* carry;
  int n_all;
  __device__ WaveRows(const WaveCtx& w, int n) : carry(w.carry), n_all(n) {}
  __device__ float& operator()(int r, int, int n) { return carry[static_cast<size_t>(r) * n_all + n]; }
};

// -- one-barrier block reductions ----------------------------------------------
// Every warp folds its lanes with the warp-reduce instructions (redux.sync
// on order-preserving 32-bit keys of the floats: one instruction per value
// where a shuffle tree takes ten), lane 0 writes the warp's partial into
// its slot, one barrier, then every warp folds the partials again (lane l
// reads slot l) so that every thread holds the result. min / max of the
// keys are min / max of the floats, order-free: bit-exact (NaN, which
// fminf / fmaxf skip, takes the identity's key). The caller gives each
// reduction of a step its own slot array: a slot array is written again
// only after a later reduction's barrier, which every reader of its
// previous contents has passed.

// the order-preserving key of a float (-0 below +0) and back
__device__ inline unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ inline float fkey_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
__device__ inline unsigned max_key(float v) { return isnan(v) ? 0u : fkey(v); }
__device__ inline unsigned min_key(float v) { return isnan(v) ? 0xffffffffu : fkey(v); }

// argmax (higher score, lowest index on ties; equal scores tie, +0 with
// -0 too) and an OR of bits
struct ArgOr {
  float bv;
  int bi;
  unsigned bits;
  __device__ void merge(const ArgOr& o) {
    if (o.bv > bv || (o.bv == bv && o.bi < bi)) { bv = o.bv; bi = o.bi; }
    bits |= o.bits;
  }
  __device__ static ArgOr identity() { return {-INFINITY, 0x7fffffff, 0u}; }
};
struct ArgOrSlot {
  unsigned key, idx, bits;
};

// the block's argmax and OR of the threads' (already merged) candidates;
// contains the one barrier. The result's bv is the winning score (+0 for
// a -0).
__device__ inline ArgOr block_argmax_or(const ArgOr& v, ArgOrSlot* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned k = isnan(v.bv) ? 0u : fkey(v.bv + 0.0f);
  unsigned km = __reduce_max_sync(0xffffffffu, k);
  unsigned im = __reduce_min_sync(0xffffffffu, k == km ? static_cast<unsigned>(v.bi) : 0xffffffffu);
  unsigned bits = __reduce_or_sync(0xffffffffu, v.bits);
  if (lane == 0) slots[warp] = {km, im, bits};
  __syncthreads();
  const ArgOrSlot o = lane < static_cast<int>(blockDim.x >> 5) ? slots[lane] : ArgOrSlot{0u, 0xffffffffu, 0u};
  km = __reduce_max_sync(0xffffffffu, o.key);
  im = __reduce_min_sync(0xffffffffu, o.key == km ? o.idx : 0xffffffffu);
  bits = __reduce_or_sync(0xffffffffu, o.bits);
  return {fkey_value(km), static_cast<int>(im), bits};
}

// NL minima, NH maxima and an OR of bits
template <int NL, int NH>
struct MinMaxOr {
  float lo[NL];
  float hi[NH];
  unsigned bits;
  static constexpr int WORDS = NL + NH + 1;  // slot words per warp
};

// The block's minima, maxima and OR; `slots` holds 32 x WORDS words.
// Values whose bit is clear in `live` (bit k: lo[k]; bit NL + k: hi[k]) are
// not reduced (the caller does not read them). Contains the one barrier.
template <int NL, int NH>
__device__ inline MinMaxOr<NL, NH> block_minmax_or(const MinMaxOr<NL, NH>& v, unsigned* slots,
                                                   unsigned live = 0xffffffffu) {
  constexpr int W = MinMaxOr<NL, NH>::WORDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  MinMaxOr<NL, NH> r = v;
  unsigned* mine = slots + warp * W;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    if (!((live >> k) & 1u)) continue;
    const unsigned m = __reduce_min_sync(0xffffffffu, min_key(v.lo[k]));
    if (lane == 0) mine[k] = m;
  }
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    if (!((live >> (NL + k)) & 1u)) continue;
    const unsigned m = __reduce_max_sync(0xffffffffu, max_key(v.hi[k]));
    if (lane == 0) mine[NL + k] = m;
  }
  const unsigned b = __reduce_or_sync(0xffffffffu, v.bits);
  if (lane == 0) mine[NL + NH] = b;
  __syncthreads();
  const unsigned* part = slots + lane * W;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    if (!((live >> k) & 1u)) continue;
    r.lo[k] = fkey_value(__reduce_min_sync(0xffffffffu, in ? part[k] : 0xffffffffu));
  }
#pragma unroll
  for (int k = 0; k < NH; ++k) {
    if (!((live >> (NL + k)) & 1u)) continue;
    r.hi[k] = fkey_value(__reduce_max_sync(0xffffffffu, in ? part[NL + k] : 0u));
  }
  r.bits = __reduce_or_sync(0xffffffffu, in ? part[NL + NH] : 0u);
  return r;
}

// A block minimum taken in two halves around a barrier the caller
// already has: warp_min_slot folds a value over the warp and lane 0 writes
// its key to slots[warp * stride]; after the barrier slot_min folds the
// warps' partials (lane l reads slots[l * stride]) so every thread holds it.
__device__ inline void warp_min_slot(float v, unsigned* slots, int stride) {
  const unsigned m = __reduce_min_sync(0xffffffffu, min_key(v));
  if ((threadIdx.x & 31) == 0) slots[(threadIdx.x >> 5) * stride] = m;
}

__device__ inline float slot_min(const unsigned* slots, int stride) {
  const int lane = threadIdx.x & 31;
  const unsigned k = lane < static_cast<int>(blockDim.x >> 5) ? slots[lane * stride] : 0xffffffffu;
  return fkey_value(__reduce_min_sync(0xffffffffu, k));
}

// the resource fit of one free row (node_stages.cuh res_fits) at stride
// `fs` between resources
__device__ inline bool fit_row(const float* fr, int fs, const float* req, int r) {
  for (int q = 0; q < r; ++q)
    if (!res_fits(fr[q * fs], req[q])) return false;
  return true;
}

// scores.cuh resource_base's arithmetic over a free row at stride `fs`
__device__ inline float resource_base_row(const float* al, const float* fr, int fs, const float* req,
                                          float w0, float w1) {
  float frac[2], bfrac[2];
  const int cols[2] = {RES_CPU, RES_MEMORY};
  for (int k = 0; k < 2; ++k) {
    const float a = al[cols[k]];
    const float f = fr[cols[k] * fs];
    const float fa = f - req[cols[k]];
    frac[k] = a > 0.0f ? __fdiv_rn(fmaxf(fa, 0.0f), fmaxf(a, TINY)) : 0.0f;
    const float used = (a - f) + req[cols[k]];
    bfrac[k] = a > 0.0f ? __fdiv_rn(used, fmaxf(a, TINY)) : 1.0f;
  }
  const float balanced = (1.0f - fabsf(bfrac[0] - bfrac[1])) * (w1 * MAX_NODE_SCORE);
  return (frac[0] + frac[1]) * (w0 * 50.0f) + balanced;
}

// -- the profile build's phase stamps -------------------------------------------
// Built with -DSIMTPU_WAVE_PROFILE (chip_smoke.py's breakdown phase only):
// thread 0 adds the clock64() cycles of each phase of every step into
// WaveCtx.prof[phase] (slot WAVE_PROF_STEPS counts the steps). The main
// path's build has no stamp.
#ifdef SIMTPU_WAVE_PROFILE
#define WAVE_STAMP_DECL long long wave_t0_ = clock64(); long long wave_acc_[WAVE_PROF_SLOTS] = {0};
#define WAVE_STAMP(phase)                                      \
  do {                                                         \
    const long long t_ = clock64();                            \
    wave_acc_[phase] += t_ - wave_t0_;                         \
    wave_t0_ = t_;                                             \
  } while (0)
#define WAVE_STAMP_STEP() (++wave_acc_[WAVE_PROF_STEPS])
#define WAVE_COUNT(slot) (++wave_acc_[slot])
#define WAVE_STAMP_FLUSH(w)                                                  \
  do {                                                                       \
    if (threadIdx.x == 0 && (w).prof)                                        \
      for (int q_ = 0; q_ < WAVE_PROF_SLOTS; ++q_) (w).prof[q_] += wave_acc_[q_]; \
  } while (0)
#else
#define WAVE_STAMP_DECL
#define WAVE_STAMP(phase) ((void)0)
#define WAVE_STAMP_STEP() ((void)0)
#define WAVE_COUNT(slot) ((void)0)
#define WAVE_STAMP_FLUSH(w) ((void)0)
#endif
