// K7 delta_apply: signed placement-log entries folded into the dense
// carried state.
//
// Replaces the JAX package's simtpu/engine/state.py placement_delta_step
// (:339), scanned by apply_placement_deltas (:405): each entry (group,
// node, w, request, LVM allocation, devices taken, GPU memory per device)
// is the commit step's state update with weight w — +1 re-places, -1
// evicts, 0 is padding and changes nothing. One call applies a whole
// eviction (or its undo).
//
// K13's design (compact_delta.cu) on the dense carry, two kernels a call
// on the same plan (kernels/cuda.py compact_delta_plan):
// 1. delta_apply_kernel: block 0 is delta_runs.cuh's grouping block; the
//    pair blocks take one thread per (entry, term slot, k-th node of the
//    chosen node's domain): the wrapper sizes each pair by its own domain
//    (kernels/cuda.py pair_starts: one thread for a per-node key, a zone's
//    nodes for a zone key, none for padding or an empty slot) and passes
//    the running sum, which a thread searches for its pair from the
//    hints of its chunk of DELTA_PAIR_CHUNK threads (pair_hints: a few
//    pairs apart for zone keys, so a chain of few loads). Each resolves
//    its slot's chain — term, key row, the chosen node's domain (node < 0
//    reads node 0), ip row, the values x w — and adds, at its node of the
//    domain (the wrapper's domain_nodes lists, no walk over all N),
//    cnt_match and the own planes cnt_own_anti / cnt_own_aff with f32
//    atomics, the pair's first thread cnt_total. Those adds are 0 or 1
//    times w = +-1 onto counts of pods: all integers far below 2^24, so
//    every partial sum is exact and the result is the same in any order.
//    A pair with a preference weight also reads the two preference planes
//    at its node and keeps the largest |value| (infinite where one is not
//    an integer) in `pref_seen`, one atomicMax a warp.
// 2. delta_apply_walk_kernel: delta_runs.cuh's walk on the dense rows
//    (free, vg_free, gpu_free, the ports / vols counts in f32, sdev_free),
//    each node's entries in log order; then `pref_blocks` blocks for the
//    preference planes w_own_aff_pref / w_own_anti_pref, which add
//    w_aff_pref / w_anti_pref x w: summed preference weights, which the
//    tensorizer reads as floats. Where the wrapper found both weight
//    planes integer-valued (`pref` > 0: 2^24 - E x their largest |w|) and
//    every touched value is an integer below `pref` in magnitude, each
//    cell takes at most E integer adds (a term has one ip row and appears
//    once in a group's slots) and every partial sum stays an integer below
//    2^24: exact in any order, so the pair threads (a node each, as in
//    kernel 1) add with atomics, a grid-stride loop over them.
//    Otherwise (`pref` 0, or a value past the bound) a block per ip row
//    takes the row's pairs in log order, a chunk of entries at a time
//    compacted in order into shared memory, and each thread adds them to
//    its nodes' two cells in that order: the reference's order per cell.
//    The blocks: as many as either path can use, at most
//    DELTA_PREF_BLOCKS (delta_pref_blocks).
// sdev_free is boolean: w > 0 clears the taken devices, w < 0 sets them.
//
// Bound: bytes — the entries, the touched rows and the domains' columns
// read and written once; a preemption wave applies a few hundred entries,
// so the launches' latency and the grouping block's passes dominate.
#include <algorithm>

#include "delta_runs.cuh"
#include "step_ctx.cuh"

__device__ inline DeltaRows<float> delta_rows(const DeltaCtx& x) {
  return {x.r, x.p_ports, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp, x.ports_req, x.vol_rw_req,
          x.vol_ro_req, x.vol_att_req, x.free, x.ports_used, x.vols_any, x.vols_rw, x.vg_free, x.sdev_free,
          x.gpu_free};
}

// A pair's chain: the entry's weight, its slot's term and ip row and the
// chosen node's domain under the term's key; false where the pair adds
// nothing (padding, an empty slot, a node without the key)
struct DeltaPair {
  float w;
  size_t gt;
  int term, ip, dom;
};

__device__ inline bool delta_pair_of(const DeltaCtx& x, int e, int t, DeltaPair& p) {
  p.w = x.wgt[e];
  if (p.w == 0.0f) return false;
  const int g = x.g[e];
  const int c = x.node[e] < 0 ? 0 : x.node[e];
  p.gt = static_cast<size_t>(g) * x.tc + t;
  p.term = x.g_terms[p.gt];
  if (p.term < 0) return false;
  p.dom = x.node_dom[static_cast<size_t>(x.term_topo[p.term]) * x.n + c];
  if (p.dom < 0) return false;
  p.ip = x.ip_of[p.term];
  return true;
}

// a pair whose preference planes take an add (both weights 0 add +-0)
__device__ inline bool delta_pref_pair(const DeltaCtx& x, const DeltaPair& p) {
  return x.pref >= 0 && p.ip >= 0 && (x.w_aff_pref[p.gt] != 0.0f || x.w_anti_pref[p.gt] != 0.0f);
}

// |v|, or infinity where v is not an integer
__device__ inline float delta_pref_size(float v) { return v == truncf(v) ? fabsf(v) : __int_as_float(0x7f800000); }

// pair threads a search hint covers (kernels/cuda.py DELTA_PAIR_CHUNK)
constexpr int DELTA_PAIR_CHUNK = 256;

// Pair thread j (j < work): its (entry, slot) pair, the pair whose
// threads pair_start[i] .. pair_start[i + 1] - 1 hold it (a binary search
// of the running sum between its chunk's hints; a pair of no threads is
// never found), its node, the k-th of the chosen node's domain, and
// whether it is the pair's first
__device__ inline bool delta_slot(const DeltaCtx& x, long long j, DeltaPair& p, int& m, bool& first) {
  const long long c = j / DELTA_PAIR_CHUNK;
  int lo = x.pair_hint[c], hi = x.pair_hint[c + 1] + 1;  // pair_start[lo] <= j < pair_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (x.pair_start[mid] <= j) lo = mid;
    else hi = mid;
  }
  if (!delta_pair_of(x, lo / x.tc, lo % x.tc, p)) return false;
  const long long k = j - x.pair_start[lo];
  const int at = x.dom_start[p.dom] + static_cast<int>(k);
  if (at >= x.dom_start[p.dom + 1]) return false;
  m = x.dom_nodes[at];
  first = k == 0;
  return true;
}

// Thread j's counts: cnt_total (the pair's first thread), cnt_match and the
// own planes at its node; returns the bits of its preference values' size
// (0 where it reads none)
__device__ inline unsigned delta_apply_pair(const DeltaCtx& x, long long j) {
  DeltaPair p;
  int m;
  bool first;
  if (!delta_slot(x, j, p, m, first)) return 0u;
  const float s = (x.s_match[p.gt] ? 1.0f : 0.0f) * p.w;
  if (first) atomicAdd(&x.cnt_total[p.term], s);
  atomicAdd(x.cnt_match + static_cast<size_t>(p.term) * x.n + m, s);
  if (p.ip < 0) return 0u;
  const size_t cell = static_cast<size_t>(p.ip) * x.n + m;
  atomicAdd(x.cnt_own_anti + cell, (x.a_anti_req[p.gt] ? 1.0f : 0.0f) * p.w);
  atomicAdd(x.cnt_own_aff + cell, (x.a_aff_req[p.gt] ? 1.0f : 0.0f) * p.w);
  if (!delta_pref_pair(x, p)) return 0u;
  return __float_as_uint(fmaxf(delta_pref_size(x.w_own_aff_pref[cell]), delta_pref_size(x.w_own_anti_pref[cell])));
}

__global__ void __launch_bounds__(DELTA_MAX_THREADS) delta_apply_kernel(DeltaCtx x, DeltaPlan p) {
  extern __shared__ __align__(16) int dsm[];
  if (blockIdx.x > 0) {
    const long long j = static_cast<long long>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
    const unsigned seen = j < x.work ? delta_apply_pair(x, j) : 0u;
    // one atomic a warp for the largest preference value it read
    const unsigned most = __reduce_max_sync(0xFFFFFFFFu, seen);
    if ((threadIdx.x & 31) == 0 && most) atomicMax(x.pref_seen, static_cast<int>(most));
    return;
  }
  delta_group_block(x, p, dsm);
}

// The preference planes with atomics: thread j's two values at its node
__device__ inline void delta_pref_atomic(const DeltaCtx& x, long long j) {
  DeltaPair p;
  int m;
  bool first;
  if (!delta_slot(x, j, p, m, first) || !delta_pref_pair(x, p)) return;
  const size_t cell = static_cast<size_t>(p.ip) * x.n + m;
  atomicAdd(x.w_own_aff_pref + cell, x.w_aff_pref[p.gt] * p.w);
  atomicAdd(x.w_own_anti_pref + cell, x.w_anti_pref[p.gt] * p.w);
}

// The preference planes in log order: ip row i's pairs (one slot an entry
// at most), a chunk of blockDim entries at a time compacted in order into
// shared memory, then added to each of the block's nodes in that order
__device__ inline void delta_pref_in_order(const DeltaCtx& x, int i) {
  __shared__ int s_dom[DELTA_WALK_THREADS];
  __shared__ float s_wa[DELTA_WALK_THREADS], s_wn[DELTA_WALK_THREADS];
  __shared__ int s_key;
  __shared__ int s_wsum[32];
  const size_t row = static_cast<size_t>(i) * x.n;
  for (int e0 = 0; e0 < x.e; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    DeltaPair p;
    bool mine = false;
    if (e < x.e)
      for (int t = 0; t < x.tc; ++t) {
        const int term = x.g_terms[static_cast<size_t>(x.g[e]) * x.tc + t];
        if (term >= 0 && x.ip_of[term] == i) {
          mine = delta_pair_of(x, e, t, p);
          break;
        }
      }
    int total;
    const int at = block_scan(mine ? 1 : 0, s_wsum, total);
    if (mine) {
      s_dom[at] = p.dom;
      s_wa[at] = x.w_aff_pref[p.gt] * p.w;
      s_wn[at] = x.w_anti_pref[p.gt] * p.w;
      s_key = x.term_topo[p.term];  // every pair of the row: the row's term's key
    }
    __syncthreads();
    if (total > 0) {
      const int* dom = x.node_dom + static_cast<size_t>(s_key) * x.n;
      for (int m = threadIdx.x; m < x.n; m += blockDim.x) {
        const int d = dom[m];
        if (d < 0) continue;
        float va = 0.0f, vn = 0.0f;
        bool read = false;
        for (int k = 0; k < total; ++k)
          if (s_dom[k] == d) {
            if (!read) {
              va = x.w_own_aff_pref[row + m];
              vn = x.w_own_anti_pref[row + m];
              read = true;
            }
            va = va + s_wa[k];
            vn = vn + s_wn[k];
          }
        if (read) {
          x.w_own_aff_pref[row + m] = va;
          x.w_own_anti_pref[row + m] = vn;
        }
      }
    }
    __syncthreads();
  }
}

// The walk kernel: walk_blocks blocks of (element, run) walkers, then
// pref_blocks blocks for the preference planes, which read pref_seen
// (kernel 1 has ended) to choose the atomics or the log order
__global__ void __launch_bounds__(DELTA_WALK_THREADS) delta_apply_walk_kernel(DeltaCtx x, DeltaPlan p) {
  if (static_cast<int>(blockIdx.x) < p.walk_blocks) {
    delta_walk(delta_rows(x), p, x.e, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
    return;
  }
  const int b = blockIdx.x - p.walk_blocks;
  if (x.pref > 0 && __int_as_float(*x.pref_seen) < static_cast<float>(x.pref)) {
    for (long long j = static_cast<long long>(b) * blockDim.x + threadIdx.x; j < x.work;
         j += static_cast<long long>(p.pref_blocks) * blockDim.x)
      delta_pref_atomic(x, j);
  } else {
    for (int i = b; i < x.ti; i += p.pref_blocks) delta_pref_in_order(x, i);
  }
}

// K7's preference blocks (kernels/cuda.py compact_delta_plan): none
// without pair threads, else as many as the atomic path's threads fill or
// the log order's ip rows take, at most DELTA_PREF_BLOCKS
constexpr int DELTA_PREF_BLOCKS = 2048;

inline int delta_pref_blocks(long long work, int ti) {
  if (work <= 0) return 0;
  const long long want = std::max((work + DELTA_WALK_THREADS - 1) / DELTA_WALK_THREADS, static_cast<long long>(ti));
  return static_cast<int>(std::min(want, static_cast<long long>(DELTA_PREF_BLOCKS)));
}

// K7 on the wrapper's plan: the grouping and pair kernel, then the walk and
// the preference blocks; refused where delta_plan_ok refuses the plan (its
// preference blocks delta_pref_blocks' where the statics hold a preference
// weight, else none), or there are pair threads but no pair starts, hints,
// domain lists or pref_seen word
extern "C" int simtpu_delta_apply(const DeltaCtx* ctx, const DeltaPlan* plan, void* stream) {
  const DeltaPlan& q = *plan;
  const DeltaCtx& x = *ctx;
  const long long walkers = static_cast<long long>(x.e) * (x.r + x.p_ports + 2 * x.w + x.v + x.sd + x.gd);
  if (x.work < 0 || !delta_plan_ok(q, x.n, x.e, x.work, walkers, x.pref >= 0 ? delta_pref_blocks(x.work, x.ti) : 0) ||
      (x.work > 0 &&
       (x.pair_start == nullptr || x.pair_hint == nullptr || x.dom_start == nullptr || x.pref_seen == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return delta_launch(delta_apply_kernel, delta_apply_walk_kernel, x, q, static_cast<cudaStream_t>(stream));
}
