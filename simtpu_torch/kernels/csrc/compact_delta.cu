// K13 compact_delta: signed placement-log entries folded straight into the
// compact carried state.
//
// Replaces the JAX package's simtpu/engine/state.py compact_delta_step
// (:1205), scanned by _apply_placement_deltas_compact_fn (:1300, jitted
// as apply_placement_deltas_compact :1312): K7's update (delta_apply.cu)
// retargeted at the compact layout, so preemption's evictions and
// restores need no expand -> K7 -> compress round trip. One call applies
// a whole packed batch (w = +1 re-places, -1 evicts, 0 is padding).
//
// What the reference scans in log order splits in two:
// - the chosen node's rows (free, vg_free, gpu_free in f32, whose adds do
//   not commute bit for bit; sdev_free set or cleared by the sign; ports /
//   vols counts in int32): delta_rows.cuh's update (K7's arithmetic),
//   applied to each node's entries in log order;
// - the count planes: int32 adds of state-independent integer values
//   (s_match, a_anti_req, a_aff_req, w_aff_pref, w_anti_pref times w,
//   truncated per entry as the reference casts them), exact and order-free.
//
// Design (launch plan kernels/cuda.py compact_delta_plan), two kernels a
// call:
// 1. compact_delta_kernel:
//    - blocks 1.. ("pair blocks"): one thread per (entry, term slot)
//      resolves the slot's chain once — term, key row, the chosen node's
//      domain and small bucket, the tabular and dense rows, the five values
//      x w — and adds them with int32 atomics: cnt_total; a tabular row is
//      constant within a domain, so its update is one bucket add at [row,
//      small domain]; a dense row gains the value at every node of the
//      chosen node's domain, read from the domain's node list (dom_start /
//      dom_nodes, built once per node_dom map by the wrapper; a domain id
//      names one key's value): one node for a per-node key, no walk over
//      every node;
//    - block 0 groups the live entries by node, stably, in linear time (a
//      counting sort): the block reads every entry's node once into its
//      scratch and gives each of the batch's nodes a head (its first entry
//      by an atomicMin per entry; the heads in no set order, since each
//      run is walked alone); the entries' chunks of 32 are walked in log
//      order in `segs` contiguous segments at once, a warp a segment:
//      the lanes holding one head's entries find each other through a bit
//      mask of the head's in shared memory (an atomicOr each), take the
//      head's count in the segment so far + their rank among them as their
//      position, and the first moves the count on (the only sequential
//      part: chunks / segs shared-memory round trips); per head a pass over
//      the segments turns its counts into the counts before each segment,
//      a scan of the heads' totals gives the runs' starts, and each entry
//      goes to its run's start + the count before its segment + its
//      position: each node's entries, in log order, one run.
// 2. compact_delta_walk_kernel: one thread per (element of a node's rows,
//    node run), element-major so that a warp's lanes share the element's
//    branches, reads the element once, adds the run's operands in log
//    order (delta_node_operand; the run's entries as (entry, group,
//    weight) words, eight entries' operands loaded together) and writes it
//    once.
// The grouping block's scratch lives in shared memory while it fits in
// WAVE_SMEM, else in the wrapper's global scratch with the runs; only the
// slots of the batch's nodes are reset, so any N and E are taken. Each
// carried element has one writer or exact integer adds.
//
// Bound: bytes — the entries, the touched rows, buckets and dense columns
// read and written once; a preemption wave applies a few hundred entries,
// so the launches' latency and the grouping block's passes dominate.
#include "delta_rows.cuh"
#include "step_ctx.cuh"
#include "wave.cuh"

// threads a block of the grouping and pair kernel at most
constexpr int DELTA_MAX_THREADS = 1024;
// threads a block of the walk (its bound lets a walker hold a chunk of a
// run in registers)
constexpr int DELTA_WALK_THREADS = 256;
// a run's entries whose operands one walker loads together
constexpr int DELTA_RUN_CHUNK = 8;

// The wrapper's launch plan (mirrored by kernels/cuda.py DeltaPlan):
// `pair_blocks` blocks of `threads` (entry, slot) pairs after the grouping
// block, `walk_blocks` blocks of DELTA_WALK_THREADS (element, run)
// walkers; the grouping block's scratch (DeltaGroup) in `smem` bytes of
// shared memory where `shared`, else in `scratch` after the runs
// (DeltaRuns)
struct DeltaPlan {
  int threads, pair_blocks, walk_blocks, segs, shared, smem;
  int* scratch;
};

// The runs in the wrapper's scratch (kernels/cuda.py compact_delta_plan):
// the number of heads; the entries in run order, each as (entry, group,
// weight bits, 0) so that a walker reads one 16-byte word an entry; per
// head its node, run start and count
struct DeltaRuns {
  int* n_heads;
  int4* order;
  int* head_node;
  int* head_start;
  int* head_cnt;
};

__device__ inline DeltaRuns delta_runs(int* scr, int e) {
  int* heads = scr + 4 + 4 * static_cast<size_t>(e);
  return {scr, reinterpret_cast<int4*>(scr + 4), heads, heads + e, heads + 2 * e};
}

// The grouping block's scratch: per segment and head the head's count in
// the segment so far (then the count before the segment) and the lanes of
// the chunk in hand that hold its entries; per node its slot (its first
// entry, then the complement of its head); per entry its node (-1 for
// padding) and its position among its head's entries in its segment; per
// head its node, then its run's length and start; in shared memory while
// 4 N + 12 E + 8 E segments bytes fit in WAVE_SMEM, else in the wrapper's
// scratch after the runs
struct DeltaGroup {
  int* cnt;
  int* mask;
  int* slot;
  int* node;
  int* pos;
  int* head;
};

__device__ inline DeltaGroup delta_group_scratch(int* at, int n, int e, int segs) {
  const size_t table = static_cast<size_t>(segs) * e;
  int* slot = at + 2 * table;
  int* node = slot + n;
  return {at, at + table, slot, node, node + e, node + 2 * e};
}

__device__ inline DeltaRows<int> delta_rows(const CompactCtx& x) {
  return {x.r, x.p, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp, x.ports_req, x.vol_rw_req, x.vol_ro_req,
          x.vol_att_req, x.c_free, x.c_ports_used, x.c_vols_any, x.c_vols_rw, x.c_vg_free, x.c_sdev_free,
          x.c_gpu_free};
}

// (entry e, slot t): the slot's term resolved once, its counts added
__device__ inline void delta_pair(const CompactCtx& x, int e, int t) {
  const float w = x.wgt[e];
  if (w == 0.0f) return;
  const int g = x.g[e];
  const int c = x.node[e] < 0 ? 0 : x.node[e];
  const size_t gt = static_cast<size_t>(g) * x.tc + t;
  const int term = x.g_terms[gt];
  if (term < 0) return;
  const size_t key_row = static_cast<size_t>(x.term_topo[term]) * x.n;
  const int dom = x.node_dom[key_row + c];
  if (dom < 0) return;
  const int s = static_cast<int>((x.s_match[gt] ? 1.0f : 0.0f) * w);
  atomicAdd(&x.c_cnt_total[term], s);
  const int ip = x.ip_of[term];
  int oa = 0, of = 0, wa = 0, wn = 0;
  if (ip >= 0) {
    oa = static_cast<int>((x.a_anti_req[gt] ? 1.0f : 0.0f) * w);
    of = static_cast<int>((x.a_aff_req[gt] ? 1.0f : 0.0f) * w);
    wa = static_cast<int>(x.w_aff_pref[gt] * w);
    wn = static_cast<int>(x.w_anti_pref[gt] * w);
  }
  // tabular rows: one bucket add at the chosen node's small domain
  const int bucket = x.nds[key_row + c];
  if (bucket >= 0) {
    const int tr = x.t_tab_of[term];
    if (tr >= 0) atomicAdd(&x.cm_tab[static_cast<size_t>(tr) * x.d + bucket], s);
    const int ir = ip >= 0 ? x.ip_tab_of[ip] : -1;
    if (ir >= 0) {
      const size_t b = static_cast<size_t>(ir) * x.d + bucket;
      atomicAdd(&x.oa_tab[b], oa);
      atomicAdd(&x.of_tab[b], of);
      atomicAdd(&x.wa_tab[b], wa);
      atomicAdd(&x.wn_tab[b], wn);
    }
  }
  // dense rows: every node of the chosen node's domain
  const int dr = x.t_dense_of[term];
  const int dir = ip >= 0 ? x.ip_dense_of[ip] : -1;
  if (dr < 0 && dir < 0) return;
  const int end = x.dom_start[dom + 1];
  for (int j = x.dom_start[dom]; j < end; ++j) {
    const size_t m = static_cast<size_t>(x.dom_nodes[j]);
    if (dr >= 0) atomicAdd(&x.cm_dense[static_cast<size_t>(dr) * x.n + m], s);
    if (dir >= 0) {
      const size_t b = static_cast<size_t>(dir) * x.n + m;
      atomicAdd(&x.oa_dense[b], oa);
      atomicAdd(&x.of_dense[b], of);
      atomicAdd(&x.wa_dense[b], wa);
      atomicAdd(&x.wn_dense[b], wn);
    }
  }
}

// The exclusive prefix of v over the block's threads in order, and their
// sum in `total`; every thread calls it (three barriers; `wsum` 32 ints)
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < warps ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += r;
    }
    wsum[lane] = t;
  }
  __syncthreads();
  total = wsum[warps - 1];
  const int out = incl - v + (warp > 0 ? wsum[warp - 1] : 0);
  __syncthreads();
  return out;
}

// entries a thread of the grouping block reads or places at once
constexpr int DELTA_GROUP_BATCH = 4;

// Block 0: the live entries grouped by node into runs, in log order, the
// chunks walked in `segs` segments at once
__device__ __forceinline__ void delta_group(const CompactCtx& x, const DeltaGroup& q, const DeltaRuns& u, int segs) {
  constexpr int B = DELTA_GROUP_BATCH;
  __shared__ int s_nh;
  __shared__ int s_wsum[32];
  const int E = x.e;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int chunks = (E + 31) / 32;
  const int per_seg = (chunks + segs - 1) / segs;
  if (threadIdx.x == 0) s_nh = 0;
  // every entry's node (-1 for padding), read once by the block, B entries
  // a thread in flight; the batch's nodes' slots set past every entry, then
  // to each node's first entry
  for (int e0 = threadIdx.x; e0 < E; e0 += B * blockDim.x) {
    int c[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int e = e0 + j * blockDim.x;
      c[j] = e < E && x.wgt[e] != 0.0f ? max(x.node[e], 0) : -1;
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < E) q.node[e] = c[j];
      if (c[j] >= 0) q.slot[c[j]] = E;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    if (q.node[e] >= 0) atomicMin(&q.slot[q.node[e]], e);
  __syncthreads();
  // the heads: each node's first entry takes one (in no set order: a run
  // keeps its node's entries in log order whatever its place) and leaves
  // its complement in the slot, which equals no entry
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int c = q.node[e];
    if (c >= 0 && q.slot[c] == e) {
      const int h = atomicAdd(&s_nh, 1);
      q.head[h] = c;
      q.slot[c] = ~h;
    }
  }
  __syncthreads();
  const int nh = s_nh;
  for (int j = threadIdx.x; j < segs * nh; j += blockDim.x) q.cnt[j] = q.mask[j] = 0;
  __syncthreads();
  // warp s walks segment s's chunks in log order: the lanes holding a
  // head's entries set their bits in its mask, then each takes the head's
  // count so far + its rank among them as its position, and the first
  // moves the count on and clears the mask
  if (warp < segs) {
    int* cnt = q.cnt + static_cast<size_t>(warp) * nh;
    int* mask = q.mask + static_cast<size_t>(warp) * nh;
    const int k1 = min(chunks, (warp + 1) * per_seg);
    for (int k = warp * per_seg; k < k1; ++k) {
      const int e = 32 * k + lane;
      const int c = e < E ? q.node[e] : -1;
      const int h = c >= 0 ? ~q.slot[c] : 0;
      if (c >= 0) atomicOr(mask + h, static_cast<int>(1u << lane));
      __syncwarp();
      const unsigned peers = c >= 0 ? static_cast<unsigned>(mask[h]) : 0u;
      const int so_far = c >= 0 ? cnt[h] : 0;
      if (c >= 0) q.pos[e] = so_far + __popc(peers & lt);
      __syncwarp();
      if (c >= 0 && (peers & lt) == 0) {
        cnt[h] = so_far + __popc(peers);
        mask[h] = 0;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // per head: its counts in the segments into the counts before each (in
  // place), and its run's length in place of its node
  for (int h = threadIdx.x; h < nh; h += blockDim.x) {
    int t = 0;
    for (int s = 0; s < segs; ++s) {
      int* at = q.cnt + static_cast<size_t>(s) * nh + h;
      const int v = *at;
      *at = t;
      t += v;
    }
    u.head_node[h] = q.head[h];
    u.head_cnt[h] = t;
    q.head[h] = t;
  }
  __syncthreads();
  // the runs' starts: an exclusive scan of the runs' lengths, in head
  // order, each in place of its length
  int start = 0;
  for (int h0 = 0; h0 < nh; h0 += blockDim.x) {
    const int h = h0 + threadIdx.x;
    int total;
    const int at = start + block_scan(h < nh ? q.head[h] : 0, s_wsum, total);
    if (h < nh) {
      u.head_start[h] = at;
      q.head[h] = at;
    }
    start += total;
  }
  if (threadIdx.x == 0) *u.n_heads = nh;
  __syncthreads();
  // each entry at its run's start + the count before its segment + its
  // position there, B entries a thread in flight
  for (int e0 = threadIdx.x; e0 < E; e0 += B * blockDim.x) {
    int at[B];
    int4 word[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int e = e0 + j * blockDim.x;
      const int c = e < E ? q.node[e] : -1;
      at[j] = -1;
      if (c >= 0) {
        const int h = ~q.slot[c];
        at[j] = q.head[h] + q.cnt[static_cast<size_t>((e >> 5) / per_seg) * nh + h] + q.pos[e];
        word[j] = make_int4(e, x.g[e], __float_as_int(x.wgt[e]), 0);
      }
    }
#pragma unroll
    for (int j = 0; j < B; ++j)
      if (at[j] >= 0) u.order[at[j]] = word[j];
  }
}

__global__ void __launch_bounds__(DELTA_MAX_THREADS) compact_delta_kernel(CompactCtx x, DeltaPlan p) {
  extern __shared__ __align__(16) int dsm[];
  if (blockIdx.x > 0) {
    const long long j = static_cast<long long>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
    if (j < static_cast<long long>(x.e) * x.tc) delta_pair(x, static_cast<int>(j / x.tc), static_cast<int>(j % x.tc));
    return;
  }
  // one inlined copy a memory space, so that the shared one's accesses are
  // shared-memory instructions
  const DeltaRuns u = delta_runs(p.scratch, x.e);
  if (p.shared)
    delta_group(x, delta_group_scratch(dsm, x.n, x.e, p.segs), u, p.segs);
  else
    delta_group(x, delta_group_scratch(p.scratch + 4 + 7 * static_cast<size_t>(x.e), x.n, x.e, p.segs), u, p.segs);
}

// One thread per (element, run): element i of the run's node's rows, the
// run's operands added in log order between one read and one write
__global__ void __launch_bounds__(DELTA_WALK_THREADS) compact_delta_walk_kernel(CompactCtx x, DeltaPlan p) {
  const DeltaRows<int> rows = delta_rows(x);
  const DeltaRuns u = delta_runs(p.scratch, x.e);
  const int width = delta_node_width(rows);
  // element-major: a warp's lanes take one element of 32 runs, so the
  // element's branches in delta_node_operand are the same across the warp
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int i = static_cast<int>(j / x.e), h = static_cast<int>(j % x.e);
  if (i >= width) return;
  // the run's head read beside the number of heads (every h < E is within
  // the scratch)
  const int nh = *u.n_heads;
  const size_t c = static_cast<size_t>(u.head_node[h]);
  const int4* run = u.order + u.head_start[h];
  const int len = u.head_cnt[h];
  if (h >= nh) return;
  // the element: a float (free, vg_free, gpu_free), an int32 count (ports,
  // vols) or a device byte (sdev_free)
  float* f = nullptr;
  int* n = nullptr;
  uint8_t* b = nullptr;
  int k = i;
  if (k < x.r) f = x.c_free + c * x.r + k;
  else if ((k -= x.r) < x.p) n = x.c_ports_used + c * x.p + k;
  else if ((k -= x.p) < x.w) n = x.c_vols_any + c * x.w + k;
  else if ((k -= x.w) < x.w) n = x.c_vols_rw + c * x.w + k;
  else if ((k -= x.w) < x.v) f = x.c_vg_free + c * x.v + k;
  else if ((k -= x.v) < x.sd) b = x.c_sdev_free + c * x.sd + k;
  else f = x.c_gpu_free + c * x.gd + (k - x.sd);
  float vf = f ? *f : 0.0f;
  int vn = n ? *n : 0;
  bool vb = b ? *b != 0 : false;
  for (int k0 = 0; k0 < len; k0 += DELTA_RUN_CHUNK) {
    float op[DELTA_RUN_CHUNK];
#pragma unroll
    for (int q = 0; q < DELTA_RUN_CHUNK; ++q)
      if (k0 + q < len) {
        const int4 en = run[k0 + q];
        op[q] = delta_node_operand(rows, en.x, en.y, __int_as_float(en.z), i);
      }
#pragma unroll
    for (int q = 0; q < DELTA_RUN_CHUNK; ++q)
      if (k0 + q < len) {
        if (f) vf = vf + op[q];
        else if (n) vn = vn + static_cast<int>(op[q]);
        else vb = op[q] == 1.0f ? false : (op[q] == 2.0f ? true : vb);
      }
  }
  if (f) *f = vf;
  else if (n) *n = vn;
  else *b = vb ? 1 : 0;
}

// K13 on the wrapper's plan: the grouping and pair kernel, then the walk;
// refused where the blocks do not cover the (entry, slot) pairs or the
// (element, entry) walkers, the threads are not whole warps up to
// DELTA_MAX_THREADS, there is no scratch, or the grouping scratch is in
// neither shared memory within the budget nor the scratch
extern "C" int simtpu_compact_delta(const CompactCtx* ctx, const DeltaPlan* plan, void* stream) {
  const DeltaPlan& q = *plan;
  const CompactCtx& x = *ctx;
  const long long pairs = static_cast<long long>(x.e) * x.tc;
  const long long walkers = static_cast<long long>(x.e) * (x.r + x.p + 2 * x.w + x.v + x.sd + x.gd);
  auto covers = [&](int blocks, int threads, long long work) {
    return blocks >= 0 && static_cast<long long>(blocks) * threads >= work &&
           (blocks == 0 || static_cast<long long>(blocks - 1) * threads < work);
  };
  if (q.threads < 32 || q.threads > DELTA_MAX_THREADS || q.threads % 32 != 0 ||
      !covers(q.pair_blocks, q.threads, pairs) || !covers(q.walk_blocks, DELTA_WALK_THREADS, walkers) ||
      q.scratch == nullptr ||
      q.segs < 1 || q.segs > q.threads / 32 ||
      (q.shared ? (q.smem < 4LL * x.n + 4LL * x.e * (3 + 2 * q.segs) || q.smem > WAVE_SMEM) : q.smem != 0) ||
      (pairs > 0 && x.dom_start == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static int attrs = -1;
  if (attrs < 0) attrs = static_cast<int>(cudaFuncSetAttribute(compact_delta_kernel,
                                                               cudaFuncAttributeMaxDynamicSharedMemorySize, WAVE_SMEM));
  if (attrs) return attrs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_delta_kernel<<<1 + q.pair_blocks, q.threads, q.smem, s>>>(x, q);
  if (const int err = launch_status()) return err;
  if (q.walk_blocks > 0) compact_delta_walk_kernel<<<q.walk_blocks, DELTA_WALK_THREADS, 0, s>>>(x, q);
  return launch_status();
}
