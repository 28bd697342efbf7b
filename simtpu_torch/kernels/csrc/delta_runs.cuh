// A signed placement-log batch grouped by node, and each node's rows
// walked in log order: the launch plan, the grouping block and the walk
// shared by K7 `delta_apply` (the dense carry, count planes in f32) and
// K13 `compact_delta` (the compact carry, count planes in int32). Each
// kernel's own part is its pair function: each (entry, term slot)'s chain
// resolved once and its counts added (K13 a thread a pair, K7 a thread per
// node of the pair's domain).
//
// What the reference scans in log order splits in two:
// - the chosen node's rows (free, vg_free, gpu_free in f32, whose adds do
//   not commute bit for bit; sdev_free set or cleared by the sign; ports /
//   vols counts in the plane type C): delta_rows.cuh's update, applied to
//   each node's entries in log order;
// - the count planes, which the pair threads add to (each kernel says why
//   its adds are order-free).
//
// Design (launch plan kernels/cuda.py compact_delta_plan), two kernels a
// call:
// 1. the grouping and pair kernel:
//    - blocks 1.. ("pair blocks"): the pair threads, the kernel's own pair
//      function;
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
// 2. the walk kernel: one thread per (element of a node's rows, node run),
//    element-major so that a warp's lanes share the element's branches,
//    reads the element once, adds the run's operands in log order
//    (delta_node_operand; the run's entries as (entry, group, weight)
//    words, eight entries' operands loaded together) and writes it once.
//    K7 adds `pref_blocks` blocks behind the walkers (delta_apply.cu).
// The grouping block's scratch lives in shared memory while it fits in
// WAVE_SMEM, else in the wrapper's global scratch with the runs; only the
// slots of the batch's nodes are reset, so any N and E are taken.
#pragma once
#include "delta_rows.cuh"
#include "wave.cuh"

// threads a block of the grouping and pair kernel at most
constexpr int DELTA_MAX_THREADS = 1024;
// threads a block of the walk (its bound lets a walker hold a chunk of a
// run in registers)
constexpr int DELTA_WALK_THREADS = 256;
// a run's entries whose operands one walker loads together
constexpr int DELTA_RUN_CHUNK = 8;
// entries a thread of the grouping block reads or places at once
constexpr int DELTA_GROUP_BATCH = 4;

// The wrapper's launch plan (mirrored by kernels/cuda.py DeltaPlan):
// `pair_blocks` blocks of `threads` pair threads after the grouping
// block, `walk_blocks` blocks of DELTA_WALK_THREADS (element, run)
// walkers, then `pref_blocks` more of the walk kernel's size (K7's
// preference planes; 0 for K13); the grouping block's scratch (DeltaGroup)
// in `smem` bytes of shared memory where `shared`, else in `scratch` after
// the runs (DeltaRuns)
struct DeltaPlan {
  int threads, pair_blocks, walk_blocks, pref_blocks, segs, shared, smem;
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

// Block 0: the live entries of `x` (its e, g, node and wgt fields: a
// DeltaCtx or a CompactCtx) grouped by node into runs, in log order, the
// chunks walked in `segs` segments at once
template <typename X>
__device__ __forceinline__ void delta_group(const X& x, const DeltaGroup& q, const DeltaRuns& u, int segs) {
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

// Block 0 of the grouping and pair kernel, its scratch in shared memory
// (`dsm`) or after the runs in the plan's global scratch: one inlined copy
// a memory space, so that the shared one's accesses are shared-memory
// instructions
template <typename X>
__device__ __forceinline__ void delta_group_block(const X& x, const DeltaPlan& p, int* dsm) {
  const DeltaRuns u = delta_runs(p.scratch, x.e);
  if (p.shared)
    delta_group(x, delta_group_scratch(dsm, x.n, x.e, p.segs), u, p.segs);
  else
    delta_group(x, delta_group_scratch(p.scratch + 4 + 7 * static_cast<size_t>(x.e), x.n, x.e, p.segs), u, p.segs);
}

// Walker j of the walk kernel (j = element * E + run): element i of the
// run's node's rows, the run's operands added in log order between one
// read and one write; the count planes of type C take each operand cast to
// C (an f32 operand as it is)
template <typename C>
__device__ __forceinline__ void delta_walk(const DeltaRows<C>& rows, const DeltaPlan& p, int e, long long j) {
  const DeltaRuns u = delta_runs(p.scratch, e);
  const int width = delta_node_width(rows);
  // element-major: a warp's lanes take one element of 32 runs, so the
  // element's branches in delta_node_operand are the same across the warp
  const int i = static_cast<int>(j / e), h = static_cast<int>(j % e);
  if (i >= width) return;
  // the run's head read beside the number of heads (every h < E is within
  // the scratch)
  const int nh = *u.n_heads;
  const size_t c = static_cast<size_t>(u.head_node[h]);
  const int4* run = u.order + u.head_start[h];
  const int len = u.head_cnt[h];
  if (h >= nh) return;
  // the element: a float (free, vg_free, gpu_free), a count of type C
  // (ports, vols) or a device byte (sdev_free)
  float* f = nullptr;
  C* n = nullptr;
  uint8_t* b = nullptr;
  int k = i;
  if (k < rows.r) f = rows.free + c * rows.r + k;
  else if ((k -= rows.r) < rows.p) n = rows.ports_used + c * rows.p + k;
  else if ((k -= rows.p) < rows.w) n = rows.vols_any + c * rows.w + k;
  else if ((k -= rows.w) < rows.w) n = rows.vols_rw + c * rows.w + k;
  else if ((k -= rows.w) < rows.v) f = rows.vg_free + c * rows.v + k;
  else if ((k -= rows.v) < rows.sd) b = rows.sdev_free + c * rows.sd + k;
  else f = rows.gpu_free + c * rows.gd + (k - rows.sd);
  float vf = f ? *f : 0.0f;
  C vn = n ? *n : C(0);
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
        else if (n) vn = vn + static_cast<C>(op[q]);
        else vb = op[q] == 1.0f ? false : (op[q] == 2.0f ? true : vb);
      }
  }
  if (f) *f = vf;
  else if (n) *n = vn;
  else *b = vb ? 1 : 0;
}

// The plan checks shared by both C entries: refused where the blocks do
// not cover the pair threads or the (element, entry) walkers, the
// preference blocks are not `pref_blocks` (K7's count, 0 for K13), the
// threads are not whole warps up to DELTA_MAX_THREADS, there is no
// scratch, or the grouping scratch is in neither shared memory within the
// budget nor the scratch
inline bool delta_plan_ok(const DeltaPlan& q, int n, int e, long long pairs, long long walkers, int pref_blocks) {
  auto covers = [](int blocks, int threads, long long work) {
    return blocks >= 0 && static_cast<long long>(blocks) * threads >= work &&
           (blocks == 0 || static_cast<long long>(blocks - 1) * threads < work);
  };
  return q.threads >= 32 && q.threads <= DELTA_MAX_THREADS && q.threads % 32 == 0 &&
         covers(q.pair_blocks, q.threads, pairs) && covers(q.walk_blocks, DELTA_WALK_THREADS, walkers) &&
         q.pref_blocks == pref_blocks && q.scratch != nullptr && q.segs >= 1 && q.segs <= q.threads / 32 &&
         (q.shared ? (q.smem >= 4LL * n + 4LL * e * (3 + 2 * q.segs) && q.smem <= WAVE_SMEM) : q.smem == 0);
}

// The two kernels of a call on plan `q`: `group_pair` on 1 + pair_blocks
// blocks (the grouping block's shared scratch opted in once per kernel),
// then `walk` on walk_blocks + pref_blocks blocks where there are any
template <typename X>
inline int delta_launch(void (*group_pair)(X, DeltaPlan), void (*walk)(X, DeltaPlan), const X& x,
                        const DeltaPlan& q, cudaStream_t s) {
  static int attrs = -1;
  if (attrs < 0)
    attrs = static_cast<int>(cudaFuncSetAttribute(group_pair, cudaFuncAttributeMaxDynamicSharedMemorySize, WAVE_SMEM));
  if (attrs) return attrs;
  group_pair<<<1 + q.pair_blocks, q.threads, q.smem, s>>>(x, q);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  if (q.walk_blocks + q.pref_blocks > 0) walk<<<q.walk_blocks + q.pref_blocks, DELTA_WALK_THREADS, 0, s>>>(x, q);
  return static_cast<int>(cudaGetLastError());
}
