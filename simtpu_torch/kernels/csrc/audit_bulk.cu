// K8 audit_bulk: the placement auditor's bulk pass.
//
// Replaces the JAX package's simtpu/audit/checker.py _get_bulk_jit (:388),
// the jitted twin of _bulk_flags_numpy (:297): for M placed entries in
// placement order on N nodes, one flag word per entry, bit b set when the
// entry violates class b (simtpu_torch/kernels/audit.py BULK_BITS):
// invalid node / pin, overcommit, host port, exclusive volume, attach
// limit, Open-Local storage, GPU-share memory. Forced (spec.nodeName)
// entries bypass every feasibility bit but the pin bit; their requests
// still count toward later entries' prefixes. All arithmetic is f64, as the
// JAX pass runs under x64; built with -fmad=false, so `a * b + c` is two
// roundings as in numpy.
//
// Design: linear in the log, as the JAX pass (a stable sort and cumsums).
//   1. The entries' stable by-node order, on the card: an LSD radix sort of
//      the node ids (a node outside [0, N) takes the key N), passes of at
//      most AUDIT_MAX_DIGIT_BITS bits (one pass up to 1023 nodes, two up
//      to 2^20). A pass is two kernels: `count` — each block's tile of
//      AUDIT_SORT_TILE entries, each warp a run of them, counts its
//      digits (__match_any_sync: one add per distinct digit of 32 ids),
//      and the last block to finish turns the tiles' counts (stored
//      digit-major, tile order within a digit: the order of the offsets)
//      into offsets with one exclusive scan; `place` — each block counts again and
//      scatters its entries to their offsets, warp by warp in order,
//      32 ids at a time ranked among equal digits by their lane: stable.
//   2. `tails` — each block of AUDIT_SCAN_TILE sorted positions, one a
//      thread, takes for every column of the S = R + P + 2W + V + SD + GD
//      the sum from the tile's last segment start to its end (a segmented
//      scan, one barrier a column); the last block to finish chains them
//      into each tile's carry: the sum of the segment of its first
//      position over the earlier tiles.
//   3. `flags` — the same tiles scan every column again from their carry:
//      each position gets its entry's exclusive prefix on its node (the
//      entries before it in placement order) and checks the entry against
//      it, one column at a time, then writes the entry's flag word. The
//      volumes' on-node bits go through the scratch `onw` for the attach
//      check, which needs every column of a class.
// Every element of every scratch array and every flag word has one writer.
// A node with thousands of entries is spread over the tiles like any
// other: no lane walks a node.
//
// Sum form: the prefix before an entry is a segmented sum along the
// node's entries in placement order, in tree order within a tile and
// chained across tiles. The JAX package takes it as a global cumsum over
// the node-sorted entries less the cumsum at the segment's start; the two
// round differently by far less than the slack (at least 1e-3 absolute),
// so the flag words agree. The count columns (ports, volumes, devices) are
// small integers: exact in any order.
//
// Bound: bytes — the entries' rows and the per-node planes each read once,
// one flag word written per entry; the sort moves 8 bytes an entry a pass
// and the scans read the columns twice. 2 * passes + 2 kernels and one
// memset of the finish counters on the stream. Index products are 64-bit.
// A zero width (P, W, C, V, SD, GD) skips its family: its pointer is never
// read. The launch plan is the wrapper's (kernels/cuda.py audit_plan).
#include "step_ctx.cuh"

constexpr int AUDIT_THREADS = 256;
constexpr int AUDIT_SORT_TILE = 2048;
constexpr int AUDIT_SCAN_TILE = 256;
constexpr int AUDIT_MAX_DIGIT_BITS = 10;

namespace {

constexpr int WARPS = AUDIT_THREADS / 32;
constexpr int BUCKETS_MAX = 1 << AUDIT_MAX_DIGIT_BITS;
// entries of a sort tile each warp ranks, 32 at a time: ITEMS a lane
constexpr int WARP_RUN = AUDIT_SORT_TILE / WARPS;
constexpr int ITEMS = WARP_RUN / 32;
// prefix columns a scan thread loads at a time
constexpr int COLS = 8;
constexpr double EPS_REL = 2e-5;
constexpr double EPS_ABS = 1e-3;
constexpr double ATTACH_EPS = 1e-9;

enum : int {
  B_INVALID_NODE = 0, B_OVERCOMMIT, B_PORT, B_VOLUME, B_ATTACH, B_STORAGE, B_GPU,
};

static_assert(AUDIT_SCAN_TILE == AUDIT_THREADS, "a scan tile holds one sorted position a thread");
static_assert(WARP_RUN % 32 == 0, "a warp ranks whole runs of 32 entries");

}  // namespace

// Mirrored field for field by simtpu_torch/kernels/cuda.py AuditCtx.
struct AuditCtx {
  int n, m, r, p, w, c, v, sd, gd, pad_;
  // per node
  const double* alloc;           // [N, R]
  const uint8_t* node_valid;     // [N]
  const double* attach_limits;   // [N, C]
  const double* vg_avail0;       // [N, V]
  const uint8_t* sdev_free0;     // [N, SD]
  const double* gpu_total;       // [N, GD]
  // per group
  const uint8_t* static_mask;    // [G, N]
  const uint8_t* vol_mask;       // [G, N]
  const uint8_t* ports;          // [G, P]
  const uint8_t* vol_rw;         // [G, W]
  const uint8_t* vol_ro;         // [G, W]
  const uint8_t* vol_att;        // [G, W]
  const double* vol_class_mask;  // [C, W]
  // per entry, placement order
  const int64_t* g;              // [M]
  const int64_t* node;           // [M]
  const int64_t* pin;            // [M]
  const uint8_t* forced;         // [M]
  const double* req;             // [M, R]
  const double* lvm;             // [M, V]
  const uint8_t* sdev;           // [M, SD]
  const double* gpu;             // [M, GD]
  // output
  int* flags;                    // [M]
};

// The launch plan and the scratch (kernels/cuda.py audit_plan; one slab
// the wrapper allocates); mirrored by cuda.py AuditPlan.
struct AuditPlan {
  int passes, digit_bits, sort_tiles, scan_tiles, s, words;
  unsigned* keys;     // [2][M] the node ids in the order of the last pass
  int* vals;          // [2][M] the entries in that order
  int* hist;          // [2^digit_bits][sort_tiles] a tile's digit counts, then its offsets
  double* tail;       // [scan_tiles][S] the sum from a tile's last segment start to its end
  double* carry;      // [scan_tiles][S] the sum of a tile's first segment before the tile
  int* starts;        // [scan_tiles] 1: a segment starts in the tile
  unsigned* onw;      // [words][M] the volumes' on-node bits of each sorted position
  unsigned* done;     // [passes + 1] finished blocks, zeroed by the C entry
};

namespace {

__device__ __forceinline__ bool over_slack(double want, double free) {
  const double slack = EPS_REL * fmax(fabs(free), 1.0) + EPS_ABS;
  return want > free + slack;
}

// the sort key of entry k (pass 0 reads the log, later passes the previous
// pass's order): the node id, N for one outside [0, N)
template <bool FIRST>
__device__ __forceinline__ void sort_item(const AuditCtx& x, const AuditPlan& p, int pass, int k, unsigned& key,
                                          int& val) {
  if (FIRST) {
    const int64_t n = x.node[k];
    key = (n >= 0 && n < x.n) ? static_cast<unsigned>(n) : static_cast<unsigned>(x.n);
    val = k;
  } else {
    const size_t from = static_cast<size_t>((pass - 1) & 1) * x.m;
    key = p.keys[from + k];
    val = p.vals[from + k];
  }
}

// A lane's ITEMS entries of its warp's run (entry base + lane + 32 j),
// every load in flight at once, and their digits (BUCKETS_MAX past the log)
template <bool FIRST>
__device__ inline void load_items(const AuditCtx& x, const AuditPlan& p, int pass, unsigned (&key)[ITEMS],
                                  int (&val)[ITEMS], unsigned (&d)[ITEMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = (1u << p.digit_bits) - 1;
  const int shift = pass * p.digit_bits;
  const int base = blockIdx.x * AUDIT_SORT_TILE + warp * WARP_RUN + lane;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = base + 32 * j;
    key[j] = 0;
    val[j] = 0;
    if (k < x.m) sort_item<FIRST>(x, p, pass, k, key[j], val[j]);
    d[j] = k < x.m ? (key[j] >> shift) & mask : BUCKETS_MAX;
  }
}

// Block's digit counts of its tile, one row per warp: wh[warp][digit]
__device__ inline void count_tile(const unsigned (&d)[ITEMS], int (*wh)[BUCKETS_MAX]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const unsigned peers = __match_any_sync(0xffffffffu, d[j]);
    if (d[j] != BUCKETS_MAX && lane == __ffs(peers) - 1) wh[warp][d[j]] += __popc(peers);
    __syncwarp();
  }
}

// the last block of a kernel to finish (after its writes are fenced)
__device__ inline bool last_block(unsigned* done) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Pass `pass`, part 1: each tile's digit counts; the last block turns them
// into each (digit, tile)'s first position: digits ascending, tiles in
// order within a digit.
template <bool FIRST>
__global__ void __launch_bounds__(AUDIT_THREADS) audit_bulk_count_kernel(AuditCtx x, AuditPlan p, int pass) {
  __shared__ int wh[WARPS][BUCKETS_MAX];
  __shared__ int slots[WARPS];
  const int buckets = 1 << p.digit_bits;
  unsigned key[ITEMS], d[ITEMS];
  int val[ITEMS];
  load_items<FIRST>(x, p, pass, key, val, d);
  for (int q = threadIdx.x; q < WARPS * buckets; q += blockDim.x) wh[q / buckets][q % buckets] = 0;
  __syncthreads();
  count_tile(d, wh);
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += wh[w][b];
    p.hist[static_cast<size_t>(b) * p.sort_tiles + blockIdx.x] = sum;
  }
  if (!last_block(p.done + pass)) return;
  // the digit-major counts are in offset order: one exclusive scan. Each
  // warp takes a contiguous segment, 32 counts at a time (coalesced
  // loads): its total first, the warps' totals scanned across the block,
  // then the segment scanned from that base.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int total = buckets * p.sort_tiles;
  const int seg = (total + WARPS * 32 - 1) / (WARPS * 32) * 32;
  const int lo = min(total, warp * seg), hi = min(total, lo + seg);
  int sum = 0;
#pragma unroll 4
  for (int q = lo + lane; q < hi; q += 32) sum += __ldcg(p.hist + q);
  sum = __reduce_add_sync(0xffffffffu, sum);
  if (lane == 0) slots[warp] = sum;
  __syncthreads();
  int run = 0;
  for (int w = 0; w < warp; ++w) run += slots[w];
#pragma unroll 4
  for (int q0 = lo; q0 < hi; q0 += 32) {
    const int q = q0 + lane;
    const int c = q < hi ? __ldcg(p.hist + q) : 0;
    int inc = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += o;
    }
    if (q < hi) p.hist[q] = run + inc - c;
    run += __shfl_sync(0xffffffffu, inc, 31);
  }
}

// Pass `pass`, part 2: each entry to its place, stably.
template <bool FIRST>
__global__ void __launch_bounds__(AUDIT_THREADS) audit_bulk_place_kernel(AuditCtx x, AuditPlan p, int pass) {
  __shared__ int wh[WARPS][BUCKETS_MAX];
  const int buckets = 1 << p.digit_bits;
  unsigned key[ITEMS], d[ITEMS];
  int val[ITEMS];
  load_items<FIRST>(x, p, pass, key, val, d);
  for (int q = threadIdx.x; q < WARPS * buckets; q += blockDim.x) wh[q / buckets][q % buckets] = 0;
  __syncthreads();
  count_tile(d, wh);
  __syncthreads();
  // each warp's first position of each digit: the tile's offset plus the
  // earlier warps' counts
  for (int b = threadIdx.x; b < buckets; b += blockDim.x) {
    int at = p.hist[static_cast<size_t>(b) * p.sort_tiles + blockIdx.x];
    for (int w = 0; w < WARPS; ++w) {
      const int c = wh[w][b];
      wh[w][b] = at;
      at += c;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t to = static_cast<size_t>(pass & 1) * x.m;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool in = d[j] != BUCKETS_MAX;
    const unsigned peers = __match_any_sync(0xffffffffu, d[j]);
    if (in) {
      const int at = wh[warp][d[j]] + __popc(peers & ((1u << lane) - 1));
      p.keys[to + at] = key[j];
      p.vals[to + at] = val[j];
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) wh[warp][d[j]] += __popc(peers);
    __syncwarp();
  }
}

// column c of entry e of group g, in the order R requests, P ports,
// W volumes held (rw, ro or attached), W volumes held read-write, V LVM
// sizes, SD devices, GD GPU memory
__device__ inline double column(const AuditCtx& x, size_t e, size_t g, int c) {
  if (c < x.r) return x.req[e * x.r + c];
  c -= x.r;
  if (c < x.p) return x.ports[g * x.p + c] ? 1.0 : 0.0;
  c -= x.p;
  if (c < x.w) {
    const size_t gw = g * x.w + c;
    return (x.vol_rw[gw] || x.vol_ro[gw] || x.vol_att[gw]) ? 1.0 : 0.0;
  }
  c -= x.w;
  if (c < x.w) return x.vol_rw[g * x.w + c] ? 1.0 : 0.0;
  c -= x.w;
  if (c < x.v) return x.lvm[e * x.v + c];
  c -= x.v;
  if (c < x.sd) return x.sdev[e * x.sd + c] ? 1.0 : 0.0;
  c -= x.sd;
  return x.gpu[e * x.gd + c];
}

// Warp-wide segmented scan: (iv, f) become the inclusive sum of the
// lane's segment within the warp and whether a segment starts at or before
// it in the warp
__device__ inline void warp_seg_scan(double& iv, int& f) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const double ov = __shfl_up_sync(0xffffffffu, iv, d);
    const int of = __shfl_up_sync(0xffffffffu, f, d);
    if (lane >= d) {
      if (!f) iv = ov + iv;
      f |= of;
    }
  }
}

// Block-wide segmented scan of one value a thread (thread order = sorted
// order; `start`: a segment starts here), from `carry`, the sum of the
// first segment before the tile: returns the exclusive sum of the
// thread's segment before it, `inc` the inclusive one. `sv` / `sf` hold
// WARPS slots; one barrier (the caller alternates two slot arrays).
__device__ inline double seg_scan(double v, bool start, double carry, double* sv, int* sf, double& inc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double iv = v;
  int f = start ? 1 : 0;
  warp_seg_scan(iv, f);
  if (lane == 31) {
    sv[warp] = iv;
    sf[warp] = f;
  }
  __syncthreads();
  // the inclusive sum at the end of the previous warp
  double pv = carry;
  for (int w = 0; w < warp; ++w) pv = sf[w] ? sv[w] : pv + sv[w];
  inc = f ? iv : pv + iv;
  const double prev = __shfl_up_sync(0xffffffffu, inc, 1);
  return start ? 0.0 : (lane == 0 ? pv : prev);
}

// the sorted position of this thread: its node (N: none), its entry,
// whether a segment starts at it
struct Position {
  int q, n, e;
  bool in, start;
};

__device__ inline Position position(const AuditCtx& x, const AuditPlan& p) {
  const size_t at = static_cast<size_t>((p.passes - 1) & 1) * x.m;
  Position s;
  s.q = blockIdx.x * AUDIT_SCAN_TILE + threadIdx.x;
  s.in = s.q < x.m;
  s.n = s.in ? static_cast<int>(p.keys[at + s.q]) : x.n;
  s.e = s.in ? p.vals[at + s.q] : 0;
  s.start = s.in && (s.q == 0 || static_cast<int>(p.keys[at + s.q - 1]) != s.n);
  return s;
}

// Each tile's per-column tail and whether a segment starts in it; the last
// block chains them into each tile's carry.
__global__ void __launch_bounds__(AUDIT_THREADS) audit_bulk_tails_kernel(AuditCtx x, AuditPlan p) {
  __shared__ double sv[2][WARPS];
  __shared__ int sf[2][WARPS];
  const Position s = position(x, p);
  const bool live = s.in && s.n < x.n;
  const size_t g = live ? static_cast<size_t>(x.g[s.e]) : 0;
  const int last = min(x.m, (blockIdx.x + 1) * AUDIT_SCAN_TILE) - 1;
  const int any = __syncthreads_or(s.start);
  if (threadIdx.x == 0) p.starts[blockIdx.x] = any;
  for (int c0 = 0; c0 < p.s; c0 += COLS) {
    double v[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) v[k] = live && c0 + k < p.s ? column(x, s.e, g, c0 + k) : 0.0;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = c0 + k;
      if (c >= p.s) break;
      double inc;
      seg_scan(v[k], s.start, 0.0, sv[c & 1], sf[c & 1], inc);
      if (s.q == last) p.tail[static_cast<size_t>(blockIdx.x) * p.s + c] = inc;
    }
  }
  if (!last_block(p.done + p.passes)) return;
  // one warp a column: the tiles' tails scanned 32 at a time, segmented at
  // the tiles where a segment starts; a tile's carry is the inclusive sum
  // through the tile before it
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < p.s; c += WARPS) {
    double run = 0.0;
    for (int t0 = 0; t0 < p.scan_tiles; t0 += 32) {
      const int t = t0 + lane;
      const size_t at = static_cast<size_t>(t) * p.s + c;
      double iv = t < p.scan_tiles ? __ldcg(p.tail + at) : 0.0;
      int f = t < p.scan_tiles ? __ldcg(p.starts + t) : 0;
      warp_seg_scan(iv, f);
      const double inc = f ? iv : run + iv;
      const double prev = __shfl_up_sync(0xffffffffu, inc, 1);
      if (t < p.scan_tiles) p.carry[at] = lane == 0 ? run : prev;
      run = __shfl_sync(0xffffffffu, inc, 31);
    }
  }
}

// Each entry's prefix on its node, column by column, and its flag word.
__global__ void __launch_bounds__(AUDIT_THREADS) audit_bulk_flags_kernel(AuditCtx x, AuditPlan p) {
  __shared__ double sv[2][WARPS];
  __shared__ int sf[2][WARPS];
  const Position s = position(x, p);
  const bool live = s.in && s.n < x.n;
  const size_t e = static_cast<size_t>(s.e), nr = static_cast<size_t>(live ? s.n : 0);
  const size_t g = live ? static_cast<size_t>(x.g[e]) : 0;
  const bool forced = live && x.forced[e] != 0;
  const bool soft = live && !forced;
  int bits = 0;
  if (live) {
    const int n = s.n;
    const int64_t pin = x.pin[e];
    const bool nv = x.node_valid[n] != 0;
    bool bad;
    if (forced) {
      bad = !(pin >= 0 && n == pin && nv);
    } else {
      const size_t gn = g * x.n + n;
      const bool ok_static = x.static_mask[gn] && x.vol_mask[gn];
      const bool pin_ok = pin >= 0 ? n == pin : pin > -2;
      bad = !(ok_static && pin_ok && nv);
    }
    if (bad) bits |= 1 << B_INVALID_NODE;
  }
  const double* carry = p.carry + static_cast<size_t>(blockIdx.x) * p.s;
  unsigned word = 0;
  for (int c0 = 0; c0 < p.s; c0 += COLS) {
    // COLS columns' values and carries loaded at a time
    double vs[COLS], cs[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      vs[k] = live && c0 + k < p.s ? column(x, e, g, c0 + k) : 0.0;
      cs[k] = c0 + k < p.s ? carry[c0 + k] : 0.0;
    }
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int c = c0 + q;
      if (c >= p.s) break;
      const double v = vs[q];
      double inc;
      const double pre = seg_scan(v, s.start, cs[q], sv[c & 1], sf[c & 1], inc);
      if (!live) continue;
      int k = c;
      if (k < x.r) {
        if (soft && over_slack(v, x.alloc[nr * x.r + k] - pre)) bits |= 1 << B_OVERCOMMIT;
        continue;
      }
      k -= x.r;
      if (k < x.p) {
        if (soft && v > 0.0 && pre > 0.0) bits |= 1 << B_PORT;
        continue;
      }
      k -= x.p;
      if (k < x.w) {
        const bool on = pre > 0.0;
        if (soft && on && x.vol_rw[g * x.w + k]) bits |= 1 << B_VOLUME;
        word |= (on ? 1u : 0u) << (k & 31);
        if ((k & 31) == 31 || k == x.w - 1) {
          p.onw[static_cast<size_t>(k >> 5) * x.m + s.q] = word;
          word = 0;
        }
        continue;
      }
      k -= x.w;
      if (k < x.w) {
        if (soft && pre > 0.0 && x.vol_ro[g * x.w + k]) bits |= 1 << B_VOLUME;
        continue;
      }
      k -= x.w;
      if (k < x.v) {
        if (soft && over_slack(v, x.vg_avail0[nr * x.v + k] - pre)) bits |= 1 << B_STORAGE;
        continue;
      }
      k -= x.v;
      if (k < x.sd) {
        if (soft && v > 0.0 && (!x.sdev_free0[nr * x.sd + k] || pre > 0.0)) bits |= 1 << B_STORAGE;
        continue;
      }
      k -= x.sd;
      if (soft && over_slack(v, x.gpu_total[nr * x.gd + k] - pre)) bits |= 1 << B_GPU;
    }
  }
  if (!s.in) return;
  // attach limits: per class, the volumes on the node and the entry's new
  // ones against the node's limit
  if (soft && x.w) {
    bool attach = false;
    for (int c = 0; c < x.c && !attach; ++c) {
      double used_c = 0.0, new_c = 0.0;
      for (int w = 0; w < x.w; ++w) {
        const double cm = x.vol_class_mask[static_cast<size_t>(c) * x.w + w];
        const bool on = (p.onw[static_cast<size_t>(w >> 5) * x.m + s.q] >> (w & 31)) & 1u;
        if (on)
          used_c += cm;
        else if (x.vol_att[g * x.w + w])
          new_c += cm;
      }
      attach = new_c > 0.0 && used_c + new_c > x.attach_limits[nr * x.c + c] + ATTACH_EPS;
    }
    if (attach) bits |= 1 << B_ATTACH;
  }
  x.flags[e] = bits;
}

}  // namespace

extern "C" int simtpu_audit_bulk(const AuditCtx* ctx, const AuditPlan* plan, void* stream) {
  if (ctx->m <= 0) return 0;
  const AuditPlan& p = *plan;
  // the launch follows the wrapper's plan; one that does not cover the
  // node ids and the log is refused
  if (p.passes < 1 || p.digit_bits < 1 || p.digit_bits > AUDIT_MAX_DIGIT_BITS ||
      p.passes * p.digit_bits < 32 - __builtin_clz(static_cast<unsigned>(ctx->n) | 1u) ||
      p.sort_tiles != (ctx->m + AUDIT_SORT_TILE - 1) / AUDIT_SORT_TILE ||
      p.scan_tiles != (ctx->m + AUDIT_SCAN_TILE - 1) / AUDIT_SCAN_TILE ||
      p.s != ctx->r + ctx->p + 2 * ctx->w + ctx->v + ctx->sd + ctx->gd || p.words != (ctx->w + 31) / 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(p.done, 0, sizeof(unsigned) * (p.passes + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int pass = 0; pass < p.passes; ++pass) {
    if (pass == 0) {
      audit_bulk_count_kernel<true><<<p.sort_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p, pass);
      audit_bulk_place_kernel<true><<<p.sort_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p, pass);
    } else {
      audit_bulk_count_kernel<false><<<p.sort_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p, pass);
      audit_bulk_place_kernel<false><<<p.sort_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p, pass);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  audit_bulk_tails_kernel<<<p.scan_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p);
  audit_bulk_flags_kernel<<<p.scan_tiles, AUDIT_THREADS, 0, st>>>(*ctx, p);
  return launch_status();
}
