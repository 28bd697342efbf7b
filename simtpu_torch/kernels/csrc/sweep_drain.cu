// K18 sweep_drain: the drain of every scenario of a fault-sweep chunk, on
// a grid of scenarios x node tiles.
//
// Replaces the per-scenario delta scan inside the JAX package's
// simtpu/faults/sweep.py _fault_sweep (:68-70) — lax.scan of
// simtpu/engine/state.py placement_delta_step (:339) under jax.vmap —
// together with the broadcast of the shared base carry into the vmapped
// replicas. With no entries it is the broadcast alone, which the batched
// capacity sweep (simtpu/parallel/sweep.py _sweep_scan :49) needs.
//
// Bound: bytes — S replicas of the dense carry written once and the base
// read S times (it stays in the 50 MB L2 across the S reads: the grid's
// fastest axis is the scenario, so the S blocks of one tile read the same
// base bytes close together); the entries' few rows are noise beside them.
//
// Design: the drain separates by node. Every element an entry writes is in
// one node's column — node c's own rows (delta_rows.cuh, shared with K7 and
// K13) and the count columns of the nodes that share c's domain on one of
// the entry's terms — except the replica's cnt_total [T]. So block (s, j)
//   1. stages the first run of scenario s's entries (SweepCtx.idx row s:
//      rows of the whole placement log, packed once; -1 = padding, which
//      only trails) and asks L2 for the rows the run's staging reads next,
//      before any block's copy fills the memory's queues;
//   2. copies node tile j's part of every plane of replica s from the base
//      carry (read only), 16 bytes a thread where source and destination
//      allow it (4 or 1 at the edges and where they do not: the u8
//      sdev_free plane, planes whose size is no multiple of 16 bytes), with
//      stores that evict first, so the base carry stays in L2;
//   3. walks the entries in log order on the tile's nodes, each element
//      read once per run (in the first from the base carry, in L2), its
//      increments added in a register in log order, written once: the
//      entries' own nodes' rows one element a thread (a scenario's entries
//      mostly name the same few failed nodes), the count rows by node
//      through the run's (entry, term) pairs ranked by (key, domain, term,
//      log order) on the staged fields (no field cut to pack a key: any
//      number of topology keys, domains and terms), where a node finds the pairs of
//      its own domains by binary search, first its key's run and then its
//      domain's inside it; the tile-0 block updates cnt_total, one thread
//      a term.
// A w = 0 entry is skipped (in JAX its device mask is zeroed, so it is an
// exact no-op there too). Each element has one writer and its f32 adds
// happen in log order, bit for bit JAX's sequential scan: no atomics. (A
// read that misses L2 while the copies fill the memory's queues waits
// behind them, up to hundreds of microseconds: hence the staging before
// the copy, the reads from the base and the one read per element.)
//
// The launch plan is the wrapper's (simtpu_torch/kernels/cuda.py
// sweep_drain_plan): SweepCtx.threads threads a block, SweepCtx.npt nodes
// a tile, tiles enough that the main paths' chunks put at least
// DRAIN_BLOCKS_PER_SM blocks on every SM (one more fits, so they run in
// one wave); SweepCtx.pod_words entries staged at a time in SweepCtx.smem
// shared bytes.
#include "delta_rows.cuh"
#include "step_ctx.cuh"

constexpr int DRAIN_THREADS = 256;
constexpr int DRAIN_MIN_TILE = 64;
constexpr int DRAIN_BLOCKS_PER_SM = 2;
// the entries staged in shared memory at a time at most, and the words
// the staging may take (48 KB: no opt-in attribute); where one entry of a
// group's term columns takes more, one entry at a time in up to
// DRAIN_SMEM_MAX shared bytes (opt-in), and past that in the block's slab
// of global scratch (SweepCtx.slab; kernels/cuda.py sweep_drain_plan)
constexpr int DRAIN_STAGE_ENTRIES = 64;
constexpr int DRAIN_STAGE_WORDS = 12 * 1024;
constexpr int DRAIN_SMEM_MAX = 200 * 1024;

// term rows of a node a walk reads before it writes them
constexpr int DRAIN_RUNS = 2;

// shared words of `en` staged entries of a group with tc term columns, on
// node rows `width` elements wide: 5 per entry, 10 per (entry, term), one
// per (entry, element)
__host__ __device__ inline int drain_stage_words(int en, int tc, int width) {
  return en * (5 + 10 * tc + width);
}

namespace {

__device__ inline void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// the replicas are written once and not read again by this launch: stores
// that evict first, so the base carry and the staged reads keep L2
__device__ inline void st_stream(uint4* p, const uint4& v) { __stcs(p, v); }
__device__ inline void st_stream(unsigned* p, unsigned v) { __stcs(p, v); }
__device__ inline void st_stream(uint8_t* p, uint8_t v) { *p = v; }


// rows x bytes_row bytes, row r at src + r * stride / dst + r * stride,
// copied by the block in units of U where dst and src share their offset
// modulo sizeof(U) (and so does every row: stride % sizeof(U) == 0); the
// head and tail of each row bytewise
template <typename U>
__device__ inline void copy_rows_as(uint8_t* dst, const uint8_t* src, int rows, size_t stride, size_t bytes_row) {
  constexpr size_t A = sizeof(U);
  const size_t head = min(bytes_row, (A - (reinterpret_cast<uintptr_t>(dst) & (A - 1))) & (A - 1));
  const size_t body = (bytes_row - head) / A;
  const size_t tail = bytes_row - head - body * A;
  const size_t edge = head + tail;
  // the units: (row, unit) flattened, the row found by stepping; four
  // loads in flight a thread before their stores
  const size_t total = static_cast<size_t>(rows) * body;
  if (total) {
    const size_t bd = blockDim.x;
    size_t row = threadIdx.x / body, u = threadIdx.x % body;
    const size_t step_r = bd / body, step_u = bd % body;
    for (size_t q = threadIdx.x; q < total; q += 4 * bd) {
      U v[4];
      size_t off[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        off[k] = row * stride + head + u * A;
        if (q + k * bd < total) v[k] = __ldg(reinterpret_cast<const U*>(src + off[k]));
        row += step_r;
        u += step_u;
        if (u >= body) {
          u -= body;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q + k * bd < total) st_stream(reinterpret_cast<U*>(dst + off[k]), v[k]);
    }
  }
  if (edge)
    for (size_t q = threadIdx.x; q < static_cast<size_t>(rows) * edge; q += blockDim.x) {
      const size_t row = q / edge, e = q % edge;
      const size_t off = row * stride + (e < head ? e : head + body * A + (e - head));
      dst[off] = __ldg(src + off);
    }
}

__device__ inline void copy_rows(void* dst, const void* src, int rows, size_t stride, size_t bytes_row) {
  if (rows <= 0 || bytes_row == 0) return;
  auto d = static_cast<uint8_t*>(dst);
  auto s = static_cast<const uint8_t*>(src);
  const uintptr_t mis = reinterpret_cast<uintptr_t>(d) ^ reinterpret_cast<uintptr_t>(s);
  if ((mis & 15) == 0 && (rows == 1 || stride % 16 == 0))
    copy_rows_as<uint4>(d, s, rows, stride, bytes_row);
  else if ((mis & 3) == 0 && (rows == 1 || stride % 4 == 0))
    copy_rows_as<unsigned>(d, s, rows, stride, bytes_row);
  else
    copy_rows_as<uint8_t>(d, s, rows, stride, bytes_row);
}

// SLAB: the plan stages in the block's slab of global scratch (a build
// for each, so that the shared staging stays shared-typed)
template <bool SLAB>
__global__ void __launch_bounds__(DRAIN_THREADS, DRAIN_BLOCKS_PER_SM + 1) sweep_drain_kernel(DeltaCtx x, SweepCtx w) {
  const int s = blockIdx.x;
  const int N = x.n;
  const int n0 = blockIdx.y * w.npt;
  const int n1 = min(N, n0 + w.npt);
  const int tn = max(0, n1 - n0);
  const size_t sn = static_cast<size_t>(s) * N;
  const size_t t_n = static_cast<size_t>(w.t) * N;
  const size_t ti_n = static_cast<size_t>(w.ti) * N;
  // replica s of every plane
  float* free = x.free + sn * x.r;
  float* cnt_match = x.cnt_match + static_cast<size_t>(s) * t_n;
  float* cnt_total = x.cnt_total + static_cast<size_t>(s) * w.t;
  float* own_anti = x.cnt_own_anti + static_cast<size_t>(s) * ti_n;
  float* own_aff = x.cnt_own_aff + static_cast<size_t>(s) * ti_n;
  float* aff_pref = x.w_own_aff_pref + static_cast<size_t>(s) * ti_n;
  float* anti_pref = x.w_own_anti_pref + static_cast<size_t>(s) * ti_n;
  float* vg_free = x.vg_free + sn * x.v;
  uint8_t* sdev_free = x.sdev_free + sn * x.sd;
  float* gpu_free = x.gpu_free + sn * x.gd;
  float* ports_used = x.ports_used + sn * x.p_ports;
  float* vols_any = x.vols_any + sn * x.w;
  float* vols_rw = x.vols_rw + sn * x.w;
  const bool total_owner = blockIdx.y == 0;

  // The staged run: per entry its node, weight, row, group, whether it is
  // the first staged entry on its node and its operands on its node's rows
  // (delta_rows.cuh); per (entry, term) pair its key, the domain of the
  // entry's node on it (-1: no count moves, also for a w = 0 entry), the
  // term, the interpod row, its sort rank and the five increments (each
  // incidence or weight times w: the products the sequential scan adds).
  extern __shared__ __align__(16) unsigned long long stage_smem[];
  __shared__ int s_moves;  // the staged run's pairs that move a count
  unsigned long long* stage =
      SLAB ? reinterpret_cast<unsigned long long*>(
                 w.slab + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * w.slab_stride)
           : stage_smem;
  const DeltaRows<float> rows{x.r, x.p_ports, x.w, x.v, x.sd, x.gd, x.req, x.vg, x.sd_take, x.gp,
                              x.ports_req, x.vol_rw_req, x.vol_ro_req, x.vol_att_req, free,
                              ports_used, vols_any, vols_rw, vg_free, sdev_free, gpu_free};
  const int tc = x.tc, en = w.pod_words, width = delta_node_width(rows);
  const int pn = en * tc;
  // [pn] (domain, key, term, interpod row) of each pair, (-1, -1) where it
  // moves no count: the rank pass reads a pair's sort fields in one
  // 16-byte load
  int4* t_pair = reinterpret_cast<int4*>(stage);
  int* t_order = reinterpret_cast<int*>(t_pair + pn);  // [pn] the pair of each sort rank
  float* t_inc = reinterpret_cast<float*>(t_order + pn);  // [5][pn]
  int* e_c = reinterpret_cast<int*>(t_inc + 5 * pn);
  float* e_w = reinterpret_cast<float*>(e_c + en);
  int* e_e = e_c + 2 * en;
  int* e_g = e_c + 3 * en;
  int* e_first = e_c + 4 * en;
  float* e_op = reinterpret_cast<float*>(e_c + 5 * en);  // [en][width]
  const int* idx = w.idx + static_cast<size_t>(s) * w.cols;
  // the pairs' order: by (key, domain, term, log order), the key and the
  // domain (both below 2^31) compared as one 64-bit word, key high: no
  // field is cut. A pair that moves no count (no domain: no term, or w = 0)
  // has both at -1, so its word is the largest and it sorts after every
  // pair that moves one.
  auto kd = [](const int4& a) {
    return (static_cast<unsigned long long>(static_cast<unsigned>(a.y)) << 32) | static_cast<unsigned>(a.x);
  };
  auto before = [&](const int4& a, int p2, const int4& b, int p) {
    const unsigned long long ka = kd(a), kb = kd(b);
    return ka < kb || (ka == kb && (a.z < b.z || (a.z == b.z && p2 < p)));
  };
  // the first rank in [lo, hi) whose pair is not below the bound: a key
  // above kk; a domain of at least d (in kk's run)
  auto first = [&](int lo, int hi, auto below) {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (below(t_order[mid])) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  // the entries' node, weight, row and group, staged; each thread also
  // asks L2 for the lines the run's later staging reads of that entry
  auto stage_entries = [&](int k0, int kn) {
    for (int k = threadIdx.x; k < kn; k += blockDim.x) {
      const int e = idx[k0 + k];
      e_e[k] = e;
      if (e < 0) {
        e_w[k] = 0.0f;
        e_g[k] = e_c[k] = 0;
        continue;
      }
      const int g = x.g[e];
      e_w[k] = x.wgt[e];
      e_g[k] = g;
      e_c[k] = x.node[e] < 0 ? 0 : x.node[e];
      const size_t er = static_cast<size_t>(e), gr = static_cast<size_t>(g);
      prefetch_l2(x.req + er * x.r);
      if (x.v) prefetch_l2(x.vg + er * x.v);
      if (x.sd) prefetch_l2(x.sd_take + er * x.sd);
      if (x.gd) prefetch_l2(x.gp + er * x.gd);
      if (x.p_ports) prefetch_l2(x.ports_req + gr * x.p_ports);
      if (x.w) {
        prefetch_l2(x.vol_rw_req + gr * x.w);
        prefetch_l2(x.vol_ro_req + gr * x.w);
        prefetch_l2(x.vol_att_req + gr * x.w);
      }
      if (tc) {
        prefetch_l2(x.g_terms + gr * tc);
        prefetch_l2(x.s_match + gr * tc);
        prefetch_l2(x.a_anti_req + gr * tc);
        prefetch_l2(x.a_aff_req + gr * tc);
        prefetch_l2(x.w_aff_pref + gr * tc);
        prefetch_l2(x.w_anti_pref + gr * tc);
      }
    }
  };
  // 1. the first run's entries, and the term tables into L2, before the
  // copy: the reads are issued while the memory is quiet
  stage_entries(0, min(en, w.cols));
  for (size_t q = threadIdx.x * 32; q < static_cast<size_t>(w.t); q += blockDim.x * 32) {
    prefetch_l2(x.term_topo + q);
    prefetch_l2(x.ip_of + q);
  }
  // 2. the tile's part of the base carry: node-major planes [N, X] are one
  // span each, term-major planes [T, N] one row segment per term
  {
    const size_t f4 = sizeof(float);
    copy_rows(free + static_cast<size_t>(n0) * x.r, w.free + static_cast<size_t>(n0) * x.r, 1, 0,
              static_cast<size_t>(tn) * x.r * f4);
    copy_rows(vg_free + static_cast<size_t>(n0) * x.v, w.vg_free + static_cast<size_t>(n0) * x.v, 1, 0,
              static_cast<size_t>(tn) * x.v * f4);
    copy_rows(sdev_free + static_cast<size_t>(n0) * x.sd, w.sdev_free + static_cast<size_t>(n0) * x.sd, 1, 0,
              static_cast<size_t>(tn) * x.sd);
    copy_rows(gpu_free + static_cast<size_t>(n0) * x.gd, w.gpu_free + static_cast<size_t>(n0) * x.gd, 1, 0,
              static_cast<size_t>(tn) * x.gd * f4);
    copy_rows(ports_used + static_cast<size_t>(n0) * x.p_ports, w.ports_used + static_cast<size_t>(n0) * x.p_ports,
              1, 0, static_cast<size_t>(tn) * x.p_ports * f4);
    copy_rows(vols_any + static_cast<size_t>(n0) * x.w, w.vols_any + static_cast<size_t>(n0) * x.w, 1, 0,
              static_cast<size_t>(tn) * x.w * f4);
    copy_rows(vols_rw + static_cast<size_t>(n0) * x.w, w.vols_rw + static_cast<size_t>(n0) * x.w, 1, 0,
              static_cast<size_t>(tn) * x.w * f4);
    const size_t row_b = static_cast<size_t>(N) * f4;
    copy_rows(cnt_match + n0, w.cnt_match + n0, w.t, row_b, static_cast<size_t>(tn) * f4);
    copy_rows(own_anti + n0, w.cnt_own_anti + n0, w.ti, row_b, static_cast<size_t>(tn) * f4);
    copy_rows(own_aff + n0, w.cnt_own_aff + n0, w.ti, row_b, static_cast<size_t>(tn) * f4);
    copy_rows(aff_pref + n0, w.w_own_aff_pref + n0, w.ti, row_b, static_cast<size_t>(tn) * f4);
    copy_rows(anti_pref + n0, w.w_own_anti_pref + n0, w.ti, row_b, static_cast<size_t>(tn) * f4);
    if (total_owner) copy_rows(cnt_total, w.cnt_total, 1, 0, static_cast<size_t>(w.t) * f4);
  }
  __syncthreads();

  // 3. the walk, run by run (the later runs staged here, read from the
  // replica the earlier ones wrote)
  for (int k0 = 0; k0 < w.cols; k0 += en) {
    const int kn = min(en, w.cols - k0);
    if (k0 > 0) stage_entries(k0, kn);
    if (threadIdx.x == 0) s_moves = 0;
    __syncthreads();
    // the entries end at the first padding column
    int kv = kn;
    for (int k = 0; k < kn; ++k)
      if (e_e[k] < 0) {
        kv = k;
        break;
      }
    for (int k = threadIdx.x; k < kv; k += blockDim.x) {
      bool first = true;
      for (int k2 = 0; k2 < k && first; ++k2) first = e_c[k2] != e_c[k];
      e_first[k] = first ? 1 : 0;
    }
    for (int q = threadIdx.x; q < kv * width; q += blockDim.x) {
      const int k = q / width, i = q - k * width;
      e_op[q] = e_w[k] == 0.0f ? 0.0f : delta_node_operand(rows, e_e[k], e_g[k], e_w[k], i);
    }
    const int pv = kv * tc;
    int moving = 0;
    for (int p = threadIdx.x; p < pv; p += blockDim.x) {
      const int k = p / tc, t = p - k * tc;
      const float wt = e_w[k];
      const size_t gt = static_cast<size_t>(e_g[k]) * tc + t;
      const int term = x.g_terms[gt];
      int key = 0, dc = -1, ip = -1;
      float inc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (term >= 0) {
        key = x.term_topo[term];
        dc = x.node_dom[static_cast<size_t>(key) * N + e_c[k]];
        ip = x.ip_of[term];
        inc[0] = (x.s_match[gt] ? 1.0f : 0.0f) * wt;
        inc[1] = (x.a_anti_req[gt] ? 1.0f : 0.0f) * wt;
        inc[2] = (x.a_aff_req[gt] ? 1.0f : 0.0f) * wt;
        inc[3] = x.w_aff_pref[gt] * wt;
        inc[4] = x.w_anti_pref[gt] * wt;
      }
      const bool moves = wt != 0.0f && dc >= 0;
      moving += moves ? 1 : 0;
      t_pair[p] = make_int4(moves ? dc : -1, moves ? key : -1, term, ip);
      for (int q = 0; q < 5; ++q) t_inc[q * pn + p] = inc[q];
    }
    if (moving) atomicAdd(&s_moves, moving);
    __syncthreads();
    // each moving pair's rank in that order (no pair that moves nothing
    // comes before it, so it is its rank among the moving pairs); the rest
    // are never walked
    for (int p = threadIdx.x; p < pv; p += blockDim.x) {
      const int4 b = t_pair[p];
      if (b.x < 0) continue;
      int rank = 0;
      for (int p2 = 0; p2 < pv; ++p2) rank += before(t_pair[p2], p2, b, p) ? 1 : 0;
      t_order[rank] = p;
    }
    const bool first_run = k0 == 0;
    __syncthreads();
    const int moves = s_moves;

    // the entries' own nodes' rows, one thread per element of a node's rows
    for (int k = 0; k < kv; ++k) {
      const int c = e_c[k];
      if (!e_first[k] || c < n0 || c >= n1) continue;
      for (int i = threadIdx.x; i < width; i += blockDim.x) {
        float* f;
        uint8_t* bt;
        delta_node_at(free, ports_used, vols_any, vols_rw, vg_free, sdev_free, gpu_free, rows, c, i, f, bt);
        float v;
        if (first_run) {
          const float* bf;
          const uint8_t* bb;
          delta_node_at(w.free, w.ports_used, w.vols_any, w.vols_rw, w.vg_free, w.sdev_free, w.gpu_free, rows, c,
                        i, bf, bb);
          v = bf ? __ldg(bf) : (__ldg(bb) ? 1.0f : 0.0f);
        } else {
          v = f ? *f : (*bt ? 1.0f : 0.0f);
        }
        for (int k2 = k; k2 < kv; ++k2) {
          if (e_c[k2] != c || e_w[k2] == 0.0f) continue;
          const float op = e_op[k2 * width + i];
          v = f ? v + op : (op == 1.0f ? 0.0f : (op == 2.0f ? 1.0f : v));
        }
        if (f)
          *f = v;
        else
          *bt = v != 0.0f ? 1 : 0;
      }
    }
    // same-domain counts: node n gains each pair's increments where it
    // shares the pair's domain on the pair's key; DRAIN_RUNS term rows at
    // a time, their reads in flight together (distinct terms, distinct rows)
    const float* src_match = first_run ? w.cnt_match : cnt_match;
    const float* src_own[4] = {first_run ? w.cnt_own_anti : own_anti, first_run ? w.cnt_own_aff : own_aff,
                               first_run ? w.w_own_aff_pref : aff_pref, first_run ? w.w_own_anti_pref : anti_pref};
    float* dst_own[4] = {own_anti, own_aff, aff_pref, anti_pref};
    for (int n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
      for (int q = 0; q < moves;) {
        const int kk = t_pair[t_order[q]].y;
        const int end = first(q, moves, [&](int p) { return t_pair[p].y <= kk; });
        const int d = __ldg(x.node_dom + static_cast<size_t>(kk) * N + n);
        if (d >= 0) {
          int a = first(q, end, [&](int p) { return t_pair[p].x < d; });
          const int z = first(a, end, [&](int p) { return t_pair[p].x <= d; });
          while (a < z) {
            int run0[DRAIN_RUNS], run1[DRAIN_RUNS];
            float v[DRAIN_RUNS][5];
            size_t row[DRAIN_RUNS], ipn[DRAIN_RUNS];
            bool own[DRAIN_RUNS];
#pragma unroll
            for (int u = 0; u < DRAIN_RUNS; ++u) {
              run0[u] = run1[u] = a;
              if (a >= z) continue;
              const int term_k = t_pair[t_order[a]].z;
              while (a < z && t_pair[t_order[a]].z == term_k) ++a;
              run1[u] = a;
              const int4 p0 = t_pair[t_order[run0[u]]];
              row[u] = static_cast<size_t>(p0.z) * N + n;
              own[u] = p0.w >= 0;
              ipn[u] = static_cast<size_t>(own[u] ? p0.w : 0) * N + n;
              v[u][0] = src_match[row[u]];
              if (own[u])
                for (int o = 0; o < 4; ++o) v[u][1 + o] = src_own[o][ipn[u]];
            }
#pragma unroll
            for (int u = 0; u < DRAIN_RUNS; ++u) {
              if (run0[u] == run1[u]) continue;
              for (int r = run0[u]; r < run1[u]; ++r) {
                const int p = t_order[r];
                v[u][0] = v[u][0] + t_inc[p];
                if (own[u])
                  for (int o = 0; o < 4; ++o) v[u][1 + o] = v[u][1 + o] + t_inc[(1 + o) * pn + p];
              }
              cnt_match[row[u]] = v[u][0];
              if (own[u])
                for (int o = 0; o < 4; ++o) dst_own[o][ipn[u]] = v[u][1 + o];
            }
          }
        }
        q = end;
      }
    }
    // replica s's cnt_total, in the tile-0 block: term `term` is thread
    // term % threads's, which adds its pairs in log order
    if (total_owner)
      for (int p = 0; p < pv; ++p) {
        const int term = t_pair[p].z;
        if (term < 0 || term % static_cast<int>(blockDim.x) != static_cast<int>(threadIdx.x) || t_pair[p].x < 0)
          continue;
        cnt_total[term] = cnt_total[term] + t_inc[p];
      }
    if (kv < kn) break;
    __syncthreads();
  }
}

}  // namespace

extern "C" int simtpu_sweep_drain(const DeltaCtx* ctx, const SweepCtx* w, void* stream) {
  if (w->s == 0) return 0;
  // the launch follows the wrapper's plan (kernels/cuda.py
  // sweep_drain_plan); a plan whose tiles do not cover the nodes, or whose
  // entry staging does not fit its shared bytes, is refused
  const long long need = static_cast<long long>(drain_stage_words(
                             w->pod_words, ctx->tc, ctx->r + ctx->p_ports + 2 * ctx->w + ctx->v + ctx->sd + ctx->gd)) * 4;
  if (w->threads < 32 || w->threads > DRAIN_THREADS || w->threads % 32 != 0 || w->npt < 1 ||
      w->pod_words < 1 || (w->slab ? (w->slab_stride < need || w->slab_stride % 16 != 0 || w->smem != 0)
                                   : (w->smem < need || w->smem > DRAIN_SMEM_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (w->smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(sweep_drain_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, w->smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = ctx->n > 0 ? (ctx->n + w->npt - 1) / w->npt : 1;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w->slab)
    sweep_drain_kernel<true><<<dim3(w->s, tiles), w->threads, 0, st>>>(*ctx, *w);
  else
    sweep_drain_kernel<false><<<dim3(w->s, tiles), w->threads, w->smem, st>>>(*ctx, *w);
  return launch_status();
}
