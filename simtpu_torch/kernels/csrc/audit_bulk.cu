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
// Design: one warp per node. The block's warps stage the entries' node ids
// through shared memory in tiles of TILE; each warp scans a tile 32 ids at
// a time and takes its node's entries from a ballot, lowest index first —
// the stable by-node order, placement order within a node, without a sort.
// Lane 0 of the warp visits the node's entries in that order: it checks
// each against the node's running sums, writes the entry's flag word, then
// adds the entry in. The running sums live in the node's row of the
// scratch `acc` [N, S] (S = R + P + 2W + V + SD + GD), which the warp
// zeroes first; every row and every flag word has one writer.
//
// Sum form: the prefix before an entry is a running sum along the node's
// entries in placement order. The JAX package takes it as a global cumsum
// over the node-sorted entries less the cumsum at the segment's start;
// the two round differently by far less than the slack (at least 1e-3
// absolute), so the flag words agree.
//
// Bound: O(N * M) id compares (one scan of the ids per node) against
// bytes of O(N + M); at N = 1000 and M = 10^4 the kernel is one launch
// plus a few microseconds of shared-memory scans. Index products are
// 64-bit. A zero width (P, W, C, V, SD, GD) skips its family: its pointer
// is never read.
#include "step_ctx.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int TILE = 2048;
constexpr double EPS_REL = 2e-5;
constexpr double EPS_ABS = 1e-3;
constexpr double ATTACH_EPS = 1e-9;

enum : int {
  B_INVALID_NODE = 0, B_OVERCOMMIT, B_PORT, B_VOLUME, B_ATTACH, B_STORAGE, B_GPU,
};

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
  // scratch and output
  double* acc;                   // [N, S]
  int* flags;                    // [M]
};

__device__ __forceinline__ bool over_slack(double want, double free) {
  const double slack = EPS_REL * fmax(fabs(free), 1.0) + EPS_ABS;
  return want > free + slack;
}

// Entry j on node n: its flag word against the running sums in `acc`,
// then the entry added into them.
__device__ void visit(const AuditCtx& x, int n, int64_t j, double* acc) {
  const int64_t g = x.g[j];
  const bool forced = x.forced[j] != 0;
  const int64_t pin = x.pin[j];
  const bool nv = x.node_valid[n] != 0;
  bool bad;
  if (forced) {
    bad = !(pin >= 0 && n == pin && nv);
  } else {
    const size_t gn = static_cast<size_t>(g) * x.n + n;
    const bool ok_static = x.static_mask[gn] && x.vol_mask[gn];
    const bool pin_ok = pin >= 0 ? n == pin : pin > -2;
    bad = !(ok_static && pin_ok && nv);
  }
  int bits = bad ? 1 << B_INVALID_NODE : 0;

  double* used = acc;
  double* cnt_port = used + x.r;
  double* cnt_any = cnt_port + x.p;
  double* cnt_rw = cnt_any + x.w;
  double* used_vg = cnt_rw + x.w;
  double* cnt_sd = used_vg + x.v;
  double* used_g = cnt_sd + x.sd;
  const size_t nr = static_cast<size_t>(n);
  const size_t jj = static_cast<size_t>(j);
  const size_t gg = static_cast<size_t>(g);

  if (!forced) {
    bool over = false;
    for (int r = 0; r < x.r; ++r)
      over |= over_slack(x.req[jj * x.r + r], x.alloc[nr * x.r + r] - used[r]);
    if (over) bits |= 1 << B_OVERCOMMIT;

    bool port = false;
    for (int p = 0; p < x.p; ++p)
      port |= x.ports[gg * x.p + p] && cnt_port[p] > 0.0;
    if (port) bits |= 1 << B_PORT;

    if (x.w) {
      bool vol = false;
      for (int w = 0; w < x.w; ++w) {
        const size_t gw = gg * x.w + w;
        vol |= (x.vol_rw[gw] && cnt_any[w] > 0.0) || (x.vol_ro[gw] && cnt_rw[w] > 0.0);
      }
      if (vol) bits |= 1 << B_VOLUME;
      bool attach = false;
      for (int c = 0; c < x.c; ++c) {
        double used_c = 0.0, new_c = 0.0;
        for (int w = 0; w < x.w; ++w) {
          const double cm = x.vol_class_mask[static_cast<size_t>(c) * x.w + w];
          if (cnt_any[w] > 0.0)
            used_c += cm;
          else if (x.vol_att[gg * x.w + w])
            new_c += cm;
        }
        attach |= new_c > 0.0 && used_c + new_c > x.attach_limits[nr * x.c + c] + ATTACH_EPS;
      }
      if (attach) bits |= 1 << B_ATTACH;
    }

    bool storage = false;
    for (int v = 0; v < x.v; ++v)
      storage |= over_slack(x.lvm[jj * x.v + v], x.vg_avail0[nr * x.v + v] - used_vg[v]);
    for (int s = 0; s < x.sd; ++s)
      storage |= x.sdev[jj * x.sd + s] && (!x.sdev_free0[nr * x.sd + s] || cnt_sd[s] > 0.0);
    if (storage) bits |= 1 << B_STORAGE;

    bool gpu = false;
    for (int d = 0; d < x.gd; ++d)
      gpu |= over_slack(x.gpu[jj * x.gd + d], x.gpu_total[nr * x.gd + d] - used_g[d]);
    if (gpu) bits |= 1 << B_GPU;
  }
  x.flags[j] = bits;

  for (int r = 0; r < x.r; ++r) used[r] += x.req[jj * x.r + r];
  for (int p = 0; p < x.p; ++p) cnt_port[p] += x.ports[gg * x.p + p] ? 1.0 : 0.0;
  for (int w = 0; w < x.w; ++w) {
    const size_t gw = gg * x.w + w;
    const bool rw = x.vol_rw[gw] != 0;
    cnt_any[w] += (rw || x.vol_ro[gw] || x.vol_att[gw]) ? 1.0 : 0.0;
    cnt_rw[w] += rw ? 1.0 : 0.0;
  }
  for (int v = 0; v < x.v; ++v) used_vg[v] += x.lvm[jj * x.v + v];
  for (int s = 0; s < x.sd; ++s) cnt_sd[s] += x.sdev[jj * x.sd + s] ? 1.0 : 0.0;
  for (int d = 0; d < x.gd; ++d) used_g[d] += x.gpu[jj * x.gd + d];
}

__global__ void __launch_bounds__(WARPS * 32) audit_bulk_kernel(AuditCtx x) {
  __shared__ int tile[TILE];
  const int lane = threadIdx.x & 31;
  const int node = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = node < x.n;  // uniform across the warp
  const int s = x.r + x.p + 2 * x.w + x.v + x.sd + x.gd;
  double* acc = x.acc + static_cast<size_t>(live ? node : 0) * s;
  if (live) {
    for (int k = lane; k < s; k += 32) acc[k] = 0.0;
  }
  __syncwarp();
  for (int64_t base = 0; base < x.m; base += TILE) {
    const int len = static_cast<int>(x.m - base < TILE ? x.m - base : TILE);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < len; k += blockDim.x)
      tile[k] = static_cast<int>(x.node[base + k]);
    __syncthreads();
    if (!live) continue;
    for (int k0 = 0; k0 < len; k0 += 32) {
      const int k = k0 + lane;
      unsigned hits = __ballot_sync(0xffffffffu, k < len && tile[k] == node);
      while (hits) {
        const int b = __ffs(hits) - 1;
        hits &= hits - 1;
        if (lane == 0) visit(x, node, base + k0 + b, acc);
        __syncwarp();
      }
    }
  }
}

extern "C" int simtpu_audit_bulk(const AuditCtx* ctx, void* stream) {
  if (ctx->n <= 0) return 0;
  const int blocks = (ctx->n + WARPS - 1) / WARPS;
  audit_bulk_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
