// K11 compact_compress: the dense carried state in the compact layout.
//
// Replaces the JAX package's simtpu/engine/state.py _compress_state_fn
// (:1027, with _compress_rows :999), jitted as compress_state: at the end
// of each batch the engine stores its final state compressed.
//
// What each output element is:
// - a tabular element [r, d] of a count plane is the plane's row
//   ids_tab[r] at the domain's representative node rep[r, d] (0 where the
//   domain has no node): a gather, not a reduction, exact because a
//   tabular row is constant within a domain (every writer of the state —
//   K4, K7, K9/K10, K13 — updates all nodes of the domain);
// - a dense element [r, n] is the plane's row ids_dense[r] at node n;
// - cnt_total, ports_used, vols_any and vols_rw are cast to int32;
// - sdev_free is copied (bool).
// Casts truncate toward zero, as XLA's f32 -> s32 convert does; the
// values are integer counts and integer preference weights, so they are
// exact. free, vg_free and gpu_free move into the compact state without a
// copy (the wrapper hands over the dense tensors).
//
// Design: a row-task table (kernels/cuda.py compress_plan, built once per
// CompactSpecDev and shape): one task per dense output row (N casts of one
// source row) and per chunk of a flat output — a tabular plane's [Rt, D]
// elements, gathered through the plan's table of source offsets (each
// element's row ids_tab[r] x N + rep[r, d], -1 where the domain has no
// node: rep and the row ids folded once on the host), a flat cast, a
// chunk of sdev_free's bytes — as (kind and plane, source offset,
// destination offset, length) in elements. A 2-D grid: blockIdx.y picks
// the task (looping past gridDim.y), blockIdx.x tiles the row, and a
// thread takes one 16-byte vector (4 casts, 16 bytes) where the source's
// and the destination's addresses share their phase mod 16, with scalar
// heads and tails; index arithmetic is 32-bit, nothing is divided per
// element, and each plane's pointer is picked by a switch on the task's
// plane (no array of the block's pointers, which would live in local
// memory). Every output element has one writer.
//
// Bound: bytes — each output element is written once and reads one input
// element (the tabular ones one of D per domain); at N = 1000 one launch's
// latency dominates, at the bulk problem's N = 5000 the bytes.
#include "step_ctx.cuh"

// threads a block of the compress grid
constexpr int COMPRESS_THREADS = 256;
// a gathering thread's elements in flight (a chunk is 4 x the row's
// threads: one round)
constexpr int GATHER_ILP = 4;
// task kinds (a task's first word is kind * 8 + plane)
enum : int { CT_GATHER = 0, CT_DENSE = 1, CT_CAST = 2, CT_BYTES = 3 };

// The launch plan (mirrored by kernels/cuda.py CompressPlan): `tasks`
// int4 words on the device, `tiles` blocks along a row (every task's
// length within tiles x COMPRESS_THREADS x 16 bytes), `gather` the
// tabular elements' source offsets
struct CompressPlan {
  int n_tasks, tiles;
  const int4* tasks;
  const int* gather;
};

// count plane q's dense source, tabular and dense outputs (CompactState
// order: cnt_match, cnt_own_anti, cnt_own_aff, w_own_aff_pref,
// w_own_anti_pref)
__device__ __forceinline__ const float* plane_full(const CompactCtx& x, int q) {
  switch (q) {
    case 0: return x.cnt_match;
    case 1: return x.cnt_own_anti;
    case 2: return x.cnt_own_aff;
    case 3: return x.w_own_aff_pref;
    default: return x.w_own_anti_pref;
  }
}
__device__ __forceinline__ int* plane_tab(const CompactCtx& x, int q) {
  switch (q) {
    case 0: return x.cm_tab;
    case 1: return x.oa_tab;
    case 2: return x.of_tab;
    case 3: return x.wa_tab;
    default: return x.wn_tab;
  }
}
__device__ __forceinline__ int* plane_dense(const CompactCtx& x, int q) {
  switch (q) {
    case 0: return x.cm_dense;
    case 1: return x.oa_dense;
    case 2: return x.of_dense;
    case 3: return x.wa_dense;
    default: return x.wn_dense;
  }
}

// The row's threads: this block's tile of the grid's x axis
__device__ __forceinline__ int row_thread() { return blockIdx.x * blockDim.x + threadIdx.x; }
__device__ __forceinline__ int row_span() { return gridDim.x * blockDim.x; }

// Elements [0, head) and [head + vecs x V, len) one at a time, the vectors
// of V elements between them 16 bytes at a time: `head` up to the first
// 16-byte aligned element where both addresses share their phase mod 16
// (else every element one at a time)
__device__ __forceinline__ void row_split(uintptr_t a, uintptr_t b, int len, int size, int& head, int& vecs) {
  head = len;
  vecs = 0;
  if (((a ^ b) & 15) == 0) {
    head = min(len, static_cast<int>(((16 - (a & 15)) & 15) / size));
    vecs = (len - head) / (16 / size);
  }
}

// dst[j] = (int) src[j], truncating as XLA's f32 -> s32 convert does
__device__ __forceinline__ void cast_row(const float* src, int* dst, int len) {
  const int gt = row_thread(), span = row_span();
  int head, vecs;
  row_split(reinterpret_cast<uintptr_t>(src), reinterpret_cast<uintptr_t>(dst), len, 4, head, vecs);
  for (int j = gt; j < head; j += span) dst[j] = static_cast<int>(src[j]);
  for (int v = gt; v < vecs; v += span) {
    const int at = head + 4 * v;
    const float4 f = __ldg(reinterpret_cast<const float4*>(src + at));
    *reinterpret_cast<int4*>(dst + at) =
        make_int4(static_cast<int>(f.x), static_cast<int>(f.y), static_cast<int>(f.z), static_cast<int>(f.w));
  }
  for (int j = head + 4 * vecs + gt; j < len; j += span) dst[j] = static_cast<int>(src[j]);
}

// dst[j] = (int) full[at[j]], 0 where at[j] < 0: a thread's GATHER_ILP
// elements (a row_span apart, so that neighbouring threads read
// neighbouring offsets) with their offsets loaded together, then their
// sources, so that the two dependent loads are paid once a round
__device__ __forceinline__ void gather_row(const float* full, const int* at, int* dst, int len) {
  const int gt = row_thread(), span = row_span();
  for (int j0 = gt; j0 < len; j0 += GATHER_ILP * span) {
    int off[GATHER_ILP];
    float v[GATHER_ILP];
#pragma unroll
    for (int k = 0; k < GATHER_ILP; ++k) off[k] = j0 + k * span < len ? __ldg(at + j0 + k * span) : -1;
#pragma unroll
    for (int k = 0; k < GATHER_ILP; ++k) v[k] = off[k] >= 0 ? full[off[k]] : 0.0f;
#pragma unroll
    for (int k = 0; k < GATHER_ILP; ++k)
      if (j0 + k * span < len) dst[j0 + k * span] = static_cast<int>(v[k]);
  }
}

// dst[j] = src[j] over bytes
__device__ __forceinline__ void copy_bytes(const uint8_t* src, uint8_t* dst, int len) {
  const int gt = row_thread(), span = row_span();
  int head, vecs;
  row_split(reinterpret_cast<uintptr_t>(src), reinterpret_cast<uintptr_t>(dst), len, 1, head, vecs);
  for (int j = gt; j < head; j += span) dst[j] = src[j];
  for (int v = gt; v < vecs; v += span)
    *reinterpret_cast<int4*>(dst + head + 16 * v) = __ldg(reinterpret_cast<const int4*>(src + head + 16 * v));
  for (int j = head + 16 * vecs + gt; j < len; j += span) dst[j] = src[j];
}

__global__ void __launch_bounds__(COMPRESS_THREADS) compact_compress_kernel(CompactCtx x, CompressPlan p) {
  for (int k = blockIdx.y; k < p.n_tasks; k += gridDim.y) {
    const int4 t = p.tasks[k];
    const int kind = t.x >> 3, q = t.x & 7;
    if (kind == CT_GATHER) {
      gather_row(plane_full(x, q), p.gather + t.y, plane_tab(x, q) + t.z, t.w);
    } else if (kind == CT_DENSE) {
      cast_row(plane_full(x, q) + t.y, plane_dense(x, q) + t.z, t.w);
    } else if (kind == CT_CAST) {
      const float* src = q == 0 ? x.cnt_total : q == 1 ? x.ports_used : q == 2 ? x.vols_any : x.vols_rw;
      int* dst = q == 0 ? x.c_cnt_total : q == 1 ? x.c_ports_used : q == 2 ? x.c_vols_any : x.c_vols_rw;
      cast_row(src + t.y, dst + t.z, t.w);
    } else {
      copy_bytes(x.sdev_free + t.y, x.c_sdev_free + t.z, t.w);
    }
  }
}

// K11 on the wrapper's plan; refused with tasks but no table or a tile
// count outside 1 ... 65 535
extern "C" int simtpu_compact_compress(const CompactCtx* ctx, const CompressPlan* plan, void* stream) {
  const CompressPlan& p = *plan;
  if (p.n_tasks < 0 || (p.n_tasks > 0 && (p.tasks == nullptr || p.gather == nullptr || p.tiles < 1 || p.tiles > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_tasks == 0) return 0;
  const dim3 grid(p.tiles, p.n_tasks < 65535 ? p.n_tasks : 65535);
  compact_compress_kernel<<<grid, COMPRESS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*ctx, p);
  return launch_status();
}
