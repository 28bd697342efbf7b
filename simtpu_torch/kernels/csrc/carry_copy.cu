// K17 carry_copy: every plane of a carried state copied into fresh storage
// in one launch.
//
// Replaces the JAX package's simtpu/plan/incremental.py _copy_state
// (:119), the jitted tree_map(jnp.copy) the incremental planner runs once
// per completion probe. The port's kernels update dense planes in place,
// so each probe takes a copy of the base run's snapshot (dense SchedState
// or CompactState alike) and the snapshot stays untouched by
// construction. The planes are the segments of a table [S] (source,
// destination, bytes) in field order; blockIdx.y picks the segment, the
// x blocks stride over its bytes, 16 bytes at a time where source and
// destination are 16-byte aligned (the caching allocator's blocks are),
// the tail byte by byte.
//
// Bound: bytes — every plane read once and written once.
#include "step_ctx.cuh"

struct CopySeg {
  const uint8_t* src;
  uint8_t* dst;
  long long bytes;
};

struct CopyCtx {
  int n_seg, pad_;
  const CopySeg* segs;  // [S]
};

__global__ void carry_copy_kernel(CopyCtx c) {
  const CopySeg s = c.segs[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool vec = (reinterpret_cast<uintptr_t>(s.src) % 16 == 0) && (reinterpret_cast<uintptr_t>(s.dst) % 16 == 0);
  long long done = 0;
  if (vec) {
    const long long n16 = s.bytes / 16;
    const uint4* src = reinterpret_cast<const uint4*>(s.src);
    uint4* dst = reinterpret_cast<uint4*>(s.dst);
    for (long long q = tid; q < n16; q += stride) dst[q] = src[q];
    done = n16 * 16;
  }
  for (long long q = done + tid; q < s.bytes; q += stride) s.dst[q] = s.src[q];
}

extern "C" int simtpu_carry_copy(const CopyCtx* ctx, void* stream) {
  if (ctx->n_seg == 0) return 0;
  const int threads = 256;
  dim3 grid(132, ctx->n_seg);
  carry_copy_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
