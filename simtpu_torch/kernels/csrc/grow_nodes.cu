// K25 grow_nodes: every plane of a grow-mode carry widened from N to N + a
// nodes, in one launch.
//
// Replaces the JAX package's simtpu/engine/state.py _extend_nodes_kernel
// (:585). The planes are the rows of a descriptor table, one per plane;
// blockIdx.y picks the plane and the x blocks stride over its fresh,
// wider allocation. A plane grows along its rows (free, vg_free,
// sdev_free, gpu_free, ports_used, vols_any, vols_rw: [N, X] -> [N + a, X],
// the new nodes' rows from the host plan, or zeros) or along its columns
// (cnt_match and the four own planes: [T, N] -> [T, N + a], the new
// nodes' host-computed count columns). Elements are moved as 4-byte or
// 1-byte words by the plane's element size; values are copied, never
// computed, so the result is bit for bit the plain concatenation.
//
// Bound: bytes — each old plane read once, each new part read once, each
// widened plane written once.
#include "step_ctx.cuh"

struct GrowPlane {
  const void* src;  // [rows, cols] old plane
  const void* add;  // the new nodes' part, or null = zeros
  void* dst;        // the widened plane
  int rows, cols;   // old shape
  int add_rows;     // rows appended (axis 0), else 0
  int add_cols;     // columns appended (axis 1), else 0
  int elem;         // bytes per element: 4 or 1
  int pad_;
};

struct GrowNodesCtx {
  int n_planes, pad_;
  const GrowPlane* planes;  // [n_planes]
};

template <typename T>
__device__ void grow_plane(const GrowPlane& p, long long tid, long long stride) {
  const T* src = static_cast<const T*>(p.src);
  const T* add = static_cast<const T*>(p.add);
  T* dst = static_cast<T*>(p.dst);
  const long long out_cols = p.cols + p.add_cols;
  const long long total = static_cast<long long>(p.rows + p.add_rows) * out_cols;
  for (long long q = tid; q < total; q += stride) {
    const long long i = q / out_cols, j = q - i * out_cols;
    T v;
    if (i < p.rows && j < p.cols) v = src[i * p.cols + j];
    else if (add == nullptr) v = T(0);
    else if (p.add_cols) v = add[i * p.add_cols + (j - p.cols)];
    else v = add[(i - p.rows) * p.cols + j];
    dst[q] = v;
  }
}

__global__ void grow_nodes_kernel(GrowNodesCtx x) {
  const GrowPlane p = x.planes[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p.elem == 4) grow_plane<uint32_t>(p, tid, stride);
  else grow_plane<uint8_t>(p, tid, stride);
}

extern "C" int simtpu_grow_nodes(const GrowNodesCtx* ctx, void* stream) {
  if (ctx->n_planes == 0) return 0;
  dim3 grid(264, ctx->n_planes);
  grow_nodes_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(*ctx);
  return launch_status();
}
