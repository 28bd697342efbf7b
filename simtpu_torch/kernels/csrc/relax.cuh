// The relaxation's argument block, shared by K22 relax_load and K23
// relax_project (simtpu_torch/solve/relax.py). Mirrored field for field by
// the ctypes structure RelaxCtx in simtpu_torch/kernels/cuda.py; passed to
// both kernels by value.
#pragma once
#include "step_ctx.cuh"

// RelaxCtx.mode bits: K22 writes residual[s]; K23 writes the start point
constexpr int RELAX_RESIDUAL = 1;
constexpr int RELAX_INIT = 1;
// K23's three paths by the padded row (the next power of two >= N):
// up to RELAX_REG_ROW the row's keys sort in registers, one block of at
// most RELAX_ROW_THREADS threads per row (RelaxCtx.threads x .kpt keys,
// at most RELAX_REG_ROW of them);
// up to RELAX_SHARED_ROW its keys (f32) and prefix sums (f64) sit in
// dynamic shared memory (12 B each, 227 KB), one block of 1024 threads;
// a wider row sorts in a slab of RelaxCtx.scratch
constexpr int RELAX_REG_ROW = 4096;
constexpr int RELAX_ROW_THREADS = 512;
constexpr int RELAX_SHARED_ROW = 16384;
// K22's threads a block at most (its plan: kernels/cuda.py relax_load_plan)
constexpr int RELAX_LOAD_THREADS = 256;
// the classes of req K22 stages in shared memory at a time
constexpr int RELAX_LOAD_REQ_ROWS = 1024;

struct RelaxCtx {
  int s, c, n, r, mode, np2;
  float lr;
  int slabs;            // blocks of the wide-row path, each with one slab (0: shared memory)
  const uint8_t* feas;  // [C, N] class feasibility
  const float* req;     // [C, R] scaled per-pod request
  const float* cnt;     // [C] pods per class
  const float* fixed;   // [N, R] scaled pinned load
  const float* cap;     // [N, R] scaled allocatable
  const uint8_t* valid; // [S, N] candidate membership
  float* y;             // [S, C, N] fractional assignment (in place)
  float* over;          // [S, N, R] overcommit of the current y
  float* residual;      // [S] max overcommit (zeroed by the caller)
  int* stuck;           // [S] a class with demand has no feasible valid node
  unsigned char* scratch; // [slabs, np2] prefix sums (f64) then keys (f32), wide rows only
  // K23's register path (np2 <= RELAX_REG_ROW): threads per row and keys
  // per thread (kernels/cuda.py relax_project_plan)
  int threads, kpt;
  // K22's plan: threads a block, nodes a thread, classes unrolled
  int load_threads, load_npt, load_unroll, pad_;
};
