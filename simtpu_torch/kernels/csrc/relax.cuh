// The relaxation's argument block, shared by K22 relax_load and K23
// relax_project (simtpu_torch/solve/relax.py). Mirrored field for field by
// the ctypes structure RelaxCtx in simtpu_torch/kernels/cuda.py; passed to
// both kernels by value.
#pragma once
#include "step_ctx.cuh"

// RelaxCtx.mode bits: K22 writes residual[s]; K23 writes the start point
constexpr int RELAX_RESIDUAL = 1;
constexpr int RELAX_INIT = 1;
// widest node row K23 sorts in one block: the keys (f32) and their prefix
// sums (f64) of the next power of two >= N in dynamic shared memory
constexpr int RELAX_MAX_ROW = 16384;

struct RelaxCtx {
  int s, c, n, r, mode, np2;
  float lr;
  int pad_;
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
};
