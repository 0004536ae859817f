// One dense layer over rows in shared memory whose matrix lies in device
// memory: the layer of mlp_learner.cuh's tile route, which the IMPALA
// learner (K5 / K6, vtrace_sgd.cu) runs.
//
// W [in, out] and the bias are read through the read-only path: every CTA
// reads the same matrix, so it stays in L2, and a warp's threads own
// neighbouring columns, so a load is whole lines. A thread owns one output
// column for a register tile of TILE rows and reads the rows as shared-memory
// broadcasts. A layer too wide to stage its input runs over chunks of XCH
// input columns: each chunk's call adds its part to the sums kept in y, in
// the order of the columns. With BX each x is rounded to bf16 where it is
// read (a learner's bf16-operand product; W is then a rounded copy).
#pragma once

#include <cuda_runtime.h>

#include "bf16_round.cuh"

namespace {

constexpr int XCH = 128;  // input columns per chunk of a chunked first layer

// y[n][o] = act(sum_i x[n][i] W[i][o] + b[o]) for GROUPS * TILE rows, by
// THREADS threads; or one chunk's part of that sum: unless `first` the sum
// starts from y, and only `last` adds the bias and applies the activation.
// On `last`, rows < nvalid also go to g[(n0 + n) * out + o] unless g is
// null.
template <int THREADS, int TILE, int GROUPS, bool BX = false>
__device__ void dense_l2(
    const float* W, const float* bias, const float* x, int xs, int in,
    float* y, int ys, int out, bool use_tanh, bool first, bool last,
    float* g, long n0, int nvalid) {
  for (int item = threadIdx.x; item < out * GROUPS; item += THREADS) {
    const int o = item % out, grp = item / out;
    const float* xg = x + grp * TILE * xs;
    float acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r)
      acc[r] = first ? 0.f : y[(grp * TILE + r) * ys + o];
#pragma unroll 4
    for (int i = 0; i < in; ++i) {
      const float wi = __ldg(W + (long)i * out + o);
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        acc[r] = fmaf(rbf<BX>(xg[r * xs + i]), wi, acc[r]);
    }
    const float bo = last ? __ldg(bias + o) : 0.f;
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const int n = grp * TILE + r;
      const float z = acc[r] + bo;
      const float v = last && use_tanh ? tanhf(z) : z;
      y[n * ys + o] = v;
      if (last && g && n < nvalid) g[(n0 + n) * out + o] = v;
    }
  }
}

}  // namespace
