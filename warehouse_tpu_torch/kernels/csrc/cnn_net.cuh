// The CNN policy's packed parameter layout, shared by the CNN acting kernel
// (K10, act_cnn.cu) and the CNN PPO learner (K11/K12, sgd_cnn.cu), whose
// stage kernels are their own: two 3x3 SAME convolutions with relu over the
// [S, S, C] grid of the observation (channel-last, as the observation lies
// in memory), the 6 self features joined after the channel-last flatten, a
// tanh trunk and the fused logits + value head
// (warehouse_tpu/models/policy.py ActorCriticCNN).
//
// The TPU kernels run each convolution as one dense product with an
// unrolled [S^2 OC, S^2 IC] matrix, because an S x S image is a poor shape
// for their matrix unit. Here the convolution is computed directly over its
// valid taps: 2.3x fewer operations at S = 5, and the weight gradient then
// accumulates in the 3x3 basis itself, so the unrolled matrices, their
// rebuild after each optimizer step and the fold of their gradients have no
// counterpart.
//
// The packed parameter vector (float32):
//   W0 [9 C1, C0]   conv 0, row k C1 + oc (k = 3 dr + dc the tap), column ic:
//                   an elementwise relayout of torch's [C1, C0, 3, 3];
//   b0 [C1]; W1 [9 C2, C1]; b1 [C2];
//   Wt [H, P2 C2 + 6], bt [H]   the trunk, torch's [out, in];
//   head W [6, H] (5 logits, then the value), b [6].
//
// Policy groups keep K such vectors one after another in group order.
#pragma once

#include <cuda_runtime.h>

#include "device_limits.cuh"
#include "rnn_cell.cuh"

namespace {

constexpr int NSELF = 6;  // self features after the grid

struct CnnNet {
  int S, P2, C0, C1, C2, H, D;
  int trunk_in;  // P2 C2 + 6
  long w0, b0, w1, b1, wt, bt, head_w, head_b;  // offsets in the packed vector
  long n_conv, n_params;
};

// Any trunk width H: the stages read H-wide rows element by element, and
// their tiles pad H to 32 or 128.
inline bool make_cnn_net(int S, int C0, int C1, int C2, int H, CnnNet* net) {
  if (S < 1 || C0 < 1 || C1 < 4 || C2 < 4 || H < 1 || C1 % 4 || C2 % 4)
    return false;
  net->S = S;
  net->P2 = S * S;
  net->C0 = C0;
  net->C1 = C1;
  net->C2 = C2;
  net->H = H;
  net->D = net->P2 * C0 + NSELF;
  net->trunk_in = net->P2 * C2 + NSELF;
  long off = 0;
  net->w0 = off, off += 9L * C1 * C0;
  net->b0 = off, off += C1;
  net->w1 = off, off += 9L * C2 * C1;
  net->b1 = off, off += C2;
  net->n_conv = off;
  net->wt = off, off += (long)H * net->trunk_in;
  net->bt = off, off += H;
  net->head_w = off, off += (long)RHEAD * H;
  net->head_b = off, off += RHEAD;
  net->n_params = off;
  return true;
}

}  // namespace
