// The CNN policy's forward pass for the CNN acting kernel (K10,
// act_cnn.cu), and the packed parameter layout it shares with the CNN PPO
// learner (K11/K12, sgd_cnn.cu, whose stage kernels are its own): two 3x3
// SAME convolutions with relu over the [S, S, C] grid of the observation
// (channel-last, as the observation lies in memory), the 6 self features
// joined after the channel-last flatten, a tanh trunk and the fused logits +
// value head (warehouse_tpu/models/policy.py ActorCriticCNN).
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
// The two conv kernels (~25 KB) are staged in shared memory, each row
// padded so that a warp's float4 reads of neighbouring output channels fall
// in different banks. The trunk (413 KB at S = 5, hidden 128) does not fit
// one SM's shared memory: it stays in device memory (L2-resident, every CTA
// reads the same matrix) and the forward reads a transposed copy [in, out]
// with rnn_cell.cuh's fma_cols, neighbouring threads on neighbouring
// columns. A tile's rows keep their activations (obs, both conv outputs,
// trunk, head) in shared memory: CROWS = 32 rows on the 5 x 5 ego window
// (~186 KB), fewer where a row is larger (act_cnn.cu cnn_act_envs): 8 on
// the 9 x 9 global view, whose row is 18.8 KB.
//
// The global observation has 5 channels per cell. The conv loops read 4
// input channels per load, so in shared memory only, the observation's grid
// and conv 0's kernel rows are padded to C0p = 8 channels, the pad zero in
// both: it adds exact zeros to the sums. The packed vector, the obs rows in
// device memory and the gradients keep the true 5 (obs_slot maps a feature
// to its padded place).
//
// Policy groups run these pieces once per group, on that group's rows,
// staged conv kernels, packed vector and transposed trunk.
#pragma once

#include <cuda_runtime.h>

#include "device_limits.cuh"
#include "rnn_cell.cuh"

namespace {

constexpr int CROWS = 32;  // rows per tile at most
constexpr int NSELF = 6;   // self features after the grid

struct CnnNet {
  int S, P2, C0, C1, C2, H, D;
  int C0p;            // C0 rounded up to a multiple of 4: shared memory's
  int trunk_in;       // P2 C2 + 6
  int xs, a0s, a1s;   // shared-memory row strides: obs, conv 0 out, trunk in
  int ws0, ws1;       // shared-memory row strides of the conv kernels
  long w0, b0, w1, b1, wt, bt, head_w, head_b;  // offsets in the packed vector
  long n_conv, n_params;
};

inline bool make_cnn_net(int S, int C0, int C1, int C2, int H, CnnNet* net) {
  if (S < 1 || C0 < 1 || C1 < 4 || C2 < 4 || H < 4 || C1 % 4 || C2 % 4 ||
      H % 4)
    return false;
  const int C0p = round4(C0);
  net->S = S;
  net->P2 = S * S;
  net->C0 = C0;
  net->C0p = C0p;
  net->C1 = C1;
  net->C2 = C2;
  net->H = H;
  net->D = net->P2 * C0 + NSELF;
  net->trunk_in = net->P2 * C2 + NSELF;
  net->xs = round4(net->P2 * C0p + NSELF);
  net->a0s = net->P2 * C1;
  net->a1s = round4(net->trunk_in);
  // A row of 16 or 32 floats would put every fourth lane's float4 in the
  // same banks; 4 floats of padding spread a quarter-warp over all 32.
  net->ws0 = C0p % 16 ? C0p : C0p + 4;
  net->ws1 = C1 % 16 ? C1 : C1 + 4;
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

// Floats of the staged conv kernels (a multiple of 4).
__host__ __device__ inline int conv_smem_floats(const CnnNet& net) {
  return 9 * net.C1 * net.ws0 + net.C1 + 9 * net.C2 * net.ws1 + net.C2;
}

// Floats of a tile's row buffers: obs, conv 0 out, trunk in, trunk out, head.
__host__ __device__ inline int cnn_row_floats(const CnnNet& net) {
  return net.xs + net.a0s + net.a1s + net.H + ROST;
}

// Where feature f of an observation row [P2 C0 + 6] lies in its shared-
// memory row: the grid's cells at C0p channels, then the self features.
__device__ __forceinline__ int obs_slot(const CnnNet& net, int f) {
  if (net.C0 == net.C0p) return f;
  const int grid = net.P2 * net.C0;
  return f < grid ? f / net.C0 * net.C0p + f % net.C0
                  : net.P2 * net.C0p + f - grid;
}

struct ConvW {  // the staged conv kernels
  const float *w0, *b0, *w1, *b1;
};

// The packed conv kernels into shared memory at their padded row strides.
__device__ inline ConvW stage_conv(const CnnNet& net, const float* p,
                                   float* smem) {
  float* w0 = smem;
  float* b0 = w0 + 9 * net.C1 * net.ws0;
  float* w1 = b0 + net.C1;
  float* b1 = w1 + 9 * net.C2 * net.ws1;
  for (int i = threadIdx.x; i < 9 * net.C1 * net.C0p; i += RNT) {
    const int row = i / net.C0p, ic = i % net.C0p;  // the pad channels: 0
    w0[row * net.ws0 + ic] =
        ic < net.C0 ? p[net.w0 + row * net.C0 + ic] : 0.f;
  }
  for (int i = threadIdx.x; i < net.C1; i += RNT) b0[i] = p[net.b0 + i];
  for (int i = threadIdx.x; i < 9 * net.C2 * net.C1; i += RNT)
    w1[i / net.C1 * net.ws1 + i % net.C1] = p[net.w1 + i];
  for (int i = threadIdx.x; i < net.C2; i += RNT) b1[i] = p[net.b1 + i];
  return ConvW{w0, b0, w1, b1};
}

// y[n][po OC + oc] = relu(b[oc] + sum over the valid taps k of po and over ic
// of x[n][pi IC + ic] W[(k OC + oc) ws + ic]) for `rows` rows (a multiple of
// RRT) of shared memory; pi is po moved by tap k. A thread owns one output
// (po, oc) for RRT rows and reads 4 input channels per load.
__device__ inline void conv_relu(const float* W, int ws, const float* b,
                                 const float* x, int xs, int IC, float* y,
                                 int ys, int OC, int S, int rows) {
  const int cols = S * S * OC;
  for (int item = threadIdx.x; item < cols * (rows / RRT); item += RNT) {
    const int col = item % cols, r0 = item / cols * RRT;
    const int po = col / OC, oc = col % OC, ro = po / S, co = po % S;
    float acc[RRT];
#pragma unroll
    for (int r = 0; r < RRT; ++r) acc[r] = 0.f;
    for (int k = 0; k < 9; ++k) {
      const int ri = ro + k / 3 - 1, ci = co + k % 3 - 1;
      if (ri < 0 || ri >= S || ci < 0 || ci >= S) continue;
      const float* w = W + (k * OC + oc) * ws;
      const float* xp = x + r0 * xs + (ri * S + ci) * IC;
      for (int ic = 0; ic < IC; ic += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(w + ic);
#pragma unroll
        for (int r = 0; r < RRT; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xp + r * xs + ic);
          acc[r] = fmaf(xv.x, wv.x, acc[r]);
          acc[r] = fmaf(xv.y, wv.y, acc[r]);
          acc[r] = fmaf(xv.z, wv.z, acc[r]);
          acc[r] = fmaf(xv.w, wv.w, acc[r]);
        }
      }
    }
    const float bo = b[oc];
#pragma unroll
    for (int r = 0; r < RRT; ++r)
      y[(r0 + r) * ys + col] = fmaxf(acc[r] + bo, 0.f);
  }
}

// Both convolutions of the tile: obs rows x -> a0 -> the first P2 C2 columns
// of a1, whose next 6 columns get the rows' self features. Ends synchronised.
__device__ inline void conv_forward(const CnnNet& net, const ConvW& cw,
                                    const float* x, float* a0, float* a1,
                                    int rows) {
  conv_relu(cw.w0, net.ws0, cw.b0, x, net.xs, net.C0p, a0, net.a0s, net.C1,
            net.S, rows);
  __syncthreads();
  conv_relu(cw.w1, net.ws1, cw.b1, a0, net.a0s, net.C1, a1, net.a1s,
                net.C2, net.S, rows);
  for (int idx = threadIdx.x; idx < rows * NSELF; idx += RNT) {
    const int n = idx / NSELF, f = idx % NSELF;
    a1[n * net.a1s + net.P2 * net.C2 + f] = x[n * net.xs + net.P2 * net.C0p + f];
  }
  __syncthreads();
}

// h[n][j] = tanh(a1[n] . Wt[j] + bt[j]) for the tile's rows; Wt_t is the
// trunk's kernel transposed to [trunk_in, H]. Rows < nvalid also go to
// g[(n0 + n) * H + j] when g is set.
__device__ inline void trunk_forward(const CnnNet& net, const float* Wt_t,
                                     const float* bt, const float* a1,
                                     float* h, int rows, float* g, long n0,
                                     int nvalid) {
  const int H = net.H;
  for (int item = threadIdx.x; item < H * (rows / RRT); item += RNT) {
    const int j = item % H, r0 = item / H * RRT;
    float acc[1][RRT];
    zero_acc(acc);
    fma_cols<1>(acc, a1 + r0 * net.a1s, net.a1s, Wt_t + j, H, 0,
                    net.trunk_in);
    const float bj = bt[j];
#pragma unroll
    for (int r = 0; r < RRT; ++r) {
      const float v = tanhf(acc[0][r] + bj);
      h[(r0 + r) * H + j] = v;
      if (g && r0 + r < nvalid) g[(n0 + r0 + r) * H + j] = v;
    }
  }
}

// out[n][o] = h[n] . Whead[o] + b[o], o < 6, one thread per (row, output).
__device__ inline void cnn_head(const CnnNet& net, const float* p,
                                const float* h, float* out, int rows) {
  for (int item = threadIdx.x; item < rows * RHEAD; item += RNT) {
    const int n = item / RHEAD, o = item % RHEAD;
    const float* w = p + net.head_w + (long)o * net.H;
    float acc = 0.f;
    for (int k = 0; k < net.H; ++k)
      acc = fmaf(h[n * net.H + k], __ldg(w + k), acc);
    out[n * ROST + o] = acc + p[net.head_b + o];
  }
}

// wt_t = the trunk's kernel [H, trunk_in] of the packed vector as
// [trunk_in, H].
__global__ void trunk_transpose_kernel(CnnNet net, const float* p,
                                       float* wt_t) {
  const long n = (long)net.H * net.trunk_in;
  for (long k = (long)blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += (long)gridDim.x * blockDim.x)
    wt_t[(k % net.trunk_in) * net.H + k / net.trunk_in] = p[net.wt + k];
}

inline cudaError_t launch_trunk_transpose(const CnnNet& net, const float* p,
                                          float* wt_t, cudaStream_t stream) {
  trunk_transpose_kernel<<<64, 256, 0, stream>>>(net, p, wt_t);
  return cudaGetLastError();
}

}  // namespace
