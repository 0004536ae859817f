// The recurrent policy's forward step for the recurrent acting kernel (K7,
// act_rnn.cu), and its packed parameter layout, which the recurrent PPO
// learner (K8/K9, sgd_rnn.cu) shares: tanh encoder layers -> GRU or LSTM
// cell -> fused logits + value head, in flax's cell math
// (warehouse_tpu/pallas/act.py:522-526):
//
//   GRU:  r = sig(Wir e + bir + Whr h); z = sig(Wiz e + biz + Whz h);
//         q = Whn h + bhn; n = tanh(Win e + bin + r q); h' = (1-z) n + z h.
//   LSTM: i, f, o = sig(Wi* e + Wh* h + bh*); g = tanh(Wig e + Whg h + bhg);
//         c' = f c + i g; h' = o tanh(c').
//
// The packed parameter vector (float32; every W is [out, in], torch's
// layout):
//   per encoder layer W [E_l, in], b [E_l];
//   Wi [G H, E]   the input-side gate kernels stacked (GRU ir, iz, in;
//                 LSTM ii, if, ig, io), G = 3 or 4;
//   GRU only: bi [3 H];
//   Wh [G H, H]   the recurrent gate kernels stacked (hr, hz, hn; hi, hf,
//                 hg, ho);
//   bh            GRU: bhn [H]; LSTM: [4 H];
//   head W [6, H] (5 logits, then the value), b [6].
//
// At hidden 128 the vector is ~113 K floats (GRU) or ~146 K (LSTM): more
// than one SM's shared memory, so no kernel stages it. The weights stay in
// device memory (L2-resident: every CTA reads the same ~0.5 MB each step)
// and a CTA keeps only its rows' activations in shared memory. A forward
// product reads a transposed copy Wt [in, out] (transpose_kernel), so the
// threads of a warp, which own neighbouring output columns, read
// neighbouring addresses. A thread owns one column for RT rows and reads
// the rows from shared memory as float4 broadcasts: 4 k's times NG gates of
// FMAs per 16-byte shared load.
//
// The recurrent learner (K8/K9, sgd_rnn.cu) takes RnnNet, make_rnn_net and
// sigmoidf from here; its products run as tiles of its own (mma_tiles.cuh).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAXE = 3;    // encoder layers
constexpr int RNT = 512;   // threads of the recurrent tile kernels
constexpr int RRT = 8;     // rows per register tile
constexpr int RHEAD = 6;   // 5 logits + value
constexpr int ROST = 8;    // row stride of the head outputs

struct RnnNet {
  int n_enc, D, E, H, lstm, G;
  int enc_in[MAXE], enc_out[MAXE];
  long enc_w[MAXE], enc_b[MAXE];
  long wi, bi;  // bi < 0 for the LSTM (no input-side bias)
  long wh, bh;  // bh: GRU [H] (hn's), LSTM [4 H]
  long head_w, head_b;
  long n_params;
};

// dims = obs width, then the encoder widths.
inline bool make_rnn_net(int n_enc, const int* dims, int H, int lstm,
                         RnnNet* net) {
  if (n_enc < 1 || n_enc > MAXE || H <= 0 || H % 4) return false;
  net->n_enc = n_enc;
  net->D = dims[0];
  net->H = H;
  net->lstm = lstm ? 1 : 0;
  net->G = lstm ? 4 : 3;
  long off = 0;
  for (int l = 0; l < n_enc; ++l) {
    const int in = dims[l], out = dims[l + 1];
    if (in <= 0 || out <= 0 || out % 4) return false;
    net->enc_in[l] = in;
    net->enc_out[l] = out;
    net->enc_w[l] = off;
    net->enc_b[l] = off + (long)in * out;
    off = net->enc_b[l] + out;
  }
  const int E = net->E = dims[n_enc], G = net->G;
  net->wi = off;
  off += (long)G * H * E;
  net->bi = lstm ? -1 : off;
  if (!lstm) off += 3 * H;
  net->wh = off;
  off += (long)G * H * H;
  net->bh = off;
  off += lstm ? 4 * H : H;
  net->head_w = off;
  off += (long)RHEAD * H;
  net->head_b = off;
  net->n_params = off + RHEAD;
  return true;
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// The widest encoder layer: the row stride of the encoder's buffers.
__host__ __device__ inline int enc_max(const RnnNet& net) {
  int emax = 0;
  for (int l = 0; l < net.n_enc; ++l)
    emax = net.enc_out[l] > emax ? net.enc_out[l] : emax;
  return emax;
}

// pt = every forward matrix of the packed vector transposed to [in, out], at
// its offset in the packed vector (the biases and the head are read from p).
__global__ void transpose_kernel(RnnNet net, const float* p, float* pt) {
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int m = 0; m < net.n_enc + 2; ++m) {
    long off;
    int out, in;
    if (m < net.n_enc) {
      off = net.enc_w[m], out = net.enc_out[m], in = net.enc_in[m];
    } else if (m == net.n_enc) {
      off = net.wi, out = net.G * net.H, in = net.E;
    } else {
      off = net.wh, out = net.G * net.H, in = net.H;
    }
    for (long k = tid; k < (long)out * in; k += stride)
      pt[off + (k % in) * out + k / in] = p[off + k];
  }
}

// acc[g][r] += sum_k x[r * xs + k] * W[k * ldw + g * gs], k in [0, in):
// NG columns (gate g's is W + g * gs) for RRT rows of shared memory. xs is a
// multiple of 4 and x 16-byte aligned.
template <int NG>
__device__ __forceinline__ void fma_cols(float (&acc)[NG][RRT], const float* x,
                                         int xs, const float* W, int ldw,
                                         int gs, int in) {
  int k = 0;
  for (; k + 4 <= in; k += 4) {
    float w[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[g][j] = __ldg(W + (long)(k + j) * ldw + g * gs);
#pragma unroll
    for (int r = 0; r < RRT; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(x + r * xs + k);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[g][r] = fmaf(xv.x, w[g][0], acc[g][r]);
        acc[g][r] = fmaf(xv.y, w[g][1], acc[g][r]);
        acc[g][r] = fmaf(xv.z, w[g][2], acc[g][r]);
        acc[g][r] = fmaf(xv.w, w[g][3], acc[g][r]);
      }
    }
  }
  for (; k < in; ++k) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float w = __ldg(W + (long)k * ldw + g * gs);
#pragma unroll
      for (int r = 0; r < RRT; ++r)
        acc[g][r] = fmaf(x[r * xs + k], w, acc[g][r]);
    }
  }
}

template <int NG>
__device__ __forceinline__ void zero_acc(float (&acc)[NG][RRT]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int r = 0; r < RRT; ++r) acc[g][r] = 0.f;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// y[n][o] = tanh(x[n] . W[o] + b[o]) for the tile's `rows` rows (a multiple
// of RRT); rows < nvalid also go to g[(n0 + n) * out + o] when g is set.
// Wt is the layer's transposed kernel [in, out].
__device__ void enc_layer(const float* Wt, const float* bias, const float* x,
                          int xs, int in, float* y, int ys, int out, int rows,
                          float* g, long n0, int nvalid) {
  for (int item = threadIdx.x; item < out * (rows / RRT); item += RNT) {
    const int o = item % out, r0 = item / out * RRT;
    float acc[1][RRT];
    zero_acc(acc);
    fma_cols<1>(acc, x + r0 * xs, xs, Wt + o, out, 0, in);
    const float bo = bias[o];
#pragma unroll
    for (int r = 0; r < RRT; ++r) {
      const float v = tanhf(acc[0][r] + bo);
      y[(r0 + r) * ys + o] = v;
      if (g && r0 + r < nvalid) g[(n0 + r0 + r) * out + o] = v;
    }
  }
}

// The cell's forward on the tile: e [rows, E] and the carry h (and c) in
// shared memory give h_next (a second buffer: other threads still read h)
// and, for the LSTM, c in place. With `gates` set, rows < nvalid store the
// post-activation gates to gates[(n0 + n) * 4 H + {0, 1, 2, 3} H + j] (GRU
// r, z, n, q; LSTM i, f, g, o) and the new carry to h_out / c_out
// [(n0 + n) * H + j].
__device__ void cell_forward(const RnnNet& net, const float* p,
                             const float* pt, const float* e, int es,
                             const float* h, float* h_next, float* c, int hs,
                             int rows, float* gates, float* h_out,
                             float* c_out, long n0, int nvalid) {
  const int H = net.H, E = net.E, GH = net.G * net.H;
  const float* Wti = pt + net.wi;
  const float* Wth = pt + net.wh;
  for (int item = threadIdx.x; item < H * (rows / RRT); item += RNT) {
    const int j = item % H, r0 = item / H * RRT;
    if (net.lstm) {
      float acc[4][RRT];
      zero_acc(acc);
      fma_cols<4>(acc, e + r0 * es, es, Wti + j, GH, H, E);
      fma_cols<4>(acc, h + r0 * hs, hs, Wth + j, GH, H, H);
      const float* bh = p + net.bh;
      const float bi = bh[j], bf = bh[H + j], bg = bh[2 * H + j],
                  bo = bh[3 * H + j];
#pragma unroll
      for (int r = 0; r < RRT; ++r) {
        const int n = r0 + r;
        const float ig = sigmoidf(acc[0][r] + bi);
        const float fg = sigmoidf(acc[1][r] + bf);
        const float gg = tanhf(acc[2][r] + bg);
        const float og = sigmoidf(acc[3][r] + bo);
        const float cn = fg * c[n * hs + j] + ig * gg;
        const float hn = og * tanhf(cn);
        c[n * hs + j] = cn;
        h_next[n * hs + j] = hn;
        if (gates && n < nvalid) {
          float* gr = gates + (n0 + n) * 4 * H + j;
          gr[0] = ig;
          gr[H] = fg;
          gr[2 * H] = gg;
          gr[3 * H] = og;
          h_out[(n0 + n) * H + j] = hn;
          c_out[(n0 + n) * H + j] = cn;
        }
      }
    } else {
      float ai[3][RRT], ah[3][RRT];
      zero_acc(ai);
      zero_acc(ah);
      fma_cols<3>(ai, e + r0 * es, es, Wti + j, GH, H, E);
      fma_cols<3>(ah, h + r0 * hs, hs, Wth + j, GH, H, H);
      const float* bi = p + net.bi;
      const float br = bi[j], bz = bi[H + j], bn = bi[2 * H + j];
      const float bq = p[net.bh + j];
#pragma unroll
      for (int r = 0; r < RRT; ++r) {
        const int n = r0 + r;
        const float rg = sigmoidf(ai[0][r] + br + ah[0][r]);
        const float zg = sigmoidf(ai[1][r] + bz + ah[1][r]);
        const float q = ah[2][r] + bq;
        const float ng = tanhf(ai[2][r] + bn + rg * q);
        const float hn = (1.f - zg) * ng + zg * h[n * hs + j];
        h_next[n * hs + j] = hn;
        if (gates && n < nvalid) {
          float* gr = gates + (n0 + n) * 4 * H + j;
          gr[0] = rg;
          gr[H] = zg;
          gr[2 * H] = ng;
          gr[3 * H] = q;
          h_out[(n0 + n) * H + j] = hn;
        }
      }
    }
  }
}

// out[n][o] = h[n] . Whead[o] + b[o], o < 6, one thread per (row, output).
__device__ void head_forward(const RnnNet& net, const float* p, const float* h,
                             int hs, float* out, int rows) {
  for (int item = threadIdx.x; item < rows * RHEAD; item += RNT) {
    const int n = item / RHEAD, o = item % RHEAD;
    const float* w = p + net.head_w + (long)o * net.H;
    float acc = 0.f;
    for (int k = 0; k < net.H; ++k)
      acc = fmaf(h[n * hs + k], __ldg(w + k), acc);
    out[n * ROST + o] = acc + p[net.head_b + o];
  }
}

inline cudaError_t launch_transpose(const RnnNet& net, const float* p,
                                    float* pt, cudaStream_t stream) {
  transpose_kernel<<<64, 256, 0, stream>>>(net, p, pt);
  return cudaGetLastError();
}

}  // namespace
