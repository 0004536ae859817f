// K8 + K9: the SGD phase of the recurrent (GRU / LSTM) PPO learner, and one
// minibatch's sequence-replay gradient.
//
// Replaces warehouse_tpu/pallas/sgd_rnn.py ppo_rnn_sgd_phase_pallas (:551;
// body _sgd_rnn_kernel :317 with _seq_fwd_bwd :79) and
// ppo_rnn_minibatch_grads_pallas (:665; body _grads_rnn_kernel :397).
// Minibatch m is env columns [m B/M, (m+1) B/M) of the trajectory: N = B/M *
// A sequences of T steps, replayed from the rollout-start carry h0 with no
// carry reset inside the chunk (the trainer only lets an episode end on a
// chunk's last step). One optimizer step is seven launches on the caller's
// stream, six for the gradient (K9, wh_rnn_sgd_grads):
//
//   (a) transpose_kernel: the forward matrices as [in, out] (rnn_cell.cuh).
//   (b) rnn_fwd_kernel: a CTA owns a tile of 32 sequences and loops over T
//       itself: encoder, cell, head and the clipped-PPO loss chain per row
//       (loss_row, shared with the PPO learner). It stores, per step, the
//       encoder activations, the post-activation gates, the carry sequence
//       h_0..h_T (and c) and the head deltas in device memory, and one row
//       of metric sums per tile.
//   (c) rnn_bwd_kernel: the same tiles in reverse time with dh (and dc) in
//       shared memory: the cell's adjoint from the stored gates
//       (sgd_rnn.py:229-311; GRU's r * (Whn h + bhn) term gives dq = dpn r
//       for Whn, bhn and dh_prev, and dr = dpn q), dh_prev and de as
//       products with W [out, in], the encoder's deltas. It writes every
//       pre-activation delta.
//   (d) wgrad_kernel, (e) reduce_kernel, (f) metrics_kernel of
//       mlp_learner.cuh: every dW = delta^T prev over the T N rows as
//       split-K products without atomics, the partials summed in a fixed
//       order, the metric sums.
//
// K8 (wh_rnn_sgd_clip_adam) follows each gradient with adam_kernel, the
// optax clip + Adam step of the PPO learner. Every sum runs in an order
// fixed by the shapes alone, so a rerun gives the same bits.
//
// The TPU kernel keeps only h and the head deltas and recomputes encoder
// and gates in the backward sweep, because its fast memory is small; this
// card has the device memory to store them (~0.4 GB of scratch at config 4,
// reused by every step), which saves the backward sweep one forward's
// products. The weights (~450-580 KB at hidden 128) do not fit one SM's
// shared memory and are read through L2; a CTA's shared memory holds its 32
// rows' activations (fwd ~97 KB, bwd ~132 KB for the GRU and ~148 KB for the
// LSTM at hidden 128).
// The bound is the FMA loops on the CUDA cores: per step ~15 GFLOP forward,
// ~13 backward and ~15 in the weight gradients at config 4.
//
// bf16 operands (matmul_dtype="bfloat16", _seq_fwd_bwd's dot at
// sgd_rnn.py:116-119), GRU and LSTM alike: the two tile kernels, the
// transposed copy and wgrad_kernel take the flag BF of rnn_cell.cuh and
// mlp_learner.cuh, chosen per call of wh_rnn_sgd_grads. The observation
// tile is rounded where it is staged; in the backward every product (the
// head's adjoint, dp / dq times Wh and Wi, the encoder's deltas times W)
// rounds both operands where it reads them, and the gate adjoints, tanh',
// the carries and the bias sums stay float32. The TPU kernel recomputes the
// forward in its backward sweep from the same rounded operands, so the
// stored activations are the values it recomputes.

#include <cuda_runtime.h>

#include "mlp_learner.cuh"
#include "rnn_cell.cuh"

namespace {

constexpr int RTILE = 32;  // sequences per tile

struct RnnScratch {
  float* pt;          // [n_params] transposed forward matrices
  float* act[MAXE];   // [T N, E_l] encoder activations
  float* dz[MAXE];    // [T N, E_l] their deltas
  float* hs;          // [(T + 1) N, H] h_0 .. h_T
  float* cs;          // [(T + 1) N, H] c_0 .. c_T (LSTM)
  float* gates;       // [T N, 4 H] GRU r, z, n, q; LSTM i, f, g, o
  float* dp;          // [T N, G H] gate pre-activation deltas
  float* dq;          // [T N, H] GRU: delta of q = Whn h + bhn
  float* dout;        // [T N, OST] head deltas
  float* part;        // [S, n_params] gradient partials
  float* sq;          // [n_params / RED] sums of squares
  float* met;         // [n_tiles, 4] metric sums per tile
  int S;
  long n_tiles, n_sq;
};

long carve_rnn(const RnnNet& net, int T, long N, float* base, RnnScratch* sc) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const long TN = (long)T * N;
  sc->pt = take(net.n_params);
  for (int l = 0; l < net.n_enc; ++l) {
    sc->act[l] = take(TN * net.enc_out[l]);
    sc->dz[l] = take(TN * net.enc_out[l]);
  }
  sc->hs = take((TN + N) * net.H);
  sc->cs = net.lstm ? take((TN + N) * net.H) : nullptr;
  sc->gates = take(TN * 4 * net.H);
  sc->dp = take(TN * net.G * net.H);
  sc->dq = net.lstm ? nullptr : take(TN * net.H);
  sc->dout = take(TN * OST);
  sc->S = (int)n_splits(TN);
  sc->part = take(sc->S * net.n_params);
  sc->n_sq = (net.n_params + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->n_tiles = (N + RTILE - 1) / RTILE;
  sc->met = take(sc->n_tiles * 4);
  return off;
}

struct SeqArgs {
  RnnNet net;
  Batch bt;       // bt.nb = N sequences, bt.N = T N samples
  RnnScratch sc;
  Coefs c;
  int T;
  const float* params;
  const float* scal;     // ent_coef, kl_coeff
  const float *h0, *c0;  // [B, A, H] rollout-start carry
};

size_t fwd_smem(const RnnNet& net) {
  return sizeof(float) * ((size_t)RTILE * (round4(net.D) + 2 * enc_max(net) +
                                           3 * net.H + OST + 4) + 4);
}

size_t bwd_smem(const RnnNet& net) {
  return sizeof(float) * (size_t)RTILE *
         (3 * net.H + net.G * net.H + 2 * enc_max(net) + OST);
}

// ---- (b) forward over T, loss -------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(RNT) rnn_fwd_kernel(SeqArgs p) {
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const Batch& bt = p.bt;
  const int H = net.H, D = net.D, xs = round4(net.D), emax = enc_max(net);
  const long N = bt.nb;
  float* xa = smem;
  float* ea = xa + RTILE * xs;
  float* eb = ea + RTILE * emax;
  float* ha = eb + RTILE * emax;
  float* hb = ha + RTILE * H;
  float* cs = hb + RTILE * H;
  float* outs = cs + RTILE * H;
  float* met = outs + RTILE * OST;
  float* macc = met + RTILE * 4;
  const int tid = threadIdx.x;
  const float ent_coef = p.scal[0], kl_coeff = p.scal[1];
  float* h_out = p.sc.hs + N * H;  // row t N + n holds h_{t+1}
  float* c_out = net.lstm ? p.sc.cs + N * H : nullptr;

  for (long tile = blockIdx.x; tile < p.sc.n_tiles; tile += gridDim.x) {
    const long n0 = tile * RTILE;
    const int nvalid = N - n0 < RTILE ? (int)(N - n0) : RTILE;
    for (int idx = tid; idx < RTILE * H; idx += RNT) {
      const int n = idx / H, j = idx % H;
      const bool live = n < nvalid;
      const long src = (bt.mb_off + n0 + n) * H + j;
      const float hv = live ? p.h0[src] : 0.f;
      const float cv = live && net.lstm ? p.c0[src] : 0.f;
      ha[idx] = hv;
      cs[idx] = cv;
      if (live) {
        p.sc.hs[(n0 + n) * H + j] = hv;
        if (net.lstm) p.sc.cs[(n0 + n) * H + j] = cv;
      }
    }
    for (int idx = tid; idx < RTILE * xs; idx += RNT) xa[idx] = 0.f;
    if (tid < 4) macc[tid] = 0.f;
    __syncthreads();

    float *h = ha, *h_next = hb;
    for (int t = 0; t < p.T; ++t) {
      const long q0 = (long)t * N + n0;  // the tile's first sample row
      for (int idx = tid; idx < RTILE * D; idx += RNT) {
        const int n = idx / D, f = idx % D;
        xa[n * xs + f] =
            rbf<BF>(n < nvalid ? bt.obs[bt.row(q0 + n) * D + f] : 0.f);
      }
      __syncthreads();
      const float* x = xa;
      int xw = xs, in = D;
      float *y = ea, *spare = eb;
      for (int l = 0; l < net.n_enc; ++l) {
        enc_layer<BF>(p.sc.pt + net.enc_w[l], p.params + net.enc_b[l], x, xw, in,
                  y, net.enc_out[l], net.enc_out[l], RTILE, p.sc.act[l], q0,
                  nvalid);
        __syncthreads();
        x = y;
        xw = in = net.enc_out[l];
        float* tmp = y;
        y = spare;
        spare = tmp;
      }
      cell_forward<BF>(net, p.params, p.sc.pt, x, xw, h, h_next, cs, H, RTILE,
                       p.sc.gates, h_out, c_out, q0, nvalid);
      __syncthreads();
      float* tmp = h;
      h = h_next;
      h_next = tmp;
      head_forward<BF>(net, p.params, h, H, outs, RTILE);
      __syncthreads();

      if (tid < RTILE) {
        float* o = outs + tid * OST;
        float* m = met + tid * 4;
        if (tid < nvalid) {
          loss_row(o, bt.row(q0 + tid), bt, p.c, ent_coef, kl_coeff, m);
          for (int r = 0; r < NHEAD; ++r) p.sc.dout[(q0 + tid) * OST + r] = o[r];
        } else {
          for (int k = 0; k < 4; ++k) m[k] = 0.f;
        }
      }
      __syncthreads();
      if (tid < 4) {  // fixed-order sums over the tile's rows, then over t
        float s = 0.f;
        for (int n = 0; n < RTILE; ++n) s += met[n * 4 + tid];
        macc[tid] += s;
      }
    }
    __syncthreads();
    if (tid < 4) p.sc.met[tile * 4 + tid] = macc[tid];
    __syncthreads();
  }
}

// ---- (c) backward over T ------------------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(RNT) rnn_bwd_kernel(SeqArgs p) {
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const int H = net.H, E = net.E, GH = net.G * net.H, emax = enc_max(net);
  const bool lstm = net.lstm;
  const long N = p.bt.nb;
  float* dh = smem;
  float* dc = dh + RTILE * H;
  float* dqs = dc + RTILE * H;
  float* dps = dqs + RTILE * H;
  float* da = dps + RTILE * GH;
  float* db = da + RTILE * emax;
  float* outs = db + RTILE * emax;
  const int tid = threadIdx.x;
  const float* Whead = p.params + net.head_w;
  const float* Wh = p.params + net.wh;
  const float* Wi = p.params + net.wi;

  for (long tile = blockIdx.x; tile < p.sc.n_tiles; tile += gridDim.x) {
    const long n0 = tile * RTILE;
    const int nvalid = N - n0 < RTILE ? (int)(N - n0) : RTILE;
    for (int idx = tid; idx < RTILE * H; idx += RNT) dh[idx] = dc[idx] = 0.f;
    __syncthreads();

    for (int t = p.T - 1; t >= 0; --t) {
      const long q0 = (long)t * N + n0;
      for (int idx = tid; idx < RTILE * OST; idx += RNT)
        outs[idx] = idx / OST < nvalid ? p.sc.dout[q0 * OST + idx] : 0.f;
      __syncthreads();

      // The cell's adjoint, elementwise per (row, unit).
      for (int idx = tid; idx < RTILE * H; idx += RNT) {
        const int n = idx / H, j = idx % H;
        const bool live = n < nvalid;
        float d = dh[idx];
#pragma unroll
        for (int o = 0; o < NHEAD; ++o)
          d = fmaf(rbf<BF>(outs[n * OST + o]), rbf<BF>(__ldg(Whead + o * H + j)),
                   d);
        float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f, hp = 0.f;
        if (live) {
          const float* gr = p.sc.gates + (q0 + n) * 4 * H + j;
          g0 = gr[0], g1 = gr[H], g2 = gr[2 * H], g3 = gr[3 * H];
          hp = p.sc.hs[(q0 + n) * H + j];
        }
        float* dpr = dps + n * GH + j;
        if (lstm) {
          const float ig = g0, fg = g1, gg = g2, og = g3;
          float c_cur = 0.f, c_prev = 0.f;
          if (live) {
            c_cur = p.sc.cs[(q0 + N + n) * H + j];
            c_prev = p.sc.cs[(q0 + n) * H + j];
          }
          const float tc = tanhf(c_cur);
          const float d_o = d * tc;
          const float dcv = dc[idx] + d * og * (1.f - tc * tc);
          dc[idx] = dcv * fg;
          dh[idx] = 0.f;
          dpr[0] = dcv * gg * ig * (1.f - ig);
          dpr[H] = dcv * c_prev * fg * (1.f - fg);
          dpr[2 * H] = dcv * ig * (1.f - gg * gg);
          dpr[3 * H] = d_o * og * (1.f - og);
        } else {
          const float rg = g0, zg = g1, ng = g2, q = g3;
          const float dpn = d * (1.f - zg) * (1.f - ng * ng);
          const float dpz = d * (hp - ng) * zg * (1.f - zg);
          dh[idx] = d * zg;
          dpr[0] = dpn * q * rg * (1.f - rg);
          dpr[H] = dpz;
          dpr[2 * H] = dpn;
          dqs[idx] = dpn * rg;
          if (live) p.sc.dq[(q0 + n) * H + j] = dpn * rg;
        }
        if (live) {
          float* gd = p.sc.dp + (q0 + n) * GH + j;
          for (int g = 0; g < net.G; ++g) gd[g * H] = dpr[g * H];
        }
      }
      __syncthreads();

      // dh_prev += dp Wh (GRU: the r, z columns, then dq Whn);
      // de = dp Wi, times the last encoder layer's tanh'.
      const float* a_last = p.sc.act[net.n_enc - 1];
      float* dz_last = p.sc.dz[net.n_enc - 1];
      for (int item = tid; item < (H + E) * (RTILE / RRT); item += RNT) {
        const int col = item % (H + E), r0 = item / (H + E) * RRT;
        float acc[1][RRT];
        zero_acc(acc);
        if (col < H) {
          fma_cols<1, BF, BF>(acc, dps + r0 * GH, GH, Wh + col, H, 0,
                              lstm ? GH : 2 * H);
          if (!lstm)
            fma_cols<1, BF, BF>(acc, dqs + r0 * H, H,
                                Wh + (long)2 * H * H + col, H, 0, H);
#pragma unroll
          for (int r = 0; r < RRT; ++r) dh[(r0 + r) * H + col] += acc[0][r];
        } else {
          const int i = col - H;
          fma_cols<1, BF, BF>(acc, dps + r0 * GH, GH, Wi + i, E, 0, GH);
#pragma unroll
          for (int r = 0; r < RRT; ++r) {
            const int n = r0 + r;
            float dz = 0.f;
            if (n < nvalid) {
              const float a = a_last[(q0 + n) * E + i];
              dz = acc[0][r] * (1.f - a * a);
              dz_last[(q0 + n) * E + i] = dz;
            }
            da[n * E + i] = dz;
          }
        }
      }
      __syncthreads();

      // The encoder's earlier layers.
      float *d_cur = da, *d_prev = db;
      for (int l = net.n_enc - 1; l > 0; --l) {
        const int out = net.enc_out[l], in = net.enc_in[l];
        const float* W = p.params + net.enc_w[l];
        for (int item = tid; item < in * (RTILE / RRT); item += RNT) {
          const int i = item % in, r0 = item / in * RRT;
          float acc[1][RRT];
          zero_acc(acc);
          fma_cols<1, BF, BF>(acc, d_cur + r0 * out, out, W + i, in, 0, out);
#pragma unroll
          for (int r = 0; r < RRT; ++r) {
            const int n = r0 + r;
            float dz = 0.f;
            if (n < nvalid) {
              const float a = p.sc.act[l - 1][(q0 + n) * in + i];
              dz = acc[0][r] * (1.f - a * a);
              p.sc.dz[l - 1][(q0 + n) * in + i] = dz;
            }
            d_prev[n * in + i] = dz;
          }
        }
        __syncthreads();
        float* tmp = d_cur;
        d_cur = d_prev;
        d_prev = tmp;
      }
    }
    __syncthreads();
  }
}

// ---- host side ----------------------------------------------------------------

bool make_seq(int n_enc, const int* dims, int H, int lstm, int T, long B,
              int A, int M, int mb, const float* obs, SeqArgs* sa) {
  if (!make_rnn_net(n_enc, dims, H, lstm, &sa->net) ||
      !batch_rows(T, B, A, M, mb, sa->net.D, obs, &sa->bt))
    return false;
  sa->T = T;
  return true;
}

// Every weight gradient from the stored activations and deltas, reduced
// into `grads` (its sums of squares into sc.sq), and the metric sums.
cudaError_t launch_rnn_tail(const SeqArgs& sa, float* grads, float* sums,
                            bool bf16, cudaStream_t stream) {
  const RnnNet& net = sa.net;
  const RnnScratch& sc = sa.sc;
  const int H = net.H, E = net.E, GH = net.G * net.H;
  const long N = sa.bt.nb;
  WArgs wa;
  wa.bt = sa.bt;
  wa.n_params = net.n_params;
  wa.part = sc.part;
  wa.chunk = ((sa.bt.N + sc.S - 1) / sc.S + NC - 1) / NC * NC;
  int tiles = 0, k = 0;
  for (int l = 0; l < net.n_enc; ++l)
    wa.t[k++] = wtask(l == 0 ? nullptr : sc.act[l - 1], sc.dz[l],
                      net.enc_out[l], net.enc_in[l], net.enc_out[l],
                      net.enc_w[l], net.enc_b[l], &tiles);
  wa.t[k++] = wtask(sc.act[net.n_enc - 1], sc.dp, GH, E, GH, net.wi, net.bi,
                    &tiles);
  if (net.lstm) {
    wa.t[k++] = wtask(sc.hs, sc.dp, GH, H, GH, net.wh, net.bh, &tiles);
  } else {
    wa.t[k++] = wtask(sc.hs, sc.dp, GH, H, 2 * H, net.wh, -1, &tiles);
    wa.t[k++] = wtask(sc.hs, sc.dq, H, H, H, net.wh + (long)2 * H * H, net.bh,
                      &tiles);
  }
  wa.t[k++] = wtask(sc.hs + N * H, sc.dout, OST, H, NHEAD, net.head_w,
                    net.head_b, &tiles);
  wa.n_layers = k;
  cudaError_t e = launch_wgrad_kernel(wa, tiles, sc.S, bf16, stream);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<(unsigned)sc.n_sq, RED, 0, stream>>>(sc.part, sc.S,
                                                       net.n_params, grads,
                                                       sc.sq);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  metrics_kernel<<<1, 128, 0, stream>>>(sc.met, sc.n_tiles, sums);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the larger of the two tile kernels in bytes, or 0 for
// unsupported widths.
extern "C" long wh_rnn_sgd_smem_bytes(int n_enc, const int* dims, int H,
                                      int lstm) {
  RnnNet net;
  if (!make_rnn_net(n_enc, dims, H, lstm, &net)) return 0;
  const size_t f = fwd_smem(net), b = bwd_smem(net);
  return (long)(f > b ? f : b);
}

// Floats of scratch the two entry points below share, or 0 for an
// unsupported shape.
extern "C" long wh_rnn_sgd_workspace_floats(int n_enc, const int* dims, int H,
                                            int lstm, int T, long B, int A,
                                            int M) {
  SeqArgs sa;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa)) return 0;
  return carve_rnn(sa.net, T, sa.bt.nb, nullptr, &sa.sc);
}

namespace {

// (b) and (c) of one gradient, their shared memory opted in.
template <bool BF>
cudaError_t launch_seq(const SeqArgs& sa, cudaStream_t stream) {
  const size_t fs = fwd_smem(sa.net), bs = bwd_smem(sa.net);
  cudaError_t e = cudaFuncSetAttribute(
      rnn_fwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fs);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(rnn_bwd_kernel<BF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bs);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)sa.sc.n_tiles;
  rnn_fwd_kernel<BF><<<grid, RNT, fs, stream>>>(sa);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  rnn_bwd_kernel<BF><<<grid, RNT, bs, stream>>>(sa);
  return cudaGetLastError();
}

}  // namespace

// K9: the sequence-replay loss and gradient of minibatch mb from the
// rollout-start carry h0 (and c0 for the LSTM), [B, A, H]. `grads` gets the
// gradient in the packed layout, sums[0..3] the metric sums (min surrogate,
// max squared value error, entropy, old_lp - lp); the workspace keeps the
// gradient's sums of squares for wh_rnn_sgd_clip_adam. bf16 != 0: every
// product on bf16 operands (matmul_dtype="bfloat16").
extern "C" int wh_rnn_sgd_grads(
    int n_enc, const int* dims, int H, int lstm, int T, long B, int A, int M,
    int mb, const float* obs, const int* action, const float* old_lp,
    const float* old_v, const float* adv, const float* target,
    const unsigned char* mask, const float* h0, const float* c0,
    const float* params, const float* scal, float clip_eps, float clip_lo,
    float clip_hi, float value_coef, float inv_n, float* work, float* grads,
    float* sums, int bf16, void* stream_) {
  SeqArgs sa;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, mb, obs, &sa) ||
      (lstm && !c0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  sa.bt.action = action;
  sa.bt.old_lp = old_lp;
  sa.bt.old_v = old_v;
  sa.bt.adv = adv;
  sa.bt.target = target;
  sa.bt.mask = mask;
  carve_rnn(sa.net, T, sa.bt.nb, work, &sa.sc);
  sa.c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  sa.params = params;
  sa.scal = scal;
  sa.h0 = h0;
  sa.c0 = c0;

  cudaError_t e = launch_transpose(sa.net, params, sa.sc.pt, stream, bf16);
  if (e != cudaSuccess) return (int)e;
  e = bf16 ? launch_seq<true>(sa, stream) : launch_seq<false>(sa, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_rnn_tail(sa, grads, sums, bf16 != 0, stream);
}

// K8's optimizer step `step` after wh_rnn_sgd_grads on the same workspace:
// clip by the global norm of `grads`, then Adam on params / m / v in place
// with lr_row[step], bc1_row[step], bc2_row[step].
extern "C" int wh_rnn_sgd_clip_adam(
    int n_enc, const int* dims, int H, int lstm, int T, long B, int A, int M,
    int step, float* params, float* m, float* v, const float* grads,
    const float* lr_row, const float* bc1_row, const float* bc2_row,
    float max_grad_norm, float b1, float one_m_b1, float b2, float one_m_b2,
    float eps, float* work, void* stream_) {
  SeqArgs sa;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa) || step < 0)
    return (int)cudaErrorInvalidValue;
  carve_rnn(sa.net, T, sa.bt.nb, work, &sa.sc);
  const AdamArgs p = {sa.net.n_params, sa.sc.n_sq, grads, sa.sc.sq, params, m,
                      v, lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
