// K11 + K12: the SGD phase of the CNN PPO learner, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd_cnn.py ppo_cnn_sgd_phase_pallas (:482;
// body _cnn_sgd_kernel :271 with _cnn_block_grads :201, _loss_and_dout
// sgd.py:68 and _clip_adam_step sgd.py:226) and
// ppo_cnn_minibatch_grads_pallas (:595; the same body with emit_grads).
// Minibatch m is env columns [m B/M, (m+1) B/M) of the trajectory, N = T *
// B/M * A samples. One optimizer step is seven launches on the caller's
// stream, six for the gradient (K12, wh_cnn_sgd_grads):
//
//   (a) trunk_transpose_kernel: the trunk's kernel as [in, out] (cnn_net.cuh).
//   (b) cnn_fwd_bwd_kernel: persistent CTAs loop over tiles of 32 samples,
//       or of as many as fit its shared memory (sgd_tile_rows: 8 on the
//       9 x 9 global view).
//       Per tile: both convolutions, the trunk, the head, the clipped-PPO
//       loss chain per row (loss_row, shared with the MLP learner), then
//       backward in place over the tile's shared memory: the trunk's delta,
//       its product with the trunk kernel masked by the second conv's relu
//       (routed on z > 0, sgd_cnn.py:263), the second conv's transposed
//       convolution masked by the first conv's relu. The conv kernels'
//       gradients never leave the SM: one thread owns a 4 x 4 (oc, ic)
//       block of one tap (or one bias) and accumulates it in registers over
//       the rows and valid positions of every tile of its CTA, directly in
//       the 3x3 basis, and the CTA writes one partial at the end. The
//       trunk's input and output, its delta and the head's delta go to
//       device memory for (c).
//   (c) wgrad_kernel of mlp_learner.cuh: the trunk's and the head's dW =
//       delta^T prev as split-K products over the N samples, no atomics.
//   (d) reduce_kernel twice: the conv partials of (b) summed in CTA order,
//       the dense partials of (c) in split order; sums of squares per 256
//       gradients.
//   (e) metrics_kernel: the metric sums of the step in a fixed order.
//
// K11 (wh_cnn_sgd_clip_adam) follows each gradient with adam_kernel, the
// optax clip + Adam step of the MLP learner, on the packed vector: clip's
// global norm and Adam are elementwise, so they are the same in the packed
// layout as in flax's. Every sum runs in an order fixed by the shapes and
// the card's SM count, so a rerun gives the same bits.
//
// The TPU kernel accumulates the conv gradients in the unrolled dense basis
// and folds them onto the 3x3 kernels before the optimizer step, then
// rebuilds the unrolled matrices; here the convolution and its gradient are
// computed in the 3x3 basis, so neither step exists. The trunk's kernel
// (413 KB at hidden 128) does not fit one SM's shared memory and is read
// through L2; a CTA's shared memory holds the conv kernels and its tile's
// activations (~212 KB for 32 rows at S = 5, hidden 128). With the global
// observation's 5 channels the obs grid is padded to 8 in shared memory
// (cnn_net.cuh); the pad channels' gradient blocks are computed and dropped. The bound is the FMA loops on
// the CUDA cores: per sample ~0.4 MFLOP forward, ~0.38 backward to the
// layers' inputs and ~0.4 in the weight gradients.
//
// bf16 operands (matmul_dtype="bfloat16", _cnn_block_grads' dot at
// sgd_cnn.py:213-216): cnn_fwd_bwd_kernel, the trunk's transposed copy and
// wgrad_kernel take the flag BF (cnn_net.cuh, mlp_learner.cuh), chosen per
// call of wh_cnn_sgd_grads, at S = 5 and the global view's S = 9 alike. The
// obs rows are rounded where they are staged; the backward products (the
// head's adjoint, the trunk delta times the trunk kernel, conv 1's
// transposed convolution, the conv weight gradients) round both operands
// where they read them. The relu masks, tanh', the bias sums and the conv
// partials stay float32.
//
// Tie rules: the relu passes gradient where its output is positive (z > 0),
// which is also torch's; the surrogate-min and value-max ties follow
// loss_row (sgd.cu's note).

#include <cuda_runtime.h>

#include "cnn_net.cuh"
#include "mlp_learner.cuh"

namespace {

constexpr long MAXG = 1024;  // CTAs of (b) at most: rows of conv partials

struct CnnScratch {
  float* wt_t;    // [trunk_in, H] the trunk's kernel transposed
  float* a1;      // [N, trunk_in] trunk inputs
  float* h;       // [N, H] trunk outputs
  float* dzt;     // [N, H] their deltas
  float* dout;    // [N, OST] head deltas
  float* part;    // [S, n_params - n_conv] dense gradient partials
  float* cpart;   // [MAXG, n_conv] conv gradient partials, one row per CTA
  float* sq;      // [n_sq] sums of squares: the conv blocks, then the dense
  float* met;     // [n_tiles, 4] metric sums per tile
  int S;
  int rows;       // samples per tile
  long n_tiles, n_sq_conv, n_sq;
};

// Bytes of a CTA's shared memory with `rows` samples per tile: the conv
// kernels, then each row's buffers and its 4 metric terms.
size_t tile_smem(const CnnNet& net, int rows) {
  return sizeof(float) * ((size_t)conv_smem_floats(net) +
                          (size_t)rows * (cnn_row_floats(net) + 4));
}

// Samples per tile: the most of CROWS, in steps of RRT, that fit the
// device's shared memory; 0 when not even RRT do.
int sgd_tile_rows(const CnnNet& net) {
  const size_t limit = smem_optin_limit();
  int rows = CROWS;
  while (rows > 0 && tile_smem(net, rows) > limit) rows -= RRT;
  return rows;
}

long carve_cnn(const CnnNet& net, long N, float* base, CnnScratch* sc) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const long n_dense = net.n_params - net.n_conv;
  sc->wt_t = take((long)net.H * net.trunk_in);
  sc->a1 = take(N * net.trunk_in);
  sc->h = take(N * net.H);
  sc->dzt = take(N * net.H);
  sc->dout = take(N * OST);
  sc->S = (int)n_splits(N);
  sc->part = take(sc->S * n_dense);
  sc->rows = sgd_tile_rows(net);
  if (sc->rows < 1) return 0;
  sc->n_tiles = (N + sc->rows - 1) / sc->rows;
  sc->cpart = take((sc->n_tiles < MAXG ? sc->n_tiles : MAXG) * net.n_conv);
  sc->n_sq_conv = (net.n_conv + RED - 1) / RED;
  sc->n_sq = sc->n_sq_conv + (n_dense + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->met = take(sc->n_tiles * 4);
  return off;
}

struct CnnArgs {
  CnnNet net;
  Batch bt;
  CnnScratch sc;
  Coefs c;
  const float* params;
  const float* scal;  // ent_coef, kl_coeff
};

// Shared memory of a CTA; of the smallest tile when not even that fits, so
// that the caller's comparison with the limit fails.
size_t cnn_sgd_smem(const CnnNet& net) {
  const int rows = sgd_tile_rows(net);
  return tile_smem(net, rows ? rows : RRT);
}

// acc[a][b] += sum over the tile's rows and the valid output positions of
// tap k of d[n][po OC + oc0 + a] x[n][pi IC + ic0 + b]: one 4 x 4 block of
// one tap of a conv kernel's gradient; with BF on bf16-rounded operands.
template <bool BF>
__device__ __forceinline__ void conv_wgrad_block(
    float (&acc)[4][4], const float* d, int ds, int OC, const float* x,
    int xs, int IC, int S, int k, int oc0, int ic0, int rows) {
  const int kr = k / 3 - 1, kc = k % 3 - 1;
  const int ro_lo = kr < 0 ? -kr : 0, ro_hi = kr > 0 ? S - kr : S;
  const int co_lo = kc < 0 ? -kc : 0, co_hi = kc > 0 ? S - kc : S;
  for (int n = 0; n < rows; ++n) {
    for (int ro = ro_lo; ro < ro_hi; ++ro) {
      for (int co = co_lo; co < co_hi; ++co) {
        const int po = ro * S + co, pi = (ro + kr) * S + co + kc;
        const float4 dv = rbf4<BF>(
            *reinterpret_cast<const float4*>(d + n * ds + po * OC + oc0));
        const float4 xv = rbf4<BF>(
            *reinterpret_cast<const float4*>(x + n * xs + pi * IC + ic0));
        const float da[4] = {dv.x, dv.y, dv.z, dv.w};
        const float xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(da[a], xb[b], acc[a][b]);
      }
    }
  }
}

// The sum over the tile's rows and positions of d[n][po OC + oc]: a conv
// bias's gradient.
__device__ __forceinline__ float conv_bgrad(const float* d, int ds, int OC,
                                            int P2, int oc, int rows) {
  float s = 0.f;
  for (int n = 0; n < rows; ++n)
    for (int po = 0; po < P2; ++po) s += d[n * ds + po * OC + oc];
  return s;
}

// ---- (b) forward, loss, backward, conv weight gradients ----------------------

template <bool BF>
__global__ void __launch_bounds__(RNT) cnn_fwd_bwd_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  const Batch& bt = p.bt;
  const int H = net.H, D = net.D, S = net.S, P2 = net.P2;
  const int C0 = net.C0, C0p = net.C0p, C1 = net.C1, C2 = net.C2;
  const int rows = p.sc.rows;  // the tile's samples, at most CROWS
  const ConvW cw = stage_conv<BF>(net, p.params, smem);
  float* xa = smem + conv_smem_floats(net);
  float* a0 = xa + rows * net.xs;
  float* a1 = a0 + rows * net.a0s;
  float* hs = a1 + rows * net.a1s;
  float* outs = hs + rows * H;
  float* met = outs + rows * ROST;
  const int tid = threadIdx.x;
  const float ent_coef = p.scal[0], kl_coeff = p.scal[1];
  const float* Wt = p.params + net.wt;
  const float* Whead = p.params + net.head_w;

  // The thread's share of the conv gradients: a 4 x 4 block of conv 1
  // (role 1) or of conv 0 (role 0), a bias of conv 1 (2) or of conv 0 (3).
  const int per1 = (C2 / 4) * (C1 / 4), per0 = (C1 / 4) * (C0p / 4);
  const int n1 = 9 * per1, n0 = 9 * per0;
  int role = -1, wk = 0, woc = 0, wic = 0;
  if (tid < n1) {
    role = 1, wk = tid / per1, woc = tid % per1 / (C1 / 4) * 4,
    wic = tid % per1 % (C1 / 4) * 4;
  } else if (tid < n1 + n0) {
    const int t = tid - n1;
    role = 0, wk = t / per0, woc = t % per0 / (C0p / 4) * 4,
    wic = t % per0 % (C0p / 4) * 4;
  } else if (tid < n1 + n0 + C2) {
    role = 2, woc = tid - n1 - n0;
  } else if (tid < n1 + n0 + C2 + C1) {
    role = 3, woc = tid - n1 - n0 - C2;
  }
  float wacc[4][4] = {}, bacc = 0.f;
  for (int idx = tid; idx < rows * net.xs; idx += RNT) xa[idx] = 0.f;
  __syncthreads();

  for (long tile = blockIdx.x; tile < p.sc.n_tiles; tile += gridDim.x) {
    const long q0 = tile * rows;
    const int nvalid = bt.N - q0 < rows ? (int)(bt.N - q0) : rows;
    for (int idx = tid; idx < rows * D; idx += RNT) {
      const int n = idx / D, f = idx % D;
      xa[n * net.xs + obs_slot(net, f)] =
          rbf<BF>(n < nvalid ? bt.obs[bt.row(q0 + n) * D + f] : 0.f);
    }
    __syncthreads();

    // Forward; the trunk's input and output rows go to device memory.
    conv_forward<BF>(net, cw, xa, a0, a1, rows);
    for (int idx = tid; idx < nvalid * net.trunk_in; idx += RNT) {
      const int n = idx / net.trunk_in, i = idx % net.trunk_in;
      p.sc.a1[(q0 + n) * net.trunk_in + i] = a1[n * net.a1s + i];
    }
    trunk_forward<BF>(net, p.sc.wt_t, p.params + net.bt, a1, hs, rows, p.sc.h,
                      q0, nvalid);
    __syncthreads();
    cnn_head<BF>(net, p.params, hs, outs, rows);
    __syncthreads();

    if (tid < rows) {
      float* o = outs + tid * OST;
      float* m = met + tid * 4;
      if (tid < nvalid) {
        loss_row(o, bt.row(q0 + tid), bt, p.c, ent_coef, kl_coeff, m);
        for (int r = 0; r < NHEAD; ++r) p.sc.dout[(q0 + tid) * OST + r] = o[r];
      } else {
        for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
        for (int k = 0; k < 4; ++k) m[k] = 0.f;
      }
    }
    __syncthreads();
    if (tid < 4) {  // fixed-order sum over the tile's rows
      float s = 0.f;
      for (int n = 0; n < rows; ++n) s += met[n * 4 + tid];
      p.sc.met[tile * 4 + tid] = s;
    }

    // The trunk's delta, over its output in shared memory.
    for (int idx = tid; idx < rows * H; idx += RNT) {
      const int n = idx / H, j = idx % H;
      float d = 0.f;
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        d = fmaf(rbf<BF>(outs[n * OST + o]), rbf<BF>(__ldg(Whead + o * H + j)),
                 d);
      const float hv = hs[idx];
      const float dz = d * (1.f - hv * hv);
      hs[idx] = dz;
      if (n < nvalid) p.sc.dzt[(q0 + n) * H + j] = dz;
    }
    __syncthreads();

    // Conv 1's delta = (trunk delta . Wt) where its output is positive, over
    // that output; the self-feature columns are inputs and get none.
    for (int item = tid; item < P2 * C2 * (rows / RRT); item += RNT) {
      const int i = item % (P2 * C2), r0 = item / (P2 * C2) * RRT;
      float acc[1][RRT];
      zero_acc(acc);
      fma_cols<1, BF, BF>(acc, hs + r0 * H, H, Wt + i, net.trunk_in, 0, H);
#pragma unroll
      for (int r = 0; r < RRT; ++r) {
        float* a = a1 + (r0 + r) * net.a1s + i;
        *a = *a > 0.f ? acc[0][r] : 0.f;
      }
    }
    __syncthreads();

    // Conv 1's kernel and bias gradients from its delta and its input.
    if (role == 1)
      conv_wgrad_block<BF>(wacc, a1, net.a1s, C2, a0, net.a0s, C1, S, wk, woc,
                           wic, rows);
    else if (role == 2)
      bacc += conv_bgrad(a1, net.a1s, C2, P2, woc, rows);
    __syncthreads();

    // Conv 0's delta = conv 1's transposed convolution of its delta where
    // conv 0's output is positive, over that output.
    for (int item = tid; item < P2 * C1 * (rows / RRT); item += RNT) {
      const int col = item % (P2 * C1), r0 = item / (P2 * C1) * RRT;
      const int pi = col / C1, ic = col % C1, ri = pi / S, ci = pi % S;
      float acc[RRT];
#pragma unroll
      for (int r = 0; r < RRT; ++r) acc[r] = 0.f;
      for (int k = 0; k < 9; ++k) {
        const int ro = ri - (k / 3 - 1), co = ci - (k % 3 - 1);
        if (ro < 0 || ro >= S || co < 0 || co >= S) continue;
        const float* w = cw.w1 + k * C2 * net.ws1 + ic;
        const float* dp = a1 + r0 * net.a1s + (ro * S + co) * C2;
        for (int oc = 0; oc < C2; oc += 4) {
          const float w0 = w[oc * net.ws1], w1 = w[(oc + 1) * net.ws1];
          const float w2 = w[(oc + 2) * net.ws1], w3 = w[(oc + 3) * net.ws1];
#pragma unroll
          for (int r = 0; r < RRT; ++r) {
            const float4 dv = rbf4<BF>(
                *reinterpret_cast<const float4*>(dp + r * net.a1s + oc));
            acc[r] = fmaf(dv.x, w0, acc[r]);
            acc[r] = fmaf(dv.y, w1, acc[r]);
            acc[r] = fmaf(dv.z, w2, acc[r]);
            acc[r] = fmaf(dv.w, w3, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RRT; ++r) {
        float* a = a0 + (r0 + r) * net.a0s + col;
        *a = *a > 0.f ? acc[r] : 0.f;
      }
    }
    __syncthreads();

    // Conv 0's kernel and bias gradients from its delta and the obs grid.
    if (role == 0)
      conv_wgrad_block<BF>(wacc, a0, net.a0s, C1, xa, net.xs, C0p, S, wk, woc,
                           wic, rows);
    else if (role == 3)
      bacc += conv_bgrad(a0, net.a0s, C1, P2, woc, rows);
    __syncthreads();
  }

  // The CTA's conv partial, in the packed layout.
  float* out = p.sc.cpart + (long)blockIdx.x * net.n_conv;
  if (role == 0 || role == 1) {
    const int OC = role ? C2 : C1, IC = role ? C1 : C0;
    const long base = role ? net.w1 : net.w0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (wic + b < IC)  // conv 0's pad channels have no parameter
          out[base + ((long)wk * OC + woc + a) * IC + wic + b] = wacc[a][b];
  } else if (role == 2) {
    out[net.b1 + woc] = bacc;
  } else if (role == 3) {
    out[net.b0 + woc] = bacc;
  }
}

// ---- host side ----------------------------------------------------------------

bool make_cnn(int S, int C0, int C1, int C2, int H, int T, long B, int A,
              int M, int mb, const float* obs, CnnArgs* ca) {
  return make_cnn_net(S, C0, C1, C2, H, &ca->net) &&
         batch_rows(T, B, A, M, mb, ca->net.D, obs, &ca->bt);
}

// The trunk's and the head's weight gradients from the stored rows, every
// partial reduced into `grads` (its sums of squares into sc.sq), and the
// metric sums. `grid` is the CTA count of cnn_fwd_bwd_kernel.
cudaError_t launch_cnn_tail(const CnnArgs& ca, long grid, float* grads,
                            float* sums, bool bf16, cudaStream_t stream) {
  const CnnNet& net = ca.net;
  const CnnScratch& sc = ca.sc;
  const long n_dense = net.n_params - net.n_conv;
  WArgs wa;
  wa.bt = ca.bt;
  wa.n_params = n_dense;  // the dense partials are laid out from the trunk on
  wa.part = sc.part;
  wa.chunk = ((ca.bt.N + sc.S - 1) / sc.S + NC - 1) / NC * NC;
  int tiles = 0;
  wa.t[0] = wtask(sc.a1, sc.dzt, net.H, net.trunk_in, net.H,
                  net.wt - net.n_conv, net.bt - net.n_conv, &tiles);
  wa.t[1] = wtask(sc.h, sc.dout, OST, net.H, NHEAD, net.head_w - net.n_conv,
                  net.head_b - net.n_conv, &tiles);
  wa.n_layers = 2;
  cudaError_t e = launch_wgrad_kernel(wa, tiles, sc.S, bf16, stream);
  if (e != cudaSuccess) return e;
  reduce_kernel<<<(unsigned)sc.n_sq_conv, RED, 0, stream>>>(
      sc.cpart, (int)grid, net.n_conv, grads, sc.sq);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  reduce_kernel<<<(unsigned)(sc.n_sq - sc.n_sq_conv), RED, 0, stream>>>(
      sc.part, sc.S, n_dense, grads + net.n_conv, sc.sq + sc.n_sq_conv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  metrics_kernel<<<1, 128, 0, stream>>>(sc.met, sc.n_tiles, sums);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one cnn_fwd_bwd_kernel CTA in bytes, or 0 for
// unsupported widths.
extern "C" long wh_cnn_sgd_smem_bytes(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  return make_cnn_net(S, C0, C1, C2, H, &net) ? (long)cnn_sgd_smem(net) : 0;
}

// Whether a tile holds fewer than the full CROWS samples on the current
// device (1: a grid larger than the ego window, as the global view's whole
// map; 0: full tiles); -1 for unsupported widths.
extern "C" int wh_cnn_sgd_small_tile(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  return make_cnn_net(S, C0, C1, C2, H, &net) ? sgd_tile_rows(net) < CROWS : -1;
}

// Floats of scratch the two entry points below share, or 0 for an
// unsupported shape.
extern "C" long wh_cnn_sgd_workspace_floats(int S, int C0, int C1, int C2,
                                            int H, int T, long B, int A,
                                            int M) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca)) return 0;
  return carve_cnn(ca.net, ca.bt.N, nullptr, &ca.sc);
}

namespace {

// (b) on a persistent grid of at most MAXG CTAs; its size into *grid.
template <bool BF>
cudaError_t launch_cnn_fwd_bwd(const CnnArgs& ca, long* grid,
                               cudaStream_t stream) {
  const size_t smem = cnn_sgd_smem(ca.net);
  cudaError_t e = persistent_grid(cnn_fwd_bwd_kernel<BF>, smem,
                                  ca.sc.n_tiles < MAXG ? ca.sc.n_tiles : MAXG,
                                  grid, RNT);
  if (e != cudaSuccess) return e;
  cnn_fwd_bwd_kernel<BF><<<(unsigned)*grid, RNT, smem, stream>>>(ca);
  return cudaGetLastError();
}

}  // namespace

// K12: the loss and gradient of minibatch mb. `grads` gets the gradient in
// the packed layout, sums[0..3] the metric sums (min surrogate, max squared
// value error, entropy, old_lp - lp); the workspace keeps the gradient's
// sums of squares for wh_cnn_sgd_clip_adam. bf16 != 0: every product on
// bf16 operands (matmul_dtype="bfloat16").
extern "C" int wh_cnn_sgd_grads(
    int S, int C0, int C1, int C2, int H, int T, long B, int A, int M, int mb,
    const float* obs, const int* action, const float* old_lp,
    const float* old_v, const float* adv, const float* target,
    const unsigned char* mask, const float* params, const float* scal,
    float clip_eps, float clip_lo, float clip_hi, float value_coef,
    float inv_n, float* work, float* grads, float* sums, int bf16,
    void* stream_) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, mb, obs, &ca))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  ca.bt.action = action;
  ca.bt.old_lp = old_lp;
  ca.bt.old_v = old_v;
  ca.bt.adv = adv;
  ca.bt.target = target;
  ca.bt.mask = mask;
  if (carve_cnn(ca.net, ca.bt.N, work, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;  // not one tile fits shared memory
  ca.c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  ca.params = params;
  ca.scal = scal;

  cudaError_t e =
      launch_trunk_transpose(ca.net, params, ca.sc.wt_t, stream, bf16 != 0);
  if (e != cudaSuccess) return (int)e;
  long grid = 0;
  e = bf16 ? launch_cnn_fwd_bwd<true>(ca, &grid, stream)
           : launch_cnn_fwd_bwd<false>(ca, &grid, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_cnn_tail(ca, grid, grads, sums, bf16 != 0, stream);
}

// K11's optimizer step `step` after wh_cnn_sgd_grads on the same workspace:
// clip by the global norm of `grads`, then Adam on params / m / v in place
// with lr_row[step], bc1_row[step], bc2_row[step].
extern "C" int wh_cnn_sgd_clip_adam(
    int S, int C0, int C1, int C2, int H, int T, long B, int A, int M,
    int step, float* params, float* m, float* v, const float* grads,
    const float* lr_row, const float* bc1_row, const float* bc2_row,
    float max_grad_norm, float b1, float one_m_b1, float b2, float one_m_b2,
    float eps, float* work, void* stream_) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca) || step < 0)
    return (int)cudaErrorInvalidValue;
  if (carve_cnn(ca.net, ca.bt.N, work, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {ca.net.n_params, ca.sc.n_sq, grads, ca.sc.sq, params, m,
                      v, lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
