// K3 + K4: the PPO SGD phase of the MLP policy, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd.py ppo_sgd_phase_pallas (:691; body
// _sgd_kernel :309 with _loss_and_dout :68, _block_grads :158 and
// _clip_adam_step :226) and ppo_minibatch_grads_pallas (:818; body
// _grads_kernel :404). Minibatch m is env columns [m B/M, (m+1) B/M) of
// the trajectory: N = T * B/M * A samples in Rows::row order.
//
// One minibatch's gradient (K4, wh_sgd_grads) is stages shaped by their
// products, each a kernel on the caller's stream, with no host
// synchronisation. Every product runs over all N rows at once as a tile
// GEMM (row_stages.cuh on mma_tiles.cuh):
//
//   prep: the minibatch's observation rows gathered into x0 [N, Xs] (zeros
//      to Xs = D rounded to 32; a row's 424-byte stride need not be 16-byte
//      aligned, x0's is), and each hidden layer's W copied zero-padded as
//      the stages read it: [out, in] for the forward, transposed for the
//      dgrads.
//   A fwd: act_l = tanh(act_{l-1} W_l^T + b_l) for each hidden layer (act_0
//      from x0), 64 x 128 tile GEMMs over the N rows, tanh in the epilogue.
//      act_l stays float32: tanh' reads it.
//   C head_loss: tiles of 64 rows of the last layer in shared memory: the
//      6-wide head (5 logits and the value), the clipped-PPO loss chain
//      and its derivative per row (loss_row, shared with the recurrent
//      learner), one row of metric sums per tile in row order, dout to the
//      scratch, and dz_L = (dout W_head) (1 - act_L^2).
//   E dgrad: dz_{l-1} = (dz_l W_l) (1 - act_{l-1}^2) for l = L..2, tile
//      GEMMs on the transposed copies; the first layer needs no input
//      gradient.
//   F wgrad: dW_l = dz_l^T act_{l-1} (x0 for the first layer) and the
//      biases' sums, 128 x 128 tiles split-K over row ranges, one partial
//      per range (wgrad_tn_kernel); the 6-row head on a route of its own
//      (head_wgrad_kernel: 32 columns a CTA, 8 warps over the range's rows,
//      a lane a column) rather than a 128-row tile that is 95% padding.
//   then reduce_kernel (the partials in range order, the sums of squares
//   per 256 gradients) and metrics_kernel (mlp_learner.cuh).
//
// K3 (wh_sgd_clip_adam) follows each gradient with adam_kernel, the optax
// clip + Adam step, on a grid of CTAs that each compute the global norm
// (one CTA took 0.53 ms of a 23 ms phase at config 4, 1.99 at D = 611).
// Every sum runs in an order fixed by the shapes alone, with no atomics,
// so a rerun gives the same bits.
//
// Policy groups (pallas/sgd.py:293-306, _sgd_kernel :309, _grads_kernel
// :404): the params are K MLPs' in group order; sample (t, b, a) goes
// forward and backward through group groups[a]'s params and its weight
// gradients go to that group's slice of the gradient. The stages' rows
// come group after group (GroupSplit, each group's in Rows::row order): A,
// E and F run a launch per group on its row range and its params (prep
// copies every group's weights), C finds a tile's group from the tile
// offsets; the loss still averages over all N samples of the minibatch, the
// metric sums run over every sample, and one global-norm clip and Adam span
// all K groups.
//
// The products (mma_tiles.cuh): with bf16 operands (matmul_dtype=
// "bfloat16", _block_grads' dot at sgd.py:188-191) on the tensor cores as
// m16n8k16 with float32 sums, each operand rounded where the mma packs it,
// so a value both a product and tanh' or a bias sum read (act, dz, dout)
// stays float32 in memory; in float32 as FFMA register blocks on the CUDA
// cores. The head's products (6 wide) run on the CUDA cores on rounded
// operands (rbf). The loss chain, tanh', the bias sums, the clip and Adam
// stay float32.
//
// The bound is the products' rate: per step at config 4 ~4.3 GFLOP
// forward, ~2.2 in the dgrads and ~4.3 in the weight gradients (the first
// layer's K padded from 106 to 128). Every activation and delta goes
// through device memory between the stages (~0.2 GB of scratch at config
// 4, reused by every step), so that each product runs as whole tiles.
//
// Tie rules, as the TPU kernel writes them (_block_grads, sgd.py:170-179):
// a tie of the surrogate min routes the whole gradient to the unclipped
// branch (pg1 <= pg2), a tie of the value max to the unclipped error
// (sq1 >= sq2); jax.grad and torch split such ties 0.5/0.5. Both agree
// at the epoch-0 ratio == 1 ties, where the two branches have the same
// derivative; they differ only at a tie exactly on a clip bound. The
// clip bounds themselves pass gradient 1, as jnp.clip and torch.clamp do.

#include <cuda_runtime.h>

#include "bf16_round.cuh"
#include "mlp_learner.cuh"
#include "mma_tiles.cuh"
#include "row_stages.cuh"

namespace {

constexpr int CB = R;           // rows per stage-C tile: GroupSplit's tiles
constexpr int HPAD = 8;         // stage C's row pad: a warp's 4 x 8 reads
                                // hit 32 distinct banks
constexpr int HW = 32;          // columns per head_wgrad_kernel CTA
constexpr int SF_TARGET = 512;  // stage-F CTAs aimed at, per group
constexpr int MAXSF = 128;      // row ranges of stage F at most
static_assert(MAXT >= MAXL, "a group's hidden layers fit one F launch");

struct SDims {      // the stages' padded widths
  int Xs;           // D rounded to 32: x0's row stride
  int Es[MAXL];     // hidden widths rounded to 32: act / dz row strides
  int Ks[MAXL];     // each layer's K: Xs, then Es[l - 1]
};

SDims make_sdims(const Net& net) {
  SDims sd;
  sd.Xs = rup(net.D, 32);
  for (int l = 0; l < net.n_hidden; ++l) {
    sd.Es[l] = rup(net.L[l].out, 32);
    sd.Ks[l] = l == 0 ? sd.Xs : sd.Es[l - 1];
  }
  return sd;
}

struct StageScratch {
  float* wp[MAXL];    // [K][rup(out_l, 128), Ks_l] W_l as GEMM rows of k
  float* wt[MAXL];    // [K][rup(in_l, 128), Es_l] W_l^T (l >= 1)
  long wp_n[MAXL], wt_n[MAXL];  // one group's floats of each
  float* x0;          // [N, Xs] the observation rows
  float* act[MAXL];   // [N, Es_l] hidden activations
  float* dz[MAXL];    // [N, Es_l] their deltas
  float* dout;        // [N, OST] head deltas
  float* part;        // group g's SF[g] partials of n_params at part_off[g]
  long part_off[MAXK];
  long chunk[MAXK];   // rows per stage-F range of group g
  int SF[MAXK];
  float* sq;          // [K n_sq1] sums of squares, group after group
  float* met;         // [n_tiles, 4] metric sums per stage-C tile
  long n_sq1, n_tiles;
};

long carve_stages(const Net& net, const SDims& sd, const GroupSplit& gs,
                  float* base, StageScratch* sc) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const int L = net.n_hidden, K = gs.K;
  const long N = gs.noff[K];
  int f_tiles = 0;
  for (int l = 0; l < L; ++l) {
    const Layer& y = net.L[l];
    sc->wp_n[l] = (long)rup(y.out, 128) * sd.Ks[l];
    sc->wt_n[l] = l ? (long)rup(y.in, 128) * sd.Es[l] : 0;
    sc->wp[l] = take(K * sc->wp_n[l]);
    sc->wt[l] = l ? take(K * sc->wt_n[l]) : nullptr;
    f_tiles += f_tile_count(y.out, y.in);
  }
  sc->x0 = take(N * sd.Xs);
  for (int l = 0; l < L; ++l) {
    sc->act[l] = take(N * sd.Es[l]);
    sc->dz[l] = take(N * sd.Es[l]);
  }
  sc->dout = take(N * OST);
  long sf = (SF_TARGET + f_tiles - 1) / f_tiles, n_part = 0;
  sf = sf < 1 ? 1 : (sf > MAXSF ? MAXSF : sf);
  for (int g = 0; g < K; ++g) {
    const long Ng = gs.rows[g].N;
    long chunk = (Ng + sf - 1) / sf;
    chunk = (chunk + EN - 1) / EN * EN;
    sc->chunk[g] = chunk;
    sc->SF[g] = (int)((Ng + chunk - 1) / chunk);
    sc->part_off[g] = n_part;
    n_part += sc->SF[g] * net.n_params;
  }
  sc->part = take(n_part);
  sc->n_sq1 = (net.n_params + RED - 1) / RED;
  sc->sq = take(K * sc->n_sq1);
  sc->n_tiles = gs.toff[K];
  sc->met = take(sc->n_tiles * 4);
  return off;
}

struct StageArgs {
  Net net;            // one group's widths
  SDims sd;
  Batch bt;           // the minibatch's fields
  GroupSplit gs;      // its rows by policy group (K = 1: all of them)
  StageScratch sc;
  Coefs c;
  const float* params;  // K groups'
  const float* scal;    // ent_coef, kl_coeff
};

size_t smem_head(const Net& net) {
  return sizeof(float) * CB * (net.L[net.n_hidden].in + HPAD + OST + 4);
}

size_t stage_smem(const Net& net) {
  const size_t s[] = {smem_gemm(), smem_wgrad(), smem_head(net)};
  size_t m = 0;
  for (size_t x : s) m = x > m ? x : m;
  return m;
}

// ---- prep: the observation rows and the padded weight copies ---------------

__global__ void mlp_prep_kernel(StageArgs p) {
  const Net& net = p.net;
  const SDims& sd = p.sd;
  const GroupSplit& gs = p.gs;
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  for (int g = 0; g < gs.K; ++g)
    for (int l = 0; l < net.n_hidden; ++l) {
      const Layer& y = net.L[l];
      const float* W = p.params + g * net.n_params + y.w_off;
      pad_copy(p.sc.wp[l] + g * p.sc.wp_n[l], rup(y.out, 128), sd.Ks[l], W,
               y.out, y.in, false, i0, stride);
      if (l)
        pad_copy(p.sc.wt[l] + g * p.sc.wt_n[l], rup(y.in, 128), sd.Es[l], W,
                 y.out, y.in, true, i0, stride);
    }
  // The observation rows, group after group: a warp a row at a time, the
  // row's offset found once, 4 loads a lane in flight before their stores.
  const int D = net.D, Xs = sd.Xs, lane = threadIdx.x & 31;
  const long warps = stride / 32;
  for (long q = i0 / 32; q < gs.noff[gs.K]; q += warps) {
    int g = 0;
    while (g + 1 < gs.K && q >= gs.noff[g + 1]) ++g;
    const float* src = p.bt.obs + gs.rows[g].row(q - gs.noff[g]) * D;
    float* dst = p.sc.x0 + q * Xs;
    for (int f0 = lane; f0 < Xs; f0 += 128) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = f0 + 32 * u < D ? __ldg(src + f0 + 32 * u) : 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (f0 + 32 * u < Xs) dst[f0 + 32 * u] = v[u];
    }
  }
}

// ---- C: the head, the loss and the last layer's delta ----------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) mlp_head_kernel(StageArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = p.net;
  const GroupSplit& gs = p.gs;
  const int L = net.n_hidden;
  const Layer& hd = net.L[L];
  const int H = hd.in, HC = H + HPAD, Es = p.sd.Es[L - 1];
  float* hsm = smem;             // [CB][HC] the tile's last-layer rows
  float* outs = hsm + CB * HC;   // [CB][OST] head outputs, then deltas
  float* met = outs + CB * OST;  // [CB][4]
  const int tid = threadIdx.x;
  const long tile = blockIdx.x;
  int g = 0;
  while (g + 1 < gs.K && tile >= gs.toff[g + 1]) ++g;
  const Rows& rows = gs.rows[g];
  const long q0 = (tile - gs.toff[g]) * CB, n0 = gs.noff[g] + q0;
  const int nvalid = rows.N - q0 < CB ? (int)(rows.N - q0) : CB;
  const float* params = p.params + g * net.n_params;
  const float* Wh = params + hd.w_off;
  const float* hrow = p.sc.act[L - 1] + n0 * Es;
  for (int i = tid; i < CB * H; i += GNT) {
    const int n = i / H, j = i % H;
    hsm[n * HC + j] = n < nvalid ? hrow[(long)n * Es + j] : 0.f;
  }
  __syncthreads();
  // The head: a warp takes 4 rows at a time, 8 lanes a row over k (k = kl
  // + 8 i), then a sum over the row's 8 lanes per output.
  const int warp = tid >> 5, lane = tid & 31, kl = lane & 7;
  for (int n = 4 * warp + (lane >> 3); n < CB; n += GNT / 8) {
    float a[NHEAD] = {};
    for (int k = kl; k < H; k += 8) {
      const float hv = rbf<BF>(hsm[n * HC + k]);
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        a[o] = fmaf(hv, rbf<BF>(__ldg(Wh + o * H + k)), a[o]);
    }
#pragma unroll
    for (int o = 0; o < NHEAD; ++o)
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        a[o] += __shfl_xor_sync(0xffffffffu, a[o], off);
    if (kl == 0)
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        outs[n * OST + o] = a[o] + __ldg(params + hd.b_off + o);
  }
  __syncthreads();
  if (tid < CB) {
    float* o = outs + tid * OST;
    float* m = met + tid * 4;
    if (tid < nvalid) {
      loss_row(o, rows.row(q0 + tid), p.bt, p.c, p.scal[0], p.scal[1], m);
      for (int r = 0; r < OST; ++r)
        p.sc.dout[(n0 + tid) * OST + r] = r < NHEAD ? o[r] : 0.f;
      for (int r = 0; r < NHEAD; ++r) o[r] = rbf<BF>(o[r]);  // dz's operand
    } else {
      for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
      for (int k = 0; k < 4; ++k) m[k] = 0.f;
    }
  }
  __syncthreads();
  if (tid < 4) {  // fixed-order sum over the tile's rows
    float s = 0.f;
    for (int n = 0; n < CB; ++n) s += met[n * 4 + tid];
    p.sc.met[tile * 4 + tid] = s;
  }
  // dz_L = (dout W_head) (1 - act_L^2); zeros in the pad columns. A thread
  // keeps column j's 6 head weights and takes every rstep-th row.
  const int rstep = Es < GNT ? GNT / Es : 1, r0 = Es < GNT ? tid / Es : 0;
  float* dz = p.sc.dz[L - 1] + n0 * Es;
  if (r0 < rstep)
    for (int j = Es < GNT ? tid % Es : tid; j < Es; j += GNT) {
      float w[NHEAD];
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        w[o] = j < H ? rbf<BF>(__ldg(Wh + o * H + j)) : 0.f;
      for (int n = r0; n < nvalid; n += rstep) {
        float v = 0.f;
        if (j < H) {
          float d = 0.f;
#pragma unroll
          for (int o = 0; o < NHEAD; ++o)
            d = fmaf(outs[n * OST + o], w[o], d);
          const float a = hsm[n * HC + j];
          v = d * (1.f - a * a);
        }
        dz[(long)n * Es + j] = v;
      }
    }
}

// ---- F: the head's weight gradient -----------------------------------------

struct HeadGradArgs {
  const float* dout;  // [rows, OST] the group's head deltas
  const float* h;     // [rows, ldh] its last hidden layer
  long ldh, rows, chunk, n_params;
  int H;
  long w_off, b_off;
  float* part;        // [SF, n_params] the group's partials
};

// dW_head [6, H] and db_head over range blockIdx.y's rows: a CTA takes HW
// columns, each warp a contiguous eighth of the range's rows with a lane a
// column; the warps' sums are added in warp order. bf16 rounds dout and h
// where they are read; the bias sums the float32 dout.
template <bool BF>
__global__ void __launch_bounds__(GNT) head_wgrad_kernel(HeadGradArgs p) {
  __shared__ float red[GNT / 32][NHEAD + 1][HW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * HW + lane;
  const long q0 = (long)blockIdx.y * p.chunk;
  const long q1 = q0 + p.chunk < p.rows ? q0 + p.chunk : p.rows;
  const long per = (q1 - q0 + GNT / 32 - 1) / (GNT / 32);
  const long qa = q0 + warp * per;
  const long qb = qa + per < q1 ? qa + per : q1;
  const bool bias = blockIdx.x == 0 && lane < NHEAD;
  float acc[NHEAD] = {}, bs = 0.f;
#pragma unroll 4
  for (long q = qa; q < qb; ++q) {
    const float4 d0 = *reinterpret_cast<const float4*>(p.dout + q * OST);
    const float4 d1 = *reinterpret_cast<const float4*>(p.dout + q * OST + 4);
    const float d[NHEAD] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y};
    const float hv = k < p.H ? rbf<BF>(p.h[q * p.ldh + k]) : 0.f;
#pragma unroll
    for (int o = 0; o < NHEAD; ++o) acc[o] = fmaf(rbf<BF>(d[o]), hv, acc[o]);
    if (bias) {
      float dl = d[0];
#pragma unroll
      for (int o = 1; o < NHEAD; ++o) dl = lane == o ? d[o] : dl;
      bs += dl;
    }
  }
#pragma unroll
  for (int o = 0; o < NHEAD; ++o) red[warp][o][lane] = acc[o];
  red[warp][NHEAD][lane] = bs;
  __syncthreads();
  if (warp) return;
  float* out = p.part + (long)blockIdx.y * p.n_params;
  for (int o = 0; o < NHEAD; ++o) {
    float s = 0.f;
    for (int w = 0; w < GNT / 32; ++w) s += red[w][o][lane];
    if (k < p.H) out[p.w_off + (long)o * p.H + k] = s;
  }
  if (bias) {
    float s = 0.f;
    for (int w = 0; w < GNT / 32; ++w) s += red[w][NHEAD][lane];
    out[p.b_off + lane] = s;
  }
}

// ---- host side -------------------------------------------------------------

enum Stage { FWD, HEAD_LOSS, DGRAD, WGRAD };

template <bool BF>
cudaError_t fwd_stage(const StageArgs& sa, cudaStream_t stream) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  cudaError_t e = cudaSuccess;
  for (int g = 0; g < sa.gs.K; ++g) {
    const long n0 = sa.gs.noff[g], Ng = sa.gs.rows[g].N;
    for (int l = 0; l < net.n_hidden && e == cudaSuccess; ++l) {
      const Layer& y = net.L[l];
      const float* A = l ? sc.act[l - 1] + n0 * sd.Es[l - 1]
                         : sc.x0 + n0 * sd.Xs;
      e = launch_gemm<BF, EPI_TANH>(
          gemm_args(A, sd.Ks[l], Ng, sc.wp[l] + g * sc.wp_n[l], sd.Ks[l],
                    sa.params + g * net.n_params + y.b_off, nullptr, 0,
                    sc.act[l] + n0 * sd.Es[l], sd.Es[l], y.out),
          stream);
    }
  }
  return e;
}

template <bool BF>
cudaError_t dgrad_stage(const StageArgs& sa, cudaStream_t stream) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  cudaError_t e = cudaSuccess;
  for (int g = 0; g < sa.gs.K; ++g) {
    const long n0 = sa.gs.noff[g], Ng = sa.gs.rows[g].N;
    for (int l = net.n_hidden - 1; l > 0 && e == cudaSuccess; --l)
      e = launch_gemm<BF, EPI_DTANH>(
          gemm_args(sc.dz[l] + n0 * sd.Es[l], sd.Es[l], Ng,
                    sc.wt[l] + g * sc.wt_n[l], sd.Es[l], nullptr,
                    sc.act[l - 1] + n0 * sd.Es[l - 1], sd.Es[l - 1],
                    sc.dz[l - 1] + n0 * sd.Es[l - 1], sd.Es[l - 1],
                    net.L[l].in),
          stream);
  }
  return e;
}

template <bool BF>
cudaError_t wgrad_stage(const StageArgs& sa, cudaStream_t stream) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  const int L = net.n_hidden;
  const Layer& hd = net.L[L];
  cudaError_t e = opt_in(wgrad_tn_kernel<BF>, smem_wgrad());
  for (int g = 0; g < sa.gs.K && e == cudaSuccess; ++g) {
    const long n0 = sa.gs.noff[g], Ng = sa.gs.rows[g].N;
    FArgs fa;
    fa.rows = Ng;
    fa.chunk = sc.chunk[g];
    fa.n_params = net.n_params;
    fa.part = sc.part + sc.part_off[g];
    int tiles = 0;
    for (int l = 0; l < L; ++l) {
      const Layer& y = net.L[l];
      fa.t[l] = ftask(sc.dz[l] + n0 * sd.Es[l], sd.Es[l], y.out,
                      l ? sc.act[l - 1] + n0 * sd.Es[l - 1]
                        : sc.x0 + n0 * sd.Xs,
                      sd.Ks[l], y.in, y.w_off, y.b_off, 0, y.out, &tiles);
    }
    fa.n = L;
    wgrad_tn_kernel<BF>
        <<<dim3(tiles, sc.SF[g]), GNT, smem_wgrad(), stream>>>(fa);
    const HeadGradArgs ha = {sc.dout + n0 * OST,
                             sc.act[L - 1] + n0 * sd.Es[L - 1],
                             sd.Es[L - 1], Ng, sc.chunk[g], net.n_params,
                             hd.in, hd.w_off, hd.b_off, fa.part};
    head_wgrad_kernel<BF>
        <<<dim3((hd.in + HW - 1) / HW, sc.SF[g]), GNT, 0, stream>>>(ha);
    e = cudaGetLastError();
  }
  return e;
}

template <bool BF>
cudaError_t launch_stage(const StageArgs& sa, Stage st, cudaStream_t stream) {
  switch (st) {
    case FWD:
      return fwd_stage<BF>(sa, stream);
    case HEAD_LOSS: {
      const size_t smem = smem_head(sa.net);
      cudaError_t e = opt_in(mlp_head_kernel<BF>, smem);
      if (e != cudaSuccess) return e;
      mlp_head_kernel<BF>
          <<<(unsigned)sa.sc.n_tiles, GNT, smem, stream>>>(sa);
      return cudaGetLastError();
    }
    case DGRAD:
      return dgrad_stage<BF>(sa, stream);
    case WGRAD:
      return wgrad_stage<BF>(sa, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run_stage(const StageArgs& sa, Stage st, bool bf16,
                      cudaStream_t stream) {
  return bf16 ? launch_stage<true>(sa, st, stream)
              : launch_stage<false>(sa, st, stream);
}

cudaError_t prep(const StageArgs& sa, cudaStream_t stream) {
  mlp_prep_kernel<<<1024, 256, 0, stream>>>(sa);
  return cudaGetLastError();
}

// Stage F's partials summed in range order into grads (group g's at g
// n_params), their sums of squares into sc.sq, group after group.
cudaError_t reduce(const StageArgs& sa, float* grads, cudaStream_t stream) {
  const StageScratch& sc = sa.sc;
  const long n = sa.net.n_params;
  for (int g = 0; g < sa.gs.K; ++g)
    reduce_kernel<<<(unsigned)sc.n_sq1, RED, 0, stream>>>(
        sc.part + sc.part_off[g], sc.SF[g], n, grads + g * n,
        sc.sq + g * sc.n_sq1);
  return cudaGetLastError();
}

cudaError_t metrics(const StageArgs& sa, float* sums, cudaStream_t stream) {
  metrics_kernel<<<1, 128, 0, stream>>>(sa.sc.met, sa.sc.n_tiles, sums);
  return cudaGetLastError();
}

// The net, the minibatch mb's rows and their split by the K groups of
// `groups` (null: one group), the stages' widths, and the scratch laid out
// from `work` (or only sized, when it is null).
bool make_stage_args(int n_hidden, const int* dims, int T, long B, int A,
                     int M, int K, const int* groups, int mb, const float* obs,
                     float* work, StageArgs* sa, long* floats = nullptr) {
  if (!make_rows(n_hidden, dims, T, B, A, M, mb, obs, &sa->net, &sa->bt) ||
      !split_groups(sa->bt, B / M, K, groups, &sa->gs))
    return false;
  sa->sd = make_sdims(sa->net);
  const long n = carve_stages(sa->net, sa->sd, sa->gs, work, &sa->sc);
  if (floats) *floats = n;
  return true;
}

int make_grads_args(int n_hidden, const int* dims, int T, long B, int A,
                    int M, int K, const int* groups, int mb, const float* obs,
                    const int* action, const float* old_lp,
                    const float* old_v, const float* adv, const float* target,
                    const unsigned char* mask, const float* params,
                    const float* scal, float clip_eps, float clip_lo,
                    float clip_hi, float value_coef, float inv_n, float* work,
                    StageArgs* sa) {
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs, work,
                       sa))
    return (int)cudaErrorInvalidValue;
  sa->bt.action = action;
  sa->bt.old_lp = old_lp;
  sa->bt.old_v = old_v;
  sa->bt.adv = adv;
  sa->bt.target = target;
  sa->bt.mask = mask;
  sa->c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  sa->params = params;
  sa->scal = scal;
  return 0;
}

}  // namespace

// Shared memory of the largest stage's CTA in bytes, or 0 for an
// unsupported shape (the stage-C tile's rows of the last hidden layer grow
// with its width).
extern "C" long wh_sgd_stage_smem_bytes(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (long)stage_smem(net) : 0;
}

// The tile route's shared memory per CTA (K5/K6's tile kernels in
// vtrace_sgd.cu, mlp_learner.cuh's layout) in bytes, more than the device
// allows for hidden layers too wide to keep a tile's rows, or 0 for an
// unsupported shape.
extern "C" long wh_sgd_smem_bytes(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (long)smem_bytes(net) : 0;
}

// The chunks of XCH columns an observation of these widths spans (more
// than 1: wider than 128 features, a global view), or -1 for an
// unsupported shape. K5/K6's first layer runs over them.
extern "C" int wh_sgd_obs_chunks(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (net.D + XCH - 1) / XCH : -1;
}

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape. With K policy groups (`groups`: agent -> group, null for K = 1)
// `dims` are one group's widths and the params K groups'.
extern "C" long wh_sgd_workspace_floats(int n_hidden, const int* dims, int T,
                                        long B, int A, int M, int K,
                                        const int* groups) {
  StageArgs sa;
  long n = 0;
  return make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                         nullptr, &sa, &n)
             ? n
             : 0;
}

// Where the stages' rows lie in the workspace: out[0, 10) = float offsets
// of x0, act0..act3, dz0..dz3, dout (-1 where the net has none), out[10,
// 15) = the row strides Xs, Es0..Es3 (0 where none). The rows come group
// after group.
extern "C" int wh_sgd_layout(int n_hidden, const int* dims, int T, long B,
                             int A, int M, int K, const int* groups,
                             long* out) {
  StageArgs sa;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       base, &sa))
    return (int)cudaErrorInvalidValue;
  const StageScratch& sc = sa.sc;
  out[0] = sc.x0 - base;
  out[9] = sc.dout - base;
  out[10] = sa.sd.Xs;
  for (int l = 0; l < MAXL; ++l) {
    const bool has = l < n_hidden;
    out[1 + l] = has ? sc.act[l] - base : -1;
    out[5 + l] = has ? sc.dz[l] - base : -1;
    out[11 + l] = has ? sa.sd.Es[l] : 0;
  }
  return 0;
}

// K4: the loss and gradient of minibatch mb. `grads` gets the gradient in
// the packed layout (K groups' in group order), sums[0..3] the metric sums
// (min surrogate, max squared value error, entropy, old_lp - lp); the
// workspace keeps the gradient's sums of squares for wh_sgd_clip_adam.
// bf16 != 0: every product on bf16 operands (matmul_dtype="bfloat16").
extern "C" int wh_sgd_grads(
    int n_hidden, const int* dims, int T, long B, int A, int M, int K,
    const int* groups, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* params,
    const float* scal, float clip_eps, float clip_lo, float clip_hi,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    int bf16, void* stream_) {
  StageArgs sa;
  int err = make_grads_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs,
                            action, old_lp, old_v, adv, target, mask, params,
                            scal, clip_eps, clip_lo, clip_hi, value_coef,
                            inv_n, work, &sa);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = prep(sa, stream);
  const Stage order[] = {FWD, HEAD_LOSS, DGRAD, WGRAD};
  for (Stage st : order)
    if (e == cudaSuccess) e = run_stage(sa, st, bf16 != 0, stream);
  if (e == cudaSuccess) e = reduce(sa, grads, stream);
  if (e == cudaSuccess) e = metrics(sa, sums, stream);
  return (int)e;
}

// One stage of wh_sgd_grads on the rows the workspace holds (the stages'
// checks and times), after prep (the observation rows, the weight copies):
// 0 fwd (act); 1 head_loss (dout, the last dz, sums[0..3]); 2 dgrad (the
// other dz); 3 wgrad (grads).
extern "C" int wh_sgd_stage(
    int stage, int n_hidden, const int* dims, int T, long B, int A, int M,
    int K, const int* groups, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* params,
    const float* scal, float clip_eps, float clip_lo, float clip_hi,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    int bf16, void* stream_) {
  if (stage < FWD || stage > WGRAD) return (int)cudaErrorInvalidValue;
  StageArgs sa;
  int err = make_grads_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs,
                            action, old_lp, old_v, adv, target, mask, params,
                            scal, clip_eps, clip_lo, clip_hi, value_coef,
                            inv_n, work, &sa);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = prep(sa, stream);
  if (e == cudaSuccess) e = run_stage(sa, (Stage)stage, bf16 != 0, stream);
  if (e == cudaSuccess && stage == HEAD_LOSS) e = metrics(sa, sums, stream);
  if (e == cudaSuccess && stage == WGRAD) e = reduce(sa, grads, stream);
  return (int)e;
}

// K3's optimizer step `step` after wh_sgd_grads on the same workspace:
// clip by the global norm of `grads` (all K groups'), then Adam on params /
// m / v in place with lr_row[step], bc1_row[step], bc2_row[step].
extern "C" int wh_sgd_clip_adam(
    int n_hidden, const int* dims, int T, long B, int A, int M, int K,
    const int* groups, int step, float* params, float* m, float* v,
    const float* grads, const float* lr_row, const float* bc1_row,
    const float* bc2_row, float max_grad_norm, float b1, float one_m_b1,
    float b2, float one_m_b2, float eps, float* work, void* stream_) {
  StageArgs sa;
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       work, &sa) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {K * sa.net.n_params, K * sa.sc.n_sq1, grads, sa.sc.sq,
                      params, m, v, lr_row, bc1_row, bc2_row, step,
                      max_grad_norm, b1, one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<(unsigned)((p.n + FNT - 1) / FNT), FNT, 0,
                (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
