// The MLP learner's stages, shared by the PPO learner (K3/K4, sgd.cu) and
// the IMPALA learner (K5/K6, vtrace_sgd.cu): one minibatch's gradient as
// kernels over all of its rows at once, every product a tile GEMM
// (row_stages.cuh on mma_tiles.cuh).
//
// - The stages' scratch (StageScratch, carve_stages): the observation rows
//   x0 [N, Xs] (Xs = D rounded to 32), each hidden layer's activations and
//   deltas, the head's rows dout [N, OST], the weight gradients' split-K
//   partials and the sums of squares; `extra` forward-only rows follow the
//   N samples in x0, act and dout (the IMPALA learner's last-obs rows).
// - prep_plan / gather_row: each hidden layer's W copied zero-padded as
//   the GEMMs read it ([out, in] for the forward, transposed for the
//   dgrads; pad_jobs.cuh), and a row of x0.
// - load_head_rows, head_fwd_rows, head_dz_rows: a 64-row tile of the last
//   hidden layer in shared memory, the 6-wide head over it (5 logits and
//   the value), and the last layer's delta dz_L = (dout W_head) (1 -
//   act_L^2) from the head's deltas.
// - fwd_stage, dgrad_stage, wgrad_stage: the hidden layers' forward
//   (rows_gemm_kernel EPI_TANH), their dgrads below the last (EPI_DTANH)
//   and every weight gradient (wgrad_tn_kernel split-K over row ranges and
//   head_wgrad_kernel for the 6-row head), group by group; reduce: the
//   partials in range order into the gradient and its sums of squares.
//
// With bf16 operands (BF) the products round each operand (mma_tiles.cuh,
// rbf for the head's 6-wide products); a value both a product and tanh' or
// a bias sum read stays float32 in memory. Every sum runs in an order
// fixed by the shapes alone.
//
// Any number of hidden layers: the per-layer tables (the layers, their
// padded widths and rows) live in the caller's MlpTables on the host; the
// kernels read the last layer's entries only (SDims::Es_last,
// StageScratch::act_last / dz_last), and the prep's copies and stage F's
// products go MAXJ / MAXT to a launch.
#pragma once

#include <cuda_runtime.h>

#include "mlp_learner.cuh"
#include "mma_tiles.cuh"
#include "row_stages.cuh"

namespace {

constexpr int CB = R;           // rows per head tile: GroupSplit's tiles
constexpr int HPAD = 8;         // the head tile's row pad: a warp's 4 x 8
                                // reads hit 32 distinct banks
constexpr int HW = 32;          // columns per head_wgrad_kernel CTA
constexpr int SF_TARGET = 512;  // weight-gradient CTAs aimed at, per group
constexpr int MAXSF = 128;      // row ranges of the weight gradients at most
// Host storage of the per-layer tables below, sized from the net.
struct MlpTables {
  std::vector<Layer> L;
  std::vector<int> Es, Ks;
  std::vector<float*> wp, wt, act, dz;
  std::vector<long> wp_n, wt_n;
};

struct SDims {       // the stages' padded widths
  int Xs;            // D rounded to 32: x0's row stride
  HostPtr<const int> Es;  // hidden widths rounded to 32: act / dz strides
  HostPtr<const int> Ks;  // each layer's K: Xs, then Es[l - 1]
  int Es_last;       // Es[L - 1]
};

SDims make_sdims(const Net& net, MlpTables* tb) {
  SDims sd;
  const int L = net.n_hidden;
  tb->Es.assign(L, 0);
  tb->Ks.assign(L, 0);
  sd.Xs = rup(net.D, 32);
  for (int l = 0; l < L; ++l) {
    tb->Es[l] = rup(net.L[l].out, 32);
    tb->Ks[l] = l == 0 ? sd.Xs : tb->Es[l - 1];
  }
  sd.Es = tb->Es.data();
  sd.Ks = tb->Ks.data();
  sd.Es_last = tb->Es[L - 1];
  return sd;
}

struct StageScratch {  // the per-layer pointer tables are the host's
  HostPtr<float*> wp;  // [K][rup(out_l, 128), Ks_l] W_l as GEMM rows of k
  HostPtr<float*> wt;  // [K][rup(in_l, 128), Es_l] W_l^T (l >= 1)
  HostPtr<long> wp_n, wt_n;  // one group's floats of each
  float* x0;          // [N + extra, Xs] the observation rows
  HostPtr<float*> act;  // [N + extra, Es_l] hidden activations
  HostPtr<float*> dz;   // [N, Es_l] their deltas
  float *act_last, *dz_last;  // act[L - 1], dz[L - 1]
  float* dout;        // [N + extra, OST] head outputs or deltas
  float* part;        // group g's SF[g] partials of n_params at part_off[g]
  long part_off[MAXK];
  long chunk[MAXK];   // rows per weight-gradient range of group g
  int SF[MAXK];
  float* sq;          // [K n_sq1] sums of squares, group after group
  float* met;         // [n_tiles, 4] metric sums per head tile
  long n_sq1, n_tiles;
};

// Lays the scratch out from `base` (or only sizes it when base is null):
// returns its floats.
long carve_stages(const Net& net, const SDims& sd, const GroupSplit& gs,
                  long extra, float* base, StageScratch* sc, MlpTables* tb) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const int L = net.n_hidden, K = gs.K;
  for (auto* v : {&tb->wp, &tb->wt, &tb->act, &tb->dz}) v->assign(L, nullptr);
  tb->wp_n.assign(L, 0);
  tb->wt_n.assign(L, 0);
  sc->wp = tb->wp.data();
  sc->wt = tb->wt.data();
  sc->act = tb->act.data();
  sc->dz = tb->dz.data();
  sc->wp_n = tb->wp_n.data();
  sc->wt_n = tb->wt_n.data();
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
  sc->x0 = take((N + extra) * sd.Xs);
  for (int l = 0; l < L; ++l) {
    sc->act[l] = take((N + extra) * sd.Es[l]);
    sc->dz[l] = take(N * sd.Es[l]);
  }
  sc->act_last = sc->act[L - 1];
  sc->dz_last = sc->dz[L - 1];
  sc->dout = take((N + extra) * OST);
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

// What every stage reads: one group's widths, the minibatch's rows by
// policy group (K = 1: all of them), the scratch, the `extra` forward-only
// rows after the last group's (0 but for the IMPALA learner's last-obs
// rows) and the K groups' packed params.
struct MlpStage {
  Net net;
  SDims sd;
  GroupSplit gs;
  StageScratch sc;
  long extra;
  const float* params;
};

// The head tile: the last layer's rows, the head's outputs or deltas, and
// (sgd.cu) a row of metric terms each.
size_t smem_head(const Net& net) {
  return sizeof(float) * CB * (net.head.in + HPAD + OST + 4);
}

size_t stage_smem(const Net& net) {
  const size_t s[] = {smem_gemm(), smem_wgrad(), smem_head(net)};
  size_t m = 0;
  for (size_t x : s) m = x > m ? x : m;
  return m;
}

// ---- prep: the padded weight copies and the observation rows ---------------

// Each hidden layer's copies for every group: W_l as GEMM rows, and (l >=
// 1) W_l^T.
PadPlan prep_plan(const MlpStage& p) {
  const Net& net = p.net;
  const SDims& sd = p.sd;
  PadPlan plan;
  plan.K = p.gs.K;
  for (int l = 0; l < net.n_hidden; ++l) {
    const Layer& y = net.L[l];
    const float* W = p.params + y.w_off;
    plan.add(p.sc.wp[l], p.sc.wp_n[l], W, net.n_params, rup(y.out, 128),
             sd.Ks[l], y.out, y.in, false);
    if (l)
      plan.add(p.sc.wt[l], p.sc.wt_n[l], W, net.n_params, rup(y.in, 128),
               sd.Es[l], y.out, y.in, true);
  }
  return plan;
}

// One row of x0 by one warp: src's D features, zeros to Xs, 4 loads a lane
// in flight before their stores (a row's 424-byte stride need not be
// 16-byte aligned, x0's is).
__device__ void gather_row(const float* src, float* dst, int D, int Xs,
                           int lane) {
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

// ---- the head tile ----------------------------------------------------------

// hsm [CB][H + HPAD] = rows [n0, n0 + nvalid) of the last layer's
// activations `act` (row stride Es), zeros past nvalid.
__device__ void load_head_rows(float* hsm, const float* act, int Es, int H,
                               long n0, int nvalid) {
  const int HC = H + HPAD;
  const float* hrow = act + n0 * Es;
  for (int i = threadIdx.x; i < CB * H; i += GNT) {
    const int n = i / H, j = i % H;
    hsm[n * HC + j] = n < nvalid ? hrow[(long)n * Es + j] : 0.f;
  }
}

// outs [CB][OST] = the head of the tile's rows: a warp takes 4 rows at a
// time, 8 lanes a row over k (k = kl + 8 i), then a sum over the row's 8
// lanes per output.
template <bool BF>
__device__ void head_fwd_rows(const float* hsm, int H, const float* Wh,
                              const float* bh, float* outs) {
  const int HC = H + HPAD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kl = lane & 7;
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
        outs[n * OST + o] = a[o] + __ldg(bh + o);
  }
}

// dz [nvalid][Es] = (outs W_head) (1 - hsm^2), zeros in the pad columns;
// outs holds the head's deltas as the product reads them (rounded with
// bf16 operands). A thread keeps column j's 6 head weights and takes every
// rstep-th row.
template <bool BF>
__device__ void head_dz_rows(const float* outs, const float* hsm, int H,
                             int Es, const float* Wh, float* dz,
                             int nvalid) {
  const int HC = H + HPAD, tid = threadIdx.x;
  const int rstep = Es < GNT ? GNT / Es : 1, r0 = Es < GNT ? tid / Es : 0;
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

// ---- the head's weight gradient --------------------------------------------

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

// act_l = tanh(act_{l-1} W_l^T + b_l) for each hidden layer over every
// group's rows (the last group's with the extra rows). Each stage below
// adds the kernels it launched to *launched, where given.
template <bool BF>
cudaError_t fwd_stage(const MlpStage& sa, cudaStream_t stream,
                      long* launched = nullptr) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  cudaError_t e = cudaSuccess;
  for (int g = 0; g < sa.gs.K; ++g) {
    const long n0 = sa.gs.noff[g];
    const long Ng = sa.gs.rows[g].N + (g == sa.gs.K - 1 ? sa.extra : 0);
    for (int l = 0; l < net.n_hidden && e == cudaSuccess; ++l) {
      const Layer& y = net.L[l];
      const float* A = l ? sc.act[l - 1] + n0 * sd.Es[l - 1]
                         : sc.x0 + n0 * sd.Xs;
      e = launch_gemm<BF, EPI_TANH>(
          gemm_args(A, sd.Ks[l], Ng, sc.wp[l] + g * sc.wp_n[l], sd.Ks[l],
                    sa.params + g * net.n_params + y.b_off, nullptr, 0,
                    sc.act[l] + n0 * sd.Es[l], sd.Es[l], y.out),
          stream);
      if (e == cudaSuccess && launched) ++*launched;
    }
  }
  return e;
}

// dz_{l-1} = (dz_l W_l) (1 - act_{l-1}^2) for l = L-1..1 over the groups'
// rows, on the transposed copies.
template <bool BF>
cudaError_t dgrad_stage(const MlpStage& sa, cudaStream_t stream,
                        long* launched = nullptr) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  cudaError_t e = cudaSuccess;
  for (int g = 0; g < sa.gs.K; ++g) {
    const long n0 = sa.gs.noff[g], Ng = sa.gs.rows[g].N;
    for (int l = net.n_hidden - 1; l > 0 && e == cudaSuccess; --l) {
      e = launch_gemm<BF, EPI_DTANH>(
          gemm_args(sc.dz[l] + n0 * sd.Es[l], sd.Es[l], Ng,
                    sc.wt[l] + g * sc.wt_n[l], sd.Es[l], nullptr,
                    sc.act[l - 1] + n0 * sd.Es[l - 1], sd.Es[l - 1],
                    sc.dz[l - 1] + n0 * sd.Es[l - 1], sd.Es[l - 1],
                    net.L[l].in),
          stream);
      if (e == cudaSuccess && launched) ++*launched;
    }
  }
  return e;
}

// Every weight and bias gradient of each group's rows into its partials:
// dW_l = dz_l^T act_{l-1} (x0 for the first layer) and the head's from
// dout.
template <bool BF>
cudaError_t wgrad_stage(const MlpStage& sa, cudaStream_t stream,
                        long* launched = nullptr) {
  const Net& net = sa.net;
  const SDims& sd = sa.sd;
  const StageScratch& sc = sa.sc;
  const int L = net.n_hidden;
  const Layer& hd = net.head;
  cudaError_t e = opt_in(wgrad_tn_kernel<BF>, smem_wgrad());
  for (int g = 0; g < sa.gs.K && e == cudaSuccess; ++g) {
    const long n0 = sa.gs.noff[g], Ng = sa.gs.rows[g].N;
    float* part = sc.part + sc.part_off[g];
    std::vector<FTask> tasks;
    int tiles = 0;
    for (int l = 0; l < L; ++l) {
      const Layer& y = net.L[l];
      tasks.push_back(ftask(sc.dz[l] + n0 * sd.Es[l], sd.Es[l], y.out,
                            l ? sc.act[l - 1] + n0 * sd.Es[l - 1]
                              : sc.x0 + n0 * sd.Xs,
                            sd.Ks[l], y.in, y.w_off, y.b_off, 0, y.out,
                            &tiles));
    }
    e = launch_wgrad<BF>(tasks, Ng, sc.chunk[g], net.n_params, part,
                         sc.SF[g], smem_wgrad(), stream, launched);
    if (e != cudaSuccess) return e;
    const HeadGradArgs ha = {sc.dout + n0 * OST,
                             sc.act[L - 1] + n0 * sd.Es[L - 1],
                             sd.Es[L - 1], Ng, sc.chunk[g], net.n_params,
                             hd.in, hd.w_off, hd.b_off, part};
    head_wgrad_kernel<BF>
        <<<dim3((hd.in + HW - 1) / HW, sc.SF[g]), GNT, 0, stream>>>(ha);
    e = cudaGetLastError();
    if (e == cudaSuccess && launched) ++*launched;
  }
  return e;
}

// The weight gradients' partials summed in range order into grads (group
// g's at g n_params), their sums of squares into sc.sq, group after group.
cudaError_t reduce(const MlpStage& sa, float* grads, cudaStream_t stream,
                   long* launched = nullptr) {
  const StageScratch& sc = sa.sc;
  const long n = sa.net.n_params;
  for (int g = 0; g < sa.gs.K; ++g)
    reduce_kernel<<<(unsigned)sc.n_sq1, RED, 0, stream>>>(
        sc.part + sc.part_off[g], sc.SF[g], n, grads + g * n,
        sc.sq + g * sc.n_sq1);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && launched) *launched += sa.gs.K;
  return e;
}

// The workspace offsets of the stages' rows (from a fake base): out[0, 3)
// = the float offsets of x0 and dout, x0's row stride Xs; then per hidden
// layer l, out[3 + 3 l, 6 + 3 l) = the offsets of act_l and dz_l and their
// row stride Es_l.
void stage_layout(const MlpStage& sa, const float* base, long* out) {
  const StageScratch& sc = sa.sc;
  out[0] = sc.x0 - base;
  out[1] = sc.dout - base;
  out[2] = sa.sd.Xs;
  for (int l = 0; l < sa.net.n_hidden; ++l) {
    out[3 + 3 * l] = sc.act[l] - base;
    out[4 + 3 * l] = sc.dz[l] - base;
    out[5 + 3 * l] = sa.sd.Es[l];
  }
}

}  // namespace
