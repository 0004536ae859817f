// The MLP learner's building blocks. The tile route (fwd_tile, bwd_tile,
// mlp_transpose_kernel, wgrad_kernel, carve's Scratch) is the IMPALA
// learner's alone (K5/K6, vtrace_sgd.cu) since the PPO learner (K3/K4,
// sgd.cu) runs as row-parallel tile GEMMs (row_stages.cuh). The PPO
// learner (sgd.cu) and the recurrent PPO learner (K8/K9, sgd_rnn.cu) share
// the rest: the packed layout, the minibatch's rows and their split by
// policy group, the loss chain, and the reduce, metrics and Adam kernels.
//
// - The packed parameter layout: per dense layer W [out, in] then b [out]
//   (torch's layout), the head as the 6 x H stack of 5 logits and the
//   value. The tile route stages no weight in shared memory: the forward
//   reads a transposed copy Wt [in, out] (mlp_transpose_kernel, rebuilt
//   before each gradient since the optimizer rewrites the params) with
//   dense_l2.cuh's layer, the backward the packed W [out, in] itself, both
//   from device memory (L2-resident), neighbouring threads on neighbouring
//   addresses. The first layer runs over chunks of XCH input columns, its
//   sums kept in the first hidden buffer between chunks, so only [R, XCH]
//   of the input rows is staged and no observation is too wide; it needs no
//   input gradient and wgrad_kernel reads the observations from device
//   memory. A tile's rows take ~100 KB at hidden 128 x 2, so two CTAs
//   share an SM. Staging every weight in shared memory instead leaves room
//   for one CTA per SM and is slower (config 4's PPO phase on an H100,
//   when K3 ran this route: 29.1 ms against 23.4), and no 611-wide
//   observation or 256-wide layer fits beside 64 full input rows.
// - fwd_tile / bwd_tile: the dense layers over a tile of R sample rows in
//   shared memory, a thread owning one column for RT rows.
// - loss_row: the clipped-PPO loss chain of one sample and its derivative
//   with respect to the head outputs, shared by the PPO learner (sgd.cu)
//   and the recurrent PPO learner (sgd_rnn.cu).
// - Kernels that read activations and deltas only: wgrad_kernel (dW =
//   delta^T prev and db = sum(delta) as split-K products, one partial per
//   sample range, no atomics), reduce_kernel (the partials summed in split
//   order, sums of squares per 256 gradients), metrics_kernel (per-tile
//   metric rows summed in a fixed order), and adam_kernel (the optax clip
//   + Adam step, on one CTA or a grid).
//
// Policy groups (K3/K4, pallas/sgd.py:293-306): K MLPs of the same widths,
// their params one after another in group order, and a static agent ->
// group map. Each group's samples form their own Rows (only its agents);
// GroupSplit gives each group's first row and first tile of R rows, so
// that a learner can run the groups' rows one group after another, each
// through its params and in its order without groups. One global norm
// spans every group's gradient.
//
// The tile route is float32 only: the IMPALA learner takes no bf16
// operands (its trainer sends them to the plain phase). The PPO learner's
// bf16 route (sgd.cu) rounds on the tensor cores.
//
// Every sum runs in an order fixed by the shapes alone, so two runs on the
// same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "dense_l2.cuh"

namespace {

constexpr int MAXL = 4;       // hidden layers
constexpr int NACT = 5;
constexpr int NHEAD = 6;      // 5 logits + value
constexpr int OST = 8;        // row stride of head outputs and deltas
constexpr int NT = 256;       // threads of the tile kernels
constexpr int R = 64;         // samples per tile
constexpr int RT = 16;        // rows per register tile
constexpr int G = R / RT;
constexpr int WT = 64;        // output tile side of wgrad_kernel
constexpr int NC = 32;        // samples per shared-memory stage of wgrad
constexpr int WNT = 256;      // threads of wgrad_kernel
constexpr int MAXS = 64;      // sample splits of wgrad_kernel
constexpr int MAXW = 8;       // weight-gradient products per launch
constexpr int RED = 256;      // threads of reduce_kernel
constexpr int FNT = 1024;     // threads of the optimizer kernels
constexpr int MAXK = 8;       // policy groups, and agents of a grouped batch
constexpr float NEG_INF = -1e9f;

struct Layer {
  int in, out;
  long w_off, b_off;  // packed vector: W [out, in] then b [out]
};

struct Net {
  int n_hidden, D;
  Layer L[MAXL + 1];  // the hidden layers, then the head
  long n_params;
  int act_floats;     // floats of the per-tile row buffers
};

size_t smem_bytes(const Net& net) {
  return sizeof(float) * (size_t)net.act_floats;
}

// The layout of an MLP of these widths. A tile's row buffers: one input
// chunk [R, XCH], every hidden layer's rows, the head rows [R, OST], R x 4
// metric terms and the tile's R row pointers (2 floats each).
bool make_net(int n_hidden, const int* dims, Net* net) {
  if (n_hidden < 1 || n_hidden > MAXL) return false;
  net->n_hidden = n_hidden;
  net->D = dims[0];
  long off = 0;
  int act = R * (XCH + OST + 4 + 2);
  for (int l = 0; l <= n_hidden; ++l) {
    Layer& y = net->L[l];
    y.in = dims[l];
    y.out = l < n_hidden ? dims[l + 1] : NHEAD;
    if (y.in <= 0 || y.out <= 0) return false;
    y.w_off = off;
    y.b_off = off + (long)y.out * y.in;
    off = y.b_off + y.out;
    if (l < n_hidden) act += R * y.out;
  }
  net->n_params = off;
  net->act_floats = act;
  return true;
}

// The samples of one minibatch: env columns [m B/M, (m+1) B/M) of a
// [T, B, A] trajectory, N = T * B/M * A samples in time-major order; or,
// for one policy group, only its na agents' (na < A), N = T * B/M * na.
struct Rows {
  long N;       // samples
  long nb;      // samples per time step: B/M * na
  long BA;      // B * A
  long mb_off;  // m * B/M * A
  int D;
  int A, na;    // agents, and the agents enumerated
  int code;     // the enumerated agents, 3 bits each, when na < A
  const float* obs;  // [T, B, A, D]
  // Row of sample q in the [T, B, A] arrays: time step q / nb, then the
  // minibatch's env columns (with na < A, each env's enumerated agents).
  __device__ long row(long q) const {
    if (na == A) return (q / nb) * BA + mb_off + q % nb;
    const long r = q % nb;
    return (q / nb) * BA + mb_off + (r / na) * A +
           ((code >> (3 * (int)(r % na))) & 7);
  }
};

// Minibatch mb of M of a [T, B, A] trajectory with D-wide observations.
bool batch_rows(int T, long B, int A, int M, int mb, int D, const float* obs,
                Rows* rows) {
  if (T <= 0 || B <= 0 || A <= 0 || M <= 0 || B % M || mb < 0 || mb >= M)
    return false;
  rows->nb = (B / M) * A;
  rows->N = (long)T * rows->nb;
  rows->BA = B * A;
  rows->mb_off = mb * rows->nb;
  rows->D = D;
  rows->A = rows->na = A;
  rows->code = 0;
  rows->obs = obs;
  return true;
}

// A minibatch's samples split by policy group: group g's Rows, its first
// row in the scratch's activations (noff) and its first tile (toff).
// Without groups K = 1 and the one group is the whole minibatch.
struct GroupSplit {
  int K;
  Rows rows[MAXK];
  long noff[MAXK + 1], toff[MAXK + 1];
};

// The split of `all` (batch_rows' minibatch of T * B/M * A samples) by the
// agent -> group map `groups` of K groups (null: one group). Returns false
// for a map that is not K non-empty groups of at most MAXK agents.
bool split_groups(const Rows& all, long bm, int K, const int* groups,
                  GroupSplit* gs) {
  const long T = all.N / all.nb;
  if (K < 1 || K > MAXK || (K > 1 && (!groups || all.A > MAXK))) return false;
  gs->K = K;
  gs->noff[0] = gs->toff[0] = 0;
  for (int g = 0; g < K; ++g) {
    Rows r = all;
    r.na = 0;
    r.code = 0;
    for (int a = 0; a < all.A; ++a) {
      const int ga = groups ? groups[a] : 0;
      if (ga < 0 || ga >= K) return false;
      if (ga == g) r.code |= a << (3 * r.na++);
    }
    if (r.na == 0) return false;
    r.nb = bm * r.na;
    r.N = T * r.nb;
    if (r.na == r.A) r.code = 0;
    gs->rows[g] = r;
    gs->noff[g + 1] = gs->noff[g] + r.N;
    gs->toff[g + 1] = gs->toff[g] + (r.N + R - 1) / R;
  }
  return true;
}

bool make_rows(int n_hidden, const int* dims, int T, long B, int A, int M,
               int mb, const float* obs, Net* net, Rows* rows) {
  return make_net(n_hidden, dims, net) &&
         batch_rows(T, B, A, M, mb, net->D, obs, rows);
}

struct Batch : Rows {  // one minibatch of the trajectory
  const int* action;
  const float *old_lp, *old_v, *adv, *target;  // [T, B, A]
  const unsigned char* mask;                   // [T, B, A, 5] or null
};

struct Coefs {
  float clip_eps, clip_lo, clip_hi, value_coef, inv_n;
};

struct Scratch {
  float* act[MAXL];  // [N, H_l] hidden activations
  float* dz[MAXL];   // [N, H_l] their deltas
  float* dout;       // [N + extra, OST] head outputs / deltas
  float* part;       // [S, n_params] gradient partials
  float* sq;         // [n_params / RED] sums of squares
  float* met;        // [n_tiles, 4] metric sums per tile
  float* wt;         // [n_params] every W as [in, out]
  int S;
  long n_tiles, n_sq;
};

long n_splits(long N) {
  long s = (N + 1023) / 1024;
  return s < 1 ? 1 : (s > MAXS ? MAXS : s);
}

// Lays the tile route's scratch out from `base` (or only sizes it when base
// is null); `extra` head rows follow the N samples'. Returns its floats.
long carve(const Net& net, long N, long extra, float* base, Scratch* sc) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  for (int l = 0; l < net.n_hidden; ++l) {
    sc->act[l] = take(N * net.L[l].out);
    sc->dz[l] = take(N * net.L[l].out);
  }
  sc->dout = take((N + extra) * OST);
  sc->S = (int)n_splits(N);
  sc->part = take(sc->S * net.n_params);
  sc->n_sq = (net.n_params + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->n_tiles = (N + R - 1) / R;
  sc->met = take(sc->n_tiles * 4);
  sc->wt = take(net.n_params);
  return off;
}

// ---- tile kernels' pieces ----------------------------------------------------

// The per-tile row buffers: one chunk xs [R, XCH] of the input rows, each
// hidden layer's rows hs[l] [R, H_l], the head rows outs [R, OST], R x 4
// floats of metric terms, then `rows`: the address of each of the tile's
// input rows in device memory (null past the last sample).
struct TileBufs {
  float* xs;
  float* hs[MAXL];
  float* outs;
  float* met;
  const float** rows;
};

__device__ TileBufs tile_bufs(const Net& net, float* smem) {
  TileBufs b;
  b.xs = smem;
  float* next = b.xs + R * XCH;
  for (int l = 0; l < net.n_hidden; ++l) {
    b.hs[l] = next;
    next += R * net.L[l].out;
  }
  b.outs = next;
  b.met = b.outs + R * OST;
  b.rows = reinterpret_cast<const float**>(b.met + R * 4);
  return b;
}

// The tile's forward from its row pointers b.rows: the first layer over
// chunks of XCH input columns staged in b.xs, then the other hidden layers
// (activations of rows < nvalid to sc.act) and the head into b.outs, every
// matrix from the transposed copy `wt`.
__device__ void fwd_tile(const Net& net, const float* params, const float* wt,
                         const TileBufs& b, const Scratch& sc, long n0,
                         int nvalid) {
  const Layer& y0 = net.L[0];
  for (int c0 = 0; c0 < net.D; c0 += XCH) {
    const int cw = net.D - c0 < XCH ? net.D - c0 : XCH;
    for (int k = threadIdx.x; k < R * cw; k += NT) {
      const int n = k / cw, c = k % cw;
      const float* row = b.rows[n];
      b.xs[n * XCH + c] = row ? row[c0 + c] : 0.f;
    }
    __syncthreads();
    dense_l2<NT, RT, G>(wt + y0.w_off + (long)c0 * y0.out, params + y0.b_off,
                        b.xs, XCH, cw, b.hs[0], y0.out, y0.out, true, c0 == 0,
                        c0 + XCH >= net.D, sc.act[0], n0, nvalid);
    __syncthreads();
  }
  for (int l = 1; l <= net.n_hidden; ++l) {
    const Layer& y = net.L[l];
    const bool head = l == net.n_hidden;
    dense_l2<NT, RT, G>(wt + y.w_off, params + y.b_off, b.hs[l - 1], y.in,
                        y.in, head ? b.outs : b.hs[l], head ? OST : y.out,
                        y.out, !head, true, true,
                        head ? nullptr : sc.act[l], n0, nvalid);
    __syncthreads();
  }
}

// wt = every W [out, in] of the packed vector as [in, out], at its offset.
__global__ void mlp_transpose_kernel(Net net, const float* p, float* wt) {
  const long stride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int l = 0; l <= net.n_hidden; ++l) {
    const Layer& y = net.L[l];
    for (long k = tid; k < (long)y.out * y.in; k += stride)
      wt[y.w_off + (k % y.in) * y.out + k / y.in] = p[y.w_off + k];
  }
}

// Before the tile kernels: the transposed copy of the params.
inline cudaError_t launch_mlp_transpose(const Net& net, const float* params,
                                        const Scratch& sc,
                                        cudaStream_t stream) {
  mlp_transpose_kernel<<<128, 256, 0, stream>>>(net, params, sc.wt);
  return cudaGetLastError();
}

// dz[n][i] = (sum_o d[n][o] W[o][i]) * (1 - h[n][i]^2), written over h and,
// for rows < nvalid, to g[(n0 + n) * in + i]. W [out, in] is the packed
// matrix in device memory, read through the read-only path.
__device__ void bwd_layer(const float* W, const float* d, int ds, int out,
                          float* h, int in, float* g, long n0, int nvalid) {
  for (int item = threadIdx.x; item < in * G; item += NT) {
    const int i = item % in, grp = item / in;
    const float* dg = d + grp * RT * ds;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int o = 0; o < out; ++o) {
      const float w = __ldg(W + (long)o * in + i);
#pragma unroll
      for (int r = 0; r < RT; ++r)
        acc[r] = fmaf(dg[r * ds + o], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int n = grp * RT + r;
      const float hv = h[n * in + i];
      const float dz = acc[r] * (1.f - hv * hv);
      h[n * in + i] = dz;
      if (n < nvalid) g[(n0 + n) * in + i] = dz;
    }
  }
}

// The head deltas in b.outs back through the head and the hidden layers
// (over b.hs, which hold the activations); the deltas of rows < nvalid go
// to sc.dz.
__device__ void bwd_tile(const Net& net, const float* params,
                         const TileBufs& b, const Scratch& sc, long n0,
                         int nvalid) {
  const int L = net.n_hidden;
  const Layer& hd = net.L[L];
  bwd_layer(params + hd.w_off, b.outs, OST, NHEAD, b.hs[L - 1], hd.in,
            sc.dz[L - 1], n0, nvalid);
  __syncthreads();
  for (int l = L - 2; l >= 0; --l) {
    const Layer& y = net.L[l + 1];
    bwd_layer(params + y.w_off, b.hs[l + 1], y.out, y.out, b.hs[l], y.in,
              sc.dz[l], n0, nvalid);
    __syncthreads();
  }
}

// ---- the PPO loss of one sample ------------------------------------------------

// The clipped-PPO loss chain of one sample and d(mean loss)/d(head
// output), in the order of _loss_and_dout (pallas/sgd.py:68-155). `o` holds the
// head outputs and receives the deltas; `met` the four metric terms.
__device__ void loss_row(float* o, long gi, const Batch& bt, const Coefs& c,
                         float ent_coef, float kl_coeff, float* met) {
  bool valid[NACT];
  float logit[NACT];
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    valid[r] = !bt.mask || bt.mask[gi * NACT + r];
    logit[r] = valid[r] ? o[r] : NEG_INF;
  }
  const float v = o[NACT];
  float mx = logit[0];
#pragma unroll
  for (int r = 1; r < NACT; ++r) mx = fmaxf(mx, logit[r]);
  float ssum = 0.f;
#pragma unroll
  for (int r = 0; r < NACT; ++r) ssum += expf(logit[r] - mx);
  const float lse = mx + logf(ssum);
  const int a = bt.action[gi];
  float logp[NACT], p[NACT], lp = 0.f, ent = 0.f;
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    logp[r] = logit[r] - lse;
    p[r] = expf(logp[r]);
    if (a == r) lp = logp[r];
    ent = ent - p[r] * logp[r];
  }
  const float old_lp = bt.old_lp[gi], old_v = bt.old_v[gi];
  const float adv = bt.adv[gi], tgt = bt.target[gi];

  const float ratio = expf(lp - old_lp);
  const float r_clip = fminf(fmaxf(ratio, c.clip_lo), c.clip_hi);
  const float pg1 = ratio * adv, pg2 = r_clip * adv;
  const float v_err = v - tgt, dv = v - old_v;
  const float vc_err = (old_v + fminf(fmaxf(dv, -c.clip_eps), c.clip_eps)) - tgt;
  const float sq1 = v_err * v_err, sq2 = vc_err * vc_err;
  met[0] = fminf(pg1, pg2);
  met[1] = fmaxf(sq1, sq2);
  met[2] = ent;
  met[3] = old_lp - lp;

  const bool inclip = ratio >= c.clip_lo && ratio <= c.clip_hi;
  const float sel = (pg1 <= pg2 || inclip) ? 1.f : 0.f;
  const float d_lp = -(adv * ratio * sel + kl_coeff) * c.inv_n;
  const float ent_scale = ent_coef * c.inv_n;
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    const float d = d_lp * ((a == r ? 1.f : 0.f) - p[r]) +
                    ent_scale * p[r] * (logp[r] + ent);
    o[r] = valid[r] ? d : 0.f;
  }
  const bool invc = dv >= -c.clip_eps && dv <= c.clip_eps;
  const float err = sq1 >= sq2 ? v_err : (invc ? vc_err : 0.f);
  o[NACT] = c.value_coef * c.inv_n * err;
}

// ---- weight gradients as split-K products -----------------------------------

struct WTask {
  const float* prev;   // [N, in] activations, or null: the obs rows
  const float* delta;  // [N, ds]
  int ds, in, out;
  long w_off, b_off;  // b_off < 0: the layer has no bias
  int i_tiles, tile0;
};

struct WArgs {
  WTask t[MAXW];
  int n_layers;
  Rows bt;
  long chunk, n_params;
  float* part;
};

// One product dW [out, in] = delta^T prev (and db, unless b_off < 0) of a
// wgrad_kernel launch; `tiles` counts the launch's output tiles.
WTask wtask(const float* prev, const float* delta, int ds, int in, int out,
            long w_off, long b_off, int* tiles) {
  WTask t;
  t.prev = prev;
  t.delta = delta;
  t.ds = ds;
  t.in = in;
  t.out = out;
  t.w_off = w_off;
  t.b_off = b_off;
  t.i_tiles = (in + WT - 1) / WT;
  t.tile0 = *tiles;
  *tiles += t.i_tiles * ((out + WT - 1) / WT);
  return t;
}

__global__ void __launch_bounds__(WNT) wgrad_kernel(WArgs p) {
  __shared__ __align__(16) float Ds[NC][WT];
  __shared__ __align__(16) float Ps[NC][WT];
  int l = 0;
  while (l + 1 < p.n_layers && (int)blockIdx.x >= p.t[l + 1].tile0) ++l;
  const WTask& w = p.t[l];
  const int tile = blockIdx.x - w.tile0;
  const int o0 = tile / w.i_tiles * WT, i0 = tile % w.i_tiles * WT;
  const bool bias = i0 == 0 && w.b_off >= 0;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long q0 = blockIdx.y * p.chunk;
  const long q1 = q0 + p.chunk < p.bt.N ? q0 + p.chunk : p.bt.N;

  float acc[4][4] = {}, bsum[4] = {};
  for (long qc = q0; qc < q1; qc += NC) {
    for (int k = tid; k < NC * WT; k += WNT) {
      const int nn = k / WT, col = k % WT;
      const long q = qc + nn;
      const bool ok = q < q1;
      Ds[nn][col] = ok && o0 + col < w.out ? w.delta[q * w.ds + o0 + col] : 0.f;
      float pv = 0.f;
      if (ok && i0 + col < w.in)
        pv = w.prev ? w.prev[q * w.in + i0 + col]
                    : p.bt.obs[p.bt.row(q) * p.bt.D + i0 + col];
      Ps[nn][col] = pv;
    }
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < NC; ++nn) {
      const float4 d = *reinterpret_cast<const float4*>(&Ds[nn][ty * 4]);
      const float4 x = *reinterpret_cast<const float4*>(&Ps[nn][tx * 4]);
      const float dv[4] = {d.x, d.y, d.z, d.w}, xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float da = dv[a];
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(da, xv[b], acc[a][b]);
      }
      if (bias && tx == 0)
#pragma unroll
        for (int a = 0; a < 4; ++a) bsum[a] += dv[a];
    }
    __syncthreads();
  }
  float* out = p.part + blockIdx.y * p.n_params;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int o = o0 + ty * 4 + a;
    if (o >= w.out) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + tx * 4 + b;
      if (i < w.in) out[w.w_off + (long)o * w.in + i] = acc[a][b];
    }
    if (bias && tx == 0) out[w.b_off + o] = bsum[a];
  }
}

// ---- partials -> gradient, sums of squares ----------------------------------

__global__ void __launch_bounds__(RED) reduce_kernel(const float* part, int S,
                                                     long n, float* grads,
                                                     float* sq) {
  __shared__ float sh[RED];
  const long k = (long)blockIdx.x * RED + threadIdx.x;
  float g = 0.f;
  if (k < n) {
    for (int s = 0; s < S; ++s) g += part[s * n + k];
    grads[k] = g;
  }
  sh[threadIdx.x] = g * g;
  __syncthreads();
  for (int w = RED / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sq[blockIdx.x] = sh[0];
}

// ---- metric sums; global norm, clip + Adam ----------------------------------

__device__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// sums[k] = the tiles' metric k in a fixed order, one warp per metric.
__global__ void metrics_kernel(const float* met, long n_tiles, float* sums) {
  const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.f;
  for (long t = lane; t < n_tiles; t += 32) s += met[t * 4 + k];
  s = warp_sum(s);
  if (lane == 0) sums[k] = s;
}

// The global norm of the gradient from its sums of squares, in a fixed
// order, by the first warp into *norm_s.
__device__ void global_norm(const float* sq, long n_sq, float* norm_s) {
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (long b = threadIdx.x; b < n_sq; b += 32) s += sq[b];
    s = warp_sum(s);
    if (threadIdx.x == 0) *norm_s = __fsqrt_rn(s);
  }
  __syncthreads();
}

struct AdamArgs {
  long n, n_sq;
  const float *grads, *sq;
  float *params, *m, *v;
  const float *lr_row, *bc1_row, *bc2_row;
  int step;
  float max_grad_norm, b1, one_m_b1, b2, one_m_b2, eps;
};

// optax.chain(clip_by_global_norm, adam) in its op order (_clip_adam_step,
// sgd.py:226-248): scale = norm < max ? 1 : (g / norm) * max, the moment
// updates, update = lr * (m / bc1) / (sqrt(v / bc2) + eps). One CTA, or a
// grid of them (each computes the same norm from the sums of squares, then
// updates its share of the parameters).
__global__ void __launch_bounds__(FNT) adam_kernel(AdamArgs p) {
  __shared__ float norm_s;
  global_norm(p.sq, p.n_sq, &norm_s);
  const float norm = norm_s, maxn = p.max_grad_norm;
  const bool keep = norm < maxn;
  const float lr = p.lr_row[p.step], bc1 = p.bc1_row[p.step];
  const float bc2 = p.bc2_row[p.step];
  for (long k = (long)blockIdx.x * FNT + threadIdx.x; k < p.n;
       k += (long)gridDim.x * FNT) {
    float g = p.grads[k];
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), maxn);
    const float m = __fadd_rn(__fmul_rn(p.one_m_b1, g),
                              __fmul_rn(p.b1, p.m[k]));
    const float v = __fadd_rn(__fmul_rn(p.one_m_b2, __fmul_rn(g, g)),
                              __fmul_rn(p.b2, p.v[k]));
    p.m[k] = m;
    p.v[k] = v;
    const float upd = __fdiv_rn(
        __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), p.eps));
    p.params[k] = __fsub_rn(p.params[k], __fmul_rn(lr, upd));
  }
}

// ---- host side ----------------------------------------------------------------

// Opts `kernel` in to `smem` bytes of dynamic shared memory and sizes its
// persistent grid of `threads`-wide CTAs: one per resident slot, at most
// n_tiles.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long n_tiles,
                            long* grid, int threads = NT) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, n_sm = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long resident = (long)n_sm * per_sm;
  *grid = n_tiles < resident ? n_tiles : resident;
  return cudaSuccess;
}

// The weight gradients of every layer from the activations and deltas of
// `rows`' N samples (sc's act / dz / dout from its first row on; the head's
// deltas are dout's), over `S` sample ranges, reduced into `grads` with
// its sums of squares into `sq`.
cudaError_t launch_wgrad(const Net& net, const Rows& rows, const Scratch& sc,
                         int S, float* grads, float* sq,
                         cudaStream_t stream) {
  WArgs wa;
  wa.n_layers = net.n_hidden + 1;
  wa.bt = rows;
  wa.n_params = net.n_params;
  wa.part = sc.part;
  wa.chunk = ((rows.N + S - 1) / S + NC - 1) / NC * NC;
  int tiles = 0;
  for (int l = 0; l <= net.n_hidden; ++l) {
    const Layer& y = net.L[l];
    const bool head = l == net.n_hidden;
    wa.t[l] = wtask(l == 0 ? nullptr : sc.act[l - 1],
                    head ? sc.dout : sc.dz[l], head ? OST : y.out, y.in, y.out,
                    y.w_off, y.b_off, &tiles);
  }
  wgrad_kernel<<<dim3(tiles, S), WNT, 0, stream>>>(wa);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<(unsigned)((net.n_params + RED - 1) / RED), RED, 0,
                  stream>>>(sc.part, S, net.n_params, grads, sq);
  return cudaGetLastError();
}

// After the tile kernels: the weight gradients of every layer from the
// activations and deltas in `sc` (the head's deltas are sc.dout's first N
// rows), reduced into `grads` with its sums of squares into sc.sq, and the
// n_met metric rows of sc.met summed into sums[0..3].
cudaError_t launch_grads_tail(const Net& net, const Rows& rows,
                              const Scratch& sc, long n_met, float* grads,
                              float* sums, cudaStream_t stream) {
  cudaError_t e = launch_wgrad(net, rows, sc, sc.S, grads, sc.sq, stream);
  if (e != cudaSuccess) return e;
  metrics_kernel<<<1, 128, 0, stream>>>(sc.met, n_met, sums);
  return cudaGetLastError();
}

}  // namespace
