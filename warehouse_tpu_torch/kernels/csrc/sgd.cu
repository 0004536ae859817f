// K3 + K4: the PPO SGD phase of the MLP policy, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd.py ppo_sgd_phase_pallas (:691; body
// _sgd_kernel :309 with _loss_and_dout :68, _block_grads :158 and
// _clip_adam_step :226) and ppo_minibatch_grads_pallas (:818; body
// _grads_kernel :404). One optimizer step on minibatch m (env columns
// [m B/M, (m+1) B/M) of the trajectory, N = T * B/M * A samples) is five
// launches on the caller's stream, with no host synchronisation between
// steps, four for the gradient:
//
//   (a) fwd_bwd_kernel: sample tiles of R rows. The weights (~122 KB in
//       f32 at 106 -> 128 -> 128 -> 6) sit in opted-in shared memory for
//       the CTA's life; the CTA loops over tiles. Per tile: MLP forward,
//       the clipped-PPO loss chain and its derivative per row, then the
//       deltas back through the head and the hidden layers. It writes each
//       hidden layer's activation and delta and the head delta to device
//       memory, and one row of metric sums per tile.
//   (b) wgrad_kernel: dW = delta^T * prev and db = sum(delta) per layer
//       as split-K products: 64 x 64 output tiles times S sample ranges,
//       each CTA writing its own partial (no atomics).
//   (c) reduce_kernel: the S partials summed in a fixed order, and the
//       sum of squares of each 256 gradients.
//   (d) metrics_kernel: the metric sums of the step in a fixed order.
//
// That is K4, wh_sgd_grads. K3 follows each K4 step with adam_kernel
// (wh_sgd_clip_adam, one CTA): the global norm in a fixed order, then the
// optax clip + Adam step on params and moments in place, with lr and the
// bias corrections of this step read from device rows. Every sum runs
// in an order fixed by the shapes alone, so two runs on the same inputs
// give the same bits. The weights and one CTA's gradient partials do not
// fit one SM's shared memory together, hence the split into (a) and (b).
//
// The bound: at config 4 a step is ~6.3 GFLOP in (a) and ~4 GFLOP in (b)
// on the CUDA cores in f32. (a) is limited by shared-memory loads: a
// thread owns one output column for RT rows, reading its weight row with
// conflict-free strided loads (odd row stride in shared memory) and the
// rows as broadcasts. (b) keeps a 4 x 4 register tile per thread.
//
// Tie rules, as the TPU kernel writes them (_block_grads, sgd.py:170-179):
// a tie of the surrogate min routes the whole gradient to the unclipped
// branch (pg1 <= pg2), a tie of the value max to the unclipped error
// (sq1 >= sq2); jax.grad and torch split such ties 0.5/0.5. Both agree
// at the epoch-0 ratio == 1 ties, where the two branches have the same
// derivative; they differ only at a tie exactly on a clip bound. The
// clip bounds themselves pass gradient 1, as jnp.clip and torch.clamp do.

#include <cuda_runtime.h>

namespace {

constexpr int MAXL = 4;       // hidden layers
constexpr int NACT = 5;
constexpr int NHEAD = 6;      // 5 logits + value
constexpr int OST = 8;        // row stride of head outputs and deltas
constexpr int NT = 256;       // threads of (a)
constexpr int R = 64;         // samples per tile of (a)
constexpr int RT = 16;        // rows per register tile
constexpr int G = R / RT;
constexpr int WT = 64;        // output tile side of (b)
constexpr int NC = 32;        // samples per shared-memory stage of (b)
constexpr int WNT = 256;      // threads of (b)
constexpr int MAXS = 64;      // sample splits of (b)
constexpr int RED = 256;      // threads of (c)
constexpr int FNT = 1024;     // threads of (d)
constexpr float NEG_INF = -1e9f;

struct Layer {
  int in, out;
  long w_off, b_off;  // packed vector: W [out, in] then b [out]
  int ws;             // shared-memory row stride of W (odd)
  int s_off;          // shared-memory offset of W; the bias follows
};

struct Net {
  int n_hidden, D;
  Layer L[MAXL + 1];  // the hidden layers, then the head
  long n_params;
  int smem_w;         // floats of the staged weights
  int act_floats;     // floats of the per-tile row buffers
};

bool make_net(int n_hidden, const int* dims, Net* net) {
  if (n_hidden < 1 || n_hidden > MAXL) return false;
  net->n_hidden = n_hidden;
  net->D = dims[0];
  long off = 0;
  int soff = 0, act = R * (dims[0] + OST + 4);
  for (int l = 0; l <= n_hidden; ++l) {
    Layer& y = net->L[l];
    y.in = dims[l];
    y.out = l < n_hidden ? dims[l + 1] : NHEAD;
    if (y.in <= 0 || y.out <= 0) return false;
    y.w_off = off;
    y.b_off = off + (long)y.out * y.in;
    off = y.b_off + y.out;
    y.ws = y.in | 1;
    y.s_off = soff;
    soff += y.out * y.ws + y.out;
    if (l < n_hidden) act += R * y.out;
  }
  net->n_params = off;
  net->smem_w = soff;
  net->act_floats = act;
  return true;
}

size_t smem_bytes(const Net& net) {
  return sizeof(float) * ((size_t)net.smem_w + net.act_floats);
}

struct Batch {  // one minibatch of the trajectory
  long N;       // samples
  long nb;      // samples per time step: B/M * A
  long BA;      // B * A
  long mb_off;  // m * nb
  int D;
  const float* obs;  // [T, B, A, D]
  const int* action;
  const float *old_lp, *old_v, *adv, *target;  // [T, B, A]
  const unsigned char* mask;                   // [T, B, A, 5] or null
  // Row of sample q in the [T, B, A] arrays: time step q / nb, then the
  // minibatch's env columns.
  __device__ long row(long q) const {
    return (q / nb) * BA + mb_off + q % nb;
  }
};

struct Scratch {
  float* act[MAXL];  // [N, H_l] hidden activations
  float* dz[MAXL];   // [N, H_l] their deltas
  float* dout;       // [N, OST] head deltas
  float* part;       // [S, n_params] gradient partials
  float* sq;         // [n_params / RED] sums of squares
  float* met;        // [n_tiles, 4] metric sums per tile
  int S;
  long n_tiles, n_sq;
};

long n_splits(long N) {
  long s = (N + 1023) / 1024;
  return s < 1 ? 1 : (s > MAXS ? MAXS : s);
}

long carve(const Net& net, long N, float* base, Scratch* sc) {
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
  sc->dout = take(N * OST);
  sc->S = (int)n_splits(N);
  sc->part = take(sc->S * net.n_params);
  sc->n_sq = (net.n_params + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->n_tiles = (N + R - 1) / R;
  sc->met = take(sc->n_tiles * 4);
  return off;
}

struct Coefs {
  float clip_eps, clip_lo, clip_hi, value_coef, inv_n, max_grad_norm;
  float b1, one_m_b1, b2, one_m_b2, eps;
};

// ---- (a) forward, loss, backward -------------------------------------------

struct FwdArgs {
  Net net;
  Batch bt;
  Scratch sc;
  Coefs c;
  const float* params;
  const float* scal;  // ent_coef, kl_coeff
};

// y[n][o] = act(x[n] . W[o] + b[o]) for the tile's R rows; rows < nvalid
// also go to g[(n0 + n) * out + o].
__device__ void fwd_layer(const float* W, int ws, const float* bias,
                          const float* x, int in, float* y, int ys, int out,
                          bool use_tanh, float* g, long n0, int nvalid) {
  for (int item = threadIdx.x; item < out * G; item += NT) {
    const int o = item % out, grp = item / out;
    const float* xg = x + grp * RT * in;
    const float* w = W + o * ws;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int i = 0; i < in; ++i) {
      const float wi = w[i];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(xg[r * in + i], wi, acc[r]);
    }
    const float bo = bias[o];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int n = grp * RT + r;
      const float z = acc[r] + bo;
      const float v = use_tanh ? tanhf(z) : z;
      y[n * ys + o] = v;
      if (g && n < nvalid) g[(n0 + n) * out + o] = v;
    }
  }
}

// dz[n][i] = (sum_o d[n][o] W[o][i]) * (1 - h[n][i]^2), written over h and,
// for rows < nvalid, to g[(n0 + n) * in + i].
__device__ void bwd_layer(const float* W, int ws, const float* d, int ds,
                          int out, float* h, int in, float* g, long n0,
                          int nvalid) {
  for (int item = threadIdx.x; item < in * G; item += NT) {
    const int i = item % in, grp = item / in;
    const float* dg = d + grp * RT * ds;
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int o = 0; o < out; ++o) {
      const float w = W[o * ws + i];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(dg[r * ds + o], w, acc[r]);
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

// The clipped-PPO loss chain of one sample and d(mean loss)/d(head
// output), in the order of _loss_and_dout (sgd.py:68-155). `o` holds the
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

__global__ void __launch_bounds__(NT) fwd_bwd_kernel(FwdArgs p) {
  extern __shared__ float smem[];
  const Net& net = p.net;
  const int L = net.n_hidden, tid = threadIdx.x;

  for (int l = 0; l <= L; ++l) {
    const Layer& y = net.L[l];
    for (int k = tid; k < y.out * y.in; k += NT)
      smem[y.s_off + (k / y.in) * y.ws + k % y.in] = p.params[y.w_off + k];
    for (int k = tid; k < y.out; k += NT)
      smem[y.s_off + y.out * y.ws + k] = p.params[y.b_off + k];
  }
  float* xs = smem + net.smem_w;
  float* hs[MAXL];
  float* next = xs + R * net.D;
  for (int l = 0; l < L; ++l) {
    hs[l] = next;
    next += R * net.L[l].out;
  }
  float* outs = next;
  float* met = outs + R * OST;
  const float ent_coef = p.scal[0], kl_coeff = p.scal[1];
  const Batch& bt = p.bt;
  const int D = net.D;
  __syncthreads();

  for (long tile = blockIdx.x; tile < p.sc.n_tiles; tile += gridDim.x) {
    const long n0 = tile * R;
    const int nvalid = bt.N - n0 < R ? (int)(bt.N - n0) : R;
    for (int k = tid; k < R * D; k += NT) {
      const int n = k / D;
      xs[k] = n < nvalid ? bt.obs[bt.row(n0 + n) * D + k % D] : 0.f;
    }
    __syncthreads();

    const float* x = xs;
    for (int l = 0; l < L; ++l) {
      const Layer& y = net.L[l];
      fwd_layer(smem + y.s_off, y.ws, smem + y.s_off + y.out * y.ws, x, y.in,
                hs[l], y.out, y.out, true, p.sc.act[l], n0, nvalid);
      __syncthreads();
      x = hs[l];
    }
    const Layer& hd = net.L[L];
    fwd_layer(smem + hd.s_off, hd.ws, smem + hd.s_off + hd.out * hd.ws, x,
              hd.in, outs, OST, NHEAD, false, nullptr, n0, nvalid);
    __syncthreads();

    if (tid < R) {
      float* o = outs + tid * OST;
      float* m = met + tid * 4;
      if (tid < nvalid) {
        loss_row(o, bt.row(n0 + tid), bt, p.c, ent_coef, kl_coeff, m);
        for (int r = 0; r < NHEAD; ++r)
          p.sc.dout[(n0 + tid) * OST + r] = o[r];
      } else {
        for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
        for (int k = 0; k < 4; ++k) m[k] = 0.f;
      }
    }
    __syncthreads();
    if (tid < 4) {  // fixed-order sum over the tile's rows
      float s = 0.f;
      for (int n = 0; n < R; ++n) s += met[n * 4 + tid];
      p.sc.met[tile * 4 + tid] = s;
    }

    bwd_layer(smem + hd.s_off, hd.ws, outs, OST, NHEAD, hs[L - 1], hd.in,
              p.sc.dz[L - 1], n0, nvalid);
    __syncthreads();
    for (int l = L - 2; l >= 0; --l) {
      const Layer& y = net.L[l + 1];
      bwd_layer(smem + y.s_off, y.ws, hs[l + 1], y.out, y.out, hs[l], y.in,
                p.sc.dz[l], n0, nvalid);
      __syncthreads();
    }
  }
}

// ---- (b) weight gradients as split-K products -------------------------------

struct WTask {
  const float* prev;   // [N, in] activations, or null: the obs rows
  const float* delta;  // [N, ds]
  int ds, in, out;
  long w_off, b_off;
  int i_tiles, tile0;
};

struct WArgs {
  WTask t[MAXL + 1];
  int n_layers;
  Batch bt;
  long chunk, n_params;
  float* part;
};

__global__ void __launch_bounds__(WNT) wgrad_kernel(WArgs p) {
  __shared__ __align__(16) float Ds[NC][WT];
  __shared__ __align__(16) float Ps[NC][WT];
  int l = 0;
  while (l + 1 < p.n_layers && (int)blockIdx.x >= p.t[l + 1].tile0) ++l;
  const WTask& w = p.t[l];
  const int tile = blockIdx.x - w.tile0;
  const int o0 = tile / w.i_tiles * WT, i0 = tile % w.i_tiles * WT;
  const bool bias = i0 == 0;
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
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(dv[a], xv[b], acc[a][b]);
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

// ---- (c) partials -> gradient, sums of squares ------------------------------

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

// ---- (d) metric sums; global norm, clip + Adam ----------------------------

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

struct AdamArgs {
  long n, n_sq;
  const float *grads, *sq;
  float *params, *m, *v;
  const float *lr_row, *bc1_row, *bc2_row;
  int step;
  Coefs c;
};

// optax.chain(clip_by_global_norm, adam) in its op order (_clip_adam_step,
// sgd.py:226-248): scale = norm < max ? 1 : (g / norm) * max, the moment
// updates, update = lr * (m / bc1) / (sqrt(v / bc2) + eps).
__global__ void __launch_bounds__(FNT) adam_kernel(AdamArgs p) {
  __shared__ float norm_s;
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (long b = threadIdx.x; b < p.n_sq; b += 32) s += p.sq[b];
    s = warp_sum(s);
    if (threadIdx.x == 0) norm_s = __fsqrt_rn(s);
  }
  __syncthreads();
  const float norm = norm_s, maxn = p.c.max_grad_norm;
  const bool keep = norm < maxn;
  const float lr = p.lr_row[p.step], bc1 = p.bc1_row[p.step];
  const float bc2 = p.bc2_row[p.step];
  for (long k = threadIdx.x; k < p.n; k += FNT) {
    float g = p.grads[k];
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), maxn);
    const float m = __fadd_rn(__fmul_rn(p.c.one_m_b1, g),
                              __fmul_rn(p.c.b1, p.m[k]));
    const float v = __fadd_rn(__fmul_rn(p.c.one_m_b2, __fmul_rn(g, g)),
                              __fmul_rn(p.c.b2, p.v[k]));
    p.m[k] = m;
    p.v[k] = v;
    const float upd = __fdiv_rn(
        __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), p.c.eps));
    p.params[k] = __fsub_rn(p.params[k], __fmul_rn(lr, upd));
  }
}

bool make_batch(int n_hidden, const int* dims, int T, long B, int A, int M,
                Net* net, long* N) {
  if (!make_net(n_hidden, dims, net) || T <= 0 || B <= 0 || A <= 0 ||
      M <= 0 || B % M)
    return false;
  *N = (long)T * (B / M) * A;
  return true;
}

}  // namespace

// Shared memory of one (a) CTA in bytes, or 0 for an unsupported shape.
extern "C" long wh_sgd_smem_bytes(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (long)smem_bytes(net) : 0;
}

// Floats of scratch the two entry points below share, or 0 for an
// unsupported shape.
extern "C" long wh_sgd_workspace_floats(int n_hidden, const int* dims, int T,
                                        long B, int A, int M) {
  Net net;
  long N;
  if (!make_batch(n_hidden, dims, T, B, A, M, &net, &N)) return 0;
  Scratch sc;
  return carve(net, N, nullptr, &sc);
}

// K4: the loss and gradient of minibatch mb (kernels a-c and the metric
// sums). `grads` gets the gradient in the packed layout, sums[0..3] the
// metric sums (min surrogate, max squared value error, entropy,
// old_lp - lp); the workspace keeps the gradient's sums of squares for
// wh_sgd_clip_adam.
extern "C" int wh_sgd_grads(
    int n_hidden, const int* dims, int T, long B, int A, int M, int mb,
    const float* obs, const int* action, const float* old_lp,
    const float* old_v, const float* adv, const float* target,
    const unsigned char* mask, const float* params, const float* scal,
    float clip_eps, float clip_lo, float clip_hi, float value_coef,
    float inv_n, float* work, float* grads, float* sums, void* stream_) {
  Net net;
  long N;
  if (!make_batch(n_hidden, dims, T, B, A, M, &net, &N) || mb < 0 || mb >= M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  FwdArgs fa;
  fa.net = net;
  fa.bt.N = N;
  fa.bt.nb = (B / M) * A;
  fa.bt.BA = B * A;
  fa.bt.mb_off = mb * fa.bt.nb;
  fa.bt.D = net.D;
  fa.bt.obs = obs;
  fa.bt.action = action;
  fa.bt.old_lp = old_lp;
  fa.bt.old_v = old_v;
  fa.bt.adv = adv;
  fa.bt.target = target;
  fa.bt.mask = mask;
  carve(net, N, work, &fa.sc);
  fa.c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n,
               0.f,      0.f,     0.f,     0.f,        0.f, 0.f};
  fa.params = params;
  fa.scal = scal;

  const size_t smem = smem_bytes(net);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, n_sm = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_bwd_kernel,
                                                      NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long resident = (long)n_sm * per_sm;
  const long grid_a = fa.sc.n_tiles < resident ? fa.sc.n_tiles : resident;

  WArgs wa;
  wa.n_layers = n_hidden + 1;
  wa.bt = fa.bt;
  wa.n_params = net.n_params;
  wa.part = fa.sc.part;
  wa.chunk = ((N + fa.sc.S - 1) / fa.sc.S + NC - 1) / NC * NC;
  int tiles = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    WTask& t = wa.t[l];
    const Layer& y = net.L[l];
    t.prev = l == 0 ? nullptr : fa.sc.act[l - 1];
    t.delta = l < n_hidden ? fa.sc.dz[l] : fa.sc.dout;
    t.ds = l < n_hidden ? y.out : OST;
    t.in = y.in;
    t.out = y.out;
    t.w_off = y.w_off;
    t.b_off = y.b_off;
    t.i_tiles = (y.in + WT - 1) / WT;
    t.tile0 = tiles;
    tiles += t.i_tiles * ((y.out + WT - 1) / WT);
  }

  fwd_bwd_kernel<<<(unsigned)grid_a, NT, smem, stream>>>(fa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  wgrad_kernel<<<dim3(tiles, fa.sc.S), WNT, 0, stream>>>(wa);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  reduce_kernel<<<(unsigned)fa.sc.n_sq, RED, 0, stream>>>(
      fa.sc.part, fa.sc.S, net.n_params, grads, fa.sc.sq);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  metrics_kernel<<<1, 128, 0, stream>>>(fa.sc.met, fa.sc.n_tiles, sums);
  return (int)cudaGetLastError();
}

// K3's optimizer step `step` after wh_sgd_grads on the same workspace:
// clip by the global norm of `grads`, then Adam on params / m / v in
// place with lr_row[step], bc1_row[step], bc2_row[step].
extern "C" int wh_sgd_clip_adam(
    int n_hidden, const int* dims, int T, long B, int A, int M, int step,
    float* params, float* m, float* v, const float* grads,
    const float* lr_row, const float* bc1_row, const float* bc2_row,
    float max_grad_norm, float b1, float one_m_b1, float b2, float one_m_b2,
    float eps, float* work, void* stream_) {
  Net net;
  long N;
  if (!make_batch(n_hidden, dims, T, B, A, M, &net, &N) || step < 0)
    return (int)cudaErrorInvalidValue;
  Scratch sc;
  carve(net, N, work, &sc);
  AdamArgs p;
  p.n = net.n_params;
  p.n_sq = sc.n_sq;
  p.grads = grads;
  p.sq = sc.sq;
  p.params = params;
  p.m = m;
  p.v = v;
  p.lr_row = lr_row;
  p.bc1_row = bc1_row;
  p.bc2_row = bc2_row;
  p.step = step;
  p.c = Coefs{0.f, 0.f,      0.f, 0.f,      0.f, max_grad_norm,
              b1,  one_m_b1, b2,  one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
