// K8 + K9: the SGD phase of the recurrent (GRU / LSTM) PPO learner, and one
// minibatch's sequence-replay gradient.
//
// Replaces warehouse_tpu/pallas/sgd_rnn.py ppo_rnn_sgd_phase_pallas (:551;
// body _sgd_rnn_kernel :317 with _seq_fwd_bwd :79) and
// ppo_rnn_minibatch_grads_pallas (:665; body _grads_rnn_kernel :397).
// Minibatch m is env columns [m B/M, (m+1) B/M) of the trajectory: N = B/M *
// A sequences of T steps, T N rows (row t N + n is sequence n's step t),
// replayed from the rollout-start carry h0 with no carry reset inside the
// chunk (the trainer only lets an episode end on a chunk's last step).
//
// One minibatch's gradient (K9, wh_rnn_sgd_grads) is stages shaped by their
// products, each a kernel on the caller's stream. Every product that does
// not depend on the carry runs over all T N rows at once as a tile GEMM
// (mma_tiles.cuh); only the carry's own products stay in a loop over t:
//
//   prep: the minibatch's observation rows gathered into x0 [T N, Xs] (zeros
//      to Xs = D rounded to 32) and every matrix copied zero-padded as the
//      stages read it: each W [out, in] as GEMM rows of k (encoder, Wi), its
//      transpose for the dgrads, Wh gate-blocked for B and transposed for D.
//   A enc_fwd: the encoder layers act_l = tanh(act_{l-1} W_l^T + b_l) and
//      the input side of the gates gi = e Wi^T (+ bi for the GRU), each a
//      64 x 128 tile GEMM over the T N rows, the activation in its
//      epilogue. act_l stays float32: tanh' reads it.
//   B rec_fwd: a CTA owns RB = 32 sequences for all T steps, h (and c) in
//      shared memory. Each step is gh = h Wh^T as 8 warps x (8 units x G
//      gates) per pass of 64 units, so that every thread holds all G gates
//      of its (row, unit) pairs and the cell's math (flax's, rnn_cell.cuh)
//      runs in the product's epilogue with gi[t]; it stores the gates, h_t
//      (and c_t) for the backward.
//   C head_loss: the 6-wide head, the clipped-PPO loss chain (loss_row,
//      shared with the MLP learner) and the head's adjoint dout over tiles
//      of 64 rows of h_1..h_T; the metric sums per tile in row order; the
//      head's part of dh, dhead = dout Whead, time-parallel too.
//   D rec_bwd: the same tiles in reverse t: the cell's adjoint from the
//      stored gates (sgd_rnn.py:229-311; GRU's dq = dpn r for Whn, bhn and
//      dh_prev) gives dp (the input side's deltas) and dx (the recurrent
//      side's: dp for the LSTM, (dpr, dpz, dq) for the GRU), then dh_prev =
//      d z (GRU) + dx Wh as 8 warps x 16 units per pass of 128 units.
//   E enc_bwd: de = dp Wi times tanh', then the earlier encoder layers'
//      deltas, each a tile GEMM over the T N rows.
//   F wgrad: every dW = delta^T prev over the T N rows (encoder from x0 and
//      act, Wi from dp and e, Wh from dx and h_0..h_{T-1}, the head from
//      dout and h_1..h_T) and the biases' sums, as 128 x 128 tiles split-K
//      over row ranges, one partial per range.
//   then reduce_kernel (the partials in range order, sums of squares per
//   256 gradients) and metrics_kernel (mlp_learner.cuh).
//
// K8 (wh_rnn_sgd_clip_adam) follows each gradient with adam_kernel, the
// optax clip + Adam step of the PPO learner, on a grid of CTAs that each
// compute the global norm (one CTA took 1.7 ms of a 21 ms phase). Every
// sum runs in an order fixed by the shapes alone, with no atomics, so a
// rerun gives the same bits.
//
// The products (mma_tiles.cuh): with bf16 operands (matmul_dtype=
// "bfloat16", _seq_fwd_bwd's dot at sgd_rnn.py:116-119) on the tensor
// cores as m16n8k16 with float32 sums, each operand rounded where the
// mma packs it, so a value both a product and the gate arithmetic read
// (act, h, dp, dx) stays float32 in memory; in float32 as FFMA register
// blocks on the CUDA cores (the tile GEMMs in mma_tiles.cuh's float4
// blocks, the recurrences in mma_k16's fragments). The head's products (6
// wide) run on the CUDA cores on rounded operands (rbf); the gate
// arithmetic, tanh', the carries and the bias sums stay float32.
//
// The TPU kernel keeps only h and the head deltas and recomputes encoder
// and gates in its backward sweep, because its fast memory is small; this
// card has the device memory to store them (~0.6 GB of scratch at config
// 4, reused by every step). The bound is the products' rate: per step at
// config 4 ~15 GFLOP forward, ~13 backward and ~15 in the weight
// gradients, of which only the carry's products (h Wh^T, dx Wh: ~6.4) are
// serial in t. Those run on 128 CTAs (N = 4096 / 32), one an SM, so their
// time is the latency of T dependent steps; where Wh comes from in them is
// a route chosen by what fits in shared memory (Route, at stage B): with
// bf16 operands the whole of Wh (and Wh^T in D) stays there for all T
// steps as packed bf16 pairs (98 KB for the GRU, 131 KB for the LSTM at
// hidden 128); in float32 (196 / 256 KB) a pass's slice of it is staged
// by cp.async; wider nets read it through L1.
//
// Any hidden width: the stages pair a thread's units (float2 rows of gi,
// the gates, h and c) and stage F reads h's rows as 16-byte copies, so they
// run the net padded to Hq = H rounded up to 4. Where H is not a multiple
// of 4, prep first writes the padded copies of the params and of the carry
// (pad_params_kernel: zero weights, biases and carry past H in each gate
// block, the head's columns too) and the reduce writes the gradient back
// at the natural width (unpad_kernel). A pad unit then stays 0 forward
// (tanh(0) = 0; the GRU's h' = 0.5 n + 0.5 h = 0 with n = tanh(0); the
// LSTM's c' = 0.5 c + 0.5 tanh(0) = 0, h' = o tanh(0) = 0) and every
// weight out of it is 0, so the gradient into it and every pad weight's
// gradient are exactly 0: the natural entries are the unpadded net's up to
// the order of the float32 sums, and the global norm is theirs. Widths that
// are multiples of 4 run unpadded, as before. Any number of encoder layers:
// the per-layer tables live in the caller's RnnTables on the host, the
// prep's copies go MAXJ and stage F's products MAXT to a launch.

#include <cuda_runtime.h>

#include "device_limits.cuh"
#include "mlp_learner.cuh"
#include "mma_tiles.cuh"
#include "rnn_cell.cuh"
#include "row_stages.cuh"

namespace {

constexpr int RB = 32;     // sequences per recurrent tile (stages B and D)
constexpr int RNTB = 256;  // threads of the recurrent tiles: 8 warps
constexpr int UB = 64;     // units per pass of stage B: 8 warps x 8
constexpr int UD = 128;    // units per pass of stage D: 8 warps x 16 (RT_ST: UB)
constexpr int CB = 64;     // rows per stage-C tile
constexpr int SF_TARGET = 512;  // stage-F CTAs aimed at (split-K ranges)
constexpr int MAXSF = 64;  // row ranges of stage F at most
constexpr int MAXB = 8;    // blocks of a PadMap

// A row of k values as packed bf16 pairs, 4 words of pad: a warp's
// fragment loads (row g, word t) then hit distinct banks.
__host__ __device__ inline int packed_words(int k) { return k / 2 + 4; }

struct RDims {  // the stages' padded widths
  int Xs;         // D rounded to 32: x0's row stride
  HostPtr<const int> Es;  // encoder widths rounded to 32: act / dz strides
  HostPtr<const int> Ks;  // each encoder layer's K: Xs, then Es[l - 1]
  int Es_last;    // Es[n_enc - 1]
  int GH, GHs;    // G H, and rounded to 32: dp / dx row stride
  int HU;         // H rounded to UB: the rows of one gate in whp
  int Hk;         // H rounded to 16: K of stage B's product
  int HS;         // stage B's h row stride in shared memory
  int GHk;        // G H rounded to 16: K of stage D's product
  int DXS;        // stage D's dx row stride in shared memory
  int HV;         // H rounded to UD: the rows of wht
};

RDims make_rdims(const RnnNet& net, RnnTables* tb) {
  RDims rd;
  rd.Xs = rup(net.D, 32);
  tb->Es.assign(net.n_enc, 0);
  tb->Ks.assign(net.n_enc, 0);
  for (int l = 0; l < net.n_enc; ++l) {
    tb->Es[l] = rup(net.enc_out[l], 32);
    tb->Ks[l] = l == 0 ? rd.Xs : tb->Es[l - 1];
  }
  rd.Es = tb->Es.data();
  rd.Ks = tb->Ks.data();
  rd.Es_last = tb->Es[net.n_enc - 1];
  rd.GH = net.G * net.H;
  rd.GHs = rup(rd.GH, 32);
  rd.HU = rup(net.H, UB);
  rd.Hk = rup(net.H, 16);
  rd.HS = rd.Hk + 4;
  rd.GHk = rup(rd.GH, 16);
  rd.DXS = rd.GHk + 4;
  rd.HV = rup(net.H, UD);
  return rd;
}

struct RnnScratch {
  HostPtr<float*> encp;  // [rup(E_l, 128), Ks_l] W_l as GEMM rows
  HostPtr<float*> enct;  // [rup(in_l, 128), Es_l] W_l^T (l >= 1)
  float* wip;         // [rup(GH, 128), Es_last] Wi
  float* wit;         // [rup(E, 128), GHs] Wi^T
  float* whp;         // [G HU, Hk] Wh, gate g's rows at g HU
  float* wht;         // [HV, GHk] Wh^T
  uint32_t* whw;      // [G HU, Hk / 2 + 4] whp as packed bf16 pairs
  uint32_t* wtw;      // [HV, GHk / 2 + 4] wht as packed bf16 pairs
  float* x0;          // [T N, Xs] the observation rows
  HostPtr<float*> act;   // [T N, Es_l] encoder activations
  HostPtr<float*> dz;    // [T N, Es_l] their deltas
  float* gi;          // [T N, G H] the gates' input side
  float* hs;          // [(T + 1) N, H] h_0 .. h_T
  float* cs;          // [(T + 1) N, H] c_0 .. c_T (LSTM)
  float* gates;       // [T N, 4 H] GRU r, z, n, q; LSTM i, f, g, o
  float* dout;        // [T N, OST] head deltas
  float* dhead;       // [T N, H] dout Whead
  float* dp;          // [T N, GHs] gate pre-activation deltas
  float* dx;          // [T N, GHs] the recurrent side's (LSTM: dp)
  float* part;        // [SF, n_params] gradient partials
  float* sq;          // [n_sq] sums of squares
  float* met;         // [n_tiles_c, 4] metric sums per stage-C tile
  float *pp, *pg;     // padded widths: [n_params] the params, the gradient
  float *ph0, *pc0;   // padded widths: [B A, Hq] the carry
  int SF;
  long chunk;         // rows per stage-F range
  long n_tiles_c, n_sq;
};

int f_tiles_of(const RnnNet& net) {
  int n = 0;
  for (int l = 0; l < net.n_enc; ++l)
    n += f_tile_count(net.enc_out[l], net.enc_in[l]);
  const int GH = net.G * net.H;
  return n + f_tile_count(GH, net.E) + f_tile_count(GH, net.H) +
         f_tile_count(NHEAD, net.H);
}

// ---- a hidden width that is not a multiple of 4 ----------------------------

// The natural packed vector against the padded net's: block k's gr groups
// of [rows, cols] at nat are [prows, pcols] at pad, zeros past the natural
// ones; the blocks cover both vectors in order.
struct PadBlock {
  long nat, pad;
  int gr, rows, cols, prows, pcols;
};

struct PadMap {
  int on;  // the net runs padded
  int n;
  PadBlock b[MAXB];
  long n_nat, n_pad;
  int H, Hq;
};

PadMap rnn_pad_map(const RnnNet& a, const RnnNet& p) {
  PadMap m = {};
  m.on = a.H != p.H;
  m.H = a.H;
  m.Hq = p.H;
  m.n_nat = a.n_params;
  m.n_pad = p.n_params;
  auto add = [&](long nat, long pad, int gr, int rows, int cols, int prows,
                 int pcols) {
    m.b[m.n++] = PadBlock{nat, pad, gr, rows, cols, prows, pcols};
  };
  add(0, 0, 1, 1, (int)a.wi, 1, (int)p.wi);  // the encoder: the same
  add(a.wi, p.wi, a.G, a.H, a.E, p.H, p.E);
  if (!a.lstm) add(a.bi, p.bi, 3, a.H, 1, p.H, 1);
  add(a.wh, p.wh, a.G, a.H, a.H, p.H, p.H);
  add(a.bh, p.bh, a.lstm ? 4 : 1, a.H, 1, p.H, 1);
  add(a.head_w, p.head_w, 1, RHEAD, a.H, RHEAD, p.H);
  add(a.head_b, p.head_b, 1, RHEAD, 1, RHEAD, 1);
  return m;
}

// The padded params from the natural ones, and the carry [B A, H] padded to
// [B A, Hq] (c: the LSTM's, or null).
__global__ void pad_params_kernel(PadMap m, const float* nat, float* pad,
                                  const float* h0, const float* c0,
                                  float* ph0, float* pc0, long BA) {
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = i0; i < m.n_pad; i += stride) {
    int k = 0;
    while (k + 1 < m.n && i >= m.b[k + 1].pad) ++k;
    const PadBlock& b = m.b[k];
    const long off = i - b.pad, per = (long)b.prows * b.pcols;
    const int r = (int)(off % per / b.pcols), c = (int)(off % b.pcols);
    pad[i] = r < b.rows && c < b.cols
                 ? nat[b.nat + (off / per * b.rows + r) * b.cols + c]
                 : 0.f;
  }
  for (long i = i0; i < BA * m.Hq; i += stride) {
    const long n = i / m.Hq;
    const int j = (int)(i % m.Hq);
    ph0[i] = j < m.H ? h0[n * m.H + j] : 0.f;
    if (c0) pc0[i] = j < m.H ? c0[n * m.H + j] : 0.f;
  }
}

// The natural gradient from the padded one.
__global__ void unpad_kernel(PadMap m, const float* pad, float* nat) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < m.n_nat;
       i += (long)gridDim.x * blockDim.x) {
    int k = 0;
    while (k + 1 < m.n && i >= m.b[k + 1].nat) ++k;
    const PadBlock& b = m.b[k];
    const long off = i - b.nat, per = (long)b.rows * b.cols;
    const int r = (int)(off % per / b.cols), c = (int)(off % b.cols);
    nat[i] = pad[b.pad + (off / per * b.prows + r) * b.pcols + c];
  }
}

// ---- the scratch -------------------------------------------------------------

long carve_rnn(const RnnNet& net, const RDims& rd, int T, long N, float* base,
               RnnScratch* sc, RnnTables* tb, const PadMap& map, long BA) {
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const long TN = (long)T * N;
  const int L = net.n_enc, H = net.H, E = net.E;
  for (auto* v : {&tb->encp, &tb->enct, &tb->act, &tb->dz})
    v->assign(L, nullptr);
  sc->encp = tb->encp.data();
  sc->enct = tb->enct.data();
  sc->act = tb->act.data();
  sc->dz = tb->dz.data();
  for (int l = 0; l < L; ++l) {
    sc->encp[l] = take((long)rup(net.enc_out[l], 128) * rd.Ks[l]);
    sc->enct[l] = l ? take((long)rup(net.enc_in[l], 128) * rd.Es[l]) : nullptr;
  }
  sc->wip = take((long)rup(rd.GH, 128) * rd.Es[L - 1]);
  sc->wit = take((long)rup(E, 128) * rd.GHs);
  sc->whp = take((long)net.G * rd.HU * rd.Hk);
  sc->wht = take((long)rd.HV * rd.GHk);
  sc->whw = reinterpret_cast<uint32_t*>(
      take((long)net.G * rd.HU * packed_words(rd.Hk)));
  sc->wtw = reinterpret_cast<uint32_t*>(
      take((long)rd.HV * packed_words(rd.GHk)));
  sc->x0 = take(TN * rd.Xs);
  for (int l = 0; l < L; ++l) {
    sc->act[l] = take(TN * rd.Es[l]);
    sc->dz[l] = take(TN * rd.Es[l]);
  }
  sc->gi = take(TN * rd.GH);
  sc->hs = take((TN + N) * H);
  sc->cs = net.lstm ? take((TN + N) * H) : nullptr;
  sc->gates = take(TN * 4 * H);
  sc->dout = take(TN * OST);
  sc->dhead = take(TN * H);
  sc->dp = take(TN * rd.GHs);
  sc->dx = net.lstm ? sc->dp : take(TN * rd.GHs);
  const int f_tiles = f_tiles_of(net);
  long sf = (SF_TARGET + f_tiles - 1) / f_tiles;
  sf = sf < 1 ? 1 : (sf > MAXSF ? MAXSF : sf);
  sc->chunk = (TN + sf - 1) / sf;
  sc->chunk = (sc->chunk + EN - 1) / EN * EN;
  sc->SF = (int)((TN + sc->chunk - 1) / sc->chunk);
  sc->part = take(sc->SF * net.n_params);
  sc->n_sq = (net.n_params + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->n_tiles_c = (TN + CB - 1) / CB;
  sc->met = take(sc->n_tiles_c * 4);
  sc->pp = sc->pg = sc->ph0 = sc->pc0 = nullptr;
  if (map.on) {
    sc->pp = take(net.n_params);
    sc->pg = take(net.n_params);
    sc->ph0 = take(BA * H);
    if (net.lstm) sc->pc0 = take(BA * H);
  }
  return off;
}

struct SeqArgs {
  RnnNet net;     // at the padded width Hq
  RDims rd;
  Batch bt;       // bt.nb = N sequences, bt.N = T N rows
  RnnScratch sc;
  Coefs c;
  int T;
  const float* params;   // at the padded width (map.on: sc.pp)
  const float* scal;     // ent_coef, kl_coeff
  const float *h0, *c0;  // [B, A, Hq] rollout-start carry (map.on: sc.ph0)
  PadMap map;
  const float *nat_params, *nat_h0, *nat_c0;  // the caller's, at H
};

size_t smem_fwd(const RnnNet& net, const RDims& rd) {
  return sizeof(float) * (net.lstm ? 3 : 2) * RB * rd.HS;
}
size_t smem_head(const RnnNet& net) {
  return sizeof(float) * CB * (net.H + 1 + OST + 4);
}
size_t smem_bwd(const RnnNet& net, const RDims& rd) {
  return sizeof(float) * RB * ((net.lstm ? 2 : 1) * net.H + rd.DXS);
}

size_t rnn_smem(const RnnNet& net, const RDims& rd) {
  size_t m = smem_gemm();
  const size_t s[] = {smem_wgrad(), smem_fwd(net, rd), smem_head(net),
                      smem_bwd(net, rd)};
  for (size_t x : s) m = x > m ? x : m;
  return m;
}

// ---- prep: the observation rows and the padded weight copies -----------------

// Each encoder layer's copies: W_l as GEMM rows and (l >= 1) W_l^T.
PadPlan enc_plan(const SeqArgs& p) {
  const RnnNet& net = p.net;
  const RDims& rd = p.rd;
  PadPlan plan;
  for (int l = 0; l < net.n_enc; ++l) {
    const float* W = p.params + net.enc_w[l];
    const int out = net.enc_out[l], in = net.enc_in[l];
    plan.add(p.sc.encp[l], 0, W, 0, rup(out, 128), rd.Ks[l], out, in, false);
    if (l)
      plan.add(p.sc.enct[l], 0, W, 0, rup(in, 128), rd.Es[l], out, in, true);
  }
  return plan;
}

// The first MAXJ encoder copies (enc_plan), the cell's and the observation
// rows.
__global__ void rnn_prep_kernel(SeqArgs p, PadJobs pj) {
  const RnnNet& net = p.net;
  const RDims& rd = p.rd;
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  const int H = net.H, E = net.E, GH = rd.GH;
  run_pad_jobs(pj, i0, stride);
  const float* Wi = p.params + net.wi;
  pad_copy(p.sc.wip, rup(GH, 128), rd.Es_last, Wi, GH, E, false, i0, stride);
  pad_copy(p.sc.wit, rup(E, 128), rd.GHs, Wi, GH, E, true, i0, stride);
  const float* Wh = p.params + net.wh;
  for (int g = 0; g < net.G; ++g)
    pad_copy(p.sc.whp + (long)g * rd.HU * rd.Hk, rd.HU, rd.Hk,
             Wh + (long)g * H * H, H, H, false, i0, stride);
  pad_copy(p.sc.wht, rd.HV, rd.GHk, Wh, GH, H, true, i0, stride);
  // The same two as packed bf16 pairs (the bf16 recurrences stage them).
  const int WS = packed_words(rd.Hk), WTS = packed_words(rd.GHk);
  for (long i = i0; i < (long)net.G * rd.HU * WS; i += stride) {
    const int r = (int)(i / WS), k = 2 * (int)(i % WS);
    const int g = r / rd.HU, j = r % rd.HU;
    float2 v = make_float2(0.f, 0.f);
    if (j < H && k < H) {
      const float* w = Wh + ((long)g * H + j) * H + k;
      v = make_float2(w[0], w[1]);
    }
    p.sc.whw[i] = pack_bf16(v);
  }
  for (long i = i0; i < (long)rd.HV * WTS; i += stride) {
    const int j = (int)(i / WTS), c = 2 * (int)(i % WTS);
    float2 v = make_float2(0.f, 0.f);
    if (j < H && c < GH) v = make_float2(Wh[(long)c * H + j],
                                         Wh[(long)(c + 1) * H + j]);
    p.sc.wtw[i] = pack_bf16(v);
  }
  // The observation rows: a warp a row at a time, the row's offset found
  // once.
  const Batch& bt = p.bt;
  const int D = net.D, Xs = rd.Xs, lane = threadIdx.x & 31;
  const long warps = stride / 32;
  for (long q = i0 / 32; q < bt.N; q += warps) {
    const float* src = bt.obs + bt.row(q) * D;
    float* dst = p.sc.x0 + q * Xs;
    for (int f = lane; f < Xs; f += 32) dst[f] = f < D ? src[f] : 0.f;
  }
}

// ---- B: the recurrence forward ----------------------------------------------

// Where Wh comes from in the recurrences' products (B and D), chosen per
// launch by what fits in shared memory beside the tiles:
// - RT_SW (bf16; GRU and LSTM at hidden 128): Wh stays in shared memory
//   for all T steps as packed bf16 pairs (prep packs them once), and in B
//   h beside its float32 value as packed pairs too, so a step's product
//   reads no device memory and converts nothing; the products are
//   mma_k16<true>'s, so the bits are those of RT_L1.
// - RT_ST (float32, where a pass's slice fits: 98 / 131 KB for the GRU /
//   LSTM at hidden 128 in B): each pass of 64 units stages its slice of Wh
//   (every gate's rows; D: Wh^T's) by cp.async and runs the FFMA blocks
//   on it; the whole of Wh (196 / 256 KB) does not fit. Through L1 a
//   pass's B loads wait on L2: the float32 product took 60% of B.
// - RT_L1: Wh read through L1, any width.
enum Route { RT_L1, RT_SW, RT_ST };

size_t smem_fwd_route(const RnnNet& net, const RDims& rd, int rt) {
  const int WS = packed_words(rd.Hk);
  if (rt == RT_SW)
    return sizeof(float) * ((size_t)net.G * rd.HU * WS +
                            (net.lstm ? 2 : 1) * RB * rd.HS + 2 * RB * WS);
  return smem_fwd(net, rd) +
         (rt == RT_ST ? sizeof(float) * (size_t)net.G * UB * rd.HS : 0);
}

template <bool BF, bool LSTM, int RT>
__global__ void __launch_bounds__(RNTB) rec_fwd_kernel(SeqArgs p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr bool SW = RT == RT_SW, ST = RT == RT_ST;
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const int H = net.H, GH = NG * H, HS = p.rd.HS, Hk = p.rd.Hk;
  const int HU = p.rd.HU, WS = packed_words(Hk);
  const long ns = (long)HU * Hk;  // whp's rows of one gate
  const long N = p.bt.nb;
  // SW: ws [G HU][WS] (packed Wh), one float32 h [RB][HS] (only its own
  // thread reads an element), c, then hw [2][RB][WS] (packed h).
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);
  // ST: ss [G][UB][HS] (a pass's slice of Wh), then h as without it.
  float* ss = smem;
  float* base = SW ? smem + NG * HU * WS : ST ? smem + NG * UB * HS : smem;
  float* hb[2] = {base, SW ? base : base + RB * HS};
  float* cb = base + (SW ? 1 : 2) * RB * HS;  // LSTM: c
  uint32_t* hw[2];
  hw[0] = reinterpret_cast<uint32_t*>(cb + (LSTM ? RB * HS : 0));
  hw[1] = hw[0] + RB * WS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long n0 = (long)blockIdx.x * RB;
  const int nvalid = N - n0 < RB ? (int)(N - n0) : RB;
  const float* bh = p.params + net.bh;

  // h_0 (and c_0); zeros past the last sequence and in the pad columns.
  for (int i = tid; i < RB * HS; i += RNTB) {
    const int n = i / HS, j = i % HS;
    const bool live = n < nvalid && j < H;
    const long src = (p.bt.mb_off + n0 + n) * H + j;
    const float hv = live ? p.h0[src] : 0.f;
    hb[0][i] = hv;
    if (!SW) hb[1][i] = 0.f;
    if (LSTM) cb[i] = live ? p.c0[src] : 0.f;
    if (live) {
      p.sc.hs[(n0 + n) * H + j] = hv;
      if (LSTM) p.sc.cs[(n0 + n) * H + j] = cb[i];
    }
  }
  if (SW) {
    const float* src = reinterpret_cast<const float*>(p.sc.whw);
    for (int i = tid; i < NG * HU * WS / 4; i += RNTB)
      cp_async16(smem + 4 * i, src + 4 * i, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < 2 * RB * WS; i += RNTB) {
      const int n = i / WS % RB, w = i % WS;
      hw[0][i] = i < RB * WS && 2 * w < Hk
                     ? pack_bf16(*reinterpret_cast<const float2*>(
                           hb[0] + n * HS + 2 * w))
                     : 0u;
    }
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const float* h = hb[t & 1];
    float* hn = hb[(t + 1) & 1];
    const uint32_t* hwc = hw[t & 1];
    uint32_t* hwn = hw[(t + 1) & 1];
    const long q0 = (long)t * N + n0;
    for (int u0 = 0; u0 < H; u0 += UB) {
      const int j0 = u0 + warp * 8;  // the warp's 8 units
      if constexpr (ST) {  // the pass's slice of Wh, every gate's rows
        __syncthreads();   // the previous pass's readers are done
        const int c4s = Hk / 4;
        for (int i = tid; i < NG * UB * c4s; i += RNTB) {
          const int r = i / c4s, c4 = i % c4s * 4;
          cp_async16(ss + r * HS + c4,
                     p.sc.whp + ((long)(r / UB) * HU + u0 + r % UB) * Hk + c4,
                     true);
        }
        cp_async_commit();
      }
      // The gates' input side of the thread's rows at its two units (j,
      // j + 1: both below H or neither, H and j being even), loaded before
      // the product.
      const int j = j0 + 2 * t4;
      float2 gin[2][2][NG];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = 16 * mi + g + 8 * rh;
          const bool live = row < nvalid && j < H;
#pragma unroll
          for (int x = 0; x < NG; ++x)
            gin[mi][rh][x] =
                live ? *reinterpret_cast<const float2*>(
                           p.sc.gi + (q0 + row) * GH + x * H + j)
                     : make_float2(0.f, 0.f);
        }
      if constexpr (ST) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (j0 >= H) continue;
      float acc[2][NG][4];
      zero_frags(acc);
      if constexpr (SW) {
        for (int k = 0; k < Hk; k += 16) {
          uint32_t a[2][4], b[NG][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint32_t* ar = hwc + (16 * mi + g) * WS + k / 2 + t4;
            a[mi][0] = ar[0];
            a[mi][1] = ar[8 * WS];
            a[mi][2] = ar[4];
            a[mi][3] = ar[8 * WS + 4];
          }
#pragma unroll
          for (int x = 0; x < NG; ++x) {
            const uint32_t* br = ws + (x * HU + j0 + g) * WS + k / 2 + t4;
            b[x][0] = br[0];
            b[x][1] = br[4];
          }
          mma_packed(acc, a, b);
        }
      } else if constexpr (BF) {
        const float* wb = p.sc.whp + (long)(j0 + g) * Hk;
        for (int k = 0; k < Hk; k += 16)
          mma_k16<BF>(acc, RtRowLoader{h + g * HS + k, HS},
                      RtColLoader{wb + k, ns, Hk});
      } else if constexpr (ST) {
        ffma_k4(acc, h + g * HS, HS, ss + (j0 - u0 + 2 * t4) * HS,
                (long)UB * HS, HS, Hk);
      } else {
        ffma_k4(acc, h + g * HS, HS, p.sc.whp + (long)(j0 + 2 * t4) * Hk, ns,
                Hk, Hk);
      }
      // The cell's math per (row, unit), each pair of units stored as a
      // float2. SW: with no second float32 h, the GRU's z h reads the
      // thread's own elements before they are overwritten.
      if (j >= H) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = 16 * mi + g + 8 * rh, s = row * HS + j;
          if (row >= nvalid) {
            hn[s] = hn[s + 1] = 0.f;
            if (SW) hwn[row * WS + j / 2] = 0u;
            continue;
          }
          float hv[2], gt[4][2], cn[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            auto gx = [&](int x) {
              return c ? gin[mi][rh][x].y : gin[mi][rh][x].x;
            };
            auto gh = [&](int x) { return acc[mi][x][2 * rh + c]; };
            if constexpr (LSTM) {
              const float ig = sigmoidf(gx(0) + (gh(0) + bh[j + c]));
              const float fg = sigmoidf(gx(1) + (gh(1) + bh[H + j + c]));
              const float gg = tanhf(gx(2) + (gh(2) + bh[2 * H + j + c]));
              const float og = sigmoidf(gx(3) + (gh(3) + bh[3 * H + j + c]));
              cn[c] = fg * cb[s + c] + ig * gg;
              hv[c] = og * tanhf(cn[c]);
              cb[s + c] = cn[c];
              gt[0][c] = ig;
              gt[1][c] = fg;
              gt[2][c] = gg;
              gt[3][c] = og;
            } else {
              const float rg = sigmoidf(gx(0) + gh(0));
              const float zg = sigmoidf(gx(1) + gh(1));
              const float q = gh(2) + bh[j + c];
              const float ng = tanhf(gx(2) + rg * q);
              hv[c] = (1.f - zg) * ng + zg * h[s + c];
              gt[0][c] = rg;
              gt[1][c] = zg;
              gt[2][c] = ng;
              gt[3][c] = q;
            }
            hn[s + c] = hv[c];
          }
          const long q = q0 + row;
#pragma unroll
          for (int x = 0; x < 4; ++x)
            *reinterpret_cast<float2*>(p.sc.gates + q * 4 * H + x * H + j) =
                make_float2(gt[x][0], gt[x][1]);
          *reinterpret_cast<float2*>(p.sc.hs + (q + N) * H + j) =
              make_float2(hv[0], hv[1]);
          if (LSTM)
            *reinterpret_cast<float2*>(p.sc.cs + (q + N) * H + j) =
                make_float2(cn[0], cn[1]);
          if (SW) hwn[row * WS + j / 2] = pack_bf16(make_float2(hv[0], hv[1]));
        }
    }
    __syncthreads();
  }
}

// ---- C: the head, the loss and the head's adjoint ---------------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) head_loss_kernel(SeqArgs p) {
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const int H = net.H, HC = H + 1;
  const long N = p.bt.nb, TN = p.bt.N;
  float* hsm = smem;               // [CB][HC] h_{t+1} rows
  float* outs = hsm + CB * HC;     // [CB][OST] head outputs, then deltas
  float* met = outs + CB * OST;    // [CB][4]
  const int tid = threadIdx.x;
  const long q0 = (long)blockIdx.x * CB;
  const int nvalid = TN - q0 < CB ? (int)(TN - q0) : CB;
  const float* Wh = p.params + net.head_w;
  const float* hrow = p.sc.hs + (N + q0) * H;
  for (int i = tid; i < CB * H; i += GNT) {
    const int n = i / H, j = i % H;
    hsm[n * HC + j] = n < nvalid ? hrow[(long)n * H + j] : 0.f;
  }
  __syncthreads();
  // The head: a warp a row at a time, its lanes over k, then a warp sum
  // per output.
  const int warp = tid >> 5, lane = tid & 31;
  for (int n = warp; n < CB; n += GNT / 32) {
    float a[NHEAD] = {};
    for (int k = lane; k < H; k += 32) {
      const float hv = rbf<BF>(hsm[n * HC + k]);
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        a[o] = fmaf(hv, rbf<BF>(__ldg(Wh + o * H + k)), a[o]);
    }
#pragma unroll
    for (int o = 0; o < NHEAD; ++o) a[o] = warp_sum(a[o]);
    if (lane == 0)
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        outs[n * OST + o] = a[o] + __ldg(p.params + net.head_b + o);
  }
  __syncthreads();
  if (tid < CB) {
    float* o = outs + tid * OST;
    float* m = met + tid * 4;
    if (tid < nvalid) {
      loss_row(o, p.bt.row(q0 + tid), p.bt, p.c, p.scal[0], p.scal[1], m);
      for (int r = 0; r < OST; ++r)
        p.sc.dout[(q0 + tid) * OST + r] = r < NHEAD ? o[r] : 0.f;
    } else {
      for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
      for (int k = 0; k < 4; ++k) m[k] = 0.f;
    }
  }
  __syncthreads();
  if (tid < 4) {  // fixed-order sum over the tile's rows
    float s = 0.f;
    for (int n = 0; n < CB; ++n) s += met[n * 4 + tid];
    p.sc.met[blockIdx.x * 4 + tid] = s;
  }
  for (int i = tid; i < nvalid * H; i += GNT) {
    const int n = i / H, j = i % H;
    float d = 0.f;
#pragma unroll
    for (int o = 0; o < NHEAD; ++o)
      d = fmaf(rbf<BF>(outs[n * OST + o]), rbf<BF>(__ldg(Wh + o * H + j)), d);
    p.sc.dhead[(q0 + n) * H + j] = d;
  }
}

// ---- D: the recurrence backward ---------------------------------------------

// Wh^T's routes as B's: RT_SW the whole of it packed, RT_ST a pass's UB
// rows (units) at a time, 8 a warp.
size_t smem_bwd_route(const RnnNet& net, const RDims& rd, int rt) {
  return smem_bwd(net, rd) +
         (rt == RT_SW ? sizeof(float) * (size_t)rd.HV * packed_words(rd.GHk)
          : rt == RT_ST ? sizeof(float) * (size_t)UB * rd.DXS : 0);
}

template <bool BF, bool LSTM, int RT>
__global__ void __launch_bounds__(RNTB) rec_bwd_kernel(SeqArgs p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr bool SW = RT == RT_SW, ST = RT == RT_ST;
  constexpr int UP = ST ? UB : UD;  // units a pass
  constexpr int NTD = UP / 64;      // n8 tiles of units a warp
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const int H = net.H, GH = NG * H, GHs = p.rd.GHs, GHk = p.rd.GHk;
  const int DXS = p.rd.DXS, WTS = packed_words(GHk);
  const long N = p.bt.nb;
  float* dh = smem;                          // [RB][H]
  float* dc = dh + RB * H;                   // [RB][H] (LSTM)
  float* dxs = dh + (LSTM ? 2 : 1) * RB * H;  // [RB][DXS]
  uint32_t* wts = reinterpret_cast<uint32_t*>(dxs + RB * DXS);  // SW
  float* ts = dxs + RB * DXS;  // ST: [UB][DXS] a pass's rows of Wh^T
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long n0 = (long)blockIdx.x * RB;
  const int nvalid = N - n0 < RB ? (int)(N - n0) : RB;
  for (int i = tid; i < RB * ((LSTM ? 2 : 1) * H + DXS); i += RNTB) smem[i] = 0.f;
  if (SW) {
    const float* src = reinterpret_cast<const float*>(p.sc.wtw);
    for (int i = tid; i < p.rd.HV * WTS / 4; i += RNTB)
      cp_async16(reinterpret_cast<float*>(wts) + 4 * i, src + 4 * i, true);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();

  for (int t = p.T - 1; t >= 0; --t) {
    const long q0 = (long)t * N + n0;
    // The cell's adjoint, elementwise per (row, unit): a thread loads DB
    // items' stored values before it computes any, so that their loads are
    // in flight together.
    constexpr int DB = 4;
    const int items = nvalid * H;
    for (int i0 = tid; i0 < items; i0 += DB * RNTB) {
      float ld[DB][7] = {};  // dhead, 4 gates, h_t (GRU) or c_{t+1}, c_t
#pragma unroll
      for (int b = 0; b < DB; ++b) {
        const int idx = i0 + b * RNTB;
        if (idx >= items) continue;
        const int n = idx / H, j = idx % H;
        const long q = q0 + n;
        const float* gr = p.sc.gates + q * 4 * H + j;
        ld[b][0] = p.sc.dhead[q * H + j];
#pragma unroll
        for (int x = 0; x < 4; ++x) ld[b][1 + x] = gr[x * H];
        if constexpr (LSTM) {
          ld[b][5] = p.sc.cs[(q + N) * H + j];
          ld[b][6] = p.sc.cs[q * H + j];
        } else {
          ld[b][5] = p.sc.hs[q * H + j];
        }
      }
#pragma unroll
      for (int b = 0; b < DB; ++b) {
        const int idx = i0 + b * RNTB;
        if (idx >= items) continue;
        const int n = idx / H, j = idx % H;
        const long q = q0 + n;
        const float d = dh[idx] + ld[b][0];
        const float g0 = ld[b][1], g1 = ld[b][2], g2 = ld[b][3], g3 = ld[b][4];
        float dp[NG], dx[NG];
        if constexpr (LSTM) {
          const float ig = g0, fg = g1, gg = g2, og = g3;
          const float c_cur = ld[b][5], c_prev = ld[b][6];
          const float tc = tanhf(c_cur);
          const float d_o = d * tc;
          const float dcv = dc[idx] + d * og * (1.f - tc * tc);
          dc[idx] = dcv * fg;
          dh[idx] = 0.f;
          dp[0] = dcv * gg * ig * (1.f - ig);
          dp[1] = dcv * c_prev * fg * (1.f - fg);
          dp[2] = dcv * ig * (1.f - gg * gg);
          dp[NG - 1] = d_o * og * (1.f - og);
#pragma unroll
          for (int x = 0; x < NG; ++x) dx[x] = dp[x];
        } else {
          const float rg = g0, zg = g1, ng = g2, qv = g3;
          const float hp = ld[b][5];
          const float dpn = d * (1.f - zg) * (1.f - ng * ng);
          const float dpz = d * (hp - ng) * zg * (1.f - zg);
          dh[idx] = d * zg;
          dp[0] = dx[0] = dpn * qv * rg * (1.f - rg);
          dp[1] = dx[1] = dpz;
          dp[2] = dpn;
          dx[2] = dpn * rg;
        }
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          dxs[n * DXS + x * H + j] = dx[x];
          p.sc.dp[q * GHs + x * H + j] = dp[x];
          if (!LSTM) p.sc.dx[q * GHs + x * H + j] = dx[x];
        }
      }
    }
    // dp's and dx's pad columns are zeros (stages E and F read them).
    const int pad = GHs - GH;
    for (int idx = tid; idx < nvalid * pad; idx += RNTB) {
      const long q = q0 + idx / pad;
      const int c = GH + idx % pad;
      p.sc.dp[q * GHs + c] = 0.f;
      if (!LSTM) p.sc.dx[q * GHs + c] = 0.f;
    }
    __syncthreads();
    if (t == 0) break;

    // dh_prev += dx Wh: 8 warps x 8 NTD units per pass.
    for (int u0 = 0; u0 < H; u0 += UP) {
      const int j0 = u0 + warp * 8 * NTD;
      if constexpr (ST) {
        if (u0) __syncthreads();  // the previous pass's readers are done
        const int c4s = GHk / 4;
        for (int i = tid; i < UB * c4s; i += RNTB) {
          const int r = i / c4s, c4 = i % c4s * 4;
          cp_async16(ts + r * DXS + c4, p.sc.wht + (long)(u0 + r) * GHk + c4,
                     true);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (j0 >= H) continue;
      float acc[2][NTD][4];
      zero_frags(acc);
      if constexpr (SW) {
        for (int k = 0; k < GHk; k += 16) {
          uint32_t a[2][4], b[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* ar = dxs + (16 * mi + g) * DXS + k + 2 * t4;
            a[mi][0] = pack_bf16(*reinterpret_cast<const float2*>(ar));
            a[mi][1] = pack_bf16(
                *reinterpret_cast<const float2*>(ar + 8 * DXS));
            a[mi][2] = pack_bf16(*reinterpret_cast<const float2*>(ar + 8));
            a[mi][3] = pack_bf16(
                *reinterpret_cast<const float2*>(ar + 8 * DXS + 8));
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const uint32_t* br = wts + (j0 + 8 * ni + g) * WTS + k / 2 + t4;
            b[ni][0] = br[0];
            b[ni][1] = br[4];
          }
          mma_packed(acc, a, b);
        }
      } else if constexpr (BF) {
        const float* wb = p.sc.wht + (long)(j0 + g) * GHk;
        for (int k = 0; k < GHk; k += 16)
          mma_k16<BF>(acc, RtRowLoader{dxs + g * DXS + k, DXS},
                      RtColLoader{wb + k, 8L * GHk, GHk});
      } else if constexpr (ST) {
        ffma_k4(acc, dxs + g * DXS, DXS, ts + (j0 - u0 + 2 * t4) * DXS,
                8L * DXS, DXS, GHk);
      } else {
        ffma_k4(acc, dxs + g * DXS, DXS, p.sc.wht + (long)(j0 + 2 * t4) * GHk,
                8L * GHk, GHk, GHk);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTD; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 16 * mi + g + 8 * (r >> 1);
            const int j = j0 + 8 * ni + 2 * t4 + (r & 1);
            if (row < nvalid && j < H) dh[row * H + j] += acc[mi][ni][r];
          }
    }
    __syncthreads();
  }
}

// ---- host side ----------------------------------------------------------------

// The net at the padded width Hq (its tables in *tb), its map from the
// natural one, the minibatch's rows and the stages' widths.
bool make_seq(int n_enc, const int* dims, int H, int lstm, int T, long B,
              int A, int M, int mb, const float* obs, SeqArgs* sa,
              RnnTables* tb) {
  RnnNet nat;
  RnnTables nt;
  if (!make_rnn_net(n_enc, dims, H, lstm, &nat, &nt) ||
      !make_rnn_net(n_enc, dims, rup(H, 4), lstm, &sa->net, tb) ||
      !batch_rows(T, B, A, M, mb, sa->net.D, obs, &sa->bt))
    return false;
  sa->map = rnn_pad_map(nat, sa->net);
  sa->rd = make_rdims(sa->net, tb);
  sa->T = T;
  return true;
}

long carve(SeqArgs* sa, float* base, RnnTables* tb) {
  return carve_rnn(sa->net, sa->rd, sa->T, sa->bt.nb, base, &sa->sc, tb,
                   sa->map, sa->bt.BA);
}

enum Stage { ENC_FWD, REC_FWD, HEAD_LOSS, REC_BWD, ENC_BWD, WGRAD };

template <bool BF>
cudaError_t enc_fwd(const SeqArgs& sa, cudaStream_t stream) {
  const RnnNet& net = sa.net;
  const RDims& rd = sa.rd;
  const RnnScratch& sc = sa.sc;
  const long TN = sa.bt.N;
  cudaError_t e = cudaSuccess;
  for (int l = 0; l < net.n_enc && e == cudaSuccess; ++l)
    e = launch_gemm<BF, EPI_TANH>(
        gemm_args(l ? sc.act[l - 1] : sc.x0, rd.Ks[l], TN, sc.encp[l],
                  rd.Ks[l], sa.params + net.enc_b[l], nullptr, 0, sc.act[l],
                  rd.Es[l], net.enc_out[l]),
        stream);
  if (e != cudaSuccess) return e;
  const int L = net.n_enc;
  return launch_gemm<BF, EPI_BIAS>(
      gemm_args(sc.act[L - 1], rd.Es[L - 1], TN, sc.wip, rd.Es[L - 1],
                net.lstm ? nullptr : sa.params + net.bi, nullptr, 0, sc.gi,
                rd.GH, rd.GH),
      stream);
}

template <bool BF>
cudaError_t enc_bwd(const SeqArgs& sa, cudaStream_t stream) {
  const RnnNet& net = sa.net;
  const RDims& rd = sa.rd;
  const RnnScratch& sc = sa.sc;
  const long TN = sa.bt.N;
  const int L = net.n_enc;
  cudaError_t e = launch_gemm<BF, EPI_DTANH>(
      gemm_args(sc.dp, rd.GHs, TN, sc.wit, rd.GHs, nullptr, sc.act[L - 1],
                rd.Es[L - 1], sc.dz[L - 1], rd.Es[L - 1], net.E),
      stream);
  for (int l = L - 1; l > 0 && e == cudaSuccess; --l)
    e = launch_gemm<BF, EPI_DTANH>(
        gemm_args(sc.dz[l], rd.Es[l], TN, sc.enct[l], rd.Es[l], nullptr,
                  sc.act[l - 1], rd.Es[l - 1], sc.dz[l - 1], rd.Es[l - 1],
                  net.enc_in[l]),
        stream);
  return e;
}

template <bool BF>
cudaError_t wgrad(const SeqArgs& sa, cudaStream_t stream) {
  const RnnNet& net = sa.net;
  const RDims& rd = sa.rd;
  const RnnScratch& sc = sa.sc;
  const int H = net.H, GH = rd.GH, L = net.n_enc;
  const long N = sa.bt.nb;
  std::vector<FTask> t;
  int tiles = 0;
  for (int l = 0; l < L; ++l)
    t.push_back(ftask(sc.dz[l], rd.Es[l], net.enc_out[l],
                      l ? sc.act[l - 1] : sc.x0, rd.Ks[l], net.enc_in[l],
                      net.enc_w[l], net.enc_b[l], 0, net.enc_out[l], &tiles));
  // Wi from dp and e; the GRU's bi sums dp.
  t.push_back(ftask(sc.dp, rd.GHs, GH, sc.act[L - 1], rd.Es[L - 1], net.E,
                    net.wi, net.lstm ? -1 : net.bi, 0, GH, &tiles));
  // Wh from dx and h_0..h_{T-1}; bh sums dx (the GRU's only its q part).
  t.push_back(ftask(sc.dx, rd.GHs, GH, sc.hs, H, H, net.wh, net.bh,
                    net.lstm ? 0 : 2 * H, GH, &tiles));
  t.push_back(ftask(sc.dout, OST, NHEAD, sc.hs + N * H, H, H, net.head_w,
                    net.head_b, 0, NHEAD, &tiles));
  const size_t smem = smem_wgrad();
  cudaError_t e = opt_in(wgrad_tn_kernel<BF>, smem);
  if (e != cudaSuccess) return e;
  return launch_wgrad<BF>(t, sa.bt.N, sc.chunk, net.n_params, sc.part, sc.SF,
                          smem, stream);
}

// Stage B (fwd) or D on the route its weights take (Route): with bf16
// operands RT_SW, in float32 RT_ST, where they fit; else RT_L1.
template <bool BF, bool LSTM>
cudaError_t launch_rec(const SeqArgs& sa, bool fwd, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((sa.bt.nb + RB - 1) / RB);
  constexpr int fast = BF ? RT_SW : RT_ST;
  const size_t want = fwd ? smem_fwd_route(sa.net, sa.rd, fast)
                          : smem_bwd_route(sa.net, sa.rd, fast);
  const bool staged = want <= smem_optin_limit();
  const size_t smem = staged ? want
                      : fwd  ? smem_fwd_route(sa.net, sa.rd, RT_L1)
                             : smem_bwd_route(sa.net, sa.rd, RT_L1);
  auto go = [&](auto kernel) {
    cudaError_t e = opt_in(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<tiles, RNTB, smem, stream>>>(sa);
    return cudaGetLastError();
  };
  if (fwd)
    return staged ? go(rec_fwd_kernel<BF, LSTM, fast>)
                  : go(rec_fwd_kernel<BF, LSTM, RT_L1>);
  return staged ? go(rec_bwd_kernel<BF, LSTM, fast>)
                : go(rec_bwd_kernel<BF, LSTM, RT_L1>);
}

// One stage's kernels (prep not included).
template <bool BF>
cudaError_t launch_stage(const SeqArgs& sa, Stage st, cudaStream_t stream) {
  const RnnNet& net = sa.net;
  cudaError_t e = cudaSuccess;
  switch (st) {
    case ENC_FWD:
      return enc_fwd<BF>(sa, stream);
    case REC_FWD:
      return net.lstm ? launch_rec<BF, true>(sa, true, stream)
                      : launch_rec<BF, false>(sa, true, stream);
    case HEAD_LOSS: {
      const size_t smem = smem_head(net);
      if ((e = opt_in(head_loss_kernel<BF>, smem)) != cudaSuccess) return e;
      head_loss_kernel<BF>
          <<<(unsigned)sa.sc.n_tiles_c, GNT, smem, stream>>>(sa);
      break;
    }
    case REC_BWD:
      return net.lstm ? launch_rec<BF, true>(sa, false, stream)
                      : launch_rec<BF, false>(sa, false, stream);
    case ENC_BWD:
      return enc_bwd<BF>(sa, stream);
    case WGRAD:
      return wgrad<BF>(sa, stream);
  }
  return cudaGetLastError();
}

cudaError_t run_stage(const SeqArgs& sa, Stage st, bool bf16,
                      cudaStream_t stream) {
  return bf16 ? launch_stage<true>(sa, st, stream)
              : launch_stage<false>(sa, st, stream);
}

// The padded params and carry (at a width that is not a multiple of 4),
// then the weight copies and the observation rows.
cudaError_t prep(const SeqArgs& sa, cudaStream_t stream) {
  cudaError_t e;
  if (sa.map.on) {
    pad_params_kernel<<<256, 256, 0, stream>>>(
        sa.map, sa.nat_params, sa.sc.pp, sa.nat_h0, sa.nat_c0, sa.sc.ph0,
        sa.sc.pc0, sa.bt.BA);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const PadPlan plan = enc_plan(sa);
  rnn_prep_kernel<<<1024, 256, 0, stream>>>(sa, plan.batch(0));
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return plan.launch_rest(1024, 256, stream);
}

// Stage F's partials summed in range order into grads (at the natural
// width: through sc.pg and unpad_kernel where the net runs padded), their
// sums of squares into sc.sq.
cudaError_t reduce(const SeqArgs& sa, float* grads, cudaStream_t stream) {
  reduce_kernel<<<(unsigned)sa.sc.n_sq, RED, 0, stream>>>(
      sa.sc.part, sa.sc.SF, sa.net.n_params, sa.map.on ? sa.sc.pg : grads,
      sa.sc.sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !sa.map.on) return e;
  unpad_kernel<<<256, 256, 0, stream>>>(sa.map, sa.sc.pg, grads);
  return cudaGetLastError();
}

cudaError_t metrics(const SeqArgs& sa, float* sums, cudaStream_t stream) {
  metrics_kernel<<<1, 128, 0, stream>>>(sa.sc.met, sa.sc.n_tiles_c, sums);
  return cudaGetLastError();
}

// The arguments of wh_rnn_sgd_grads and wh_rnn_sgd_stage as SeqArgs.
int make_grads_args(int n_enc, const int* dims, int H, int lstm, int T,
                    long B, int A, int M, int mb, const float* obs,
                    const int* action, const float* old_lp,
                    const float* old_v, const float* adv, const float* target,
                    const unsigned char* mask, const float* h0,
                    const float* c0, const float* params, const float* scal,
                    float clip_eps, float clip_lo, float clip_hi,
                    float value_coef, float inv_n, float* work, SeqArgs* sa,
                    RnnTables* tb) {
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, mb, obs, sa, tb) ||
      (lstm && !c0))
    return (int)cudaErrorInvalidValue;
  sa->bt.action = action;
  sa->bt.old_lp = old_lp;
  sa->bt.old_v = old_v;
  sa->bt.adv = adv;
  sa->bt.target = target;
  sa->bt.mask = mask;
  carve(sa, work, tb);
  sa->c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  sa->nat_params = params;
  sa->nat_h0 = h0;
  sa->nat_c0 = lstm ? c0 : nullptr;
  const bool pad = sa->map.on;
  sa->params = pad ? sa->sc.pp : params;
  sa->h0 = pad ? sa->sc.ph0 : h0;
  sa->c0 = pad ? sa->sc.pc0 : c0;
  sa->scal = scal;
  return 0;
}

}  // namespace

// Shared memory of the largest stage's CTA in bytes, or 0 for unsupported
// widths.
extern "C" long wh_rnn_sgd_smem_bytes(int n_enc, const int* dims, int H,
                                      int lstm) {
  RnnNet net;
  RnnTables tb;
  if (H <= 0 || !make_rnn_net(n_enc, dims, rup(H, 4), lstm, &net, &tb))
    return 0;
  return (long)rnn_smem(net, make_rdims(net, &tb));
}

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape.
extern "C" long wh_rnn_sgd_workspace_floats(int n_enc, const int* dims, int H,
                                            int lstm, int T, long B, int A,
                                            int M) {
  SeqArgs sa;
  RnnTables tb;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa, &tb))
    return 0;
  return carve(&sa, nullptr, &tb);
}

// Where the stages' rows lie in the workspace, 12 + 3 n_enc longs: out[0,
// 9) = the float offsets of x0, gi, hs, cs, gates, dout, dhead, dp, dx (-1
// where the net has none), out[9, 12) = the row stride Xs of x0, GHs of dp
// and dx, and the padded width Hq (H rounded up to 4: the row stride of
// hs, cs and dhead, the stride of a gate's block in gi, gates, dp and dx);
// then per encoder layer l, out[12 + 3 l, 15 + 3 l) = the offsets of act_l
// and dz_l and their row stride Es_l.
extern "C" int wh_rnn_sgd_layout(int n_enc, const int* dims, int H, int lstm,
                                 int T, long B, int A, int M, long* out) {
  SeqArgs sa;
  RnnTables tb;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  carve(&sa, base, &tb);
  const RnnScratch& sc = sa.sc;
  const float* ptrs[9] = {sc.x0,   sc.gi,    sc.hs, sc.cs, sc.gates,
                          sc.dout, sc.dhead, sc.dp, sc.dx};
  for (int i = 0; i < 9; ++i) out[i] = ptrs[i] ? (long)(ptrs[i] - base) : -1;
  out[9] = sa.rd.Xs;
  out[10] = sa.rd.GHs;
  out[11] = sa.net.H;
  for (int l = 0; l < n_enc; ++l) {
    out[12 + 3 * l] = sc.act[l] - base;
    out[13 + 3 * l] = sc.dz[l] - base;
    out[14 + 3 * l] = sa.rd.Es[l];
  }
  return 0;
}

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
  RnnTables tb;
  int err = make_grads_args(n_enc, dims, H, lstm, T, B, A, M, mb, obs, action,
                            old_lp, old_v, adv, target, mask, h0, c0, params,
                            scal, clip_eps, clip_lo, clip_hi, value_coef,
                            inv_n, work, &sa, &tb);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = prep(sa, stream);
  const Stage order[] = {ENC_FWD, REC_FWD, HEAD_LOSS, REC_BWD, ENC_BWD, WGRAD};
  for (Stage st : order)
    if (e == cudaSuccess) e = run_stage(sa, st, bf16 != 0, stream);
  if (e == cudaSuccess) e = reduce(sa, grads, stream);
  if (e == cudaSuccess) e = metrics(sa, sums, stream);
  return (int)e;
}

// One stage of wh_rnn_sgd_grads on the rows the workspace holds (the
// stages' checks and times), after prep (the observation rows, the weight
// copies): 0 enc_fwd (act, gi); 1 rec_fwd (hs, cs, gates); 2 head_loss
// (dout, dhead, sums[0..3]); 3 rec_bwd (dp, dx); 4 enc_bwd (dz); 5 wgrad
// (grads).
extern "C" int wh_rnn_sgd_stage(
    int stage, int n_enc, const int* dims, int H, int lstm, int T, long B,
    int A, int M, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* h0,
    const float* c0, const float* params, const float* scal, float clip_eps,
    float clip_lo, float clip_hi, float value_coef, float inv_n, float* work,
    float* grads, float* sums, int bf16, void* stream_) {
  if (stage < ENC_FWD || stage > WGRAD) return (int)cudaErrorInvalidValue;
  SeqArgs sa;
  RnnTables tb;
  int err = make_grads_args(n_enc, dims, H, lstm, T, B, A, M, mb, obs, action,
                            old_lp, old_v, adv, target, mask, h0, c0, params,
                            scal, clip_eps, clip_lo, clip_hi, value_coef,
                            inv_n, work, &sa, &tb);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = prep(sa, stream);
  if (e == cudaSuccess) e = run_stage(sa, (Stage)stage, bf16 != 0, stream);
  if (e == cudaSuccess && stage == HEAD_LOSS) e = metrics(sa, sums, stream);
  if (e == cudaSuccess && stage == WGRAD) e = reduce(sa, grads, stream);
  return (int)e;
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
  RnnTables tb;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa, &tb) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  carve(&sa, work, &tb);
  // The natural vector; the sums of squares are the padded gradient's,
  // whose pad entries are zeros.
  const AdamArgs p = {sa.map.n_nat, sa.sc.n_sq, grads, sa.sc.sq, params, m,
                      v, lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<(unsigned)((p.n + FNT - 1) / FNT), FNT, 0,
                (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}

// The sums of squares of `grads` (the natural layout, at H: the all-reduced
// buffer's) as reduce_kernel takes them over the net the kernels run
// (launch_sumsq): where H is not a multiple of 4 the gradient is first
// scattered into the padded layout at sc.pg (pad_params_kernel's PadMap,
// zeros at the pad entries, as reduce leaves them), so that the sums run
// over the same blocks. Into `sq` where it is not null, else into the
// workspace, where wh_rnn_sgd_clip_adam reads them. The meshed route
// launches it on the gradient averaged over the ranks.
extern "C" int wh_rnn_sgd_sumsq(int n_enc, const int* dims, int H, int lstm,
                                int T, long B, int A, int M,
                                const float* grads, float* sq, float* work,
                                void* stream_) {
  SeqArgs sa;
  RnnTables tb;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  carve(&sa, work, &tb);
  cudaStream_t stream = (cudaStream_t)stream_;
  const float* padded = grads;
  if (sa.map.on) {
    pad_params_kernel<<<256, 256, 0, stream>>>(sa.map, grads, sa.sc.pg,
                                               nullptr, nullptr, nullptr,
                                               nullptr, 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    padded = sa.sc.pg;
  }
  return (int)launch_sumsq(padded, sa.net.n_params, 1, sq ? sq : sa.sc.sq,
                           stream);
}

// Where the gradient's sums of squares lie in the workspace: out[0] their
// float offset, out[1] their count (over the padded net), out[2] the
// padded net's parameter count.
extern "C" int wh_rnn_sgd_sq_layout(int n_enc, const int* dims, int H,
                                    int lstm, int T, long B, int A, int M,
                                    long* out) {
  SeqArgs sa;
  RnnTables tb;
  if (!make_seq(n_enc, dims, H, lstm, T, B, A, M, 0, nullptr, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  carve(&sa, base, &tb);
  out[0] = sa.sc.sq - base;
  out[1] = sa.sc.n_sq;
  out[2] = sa.net.n_params;
  return 0;
}
