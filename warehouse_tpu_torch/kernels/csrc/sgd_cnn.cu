// K11 + K12: the SGD phase of the CNN PPO learner, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd_cnn.py ppo_cnn_sgd_phase_pallas (:482;
// body _cnn_sgd_kernel :271 with _cnn_block_grads :201, _loss_and_dout
// sgd.py:68 and _clip_adam_step sgd.py:226) and
// ppo_cnn_minibatch_grads_pallas (:595; the same body with emit_grads).
// Minibatch m is env columns [m B/M, (m+1) B/M) of the trajectory, N = T *
// B/M * A samples. One minibatch's gradient (K12, wh_cnn_sgd_grads) is
// stages shaped by their products, each a kernel on the caller's stream:
//
//   prep: the trunk's kernel Wt [H, trunk_in] as two zero-padded copies,
//      wk [HP, KT] (rows of k) and wtt [NC1, HK] (its conv columns
//      transposed), rounded to bf16 with BF.
//   A conv_fwd_kernel: persistent CTAs of 16 warps over tiles of RA
//      samples (64, or as many as fit: 16 on the 9 x 9 global view), the
//      obs rows staged by cp.async. Both convolutions as implicit products
//      (rows = the tile's (sample, position); conv 0: 16 columns, K = 10
//      taps x 8 padded channels, on the CUDA cores in both instances; conv
//      1: 32 columns, K = 9 taps x 16); a0 [N, P2 C1] and the trunk's
//      input a1 [N, KT] (self features after the grid, zeros to KT) go to
//      device memory.
//   B trunk_fwd_kernel: h = tanh(a1 Wt^T + bt) over tiles of 64 samples x
//      128 columns (a pass per 128 of H), Wt's k-slices and a1's
//      through a double-buffered cp.async ring; the epilogue holds whole
//      rows of h, so it computes the 6 x H head, the clipped-PPO loss chain
//      per row (loss_row, shared with the MLP learner), the tile's metric
//      sums in row order, the head's adjoint and tanh', and writes h, dout
//      and dzt.
//   C trunk_dgrad_kernel: conv 1's delta d1 = (dzt Wt[:, :P2 C2]) where
//      a1 > 0 (the relu routes on z > 0, sgd_cnn.py:263), tiles of 64 x 128.
//   D conv_bwd_kernel: persistent CTAs of 18 warps, two per tap, over tiles
//      of RD samples (24; 8 on the 9 x 9 view) staged by cp.async: conv 0's
//      delta d0 = conv 1's transposed convolution of d1 (rows = (sample,
//      position), K = 9 taps x 32) masked by a0 > 0, conv 1's and conv 0's
//      weight gradients (K = the tile's samples at the tap's valid
//      positions, each of its two warps half of them) and the biases'
//      sums. A CTA keeps its partials in registers over its tiles and
//      writes one row of conv partials, in the 3x3 basis, each tap's two
//      parts summed in order.
//   E trunk_wgrad_kernel: dWt = dzt^T a1 over tiles of 128 x 128 and the
//      head's dWh = dout^T h (CUDA cores), split-K over SE sample ranges,
//      one partial per range.
//   then reduce_kernel twice (the conv partials in CTA order, the dense
//      ones in split order; sums of squares per 256 gradients) and
//      metrics_kernel (mlp_learner.cuh).
//
// K11 (wh_cnn_sgd_clip_adam) follows each gradient with adam_kernel, the
// optax clip + Adam step of the MLP learner, on the packed vector.
//
// The products (mma_tiles.cuh): with bf16 operands (matmul_dtype=
// "bfloat16", _cnn_block_grads' dot at sgd_cnn.py:213-216) on the tensor
// cores as m16n8k16 with float32 sums; in float32 as FFMA on the CUDA cores
// over the same tiles, each thread a register block (the tensor cores'
// TF32 routes miss the float32 twin's bounds: mma_tiles.cuh). With BF the
// operands are rounded where the mma packs them; a value that is only ever
// an operand is stored rounded (a0, a1, the obs grid, the weight copies);
// d1, d0, dzt and dout stay float32 for the bias sums, the masks and
// tanh'. The head's products run on the CUDA cores on rounded operands.
// Every sum runs in an order fixed by the shapes and the card's SM count
// (D's persistent grid), with no atomics, so a rerun gives the same bits.
//
// The TPU kernel accumulates the conv gradients in the unrolled dense basis
// and folds them onto the 3x3 kernels before the optimizer step, then
// rebuilds the unrolled matrices; here the convolution and its gradient are
// computed in the 3x3 basis, so neither step exists. The bound is the
// products' rate (the tensor cores' in bf16, the CUDA cores' in float32):
// per sample ~0.4 MFLOP forward, ~0.38 backward to the layers' inputs and
// ~0.4 in the weight gradients at S = 5 (x3.3 at S = 9).
//
// Tie rules: the relu passes gradient where its output is positive (z > 0),
// which is also torch's; the surrogate-min and value-max ties follow
// loss_row (sgd.cu's note).

#include <cuda_runtime.h>

#include "cnn_net.cuh"
#include "mlp_learner.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int LC1 = 16, LC2 = 32;  // the learner's conv widths (CNN_CHANNELS)
constexpr int XC = 8;       // obs channels in shared memory: C0 <= 8, zero pad
constexpr int ANT = 512;    // threads of stage A
constexpr int DNT = 576;    // threads of stage D: two warps per tap
constexpr int RA_MAX = 64;  // samples per stage-A tile at most
constexpr int RD_MAX = 24;  // samples per stage-D tile at most
constexpr int SE_TARGET = 512;  // stage E CTAs aimed at (split-K ranges)
constexpr int MAXSE = 64;   // sample ranges of stage E at most
constexpr int A1S = LC1 + 4;   // a0's stride per position in shared memory
constexpr int D1S = LC2 + 4;   // d1's (stage D)
constexpr int XSD = XC + 4;    // the obs grid's (stage D)
constexpr int W1TS = LC2 + 4;  // conv 1's kernel transposed, per (tap, ic)
constexpr int MDMAX = 3;    // stage D: m16 tiles of d0 per warp at most
constexpr long MAXG = 1024;  // stage-D CTAs at most: rows of conv partials

inline int round_up(long x, int m) { return (int)((x + m - 1) / m * m); }

struct LDims {  // the learner's padded widths and tiles
  int KT;    // trunk_in rounded up to 32: a1's and wk's row stride
  int HK;    // H rounded up to 32: dzt's and wtt's row stride
  int HP;    // H rounded up to 128: wk's rows, stage B's passes x 128
  int P2C1, P2C2;
  int NC1;   // P2 C2 rounded up to 128: wtt's rows
  int TK;    // stage E's tiles along KT
  int RA, RD;  // samples per tile of stages A and D (0: none fits)
};

// Stage A: the conv kernels, then per sample the obs row, conv 0's output
// and the offset of its obs row in device memory (2 floats).
size_t smem_a(const CnnNet& net, int ra) {
  return sizeof(float) * (10 * LC1 * XC + LC1 + 9 * LC2 * A1S + LC2 + 16 +
                          (size_t)ra * (net.P2 * XC + 8 + net.P2 * A1S + 2));
}

// Stage D: conv 1's kernel transposed, then per sample d1, a0 (then d0)
// and the obs grid, a zero row, and each sample's obs row offset.
size_t smem_d(const CnnNet& net, int rd) {
  return sizeof(float) *
         (9 * LC1 * W1TS + 16 + (size_t)rd * (net.P2 * (D1S + A1S + XSD) + 2));
}

// The next (position, sample run) of a tap's valid output positions, in
// row, column, run order.
__device__ __forceinline__ void next_half(int& ro, int& co, int& b, int co_lo,
                                          int co_hi, int nb) {
  if (++b < nb) return;
  b = 0;
  if (++co < co_hi) return;
  co = co_lo;
  ++ro;
}

// Each sample's obs row offset in device memory, for the tile's first
// sample q0 (0 past the last sample), into rowoff[0, rows).
__device__ __forceinline__ void tile_rows(const Batch& bt, long q0, int rows,
                                          int nvalid, long* rowoff) {
  for (int n = threadIdx.x; n < rows; n += blockDim.x)
    rowoff[n] = n < nvalid ? bt.row(q0 + n) * bt.D : 0;
}

size_t smem_b(const LDims& ld, bool bf) {
  const int LD = bf ? ldt<true>() : ldt<false>();
  return sizeof(float) *
         (2 * (BM + BN) * LD + BM * (ld.HP + 4) + BM * OST + BM * 4);
}

size_t smem_c(bool bf) {
  return sizeof(float) * 2 * (BM + BN) * (bf ? ldt<true>() : ldt<false>());
}

size_t smem_e(bool bf) {
  return sizeof(float) * 2 * 2 * EN * (bf ? lde<true>() : lde<false>());
}

// The learner's widths: conv widths 16 and 32, at most 8 input channels;
// the tiles from the device's shared memory (stage B's rows of h take
// the rest: learn_smem).
bool make_learn(const CnnNet& net, LDims* ld) {
  if (net.C1 != LC1 || net.C2 != LC2 || net.C0 > XC) return false;
  ld->KT = round_up(net.trunk_in, 32);
  ld->HK = round_up(net.H, 32);
  ld->HP = round_up(net.H, BN);
  ld->P2C1 = net.P2 * LC1;
  ld->P2C2 = net.P2 * LC2;
  ld->NC1 = round_up(ld->P2C2, BN);
  ld->TK = (ld->KT + EK - 1) / EK;
  const size_t limit = smem_optin_limit();
  ld->RA = 0;
  for (int ra = RA_MAX; ra >= 16 && !ld->RA; ra -= 16)
    if (smem_a(net, ra) <= limit) ld->RA = ra;
  ld->RD = 0;
  for (int rd = RD_MAX; rd >= 8 && !ld->RD; rd -= 8) {
    const int mtiles = (rd * net.P2 + 15) / 16;
    if (smem_d(net, rd) <= limit && (mtiles + 17) / 18 <= MDMAX) ld->RD = rd;
  }
  return true;
}

// Bytes of the largest stage's shared memory: of the smallest conv tiles
// when not even those fit, so that the caller's comparison fails.
size_t learn_smem(const CnnNet& net, const LDims& ld) {
  size_t m = smem_a(net, ld.RA ? ld.RA : 16);
  const size_t d = smem_d(net, ld.RD ? ld.RD : 8);
  const size_t b = smem_b(ld, true);
  m = d > m ? d : m;
  m = b > m ? b : m;
  m = smem_c(true) > m ? smem_c(true) : m;
  return smem_e(false) > m ? smem_e(false) : m;
}

struct CnnScratch {
  float* wk;     // [HP, KT] the trunk's kernel, zero-padded
  float* wtt;    // [NC1, HK] its first P2 C2 columns transposed
  float* a0;     // [N, P2 C1] conv 0's output
  float* a1;     // [N, KT] the trunk's input
  float* h;      // [N, H] its output
  float* dzt;    // [N, HK] its delta
  float* dout;   // [N, OST] the head's deltas
  float* d1;     // [N, P2 C2] conv 1's delta
  float* part;   // [SE, n_params - n_conv] dense gradient partials
  float* cpart;  // [MAXG, n_conv] conv gradient partials, one row per CTA
  float* sq;     // [n_sq] sums of squares: the conv blocks, then the dense
  float* met;    // [n_tiles_b, 4] metric sums per stage-B tile
  int SE;
  long chunk;    // samples per stage-E range
  long tiles_a, tiles_b, tiles_d, n_sq_conv, n_sq;
};

long carve_cnn(const CnnNet& net, const LDims& ld, long N, float* base,
               CnnScratch* sc) {
  if (ld.RA < 1 || ld.RD < 1) return 0;
  long off = 0;
  auto take = [&](long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 31) / 32 * 32;
    return p;
  };
  const long n_dense = net.n_params - net.n_conv;
  sc->wk = take((long)ld.HP * ld.KT);
  sc->wtt = take((long)ld.NC1 * ld.HK);
  sc->a0 = take(N * ld.P2C1);
  sc->a1 = take(N * ld.KT);
  sc->h = take(N * net.H);
  sc->dzt = take(N * ld.HK);
  sc->dout = take(N * OST);
  sc->d1 = take(N * ld.P2C2);
  const int tiles_e = ld.HP / EJ * ld.TK;
  long se = (SE_TARGET + tiles_e - 1) / tiles_e;
  se = se < 1 ? 1 : (se > MAXSE ? MAXSE : se);
  sc->chunk = (N + se - 1) / se;
  sc->chunk = (sc->chunk + EN - 1) / EN * EN;
  sc->SE = (int)((N + sc->chunk - 1) / sc->chunk);
  sc->part = take(sc->SE * n_dense);
  sc->tiles_a = (N + ld.RA - 1) / ld.RA;
  sc->tiles_b = (N + BM - 1) / BM;
  sc->tiles_d = (N + ld.RD - 1) / ld.RD;
  sc->cpart = take((sc->tiles_d < MAXG ? sc->tiles_d : MAXG) * net.n_conv);
  sc->n_sq_conv = (net.n_conv + RED - 1) / RED;
  sc->n_sq = sc->n_sq_conv + (n_dense + RED - 1) / RED;
  sc->sq = take(sc->n_sq);
  sc->met = take(sc->tiles_b * 4);
  return off;
}

struct CnnArgs {
  CnnNet net;
  LDims ld;
  Batch bt;
  CnnScratch sc;
  Coefs c;
  const float* params;
  const float* scal;  // ent_coef, kl_coeff
};

// ---- prep: the trunk's kernel as the stages read it -------------------------

template <bool BF>
__global__ void trunk_prep_kernel(CnnArgs p) {
  const CnnNet& net = p.net;
  const LDims& ld = p.ld;
  const float* Wt = p.params + net.wt;
  const long nk = (long)ld.HP * ld.KT, n = nk + (long)ld.NC1 * ld.HK;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if (i < nk) {
      const int j = (int)(i / ld.KT), k = (int)(i % ld.KT);
      p.sc.wk[i] = j < net.H && k < net.trunk_in
                       ? rbf<BF>(Wt[(long)j * net.trunk_in + k])
                       : 0.f;
    } else {
      const int c = (int)((i - nk) / ld.HK), j = (int)((i - nk) % ld.HK);
      p.sc.wtt[i - nk] = c < ld.P2C2 && j < net.H
                             ? rbf<BF>(Wt[(long)j * net.trunk_in + c])
                             : 0.f;
    }
  }
}

// ---- A: the convolutions forward --------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(ANT) conv_fwd_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  const Batch& bt = p.bt;
  const int S = net.S, P2 = net.P2, C0 = net.C0, RA = p.ld.RA;
  const int KT = p.ld.KT, XR = P2 * XC + 8;  // an obs row in shared memory
  float* w0 = smem;                 // [10 C1][XC]: row k C1 + oc; tap 9 zeros
  float* b0 = w0 + 10 * LC1 * XC;   // [C1]
  float* w1 = b0 + LC1;             // [9 C2][A1S]: row k C2 + oc, column ic
  float* b1 = w1 + 9 * LC2 * A1S;   // [C2]
  float* zrow = b1 + LC2;           // [16] zeros: a tap outside the grid
  float* xs = zrow + 16;            // [RA][XR]
  float* a0 = xs + RA * XR;         // [RA P2][A1S]
  long* rowoff = reinterpret_cast<long*>(a0 + RA * P2 * A1S);
  const int tid = threadIdx.x;
  const float* prm = p.params;

  for (int i = tid; i < 10 * LC1 * XC; i += ANT) {
    const int row = i / XC, ic = i % XC;
    w0[i] = row < 9 * LC1 && ic < C0 ? rbf<BF>(prm[net.w0 + row * C0 + ic])
                                     : 0.f;
  }
  for (int i = tid; i < LC1; i += ANT) b0[i] = prm[net.b0 + i];
  for (int i = tid; i < 9 * LC2 * LC1; i += ANT)
    w1[i / LC1 * A1S + i % LC1] = rbf<BF>(prm[net.w1 + i]);
  for (int i = tid; i < LC2; i += ANT) b1[i] = prm[net.b1 + i];
  for (int i = tid; i < 16; i += ANT) zrow[i] = 0.f;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int mtiles = RA * P2 / 16;  // m16 tiles of (sample, position) rows

  for (long tile = blockIdx.x; tile < p.sc.tiles_a; tile += gridDim.x) {
    const long q0 = tile * RA;
    const int nvalid = bt.N - q0 < RA ? (int)(bt.N - q0) : RA;
    __syncthreads();  // the previous tile's readers are done
    tile_rows(bt, q0, RA, nvalid, rowoff);
    __syncthreads();
    // The obs rows through cp.async: the grid at XC channels, the self
    // features, zeros for the pad channels and past the last sample.
    for (int i = tid; i < RA * XR; i += ANT) {
      const int n = i / XR, s = i % XR;
      const int c = s % XC, sf = s - P2 * XC;
      const bool ok = n < nvalid && (s < P2 * XC ? c < C0 : sf < NSELF);
      const int f = s < P2 * XC ? s / XC * C0 + c : P2 * C0 + sf;
      cp_async4(xs + i, ok ? bt.obs + rowoff[n] + f : bt.obs, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (BF) {
      for (int i = tid; i < RA * XR; i += ANT) xs[i] = rbf<BF>(xs[i]);
      __syncthreads();
    }

    // Both convolutions as implicit products, a warp two m16 tiles of
    // (sample, position) rows at a time; a tap outside the grid reads the
    // zero row. Conv 0: K = (tap, channel), two taps of 8 channels a chunk
    // (the tenth tap zeros), into a0. Conv 1: K = (tap, input channel),
    // one tap a chunk, into a1 in device memory.
    for (int conv = 0; conv < 2; ++conv) {
      for (int mt = 2 * warp; mt < mtiles; mt += 2 * (ANT / 32)) {
        int rn[2][2], rro[2][2], rco[2][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int m = (mt + mi) * 16 + g + 8 * r;
            rn[mi][r] = mt + mi < mtiles ? m / P2 : -1;
            rro[mi][r] = m % P2 / S;
            rco[mi][r] = m % P2 % S;
          }
        // The lane's row (mi, r) at tap k: its input position's run in a
        // buffer of rs floats a sample and ps a position.
        auto at = [&](int mi, int r, int k, const float* base, int rs,
                      int ps) {
          const int ri = rro[mi][r] + k / 3 - 1, ci = rco[mi][r] + k % 3 - 1;
          return k < 9 && rn[mi][r] >= 0 && ri >= 0 && ri < S && ci >= 0 &&
                         ci < S
                     ? base + rn[mi][r] * rs + (ri * S + ci) * ps
                     : (const float*)zrow;
        };
        if (conv == 0) {
          float acc[2][2][4];
          zero_frags(acc);
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            TapRowsLoader<2> la;
            TapColLoader<XC> lb;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              lb.p[h] = w0 + ((2 * c + h) * LC1 + g) * XC;
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int r = 0; r < 2; ++r)
                  la.p[mi][r][h] = at(mi, r, 2 * c + h, xs, XR, XC);
            }
            // On the CUDA cores in both instances: the operands are stored
            // rounded with BF, so the products are the bf16 ones, summed
            // in float32 with rounding (the tensor cores' truncating sums
            // put the bf16 phase's moments past their bound on the 9 x 9
            // view).
            mma_k16<false>(acc, la, lb);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              if (rn[mi][rh] < 0) continue;
              float* dst = a0 + ((mt + mi) * 16 + g + 8 * rh) * A1S;
#pragma unroll
              for (int ni = 0; ni < 2; ++ni) {
                const int oc = 8 * ni + 2 * t;
                float2 v;
                v.x = rbf<BF>(fmaxf(acc[mi][ni][2 * rh] + b0[oc], 0.f));
                v.y = rbf<BF>(fmaxf(acc[mi][ni][2 * rh + 1] + b0[oc + 1],
                                    0.f));
                *reinterpret_cast<float2*>(dst + oc) = v;
              }
            }
        } else {
          float acc[2][4][4];
          zero_frags(acc);
#pragma unroll 3
          for (int k = 0; k < 9; ++k) {
            RowsLoader<2> la;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                la.p[mi][r] = at(mi, r, k, a0, P2 * A1S, A1S);
            mma_k16<BF>(acc, la, ColLoader<A1S>{w1 + (k * LC2 + g) * A1S});
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const int n = rn[mi][rh];
              if (n < 0 || n >= nvalid) continue;
              float* dst = p.sc.a1 + (q0 + n) * KT +
                           (rro[mi][rh] * S + rco[mi][rh]) * LC2;
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                const int oc = 8 * ni + 2 * t;
                float2 v;
                v.x = rbf<BF>(fmaxf(acc[mi][ni][2 * rh] + b1[oc], 0.f));
                v.y = rbf<BF>(fmaxf(acc[mi][ni][2 * rh + 1] + b1[oc + 1],
                                    0.f));
                *reinterpret_cast<float2*>(dst + oc) = v;
              }
            }
        }
      }
      __syncthreads();  // a0 complete before conv 1 and its store
      if (conv == 0)
        for (int i = tid; i < nvalid * p.ld.P2C1; i += ANT) {
          const int n = i / p.ld.P2C1, r = i % p.ld.P2C1;
          p.sc.a0[(q0 + n) * p.ld.P2C1 + r] =
              a0[(n * P2 + r / LC1) * A1S + r % LC1];
        }
    }
    const int tail = KT - p.ld.P2C2;  // the self features, then zeros
    for (int i = tid; i < nvalid * tail; i += ANT) {
      const int n = i / tail, f = i % tail;
      p.sc.a1[(q0 + n) * KT + p.ld.P2C2 + f] =
          f < NSELF ? xs[n * XR + P2 * XC + f] : 0.f;
    }
  }
}

// ---- B: the trunk forward, the head and the loss ----------------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) trunk_fwd_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = ldt<BF>();
  const CnnNet& net = p.net;
  const int H = net.H, HK = p.ld.HK, HS = p.ld.HP + 4, KT = p.ld.KT;
  float* ring = smem;
  float* hb = ring + 2 * (BM + BN) * LD;  // [BM][HS] the tile's h rows
  float* outs = hb + BM * HS;             // [BM][OST] head outputs, deltas
  float* met = outs + BM * OST;           // [BM][4]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const long q0 = (long)blockIdx.x * BM;
  const int nvalid = p.bt.N - q0 < BM ? (int)(p.bt.N - q0) : BM;
  const float* bias = p.params + net.bt;
  const float* Wh = p.params + net.head_w;

  for (int n0 = 0; n0 < p.ld.HP; n0 += BN) {
    float acc[2][4][4];
    zero_frags(acc);
    gemm_64x128<BF>(acc, p.sc.a1 + q0 * KT, KT, nvalid,
                    p.sc.wk + (long)n0 * KT, KT, KT, ring);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm * 32 + 16 * mi + g + 8 * (r >> 1);
          const int j = n0 + wn * 32 + 8 * ni + 2 * t + (r & 1);
          if (j < H) hb[row * HS + j] = tanhf(acc[mi][ni][r] + __ldg(bias + j));
        }
  }
  __syncthreads();
  for (int i = tid; i < nvalid * H; i += GNT) {
    const int n = i / H, j = i % H;
    p.sc.h[(q0 + n) * H + j] = hb[n * HS + j];
  }
  for (int i = tid; i < BM * NHEAD; i += GNT) {
    const int n = i / NHEAD, o = i % NHEAD;
    float a = 0.f;
    for (int k = 0; k < H; ++k)
      a = fmaf(rbf<BF>(hb[n * HS + k]), rbf<BF>(__ldg(Wh + o * H + k)), a);
    outs[n * OST + o] = a + __ldg(p.params + net.head_b + o);
  }
  __syncthreads();
  if (tid < BM) {
    float* o = outs + tid * OST;
    float* m = met + tid * 4;
    if (tid < nvalid) {
      loss_row(o, p.bt.row(q0 + tid), p.bt, p.c, p.scal[0], p.scal[1], m);
      for (int r = 0; r < NHEAD; ++r) p.sc.dout[(q0 + tid) * OST + r] = o[r];
    } else {
      for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
      for (int k = 0; k < 4; ++k) m[k] = 0.f;
    }
  }
  __syncthreads();
  if (tid < 4) {  // fixed-order sum over the tile's rows
    float s = 0.f;
    for (int n = 0; n < BM; ++n) s += met[n * 4 + tid];
    p.sc.met[blockIdx.x * 4 + tid] = s;
  }
  // The trunk's delta: the head's adjoint times tanh'; zeros to HK.
  for (int i = tid; i < nvalid * HK; i += GNT) {
    const int n = i / HK, j = i % HK;
    float dz = 0.f;
    if (j < H) {
      float d = 0.f;
#pragma unroll
      for (int o = 0; o < NHEAD; ++o)
        d = fmaf(rbf<BF>(outs[n * OST + o]), rbf<BF>(__ldg(Wh + o * H + j)),
                 d);
      const float hv = hb[n * HS + j];
      dz = d * (1.f - hv * hv);
    }
    p.sc.dzt[(q0 + n) * HK + j] = dz;
  }
}

// ---- C: the trunk's product back to conv 1's output -------------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) trunk_dgrad_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int HK = p.ld.HK, KT = p.ld.KT, P2C2 = p.ld.P2C2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const long q0 = (long)blockIdx.x * BM;
  const int i0 = blockIdx.y * BN;
  const int nvalid = p.bt.N - q0 < BM ? (int)(p.bt.N - q0) : BM;
  float acc[2][4][4];
  zero_frags(acc);
  gemm_64x128<BF>(acc, p.sc.dzt + q0 * HK, HK, nvalid,
                  p.sc.wtt + (long)i0 * HK, HK, HK, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = wm * 32 + 16 * mi + g + 8 * rh;
        const int col = i0 + wn * 32 + 8 * ni + 2 * t;
        if (row >= nvalid || col >= P2C2) continue;
        const float2 z =
            *reinterpret_cast<const float2*>(p.sc.a1 + (q0 + row) * KT + col);
        float2 v;
        v.x = z.x > 0.f ? acc[mi][ni][2 * rh] : 0.f;
        v.y = z.y > 0.f ? acc[mi][ni][2 * rh + 1] : 0.f;
        *reinterpret_cast<float2*>(p.sc.d1 + (q0 + row) * P2C2 + col) = v;
      }
}

// ---- D: the convolutions backward -------------------------------------------

template <bool BF>
__global__ void __launch_bounds__(DNT) conv_bwd_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  const Batch& bt = p.bt;
  const int S = net.S, P2 = net.P2, C0 = net.C0, R = p.ld.RD;
  float* w1t = smem;  // [9 C1][W1TS]: W1[k][oc][ic] at (k C1 + ic, oc)
  float* d1s = w1t + 9 * LC1 * W1TS;  // [R P2][D1S]
  float* a0s = d1s + R * P2 * D1S;    // [R P2][A1S]: a0, then d0
  float* xs = a0s + R * P2 * A1S;     // [R P2][XSD]
  float* zrow = xs + R * P2 * XSD;    // [16] zeros: a tap outside the grid
  long* rowoff = reinterpret_cast<long*>(zrow + 16);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 9 * LC2 * LC1; i += DNT) {
    const int k = i / (LC2 * LC1), oc = i / LC1 % LC2, ic = i % LC1;
    w1t[(k * LC1 + ic) * W1TS + oc] = rbf<BF>(p.params[net.w1 + i]);
  }
  for (int i = tid; i < 16; i += DNT) zrow[i] = 0.f;

  // The warp's tap and its valid output positions; the two warps of a
  // tap (part 0 and 1) take the first and the second half of its chunks.
  const int tap = warp % 9, part = warp / 9;
  const int kr = tap / 3 - 1, kc = tap % 3 - 1;
  const int ro_lo = kr < 0 ? -kr : 0, ro_hi = kr > 0 ? S - kr : S;
  const int co_lo = kc < 0 ? -kc : 0, co_hi = kc > 0 ? S - kc : S;
  const int nb = R / 8;  // runs of 8 samples a position
  const int nhalf = (ro_hi - ro_lo) * (co_hi - co_lo) * nb;
  const int nchunk = (nhalf + 1) / 2, split = (nchunk + 1) / 2;
  const int c_lo = part ? 2 * split : 0, c_hi = part ? nhalf : 2 * split;
  // The walk's start: half c_lo as (row, column, run).
  const int v_lo = c_lo / nb, vw = co_hi - co_lo;
  const int ro0 = ro_lo + v_lo / vw, co0 = co_lo + v_lo % vw, b0 = c_lo % nb;
  const int shift = kr * S + kc;
  const int rows = R * P2;
  // 48 biases (conv 1's, then conv 0's), each summed by 12 threads.
  const int bsel = tid / 12, bpart = tid % 12;
  float acc1[2][2][4], acc0[1][1][4], bacc = 0.f;
  zero_frags(acc1);
  zero_frags(acc0);

  for (long tile = blockIdx.x; tile < p.sc.tiles_d; tile += gridDim.x) {
    const long q0 = tile * R;
    const int nvalid = bt.N - q0 < R ? (int)(bt.N - q0) : R;
    __syncthreads();  // the previous tile's readers are done
    tile_rows(bt, q0, R, nvalid, rowoff);
    __syncthreads();
    // d1, a0 and the obs grid through cp.async (zeros past the last
    // sample and in the pad channels).
    const int c1 = p.ld.P2C2 / 4, c0 = p.ld.P2C1 / 4;
    for (int i = tid; i < R * c1; i += DNT) {
      const int n = i / c1, j = i % c1 * 4;
      const bool ok = n < nvalid;
      cp_async16(d1s + (n * P2 + j / LC2) * D1S + j % LC2,
                 ok ? p.sc.d1 + (q0 + n) * p.ld.P2C2 + j : p.sc.d1, ok);
    }
    for (int i = tid; i < R * c0; i += DNT) {
      const int n = i / c0, j = i % c0 * 4;
      const bool ok = n < nvalid;
      cp_async16(a0s + (n * P2 + j / LC1) * A1S + j % LC1,
                 ok ? p.sc.a0 + (q0 + n) * p.ld.P2C1 + j : p.sc.a0, ok);
    }
    for (int i = tid; i < R * P2 * XC; i += DNT) {
      const int n = i / (P2 * XC), pos = i / XC % P2, c = i % XC;
      const bool ok = n < nvalid && c < C0;
      cp_async4(xs + (n * P2 + pos) * XSD + c,
                ok ? bt.obs + rowoff[n] + pos * C0 + c : bt.obs, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (BF) {
      for (int i = tid; i < R * P2 * XC; i += DNT) {
        float* x = xs + i / XC * XSD + i % XC;
        *x = rbf<BF>(*x);
      }
      __syncthreads();
    }

    // d0 before masking: rows (sample, position pi), K = (tap, oc) with the
    // output position pi - shift(tap); the warp's m16 tiles (mt = warp +
    // 18 i) in one product, so that the B fragments load once a chunk;
    // kept in registers; a tap outside the grid or a row past the tile
    // reads the zero row.
    float accd[MDMAX][2][4];
    zero_frags(accd);
    {
      int rn[MDMAX][2], rri[MDMAX][2], rci[MDMAX][2];
#pragma unroll
      for (int mi = 0; mi < MDMAX; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = (warp + 18 * mi) * 16 + g + 8 * r;
          rn[mi][r] = m < rows ? m / P2 : -1;
          rri[mi][r] = m % P2 / S;
          rci[mi][r] = m % P2 % S;
        }
      for (int k = 0; k < 9; ++k) {
        const int dr = k / 3 - 1, dc = k % 3 - 1;
        RowsLoader<MDMAX> la, lb;
#pragma unroll
        for (int mi = 0; mi < MDMAX; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ro = rri[mi][r] - dr, co = rci[mi][r] - dc;
            const bool ok =
                rn[mi][r] >= 0 && ro >= 0 && ro < S && co >= 0 && co < S;
            la.p[mi][r] = ok ? d1s + (rn[mi][r] * P2 + ro * S + co) * D1S
                             : zrow;
            lb.p[mi][r] = ok ? la.p[mi][r] + 16 : zrow;  // channels 16-31
          }
        const float* w = w1t + (k * LC1 + g) * W1TS;
        mma_k16<BF>(accd, la, ColLoader<W1TS>{w});
        mma_k16<BF>(accd, lb, ColLoader<W1TS>{w + 16});
      }
    }

    // Conv 1's weight gradient for the warp's tap: K = (valid position,
    // sample), 8 samples a half.
#pragma unroll 2
    for (int c = c_lo, ro = ro0, co = co0, b = b0; c < c_hi; c += 2) {
      HalfRowLoader la;
      HalfColLoader lb;
      la.ks = P2 * D1S;
      lb.ks = P2 * A1S;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int po = ro * S + co;
        const bool ok = c + h < c_hi;
        la.base[h] = ok ? d1s + (b * 8 * P2 + po) * D1S + g : nullptr;
        lb.base[h] = ok ? a0s + (b * 8 * P2 + po + shift) * A1S + g : nullptr;
        next_half(ro, co, b, co_lo, co_hi, nb);
      }
      mma_k16<BF>(acc1, la, lb);
    }
    if (bsel < LC2)
      for (int m = bpart; m < rows; m += 12) bacc += d1s[m * D1S + bsel];
    __syncthreads();  // a0 read by every warp's product above

    // d0 masked by a0 > 0, over a0.
#pragma unroll
    for (int mi = 0; mi < MDMAX; ++mi)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int m = (warp + 18 * mi) * 16 + g + 8 * rh;
        if (m >= rows) continue;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          float* a = a0s + m * A1S + 8 * ni + 2 * t;
          a[0] = a[0] > 0.f ? accd[mi][ni][2 * rh] : 0.f;
          a[1] = a[1] > 0.f ? accd[mi][ni][2 * rh + 1] : 0.f;
        }
      }
    __syncthreads();

    // Conv 0's weight gradient for the warp's tap, from d0 and the grid.
#pragma unroll 2
    for (int c = c_lo, ro = ro0, co = co0, b = b0; c < c_hi; c += 2) {
      HalfRowLoader la;
      HalfColLoader lb;
      la.ks = P2 * A1S;
      lb.ks = P2 * XSD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int po = ro * S + co;
        const bool ok = c + h < c_hi;
        la.base[h] = ok ? a0s + (b * 8 * P2 + po) * A1S + g : nullptr;
        lb.base[h] = ok ? xs + (b * 8 * P2 + po + shift) * XSD + g : nullptr;
        next_half(ro, co, b, co_lo, co_hi, nb);
      }
      mma_k16<BF>(acc0, la, lb);
    }
    if (bsel >= LC2)
      for (int m = bpart; m < rows; m += 12)
        bacc += a0s[m * A1S + bsel - LC2];
  }

  // The CTA's conv partial, in the packed layout: each tap's two parts
  // summed in part order.
  __syncthreads();
  float* spill = d1s + (tap * 32 + lane) * 20;  // part 1's fragments
  if (part) {
#pragma unroll
    for (int i = 0; i < 16; ++i) spill[i] = (&acc1[0][0][0])[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) spill[16 + i] = acc0[0][0][i];
  }
  __syncthreads();
  float* out = p.sc.cpart + (long)blockIdx.x * net.n_conv;
  if (!part) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int oc = 16 * mi + g + 8 * (r >> 1);
          const int ic = 8 * ni + 2 * t + (r & 1);
          out[net.w1 + ((long)tap * LC2 + oc) * LC1 + ic] =
              acc1[mi][ni][r] + spill[(mi * 2 + ni) * 4 + r];
        }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c1 = g + 8 * (r >> 1), c0 = 2 * t + (r & 1);
      if (c0 < C0)  // conv 0's pad channels have no parameter
        out[net.w0 + ((long)tap * LC1 + c1) * C0 + c0] =
            acc0[0][0][r] + spill[16 + r];
    }
  }
  __syncthreads();
  d1s[tid] = bacc;
  __syncthreads();
  if (tid < LC2 + LC1) {
    float s = 0.f;
    for (int j = 0; j < 12; ++j) s += d1s[tid * 12 + j];
    out[tid < LC2 ? net.b1 + tid : net.b0 + tid - LC2] = s;
  }
}

// ---- E: the trunk's and the head's weight gradients -------------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) trunk_wgrad_kernel(CnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  const int H = net.H, HK = p.ld.HK, KT = p.ld.KT, TIN = net.trunk_in;
  const long q0 = (long)blockIdx.y * p.sc.chunk;
  const long q1 = q0 + p.sc.chunk < p.bt.N ? q0 + p.sc.chunk : p.bt.N;
  float* out = p.sc.part + (long)blockIdx.y * (net.n_params - net.n_conv);
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= p.ld.HP / EJ * p.ld.TK) {  // the head, on CUDA cores
    for (int i = tid; i < NHEAD * H + NHEAD; i += GNT) {
      float s = 0.f;
      if (i < NHEAD * H) {
        const int o = i / H, j = i % H;
        for (long q = q0; q < q1; ++q)
          s = fmaf(rbf<BF>(p.sc.dout[q * OST + o]),
                   rbf<BF>(p.sc.h[q * H + j]), s);
        out[net.head_w - net.n_conv + i] = s;
      } else {
        const int o = i - NHEAD * H;
        for (long q = q0; q < q1; ++q) s += p.sc.dout[q * OST + o];
        out[net.head_b - net.n_conv + o] = s;
      }
    }
    return;
  }
  const int j0 = blockIdx.x / p.ld.TK * EJ, k0 = blockIdx.x % p.ld.TK * EK;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wj = warp >> 2, wk = warp & 3;  // 2 x 4 warps, 64 x 32 each
  float acc[4][4][4], bsum = 0.f;
  zero_frags(acc);
  gemm_tn_128x128<BF>(acc, k0 == 0 ? &bsum : nullptr, p.sc.dzt + j0, HK,
                      HK - j0, p.sc.a1 + k0, KT, KT - k0, q0, q1, smem);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + wj * 64 + 16 * mi + g + 8 * (r >> 1);
        const int k = k0 + wk * 32 + 8 * ni + 2 * t + (r & 1);
        if (j < H && k < TIN)
          out[net.wt - net.n_conv + (long)j * TIN + k] = acc[mi][ni][r];
      }
  if (k0 == 0 && tid < EJ && j0 + tid < H)
    out[net.bt - net.n_conv + j0 + tid] = bsum;
}

// ---- host side --------------------------------------------------------------

bool make_cnn(int S, int C0, int C1, int C2, int H, int T, long B, int A,
              int M, int mb, const float* obs, CnnArgs* ca) {
  return make_cnn_net(S, C0, C1, C2, H, &ca->net) &&
         make_learn(ca->net, &ca->ld) &&
         batch_rows(T, B, A, M, mb, ca->net.D, obs, &ca->bt);
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

enum Stage { PREP, CONV_FWD, TRUNK_FWD, TRUNK_DGRAD, CONV_BWD, TRUNK_WGRAD };

// One stage's kernel; CONV_BWD's grid size into *grid.
template <bool BF>
cudaError_t launch_stage(const CnnArgs& ca, Stage st, long* grid,
                         cudaStream_t stream) {
  const CnnNet& net = ca.net;
  const LDims& ld = ca.ld;
  const CnnScratch& sc = ca.sc;
  cudaError_t e = cudaSuccess;
  switch (st) {
    case PREP:
      trunk_prep_kernel<BF><<<128, 256, 0, stream>>>(ca);
      break;
    case CONV_FWD: {
      const size_t smem = smem_a(net, ld.RA);
      long g = 0;
      e = persistent_grid(conv_fwd_kernel<BF>, smem, sc.tiles_a, &g, ANT);
      if (e != cudaSuccess) return e;
      conv_fwd_kernel<BF><<<(unsigned)g, ANT, smem, stream>>>(ca);
      break;
    }
    case TRUNK_FWD: {
      const size_t smem = smem_b(ld, BF);
      if ((e = opt_in(trunk_fwd_kernel<BF>, smem)) != cudaSuccess) return e;
      trunk_fwd_kernel<BF><<<(unsigned)sc.tiles_b, GNT, smem, stream>>>(ca);
      break;
    }
    case TRUNK_DGRAD: {
      const size_t smem = smem_c(BF);
      if ((e = opt_in(trunk_dgrad_kernel<BF>, smem)) != cudaSuccess) return e;
      trunk_dgrad_kernel<BF>
          <<<dim3((unsigned)sc.tiles_b, ld.NC1 / BN), GNT, smem, stream>>>(ca);
      break;
    }
    case CONV_BWD: {
      const size_t smem = smem_d(net, ld.RD);
      e = persistent_grid(conv_bwd_kernel<BF>, smem,
                          sc.tiles_d < MAXG ? sc.tiles_d : MAXG, grid, DNT);
      if (e != cudaSuccess) return e;
      conv_bwd_kernel<BF><<<(unsigned)*grid, DNT, smem, stream>>>(ca);
      break;
    }
    case TRUNK_WGRAD: {
      const size_t smem = smem_e(BF);
      if ((e = opt_in(trunk_wgrad_kernel<BF>, smem)) != cudaSuccess) return e;
      trunk_wgrad_kernel<BF>
          <<<dim3(ld.HP / EJ * ld.TK + 1, sc.SE), GNT, smem, stream>>>(ca);
      break;
    }
  }
  return cudaGetLastError();
}

cudaError_t run_stage(const CnnArgs& ca, Stage st, long* grid, bool bf16,
                      cudaStream_t stream) {
  return bf16 ? launch_stage<true>(ca, st, grid, stream)
              : launch_stage<false>(ca, st, grid, stream);
}

// The conv partials of stage D's `grid` CTAs summed in CTA order into
// grads[0, n_conv), their sums of squares into sc.sq.
cudaError_t reduce_conv(const CnnArgs& ca, long grid, float* grads,
                        cudaStream_t stream) {
  reduce_kernel<<<(unsigned)ca.sc.n_sq_conv, RED, 0, stream>>>(
      ca.sc.cpart, (int)grid, ca.net.n_conv, grads, ca.sc.sq);
  return cudaGetLastError();
}

// Stage E's partials summed in split order into grads[n_conv, n_params).
cudaError_t reduce_dense(const CnnArgs& ca, float* grads,
                         cudaStream_t stream) {
  const CnnScratch& sc = ca.sc;
  reduce_kernel<<<(unsigned)(sc.n_sq - sc.n_sq_conv), RED, 0, stream>>>(
      sc.part, sc.SE, ca.net.n_params - ca.net.n_conv, grads + ca.net.n_conv,
      sc.sq + sc.n_sq_conv);
  return cudaGetLastError();
}

cudaError_t metrics(const CnnArgs& ca, float* sums, cudaStream_t stream) {
  metrics_kernel<<<1, 128, 0, stream>>>(ca.sc.met, ca.sc.tiles_b, sums);
  return cudaGetLastError();
}

// The arguments of wh_cnn_sgd_grads and wh_cnn_sgd_stage as CnnArgs.
int make_grads_args(int S, int C0, int C1, int C2, int H, int T, long B,
                    int A, int M, int mb, const float* obs, const int* action,
                    const float* old_lp, const float* old_v, const float* adv,
                    const float* target, const unsigned char* mask,
                    const float* params, const float* scal, float clip_eps,
                    float clip_lo, float clip_hi, float value_coef,
                    float inv_n, float* work, CnnArgs* ca) {
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, mb, obs, ca))
    return (int)cudaErrorInvalidValue;
  ca->bt.action = action;
  ca->bt.old_lp = old_lp;
  ca->bt.old_v = old_v;
  ca->bt.adv = adv;
  ca->bt.target = target;
  ca->bt.mask = mask;
  if (carve_cnn(ca->net, ca->ld, ca->bt.N, work, &ca->sc) == 0)
    return (int)cudaErrorInvalidValue;  // a conv tile does not fit
  ca->c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  ca->params = params;
  ca->scal = scal;
  return 0;
}

}  // namespace

// Shared memory of the largest stage's CTA in bytes, or 0 for unsupported
// widths.
extern "C" long wh_cnn_sgd_smem_bytes(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  LDims ld;
  return make_cnn_net(S, C0, C1, C2, H, &net) && make_learn(net, &ld)
             ? (long)learn_smem(net, ld)
             : 0;
}

// Whether a conv stage's tile holds fewer samples than on the 5 x 5 ego
// window (1: a grid larger than the ego window, as the global view's whole
// map; 0: full tiles); -1 for unsupported widths.
extern "C" int wh_cnn_sgd_small_tile(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  LDims ld;
  if (!make_cnn_net(S, C0, C1, C2, H, &net) || !make_learn(net, &ld))
    return -1;
  return ld.RA < RA_MAX || ld.RD < RD_MAX;
}

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape.
extern "C" long wh_cnn_sgd_workspace_floats(int S, int C0, int C1, int C2,
                                            int H, int T, long B, int A,
                                            int M) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca)) return 0;
  return carve_cnn(ca.net, ca.ld, ca.bt.N, nullptr, &ca.sc);
}

// Where the stages' rows lie in the workspace: out = float offsets of a0,
// a1, h, dzt, dout, d1, then the row strides KT (a1) and HK (dzt).
extern "C" int wh_cnn_sgd_layout(int S, int C0, int C1, int C2, int H, int T,
                                 long B, int A, int M, long* out) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca))
    return (int)cudaErrorInvalidValue;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (carve_cnn(ca.net, ca.ld, ca.bt.N, base, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;
  const float* ptrs[6] = {ca.sc.a0, ca.sc.a1, ca.sc.h, ca.sc.dzt, ca.sc.dout,
                          ca.sc.d1};
  for (int i = 0; i < 6; ++i) out[i] = (long)(ptrs[i] - base);
  out[6] = ca.ld.KT;
  out[7] = ca.ld.HK;
  return 0;
}

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
  int err = make_grads_args(S, C0, C1, C2, H, T, B, A, M, mb, obs, action,
                            old_lp, old_v, adv, target, mask, params, scal,
                            clip_eps, clip_lo, clip_hi, value_coef, inv_n,
                            work, &ca);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  long grid = 0;
  const Stage order[] = {PREP,        CONV_FWD, TRUNK_FWD,
                         TRUNK_DGRAD, CONV_BWD, TRUNK_WGRAD};
  for (Stage st : order) {
    cudaError_t e = run_stage(ca, st, &grid, bf16 != 0, stream);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = reduce_conv(ca, grid, grads, stream);
  if (e == cudaSuccess) e = reduce_dense(ca, grads, stream);
  if (e == cudaSuccess) e = metrics(ca, sums, stream);
  return (int)e;
}

// One stage of wh_cnn_sgd_grads on the rows the workspace holds (the
// stages' checks and times): 0 conv forward (writes a0, a1); 1 the trunk
// forward and loss (prep, then h, dout, dzt and sums[0..3]); 2 the trunk's
// dgrad (prep, then d1); 3 the convolutions backward (grads[0, n_conv)); 4
// the trunk's and head's weight gradients (grads[n_conv, n_params)).
extern "C" int wh_cnn_sgd_stage(
    int stage, int S, int C0, int C1, int C2, int H, int T, long B, int A,
    int M, int mb, const float* obs, const int* action, const float* old_lp,
    const float* old_v, const float* adv, const float* target,
    const unsigned char* mask, const float* params, const float* scal,
    float clip_eps, float clip_lo, float clip_hi, float value_coef,
    float inv_n, float* work, float* grads, float* sums, int bf16,
    void* stream_) {
  CnnArgs ca;
  int err = make_grads_args(S, C0, C1, C2, H, T, B, A, M, mb, obs, action,
                            old_lp, old_v, adv, target, mask, params, scal,
                            clip_eps, clip_lo, clip_hi, value_coef, inv_n,
                            work, &ca);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  const bool bf = bf16 != 0;
  long grid = 0;
  cudaError_t e = cudaSuccess;
  switch (stage) {
    case 0:
      e = run_stage(ca, CONV_FWD, &grid, bf, stream);
      break;
    case 1:
      e = run_stage(ca, PREP, &grid, bf, stream);
      if (e == cudaSuccess) e = run_stage(ca, TRUNK_FWD, &grid, bf, stream);
      if (e == cudaSuccess) e = metrics(ca, sums, stream);
      break;
    case 2:
      e = run_stage(ca, PREP, &grid, bf, stream);
      if (e == cudaSuccess) e = run_stage(ca, TRUNK_DGRAD, &grid, bf, stream);
      break;
    case 3:
      e = run_stage(ca, CONV_BWD, &grid, bf, stream);
      if (e == cudaSuccess) e = reduce_conv(ca, grid, grads, stream);
      break;
    case 4:
      e = run_stage(ca, TRUNK_WGRAD, &grid, bf, stream);
      if (e == cudaSuccess) e = reduce_dense(ca, grads, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
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
  if (carve_cnn(ca.net, ca.ld, ca.bt.N, work, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {ca.net.n_params, ca.sc.n_sq, grads, ca.sc.sq, params, m,
                      v, lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}

// The sums of squares of `grads` (wh_cnn_sgd_grads' layout) as the two
// reduce_kernel launches take them (launch_sumsq): the conv gradient's
// blocks, then the dense layers'; into `sq` where it is not null, else into
// the workspace, where wh_cnn_sgd_clip_adam reads them. The meshed route
// launches it on the gradient averaged over the ranks.
extern "C" int wh_cnn_sgd_sumsq(int S, int C0, int C1, int C2, int H, int T,
                                long B, int A, int M, const float* grads,
                                float* sq, float* work, void* stream_) {
  CnnArgs ca;
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca) ||
      carve_cnn(ca.net, ca.ld, ca.bt.N, work, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;
  float* out = sq ? sq : ca.sc.sq;
  const long n_conv = ca.net.n_conv;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = launch_sumsq(grads, n_conv, 1, out, stream);
  if (e == cudaSuccess)
    e = launch_sumsq(grads + n_conv, ca.net.n_params - n_conv, 1,
                     out + ca.sc.n_sq_conv, stream);
  return (int)e;
}

// Where the gradient's sums of squares lie in the workspace: out[0] their
// float offset, out[1] their count (the conv blocks', then the dense
// blocks'), out[2] the conv blocks' count.
extern "C" int wh_cnn_sgd_sq_layout(int S, int C0, int C1, int C2, int H,
                                    int T, long B, int A, int M, long* out) {
  CnnArgs ca;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_cnn(S, C0, C1, C2, H, T, B, A, M, 0, nullptr, &ca) ||
      carve_cnn(ca.net, ca.ld, ca.bt.N, base, &ca.sc) == 0)
    return (int)cudaErrorInvalidValue;
  out[0] = ca.sc.sq - base;
  out[1] = ca.sc.n_sq;
  out[2] = ca.sc.n_sq_conv;
  return 0;
}
