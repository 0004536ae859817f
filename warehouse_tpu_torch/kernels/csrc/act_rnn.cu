// K7: the acting phase of the recurrent (GRU / LSTM) policy, T steps a call.
//
// Replaces warehouse_tpu/pallas/act.py ppo_rnn_rollout_pallas (:747; body
// _act_rnn_kernel :516 with _obs_rows :138, _sample_logprob :491 and the env
// tick of rollout.py:57), with its action-masking option. The carry is
// threaded over the T steps and written out unreset: the caller zeroes it
// where the chunk truncated.
//
// Each step is stage kernels on the caller's stream over all of the step's
// N = B A rows (env, agent; row b A + a), with no host synchronisation; the
// env states live in device memory (envst) from one step to the next, as
// K2's (act.cu):
//
//   encoder: hidden_kernel (act_stages.cuh), a launch per encoder layer,
//      y = tanh(x W^T + b) as 64 x 128 tiles. The first layer reads `xs`,
//      the observation rows zero-padded to D rounded up to 32; the last
//      writes e into the first part of a row buffer [N, Ep + Hp] whose
//      second part holds h (Ep, Hp: E, H rounded up to 32, zeros past
//      them). Two such buffers ping-pong: step t reads [e_t | h_t] from
//      one and writes h_{t+1} into the other.
//   cell: cell_kernel, C = [e | h] Bt^T as 64 x 128 tiles with the cell's
//      math in the epilogue: the GRU's h_{t+1} from h_t of the read
//      buffer, the LSTM's c in place (one thread owns (n, j)). The prep
//      lays the gate kernels out as one Bt over K = Ep + Hp, the input-side
//      rows then the recurrent ones, with the gate columns interleaved: a
//      128-column tile holds every gate of 32 hidden units, so that one
//      thread's epilogue sees all of a unit's gates. The GRU's r and z are
//      one sum over [e | h]; its n needs W_in e + b_in apart from
//      q = W_hn h + b_hn, so the tile keeps n_in (nonzero on the e part
//      only) and q (on the h part only) as sets of their own and skips
//      each one's zero half: 3 H (E + H) multiply-adds a row, not 4.
//   head: rnn_head_kernel, head [N, 8] = h_{t+1} W_head^T + b: 64 rows a
//      CTA staged in shared memory, two threads a row, each three sums as
//      independent chains; bound by the bytes of h (8 MB a step at
//      config 4).
//   env: env_kernel then obs_kernel (act_stages.cuh, K2's): mask, sample,
//      log-softmax, tick, rewards, then the next observation rows into
//      obs[t + 1] and into xs. A prologue pair writes obs[0]; the last step
//      stores the final state and observes nothing.
//   prep (once a call): the encoder layers' Bt (pad_jobs.cuh: one launch
//      up to 8 layers, one more for each 8 past them), the cell's Bt split
//      into its TF32 high parts and remainders, the head as [6, H4] (H4: H
//      rounded up to 4, zeros past H, so that the head stage's float4 rows
//      hold any width), and the initial carry into the row buffers (c into
//      its own buffer [N, H]); the last step's cell epilogue writes the
//      final carry to o_h / o_c.
//
// Any hidden and encoder width: the tiles pad each to 32 or 128, the head
// stage reads h's row buffer to H4 (its columns past H are zeros: the prep
// zeroes them, no cell tile writes them); the carry, the params and the
// outputs keep their own widths. Any number of encoder layers: the
// per-layer tables live in the caller's RnnTables on the host.
//
// So T steps are (n_enc + 4) T + 2 launches. The cell's products are 87%
// of the step's operations at config 4 (GRU: 3.22 of 3.69 GFLOP a step),
// and the cell's tiles run them on the tensor cores as 3xTF32
// (mma_tiles.cuh mma_tf32: each float32 operand a TF32 high part and a
// TF32 remainder, three m16n8k8 products, float32 sums, a slice's sum
// joined by a rounded add; the weights split once by the prep: split in
// the tile's loop beside the rounded adds, they took the LSTM's cell stage
// 1.4x the time). On one H100 that route took the cell stage 1.3x (GRU) to
// 1.9x (LSTM) less time than FFMA register blocks on gemm_64x128_f32's
// tiles, and it holds every K7 bound (PERF.md §6).
// Single-pass TF32 is not used. The cell stage is bound by its products:
// at the tensor cores' TF32 rate, three products a k, 0.020 ms a step for
// the GRU at config 4. It takes about five times that, whatever its L2
// bytes or its split's ALU work (PERF.md §6); the rate of mma.sync, not
// wgmma's, is the likely limit. The encoder (FFMA) and the env stage take
// most of the rest.
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine (act_common.cuh, env_tick.cuh, shared with K2);
// the policy outputs and the carry are held to a float32 tolerance. Every
// sum is taken in a fixed order whatever the grid, with no atomics, so a
// rerun gives the same bits.

#include <cuda_runtime.h>

#include "act_stages.cuh"
#include "rnn_cell.cuh"

namespace {

constexpr int CU = 32;    // hidden units of a cell tile: BN / 4 gate sets

// K7's padded widths and its workspace, offsets in floats, each a multiple
// of 32: bt[l] [hp[l]][ld[l]] each encoder layer's kernel, bc [tiles BN][K]
// twice, the cell's TF32 high parts, then their remainders, hw [6][H4] the
// head's, xs [N][ld[0]], enc two buffers of
// [N][EL] for the encoder layers but the last, rb two row buffers
// [N][K], cs [N][H] the LSTM's c, head [N][HSTRIDE], envst [B][4 A + 6 R]
// ints.
struct RnnLayout {
  HostPtr<const int> ld;  // each encoder layer's input width rounded to BK
  HostPtr<const int> hp;  // its output width rounded up to BN: its Bt's rows
  HostPtr<const long> bt;  // its Bt's offset
  int EL;         // the widest intermediate encoder row
  int Ep, Hp, K;  // E and H rounded up to 32; K = Ep + Hp
  int H4;         // H rounded up to 4: the head stage's row
  int tiles;      // the cell's column tiles: Hp / CU
  long bc, hw, xs, enc[2], rb[2], cs, head, envst, total;
};

RnnLayout rnn_layout(const RnnNet& net, int A, int R, long B,
                     RnnTables* tb) {
  RnnLayout w = {};
  long off = 0;
  auto take = [&](long n) {
    const long o = off;
    off += (n + 31) / 32 * 32;
    return o;
  };
  const long N = B * A;
  tb->ld.assign(net.n_enc, 0);
  tb->hp.assign(net.n_enc, 0);
  tb->bt.assign(net.n_enc, 0);
  for (int l = 0; l < net.n_enc; ++l) {
    tb->ld[l] = round_up(net.enc_in[l], BK);
    tb->hp[l] = round_up(net.enc_out[l], BN);
    if (l > 0) w.EL = w.EL > tb->ld[l] ? w.EL : tb->ld[l];
  }
  w.ld = tb->ld.data();
  w.hp = tb->hp.data();
  w.bt = tb->bt.data();
  w.Ep = round_up(net.E, BK);
  w.Hp = round_up(net.H, CU);
  w.K = w.Ep + w.Hp;
  w.H4 = round_up(net.H, 4);
  w.tiles = w.Hp / CU;
  for (int l = 0; l < net.n_enc; ++l)
    tb->bt[l] = take((long)w.hp[l] * w.ld[l]);
  w.bc = take(2L * w.tiles * BN * w.K);
  w.hw = take((long)RHEAD * w.H4);
  w.xs = take(N * w.ld[0]);
  w.enc[0] = take(net.n_enc > 1 ? N * w.EL : 0);
  w.enc[1] = take(net.n_enc > 2 ? N * w.EL : 0);
  w.rb[0] = take(N * w.K);
  w.rb[1] = take(N * w.K);
  w.cs = take(net.lstm ? N * net.H : 0);
  w.head = take(N * HSTRIDE);
  w.envst = take(B * (4L * A + 6L * R));
  w.total = off;
  return w;
}

// K7's arguments: the env stage's, then the net, its workspace and carry.
struct ActRnnArgs : ActEnvArgs {
  RnnNet net;
  RnnLayout w;
  const float* params;   // the packed vector (rnn_cell.cuh)
  const float *h0, *c0;  // [N, H] the initial carry; c0 null for the GRU
  float *o_h, *o_c;      // [N, H] the final carry
  float* work;
};

// The gate set and the unit (of the tile's CU) of a cell tile's column cc:
// a warp's 32 columns hold 8 units' 4 sets, set-major, so that each n8 tile
// of its mma fragments is one set and a lane's accumulators hold every set
// of its units. Sets: GRU r, z, n_in, q; LSTM i, f, g, o.
__host__ __device__ inline void cell_col(int cc, int* unit, int* set) {
  *unit = 8 * (cc / 32) + cc % 8;
  *set = cc / 8 % 4;
}

// ---- prep: the kernels as the tile GEMMs read them, the initial carry -------

// Each encoder layer's Bt [hp[l]][ld[l]], zeros past its widths.
PadPlan enc_plan(const ActRnnArgs& p) {
  const RnnNet& net = p.net;
  const RnnLayout& w = p.w;
  PadPlan plan;
  for (int l = 0; l < net.n_enc; ++l)
    plan.add(p.work + w.bt[l], 0, p.params + net.enc_w[l], 0, w.hp[l],
             w.ld[l], net.enc_out[l], net.enc_in[l], false);
  return plan;
}

// The first MAXJ encoder copies (enc_plan), the cell's and the head's
// kernels, the carry.
__global__ void rnn_prep_kernel(ActRnnArgs p, PadJobs pj) {
  const RnnNet& net = p.net;
  const RnnLayout& w = p.w;
  const float* pr = p.params;
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  const int H = net.H, E = net.E;
  run_pad_jobs(pj, i0, stride);
  // The cell: Bt row (tile, cc) holds unit tile CU + cc's weights of its
  // set over [e | h], zeros past E, past H and on a GRU set's zero half.
  float* bc = p.work + w.bc;
  for (long i = i0; i < (long)w.tiles * BN * w.K; i += stride) {
    const long r = i / w.K;
    const int k = (int)(i % w.K);
    int ul, set;
    cell_col((int)(r % BN), &ul, &set);
    const int u = (int)(r / BN) * CU + ul;
    float v = 0.f;
    if (u < H && k < E) {  // input side: GRU r, z, n_in; LSTM every gate
      if (net.lstm || set < 3)
        v = pr[net.wi + ((long)set * H + u) * E + k];
    } else if (u < H && k >= w.Ep && k - w.Ep < H) {  // recurrent side
      const int gate = net.lstm ? set : set == 3 ? 2 : set == 2 ? -1 : set;
      if (gate >= 0) v = pr[net.wh + ((long)gate * H + u) * H + k - w.Ep];
    }
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    bc[i] = __uint_as_float(hi);
    bc[(long)w.tiles * BN * w.K + i] = __uint_as_float(lo);
  }
  for (long i = i0; i < (long)RHEAD * w.H4; i += stride) {
    const int o = (int)(i / w.H4), k = (int)(i % w.H4);
    p.work[w.hw + i] = k < H ? pr[net.head_w + (long)o * H + k] : 0.f;
  }
  // The carry: h0 into the first row buffer's h part, zeros past H; the
  // second's h part zero (its pad columns stay so); c0 into cs.
  const long N = p.B * p.A;
  float* rb0 = p.work + w.rb[0];
  float* rb1 = p.work + w.rb[1];
  for (long i = i0; i < N * w.Hp; i += stride) {
    const long n = i / w.Hp;
    const int j = (int)(i % w.Hp);
    rb0[n * w.K + w.Ep + j] = j < H ? p.h0[n * H + j] : 0.f;
    rb1[n * w.K + w.Ep + j] = 0.f;
  }
  if (net.lstm)
    for (long i = i0; i < N * H; i += stride) p.work[w.cs + i] = p.c0[i];
}

// ---- the cell ---------------------------------------------------------------

struct CellStage {
  const float* x;  // [N][K] the read buffer: [e_t | h_t]
  float* y;        // [N][K] the write buffer: h_{t+1} at Ep + u
  const float* bt; // [tiles BN][K] the high parts, then the remainders
  int K, Ep, H, tiles;
  long N;
  const float* bias;  // GRU: bi [3 H] (r, z, n); LSTM: bh [4 H]
  const float* bhn;   // GRU: bhn [H]
  float* c;           // LSTM: [N][H], in place
  float *o_h, *o_c;   // [N][H] the final carry on the chunk's last step
};

// One (row n, unit u)'s epilogue on its four sets' sums a[0..3].
template <bool LSTM>
__device__ __forceinline__ void cell_unit(const CellStage& s, long n, int u,
                                          float a0, float a1, float a2,
                                          float a3) {
  const float a[4] = {a0, a1, a2, a3};
  const int H = s.H;
  const float* b = s.bias;
  float h;
  if (LSTM) {
    const float ig = sigmoidf(a[0] + __ldg(b + u));
    const float fg = sigmoidf(a[1] + __ldg(b + H + u));
    const float gg = tanhf(a[2] + __ldg(b + 2 * H + u));
    const float og = sigmoidf(a[3] + __ldg(b + 3 * H + u));
    const float c = fg * s.c[n * H + u] + ig * gg;
    h = og * tanhf(c);
    s.c[n * H + u] = c;
    if (s.o_c) s.o_c[n * H + u] = c;
  } else {
    const float r = sigmoidf(a[0] + __ldg(b + u));
    const float z = sigmoidf(a[1] + __ldg(b + H + u));
    const float q = a[3] + __ldg(s.bhn + u);
    const float nn = tanhf(a[2] + __ldg(b + 2 * H + u) + r * q);
    h = (1.f - z) * nn + z * s.x[n * s.K + s.Ep + u];
  }
  s.y[n * s.K + s.Ep + u] = h;
  if (s.o_h) s.o_h[n * H + u] = h;
}

// The sets a slice of k's multiplies: all four for the LSTM; for the GRU r,
// z and n_in on the e part, r, z and q on the h part.
template <bool LSTM>
__host__ __device__ constexpr unsigned sets_lo() { return LSTM ? 0xF : 0x7; }
template <bool LSTM>
__host__ __device__ constexpr unsigned sets_hi() { return LSTM ? 0xF : 0xB; }

// ---- the cell's tiles: 3xTF32 on the tensor cores ---------------------------

// One k-slice of a warp's 32 x 32 (2 m16 by 4 n8 tiles, n8 tile ni = set
// ni) on the sets in S: per chunk of 8 k's, A split into its TF32 high part
// and remainder, B's parts from the prep, three products (the small ones
// first) into a zeroed fragment; the slice's sum is then added to acc with
// a rounded add, as the tensor cores truncate a sum to its largest term
// (summed in one accumulator over the 96 products of K = 256, the cell's
// rows drifted 1.8x past STAGE_TOL). as: the lane's row g at k t; bh /
// bl: its column g at k t.
template <unsigned S>
__device__ __forceinline__ void tf32_slice(float (&acc)[2][4][4],
                                           const float* as, const float* bh,
                                           const float* bl) {
  constexpr int LD = ldt<false>();
  float part[2][4][4] = {};
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(as[(16 * mi + 8 * (q & 1)) * LD + kk + 4 * (q >> 1)],
                   ah[mi][q], al[mi][q]);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (!(S >> ni & 1)) continue;
      const uint32_t bhi[2] = {__float_as_uint(bh[8 * ni * LD + kk]),
                               __float_as_uint(bh[8 * ni * LD + kk + 4])};
      const uint32_t blo[2] = {__float_as_uint(bl[8 * ni * LD + kk]),
                               __float_as_uint(bl[8 * ni * LD + kk + 4])};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_tf32(part[mi][ni], al[mi], bhi);
        mma_tf32(part[mi][ni], ah[mi], blo);
        mma_tf32(part[mi][ni], ah[mi], bhi);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      if (S >> ni & 1)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], part[mi][ni][r]);
}

// gemm_64x128's tile with a ring of its own: per stage A [BM][LD] and B's
// two parts [BN][LD] (mma_tiles.cuh load_slice, then the remainders); on
// the sets of each slice, then the cell's epilogue: 8 warps as 2 x 4, each
// 32 rows by 8 units x 4 sets.
template <bool LSTM>
__device__ void cell_tile(const CellStage& s, long q0, int nvalid, int tile,
                          float* ring) {
  constexpr int LD = ldt<false>(), ST = (BM + 2 * BN) * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const float* A = s.x + q0 * s.K;
  const long part = (long)s.tiles * BN * s.K;
  const float* Bt = s.bt + (long)tile * BN * s.K;
  const int nk = s.K / BK;
  auto load = [&](int st, int k0) {
    float* as = ring + st * ST;
    load_slice<false>(as, as + BM * LD, A, s.K, nvalid, Bt, s.K, k0);
    for (int i = threadIdx.x; i < BN * BK / 4; i += GNT) {
      const int r = i / (BK / 4), c4 = i % (BK / 4) * 4;
      cp_async16(as + (BM + BN + r) * LD + c4, Bt + part + r * s.K + k0 + c4,
                 true);
    }
  };
  float acc[2][4][4] = {};
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = ring + (kt & 1) * ST;
    const float* as = st + (wm * 32 + g) * LD + t;
    const float* bh = st + (BM + wn * 32 + g) * LD + t;
    const float* bl = bh + BN * LD;
    if (kt * BK < s.Ep)
      tf32_slice<sets_lo<LSTM>()>(acc, as, bh, bl);
    else
      tf32_slice<sets_hi<LSTM>()>(acc, as, bh, bl);
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = wm * 32 + 16 * mi + 8 * r + g;
        const int u = tile * CU + 8 * wn + 2 * t + c;
        if (row >= nvalid || u >= s.H) continue;
        cell_unit<LSTM>(s, q0 + row, u, acc[mi][0][2 * r + c],
                        acc[mi][1][2 * r + c], acc[mi][2][2 * r + c],
                        acc[mi][3][2 * r + c]);
      }
}

// One BM-row tile (blockIdx.x) by one tile of CU units (blockIdx.y).
template <bool LSTM>
__global__ void __launch_bounds__(GNT) cell_kernel(CellStage s) {
  extern __shared__ __align__(16) float smem[];
  const long q0 = (long)blockIdx.x * BM;
  const int nvalid = (int)(s.N - q0 < BM ? s.N - q0 : BM);
  cell_tile<LSTM>(s, q0, nvalid, blockIdx.y, smem);
}

size_t smem_cell() {
  return sizeof(float) * 2 * (BM + 2 * BN) * ldt<false>();
}

// ---- the head -----------------------------------------------------------------

constexpr int HROWS = 64;  // rows of a head-stage CTA, two threads a row

struct RnnHeadStage {
  const float* h;  // the rows' h, ld floats apart (16-byte aligned)
  int ld, H;
  const float* w;  // [6][H]
  const float* b;  // [6]
  float* head;     // [N][HSTRIDE]
  long N;
};

// Row and head strides in shared memory: a row's float4 reads by 8 threads
// (4 rows) and the two threads' head rows fall on distinct banks.
__host__ __device__ inline int head_hs(int H) { return (H / 4 | 1) * 4; }

size_t smem_rnn_head(int H) {
  return sizeof(float) * (HROWS * head_hs(H) + RHEAD * (H + 4));
}

// HROWS rows a CTA, staged in shared memory by 16-byte copies beside the
// head's kernel; then two threads a row, each three of its six sums as
// independent FMA chains in k order from 0, then + b.
__global__ void __launch_bounds__(2 * HROWS) rnn_head_kernel(RnnHeadStage s) {
  extern __shared__ __align__(16) float smem[];
  const int H = s.H, hs = head_hs(H), ws = H + 4;
  float* hr = smem;              // [HROWS][hs]
  float* wr = smem + HROWS * hs; // [6][ws]
  const long n0 = (long)blockIdx.x * HROWS;
  const int rows = (int)(s.N - n0 < HROWS ? s.N - n0 : HROWS);
  for (int i = threadIdx.x; i < rows * (H / 4); i += 2 * HROWS) {
    const int r = i / (H / 4), k4 = i % (H / 4) * 4;
    cp_async16(hr + r * hs + k4, s.h + (n0 + r) * s.ld + k4, true);
  }
  for (int i = threadIdx.x; i < RHEAD * (H / 4); i += 2 * HROWS) {
    const int o = i / (H / 4), k4 = i % (H / 4) * 4;
    cp_async16(wr + o * ws + k4, s.w + o * H + k4, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r = threadIdx.x / 2, o0 = threadIdx.x % 2 * 3;
  if (r >= rows) return;
  float acc[3] = {};
  for (int k = 0; k < H; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(hr + r * hs + k);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 wv =
          *reinterpret_cast<const float4*>(wr + (o0 + j) * ws + k);
      acc[j] = fmaf(v.x, wv.x, acc[j]);
      acc[j] = fmaf(v.y, wv.y, acc[j]);
      acc[j] = fmaf(v.z, wv.z, acc[j]);
      acc[j] = fmaf(v.w, wv.w, acc[j]);
    }
  }
  float* out = s.head + (n0 + r) * HSTRIDE;
#pragma unroll
  for (int j = 0; j < 3; ++j) out[o0 + j] = acc[j] + __ldg(s.b + o0 + j);
  if (o0) out[RHEAD] = out[RHEAD + 1] = 0.f;
}

// ---- host side ----------------------------------------------------------------

enum Stage {
  RS_ENC = 0,
  RS_CELL = 1,
  RS_HEAD = 2,
  RS_ENV = 3,
  RS_PREP = 4,
  RS_ALL = 5
};

// One K7 call: the whole chunk (RS_ALL), or one stage of its step 0 on the
// rows the workspace holds (the stage checks): RS_ENC runs encoder layer
// `layer`, RS_CELL the cell (writing the final carry too: T = 1), RS_HEAD
// the head on the second row buffer, RS_ENV step 0's env stage with the
// next observation rows into obs_next and xs, RS_PREP the prep alone. p's
// shapes, pointers and options are set; this carves the workspace and
// launches, adding each kernel it launches to launched[5] where given: the
// encoder stages', the cell stages', the head stages', the env stages'
// (tick and observation rows), the prep's.
cudaError_t run_act_rnn(int stage, int layer, ActRnnArgs& p, int R,
                        float* obs_next, long* launched,
                        cudaStream_t stream) {
  const RnnNet& net = p.net;
  const RnnLayout& w = p.w;
  const int A = p.A;
  if (!make_groups(A, p.B, 1, nullptr, 0, &p.rg)) return cudaErrorInvalidValue;
  float* work = p.work;
  p.head = work + w.head;
  p.envst = reinterpret_cast<int*>(work + w.envst);
  const long N = p.B * A;
  const unsigned tiles = (unsigned)((N + BM - 1) / BM);
  long unused[5] = {};
  if (!launched) launched = unused;
  auto count = [&](cudaError_t e, int slot) {
    if (e == cudaSuccess) ++launched[slot];
    return e;
  };
  cudaError_t e;
  if ((e = opt_in(hidden_kernel, smem_hidden())) != cudaSuccess ||
      (e = opt_in(cell_kernel<false>, smem_cell())) != cudaSuccess ||
      (e = opt_in(cell_kernel<true>, smem_cell())) != cudaSuccess ||
      (e = opt_in(rnn_head_kernel, smem_rnn_head(w.H4))) != cudaSuccess)
    return e;
  auto env = [&](int t, int mode, float* out) {
    cudaError_t err = count(launch_env(p, R, t, mode, nullptr, stream), 3);
    if (err != cudaSuccess || ((mode & TO_OUTPUT) && !(mode & KEEP_STATE)))
      return err;
    return count(launch_obs(p, R, out, work + w.xs, w.ld[0], stream), 3);
  };
  // Encoder layer l of step t: the last writes the e part of rb[t % 2].
  auto encoder = [&](int l, int t) {
    const bool last = l + 1 == net.n_enc;
    const float* x = l == 0 ? work + w.xs : work + w.enc[(l - 1) % 2];
    float* y = last ? work + w.rb[t % 2] : work + w.enc[l % 2];
    const int ys = last ? w.K : w.EL;
    const int cols = last ? w.Ep : w.ld[l + 1];
    const HiddenStage hs = {x, w.ld[l], work + w.bt[l], 0,
                            p.params + net.enc_b[l], 0, y, ys, cols,
                            net.enc_out[l]};
    const dim3 grid(tiles, (unsigned)(w.hp[l] / BN));
    hidden_kernel<<<grid, GNT, smem_hidden(), stream>>>(hs, p.rg);
    return count(cudaGetLastError(), 0);
  };
  auto cell = [&](int t) {
    const bool last = t + 1 == p.T;
    const CellStage cs = {
        work + w.rb[t % 2], work + w.rb[(t + 1) % 2], work + w.bc, w.K,
        w.Ep, net.H, w.tiles, N,
        p.params + (net.lstm ? net.bh : net.bi),
        p.params + net.bh, net.lstm ? work + w.cs : nullptr,
        last ? p.o_h : nullptr, last && net.lstm ? p.o_c : nullptr};
    const dim3 grid(tiles, (unsigned)w.tiles);
    if (net.lstm)
      cell_kernel<true><<<grid, GNT, smem_cell(), stream>>>(cs);
    else
      cell_kernel<false><<<grid, GNT, smem_cell(), stream>>>(cs);
    return count(cudaGetLastError(), 1);
  };
  auto head = [&](int t) {
    const RnnHeadStage hs = {work + w.rb[(t + 1) % 2] + w.Ep, w.K, w.H4,
                             work + w.hw, p.params + net.head_b, p.head, N};
    rnn_head_kernel<<<(unsigned)((N + HROWS - 1) / HROWS), 2 * HROWS,
                      smem_rnn_head(w.H4), stream>>>(hs);
    return count(cudaGetLastError(), 2);
  };
  if (stage == RS_PREP || stage == RS_ALL) {
    const PadPlan plan = enc_plan(p);
    rnn_prep_kernel<<<256, 256, 0, stream>>>(p, plan.batch(0));
    if ((e = count(cudaGetLastError(), 4)) != cudaSuccess ||
        (e = plan.launch_rest(256, 256, stream, launched + 4)) != cudaSuccess)
      return e;
    if (stage == RS_PREP) return cudaSuccess;
  }
  if (stage == RS_ENC)
    return layer >= 0 && layer < net.n_enc ? encoder(layer, 0)
                                           : cudaErrorInvalidValue;
  if (stage == RS_CELL) return cell(0);
  if (stage == RS_HEAD) return head(0);
  if (stage == RS_ENV)
    return env(0, FROM_INPUT | TO_OUTPUT | KEEP_STATE, obs_next);
  const long obs_step = N * (long)p.D;
  if ((e = env(-1, FROM_INPUT, p.obs)) != cudaSuccess) return e;
  for (int t = 0; t < p.T; ++t) {
    for (int l = 0; l < net.n_enc; ++l)
      if ((e = encoder(l, t)) != cudaSuccess) return e;
    if ((e = cell(t)) != cudaSuccess || (e = head(t)) != cudaSuccess)
      return e;
    const bool last = t + 1 == p.T;
    if ((e = env(t, last ? TO_OUTPUT : 0,
                 last ? nullptr : p.obs + (t + 1) * obs_step)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

// The shape checks of every entry point: a supported net, agents and queue
// of this build (dispatch_shape).
bool rnn_shape_ok(int A, int R, int n_enc, const int* dims, int H, int lstm,
                  RnnNet* net, RnnTables* tb) {
  return make_rnn_net(n_enc, dims, H, lstm, net, tb) && known_shape(A, R);
}

// The arguments shared by the two entry points below.
int act_rnn_call(
    int stage, int layer, int A, int R, long B, int T, int H, int W,
    float spawn_prob, int S, int k, int D, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int n_enc, const int* dims, int hidden,
    int lstm, const unsigned char* walls, const float* params, float* work,
    const int* pos, const int* areq, const int* carry, const int* rpick,
    const int* rdrop, const int* rstat, const int* ragent, const float* h0,
    const float* c0, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* o_h,
    float* o_c, float* obs, int* action, float* log_prob, float* value,
    float* reward, int* delivered, float* logits, unsigned char* mask,
    float* obs_next, long* launched, void* stream_) {
  ActRnnArgs p = {};
  RnnTables tb;
  if (!rnn_shape_ok(A, R, n_enc, dims, hidden, lstm, &p.net, &tb) ||
      dims[0] != D || (lstm && (!c0 || !o_c)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  set_env_args(p, B, T, A, H, W, spawn_prob, S, k, D, 0, inv_h, inv_w,
               step_penalty, pickup_reward, delivery_reward,
               collision_penalty, walls, pos, areq, carry, rpick, rdrop,
               rstat, ragent, u, pick, drop, gumbel, o_pos, o_areq, o_carry,
               o_rpick, o_rdrop, o_rstat, o_ragent, obs, action, log_prob,
               value, reward, delivered, logits, mask, nullptr, nullptr,
               nullptr, 0.f, 0.f);
  p.w = rnn_layout(p.net, A, R, B, &tb);
  p.params = params;
  p.h0 = h0;
  p.c0 = lstm ? c0 : nullptr;
  p.o_h = o_h;
  p.o_c = lstm ? o_c : nullptr;
  p.work = work;
  return (int)run_act_rnn(stage, layer, p, R, obs_next, launched,
                          (cudaStream_t)stream_);
}

}  // namespace

// Floats of the packed parameter vector, or 0 for unsupported widths.
extern "C" long wh_rnn_param_floats(int n_enc, const int* dims, int H,
                                    int lstm) {
  RnnNet net;
  RnnTables tb;
  return make_rnn_net(n_enc, dims, H, lstm, &net, &tb) ? net.n_params : 0;
}

// Floats of the workspace a call takes for B envs, or 0 for an unsupported
// shape.
extern "C" long wh_act_rnn_workspace_floats(int A, int R, long B, int n_enc,
                                            const int* dims, int H,
                                            int lstm) {
  RnnNet net;
  RnnTables tb;
  if (!rnn_shape_ok(A, R, n_enc, dims, H, lstm, &net, &tb)) return 0;
  return rnn_layout(net, A, R, B, &tb).total;
}

// The workspace's layout: out = the float offsets of xs, enc[0], enc[1],
// rb[0], rb[1], cs, head and envst. Rows of xs are D rounded up to 32
// floats apart, of enc the widest intermediate encoder width so rounded, of
// rb [e | h] with E and H each so rounded; cs and head [N][8] are dense.
extern "C" int wh_act_rnn_layout(int A, int R, long B, int n_enc,
                                 const int* dims, int H, int lstm,
                                 long* out) {
  RnnNet net;
  RnnTables tb;
  if (!rnn_shape_ok(A, R, n_enc, dims, H, lstm, &net, &tb))
    return (int)cudaErrorInvalidValue;
  const RnnLayout w = rnn_layout(net, A, R, B, &tb);
  const long offs[8] = {w.xs, w.enc[0], w.enc[1], w.rb[0],
                        w.rb[1], w.cs, w.head, w.envst};
  for (int i = 0; i < 8; ++i) out[i] = offs[i];
  return 0;
}

// T steps of the recurrent policy. `work` is the workspace
// (wh_act_rnn_workspace_floats). launched[0..4] gets the kernels launched
// added: the encoder stages', the cell stages', the head stages', the env
// stages', the prep's.
extern "C" int wh_act_rnn_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, float inv_h, float inv_w, float step_penalty,
    float pickup_reward, float delivery_reward, float collision_penalty,
    int n_enc, const int* dims, int hidden, int lstm,
    const unsigned char* walls, const float* params, float* work,
    const int* pos, const int* areq, const int* carry, const int* rpick,
    const int* rdrop, const int* rstat, const int* ragent, const float* h0,
    const float* c0, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* o_h,
    float* o_c, float* obs, int* action, float* log_prob, float* value,
    float* reward, int* delivered, float* logits, unsigned char* mask,
    long* launched, void* stream) {
  return act_rnn_call(
      RS_ALL, 0, A, R, B, T, H, W, spawn_prob, S, k, D, inv_h, inv_w,
      step_penalty, pickup_reward, delivery_reward, collision_penalty, n_enc,
      dims, hidden, lstm, walls, params, work, pos, areq, carry, rpick, rdrop,
      rstat, ragent, h0, c0, u, pick, drop, gumbel, o_pos, o_areq, o_carry,
      o_rpick, o_rdrop, o_rstat, o_ragent, o_h, o_c, obs, action, log_prob,
      value, reward, delivered, logits, mask, nullptr, launched, stream);
}

// One stage of step 0 (0: encoder layer `layer`, 1: cell, 2: head, 3: env,
// 4: the prep alone; wh_act_rnn_rollout's arguments, T = 1), on the rows
// the workspace holds; the env stage writes the next observation rows [B,
// A, D] into obs_next.
extern "C" int wh_act_rnn_stage(
    int stage, int layer, int A, int R, long B, int T, int H, int W,
    float spawn_prob, int S, int k, int D, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int n_enc, const int* dims, int hidden,
    int lstm, const unsigned char* walls, const float* params, float* work,
    const int* pos, const int* areq, const int* carry, const int* rpick,
    const int* rdrop, const int* rstat, const int* ragent, const float* h0,
    const float* c0, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* o_h,
    float* o_c, float* obs, int* action, float* log_prob, float* value,
    float* reward, int* delivered, float* logits, unsigned char* mask,
    float* obs_next, long* launched, void* stream) {
  if (stage < RS_ENC || stage > RS_PREP) return (int)cudaErrorInvalidValue;
  return act_rnn_call(
      stage, layer, A, R, B, T, H, W, spawn_prob, S, k, D, inv_h, inv_w,
      step_penalty, pickup_reward, delivery_reward, collision_penalty, n_enc,
      dims, hidden, lstm, walls, params, work, pos, areq, carry, rpick, rdrop,
      rstat, ragent, h0, c0, u, pick, drop, gumbel, o_pos, o_areq, o_carry,
      o_rpick, o_rdrop, o_rstat, o_ragent, o_h, o_c, obs, action, log_prob,
      value, reward, delivered, logits, mask, obs_next, launched, stream);
}
