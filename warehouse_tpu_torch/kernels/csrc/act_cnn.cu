// K10: the PPO acting phase of the CNN policy, T steps a call.
//
// Replaces the CNN arm of warehouse_tpu/pallas/act.py ppo_rollout_pallas
// (:1028 with arch="cnn": extract_cnn_weights :942, the layer loop of
// _act_kernel :365-389 with n_relu / cnn_split, _obs_rows :138,
// _sample_logprob :491 and the env tick of rollout.py:57), with its
// action-masking, its potential-shaping (act_common.cuh tick_env), its
// global-observation option (act_common.cuh obs_value: the grid is then the
// whole map, S = the grid's side, 5 channels) and its policy groups
// (:1062-1076, the trace-time selection of _act_kernel :336-338, :409).
//
// Each step is three stage kernels on the caller's stream over all of the
// step's N = B A rows (env, agent), with no host synchronisation; the env
// state lives in device memory (envst) from one step to the next:
//
//   A conv_kernel: persistent CTAs of 8 warps over tiles of RA samples (16
//      to 64, chosen from the shapes and the card's SMs: choose_ra), the
//      rows of obs[t] staged by cp.async into a zero-bordered (S + 2)^2
//      grid, so that no tap needs a bounds test. Both convolutions as
//      implicit products over the tile's (sample, position) rows, a thread
//      8 rows by 4 columns (conv 0) or 8 (conv 1): conv 0 sums over the
//      9 C0 (tap, channel) pairs of its window (45 at C0 = 5, no pad
//      channel), one A value and one float4 of 4 columns a k; conv 1 over 9
//      taps x C1 channels read as float4 (8 + 8 16-byte loads for 256 FMAs
//      per 4 channels). a0 stays in shared memory; relu(conv 1), the self
//      features and zeros to KT go to a1 [N, KT].
//   B trunk_kernel: h = tanh(a1 Wt^T + bt) as 64 x 128 tiles
//      (mma_tiles.cuh gemm_64x128_f32, a pass per 128 of H); the epilogue
//      keeps a pass's h in shared memory and carries the 6 x H head's sums
//      over the passes in column order: head [N, 8].
//   C env_kernel: 128 threads over 32 / A envs (16 at 6 and 8 agents:
//      env_cta): each row's mask, sample and outputs (act_common.cuh
//      sample_row: gumbel, first max, stable log-softmax), each env's tick
//      with rewards, shaping and deliveries (tick_env), then the next
//      step's observation rows into obs[t + 1] (obs_value). A prologue
//      launch writes obs[0]; the last step stores the final state.
//   prep (once a call): the trunk's kernel as wk [HP, KT] per group,
//      zero-padded to whole tiles.
//
// So T steps are 3 T + 2 launches. The rows are group-major: group 0's
// (env, agent) pairs env by env, then group 1's, and so on (without
// groups: b A + a, env-major). A tile of A or B holds one group's rows and
// runs on that group's packed vector; C finds a pair's head row from the
// group tables (RowGroups). A stage-A CTA restages the conv kernels only
// when its next tile is another group's.
//
// The bound is the products on the CUDA cores in float32: per row ~0.40
// MFLOP at S = 5 and ~1.4 at S = 9 (hidden 128; convolutions over their
// valid taps), against which a1's bytes (3.3 and 10.5 KB a row, written by
// A and read by B, mostly from L2) are small. The TPU kernel's whole-chunk
// residency has no counterpart: the step's rows do not fit one SM, so they
// go through device memory between stages, and every stage is a grid over
// all the rows instead of one CTA's few envs.
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine (act_common.cuh, env_tick.cuh, shared with K2 and
// K7); the policy outputs are float32 FMA chains, each sum in a fixed
// order (conv: tap, then channel; trunk and head: k), whatever the tiles,
// with no atomics, so a rerun gives the same bits. The products are FFMA
// on the CUDA cores (no TF32: mma_tiles.cuh).

#include <cuda_runtime.h>

#include "act_common.cuh"
#include "cnn_net.cuh"
#include "env_tick.cuh"
#include "mma_tiles.cuh"

namespace {

constexpr int CNN_MAXK = 8;  // policy groups
constexpr int CNN_MAXA = 8;  // agents of an env (the presets' most)
constexpr int ANT = 256;     // threads of stage A: 8 warps
constexpr int ANW = ANT / 32;
constexpr int RA_MIN = 16;   // samples of a stage-A tile at least (K12's
                             // smallest: the maps K11 refuses stay refused)
constexpr int RA_MAX = 64;
constexpr int CNT = 128;     // threads of stage C

// Envs of a stage-C CTA. One thread ticks each env, serially, and the tick
// of 6 or 8 agents holds 167-255 registers a thread, so few CTAs fit an SM:
// 16 envs a CTA then tick in one wave at B = 4096 where 32 / A would take
// three or four. At 2 and 4 agents 32 rows a CTA (the observation rows'
// work spread over more CTAs).
__host__ __device__ constexpr int env_cta(int A) {
  return A <= 4 ? 32 / A : 16;
}

// Stage A's layout of one sample and of the conv kernels, and stage B's
// padded widths.
struct ConvDims {
  int SP;    // S + 2: the zero-bordered grid's side
  int K0;    // conv 0's sum: 9 C0 (tap, channel) pairs
  int C1p;   // C1 rounded up to 16: conv 0's column blocks
  int C2p;   // C2 rounded up to 32: conv 1's
  int A0S;   // a0's floats a position (C1, + 4 where 32 divides it)
  int W1S;   // conv 1's kernel row (C1, + 4 where 16 divides it)
  int XR;    // floats of a sample's bordered obs grid + self features
  int A0R;   // floats of a sample's bordered a0
  int KT;    // a1's row stride: trunk_in rounded up to 32
  int HP;    // H rounded up to 128: wk's rows, stage B's passes
  int WF;    // floats of the staged conv kernels (+ koff), a multiple of 4
};

inline int round_up(long x, int m) { return (int)((x + m - 1) / m * m); }

inline ConvDims conv_dims(const CnnNet& net) {
  ConvDims d;
  d.SP = net.S + 2;
  d.K0 = 9 * net.C0;
  d.C1p = round_up(net.C1, 16);
  d.C2p = round_up(net.C2, 32);
  d.A0S = net.C1 % 32 ? net.C1 : net.C1 + 4;
  d.W1S = net.C1 % 16 ? net.C1 : net.C1 + 4;
  d.XR = round_up(d.SP * d.SP * net.C0 + NSELF, 4);
  d.A0R = d.SP * d.SP * d.A0S;
  d.KT = round_up(net.trunk_in, 32);
  d.HP = round_up(net.H, BN);
  // w0t [K0][C1p], b0 [C1p], w1 [9 C2p][W1S], b1 [C2p], koff [K0] ints
  d.WF = round_up((long)d.K0 * d.C1p + d.C1p + 9L * d.C2p * d.W1S + d.C2p +
                      d.K0,
                  4);
  return d;
}

// Floats of stage A's obs row offsets (a long a sample), a multiple of 4.
__host__ __device__ inline int rowoff_floats(int ra) {
  return (2 * ra + 3) / 4 * 4;
}

// Stage A's shared memory at `ra` samples a tile: the conv kernels, then
// each sample's obs row offset, obs grid and a0.
size_t smem_a(const ConvDims& d, int ra) {
  return sizeof(float) * ((size_t)d.WF + rowoff_floats(ra) +
                          (size_t)ra * (d.XR + d.A0R));
}

size_t smem_b() {
  return sizeof(float) * (2 * (BM + BN) * ldt<false>() + BM * (BN + 4) +
                          BM * ROST);
}

// The rows' order: group g's (env, agent) pairs are rows first[g] ..
// first[g + 1] - 1, env by env, each env's in agent order. Without groups,
// one group of all agents: row b A + a.
struct RowGroups {
  int K;                          // groups (1 without groups)
  int group[CNN_MAXA];            // agent -> group
  int n[CNN_MAXK];                // agents of each group
  int rank[CNN_MAXA];             // an agent's place in its group
  int agent[CNN_MAXK][CNN_MAXA];  // each group's agents in order
  long first[CNN_MAXK + 1];       // each group's first row
  long tile_a[CNN_MAXK + 1];      // each group's first stage-A tile
  long tile_b[CNN_MAXK + 1];      // its first stage-B tile

  __host__ __device__ long row_of(long b, int a) const {
    const int g = group[a];
    return first[g] + b * n[g] + rank[a];
  }
  // The group of stage tile `tile` whose table is `tiles`.
  __device__ int group_of(long tile, const long* tiles) const {
    int g = 0;
    while (g + 1 < K && tile >= tiles[g + 1]) ++g;
    return g;
  }
};

// False for a map with a group id out of [0, K), or K out of [1, 8].
inline bool make_groups(int A, long B, int K, const int* group, int ra,
                        RowGroups* rg) {
  if (K < 1 || K > CNN_MAXK || A > CNN_MAXA) return false;
  rg->K = K;
  for (int g = 0; g < K; ++g) rg->n[g] = 0;
  for (int a = 0; a < A; ++a) {
    const int g = group ? group[a] : 0;
    if (g < 0 || g >= K) return false;
    rg->group[a] = g;
    rg->rank[a] = rg->n[g];
    rg->agent[g][rg->n[g]++] = a;
  }
  rg->first[0] = rg->tile_a[0] = rg->tile_b[0] = 0;
  for (int g = 0; g < K; ++g) {
    const long rows = B * rg->n[g];
    rg->first[g + 1] = rg->first[g] + rows;
    rg->tile_a[g + 1] = rg->tile_a[g] + (ra > 0 ? (rows + ra - 1) / ra : 0);
    rg->tile_b[g + 1] = rg->tile_b[g] + (rows + BM - 1) / BM;
  }
  return true;
}

struct ActCnnArgs {
  long B;
  int T, A;
  wh::Geometry geo;
  int S, k, D;         // window side, radius, obs dim
  int gobs;            // the global observation instead of the ego window
  float inv_h, inv_w;  // float32 reciprocals of H and W
  float step_penalty, pickup_reward, delivery_reward, collision_penalty;
  CnnNet net;
  ConvDims cd;
  RowGroups rg;
  int RA;                // samples per stage-A tile
  const float* params;   // the packed vector (cnn_net.cuh), per group
  float* wk;             // [K][HP][KT] the trunk's kernels, zero-padded
  float* a1;             // [N][KT] the trunk's input rows
  float* head;           // [N][ROST] the head's outputs
  int* envst;            // [B][EnvSmem SIZE] the env states between steps
  const int *pos, *areq, *carry, *rpick, *rdrop, *rstat, *ragent;
  const float* u;
  const int *pick, *drop;
  const float* gumbel;   // [T, 5, B * A]
  int *o_pos, *o_areq, *o_carry, *o_rpick, *o_rdrop, *o_rstat, *o_ragent;
  float* obs;            // [T, B, A, D]
  int* action;           // [T, B, A]
  float *log_prob, *value, *reward;  // [T, B, A]
  int* delivered;        // [T, B]
  float* logits;         // [T, B, A, 5] pre-mask logits, or null
  unsigned char* mask;   // [T, B, A, 5] valid moves, or null: no masking
  Shaping shp;  // the potential-shaping option; off when its table is null
};

// ---- prep: the trunk's kernels as stage B reads them ------------------------

__global__ void trunk_prep_kernel(ActCnnArgs p) {
  const CnnNet& net = p.net;
  const int HP = p.cd.HP, KT = p.cd.KT;
  const long per = (long)HP * KT, n = per * p.rg.K;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int g = (int)(i / per), j = (int)(i % per / KT),
              k = (int)(i % KT);
    p.wk[i] = j < net.H && k < net.trunk_in
                  ? p.params[g * net.n_params + net.wt +
                             (long)j * net.trunk_in + k]
                  : 0.f;
  }
}

// ---- A: the convolutions ----------------------------------------------------

__global__ void __launch_bounds__(ANT) conv_kernel(ActCnnArgs p, int t) {
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  const ConvDims& d = p.cd;
  const RowGroups& rg = p.rg;
  const int S = net.S, P2 = net.P2, C0 = net.C0, C1 = net.C1, C2 = net.C2;
  const int SP = d.SP, K0 = d.K0, RA = p.RA, D = p.D;
  float* w0t = smem;                         // [K0][C1p] conv 0, k-major
  float* b0 = w0t + K0 * d.C1p;              // [C1p]
  float* w1 = b0 + d.C1p;                    // [9 C2p][W1S]: row k C2p + oc
  float* b1 = w1 + 9 * d.C2p * d.W1S;        // [C2p]
  int* koff = reinterpret_cast<int*>(b1 + d.C2p);  // [K0]
  long* rowoff = reinterpret_cast<long*>(smem + d.WF);  // [RA]
  float* xs = smem + d.WF + rowoff_floats(RA);  // [RA][XR]
  float* a0 = xs + RA * d.XR;                // [RA][A0R]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rgi = lane >> 2, cg = lane & 3;  // row group, column group
  const int mrows = RA * P2, nrb = (mrows + 63) / 64;

  // The borders stay zero: nothing below writes them.
  for (int i = tid; i < RA * (d.XR + d.A0R); i += ANT) xs[i] = 0.f;
  for (int k = tid; k < K0; k += ANT) {
    const int tap = k / C0, c = k % C0;
    koff[k] = ((tap / 3) * SP + tap % 3) * C0 + c;
  }
  int staged = -1;  // the group whose conv kernels are staged

  for (long tile = blockIdx.x; tile < rg.tile_a[rg.K]; tile += gridDim.x) {
    const int g = rg.group_of(tile, rg.tile_a);
    const long q0 = rg.first[g] + (tile - rg.tile_a[g]) * RA;
    const int nvalid =
        (int)(rg.first[g + 1] - q0 < RA ? rg.first[g + 1] - q0 : RA);
    __syncthreads();  // the previous tile's readers are done
    if (g != staged) {
      const float* pg = p.params + g * net.n_params;
      for (int i = tid; i < K0 * d.C1p; i += ANT) {
        const int k = i / d.C1p, oc = i % d.C1p;  // W0 row (tap C1 + oc)
        w0t[i] = oc < C1 ? pg[net.w0 + ((k / C0) * C1 + oc) * C0 + k % C0]
                         : 0.f;
      }
      for (int i = tid; i < d.C1p; i += ANT)
        b0[i] = i < C1 ? pg[net.b0 + i] : 0.f;
      for (int i = tid; i < 9 * d.C2p * C1; i += ANT) {
        const int row = i / C1, ic = i % C1, tap = row / d.C2p,
                  oc = row % d.C2p;
        w1[row * d.W1S + ic] =
            oc < C2 ? pg[net.w1 + (tap * C2 + oc) * C1 + ic] : 0.f;
      }
      for (int i = tid; i < d.C2p; i += ANT)
        b1[i] = i < C2 ? pg[net.b1 + i] : 0.f;
      staged = g;
    }
    // Each sample's obs row in obs[t]: row q = (env b, agent a).
    for (int n = tid; n < RA; n += ANT) {
      long off = 0;
      if (n < nvalid) {
        const long l = q0 + n - rg.first[g];
        const long b = l / rg.n[g];
        const int a = rg.agent[g][l % rg.n[g]];
        off = (((long)t * p.B + b) * p.A + a) * D;
      }
      rowoff[n] = off;
    }
    __syncthreads();
    // The obs rows into the bordered grid's interior and the self features
    // (zeros past the last sample).
    for (int i = tid; i < RA * D; i += ANT) {
      const int n = i / D, f = i % D;
      const int grid = P2 * C0;
      int s;
      if (f < grid) {
        const int cell = f / C0;
        s = ((cell / S + 1) * SP + cell % S + 1) * C0 + f % C0;
      } else {
        s = SP * SP * C0 + f - grid;
      }
      const bool ok = n < nvalid;
      cp_async4(xs + n * d.XR + s, ok ? p.obs + rowoff[n] + f : p.obs, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // Rows m = (sample m / P2, position m % P2) of the tile, 64 a block: a
    // thread's rows rb 64 + rgi + 8 i; past the tile's rows it computes on
    // sample 0 and stores nothing.
    int xoff[8], aoff[8];
    // Conv 0: K = the window's (tap, channel) pairs; columns cb 16 + 4 cg
    // + 0..3, relu into a0's interior.
    const int ncb0 = d.C1p / 16;
    for (int item = warp; item < nrb * ncb0; item += ANW) {
      const int rb = item / ncb0, c0 = item % ncb0 * 16 + 4 * cg;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int m = rb * 64 + rgi + 8 * i;
        m = m < mrows ? m : 0;
        const int n = m / P2, po = m % P2, ro = po / S, co = po % S;
        xoff[i] = n * d.XR + (ro * SP + co) * C0;
        aoff[i] = n * d.A0R + (ro * SP + co) * d.A0S;
      }
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 3
      for (int k = 0; k < K0; ++k) {
        const int ko = koff[k];
        const float4 w = *reinterpret_cast<const float4*>(w0t + k * d.C1p +
                                                          c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = xs[xoff[i] + ko];
          acc[i][0] = fmaf(x, w.x, acc[i][0]);
          acc[i][1] = fmaf(x, w.y, acc[i][1]);
          acc[i][2] = fmaf(x, w.z, acc[i][2]);
          acc[i][3] = fmaf(x, w.w, acc[i][3]);
        }
      }
      if (c0 < C1) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (rb * 64 + rgi + 8 * i >= mrows) continue;
          float4 v;
          v.x = fmaxf(acc[i][0] + b0[c0], 0.f);
          v.y = fmaxf(acc[i][1] + b0[c0 + 1], 0.f);
          v.z = fmaxf(acc[i][2] + b0[c0 + 2], 0.f);
          v.w = fmaxf(acc[i][3] + b0[c0 + 3], 0.f);
          // one position down and right: the interior of the bordered grid
          *reinterpret_cast<float4*>(a0 + aoff[i] + (SP + 1) * d.A0S + c0) =
              v;
        }
      }
    }
    // The self features, then zeros to KT, after conv 1's columns.
    const int tail = d.KT - P2 * C2;
    for (int i = tid; i < nvalid * tail; i += ANT) {
      const int n = i / tail, f = i % tail;
      p.a1[(q0 + n) * d.KT + P2 * C2 + f] =
          f < NSELF ? xs[n * d.XR + SP * SP * C0 + f] : 0.f;
    }
    __syncthreads();  // a0 complete

    // Conv 1: K = 9 taps x C1 channels, 4 a step as float4; columns cb 32
    // + 2 cg + 8 j + e (e < 2, j < 4), relu into a1.
    const int ncb1 = d.C2p / 32;
    for (int item = warp; item < nrb * ncb1; item += ANW) {
      const int rb = item / ncb1, c0 = item % ncb1 * 32 + 2 * cg;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        int m = rb * 64 + rgi + 8 * i;
        m = m < mrows ? m : 0;
        const int po = m % P2;
        aoff[i] = m / P2 * d.A0R + (po / S * SP + po % S) * d.A0S;
      }
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = ((tap / 3) * SP + tap % 3) * d.A0S;
        const float* wt = w1 + (tap * d.C2p + c0) * d.W1S;
#pragma unroll 2
        for (int k = 0; k < C1; k += 4) {
          float4 av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = *reinterpret_cast<const float4*>(a0 + aoff[i] + toff + k);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 w = *reinterpret_cast<const float4*>(
                wt + (8 * (j >> 1) + (j & 1)) * d.W1S + k);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float o = acc[i][j];
              o = fmaf(av[i].x, w.x, o);
              o = fmaf(av[i].y, w.y, o);
              o = fmaf(av[i].z, w.z, o);
              o = fmaf(av[i].w, w.w, o);
              acc[i][j] = o;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = rb * 64 + rgi + 8 * i, n = m / P2;
        if (m >= mrows || n >= nvalid) continue;
        float* dst = p.a1 + (q0 + n) * d.KT + (m % P2) * C2;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int oc = c0 + 8 * jj;
          if (oc >= C2) continue;
          float2 v;
          v.x = fmaxf(acc[i][2 * jj] + b1[oc], 0.f);
          v.y = fmaxf(acc[i][2 * jj + 1] + b1[oc + 1], 0.f);
          *reinterpret_cast<float2*>(dst + oc) = v;
        }
      }
    }
  }
}

// ---- B: the trunk and the head ----------------------------------------------

__global__ void __launch_bounds__(GNT) trunk_kernel(ActCnnArgs p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HBS = BN + 4;
  const CnnNet& net = p.net;
  const RowGroups& rg = p.rg;
  const int H = net.H, KT = p.cd.KT;
  float* ring = smem;
  float* hb = ring + 2 * (BM + BN) * ldt<false>();  // [BM][HBS] a pass's h
  float* hsum = hb + BM * HBS;                      // [BM][ROST] head sums
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int g = rg.group_of(blockIdx.x, rg.tile_b);
  const long q0 = rg.first[g] + ((long)blockIdx.x - rg.tile_b[g]) * BM;
  const int nvalid =
      (int)(rg.first[g + 1] - q0 < BM ? rg.first[g + 1] - q0 : BM);
  const float* pg = p.params + g * net.n_params;
  const float* wk = p.wk + (long)g * p.cd.HP * KT;
  for (int i = tid; i < BM * ROST; i += GNT) hsum[i] = 0.f;
  for (int n0 = 0; n0 < p.cd.HP; n0 += BN) {
    float acc[4][8] = {};
    gemm_64x128_f32(acc, p.a1 + q0 * KT, KT, nvalid, wk + (long)n0 * KT, KT,
                    KT, ring);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tc + 16 * j;
        hb[(tr + 16 * i) * HBS + tc + 16 * j] =
            col < H ? tanhf(acc[i][j] + __ldg(pg + net.bt + col)) : 0.f;
      }
    __syncthreads();
    // The head's sums carried over the passes, each in column order. The
    // next pass's GEMM synchronises before anything writes hb again.
    const int w = H - n0 < BN ? H - n0 : BN;
    for (int it = tid; it < BM * RHEAD; it += GNT) {
      const int n = it / RHEAD, o = it % RHEAD;
      const float* wo = pg + net.head_w + (long)o * H + n0;
      float s = hsum[n * ROST + o];
      for (int k = 0; k < w; ++k) s = fmaf(hb[n * HBS + k], __ldg(wo + k), s);
      hsum[n * ROST + o] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i < nvalid * ROST; i += GNT) {
    const int n = i / ROST, o = i % ROST;
    p.head[(q0 + n) * ROST + o] =
        o < RHEAD ? hsum[n * ROST + o] + __ldg(pg + net.head_b + o) : 0.f;
  }
}

// ---- C: sample, tick, observe -----------------------------------------------

enum { FROM_INPUT = 1, TO_OUTPUT = 2 };

// env_cta(A) envs a CTA: their states from the inputs (FROM_INPUT) or
// envst; at t >= 0 each row's sample from its head row and each env's tick
// at step t; the observation rows of the ticked states into obs_out (when
// set, [B, A, D]); the states to the outputs (TO_OUTPUT) or envst.
template <int A, int R>
__global__ void __launch_bounds__(CNT) env_kernel(ActCnnArgs p, int t,
                                                  int mode, float* obs_out) {
  using ES = EnvSmem<A, R>;
  constexpr int NE = env_cta(A);
  static_assert(NE * A <= CNT, "a thread samples each row");
  __shared__ int env_s[NE * ES::SIZE];
  __shared__ int act_s[NE * A];
  const int tid = threadIdx.x;
  const long b0 = (long)blockIdx.x * NE;
  const int ne = (int)(p.B - b0 < NE ? p.B - b0 : NE);
  if (mode & FROM_INPUT) {
    if (tid < ne) {
      wh::Env<A, R> e;
      wh::load_env(e, b0 + tid, p.pos, p.areq, p.carry, p.rpick, p.rdrop,
                   p.rstat, p.ragent);
      ES::put(e, env_s + tid * ES::SIZE);
    }
  } else {
    for (int i = tid; i < ne * ES::SIZE; i += CNT)
      env_s[i] = p.envst[b0 * ES::SIZE + i];
  }
  __syncthreads();
  if (t >= 0) {
    // Mask, sample, log-softmax (as K2), one thread per (env, agent).
    if (tid < ne * A) {
      const long b = b0 + tid / A;
      const int a = tid % A;
      act_s[tid] = sample_row<A>(p, p.head + p.rg.row_of(b, a) * ROST,
                                 env_s + (tid / A) * ES::SIZE, a, true, t,
                                 b);
    }
    __syncthreads();
    // Env tick and rewards, one thread per env.
    if (tid < ne)
      tick_env<A, R>(p, env_s + tid * ES::SIZE, act_s + tid * A,
                     (long)t * p.B + b0 + tid);
    __syncthreads();
  }
  if (obs_out) {
    const int D = p.D, n = ne * A * D;
    float* dst = obs_out + b0 * A * D;
    for (int i = tid; i < n; i += CNT) {
      const int r = i / D;
      dst[i] = obs_value<A, R>(env_s + (r / A) * ES::SIZE, r % A, i % D, p);
    }
  }
  if (mode & TO_OUTPUT) {
    if (tid < ne) {
      wh::Env<A, R> e;
      ES::get(env_s + tid * ES::SIZE, e);
      wh::store_env(e, b0 + tid, p.o_pos, p.o_areq, p.o_carry, p.o_rpick,
                    p.o_rdrop, p.o_rstat, p.o_ragent);
    }
  } else {
    for (int i = tid; i < ne * ES::SIZE; i += CNT)
      p.envst[b0 * ES::SIZE + i] = env_s[i];
  }
}

template <int A, int R>
struct EnvLaunch {
  static void run(const ActCnnArgs& p, int t, int mode, float* obs_out,
                  cudaStream_t stream, int* err) {
    constexpr int NE = env_cta(A);
    const unsigned blocks = (unsigned)((p.B + NE - 1) / NE);
    env_kernel<A, R><<<blocks, CNT, 0, stream>>>(p, t, mode, obs_out);
    *err = (int)cudaGetLastError();
  }
};

template <int A, int R>
struct KnownShape {
  static void run(int* ok) { *ok = 1; }
};

// ---- host side --------------------------------------------------------------

// Stage A's tile and grid for this call's rows: of the even tiles from
// RA_MAX down to RA_MIN samples that fit, the one whose CTAs leave the
// least work on the busiest SM (tiles a CTA slot runs, times the CTAs
// sharing an SM, times the rounds of 64-row blocks over the 8 warps a tile
// takes); ra 0 when not even RA_MIN fit.
struct ConvLaunch {
  int ra;
  unsigned grid;
  size_t smem;
};

ConvLaunch choose_ra(const CnnNet& net, const ConvDims& d, int A, long B,
                     int K, const int* group) {
  ConvLaunch best = {0, 0, 0};
  const size_t limit = smem_optin_limit();
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(conv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)limit) != cudaSuccess)
    return best;
  long best_cost = 0;
  for (int ra = RA_MAX; ra >= RA_MIN; ra -= 2) {
    const size_t smem = smem_a(d, ra);
    int occ = 0;
    if (smem > limit ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, conv_kernel, ANT,
                                                      smem) != cudaSuccess ||
        occ < 1)
      continue;
    RowGroups rg;
    make_groups(A, B, K, group, ra, &rg);
    const long tiles = rg.tile_a[rg.K], slots = (long)sms * occ;
    const long rounds = ((ra * net.P2 + 63) / 64 + ANW - 1) / ANW;
    const long cost = (tiles + slots - 1) / slots * occ * rounds;
    if (best.ra == 0 || cost < best_cost) {
      best = {ra, (unsigned)(tiles < slots ? tiles : slots), smem};
      best_cost = cost;
    }
  }
  return best;
}

// The workspace: wk [K][HP][KT], a1 [N][KT], head [N][ROST], envst [B][4 A
// + 6 R] ints; offsets in floats, each a multiple of 32.
struct WorkLayout {
  long wk, a1, head, envst, total;
};

WorkLayout work_layout(const ConvDims& d, int A, int R, long B, int K) {
  WorkLayout w;
  long off = 0;
  auto take = [&](long n) {
    const long o = off;
    off += (n + 31) / 32 * 32;
    return o;
  };
  w.wk = take((long)K * d.HP * d.KT);
  w.a1 = take(B * A * d.KT);
  w.head = take(B * A * ROST);
  w.envst = take(B * (4L * A + 6L * R));
  w.total = off;
  return w;
}

// The shape checks of every entry point: a supported net, agents and queue
// of a preset, K in [0, 8] (0: no groups) with a valid map.
bool shape_ok(int A, int R, int S, int C0, int C1, int C2, int H, int K,
              const int* group, CnnNet* net) {
  int known = 0;
  RowGroups rg;
  return make_cnn_net(S, C0, C1, C2, H, net) &&
         wh::dispatch_shape<KnownShape>(A, R, &known) && known && K >= 0 &&
         make_groups(A, 1, K > 0 ? K : 1, K > 0 ? group : nullptr, RA_MIN,
                     &rg);
}

enum Stage { ST_CONV = 0, ST_TRUNK = 1, ST_ENV = 2, ST_ALL = 3 };

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One K10 call: the whole chunk (ST_ALL), or one stage of its step 0 (the
// stage checks): ST_CONV reads obs[0] and writes a1, ST_TRUNK (with prep)
// reads a1 and writes head, ST_ENV reads head and the input state and
// writes step 0's outputs, the final state and the next observation rows
// into obs_next. p's shapes, pointers and options are set; this sets the
// stage layout, carves the workspace and launches.
cudaError_t run_act_cnn(int stage, ActCnnArgs& p, int R, int K,
                        const int* group, float* work, float* obs_next,
                        cudaStream_t stream) {
  const int A = p.A;
  const int KK = K > 0 ? K : 1;
  const int* gmap = K > 0 ? group : nullptr;
  p.cd = conv_dims(p.net);
  const ConvLaunch cl = choose_ra(p.net, p.cd, A, p.B, KK, gmap);
  if (cl.ra < 1 || !make_groups(A, p.B, KK, gmap, cl.ra, &p.rg))
    return cudaErrorInvalidValue;
  p.RA = cl.ra;
  const WorkLayout wl = work_layout(p.cd, A, R, p.B, KK);
  p.wk = work + wl.wk;
  p.a1 = work + wl.a1;
  p.head = work + wl.head;
  p.envst = reinterpret_cast<int*>(work + wl.envst);
  cudaError_t e;
  int err = 0;
  auto env = [&](int t, int mode, float* out) {
    wh::dispatch_shape<EnvLaunch>(A, R, p, t, mode, out, stream, &err);
    return (cudaError_t)err;
  };
  auto conv = [&](int t) {
    conv_kernel<<<cl.grid, ANT, cl.smem, stream>>>(p, t);
    return cudaGetLastError();
  };
  const unsigned tiles_b = (unsigned)p.rg.tile_b[p.rg.K];
  auto trunk = [&]() {
    trunk_kernel<<<tiles_b, GNT, smem_b(), stream>>>(p);
    return cudaGetLastError();
  };
  if ((e = opt_in(trunk_kernel, smem_b())) != cudaSuccess) return e;
  if (stage == ST_TRUNK || stage == ST_ALL) {
    trunk_prep_kernel<<<256, 256, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (stage == ST_CONV) return conv(0);
  if (stage == ST_TRUNK) return trunk();
  if (stage == ST_ENV) return env(0, FROM_INPUT | TO_OUTPUT, obs_next);
  const long obs_step = p.B * A * (long)p.D;
  if ((e = env(-1, FROM_INPUT, p.obs)) != cudaSuccess) return e;
  for (int t = 0; t < p.T; ++t) {
    if ((e = conv(t)) != cudaSuccess || (e = trunk()) != cudaSuccess)
      return e;
    const bool last = t + 1 == p.T;
    if ((e = env(t, last ? TO_OUTPUT : 0,
                 last ? nullptr : p.obs + (t + 1) * obs_step)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of the packed parameter vector, or 0 for unsupported widths.
extern "C" long wh_cnn_param_floats(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  return make_cnn_net(S, C0, C1, C2, H, &net) ? net.n_params : 0;
}

// Shared memory the largest stage needs at stage A's smallest tile (RA_MIN
// samples), in bytes: more than the device allows when that tile does not
// fit; 0 for an unsupported shape or group map. K = 0: without groups;
// else `group` maps each of the A agents to a group in [0, K).
extern "C" long wh_act_cnn_smem_bytes(int A, int R, int S, int C0, int C1,
                                      int C2, int H, int K,
                                      const int* group) {
  CnnNet net;
  if (!shape_ok(A, R, S, C0, C1, C2, H, K, group, &net)) return 0;
  const size_t a = smem_a(conv_dims(net), RA_MIN), b = smem_b();
  return (long)(a > b ? a : b);
}

// Floats of the workspace a call takes for B envs (K = 0: one policy).
extern "C" long wh_act_cnn_workspace_floats(int A, int R, long B, int S,
                                            int C0, int C1, int C2, int H,
                                            int K) {
  CnnNet net;
  if (!make_cnn_net(S, C0, C1, C2, H, &net)) return 0;
  return work_layout(conv_dims(net), A, R, B, K > 0 ? K : 1).total;
}

// The workspace's layout: out = the float offsets of wk, a1, head and
// envst, then KT (a1's row stride) and HP (wk's rows per group).
extern "C" int wh_act_cnn_layout(int A, int R, long B, int S, int C0, int C1,
                                 int C2, int H, int K, long* out) {
  CnnNet net;
  if (!make_cnn_net(S, C0, C1, C2, H, &net))
    return (int)cudaErrorInvalidValue;
  const ConvDims d = conv_dims(net);
  const WorkLayout w = work_layout(d, A, R, B, K > 0 ? K : 1);
  out[0] = w.wk;
  out[1] = w.a1;
  out[2] = w.head;
  out[3] = w.envst;
  out[4] = d.KT;
  out[5] = d.HP;
  return 0;
}

namespace {

// The arguments shared by the two entry points below.
int act_cnn_call(
    int stage, int A, int R, long B, int T, int H, int W, float spawn_prob,
    int S, int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int C0, int C1, int C2, int hidden, int K,
    const int* group, const unsigned char* walls, const float* params,
    float* work, const int* pos, const int* areq, const int* carry,
    const int* rpick, const int* rdrop, const int* rstat, const int* ragent,
    const float* u, const int* pick, const int* drop, const float* gumbel,
    int* o_pos, int* o_areq, int* o_carry, int* o_rpick, int* o_rdrop,
    int* o_rstat, int* o_ragent, float* obs, int* action, float* log_prob,
    float* value, float* reward, int* delivered, float* logits,
    unsigned char* mask, const int* table, const float* done,
    float* raw_reward, float shaping_coef, float gamma, float* obs_next,
    void* stream_) {
  ActCnnArgs p = {};
  if (!shape_ok(A, R, S, C0, C1, C2, hidden, K, group, &p.net) ||
      p.net.D != D)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  p.B = B;
  p.T = T;
  p.A = A;
  p.geo.H = H;
  p.geo.W = W;
  p.geo.spawn_prob = spawn_prob;
  p.geo.walls = walls;
  p.S = S;
  p.k = k;
  p.D = D;
  p.gobs = global_obs;
  p.inv_h = inv_h;
  p.inv_w = inv_w;
  p.step_penalty = step_penalty;
  p.pickup_reward = pickup_reward;
  p.delivery_reward = delivery_reward;
  p.collision_penalty = collision_penalty;
  p.params = params;
  p.pos = pos;
  p.areq = areq;
  p.carry = carry;
  p.rpick = rpick;
  p.rdrop = rdrop;
  p.rstat = rstat;
  p.ragent = ragent;
  p.u = u;
  p.pick = pick;
  p.drop = drop;
  p.gumbel = gumbel;
  p.o_pos = o_pos;
  p.o_areq = o_areq;
  p.o_carry = o_carry;
  p.o_rpick = o_rpick;
  p.o_rdrop = o_rdrop;
  p.o_rstat = o_rstat;
  p.o_ragent = o_ragent;
  p.obs = obs;
  p.action = action;
  p.log_prob = log_prob;
  p.value = value;
  p.reward = reward;
  p.delivered = delivered;
  p.logits = logits;
  p.mask = mask;
  p.shp.table = table;
  p.shp.done = done;
  p.shp.raw_reward = raw_reward;
  p.shp.coef = shaping_coef;
  p.shp.gamma = gamma;
  p.shp.C = H * W;
  return (int)run_act_cnn(stage, p, R, K, group, work, obs_next,
                          (cudaStream_t)stream_);
}

}  // namespace

// T steps of the CNN policy. `work` is the workspace
// (wh_act_cnn_workspace_floats). K = 0: one policy; else `params` holds K
// packed vectors in group order and `group` maps each agent to one of them.
extern "C" int wh_act_cnn_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int C0, int C1, int C2, int hidden, int K,
    const int* group, const unsigned char* walls, const float* params,
    float* work, const int* pos, const int* areq, const int* carry,
    const int* rpick, const int* rdrop, const int* rstat, const int* ragent,
    const float* u, const int* pick, const int* drop, const float* gumbel,
    int* o_pos, int* o_areq, int* o_carry, int* o_rpick, int* o_rdrop,
    int* o_rstat, int* o_ragent, float* obs, int* action, float* log_prob,
    float* value, float* reward, int* delivered, float* logits,
    unsigned char* mask, const int* table, const float* done,
    float* raw_reward, float shaping_coef, float gamma, void* stream_) {
  return act_cnn_call(
      ST_ALL, A, R, B, T, H, W, spawn_prob, S, k, D, global_obs, inv_h, inv_w,
      step_penalty, pickup_reward, delivery_reward, collision_penalty, C0, C1,
      C2, hidden, K, group, walls, params, work, pos, areq, carry, rpick,
      rdrop, rstat, ragent, u, pick, drop, gumbel, o_pos, o_areq, o_carry,
      o_rpick, o_rdrop, o_rstat, o_ragent, obs, action, log_prob, value,
      reward, delivered, logits, mask, table, done, raw_reward, shaping_coef,
      gamma, nullptr, stream_);
}

// One stage of step 0 (0: conv, 1: trunk, 2: env; wh_act_cnn_rollout's
// arguments, T = 1), on the rows the workspace holds; the env stage writes
// the next observation rows [B, A, D] into obs_next.
extern "C" int wh_act_cnn_stage(
    int stage, int A, int R, long B, int T, int H, int W, float spawn_prob,
    int S, int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int C0, int C1, int C2, int hidden, int K,
    const int* group, const unsigned char* walls, const float* params,
    float* work, const int* pos, const int* areq, const int* carry,
    const int* rpick, const int* rdrop, const int* rstat, const int* ragent,
    const float* u, const int* pick, const int* drop, const float* gumbel,
    int* o_pos, int* o_areq, int* o_carry, int* o_rpick, int* o_rdrop,
    int* o_rstat, int* o_ragent, float* obs, int* action, float* log_prob,
    float* value, float* reward, int* delivered, float* logits,
    unsigned char* mask, const int* table, const float* done,
    float* raw_reward, float shaping_coef, float gamma, float* obs_next,
    void* stream_) {
  if (stage < ST_CONV || stage > ST_ENV) return (int)cudaErrorInvalidValue;
  return act_cnn_call(
      stage, A, R, B, T, H, W, spawn_prob, S, k, D, global_obs, inv_h, inv_w,
      step_penalty, pickup_reward, delivery_reward, collision_penalty, C0, C1,
      C2, hidden, K, group, walls, params, work, pos, areq, carry, rpick,
      rdrop, rstat, ragent, u, pick, drop, gumbel, o_pos, o_areq, o_carry,
      o_rpick, o_rdrop, o_rstat, o_ragent, obs, action, log_prob, value,
      reward, delivered, logits, mask, table, done, raw_reward, shaping_coef,
      gamma, obs_next, stream_);
}
