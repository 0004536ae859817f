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
//   B head_kernel (act_stages.cuh, shared with K2): h = tanh(a1 Wt^T +
//      bt) as 64 x 128 tiles (mma_tiles.cuh gemm_64x128_f32, a pass per 128
//      of H); the epilogue keeps a pass's h in shared memory and carries
//      the 6 x H head's sums over the passes in column order: head [N, 8].
//   C env_kernel (act_stages.cuh, shared with K2): 128 threads over 32 / A
//      envs (16 at 6 and 8 agents: env_cta): each row's mask, sample and
//      outputs (act_common.cuh sample_row: gumbel, first max, stable
//      log-softmax), each env's tick with rewards, shaping and deliveries
//      (tick_env), then the next step's observation rows into obs[t + 1]
//      (obs_value). A prologue launch writes obs[0]; the last step stores
//      the final state.
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

#include "act_stages.cuh"
#include "cnn_net.cuh"

namespace {

constexpr int ANT = 256;     // threads of stage A: 8 warps
constexpr int ANW = ANT / 32;
constexpr int RA_MIN = 16;   // samples of a stage-A tile at least (K12's
                             // smallest: the maps K11 refuses stay refused)
constexpr int RA_MAX = 64;
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

// K10's arguments: the env stage's, then the CNN's layout and workspace.
struct ActCnnArgs : ActEnvArgs {
  CnnNet net;
  ConvDims cd;
  int RA;                // samples per stage-A tile
  const float* params;   // the packed vector (cnn_net.cuh), per group
  float* wk;             // [K][HP][KT] the trunk's kernels, zero-padded
  float* a1;             // [N][KT] the trunk's input rows
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

// The workspace: wk [K][HP][KT], a1 [N][KT], head [N][HSTRIDE], envst [B][4 A
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
  w.head = take(B * A * HSTRIDE);
  w.envst = take(B * (4L * A + 6L * R));
  w.total = off;
  return w;
}

// The shape checks of every entry point: a supported net, agents and queue
// of this build (dispatch_shape), K in [0, ACT_MAXK] (0: no groups) with a
// valid map.
bool shape_ok(int A, int R, int S, int C0, int C1, int C2, int H, int K,
              const int* group, CnnNet* net) {
  RowGroups rg;
  return make_cnn_net(S, C0, C1, C2, H, net) && known_shape(A, R) && K >= 0 &&
         make_groups(A, 1, K > 0 ? K : 1, K > 0 ? group : nullptr, RA_MIN,
                     &rg);
}

enum Stage { ST_CONV = 0, ST_TRUNK = 1, ST_ENV = 2, ST_ALL = 3 };

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
  auto env = [&](int t, int mode, float* out) {
    return launch_env(p, R, t, mode, out, stream);
  };
  auto conv = [&](int t) {
    conv_kernel<<<cl.grid, ANT, cl.smem, stream>>>(p, t);
    return cudaGetLastError();
  };
  // The trunk and the head on the shared head stage: group g's kernel, bias
  // and head in its packed vector.
  const CnnNet& net = p.net;
  const HeadStage hs = {p.a1, p.cd.KT, p.wk, (long)p.cd.HP * p.cd.KT, net.H,
                        p.cd.HP, p.params + net.bt, net.n_params,
                        p.params + net.head_w, net.n_params,
                        p.params + net.head_b, net.n_params, p.head};
  auto trunk = [&]() { return launch_head(hs, p.rg, stream); };
  if ((e = opt_in(head_kernel, smem_head())) != cudaSuccess) return e;
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
  const size_t a = smem_a(conv_dims(net), RA_MIN), b = smem_head();
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
  set_env_args(p, B, T, A, H, W, spawn_prob, S, k, D, global_obs, inv_h,
               inv_w, step_penalty, pickup_reward, delivery_reward,
               collision_penalty, walls, pos, areq, carry, rpick, rdrop, rstat,
               ragent, u, pick, drop, gumbel, o_pos, o_areq, o_carry, o_rpick,
               o_rdrop, o_rstat, o_ragent, obs, action, log_prob, value,
               reward, delivered, logits, mask, table, done, raw_reward,
               shaping_coef, gamma);
  p.params = params;
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
