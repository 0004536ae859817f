// The stage kernels that the acting kernels share: K2 (the MLP policy,
// act.cu), K10 (the CNN policy, act_cnn.cu) and K7 (the recurrent policy,
// act_rnn.cu). Each runs a step as stage kernels on the caller's stream
// over all of the step's N = B A rows (env, agent):
//
// - hidden_kernel (K2's hidden layers but the last, K7's encoder layers):
//   y = tanh(x Bt^T + b) as 64 x 128 tiles (mma_tiles.cuh gemm_64x128_f32:
//   FFMA register blocks, the k-slices through a cp.async ring), bound by
//   the products on the CUDA cores. Replaces the layer loop of
//   warehouse_tpu/pallas/act.py _act_kernel (:375) and the encoder of
//   _act_rnn_kernel (:590). (K7's cell stage, the product after it, runs
//   on the tensor cores as 3xTF32 in act_rnn.cu; this stage stays FFMA, so
//   that K2 keeps its bits.)
// - head_kernel: the policy's last tanh layer and its fused 6-wide head,
//   h = tanh(x Wt^T + bt) as 64 x 128 tiles (mma_tiles.cuh
//   gemm_64x128_f32, a pass per 128 of H); the epilogue keeps a pass's h in
//   shared memory and carries the head's sums over the passes in column
//   order: head [N, 8]. K10's trunk, K2's last hidden layer.
// - env_kernel: 128 threads over env_cta(A) envs: each row's mask, sample
//   and outputs (act_common.cuh sample_row: gumbel, first max, stable
//   log-softmax), each env's tick with rewards, shaping and deliveries
//   (tick_env), then, for K10, the next step's observation rows
//   (obs_value). A prologue launch writes obs[0]; the last step stores the
//   final state. The env states live in device memory (envst) from one
//   step to the next.
// - obs_kernel (K2, K7): the next step's observation rows from envst, into
//   the obs output and into a zero-padded copy in row order that the first
//   layer's tile GEMM reads, over light CTAs of 4 envs (the env stage's
//   few thin CTAs take 10.6 ms a chunk over the D = 611 rows of the
//   shelves global recipe when they build them; PERF.md §6).
//
// The rows are group-major: group 0's (env, agent) pairs env by env, then
// group 1's, and so on (without groups: b A + a, env-major). A tile of a
// GEMM stage holds one group's rows and runs on that group's weights; the
// env stage finds a pair's head row from the group tables (RowGroups).
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine (act_common.cuh, env_tick.cuh); each sum of the
// head stage is a float32 FMA chain in k order from 0, whatever the tiles,
// then + b, with no atomics, so a rerun gives the same bits.
#pragma once

#include <cuda_runtime.h>

#include "act_common.cuh"
#include "env_tick.cuh"
#include "mma_tiles.cuh"
#include "pad_jobs.cuh"

namespace {

// Agents of an env the row tables hold: the presets' most, 8, in the
// library's build; a pair's build (env_tick.cuh dispatch_shape) holds its
// own A when that is more. Policy groups: as many as agents.
#ifdef WH_PAIR_A
constexpr int ACT_MAXA = WH_PAIR_A > 8 ? WH_PAIR_A : 8;
#else
constexpr int ACT_MAXA = 8;
#endif
constexpr int ACT_MAXK = ACT_MAXA;
constexpr int CNT = 128;     // threads of the env stage

// Envs of an env-stage CTA. One thread ticks each env, serially, and the
// tick of 6 or 8 agents holds 167-255 registers a thread, so few CTAs fit an
// SM: 16 envs a CTA then tick in one wave at B = 4096 where 32 / A would
// take three or four. At 2 and 4 agents 32 rows a CTA (the observation
// rows' work spread over more CTAs). Past 8 agents, as many envs as leave a
// thread for each of their rows (the sample runs a thread a row): 10 at 12
// agents. More than CNT agents are refused (0 envs).
__host__ __device__ constexpr int env_cta(int A) {
  return A <= 4 ? 32 / A : (A <= 8 ? 16 : CNT / A);
}

__host__ __device__ inline int round_up(long x, int m) {
  return (int)((x + m - 1) / m * m);
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The rows' order: group g's (env, agent) pairs are rows first[g] ..
// first[g + 1] - 1, env by env, each env's in agent order. Without groups,
// one group of all agents: row b A + a.
struct RowGroups {
  int K;                          // groups (1 without groups)
  int group[ACT_MAXA];            // agent -> group
  int n[ACT_MAXK];                // agents of each group
  int rank[ACT_MAXA];             // an agent's place in its group
  int agent[ACT_MAXK][ACT_MAXA];  // each group's agents in order
  long first[ACT_MAXK + 1];       // each group's first row
  long tile_a[ACT_MAXK + 1];      // each group's first K10 stage-A tile
  long tile_b[ACT_MAXK + 1];      // its first BM-row tile

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
  // A BM-row tile's group, first row and rows.
  __device__ int bm_tile(long tile, long* q0, int* nvalid) const {
    const int g = group_of(tile, tile_b);
    *q0 = first[g] + (tile - tile_b[g]) * BM;
    *nvalid = (int)(first[g + 1] - *q0 < BM ? first[g + 1] - *q0 : BM);
    return g;
  }
};

// False for a map with a group id out of [0, K), K out of [1, ACT_MAXK] or
// more than ACT_MAXA agents. `ra`:
// the samples of a K10 stage-A tile (0: no such tiles).
inline bool make_groups(int A, long B, int K, const int* group, int ra,
                        RowGroups* rg) {
  if (K < 1 || K > ACT_MAXK || A > ACT_MAXA) return false;
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

// What the env stage reads and writes: the env, its draws and outputs, the
// options, and the step rows' group tables, head rows and env states. The
// kernels' argument structs extend it.
struct ActEnvArgs {
  long B;
  int T, A;
  wh::Geometry geo;
  int S, k, D;         // window side, radius, obs dim
  int gobs;            // the global observation instead of the ego window
  float inv_h, inv_w;  // float32 reciprocals of H and W
  float step_penalty, pickup_reward, delivery_reward, collision_penalty;
  RowGroups rg;
  float* head;           // [N][HSTRIDE] the head's outputs
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

// ---- a tanh layer -----------------------------------------------------------

// y = tanh(x Bt^T + b) on group g's Bt and bias (their bases plus g times
// their group strides): columns < n, zeros in [n, cols); y's rows are ys
// floats apart (K2: ys = cols; K7's last encoder layer writes the e part of
// its [e | h] rows).
struct HiddenStage {
  const float* x;
  int K;  // x's row stride and the columns read: a multiple of BK
  const float* bt;
  long bt_g;
  const float* bias;
  long bias_g;
  float* y;
  int ys, cols, n;
};

// One BM-row tile (blockIdx.x) of one group's rows by BN columns
// (blockIdx.y).
__global__ void __launch_bounds__(GNT) hidden_kernel(HiddenStage s,
                                                     RowGroups rg) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int n0 = blockIdx.y * BN;
  long q0;
  int nvalid;
  const int g = rg.bm_tile(blockIdx.x, &q0, &nvalid);
  const float* bias = s.bias + g * s.bias_g;
  float acc[4][8] = {};
  gemm_64x128_f32(acc, s.x + q0 * s.K, s.K, nvalid,
                  s.bt + g * s.bt_g + (long)n0 * s.K, s.K, s.K, smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = tr + 16 * i, col = n0 + tc + 16 * j;
      if (row >= nvalid || col >= s.cols) continue;
      s.y[(q0 + row) * s.ys + col] =
          col < s.n ? tanhf(acc[i][j] + __ldg(bias + col)) : 0.f;
    }
}

size_t smem_hidden() { return sizeof(float) * 2 * (BM + BN) * ldt<false>(); }

// ---- the last tanh layer and the head ---------------------------------------

// Group g's operands at their base plus g times their group stride.
struct HeadStage {
  const float* x;  // [N][K] the layer's input rows, zero past its width
  int K;           // a multiple of BK
  const float* wk;  // [HP][K] the layer's kernel, zero-padded
  long wk_g;
  int H, HP;        // the layer's width, rounded up to BN
  const float* bias;  // [H]
  long bias_g;
  const float* hw;  // [6][H] the head's kernel: 5 logits, the value
  long hw_g;
  const float* hb;  // [6]
  long hb_g;
  float* head;  // [N][HSTRIDE]
};

size_t smem_head() {
  return sizeof(float) * (2 * (BM + BN) * ldt<false>() + BM * (BN + 4) +
                          BM * HSTRIDE);
}

// One BM-row tile (blockIdx.x) of one group's rows.
__global__ void __launch_bounds__(GNT) head_kernel(HeadStage s,
                                                   RowGroups rg) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HBS = BN + 4;
  const int H = s.H, K = s.K;
  float* ring = smem;
  float* hb = ring + 2 * (BM + BN) * ldt<false>();  // [BM][HBS] a pass's h
  float* hsum = hb + BM * HBS;                      // [BM][HSTRIDE] sums
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  long q0;
  int nvalid;
  const int g = rg.bm_tile(blockIdx.x, &q0, &nvalid);
  const float* wk = s.wk + g * s.wk_g;
  const float* bias = s.bias + g * s.bias_g;
  const float* hw = s.hw + g * s.hw_g;
  for (int i = tid; i < BM * HSTRIDE; i += GNT) hsum[i] = 0.f;
  for (int n0 = 0; n0 < s.HP; n0 += BN) {
    float acc[4][8] = {};
    gemm_64x128_f32(acc, s.x + q0 * K, K, nvalid, wk + (long)n0 * K, K, K,
                    ring);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tc + 16 * j;
        hb[(tr + 16 * i) * HBS + tc + 16 * j] =
            col < H ? tanhf(acc[i][j] + __ldg(bias + col)) : 0.f;
      }
    __syncthreads();
    // The head's sums carried over the passes, each in column order. The
    // next pass's GEMM synchronises before anything writes hb again.
    const int w = H - n0 < BN ? H - n0 : BN;
    for (int it = tid; it < BM * NHEAD; it += GNT) {
      const int n = it / NHEAD, o = it % NHEAD;
      const float* wo = hw + (long)o * H + n0;
      float sum = hsum[n * HSTRIDE + o];
      for (int k = 0; k < w; ++k)
        sum = fmaf(hb[n * HBS + k], __ldg(wo + k), sum);
      hsum[n * HSTRIDE + o] = sum;
    }
  }
  __syncthreads();
  const float* hbias = s.hb + g * s.hb_g;
  for (int i = tid; i < nvalid * HSTRIDE; i += GNT) {
    const int n = i / HSTRIDE, o = i % HSTRIDE;
    s.head[(q0 + n) * HSTRIDE + o] =
        o < NHEAD ? hsum[n * HSTRIDE + o] + __ldg(hbias + o) : 0.f;
  }
}

cudaError_t launch_head(const HeadStage& s, const RowGroups& rg,
                        cudaStream_t stream) {
  head_kernel<<<(unsigned)rg.tile_b[rg.K], GNT, smem_head(), stream>>>(s, rg);
  return cudaGetLastError();
}

// ---- sample, tick, observe --------------------------------------------------

enum { FROM_INPUT = 1, TO_OUTPUT = 2, KEEP_STATE = 4 };

// env_cta(A) envs a CTA: their states from the inputs (FROM_INPUT) or
// envst; at t >= 0 each row's sample from its head row and each env's tick
// at step t; the observation rows of the ticked states into obs_out (when
// set, [B, A, D]); the states to the outputs (TO_OUTPUT) or envst, to both
// with KEEP_STATE.
template <int A, int R>
__global__ void __launch_bounds__(CNT) env_kernel(ActEnvArgs p, int t,
                                                  int mode, float* obs_out) {
  using ES = EnvSmem<A, R>;
  constexpr int NE = env_cta(A);
  static_assert(NE >= 1 && NE * A <= CNT, "a thread samples each row");
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
    // Mask, sample, log-softmax, one thread per (env, agent).
    if (tid < ne * A) {
      const long b = b0 + tid / A;
      const int a = tid % A;
      act_s[tid] = sample_row<A>(p, p.head + p.rg.row_of(b, a) * HSTRIDE,
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
  }
  if (!(mode & TO_OUTPUT) || (mode & KEEP_STATE)) {
    for (int i = tid; i < ne * ES::SIZE; i += CNT)
      p.envst[b0 * ES::SIZE + i] = env_s[i];
  }
}

// ---- the observation rows, apart from the tick ------------------------------

constexpr int ONT = 256;     // threads of the observation stage: 8 warps
constexpr int OBS_ENVS = 4;  // envs of an observation-stage CTA

// The observation rows of the states in envst, a warp a row: into obs_out
// (when set, [B, A, D]) and rows_out ([N, ldr] in row order, zeros past
// D). A lane takes a grid cell's channels at once (act_common.cuh
// obs_cell), then lanes 0-5 the self features. The env stage's CTAs are
// few and thin (one thread ticks each env, serially, at up to 255
// registers); here every SM holds many light CTAs, which the global view's
// D = 411 / 611 / 1131 rows need.
template <int A, int R>
__global__ void __launch_bounds__(ONT) obs_kernel(ActEnvArgs p,
                                                  float* obs_out,
                                                  float* rows_out, int ldr) {
  using ES = EnvSmem<A, R>;
  __shared__ int env_s[OBS_ENVS * ES::SIZE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long b0 = (long)blockIdx.x * OBS_ENVS;
  const int ne = (int)(p.B - b0 < OBS_ENVS ? p.B - b0 : OBS_ENVS);
  for (int i = tid; i < ne * ES::SIZE; i += ONT)
    env_s[i] = p.envst[b0 * ES::SIZE + i];
  __syncthreads();
  const int D = p.D, C = p.gobs ? 5 : 4;
  const int cells = p.gobs ? p.geo.H * p.geo.W : p.S * p.S;
  for (int r = warp; r < ne * A; r += ONT / 32) {
    const int a = r % A;
    const long b = b0 + r / A;
    const int* s = env_s + (r / A) * ES::SIZE;
    float* row = rows_out + p.rg.row_of(b, a) * ldr;
    float* ob = obs_out ? obs_out + (b * A + a) * D : nullptr;
    for (int cell = lane; cell < cells; cell += 32) {
      float v[5];
      obs_cell<A, R>(s, a, cell, p, v);
      for (int ch = 0; ch < C; ++ch) {
        if (ob) ob[cell * C + ch] = v[ch];
        row[cell * C + ch] = v[ch];
      }
    }
    for (int f = cells * C + lane; f < ldr; f += 32) {
      const float v = f < D ? obs_value<A, R>(s, a, f, p) : 0.f;
      if (ob && f < D) ob[f] = v;
      row[f] = v;
    }
  }
}

template <int A, int R>
struct ObsLaunch {
  static void run(const ActEnvArgs& p, float* obs_out, float* rows_out,
                  int ldr, cudaStream_t stream, int* err) {
    const unsigned blocks = (unsigned)((p.B + OBS_ENVS - 1) / OBS_ENVS);
    obs_kernel<A, R><<<blocks, ONT, 0, stream>>>(p, obs_out, rows_out, ldr);
    *err = (int)cudaGetLastError();
  }
};

cudaError_t launch_obs(const ActEnvArgs& p, int R, float* obs_out,
                       float* rows_out, int ldr, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  wh::dispatch_shape<ObsLaunch>(p.A, R, p, obs_out, rows_out, ldr, stream,
                                &err);
  return (cudaError_t)err;
}

template <int A, int R>
struct EnvLaunch {
  static void run(const ActEnvArgs& p, int t, int mode, float* obs_out,
                  cudaStream_t stream, int* err) {
    constexpr int NE = env_cta(A);
    const unsigned blocks = (unsigned)((p.B + NE - 1) / NE);
    env_kernel<A, R><<<blocks, CNT, 0, stream>>>(p, t, mode, obs_out);
    *err = (int)cudaGetLastError();
  }
};

cudaError_t launch_env(const ActEnvArgs& p, int R, int t, int mode,
                       float* obs_out, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  wh::dispatch_shape<EnvLaunch>(p.A, R, p, t, mode, obs_out, stream, &err);
  return (cudaError_t)err;
}

template <int A, int R>
struct KnownShape {
  static void run(int* ok) { *ok = 1; }
};

// Whether the env kernels are built for (A, R).
inline bool known_shape(int A, int R) {
  int known = 0;
  return wh::dispatch_shape<KnownShape>(A, R, &known) && known;
}

// The env stage's arguments from the C entry points' common ones.
void set_env_args(ActEnvArgs& p, long B, int T, int A, int H, int W,
                  float spawn_prob, int S, int k, int D, int global_obs,
                  float inv_h, float inv_w, float step_penalty,
                  float pickup_reward, float delivery_reward,
                  float collision_penalty, const unsigned char* walls,
                  const int* pos, const int* areq, const int* carry,
                  const int* rpick, const int* rdrop, const int* rstat,
                  const int* ragent, const float* u, const int* pick,
                  const int* drop, const float* gumbel, int* o_pos,
                  int* o_areq, int* o_carry, int* o_rpick, int* o_rdrop,
                  int* o_rstat, int* o_ragent, float* obs, int* action,
                  float* log_prob, float* value, float* reward,
                  int* delivered, float* logits, unsigned char* mask,
                  const int* table, const float* done, float* raw_reward,
                  float shaping_coef, float gamma) {
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
}

}  // namespace
