// K10: the PPO acting phase of the CNN policy, T steps in one launch.
//
// Replaces the CNN arm of warehouse_tpu/pallas/act.py ppo_rollout_pallas
// (:1028 with arch="cnn": extract_cnn_weights :942, the layer loop of
// _act_kernel :365-389 with n_relu / cnn_split, _obs_rows :138,
// _sample_logprob :491 and the env tick of rollout.py:57), with its
// action-masking, its potential-shaping (act_common.cuh tick_env), its
// global-observation option (act_common.cuh obs_value: the grid is then the
// whole map, S = the grid's side, 5 channels) and its policy groups
// (:1062-1076, the trace-time selection of _act_kernel :336-338, :409). Each
// step, for every env of the CTA: build the observation of each
// agent, run the two 3x3 SAME convolutions (relu) over its grid, join the
// self features, run the tanh trunk and the fused logits + value head, with
// masking floor the logits of invalid moves, sample argmax(logits + gumbel)
// with the first-max tie rule, take the log-softmax of the chosen action,
// tick the env.
//
// Layout: a CTA owns NE whole envs (the tick needs all A agents of an env),
// NE * A <= 32 rows of (env, agent), as many as fit its shared memory (8
// envs of 4 agents on the 5 x 5 window, 2 on the 9 x 9 global view:
// cnn_act_envs). Its rows' observations, both conv
// outputs, the trunk's output and the env states stay in shared memory (~186
// KB at S = 5, hidden 128) beside the two conv kernels (~25 KB); the trunk's
// kernel does not fit with them (413 KB) and is read from device memory
// through L2 each step, transposed once per launch (cnn_net.cuh). Device
// memory sees the draws, the gumbel noise and the outputs. The convolution
// is computed over its valid taps, not as the TPU kernel's unrolled dense
// product. The bound is the FMA loops on the CUDA cores (about 403 kFLOP
// per row and step at S = 5, channels 4 -> 16 -> 32, hidden 128).
//
// Policy groups (the GROUPED instance): K CNNs of the same widths, their
// packed vectors one after another in group order, and a static agent ->
// group map; each row runs its agent's group's convolutions, trunk and head
// only. A register tile of the conv and trunk loops applies one weight to
// RRT = 8 rows, so every tile must be one group's. Each step runs one pass
// per group: stage that group's conv kernels, build the observations of its
// (env, agent) pairs alone, env by env, padded with zero rows to a multiple
// of 8 (a pad row is never read), run the convolutions, the trunk (its own
// transposed copy) and the head over them, and copy each pair's head row
// into a buffer of all the CTA's pairs, which the sample reads env-major as
// without groups. Shared memory then holds one group's conv kernels and one
// pass's rows, whatever K is, so a CTA keeps as many envs as make a pass of
// at most CROWS rows (cnn_act_envs_grouped): 32 envs with one policy per
// agent, 16 on config 4 with two groups, 4 on the 9 x 9 global view with
// two. The restaging costs one group's ~25 KB from L2 per pass. Each row's
// arithmetic is the same as without groups. Without groups the kernel keeps
// its env-major rows and its code.
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine (act_common.cuh, env_tick.cuh, shared with K2 and
// K7); the policy outputs are held to a float32 tolerance.

#include <cuda_runtime.h>

#include "act_common.cuh"
#include "cnn_net.cuh"
#include "env_tick.cuh"

namespace {

// Bytes of one env's state and its agents' sampled actions in shared memory.
template <int A, int R>
constexpr size_t env_smem_bytes() {
  return sizeof(int) * (EnvSmem<A, R>::SIZE + A);
}

// Envs per CTA: the most whose NE * A rows are a multiple of RRT, at most
// CROWS, and fit the device's shared memory; 0 when none does.
template <int A, int R>
int cnn_act_envs(const CnnNet& net) {
  const size_t limit = smem_optin_limit();
  for (int ne = CROWS / A; ne > 0; --ne) {
    const size_t bytes =
        sizeof(float) * ((size_t)conv_smem_floats(net) +
                         (size_t)ne * A * cnn_row_floats(net)) +
        ne * env_smem_bytes<A, R>();
    if (ne * A % RRT == 0 && bytes <= limit) return ne;
  }
  return 0;
}

constexpr int CNN_MAXK = 8;  // policy groups
constexpr int CNN_MAXA = 8;  // agents of a grouped env

// Rows of a grouped CTA's largest pass at `ne` envs: a group's ne n_g
// (env, agent) pairs padded to a multiple of RRT.
inline int pass_rows(int ne, int K, const int* n_g) {
  int rows = 0;
  for (int g = 0; g < K; ++g) {
    const int r = (ne * n_g[g] + RRT - 1) / RRT * RRT;
    if (r > rows) rows = r;
  }
  return rows;
}

// Shared memory of a grouped CTA of `ne` envs whose largest pass has `rows`
// rows: one group's conv kernels, the pass's row buffers, every pair's head
// row, the env states and the pass map.
template <int A, int R>
size_t act_cnn_grouped_smem(const CnnNet& net, int ne, int rows) {
  return sizeof(float) * ((size_t)conv_smem_floats(net) +
                          (size_t)rows * cnn_row_floats(net) +
                          (size_t)ne * A * ROST) +
         ne * env_smem_bytes<A, R>() + sizeof(int) * (ne * A + CNN_MAXK + 1);
}

// Envs per grouped CTA: the most whose largest pass is at most CROWS rows
// and that fit the device's shared memory; 0 when none does.
template <int A, int R>
int cnn_act_envs_grouped(const CnnNet& net, int K, const int* n_g) {
  const size_t limit = smem_optin_limit();
  for (int ne = CROWS; ne > 0; --ne) {
    const int rows = pass_rows(ne, K, n_g);
    if (rows <= CROWS && act_cnn_grouped_smem<A, R>(net, ne, rows) <= limit)
      return ne;
  }
  return 0;
}

struct ActCnnArgs {
  long B;
  int T;
  wh::Geometry geo;
  int S, k, D;         // window side, radius, obs dim
  int gobs;            // the global observation instead of the ego window
  int ne;              // envs per CTA
  int rows;            // rows of the grouped instance's largest pass
  int n_groups;        // K policy groups (the grouped instance)
  int group[CNN_MAXA];  // agent -> group
  float inv_h, inv_w;  // float32 reciprocals of H and W
  float step_penalty, pickup_reward, delivery_reward, collision_penalty;
  CnnNet net;
  const float* params;   // the packed vector (cnn_net.cuh), per group
  const float* trunk_t;  // its trunk kernel transposed, per group
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

template <int A, int R, bool GROUPED>
__global__ void __launch_bounds__(RNT) act_cnn_kernel(ActCnnArgs p) {
  const int NE = p.ne, ROWS = GROUPED ? p.rows : NE * A;
  using ES = EnvSmem<A, R>;
  extern __shared__ __align__(16) float smem[];
  const CnnNet& net = p.net;
  ConvW cw;  // grouped: staged by each pass
  if (!GROUPED) cw = stage_conv(net, p.params, smem);
  float* xa = smem + conv_smem_floats(net);
  float* a0 = xa + ROWS * net.xs;
  float* a1 = a0 + ROWS * net.a0s;
  float* hs = a1 + ROWS * net.a1s;
  float* head = hs + ROWS * net.H;
  // The grouped instance: every pair's head row [NE A, ROST]; after the
  // actions, the pass map: group 0's pairs e A + a env by env, then group
  // 1's, ...; group g's are gpair[gfirst[g]] .. gpair[gfirst[g + 1] - 1].
  float* phead = head + ROWS * ROST;
  int* env_s = reinterpret_cast<int*>(phead + (GROUPED ? NE * A * ROST : 0));
  int* act_s = env_s + NE * ES::SIZE;
  int* gpair = act_s + NE * A;
  int* gfirst = gpair + NE * A;

  const int tid = threadIdx.x;
  const long b0 = (long)blockIdx.x * NE;
  const int ne = (int)min((long)NE, p.B - b0);

  if (tid < NE) {
    wh::Env<A, R> e = {};  // rows past the batch end compute on zeros
    if (tid < ne)
      wh::load_env(e, b0 + tid, p.pos, p.areq, p.carry, p.rpick, p.rdrop,
                   p.rstat, p.ragent);
    ES::put(e, env_s + tid * ES::SIZE);
  }
  if (GROUPED && tid == 0) {
    int n = 0;
    for (int g = 0; g < p.n_groups; ++g) {
      gfirst[g] = n;
      for (int e = 0; e < NE; ++e)
#pragma unroll
        for (int a = 0; a < A; ++a)
          if (p.group[a] == g) gpair[n++] = e * A + a;
    }
    gfirst[p.n_groups] = n;
  }
  for (int idx = tid; idx < ROWS * net.xs; idx += RNT) xa[idx] = 0.f;
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const long tb = (long)t * p.B + b0;  // first (t, b) of the CTA
    if (GROUPED) {
      // 1-2. One pass per group: its conv kernels, its pairs' observations
      // (zero pad rows), convolutions, trunk, head, each pair's head row out.
      for (int g = 0; g < p.n_groups; ++g) {
        const int* pairs = gpair + gfirst[g];
        const int n = gfirst[g + 1] - gfirst[g];
        const int rows = (n + RRT - 1) / RRT * RRT;
        const float* pg = p.params + g * net.n_params;
        const ConvW cg = stage_conv(net, pg, smem);
        for (int idx = tid; idx < rows * p.D; idx += RNT) {
          const int r = idx / p.D, f = idx % p.D;
          float v = 0.f;
          if (r < n) {
            const int pr = pairs[r];
            v = obs_value<A, R>(env_s + (pr / A) * ES::SIZE, pr % A, f, p);
            if (pr / A < ne) p.obs[(tb * A + pr) * p.D + f] = v;
          }
          xa[r * net.xs + obs_slot(net, f)] = v;
        }
        __syncthreads();
        conv_forward(net, cg, xa, a0, a1, rows);
        trunk_forward(net, p.trunk_t + g * (long)net.H * net.trunk_in,
                      pg + net.bt, a1, hs, rows, nullptr, 0, 0);
        __syncthreads();
        cnn_head(net, pg, hs, head, rows);
        __syncthreads();
        // The next pass restages what this one's loops have finished with.
        for (int i = tid; i < n * RHEAD; i += RNT)
          phead[pairs[i / RHEAD] * ROST + i % RHEAD] =
              head[i / RHEAD * ROST + i % RHEAD];
      }
      __syncthreads();
    } else {
      // 1. Observations of the CTA's rows: row n = (env n / A, agent n % A).
      for (int idx = tid; idx < ROWS * p.D; idx += RNT) {
        const int n = idx / p.D, f = idx % p.D;
        const float v =
            obs_value<A, R>(env_s + (n / A) * ES::SIZE, n % A, f, p);
        xa[n * net.xs + obs_slot(net, f)] = v;
        if (n / A < ne) p.obs[tb * A * p.D + idx] = v;
      }
      __syncthreads();

      // 2. Convolutions, trunk, fused head.
      conv_forward(net, cw, xa, a0, a1, ROWS);
      trunk_forward(net, p.trunk_t, p.params + net.bt, a1, hs, ROWS, nullptr,
                    0, 0);
      __syncthreads();
      cnn_head(net, p.params, hs, head, ROWS);
      __syncthreads();
    }

    // 3. Mask, sample, log-softmax (as K2), one thread per (env, agent).
    if (tid < NE * A)
      act_s[tid] = sample_row<A>(p, (GROUPED ? phead : head) + tid * ROST,
                                 env_s + (tid / A) * ES::SIZE, tid,
                                 tid / A < ne, t, b0);
    __syncthreads();

    // 4. Env tick and rewards, one thread per env.
    if (tid < ne)
      tick_env<A, R>(p, env_s + tid * ES::SIZE, act_s + tid * A, tb + tid);
    __syncthreads();
  }

  if (tid < ne) {
    wh::Env<A, R> e;
    ES::get(env_s + tid * ES::SIZE, e);
    wh::store_env(e, b0 + tid, p.o_pos, p.o_areq, p.o_carry, p.o_rpick,
                  p.o_rdrop, p.o_rstat, p.o_ragent);
  }
}

// Shared memory of a CTA of `ne` envs; of one env when not even one fits
// (ne = 0), so that the caller's comparison with the limit fails.
template <int A, int R>
size_t act_cnn_smem(const CnnNet& net, int ne) {
  if (ne < 1) ne = 1;
  return sizeof(float) * ((size_t)conv_smem_floats(net) +
                          (size_t)ne * A * cnn_row_floats(net)) +
         ne * env_smem_bytes<A, R>();
}

// Agents per group of the map, or false for a map with a group id out of
// [0, K).
inline bool group_sizes(int A, int K, const int* group, int* n_g) {
  if (K < 1 || K > CNN_MAXK || A > CNN_MAXA) return false;
  for (int g = 0; g < K; ++g) n_g[g] = 0;
  for (int a = 0; a < A; ++a) {
    if (group[a] < 0 || group[a] >= K) return false;
    ++n_g[group[a]];
  }
  return true;
}

// Shared memory one CTA needs; K > 0 asks for the grouped instance.
template <int A, int R>
struct CnnSmemBytes {
  static void run(const CnnNet& net, int K, const int* group, size_t* out) {
    if (K == 0) {
      *out = act_cnn_smem<A, R>(net, cnn_act_envs<A, R>(net));
      return;
    }
    int n_g[CNN_MAXK];
    if (!group_sizes(A, K, group, n_g)) {
      *out = 0;
      return;
    }
    const int ne = cnn_act_envs_grouped<A, R>(net, K, n_g);
    // Of one env when not even one fits, so that the caller's comparison
    // with the limit fails.
    const int n = ne < 1 ? 1 : ne;
    *out = act_cnn_grouped_smem<A, R>(net, n, pass_rows(n, K, n_g));
  }
};

template <int A, int R>
struct LaunchActCnn {
  template <bool GROUPED>
  static void launch(ActCnnArgs& p, size_t smem, cudaStream_t stream,
                     int* err) {
    cudaError_t e = cudaFuncSetAttribute(
        act_cnn_kernel<A, R, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      *err = (int)e;
      return;
    }
    const unsigned blocks = (unsigned)((p.B + p.ne - 1) / p.ne);
    act_cnn_kernel<A, R, GROUPED><<<blocks, RNT, smem, stream>>>(p);
    *err = (int)cudaGetLastError();
  }

  static void run(ActCnnArgs& p, cudaStream_t stream, int* err) {
    if (p.n_groups == 0) {
      const int NE = p.ne = cnn_act_envs<A, R>(p.net);
      if (NE < 1) {
        *err = (int)cudaErrorInvalidValue;
        return;
      }
      launch<false>(p, act_cnn_smem<A, R>(p.net, NE), stream, err);
      return;
    }
    int n_g[CNN_MAXK];
    if (!group_sizes(A, p.n_groups, p.group, n_g) ||
        (p.ne = cnn_act_envs_grouped<A, R>(p.net, p.n_groups, n_g)) < 1) {
      *err = (int)cudaErrorInvalidValue;
      return;
    }
    p.rows = pass_rows(p.ne, p.n_groups, n_g);
    launch<true>(p, act_cnn_grouped_smem<A, R>(p.net, p.ne, p.rows), stream,
                 err);
  }
};

}  // namespace

// Floats of the packed parameter vector, or 0 for unsupported widths.
extern "C" long wh_cnn_param_floats(int S, int C0, int C1, int C2, int H) {
  CnnNet net;
  return make_cnn_net(S, C0, C1, C2, H, &net) ? net.n_params : 0;
}

// Shared memory one CTA needs, in bytes (more than the device allows when
// not one env's rows fit, or no whole number of envs makes a multiple of 8
// rows; grouped, when not one env's largest pass fits beside one group's
// conv kernels), or 0 for an unsupported shape. K = 0: without groups;
// else `group` maps each of the A agents to a group in [0, K).
extern "C" long wh_act_cnn_smem_bytes(int A, int R, int S, int C0, int C1,
                                      int C2, int H, int K,
                                      const int* group) {
  CnnNet net;
  if (!make_cnn_net(S, C0, C1, C2, H, &net)) return 0;
  size_t out = 0;
  if (!wh::dispatch_shape<CnnSmemBytes>(A, R, net, K, group, &out)) return 0;
  return (long)out;
}

// `trunk_t` is scratch of the trunk kernel's size, H * (S * S * C2 + 6),
// per group. K = 0: one policy; else `params` holds K packed vectors in
// group order and `group` maps each agent to one of them.
extern "C" int wh_act_cnn_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int C0, int C1, int C2, int hidden, int K,
    const int* group, const unsigned char* walls,
    const float* params, float* trunk_t, const int* pos, const int* areq,
    const int* carry, const int* rpick, const int* rdrop, const int* rstat,
    const int* ragent, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* obs,
    int* action, float* log_prob, float* value, float* reward,
    int* delivered, float* logits, unsigned char* mask, const int* table,
    const float* done, float* raw_reward, float shaping_coef, float gamma,
    void* stream_) {
  ActCnnArgs p = {};
  if (!make_cnn_net(S, C0, C1, C2, hidden, &p.net) || p.net.D != D)
    return (int)cudaErrorInvalidValue;
  if (K < 0 || K > CNN_MAXK || (K > 0 && A > CNN_MAXA))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_;
  p.n_groups = K;
  for (int a = 0; K > 0 && a < A; ++a) p.group[a] = group[a];
  p.B = B;
  p.T = T;
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
  p.trunk_t = trunk_t;
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
  const long n_trunk = (long)p.net.H * p.net.trunk_in;
  for (int g = 0; g < (K > 0 ? K : 1); ++g) {
    cudaError_t e = launch_trunk_transpose(
        p.net, params + g * p.net.n_params, trunk_t + g * n_trunk, stream);
    if (e != cudaSuccess) return (int)e;
  }
  int err = (int)cudaSuccess;
  if (!wh::dispatch_shape<LaunchActCnn>(A, R, p, stream, &err))
    return (int)cudaErrorInvalidValue;
  return err;
}
