// K2: the PPO acting phase of the MLP policy, T steps in one launch.
//
// Replaces warehouse_tpu/pallas/act.py ppo_rollout_pallas (:1028; body
// _act_kernel :299 with _obs_rows :138, _sample_logprob :491 and the env
// tick of rollout.py:57), MLP arm with its action-masking, its
// potential-shaping (act_common.cuh tick_env) and its global-observation
// option (_obs_rows_global :193; act_common.cuh obs_value) and its policy-
// groups option (:1062-1072). Each step, for every env of the
// CTA: build the observation of each agent, run the MLP (tanh
// hidden layers, fused logits + value head), with masking floor the
// logits of moves off the grid or into a wall to -1e9 (pallas/act.py:
// 415-428; the mask, ops/move.py valid_action_mask of the pre-tick
// positions, is written out), sample argmax(logits + gumbel) with the
// first-max tie rule, take the log-softmax of the chosen action, tick the
// env.
//
// Layout: a CTA owns NE envs (NE * A <= 64 rows of (env, agent)). The
// packed weights (~124 KB for 106 -> 128 -> 128 -> 6 in f32) are staged in
// shared memory once per launch and reused for all T steps and rows; the
// activations of the CTA's rows ping-pong between two shared buffers and
// the env states sit in shared memory too, so device memory sees only the
// draws, the gumbel noise and the outputs. The dense layers are FMA loops
// on the CUDA cores: a thread owns one output column for a tile of RT
// rows, reading its weight column with consecutive-address loads and the
// rows as shared-memory broadcasts. The bound is those shared-memory
// loads and FMAs (about 61 kFLOP per row and step at hidden 128 x 2).
//
// That staged route holds every weight and two [rows, widest layer] buffers
// in one CTA's shared memory, which a wide first layer outgrows: the global
// observation is 5 H W + 6 wide (611 on the 11 x 11 grid: 313 KB of first
// layer alone), and so does a 256-wide hidden layer. When the staged route
// does not fit the card's shared memory the wide route runs (same template,
// WIDE): no weight is staged, every layer reads its W [in, out] from device
// memory (dense_l2.cuh, shared with the MLP learners), and the first layer
// runs over chunks of XCH observation features. obs_value is a
// pure function of the env state and the feature index, so only [rows, XCH]
// of the observation is ever staged and no observation is too wide; each
// chunk is written to the obs output as it is made. The partial sums sit in
// the first hidden buffer between chunks, so the sum runs over the features
// in their order, as on the staged route. The route is picked from the
// shapes and the device's limit alone (route_for).
//
// Policy groups: K MLPs of the same widths, packed one after another in
// group order, and a static agent -> group map; each row runs its agent's
// group's forward only, as the TPU kernel's trace-time selection does. A
// register tile loads one weight and applies it to its rows, so every tile
// must be one group's: with groups a CTA orders its rows agent-major (row n
// = agent n / NE, env n % NE) and a tile holds TR rows of one agent (TR = NE
// = 8 where a CTA holds 8 envs, 6 and 8 agents). Each tile offsets its
// weights by its group's. Groups always take the wide route: two groups at
// hidden 128 (248 KB) could not be staged anyway. The sums per row run in
// the same order as without groups.
//
// Exactness: the observation features (int -> float times the f32
// reciprocal) and the per-agent rewards use __fmul_rn/__fadd_rn in the
// order of ops/obs.py:54-59 and engine.py:130-135, so they match the
// plain path bit for bit. The MLP may use FMA and is held to a tolerance.

#include <cuda_runtime.h>

#include "act_common.cuh"
#include "dense_l2.cuh"
#include "device_limits.cuh"
#include "env_tick.cuh"

namespace {

constexpr int NT = 256;    // threads per CTA
constexpr int RT = 16;     // rows per register tile in the dense layers
constexpr int MAXL = 4;    // hidden layers
constexpr int MAXK = 8;    // policy groups

// Envs per CTA: NE * A rows, a multiple of RT, at most 64.
template <int A>
__host__ __device__ constexpr int envs_per_cta() { return A == 6 ? 8 : 64 / A; }

// The CTA's rows: env-major (row n = env n / A, agent n % A) or, with policy
// groups, agent-major (agent n / NE, env n % NE), tiles of TR rows then one
// agent's (NE is a multiple of 8 for every A).
template <int A, bool GROUPED>
struct RowMap {
  static constexpr int NE = envs_per_cta<A>();
  static constexpr int TR = GROUPED && NE < RT ? NE : RT;
  static __device__ int env(int n) { return GROUPED ? n % NE : n / A; }
  static __device__ int agent(int n) { return GROUPED ? n / NE : n % A; }
};

struct ActArgs {
  long B;
  int T;
  wh::Geometry geo;
  int S, k, D;         // window side, radius, obs dim
  int gobs;            // the global observation instead of the ego window
  float inv_h, inv_w;  // float32 reciprocals of H and W
  float step_penalty, pickup_reward, delivery_reward, collision_penalty;
  int n_hidden;
  int dims[MAXL + 1];  // dims[0] = D, then the hidden widths
  int dmax;            // row stride of the staged route's buffers
  int hmax;            // the widest hidden layer: the wide route's stride
  const float* weights;  // per hidden layer W [in, out] then b [out];
  int n_weights;         // then heads W [H, 6] and b [6]; per group
  int n_groups;          // K policy groups, their weights in group order
  int group[MAXK];       // agent -> group
  const int *pos, *areq, *carry, *rpick, *rdrop, *rstat, *ragent;
  const float* u;
  const int *pick, *drop;
  const float* gumbel;  // [T, 5, B * A]
  int *o_pos, *o_areq, *o_carry, *o_rpick, *o_rdrop, *o_rstat, *o_ragent;
  float* obs;       // [T, B, A, D]
  int* action;      // [T, B, A]
  float *log_prob, *value, *reward;  // [T, B, A]
  int* delivered;   // [T, B]
  float* logits;    // [T, B, A, 5] pre-mask logits, or null: not written
  unsigned char* mask;  // [T, B, A, 5] valid moves, or null: no masking
  Shaping shp;  // the potential-shaping option; off when its table is null
};

// y[n][j] = act(sum_k x[n][k] * W[k][j] + b[j]) for the CTA's ROWS rows.
template <int ROWS>
__device__ void dense(const float* W, const float* bias, const float* x,
                      int xs, float* y, int ys, int in, int out,
                      bool use_tanh) {
  constexpr int G = ROWS / RT;
  for (int item = threadIdx.x; item < out * G; item += NT) {
    const int j = item % out, g = item / out;
    const float* xg = x + g * RT * xs;
    float acc[RT];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) acc[rr] = 0.f;
    for (int kk = 0; kk < in; ++kk) {
      const float wk = W[kk * out + j];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) acc[rr] = fmaf(wk, xg[rr * xs + kk], acc[rr]);
    }
    const float bj = bias[j];
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const float z = acc[rr] + bj;
      y[(g * RT + rr) * ys + j] = use_tanh ? tanhf(z) : z;
    }
  }
}

template <int A, int R, bool WIDE, bool GROUPED>
__global__ void __launch_bounds__(NT) act_kernel(ActArgs p) {
  static_assert(WIDE || !GROUPED, "policy groups take the wide route");
  using RM = RowMap<A, GROUPED>;
  constexpr int NE = envs_per_cta<A>();
  constexpr int ROWS = NE * A;
  constexpr int TR = RM::TR;
  constexpr int G = ROWS / TR;
  using ES = EnvSmem<A, R>;
  extern __shared__ float smem[];
  // Staged: the weights, then two [ROWS, dmax] buffers. Wide: one chunk of
  // the observation [ROWS, XCH], then two [ROWS, hmax] buffers. With
  // groups, each tile's weight offset after the rest.
  const int stride = WIDE ? p.hmax : p.dmax;
  float* w_s = smem;
  float* xa = smem + (WIDE ? ROWS * XCH : p.n_weights);
  float* xb = xa + ROWS * stride;
  float* head = xb + ROWS * stride;
  int* env_s = reinterpret_cast<int*>(head + ROWS * HSTRIDE);
  int* act_s = env_s + NE * ES::SIZE;
  int* tile_off = GROUPED ? act_s + ROWS : nullptr;

  const int tid = threadIdx.x;
  const long b0 = (long)blockIdx.x * NE;
  const int ne = (int)min((long)NE, p.B - b0);
  const long BA = p.B * A;

  if (!WIDE)
    for (int i = tid; i < p.n_weights; i += NT) w_s[i] = p.weights[i];
  if (GROUPED && tid < G)
    tile_off[tid] = p.group[RM::agent(tid * TR)] * p.n_weights;
  if (tid < NE) {
    wh::Env<A, R> e = {};  // rows past the batch end compute on zeros
    if (tid < ne)
      wh::load_env(e, b0 + tid, p.pos, p.areq, p.carry, p.rpick, p.rdrop,
                   p.rstat, p.ragent);
    ES::put(e, env_s + tid * ES::SIZE);
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const long tb = (long)t * p.B + b0;  // first (t, b) of the CTA
    float *x = xa, *y = xb;
    const float* w = WIDE ? p.weights : w_s;
    if (WIDE) {
      // 1 + 2a. The observations of the CTA's rows (RowMap), a chunk of
      // features at a time, each chunk through its rows of the first
      // layer's matrix; the sums build up in xb.
      float* xc = smem;
      const int out = p.dims[1];
      for (int c0 = 0; c0 < p.D; c0 += XCH) {
        const int cw = min(XCH, p.D - c0);
        for (int idx = tid; idx < ROWS * cw; idx += NT) {
          const int n = idx / cw, c = idx % cw;
          const int e = RM::env(n), a = RM::agent(n);
          const float v =
              obs_value<A, R>(env_s + e * ES::SIZE, a, c0 + c, p);
          xc[n * XCH + c] = v;
          if (e < ne) p.obs[((tb + e) * A + a) * p.D + c0 + c] = v;
        }
        __syncthreads();
        dense_l2<NT, TR, G>(w + (long)c0 * out, w + (long)p.D * out, xc, XCH,
                            cw, y, stride, out, true, c0 == 0,
                            c0 + XCH >= p.D, nullptr, 0, 0, tile_off);
        __syncthreads();
      }
      w += (long)p.D * out + out;
      x = xb;
      y = xa;
      // 2b. The other hidden layers, then the fused logits + value head.
      for (int l = 1; l < p.n_hidden; ++l) {
        const int in = p.dims[l], out_l = p.dims[l + 1];
        dense_l2<NT, TR, G>(w, w + in * out_l, x, stride, in, y, stride,
                            out_l, true, true, true, nullptr, 0, 0, tile_off);
        w += in * out_l + out_l;
        __syncthreads();
        float* tmp = x;
        x = y;
        y = tmp;
      }
      const int hid = p.dims[p.n_hidden];
      dense_l2<NT, TR, G>(w, w + hid * NHEAD, x, stride, hid, head, HSTRIDE,
                          NHEAD, false, true, true, nullptr, 0, 0, tile_off);
    } else {
      // 1. Observations of the CTA's rows, row n = (env n / A, agent n % A).
      for (int idx = tid; idx < ROWS * p.D; idx += NT) {
        const int n = idx / p.D, f = idx % p.D;
        const float v =
            obs_value<A, R>(env_s + (n / A) * ES::SIZE, n % A, f, p);
        xa[n * p.dmax + f] = v;
        if (n / A < ne) p.obs[tb * A * p.D + idx] = v;
      }
      __syncthreads();

      // 2. MLP: tanh hidden layers, then the fused logits + value head.
      for (int l = 0; l < p.n_hidden; ++l) {
        const int in = p.dims[l], out = p.dims[l + 1];
        dense<ROWS>(w, w + in * out, x, p.dmax, y, p.dmax, in, out, true);
        w += in * out + out;
        __syncthreads();
        float* tmp = x;
        x = y;
        y = tmp;
      }
      const int hid = p.dims[p.n_hidden];
      dense<ROWS>(w, w + hid * NHEAD, x, p.dmax, head, HSTRIDE, hid, NHEAD,
                  false);
    }
    __syncthreads();

    // 3. With masking, floor the invalid moves' logits; then sample
    // argmax(logits + gumbel), first max; stable log-softmax. act_s is
    // env-major, as tick_env reads it.
    if (tid < ROWS) {
      const int e = RM::env(tid), a = RM::agent(tid);
      act_s[e * A + a] = sample_row<A>(p, head + tid * HSTRIDE,
                                       env_s + e * ES::SIZE, e * A + a,
                                       e < ne, t, b0);
    }
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

// Shared memory of one CTA on the staged route (wide false) or the wide one.
template <int A, int R>
size_t smem_bytes(const ActArgs& p, bool wide) {
  constexpr int NE = envs_per_cta<A>();
  constexpr int ROWS = NE * A;
  const size_t floats =
      wide ? (size_t)ROWS * XCH + 2 * (size_t)ROWS * p.hmax
           : (size_t)p.n_weights + 2 * (size_t)ROWS * p.dmax;
  return sizeof(float) * (floats + ROWS * HSTRIDE) +
         sizeof(int) * (NE * EnvSmem<A, R>::SIZE + ROWS +
                        (p.n_groups > 1 ? MAXK : 0));
}

// The route of a shape: staged where that fits the device's shared memory
// and there is one policy group, else wide, which needs a hidden layer to
// hold the first layer's sums. Returns whether the route's shared memory
// fits.
template <int A, int R>
bool route_for(const ActArgs& p, bool* wide) {
  const size_t limit = smem_optin_limit();
  *wide = p.n_hidden >= 1 &&
          (p.n_groups > 1 || smem_bytes<A, R>(p, false) > limit);
  return (*wide || p.n_groups == 1) && smem_bytes<A, R>(p, *wide) <= limit;
}

template <int A, int R>
struct SmemBytes {
  static void run(const ActArgs& p, size_t* out) {
    bool wide = false;
    route_for<A, R>(p, &wide);
    *out = smem_bytes<A, R>(p, wide);
  }
};

template <int A, int R>
struct IsWide {
  static void run(const ActArgs& p, int* out) {
    bool wide = false;
    route_for<A, R>(p, &wide);
    *out = wide;
  }
};

template <int A, int R>
struct LaunchAct {
  template <bool WIDE, bool GROUPED>
  static int launch(const ActArgs& p, size_t smem, cudaStream_t stream) {
    constexpr int NE = envs_per_cta<A>();
    cudaError_t e = cudaFuncSetAttribute(
        act_kernel<A, R, WIDE, GROUPED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((p.B + NE - 1) / NE);
    act_kernel<A, R, WIDE, GROUPED><<<blocks, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  static void run(const ActArgs& p, cudaStream_t stream, int* err) {
    bool wide = false;
    if (!route_for<A, R>(p, &wide)) {
      *err = (int)cudaErrorInvalidValue;
      return;
    }
    const size_t smem = smem_bytes<A, R>(p, wide);
    *err = !wide ? launch<false, false>(p, smem, stream)
                 : p.n_groups > 1 ? launch<true, true>(p, smem, stream)
                                  : launch<true, false>(p, smem, stream);
  }
};

// Whether K groups and the agent -> group map (null: one group) are valid
// for A agents.
bool groups_ok(int A, int n_groups, const int* groups) {
  if (n_groups < 1 || n_groups > MAXK || A > MAXK) return false;
  if (n_groups > 1 && !groups) return false;
  for (int a = 0; groups && a < A; ++a)
    if (groups[a] < 0 || groups[a] >= n_groups) return false;
  return true;
}

ActArgs make_args(long B, int T, int H, int W, float spawn_prob, int S,
                  int k, int D, int gobs, float inv_h, float inv_w,
                  int n_hidden, const int* dims, int n_weights, int A = 0,
                  int n_groups = 1, const int* groups = nullptr) {
  ActArgs p = {};
  p.B = B;
  p.T = T;
  p.geo.H = H;
  p.geo.W = W;
  p.geo.spawn_prob = spawn_prob;
  p.S = S;
  p.k = k;
  p.D = D;
  p.gobs = gobs;
  p.inv_h = inv_h;
  p.inv_w = inv_w;
  p.n_hidden = n_hidden;
  p.dmax = D;
  for (int l = 0; l <= n_hidden && l <= MAXL; ++l) {
    p.dims[l] = dims[l];
    if (dims[l] > p.dmax) p.dmax = dims[l];
    if (l > 0 && dims[l] > p.hmax) p.hmax = dims[l];
  }
  p.n_weights = n_weights;
  p.n_groups = n_groups;
  for (int a = 0; groups && a < A && a < MAXK; ++a) p.group[a] = groups[a];
  return p;
}

}  // namespace

// Shared memory one CTA needs on the route the shape takes, in bytes (more
// than the device allows when no route holds the shape), or 0 for an
// unsupported shape. n_weights is one group's, of n_groups.
extern "C" long wh_act_smem_bytes(int A, int R, int D, int n_hidden,
                                  const int* dims, int n_weights,
                                  int n_groups) {
  if (n_hidden < 0 || n_hidden > MAXL || n_groups < 1 || n_groups > MAXK)
    return 0;
  ActArgs p = make_args(0, 0, 0, 0, 0.f, 0, 0, D, 0, 0.f, 0.f, n_hidden,
                        dims, n_weights, A, n_groups);
  size_t out = 0;
  if (!wh::dispatch_shape<SmemBytes>(A, R, p, &out)) return 0;
  return (long)out;
}

// Whether the shape takes the wide route (1) or the staged one (0) on the
// current device; -1 for an unsupported shape.
extern "C" int wh_act_wide(int A, int R, int D, int n_hidden,
                           const int* dims, int n_weights, int n_groups) {
  if (n_hidden < 0 || n_hidden > MAXL || n_groups < 1 || n_groups > MAXK)
    return -1;
  ActArgs p = make_args(0, 0, 0, 0, 0.f, 0, 0, D, 0, 0.f, 0.f, n_hidden,
                        dims, n_weights, A, n_groups);
  int out = 0;
  return wh::dispatch_shape<IsWide>(A, R, p, &out) ? out : -1;
}

extern "C" int wh_act_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int n_hidden, const int* dims,
    const unsigned char* walls,
    const float* weights, int n_weights, int n_groups, const int* groups,
    const int* pos, const int* areq,
    const int* carry, const int* rpick, const int* rdrop, const int* rstat,
    const int* ragent, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* obs,
    int* action, float* log_prob, float* value, float* reward,
    int* delivered, float* logits, unsigned char* mask, const int* table,
    const float* done, float* raw_reward, float shaping_coef, float gamma,
    void* stream) {
  if (n_hidden < 0 || n_hidden > MAXL || !groups_ok(A, n_groups, groups))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  ActArgs p = make_args(B, T, H, W, spawn_prob, S, k, D, global_obs, inv_h,
                        inv_w, n_hidden, dims, n_weights, A, n_groups,
                        groups);
  p.step_penalty = step_penalty;
  p.pickup_reward = pickup_reward;
  p.delivery_reward = delivery_reward;
  p.collision_penalty = collision_penalty;
  p.geo.walls = walls;
  p.weights = weights;
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
  int err = (int)cudaSuccess;
  if (!wh::dispatch_shape<LaunchAct>(A, R, p, (cudaStream_t)stream, &err))
    return (int)cudaErrorInvalidValue;
  return err;
}
