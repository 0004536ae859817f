// K7: the acting phase of the recurrent (GRU / LSTM) policy, T steps in one
// launch.
//
// Replaces warehouse_tpu/pallas/act.py ppo_rnn_rollout_pallas (:747; body
// _act_rnn_kernel :516 with _obs_rows :138, _sample_logprob :491 and the env
// tick of rollout.py:57), with its action-masking option. Each step, for
// every env of the CTA: build the ego-window observation of each agent,
// run the tanh encoder, the GRU or LSTM cell on the carried state and the
// fused logits + value head, with masking floor the logits of invalid
// moves, sample argmax(logits + gumbel), take the log-softmax of the chosen
// action, tick the env. The carry is threaded over the T steps and written
// out unreset: the caller zeroes it where the chunk truncated.
//
// Layout: a CTA owns NE whole envs (the tick needs all A agents of an env),
// NE * A <= 32 rows of (env, agent); a row's sequence never leaves its CTA,
// so there is no grid-wide synchronisation. The CTA's observations,
// encoder activations, carry (h twice, c) and env states stay in shared
// memory (~97 KB at hidden 128); the weights do not fit beside them (~450
// KB for the GRU, ~580 KB for the LSTM at hidden 128) and are read from
// device memory through L2 each step, in the layout of rnn_cell.cuh.
// Device memory sees the draws, the gumbel noise and the outputs. The bound
// is the FMA loops of the dense products on the CUDA cores (about 225
// kFLOP per row and step for the GRU at hidden 128).
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine (act_common.cuh, env_tick.cuh, shared with K2);
// the policy outputs and the carry are held to a float32 tolerance.

#include <cuda_runtime.h>

#include "act_common.cuh"
#include "env_tick.cuh"
#include "rnn_cell.cuh"

namespace {

// Envs per CTA: NE * A rows, a multiple of RRT, at most 32.
template <int A>
__host__ __device__ constexpr int rnn_envs_per_cta() {
  return A == 6 ? 4 : 32 / A;
}

struct ActRnnArgs {
  long B;
  int T;
  wh::Geometry geo;
  int S, k, D;         // window side, radius, obs dim
  int gobs;            // always 0: the recurrent kernel has no global view
  float inv_h, inv_w;  // float32 reciprocals of H and W
  float step_penalty, pickup_reward, delivery_reward, collision_penalty;
  RnnNet net;
  const float* params;    // the packed vector (rnn_cell.cuh)
  const float* params_t;  // its forward matrices transposed
  const int *pos, *areq, *carry, *rpick, *rdrop, *rstat, *ragent;
  const float *h0, *c0;   // [B, A, H]; c0 null for the GRU
  const float* u;
  const int *pick, *drop;
  const float* gumbel;    // [T, 5, B * A]
  int *o_pos, *o_areq, *o_carry, *o_rpick, *o_rdrop, *o_rstat, *o_ragent;
  float *o_h, *o_c;       // [B, A, H]
  float* obs;             // [T, B, A, D]
  int* action;            // [T, B, A]
  float *log_prob, *value, *reward;  // [T, B, A]
  int* delivered;         // [T, B]
  float* logits;          // [T, B, A, 5] pre-mask logits, or null
  unsigned char* mask;    // [T, B, A, 5] valid moves, or null: no masking
  Shaping shp;            // always off: the recurrent kernel has no shaping
};

// Floats of the activation buffers of a CTA of `rows` rows.
inline int act_floats(const RnnNet& net, int rows) {
  return rows * (round4(net.D) + 2 * enc_max(net) + 3 * net.H + ROST);
}

template <int A, int R>
__global__ void __launch_bounds__(RNT) act_rnn_kernel(ActRnnArgs p) {
  constexpr int NE = rnn_envs_per_cta<A>();
  constexpr int ROWS = NE * A;
  using ES = EnvSmem<A, R>;
  extern __shared__ __align__(16) float smem[];
  const RnnNet& net = p.net;
  const int H = net.H, xs = round4(net.D), emax = enc_max(net);
  float* xa = smem;
  float* ea = xa + ROWS * xs;
  float* eb = ea + ROWS * emax;
  float* ha = eb + ROWS * emax;
  float* hb = ha + ROWS * H;
  float* cs = hb + ROWS * H;
  float* head = cs + ROWS * H;
  int* env_s = reinterpret_cast<int*>(head + ROWS * ROST);
  int* act_s = env_s + NE * ES::SIZE;

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
  for (int idx = tid; idx < ROWS * H; idx += RNT) {
    const bool live = idx / H / A < ne;
    ha[idx] = live ? p.h0[b0 * A * H + idx] : 0.f;
    cs[idx] = live && p.c0 ? p.c0[b0 * A * H + idx] : 0.f;
  }
  for (int idx = tid; idx < ROWS * xs; idx += RNT) xa[idx] = 0.f;
  __syncthreads();

  float *h = ha, *h_next = hb;
  for (int t = 0; t < p.T; ++t) {
    const long tb = (long)t * p.B + b0;  // first (t, b) of the CTA
    // 1. Observations of the CTA's rows, row n = (env n / A, agent n % A).
    for (int idx = tid; idx < ROWS * p.D; idx += RNT) {
      const int n = idx / p.D, f = idx % p.D;
      const float v = obs_value<A, R>(env_s + (n / A) * ES::SIZE, n % A, f, p);
      xa[n * xs + f] = v;
      if (n / A < ne) p.obs[tb * A * p.D + idx] = v;
    }
    __syncthreads();

    // 2. Encoder, cell, fused head.
    const float* x = xa;
    int xw = xs, in = net.D;
    float *y = ea, *spare = eb;
    for (int l = 0; l < net.n_enc; ++l) {
      enc_layer(p.params_t + net.enc_w[l], p.params + net.enc_b[l], x, xw, in,
                y, net.enc_out[l], net.enc_out[l], ROWS, nullptr, 0, 0);
      __syncthreads();
      x = y;
      xw = in = net.enc_out[l];
      float* tmp = y;
      y = spare;
      spare = tmp;
    }
    cell_forward(net, p.params, p.params_t, x, xw, h, h_next, cs, H, ROWS,
                 nullptr, nullptr, nullptr, 0, 0);
    __syncthreads();
    float* tmp = h;
    h = h_next;
    h_next = tmp;
    head_forward(net, p.params, h, H, head, ROWS);
    __syncthreads();

    // 3. Mask, sample, log-softmax (as K2).
    if (tid < ROWS)
      act_s[tid] = sample_row<A>(p, head + tid * ROST,
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
  for (int idx = tid; idx < ne * A * H; idx += RNT) {
    p.o_h[b0 * A * H + idx] = h[idx];
    if (p.o_c) p.o_c[b0 * A * H + idx] = cs[idx];
  }
}

template <int A, int R>
size_t act_rnn_smem(const RnnNet& net) {
  constexpr int NE = rnn_envs_per_cta<A>();
  return sizeof(float) * (size_t)act_floats(net, NE * A) +
         sizeof(int) * (NE * EnvSmem<A, R>::SIZE + NE * A);
}

template <int A, int R>
struct RnnSmemBytes {
  static void run(const RnnNet& net, size_t* out) {
    *out = act_rnn_smem<A, R>(net);
  }
};

template <int A, int R>
struct LaunchActRnn {
  static void run(const ActRnnArgs& p, cudaStream_t stream, int* err) {
    constexpr int NE = rnn_envs_per_cta<A>();
    const size_t smem = act_rnn_smem<A, R>(p.net);
    cudaError_t e = cudaFuncSetAttribute(
        act_rnn_kernel<A, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
      *err = (int)e;
      return;
    }
    const unsigned blocks = (unsigned)((p.B + NE - 1) / NE);
    act_rnn_kernel<A, R><<<blocks, RNT, smem, stream>>>(p);
    *err = (int)cudaGetLastError();
  }
};

}  // namespace

// Floats of the packed parameter vector, or 0 for unsupported widths.
extern "C" long wh_rnn_param_floats(int n_enc, const int* dims, int H,
                                    int lstm) {
  RnnNet net;
  return make_rnn_net(n_enc, dims, H, lstm, &net) ? net.n_params : 0;
}

// Shared memory one CTA needs, in bytes, or 0 for an unsupported shape.
extern "C" long wh_act_rnn_smem_bytes(int A, int R, int n_enc,
                                      const int* dims, int H, int lstm) {
  RnnNet net;
  if (!make_rnn_net(n_enc, dims, H, lstm, &net)) return 0;
  size_t out = 0;
  if (!wh::dispatch_shape<RnnSmemBytes>(A, R, net, &out)) return 0;
  return (long)out;
}

// `params_t` is scratch of the packed vector's size.
extern "C" int wh_act_rnn_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, float inv_h, float inv_w, float step_penalty,
    float pickup_reward, float delivery_reward, float collision_penalty,
    int n_enc, const int* dims, int hidden, int lstm,
    const unsigned char* walls, const float* params, float* params_t,
    const int* pos, const int* areq, const int* carry, const int* rpick,
    const int* rdrop, const int* rstat, const int* ragent, const float* h0,
    const float* c0, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* o_h,
    float* o_c, float* obs, int* action, float* log_prob, float* value,
    float* reward, int* delivered, float* logits, unsigned char* mask,
    void* stream_) {
  ActRnnArgs p = {};
  if (!make_rnn_net(n_enc, dims, hidden, lstm, &p.net) || dims[0] != D ||
      (lstm && (!c0 || !o_c)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  cudaStream_t stream = (cudaStream_t)stream_;
  p.B = B;
  p.T = T;
  p.geo.H = H;
  p.geo.W = W;
  p.geo.spawn_prob = spawn_prob;
  p.geo.walls = walls;
  p.S = S;
  p.k = k;
  p.D = D;
  p.inv_h = inv_h;
  p.inv_w = inv_w;
  p.step_penalty = step_penalty;
  p.pickup_reward = pickup_reward;
  p.delivery_reward = delivery_reward;
  p.collision_penalty = collision_penalty;
  p.params = params;
  p.params_t = params_t;
  p.pos = pos;
  p.areq = areq;
  p.carry = carry;
  p.rpick = rpick;
  p.rdrop = rdrop;
  p.rstat = rstat;
  p.ragent = ragent;
  p.h0 = h0;
  p.c0 = lstm ? c0 : nullptr;
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
  p.o_h = o_h;
  p.o_c = lstm ? o_c : nullptr;
  p.obs = obs;
  p.action = action;
  p.log_prob = log_prob;
  p.value = value;
  p.reward = reward;
  p.delivered = delivered;
  p.logits = logits;
  p.mask = mask;
  cudaError_t e = launch_transpose(p.net, params, params_t, stream);
  if (e != cudaSuccess) return (int)e;
  int err = (int)cudaSuccess;
  if (!wh::dispatch_shape<LaunchActRnn>(A, R, p, stream, &err))
    return (int)cudaErrorInvalidValue;
  return err;
}
