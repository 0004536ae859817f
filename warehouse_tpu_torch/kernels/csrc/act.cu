// K2: the PPO acting phase of the MLP policy, T steps a call.
//
// Replaces warehouse_tpu/pallas/act.py ppo_rollout_pallas (:1028; body
// _act_kernel :299 with _obs_rows :138, _sample_logprob :491 and the env
// tick of rollout.py:57), MLP arm with its action-masking (:415-428), its
// potential-shaping (_phi_row :266; act_common.cuh tick_env), its global-
// observation option (_obs_rows_global :193; act_common.cuh obs_value) and
// its policy groups (:1062-1072).
//
// Each step is stage kernels on the caller's stream over all of the step's
// N = B A rows (env, agent), with no host synchronisation; the env state
// lives in device memory (envst) from one step to the next:
//
//   hidden_kernel (act_stages.cuh, K7's encoder stage), once per hidden
//      layer but the last: y = tanh(x Wl + bl) as 64 x 128 tiles
//      (mma_tiles.cuh gemm_64x128_f32: FFMA register blocks, the k-slices
//      through a cp.async ring; row_stages.cuh
//      rows_gemm_kernel<false, EPI_TANH>'s product and epilogue, each tile
//      on its group's weights). The first layer reads `xs`, the
//      observation rows in row order, zero-padded to D rounded up to 32
//      and 16-byte aligned: the obs output [T, B, A, D] is neither at D =
//      106 / 411 / 611 / 1131, so cp.async cannot read it in place. The
//      others read and write two ping-pong buffers, each layer's rows its
//      width rounded up to 32 apart, zeros past the width.
//   head_kernel (act_stages.cuh, K10's trunk stage): the last hidden layer
//      and the fused logits + value head, head [N, 8]. With no hidden layer
//      head0_kernel takes the head's sums on the observation rows.
//   env_kernel (act_stages.cuh, K10's and K7's): each row's mask, sample
//      and outputs, each env's tick with rewards, shaping and deliveries;
//      then obs_kernel (act_stages.cuh): the next step's observation rows into
//      obs[t + 1] and into xs. A prologue pair writes obs[0] and xs; the
//      last step stores the final state and observes nothing.
//   prep (once a call): each layer's kernel as Bt [HP, in rounded up to
//      32] per group (HP = its width rounded up to 128), zero-padded to
//      whole tiles, and the head as [6, H] per group (pad_jobs.cuh: one
//      launch up to 7 hidden layers, one more for each 8 past them).
//
// Any number of hidden layers: the per-layer tables live in the caller's
// MlpTables on the host, and no kernel reads them.
//
// So T steps are (L + 2) T + 2 launches at L >= 1 hidden layers, 3 T + 1 at
// L = 0. The rows are group-major (act_stages.cuh RowGroups): a tile of a
// GEMM stage holds one group's rows and runs on that group's Bt, which is
// what the TPU kernel's trace-time selection of a group's weights becomes.
//
// The bound is the products on the CUDA cores in float32 (2 x 61 kFLOP a
// row and step at 106 -> 128 -> 128 -> 6), and, at 6 agents, the env
// stage's serial tick per env. The TPU kernel's chunk-long residency of an
// env block and its weights has no counterpart: the step's rows do not fit
// one SM, so they go through device memory between stages (L2 at config 4:
// 16384 rows x 128 floats are 8 MB).
//
// Exactness: observations, rewards and the env dynamics are bit-exact
// against the plain engine. Every policy sum is a float32 FMA chain in k
// order from 0 (the padded k's add exact zeros), then + b, then tanhf for a
// hidden layer, whatever the tiles and with no atomics, so a rerun gives
// the same bits; the plain MLP is held to a tolerance.

#include <cuda_runtime.h>

#include "act_stages.cuh"

namespace {

// Host storage of MlpNet's, WorkLayout's and ActMlpArgs' per-layer tables.
struct MlpTables {
  std::vector<int> dims, ld, hp;
  std::vector<long> w_off, b_off, bt;
  std::vector<float*> btp;
};

// The MLP's packed layout and the stages' padded widths. The packed vector
// of a group: per hidden layer W [in, out] then b [out], then the head W
// [H, 6] and b [6] (H the last hidden width, or D without hidden layers).
struct MlpNet {
  int L;                       // hidden layers
  HostPtr<const int> dims;     // D, then the hidden widths
  HostPtr<const int> ld;       // each width rounded up to BK
  HostPtr<const int> hp;       // each width rounded up to BN
  HostPtr<const long> w_off, b_off;  // each layer's, in the packed vector
  int ld0;                     // ld[0]: the observation rows' stride
  long head_w, head_b;         // in the packed vector
  long n_weights;              // floats of one group's packed vector
};

bool make_mlp_net(int L, const int* dims, MlpNet* net, MlpTables* tb) {
  if (L < 0) return false;
  net->L = L;
  tb->dims.assign(L + 1, 0);
  tb->ld.assign(L + 1, 0);
  tb->hp.assign(L + 1, 0);
  tb->w_off.assign(L, 0);
  tb->b_off.assign(L, 0);
  long off = 0;
  for (int l = 0; l <= L; ++l) {
    if (dims[l] < 1) return false;
    tb->dims[l] = dims[l];
    tb->ld[l] = round_up(dims[l], BK);
    tb->hp[l] = round_up(dims[l], BN);
  }
  for (int l = 0; l < L; ++l) {
    tb->w_off[l] = off;
    off += (long)dims[l] * dims[l + 1];
    tb->b_off[l] = off;
    off += dims[l + 1];
  }
  net->dims = tb->dims.data();
  net->ld = tb->ld.data();
  net->hp = tb->hp.data();
  net->w_off = tb->w_off.data();
  net->b_off = tb->b_off.data();
  net->ld0 = tb->ld[0];
  net->head_w = off;
  off += (long)dims[L] * NHEAD;
  net->head_b = off;
  net->n_weights = off + NHEAD;
  return true;
}

// The workspace, offsets in floats, each a multiple of 32: bt[l] [K][hp[l +
// 1]][ld[l]] for l < L, hw [K][6][H], xs [N][ld[0]], two buffers of N HL
// floats (HL the widest of ld[1 .. L - 1]; hidden layer l's rows [N][ld[l +
// 1]] in h[l % 2]), head [N][HSTRIDE], envst [B][4 A + 6 R] ints.
struct WorkLayout {
  HostPtr<const long> bt;  // one per hidden layer
  long hw, xs, h[2], head, envst, total;
  int HL;
};

WorkLayout work_layout(const MlpNet& net, int A, int R, long B, int K,
                       MlpTables* tb) {
  WorkLayout w = {};
  tb->bt.assign(net.L, 0);
  w.bt = tb->bt.data();
  long off = 0;
  auto take = [&](long n) {
    const long o = off;
    off += (n + 31) / 32 * 32;
    return o;
  };
  const long N = B * A;
  for (int l = 0; l < net.L; ++l)
    tb->bt[l] = take((long)K * net.hp[l + 1] * net.ld[l]);
  w.hw = take((long)K * NHEAD * net.dims[net.L]);
  w.xs = take(N * net.ld[0]);
  for (int l = 1; l < net.L; ++l) w.HL = w.HL > net.ld[l] ? w.HL : net.ld[l];
  w.h[0] = take(N * w.HL);
  w.h[1] = take(net.L > 2 ? N * w.HL : 0);
  w.head = take(N * HSTRIDE);
  w.envst = take(B * (4L * A + 6L * R));
  w.total = off;
  return w;
}

// K2's arguments: the env stage's, then the MLP's layout and workspace.
struct ActMlpArgs : ActEnvArgs {
  MlpNet net;
  const float* weights;  // K packed vectors in group order
  HostPtr<float*> bt;    // each layer's Bt, K of them
  float* hw;             // the head [6][H], K of them
  float* xs;             // [N][ld[0]] the observation rows in row order
  float* h[2];           // the hidden rows, ping-pong
};

// ---- prep: the layers' kernels as the tile GEMMs read them ------------------

// Each group's Bt [hp[l + 1]][ld[l]] of each layer (W is [in, out]: the
// copy transposes it, zeros past it), then its head [6][H] (from [H, 6]).
PadPlan prep_plan(const ActMlpArgs& p) {
  const MlpNet& net = p.net;
  PadPlan plan;
  plan.K = p.rg.K;
  for (int l = 0; l < net.L; ++l)
    plan.add(p.bt[l], (long)net.hp[l + 1] * net.ld[l],
             p.weights + net.w_off[l], net.n_weights, net.hp[l + 1],
             net.ld[l], net.dims[l], net.dims[l + 1], true);
  const int H = net.dims[net.L];
  plan.add(p.hw, (long)NHEAD * H, p.weights + net.head_w, net.n_weights,
           NHEAD, H, H, NHEAD, true);
  return plan;
}

// ---- no hidden layer: the head on the observation rows ----------------------

// One thread a (row, head output): the sum over the D features of the
// group's head W [D, 6], in k order, then + b.
__global__ void head0_kernel(ActMlpArgs p) {
  const int D = p.D, K = p.net.ld0;
  const long n = p.rg.first[p.rg.K] * HSTRIDE;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long q = i / HSTRIDE;
    const int o = (int)(i % HSTRIDE);
    float v = 0.f;
    if (o < NHEAD) {
      int g = 0;
      while (g + 1 < p.rg.K && q >= p.rg.first[g + 1]) ++g;
      const float* w = p.weights + g * p.net.n_weights + p.net.head_w;
      const float* x = p.xs + q * K;
      for (int k = 0; k < D; ++k) v = fmaf(__ldg(w + k * NHEAD + o), x[k], v);
      v = v + __ldg(p.weights + g * p.net.n_weights + p.net.head_b + o);
    }
    p.head[i] = v;
  }
}

// ---- host side ----------------------------------------------------------------

// The shape checks of every entry point: a supported net, agents and queue
// of this build (dispatch_shape), K in [1, ACT_MAXK] with a valid map
// (null: one group).
bool shape_ok(int A, int R, int L, const int* dims, int K, const int* group,
              MlpNet* net, MlpTables* tb) {
  RowGroups rg;
  return make_mlp_net(L, dims, net, tb) && known_shape(A, R) &&
         make_groups(A, 1, K, K > 1 ? group : nullptr, 0, &rg);
}

enum Stage { ST_HIDDEN = 0, ST_HEAD = 1, ST_ENV = 2, ST_ALL = 3 };

// A hidden layer l < L - 1 reads in_buf(l), writes h[l % 2]; the head stage
// reads in_buf(L - 1) (xs without hidden layers).
const float* in_buf(const ActMlpArgs& p, int l) {
  return l <= 0 ? p.xs : p.h[(l - 1) % 2];
}

// One K2 call: the whole chunk (ST_ALL), or one stage of its step 0 (the
// stage checks): ST_HIDDEN (with prep) runs hidden layer `layer` on
// in_buf(layer), ST_HEAD (with prep) the head stage on in_buf(L - 1),
// ST_ENV reads head and the input state and writes step 0's outputs, the
// final state and the next observation rows into obs_next and xs. p's
// shapes, pointers and options are set; this carves the workspace and
// launches, adding each kernel it launches to launched[4] where given: the
// hidden stages', the head stages', the env stages' (tick and observation
// rows), the prep's.
cudaError_t run_act_mlp(int stage, int layer, ActMlpArgs& p, int R, int K,
                        const int* group, float* work, float* obs_next,
                        long* launched, MlpTables* tb, cudaStream_t stream) {
  const int A = p.A;
  const MlpNet& net = p.net;
  const int L = net.L;
  if (!make_groups(A, p.B, K, K > 1 ? group : nullptr, 0, &p.rg))
    return cudaErrorInvalidValue;
  const WorkLayout wl = work_layout(net, A, R, p.B, K, tb);
  tb->btp.assign(L, nullptr);
  p.bt = tb->btp.data();
  for (int l = 0; l < L; ++l) p.bt[l] = work + wl.bt[l];
  p.hw = work + wl.hw;
  p.xs = work + wl.xs;
  p.h[0] = work + wl.h[0];
  p.h[1] = work + wl.h[1];
  p.head = work + wl.head;
  p.envst = reinterpret_cast<int*>(work + wl.envst);
  const unsigned tiles = (unsigned)p.rg.tile_b[p.rg.K];
  long unused[4] = {};
  if (!launched) launched = unused;
  // e, counted in launched[slot] when it is a success.
  auto count = [&](cudaError_t e, int slot) {
    if (e == cudaSuccess) ++launched[slot];
    return e;
  };
  cudaError_t e;
  if ((e = opt_in(hidden_kernel, smem_hidden())) != cudaSuccess ||
      (e = opt_in(head_kernel, smem_head())) != cudaSuccess)
    return e;
  // The env stage: the tick, then (unless the chunk ends) the next
  // observation rows into `out` and xs.
  auto env = [&](int t, int mode, float* out) {
    cudaError_t err = count(launch_env(p, R, t, mode, nullptr, stream), 2);
    if (err != cudaSuccess || ((mode & TO_OUTPUT) && !(mode & KEEP_STATE)))
      return err;
    return count(launch_obs(p, R, out, p.xs, net.ld[0], stream), 2);
  };
  auto hidden = [&](int l) {
    const HiddenStage hs = {in_buf(p, l), net.ld[l], p.bt[l],
                            (long)net.hp[l + 1] * net.ld[l],
                            p.weights + net.b_off[l], net.n_weights,
                            p.h[l % 2], net.ld[l + 1], net.ld[l + 1],
                            net.dims[l + 1]};
    const dim3 grid(tiles, (unsigned)(net.hp[l + 1] / BN));
    hidden_kernel<<<grid, GNT, smem_hidden(), stream>>>(hs, p.rg);
    return count(cudaGetLastError(), 0);
  };
  auto head = [&]() {
    if (L == 0) {
      head0_kernel<<<(unsigned)((p.rg.first[p.rg.K] * HSTRIDE + 255) / 256),
                     256, 0, stream>>>(p);
      return count(cudaGetLastError(), 1);
    }
    const int l = L - 1;
    const HeadStage hs = {in_buf(p, l), net.ld[l], p.bt[l],
                          (long)net.hp[l + 1] * net.ld[l], net.dims[L],
                          net.hp[L], p.weights + net.b_off[l], net.n_weights,
                          p.hw, (long)NHEAD * net.dims[L],
                          p.weights + net.head_b, net.n_weights, p.head};
    return count(launch_head(hs, p.rg, stream), 1);
  };
  if (L > 0 && (stage == ST_HIDDEN || stage == ST_HEAD || stage == ST_ALL)) {
    const PadPlan plan = prep_plan(p);
    pad_jobs_kernel<<<256, 256, 0, stream>>>(plan.batch(0));
    if ((e = count(cudaGetLastError(), 3)) != cudaSuccess ||
        (e = plan.launch_rest(256, 256, stream, launched + 3)) != cudaSuccess)
      return e;
  }
  if (stage == ST_HIDDEN)
    return layer >= 0 && layer + 1 < L ? hidden(layer)
                                       : cudaErrorInvalidValue;
  if (stage == ST_HEAD) return head();
  if (stage == ST_ENV)
    return env(0, FROM_INPUT | TO_OUTPUT | KEEP_STATE, obs_next);
  const long obs_step = p.B * A * (long)p.D;
  if ((e = env(-1, FROM_INPUT, p.obs)) != cudaSuccess) return e;
  for (int t = 0; t < p.T; ++t) {
    for (int l = 0; l + 1 < L; ++l)
      if ((e = hidden(l)) != cudaSuccess) return e;
    if ((e = head()) != cudaSuccess) return e;
    const bool last = t + 1 == p.T;
    if ((e = env(t, last ? TO_OUTPUT : 0,
                 last ? nullptr : p.obs + (t + 1) * obs_step)) != cudaSuccess)
      return e;
  }
  return cudaSuccess;
}

// The arguments shared by the two entry points below.
int act_mlp_call(
    int stage, int layer, int A, int R, long B, int T, int H, int W,
    float spawn_prob, int S, int k, int D, int global_obs, float inv_h,
    float inv_w, float step_penalty, float pickup_reward,
    float delivery_reward, float collision_penalty, int n_hidden,
    const int* dims, const unsigned char* walls, const float* weights,
    int n_groups, const int* groups, float* work, const int* pos,
    const int* areq, const int* carry, const int* rpick, const int* rdrop,
    const int* rstat, const int* ragent, const float* u, const int* pick,
    const int* drop, const float* gumbel, int* o_pos, int* o_areq,
    int* o_carry, int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent,
    float* obs, int* action, float* log_prob, float* value, float* reward,
    int* delivered, float* logits, unsigned char* mask, const int* table,
    const float* done, float* raw_reward, float shaping_coef, float gamma,
    float* obs_next, long* launched, void* stream_) {
  ActMlpArgs p = {};
  MlpTables tb;
  if (!shape_ok(A, R, n_hidden, dims, n_groups, groups, &p.net, &tb) ||
      p.net.dims[0] != D)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0) return (int)cudaSuccess;
  set_env_args(p, B, T, A, H, W, spawn_prob, S, k, D, global_obs, inv_h,
               inv_w, step_penalty, pickup_reward, delivery_reward,
               collision_penalty, walls, pos, areq, carry, rpick, rdrop, rstat,
               ragent, u, pick, drop, gumbel, o_pos, o_areq, o_carry, o_rpick,
               o_rdrop, o_rstat, o_ragent, obs, action, log_prob, value,
               reward, delivered, logits, mask, table, done, raw_reward,
               shaping_coef, gamma);
  p.weights = weights;
  return (int)run_act_mlp(stage, layer, p, R, n_groups, groups, work,
                          obs_next, launched, &tb, (cudaStream_t)stream_);
}

}  // namespace

// Floats of one group's packed weights, or 0 for unsupported widths.
extern "C" long wh_act_weight_floats(int n_hidden, const int* dims) {
  MlpNet net;
  MlpTables tb;
  return make_mlp_net(n_hidden, dims, &net, &tb) ? net.n_weights : 0;
}

// Floats of the workspace a call takes for B envs and K groups, or 0 for an
// unsupported shape.
extern "C" long wh_act_workspace_floats(int A, int R, long B, int n_hidden,
                                        const int* dims, int K) {
  MlpNet net;
  MlpTables tb;
  if (!make_mlp_net(n_hidden, dims, &net, &tb) || K < 1) return 0;
  return work_layout(net, A, R, B, K, &tb).total;
}

// The workspace's layout: out = the float offsets of xs, h[0], h[1], head
// and envst. A row of xs, or of hidden layer l's output, is its width
// rounded up to 32 (BK) floats apart.
extern "C" int wh_act_layout(int A, int R, long B, int n_hidden,
                             const int* dims, int K, long* out) {
  MlpNet net;
  MlpTables tb;
  if (!make_mlp_net(n_hidden, dims, &net, &tb) || K < 1)
    return (int)cudaErrorInvalidValue;
  const WorkLayout w = work_layout(net, A, R, B, K, &tb);
  out[0] = w.xs;
  out[1] = w.h[0];
  out[2] = w.h[1];
  out[3] = w.head;
  out[4] = w.envst;
  return 0;
}

// T steps of the MLP policy. `work` is the workspace
// (wh_act_workspace_floats). `weights` holds n_groups packed vectors in
// group order and `groups` maps each agent to one of them (null with one
// group). launched[0..3] gets the kernels launched added: the hidden
// stages', the head stages', the env stages', the prep's.
extern "C" int wh_act_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob, int S,
    int k, int D, int global_obs, float inv_h, float inv_w,
    float step_penalty, float pickup_reward, float delivery_reward,
    float collision_penalty, int n_hidden, const int* dims,
    const unsigned char* walls, const float* weights, int n_groups,
    const int* groups, float* work, const int* pos, const int* areq,
    const int* carry, const int* rpick, const int* rdrop, const int* rstat,
    const int* ragent, const float* u, const int* pick, const int* drop,
    const float* gumbel, int* o_pos, int* o_areq, int* o_carry,
    int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent, float* obs,
    int* action, float* log_prob, float* value, float* reward,
    int* delivered, float* logits, unsigned char* mask, const int* table,
    const float* done, float* raw_reward, float shaping_coef, float gamma,
    long* launched, void* stream) {
  return act_mlp_call(
      ST_ALL, 0, A, R, B, T, H, W, spawn_prob, S, k, D, global_obs, inv_h,
      inv_w, step_penalty, pickup_reward, delivery_reward, collision_penalty,
      n_hidden, dims, walls, weights, n_groups, groups, work, pos, areq,
      carry, rpick, rdrop, rstat, ragent, u, pick, drop, gumbel, o_pos,
      o_areq, o_carry, o_rpick, o_rdrop, o_rstat, o_ragent, obs, action,
      log_prob, value, reward, delivered, logits, mask, table, done,
      raw_reward, shaping_coef, gamma, nullptr, launched, stream);
}

// One stage of step 0 (0: hidden layer `layer`, 1: head, 2: env;
// wh_act_rollout's arguments, T = 1), on the rows the workspace holds; the
// env stage writes the next observation rows [B, A, D] into obs_next.
extern "C" int wh_act_stage(
    int stage, int layer, int A, int R, long B, int T, int H, int W,
    float spawn_prob, int S, int k, int D, int global_obs, float inv_h,
    float inv_w, float step_penalty, float pickup_reward,
    float delivery_reward, float collision_penalty, int n_hidden,
    const int* dims, const unsigned char* walls, const float* weights,
    int n_groups, const int* groups, float* work, const int* pos,
    const int* areq, const int* carry, const int* rpick, const int* rdrop,
    const int* rstat, const int* ragent, const float* u, const int* pick,
    const int* drop, const float* gumbel, int* o_pos, int* o_areq,
    int* o_carry, int* o_rpick, int* o_rdrop, int* o_rstat, int* o_ragent,
    float* obs, int* action, float* log_prob, float* value, float* reward,
    int* delivered, float* logits, unsigned char* mask, const int* table,
    const float* done, float* raw_reward, float shaping_coef, float gamma,
    float* obs_next, void* stream) {
  if (stage < ST_HIDDEN || stage > ST_ENV) return (int)cudaErrorInvalidValue;
  return act_mlp_call(
      stage, layer, A, R, B, T, H, W, spawn_prob, S, k, D, global_obs, inv_h,
      inv_w, step_penalty, pickup_reward, delivery_reward, collision_penalty,
      n_hidden, dims, walls, weights, n_groups, groups, work, pos, areq,
      carry, rpick, rdrop, rstat, ragent, u, pick, drop, gumbel, o_pos,
      o_areq, o_carry, o_rpick, o_rdrop, o_rstat, o_ragent, obs, action,
      log_prob, value, reward, delivered, logits, mask, table, done,
      raw_reward, shaping_coef, gamma, obs_next, nullptr, stream);
}
