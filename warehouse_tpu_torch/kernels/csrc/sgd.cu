// K3 + K4: the PPO SGD phase of the MLP policy, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd.py ppo_sgd_phase_pallas (:691; body
// _sgd_kernel :309 with _loss_and_dout :68, _block_grads :158 and
// _clip_adam_step :226) and ppo_minibatch_grads_pallas (:818; body
// _grads_kernel :404). Minibatch m is env columns [m B/M, (m+1) B/M) of
// the trajectory: N = T * B/M * A samples in Rows::row order.
//
// One minibatch's gradient (K4, wh_sgd_grads) is stages shaped by their
// products, each a kernel on the caller's stream, with no host
// synchronisation. Every product runs over all N rows at once as a tile
// GEMM (row_stages.cuh on mma_tiles.cuh); the stages' scratch, the prep's
// pieces, the head tile's halves, A, E, F and the reduce are mlp_stages.cuh's,
// shared with the IMPALA learner (K5/K6, vtrace_sgd.cu):
//
//   prep: the minibatch's observation rows gathered into x0 [N, Xs] (zeros
//      to Xs = D rounded to 32; a row's 424-byte stride need not be 16-byte
//      aligned, x0's is), and each hidden layer's W copied zero-padded as
//      the stages read it: [out, in] for the forward, transposed for the
//      dgrads.
//   A fwd: act_l = tanh(act_{l-1} W_l^T + b_l) for each hidden layer (act_0
//      from x0), 64 x 128 tile GEMMs over the N rows, tanh in the epilogue.
//      act_l stays float32: tanh' reads it.
//   C head_loss: tiles of 64 rows of the last layer in shared memory: the
//      6-wide head (5 logits and the value), the clipped-PPO loss chain
//      and its derivative per row (loss_row, shared with the recurrent
//      learner), one row of metric sums per tile in row order, dout to the
//      scratch, and dz_L = (dout W_head) (1 - act_L^2).
//   E dgrad: dz_{l-1} = (dz_l W_l) (1 - act_{l-1}^2) for l = L..2, tile
//      GEMMs on the transposed copies; the first layer needs no input
//      gradient.
//   F wgrad: dW_l = dz_l^T act_{l-1} (x0 for the first layer) and the
//      biases' sums, 128 x 128 tiles split-K over row ranges, one partial
//      per range (wgrad_tn_kernel); the 6-row head on a route of its own
//      (head_wgrad_kernel: 32 columns a CTA, 8 warps over the range's rows,
//      a lane a column) rather than a 128-row tile that is 95% padding.
//   then reduce_kernel (the partials in range order, the sums of squares
//   per 256 gradients) and metrics_kernel (mlp_learner.cuh).
//
// K3 (wh_sgd_clip_adam) follows each gradient with adam_kernel, the optax
// clip + Adam step, on a grid of CTAs that each compute the global norm
// (one CTA took 0.53 ms of a 23 ms phase at config 4, 1.99 at D = 611).
// Every sum runs in an order fixed by the shapes alone, with no atomics,
// so a rerun gives the same bits.
//
// Policy groups (pallas/sgd.py:293-306, _sgd_kernel :309, _grads_kernel
// :404): the params are K MLPs' in group order; sample (t, b, a) goes
// forward and backward through group groups[a]'s params and its weight
// gradients go to that group's slice of the gradient. The stages' rows
// come group after group (GroupSplit, each group's in Rows::row order): A,
// E and F run a launch per group on its row range and its params (prep
// copies every group's weights), C finds a tile's group from the tile
// offsets; the loss still averages over all N samples of the minibatch, the
// metric sums run over every sample, and one global-norm clip and Adam span
// all K groups.
//
// The products (mma_tiles.cuh): with bf16 operands (matmul_dtype=
// "bfloat16", _block_grads' dot at sgd.py:188-191) on the tensor cores as
// m16n8k16 with float32 sums, each operand rounded where the mma packs it,
// so a value both a product and tanh' or a bias sum read (act, dz, dout)
// stays float32 in memory; in float32 as FFMA register blocks on the CUDA
// cores. The head's products (6 wide) run on the CUDA cores on rounded
// operands (rbf). The loss chain, tanh', the bias sums, the clip and Adam
// stay float32.
//
// The bound is the products' rate: per step at config 4 ~4.3 GFLOP
// forward, ~2.2 in the dgrads and ~4.3 in the weight gradients (the first
// layer's K padded from 106 to 128). Every activation and delta goes
// through device memory between the stages (~0.2 GB of scratch at config
// 4, reused by every step), so that each product runs as whole tiles.
//
// Tie rules, as the TPU kernel writes them (_block_grads, sgd.py:170-179):
// a tie of the surrogate min routes the whole gradient to the unclipped
// branch (pg1 <= pg2), a tie of the value max to the unclipped error
// (sq1 >= sq2); jax.grad and torch split such ties 0.5/0.5. Both agree
// at the epoch-0 ratio == 1 ties, where the two branches have the same
// derivative; they differ only at a tie exactly on a clip bound. The
// clip bounds themselves pass gradient 1, as jnp.clip and torch.clamp do.

#include <cuda_runtime.h>

#include "mlp_stages.cuh"

namespace {

struct StageArgs : MlpStage {
  Batch bt;             // the minibatch's fields
  Coefs c;
  const float* scal;    // ent_coef, kl_coeff
};

// ---- prep: the padded weight copies and the observation rows -------------

// The first MAXJ weight copies (prep_plan) and the observation rows.
__global__ void mlp_prep_kernel(StageArgs p, PadJobs pj) {
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  run_pad_jobs(pj, i0, stride);
  // The observation rows, group after group: a warp a row at a time, the
  // row's offset found once.
  const GroupSplit& gs = p.gs;
  const int D = p.net.D, Xs = p.sd.Xs, lane = threadIdx.x & 31;
  const long warps = stride / 32;
  for (long q = i0 / 32; q < gs.noff[gs.K]; q += warps) {
    int g = 0;
    while (g + 1 < gs.K && q >= gs.noff[g + 1]) ++g;
    gather_row(p.bt.obs + gs.rows[g].row(q - gs.noff[g]) * D,
               p.sc.x0 + q * Xs, D, Xs, lane);
  }
}

// ---- C: the head, the loss and the last layer's delta ----------------------

template <bool BF>
__global__ void __launch_bounds__(GNT) mlp_head_kernel(StageArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Net& net = p.net;
  const GroupSplit& gs = p.gs;
  const Layer& hd = net.head;
  const int H = hd.in, HC = H + HPAD, Es = p.sd.Es_last;
  float* hsm = smem;             // [CB][HC] the tile's last-layer rows
  float* outs = hsm + CB * HC;   // [CB][OST] head outputs, then deltas
  float* met = outs + CB * OST;  // [CB][4]
  const int tid = threadIdx.x;
  const long tile = blockIdx.x;
  int g = 0;
  while (g + 1 < gs.K && tile >= gs.toff[g + 1]) ++g;
  const Rows& rows = gs.rows[g];
  const long q0 = (tile - gs.toff[g]) * CB, n0 = gs.noff[g] + q0;
  const int nvalid = rows.N - q0 < CB ? (int)(rows.N - q0) : CB;
  const float* params = p.params + g * net.n_params;
  const float* Wh = params + hd.w_off;
  load_head_rows(hsm, p.sc.act_last, Es, H, n0, nvalid);
  __syncthreads();
  head_fwd_rows<BF>(hsm, H, Wh, params + hd.b_off, outs);
  __syncthreads();
  if (tid < CB) {
    float* o = outs + tid * OST;
    float* m = met + tid * 4;
    if (tid < nvalid) {
      loss_row(o, rows.row(q0 + tid), p.bt, p.c, p.scal[0], p.scal[1], m);
      for (int r = 0; r < OST; ++r)
        p.sc.dout[(n0 + tid) * OST + r] = r < NHEAD ? o[r] : 0.f;
      for (int r = 0; r < NHEAD; ++r) o[r] = rbf<BF>(o[r]);  // dz's operand
    } else {
      for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
      for (int k = 0; k < 4; ++k) m[k] = 0.f;
    }
  }
  __syncthreads();
  if (tid < 4) {  // fixed-order sum over the tile's rows
    float s = 0.f;
    for (int n = 0; n < CB; ++n) s += met[n * 4 + tid];
    p.sc.met[tile * 4 + tid] = s;
  }
  head_dz_rows<BF>(outs, hsm, H, Es, Wh, p.sc.dz_last + n0 * Es, nvalid);
}

// ---- host side -------------------------------------------------------------

enum Stage { FWD, HEAD_LOSS, DGRAD, WGRAD };

template <bool BF>
cudaError_t launch_stage(const StageArgs& sa, Stage st, cudaStream_t stream) {
  switch (st) {
    case FWD:
      return fwd_stage<BF>(sa, stream);
    case HEAD_LOSS: {
      const size_t smem = smem_head(sa.net);
      cudaError_t e = opt_in(mlp_head_kernel<BF>, smem);
      if (e != cudaSuccess) return e;
      mlp_head_kernel<BF>
          <<<(unsigned)sa.sc.n_tiles, GNT, smem, stream>>>(sa);
      return cudaGetLastError();
    }
    case DGRAD:
      return dgrad_stage<BF>(sa, stream);
    case WGRAD:
      return wgrad_stage<BF>(sa, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t run_stage(const StageArgs& sa, Stage st, bool bf16,
                      cudaStream_t stream) {
  return bf16 ? launch_stage<true>(sa, st, stream)
              : launch_stage<false>(sa, st, stream);
}

cudaError_t prep(const StageArgs& sa, cudaStream_t stream) {
  const PadPlan plan = prep_plan(sa);
  mlp_prep_kernel<<<1024, 256, 0, stream>>>(sa, plan.batch(0));
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : plan.launch_rest(1024, 256, stream);
}

cudaError_t metrics(const StageArgs& sa, float* sums, cudaStream_t stream) {
  metrics_kernel<<<1, 128, 0, stream>>>(sa.sc.met, sa.sc.n_tiles, sums);
  return cudaGetLastError();
}

// The net, the minibatch mb's rows and their split by the K groups of
// `groups` (null: one group), the stages' widths, and the scratch laid out
// from `work` (or only sized, when it is null); the per-layer tables in
// *tb.
bool make_stage_args(int n_hidden, const int* dims, int T, long B, int A,
                     int M, int K, const int* groups, int mb, const float* obs,
                     float* work, StageArgs* sa, MlpTables* tb,
                     long* floats = nullptr) {
  if (!make_rows(n_hidden, dims, T, B, A, M, mb, obs, &sa->net, &sa->bt,
                 &tb->L) ||
      !split_groups(sa->bt, B / M, K, groups, &sa->gs))
    return false;
  sa->sd = make_sdims(sa->net, tb);
  sa->extra = 0;
  const long n = carve_stages(sa->net, sa->sd, sa->gs, 0, work, &sa->sc, tb);
  if (floats) *floats = n;
  return true;
}

int make_grads_args(int n_hidden, const int* dims, int T, long B, int A,
                    int M, int K, const int* groups, int mb, const float* obs,
                    const int* action, const float* old_lp,
                    const float* old_v, const float* adv, const float* target,
                    const unsigned char* mask, const float* params,
                    const float* scal, float clip_eps, float clip_lo,
                    float clip_hi, float value_coef, float inv_n, float* work,
                    StageArgs* sa, MlpTables* tb) {
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs, work,
                       sa, tb))
    return (int)cudaErrorInvalidValue;
  sa->bt.action = action;
  sa->bt.old_lp = old_lp;
  sa->bt.old_v = old_v;
  sa->bt.adv = adv;
  sa->bt.target = target;
  sa->bt.mask = mask;
  sa->c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  sa->params = params;
  sa->scal = scal;
  return 0;
}

}  // namespace

// Shared memory of the largest stage's CTA in bytes, or 0 for an
// unsupported shape (the head tile's rows of the last hidden layer grow
// with its width). K5/K6's stages (vtrace_sgd.cu) take the same.
extern "C" long wh_sgd_stage_smem_bytes(int n_hidden, const int* dims) {
  Net net;
  std::vector<Layer> layers;
  return make_net(n_hidden, dims, &net, &layers) ? (long)stage_smem(net) : 0;
}

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape. With K policy groups (`groups`: agent -> group, null for K = 1)
// `dims` are one group's widths and the params K groups'.
extern "C" long wh_sgd_workspace_floats(int n_hidden, const int* dims, int T,
                                        long B, int A, int M, int K,
                                        const int* groups) {
  StageArgs sa;
  MlpTables tb;
  long n = 0;
  return make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                         nullptr, &sa, &tb, &n)
             ? n
             : 0;
}

// Where the stages' rows lie in the workspace, 3 + 3 n_hidden longs
// (mlp_stages.cuh stage_layout: x0, dout, Xs, then act_l, dz_l, Es_l per
// layer). The rows come group after group.
extern "C" int wh_sgd_layout(int n_hidden, const int* dims, int T, long B,
                             int A, int M, int K, const int* groups,
                             long* out) {
  StageArgs sa;
  MlpTables tb;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       base, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  stage_layout(sa, base, out);
  return 0;
}

// K4: the loss and gradient of minibatch mb. `grads` gets the gradient in
// the packed layout (K groups' in group order), sums[0..3] the metric sums
// (min surrogate, max squared value error, entropy, old_lp - lp); the
// workspace keeps the gradient's sums of squares for wh_sgd_clip_adam.
// bf16 != 0: every product on bf16 operands (matmul_dtype="bfloat16").
extern "C" int wh_sgd_grads(
    int n_hidden, const int* dims, int T, long B, int A, int M, int K,
    const int* groups, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* params,
    const float* scal, float clip_eps, float clip_lo, float clip_hi,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    int bf16, void* stream_) {
  StageArgs sa;
  MlpTables tb;
  int err = make_grads_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs,
                            action, old_lp, old_v, adv, target, mask, params,
                            scal, clip_eps, clip_lo, clip_hi, value_coef,
                            inv_n, work, &sa, &tb);
  if (err) return err;
  cudaStream_t stream = (cudaStream_t)stream_;
  cudaError_t e = prep(sa, stream);
  const Stage order[] = {FWD, HEAD_LOSS, DGRAD, WGRAD};
  for (Stage st : order)
    if (e == cudaSuccess) e = run_stage(sa, st, bf16 != 0, stream);
  if (e == cudaSuccess) e = reduce(sa, grads, stream);
  if (e == cudaSuccess) e = metrics(sa, sums, stream);
  return (int)e;
}

// One stage of wh_sgd_grads on the rows the workspace holds (the stages'
// checks and times), after prep (the observation rows, the weight copies):
// 0 fwd (act); 1 head_loss (dout, the last dz, sums[0..3]); 2 dgrad (the
// other dz); 3 wgrad (grads).
extern "C" int wh_sgd_stage(
    int stage, int n_hidden, const int* dims, int T, long B, int A, int M,
    int K, const int* groups, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* params,
    const float* scal, float clip_eps, float clip_lo, float clip_hi,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    int bf16, void* stream_) {
  if (stage < FWD || stage > WGRAD) return (int)cudaErrorInvalidValue;
  StageArgs sa;
  MlpTables tb;
  int err = make_grads_args(n_hidden, dims, T, B, A, M, K, groups, mb, obs,
                            action, old_lp, old_v, adv, target, mask, params,
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

// K3's optimizer step `step` after wh_sgd_grads on the same workspace:
// clip by the global norm of `grads` (all K groups'), then Adam on params /
// m / v in place with lr_row[step], bc1_row[step], bc2_row[step].
extern "C" int wh_sgd_clip_adam(
    int n_hidden, const int* dims, int T, long B, int A, int M, int K,
    const int* groups, int step, float* params, float* m, float* v,
    const float* grads, const float* lr_row, const float* bc1_row,
    const float* bc2_row, float max_grad_norm, float b1, float one_m_b1,
    float b2, float one_m_b2, float eps, float* work, void* stream_) {
  StageArgs sa;
  MlpTables tb;
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       work, &sa, &tb) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {K * sa.net.n_params, K * sa.sc.n_sq1, grads, sa.sc.sq,
                      params, m, v, lr_row, bc1_row, bc2_row, step,
                      max_grad_norm, b1, one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<(unsigned)((p.n + FNT - 1) / FNT), FNT, 0,
                (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}

// The sums of squares of `grads` (the K groups' gradients in wh_sgd_grads'
// layout) as reduce_kernel takes them (launch_sumsq): into `sq` where it is
// not null, else into the workspace, where wh_sgd_clip_adam reads them. The
// meshed route launches it on the gradient averaged over the ranks.
extern "C" int wh_sgd_sumsq(int n_hidden, const int* dims, int T, long B,
                            int A, int M, int K, const int* groups,
                            const float* grads, float* sq, float* work,
                            void* stream_) {
  StageArgs sa;
  MlpTables tb;
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       work, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  return (int)launch_sumsq(grads, sa.net.n_params, K, sq ? sq : sa.sc.sq,
                           (cudaStream_t)stream_);
}

// Where the gradient's sums of squares lie in the workspace: out[0] their
// float offset, out[1] their count (K groups' ceil(n_params / 256)).
extern "C" int wh_sgd_sq_layout(int n_hidden, const int* dims, int T, long B,
                                int A, int M, int K, const int* groups,
                                long* out) {
  StageArgs sa;
  MlpTables tb;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_stage_args(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr,
                       base, &sa, &tb))
    return (int)cudaErrorInvalidValue;
  out[0] = sa.sc.sq - base;
  out[1] = K * sa.sc.n_sq1;
  return 0;
}
