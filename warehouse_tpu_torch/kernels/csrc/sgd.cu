// K3 + K4: the PPO SGD phase of the MLP policy, and one minibatch's
// gradient.
//
// Replaces warehouse_tpu/pallas/sgd.py ppo_sgd_phase_pallas (:691; body
// _sgd_kernel :309 with _loss_and_dout :68, _block_grads :158 and
// _clip_adam_step :226) and ppo_minibatch_grads_pallas (:818; body
// _grads_kernel :404). One optimizer step on minibatch m (env columns
// [m B/M, (m+1) B/M) of the trajectory, N = T * B/M * A samples) is five
// launches on the caller's stream, with no host synchronisation between
// steps, four for the gradient:
//
//   (a) mlp_transpose_kernel, then fwd_bwd_kernel: sample tiles of R rows
//       in shared memory, the weights read from device memory (L2), the
//       first layer over chunks of the observation (mlp_learner.cuh); the
//       CTA loops over tiles. Per tile: MLP forward,
//       the clipped-PPO loss chain and its derivative per row, then the
//       deltas back through the head and the hidden layers. It writes each
//       hidden layer's activation and delta and the head delta to device
//       memory, and one row of metric sums per tile.
//   (b) wgrad_kernel: dW = delta^T * prev and db = sum(delta) per layer
//       as split-K products: 64 x 64 output tiles times S sample ranges,
//       each CTA writing its own partial (no atomics).
//   (c) reduce_kernel: the S partials summed in a fixed order, and the
//       sum of squares of each 256 gradients.
//   (d) metrics_kernel: the metric sums of the step in a fixed order.
//
// That is K4, wh_sgd_grads. K3 follows each K4 step with adam_kernel
// (wh_sgd_clip_adam, one CTA): the global norm in a fixed order, then the
// optax clip + Adam step on params and moments in place, with lr and the
// bias corrections of this step read from device rows. Every sum runs
// in an order fixed by the shapes alone, so two runs on the same inputs
// give the same bits. A tile's rows and one CTA's gradient partials do not
// fit one SM's shared memory together, hence the split into (a) and (b).
// (b)-(d), the dense layers of (a), the loss chain (loss_row) and
// adam_kernel are in mlp_learner.cuh, which the IMPALA learner
// (vtrace_sgd.cu) and the recurrent PPO learner (sgd_rnn.cu) share.
//
// Policy groups (pallas/sgd.py:293-306, _sgd_kernel :309, _grads_kernel
// :404): the params are K MLPs' in group order; sample (t, b, a) goes
// forward and backward through group groups[a]'s params and its weight
// gradients go to that group's slice of the gradient. fwd_bwd_kernel runs
// the groups' tiles one group after another (GroupSplit), the loss still
// averages over all N samples of the minibatch, the metric sums run over
// every sample, and one global-norm clip and Adam span all K groups.
//
// The bound: at config 4 a step is ~6.3 GFLOP in (a) and ~4 GFLOP in (b)
// on the CUDA cores in f32. (a) is limited by its loads: a thread owns one
// output column for RT rows, reading its weights through L2 (a warp on
// neighbouring addresses) and the rows as shared-memory broadcasts. (b)
// keeps a 4 x 4 register tile per thread.
//
// bf16 operands (matmul_dtype="bfloat16", _block_grads' dot at
// sgd.py:188-191): fwd_bwd_kernel, the transposed copy and wgrad_kernel are
// instantiated with mlp_learner.cuh's flag BF, chosen per call of
// wh_sgd_grads (groups and the chunked first layer alike); the float32
// instances are the code the route had before. Each product rounds its
// operands to bf16 and sums in float32 on the CUDA cores, as the f32 route
// does (no tensor-core path yet).
//
// Tie rules, as the TPU kernel writes them (_block_grads, sgd.py:170-179):
// a tie of the surrogate min routes the whole gradient to the unclipped
// branch (pg1 <= pg2), a tie of the value max to the unclipped error
// (sq1 >= sq2); jax.grad and torch split such ties 0.5/0.5. Both agree
// at the epoch-0 ratio == 1 ties, where the two branches have the same
// derivative; they differ only at a tie exactly on a clip bound. The
// clip bounds themselves pass gradient 1, as jnp.clip and torch.clamp do.

#include <cuda_runtime.h>

#include "mlp_learner.cuh"

namespace {

// ---- (a) forward, loss, backward -------------------------------------------

struct FwdArgs {
  Net net;
  Batch bt;
  GroupSplit gs;  // the minibatch's samples by policy group
  Scratch sc;
  Coefs c;
  const float* params;
  const float* scal;  // ent_coef, kl_coeff
};

template <bool BF>
__global__ void __launch_bounds__(NT) fwd_bwd_kernel(FwdArgs p) {
  extern __shared__ float smem[];
  const Net& net = p.net;
  const int tid = threadIdx.x;
  const TileBufs b = tile_bufs(net, smem);
  const float ent_coef = p.scal[0], kl_coeff = p.scal[1];
  const Batch& bt = p.bt;
  const int D = net.D;

  for (long tile = blockIdx.x; tile < p.gs.toff[p.gs.K]; tile += gridDim.x) {
    // The tile's group; its samples are that group's [q0, q0 + nvalid),
    // its rows in the scratch from n0 on.
    int g = 0;
    while (g + 1 < p.gs.K && tile >= p.gs.toff[g + 1]) ++g;
    const Rows rows = p.gs.rows[g];
    const long q0 = (tile - p.gs.toff[g]) * R, n0 = p.gs.noff[g] + q0;
    const int nvalid = rows.N - q0 < R ? (int)(rows.N - q0) : R;
    const float* params = p.params + g * net.n_params;
    if (tid < R)
      b.rows[tid] = tid < nvalid ? bt.obs + rows.row(q0 + tid) * D : nullptr;
    __syncthreads();
    fwd_tile<BF>(net, params, p.sc.wt + g * net.n_params, b, p.sc, n0,
                 nvalid);

    if (tid < R) {
      float* o = b.outs + tid * OST;
      float* m = b.met + tid * 4;
      if (tid < nvalid) {
        loss_row(o, rows.row(q0 + tid), bt, p.c, ent_coef, kl_coeff, m);
        for (int r = 0; r < NHEAD; ++r)
          p.sc.dout[(n0 + tid) * OST + r] = o[r];
      } else {
        for (int r = 0; r < NHEAD; ++r) o[r] = 0.f;
        for (int k = 0; k < 4; ++k) m[k] = 0.f;
      }
    }
    __syncthreads();
    if (tid < 4) {  // fixed-order sum over the tile's rows
      float s = 0.f;
      for (int n = 0; n < R; ++n) s += b.met[n * 4 + tid];
      p.sc.met[tile * 4 + tid] = s;
    }
    bwd_tile<BF>(net, params, b, p.sc, n0, nvalid);
  }
}

template <bool BF>
cudaError_t launch_fwd_bwd(const FwdArgs& fa, cudaStream_t stream) {
  const size_t smem = smem_bytes(fa.net);
  long grid = 0;
  cudaError_t e = persistent_grid(fwd_bwd_kernel<BF>, smem,
                                  fa.gs.toff[fa.gs.K], &grid);
  if (e != cudaSuccess) return e;
  fwd_bwd_kernel<BF><<<(unsigned)grid, NT, smem, stream>>>(fa);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one (a) CTA in bytes (more than the device allows for
// hidden layers too wide to keep a tile's rows), or 0 for an unsupported
// shape. The IMPALA learner's tile kernels (vtrace_sgd.cu) use the same
// layout.
extern "C" long wh_sgd_smem_bytes(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (long)smem_bytes(net) : 0;
}

// The chunks of XCH columns the first layer runs over for these widths
// (more than 1: an observation wider than one chunk), or -1 for an
// unsupported shape. K5/K6 take the same.
extern "C" int wh_sgd_obs_chunks(int n_hidden, const int* dims) {
  Net net;
  return make_net(n_hidden, dims, &net) ? (net.D + XCH - 1) / XCH : -1;
}

namespace {

// The net, the minibatch mb's rows and their split by the K groups of
// `groups` (null: one group).
bool make_groups(int n_hidden, const int* dims, int T, long B, int A, int M,
                 int K, const int* groups, int mb, const float* obs, Net* net,
                 Rows* rows, GroupSplit* gs) {
  return make_rows(n_hidden, dims, T, B, A, M, mb, obs, net, rows) &&
         split_groups(*rows, B / M, K, groups, gs);
}

}  // namespace

// Floats of scratch the two entry points below share, or 0 for an
// unsupported shape. With K policy groups (`groups`: agent -> group, null
// for K = 1) `dims` are one group's widths and the params K groups'.
extern "C" long wh_sgd_workspace_floats(int n_hidden, const int* dims, int T,
                                        long B, int A, int M, int K,
                                        const int* groups) {
  Net net;
  Rows rows;
  GroupSplit gs;
  if (!make_groups(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr, &net,
                   &rows, &gs))
    return 0;
  Scratch sc;
  return carve(net, rows.N, 0, nullptr, &sc, K);
}

// K4: the loss and gradient of minibatch mb (kernels a-c and the metric
// sums). `grads` gets the gradient in the packed layout (K groups' in
// group order), sums[0..3] the metric sums (min surrogate, max squared
// value error, entropy, old_lp - lp); the workspace keeps the gradient's
// sums of squares for wh_sgd_clip_adam. bf16 != 0: every product on bf16
// operands (matmul_dtype="bfloat16").
extern "C" int wh_sgd_grads(
    int n_hidden, const int* dims, int T, long B, int A, int M, int K,
    const int* groups, int mb, const float* obs, const int* action,
    const float* old_lp, const float* old_v, const float* adv,
    const float* target, const unsigned char* mask, const float* params,
    const float* scal, float clip_eps, float clip_lo, float clip_hi,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    int bf16, void* stream_) {
  FwdArgs fa;
  if (!make_groups(n_hidden, dims, T, B, A, M, K, groups, mb, obs, &fa.net,
                   &fa.bt, &fa.gs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  fa.bt.action = action;
  fa.bt.old_lp = old_lp;
  fa.bt.old_v = old_v;
  fa.bt.adv = adv;
  fa.bt.target = target;
  fa.bt.mask = mask;
  carve(fa.net, fa.bt.N, 0, work, &fa.sc, K);
  fa.c = Coefs{clip_eps, clip_lo, clip_hi, value_coef, inv_n};
  fa.params = params;
  fa.scal = scal;

  cudaError_t e =
      launch_mlp_transpose(fa.net, params, fa.sc, stream, K, bf16 != 0);
  if (e != cudaSuccess) return (int)e;
  e = bf16 ? launch_fwd_bwd<true>(fa, stream) : launch_fwd_bwd<false>(fa, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_group_grads_tail(fa.net, fa.gs, fa.sc, grads, sums,
                                      stream, bf16 != 0);
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
  Net net;
  Rows rows;
  GroupSplit gs;
  if (!make_groups(n_hidden, dims, T, B, A, M, K, groups, 0, nullptr, &net,
                   &rows, &gs) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  Scratch sc;
  carve(net, rows.N, 0, work, &sc, K);
  const AdamArgs p = {K * net.n_params, sc.n_sq, grads, sc.sq, params, m, v,
                      lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
