// K5 + K6: the IMPALA learner phase of the MLP policy (V-trace), and one
// minibatch's V-trace loss gradient.
//
// Replaces warehouse_tpu/pallas/vtrace_sgd.py impala_sgd_phase_pallas
// (:445; body _impala_kernel :280 with _learner_block :131 and
// _clip_rms_step :72) and impala_minibatch_grads_pallas (:553; body
// _grads_impala_kernel :360). Minibatch m is env columns [m B/M, (m+1)
// B/M) of the trajectory: N = T * B/M * A samples in Rows::row order, then
// the minibatch's nb = B/M * A last-obs rows (the bootstrap states V(s_T)).
//
// One minibatch's gradient (K6, wh_vtrace_grads) is stages shaped by their
// products, each a kernel on the caller's stream, with no host
// synchronisation. Every product runs over all of the minibatch's rows at
// once as a tile GEMM, on the stages the PPO learner runs (mlp_stages.cuh:
// row_stages.cuh on mma_tiles.cuh); what stays per row or per trace is a
// thin stage between them:
//
//   prep: the N sample rows and the nb last-obs rows gathered into x0
//      [N + nb, Xs], and each hidden layer's W copied zero-padded.
//   fwd: act_l = tanh(act_{l-1} W_l^T + b_l) for each hidden layer over
//      all N + nb rows (the last-obs rows are more rows of the same GEMM).
//   head: tiles of 64 rows of the last layer in shared memory, the 6-wide
//      head (5 logits and the value) of every row into dout [N + nb, OST].
//   trace: one thread per (env, agent) trace runs the reverse-T loop of
//      ops/vtrace.py in its op order (rho, the clipped rho and c, the next
//      value with the bootstrap_values blend, delta, acc, vs,
//      pg_advantage), the bootstrap value from the last-obs rows, and
//      writes d(mean loss)/d(head output) of each sample over its head
//      outputs, as vtrace_sgd.py:240-254 computes them: masked logits
//      floored at -1e9 and their deltas zeroed; vs and pg_advantage enter as
//      constants (stop-gradient). One row of metric sums (lp * pg_adv,
//      (v - vs)^2, entropy) per CTA, then metrics_kernel adds the rows.
//   dgrad: dz_L = (dout W_head) (1 - act_L^2) in 64-row tiles (the back
//      half of the PPO learner's head tile), then dz_{l-1} = (dz_l W_l)
//      (1 - act_{l-1}^2) as tile GEMMs, over the N sample rows only: the
//      last-obs rows feed V-trace as stop-gradient values.
//   wgrad: every weight gradient over the N sample rows, split-K
//      (wgrad_tn_kernel, head_wgrad_kernel), then reduce_kernel.
//
// K5 follows each gradient with rms_kernel (wh_vtrace_clip_rms: the global
// norm in a fixed order, optax's clip, then the RMSProp step) or
// mlp_learner.cuh's adam_kernel (wh_vtrace_clip_adam), each on a grid of
// CTAs that compute the same norm, on params and moments in place, the
// step's lr read from a device row. Every sum runs in an order fixed by the
// shapes alone, so two runs on the same inputs give the same bits. The
// learner is float32 only: the JAX trainer never runs it on bf16 operands.
//
// Why the trace is a stage of its own, where the TPU's _learner_block runs
// forward, V-trace and backward in one grid step per env block: a trace
// needs all T values of an (env, agent) before any of its deltas, so one
// kernel would hold all T x A rows of its envs; cut at the trace, each
// product runs over all rows and any T and A fit.
//
// The bound is the products' rate: per step at config 4 ~4.3 GFLOP forward
// on the samples and ~0.3 on the last-obs rows, ~2.2 in the dgrads and
// ~4.3 in the weight gradients; the trace is T dependent steps of ~100
// flops and a few transcendentals per trace, nb threads.

#include <cuda_runtime.h>

#include "mlp_stages.cuh"

namespace {

constexpr int VNT = 256;  // threads of vt_trace_kernel, one trace each

struct Traj : Rows {  // one minibatch of the IMPALA trajectory
  const float* last_obs;       // [B, A, D] bootstrap observations
  const int* action;           // [T, B, A]
  const float *blp, *reward;   // behavior log-prob, reward [T, B, A]
  const unsigned char* done;   // [T, B, A]
  const unsigned char* mask;   // [T, B, A, 5] or null
  const float* boot;           // [T, B, A] bootstrap values, or null
};

struct VtCoefs {
  float gamma, rho_clip, c_clip, value_coef, inv_n;
};

// MlpStage's rows: the N samples (one group), then extra = nb last-obs
// rows; sc.dout holds every row's head outputs, then the samples' deltas.
struct VtArgs : MlpStage {
  Traj tj;
  VtCoefs c;
  const float* scal;  // ent_coef
};

long n_traces(const VtArgs& va) { return (va.tj.nb + VNT - 1) / VNT; }

// ---- prep: the padded weight copies, the sample and last-obs rows --------

// The first MAXJ weight copies (prep_plan), the sample and last-obs rows.
__global__ void vt_prep_kernel(VtArgs p, PadJobs pj) {
  const long i0 = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  run_pad_jobs(pj, i0, stride);
  const Traj& tj = p.tj;
  const int D = p.net.D, Xs = p.sd.Xs, lane = threadIdx.x & 31;
  const long warps = stride / 32;
  for (long q = i0 / 32; q < tj.N + tj.nb; q += warps)
    gather_row(q < tj.N ? tj.obs + tj.row(q) * D
                        : tj.last_obs + (tj.mb_off + q - tj.N) * D,
               p.sc.x0 + q * Xs, D, Xs, lane);
}

// ---- head: the head outputs of every row ----------------------------------

__global__ void __launch_bounds__(GNT) vt_head_kernel(VtArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Layer& hd = p.net.head;
  const int H = hd.in;
  float* hsm = smem;                     // [CB][H + HPAD]
  float* outs = hsm + CB * (H + HPAD);   // [CB][OST]
  const long n0 = (long)blockIdx.x * CB, rows = p.tj.N + p.tj.nb;
  const int nvalid = rows - n0 < CB ? (int)(rows - n0) : CB;
  load_head_rows(hsm, p.sc.act_last, p.sd.Es_last, H, n0, nvalid);
  __syncthreads();
  head_fwd_rows<false>(hsm, H, p.params + hd.w_off, p.params + hd.b_off,
                       outs);
  __syncthreads();
  for (int i = threadIdx.x; i < nvalid * OST; i += GNT) {
    const int r = i % OST;
    p.sc.dout[n0 * OST + i] = r < NHEAD ? outs[i] : 0.f;
  }
}

// ---- trace: V-trace and the loss derivative, one thread per trace --------

__global__ void __launch_bounds__(VNT) vt_trace_kernel(VtArgs p) {
  __shared__ float red[3][VNT];
  const Traj& tj = p.tj;
  const VtCoefs& c = p.c;
  const int tid = threadIdx.x;
  const long j = (long)blockIdx.x * VNT + tid;
  float m_pg = 0.f, m_v = 0.f, m_ent = 0.f;
  if (j < tj.nb) {
    const int T = (int)(tj.N / tj.nb);
    const float ent_scale = p.scal[0] * c.inv_n;
    const float last_v = p.sc.dout[(tj.N + j) * OST + NACT];
    float v_next = last_v, vs_next = last_v, acc = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      const long q = t * tj.nb + j, gi = tj.row(q);
      float* o = p.sc.dout + q * OST;
      bool valid[NACT];
      float logit[NACT];
#pragma unroll
      for (int r = 0; r < NACT; ++r) {
        valid[r] = !tj.mask || tj.mask[gi * NACT + r];
        logit[r] = valid[r] ? o[r] : NEG_INF;
      }
      const float v = o[NACT];
      float mx = logit[0];
#pragma unroll
      for (int r = 1; r < NACT; ++r) mx = fmaxf(mx, logit[r]);
      float ssum = 0.f;
#pragma unroll
      for (int r = 0; r < NACT; ++r) ssum += expf(logit[r] - mx);
      const float lse = mx + logf(ssum);
      const int a = tj.action[gi];
      float logp[NACT], prob[NACT], lp = 0.f, ent = 0.f;
#pragma unroll
      for (int r = 0; r < NACT; ++r) {
        logp[r] = logit[r] - lse;
        prob[r] = expf(logp[r]);
        if (a == r) lp = logp[r];
        ent = ent - prob[r] * logp[r];
      }

      // V-trace in ops/vtrace.py's op order.
      const float rho = expf(lp - tj.blp[gi]);
      const float crho = fminf(rho, c.rho_clip), cs = fminf(rho, c.c_clip);
      const float nd = tj.done[gi] ? 0.f : 1.f;
      const float bv = tj.boot ? tj.boot[gi] : 0.f;
      const float rew = tj.reward[gi];
      const float vn = nd * v_next + (1.f - nd) * bv;
      acc = crho * (rew + c.gamma * vn - v) + c.gamma * nd * cs * acc;
      const float vs = v + acc;
      const float vsn = nd * vs_next + (1.f - nd) * bv;
      const float pg = crho * (rew + c.gamma * vsn - v);
      const float verr = v - vs;
      m_pg += lp * pg;
      m_v += verr * verr;
      m_ent += ent;

      // d(pg_loss + value_coef * v_loss - ent_coef * entropy) / d(out).
      const float d_lp = -pg * c.inv_n;
#pragma unroll
      for (int r = 0; r < NACT; ++r) {
        const float d = d_lp * ((a == r ? 1.f : 0.f) - prob[r]) +
                        ent_scale * prob[r] * (logp[r] + ent);
        o[r] = valid[r] ? d : 0.f;
      }
      o[NACT] = c.value_coef * c.inv_n * verr;
      v_next = v;
      vs_next = vs;
    }
  }
  red[0][tid] = m_pg;
  red[1][tid] = m_v;
  red[2][tid] = m_ent;
  __syncthreads();
  for (int w = VNT / 2; w > 0; w >>= 1) {  // fixed-order tree
    if (tid < w)
      for (int k = 0; k < 3; ++k) red[k][tid] += red[k][tid + w];
    __syncthreads();
  }
  if (tid < 4) p.sc.met[blockIdx.x * 4 + tid] = tid < 3 ? red[tid][0] : 0.f;
}

// ---- dgrad: the last layer's delta from the head's ------------------------

__global__ void __launch_bounds__(GNT) vt_head_dz_kernel(VtArgs p) {
  extern __shared__ __align__(16) float smem[];
  const Layer& hd = p.net.head;
  const int H = hd.in, Es = p.sd.Es_last;
  float* hsm = smem;                     // [CB][H + HPAD]
  float* outs = hsm + CB * (H + HPAD);   // [CB][OST] the head's deltas
  const long n0 = (long)blockIdx.x * CB;
  const int nvalid = p.tj.N - n0 < CB ? (int)(p.tj.N - n0) : CB;
  load_head_rows(hsm, p.sc.act_last, Es, H, n0, nvalid);
  for (int i = threadIdx.x; i < CB * OST; i += GNT) {
    const int n = i / OST, r = i % OST;
    outs[i] = n < nvalid && r < NHEAD ? p.sc.dout[n0 * OST + i] : 0.f;
  }
  __syncthreads();
  head_dz_rows<false>(outs, hsm, H, Es, p.params + hd.w_off,
                      p.sc.dz_last + n0 * Es, nvalid);
}

// ---- the RMSProp step ----------------------------------------------------

struct RmsArgs {
  long n, n_sq;
  const float *grads, *sq;
  float *params, *nu;
  const float* lr_row;
  int step;
  float max_grad_norm, decay, one_m_decay, eps;
};

// optax.chain(clip_by_global_norm, rmsprop(lr, decay, eps)) in its op
// order (optax scale_by_rms; _clip_rms_step, vtrace_sgd.py:72-89): the
// clip as in adam_kernel, nu = (1 - decay) g^2 + decay nu, update =
// -lr * (rsqrt(nu + eps) * g), the rsqrt a correctly rounded sqrt then
// reciprocal. On a grid of CTAs, as adam_kernel.
__global__ void __launch_bounds__(FNT) rms_kernel(RmsArgs p) {
  __shared__ float norm_s;
  global_norm(p.sq, p.n_sq, &norm_s);
  const float norm = norm_s, maxn = p.max_grad_norm;
  const bool keep = norm < maxn;
  const float lr = p.lr_row[p.step];
  for (long k = (long)blockIdx.x * FNT + threadIdx.x; k < p.n;
       k += (long)gridDim.x * FNT) {
    float g = p.grads[k];
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), maxn);
    const float nu = __fadd_rn(__fmul_rn(p.one_m_decay, __fmul_rn(g, g)),
                               __fmul_rn(p.decay, p.nu[k]));
    p.nu[k] = nu;
    const float u = __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(nu, p.eps))), g);
    p.params[k] = __fsub_rn(p.params[k], __fmul_rn(lr, u));
  }
}

// ---- host side -------------------------------------------------------------

// The stages, in the order of the wrapper's VT_STAGES, then the prep.
// run_vt_stage adds the kernels it launched to launched[st]: the trace's
// with the metric sums, the weight gradients' with the reduce.
enum VtStage { V_FWD, V_HEAD, V_TRACE, V_DGRAD, V_WGRAD, V_PREP };

cudaError_t run_vt_stage(const VtArgs& va, int st, float* grads, float* sums,
                         long* launched, cudaStream_t stream) {
  const size_t smem = smem_head(va.net);
  cudaError_t e = cudaSuccess;
  switch (st) {
    case V_FWD:
      return fwd_stage<false>(va, stream, launched + V_FWD);
    case V_HEAD:
      if ((e = opt_in(vt_head_kernel, smem)) != cudaSuccess) return e;
      vt_head_kernel<<<(unsigned)((va.tj.N + va.tj.nb + CB - 1) / CB), GNT,
                       smem, stream>>>(va);
      break;
    case V_TRACE:
      vt_trace_kernel<<<(unsigned)n_traces(va), VNT, 0, stream>>>(va);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++launched[V_TRACE];
      metrics_kernel<<<1, 128, 0, stream>>>(va.sc.met, n_traces(va), sums);
      break;
    case V_DGRAD:
      if ((e = opt_in(vt_head_dz_kernel, smem)) != cudaSuccess) return e;
      vt_head_dz_kernel<<<(unsigned)((va.tj.N + CB - 1) / CB), GNT, smem,
                          stream>>>(va);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++launched[V_DGRAD];
      return dgrad_stage<false>(va, stream, launched + V_DGRAD);
    case V_WGRAD:
      if ((e = wgrad_stage<false>(va, stream, launched + V_WGRAD)) !=
          cudaSuccess)
        return e;
      return reduce(va, grads, stream, launched + V_WGRAD);
    case V_PREP: {
      const PadPlan plan = prep_plan(va);
      vt_prep_kernel<<<1024, 256, 0, stream>>>(va, plan.batch(0));
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++launched[st];
      return plan.launch_rest(1024, 256, stream, launched + st);
    }
    default:
      return cudaErrorInvalidValue;
  }
  if ((e = cudaGetLastError()) == cudaSuccess) ++launched[st];
  return e;
}

// The net, minibatch mb's rows (one group) and its last-obs rows, the
// stages' widths, and the scratch laid out from `work` (or only sized, when
// it is null); the per-layer tables in *tb.
bool make_vt_args(int n_hidden, const int* dims, int T, long B, int A, int M,
                  int mb, const float* obs, float* work, VtArgs* va,
                  MlpTables* tb, long* floats = nullptr) {
  if (!make_rows(n_hidden, dims, T, B, A, M, mb, obs, &va->net, &va->tj,
                 &tb->L) ||
      !split_groups(va->tj, B / M, 1, nullptr, &va->gs))
    return false;
  va->sd = make_sdims(va->net, tb);
  va->extra = va->tj.nb;
  const long n = carve_stages(va->net, va->sd, va->gs, va->extra, work,
                              &va->sc, tb);
  if (floats) *floats = n;
  return true;
}

}  // namespace

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape. Their largest stage takes wh_sgd_stage_smem_bytes of shared
// memory.
extern "C" long wh_vtrace_workspace_floats(int n_hidden, const int* dims,
                                           int T, long B, int A, int M) {
  VtArgs va;
  MlpTables tb;
  long n = 0;
  return make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, nullptr, &va,
                      &tb, &n)
             ? n
             : 0;
}

// Where the stages' rows lie in the workspace, as wh_sgd_layout gives them:
// x0, act and dout hold N + nb rows (the samples', then the last-obs
// rows), dz N.
extern "C" int wh_vtrace_layout(int n_hidden, const int* dims, int T, long B,
                                int A, int M, long* out) {
  VtArgs va;
  MlpTables tb;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, base, &va, &tb))
    return (int)cudaErrorInvalidValue;
  stage_layout(va, base, out);
  return 0;
}

// K6: the V-trace loss and gradient of minibatch mb, with stage -1: the
// prep, the five stages, the reduce and the metric sums. `grads` gets the
// gradient in the packed layout, sums[0..2] the metric sums (lp * pg_adv,
// (v - vs)^2, entropy; sums[3] = 0); the workspace keeps the gradient's
// sums of squares for the optimizer step. Stage 0..4 runs that stage alone
// on the rows the workspace holds (the stages' checks and times): 0 fwd
// (act); 1 head (every row's head outputs in dout); 2 trace (the samples'
// head deltas over their outputs, sums); 3 dgrad (dz); 4 wgrad (grads);
// stage 5 the prep alone (the sample and last-obs rows, the weight
// copies). launched[0..5], where given, gets each stage's kernels added.
extern "C" int wh_vtrace_grads(
    int stage, int n_hidden, const int* dims, int T, long B, int A, int M,
    int mb, const float* obs, const float* last_obs, const int* action,
    const float* blp, const float* reward, const unsigned char* done,
    const unsigned char* mask, const float* boot, const float* params,
    const float* scal, float gamma, float rho_clip, float c_clip,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    long* launched, void* stream_) {
  VtArgs va;
  MlpTables tb;
  long unused[V_PREP + 1] = {};
  if (!launched) launched = unused;
  if (stage < -1 || stage > V_PREP ||
      !make_vt_args(n_hidden, dims, T, B, A, M, mb, obs, work, &va, &tb))
    return (int)cudaErrorInvalidValue;
  va.tj.last_obs = last_obs;
  va.tj.action = action;
  va.tj.blp = blp;
  va.tj.reward = reward;
  va.tj.done = done;
  va.tj.mask = mask;
  va.tj.boot = boot;
  va.c = VtCoefs{gamma, rho_clip, c_clip, value_coef, inv_n};
  va.params = params;
  va.scal = scal;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (stage >= 0)
    return (int)run_vt_stage(va, stage, grads, sums, launched, stream);
  const int order[] = {V_PREP, V_FWD, V_HEAD, V_TRACE, V_DGRAD, V_WGRAD};
  cudaError_t e = cudaSuccess;
  for (int st : order)
    if (e == cudaSuccess)
      e = run_vt_stage(va, st, grads, sums, launched, stream);
  return (int)e;
}

// K5's RMSProp step `step` after wh_vtrace_grads on the same workspace:
// clip by the global norm of `grads`, then RMSProp on params / nu in place
// with lr_row[step].
extern "C" int wh_vtrace_clip_rms(
    int n_hidden, const int* dims, int T, long B, int A, int M, int step,
    float* params, float* nu, const float* grads, const float* lr_row,
    float max_grad_norm, float decay, float one_m_decay, float eps,
    float* work, void* stream_) {
  VtArgs va;
  MlpTables tb;
  if (!make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, work, &va, &tb) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  const RmsArgs p = {va.net.n_params, va.sc.n_sq1, grads, va.sc.sq, params,
                     nu, lr_row, step, max_grad_norm, decay, one_m_decay,
                     eps};
  rms_kernel<<<(unsigned)((p.n + FNT - 1) / FNT), FNT, 0,
               (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}

// K5's Adam step `step` after wh_vtrace_grads on the same workspace, as
// wh_sgd_clip_adam.
extern "C" int wh_vtrace_clip_adam(
    int n_hidden, const int* dims, int T, long B, int A, int M, int step,
    float* params, float* m, float* v, const float* grads,
    const float* lr_row, const float* bc1_row, const float* bc2_row,
    float max_grad_norm, float b1, float one_m_b1, float b2, float one_m_b2,
    float eps, float* work, void* stream_) {
  VtArgs va;
  MlpTables tb;
  if (!make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, work, &va, &tb) ||
      step < 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {va.net.n_params, va.sc.n_sq1, grads, va.sc.sq, params,
                      m, v, lr_row, bc1_row, bc2_row, step, max_grad_norm,
                      b1, one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<(unsigned)((p.n + FNT - 1) / FNT), FNT, 0,
                (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}

// The sums of squares of `grads` (wh_vtrace_grads' layout) as reduce_kernel
// takes them (launch_sumsq): into `sq` where it is not null, else into the
// workspace, where wh_vtrace_clip_rms / wh_vtrace_clip_adam read them. The
// meshed route launches it on the gradient averaged over the ranks.
extern "C" int wh_vtrace_sumsq(int n_hidden, const int* dims, int T, long B,
                               int A, int M, const float* grads, float* sq,
                               float* work, void* stream_) {
  VtArgs va;
  MlpTables tb;
  if (!make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, work, &va, &tb))
    return (int)cudaErrorInvalidValue;
  return (int)launch_sumsq(grads, va.net.n_params, 1, sq ? sq : va.sc.sq,
                           (cudaStream_t)stream_);
}

// Where the gradient's sums of squares lie in the workspace: out[0] their
// float offset, out[1] their count.
extern "C" int wh_vtrace_sq_layout(int n_hidden, const int* dims, int T,
                                   long B, int A, int M, long* out) {
  VtArgs va;
  MlpTables tb;
  float* base = reinterpret_cast<float*>(256);  // offsets from a fake base
  if (!make_vt_args(n_hidden, dims, T, B, A, M, 0, nullptr, base, &va, &tb))
    return (int)cudaErrorInvalidValue;
  out[0] = va.sc.sq - base;
  out[1] = va.sc.n_sq1;
  return 0;
}
