// K5 + K6: the IMPALA learner phase of the MLP policy (V-trace), and one
// minibatch's V-trace loss gradient.
//
// Replaces warehouse_tpu/pallas/vtrace_sgd.py impala_sgd_phase_pallas
// (:445; body _impala_kernel :280 with _learner_block :131 and
// _clip_rms_step :72) and impala_minibatch_grads_pallas (:553; body
// _grads_impala_kernel :360). One gradient step on minibatch m (env
// columns [m B/M, (m+1) B/M) of the trajectory, N = T * B/M * A samples
// in time-major order, as in sgd.cu) is six launches on the caller's
// stream, with no host synchronisation between steps:
//
//   (a) vt_fwd_kernel: tiles of R rows over the N samples, then the
//       nb = B/M * A last-obs rows of the minibatch (the bootstrap states
//       V(s_T)), after mlp_transpose_kernel. The weights are read from
//       device memory (L2), the first layer over chunks of the observation
//       (mlp_learner.cuh). MLP forward; it writes the samples' hidden
//       activations and
//       every row's head outputs (5 logits + value).
//   (b) vt_trace_kernel: one thread per (env, agent) trace runs the
//       reverse-T loop of ops/vtrace.py in its op order (rho, the clipped
//       rho and c, the next value with the bootstrap_values blend, delta,
//       acc, vs, pg_advantage), and writes d(mean loss)/d(head output) of
//       each sample over its head outputs, as vtrace_sgd.py:243-251
//       computes them: masked logits floored at -1e9 and their deltas
//       zeroed; vs and pg_advantage enter as constants (stop-gradient).
//       One row of metric sums (lp * pg_adv, (v - vs)^2, entropy) per CTA.
//   (c) vt_bwd_kernel: tiles of R samples; the head deltas back through
//       the head and the hidden layers, from the activations (a) wrote.
//   (d) wgrad_kernel, reduce_kernel, metrics_kernel of mlp_learner.cuh,
//       as in K4.
//
// That is K6, wh_vtrace_grads. K5 follows each step with rms_kernel
// (wh_vtrace_clip_rms: the global norm in a fixed order, optax's clip,
// then the RMSProp step) or mlp_learner.cuh's adam_kernel
// (wh_vtrace_clip_adam), on params and moments in place, the step's lr
// read from a device row. Every sum runs in an order fixed by the shapes,
// so two runs on the same inputs give the same bits.
//
// Why the trace is a kernel of its own, where the TPU's _learner_block
// runs forward, V-trace and backward in one grid step per env block: a
// trace needs all T values of an (env, agent) before any of its deltas,
// so a fused tile would hold all T x A slots of its envs: at A = 6
// (shelves) and T = 16 that is 96 rows of activations, half again the
// tile of (a) and (c). Cutting at the trace costs
// the activations' round trip through device memory (~67 MB per step at
// config 4, tens of microseconds against milliseconds of FMAs) and takes
// any T and A.
//
// The bound is that of K4: (a) and (c) together are the FMAs of fwd_bwd in
// sgd.cu (~6.3 GFLOP per step at config 4, on the CUDA cores in f32),
// (d) ~4 GFLOP; (b) is T dependent steps of ~100 flops and a few
// transcendentals per trace, ~nb threads.

#include <cuda_runtime.h>

#include "mlp_learner.cuh"

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

struct VtArgs {
  Net net;
  Traj tj;
  Scratch sc;  // sc.dout: [N + nb, OST] head outputs, then deltas
  VtCoefs c;
  const float* params;
  const float* scal;  // ent_coef
};

// ---- (a) forward of the samples and the last-obs rows -------------------

__global__ void __launch_bounds__(NT) vt_fwd_kernel(VtArgs p) {
  extern __shared__ float smem[];
  const Net& net = p.net;
  const Traj& tj = p.tj;
  const int D = net.D, tid = threadIdx.x;
  const TileBufs b = tile_bufs(net, smem);

  const long n_rows = tj.N + tj.nb;
  const long n_tiles = (n_rows + R - 1) / R;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long n0 = tile * R;
    const int nrow = n_rows - n0 < R ? (int)(n_rows - n0) : R;
    const long ns = tj.N - n0;  // sample rows of the tile (activations)
    const int nact = ns <= 0 ? 0 : (ns < R ? (int)ns : R);
    if (tid < R) {
      const long q = n0 + tid;
      const float* row = nullptr;
      if (tid < nrow)
        row = q < tj.N ? tj.obs + tj.row(q) * D
                       : tj.last_obs + (tj.mb_off + q - tj.N) * D;
      b.rows[tid] = row;
    }
    __syncthreads();
    fwd_tile(net, p.params, p.sc.wt, b, p.sc, n0, nact);
    for (int k = tid; k < nrow * NHEAD; k += NT) {
      const int n = k / NHEAD, r = k % NHEAD;
      p.sc.dout[(n0 + n) * OST + r] = b.outs[n * OST + r];
    }
  }
}

// ---- (b) V-trace and the loss derivative, one thread per trace ----------

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

// ---- (c) backward from the head deltas -----------------------------------

__global__ void __launch_bounds__(NT) vt_bwd_kernel(VtArgs p) {
  extern __shared__ float smem[];
  const Net& net = p.net;
  const int tid = threadIdx.x;
  const TileBufs b = tile_bufs(net, smem);

  for (long tile = blockIdx.x; tile < p.sc.n_tiles; tile += gridDim.x) {
    const long n0 = tile * R;
    const int nvalid = p.tj.N - n0 < R ? (int)(p.tj.N - n0) : R;
    for (int k = tid; k < R * OST; k += NT) {
      const int n = k / OST, r = k % OST;
      b.outs[k] = n < nvalid && r < NHEAD ? p.sc.dout[(n0 + n) * OST + r]
                                          : 0.f;
    }
    for (int l = 0; l < net.n_hidden; ++l) {
      const int H = net.L[l].out;
      for (int k = tid; k < R * H; k += NT) {
        const int n = k / H;
        b.hs[l][k] = n < nvalid ? p.sc.act[l][(n0 + n) * H + k % H] : 0.f;
      }
    }
    __syncthreads();
    bwd_tile(net, p.params, b, p.sc, n0, nvalid);
  }
}

// (a), (b) and (c).
cudaError_t launch_tiles(const VtArgs& va, cudaStream_t stream) {
  const size_t smem = smem_bytes(va.net);
  long grid_f = 0, grid_b = 0;
  const long n_vblocks = (va.tj.nb + VNT - 1) / VNT;
  cudaError_t e = persistent_grid(vt_fwd_kernel, smem,
                                  (va.tj.N + va.tj.nb + R - 1) / R, &grid_f);
  if (e == cudaSuccess)
    e = persistent_grid(vt_bwd_kernel, smem, va.sc.n_tiles, &grid_b);
  if (e != cudaSuccess) return e;
  vt_fwd_kernel<<<(unsigned)grid_f, NT, smem, stream>>>(va);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  vt_trace_kernel<<<(unsigned)n_vblocks, VNT, 0, stream>>>(va);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  vt_bwd_kernel<<<(unsigned)grid_b, NT, smem, stream>>>(va);
  return cudaGetLastError();
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
// reciprocal.
__global__ void __launch_bounds__(FNT) rms_kernel(RmsArgs p) {
  __shared__ float norm_s;
  global_norm(p.sq, p.n_sq, &norm_s);
  const float norm = norm_s, maxn = p.max_grad_norm;
  const bool keep = norm < maxn;
  const float lr = p.lr_row[p.step];
  for (long k = threadIdx.x; k < p.n; k += FNT) {
    float g = p.grads[k];
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), maxn);
    const float nu = __fadd_rn(__fmul_rn(p.one_m_decay, __fmul_rn(g, g)),
                               __fmul_rn(p.decay, p.nu[k]));
    p.nu[k] = nu;
    const float u = __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(nu, p.eps))), g);
    p.params[k] = __fsub_rn(p.params[k], __fmul_rn(lr, u));
  }
}

// The scratch of the entry points below, laid out from `work`.
bool scratch_of(int n_hidden, const int* dims, int T, long B, int A, int M,
                float* work, Net* net, Scratch* sc) {
  Rows rows;
  if (!make_rows(n_hidden, dims, T, B, A, M, 0, nullptr, net, &rows))
    return false;
  carve(*net, rows.N, rows.nb, work, sc);
  return true;
}

}  // namespace

// Floats of scratch the entry points below share, or 0 for an unsupported
// shape. Their tile kernels take wh_sgd_smem_bytes of shared memory.
extern "C" long wh_vtrace_workspace_floats(int n_hidden, const int* dims,
                                           int T, long B, int A, int M) {
  Net net;
  Rows rows;
  if (!make_rows(n_hidden, dims, T, B, A, M, 0, nullptr, &net, &rows))
    return 0;
  Scratch sc;
  return carve(net, rows.N, rows.nb, nullptr, &sc);
}

// K6: the V-trace loss and gradient of minibatch mb (kernels a-d).
// `grads` gets the gradient in the packed layout, sums[0..2] the metric
// sums (lp * pg_adv, (v - vs)^2, entropy; sums[3] = 0); the workspace
// keeps the gradient's sums of squares for the optimizer step.
extern "C" int wh_vtrace_grads(
    int n_hidden, const int* dims, int T, long B, int A, int M, int mb,
    const float* obs, const float* last_obs, const int* action,
    const float* blp, const float* reward, const unsigned char* done,
    const unsigned char* mask, const float* boot, const float* params,
    const float* scal, float gamma, float rho_clip, float c_clip,
    float value_coef, float inv_n, float* work, float* grads, float* sums,
    void* stream_) {
  VtArgs va;
  if (!make_rows(n_hidden, dims, T, B, A, M, mb, obs, &va.net, &va.tj))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  va.tj.last_obs = last_obs;
  va.tj.action = action;
  va.tj.blp = blp;
  va.tj.reward = reward;
  va.tj.done = done;
  va.tj.mask = mask;
  va.tj.boot = boot;
  carve(va.net, va.tj.N, va.tj.nb, work, &va.sc);
  va.c = VtCoefs{gamma, rho_clip, c_clip, value_coef, inv_n};
  va.params = params;
  va.scal = scal;

  cudaError_t e = launch_mlp_transpose(va.net, params, va.sc, stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_tiles(va, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_grads_tail(va.net, va.tj, va.sc,
                                (va.tj.nb + VNT - 1) / VNT, grads, sums,
                                stream);
}

// K5's RMSProp step `step` after wh_vtrace_grads on the same workspace:
// clip by the global norm of `grads`, then RMSProp on params / nu in place
// with lr_row[step].
extern "C" int wh_vtrace_clip_rms(
    int n_hidden, const int* dims, int T, long B, int A, int M, int step,
    float* params, float* nu, const float* grads, const float* lr_row,
    float max_grad_norm, float decay, float one_m_decay, float eps,
    float* work, void* stream_) {
  Net net;
  Scratch sc;
  if (!scratch_of(n_hidden, dims, T, B, A, M, work, &net, &sc) || step < 0)
    return (int)cudaErrorInvalidValue;
  const RmsArgs p = {net.n_params, sc.n_sq, grads, sc.sq, params, nu,
                     lr_row, step, max_grad_norm, decay, one_m_decay, eps};
  rms_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
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
  Net net;
  Scratch sc;
  if (!scratch_of(n_hidden, dims, T, B, A, M, work, &net, &sc) || step < 0)
    return (int)cudaErrorInvalidValue;
  const AdamArgs p = {net.n_params, sc.n_sq, grads, sc.sq, params, m, v,
                      lr_row, bc1_row, bc2_row, step, max_grad_norm, b1,
                      one_m_b1, b2, one_m_b2, eps};
  adam_kernel<<<1, FNT, 0, (cudaStream_t)stream_>>>(p);
  return (int)cudaGetLastError();
}
