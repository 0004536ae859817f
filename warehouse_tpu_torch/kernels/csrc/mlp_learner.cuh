// The MLP learner's building blocks, shared by the MLP PPO learner (K3/K4,
// sgd.cu), the IMPALA learner (K5/K6, vtrace_sgd.cu), the recurrent PPO
// learner (K8/K9, sgd_rnn.cu) and the CNN learner (K11/K12, sgd_cnn.cu):
//
// - The packed parameter layout: per dense layer W [out, in] then b [out]
//   (torch's layout), the head as the 6 x H stack of 5 logits and the
//   value.
// - Rows: a minibatch's samples, and GroupSplit, their split by policy
//   group.
// - loss_row: the clipped-PPO loss chain of one sample and its derivative
//   with respect to the head outputs (sgd.cu, sgd_rnn.cu).
// - reduce_kernel (split-K partials summed in split order, sums of squares
//   per 256 gradients), sumsq_kernel (those sums taken again from a given
//   gradient: the averaged one on a data mesh), metrics_kernel (per-tile
//   metric rows summed in a fixed order), global_norm and adam_kernel (the
//   optax clip + Adam step, on a grid of CTAs that each compute the same
//   norm).
//
// Policy groups (K3/K4, pallas/sgd.py:293-306): K MLPs of the same widths,
// their params one after another in group order, and a static agent ->
// group map. Each group's samples form their own Rows (only its agents);
// GroupSplit gives each group's first row and first tile of R rows, so
// that a learner can run the groups' rows one group after another, each
// through its params and in its order without groups. One global norm
// spans every group's gradient.
//
// Every sum runs in an order fixed by the shapes alone, so two runs on the
// same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include <vector>

#include "bf16_round.cuh"
#include "host_ptr.cuh"

namespace {

constexpr int NACT = 5;
constexpr int NHEAD = 6;      // 5 logits + value
constexpr int OST = 8;        // row stride of head outputs and deltas
constexpr int R = 64;         // samples per tile of GroupSplit
constexpr int RED = 256;      // threads of reduce_kernel
constexpr int FNT = 1024;     // threads of the optimizer kernels
// Policy groups, and agents of a grouped batch: Rows::code holds an
// enumerated agent in 4 bits, 16 of them in its 64.
constexpr int MAXK = 16;
constexpr float NEG_INF = -1e9f;

struct Layer {
  int in, out;
  long w_off, b_off;  // packed vector: W [out, in] then b [out]
};

// Any number of hidden layers: the layer table lives on the host (`layers`,
// the caller's), and the kernels read only the head's entry.
struct Net {
  int n_hidden, D;
  HostPtr<const Layer> L;  // the hidden layers, then the head
  Layer head;      // L[n_hidden]
  long n_params;
};

// The packed layout of an MLP of these widths, its table in *layers.
bool make_net(int n_hidden, const int* dims, Net* net,
              std::vector<Layer>* layers) {
  if (n_hidden < 1) return false;
  layers->assign(n_hidden + 1, Layer{});
  net->n_hidden = n_hidden;
  net->D = dims[0];
  net->L = layers->data();
  long off = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    Layer& y = (*layers)[l];
    y.in = dims[l];
    y.out = l < n_hidden ? dims[l + 1] : NHEAD;
    if (y.in <= 0 || y.out <= 0) return false;
    y.w_off = off;
    y.b_off = off + (long)y.out * y.in;
    off = y.b_off + y.out;
  }
  net->head = (*layers)[n_hidden];
  net->n_params = off;
  return true;
}

// The samples of one minibatch: env columns [m B/M, (m+1) B/M) of a
// [T, B, A] trajectory, N = T * B/M * A samples in time-major order; or,
// for one policy group, only its na agents' (na < A), N = T * B/M * na.
struct Rows {
  long N;       // samples
  long nb;      // samples per time step: B/M * na
  long BA;      // B * A
  long mb_off;  // m * B/M * A
  int D;
  int A, na;    // agents, and the agents enumerated
  unsigned long long code;  // the enumerated agents, 4 bits each, na < A
  const float* obs;  // [T, B, A, D]
  // Row of sample q in the [T, B, A] arrays: time step q / nb, then the
  // minibatch's env columns (with na < A, each env's enumerated agents).
  __device__ long row(long q) const {
    if (na == A) return (q / nb) * BA + mb_off + q % nb;
    const long r = q % nb;
    return (q / nb) * BA + mb_off + (r / na) * A +
           (int)((code >> (4 * (int)(r % na))) & 15);
  }
};

// Minibatch mb of M of a [T, B, A] trajectory with D-wide observations.
bool batch_rows(int T, long B, int A, int M, int mb, int D, const float* obs,
                Rows* rows) {
  if (T <= 0 || B <= 0 || A <= 0 || M <= 0 || B % M || mb < 0 || mb >= M)
    return false;
  rows->nb = (B / M) * A;
  rows->N = (long)T * rows->nb;
  rows->BA = B * A;
  rows->mb_off = mb * rows->nb;
  rows->D = D;
  rows->A = rows->na = A;
  rows->code = 0;
  rows->obs = obs;
  return true;
}

// A minibatch's samples split by policy group: group g's Rows, its first
// row in the scratch's activations (noff) and its first tile (toff).
// Without groups K = 1 and the one group is the whole minibatch.
struct GroupSplit {
  int K;
  Rows rows[MAXK];
  long noff[MAXK + 1], toff[MAXK + 1];
};

// The split of `all` (batch_rows' minibatch of T * B/M * A samples) by the
// agent -> group map `groups` of K groups (null: one group). Returns false
// for a map that is not K non-empty groups of at most MAXK agents.
bool split_groups(const Rows& all, long bm, int K, const int* groups,
                  GroupSplit* gs) {
  const long T = all.N / all.nb;
  if (K < 1 || K > MAXK || (K > 1 && (!groups || all.A > MAXK))) return false;
  gs->K = K;
  gs->noff[0] = gs->toff[0] = 0;
  for (int g = 0; g < K; ++g) {
    Rows r = all;
    r.na = 0;
    r.code = 0;
    for (int a = 0; a < all.A; ++a) {
      const int ga = groups ? groups[a] : 0;
      if (ga < 0 || ga >= K) return false;
      if (ga == g) r.code |= (unsigned long long)a << (4 * r.na++);
    }
    if (r.na == 0) return false;
    r.nb = bm * r.na;
    r.N = T * r.nb;
    if (r.na == r.A) r.code = 0;
    gs->rows[g] = r;
    gs->noff[g + 1] = gs->noff[g] + r.N;
    gs->toff[g + 1] = gs->toff[g] + (r.N + R - 1) / R;
  }
  return true;
}

bool make_rows(int n_hidden, const int* dims, int T, long B, int A, int M,
               int mb, const float* obs, Net* net, Rows* rows,
               std::vector<Layer>* layers) {
  return make_net(n_hidden, dims, net, layers) &&
         batch_rows(T, B, A, M, mb, net->D, obs, rows);
}

struct Batch : Rows {  // one minibatch of the trajectory
  const int* action;
  const float *old_lp, *old_v, *adv, *target;  // [T, B, A]
  const unsigned char* mask;                   // [T, B, A, 5] or null
};

struct Coefs {
  float clip_eps, clip_lo, clip_hi, value_coef, inv_n;
};

// ---- the PPO loss of one sample ------------------------------------------------

// The clipped-PPO loss chain of one sample and d(mean loss)/d(head
// output), in the order of _loss_and_dout (pallas/sgd.py:68-155). `o` holds the
// head outputs and receives the deltas; `met` the four metric terms.
__device__ void loss_row(float* o, long gi, const Batch& bt, const Coefs& c,
                         float ent_coef, float kl_coeff, float* met) {
  bool valid[NACT];
  float logit[NACT];
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    valid[r] = !bt.mask || bt.mask[gi * NACT + r];
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
  const int a = bt.action[gi];
  float logp[NACT], p[NACT], lp = 0.f, ent = 0.f;
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    logp[r] = logit[r] - lse;
    p[r] = expf(logp[r]);
    if (a == r) lp = logp[r];
    ent = ent - p[r] * logp[r];
  }
  const float old_lp = bt.old_lp[gi], old_v = bt.old_v[gi];
  const float adv = bt.adv[gi], tgt = bt.target[gi];

  const float ratio = expf(lp - old_lp);
  const float r_clip = fminf(fmaxf(ratio, c.clip_lo), c.clip_hi);
  const float pg1 = ratio * adv, pg2 = r_clip * adv;
  const float v_err = v - tgt, dv = v - old_v;
  const float vc_err = (old_v + fminf(fmaxf(dv, -c.clip_eps), c.clip_eps)) - tgt;
  const float sq1 = v_err * v_err, sq2 = vc_err * vc_err;
  met[0] = fminf(pg1, pg2);
  met[1] = fmaxf(sq1, sq2);
  met[2] = ent;
  met[3] = old_lp - lp;

  const bool inclip = ratio >= c.clip_lo && ratio <= c.clip_hi;
  const float sel = (pg1 <= pg2 || inclip) ? 1.f : 0.f;
  const float d_lp = -(adv * ratio * sel + kl_coeff) * c.inv_n;
  const float ent_scale = ent_coef * c.inv_n;
#pragma unroll
  for (int r = 0; r < NACT; ++r) {
    const float d = d_lp * ((a == r ? 1.f : 0.f) - p[r]) +
                    ent_scale * p[r] * (logp[r] + ent);
    o[r] = valid[r] ? d : 0.f;
  }
  const bool invc = dv >= -c.clip_eps && dv <= c.clip_eps;
  const float err = sq1 >= sq2 ? v_err : (invc ? vc_err : 0.f);
  o[NACT] = c.value_coef * c.inv_n * err;
}

// ---- partials -> gradient, sums of squares ----------------------------------

__global__ void __launch_bounds__(RED) reduce_kernel(const float* part, int S,
                                                     long n, float* grads,
                                                     float* sq) {
  __shared__ float sh[RED];
  const long k = (long)blockIdx.x * RED + threadIdx.x;
  float g = 0.f;
  if (k < n) {
    for (int s = 0; s < S; ++s) g += part[s * n + k];
    grads[k] = g;
  }
  sh[threadIdx.x] = g * g;
  __syncthreads();
  for (int w = RED / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sq[blockIdx.x] = sh[0];
}

// ---- the sums of squares of a given gradient ---------------------------------

// reduce_kernel's sums of squares, taken again from a gradient the caller
// gives, in reduce_kernel's partition and order: block b of segment y sums
// the squares of grads[y n + b RED, y n + (b + 1) RED) by the same
// shared-memory tree into sq[y ceil(n / RED) + b]. On the gradient that
// reduce_kernel wrote the sums are its sums, bit for bit.
//
// It replaces no TPU kernel: the Pallas learners run on one device. The
// learners' meshed route (kernels/sgd.py sgd_phase_on_card) launches it on
// the gradient averaged over the ranks, between the all-reduce and the
// clip + Adam step, so that the step clips by that gradient's global norm,
// as the JAX meshed learner pmeans the gradient before optax's clip
// (warehouse_tpu/ops/ppo_update.py:241-245); the sums reduce_kernel left
// are the rank's own gradient's. Bound by bytes: n floats read once, the
// sums written; one pass, a block per RED gradients, as many blocks as
// reduce_kernel's.
__global__ void __launch_bounds__(RED) sumsq_kernel(const float* grads,
                                                    long n, float* sq) {
  __shared__ float sh[RED];
  const long k = (long)blockIdx.x * RED + threadIdx.x;
  const float g = k < n ? grads[(long)blockIdx.y * n + k] : 0.f;
  sh[threadIdx.x] = g * g;
  __syncthreads();
  for (int w = RED / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    sq[(long)blockIdx.y * gridDim.x + blockIdx.x] = sh[0];
}

// sumsq_kernel over K segments of n gradients each, one after another (K
// policy groups' gradients), their sums one segment's after another's.
cudaError_t launch_sumsq(const float* grads, long n, int K, float* sq,
                         cudaStream_t stream) {
  if (n <= 0 || K < 1) return cudaErrorInvalidValue;
  sumsq_kernel<<<dim3((unsigned)((n + RED - 1) / RED), (unsigned)K), RED, 0,
                 stream>>>(grads, n, sq);
  return cudaGetLastError();
}

// ---- metric sums; global norm, clip + Adam ----------------------------------

__device__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// sums[k] = the tiles' metric k in a fixed order, one warp per metric.
__global__ void metrics_kernel(const float* met, long n_tiles, float* sums) {
  const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.f;
  for (long t = lane; t < n_tiles; t += 32) s += met[t * 4 + k];
  s = warp_sum(s);
  if (lane == 0) sums[k] = s;
}

// The global norm of the gradient from its sums of squares, in a fixed
// order, by the first warp into *norm_s.
__device__ void global_norm(const float* sq, long n_sq, float* norm_s) {
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (long b = threadIdx.x; b < n_sq; b += 32) s += sq[b];
    s = warp_sum(s);
    if (threadIdx.x == 0) *norm_s = __fsqrt_rn(s);
  }
  __syncthreads();
}

struct AdamArgs {
  long n, n_sq;
  const float *grads, *sq;
  float *params, *m, *v;
  const float *lr_row, *bc1_row, *bc2_row;
  int step;
  float max_grad_norm, b1, one_m_b1, b2, one_m_b2, eps;
};

// optax.chain(clip_by_global_norm, adam) in its op order (_clip_adam_step,
// sgd.py:226-248): scale = norm < max ? 1 : (g / norm) * max, the moment
// updates, update = lr * (m / bc1) / (sqrt(v / bc2) + eps). On a grid of
// CTAs: each computes the same norm from the sums of squares, then updates
// its share of the parameters.
__global__ void __launch_bounds__(FNT) adam_kernel(AdamArgs p) {
  __shared__ float norm_s;
  global_norm(p.sq, p.n_sq, &norm_s);
  const float norm = norm_s, maxn = p.max_grad_norm;
  const bool keep = norm < maxn;
  const float lr = p.lr_row[p.step], bc1 = p.bc1_row[p.step];
  const float bc2 = p.bc2_row[p.step];
  for (long k = (long)blockIdx.x * FNT + threadIdx.x; k < p.n;
       k += (long)gridDim.x * FNT) {
    float g = p.grads[k];
    if (!keep) g = __fmul_rn(__fdiv_rn(g, norm), maxn);
    const float m = __fadd_rn(__fmul_rn(p.one_m_b1, g),
                              __fmul_rn(p.b1, p.m[k]));
    const float v = __fadd_rn(__fmul_rn(p.one_m_b2, __fmul_rn(g, g)),
                              __fmul_rn(p.b2, p.v[k]));
    p.m[k] = m;
    p.v[k] = v;
    const float upd = __fdiv_rn(
        __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), p.eps));
    p.params[k] = __fsub_rn(p.params[k], __fmul_rn(lr, upd));
  }
}

// ---- host side ----------------------------------------------------------------

// Opts `kernel` in to `smem` bytes of dynamic shared memory and sizes its
// persistent grid of `threads`-wide CTAs: one per resident slot, at most
// n_tiles.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long n_tiles,
                            long* grid, int threads) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, n_sm = 1, per_sm = 1;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long resident = (long)n_sm * per_sm;
  *grid = n_tiles < resident ? n_tiles : resident;
  return cudaSuccess;
}

}  // namespace
