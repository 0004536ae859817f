// Device code shared by the acting kernels: K2 (act.cu, the MLP policy), K7
// (act_rnn.cu, the recurrent policy) and K10 (act_cnn.cu, the CNN policy).
// Each is templated on the kernel's argument struct P, which provides the
// fields it reads:
//
// - obs_value: geo, S, k, gobs, inv_h, inv_w (the ego-window observation, or
//   with gobs the global one);
// - sample_row: B, geo, gumbel, mask, action, log_prob, value, logits (the
//   optional logits floor of masked moves, the gumbel-argmax sample with the
//   first-max tie rule and the stable log-softmax, pallas/act.py
//   _sample_logprob :491 and :415-428);
// - tick_env: geo, u, pick, drop, the four reward coefficients, reward,
//   delivered (the env tick and the per-agent rewards), shp (the potential
//   shaping option of K2 and K10, off when its table is null).
//
// EnvSmem keeps one env's state as 4 A + 6 R ints of shared memory.
#pragma once

#include <cuda_runtime.h>

#include "env_tick.cuh"

namespace {

constexpr int NHEAD = 6;    // 5 logits + value
constexpr int HSTRIDE = 8;  // row stride of the head outputs
constexpr float NEG_INF = -1e9f;  // logits floor of masked actions
constexpr int UNREACHABLE = 1 << 14;  // the BFS table's sentinel

// The potential-shaping option (pallas/act.py _phi_row :266-296, _act_kernel
// :356-363, :457-468). The BFS table stays in device memory and is read
// through the read-only path: K2 fills its shared memory with the weights
// and K10 with activations, the table is 58.6 KB at 121 cells and 202 KB at
// 225, and it is read 2 A times per env-step at addresses that L1 and L2
// serve.
struct Shaping {
  const int* table;   // [C, C] BFS distances, or null: shaping off
  const float* done;  // [T, B], 1 where the step truncates the episode
  float* raw_reward;  // [T, B, A] the reward before shaping
  float coef, gamma;  // float32 roundings of the trainer's doubles
  int C;              // cells, H * W
};

// Whether action a keeps an agent at (r, c) on the grid and off the walls
// (the static part of docs/SEMANTICS.md §4.1 rule 1).
__device__ inline bool valid_move(int r, int c, int a,
                                  const wh::Geometry& g) {
  r += a == wh::UP ? -1 : (a == wh::DOWN ? 1 : 0);
  c += a == wh::LEFT ? -1 : (a == wh::RIGHT ? 1 : 0);
  return r >= 0 && r < g.H && c >= 0 && c < g.W && !g.walls[r * g.W + c];
}

template <int A, int R>
struct EnvSmem {
  static constexpr int SIZE = 4 * A + 6 * R;
  static __device__ void put(const wh::Env<A, R>& e, int* s) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      s[i] = e.pr[i];
      s[A + i] = e.pc[i];
      s[2 * A + i] = e.aq[i];
      s[3 * A + i] = e.cy[i];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      s[4 * A + r] = e.qpr[r];
      s[4 * A + R + r] = e.qpc[r];
      s[4 * A + 2 * R + r] = e.qdr[r];
      s[4 * A + 3 * R + r] = e.qdc[r];
      s[4 * A + 4 * R + r] = e.qst[r];
      s[4 * A + 5 * R + r] = e.qag[r];
    }
  }
  static __device__ void get(const int* s, wh::Env<A, R>& e) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      e.pr[i] = s[i];
      e.pc[i] = s[A + i];
      e.aq[i] = s[2 * A + i];
      e.cy[i] = s[3 * A + i];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      e.qpr[r] = s[4 * A + r];
      e.qpc[r] = s[4 * A + R + r];
      e.qdr[r] = s[4 * A + 2 * R + r];
      e.qdc[r] = s[4 * A + 3 * R + r];
      e.qst[r] = s[4 * A + 4 * R + r];
      e.qag[r] = s[4 * A + 5 * R + r];
    }
  }
};

// Feature f < 5 H W of agent a's global observation (ops/obs.py with
// global_obs; pallas/act.py _obs_rows_global :193-242): cell f / 5 of the
// whole grid, channel f % 5, channel-last: 0 the agent itself, 1 any other
// agent, 2 a pending pickup, 3 the agent's own target, 4 traversable (no
// wall; every cell is on the grid, so no bounds test). `tr`, `tc` is the
// target's cell.
template <int A, int R, class P>
__device__ float global_grid_value(const int* s, int a, int f, bool has,
                                   int tr, int tc, const P& p) {
  const int *pr = s, *pc = s + A;
  const int *qpr = s + 4 * A, *qpc = qpr + R, *qst = qpc + 3 * R;
  const int cell = f / 5, ch = f % 5;
  const int wr = cell / p.geo.W, wc = cell % p.geo.W;
  const bool self = pr[a] == wr && pc[a] == wc;
  bool v = false;
  if (ch == 0) {
    v = self;
  } else if (ch == 1) {
#pragma unroll
    for (int j = 0; j < A; ++j) v |= pr[j] == wr && pc[j] == wc;
    v = v && !self;
  } else if (ch == 2) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      v |= qst[r] == wh::PENDING && qpr[r] == wr && qpc[r] == wc;
  } else if (ch == 3) {
    v = has && tr == wr && tc == wc;
  } else {
    v = !p.geo.walls[cell];
  }
  return v ? 1.f : 0.f;
}

// Feature f of agent a's observation (ops/obs.py): the grid part, channel-
// last, then the 6 self features. The grid is the S x S ego window with 4
// channels or, with p.gobs, the whole H x W grid with 5
// (global_grid_value). A pure function of the env's shared-memory ints.
template <int A, int R, class P>
__device__ float obs_value(const int* s, int a, int f, const P& p) {
  const int *pr = s, *pc = s + A, *aq = s + 2 * A, *cy = s + 3 * A;
  const int *qpr = s + 4 * A, *qpc = qpr + R, *qdr = qpc + R,
            *qdc = qdr + R, *qst = qdc + R;
  const int my = aq[a];
  const bool has = my >= 0;
  int tr = pr[a], tc = pc[a];
  if (has) {
    tr = cy[a] ? qdr[my] : qpr[my];
    tc = cy[a] ? qdc[my] : qpc[my];
  }
  const int grid = p.gobs ? p.geo.H * p.geo.W * 5 : p.S * p.S * 4;
  if (f < grid) {
    if (p.gobs) return global_grid_value<A, R>(s, a, f, has, tr, tc, p);
    const int w = f >> 2, ch = f & 3;
    const int wr = pr[a] + w / p.S - p.k, wc = pc[a] + w % p.S - p.k;
    bool v = false;
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < A; ++j) v |= pr[j] == wr && pc[j] == wc;
    } else if (ch == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        v |= qst[r] == wh::PENDING && qpr[r] == wr && qpc[r] == wc;
    } else if (ch == 2) {
      v = has && tr == wr && tc == wc;
    } else {
      v = wr >= 0 && wr < p.geo.H && wc >= 0 && wc < p.geo.W &&
          !p.geo.walls[wr * p.geo.W + wc];
    }
    return v ? 1.f : 0.f;
  }
  switch (f - grid) {
    case 0: return __fmul_rn((float)pr[a], p.inv_h);
    case 1: return __fmul_rn((float)pc[a], p.inv_w);
    case 2: return cy[a] ? 1.f : 0.f;
    case 3: return has ? 1.f : 0.f;
    case 4: return __fmul_rn((float)(has ? tr - pr[a] : 0), p.inv_h);
    default: return __fmul_rn((float)(has ? tc - pc[a] : 0), p.inv_w);
  }
}

// The grid part of agent a's observation a cell at a time: the C channels
// of grid cell `cell` into out[0 .. C) (C = 4 on the ego window, 5 on the
// global view), the values obs_value gives for features cell C .. cell C
// + C - 1. A warp whose lanes take a cell each runs no divergent channel
// branches.
template <int A, int R, class P>
__device__ void obs_cell(const int* s, int a, int cell, const P& p,
                         float* out) {
  const int *pr = s, *pc = s + A, *aq = s + 2 * A, *cy = s + 3 * A;
  const int *qpr = s + 4 * A, *qpc = qpr + R, *qdr = qpc + R,
            *qdc = qdr + R, *qst = qdc + R;
  const int my = aq[a];
  const bool has = my >= 0;
  int tr = pr[a], tc = pc[a];
  if (has) {
    tr = cy[a] ? qdr[my] : qpr[my];
    tc = cy[a] ? qdc[my] : qpc[my];
  }
  int wr, wc;
  if (p.gobs) {
    wr = cell / p.geo.W;
    wc = cell % p.geo.W;
  } else {
    wr = pr[a] + cell / p.S - p.k;
    wc = pc[a] + cell % p.S - p.k;
  }
  bool agent = false, pending = false;
#pragma unroll
  for (int j = 0; j < A; ++j) agent |= pr[j] == wr && pc[j] == wc;
#pragma unroll
  for (int r = 0; r < R; ++r)
    pending |= qst[r] == wh::PENDING && qpr[r] == wr && qpc[r] == wc;
  const bool target = has && tr == wr && tc == wc;
  if (p.gobs) {
    const bool self = pr[a] == wr && pc[a] == wc;
    out[0] = self ? 1.f : 0.f;
    out[1] = agent && !self ? 1.f : 0.f;
    out[2] = pending ? 1.f : 0.f;
    out[3] = target ? 1.f : 0.f;
    out[4] = !p.geo.walls[cell] ? 1.f : 0.f;
  } else {
    out[0] = agent ? 1.f : 0.f;
    out[1] = pending ? 1.f : 0.f;
    out[2] = target ? 1.f : 0.f;
    out[3] = wr >= 0 && wr < p.geo.H && wc >= 0 && wc < p.geo.W &&
                     !p.geo.walls[wr * p.geo.W + wc]
                 ? 1.f
                 : 0.f;
  }
}

// Row n = (env n / A, agent n % A) of the CTA whose first env is b0, at
// step t: with masking floors the invalid moves' logits (and writes the
// mask); samples argmax(logits + gumbel), first max; takes the stable
// log-softmax of the chosen action. `h` holds the row's 6 head outputs,
// `s` its env's EnvSmem. Rows past the batch end (`live` false) compute
// on zero noise and store nothing. Returns the action.
template <int A, class P>
__device__ int sample_row(const P& p, const float* h, const int* s, int n,
                          bool live, int t, long b0) {
  const long BA = p.B * A;
  const long o = ((long)t * p.B + b0) * A + n;
  float lg[5];
#pragma unroll
  for (int r = 0; r < 5; ++r) lg[r] = h[r];
  if (p.mask) {
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const bool ok = valid_move(s[n % A], s[A + n % A], r, p.geo);
      if (!ok) lg[r] = NEG_INF;
      if (live) p.mask[o * 5 + r] = ok;
    }
  }
  float best = 0.f;
  int best_a = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const float g =
        live ? p.gumbel[((long)t * 5 + r) * BA + b0 * A + n] : 0.f;
    const float z = lg[r] + g;
    if (r == 0 || z > best) {
      best = z;
      best_a = r;
    }
  }
  float mx = lg[0];
#pragma unroll
  for (int r = 1; r < 5; ++r) mx = fmaxf(mx, lg[r]);
  float ssum = 0.f;
#pragma unroll
  for (int r = 0; r < 5; ++r) ssum += expf(lg[r] - mx);
  const float lp = (lg[best_a] - mx) - logf(ssum);
  if (live) {
    p.action[o] = best_a;
    p.log_prob[o] = lp;
    p.value[o] = h[5];
    if (p.logits)
      for (int r = 0; r < 5; ++r) p.logits[o * 5 + r] = h[r];
  }
  return best_a;
}

// Agent i's shaping potential: minus the BFS distance from its cell to its
// target's cell (the pickup cell, the drop cell once carrying), 0 without a
// task or when the target is unreachable (ops/pathing.py potential). One
// table read; none without a task.
// Inlined by force into loops unrolled over i: a call would take the env's
// address and move all of it from registers to local memory, for the tick
// too.
template <int A, int R>
__device__ __forceinline__ float potential(const wh::Env<A, R>& e, int i,
                                           const Shaping& sh, int W) {
  const int aq = e.aq[i];
  if (aq < 0) return 0.f;
  int tr = 0, tc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (aq == r) {
      tr = e.cy[i] ? e.qdr[r] : e.qpr[r];
      tc = e.cy[i] ? e.qdc[r] : e.qpc[r];
    }
  }
  const int d =
      __ldg(sh.table + (long)(e.pr[i] * W + e.pc[i]) * sh.C + tr * W + tc);
  return d < UNREACHABLE ? -(float)d : 0.f;
}

// One env's tick on the actions act[0..A) and the draws of (t, b) = kt,
// then its per-agent rewards and delivery count; `s` is its EnvSmem. With
// shaping the reward becomes rew + coef * (gamma * phi_post * (1 - done) -
// phi_pre), phi_post on the ticked (pre-reset) state, in that order with
// every operation rounded by itself (no FMA contraction), and the unshaped
// reward is written beside it.
template <int A, int R, class P>
__device__ void tick_env(const P& p, int* s, const int* act_s, long kt) {
  wh::Env<A, R> e;
  EnvSmem<A, R>::get(s, e);
  int act[A];
#pragma unroll
  for (int i = 0; i < A; ++i) act[i] = act_s[i];
  const bool shaped = p.shp.table != nullptr;
  float phi_pre[A];
#pragma unroll
  for (int i = 0; i < A; ++i)
    phi_pre[i] = shaped ? potential(e, i, p.shp, p.geo.W) : 0.f;
  bool pk[A], dl[A], cl[A];
  wh::env_tick(e, act, p.u[kt], p.pick[kt], p.drop[kt], p.geo, pk, dl, cl);
  const float live = shaped ? __fsub_rn(1.f, p.shp.done[kt]) : 0.f;
  int nd = 0;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    float rew = __fadd_rn(p.step_penalty,
                          __fmul_rn(p.pickup_reward, pk[i] ? 1.f : 0.f));
    rew = __fadd_rn(rew, __fmul_rn(p.delivery_reward, dl[i] ? 1.f : 0.f));
    rew = __fadd_rn(rew, __fmul_rn(p.collision_penalty, cl[i] ? 1.f : 0.f));
    if (shaped) {
      p.shp.raw_reward[kt * A + i] = rew;
      float term = __fmul_rn(p.shp.gamma, potential(e, i, p.shp, p.geo.W));
      term = __fsub_rn(__fmul_rn(term, live), phi_pre[i]);
      rew = __fadd_rn(rew, __fmul_rn(p.shp.coef, term));
    }
    p.reward[kt * A + i] = rew;
    nd += dl[i];
  }
  p.delivered[kt] = nd;
  EnvSmem<A, R>::put(e, s);
}

}  // namespace
