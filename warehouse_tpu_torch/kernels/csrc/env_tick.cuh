// One warehouse env tick as a CUDA device function, shared by the greedy
// rollout kernel (rollout.cu) and the act-phase kernel (act.cu).
//
// Replaces env_tick / env_tick_rows of warehouse_tpu/pallas/rollout.py
// (:57, :238), which the JAX tests pin bit-equal to each other and to
// engine.step: movement (4-rule collision) -> pickup -> delivery -> spawn
// -> assignment, docs/SEMANTICS.md §4-§7, with the spec's tie rules
// (lowest agent wins a cell, first EMPTY slot spawns, strict-< nearest
// PENDING slot so the lowest slot wins ties).
//
// One thread owns one env. A and R are template parameters, so the loops
// over agents and slots unroll and array indices are compile-time
// constants, which lets the env's 4A + 6R ints live in registers. Reads of
// "my request" are select chains over the slots, not dynamic indexing,
// for the same reason. All of it is integer logic; the only float is the
// spawn draw compare.
#pragma once

#include <cuda_runtime.h>

namespace wh {

constexpr int EMPTY = 0, PENDING = 1, IN_TRANSIT = 2;
constexpr int STAY = 0, UP = 1, DOWN = 2, LEFT = 3, RIGHT = 4;
constexpr int BIG = 1 << 30;

struct Geometry {
  int H, W;
  float spawn_prob;
  const unsigned char* walls;  // [H * W], 1 on wall cells
};

template <int A, int R>
struct Env {
  int pr[A], pc[A], aq[A], cy[A];
  int qpr[R], qpc[R], qdr[R], qdc[R], qst[R], qag[R];
};

// Loads env b from natural-layout int32 tensors: agent_pos [B, A, 2],
// agent_req / carrying [B, A], req_pickup / req_drop [B, R, 2],
// req_status / req_agent [B, R].
template <int A, int R>
__device__ inline void load_env(Env<A, R>& e, long b, const int* pos,
                                const int* areq, const int* carry,
                                const int* rpick, const int* rdrop,
                                const int* rstat, const int* ragent) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    e.pr[i] = pos[(b * A + i) * 2];
    e.pc[i] = pos[(b * A + i) * 2 + 1];
    e.aq[i] = areq[b * A + i];
    e.cy[i] = carry[b * A + i];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    e.qpr[r] = rpick[(b * R + r) * 2];
    e.qpc[r] = rpick[(b * R + r) * 2 + 1];
    e.qdr[r] = rdrop[(b * R + r) * 2];
    e.qdc[r] = rdrop[(b * R + r) * 2 + 1];
    e.qst[r] = rstat[b * R + r];
    e.qag[r] = ragent[b * R + r];
  }
}

template <int A, int R>
__device__ inline void store_env(const Env<A, R>& e, long b, int* pos,
                                 int* areq, int* carry, int* rpick,
                                 int* rdrop, int* rstat, int* ragent) {
#pragma unroll
  for (int i = 0; i < A; ++i) {
    pos[(b * A + i) * 2] = e.pr[i];
    pos[(b * A + i) * 2 + 1] = e.pc[i];
    areq[b * A + i] = e.aq[i];
    carry[b * A + i] = e.cy[i];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rpick[(b * R + r) * 2] = e.qpr[r];
    rpick[(b * R + r) * 2 + 1] = e.qpc[r];
    rdrop[(b * R + r) * 2] = e.qdr[r];
    rdrop[(b * R + r) * 2 + 1] = e.qdc[r];
    rstat[b * R + r] = e.qst[r];
    ragent[b * R + r] = e.qag[r];
  }
}

// Agent i's navigation target (§10/§12): its request's pickup cell, the
// drop cell once carrying, its own cell when it has no request.
template <int A, int R>
__device__ inline void target(const Env<A, R>& e, int i, bool& has, int& tr,
                              int& tc) {
  // The slot's cells are read with masks: m is all ones on the agent's
  // slot and zero on the others, and the chain ors the masked cells. As a
  // select chain (if (aq == r) tr = cy ? qdr[r] : qpr[r]) nvcc folded the
  // reads into one at qpr + aq or qdr + aq, a dynamic index that put the
  // whole Env on the local-memory stack at (A, R) = (2, 4), (4, 8) and
  // (6, 12); with plain reads in the chain and the carry's choice after
  // it, at all four (tools/torch_k1_blocks.py counts the local loads).
  has = e.aq[i] >= 0;
  const int cm = -(int)(e.cy[i] != 0);
  int vr = 0, vc = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = -(int)(e.aq[i] == r);
    vr |= m & ((cm & e.qdr[r]) | (~cm & e.qpr[r]));
    vc |= m & ((cm & e.qdc[r]) | (~cm & e.qpc[r]));
  }
  tr = has ? vr : e.pr[i];
  tc = has ? vc : e.pc[i];
}

// One tick given the agents' actions and the tick's spawn draws. Leaves
// t and the key to the caller; returns the per-agent events.
template <int A, int R>
__device__ inline void env_tick(Env<A, R>& e, const int (&act)[A], float u,
                                int spick, int sdrop, const Geometry& g,
                                bool (&picked)[A], bool (&delivered)[A],
                                bool (&collided)[A]) {
  const int H = g.H, W = g.W;
  int pr[A], pc[A];
  bool mv[A];

  // Movement rule 1: bounds and walls.
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int a = act[i];
    const int r = e.pr[i] + (a == UP ? -1 : (a == DOWN ? 1 : 0));
    const int c = e.pc[i] + (a == LEFT ? -1 : (a == RIGHT ? 1 : 0));
    const bool m = a != STAY && r >= 0 && r < H && c >= 0 && c < W &&
                   !g.walls[r * W + c];
    mv[i] = m;
    pr[i] = m ? r : e.pr[i];
    pc[i] = m ? c : e.pc[i];
  }
  // Rule 2: same target, the lowest index wins.
#pragma unroll
  for (int i = 1; i < A; ++i) {
    bool lost = false;
#pragma unroll
    for (int j = 0; j < i; ++j)
      lost |= mv[i] && mv[j] && pr[i] == pr[j] && pc[i] == pc[j];
    if (lost) {
      mv[i] = false;
      pr[i] = e.pr[i];
      pc[i] = e.pc[i];
    }
  }
  // Rule 3: swaps, both revert.
  bool swap[A];
#pragma unroll
  for (int i = 0; i < A; ++i) swap[i] = false;
#pragma unroll
  for (int i = 0; i < A; ++i) {
#pragma unroll
    for (int j = i + 1; j < A; ++j) {
      const bool sw = mv[i] && mv[j] && pr[i] == e.pr[j] &&
                      pc[i] == e.pc[j] && pr[j] == e.pr[i] && pc[j] == e.pc[i];
      swap[i] |= sw;
      swap[j] |= sw;
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    if (swap[i]) {
      mv[i] = false;
      pr[i] = e.pr[i];
      pc[i] = e.pc[i];
    }
  }
  // Rule 4: a move into a cell held by a non-mover reverts; A passes.
#pragma unroll
  for (int pass = 0; pass < A; ++pass) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      bool blocked = false;
#pragma unroll
      for (int j = 0; j < A; ++j)
        if (j != i)
          blocked |= mv[i] && !mv[j] && pr[i] == pr[j] && pc[i] == pc[j];
      if (blocked) {
        mv[i] = false;
        pr[i] = e.pr[i];
        pc[i] = e.pc[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    collided[i] = act[i] != STAY && !mv[i];
    e.pr[i] = pr[i];
    e.pc[i] = pc[i];
  }

  // Pickup (§5): status and cells of my request are read before any
  // slot changes this tick.
#pragma unroll
  for (int i = 0; i < A; ++i) {
    int st = 0, tpr = 0, tpc = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (e.aq[i] == r) {
        st = e.qst[r];
        tpr = e.qpr[r];
        tpc = e.qpc[r];
      }
    }
    picked[i] = e.aq[i] >= 0 && e.cy[i] == 0 && st == PENDING &&
                e.pr[i] == tpr && e.pc[i] == tpc;
    if (picked[i]) e.cy[i] = 1;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool sp = false;
#pragma unroll
    for (int i = 0; i < A; ++i) sp |= picked[i] && e.aq[i] == r;
    if (sp) e.qst[r] = IN_TRANSIT;
  }

  // Delivery (§5), on the post-pickup carry flags.
#pragma unroll
  for (int i = 0; i < A; ++i) {
    int tdr = 0, tdc = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (e.aq[i] == r) {
        tdr = e.qdr[r];
        tdc = e.qdc[r];
      }
    }
    delivered[i] = e.aq[i] >= 0 && e.cy[i] != 0 && e.pr[i] == tdr &&
                   e.pc[i] == tdc;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    bool sd = false;
#pragma unroll
    for (int i = 0; i < A; ++i) sd |= delivered[i] && e.aq[i] == r;
    if (sd) {
      e.qst[r] = EMPTY;
      e.qag[r] = -1;
      e.qpr[r] = 0;
      e.qpc[r] = 0;
      e.qdr[r] = 0;
      e.qdc[r] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    if (delivered[i]) {
      e.aq[i] = -1;
      e.cy[i] = 0;
    }
  }

  // Spawn (§6): the first EMPTY slot, if the draw says so.
  bool spawn = u < g.spawn_prob;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (spawn && e.qst[r] == EMPTY) {
      e.qpr[r] = spick / W;
      e.qpc[r] = spick % W;
      e.qdr[r] = sdrop / W;
      e.qdc[r] = sdrop % W;
      e.qst[r] = PENDING;
      e.qag[r] = -1;
      spawn = false;
    }
  }

  // Assignment (§7): agents in index order take the nearest available
  // PENDING slot; strict < keeps the lowest slot on ties.
#pragma unroll
  for (int i = 0; i < A; ++i) {
    int best_d = BIG, best_r = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = abs(e.pr[i] - e.qpr[r]) + abs(e.pc[i] - e.qpc[r]);
      if (e.qst[r] == PENDING && e.qag[r] < 0 && d < best_d) {
        best_d = d;
        best_r = r;
      }
    }
    if (e.aq[i] < 0 && best_r >= 0) {
      e.aq[i] = best_r;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r == best_r) e.qag[r] = i;
    }
  }
}

// Dispatches a functor templated on (A, R). The library's build has the
// four preset shapes; a pair's build (kernels/build.py pair_library, which
// compiles the env sources with -DWH_PAIR_A=A -DWH_PAIR_R=R) has that one
// pair alone. Returns false for any other shape.
template <template <int, int> class F, typename... Args>
inline bool dispatch_shape(int A, int R, Args&&... args) {
#ifdef WH_PAIR_A
  if (A == WH_PAIR_A && R == WH_PAIR_R)
    return F<WH_PAIR_A, WH_PAIR_R>::run(args...), true;
#else
  if (A == 2 && R == 4) return F<2, 4>::run(args...), true;
  if (A == 4 && R == 8) return F<4, 8>::run(args...), true;
  if (A == 6 && R == 12) return F<6, 12>::run(args...), true;
  if (A == 8 && R == 16) return F<8, 16>::run(args...), true;
#endif
  return false;
}

}  // namespace wh
