// K1: the greedy-baseline rollout, T env ticks per env in one launch.
//
// Replaces warehouse_tpu/pallas/rollout.py greedy_rollout_pallas (:516,
// body _kernel :417). One thread owns one env and keeps its 4A + 6R
// state ints for all T steps (in registers, or in L1-cached local memory
// where ptxas puts them), so device memory sees the state once in and
// once out plus the precomputed spawn draws, 12 bytes per env-step. The
// tick is integer branch logic per env (collision rules, slot scans), so
// the bound is issue rate, not bytes; one thread per env keeps every
// branch inside the thread and the draws coalesced over envs.
//
// Exactness: the reward sum uses __fmul_rn/__fadd_rn in the order of
// rollout.py:488-493, so nvcc cannot contract it into FMAs.

#include <cuda_runtime.h>

#include "env_tick.cuh"

namespace {

struct GreedyArgs {
  long B;
  int T;
  wh::Geometry geo;
  float step_penalty_a;  // float32(step_penalty * A)
  float pickup_reward, delivery_reward, collision_penalty;
  const int *pos, *areq, *carry, *rpick, *rdrop, *rstat, *ragent;
  const float* u;
  const int *pick, *drop;
  int *o_pos, *o_areq, *o_carry, *o_rpick, *o_rdrop, *o_rstat, *o_ragent;
  int* o_deliv;
  float* o_rew;
};

template <int A, int R>
__global__ void greedy_rollout_kernel(GreedyArgs p) {
  const long b = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  wh::Env<A, R> e;
  wh::load_env(e, b, p.pos, p.areq, p.carry, p.rpick, p.rdrop, p.rstat,
               p.ragent);
  int deliv = 0;
  float rew = 0.f;
  for (int t = 0; t < p.T; ++t) {
    const long k = t * p.B + b;
    int act[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      bool has;
      int tr, tc;
      wh::target(e, i, has, tr, tc);
      const int dr = tr - e.pr[i], dc = tc - e.pc[i];
      const int a = dr != 0 ? (dr < 0 ? wh::UP : wh::DOWN)
                            : (dc != 0 ? (dc < 0 ? wh::LEFT : wh::RIGHT)
                                       : wh::STAY);
      act[i] = has ? a : wh::STAY;
    }
    bool picked[A], delivered[A], collided[A];
    wh::env_tick(e, act, p.u[k], p.pick[k], p.drop[k], p.geo, picked,
                 delivered, collided);
    int n_pick = 0, n_del = 0, n_col = 0;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      n_pick += picked[i];
      n_del += delivered[i];
      n_col += collided[i];
    }
    deliv += n_del;
    float s = __fadd_rn(p.step_penalty_a,
                        __fmul_rn(p.pickup_reward, (float)n_pick));
    s = __fadd_rn(s, __fmul_rn(p.delivery_reward, (float)n_del));
    s = __fadd_rn(s, __fmul_rn(p.collision_penalty, (float)n_col));
    rew = __fadd_rn(rew, s);
  }
  wh::store_env(e, b, p.o_pos, p.o_areq, p.o_carry, p.o_rpick, p.o_rdrop,
                p.o_rstat, p.o_ragent);
  p.o_deliv[b] = deliv;
  p.o_rew[b] = rew;
}

template <int A, int R>
struct LaunchGreedy {
  static void run(const GreedyArgs& p, cudaStream_t stream) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
    greedy_rollout_kernel<A, R><<<blocks, threads, 0, stream>>>(p);
  }
};

}  // namespace

extern "C" const char* wh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int wh_greedy_rollout(
    int A, int R, long B, int T, int H, int W, float spawn_prob,
    float step_penalty_a, float pickup_reward, float delivery_reward,
    float collision_penalty, const unsigned char* walls, const int* pos,
    const int* areq, const int* carry, const int* rpick, const int* rdrop,
    const int* rstat, const int* ragent, const float* u, const int* pick,
    const int* drop, int* o_pos, int* o_areq, int* o_carry, int* o_rpick,
    int* o_rdrop, int* o_rstat, int* o_ragent, int* o_deliv, float* o_rew,
    void* stream) {
  GreedyArgs p{B,       T,      {H, W, spawn_prob, walls},
               step_penalty_a,  pickup_reward,   delivery_reward,
               collision_penalty, pos,  areq,    carry,
               rpick,   rdrop,  rstat, ragent,  u,
               pick,    drop,   o_pos, o_areq,  o_carry,
               o_rpick, o_rdrop, o_rstat, o_ragent, o_deliv,
               o_rew};
  if (B <= 0) return (int)cudaSuccess;
  if (!wh::dispatch_shape<LaunchGreedy>(A, R, p, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
