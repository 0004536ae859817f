// K1: the greedy-baseline rollout with its draws, T env ticks per env in
// one launch.
//
// Replaces warehouse_tpu/pallas/rollout.py greedy_rollout_pallas (:516,
// body _kernel :417) together with the draw stream that function makes
// before its pallas_call (:534-535, rng.batched_step_draws). On the TPU
// XLA fused that threefry stream; here, as eager torch ops on the host's
// schedule, it took 99% of a greedy episode. The draws of one env at tick t
// depend only on that env's key chain, so the thread that owns the env for
// all T ticks carries the key in two registers and makes the tick's draws
// where it needs them (threefry.cuh spawn_draws: 14 threefry hashes).
//
// Bound on this card: the INT32 issue rate, not bytes. Device memory sees
// the env state, its key and t once in and once out, 8 bytes of outputs
// besides (70 MB an episode at B = 131072, 0.021 ms at 3.35 TB/s). The
// work is integer: at config 4 the function needs ~980 operations of
// draws and ~1050 of the tick's compares, selects and logic (rule 4's A
// passes over the agent pairs, the select chains over the R slots) per
// env-tick, ~1500 of them on the ALU pipe alone (chip_smoke.py
// k1_int_ops, counted as Hopper instructions, 3-input logic as one LOP3,
// 3-input adds as one IADD3); PERF.md gives the bound in ms.
// What the design does about it:
// - one thread owns one env, so every branch of the tick stays in the
//   thread and nothing is exchanged between threads;
// - nothing is read inside the tick from device memory: the free-cell
//   table and the wall mask are staged once a CTA into shared memory (the
//   tick's Geometry::walls points there), the draws are made in registers;
// - the env state lives in registers (in part spilled at 6 and 8 agents,
//   below): every loop over agents and slots
//   unrolls on the template's A and R, and env_tick.cuh's target reads
//   the agent's slot with masks. Under launch bounds of 512 threads a CTA
//   (128 registers a thread; -Xptxas -v on an H100 build,
//   tools/torch_k1_blocks.py): (A, R) = (2, 4) 64 registers, (4, 8) 109,
//   no stack frame or spills; (6, 12) and (8, 16) spill at 128 (96- and
//   392-byte stack frames) and still ran 8% and 28% faster at B = 131072
//   than at 256 threads unspilled (154 and 195 registers), with twice the
//   warps an SM; 512 also led at config 4. A larger env than the presets'
//   (4 A + 6 R > 128 ints, a pair's own library) takes bounds of 256
//   threads, 255 registers (K1_MAX_THREADS): at (12, 24) a 176-byte
//   stack frame against 1136 under 512, and less time an episode (PERF.md,
//   tools/torch_k1_blocks.py). A small batch takes smaller CTAs
//   (k1_threads), down to a warp, so that its CTAs cover the SMs.
//
// Exactness: the draws are rng.py's bits (threefry.cuh); the reward sum
// uses __fmul_rn/__fadd_rn in the order of rollout.py:488-493, so nvcc
// cannot contract it into FMAs.

#include <cstdint>

#include <cuda_runtime.h>

#include "env_tick.cuh"
#include "threefry.cuh"

namespace {

// The most threads a CTA of the (A, R) instance takes, its launch bounds:
// 512 (128 registers a thread) for an env of at most 128 ints, as the
// presets' are; 256 (255 registers) for a larger one.
template <int A, int R>
constexpr int K1_MAX_THREADS = 4 * A + 6 * R <= 128 ? 512 : 256;

// Threads a CTA for B envs: the instance's most, halved down to a warp
// while the CTAs would not cover the SMs.
int k1_threads(int max_threads, long B, int sms) {
  int threads = max_threads;
  while (threads > 32 && (B + threads - 1) / threads < sms) threads /= 2;
  return threads;
}

// The map staged in shared memory: the free-cell table, then the walls.
constexpr long MAX_MAP_SMEM = 48 * 1024;

struct GreedyArgs {
  long B;
  int T, H, W;
  wh::SpanMod span;
  float spawn_prob;
  float step_penalty_a;  // float32(step_penalty * A)
  float pickup_reward, delivery_reward, collision_penalty;
  const unsigned char* walls;  // [H * W], 1 on wall cells
  const int* free_cells;       // [span] row-major ids of the free cells
  const long long* key;        // [B, 2] uint32 words
  const int* t;
  const int *pos, *areq, *carry, *rpick, *rdrop, *rstat, *ragent;
  int *o_pos, *o_areq, *o_carry, *o_rpick, *o_rdrop, *o_rstat, *o_ragent;
  long long* o_key;
  int *o_t, *o_deliv;
  float* o_rew;
};

long map_smem_bytes(int span, int H, int W) {
  return 4L * span + (long)H * W;
}

template <int A, int R>
__global__ void __launch_bounds__(K1_MAX_THREADS<A, R>)
    greedy_rollout_kernel(GreedyArgs p) {
  extern __shared__ int smem[];
  int* s_free = smem;
  unsigned char* s_walls =
      reinterpret_cast<unsigned char*>(smem + p.span.span);
  for (int i = threadIdx.x; i < (int)p.span.span; i += blockDim.x)
    s_free[i] = p.free_cells[i];
  for (int i = threadIdx.x; i < p.H * p.W; i += blockDim.x)
    s_walls[i] = p.walls[i];
  __syncthreads();

  const long b = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const wh::Geometry geo{p.H, p.W, p.spawn_prob, s_walls};
  wh::Env<A, R> e;
  wh::load_env(e, b, p.pos, p.areq, p.carry, p.rpick, p.rdrop, p.rstat,
               p.ragent);
  wh::Key key{(uint32_t)p.key[2 * b], (uint32_t)p.key[2 * b + 1]};
  int deliv = 0;
  float rew = 0.f;
  for (int t = 0; t < p.T; ++t) {
    float u;
    int spick, sdrop;
    key = wh::spawn_draws(key, p.span, s_free, u, spick, sdrop);
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
    wh::env_tick(e, act, u, spick, sdrop, geo, picked, delivered, collided);
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
  p.o_key[2 * b] = key.k0;
  p.o_key[2 * b + 1] = key.k1;
  p.o_t[b] = p.t[b] + p.T;
  p.o_deliv[b] = deliv;
  p.o_rew[b] = rew;
}

template <int A, int R>
struct LaunchGreedy {
  static void run(const GreedyArgs& p, int sms, cudaStream_t stream) {
    const int threads = k1_threads(K1_MAX_THREADS<A, R>, p.B, sms);
    const unsigned blocks = (unsigned)((p.B + threads - 1) / threads);
    greedy_rollout_kernel<A, R>
        <<<blocks, threads, map_smem_bytes(p.span.span, p.H, p.W),
           stream>>>(p);
  }
};

// The checks' launch of threefry.cuh alone: T ticks of (u, pick, drop),
// [T, B] each, and the final keys, as rng.batched_step_draws makes them.
__global__ void spawn_draws_kernel(long B, int T, wh::SpanMod span,
                                   const int* free_cells,
                                   const long long* key,
                                   float* u, int* pick, int* drop,
                                   long long* o_key) {
  const long b = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  wh::Key k{(uint32_t)key[2 * b], (uint32_t)key[2 * b + 1]};
  for (int t = 0; t < T; ++t) {
    const long i = t * B + b;
    k = wh::spawn_draws(k, span, free_cells, u[i], pick[i], drop[i]);
  }
  o_key[2 * b] = k.k0;
  o_key[2 * b + 1] = k.k1;
}

wh::SpanMod span_mod(int span, unsigned magic, int sh1, int sh2,
                     unsigned mult) {
  return {(uint32_t)span, magic, sh1, sh2, mult};
}

}  // namespace

extern "C" const char* wh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int wh_greedy_rollout(
    int A, int R, long B, int T, int H, int W, int span, unsigned magic,
    int sh1, int sh2, unsigned mult, float spawn_prob, float step_penalty_a,
    float pickup_reward, float delivery_reward, float collision_penalty,
    const unsigned char* walls, const int* free_cells, const long long* key,
    const int* t, const int* pos, const int* areq, const int* carry,
    const int* rpick, const int* rdrop, const int* rstat, const int* ragent,
    int* o_pos, int* o_areq, int* o_carry, int* o_rpick, int* o_rdrop,
    int* o_rstat, int* o_ragent, long long* o_key, int* o_t, int* o_deliv,
    float* o_rew, void* stream) {
  GreedyArgs p{B,       T,      H,      W,
               span_mod(span, magic, sh1, sh2, mult),
               spawn_prob, step_penalty_a, pickup_reward,
               delivery_reward, collision_penalty, walls, free_cells,
               key,     t,      pos,    areq,   carry,  rpick,  rdrop,
               rstat,   ragent, o_pos,  o_areq, o_carry, o_rpick, o_rdrop,
               o_rstat, o_ragent, o_key, o_t,   o_deliv, o_rew};
  if (B <= 0) return (int)cudaSuccess;
  if (span < 1 || map_smem_bytes(span, H, W) > MAX_MAP_SMEM)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!wh::dispatch_shape<LaunchGreedy>(A, R, p, sms, (cudaStream_t)stream))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int wh_spawn_draws(long B, int T, int span, unsigned magic,
                              int sh1, int sh2, unsigned mult,
                              const int* free_cells, const long long* key,
                              float* u, int* pick, int* drop,
                              long long* o_key, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (span < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  spawn_draws_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      B, T, span_mod(span, magic, sh1, sh2, mult), free_cells, key, u, pick,
      drop, o_key);
  return (int)cudaGetLastError();
}
