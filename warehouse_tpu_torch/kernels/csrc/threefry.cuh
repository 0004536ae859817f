// The canonical draw stream (docs/SEMANTICS.md §9) as __device__ functions
// on uint32_t: a bit-exact counterpart of the key operations and samplers
// of rng.py (jax.random with jax_threefry_partitionable=True).
//
// - threefry2x32: 20 rounds, rotations (13, 15, 26, 6) / (17, 29, 16, 24),
//   the 0x1BD11BDA parity word, key injection x1 + ks[(i+2)%3] + (i+1);
// - split(key)[i] and fold_in(key, i) are both threefry2x32(key, (0, i));
// - random_bits of shape () is the xor of the two words of
//   threefry2x32(key, (0, 0));
// - uniform fills the mantissa of a float in [1, 2) and subtracts 1, which
//   equals rng.uniform's max(0, x * 1 + 0) bit for bit;
// - randint splits its key in two, takes two bit draws and folds them
//   modulo the span with rng.randint's multiplier, in wrapping uint32_t.
//
// The span (the number of free cells) is known only at run time. A `%` by a
// run-time divisor compiles to a long division sequence, so the wrapper
// precomputes Granlund and Montgomery's constants for an exact modulo by
// one multiply-high (rollout.py `span_mod`; Figure 4.1 of "Division by
// invariant integers using multiplication", 1994).
//
// spawn_draws makes one env tick's draws in the order of rng.step_draws:
// 14 threefry hashes, about 75 integer operations each. Header only, so
// that any kernel that owns an env for a run of ticks can carry its key in
// two registers.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace wh {

struct Key {
  uint32_t k0, k1;
};

// x mod span for any uint32_t x: q = (t + ((x - t) >> sh1)) >> sh2 with
// t = umulhi(x, magic), magic = floor(2^32 (2^l - span) / span) + 1,
// l = ceil(log2 span), sh1 = min(l, 1), sh2 = max(l - 1, 0).
struct SpanMod {
  uint32_t span, magic;
  int sh1, sh2;
  uint32_t mult;  // rng.randint's multiplier: (2^16 mod span)^2 mod span
};

__device__ __forceinline__ uint32_t mod_span(uint32_t x, const SpanMod& m) {
  const uint32_t t = __umulhi(x, m.magic);
  const uint32_t q = (t + ((x - t) >> m.sh1)) >> m.sh2;
  return x - q * m.span;
}

__device__ __forceinline__ void threefry_mix(uint32_t& x0, uint32_t& x1,
                                             int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Four rounds of block I, then the key injection that follows them.
template <int I>
__device__ __forceinline__ void threefry_block(uint32_t& x0, uint32_t& x1,
                                               const uint32_t (&ks)[3]) {
  constexpr bool odd = I % 2;
  threefry_mix(x0, x1, odd ? 17 : 13);
  threefry_mix(x0, x1, odd ? 29 : 15);
  threefry_mix(x0, x1, odd ? 16 : 26);
  threefry_mix(x0, x1, odd ? 24 : 6);
  x0 += ks[(I + 1) % 3];
  x1 += ks[(I + 2) % 3] + (uint32_t)(I + 1);
}

// threefry2x32(key, (x0, x1)), the two output words in place.
__device__ __forceinline__ void threefry2x32(Key k, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  threefry_block<0>(x0, x1, ks);
  threefry_block<1>(x0, x1, ks);
  threefry_block<2>(x0, x1, ks);
  threefry_block<3>(x0, x1, ks);
  threefry_block<4>(x0, x1, ks);
}

// split(key, n)[i] for any n, and fold_in(key, i): threefry2x32(key, (0, i)).
__device__ __forceinline__ Key fold_in(Key k, uint32_t i) {
  uint32_t x0 = 0, x1 = i;
  threefry2x32(k, x0, x1);
  return {x0, x1};
}

__device__ __forceinline__ uint32_t random_bits(Key k) {
  uint32_t x0 = 0, x1 = 0;
  threefry2x32(k, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform(Key k) {
  return __uint_as_float((random_bits(k) >> 9) | 0x3F800000u) - 1.0f;
}

// randint(key, (), 0, span).
__device__ __forceinline__ uint32_t randint(Key k, const SpanMod& m) {
  const uint32_t higher = random_bits(fold_in(k, 0));
  const uint32_t lower = random_bits(fold_in(k, 1));
  return mod_span(mod_span(higher, m) * m.mult + mod_span(lower, m), m);
}

// One tick's draws (rng.step_draws without its reset key): the next key,
// the spawn draw u and the spawn's pickup and drop cells, ids looked up in
// the free-cell table `free_cells` (span entries).
__device__ __forceinline__ Key spawn_draws(Key key, const SpanMod& m,
                                           const int* free_cells, float& u,
                                           int& pick, int& drop) {
  const Key sk = fold_in(key, 1);
  u = uniform(fold_in(sk, 0));
  pick = free_cells[randint(fold_in(sk, 1), m)];
  drop = free_cells[randint(fold_in(sk, 2), m)];
  return fold_in(key, 0);
}

}  // namespace wh
