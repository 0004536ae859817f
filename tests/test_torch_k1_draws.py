"""What the greedy rollout kernel K1 computes besides the tick, on the CPU.

K1 makes each env's draws in registers from its key chain
(``kernels/csrc/threefry.cuh`` ``spawn_draws``) and stages the map in shared
memory. Here, at a small size:

- ``rng.spawn_draws``, one tick's draws in the kernel's order, chained over
  T ticks, is bit-equal to ``rng.batched_step_draws`` and to the JAX
  package's ``batched_step_draws``;
- the wrapper's kernel arguments: the free-cell table and the wall mask
  decode back to the config, and a numpy uint32 emulation of the kernel's
  exact modulo (``rollout.span_mod``'s constants) reproduces
  ``rng.randint`` over edge values and a million seeded draws;
- greedy ticks on the per-tick draws give the plain twin's rollout.

The kernel itself is held against these on the card by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import EnvConfig as JEnvConfig
from warehouse_tpu_torch import (EnvConfig, large_config, medium_config, rng,
                                 shelves_config, small_config)
from warehouse_tpu_torch.baselines.greedy import greedy_actions
from warehouse_tpu_torch.env import batch, engine
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import rollout

from test_torch_rng import assert_bits, to_torch

T = 8
HIGH_CONTENTION = dict(height=4, width=4, num_agents=4, queue_capacity=4,
                       init_requests=4, spawn_prob=0.9)
STREAM_CONFIGS = {
    "medium": (medium_config(), dict(height=9, width=9, num_agents=4,
                                     queue_capacity=8, init_requests=4)),
    "shelves": (shelves_config(), None),
    "high_contention": (EnvConfig(**HIGH_CONTENTION), HIGH_CONTENTION),
}
MAPS = {"small": small_config(), "medium": medium_config(),
        "large": large_config(), "shelves": shelves_config(),
        "high_contention": EnvConfig(**HIGH_CONTENTION)}
M32 = 2 ** 32 - 1


def jax_config(name):
    cfg, kw = STREAM_CONFIGS[name]
    return JEnvConfig(**(kw if kw is not None else dict(
        height=cfg.height, width=cfg.width, num_agents=cfg.num_agents,
        queue_capacity=cfg.queue_capacity, init_requests=cfg.init_requests,
        walls=cfg.walls)))


@pytest.mark.parametrize("name", sorted(STREAM_CONFIGS))
def test_spawn_draws_chained_equal_the_streams(name):
    """T chained ``rng.spawn_draws``, the plain version of the kernel's
    draw launch (``rollout.spawn_draws_check`` on the card)."""
    cfg = STREAM_CONFIGS[name][0]
    jcfg = jax_config(name)
    assert jcfg.free_cells == cfg.free_cells
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(48))
    tk = to_torch(jk)
    keys, us, picks, drops = tk, [], [], []
    for _ in range(T):
        keys, u, pick, drop = rng.spawn_draws(keys, cfg)
        us.append(u)
        picks.append(pick)
        drops.append(drop)
    got = (keys, torch.stack(us), torch.stack(picks), torch.stack(drops))
    want_torch = rng.batched_step_draws(tk, cfg, T)[:4]
    want_jax = jrng.batched_step_draws(jk, jcfg, T)[:4]
    for g, wt, wj, what in zip(got, want_torch, want_jax,
                               ("key", "u", "pick", "drop")):
        assert g.dtype == wt.dtype, what
        assert torch.equal(g, wt), what
        assert_bits(np.asarray(wj), g, what)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_map_tables_decode_to_the_config(name):
    cfg = MAPS[name]
    walls, free = rollout.map_tables(cfg, "cpu")
    assert walls.dtype == torch.uint8 and walls.shape == (cfg.num_cells,)
    assert free.dtype == torch.int32 and free.shape == (cfg.num_free,)
    assert tuple(torch.nonzero(walls)[:, 0].tolist()) == tuple(
        sorted(cfg.walls))
    assert tuple(free.tolist()) == cfg.free_cells
    assert bool((walls[free.long()] == 0).all())
    # Made once per (map, device): the same tensors on every call.
    again = rollout.map_tables(cfg, torch.device("cpu"))
    assert again[0] is walls and again[1] is free
    assert rollout.wall_mask(cfg, "cpu") is walls


def emulate_mod(x, span, magic, sh1, sh2):
    """threefry.cuh ``mod_span`` in numpy uint32: multiply-high, then the
    shifts, each step wrapping as the kernel's uint32_t does."""
    x = np.asarray(x, np.uint32)
    t = ((x.astype(np.uint64) * np.uint64(magic)) >> np.uint64(32)).astype(
        np.uint32)
    q = (t + ((x - t) >> np.uint32(sh1))) >> np.uint32(sh2)
    return x - q * np.uint32(span)


def emulate_randint(higher, lower, span):
    """threefry.cuh ``randint``'s fold of two bit draws."""
    magic, sh1, sh2, mult = rollout.span_mod(span)
    hm = emulate_mod(higher, span, magic, sh1, sh2)
    lm = emulate_mod(lower, span, magic, sh1, sh2)
    return emulate_mod(hm * np.uint32(mult) + lm, span, magic, sh1, sh2)


def exact_randint(higher, lower, span):
    """rng.randint's fold on Python integers."""
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    return ((((higher % span) * mult) & M32) + lower % span & M32) % span


@pytest.fixture(scope="module")
def million_draws():
    """A million seeded keys, and the two bit draws ``rng.randint`` folds
    for each: ``random_bits`` of ``split(key, 2)``'s two keys."""
    words = np.random.default_rng(19).integers(0, 2 ** 32, size=(10 ** 6, 2),
                                               dtype=np.uint64)
    keys = torch.from_numpy(words.astype(np.int64))
    k = rng.split(keys, 2)
    higher = rng.random_bits(k[:, 0]).numpy().astype(np.uint32)
    lower = rng.random_bits(k[:, 1]).numpy().astype(np.uint32)
    return keys, higher, lower


@pytest.mark.parametrize("span", [16, 25, 81, 103, 225])
def test_span_mod_reproduces_randint(span, million_draws):
    magic, sh1, sh2, _ = rollout.span_mod(span)
    assert 0 < magic <= M32
    edges = sorted({0, 1, 2, span - 1, span, span + 1, 2 * span - 1,
                    2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, M32 - span, M32 - 1,
                    M32, (M32 // span) * span, (M32 // span) * span - 1,
                    65535, 65536, 65537})
    x = np.array(edges, np.uint32)
    np.testing.assert_array_equal(emulate_mod(x, span, magic, sh1, sh2),
                                  np.array([e % span for e in edges]))
    hi, lo = np.meshgrid(x, x)
    want = np.array([exact_randint(int(h), int(l), span)
                     for h, l in zip(hi.ravel(), lo.ravel())])
    np.testing.assert_array_equal(emulate_randint(hi.ravel(), lo.ravel(),
                                                  span), want)

    keys, higher, lower = million_draws
    want = rng.randint(keys, (), 0, span).numpy()
    np.testing.assert_array_equal(emulate_randint(higher, lower, span), want)
    np.testing.assert_array_equal(
        emulate_mod(higher, span, magic, sh1, sh2), higher % np.uint32(span))


def test_span_mod_edges():
    assert rollout.span_mod(1) == (1, 0, 0, 0)
    assert rollout.span_mod(2 ** 31)[1:3] == (1, 30)
    with pytest.raises(ValueError, match="span"):
        rollout.span_mod(0)


@pytest.mark.parametrize("name", ["medium", "shelves"])
def test_ticks_on_per_tick_draws_equal_the_twin(name):
    """The kernel's order: each tick draws from the key chain, then takes
    the greedy actions and ticks; the same rollout as the plain twin's."""
    cfg = MAPS[name]
    keys = rng.fold_in(rng.prng_key(4), torch.arange(24))
    state, _ = batch.reset_batch(cfg, keys)
    s, key = state, state.key
    deliv = torch.zeros(24, dtype=torch.int32)
    for _ in range(T):
        key, u, pick, drop = rng.spawn_draws(key, cfg)
        s, _, delivered, _ = engine.tick(cfg, s, greedy_actions(cfg, s), u,
                                         pick, drop)
        deliv += delivered.sum(-1, dtype=torch.int32)
    want, want_deliv, _ = rollout.greedy_rollout_reference(cfg, state, T)
    s = s.replace(t=state.t + T, key=key)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(want, f)), f
    assert torch.equal(deliv, want_deliv)


def test_spawn_draws_check_takes_cuda_keys():
    """The draw launch has no CPU route: its plain version is
    ``rng.spawn_draws``, chained as above."""
    keys = rng.fold_in(rng.prng_key(0, "cpu"), torch.arange(4))
    with pytest.raises(ValueError, match="CUDA keys"):
        rollout.spawn_draws_check(medium_config(), keys, 2)
