"""The port's threefry2x32 streams (warehouse_tpu_torch/rng.py) vs jax.random.

Key operations, uniform, randint and permutation are bit-exact. gumbel
goes through two logs, and torch's log differs from XLA's by up to an
ulp, so each log is held to 2 ulp and the composed draw to
2·eps + 2·ulp(g).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import medium_config, shelves_config
from warehouse_tpu_torch import rng

EPS = float(np.finfo(np.float32).eps)


def to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor; uint32 (keys) widens to int64."""
    a = np.array(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a)


def assert_bits(jax_x, torch_x, what=""):
    a, b = np.asarray(jax_x), torch_x.cpu().numpy()
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64),
                                      b.astype(np.int64), err_msg=what)


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture(scope="module", params=[0, 1234])
def keys(request):
    k = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(request.param), i))(jnp.arange(64))
    return k, to_torch(k)


@pytest.mark.parametrize("seed", [0, 7, -5, 2**31 - 1, 2**40 + 3])
def test_prng_key(seed):
    assert_bits(jax.random.PRNGKey(seed), rng.prng_key(seed))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_and_fold_in(keys, num):
    jk, tk = keys
    assert_bits(jax.vmap(lambda k: jax.random.split(k, num))(jk),
                rng.split(tk, num), "split")
    for data in (0, 1, 17, 2**31 + 5):
        assert_bits(jax.vmap(lambda k: jax.random.fold_in(k, data))(jk),
                    rng.fold_in(tk, data), f"fold_in {data}")


@pytest.mark.parametrize("shape", [(), (7,), (3, 4)])
def test_uniform(keys, shape):
    jk, tk = keys
    assert_bits(jax.vmap(lambda k: jax.random.uniform(k, shape))(jk),
                rng.uniform(tk, shape))


@pytest.mark.parametrize("n", [1, 5, 81, 121, 1000, 2**20 + 3])
def test_randint(keys, n):
    jk, tk = keys
    for shape in ((), (4,)):
        assert_bits(
            jax.vmap(lambda k: jax.random.randint(k, shape, 0, n))(jk),
            rng.randint(tk, shape, 0, n), f"shape {shape}")


@pytest.mark.parametrize("n", [1, 2, 81, 225, 2000])
def test_permutation(keys, n):
    """n = 2000 takes two sort rounds (ceil(3 ln n / ln(2^32 - 1)))."""
    jk, tk = keys
    assert_bits(jax.vmap(lambda k: jax.random.permutation(k, n))(jk),
                rng.permutation(tk, n))


def test_gumbel_within_two_ulp(keys):
    jk, tk = keys
    shape = (5, 40)
    tiny = float(np.finfo(np.float32).tiny)
    u = jax.vmap(lambda k: jax.random.uniform(k, shape, minval=tiny))(jk)
    assert_bits(u, rng.uniform(tk, shape, minval=tiny), "uniform")
    inner_j = -jnp.log(u)
    inner_t = -torch.log(to_torch(u))
    assert ulps(inner_j, inner_t.numpy()).max() <= 2
    outer_t = -torch.log(to_torch(inner_j))
    assert ulps(-jnp.log(inner_j), outer_t.numpy()).max() <= 2

    g_j = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, shape))(jk))
    g_t = rng.gumbel(tk, shape).numpy()
    bound = 2 * EPS + 2 * np.spacing(np.abs(g_j))
    assert (np.abs(g_t - g_j) <= bound).all()


@pytest.mark.parametrize("cfg", [medium_config(), shelves_config()],
                         ids=["medium", "shelves"])
def test_env_draw_streams(keys, cfg):
    jk, tk = keys
    for a, b in zip(jax.vmap(lambda k: jrng.reset_draws(k, cfg))(jk),
                    rng.reset_draws(tk, cfg)):
        assert_bits(a, b, "reset_draws")
    for a, b in zip(jax.vmap(lambda k: jrng.step_draws(k, cfg))(jk),
                    rng.step_draws(tk, cfg)):
        assert_bits(a, b, "step_draws")
    for a, b in zip(jrng.batched_step_draws(jk, cfg, 5),
                    rng.batched_step_draws(tk, cfg, 5)):
        assert_bits(a, b, "batched_step_draws")


def test_batched_gumbel_stream():
    shape = (5, 24)
    jk, g_j = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), 4, shape)
    tk, g_t = rng.batched_gumbel_stream(rng.prng_key(7), 4, shape)
    assert_bits(jk, tk, "next key")
    g_j = np.asarray(g_j)
    assert g_t.shape == g_j.shape
    bound = 2 * EPS + 2 * np.spacing(np.abs(g_j))
    assert (np.abs(g_t.numpy() - g_j) <= bound).all()
