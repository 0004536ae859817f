"""The CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so
it runs where only the port is installed; tests/conftest.py imports jax,
so run it there with ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py``. chip_smoke.py makes the same checks
at the main path's full sizes.
"""

import pytest
import torch

from warehouse_tpu_torch import (large_config, medium_config, rng,
                                 shelves_config, small_config)
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.act import act_steps
from warehouse_tpu_torch.kernels.rollout import (greedy_rollout,
                                                 greedy_rollout_reference)
from warehouse_tpu_torch.models import make_model

pytestmark = pytest.mark.gpu
N = 1000  # not a multiple of the envs per block: the last block is ragged
PRESETS = {"small": small_config(), "medium": medium_config(),
           "large": large_config(), "shelves": shelves_config()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def reset(cfg, seed, dev):
    keys = rng.fold_in(rng.prng_key(seed, dev), torch.arange(N, device=dev))
    return batch.reset_batch(cfg, keys)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_greedy_kernel_bit_equal_to_twin(name, dev):
    cfg = PRESETS[name]
    state, _ = reset(cfg, 2, dev)
    k = greedy_rollout(cfg, state, cfg.max_steps)
    p = greedy_rollout_reference(cfg, state, cfg.max_steps)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(k[0], f), getattr(p[0], f)), f
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[2].view(torch.int32), p[2].view(torch.int32))
    assert int(k[1].sum()) > 0


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_act_kernel_matches_plain_path(name, dev):
    """The kernel's actions replayed through the plain engine: obs,
    rewards and deliveries bit-equal; values and log-probs within 1e-4
    of the plain MLP on the kernel's obs."""
    cfg, steps = PRESETS[name], 8
    m = make_model(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    state, _ = reset(cfg, 4, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(1, dev), steps,
                                     (5, N * cfg.num_agents))
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, state, u, pick, drop, g)
    s = state
    for t in range(steps):
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(ts.reward, reward[t])
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    with torch.no_grad():
        logits, v = m(obs)
    lp_plain = torch.log_softmax(logits, -1).gather(
        -1, action.long()[..., None])[..., 0]
    assert float((v - value).abs().max()) < 1e-4
    assert float((lp_plain - lp).abs().max()) < 1e-4
