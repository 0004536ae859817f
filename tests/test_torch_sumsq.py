"""The plain version of the meshed learners' sums of squares
(``kernels.sgd.grad_sumsq``, ROADMAP F-10) on the CPU: each block's sum in
``reduce_kernel``'s tree order, bit for bit against a plain loop of that
tree and within float32 rounding of the float64 sum; the four learners'
layouts (a segment a policy group; the CNN's conv gradient, then its dense
one; the GRU / LSTM padded to H rounded up to 4, a padding that changes
nothing the net computes). The kernel itself runs on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py`` ``sumsq_check``).
"""

import numpy as np
import pytest
import torch

from warehouse_tpu_torch import medium_config
from warehouse_tpu_torch.kernels import sgd, sgd_cnn, sgd_rnn
from warehouse_tpu_torch.kernels.act import pack_cnn
from warehouse_tpu_torch.kernels.act_rnn import pack_rnn
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.models.policy import (apply_rnn,
                                               make_multi_policy_model)


def tree_sums(x: np.ndarray) -> np.ndarray:
    """Each block of 256's squares summed as ``reduce_kernel``'s tree: a
    float32 loop, ``sh[t] += sh[t + w]`` for w = 128, ..., 1."""
    n = len(x)
    out = []
    for b in range(-(-n // sgd.RED)):
        sh = np.zeros(sgd.RED, np.float32)
        seg = x[b * sgd.RED:(b + 1) * sgd.RED]
        sh[:len(seg)] = seg * seg
        w = sgd.RED // 2
        while w:
            for t in range(w):
                sh[t] = np.float32(sh[t] + sh[t + w])
            w //= 2
        out.append(sh[0])
    return np.array(out, np.float32)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_block_sumsq_plain_is_the_tree(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = sgd.block_sumsq_plain(torch.from_numpy(x)).numpy()
    want = tree_sums(x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    f64 = [(x[b:b + sgd.RED].astype(np.float64) ** 2).sum()
           for b in range(0, n, sgd.RED)]
    np.testing.assert_allclose(got, f64, rtol=1e-5)


def params_of(model) -> dict:
    return {k: v.detach() for k, v in model.state_dict().items()}


def test_layouts_of_the_mlp_and_cnn_learners():
    cfg, gen = medium_config(), torch.Generator().manual_seed(0)
    mlp = params_of(make_model(cfg, "mlp", 16, 2, gen, "cpu"))
    n = sgd.pack(mlp).numel()
    assert sgd.mlp_sq_layout(mlp).segments == ((0, n),)
    groups = params_of(make_multi_policy_model(cfg, (0, 1, 0, 1), "mlp", 16,
                                               2, gen, "cpu"))
    assert sgd.mlp_sq_layout(groups).segments == ((0, n), (n, n))
    cnn = params_of(make_model(cfg, "cnn", 16, 2, gen, "cpu"))
    flat = pack_cnn(cnn)
    (s0, n_conv), (s1, n_dense) = sgd_cnn.cnn_sq_layout(cnn).segments
    assert (s0, s1, n_conv + n_dense) == (0, n_conv, flat.numel())
    # The conv layers lead the packed vector: its first n_conv entries are
    # theirs, laid out [3, 3, out, in] as the kernels read them.
    conv = torch.cat([cnn[k].permute(2, 3, 0, 1).reshape(-1)
                      if cnn[k].dim() == 4 else cnn[k]
                      for k in sgd_cnn.CONV_KEYS])
    assert torch.equal(flat[:n_conv], conv)
    g = torch.randn(flat.numel(), generator=gen)
    sq = sgd.grad_sumsq(g, sgd_cnn.cnn_sq_layout(cnn))
    assert torch.equal(sq, torch.cat([sgd.block_sumsq_plain(g[:n_conv]),
                                      sgd.block_sumsq_plain(g[n_conv:])]))
    out = torch.empty_like(sq)
    layout = sgd_cnn.cnn_sq_layout(cnn)
    assert sgd.grad_sumsq(g, layout, out) is out
    assert torch.equal(out, sq) and layout.sums == sq.numel()
    with pytest.raises(ValueError, match="packed float32 gradient"):
        sgd.grad_sumsq(g[1:], layout)
    with pytest.raises(ValueError, match="contiguous float32 sums"):
        sgd.grad_sumsq(g, layout, out[1:])


@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 18])
def test_rnn_layout_pads_to_a_multiple_of_4(arch, hidden):
    """At a width off a multiple of 4 the sums run over the padded net's
    vector: the natural gradient's entries at their padded places, zeros
    between (so the same sums of squares); the padded params compute what
    the natural ones do, the pad units staying 0."""
    cfg, gen = medium_config(), torch.Generator().manual_seed(1)
    params = params_of(make_model(cfg, arch, hidden, 2, gen, "cpu"))
    layout = sgd_rnn.rnn_sq_layout(params)
    flat = pack_rnn(params)
    if hidden % 4 == 0:
        assert layout.pad is None and layout.segments == ((0, flat.numel()),)
        return
    Hq = 20
    padded = sgd_rnn.pad_rnn_params(params, Hq)
    assert torch.equal(layout.pad(flat), pack_rnn(padded))
    assert layout.segments == ((0, pack_rnn(padded).numel()),)
    for k, v in padded.items():  # H -> Hq where the cell's width runs
        want = list(params[k].shape)
        if k.startswith("cell."):
            want[0] = Hq
            if k.startswith("cell.h") and len(want) == 2:
                want[1] = Hq
        elif k in ("logits.weight", "value.weight"):
            want[1] = Hq
        assert list(v.shape) == want, k
    g = torch.randn(flat.numel(), generator=gen)
    np.testing.assert_allclose(sgd.grad_sumsq(g, layout).double().sum(),
                               (g.double() ** 2).sum(), rtol=1e-5)
    obs = torch.randn(3, cfg.num_agents, cfg.obs_dim, generator=gen)
    carry = torch.randn(3, cfg.num_agents, hidden, generator=gen)
    pad = torch.nn.functional.pad(carry, (0, Hq - hidden))
    carry, pad = ((carry, carry), (pad, pad)) if arch == "lstm" else (
        carry, pad)
    for _ in range(2):
        logits, value, carry = apply_rnn(params, obs, carry)
        plogits, pvalue, pad = apply_rnn(padded, obs, pad)
        torch.testing.assert_close(plogits, logits)
        torch.testing.assert_close(pvalue, value)
        for c, p in zip(carry if arch == "lstm" else (carry,),
                        pad if arch == "lstm" else (pad,)):
            torch.testing.assert_close(p[..., :hidden], c)
            assert not p[..., hidden:].any()
