"""The port's dropout (a3t_tpu_torch/models/dropout.py) by its rule and its
statistics.  Its bits come from a torch.Generator and cannot equal JAX's, so
the rule is held to the JAX package's: the byte threshold, the realised
keep probability, the identity below the byte grain, and a backward that
regenerates the forward's mask."""

import math

import numpy as np
import pytest
import torch

from a3t_tpu.models import dropout as jd
from a3t_tpu_torch.models import dropout as td

RATES = [0.0, 1.0 / 1024, 1.0 / 512, 0.003, 0.05, 0.1, 0.2, 0.25, 0.5, 0.7,
         0.9, 0.999]


@pytest.mark.parametrize("rate", RATES)
def test_threshold_and_scale_equal_jax(rate):
    assert td._threshold(rate) == jd._threshold(rate)
    assert td.realized_keep_prob(rate) == jd.realized_keep_prob(rate)


@pytest.mark.parametrize("rate", [0.0, 1.0 / 1024, 1.0 / 512])
def test_rates_below_the_byte_grain_are_the_identity(rate):
    x = torch.randn(64, 64)
    assert td.seeded_dropout(x, 3, rate) is x
    mod = td.SeededDropout(rate).train()
    assert mod(x) is x  # no generator needed: nothing is drawn


def test_backward_regenerates_the_forward_mask():
    """The gradient is zero exactly where the output was dropped and
    1/keep elsewhere, for the same seed."""
    x = torch.randn(128, 96, requires_grad=True)
    y = td.seeded_dropout(x, 1234, 0.3)
    (g,) = torch.autograd.grad(y.sum(), x)
    kept = y.detach() != 0
    scale = 1.0 / td.realized_keep_prob(0.3)
    assert torch.equal(g != 0, kept)
    np.testing.assert_allclose(g[kept].numpy(), scale, rtol=1e-6)
    np.testing.assert_allclose(y.detach()[kept].numpy(),
                               (x.detach() * scale)[kept].numpy(), rtol=1e-6)


def test_same_seed_same_mask_other_seed_other_mask():
    x = torch.ones(64, 64)
    a = td.seeded_dropout(x, 7, 0.5)
    assert torch.equal(a, td.seeded_dropout(x, 7, 0.5))
    assert not torch.equal(a, td.seeded_dropout(x, 8, 0.5))


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_keep_share_and_mean(rate):
    """Over n = 2^20 elements the keep share is within 5 binomial standard
    deviations of realized_keep_prob, and E[dropout(x)] = x for x = 1
    within 5 standard deviations of the scaled Bernoulli mean."""
    n = 1 << 20
    y = td.seeded_dropout(torch.ones(n), 99, rate)
    q = td.realized_keep_prob(rate)
    sd = math.sqrt(q * (1 - q) / n)
    assert abs((y != 0).float().mean().item() - q) < 5 * sd
    assert abs(y.double().mean().item() - 1.0) < 5 * sd / q


def test_module_modes():
    """Eval mode is the identity; training mode needs a generator and draws
    one seed per call from it."""
    x = torch.ones(32, 32)
    mod = td.SeededDropout(0.5)
    assert mod.eval()(x) is x
    mod.train()
    with pytest.raises(ValueError, match="generator"):
        mod(x)
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    a, b = mod(x, g1), mod(x, g2)
    assert torch.equal(a, b)
    assert not torch.equal(mod(x, g1), a)  # the next draw, another mask
