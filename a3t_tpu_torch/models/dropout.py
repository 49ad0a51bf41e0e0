"""Recompute-in-backward dropout with an 8-bit Bernoulli mask
(``a3t_tpu/models/dropout.py``).

The rule is the JAX package's:

* keep iff a uniform byte ``< _threshold(rate) = clamp(round((1 - rate) *
  256), 1, 255)``, so the keep probability is quantised to n / 256;
* kept values are scaled by 1 / ``realized_keep_prob(rate)``, the keep
  probability the byte rule realises, so E[dropout(x)] == x exactly;
* the backward saves only the seed and regenerates the mask;
* rates at or below 1/512 are the identity (they would round to the
  threshold's floor and drop 1/256 of the elements).

The bytes come from a ``torch.Generator`` seeded per call, so they differ
from JAX's bits: this module is held to its rule and its statistics, not to
JAX's masks.  Seeds are drawn on the host from the step's CPU generator
(:func:`draw_seed`), so no dropout site waits for the card.

A site on a tensor that the model axis splits (the feed-forward's hidden
units, the plain attention's heads; ``parallel/sharding.py``) takes a
``part = (dim, t, tp)``: it draws the byte mask of the full width from its
seed and keeps slice t of tp along ``dim``, so that its mask is the
matching slice of one process's.  Every site draws its seed at any tp, so
the draws from the step's generator stay in step.

A site on a tensor that the seq axis splits by rows (``parallel/
sequence.py``: a rank's frame block and the whole text) takes ``rows =
(dim, index, n)`` at call time: it draws the mask of the whole tensor,
``n`` rows along ``dim``, and keeps the rows ``index`` there, so that the
rank's mask is those rows of one process's.  ``part`` and ``rows`` compose
(a feed-forward's hidden units under both axes).
"""

from __future__ import annotations

import torch
from torch import nn


def _threshold(rate: float) -> int:
    """Keep-threshold in [1, 255]: keep iff byte < threshold."""
    return min(max(int(round((1.0 - rate) * 256.0)), 1), 255)


def realized_keep_prob(rate: float) -> float:
    """The exact keep probability the byte mask realises for ``rate``."""
    return _threshold(rate) / 256.0


def draw_seed(generator: torch.Generator) -> int:
    """One int seed in [0, 2^31 - 1) from a CPU generator, without touching
    the card."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def keep_mask(shape, seed: int, rate: float, device,
              part=None, rows=None) -> torch.Tensor:
    """Bool keep-mask of ``shape`` drawn from a generator seeded with
    ``seed`` on ``device``; with ``part = (dim, t, tp)``, slice t of tp
    along ``dim`` of the mask of the full shape (``shape[dim] * tp``); with
    ``rows = (dim, index, n)``, the rows ``index`` along ``dim`` of the
    mask of ``n`` rows there."""
    shape = list(shape)
    if part is not None:
        dim, t, tp = part
        dim %= len(shape)
        n = shape[dim]
        shape[dim] = n * tp
    if rows is not None:
        rdim, index, length = rows
        rdim %= len(shape)
        shape[rdim] = length
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8)
    if part is not None:
        bits = bits.narrow(dim, t * n, n)
    if rows is not None:
        bits = bits.index_select(rdim, index.to(device))
    return bits < _threshold(rate)


def _apply(x: torch.Tensor, seed: int, rate: float, part,
           rows) -> torch.Tensor:
    keep = keep_mask(x.shape, seed, rate, x.device, part, rows)
    return torch.where(keep, x * (1.0 / realized_keep_prob(rate)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _SeededDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed: int, rate: float, part, rows):
        ctx.seed, ctx.rate, ctx.part, ctx.rows = seed, rate, part, rows
        return _apply(x, seed, rate, part, rows)

    @staticmethod
    def backward(ctx, g):
        return (_apply(g, ctx.seed, ctx.rate, ctx.part, ctx.rows), None,
                None, None, None)


def seeded_dropout(x: torch.Tensor, seed: int, rate: float,
                   part=None, rows=None) -> torch.Tensor:
    """Unbiased byte dropout; identity when the rate is below the byte
    grain (``rate <= 1/512``).  ``part``, ``rows``: see
    :func:`keep_mask`."""
    if rate <= 1.0 / 512.0:
        return x
    if part is not None and part[2] == 1:
        part = None
    return _SeededDropout.apply(x, seed, rate, part, rows)


class SeededDropout(nn.Module):
    """Dropout with the recompute-in-backward rule, active in training mode.

    ``forward(x, generator)`` draws this call's seed from ``generator`` (the
    step's CPU generator); a module in training mode with a rate above the
    byte grain needs one, as the JAX module needs a "dropout" rng.
    ``part = (dim, t, tp)``: ``x`` is slice t of tp along ``dim`` of the
    full tensor; ``forward``'s ``rows = (dim, index, n)``: ``x`` holds the
    rows ``index`` of the whole tensor's ``n`` along ``dim``
    (:func:`keep_mask`).
    """

    def __init__(self, rate: float, part=None):
        super().__init__()
        self.rate = float(rate)
        self.part = part

    def forward(self, x, generator=None, rows=None):
        if not self.training or self.rate <= 1.0 / 512.0:
            return x
        if generator is None:
            raise ValueError("dropout in training mode needs a generator")
        return seeded_dropout(x, draw_seed(generator), self.rate, self.part,
                              rows)
