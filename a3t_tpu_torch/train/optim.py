"""Optimizer: global-norm clip -> Adam -> Noam warmup, skipped on
non-finite gradients (``a3t_tpu/train/optim.py``).

The JAX package builds an optax chain,

    apply_if_finite(chain(clip_by_global_norm, [add_decayed_weights],
                          scale_by_adam, scale_by_schedule(-lr)))

and this module computes the same update in PyTorch:

* clipping is optax's ``where(norm < max, g, g / norm * max)`` with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6, so it is not used);
* weight decay is L2 added to the gradient before Adam, not AdamW;
* Adam is optax's ``scale_by_adam`` (moments ``(1 - b) g^k + b m``, bias
  correction by the incremented count, ``eps`` outside the square root);
* the schedule reads the chain's count before it is incremented, and Noam
  counts from ``count + 1`` (optax ``optim.py:47``);
* a step whose gradients hold a NaN or an infinity is skipped, as
  ``optax.apply_if_finite`` does: the parameters, the moments and the count
  (so the schedule and Adam's bias correction) stay put, and only
  ``notfinite_count`` moves; after ``max_consecutive_nonfinite`` skips in a
  row the update is applied all the same.

Everything is computed on the parameters' device, with no device-to-host
synchronisation: the decision to skip is a ``torch.where``.  The moments
are kept as one flat float32 vector each, in the order of the parameter
list given to :meth:`Optimizer.init`.  Gradient noise and gradient
accumulation (``accum_grad > 1``, optax.MultiSteps) are not ported.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    scheduler: str = "noamlr"  # "noamlr" | "warmuplr" | "constant"
    lr: float = 1.0
    model_size: int = 384
    warmup_steps: int = 4000
    grad_clip: float = 1.0
    accum_grad: int = 1
    adam_b1: float = 0.9
    adam_b2: float = 0.999  # torch.optim.Adam defaults (betas, eps)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    # gradient noise (trainer.py:620-628); 0 disables
    grad_noise_eta: float = 0.0
    grad_noise_gamma: float = 0.55
    # steps with non-finite grads to skip in a row before applying anyway
    max_consecutive_nonfinite: int = 1000


def _steps(step) -> torch.Tensor:
    """NoamLR counts from 1: the float32 ``step + 1``."""
    return torch.as_tensor(step).to(torch.float32) + 1.0


def noam_schedule(model_size: int, warmup_steps: int, base_lr: float = 1.0):
    """lr(step) = base_lr * model_size^-0.5 * min(s^-0.5, s * warmup^-1.5),
    s = step + 1 (espnet2/schedulers/noam_lr.py:12)."""
    factor = base_lr * model_size ** -0.5

    def schedule(step):
        s = _steps(step)
        return factor * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def warmup_lr_schedule(warmup_steps: int, base_lr: float):
    """espnet2 WarmupLR: Noam without the model-size factor."""
    factor = base_lr * warmup_steps ** 0.5

    def schedule(step):
        s = _steps(step)
        return factor * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


@dataclasses.dataclass
class OptState:
    """The chain's state.  ``mu``/``nu`` are flat float32 vectors in the
    parameters' order; ``count`` is the inner chain's step count (Adam's and
    the schedule's, which move together); the rest is apply_if_finite's.
    Every field is a tensor on the parameters' device."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor


class Optimizer:
    """``make_optimizer``'s chain: ``init(params)`` and
    ``apply(params, grads, state)``, the latter updating the parameters and
    the state in place."""

    def __init__(self, config: OptimConfig = OptimConfig()):
        if config.grad_noise_eta > 0:
            raise NotImplementedError("gradient noise is not ported")
        if config.accum_grad > 1:
            raise NotImplementedError("accum_grad > 1 is not ported")
        self.config = config
        if config.scheduler == "noamlr":
            self.schedule = noam_schedule(config.model_size,
                                          config.warmup_steps, config.lr)
        elif config.scheduler == "warmuplr":
            self.schedule = warmup_lr_schedule(config.warmup_steps, config.lr)
        elif config.scheduler == "constant":
            self.schedule = lambda step: torch.full_like(  # noqa: E731
                _steps(step), config.lr)
        else:
            raise ValueError(f"unknown scheduler {config.scheduler!r}")

    def init(self, params) -> OptState:
        params = list(params)
        dev = params[0].device
        n = sum(p.numel() for p in params)

        def scalar(value, dtype=torch.int32):
            return torch.tensor(value, dtype=dtype, device=dev)

        return OptState(
            mu=torch.zeros(n, dtype=torch.float32, device=dev),
            nu=torch.zeros(n, dtype=torch.float32, device=dev),
            count=scalar(0), notfinite_count=scalar(0),
            last_finite=scalar(True, torch.bool), total_notfinite=scalar(0))

    @torch.no_grad()
    def apply(self, params, grads, state: OptState) -> torch.Tensor:
        """One update of ``params`` (a list of tensors) by ``grads`` (the
        same order), in place; returns the gradients' global norm."""
        c = self.config
        g = torch.cat([x.reshape(-1).float() for x in grads])
        finite = torch.isfinite(g).all()
        g_norm = torch.linalg.vector_norm(g)
        u = torch.where(g_norm < c.grad_clip, g, g / g_norm * c.grad_clip)
        if c.weight_decay > 0:
            u = u + c.weight_decay * torch.cat(
                [p.reshape(-1).float() for p in params])
        b1, b2 = c.adam_b1, c.adam_b2
        mu = (1 - b1) * u + b1 * state.mu
        nu = (1 - b2) * (u * u) + b2 * state.nu
        count_inc = state.count + 1
        t = count_inc.to(torch.float32)
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        u = mu_hat / (torch.sqrt(nu_hat) + c.adam_eps)
        u = -self.schedule(state.count) * u

        notfinite = torch.where(finite, torch.zeros_like(state.count),
                                state.notfinite_count + 1)
        accept = finite | (notfinite > c.max_consecutive_nonfinite)
        state.mu = torch.where(accept, mu, state.mu)
        state.nu = torch.where(accept, nu, state.nu)
        state.count = torch.where(accept, count_inc, state.count)
        state.total_notfinite = torch.where(
            finite, state.total_notfinite, state.total_notfinite + 1)
        state.notfinite_count = notfinite
        state.last_finite = finite
        u = torch.where(accept, u, torch.zeros_like(u))
        sizes = [p.numel() for p in params]
        torch._foreach_add_(list(params), [
            s.view_as(p).to(p.dtype) for s, p in zip(u.split(sizes), params)])
        return g_norm


def make_optimizer(config: OptimConfig = OptimConfig()) -> Optimizer:
    return Optimizer(config)
