"""Optimizer: [gradient noise ->] global-norm clip -> Adam -> Noam warmup,
[accumulated over k micro-steps,] skipped on non-finite gradients
(``a3t_tpu/train/optim.py``).

The JAX package builds an optax chain,

    apply_if_finite([MultiSteps(] chain([add_noise], clip_by_global_norm,
                                        [add_decayed_weights], scale_by_adam,
                                        scale_by_schedule(-lr)) [, k)])

and this module computes the same update in PyTorch:

* gradient noise (``grad_noise_eta > 0``) comes first, as ``add_noise``:
  ``std * N(0, 1)`` with ``std = sqrt(eta / (count + 1) ** gamma)``, count
  being the number of updates applied so far (``add_noise``'s own count
  moves with Adam's); the draw is :func:`gradient_noise`, a
  ``torch.Generator`` seeded from ``(0, count)``, so a resumed run draws
  the same noise without stored generator state.  Its bits are not JAX's.
  The count is read on the host, one synchronisation per step when noise
  is on;
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
  row the update is applied all the same;
* gradient accumulation (``accum_grad = k > 1``) is ``optax.MultiSteps``
  inside ``apply_if_finite``: the running mean ``acc + (g - acc) / (m + 1)``
  of the micro-steps' gradients, the inner chain applied to it at every
  k-th accepted micro-step (moving Adam's and the schedule's count once)
  and a zero update at the others; a skipped micro-step leaves the
  accumulation as it was.

Everything is computed on the parameters' device, with no device-to-host
synchronisation: the decision to skip is a ``torch.where``.  :class:`ClipAdam`
is the offline trainers' chain: the same clip and Adam at a constant rate,
with no skipping.  The moments
are kept as one flat float32 vector each, in the order of the parameter
list given to :meth:`Optimizer.init`.

Over the W ranks of the data axis (``parallel/``) the chain is ZeRO-1, as
JAX's ``shard_opt_state`` shards it: rank r keeps only its slice
(``parallel.sharding.flat_slice``, ``ceil(n / W)`` elements) of ``mu``,
``nu`` and ``acc_grads``.  A step sums the flat gradients over the data
group and keeps the owned slice, reduces the squared norm and the count of
non-finite elements (so the skip, the clip and the reported norm are
global and equal on every rank), adds its slice of the full noise draw and
of the weight decay, applies Adam and the schedule to the slice, and
gathers the slices of the update onto every rank's parameters.

Over the tp ranks of the model axis each rank's flat vector holds its own
parameters, the slices of the split ones (``parallel.sharding.
FlatLayout``), so its moments are laid out like that slice, as JAX's
``moment_partition_spec`` keeps the parameter's layout.  The squared norm
and the non-finite count sum the split parameters' terms over the model
group and count each replicated parameter once; the noise is the full
vector's draw, of which each rank keeps its elements, so every element
gets the noise of one process.  The sp ranks of the seq axis hold whole
parameters and the same moment slices as their data rank's; the flat
gradient is summed over the seq group first (their frame blocks' shares),
after which each seq rank takes the same step.  With no axis above 1 no
collective runs and every slice is the whole vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from a3t_tpu_torch.parallel.mesh import all_reduce_sum, world
from a3t_tpu_torch.parallel.sharding import (FlatLayout, all_gather_flat,
                                             flat_slice, reduce_scatter_flat,
                                             shard_flat)


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
    parameters' order (this rank's slice of them over W ranks); ``count``
    is the inner chain's step count (Adam's, the schedule's and the
    noise's, which move together);
    ``notfinite_count``, ``last_finite`` and ``total_notfinite`` are
    apply_if_finite's; ``mini_step``, ``gradient_step`` and the flat
    ``acc_grads`` are MultiSteps' (``acc_grads`` is empty without
    accumulation).  Every field is a tensor on the parameters' device."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor
    mini_step: torch.Tensor
    gradient_step: torch.Tensor
    acc_grads: torch.Tensor


# the state's flat vectors that each rank of the data axis holds a slice of
SHARDED_FIELDS = ("mu", "nu", "acc_grads")


def gradient_noise(count: int, n: int, device) -> torch.Tensor:
    """The (n,) float32 N(0, 1) draw added (scaled) to the gradients at the
    update that follows ``count`` applied ones: a ``torch.Generator`` on
    ``device`` seeded from ``SeedSequence([0, count])`` (optax's key 0)."""
    s = np.random.SeedSequence([0, int(count)]).generate_state(2)
    gen = torch.Generator(device=device).manual_seed(
        int(s[0]) << 32 | int(s[1]))
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


class Optimizer:
    """``make_optimizer``'s chain: ``init(params)`` and
    ``apply(params, grads, state)``, the latter updating the parameters and
    the state in place."""

    def __init__(self, config: OptimConfig = OptimConfig()):
        if config.accum_grad < 1:
            raise ValueError(f"accum_grad {config.accum_grad} < 1")
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
        """The state for ``params`` (a model-axis rank's: its slice)."""
        params = list(params)
        dev = params[0].device
        owned = flat_slice(sum(p.numel() for p in params))
        n = owned.stop - owned.start

        def scalar(value, dtype=torch.int32):
            return torch.tensor(value, dtype=dtype, device=dev)

        k = self.config.accum_grad
        return OptState(
            mu=torch.zeros(n, dtype=torch.float32, device=dev),
            nu=torch.zeros(n, dtype=torch.float32, device=dev),
            count=scalar(0), notfinite_count=scalar(0),
            last_finite=scalar(True, torch.bool), total_notfinite=scalar(0),
            mini_step=scalar(0), gradient_step=scalar(0),
            acc_grads=torch.zeros(n if k > 1 else 0, dtype=torch.float32,
                                  device=dev))

    def _inner(self, u: torch.Tensor, params, state: OptState, n: int,
               layout, split):
        """The inner chain on (this rank's slice of) the flat gradient
        ``u`` of ``n`` elements: (update, mu, nu, count + 1)."""
        c = self.config
        if c.grad_noise_eta > 0:
            k = c.accum_grad
            # the noise of a micro-step that emits no update is thrown away
            # (MultiSteps), so only an emitting one draws it
            if k == 1 or int(state.mini_step) == k - 1:
                count = int(state.count)
                std = torch.sqrt(c.grad_noise_eta / torch.tensor(
                    count + 1, dtype=torch.float32) ** c.grad_noise_gamma)
                noise = gradient_noise(count, n if layout is None
                                       else layout.n_full, u.device)
                if layout is not None:
                    noise = layout.local_of(noise)
                u = u + std.to(u.device) * shard_flat(noise)
        u, _ = clip_by_global_norm(u, c.grad_clip, _global_norm(u, split)[0])
        if c.weight_decay > 0:
            u = u + c.weight_decay * shard_flat(_flat(params))
        u, mu, nu, count_inc = scale_by_adam(
            u, state.mu, state.nu, state.count, c.adam_b1, c.adam_b2,
            c.adam_eps)
        return -self.schedule(state.count) * u, mu, nu, count_inc

    @torch.no_grad()
    def apply(self, params, grads, state: OptState,
              layout: FlatLayout = None) -> torch.Tensor:
        """One (micro-)step of ``params`` (a list of tensors) by ``grads``
        (the same order; over W ranks each rank's share, summed here), in
        place; returns the gradients' global norm.  ``layout`` places the
        parameters in the full flat vector when they are a model-axis
        rank's slice (``FlatLayout.of(model)``); None when they are whole."""
        c = self.config
        k = c.accum_grad
        params = list(params)
        n = sum(p.numel() for p in params)
        layout = layout if layout is not None and layout.tp > 1 else None
        if layout is not None and layout.n_local != n:
            raise ValueError("the layout does not describe the parameters")
        # this rank's slice of the split elements' mask (ZeRO-1 slices it
        # like the moments)
        split = (None if layout is None else
                 shard_flat(layout.split_mask(params[0].device)))
        g = reduce_scatter_flat(_flat(grads))
        g_norm, bad = _global_norm(g, split)
        finite = bad == 0 if g_norm is not None else torch.isfinite(g).all()
        notfinite = torch.where(finite, torch.zeros_like(state.count),
                                state.notfinite_count + 1)
        accept = finite | (notfinite > c.max_consecutive_nonfinite)
        if k > 1:
            acc = state.acc_grads + (g - state.acc_grads) / (
                state.mini_step + 1)
            emit = state.mini_step == k - 1
            u, mu, nu, count_inc = self._inner(acc, params, state, n,
                                               layout, split)
            # MultiSteps multiplies by emit (0 * NaN stays NaN) and
            # apply_if_finite selects
            u = torch.where(accept, emit * u, torch.zeros_like(u))
            keep = accept & emit
            state.acc_grads = torch.where(accept, (~emit) * acc,
                                          state.acc_grads)
            state.gradient_step = torch.where(
                keep, state.gradient_step + 1, state.gradient_step)
            state.mini_step = torch.where(
                accept, (state.mini_step + 1) % k, state.mini_step)
        else:
            u, mu, nu, count_inc = self._inner(g, params, state, n,
                                               layout, split)
            u = torch.where(accept, u, torch.zeros_like(u))
            keep = accept
        state.mu = torch.where(keep, mu, state.mu)
        state.nu = torch.where(keep, nu, state.nu)
        state.count = torch.where(keep, count_inc, state.count)
        state.total_notfinite = torch.where(
            finite, state.total_notfinite, state.total_notfinite + 1)
        state.notfinite_count = notfinite
        state.last_finite = finite
        _add_(params, all_gather_flat(u, n))
        return torch.linalg.vector_norm(g) if g_norm is None else g_norm


def _global_norm(x: torch.Tensor, split):
    """(norm, count of non-finite elements) of the full flat vector of one
    process, whose slice over the axes this rank holds in ``x``; ``split``
    marks the elements of ``x`` that the model axis splits (None: none).
    (None, None) in a process alone, where the caller reads ``x`` itself."""
    if world() == 1:
        return None, None
    sq, bad = x * x, (~torch.isfinite(x)).float()
    if split is None:
        s = all_reduce_sum(torch.stack([sq.sum(), bad.sum()]))
        return torch.sqrt(s[0]), s[1]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = all_reduce_sum(torch.stack([
        torch.where(split, sq, zero).sum(),
        torch.where(split, bad, zero).sum(),
        torch.where(split, zero, sq).sum(),
        torch.where(split, zero, bad).sum()]))
    # the split elements' sums over the model group; the replicated ones
    # are the same on every rank of it and count once
    s_split = all_reduce_sum(s[:2], "model")
    return torch.sqrt(s_split[0] + s[2]), s_split[1] + s[3]


def _flat(tensors) -> torch.Tensor:
    return torch.cat([x.reshape(-1).float() for x in tensors])


def _add_(params, u: torch.Tensor) -> None:
    """params += the flat update ``u``, split back into their shapes."""
    params = list(params)
    sizes = [p.numel() for p in params]
    torch._foreach_add_(params, [
        s.view_as(p).to(p.dtype) for s, p in zip(u.split(sizes), params)])


def clip_by_global_norm(g: torch.Tensor, max_norm: float,
                        g_norm: torch.Tensor = None):
    """optax's ``clip_by_global_norm`` on the flat gradient ``g``:
    ``where(norm < max, g, g / norm * max)``, no epsilon; (clipped,
    norm).  ``g_norm`` is the norm when ``g`` is a slice of the vector
    (None: ``g``'s own)."""
    if g_norm is None:
        g_norm = torch.linalg.vector_norm(g)
    return torch.where(g_norm < max_norm, g, g / g_norm * max_norm), g_norm


def scale_by_adam(u, mu, nu, count, b1: float, b2: float, eps: float):
    """optax's ``scale_by_adam`` (eps outside the square root, no
    ``eps_root``): (update, mu, nu, count + 1)."""
    mu = (1 - b1) * u + b1 * mu
    nu = (1 - b2) * (u * u) + b2 * nu
    count_inc = count + 1
    t = count_inc.to(torch.float32)
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    return mu_hat / (torch.sqrt(nu_hat) + eps), mu, nu, count_inc


@dataclasses.dataclass
class AdamState:
    """Adam's moments (flat float32, in the parameters' order) and its
    step count, on the parameters' device."""

    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor


class ClipAdam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr))`` at a constant
    ``lr``, the offline trainers' optimizer (``a3t_tpu/train/vocoder.py:
    239-242``, ``a3t_tpu/models/xvector.py:176``): no schedule and no
    skipping of non-finite steps."""

    def __init__(self, lr: float, clip: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps

    def init(self, params) -> AdamState:
        params = list(params)
        n = sum(p.numel() for p in params)
        dev = params[0].device
        return AdamState(mu=torch.zeros(n, device=dev),
                         nu=torch.zeros(n, device=dev),
                         count=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def apply(self, params, grads, state: AdamState) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the gradients'
        global norm."""
        u, g_norm = clip_by_global_norm(_flat(grads), self.clip)
        u, state.mu, state.nu, state.count = scale_by_adam(
            u, state.mu, state.nu, state.count, self.b1, self.b2, self.eps)
        _add_(params, -self.lr * u)
        return g_norm


def make_optimizer(config: OptimConfig = OptimConfig()) -> Optimizer:
    return Optimizer(config)
