"""Gradient accumulation and gradient noise in the port's optimizer
(a3t_tpu_torch/train/optim.py) against the JAX package's optax chain
(a3t_tpu/train/optim.py::make_optimizer: ``apply_if_finite(MultiSteps(
chain(add_noise, clip, adam, schedule), k))``).

* ``accum_grad`` 2 and 3 over six micro-steps, one of them with a NaN
  gradient: parameters within rtol 1e-6 plus two float32 ulps of the
  tensor's largest magnitude (an update that nearly cancels its parameter
  keeps the rounding of the larger operand), the moments and MultiSteps'
  running mean within 1e-6 of each one's largest magnitude (the mean of
  gradients of opposite sign cancels as well), the counters exactly; the
  parameters do not move at a micro-step that emits no update.
* Gradient noise: its bits cannot be JAX's, so the test hands the port
  the very tensors optax's ``add_noise`` draws (key 0, split once per
  applied update), by replacing :func:`gradient_noise`; the port must then
  put them at the same place in the chain (before the clip), with the same
  std and the same count, within rtol 1e-6.
* The port's own draw is a function of the count alone, and a run resumed
  from a mid-epoch checkpoint in the middle of an accumulation equals the
  uninterrupted run bit for bit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from a3t_tpu.train import optim as jo
from a3t_tpu_torch.train import optim as to
from a3t_tpu_torch.train.checkpoint import CheckpointManager
from a3t_tpu_torch.train.optim import gradient_noise
from a3t_tpu_torch.train.reporter import Reporter
from a3t_tpu_torch.train.train_step import TrainState

SHAPES = {"a": (4, 5), "b": (7,), "c": (2, 3, 3)}
BASE = dict(lr=1.0, model_size=16, warmup_steps=3, grad_clip=1.0)
# micro-step 3 carries a NaN: apply_if_finite leaves MultiSteps alone
KINDS = ("big", "small", "plain", "nan", "plain", "big")
RTOL, ULPS = 1e-6, 2 * 2.0 ** -23


def _grads(rng, kind):
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         SHAPES.items()}
    scale = {"big": 10.0, "small": 0.01}.get(kind, 1.0)
    g = {k: scale * a for k, a in g.items()}
    if kind == "nan":
        g["b"][3] = np.nan
    return g


def _optax_noise(n_updates):
    """The tensors optax's add_noise(key=0) draws at applied updates 0, 1,
    ..., flattened in the port's parameter order."""
    key = optax._src.utils.canonicalize_key(0)
    tree = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    out = []
    for _ in range(n_updates):
        key, sample = jax.random.split(key)
        noise = optax.tree.random_like(sample, target_tree=tree,
                                       sampler=jax.random.normal)
        out.append(np.concatenate([np.asarray(noise[k]).reshape(-1)
                                   for k in SHAPES]))
    return out


def _run(config, seed=0):
    """Both optimizers over KINDS; per micro-step (port params, optax
    params, port state, optax state)."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in
              SHAPES.items()}
    grads = [_grads(rng, kind) for kind in KINDS]
    tx = jo.make_optimizer(jo.OptimConfig(**config))
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    js = tx.init(jp)
    update = jax.jit(tx.update)
    port = to.make_optimizer(to.OptimConfig(**config))
    tp = [torch.tensor(params[k]) for k in SHAPES]
    ts = port.init(tp)
    out = []
    for g in grads:
        updates, js = update({k: jnp.asarray(a) for k, a in g.items()},
                             js, jp)
        jp = optax.apply_updates(jp, updates)
        g_norm = port.apply(tp, [torch.tensor(g[k]) for k in SHAPES], ts)
        want_norm = float(optax.global_norm(
            {k: jnp.asarray(a) for k, a in g.items()}))
        if np.isfinite(want_norm):
            assert float(g_norm) == pytest.approx(want_norm, rel=1e-6)
        snapshot = to.OptState(**{f: getattr(ts, f).clone() for f in
                                  to.OptState.__dataclass_fields__})
        out.append(([p.clone() for p in tp],
                    {k: np.asarray(v) for k, v in jp.items()}, snapshot, js))
    return out


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in SHAPES])


def _check(config):
    k = config.get("accum_grad", 1)
    steps = _run(config)
    prev = None
    for i, (tp, jp, ts, js) in enumerate(steps):
        for p, name in zip(tp, SHAPES):
            np.testing.assert_allclose(
                p.numpy(), jp[name], rtol=RTOL,
                atol=ULPS * float(np.abs(jp[name]).max()),
                err_msg=f"{name} @ {i}")
        multi = js.inner_state if k > 1 else None
        chain = multi.inner_opt_state if k > 1 else js.inner_state
        adam = [s for s in chain if hasattr(s, "mu")][0]
        pairs = [(ts.mu, adam.mu), (ts.nu, adam.nu)]
        if k > 1:
            pairs.append((ts.acc_grads, multi.acc_grads))
            assert int(ts.mini_step) == int(multi.mini_step)
            assert int(ts.gradient_step) == int(multi.gradient_step)
        for got, want in pairs:
            want = _flat(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=RTOL * max(float(np.abs(want).max()), 1e-30))
        assert int(ts.count) == int(adam.count)
        assert int(ts.notfinite_count) == int(js.notfinite_count)
        assert int(ts.total_notfinite) == int(js.total_notfinite)
        assert bool(ts.last_finite) == bool(js.last_finite)
        if prev is not None and int(ts.count) == prev[1]:
            # no update applied: the parameters stay bit for bit
            assert all(torch.equal(a, b) for a, b in zip(tp, prev[0]))
        prev = (tp, int(ts.count))
    # one NaN micro-step: 5 accepted, 5 // k updates applied
    assert int(steps[-1][2].count) == 5 // k


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_multisteps(k):
    _check(dict(BASE, accum_grad=k))


@pytest.mark.parametrize("k", [1, 2])
def test_noise_rule_matches_add_noise(k, monkeypatch):
    """optax's own add_noise (its std, count and place) with the port fed
    optax's draws; clip 1.0 holds the noise to account (noised gradients
    above the clip are scaled, noised ones below it are not)."""
    noise = _optax_noise(6)
    calls = []

    def optax_draw(count, n, device):
        calls.append(count)
        return torch.tensor(noise[count])

    monkeypatch.setattr(to, "gradient_noise", optax_draw)
    _check(dict(BASE, accum_grad=k, grad_noise_eta=0.3,
                grad_noise_gamma=0.55))
    # one draw per applied update, at counts 0, 1, ... (k = 1: the NaN
    # micro-step draws too, and its update is thrown away)
    assert sorted(set(calls)) == list(range(5 // k))


def test_noise_draw_is_a_function_of_the_count():
    a, b = gradient_noise(3, 1000, "cpu"), gradient_noise(3, 1000, "cpu")
    assert torch.equal(a, b) and not torch.equal(
        a, gradient_noise(4, 1000, "cpu"))
    assert abs(float(a.mean())) < 0.15 and abs(float(a.std()) - 1) < 0.1


def _train_state(config):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.BatchNorm1d(5))
    tx = to.make_optimizer(to.OptimConfig(**config))
    return TrainState(step=0, model=model, opt_state=tx.init(
        model.parameters()), tx=tx)


def _micro_step(state, i):
    x = torch.tensor(np.random.default_rng(100 + i).standard_normal(
        (8, 6)), dtype=torch.float32)
    state.model.train()
    loss = state.model(x).pow(2).mean() * (1.0 + i)
    grads = torch.autograd.grad(loss, state.params)
    state.apply_gradients(grads)


def test_resume_mid_accumulation_is_bit_exact(tmp_path):
    """A run saved after micro-step 4 of 6 (accum_grad 3: one update
    applied, one micro-step accumulated) and resumed from the file equals
    the uninterrupted run bit for bit, noise on."""
    config = dict(BASE, accum_grad=3, grad_noise_eta=0.01)
    full = _train_state(config)
    for i in range(6):
        _micro_step(full, i)
    first = _train_state(config)
    for i in range(4):
        _micro_step(first, i)
    assert int(first.opt_state.mini_step) == 1
    assert float(first.opt_state.acc_grads.abs().sum()) > 0
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    manager.save_mid_epoch(1, 4, first, Reporter())
    resumed = _train_state(config)
    resumed, epoch, it = manager.restore_mid_epoch(resumed, Reporter())
    assert (epoch, it, resumed.step) == (1, 4, 4)
    for i in range(4, 6):
        _micro_step(resumed, i)
    assert resumed.step == full.step == 6
    for name, value in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], value), name
    for field in to.OptState.__dataclass_fields__:
        assert torch.equal(getattr(resumed.opt_state, field),
                           getattr(full.opt_state, field)), field
    assert int(full.opt_state.count) == 2
