"""The port's optimizer (a3t_tpu_torch/train/optim.py) against the JAX
package's optax chain (a3t_tpu/train/optim.py::make_optimizer): the same
parameters and gradients go through both, step by step, including a step
whose gradient norm is above grad_clip and a step with a NaN gradient that
apply_if_finite skips.  fp32 on the CPU, the same operations in the same
order: parameters within rtol 1e-5 / atol 1e-8, the moments within
rtol 1e-5 / atol 1e-12, the counters exactly."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from a3t_tpu.train import optim as jo
from a3t_tpu_torch.tasks.config import OPTIM_24K
from a3t_tpu_torch.train import optim as to

SHAPES = {"a": (4, 5), "b": (7,), "c": (2, 3, 3)}
CONFIGS = {
    "yaml": dict(lr=1.0, model_size=384, warmup_steps=4000, grad_clip=1.0),
    "short_warmup_decay": dict(lr=1.0, model_size=16, warmup_steps=2,
                               grad_clip=1.0, weight_decay=0.01),
    "warmuplr": dict(scheduler="warmuplr", lr=0.002, warmup_steps=3,
                     grad_clip=5.0),
    "constant": dict(scheduler="constant", lr=0.01, grad_clip=1.0,
                     adam_b1=0.8, adam_b2=0.99, adam_eps=1e-6),
}


def _grads(rng, kind):
    """norm above clip ("big"), NaN in one leaf ("nan"), or small."""
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         SHAPES.items()}
    if kind == "big":
        g = {k: 10.0 * a for k, a in g.items()}
    elif kind == "small":
        g = {k: 0.01 * a for k, a in g.items()}
    elif kind == "nan":
        g["b"][3] = np.nan
    return g


def _run(config: dict, kinds, rng):
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in
              SHAPES.items()}
    grads = [_grads(rng, kind) for kind in kinds]
    tx = jo.make_optimizer(jo.OptimConfig(**config))
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    js = tx.init(jp)
    port = to.make_optimizer(to.OptimConfig(**config))
    tp = [torch.tensor(params[k]) for k in SHAPES]
    ts = port.init(tp)
    for g in grads:
        updates, js = tx.update({k: jnp.asarray(a) for k, a in g.items()},
                                js, jp)
        jp = optax.apply_updates(jp, updates)
        g_norm = port.apply(tp, [torch.tensor(g[k]) for k in SHAPES], ts)
        want_norm = float(optax.global_norm(
            {k: jnp.asarray(a) for k, a in g.items()}))
        if np.isfinite(want_norm):
            assert g_norm.item() == pytest.approx(want_norm, rel=1e-6)
        for k, t in zip(SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-8)
        adam = js.inner_state[-2]
        for field in ("mu", "nu"):
            flat = np.concatenate([np.asarray(getattr(adam, field)[k]).ravel()
                                   for k in SHAPES])
            np.testing.assert_allclose(getattr(ts, field).numpy(), flat,
                                       rtol=1e-5, atol=1e-12)
        assert ts.count.item() == int(adam.count) == int(
            js.inner_state[-1].count)
        assert ts.notfinite_count.item() == int(js.notfinite_count)
        assert ts.total_notfinite.item() == int(js.total_notfinite)
        assert ts.last_finite.item() == bool(js.last_finite)
    return ts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_match_optax(rng, name):
    """Clipped, skipped (NaN) and plain steps: the skipped step moves
    neither the parameters nor the count nor the moments."""
    ts = _run(CONFIGS[name], ["big", "nan", "small", "plain"], rng)
    assert ts.count.item() == 3 and ts.total_notfinite.item() == 1


def test_update_applied_after_too_many_nonfinite_steps(rng):
    """apply_if_finite gives up after max_consecutive_nonfinite skips in a
    row and applies the (NaN) update, as optax does."""
    config = dict(CONFIGS["short_warmup_decay"], max_consecutive_nonfinite=1)
    with np.errstate(invalid="ignore"):
        ts = _run(config, ["plain", "nan", "nan"], rng)
    assert ts.count.item() == 2 and ts.notfinite_count.item() == 2


@pytest.mark.parametrize("sched", ["noam", "warmuplr"])
def test_schedules_match_jax(sched):
    """Noam and WarmupLR at steps 0, 1 and 4000 (count + 1 inside):
    rtol 1e-6, both computed in fp32."""
    if sched == "noam":
        ours, ref = (m.noam_schedule(384, 4000, 1.0) for m in (to, jo))
    else:
        ours, ref = (m.warmup_lr_schedule(25000, 0.002) for m in (to, jo))
    for step in (0, 1, 4000):
        assert ours(step).item() == pytest.approx(float(ref(step)), rel=1e-6)
        assert ours(torch.tensor(step, dtype=torch.int32)).item() == \
            pytest.approx(float(ref(step)), rel=1e-6)


def test_yaml_optim_and_unported_options():
    assert dataclasses.asdict(OPTIM_24K) == dataclasses.asdict(
        jo.OptimConfig(lr=1.0, model_size=384, warmup_steps=4000,
                       grad_clip=1.0))
    # gradient noise and accumulation are ported
    # (tests/test_torch_optim_accum.py holds them against optax)
    st = to.make_optimizer(to.OptimConfig(grad_noise_eta=0.1, accum_grad=2)
                           ).init([torch.zeros(3), torch.zeros(2)])
    assert st.acc_grads.shape == (5,) and int(st.mini_step) == 0
    with pytest.raises(ValueError, match="accum_grad"):
        to.make_optimizer(to.OptimConfig(accum_grad=0))


def test_jax_optimizer_state_layout():
    """The layout the port's from_jax reads: apply_if_finite(chain(clip,
    adam, schedule)) without weight decay, with adam before the schedule
    when weight decay is on."""
    for wd in (0.0, 0.01):
        tx = jo.make_optimizer(jo.OptimConfig(weight_decay=wd))
        st = tx.init({"a": jnp.zeros(3)})
        assert hasattr(st.inner_state[-2], "mu")
        assert not hasattr(st.inner_state[-1], "mu")
        assert hasattr(st, "notfinite_count")
