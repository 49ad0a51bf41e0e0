"""Train mode of the port's layers against flax ``train=True``: BatchNorm
normalises with batch statistics over (B, T), padding included, and moves
its running statistics by flax's rule (momentum 0.9, biased variance); the
outputs, the updated ``batch_stats`` and the input gradients must agree.
Dropout is off here (rate 0), since its bits cannot match; its rule is held
in tests/test_torch_dropout.py.  fp32 on the CPU: atol 1e-5 on O(1) values
(summation order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models import layers as jl
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.models import conformer as tc
from a3t_tpu_torch.models import layers as tl

ATOL = 1e-5


def _variables(jmod, x, rng):
    v = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.2, 0.8, s.shape)).astype(np.float32),
        v["batch_stats"])
    return v


def _flax_train(jmod, v, x, w):
    """(output, updated batch_stats, d sum(out * w) / dx) at train=True."""
    def f(xx):
        out, upd = jmod.apply(v, xx, True, mutable=["batch_stats"])
        return (out * w).sum(), (out, upd["batch_stats"])

    (_, (out, stats)), gx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    return (np.asarray(out), jax.tree_util.tree_map(np.asarray, stats),
            np.asarray(gx))


def _port_train(mod, x, w):
    xt = torch.tensor(x, requires_grad=True)
    out = mod.train()(xt)
    (gx,) = torch.autograd.grad((out * torch.tensor(w)).sum(), xt)
    return out.detach().numpy(), gx.numpy()


@pytest.mark.parametrize("kernel_size", [7, 31])
def test_convolution_module_train_matches_flax(rng, kernel_size):
    x = rng.standard_normal((3, 40, 8)).astype(np.float32)
    x[2, 30:] = 0.0  # padded frames take part in the statistics
    w = rng.standard_normal((3, 40, 8)).astype(np.float32)
    jmod = jl.ConvolutionModule(kernel_size)
    v = _variables(jmod, x, rng)
    mod = tl.ConvolutionModule(8, kernel_size)
    from_jax.load_state(mod, {k.split(".", 1)[1]: a for k, a in
                              from_jax.conv_module(v["params"],
                                                   v["batch_stats"],
                                                   "m").items()})
    out_j, stats, gx_j = _flax_train(jmod, v, x, w)
    out_t, gx_t = _port_train(mod, x, w)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    np.testing.assert_allclose(gx_t, gx_j, atol=ATOL)
    np.testing.assert_allclose(mod.norm.running_mean.numpy(),
                               stats["BatchNorm_0"]["mean"], atol=1e-6)
    np.testing.assert_allclose(mod.norm.running_var.numpy(),
                               stats["BatchNorm_0"]["var"], atol=1e-6)


def test_postnet_train_matches_flax(rng):
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    w = rng.standard_normal((2, 20, 6)).astype(np.float32)
    jmod = jl.Postnet(6, n_layers=3, n_chans=12, n_filts=5, dropout_rate=0.0)
    v = _variables(jmod, x, rng)
    state = {}
    for i in range(3):
        state.update(from_jax.conv(v["params"][f"Conv_{i}"], f"postnet.{i}.0"))
        state.update(from_jax.batch_norm(
            v["params"][f"BatchNorm_{i}"], v["batch_stats"][f"BatchNorm_{i}"],
            f"postnet.{i}.1"))
    mod = tl.Postnet(6, n_layers=3, n_chans=12, n_filts=5, dropout_rate=0.0)
    from_jax.load_state(mod, state)
    out_j, stats, gx_j = _flax_train(jmod, v, x, w)
    out_t, gx_t = _port_train(mod, x, w)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    np.testing.assert_allclose(gx_t, gx_j, atol=ATOL)
    for i in range(3):
        bn = mod.postnet[i][1]
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   stats[f"BatchNorm_{i}"]["mean"], atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   stats[f"BatchNorm_{i}"]["var"], atol=1e-6)


def test_eval_mode_leaves_running_statistics_alone(rng):
    mod = tl.ConvolutionModule(8, 7).eval()
    before = mod.norm.running_var.clone()
    with torch.no_grad():
        mod(torch.tensor(rng.standard_normal((2, 12, 8)).astype(np.float32)))
    assert torch.equal(mod.norm.running_var, before)


def test_rel_pos_encoding_drops_x_and_pos_separately():
    """Two draws per call (RelPosEncoding, conformer.py:132): x and pos_emb
    get masks of their own; eval mode drops nothing."""
    enc = tc.RelPosEncoding(16, dropout_rate=0.5)
    x = torch.ones(1, 24, 16)
    xe, pe = enc.eval()(x)
    assert torch.equal(xe, x * 4.0) and bool((pe != 0).all())
    xt, pt = enc.train()(x, torch.Generator().manual_seed(0))
    assert bool((xt == 0).any()) and bool((pt == 0).any())
    assert not torch.equal(xt == 0, pt == 0)
