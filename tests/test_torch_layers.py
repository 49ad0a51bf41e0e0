"""Each port layer (a3t_tpu_torch/models/layers.py) against its flax
counterpart, weights carried across by a3t_tpu_torch/compat/from_jax.py.
fp32 on the CPU: the two frameworks sum in another order, so atol 1e-5 on
O(1) activations."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models import layers as jl
from a3t_tpu_torch.compat import from_jax
from a3t_tpu_torch.models import layers as tl

ATOL = 1e-5


def _init(module, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, variables)


def _perturb_stats(variables, rng):
    """Running statistics away from (0, 1), so BatchNorm really normalises."""
    stats = jax.tree_util.tree_map(
        lambda s: (s + rng.uniform(0.2, 0.8, s.shape)).astype(np.float32),
        variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def _sub(state):
    """A state made under the prefix "m", without it."""
    return {k.split(".", 1)[1]: a for k, a in state.items()}


def _run(module, *arrays):
    with torch.no_grad():
        return module(*[torch.from_numpy(np.asarray(a)) for a in arrays]).numpy()


def test_swish_and_sinusoidal_table(rng):
    x = rng.standard_normal((3, 7)).astype(np.float32)
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))), atol=ATOL)
    for reverse in (False, True):
        np.testing.assert_array_equal(tl.sinusoidal_table(50, 16, reverse),
                                      jl.sinusoidal_table(50, 16, reverse))


@pytest.mark.parametrize("kernel_size", [1, 3])
def test_multi_layered_conv1d(rng, kernel_size):
    x = rng.standard_normal((2, 11, 8)).astype(np.float32)
    jmod = jl.MultiLayeredConv1d(16, kernel_size, 0.0)
    v = _init(jmod, jnp.asarray(x), True)
    mod = tl.MultiLayeredConv1d(8, 16, kernel_size)
    from_jax.load_state(mod, _sub(from_jax.positionwise(v["params"], "m")))
    np.testing.assert_allclose(_run(mod, x),
                               np.asarray(jmod.apply(v, jnp.asarray(x), True)),
                               atol=ATOL)


def test_positionwise_feed_forward(rng):
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    jmod = jl.PositionwiseFeedForward(16, 0.0)
    v = _init(jmod, jnp.asarray(x), True)
    mod = tl.PositionwiseFeedForward(8, 16)
    from_jax.load_state(mod, _sub(from_jax.positionwise(v["params"], "m")))
    np.testing.assert_allclose(_run(mod, x),
                               np.asarray(jmod.apply(v, jnp.asarray(x), True)),
                               atol=ATOL)


@pytest.mark.parametrize("kernel_size", [7, 31])
def test_convolution_module(rng, kernel_size):
    """GLU -> depthwise -> BatchNorm from running stats -> swish."""
    x = rng.standard_normal((2, 40, 8)).astype(np.float32)
    jmod = jl.ConvolutionModule(kernel_size)
    v = _perturb_stats(_init(jmod, jnp.asarray(x), False), rng)
    mod = tl.ConvolutionModule(8, kernel_size)
    from_jax.load_state(mod, _sub(from_jax.conv_module(
        v["params"], v["batch_stats"], "m")))
    mod.eval()  # BatchNorm reads its running statistics
    np.testing.assert_allclose(_run(mod, x),
                               np.asarray(jmod.apply(v, jnp.asarray(x), False)),
                               atol=ATOL)


def test_postnet(rng):
    x = rng.standard_normal((2, 20, 6)).astype(np.float32)
    jmod = jl.Postnet(6, n_layers=3, n_chans=12, n_filts=5)
    v = _perturb_stats(_init(jmod, jnp.asarray(x), False), rng)
    state = {}
    for i in range(3):
        state.update(from_jax.conv(v["params"][f"Conv_{i}"], f"postnet.{i}.0"))
        state.update(from_jax.batch_norm(
            v["params"][f"BatchNorm_{i}"], v["batch_stats"][f"BatchNorm_{i}"],
            f"postnet.{i}.1"))
    mod = tl.Postnet(6, n_layers=3, n_chans=12, n_filts=5).eval()
    from_jax.load_state(mod, state)
    np.testing.assert_allclose(_run(mod, x),
                               np.asarray(jmod.apply(v, jnp.asarray(x), False)),
                               atol=ATOL)


def test_masked_input(rng):
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    m = rng.random((2, 10)) < 0.4
    jmod = jl.MaskedInput(6)
    v = _init(jmod, jnp.asarray(x), jnp.asarray(m))
    mod = tl.MaskedInput(6)
    from_jax.load_state(mod, {"mask_feature":
                              v["params"]["mask_feature"]})
    np.testing.assert_array_equal(
        _run(mod, x, m), np.asarray(jmod.apply(v, jnp.asarray(x),
                                               jnp.asarray(m))))
