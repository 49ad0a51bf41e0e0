"""The port's ParallelWaveGAN generator (a3t_tpu_torch/models/pwg.py)
against ``a3t_tpu.models.pwg.ParallelWaveGANGenerator`` with the same
weights and the same noise ``z``.  fp32 on the CPU, atol 1e-5 on waveforms
of O(1): the two frameworks sum the convolutions in another order."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.models.pwg import (ParallelWaveGANGenerator, PWGConfig,
                                convert_pwg_state)
from a3t_tpu_torch.compat.from_jax import load_state, pwg_state
from a3t_tpu_torch.models import pwg as tp

SMALL = dict(layers=6, stacks=2, residual_channels=8, gate_channels=16,
             skip_channels=8, aux_channels=10, upsample_scales=(2, 3))


def _jax_generator(rng, c, z):
    gen = ParallelWaveGANGenerator(PWGConfig(**SMALL))
    v = jax.tree_util.tree_map(np.asarray, gen.init(
        jax.random.PRNGKey(0), jnp.asarray(c), jnp.asarray(z)))
    # smoothing filters away from their constant init
    for i in range(len(SMALL["upsample_scales"])):
        k = v["params"]["upsample_net"][f"up_conv_{i}"]["kernel"]
        v["params"]["upsample_net"][f"up_conv_{i}"]["kernel"] = \
            rng.standard_normal(k.shape).astype(np.float32) * 0.3
    return gen, v


@pytest.mark.parametrize("t_feats", [5, 12])
def test_generator_matches_jax(rng, t_feats):
    c = rng.standard_normal((2, t_feats, 10)).astype(np.float32)
    z = rng.standard_normal((2, t_feats * 6, 1)).astype(np.float32)
    gen, v = _jax_generator(rng, c, z)
    ref = np.asarray(gen.apply(v, jnp.asarray(c), jnp.asarray(z)))
    port = tp.build_vocoder(tp.PWGConfig(**SMALL), device="cpu")
    load_state(port, pwg_state(v))
    with torch.no_grad():
        got = port(torch.tensor(c), torch.tensor(z)).numpy()
    assert got.shape == ref.shape == (2, t_feats * 6)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_port_state_dict_runs_in_jax(rng):
    """port state_dict -> a3t_tpu convert_pwg_state -> the same waveform."""
    c = rng.standard_normal((1, 7, 10)).astype(np.float32)
    z = rng.standard_normal((1, 42)).astype(np.float32)
    port = tp.build_vocoder(tp.PWGConfig(**SMALL), device="cpu", seed=4)
    with torch.no_grad():
        got = port(torch.tensor(c), torch.tensor(z)).numpy()
    variables = convert_pwg_state(port.state_dict(), PWGConfig(**SMALL))
    ref = ParallelWaveGANGenerator(PWGConfig(**SMALL)).apply(
        variables, jnp.asarray(c), jnp.asarray(z[..., None]))
    np.testing.assert_allclose(np.asarray(ref), got, atol=1e-5)


def test_noise_from_generator_is_reproducible(rng):
    c = torch.tensor(rng.standard_normal((1, 4, 10)).astype(np.float32))
    port = tp.build_vocoder(tp.PWGConfig(**SMALL), device="cpu")
    with torch.no_grad():
        a = port(c, generator=torch.Generator().manual_seed(5))
        b = port(c, generator=torch.Generator().manual_seed(5))
    assert a.shape == (1, 24) and torch.equal(a, b)


def test_default_config_is_the_24k_recipe():
    cfg = tp.PWGConfig()
    assert cfg.upsample_factor == 300 and cfg.layers == 30
    assert dict(vars(cfg)) == {k: getattr(PWGConfig(), k) for k in vars(cfg)}
