"""The port's log-mel front-ends against the JAX package: the plain version
of the fused log-mel kernel (a3t_tpu_torch/ops/fused_logmel.py, K6) against
JAX's Pallas ``fused_logmel`` in interpret mode, the matmul-DFT route
``LogMelFrontend.fused`` and the linear and log spectrograms against JAX's,
``featurize(use_pallas=True)`` against ``featurize()``, and the kernel
wrapper's checks.  Inputs from numpy with a seed; fp32 on the CPU.

Tolerances.  Log-mel features (|x| up to ~2) within atol 1e-5: the same
fp32 chain with the sums taken in another order (measured 7.2e-7 for K6's
plain version, 6.0e-7 for ``fused``).  Linear amplitudes (up to ~7) within
atol 2e-5 (measured 5.7e-6).  The log spectrogram takes ln of amplitudes
down to the 1e-5 floor, where an amplitude's rounding of ~1e-6 moves its log
by up to ~1e-3 (measured 3.3e-4): atol 2e-3.  ``featurize`` with K6's plain
version against the matmul-DFT route: 1e-5, masks and integer tensors equal.
The test on the card holds the kernel to its plain version within 1e-4, as
chip_smoke.py does.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp.frontend import (
    LinearSpectrogramFrontend as JaxLinearSpectrogramFrontend,
    LogSpectrogramFrontend as JaxLogSpectrogramFrontend)
from a3t_tpu.ops import fused_logmel as jax_fused_logmel
from a3t_tpu_torch.data import make_synthetic_batch
from a3t_tpu_torch.dsp import (LinearSpectrogramFrontend, LogMelConfig,
                               LogMelFrontend, LogSpectrogramFrontend)
from a3t_tpu_torch.ops import fused_logmel as fl
from a3t_tpu_torch.tasks.config import FRONTEND_16K, FRONTEND_24K
from a3t_tpu_torch.train import featurize

CONFIGS = {
    "24k": FRONTEND_24K,
    "16k": FRONTEND_16K,
    # tests/test_ops.py:32-44: 38 frames, not a multiple of the 64-frame tile
    "8k": LogMelConfig(fs=8000, n_fft=256, hop_length=80, win_length=240,
                       n_mels=20, fmin=20, fmax=4000),
}


def _audio(name: str):
    """2 utterances of 70 frames (38 at 8 kHz), the second 7 frames short."""
    c = CONFIGS[name]
    n = c.hop_length * (37 if name == "8k" else 69)
    audio = (np.random.default_rng(0).standard_normal((2, n)) * 0.1).astype(
        np.float32)
    return c, audio, np.array([n, n - 7 * c.hop_length], np.int32)


def _jax_config(c: LogMelConfig) -> JaxLogMelConfig:
    return JaxLogMelConfig(**dataclasses.asdict(c))


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_fused_logmel_matches_pallas_interpret(name, lengths):
    c, audio, lens = _audio(name)
    sl = lens if lengths else None
    want, want_l = jax_fused_logmel(
        jnp.asarray(audio), _jax_config(c),
        None if sl is None else jnp.asarray(sl), interpret=True)
    got, got_l = fl.fused_logmel(torch.tensor(audio), c,
                                 None if sl is None else torch.tensor(sl))
    assert got.dtype == torch.float32 and got_l.dtype == torch.int64
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if lengths:
        assert not got[1, int(got_l[1]):].any()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_frontend_matches_jax(name):
    c, audio, lens = _audio(name)
    want, want_l = JaxLogMelFrontend(_jax_config(c)).fused(
        jnp.asarray(audio), jnp.asarray(lens))
    fe = LogMelFrontend(c, device="cpu")
    got, got_l = fe.fused(audio, lens)
    assert fe.output_size() == c.n_mels
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("route", ["__call__", "fused"])
@pytest.mark.parametrize("kind", ["linear", "log"])
def test_spectrogram_frontends_match_jax(kind, route):
    c, audio, lens = _audio("24k")
    jcls, tcls, atol = {
        "linear": (JaxLinearSpectrogramFrontend, LinearSpectrogramFrontend,
                   2e-5),
        "log": (JaxLogSpectrogramFrontend, LogSpectrogramFrontend, 2e-3)}[kind]
    want, want_l = getattr(jcls(_jax_config(c)), route)(jnp.asarray(audio),
                                                        jnp.asarray(lens))
    fe = tcls(c, device="cpu")
    got, got_l = getattr(fe, route)(audio, lens)
    assert fe.output_size() == c.n_freqs == got.shape[-1]
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", ["24k", "16k"])
def test_featurize_use_pallas_equals_fused(name):
    """On the CPU ``use_pallas=True`` runs K6's plain version."""
    c = CONFIGS[name]
    batch = make_synthetic_batch(np.random.default_rng(1), batch_size=3,
                                 n_samples=c.hop_length * 70, n_text=8,
                                 hop_length=c.hop_length, vocab_size=40,
                                 fs=c.fs)
    fe = LogMelFrontend(c, device="cpu")
    fl.reset_launches()
    got = featurize(fe, batch, use_pallas=True)
    want = featurize(fe, batch)
    assert fl.LAUNCHES == 0
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["speech"].numpy(), want["speech"].numpy(),
                               atol=1e-5, rtol=0)
    for k in want:
        if k != "speech":
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k


def test_wrapper_rejects_what_the_kernel_does_not_take():
    c = CONFIGS["8k"]
    audio = torch.zeros(2, 800)
    with pytest.raises(TypeError, match="float32"):
        fl.fused_logmel(audio.double(), c)
    with pytest.raises(TypeError, match="float32"):
        fl.fused_logmel(audio.numpy(), c)
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        fl.fused_logmel(audio[0], c)
    with pytest.raises(ValueError, match="reflect"):
        fl.fused_logmel(torch.zeros(2, 100), c)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_logmel(torch.zeros(800, 2).t(), c)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fl.fused_logmel(torch.zeros(2, 800, device="meta"), c)
    with pytest.raises(ValueError, match="sample_lengths"):
        fl.fused_logmel(audio, c, torch.tensor([800]))
    with pytest.raises(ValueError, match="different devices"):
        fl.fused_logmel(audio, c, torch.tensor([800, 700], device="meta"))
    # what neither kernel route takes: n_fft past 4096, more than 128 mel
    # bins on the direct-DFT route (n_fft not a power of two), a window
    # longer than n_fft
    with pytest.raises(ValueError, match="4096"):
        fl.plan(dataclasses.replace(c, n_fft=8192))
    with pytest.raises(ValueError, match="128 mel"):
        fl.plan(dataclasses.replace(c, n_fft=400, win_length=400,
                                    n_mels=129))
    with pytest.raises(ValueError, match="win_length"):
        fl.plan(dataclasses.replace(c, win_length=300))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """K6 against its plain version on the card, within 1e-4, at the three
    configs, with and without lengths; tails exactly 0, flens equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in CONFIGS:
        c, audio, lens = _audio(name)
        a = torch.tensor(audio, device="cuda")
        for sl in (None, torch.tensor(lens, device="cuda")):
            fl.reset_launches()
            got, got_l = fl.fused_logmel(a, c, sl)
            want, want_l = fl.fused_logmel_plain(a, c, sl)
            assert fl.LAUNCHES == 1
            assert torch.equal(got_l, want_l)
            assert (got - want).abs().max().item() <= 1e-4
            if sl is not None:
                assert not got[1, int(got_l[1]):].any()
