"""The port's inverse STFT and Griffin-Lim (a3t_tpu_torch/dsp/stft.py::istft,
dsp/griffin_lim.py) against ``a3t_tpu.dsp.stft.istft`` and
``a3t_tpu.dsp.griffin_lim`` on the same numpy-seeded inputs, on the CPU.

* istft: within 1e-5 absolute (fp32; the overlap-add sums each sample's
  frames in another order; read ~1e-7 on O(0.1-1) signals).
* mel_to_linear: within 1e-6 relative to the largest amplitude (the same
  numpy pseudo-inverse; only the product's summation order differs).
* griffin_lim from JAX's own initial phase (``PRNGKey(0)``, drawn here and
  passed to the port): one iteration within 1e-5 relative to the largest
  sample (read 3e-7), 32 iterations within 1e-4 (read 1.2e-6: the phase
  recursion carries rounding from iteration to iteration).
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu_torch.dsp import LogMelConfig, griffin_lim, istft, logmel_to_wav
from a3t_tpu_torch.dsp import mel_to_linear
from a3t_tpu_torch.dsp.griffin_lim import initial_phase

jstft = importlib.import_module("a3t_tpu.dsp.stft")
jgl = importlib.import_module("a3t_tpu.dsp.griffin_lim")

FE = dict(fs=8000, n_fft=256, hop_length=64, win_length=256, n_mels=20,
          fmin=20, fmax=4000)
TOL_ISTFT = 1e-5
TOL_GL_1 = 1e-5
TOL_GL_32 = 1e-4


def _spec(rng, b, f, n_fft):
    shape = (b, f, n_fft // 2 + 1)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("n_fft,hop,win,length", [
    (256, 64, 256, None),
    (2048, 300, 1200, None),   # the 24 kHz front-end: hop does not divide
    (400, 160, 400, 1234),     # a non-power-of-two n_fft, trimmed
    (512, 128, None, 900),
])
def test_istft_matches_jax(n_fft, hop, win, length):
    spec = _spec(np.random.default_rng(n_fft), 2, 11, n_fft)
    want = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, win, length))
    got = istft(torch.tensor(spec), n_fft, hop, win, length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL_ISTFT, rtol=0)


def test_istft_twice_bit_for_bit():
    spec = torch.tensor(_spec(np.random.default_rng(1), 1, 40, 2048))
    a = istft(spec, 2048, 300, 1200)
    assert torch.equal(a, istft(spec, 2048, 300, 1200))


def _logmel(rng, f=30):
    return (rng.standard_normal((1, f, FE["n_mels"])) * 0.5 - 1.0).astype(
        np.float32)


def test_mel_to_linear_matches_jax():
    logmel = _logmel(np.random.default_rng(0))
    want = np.asarray(jgl.mel_to_linear(jnp.asarray(logmel),
                                        JaxLogMelConfig(**FE)))
    got = mel_to_linear(torch.tensor(logmel), LogMelConfig(**FE)).numpy()
    assert got.shape == want.shape == (1, 30, FE["n_fft"] // 2 + 1)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert got.min() >= 1e-10


@pytest.mark.parametrize("n_iters,tol", [(1, TOL_GL_1), (32, TOL_GL_32)])
def test_griffin_lim_matches_jax_from_its_phase(n_iters, tol):
    mag = np.asarray(jgl.mel_to_linear(jnp.asarray(_logmel(
        np.random.default_rng(1))), JaxLogMelConfig(**FE)))
    want = np.asarray(jgl.griffin_lim(jnp.asarray(mag), JaxLogMelConfig(**FE),
                                      n_iters))
    # the phase JAX's griffin_lim draws from PRNGKey(0)
    phase = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), mag.shape,
                                          jnp.float32, -np.pi, np.pi))
    got = griffin_lim(torch.tensor(mag), LogMelConfig(**FE), n_iters,
                      phase=torch.tensor(phase)).numpy()
    assert got.shape == want.shape == (1, 29 * FE["hop_length"])
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_logmel_to_wav_seeded():
    """The seed draws the initial phase: one seed gives one wav, another
    seed another; the phase is uniform in [-pi, pi)."""
    m = torch.tensor(_logmel(np.random.default_rng(2)))
    cfg = LogMelConfig(**FE)
    a = logmel_to_wav(m, cfg, n_iters=4)
    assert torch.equal(a, logmel_to_wav(m, cfg, n_iters=4, seed=0))
    assert not torch.equal(a, logmel_to_wav(m, cfg, n_iters=4, seed=1))
    want = griffin_lim(mel_to_linear(m, cfg), cfg, 4,
                       phase=initial_phase((1, 30, 129), 0, "cpu"))
    assert torch.equal(a, want)
    ph = initial_phase((4, 1000), 3, "cpu")
    assert ph.min() >= -np.pi and ph.max() < np.pi and ph.std() > 1.5
