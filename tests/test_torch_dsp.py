"""The port's log-mel front-end (a3t_tpu_torch/dsp) against
``a3t_tpu.dsp.LogMelFrontend`` at the 24 kHz and 16 kHz recipes.  fp32 on
the CPU; both use a pocketfft rfft, and log10 features agree within atol
1e-4."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxConfig
from a3t_tpu.dsp import LogMelFrontend as JaxFrontend
from a3t_tpu.dsp import mel as jmel
from a3t_tpu.dsp.stft import padded_window as jax_padded_window
from a3t_tpu.dsp.stft import stft as jax_stft
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend, mel
from a3t_tpu_torch.dsp.stft import padded_window, stft

RECIPES = {
    "24k": dict(),
    "16k": dict(fs=16000, n_fft=1024, hop_length=200, win_length=800),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_frontend_matches_jax(rng, recipe):
    kw = RECIPES[recipe]
    hop = JaxConfig(**kw).hop_length
    audio = (rng.standard_normal((2, hop * 40)) * 0.1).astype(np.float32)
    lengths = np.array([hop * 40, hop * 25 + 17], np.int32)
    ref, ref_len = JaxFrontend(JaxConfig(**kw))(jnp.asarray(audio),
                                                jnp.asarray(lengths))
    got, got_len = LogMelFrontend(LogMelConfig(**kw), device="cpu")(
        torch.tensor(audio), lengths)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_frontend_without_lengths(rng):
    audio = (rng.standard_normal((1, 300 * 12 + 5)) * 0.1).astype(np.float32)
    ref, ref_len = JaxFrontend(JaxConfig())(jnp.asarray(audio))
    got, got_len = LogMelFrontend(LogMelConfig(), device="cpu")(
        torch.tensor(audio))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_mel_filterbank_and_windows_are_copies():
    for args in ((24000, 2048, 80, 80.0, 7600.0), (16000, 1024, 80, 80.0, 7600.0)):
        np.testing.assert_array_equal(mel.mel_filterbank(*args),
                                      jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(mel.hz_to_mel([100.0, 3000.0]),
                                  jmel.hz_to_mel([100.0, 3000.0]))
    np.testing.assert_array_equal(padded_window(2048, 1200),
                                  jax_padded_window(2048, 1200))


def test_stft_matches_jax(rng):
    """Complex spectra within atol 1e-4 (sums of 256 terms of O(0.1))."""
    x = (rng.standard_normal((2, 1000)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_stft(jnp.asarray(x), 256, 64, 200))
    got = stft(torch.tensor(x), 256, 64, 200).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)
