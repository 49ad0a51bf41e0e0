"""The port's MCD analysis (a3t_tpu_torch/eval/mcd.py, a numpy copy) against
``a3t_tpu.eval.mcd`` function by function, on the same numpy-seeded
signals: every public function gives the same value bit for bit (the same
numpy and scipy calls in the same order).  Signals are 0.3-0.5 s at 8 kHz
with a 10 ms hop, so the per-frame Python loops stay short."""

import numpy as np
import pytest

from a3t_tpu.eval import mcd as jmcd
from a3t_tpu_torch.eval import mcd as tmcd

FS = 8000
CFG = dict(mcep_dim=24, fftl=512, shiftms=10.0, f0min=70.0, f0max=700.0)


def _wav(seed, secs=0.4, f0=140.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * FS)) / FS
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 2.7 * f0 * t) + 0.02 * rng.standard_normal(t.size)
    ).astype(np.float32)


def _cfgs():
    return tmcd.MCDConfig(**CFG), jmcd.MCDConfig(**CFG)


def _equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        np.testing.assert_array_equal(got, want)


def test_config_defaults_equal():
    import dataclasses

    assert dataclasses.asdict(tmcd.MCDConfig()) == \
        dataclasses.asdict(jmcd.MCDConfig())


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 24000, 32000, 11025])
def test_mcep_alpha(fs):
    assert tmcd.mcep_alpha(fs) == jmcd.mcep_alpha(fs)


@pytest.mark.parametrize("cutoff", [70.0, 0.0])
def test_low_cut_filter(cutoff):
    x = _wav(0).astype(np.float64)
    _equal(tmcd.low_cut_filter(x, FS, cutoff),
           jmcd.low_cut_filter(x, FS, cutoff))


@pytest.mark.parametrize("seed,secs", [(1, 0.4), (2, 0.005)])
def test_estimate_f0(seed, secs):
    x = _wav(seed, secs).astype(np.float64)
    _equal(tmcd.estimate_f0(x, FS, 10.0, 70.0, 700.0),
           jmcd.estimate_f0(x, FS, 10.0, 70.0, 700.0))


def test_cheaptrick_envelope():
    x = _wav(3).astype(np.float64)
    f0 = jmcd.estimate_f0(x, FS, 10.0, 70.0, 700.0)
    f0[::5] = 0.0  # unvoiced frames take the default F0
    _equal(tmcd.cheaptrick_envelope(x, FS, f0, 10.0, 512),
           jmcd.cheaptrick_envelope(x, FS, f0, 10.0, 512))


@pytest.mark.parametrize("n_in,order,alpha", [(257, 24, 0.41), (65, 8, 0.3)])
def test_freqt(n_in, order, alpha):
    c = np.random.default_rng(4).standard_normal((5, n_in))
    _equal(tmcd.freqt_matrix(n_in, order, alpha),
           jmcd.freqt_matrix(n_in, order, alpha))
    _equal(tmcd.freqt(c, order, alpha), jmcd.freqt(c, order, alpha))


def test_sp2mc_and_spc2npow():
    env = np.random.default_rng(5).uniform(1e-4, 2.0, (7, 257))
    _equal(tmcd.sp2mc(env, 24, 0.41), jmcd.sp2mc(env, 24, 0.41))
    _equal(tmcd.spc2npow(env), jmcd.spc2npow(env))


def test_mcep_from_wav():
    t, j = _cfgs()
    _equal(tmcd.mcep_from_wav(_wav(6), FS, t),
           jmcd.mcep_from_wav(_wav(6), FS, j))


def test_dtw_path():
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal((23, 6)), rng.standard_normal((17, 6))
    _equal(tmcd.dtw_path(x, y), jmcd.dtw_path(x, y))


@pytest.mark.parametrize("threshold", [-20.0, 100.0])
def test_mcd_from_mceps(threshold):
    rng = np.random.default_rng(8)
    args = (rng.standard_normal((20, 9)), rng.uniform(-30, 5, 20),
            rng.standard_normal((15, 9)), rng.uniform(-30, 5, 15))
    _equal(tmcd.mcd_from_mceps(*args, power_threshold_db=threshold),
           jmcd.mcd_from_mceps(*args, power_threshold_db=threshold))


@pytest.mark.parametrize("case", ["pair", "self", "empty"])
def test_mcd_between_waveforms(case):
    t, j = _cfgs()
    a, b = _wav(9), _wav(10, 0.5, f0=170.0)
    if case == "self":
        b = a
    if case == "empty":
        a = a[:0]
    got = tmcd.mcd_between_waveforms(a, b, FS, t)
    _equal(got, jmcd.mcd_between_waveforms(a, b, FS, j))
    if case == "self":
        assert got == 0.0


@pytest.mark.parametrize("text", ["a b c d e f", "a b c d e f g", "x y", "z"])
def test_middle_third_mask_str(text):
    assert tmcd.middle_third_mask_str(text) == jmcd.middle_third_mask_str(text)


def test_evaluate_masked_reconstruction():
    """Both functions on one stand-in editor (the protocol's host logic:
    masks, spans, MCD and the mean), with a zero-length span skipped."""
    import types

    hop = 80
    wavs = {"u1": _wav(11), "u2": _wav(12, 0.5), "u3": _wav(13)}
    texts = {"u1": "a b c d e f", "u2": "a b c d e f g", "u3": "a b"}
    calls = []

    def reconstruct(wav, align, text, masked):
        calls.append(masked)
        n = len(text.split())
        s = 0 if n < 3 else 8
        e = 0 if n < 3 else 24
        rng = np.random.default_rng(len(masked))
        return types.SimpleNamespace(
            old_span_boundary=[s, e],
            prediction=wav + 0.05 * rng.standard_normal(wav.size))

    editor = types.SimpleNamespace(
        fe=types.SimpleNamespace(config=types.SimpleNamespace(
            fs=FS, hop_length=hop)),
        reconstruct_masked_span=reconstruct)
    dataset = {u: {"audio": w, "phones": texts[u].split()}
               for u, w in wavs.items()}
    t, j = _cfgs()
    got = tmcd.evaluate_masked_reconstruction(editor, lambda u: None, dataset,
                                              list(wavs), t, texts)
    want = jmcd.evaluate_masked_reconstruction(editor, lambda u: None,
                                               dataset, list(wavs), j, texts)
    assert got == want and got["n"] == 2 and np.isfinite(got["mean_mcd"])
    assert calls[:3] == calls[3:]
