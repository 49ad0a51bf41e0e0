"""Mel-cepstral distortion (MCD): a numpy copy of ``a3t_tpu/eval/mcd.py``.

The analysis runs on the host, as the port keeps masking and tokenising, and
is held to the JAX package's function by function.  The protocol
(utils/mcd_calculate.py:152-211, aggregate_output/sedit_mcd.py:37-135):

    wav -> low-cut filter -> F0 -> CheapTrick spectral envelope
        -> pysptk-semantics mel-cepstrum (sp2mc/freqt, dim 80, alpha 0.41)
        -> silence stripping by normalized frame power (-20 dB threshold)
        -> DTW alignment -> mean over path of 10/ln10 * sqrt(2 * sum diff^2)

Every stage is numpy (and scipy's FIR filter):

* F0: normalized-autocorrelation search in [f0min, f0max] with parabolic
  refinement and median smoothing (the role of WORLD harvest);
* envelope: CheapTrick (Morise 2015) — pitch-adaptive 3*T0 Hanning window,
  DC correction below F0, 2F0/3 rectangular linear smoothing, and cepstral
  liftering with the sinc smoothing lifter + q1=-0.15 compensation lifter;
* sp2mc: pysptk's semantics — real cepstrum of the log power periodogram
  with c0 halved, then the SPTK ``freqt`` all-pass warping recursion
  (a cached linear map, so per-utterance cost is one
  (T, fftl/2+1) @ (fftl/2+1, order+1) product);
* DTW: exact O(T^2) dynamic program, vectorized over anti-diagonals.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class MCDConfig:
    mcep_dim: int = 80  # sedit_mcd.py calculate_mcd: --mcep_dim 80
    fftl: int = 1024
    shiftms: float = 5.0
    f0min: float = 80.0   # sedit_mcd.py: --f0min 80 --f0max 7600
    f0max: float = 7600.0
    power_threshold_db: float = -20.0
    lowcut_hz: float = 70.0
    q1: float = -0.15  # CheapTrick compensation-lifter coefficient
    alpha: float | None = 0.41  # mcd_calculate.py default --mcep_alpha 0.41


def mcep_alpha(fs: int) -> float:
    """Standard all-pass constants for mel warping per sample rate."""
    table = {8000: 0.312, 16000: 0.41, 22050: 0.455, 24000: 0.466,
             44100: 0.544, 48000: 0.554}
    if fs in table:
        return table[fs]
    return float(np.clip(0.41 + (fs - 16000) / 8000 * 0.056, 0.3, 0.6))


def low_cut_filter(x: np.ndarray, fs: int, cutoff: float = 70.0) -> np.ndarray:
    """FIR high-pass (the reference's low_cut_filter)."""
    from scipy.signal import firwin, lfilter

    if cutoff <= 0:
        return x
    nyq = fs / 2.0
    fil = firwin(255, cutoff / nyq, pass_zero=False)
    return lfilter(fil, 1, x)


# ---------------------------------------------------------------------------
# F0 (fills WORLD-harvest's role in the pipeline)
# ---------------------------------------------------------------------------

def estimate_f0(
    x: np.ndarray, fs: int, shiftms: float,
    f0min: float = 80.0, f0max: float = 7600.0,
    voicing_threshold: float = 0.45,
) -> np.ndarray:
    """Frame-level F0 via normalized autocorrelation; 0 = unvoiced.

    Windows of ~2.5 max periods at the analysis hop, lag search over
    [fs/f0max, fs/f0min], parabolic peak refinement, 3-tap median smoothing.
    """
    hop = max(1, int(fs * shiftms / 1000.0))
    lag_min = max(2, int(fs / min(f0max, fs / 4.0)))
    lag_max = min(int(np.ceil(fs / max(f0min, 1.0))), len(x) - 1)
    if lag_max <= lag_min:
        n_frames = max(1, (len(x) - 1) // hop + 1)
        return np.zeros(n_frames)
    win = int(2.5 * lag_max)
    n_frames = max(1, (len(x) - 1) // hop + 1)

    f0 = np.zeros(n_frames)
    pad = np.concatenate([x, np.zeros(win + lag_max + 1)])
    for t in range(n_frames):
        seg = pad[t * hop: t * hop + win]
        seg = seg - seg.mean()
        e0 = float(seg @ seg)
        if e0 < 1e-10:
            continue
        # normalized autocorrelation over the lag range (FFT-based)
        n_fft = 1 << int(np.ceil(np.log2(win + lag_max + 1)))
        sp = np.fft.rfft(seg, n_fft)
        ac = np.fft.irfft(sp * np.conj(sp))[: lag_max + 1]
        # normalize by the energies of the two shifted segments
        cum = np.concatenate([[0.0], np.cumsum(seg * seg)])
        e_lead = cum[win] - cum[: lag_max + 1]  # energy of seg[lag:]
        norm = np.sqrt(e0 * np.maximum(e_lead, 1e-12))
        r = ac[: lag_max + 1] / np.maximum(norm, 1e-12)
        band = r[lag_min: lag_max + 1]
        k = int(np.argmax(band)) + lag_min
        if r[k] < voicing_threshold:
            continue
        # parabolic refinement around the peak
        if 1 <= k < lag_max:
            y0, y1, y2 = r[k - 1], r[k], r[k + 1]
            denom = y0 - 2 * y1 + y2
            shift = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
            k = k + float(np.clip(shift, -1, 1))
        f0[t] = fs / k
    # median smoothing to kill octave glitches
    if n_frames >= 3:
        sm = f0.copy()
        sm[1:-1] = np.median(
            np.stack([f0[:-2], f0[1:-1], f0[2:]]), axis=0)
        f0 = sm
    f0[(f0 < f0min) | (f0 > f0max)] = 0.0
    return f0


# ---------------------------------------------------------------------------
# CheapTrick spectral envelope (Morise 2015)
# ---------------------------------------------------------------------------

_DEFAULT_F0 = 500.0  # WORLD's kDefaultF0 for unvoiced/low frames


def _cheaptrick_frame(x: np.ndarray, fs: int, f0: float, center: int,
                      fftl: int, q1: float, rng: np.random.Generator
                      ) -> np.ndarray:
    """Power-spectral envelope of one frame, |H(w)|^2, (fftl//2+1,)."""
    half = int(round(1.5 * fs / f0))
    idx = np.arange(-half, half + 1)
    pos = np.clip(center + idx, 0, len(x) - 1)
    seg = x[pos]
    # pitch-synchronous Hanning over 3 periods
    window = 0.5 * np.cos(np.pi * idx * f0 / (1.5 * fs)) + 0.5
    wsum = window.sum()
    seg = seg * window - window * (seg * window).sum() / wsum
    if len(seg) > fftl:
        seg = seg[: fftl]
    power = np.abs(np.fft.rfft(seg, fftl)) ** 2

    freq = np.arange(fftl // 2 + 1) * fs / fftl
    # DC correction: mirror the band just above F0 into the sub-F0 bins
    low = freq < f0
    if low.any():
        mirror_f = 2.0 * f0 - freq[low]
        power[low] += np.interp(mirror_f, freq, power)

    # linear smoothing with a rectangular window of width 2*f0/3
    width = 2.0 * f0 / 3.0
    cum = np.concatenate([[0.0], np.cumsum(power)])
    df = fs / fftl
    lo = np.clip((freq - width / 2) / df, 0, fftl // 2).astype(int)
    hi = np.clip((freq + width / 2) / df + 1, 1, fftl // 2 + 1).astype(int)
    smoothed = (cum[hi] - cum[lo]) / np.maximum(hi - lo, 1)

    smoothed = smoothed + np.abs(rng.standard_normal(len(smoothed))) * 1e-12

    # cepstral liftering: sinc smoothing lifter + q1 compensation lifter
    logp = np.log(np.maximum(smoothed, 1e-300))
    cep = np.fft.irfft(logp, fftl)
    quef = np.arange(fftl) / fs
    quef = np.minimum(quef, (fftl - np.arange(fftl)) / fs)  # symmetric axis
    arg = np.pi * f0 * quef
    smoothing_lifter = np.where(arg < 1e-12, 1.0, np.sin(arg) / np.maximum(
        arg, 1e-12))
    compensation_lifter = (1.0 - 2.0 * q1) + 2.0 * q1 * np.cos(
        2 * np.pi * f0 * quef)
    cep = cep * smoothing_lifter * compensation_lifter
    return np.exp(np.fft.rfft(cep, fftl).real[: fftl // 2 + 1])


def cheaptrick_envelope(
    x: np.ndarray, fs: int, f0: np.ndarray, shiftms: float, fftl: int,
    q1: float = -0.15,
) -> np.ndarray:
    """F0-adaptive spectral envelope |H(w)|^2, (T, fftl//2+1)."""
    hop = max(1, int(fs * shiftms / 1000.0))
    f0_floor = 3.0 * fs / fftl  # CheapTrick's lowest analyzable F0
    rng = np.random.default_rng(0)  # deterministic infinitesimal noise
    frames = []
    for t, f in enumerate(f0):
        fr = f if f >= f0_floor else _DEFAULT_F0
        frames.append(
            _cheaptrick_frame(x, fs, fr, t * hop, fftl, q1, rng))
    return np.stack(frames, axis=0)


# ---------------------------------------------------------------------------
# pysptk-semantics sp2mc (freqt realized as a cached linear map)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def freqt_matrix(n_in: int, order: int, alpha: float) -> np.ndarray:
    """(n_in, order+1) matrix A with freqt(c) == c @ A.

    Runs the SPTK freqt recursion on the identity basis; cached per
    (n_in, order, alpha).
    """
    wc = np.zeros((order + 1, n_in))
    for i in range(n_in - 1, -1, -1):
        prev = wc.copy()
        wc[0] = alpha * prev[0]
        wc[0, i] += 1.0
        if order > 0:
            wc[1] = (1 - alpha * alpha) * prev[0] + alpha * prev[1]
        for m in range(2, order + 1):
            wc[m] = prev[m - 1] + alpha * (prev[m] - wc[m - 1])
    return wc.T.copy()


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """SPTK frequency transform (all-pass warping) of cepstra.

    ``c``: (..., M+1) linear-frequency cepstrum -> (..., order+1) warped.
    """
    a = freqt_matrix(c.shape[-1], order, float(alpha))
    return c @ a


def sp2mc(powerspec: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """pysptk.sp2mc: power spectrum (T, fftl//2+1) -> mel-cepstrum
    (T, order+1).

    Real cepstrum of the log power periodogram, c0 halved (power ->
    amplitude convention), then freqt warping.
    """
    logsp = np.log(np.maximum(powerspec, 1e-300))
    c = np.fft.irfft(logsp, axis=-1)  # length 2*(n_freq-1)
    c[..., 0] /= 2.0
    return freqt(c[..., : powerspec.shape[-1]], order, alpha)


def spc2npow(spectrogram: np.ndarray) -> np.ndarray:
    """Normalized frame power in dB from the power envelope
    (utils/mcd_calculate.py:68-117), vectorized."""
    fftl2 = spectrogram.shape[-1] - 1
    power = (spectrogram[..., 0] + spectrogram[..., -1]
             + 2.0 * spectrogram[..., 1:-1].sum(-1)) / (2 * fftl2)
    mean_p = power.mean()
    return 10.0 * np.log10(np.maximum(power / mean_p, 1e-300))


def mcep_from_wav(
    wav: np.ndarray, fs: int, config: MCDConfig = MCDConfig()
) -> tuple[np.ndarray, np.ndarray]:
    """wav -> (mcep (T, dim+1), normalized frame power dB (T,)) — the
    world_extract analogue (utils/mcd_calculate.py:152-172)."""
    x = low_cut_filter(np.asarray(wav, np.float64), fs, config.lowcut_hz)
    f0 = estimate_f0(x, fs, config.shiftms, config.f0min, config.f0max)
    env = cheaptrick_envelope(x, fs, f0, config.shiftms, config.fftl,
                              config.q1)
    alpha = config.alpha if config.alpha is not None else mcep_alpha(fs)
    mc = sp2mc(env, config.mcep_dim, alpha)
    return mc, spc2npow(env)


# ---------------------------------------------------------------------------
# exact DTW, vectorized over anti-diagonals
# ---------------------------------------------------------------------------

def dtw_path(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact DTW (euclidean local cost); returns aligned index arrays."""
    tx, ty = len(x), len(y)
    d = np.sqrt(
        np.maximum(
            (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2.0 * (x @ y.T), 0.0))
    acc = np.full((tx + 1, ty + 1), np.inf)
    acc[0, 0] = 0.0
    # process anti-diagonals: every cell on i+j = s depends only on s-1, s-2
    for s in range(2, tx + ty + 1):
        i_lo = max(1, s - ty)
        i_hi = min(tx, s - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = s - i
        up = acc[i - 1, j]
        left = acc[i, j - 1]
        diag = acc[i - 1, j - 1]
        acc[i, j] = d[i - 1, j - 1] + np.minimum(np.minimum(up, left), diag)
    # backtrack
    path = []
    i, j = tx, ty
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        steps = ((i - 1, j), (i - 1, j - 1), (i, j - 1))
        costs = [acc[a, b] for a, b in steps]
        i, j = steps[int(np.argmin(costs))]
    path.reverse()
    p = np.asarray(path)
    return p[:, 0], p[:, 1]


def mcd_from_mceps(
    mc_cvt: np.ndarray, pow_cvt: np.ndarray,
    mc_gt: np.ndarray, pow_gt: np.ndarray,
    power_threshold_db: float = -20.0,
) -> float:
    """Silence-strip, DTW-align, average the frame-wise MCD
    (utils/mcd_calculate.py:179-210)."""
    cvt = mc_cvt[pow_cvt > power_threshold_db]
    gt = mc_gt[pow_gt > power_threshold_db]
    if len(cvt) == 0 or len(gt) == 0:
        return float("nan")
    pi, pj = dtw_path(cvt, gt)
    diff2sum = ((cvt[pi] - gt[pj]) ** 2).sum(axis=1)
    return float(np.mean(10.0 / np.log(10.0) * np.sqrt(2.0 * diff2sum)))


def mcd_between_waveforms(
    wav_cvt: np.ndarray, wav_gt: np.ndarray, fs: int,
    config: MCDConfig = MCDConfig(),
) -> float:
    # A degenerate edit (e.g. the middle-third mask of a 1-2-token
    # utterance) can yield a zero-length replaced span; score it NaN so
    # protocol means skip it, matching mcd_from_mceps' empty-frame path.
    if len(wav_cvt) == 0 or len(wav_gt) == 0:
        return float("nan")
    mc_c, pw_c = mcep_from_wav(wav_cvt, fs, config)
    mc_g, pw_g = mcep_from_wav(wav_gt, fs, config)
    return mcd_from_mceps(mc_c, pw_c, mc_g, pw_g, config.power_threshold_db)


# ---------------------------------------------------------------------------
# protocol harness (aggregate_output/sedit_mcd.py:43-135)
# ---------------------------------------------------------------------------

def middle_third_mask_str(text: str) -> str:
    """The VCTK/LJSpeech protocol mask: ``tokens[:n//3] + [MASK] +
    tokens[-n//3:]`` — exactly sedit_mcd.py:93-95 (note the tail is
    counted from the *end*, which differs from ``tokens[2*(n//3):]``
    whenever ``n % 3 != 0``)."""
    tokens = text.split()
    split = max(len(tokens) // 3, 1)
    return " ".join(tokens[:split] + ["[MASK]"] + tokens[-split:])


def evaluate_masked_reconstruction(
    editor,
    alignment_source,
    dataset,
    uids,
    config: MCDConfig = MCDConfig(),
    texts: dict | None = None,
) -> dict:
    """Teacher-forced middle-third reconstruction MCD over ``uids``.

    For each utterance: mask the middle third, regenerate, vocode the
    *replaced span* only, and compute MCD against the ground-truth span
    audio — the reference's "replaced" split.
    Returns per-utt and mean MCD.
    """
    hop = editor.fe.config.hop_length
    fs = editor.fe.config.fs
    per_utt = {}
    for uid in uids:
        item = dataset[uid]
        wav = item["audio"]
        align = alignment_source(uid)
        text = texts[uid] if texts is not None else " ".join(item["phones"])
        masked = middle_third_mask_str(text)
        res = editor.reconstruct_masked_span(wav, align, text, masked)
        s, e = res.old_span_boundary
        if e <= s:
            continue
        gen_span = res.prediction[s * hop: e * hop]
        gt_span = wav[s * hop: e * hop]
        per_utt[uid] = mcd_between_waveforms(gen_span, gt_span, fs, config)
    vals = [v for v in per_utt.values() if np.isfinite(v)]
    return {
        "per_utt": per_utt,
        "mean_mcd": float(np.mean(vals)) if vals else float("nan"),
        "n": len(vals),
    }
