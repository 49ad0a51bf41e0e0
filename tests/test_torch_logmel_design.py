"""The design of the fused log-mel kernel K6
(a3t_tpu_torch/csrc/fused_logmel.cu), held on the CPU.

The CUDA kernel cannot run here, so a torch model of its arithmetic runs in
its place, in fp32, on the wrapper's own tables:

* the FFT route (power-of-two n_fft): the windowed frame as M = n_fft / 2
  complex values in a swizzled buffer, the Stockham stages of the kernel's
  radix schedule (16, then 4s, then a last 2) on the wrapper's twiddle
  table, the real-to-complex split on its split twiddles, amplitudes, the
  sparse mel sums over each filter's range of bins in bin order, log10;
* the direct-DFT route (any other n_fft): the window's rows of the DFT bases
  and the dense mel product.

The model is held against torch.fft.rfft (the FFT and the split), against
the dense mel product (the sparse ranges), and as a whole against the plain
version and the JAX package's Pallas ``fused_logmel`` in interpret mode at
the repo's three configs and a 16 kHz n_fft 400 one.  Also the wrapper's
plan: which route, how many frames per CTA, and what it refuses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.ops import fused_logmel as jax_fused_logmel
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.dsp.mel import mel_filterbank
from a3t_tpu_torch.dsp.stft import frame_signal
from a3t_tpu_torch.ops import fused_logmel as fl
from a3t_tpu_torch.tasks.config import FRONTEND_16K, FRONTEND_24K

CONFIGS = {
    "24k": FRONTEND_24K,
    "16k": FRONTEND_16K,
    "8k": LogMelConfig(fs=8000, n_fft=256, hop_length=80, win_length=240,
                       n_mels=20, fmin=20, fmax=4000),
    # not a power of two: the direct-DFT route
    "16k_400": LogMelConfig(fs=16000, n_fft=400, hop_length=160,
                            win_length=400, n_mels=80),
}
# chip_smoke.py's bound on the log10 features (TOL_F32); the FFT against
# rfft in fp32, relative to the largest |X|; the sparse mel sum against the
# dense product, relative to the largest mel value
TOL_FEATS = 1e-4
TOL_FFT = 1e-5
TOL_MEL = 1e-6


def _swz(x: torch.Tensor) -> torch.Tensor:
    """The kernel's swizzled slot of complex value x."""
    return x ^ ((x >> 4) & 15)


def _dft4(a0, a1, a2, a3):
    s02, d02, s13, d13 = a0 + a2, a0 - a2, a1 + a3, a1 - a3
    return s02 + s13, d02 - 1j * d13, s02 - s13, d02 + 1j * d13


def _dft(u: list) -> list:
    """The kernel's R-point butterflies (R = 2, 4, 16) on a list of complex
    tensors; outputs in natural order."""
    if len(u) == 2:
        return [u[0] + u[1], u[0] - u[1]]
    if len(u) == 4:
        return list(_dft4(*u))
    u = list(u)
    for n2 in range(4):
        u[n2], u[4 + n2], u[8 + n2], u[12 + n2] = _dft4(
            u[n2], u[4 + n2], u[8 + n2], u[12 + n2])
    for k1 in range(1, 4):
        for n2 in range(1, 4):
            w = np.exp(-2j * np.pi * n2 * k1 / 16)
            u[4 * k1 + n2] = u[4 * k1 + n2] * torch.tensor(
                w, dtype=torch.complex64)
    for k1 in range(4):
        u[4 * k1:4 * k1 + 4] = _dft4(*u[4 * k1:4 * k1 + 4])
    return [u[4 * (l & 3) + (l >> 2)] for l in range(16)]


def _tables(c: LogMelConfig):
    """The wrapper's float32 tables as complex64 twiddles, the split's
    twiddles, the window, the mel ranges and the weights."""
    tab, mels, off = fl.fft_tables(c)
    tab = torch.tensor(tab)

    def cplx(a, n):
        return torch.complex(tab[a:a + 2 * n:2], tab[a + 1:a + 2 * n:2])

    m = c.n_fft // 2
    return (cplx(0, off["split"] // 2), cplx(off["split"], m // 2 + 1),
            tab[off["win"]:off["win"] + c.win_length], mels, tab[off["wts"]:])


def model_fft(z: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """(n, M) complex64 -> its M-point DFT as the kernel runs it: the
    swizzled buffer, Stockham stages in place on the twiddle table."""
    m = z.shape[-1]
    logm = m.bit_length() - 1
    slots = _swz(torch.arange(m))
    buf = torch.empty_like(z)
    buf[:, slots] = z
    p, t0 = 1, 0
    for lr in fl.fft_schedule(logm):
        r = 1 << lr
        nb = m // r
        i = torch.arange(nb)
        k = i & (p - 1)
        u = [buf[:, _swz(i + j * nb)] * (tw[t0 + j * p + k] if j else 1)
             for j in range(r)]
        y = _dft(u)
        o = (i // p) * (p * r) + k
        for l in range(r):
            buf[:, _swz(o + l * p)] = y[l]
        t0 += r * p
        p *= r
    return buf[:, slots]


def model_split(zf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, M) FFT of z[n] = x[2n] + i x[2n+1] -> the n_fft / 2 + 1 bins of
    rfft(x), from the pairs (k, M - k) as the kernel forms them."""
    m = zf.shape[-1]
    k = torch.arange(m // 2 + 1)
    zk, zm = zf[:, k], zf[:, (m - k) % m]
    sa, sb = zk + zm.conj(), zk - zm.conj()
    wb = w * sb
    xk = torch.complex(0.5 * (sa.real + wb.imag), 0.5 * (sa.imag - wb.real))
    xm = torch.complex(0.5 * (sa.real - wb.imag), 0.5 * (-sa.imag - wb.real))
    out = torch.empty(zf.shape[0], m + 1, dtype=zf.dtype)
    out[:, m - k] = xm
    out[:, k] = xk
    return out


def model_mel(amp: torch.Tensor, mels: np.ndarray, wts: torch.Tensor):
    """(n, bins) amplitudes -> (n, n_mels) sums of each filter's range, in
    bin order (zero weights pad the shorter ranges: they add nothing)."""
    lo, cnt, off = (torch.tensor(x, dtype=torch.int64) for x in mels)
    acc = torch.zeros(amp.shape[0], lo.numel())
    for e in range(int(cnt.max())):
        live = e < cnt
        wv = torch.where(live, wts[(off + e).clamp(max=wts.numel() - 1)],
                         torch.zeros(()))
        kb = torch.where(live, lo + e, torch.zeros_like(lo))
        acc = acc + wv * amp[:, kb]
    return acc


def model_logmel(audio: torch.Tensor, c: LogMelConfig, lengths=None):
    """The kernel's features (B, F, n_mels) and frame lengths."""
    plan = fl.plan(c)
    frames = frame_signal(audio, c.n_fft, c.hop_length)
    b, nf, _ = frames.shape
    left = (c.n_fft - c.win_length) // 2
    if plan.route == "fft":
        tw, w_split, win, mels, wts = _tables(c)
        x = torch.zeros_like(frames)
        x[..., left:left + c.win_length] = \
            frames[..., left:left + c.win_length] * win
        x = x.reshape(b * nf, c.n_fft)
        spec = model_split(model_fft(torch.complex(x[:, 0::2], x[:, 1::2]),
                                     tw), w_split)
        amp = torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2,
                                     min=1e-10))
        mel = model_mel(amp, mels, wts).reshape(b, nf, c.n_mels)
    else:
        w_cos, w_sin, melmat = fl.dft_tables(c, torch.device("cpu"))
        seg = frames[..., left:left + c.win_length]
        re = seg @ w_cos[:c.win_length]
        im = seg @ w_sin[:c.win_length]
        mel = torch.sqrt(torch.clamp(re * re + im * im, min=1e-10)) @ melmat
    feats = torch.log(torch.clamp(mel, min=1e-10)) * np.float32(
        1.0 / np.log(10.0))
    flens = torch.full((b,), nf, dtype=torch.int64)
    if lengths is not None:
        flens = torch.as_tensor(lengths).to(torch.int64) // c.hop_length + 1
        feats = torch.where(torch.arange(nf)[None, :, None]
                            < flens[:, None, None], feats, 0.0)
    return feats, flens


def _audio(c: LogMelConfig, frames: int = 70):
    n = c.hop_length * (frames - 1)
    audio = (np.random.default_rng(3).standard_normal((2, n)) * 0.1).astype(
        np.float32)
    return audio, np.array([n, n - 7 * c.hop_length], np.int32)


@pytest.mark.parametrize("logm", range(5, 12))
def test_fft_schedule_and_split_match_rfft(logm):
    """The twiddle table, the radix schedule and the real split of the
    kernel against torch.fft.rfft in fp32, n_fft 64 to 4096."""
    m = 1 << logm
    n_fft = 2 * m
    c = LogMelConfig(fs=16000, n_fft=n_fft, hop_length=n_fft // 4,
                     win_length=n_fft, n_mels=8, fmin=0, fmax=8000)
    tw, w_split, _, _, _ = _tables(c)
    assert tw.numel() == sum((1 << lr) * (1 << sum(fl.fft_schedule(logm)[:s]))
                             for s, lr in enumerate(fl.fft_schedule(logm)))
    assert sum(fl.fft_schedule(logm)) == logm
    assert fl.fft_schedule(logm)[0] == 4
    x = torch.tensor(np.random.default_rng(logm).standard_normal((3, n_fft)),
                     dtype=torch.float32)
    got = model_split(model_fft(torch.complex(x[:, 0::2], x[:, 1::2]), tw),
                      w_split)
    want = torch.fft.rfft(x.double())
    err = (got.to(torch.complex128) - want).abs().max() / want.abs().max()
    assert err.item() <= TOL_FFT


def test_swizzle_spreads_every_stage_over_the_banks():
    """Each half-warp's 16 complex values (8 bytes each) of every load and
    store of every stage, the strided stores of the radix-16 stage
    included, land in 16 distinct 8-byte bank pairs, at n_fft 2048."""
    m, p = 1024, 1
    for lr in fl.fft_schedule(10):
        r = 1 << lr
        nb = m // r
        for half in range(0, nb, 16):
            i = torch.arange(half, half + 16)
            k = i & (p - 1)
            o = (i // p) * (p * r) + k
            for j in range(r):
                assert len(set((_swz(i + j * nb) % 16).tolist())) == 16
                assert len(set((_swz(o + j * p) % 16).tolist())) == 16
        p *= r


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sparse_mel_ranges_cover_the_filterbank(name):
    """Each mel filter's range holds all of its non-zero weights, the bins
    past the last range are never read, and the sparse sum equals the
    dense product within 1e-6."""
    c = CONFIGS[name]
    melmat = mel_filterbank(c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax).T
    mels, wts = fl.mel_ranges(melmat)
    lo, cnt, off = mels
    for m in range(c.n_mels):
        nz = np.nonzero(melmat[:, m])[0]
        assert nz.size and lo[m] == nz[0] and lo[m] + cnt[m] - 1 == nz[-1]
        np.testing.assert_array_equal(wts[off[m]:off[m] + cnt[m]],
                                      melmat[lo[m]:lo[m] + cnt[m], m])
    assert (melmat[(lo + cnt).max():] == 0).all()
    amp = torch.tensor(np.random.default_rng(5).random((50, c.n_freqs)),
                       dtype=torch.float32)
    got = model_mel(amp, mels, torch.tensor(wts))
    want = amp.double() @ torch.tensor(melmat).double()
    assert ((got - want).abs().max() / want.abs().max()).item() <= TOL_MEL


@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_plain_and_pallas(name, lengths):
    """The whole kernel model within 1e-4 of the plain version and of the
    Pallas kernel in interpret mode on the log10 features; tails 0."""
    c = CONFIGS[name]
    assert fl.plan(c).route == ("dft" if name == "16k_400" else "fft")
    audio, lens = _audio(c)
    sl = lens if lengths else None
    got, got_l = model_logmel(torch.tensor(audio), c,
                              None if sl is None else torch.tensor(sl))
    want, want_l = fl.fused_logmel_plain(
        torch.tensor(audio), c, None if sl is None else torch.tensor(sl))
    pallas, pallas_l = jax_fused_logmel(
        jnp.asarray(audio), JaxLogMelConfig(**dataclasses.asdict(c)),
        None if sl is None else jnp.asarray(sl), interpret=True)
    assert got.shape == want.shape == pallas.shape
    assert torch.equal(got_l, want_l)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(pallas_l))
    for ref in (want.numpy(), np.asarray(pallas)):
        assert np.abs(got.numpy() - ref).max() <= TOL_FEATS
    if lengths:
        assert not got[1, int(got_l[1]):].any()


def test_plan_routes_and_limits():
    """The wrapper's plan: the FFT for power-of-two n_fft with the frames
    per CTA that keep the most frames on an SM, the direct DFT otherwise,
    each within a CTA's shared memory; n_fft past 4096 and a DFT config
    with more than 128 mel bins raise, with the limit."""
    p24, p16, p8 = (fl.plan(CONFIGS[n]) for n in ("24k", "16k", "8k"))
    assert (p24.route, p24.frames, p24.span) == ("fft", 8, 7 * 300 + 1200)
    assert (p16.route, p16.frames) == ("fft", 16)
    assert p8.route == "fft"
    p400 = fl.plan(CONFIGS["16k_400"])
    assert (p400.route, p400.frames) == ("dft", 64)
    for p in (p24, p16, p8, p400):
        assert p.smem <= fl.SMEM_MAX
    # two CTAs of 8 frames share an SM at 24 kHz
    assert 2 * (p24.smem + 1024) <= fl.SMEM_SM
    big = LogMelConfig(fs=48000, n_fft=4096, hop_length=1024,
                       win_length=4096, n_mels=128, fmin=0, fmax=24000)
    assert fl.plan(big).route == "fft" and fl.plan(big).smem <= fl.SMEM_MAX
    with pytest.raises(ValueError, match="4096"):
        fl.plan(dataclasses.replace(big, n_fft=8192))
    with pytest.raises(ValueError, match="128 mel"):
        fl.plan(dataclasses.replace(CONFIGS["16k_400"], n_mels=129))
    with pytest.raises(ValueError, match="win_length"):
        fl.plan(dataclasses.replace(CONFIGS["8k"], win_length=300))
