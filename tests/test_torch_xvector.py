"""The port's x-vector network and extractors (a3t_tpu_torch/models/
xvector.py) against ``a3t_tpu.models.xvector`` on the CPU, on the trained
weights of artifacts/xvector (plain npz, 16 kHz front-end, 80 mel bins).

Tolerances (fp32; the frameworks sum the five convolutions and the pooling
in another order): embeddings and logits within 2e-6 of the embedding's
largest magnitude (read 2.5e-7 on embeddings up to ~45); the npz read back
by the JAX loader bit for bit.  The context extractor's output is the same
bit for bit when samples that reach no unmasked frame are replaced (the
masked span's interior), and moves when the span's edges are.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import xvector as jxv
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import xvector as xv
from a3t_tpu_torch.tasks.config import FRONTEND_16K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XV_DIR = os.path.join(ROOT, "artifacts", "xvector")
REL = 2e-6
FE = {k: getattr(FRONTEND_16K, k) for k in (
    "fs", "n_fft", "hop_length", "win_length", "n_mels", "fmin", "fmax")}
# the extractor's reach around a frame: the STFT's half-window in samples
# and the TDNN's context, sum((k - 1) / 2 * dilation) = 2 + 2 + 3 frames
TDNN_CONTEXT = 7


@pytest.fixture(scope="module")
def nets():
    if not os.path.isdir(XV_DIR):
        pytest.skip("artifacts/xvector is not in this checkout")
    jm, jv, jmvn = jxv.load_xvector(XV_DIR)
    pm, pmvn = xv.load_xvector(XV_DIR, device="cpu")
    return jm, jv, jmvn, pm, pmvn


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five 16 kHz utterances of three speakers."""
    return generate_mini_corpus(str(tmp_path_factory.mktemp("xv") / "d"),
                                n_utts=5, fs=16000, n_phones_range=(6, 12))


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(np.asarray(got) - want).max()
    assert err <= REL * np.abs(want).max(), err


def test_load_xvector_reads_the_artifacts(nets):
    """The config (the classifier head of 16 speakers included) and the
    normalisation pair as JAX reads them; every weight bit for bit."""
    jm, jv, jmvn, pm, pmvn = nets
    assert pm.config.n_speakers == jm.config.n_speakers == 16
    assert pm.config.embed_dim == 192 and pm.config.channels == 512
    for a, b in zip(pmvn, jmvn):
        np.testing.assert_array_equal(a, b)
    p = jv["params"]
    sd = pm.state_dict()
    np.testing.assert_array_equal(sd["tdnn_1.weight"].numpy(),
                                  np.asarray(p["tdnn_1"]["kernel"]).transpose(
                                      2, 1, 0))
    np.testing.assert_array_equal(sd["bn_4.weight"].numpy(),
                                  np.asarray(p["bn_4"]["scale"]))
    np.testing.assert_array_equal(sd["classifier.weight"].numpy(),
                                  np.asarray(p["classifier"]["kernel"]).T)
    assert pm.bn_0.eps == 1e-6  # flax LayerNorm's default


@pytest.mark.parametrize("masked", [False, True])
def test_xvector_net_matches_jax(nets, rng, masked):
    """Embedding and logits, with the unmasked pooling (torch.var, as jnp
    .var) and the masked one (E[h^2] - mean^2 over the valid frames)."""
    jm, jv, _, pm, _ = nets
    feats = rng.standard_normal((2, 50, 80)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 50), bool)
        mask[1, 30:] = False
        mask[0, 10:20] = False
    je, jl = jm.apply(jv, jnp.asarray(feats),
                      None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        pe, pl = pm(torch.tensor(feats),
                    None if mask is None else torch.tensor(mask))
    _close(pe.numpy(), je)
    err = np.abs(pl.numpy() - np.asarray(jl)).max()
    assert err <= REL * np.abs(np.asarray(je)).max()


def test_save_xvector_reads_back_in_jax(nets, tmp_path):
    """save_xvector writes train_xvector's format: JAX's load_xvector reads
    every leaf back bit for bit, and a network without the head loads in
    both."""
    _, jv, _, pm, pmvn = nets
    xv.save_xvector(pm, pmvn, str(tmp_path / "a"))
    _, jv2, mvn2 = jxv.load_xvector(str(tmp_path / "a"))
    for a, b in zip(jax.tree_util.tree_leaves(jv),
                    jax.tree_util.tree_leaves(jv2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(mvn2[0], pmvn[0])
    small = xv.XVectorNet(xv.XVectorConfig(channels=8, embed_dim=4))
    xv.save_xvector(small, pmvn, str(tmp_path / "b"))
    jm3, jv3, _ = jxv.load_xvector(str(tmp_path / "b"))
    back, _ = xv.load_xvector(str(tmp_path / "b"), device="cpu")
    assert back.config == small.config
    feats = np.ones((1, 12, 80), np.float32)
    with torch.no_grad():
        got = back(torch.tensor(feats))[0].numpy()
    _close(got, jm3.apply(jv3, jnp.asarray(feats))[0])


def test_build_spk2xvector_and_utt2xvector_match_jax(nets, corpus, tmp_path):
    """Per-speaker means (one call per utterance, 256-frame padding) and
    per-utterance embeddings (chunks of 2, so a short last chunk) equal
    JAX's within the tolerance, and the .npz files hold them."""
    jm, jv, jmvn, pm, pmvn = nets
    jfe = JaxLogMelFrontend(JaxLogMelConfig(**FE))
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    jds, ds = JaxA3TDataset(corpus), A3TDataset(corpus)
    want = jxv.build_spk2xvector(jm, jv, jfe, jds, max_frames=256,
                                 mel_mvn=jmvn, max_utts_per_speaker=1)
    got = xv.build_spk2xvector(pm, fe, ds, str(tmp_path / "spk.npz"),
                               max_frames=256, mel_mvn=pmvn,
                               max_utts_per_speaker=1)
    assert sorted(got) == sorted(want) == ["spk0", "spk1", "spk2"]
    for k in want:
        _close(got[k], want[k])
    back = xv.load_spk2xvector(str(tmp_path / "spk.npz"))
    assert all(np.array_equal(back[k], got[k]) for k in got)
    want = jxv.build_utt2xvector(jm, jv, jfe, jds, mel_mvn=jmvn, chunk=2)
    got = xv.build_utt2xvector(pm, fe, ds, str(tmp_path / "utt.npz"),
                               mel_mvn=pmvn, chunk=2)
    assert sorted(got) == sorted(want) == list(ds.uids)
    for k in want:
        _close(got[k], want[k])


@pytest.fixture(scope="module")
def context_case(corpus):
    """A padded utterance of A3TDataset and a frame mask with padding and a
    masked span of at least 3 x (TDNN context + half-window) frames."""
    ds = A3TDataset(corpus)
    uid = max(ds.uids, key=ds.num_samples)
    wav = ds[uid]["audio"]
    hop = FE["hop_length"]
    n_f = 1 + len(wav) // hop
    f_pad = (n_f + 63) // 64 * 64
    audio = np.zeros((f_pad - 1) * hop, np.float32)
    audio[: len(wav)] = wav
    s, e = n_f // 4, 3 * n_f // 4
    mask = np.arange(f_pad) < n_f
    mask[s:e] = False
    assert e - s >= 3 * (TDNN_CONTEXT + FE["n_fft"] // (2 * hop) + 1)
    assert ((s - 1 + TDNN_CONTEXT) * hop + FE["n_fft"] // 2
            < (e - TDNN_CONTEXT) * hop - FE["n_fft"] // 2)
    return audio, mask, s, e


def test_spemb_extractor_matches_jax_and_pools_the_context(nets,
                                                            context_case):
    """make_spemb_extractor against JAX's on a context mask; with the
    samples that reach no unmasked frame replaced by noise (the masked
    span's interior: past the TDNN context and the STFT's half-window from
    each edge) the x-vector is the same bit for bit, in both packages;
    noise over the whole span (its edges reach the context frames through
    the STFT window and the TDNN) moves it."""
    audio, mask, s, e = context_case
    hop, half = FE["hop_length"], FE["n_fft"] // 2
    fn = xv.make_spemb_extractor(XV_DIR, LogMelFrontend(LogMelConfig(**FE),
                                                        device="cpu"))
    jfn = jxv.make_spemb_extractor(XV_DIR,
                                   JaxLogMelFrontend(JaxLogMelConfig(**FE)))
    got = fn(audio, mask)
    assert got.shape == (192,)
    want = jfn(audio, mask)
    _close(got, want)
    noise = np.random.default_rng(9).standard_normal(audio.size).astype(
        np.float32)
    # frame j reads mel frames j - 7 .. j + 7, mel frame t the samples
    # [t * hop - half, t * hop + half)
    lo = (s - 1 + TDNN_CONTEXT) * hop + half
    hi = (e - TDNN_CONTEXT) * hop - half
    inner = audio.copy()
    inner[lo:hi] = noise[lo:hi]
    np.testing.assert_array_equal(fn(inner, mask), got)
    np.testing.assert_array_equal(jfn(inner, mask), want)
    whole = audio.copy()
    whole[s * hop:e * hop] = noise[s * hop:e * hop]
    assert not np.array_equal(fn(whole, mask), got)


def test_train_xvector_is_not_ported():
    with pytest.raises(NotImplementedError, match="A9"):
        xv.train_xvector("data", None, "out")
