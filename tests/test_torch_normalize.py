"""The port's feature normalization and statistics collection
(a3t_tpu_torch/dsp/normalize.py) against a3t_tpu/dsp/normalize.py: GlobalMVN
(from statistics, and its inverse), UtteranceMVN with and without a frame
mask, and collect_stats + aggregate_stats over a tiny in-memory corpus.
Inputs from numpy with a seed; fp32 on the CPU.

Tolerances.  Normalized features (|x| up to ~10) within atol 1e-5: the same
fp32 arithmetic, sums over frames in another order.  The collected sums
(float64, over ~100 frames of log-mel features that the two rfft front-ends
give within ~1e-6 of each other) within rtol 1e-5; counts and shape files
equal.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.dsp import normalize as jn
from a3t_tpu_torch.dsp import (GlobalMVN, LogMelConfig, LogMelFrontend,
                               UtteranceMVN, aggregate_stats, collect_stats)

FRONTEND = dict(fs=8000, n_fft=256, hop_length=80, win_length=240, n_mels=20,
                fmin=20, fmax=4000)


def _feats():
    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((3, 30, 20)) * 2.0 + 1.5).astype(np.float32)
    mask = np.ones((3, 30), bool)
    mask[1, 22:] = False
    mask[2, 9:] = False
    return rng, feats, mask


@pytest.mark.parametrize("means,variances", [(True, True), (True, False),
                                             (False, True)])
def test_global_mvn_matches_jax(means, variances):
    rng, feats, _ = _feats()
    mean = rng.standard_normal(20).astype(np.float32)
    std = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    std[3] = 0.0  # clamped at 1e-20
    j = jn.GlobalMVN(mean, std, norm_means=means, norm_vars=variances)
    t = GlobalMVN(mean, std, norm_means=means, norm_vars=variances)
    x = torch.tensor(feats)
    x[:, :, 3] = 0.0
    got = t(x)
    want = j(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(t.inverse(got).numpy(),
                               np.asarray(j.inverse(want)), atol=1e-5,
                               rtol=1e-6)


def test_global_mvn_from_stats_matches_jax(tmp_path):
    rng, feats, _ = _feats()
    flat = feats.reshape(-1, 20).astype(np.float64)
    path = os.path.join(tmp_path, "feats_stats.npz")
    np.savez(path, sum=flat.sum(0), sqsum=(flat**2).sum(0), count=len(flat))
    j = jn.GlobalMVN.from_stats(path)
    t = GlobalMVN.from_stats(path)
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    got = t(torch.tensor(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(feats))),
                               atol=1e-5, rtol=1e-6)
    # normalized by its own statistics: mean 0 and std 1 per bin
    np.testing.assert_allclose(got.reshape(-1, 20).mean(0).numpy(), 0.0,
                               atol=1e-5)
    np.testing.assert_allclose(got.reshape(-1, 20).std(0, unbiased=False)
                               .numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("variances", [False, True])
def test_utterance_mvn_matches_jax(masked, variances):
    _, feats, mask = _feats()
    j = jn.UtteranceMVN(norm_vars=variances)
    t = UtteranceMVN(norm_vars=variances)
    want = j(jnp.asarray(feats), jnp.asarray(mask) if masked else None)
    got = t(torch.tensor(feats), torch.tensor(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


class _Corpus:
    """The duck-typed dataset collect_stats reads: ``.uids`` and
    ``[uid]["audio"]`` (with ``"text_ids"`` for some utterances)."""

    def __init__(self, seed: int, n: int):
        rng = np.random.default_rng(seed)
        self.items = {}
        for i in range(n):
            item = {"audio": (rng.standard_normal(int(rng.integers(
                900, 2600))) * 0.1).astype(np.float32)}
            if i % 2 == 0:
                item["text_ids"] = rng.integers(1, 40, int(rng.integers(
                    3, 9))).astype(np.int32)
            self.items[f"utt{seed}_{i}"] = item
        self.uids = sorted(self.items)

    def __getitem__(self, uid):
        return self.items[uid]


def _read(d: str):
    z = np.load(os.path.join(d, "feats_stats.npz"))
    files = {}
    for name in ("speech_shape", "text_shape"):
        with open(os.path.join(d, name)) as f:
            files[name] = f.read()
    return {k: z[k] for k in ("sum", "sqsum", "count")}, files


def test_collect_and_aggregate_stats_match_jax(tmp_path):
    jfe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
    tfe = LogMelFrontend(LogMelConfig(**FRONTEND), device="cpu")
    corpora = [_Corpus(1, 3), _Corpus(2, 2)]
    for side, fe, collect, aggregate in (
            ("jax", jfe, jn.collect_stats, jn.aggregate_stats),
            ("port", tfe, collect_stats, aggregate_stats)):
        dirs = []
        for i, corpus in enumerate(corpora):
            dirs.append(os.path.join(tmp_path, side, f"split{i}"))
            out = collect(fe, corpus, dirs[-1])
            assert out["count"] == sum(1 + len(corpus[u]["audio"]) // 80
                                       for u in corpus.uids)
        aggregate(dirs, os.path.join(tmp_path, side, "all"))
    for d in ("split0", "split1", "all"):
        (ws, wf), (gs, gf) = (_read(os.path.join(tmp_path, side, d))
                              for side in ("jax", "port"))
        assert gf == wf, d
        assert int(gs["count"]) == int(ws["count"])
        for k in ("sum", "sqsum"):
            assert gs[k].dtype == ws[k].dtype == np.float64
            np.testing.assert_allclose(gs[k], ws[k], rtol=1e-5, atol=0,
                                       err_msg=f"{d} {k}")
