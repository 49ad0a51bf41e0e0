"""Feature normalization and statistics collection
(``a3t_tpu/dsp/normalize.py``).

* :class:`GlobalMVN` — global mean/variance normalization from collected
  statistics (espnet2/layers/global_mvn.py:14-70), with its inverse;
* :class:`UtteranceMVN` — per-utterance normalization, over every frame or
  over the frames a mask marks valid;
* :func:`collect_stats` — one pass over a corpus writing per-utterance
  shape files and the features' sum, sum of squares and count
  (espnet2/main_funcs/collect_stats.py:24), mergeable across split jobs by
  :func:`aggregate_stats`.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class GlobalMVN:
    """``(feats - mean) / std`` with numpy statistics (std clamped at
    1e-20); the statistics move to a tensor's device on first use there."""

    def __init__(self, mean: np.ndarray, std: np.ndarray,
                 norm_means: bool = True, norm_vars: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.maximum(np.asarray(std, np.float32), 1e-20)
        self.norm_means = norm_means
        self.norm_vars = norm_vars
        self._on = {}

    @classmethod
    def from_stats(cls, path: str, **kw) -> "GlobalMVN":
        """From a ``feats_stats.npz`` of :func:`collect_stats`."""
        z = np.load(path)
        count = z["count"]
        mean = z["sum"] / count
        var = z["sqsum"] / count - mean**2
        return cls(mean, np.sqrt(np.maximum(var, 1e-20)), **kw)

    def _stats(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (torch.as_tensor(self.mean, device=device),
                                torch.as_tensor(self.std, device=device))
        return self._on[device]

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        mean, std = self._stats(feats.device)
        out = feats
        if self.norm_means:
            out = out - mean
        if self.norm_vars:
            out = out / std
        return out

    def inverse(self, feats: torch.Tensor) -> torch.Tensor:
        mean, std = self._stats(feats.device)
        out = feats
        if self.norm_vars:
            out = out * std
        if self.norm_means:
            out = out + mean
        return out


class UtteranceMVN:
    """Per-utterance normalization of (B, F, D) features over the frames;
    with ``frame_mask`` (B, F) the statistics count only valid frames."""

    def __init__(self, norm_means: bool = True, norm_vars: bool = False):
        self.norm_means = norm_means
        self.norm_vars = norm_vars

    def __call__(self, feats: torch.Tensor, frame_mask=None) -> torch.Tensor:
        if frame_mask is None:
            mean = feats.mean(dim=1, keepdim=True)
            var = feats.var(dim=1, keepdim=True, unbiased=False)
        else:
            w = frame_mask.to(feats.dtype)[..., None]
            denom = w.sum(dim=1, keepdim=True) + 1e-6
            mean = (feats * w).sum(dim=1, keepdim=True) / denom
            var = (feats**2 * w).sum(dim=1, keepdim=True) / denom - mean**2
        out = feats
        if self.norm_means:
            out = out - mean
        if self.norm_vars:
            out = out / torch.sqrt(torch.clamp(var, min=1e-20))
        return out


def _write_shapes(out_dir: str, name: str, shapes: dict) -> None:
    with open(os.path.join(out_dir, name), "w") as f:
        for k in sorted(shapes):
            f.write(f"{k} {shapes[k]}\n")


def collect_stats(frontend, dataset, out_dir: str) -> dict:
    """Write ``speech_shape``, ``text_shape`` and ``feats_stats.npz`` (sum,
    sqsum, count over every valid frame) for a corpus: ``dataset`` has
    ``.uids`` and ``dataset[uid]["audio"]`` (1-D float audio, optionally
    ``"text_ids"``).  The features come from the port's rfft front-end on
    the front-end's device, one utterance at a time."""
    os.makedirs(out_dir, exist_ok=True)
    hop = frontend.config.hop_length
    n_mels = frontend.config.n_mels
    total = np.zeros(n_mels, np.float64)
    sq = np.zeros(n_mels, np.float64)
    count = 0
    speech_shape, text_shape = {}, {}
    for uid in dataset.uids:
        item = dataset[uid]
        wav = np.asarray(item["audio"])
        with torch.no_grad():
            feats = frontend(wav[None])[0][0].cpu().numpy()
        n_f = 1 + len(wav) // hop
        feats = feats[:n_f]
        total += feats.sum(axis=0)
        sq += (feats.astype(np.float64) ** 2).sum(axis=0)
        count += n_f
        speech_shape[uid] = f"{n_f},{n_mels}"
        if "text_ids" in item:
            text_shape[uid] = str(len(item["text_ids"]))

    np.savez(os.path.join(out_dir, "feats_stats.npz"),
             sum=total, sqsum=sq, count=count)
    _write_shapes(out_dir, "speech_shape", speech_shape)
    if text_shape:
        _write_shapes(out_dir, "text_shape", text_shape)
    return {"count": count}


def aggregate_stats(dirs: list[str], out_dir: str) -> None:
    """Merge the statistics and shape files of split jobs into ``out_dir``
    (espnet2/bin/aggregate_stats_dirs.py)."""
    os.makedirs(out_dir, exist_ok=True)
    total = sq = None
    count = 0
    shapes: dict[str, str] = {}
    text_shapes: dict[str, str] = {}
    for d in dirs:
        z = np.load(os.path.join(d, "feats_stats.npz"))
        total = z["sum"] if total is None else total + z["sum"]
        sq = z["sqsum"] if sq is None else sq + z["sqsum"]
        count += int(z["count"])
        for name, dst in (("speech_shape", shapes),
                          ("text_shape", text_shapes)):
            p = os.path.join(d, name)
            if os.path.exists(p):
                with open(p) as f:
                    for line in f:
                        k, v = line.split(maxsplit=1)
                        dst[k] = v.strip()
    np.savez(os.path.join(out_dir, "feats_stats.npz"),
             sum=total, sqsum=sq, count=count)
    for name, src in (("speech_shape", shapes), ("text_shape", text_shapes)):
        if src:
            _write_shapes(out_dir, name, src)
