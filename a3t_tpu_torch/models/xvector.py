"""Speaker embeddings: the x-vector TDNN and the corpus and inference
extractors (``a3t_tpu/models/xvector.py:30-87, 239-427``).

* :class:`XVectorNet` — five dilated frame-level convolutions, each with
  ReLU and LayerNorm (flax's epsilon 1e-6), mean + standard-deviation
  pooling over the valid frames, a bottleneck embedding and, when the
  network was trained as a speaker classifier, its head;
* :func:`load_xvector` — a ``train_xvector`` directory (``xvector.npz``,
  keyed by ``jax.tree_util.keystr`` paths such as
  ``['params']['tdnn_0']['kernel']``, and ``xvector.json`` with the config
  and the log-mel normalisation), read with numpy and json only;
* :func:`build_spk2xvector` / :func:`build_utt2xvector` — per-speaker means
  and per-utterance embeddings over a corpus, saved as ``.npz``;
* :func:`make_spemb_extractor` — ``fn(audio, frame_mask) -> (E,)`` for
  ``SpeechEditor(spemb_fn=...)``, pooling over the unmasked context only.

Training the network (``train_xvector``) is not ported (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn

from a3t_tpu_torch.compat.from_jax import load_state, xvector_state
from a3t_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class XVectorConfig:
    n_mels: int = 80
    channels: int = 512
    embed_dim: int = 192
    n_speakers: int = 0  # > 0 adds the classification head
    kernels: tuple = (5, 3, 3, 1, 1)
    dilations: tuple = (1, 2, 3, 1, 1)


class XVectorNet(nn.Module):
    """(B, T, n_mels) features -> ((B, embed_dim) embedding, logits or
    None).  Parameter names are the flax tree's."""

    def __init__(self, config: XVectorConfig = XVectorConfig()):
        super().__init__()
        c = self.config = config
        n = len(c.kernels)
        in_ch = c.n_mels
        for i, (k, dil) in enumerate(zip(c.kernels, c.dilations)):
            out_ch = c.channels if i < n - 1 else c.channels * 3
            # flax "SAME": (k - 1) * dil padding, the smaller half first
            setattr(self, f"tdnn_{i}", nn.Conv1d(in_ch, out_ch, k,
                                                 dilation=dil,
                                                 padding="same"))
            setattr(self, f"bn_{i}", nn.LayerNorm(out_ch, eps=1e-6))
            in_ch = out_ch
        self.embed_a = nn.Linear(2 * in_ch, c.embed_dim)
        if c.n_speakers > 0:
            self.bn_embed = nn.LayerNorm(c.embed_dim, eps=1e-6)
            self.embed_b = nn.Linear(c.embed_dim, c.embed_dim)
            self.classifier = nn.Linear(c.embed_dim, c.n_speakers)

    def forward(self, feats, frame_mask=None):
        h = feats.transpose(1, 2)
        for i in range(len(self.config.kernels)):
            h = torch.relu(getattr(self, f"tdnn_{i}")(h))
            h = getattr(self, f"bn_{i}")(h.transpose(1, 2)).transpose(1, 2)
        h = h.transpose(1, 2)  # (B, T, C)
        if frame_mask is None:
            mean = h.mean(dim=1)
            var = h.var(dim=1, unbiased=False)
        else:
            # E[h^2] - mean^2 over the valid frames (xvector.py:59-68)
            w = frame_mask.to(h.dtype)[..., None]
            denom = w.sum(dim=1) + 1e-6
            mean = (h * w).sum(dim=1) / denom
            var = (h * h * w).sum(dim=1) / denom - mean ** 2
        std = torch.sqrt(torch.clamp(var, min=1e-8))
        emb = self.embed_a(torch.cat([mean, std], dim=-1))
        logits = None
        if self.config.n_speakers > 0:
            h2 = self.bn_embed(torch.relu(emb))
            logits = self.classifier(torch.relu(self.embed_b(h2)))
        return emb, logits


def train_xvector(*args, **kwargs):
    """Training the speaker classifier (``a3t_tpu/models/xvector.py:96-236``)
    is not ported (ROADMAP A9); :func:`load_xvector` reads what it
    writes."""
    raise NotImplementedError("train_xvector is not ported (ROADMAP A9)")


def _nested(flat: dict) -> dict:
    """``{"['params']['tdnn_0']['kernel']": array}`` -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        parts = re.findall(r"\['([^']*)'\]", key)
        if "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"not a flax key path: {key!r}")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_xvector(out_dir: str, device=None):
    """A ``train_xvector`` directory -> (model in eval mode on ``device``,
    (mel_mean, mel_std)); cuda unless the caller asks for the CPU.  The
    log-mels must be normalised by that pair before the model."""
    dev = resolve_device(device)
    with open(os.path.join(out_dir, "xvector.json")) as f:
        meta = json.load(f)
    cfg = XVectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in meta["config"].items()})
    with np.load(os.path.join(out_dir, "xvector.npz")) as data:
        tree = _nested({k: data[k] for k in data.files})
    model = XVectorNet(cfg)
    load_state(model, xvector_state(tree))
    mvn = (np.asarray(meta["mel_mean"], np.float32),
           np.asarray(meta["mel_std"], np.float32))
    return model.to(dev).eval(), mvn


def save_xvector(model: XVectorNet, mel_mvn, out_dir: str) -> None:
    """Write ``model`` in :func:`load_xvector`'s format (the flax key paths
    of ``train_xvector``'s ``xvector.npz`` and its ``xvector.json``), so
    the JAX package's ``load_xvector`` reads it too."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for name, t in model.state_dict().items():
        layer, leaf = name.split(".")
        v = t.detach().cpu().numpy()
        if layer.startswith("bn_"):
            leaf = {"weight": "scale"}.get(leaf, leaf)
        elif leaf == "weight":
            leaf, v = "kernel", (v.transpose(2, 1, 0) if v.ndim == 3 else v.T)
        flat[f"['params']['{layer}']['{leaf}']"] = np.ascontiguousarray(v)
    np.savez(os.path.join(out_dir, "xvector.npz"), **flat)
    with open(os.path.join(out_dir, "xvector.json"), "w") as f:
        json.dump({"config": dataclasses.asdict(model.config),
                   "mel_mean": np.asarray(mel_mvn[0]).tolist(),
                   "mel_std": np.asarray(mel_mvn[1]).tolist(),
                   "n_mels": model.config.n_mels}, f, indent=1)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _normalise(feats, mel_mvn):
    if mel_mvn is None:
        return feats
    mean, std = (torch.as_tensor(np.asarray(a), device=feats.device)
                 for a in mel_mvn)
    return (feats - mean) / std


def build_spk2xvector(model: XVectorNet, frontend, dataset,
                      out_path: Optional[str] = None, max_frames: int = 1024,
                      mel_mvn: Optional[tuple] = None,
                      max_utts_per_speaker: Optional[int] = None
                      ) -> dict[str, np.ndarray]:
    """Per-speaker mean x-vectors over ``dataset`` (speakers from its
    ``utt2spk``, else each uid its own), one utterance per call: its audio
    zero-padded to ``max_frames`` frames, the rfft log-mels normalised by
    ``mel_mvn``, pooled over the utterance's own frames.
    ``max_utts_per_speaker`` caps each average.  Saved as ``.npz``."""
    hop = frontend.config.hop_length
    dev = _device(model)
    uids = list(dataset.uids)
    if max_utts_per_speaker is not None:
        per_spk: dict[str, int] = {}
        capped = []
        for uid in uids:
            spk = dataset.get_meta(uid).get("speaker", uid)
            if per_spk.get(spk, 0) < max_utts_per_speaker:
                per_spk[spk] = per_spk.get(spk, 0) + 1
                capped.append(uid)
        uids = capped
    sums: dict[str, np.ndarray] = {}
    counts: dict[str, int] = {}
    for uid in uids:
        item = dataset[uid]
        spk = item.get("speaker", uid)
        wav = item["audio"]
        n_f = min(1 + len(wav) // hop, max_frames)
        pad_wav = np.zeros(((max_frames - 1) * hop,), np.float32)
        n = min(len(wav), len(pad_wav))
        pad_wav[:n] = wav[:n]
        with torch.inference_mode():
            feats, _ = frontend(pad_wav[None])
            feats = _normalise(feats, mel_mvn)
            mask = torch.arange(feats.shape[1], device=dev)[None] < n_f
            emb = model(feats, mask)[0][0].cpu().numpy()
        if spk in sums:
            sums[spk] += emb
            counts[spk] += 1
        else:
            sums[spk] = emb.copy()
            counts[spk] = 1
    spk2xv = {s: sums[s] / counts[s] for s in sums}
    if out_path:
        np.savez(out_path, **spk2xv)
    return spk2xv


def load_spk2xvector(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def make_spemb_extractor(xv_dir: str, frontend):
    """``fn(audio (S,) float32, frame_mask (F,) bool) -> (E,)`` on the
    front-end's device.  Frames where ``frame_mask`` is False (padding and
    the masked edit span) are left out of the statistics pooling, so the
    embedding pools the unmasked context's frames; what reaches those
    frames through the STFT window and the TDNN's context (7 frames either
    side) stays in."""
    model, mvn = load_xvector(xv_dir, device=frontend.device)

    def fn(audio: np.ndarray, frame_mask: np.ndarray) -> np.ndarray:
        audio = np.ascontiguousarray(audio, np.float32)
        mask = torch.as_tensor(np.ascontiguousarray(frame_mask, bool)[None],
                               device=frontend.device)
        with torch.inference_mode():
            feats, _ = frontend(audio[None])
            feats = _normalise(feats, mvn)
            n_f = min(feats.shape[1], mask.shape[1])
            emb, _ = model(feats[:, :n_f], mask[:, :n_f])
        return emb[0].cpu().numpy()

    return fn


def build_utt2xvector(model: XVectorNet, frontend, dataset,
                      out_path: Optional[str] = None,
                      mel_mvn: Optional[tuple] = None, chunk: int = 32,
                      max_frames: int = 1024) -> dict[str, np.ndarray]:
    """Per-utterance x-vectors over ``dataset``, ``chunk`` utterances per
    call at one frame bucket (the longest utterance rounded up to 64
    frames, at most ``max_frames``).  Saved as ``.npz`` keyed by uid; by
    convention ``utt2xvector.npz`` in the data directory, where
    ``MLMTask`` looks first."""
    hop = frontend.config.hop_length
    dev = _device(model)
    uids = list(dataset.uids)
    bucket_f = min(max_frames, int(np.ceil(
        (1 + max(dataset.num_samples(u) for u in uids) // hop) / 64.0)) * 64)
    bucket_s = (bucket_f - 1) * hop
    out: dict[str, np.ndarray] = {}
    for c0 in range(0, len(uids), chunk):
        group = uids[c0: c0 + chunk]
        audio = np.zeros((chunk, bucket_s), np.float32)
        n_f = np.zeros(chunk, np.int32)
        for i, u in enumerate(group):
            wav = dataset[u]["audio"][:bucket_s]
            audio[i, : len(wav)] = wav
            n_f[i] = min(1 + len(wav) // hop, bucket_f)
        with torch.inference_mode():
            feats, _ = frontend(audio)
            feats = _normalise(feats, mel_mvn)
            mask = (torch.arange(feats.shape[1], device=dev)[None]
                    < torch.as_tensor(n_f, device=dev)[:, None])
            emb = model(feats[:, :bucket_f], mask[:, :bucket_f])[0]
        emb = emb.cpu().numpy()
        for i, u in enumerate(group):
            out[u] = emb[i]
    if out_path:
        np.savez(out_path, **out)
    return out
