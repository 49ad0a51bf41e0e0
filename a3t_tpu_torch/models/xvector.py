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
  ``SpeechEditor(spemb_fn=...)``, pooling over the unmasked context only;
* :func:`train_xvector` — the speaker classifier trained on a data
  directory (``wav.scp`` + ``utt2spk``) with :func:`sample_crops`'s batches
  and :func:`xvector_step` (clip 5.0 -> Adam at a constant rate), written
  by :func:`save_xvector` (``a3t_tpu/models/xvector.py:89-236``).
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


def speaker_classification_loss(logits: torch.Tensor,
                                speaker_ids: torch.Tensor):
    """(mean negative log-likelihood, accuracy) of (B, S) logits against
    (B,) speaker ids."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, speaker_ids[:, None].long())[:, 0]
    acc = (logits.argmax(-1) == speaker_ids).float().mean()
    return nll.mean(), acc


def sample_crops(items, spk_id: dict, rng: np.random.Generator,
                 batch_size: int, n_frames: int, n_mels: int):
    """One training batch ((B, n_frames, n_mels) float32 mels, (B,) int32
    speaker ids): each row a random ``(speaker, mel)`` of ``items``, tiled
    when it is not longer than ``n_frames``, cropped at a random start;
    ``rng``'s draws in JAX's order, so the batches are JAX's."""
    mel = np.zeros((batch_size, n_frames, n_mels), np.float32)
    sid = np.zeros((batch_size,), np.int32)
    for b in range(batch_size):
        spk, m = items[rng.integers(len(items))]
        if m.shape[0] <= n_frames:
            m = np.tile(m, (int(np.ceil(n_frames / max(m.shape[0], 1))), 1))
        f0 = int(rng.integers(m.shape[0] - n_frames + 1))
        mel[b] = m[f0: f0 + n_frames]
        sid[b] = spk_id[spk]
    return mel, sid


def xvector_step(model: XVectorNet, tx, opt_state, mel, sid):
    """One optimizer step of the classifier on ``mel`` (B, T, n_mels) and
    ``sid`` (B,) (host arrays or tensors); returns the loss and the
    accuracy as device tensors."""
    dev = _device(model)
    _, logits = model(torch.as_tensor(mel, device=dev))
    loss, acc = speaker_classification_loss(
        logits, torch.as_tensor(sid, device=dev))
    params = list(model.parameters())
    tx.apply(params, torch.autograd.grad(loss, params), opt_state)
    return loss.detach(), acc


def train_xvector(
    data_dir: str,
    frontend,
    out_dir: str,
    config: Optional[XVectorConfig] = None,
    crop_frames: int = 256,
    batch_size: int = 32,
    total_steps: int = 3000,
    lr: float = 1e-3,
    seed: int = 0,
    eval_data_dir: Optional[str] = None,
    log_fn=print,
    max_utts: Optional[int] = None,
):
    """Train the speaker classifier on a data directory (``wav.scp`` +
    ``utt2spk``) on ``frontend``'s device; returns (model, report) and
    writes ``xvector.npz`` and ``xvector.json`` into ``out_dir``.

    The log-mels (:func:`extract_corpus_mels`) are normalised by the
    corpus MVN; each step's crop is 1, 2 or 4 times ``crop_frames`` long,
    drawn with the crops from ``np.random.default_rng(seed)`` in JAX's
    order.  Weights start from the JAX package's initialisers seeded with
    ``seed``.  With ``eval_data_dir`` the report holds the accuracy on its
    utterances of the training speakers, each whole (padded to a multiple
    of 64 frames and masked)."""
    from a3t_tpu_torch.data.fileio import SoundScpReader, read_2column_text
    from a3t_tpu_torch.dsp.frontend import corpus_mvn, extract_corpus_mels
    from a3t_tpu_torch.models.mlm import init_parameters
    from a3t_tpu_torch.train.optim import ClipAdam

    os.makedirs(out_dir, exist_ok=True)
    dev = frontend.device

    def load_corpus(d, cap=None):
        reader = SoundScpReader(os.path.join(d, "wav.scp"))
        utt2spk = read_2column_text(os.path.join(d, "utt2spk"))
        uids = [u for u in utt2spk if u in reader]
        if cap is not None and len(uids) > cap:
            uids = list(np.random.default_rng(0).permutation(uids)[:cap])
        _, mels = extract_corpus_mels(frontend,
                                      [reader[u][1] for u in uids])
        return [(utt2spk[u], m) for u, m in zip(uids, mels)]

    train_items = load_corpus(data_dir, cap=max_utts)
    mel_mean, mel_std = corpus_mvn([m for _, m in train_items])
    train_items = [(s, (m - mel_mean) / mel_std) for s, m in train_items]
    speakers = sorted({s for s, _ in train_items})
    spk_id = {s: i for i, s in enumerate(speakers)}
    cfg = dataclasses.replace(
        config or XVectorConfig(n_mels=frontend.config.n_mels),
        n_speakers=len(speakers))
    model = XVectorNet(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(dev).train()
    tx = ClipAdam(lr, 5.0)
    opt_state = tx.init(model.parameters())
    rng = np.random.default_rng(seed)
    crop_lengths = (crop_frames, 2 * crop_frames, 4 * crop_frames)
    history = []
    for i in range(1, total_steps + 1):
        mel, sid = sample_crops(train_items, spk_id, rng, batch_size,
                                crop_lengths[int(rng.integers(3))],
                                cfg.n_mels)
        loss, acc = xvector_step(model, tx, opt_state, mel, sid)
        if i % 200 == 0 or i == total_steps:
            history.append({"step": i, "loss": round(float(loss), 4),
                            "acc": round(float(acc), 4)})
            log_fn(f"xvector step {i}/{total_steps} "
                   f"loss {float(loss):.3f} acc {float(acc):.3f}")
    model.eval()

    report = {"n_speakers": len(speakers), "speakers": speakers,
              "train_history": history}
    if eval_data_dir:
        eval_items = [(s, (m - mel_mean) / mel_std)
                      for s, m in load_corpus(eval_data_dir) if s in spk_id]
        max_f = -(-max(m.shape[0] for _, m in eval_items) // 64) * 64
        correct = 0
        with torch.inference_mode():
            for spk, m in eval_items:
                mel = torch.zeros(1, max_f, cfg.n_mels, device=dev)
                mel[0, : m.shape[0]] = torch.as_tensor(m, device=dev)
                mask = torch.arange(max_f, device=dev)[None] < m.shape[0]
                _, logits = model(mel, mask)
                correct += int(logits[0].argmax()) == spk_id[spk]
        report["eval_n"] = len(eval_items)
        report["eval_acc"] = round(correct / max(len(eval_items), 1), 4)
        log_fn(f"xvector held-out accuracy: {report['eval_acc']} "
               f"({correct}/{len(eval_items)})")
    save_xvector(model, (mel_mean, mel_std), out_dir, report)
    return model, report


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


def save_xvector(model: XVectorNet, mel_mvn, out_dir: str,
                 report: Optional[dict] = None) -> None:
    """Write ``model`` in :func:`load_xvector`'s format (the flax key paths
    of ``train_xvector``'s ``xvector.npz`` and its ``xvector.json``, which
    also holds ``report``'s entries), so the JAX package's ``load_xvector``
    reads it too."""
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
        json.dump({**(report or {}),
                   "config": dataclasses.asdict(model.config),
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
