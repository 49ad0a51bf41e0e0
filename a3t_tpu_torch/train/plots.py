"""Validation-time plots (``a3t_tpu/train/plots.py``): target against
reconstructed mels with the masked span marked, and per-layer attention
maps (the reference's att_ws plots, trainer.py:764+).

Each plot is split in two: the arrays, computed on the model's device in
eval mode from one fixed validation batch (no dropout, nothing drawn from
the training generator), and the rendering, which moves them to the host
and imports matplotlib inside the function, as JAX does: matplotlib is not
a dependency of the port.  Where it is not installed the plot functions
compute their arrays and log that nothing was rendered (JAX's raise
ImportError, which its trainer logs).  A plot function ``plot_fn(state,
epoch)`` returns its arrays, so a caller can read them.

The fused attention kernels never materialise the probabilities, so the
attention plot's forward runs every rel-pos attention through its plain
branch (JAX's plot model turns its kernels off, tasks/mlm.py:357-368) and
captures each module's (B, H, T1, T2) float32 probabilities; afterwards
the modules take their kernels again.  Windowed (longformer) attention
captures nothing, and the plot is skipped with a log line (plots.py:111-117).

On the mesh's model axis (``parallel/``) every rank of a model group runs
the plot's forward, whose all-reduces it takes part in; the attention maps
are gathered from the group's ranks into every head's, and one rank
renders (``render=False`` on the others).  On the seq axis the forward
takes no seq layout: each seq rank of data rank 0 runs it on the whole
frames, so the maps and outputs are one process's.
"""

from __future__ import annotations

import contextlib
import logging
import os

import numpy as np
import torch

from a3t_tpu_torch.models.attention import (MultiHeadedAttention,
                                            RelPositionMultiHeadedAttention)
from a3t_tpu_torch.parallel.mesh import model_group, model_world
from a3t_tpu_torch.train.train_step import featurize

logger = logging.getLogger("a3t_tpu_torch")


def _host(batch: dict) -> dict:
    """A host copy of a batch (numpy arrays or tensors on any device)."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.array(v) for k, v in batch.items()}


@contextlib.contextmanager
def _eval(model):
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was)


def mel_plot_arrays(model, frontend, normalizer, batch: dict):
    """(target, reconstruction, masked, valid) on the model's device: the
    rfft front-end's features (JAX's ``use_fused=False``), the postnet's
    output (the decoder's without a postnet), the masked positions and the
    valid frames."""
    with _eval(model):
        mb = featurize(frontend, batch, use_fused=False,
                       normalizer=normalizer)
        before, after = model(**mb)
    return (mb["speech"], after if after is not None else before,
            mb["masked_position"], mb["speech_mask"])


@contextlib.contextmanager
def capture_attention(model):
    """Within this context every attention module of ``model`` that has a
    plain branch takes it and appends ``(module name, probabilities)`` to
    the yielded list; the flash flags and the capture are undone on exit."""
    entries: list = []
    mods = [(name, m) for name, m in model.named_modules()
            if isinstance(m, MultiHeadedAttention)]
    flash = {m: m.use_flash for _, m in mods
             if isinstance(m, RelPositionMultiHeadedAttention)}
    for name, m in mods:
        m.capture = (lambda a, name=name: entries.append((name, a)))
        if m in flash:
            m.use_flash = False
    try:
        yield entries
    finally:
        for _, m in mods:
            m.capture = None
            if m in flash:
                m.use_flash = flash[m]


def attention_plot_arrays(model, frontend, normalizer, batch: dict) -> list:
    """[(module name, (B, H, T1, T2) probabilities on the device)] of an
    eval forward through the plain attention; empty for a model whose
    attention materialises no probabilities (windowed attention).  On the
    model axis each module's heads are gathered from the model group's
    ranks (a collective of the group)."""
    with capture_attention(model) as entries, _eval(model):
        if any(isinstance(m, MultiHeadedAttention) for m in model.modules()):
            model(**featurize(frontend, batch, use_fused=False,
                              normalizer=normalizer))
    tp = model_world()
    if tp > 1:
        import torch.distributed as dist

        for i, (name, a) in enumerate(entries):
            parts = [torch.empty_like(a) for _ in range(tp)]
            dist.all_gather(parts, a.contiguous(), group=model_group())
            entries[i] = (name, torch.cat(parts, dim=1))
    return entries


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _render(fn, *args) -> None:
    """``fn(*args)``, or a log line where matplotlib is not installed: the
    arrays are computed either way."""
    try:
        fn(*args)
    except ImportError as e:
        logger.warning("plots not rendered: %s", e)


def render_mel(arrays, out_dir: str, epoch: int, n_examples: int) -> None:
    plt = _pyplot()
    target, pred, masked, valid = (a.cpu().numpy() for a in arrays)
    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(n_examples, target.shape[0])):
        n_f = int(valid[i].sum())
        fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
        for ax, mel, title in zip(axes, (target[i, :n_f], pred[i, :n_f]),
                                  ("target", "reconstruction")):
            ax.imshow(mel.T, origin="lower", aspect="auto",
                      interpolation="none")
            ax.set_ylabel(title)
        for t in np.nonzero(masked[i, :n_f])[0]:  # the masked span(s)
            for ax in axes:
                ax.axvline(t, color="w", alpha=0.04)
        fig.suptitle(f"epoch {epoch} utt {i}")
        fig.savefig(os.path.join(out_dir, f"epoch{epoch}_utt{i}.png"),
                    dpi=80)
        plt.close(fig)


def render_attention(entries, out_dir: str, epoch: int,
                     n_examples: int) -> None:
    plt = _pyplot()
    entries = [(name, a.cpu().numpy()) for name, a in entries]
    os.makedirs(out_dir, exist_ok=True)
    n_l = len(entries)
    n_h = max(a.shape[1] for _, a in entries)
    for i in range(min(n_examples, entries[0][1].shape[0])):
        fig, axes = plt.subplots(n_l, n_h, figsize=(3 * n_h, 2.4 * n_l),
                                 squeeze=False)
        for li, (name, a) in enumerate(entries):
            for h in range(a.shape[1]):
                ax = axes[li][h]
                ax.imshow(a[i, h], origin="upper", aspect="auto",
                          interpolation="none", cmap="viridis")
                if h == 0:
                    ax.set_ylabel(name[-24:], fontsize=6)
                ax.set_title(f"head {h}", fontsize=6)
                ax.tick_params(labelsize=5)
        fig.suptitle(f"epoch {epoch} utt {i} attention")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"att_epoch{epoch}_utt{i}.png"),
                    dpi=70)
        plt.close(fig)


def make_mel_plot_fn(frontend, normalizer, batch: dict, out_dir: str,
                     n_examples: int = 3, render: bool = True):
    """plot_fn(state, epoch): the first ``n_examples`` utterances of a
    fixed validation batch, target against reconstruction; returns the
    arrays (rendered unless ``render`` is False)."""
    batch = _host(batch)

    def plot_fn(state, epoch: int):
        arrays = mel_plot_arrays(state.model, frontend, normalizer, batch)
        if render:
            _render(render_mel, arrays, out_dir, epoch, n_examples)
        return arrays

    return plot_fn


def make_attention_plot_fn(frontend, normalizer, batch: dict, out_dir: str,
                           n_examples: int = 1, render: bool = True):
    """plot_fn(state, epoch): per-layer attention maps of the first
    ``n_examples`` utterances (the batch is cut before the forward, so the
    captured probabilities stay small); returns the captured entries
    (rendered unless ``render`` is False)."""
    batch = {k: v[:n_examples] for k, v in _host(batch).items()}

    def plot_fn(state, epoch: int):
        entries = attention_plot_arrays(state.model, frontend, normalizer,
                                        batch)
        if not entries:
            logger.info("no attention probabilities captured; skipping "
                        "attention plots")
            return entries
        if render:
            _render(render_attention, entries, out_dir, epoch, n_examples)
        return entries

    return plot_fn
