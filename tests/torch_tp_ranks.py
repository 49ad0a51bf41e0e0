"""The rank side of tests/test_torch_tensor_parallel.py: scenarios of the
mesh's model axis that each rank of a gloo group of CPU processes runs
(spawned by ``torch_parallel_ranks.spawn`` as ``torch_tp_ranks:<fn>``).
Importing this module imports torch and the port only (no JAX).

Each scenario lays the group out as ``dp x tp`` first
(``parallel.make_mesh``), reads its inputs from ``workdir`` and writes what
the test compares to ``workdir/<tag>_r<rank>.pt``; run in the test's own
process without a group it is the one-process reference (``<tag>_w1``).
"""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch

from torch_parallel_ranks import _gathered_opt, _out, _whole_model, set_dropout


def _setup(workdir: str) -> dict:
    with open(os.path.join(workdir, "setup.pkl"), "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def recorded_masks(out: list):
    """Record every dropout keep-mask drawn inside (the byte masks of
    ``models/dropout.py`` and the attention kernels' masks of their plain
    versions: K1's, and the query-chunk draws of K3/K4, band and text), in
    draw order, as ``(site, mask)``."""
    from a3t_tpu_torch.models import dropout
    from a3t_tpu_torch.ops import banded_attention as ba
    from a3t_tpu_torch.ops import fused_attention as fa

    byte, attn = dropout.keep_mask, fa.keep_mask
    band, text = ba.band_keep, ba.text_keep

    def banded(fn):
        def drawn(*a, **kw):
            m = fn(*a, **kw)
            if kw.get("chunks") is None:  # K5's regenerated draws aside
                out.append(("banded", m.clone()))
            return m
        return drawn

    def byte_mask(*a, **kw):
        m = byte(*a, **kw)
        out.append(("byte", m.clone()))
        return m

    def attn_mask(*a, **kw):
        m = attn(*a, **kw)
        out.append(("attention", m.clone()))
        return m

    dropout.keep_mask, fa.keep_mask = byte_mask, attn_mask
    ba.band_keep, ba.text_keep = banded(band), banded(text)
    try:
        yield out
    finally:
        dropout.keep_mask, fa.keep_mask = byte, attn
        ba.band_keep, ba.text_keep = band, text


def tp_step(workdir: str, tag: str, tp: int = 1, optim: dict = None,
            model: dict = None, dropout: float = 0.0, steps: int = 1,
            masks: bool = False):
    """``steps`` train steps of the tiny model from ``init.pt`` on this
    data rank's rows of ``batch.npz`` over a mesh of ``world / tp`` x
    ``tp`` (every dropout site at ``dropout``; ``optim`` and ``model``
    override the setup's fields): each step's stats, the gathered model
    and moments, the rank's parameter count and, with ``masks``, the
    first step's keep-masks."""
    import dataclasses

    from a3t_tpu_torch.compat.from_jax import load_state
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.parallel import make_mesh, row_block
    from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                     make_optimizer, make_train_step)

    make_mesh(None, tp)
    setup = _setup(workdir)
    cfg = setup["model"]
    if model:
        cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, **model),
            decoder=dataclasses.replace(cfg.decoder, **model))
    net = build_model(cfg, device="cpu")
    set_dropout(net, dropout)
    load_state(net, torch.load(os.path.join(workdir, "init.pt")))
    state = create_train_state(net, make_optimizer(OptimConfig(
        **{**setup["optim"], **(optim or {})})), device="cpu")
    fe = LogMelFrontend(LogMelConfig(**setup["frontend"]), device="cpu")
    step = make_train_step(net, fe, device="cpu")
    with np.load(os.path.join(workdir, "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    rows = row_block(len(batch["audio_lengths"]))
    batch = {k: v[rows] for k, v in batch.items()}
    stats, drawn = [], []
    for i in range(steps):
        with (recorded_masks(drawn) if masks and i == 0
              else contextlib.nullcontext()):
            state, s = step(state, batch, i)
        stats.append({k: v.clone() for k, v in s.items()})
    torch.save({"stats": stats, "model": _whole_model(state),
                "opt": _gathered_opt(state),
                "n_params": sum(p.numel() for p in net.parameters()),
                "masks": drawn}, _out(workdir, tag))


def jax_forward(workdir: str, tp: int = 1):
    """The tiny model's eval forward on ``forward.npz`` with the JAX
    parameters of ``jax_state.pt`` carried onto this rank
    (``compat.from_jax.load_state``)."""
    from a3t_tpu_torch.compat.from_jax import load_state
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.parallel import make_mesh

    make_mesh(None, tp)
    net = build_model(_setup(workdir)["model"], device="cpu")
    load_state(net, torch.load(os.path.join(workdir, "jax_state.pt")))
    with np.load(os.path.join(workdir, "forward.npz")) as f:
        batch = {k: torch.as_tensor(f[k]) for k in f.files}
    with torch.no_grad():
        before, after = net(**batch)
    torch.save({"before": before, "after": after,
                "n_params": sum(p.numel() for p in net.parameters())},
               _out(workdir, "forward"))


def refusals(workdir: str):
    """What a group of two refuses: a mesh that does not cover it, a tp
    that does not divide the heads, FastSpeech2 and chained dispatch; the
    messages, by case (None where the build goes through: the longformer
    on the model axis)."""
    import dataclasses

    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.parallel import make_mesh
    from a3t_tpu_torch.tasks.config import config_from_dict
    from a3t_tpu_torch.tasks.fs2 import FS2Task, load_fs2_config
    from a3t_tpu_torch.tasks.mlm import MLMTask
    from a3t_tpu_torch.train.train_step import make_chained_train_step

    setup = _setup(workdir)
    out = {}

    def record(case, fn):
        try:
            fn()
            out[case] = None
        except (ValueError, NotImplementedError) as e:
            out[case] = f"{type(e).__name__}: {e}"

    record("dp x tp", lambda: make_mesh(2, 2))
    record("tp 3", lambda: make_mesh(None, 3))
    cfg = setup["model"]
    three = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, attention_heads=3, attention_dim=33))
    make_mesh(None, 2)
    record("heads", lambda: build_model(three, device="cpu"))
    lf = dict(setup["task"], model={"encoder": {
        "selfattention_layer_type": "longformer", "attention_window": 8,
        "attention_dim": 32, "attention_heads": 2, "linear_units": 32,
        "num_blocks": 1}}, mesh={"tensor_parallel": 2})
    record("longformer", lambda: MLMTask.build(config_from_dict(lf),
                                               device="cpu"))
    record("fs2", lambda: FS2Task.build(load_fs2_config(
        setup["fs2_config"], [f"exp_dir={workdir}/fs2"]), device="cpu"))
    net = build_model(cfg, device="cpu")
    fe = LogMelFrontend(LogMelConfig(**setup["frontend"]), device="cpu")
    record("chained", lambda: make_chained_train_step(net, fe, 2,
                                                      device="cpu"))
    torch.save(out, _out(workdir, "refusals"))
