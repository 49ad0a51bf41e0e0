"""The rank side of tests/test_torch_seq_parallel.py: scenarios of the
mesh's seq axis that each rank of a gloo group of CPU processes runs
(spawned by ``torch_parallel_ranks.spawn`` as ``torch_sp_ranks:<fn>``).
Importing this module imports torch and the port only (no JAX).

Each scenario lays the group out as ``dp x sp x tp`` first
(``parallel.make_mesh``), reads its inputs from ``workdir`` and writes what
the test compares to ``workdir/<tag>_r<rank>.pt``; run in the test's own
process without a group it is the one-process reference (``<tag>_w1``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from torch_parallel_ranks import _gathered_opt, _out, _whole_model, set_dropout
from torch_tp_ranks import _setup, recorded_masks


def _batch(workdir: str, name: str) -> dict:
    from a3t_tpu_torch.parallel import row_block

    with np.load(os.path.join(workdir, name)) as f:
        batch = {k: f[k] for k in f.files}
    rows = row_block(len(batch["audio_lengths"]))
    return {k: v[rows] for k, v in batch.items()}


def sp_step(workdir: str, tag: str, sp: int = 1, tp: int = 1,
            optim: dict = None, model: dict = None, dropout: float = 0.0,
            steps: int = 1, masks: bool = False, tts: bool = False,
            batch: str = "batch.npz"):
    """``steps`` train steps of the tiny model from ``init.pt`` (``tts``:
    the duration-aware variant from ``tts_init.pt`` on ``tts_batch.npz``)
    on this data rank's rows of ``batch`` over a mesh of ``world / (sp *
    tp)`` x ``sp`` x ``tp`` (every dropout site at ``dropout``; ``optim``
    and ``model`` override the setup's fields), then the eval step on the
    same rows: each step's stats, the eval loss, the gathered model and
    moments, the rank's place on the seq and model axes and, with
    ``masks``, the first step's keep-masks."""
    from a3t_tpu_torch.compat.from_jax import load_state
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.parallel import make_mesh
    from a3t_tpu_torch.parallel.mesh import (model_rank, model_world,
                                             seq_rank, seq_world)
    from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                     make_optimizer, make_train_step)
    from a3t_tpu_torch.train.train_step import (make_eval_step,
                                                make_tts_train_step)

    make_mesh(None, tp, sp)
    setup = _setup(workdir)
    cfg = setup["tts_model" if tts else "model"]
    if model:
        cfg = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, **model),
            decoder=dataclasses.replace(cfg.decoder, **model))
    net = build_model(cfg, device="cpu")
    set_dropout(net, dropout)
    load_state(net, torch.load(os.path.join(
        workdir, "tts_init.pt" if tts else "init.pt")))
    state = create_train_state(net, make_optimizer(OptimConfig(
        **{**setup["tts_optim" if tts else "optim"], **(optim or {})})),
        device="cpu")
    fe = LogMelFrontend(LogMelConfig(
        **setup["tts_frontend" if tts else "frontend"]), device="cpu")
    step = (make_tts_train_step(net, fe, device="cpu") if tts
            else make_train_step(net, fe, device="cpu"))
    batch = _batch(workdir, "tts_batch.npz" if tts else batch)
    stats, drawn = [], []
    for i in range(steps):
        with (recorded_masks(drawn) if masks and i == 0
              else contextlib.nullcontext()):
            state, s = step(state, batch, i)
        stats.append({k: v.clone() for k, v in s.items()})
    ev = None
    if not tts:
        ev = make_eval_step(net, fe, device="cpu")(state, batch)["loss"]
    torch.save({"stats": stats, "eval": ev, "model": _whole_model(state),
                "opt": _gathered_opt(state), "masks": drawn,
                "seq": (seq_rank(), seq_world()),
                "model_axis": (model_rank(), model_world())},
               _out(workdir, tag))


def refusals(workdir: str):
    """What a group of two refuses: a frame bucket that does not split
    over the seq axis, a mesh that does not cover the group, a longformer
    whose frame buckets are not multiples of its half-window, FastSpeech2
    and chained dispatch; the messages, by case (None where the build goes
    through: the longformer on the seq and model axes, also where a rank's
    block is part of a chunk)."""
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.parallel import make_mesh
    from a3t_tpu_torch.tasks.config import config_from_dict
    from a3t_tpu_torch.tasks.fs2 import FS2Task, load_fs2_config
    from a3t_tpu_torch.tasks.mlm import MLMTask
    from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                     make_optimizer, make_train_step)
    from a3t_tpu_torch.train.train_step import make_chained_train_step

    setup = _setup(workdir)
    out = {}

    def record(case, fn):
        try:
            fn()
            out[case] = None
        except (ValueError, NotImplementedError) as e:
            out[case] = f"{type(e).__name__}: {e}"

    record("dp x sp x tp", lambda: make_mesh(2, 1, 2))
    record("sp 3", lambda: make_mesh(None, 1, 3))
    for axis in ("sequence_parallel", "tensor_parallel"):
        lf = dict(setup["task"], model={"encoder": {
            "selfattention_layer_type": "longformer", "attention_window": 8,
            "attention_dim": 32, "attention_heads": 2, "linear_units": 32,
            "num_blocks": 1}}, mesh={axis: 2})
        record(f"longformer {axis}", lambda: MLMTask.build(
            config_from_dict(lf), device="cpu"))
    # half-window 128: the 256-frame bucket is 128 frames a rank, the
    # 128-frame bucket 64, part of a chunk; half-window 256: the 128-frame
    # bucket is not a multiple of it
    for case, window in (("longformer block", 256),
                         ("longformer bucket", 512)):
        lf = dict(setup["task"], model={"encoder": {
            "selfattention_layer_type": "longformer",
            "attention_window": window, "attention_dim": 32,
            "attention_heads": 2, "linear_units": 32, "num_blocks": 1}},
            mesh={"sequence_parallel": 2})
        record(case, lambda: MLMTask.build(config_from_dict(lf),
                                           device="cpu"))
    make_mesh(None, 1, 2)
    record("fs2", lambda: FS2Task.build(load_fs2_config(
        setup["fs2_config"], [f"exp_dir={workdir}/fs2"]), device="cpu"))
    net = build_model(setup["model"], device="cpu")
    fe = LogMelFrontend(LogMelConfig(**setup["frontend"]), device="cpu")
    record("chained", lambda: make_chained_train_step(net, fe, 2,
                                                      device="cpu"))
    state = create_train_state(net, make_optimizer(OptimConfig(
        **setup["optim"])), device="cpu")
    odd = _batch(workdir, "odd_batch.npz")  # 41 frames over sp = 2
    record("bucket", lambda: make_train_step(net, fe, device="cpu")(
        state, odd, 0))
    torch.save(out, _out(workdir, "refusals"))
