"""The rank side of tests/test_torch_parallel.py: scenarios that each rank
of a gloo group of CPU processes runs, and the spawner that starts the
group.  Importing this module imports torch and the port only (no JAX), so
the spawned processes start quickly.

A scenario is ``fn(workdir, **kw)``; it reads its inputs from ``workdir``
and writes what the test compares to ``workdir/<tag>_r<rank>.pt``.  The
same function runs in the test's own process without a group as the
one-process reference (tag ``..._w1``).  A job names a scenario of this
module, or ``module:fn`` of another module beside it.
"""

from __future__ import annotations

import contextlib
import copy
import multiprocessing
import os
import pickle
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _entry(r: int, w: int, port: int, jobs: list, errfile: str) -> None:
    torch.set_num_threads(1)
    try:
        from a3t_tpu_torch.parallel import initialize_multihost

        initialize_multihost(f"127.0.0.1:{port}", w, r, device="cpu")
        try:
            for fn, kw in jobs:
                if ":" in fn:
                    module, fn = fn.split(":")
                    getattr(__import__(module), fn)(**kw)
                else:
                    globals()[fn](**kw)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(f"{errfile}.{r}", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, jobs: list, workdir: str, timeout: float = 300.0):
    """Run ``jobs`` ([(scenario name, kwargs)], in order) on every rank of
    a gloo group of ``world`` CPU processes; raise with the first failing
    rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    errfile = os.path.join(workdir, "rank_error")
    procs = [ctx.Process(target=_entry, args=(r, world, port, jobs, errfile))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        errs = [open(f"{errfile}.{r}").read() for r in range(world)
                if os.path.exists(f"{errfile}.{r}")]
        raise RuntimeError(f"ranks exited {codes}:\n" + "\n".join(errs))


def _out(workdir: str, tag: str) -> str:
    from a3t_tpu_torch.parallel import rank, world

    suffix = f"r{rank()}" if world() > 1 else "w1"
    return os.path.join(workdir, f"{tag}_{suffix}.pt")


def _gathered_opt(state) -> dict:
    """The optimizer's state with the moment slices gathered (every rank
    takes part), as a checkpoint holds it."""
    from a3t_tpu_torch.train.checkpoint import _state_tree

    return {k: v.clone() for k, v in _state_tree(state)["opt_state"].items()}


def _whole_model(state) -> dict:
    """The model's state with the model axis's slices gathered (every rank
    takes part), as a checkpoint holds it."""
    from a3t_tpu_torch.parallel import all_gather_state

    return {k: v.clone()
            for k, v in all_gather_state(state.model.state_dict()).items()}


def _model(config, dropout: float = 0.0):
    from a3t_tpu_torch.models import build_model

    model = build_model(config, device="cpu")
    set_dropout(model, dropout)
    return model


def set_dropout(model, rate: float) -> None:
    """Every dropout site of ``model`` at ``rate`` (the postnet's and the
    duration predictor's fixed rates too)."""
    from a3t_tpu_torch.models.dropout import SeededDropout

    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.rate = rate


def tiny_step(workdir: str, tag: str = "step", optim: dict = None):
    """One train step of the tiny model from ``init.pt`` on this rank's
    rows of ``batch.npz`` (dropout 0; ``optim`` overrides the setup's
    optimizer fields): the stats, the model's state, the gathered moments
    and the local moment length."""
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.parallel import row_block
    from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                     make_optimizer, make_train_step)

    with open(os.path.join(workdir, "setup.pkl"), "rb") as f:
        setup = pickle.load(f)
    model = _model(setup["model"])
    model.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
    state = create_train_state(model, make_optimizer(OptimConfig(
        **{**setup["optim"], **(optim or {})})), device="cpu")
    fe = LogMelFrontend(LogMelConfig(**setup["frontend"]), device="cpu")
    step = make_train_step(model, fe, device="cpu")
    with np.load(os.path.join(workdir, "batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    rows = row_block(len(batch["audio_lengths"]))
    state, stats = step(state, {k: v[rows] for k, v in batch.items()}, 0)
    torch.save({"stats": {k: v.clone() for k, v in stats.items()},
                "model": _whole_model(state),
                "opt": _gathered_opt(state),
                "local_mu": state.opt_state.mu.numel()},
               _out(workdir, tag))


def dropout_masks(workdir: str, batch_file: str):
    """The tiny model's train-mode output at dropout 0.2 on this rank's
    rows of ``batch_file`` (made equal on every rank by the test), under
    the trainer's generator of this rank's step and under the one-process
    seeds of the same step."""
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.parallel import row_block
    from a3t_tpu_torch.train.train_step import featurize
    from a3t_tpu_torch.train.trainer import (rank_step_generator,
                                             step_generator)

    with open(os.path.join(workdir, "setup.pkl"), "rb") as f:
        setup = pickle.load(f)
    model = _model(setup["model"], dropout=0.2)
    model.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
    fe = LogMelFrontend(LogMelConfig(**setup["frontend"]), device="cpu")
    with np.load(os.path.join(workdir, batch_file)) as f:
        batch = {k: f[k] for k in f.files}
    rows = row_block(len(batch["audio_lengths"]))
    mb = featurize(fe, {k: v[rows] for k, v in batch.items()})
    model.train()
    out = {}
    with torch.no_grad():
        for name, gen in (("folded", rank_step_generator(0, 1, 0)),
                          ("unfolded", step_generator(0, 1, 0))):
            before, _ = model(**mb, generator=gen)
            out[name] = before.clone()
    torch.save(out, _out(workdir, "dropout"))


class Stop(Exception):
    """Raised after the mid-epoch save that ends an interrupted run."""


def checkpoint_views(workdir: str):
    """Each rank's checkpoint manager on a directory of its own (rank 0's
    holds epoch 3), then on one shared directory: what ``latest_epoch``,
    ``check_shared`` and ``average_nbest`` (no ranked epoch) give this
    rank, and the shared directory's files after."""
    from a3t_tpu_torch.parallel import rank
    from a3t_tpu_torch.train.checkpoint import CheckpointManager
    from a3t_tpu_torch.train.reporter import Reporter

    own = CheckpointManager(os.path.join(workdir, f"views_{rank()}"))
    if rank() == 0:
        torch.save({}, os.path.join(own.directory, "epoch_3.pt"))
        with open(os.path.join(own.directory, "LATEST"), "w") as f:
            f.write("3")
    out = {"latest": own.latest_epoch()}
    try:
        own.check_shared()
        out["own"] = None
    except RuntimeError as e:
        out["own"] = str(e)
    shared = CheckpointManager(os.path.join(workdir, "views_shared"))
    shared.check_shared()
    try:
        out["average"] = shared.average_nbest(Reporter(),
                                              torch.nn.Linear(1, 1))
    except ValueError as e:
        out["average"] = str(e)
    out["shared_files"] = sorted(os.listdir(shared.directory))
    torch.save(out, _out(workdir, "views"))


@contextlib.contextmanager
def _stop_after_mid_save(at):
    from a3t_tpu_torch.train.checkpoint import CheckpointManager

    save = CheckpointManager.save_mid_epoch

    def save_then_stop(self, epoch, iteration, *a, **kw):
        save(self, epoch, iteration, *a, **kw)
        if (epoch, iteration) == tuple(at):
            raise Stop

    CheckpointManager.save_mid_epoch = save_then_stop
    try:
        yield
    finally:
        CheckpointManager.save_mid_epoch = save


def task_run(workdir: str, tag: str, config: dict, dropout=None,
             stop_at=None):
    """``MLMTask.build`` and ``Trainer.run`` of ``config`` (a config
    dict); every dropout site at ``dropout`` when given; ``stop_at``
    (epoch, iteration) ends the run after that mid-epoch save.  Writes the
    step log's losses, the history, the model's state and the gathered
    optimizer state."""
    from a3t_tpu_torch.parallel import rank, world
    from a3t_tpu_torch.tasks.config import config_from_dict
    from a3t_tpu_torch.tasks.mlm import MLMTask

    cfg = config_from_dict(copy.deepcopy(config))
    build_model = MLMTask.build_model.__func__

    def zeroed(cls, *a, **kw):
        model = build_model(cls, *a, **kw)
        if dropout is not None:
            set_dropout(model, dropout)
        return model

    MLMTask.build_model = classmethod(zeroed)
    try:
        trainer, state = MLMTask.build(cfg, device="cpu")
        stopped = False
        if stop_at is None:
            state = trainer.run(state)
        else:
            with _stop_after_mid_save(stop_at):
                try:
                    trainer.run(state)
                except Stop:
                    stopped = True
    finally:
        MLMTask.build_model = classmethod(build_model)
    batcher = getattr(trainer.train_iter_factory, "batcher", None)
    torch.save({
        # a stopped run leaves its last steps unflushed, without a loss
        "steps": [(r["epoch"], r["iteration"], r.get("loss"), r["batch"])
                  for r in trainer.step_log],
        "history": copy.deepcopy(trainer.reporter.history),
        "model": _whole_model(state),
        "opt": _gathered_opt(state),
        "local_mu": state.opt_state.mu.numel(),
        "stopped": stopped,
        "world": world(), "rank": rank(),
        "buckets": None if batcher is None else
        [(b.n_frames, b.batch_size) for b in batcher.buckets],
    }, _out(workdir, tag))
