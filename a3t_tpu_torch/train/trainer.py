"""The training loop: the port of ``a3t_tpu/train/trainer.py``
(reference: espnet2/train/trainer.py:94-837).

Epochs of a fixed ``num_iters_per_epoch`` steps, validation, per-epoch and
mid-epoch checkpoints, n-best retention and averaging, resume, warm start,
patience, a walltime budget, and the stop when every step of an epoch had
non-finite gradients.  Two points keep the host from pacing the card:

* a step's statistics stay device tensors until a ``log_interval``
  boundary or the epoch's end, where the pending steps' statistics reach
  the host in one copy (the JAX trainer's ``_register_pending``); the only
  other read of the device is the non-finite count, once per epoch;
* each step's dropout generator is seeded from (seed, epoch, iteration)
  alone, so a run resumed mid-epoch, which skips iterations without
  stepping, draws the masks an uninterrupted run draws.  (The JAX trainer
  splits ``PRNGKey(seed + epoch)`` once per step for the same property.)

On the card each step is bracketed by two CUDA events, read at the same
flushes: ``Trainer.step_log`` keeps, per step, the batch's shape, the wait
for the batch on the host (the reporter's ``iter`` time), the host's time
in the step call, the step's time on the device's clock and, within an
epoch, the device's clock from the previous step's end to this step's
start (what the device waited between steps).

With ``steps_per_dispatch = k > 1`` the iterator yields chained groups
``("chained", stacked, valid, weights)`` and the train step takes k
sub-steps per call (``train_step.make_chained_train_step``): each valid
sub-step registers its own statistics, weighted by ``weights[i]``, and
counts as a step of the epoch; sub-step i of a group that starts at step
n draws its dropout from ``step_generator(seed, epoch, n + i)``, so a
mid-epoch resume, which saves and skips whole groups, lands on a group's
edge.  A step-log record then covers the group (``steps`` sub-steps).  A
mid-epoch checkpoint records k; one saved under another k is not resumed
(the run keeps its epoch restore, with a warning).  Batches of the
multi-corpus factory come as ``(corpus name, batch)``.  ``plot_fn(state,
epoch)``, when given, runs after each epoch's validation (the per-epoch
plots of ``train/plots.py``); an exception in it is logged, not raised, as
in JAX: plots must never stop training.

Over the W ranks of the data axis (``parallel/``) every rank runs this
loop on its row blocks of the same plan: a step's dropout generator also
folds in the data rank (ranks must not draw one mask for different rows;
W = 1 keeps the seeds above), while the tp ranks of one data rank draw the
same seeds, as their replicated activations must stay equal, the
statistics and the validation loss are the
global batch's on every rank, the decisions taken before a collective (the
non-finite stop, early stopping, the walltime budget) are rank 0's, and
the checkpoint manager gathers the moments and writes on rank 0.  The
task gives tensorboard, wandb and ``plot_fn`` to rank 0 alone; rank 0
alone writes the profile.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import subprocess
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from a3t_tpu_torch.parallel.mesh import agree, data_rank, data_world, rank
from a3t_tpu_torch.train.checkpoint import CheckpointManager, warm_start_params
from a3t_tpu_torch.train.reporter import Reporter

logger = logging.getLogger("a3t_tpu_torch")
STEP_LOG_LEN = 10_000


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's ``TrainerConfig`` field for field."""

    max_epoch: int = 1500
    num_iters_per_epoch: Optional[int] = 800
    keep_nbest_models: int = 5
    best_model_criterion: tuple = ("valid", "loss", "min")
    patience: Optional[int] = None
    log_interval: int = 50
    seed: int = 0
    resume: bool = True
    average_nbest_at_end: bool = True
    # write a torch.profiler trace of iters [10, 15) of epoch 1 here
    profile_dir: Optional[str] = None
    # extra mid-epoch full-state checkpoints (preemption safety)
    save_interval_steps: Optional[int] = None
    # when less budget remains than the longest epoch: stop after the
    # epoch's checkpoint and run resubmit_command (reference
    # trainer.py:179-198, 459-475)
    max_walltime_sec: Optional[float] = None
    resubmit_command: Optional[str] = None
    # warm start, when there is nothing to resume, from the parameters of
    # a port checkpoint file (ave_*.pt, epoch_N.pt) or a bin.export_params
    # directory (the reference's --init_param)
    init_params_dir: Optional[str] = None
    init_params_grow_vocab: bool = False
    init_params_allow_missing: bool = False
    # optimizer steps per call of the train step (chained groups of
    # same-bucket batches); num_iters, log and save intervals stay in steps
    steps_per_dispatch: int = 1


def step_generator(seed: int, epoch: int, iteration: int,
                   rank: Optional[int] = None) -> torch.Generator:
    """The dropout generator of step ``iteration`` (0-based) of ``epoch``;
    with ``rank`` (world size > 1) that rank's."""
    key = [seed, epoch, iteration] + ([] if rank is None else [rank])
    s = np.random.SeedSequence(key).generate_state(2)
    return torch.Generator().manual_seed(int(s[0]) << 32 | int(s[1]))


def rank_step_generator(seed: int, epoch: int,
                        iteration: int) -> torch.Generator:
    """This process's dropout generator of a step: over W > 1 data ranks
    its data rank is folded in, so that ranks draw their own masks for
    their rows; the seq and model axes' ranks of one data rank draw the
    same seeds (each keeps its rows and columns of the whole draws), and
    dp = 1 keeps :func:`step_generator`'s seeds."""
    return step_generator(seed, epoch, iteration,
                          data_rank() if data_world() > 1 else None)


def _chained(batch) -> bool:
    return (isinstance(batch, tuple) and len(batch) == 4
            and batch[0] == "chained")


def batch_shape(batch) -> tuple[int, int]:
    """(batch size, frames) of an A3T batch, of a multi-corpus ``(name,
    batch)`` pair or of a chained group's batches."""
    if isinstance(batch, tuple):
        batch = batch[1]
    b, f = batch["masked_position"].shape[-2:]
    return int(b), int(f)


class Trainer:
    """Drives train/valid epochs over iterator factories
    (``factory(epoch) -> iterable of batches``, reseeded per epoch).
    ``batch_shape(batch) -> (batch size, frames)`` weighs each step's
    statistics and fills the step log (``batch_shape`` for A3T batches);
    a chained group's sub-steps are weighted by the group's ``weights``."""

    def __init__(
        self,
        config: TrainerConfig,
        train_step: Callable,
        eval_step: Optional[Callable],
        train_iter_factory: Callable[[int], Iterable],
        valid_iter_factory: Optional[Callable[[int], Iterable]] = None,
        checkpoint_manager: Optional[CheckpointManager] = None,
        tensorboard_writer=None,
        wandb_run=None,
        batch_shape: Callable = batch_shape,
        plot_fn: Optional[Callable] = None,
    ):
        self.config = config
        self.train_step = train_step
        self.eval_step = eval_step
        self.train_iter_factory = train_iter_factory
        self.valid_iter_factory = valid_iter_factory
        self.ckpt = checkpoint_manager
        self.batch_shape = batch_shape
        self.plot_fn = plot_fn
        self.reporter = Reporter()
        self.tb = tensorboard_writer
        self.wandb = wandb_run
        self._last_epoch_steps = 0
        # the last STEP_LOG_LEN steps: epoch, iteration, batch, frames,
        # iter_wait_s, host_s, loss and (on the card) device_ms, gap_ms
        self.step_log: collections.deque = collections.deque(
            maxlen=STEP_LOG_LEN)

    def run(self, state):
        cfg = self.config
        start_epoch, skip_iters = 1, 0
        if self.ckpt is not None:
            self.ckpt.check_shared()
        if cfg.resume and self.ckpt is not None:
            latest = self.ckpt.latest_epoch()
            if latest is not None:
                state = self.ckpt.restore(latest, state)
                self.ckpt.restore_reporter(self.reporter, up_to_epoch=latest)
                start_epoch = latest + 1
                logger.info("resumed from epoch %d", latest)
            mid = self.ckpt.latest_mid_epoch()
            if mid is not None and mid[0] >= start_epoch:
                try:
                    state, start_epoch, skip_iters = \
                        self.ckpt.restore_mid_epoch(
                            state, self.reporter,
                            steps_per_dispatch=cfg.steps_per_dispatch)
                    logger.info("resumed mid-epoch %d at iter %d",
                                start_epoch, skip_iters)
                except ValueError as e:
                    # saved under another steps_per_dispatch: the replay
                    # cannot reach its step, so the epoch restore stands
                    logger.warning("%s", e)
        if cfg.init_params_dir and start_epoch == 1 and skip_iters == 0:
            warm_start_params(state.model, cfg.init_params_dir,
                              grow_vocab=cfg.init_params_grow_vocab,
                              allow_missing=cfg.init_params_allow_missing)
            logger.info("warm-started params from %s", cfg.init_params_dir)

        run_t0 = time.perf_counter()
        max_epoch_sec = 0.0
        notfinite = int(state.opt_state.total_notfinite)
        for epoch in range(start_epoch, cfg.max_epoch + 1):
            epoch_t0 = time.perf_counter()
            self.reporter.start_epoch(epoch)
            state = self.train_one_epoch(state, epoch, skip_iters)
            skip_iters = 0
            # the one read of the device per epoch besides the statistics
            before, notfinite = notfinite, int(state.opt_state.total_notfinite)
            if agree(self._last_epoch_steps > 0
                     and notfinite - before >= self._last_epoch_steps):
                logger.warning(
                    "the gradients at all %d steps of epoch %d were "
                    "non-finite — something is wrong; stopping training",
                    self._last_epoch_steps, epoch)
                break
            if self.valid_iter_factory is not None and self.eval_step:
                self.validate_one_epoch(state, epoch)
            if self.plot_fn is not None:
                try:
                    self.plot_fn(state, epoch)
                except Exception:  # plots must never kill training
                    logger.exception("plot_fn failed at epoch %d", epoch)
            self.reporter.finish_epoch(self.tb, self.wandb)
            logger.info(self.reporter.log_message())
            if self.ckpt is not None:
                self.ckpt.save_epoch(epoch, state, self.reporter)
                self.ckpt.clear_mid_epoch()

            phase, key, mode = cfg.best_model_criterion
            if cfg.patience is not None and agree(
                    self.reporter.check_early_stopping(cfg.patience, phase,
                                                       key, mode)):
                logger.info("early stopping at epoch %d", epoch)
                break
            max_epoch_sec = max(max_epoch_sec, time.perf_counter() - epoch_t0)
            if cfg.max_walltime_sec is not None:
                remaining = cfg.max_walltime_sec - (
                    time.perf_counter() - run_t0)
                # rank 0's clock decides for every rank
                if agree(remaining < max_epoch_sec
                         and epoch < cfg.max_epoch):
                    logger.info(
                        "walltime: %.0fs remain < longest epoch %.0fs — "
                        "stopping for resubmission after epoch %d",
                        remaining, max_epoch_sec, epoch)
                    if cfg.resubmit_command and rank() == 0:
                        subprocess.Popen(cfg.resubmit_command, shell=True,
                                         start_new_session=True)
                        logger.info("resubmitted: %s", cfg.resubmit_command)
                    break

        if (cfg.average_nbest_at_end and self.ckpt is not None
                and self.reporter.history):
            try:
                self.ckpt.average_nbest(self.reporter, state.model)
            except ValueError as e:  # no ranked epoch has a checkpoint
                logger.warning("no n-best average: %s", e)
        return state

    def _flush(self, sub, pending: list) -> float:
        """Register the pending steps' statistics (one device-to-host copy)
        and their device times; returns the last step's loss.  An entry is
        (stats, weights, valid, rec): a step's scalar statistics with
        ``valid`` None, or a chained group's stacked ones, of which the
        valid sub-steps register."""
        if not pending:
            return float("nan")
        keys = list(pending[0][0])
        host = torch.cat([
            torch.stack([s[k].detach().float().reshape(-1) for k in keys], 1)
            for s, _, _, _ in pending]).cpu().numpy()
        row = 0
        last = float("nan")
        for _, weights, valid, rec in pending:
            n = 1 if valid is None else len(valid)
            for i in range(n):
                if valid is None or valid[i]:
                    w = weights if valid is None else float(weights[i])
                    sub.register(dict(zip(keys, host[row + i])), weight=w)
                    last = float(host[row + i][keys.index("loss")])
            row += n
            rec["loss"] = last
            events = rec.pop("events", None)
            if events is not None:
                rec["device_ms"] = events[0].elapsed_time(events[1])
                sub.register_time("device_step", rec["device_ms"] / 1e3)
                prev_end = rec.pop("prev_end")
                if prev_end is not None:
                    rec["gap_ms"] = prev_end.elapsed_time(events[0])
        pending.clear()
        return last

    def train_one_epoch(self, state, epoch: int, skip_iters: int = 0):
        cfg = self.config
        sub = self.reporter.phase("train")
        on_cuda = next(state.model.parameters()).is_cuda
        pending: list = []
        self._last_epoch_steps = 0
        steps_done = last_saved = last_logged = 0
        prof = prev_end = None
        iterator = self.train_iter_factory(epoch)
        t_last = time.perf_counter()
        try:
            for it, batch in enumerate(iterator):
                if (cfg.num_iters_per_epoch is not None
                        and steps_done >= cfg.num_iters_per_epoch):
                    break
                valid = batch[2] if _chained(batch) else None
                n_steps = 1 if valid is None else int(np.sum(valid))
                if steps_done < skip_iters:
                    # mid-epoch resume: replay the epoch-seeded stream
                    # without stepping (a chained run saves and skips
                    # whole groups)
                    steps_done += n_steps
                    t_last = time.perf_counter()
                    continue
                if cfg.profile_dir and epoch == 1 and rank() == 0:
                    if it == 10:
                        prof = torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            *([torch.profiler.ProfilerActivity.CUDA]
                              if on_cuda else [])])
                        prof.start()
                    elif it == 15 and prof is not None:
                        self._stop_profile(prof)
                        prof = None
                t0 = time.perf_counter()
                sub.register_time("iter", t0 - t_last)
                b, f = self.batch_shape(batch)
                rec = {"epoch": epoch, "iteration": steps_done, "batch": b,
                       "frames": f, "iter_wait_s": t0 - t_last}
                if isinstance(batch, tuple) and not _chained(batch):
                    rec["corpus"] = batch[0]
                if on_cuda:
                    rec["events"] = [torch.cuda.Event(enable_timing=True)
                                     for _ in range(2)]
                    rec["events"][0].record()
                    rec["prev_end"], prev_end = prev_end, rec["events"][1]
                if valid is None:
                    state, stats = self.train_step(
                        state, batch, rank_step_generator(cfg.seed, epoch,
                                                          steps_done))
                    weights = float(b)
                else:
                    _, stacked, valid, weights = batch
                    rec["steps"] = n_steps
                    state, stats = self.train_step(state, stacked, [
                        step_generator(cfg.seed, epoch, steps_done + i)
                        for i in range(len(valid))], valid)
                if on_cuda:
                    rec["events"][1].record()
                steps_done += n_steps
                self._last_epoch_steps += n_steps
                self.step_log.append(rec)
                pending.append((stats, weights, valid, rec))
                t_last = time.perf_counter()
                rec["host_s"] = t_last - t0
                # per optimizer step, also for a chained group
                sub.register_time("step", (t_last - t0) / max(n_steps, 1))
                if (cfg.save_interval_steps and self.ckpt is not None
                        and steps_done - last_saved
                        >= cfg.save_interval_steps):
                    self.ckpt.save_mid_epoch(
                        epoch, steps_done, state, self.reporter,
                        steps_per_dispatch=cfg.steps_per_dispatch)
                    last_saved = steps_done
                if steps_done - last_logged >= cfg.log_interval:
                    last_logged = steps_done
                    loss = self._flush(sub, pending)
                    logger.info(
                        "epoch %d iter %d: loss=%.4f (%.0f ms/step host, "
                        "%.0f ms iter wait)%s", epoch, steps_done, loss,
                        1e3 * np.mean(sub._timings["step"][-cfg.log_interval:]),
                        1e3 * np.mean(sub._timings["iter"][-cfg.log_interval:]),
                        self._pipe_line(iterator))
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
            if prof is not None:
                self._stop_profile(prof)
        self._flush(sub, pending)
        return state

    def _stop_profile(self, prof) -> None:
        prof.stop()
        os.makedirs(self.config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.profile_dir,
                                              "trace.json"))

    @staticmethod
    def _pipe_line(iterator) -> str:
        """The producer's per-batch split: gen = host batch assembly, put =
        the copy to the device, qfull = waiting on the consumer (healthy)."""
        n = getattr(iterator, "n_produced", 0)
        if not n:
            return ""
        return " pipe[gen %.0f put %.0f qfull %.0f ms/b]" % (
            1e3 * iterator.t_gen / n, 1e3 * iterator.t_transform / n,
            1e3 * iterator.t_qfull / n)

    def validate_one_epoch(self, state, epoch: int):
        sub = self.reporter.phase("valid")
        pending = []
        for batch in self.valid_iter_factory(epoch):
            pending.append((self.eval_step(state, batch),
                            float(self.batch_shape(batch)[0]), None, {}))
        self._flush(sub, pending)
