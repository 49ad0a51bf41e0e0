"""Checkpoints with the reference's retention semantics: the port of
``a3t_tpu/train/checkpoint.py`` (reference trainer.py:366-443,
main_funcs/average_nbest_models.py).

A checkpoint directory holds

* ``epoch_<n>.pt`` — the full training state after epoch n: the step, the
  model's ``state_dict`` (its parameters and the BatchNorm running
  statistics) and the optimizer's ``OptState`` tensors, written with
  ``torch.save``;
* ``step_e<n>_i<k>.pt`` — the same, mid-epoch (preemption safety);
* ``ave_<n>best.pt`` — ``{"params": ...}``, the mean of the n best epochs'
  parameters;
* ``meta.json`` / ``meta_step.json`` — the reporter's history as JSON, and
  ``LATEST``, the newest epoch.

The format is the port's own; the port writes no orbax.  Every file is
written to a temporary name and moved into place with ``os.replace``, so a
crash never leaves half a checkpoint under a checkpoint's name.  The JAX
package's orbax checkpoints are read (``compat/orbax.py``): by
:func:`load_params` and :func:`warm_start_params` (a params-only stash, an
``ave_*`` export or an epoch checkpoint) and by :func:`experiment_state` (a
JAX experiment's ``checkpoints/``).

Over the ranks of the mesh (``parallel/``) the files do not depend on its
layout ``(dp, sp, tp)``: every rank takes part in gathering the model
axis's slices of the parameters into whole tensors and the optimizer's
moment slices (``mu``, ``nu``, ``acc_grads``, sliced over the data and
model axes; the seq axis's ranks hold their data rank's) into whole
vectors in one process's order, rank 0 alone writes the same files one
process writes, and every rank waits at a barrier before it goes on.  A
restore reads the whole state on every rank and keeps each rank's slices,
so a checkpoint written at one layout resumes at another.  Every rank
must therefore see the directory rank 0 writes (``exp_dir`` on a file
system the machines share), which :meth:`CheckpointManager.check_shared`
verifies; where to resume and which epochs to average are rank 0's
decisions.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Optional

import torch

from a3t_tpu_torch.compat.from_jax import mlm_state
from a3t_tpu_torch.compat.orbax import is_orbax_checkpoint, restore_portable
from a3t_tpu_torch.parallel.mesh import agree, barrier, every, rank, world
from a3t_tpu_torch.parallel.sharding import (FlatLayout, all_gather_flat,
                                             all_gather_flat_model,
                                             all_gather_state, shard_flat,
                                             shard_state)
from a3t_tpu_torch.train.optim import SHARDED_FIELDS, OptState
from a3t_tpu_torch.train.reporter import Reporter

logger = logging.getLogger("a3t_tpu_torch")


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _save(obj, path: str) -> None:
    _write_atomic(path, lambda tmp: torch.save(obj, tmp))


def _save_text(text: str, path: str) -> None:
    def write(tmp):
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)

    _write_atomic(path, write)


def _state_tree(state) -> dict:
    """The state's tree, the model's slices gathered into whole tensors and
    each moment slice into its whole vector (a collective: every rank
    calls this)."""
    os_ = state.opt_state
    layout = FlatLayout.of(state.model)

    def whole(k):
        v = getattr(os_, k)
        if k not in SHARDED_FIELDS or not v.numel():
            return v
        return all_gather_flat_model(all_gather_flat(v, layout.n_local),
                                     layout)

    return {"step": state.step,
            "model": all_gather_state(state.model.state_dict()),
            "opt_state": {k: whole(k) for k in OptState.__dataclass_fields__}}


def _load_into(state, tree: dict):
    """Restore ``tree`` into the live TrainState ``state`` (in place),
    keeping each tensor's device and this rank's slices of the model and
    of each moment."""
    layout = FlatLayout.of(state.model)
    state.model.load_state_dict(
        shard_state(tree["model"], layout.t, layout.tp), strict=True)
    os_ = state.opt_state
    for k, v in tree["opt_state"].items():
        old = getattr(os_, k)
        if k in SHARDED_FIELDS and v.numel():
            v = shard_flat(layout.local_of(v))
        setattr(os_, k, v.to(device=old.device, dtype=old.dtype))
    state.step = int(tree["step"])
    return state


def _read(path: str, device="cpu"):
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_nbest: int = 5,
                 criterion=("valid", "loss", "min")):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_nbest = keep_nbest
        self.criterion = tuple(criterion)

    def check_shared(self):
        """Over several ranks, raise on every rank unless every rank sees
        the file rank 0 writes here; nothing at world size 1.  Rank 0 alone
        writes the checkpoints and every rank reads them on resume, so the
        directory must be on a file system all the ranks share.  A
        collective: every rank calls it."""
        if world() == 1:
            return
        path = os.path.join(self.directory, ".rank0")
        token = agree(f"{socket.gethostname()}:{os.getpid()}:"
                      f"{time.time_ns()}")
        if rank() == 0:
            _save_text(token, path)
        barrier()
        try:
            with open(path, encoding="utf-8") as f:
                seen = f.read() == token
        except OSError:
            seen = False
        blind = [r for r, ok in enumerate(every(seen)) if not ok]
        if rank() == 0:
            os.remove(path)
        if blind:
            raise RuntimeError(
                f"rank(s) {blind} do not see rank 0's checkpoint directory "
                f"{self.directory}: every rank must see the same exp_dir, "
                "on a file system the machines share")

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    @staticmethod
    def _epoch_of(name: str) -> Optional[int]:
        """epoch_<n>.pt -> n; None for anything else."""
        if not (name.startswith("epoch_") and name.endswith(".pt")):
            return None
        tail = name[len("epoch_"):-len(".pt")]
        return int(tail) if tail.isdigit() else None

    # -- per-epoch checkpoints ---------------------------------------------
    def save_epoch(self, epoch: int, state, reporter: Reporter):
        """Save the full state after ``epoch``, the reporter's history and
        the LATEST pointer, then prune to the n best."""
        tree = _state_tree(state)
        if rank() == 0:
            _save(tree, self._epoch_path(epoch))
            _save_text(json.dumps({"epoch": epoch,
                                   "reporter": reporter.state_dict()}),
                       os.path.join(self.directory, "meta.json"))
            _save_text(str(epoch), os.path.join(self.directory, "LATEST"))
            self._prune(reporter)
        barrier()

    def _prune(self, reporter: Reporter):
        phase, key, mode = self.criterion
        keep = set(reporter.sort_epochs(phase, key, mode)[: self.keep_nbest])
        # always keep the newest for resume, also when the criterion's phase
        # has no stats (training without a validation set)
        keep.add(reporter.epoch)
        for name in os.listdir(self.directory):
            e = self._epoch_of(name)
            if e is not None and e not in keep:
                os.remove(os.path.join(self.directory, name))

    def latest_epoch(self) -> Optional[int]:
        """The newest epoch with a checkpoint, as rank 0 sees it (a
        collective over several ranks)."""
        return agree(self._latest_epoch() if rank() == 0 else None)

    def _latest_epoch(self) -> Optional[int]:
        marker = os.path.join(self.directory, "LATEST")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            e = int(f.read().strip())
        if os.path.exists(self._epoch_path(e)):
            return e
        done = [d for d in map(self._epoch_of, os.listdir(self.directory))
                if d is not None]
        return max(done) if done else None

    def restore(self, epoch: int, state):
        """Load epoch ``epoch``'s full state into ``state`` (in place)."""
        return _load_into(state, _read(self._epoch_path(epoch)))

    def restore_reporter(self, reporter: Reporter,
                         up_to_epoch: Optional[int] = None) -> Optional[int]:
        """Load the reporter's history from meta.json, dropping entries newer
        than ``up_to_epoch`` (the epoch whose weights exist)."""
        meta_path = os.path.join(self.directory, "meta.json")
        if not os.path.exists(meta_path):
            return None
        meta = self._read_json("meta.json")
        reporter.load_state_dict(meta["reporter"])
        epoch = int(meta["epoch"])
        if up_to_epoch is not None and epoch > up_to_epoch:
            reporter.history = {e: h for e, h in reporter.history.items()
                                if e <= up_to_epoch}
            reporter.epoch = epoch = up_to_epoch
        return epoch

    # -- mid-epoch checkpoints ---------------------------------------------
    def _read_json(self, name: str):
        with open(os.path.join(self.directory, name), encoding="utf-8") as f:
            return json.load(f)

    def _step_path(self, epoch: int, iteration: int) -> str:
        return os.path.join(self.directory, f"step_e{epoch}_i{iteration}.pt")

    def save_mid_epoch(self, epoch: int, iteration: int, state,
                       reporter: Reporter, steps_per_dispatch: int = 1):
        """Save the full state after ``iteration`` steps of ``epoch``; only
        the newest mid-epoch checkpoint is kept, and the epoch checkpoints,
        the n-best ranking and LATEST stay as they are.
        ``steps_per_dispatch`` is recorded: a chained run orders its data in
        groups and skips whole groups on resume, so a run with another k
        could not replay up to the saved step."""
        path = self._step_path(epoch, iteration)
        tree = _state_tree(state)
        if rank() == 0:
            _save(tree, path)
            _save_text(json.dumps({"epoch": epoch, "iteration": iteration,
                                   "steps_per_dispatch": steps_per_dispatch,
                                   "reporter": reporter.state_dict()}),
                       os.path.join(self.directory, "meta_step.json"))
            for name in os.listdir(self.directory):
                if name.startswith("step_") and \
                        name != os.path.basename(path):
                    os.remove(os.path.join(self.directory, name))
        barrier()

    def latest_mid_epoch(self) -> Optional[tuple[int, int]]:
        """(epoch, iteration) of the newest mid-epoch checkpoint, if any, as
        rank 0 sees it (a collective over several ranks)."""
        return agree(self._latest_mid_epoch() if rank() == 0 else None)

    def _latest_mid_epoch(self) -> Optional[tuple[int, int]]:
        keys = []
        for name in os.listdir(self.directory):
            if name.startswith("step_e") and name.endswith(".pt"):
                e, i = name[len("step_e"):-len(".pt")].split("_i")
                keys.append((int(e), int(i)))
        return max(keys) if keys else None

    def restore_mid_epoch(self, state, reporter: Reporter,
                          steps_per_dispatch: int = 1):
        """Load the newest mid-epoch checkpoint into ``state``; returns
        (state, epoch, iteration).  The caller resumes that epoch skipping
        the first ``iteration`` steps.  A checkpoint saved under another
        ``steps_per_dispatch`` raises ``ValueError`` before anything is
        loaded (the caller keeps the epoch restore)."""
        key = self.latest_mid_epoch()
        if key is None:
            raise FileNotFoundError("no mid-epoch checkpoint")
        epoch, iteration = key
        meta = agree(self._read_json("meta_step.json") if rank() == 0
                     else None)
        saved_k = int(meta.get("steps_per_dispatch", 1))
        if saved_k != steps_per_dispatch:
            raise ValueError(
                f"mid-epoch checkpoint was saved with steps_per_dispatch"
                f"={saved_k} but the run now uses {steps_per_dispatch}; "
                "the data-stream replay cannot reach the saved sub-step "
                "boundary — falling back to the epoch checkpoint")
        state = _load_into(state, _read(self._step_path(epoch, iteration)))
        reporter.load_state_dict(meta["reporter"])
        return state, epoch, iteration

    def clear_mid_epoch(self):
        """Drop mid-epoch checkpoints (once their epoch completes)."""
        if rank() == 0:
            for name in os.listdir(self.directory):
                if name.startswith("step_") or name == "meta_step.json":
                    os.remove(os.path.join(self.directory, name))
        barrier()

    # -- n-best averaging ----------------------------------------------------
    def average_nbest(self, reporter: Reporter, model: torch.nn.Module,
                      n: Optional[int] = None):
        """Write ``ave_<k>best.pt``: the mean (in float64, cast back to each
        parameter's dtype) of the parameters of the k <= n best epochs that
        still have checkpoints.  Returns ({name: tensor}, epochs).  Over
        several ranks rank 0 alone chooses, reads and writes (a ValueError
        when no ranked epoch has a checkpoint is rank 0's) and the others
        wait; they return (None, None)."""
        if rank() != 0:
            barrier()
            return None, None
        try:
            return self._average_nbest(reporter, model, n)
        finally:
            barrier()

    def _average_nbest(self, reporter: Reporter, model: torch.nn.Module,
                       n: Optional[int]):
        phase, key, mode = self.criterion
        n = n if n is not None else self.keep_nbest
        epochs = [e for e in reporter.sort_epochs(phase, key, mode)[:n]
                  if os.path.exists(self._epoch_path(e))]
        if not epochs:
            raise ValueError("no ranked epochs available to average")
        names = [name for name, _ in model.named_parameters()]
        acc = None
        for e in epochs:
            sd = _read(self._epoch_path(e))["model"]
            vals = [sd[name].to(torch.float64) for name in names]
            acc = vals if acc is None else [a + v for a, v in zip(acc, vals)]
        dtypes = {name: p.dtype for name, p in model.named_parameters()}
        avg = {name: (a / len(epochs)).to(dtypes[name])
               for name, a in zip(names, acc)}
        _save({"params": avg},
              os.path.join(self.directory, f"ave_{len(epochs)}best.pt"))
        return avg, epochs


def _tensors(state: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in state.items()}


def load_params(path: str) -> dict:
    """The parameters ``{name: tensor}`` (on the CPU) of a port checkpoint
    file: an ``ave_*`` file's ``params``, or an epoch or mid-epoch
    checkpoint's model state (BatchNorm statistics included); or of a
    directory written by ``bin.export_params`` (its ``params.pt``).  It
    stands where ``a3t_tpu.train.checkpoint.restore_portable`` does.

    An orbax directory of the JAX package (``bin/export_params``'s stash,
    an ``ave_*`` export or an epoch checkpoint) gives its ``params`` (and
    ``batch_stats`` where it holds them) carried by
    ``compat/from_jax.py::mlm_state`` (the A3T model's layout), float32; a
    bfloat16 stash widens exactly."""
    if is_orbax_checkpoint(path):
        tree = (restore_portable(path, only=("params", "batch_stats"))
                or restore_portable(path))  # a bare params tree
        variables = {"params": tree.get("params", tree)}
        if tree.get("batch_stats"):
            variables["batch_stats"] = tree["batch_stats"]
        return _tensors(mlm_state(variables))
    if os.path.isdir(path):
        path = os.path.join(path, "params.pt")
    tree = _read(path)
    return tree["params"] if "params" in tree else tree["model"]


def _jax_latest_epoch(ckpt_dir: str) -> Optional[int]:
    """``a3t_tpu/train/checkpoint.py::CheckpointManager.latest_epoch``: the
    ``LATEST`` pointer's epoch, or the newest finalized epoch directory
    when that one never materialized."""
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        e = int(f.read().strip())
    if os.path.exists(os.path.join(ckpt_dir, f"epoch_{e}")):
        return e
    done = [int(n[len("epoch_"):]) for n in os.listdir(ckpt_dir)
            if n.startswith("epoch_") and n[len("epoch_"):].isdigit()
            and os.path.exists(os.path.join(ckpt_dir, n,
                                            "_CHECKPOINT_METADATA"))]
    return max(done) if done else None


def is_jax_experiment(ckpt_dir: str) -> bool:
    """Whether an experiment's ``checkpoints/`` holds the JAX package's
    orbax ``epoch_N/`` or ``ave_*`` directories."""
    return any(n.startswith(("epoch_", "ave_"))
               and is_orbax_checkpoint(os.path.join(ckpt_dir, n))
               for n in os.listdir(ckpt_dir))


def experiment_state(ckpt_dir: str, which: str, convert) -> dict:
    """The state ``{name: tensor}`` that a task's ``build_model_from_dir``
    loads from an experiment's ``checkpoints/``.  ``which``: "ave" (the
    newest ``ave_*`` parameters with the latest epoch's BatchNorm
    statistics), "best"/"latest" (the latest epoch) or "epoch_N".

    The port's files (``epoch_N.pt``, ``ave_*.pt``) load as they are; a JAX
    experiment's orbax directories are chosen by JAX's rules
    (``a3t_tpu/tasks/mlm.py:451-468``, ``tasks/fs2.py:327-348``) and their
    variables carried by ``convert`` (``mlm_state`` or ``fs2_state``)."""
    ave = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("ave_"))
    if is_jax_experiment(ckpt_dir):
        latest = _jax_latest_epoch(ckpt_dir)
        if which == "ave" and ave:
            params = restore_portable(os.path.join(ckpt_dir, ave[-1]),
                                      only=("params",))["params"]
            epoch, keep = latest, ("batch_stats",)
        else:
            epoch = (latest if which in ("ave", "best", "latest")
                     else int(which.split("_")[-1]))
            params, keep = None, ("params", "batch_stats")
        if epoch is None:
            raise FileNotFoundError(f"no epoch checkpoint in {ckpt_dir}")
        tree = restore_portable(os.path.join(ckpt_dir, f"epoch_{epoch}"),
                                only=keep)
        return _tensors(convert({
            "params": tree["params"] if params is None else params,
            "batch_stats": tree.get("batch_stats") or {}}))
    latest = CheckpointManager(ckpt_dir).latest_epoch()
    epoch = (latest if which in ("ave", "best", "latest")
             else int(which.split("_")[-1]))
    if epoch is None:
        raise FileNotFoundError(f"no epoch checkpoint in {ckpt_dir}")
    state = load_params(os.path.join(ckpt_dir, f"epoch_{epoch}.pt"))
    if which == "ave" and ave:
        state = {**state, **load_params(os.path.join(ckpt_dir, ave[-1]))}
    return state


def warm_start_params(model: torch.nn.Module, path: str,
                      grow_vocab: bool = False,
                      allow_missing: bool = False) -> torch.nn.Module:
    """Load a checkpoint's parameters (:func:`load_params`: a port file or
    directory, or a JAX orbax directory such as ``artifacts/soak12k_params``)
    into ``model`` (in place), each cast to the model's dtype and device:
    the reference's --init_param
    (espnet2/torch_utils/load_pretrained_model.py:43-102).

    ``grow_vocab=True`` lets the model's embedding tables be longer than the
    checkpoint's (the first rows are loaded, the new ids keep their fresh
    init); ``allow_missing=True`` lets the model hold parameters the
    checkpoint lacks (they keep their fresh init).  Checkpoint parameters the
    model lacks always raise."""
    buffers = dict(model.named_buffers())  # BatchNorm statistics
    loaded = {k: v for k, v in load_params(path).items() if k not in buffers}
    # a model-axis slice of a model takes its slices of the parameters
    layout = FlatLayout.of(model)
    loaded = shard_state(loaded, layout.t, layout.tp)
    own = dict(model.named_parameters())
    extra = sorted(set(loaded) - set(own))
    if extra:
        raise ValueError(
            f"warm-start params structure mismatch: {path} holds params the "
            f"model lacks (first: {extra[:3]}) — did the config change?")
    fresh = sorted(set(own) - set(loaded))
    if fresh and not allow_missing:
        raise ValueError(
            f"warm-start params structure mismatch: model params missing "
            f"from {path} (first: {fresh[:3]}); pass allow_missing=True to "
            "keep their fresh init (new-module fine-tune)")
    if fresh:
        logger.info("warm-start: %d params not in %s keep fresh init "
                    "(first: %s)", len(fresh), path, fresh[:3])
    with torch.no_grad():
        for name, x in loaded.items():
            p = own[name]
            if x.shape != p.shape:
                growth = (grow_vocab and x.dim() == p.dim()
                          and x.shape[1:] == p.shape[1:]
                          and x.shape[0] < p.shape[0])
                if not growth:
                    raise ValueError(
                        f"warm-start shape mismatch at {name}: checkpoint "
                        f"{tuple(x.shape)} vs model {tuple(p.shape)}")
                p[: x.shape[0]].copy_(x.to(p.dtype))
            else:
                p.copy_(x.to(p.dtype))
    return model
