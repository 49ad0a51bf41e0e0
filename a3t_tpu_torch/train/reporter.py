"""Metric aggregation and logging: a copy of ``a3t_tpu/train/reporter.py``
(reference: espnet2/train/reporter.py).

Keeps per-epoch train/valid buckets of weighted-average statistics, renders
log lines, answers best-epoch queries for checkpoint retention, and holds
its history in plain dicts so that it serializes as JSON beside the
checkpoints.  Statistics arrive as host numbers: the trainer moves a run of
steps' device statistics to the host in one copy before registering them.
TensorBoard emission is optional.  ``Reporter.plot`` (matplotlib curves) is
not ported (ROADMAP A7-rest).
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Optional

import numpy as np

logger = logging.getLogger("a3t_tpu_torch")


class SubReporter:
    """Accumulates weighted averages for one (epoch, phase)."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._weights = defaultdict(float)
        self._timings = defaultdict(list)
        self.steps = 0

    def register(self, stats: dict, weight: float = 1.0):
        self.steps += 1
        for k, v in stats.items():
            if v is None:
                continue
            v = float(np.asarray(v))
            if np.isfinite(v):
                self._sums[k] += v * weight
                self._weights[k] += weight

    def register_time(self, name: str, seconds: float):
        self._timings[name].append(seconds)

    def mean(self, key: str) -> float:
        w = self._weights.get(key, 0.0)
        return self._sums[key] / w if w > 0 else float("nan")

    def summary(self) -> dict:
        out = {k: self.mean(k) for k in self._sums}
        for name, vals in self._timings.items():
            out[f"{name}_time"] = float(np.mean(vals))
        return out


class Reporter:
    """Epoch-indexed history of train/valid stats."""

    def __init__(self):
        self.history: dict[int, dict[str, dict]] = {}
        self.epoch = 0
        self._current: dict[str, SubReporter] = {}

    # -- epoch lifecycle -------------------------------------------------
    def start_epoch(self, epoch: int):
        self.epoch = epoch
        self._current = {}

    def phase(self, name: str) -> SubReporter:
        if name not in self._current:
            self._current[name] = SubReporter()
        return self._current[name]

    def finish_epoch(self, tensorboard_writer=None, wandb_run=None):
        summary = {p: sr.summary() for p, sr in self._current.items()}
        self.history[self.epoch] = summary
        if tensorboard_writer is not None:
            for phase, stats in summary.items():
                for k, v in stats.items():
                    tensorboard_writer.add_scalar(f"{phase}/{k}", v, self.epoch)
        if wandb_run is not None:
            # Weights & Biases sink (abs_task.py:1243-1278, trainer.py:409-425)
            flat = {
                f"{phase}/{k}": v
                for phase, stats in summary.items()
                for k, v in stats.items()
            }
            wandb_run.log(flat, step=self.epoch)
        return summary

    def log_message(self) -> str:
        parts = []
        for phase, sr in self._current.items():
            stats = ", ".join(f"{k}={v:.4g}" for k, v in sr.summary().items())
            parts.append(f"[{phase}] {stats}")
        return f"epoch {self.epoch}: " + " | ".join(parts)

    # -- best-epoch queries (trainer.py:366-443 analogue) ----------------
    def get_value(self, phase: str, key: str, epoch: Optional[int] = None) -> float:
        epoch = self.epoch if epoch is None else epoch
        return self.history.get(epoch, {}).get(phase, {}).get(key, float("nan"))

    def best_epoch(self, phase: str, key: str, mode: str = "min") -> Optional[int]:
        vals = {
            e: h[phase][key]
            for e, h in self.history.items()
            if phase in h and key in h[phase] and np.isfinite(h[phase][key])
        }
        if not vals:
            return None
        pick = min if mode == "min" else max
        return pick(vals, key=vals.get)

    def sort_epochs(self, phase: str, key: str, mode: str = "min") -> list[int]:
        vals = {
            e: h[phase][key]
            for e, h in self.history.items()
            if phase in h and key in h[phase] and np.isfinite(h[phase][key])
        }
        return sorted(vals, key=vals.get, reverse=(mode == "max"))

    def check_early_stopping(self, patience: int, phase: str, key: str,
                             mode: str = "min") -> bool:
        best = self.best_epoch(phase, key, mode)
        return best is not None and (self.epoch - best) > patience

    # -- (de)serialization ----------------------------------------------
    def state_dict(self) -> dict:
        return {"history": self.history, "epoch": self.epoch}

    def load_state_dict(self, state: dict):
        self.history = {int(k): v for k, v in state["history"].items()}
        self.epoch = int(state["epoch"])


class StepTimer:
    """Context helper measuring forward/backward/step wall times."""

    def __init__(self, sub: SubReporter, name: str):
        self.sub = sub
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sub.register_time(self.name, time.perf_counter() - self.t0)
