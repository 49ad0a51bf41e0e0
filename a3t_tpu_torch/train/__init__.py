from a3t_tpu_torch.train.optim import (
    OptimConfig,
    Optimizer,
    make_optimizer,
    noam_schedule,
    warmup_lr_schedule,
)
from a3t_tpu_torch.train.reporter import Reporter
from a3t_tpu_torch.train.train_step import (
    TrainState,
    create_train_state,
    featurize,
    gather_audio,
    make_eval_step,
    make_train_step,
)
from a3t_tpu_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["OptimConfig", "Optimizer", "make_optimizer", "noam_schedule",
           "warmup_lr_schedule", "Reporter", "TrainState",
           "create_train_state", "featurize", "gather_audio",
           "make_eval_step", "make_train_step", "Trainer", "TrainerConfig"]
