from a3t_tpu_torch.tasks.config import A3TTaskConfig, load_config
from a3t_tpu_torch.tasks.mlm import MLMTask

__all__ = ["A3TTaskConfig", "load_config", "MLMTask"]
