"""Training: config, model container, merge loop, orchestration."""

from yabpe_tpu_torch.train.config import BBPETrainerConfig
from yabpe_tpu_torch.train.model import BBPEModel
from yabpe_tpu_torch.train.trainer import BBPETrainer

__all__ = ["BBPETrainer", "BBPETrainerConfig", "BBPEModel"]
