# The training loop: make_train_step (gradient accumulation in f32) and the
# checkpoint/restart Trainer — the port's counterpart of repro.train.
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

__all__ = ["Trainer", "TrainerConfig", "make_train_step"]
