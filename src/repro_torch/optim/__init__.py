# AdamW with f32 / bf16 / int8 moments and the learning-rate schedules: the
# port's counterpart of repro.optim.
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import constant, inverse_sqrt, warmup_cosine

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state",
           "constant", "inverse_sqrt", "warmup_cosine"]
