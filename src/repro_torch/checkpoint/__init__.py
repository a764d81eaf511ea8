# Atomic, asynchronous, keep-k checkpoints of trees of torch tensors: the
# port's counterpart of repro.checkpoint.
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
