# The HEFT_RT overlay's dataplane as CUDA kernels for Hopper, each with its
# plain PyTorch version beside it:
#   heft_fused     — the full overlay: sort + EFT drain, one CTA per event
#   fused_decision — the same event with a device-resident PE mask
from repro_torch.kernels.fused_decision import (decision_ref,
                                                pack_tick_outputs,
                                                unpack_decision)
from repro_torch.kernels.ops import (build_kernels, decision_hw, heft_rt_hw,
                                     launch_counts, reset_launch_counts)

__all__ = [
    "build_kernels",
    "decision_hw",
    "decision_ref",
    "heft_rt_hw",
    "launch_counts",
    "pack_tick_outputs",
    "reset_launch_counts",
    "unpack_decision",
]
