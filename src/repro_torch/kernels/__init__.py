# The HEFT_RT overlay's dataplane as CUDA kernels for Hopper, each with its
# plain PyTorch version beside it:
#   heft_fused     — the full overlay: sort + EFT drain, one CTA per event
#   fused_decision — the same event with a device-resident PE mask
#   oddeven_sort   — the priority queue alone: stable descending sort
#   eft_select     — the EFT selector alone: the drain of a sorted queue
# and, for the paged decode tick,
#   paged_attention — decode attention read from the KV pages in place
from repro_torch.kernels.fused_decision import (decision_ref,
                                                pack_tick_outputs,
                                                unpack_decision)
from repro_torch.kernels.ops import (build_kernels, decision_hw, eft_select,
                                     heft_rt_hw, launch_counts, oddeven_sort,
                                     paged_decode_attention,
                                     reset_launch_counts)

__all__ = [
    "build_kernels",
    "decision_hw",
    "decision_ref",
    "eft_select",
    "heft_rt_hw",
    "launch_counts",
    "oddeven_sort",
    "pack_tick_outputs",
    "paged_decode_attention",
    "reset_launch_counts",
    "unpack_decision",
]
