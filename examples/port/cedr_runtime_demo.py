"""CEDR runtime demo on the port: the paper's oversubscription experiment,
end to end.

  PYTHONPATH=src python examples/port/cedr_runtime_demo.py [--device cpu]

Sweeps injection rate over the high-latency workload (10×PulseDoppler +
10×WiFi-TX) on the 3×ARM + FFT SoC and compares the software scheduler
against the hardware scheduler (calibrated overhead models).  Every mapping
event goes through a ``MappingFabric``: on the card the ``heft_fused``
CUDA kernel, with ``--device cpu`` the float64 host path (the reference's
arithmetic; ``REPRO_TORCH_FABRIC_BACKEND=torch`` runs the kernel's float32
plain version instead, the card's arithmetic).

Without ``--device`` it runs on the CUDA card.
"""

import argparse

from repro_torch.runtime import (HW_MODEL, SW_MODEL, CedrSimulator,
                                 make_dispatch_fabric, paper_soc_pe_types)
from repro_torch.runtime.workload import high_latency_arrivals

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

print(f"{'target':>7} {'sw fps':>8} {'hw fps':>8} {'gain':>7} "
      f"{'sw exec':>9} {'hw exec':>9} {'maxQ':>6}")
pes = paper_soc_pe_types()
for rate in [100, 200, 300, 400, 500, 600]:
    arr = high_latency_arrivals(rate, seed=1)
    sw = CedrSimulator(pes, make_dispatch_fabric(device=args.device),
                       overhead=SW_MODEL, seed=7).run(arr)
    hw = CedrSimulator(pes, make_dispatch_fabric(device=args.device),
                       overhead=HW_MODEL, seed=7).run(arr)
    print(f"{rate:7d} {sw.achieved_frame_rate:8.1f} {hw.achieved_frame_rate:8.1f} "
          f"{(hw.achieved_frame_rate/sw.achieved_frame_rate-1)*100:6.1f}% "
          f"{sw.avg_app_exec_time*1e3:8.2f}ms {hw.avg_app_exec_time*1e3:8.2f}ms "
          f"{sw.max_queue_size:6d}")
print("\npaper (Fig 5/6): sw saturates ~161.5 fps, hw ~204.6 fps (+26.7%); "
      "hw per-app exec time 31.7% lower in saturation")
