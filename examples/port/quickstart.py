"""Quickstart on the port: one HEFT_RT mapping event, three ways — then
serve with it.

  PYTHONPATH=src python examples/port/quickstart.py [--device cpu]

1. software HEFT_RT (the paper's baseline scheduler, plain PyTorch),
2. the hand-written CUDA kernel (``heft_rt_hw``: stable sort + EFT drain,
   one launch), bit-identical; with ``--device cpu`` its plain version,
3. the hardware cycle/latency model (3n+3 @ 3.048 ns → 9.144 ns/decision),
4. the paged serving API: two requests continuously batched through one
   ServeEngine's block-paged KV pool, token-identical to the dense oracle.

Without ``--device`` it runs on the CUDA card.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (PAPER_CRITICAL_PATH_NS, heft_rt,
                              per_decision_latency_ns, simulate_mapping_event,
                              worst_case_cycles)
from repro_torch.kernels import heft_rt_hw
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()
dev = torch.device(args.device) if args.device else torch.device("cuda")

# A ready queue of 8 tasks on the paper's SoC: 3×ARM + 1×FFT accelerator.
# Tasks 0-3 are FFTs (fast on PE3), tasks 4-7 are DSP (ARM-only → inf).
exec_times = np.array([
    # ARM0   ARM1   ARM2   FFT
    [0.35,  0.35,  0.35,  0.035],
    [0.35,  0.35,  0.35,  0.035],
    [0.35,  0.35,  0.35,  0.035],
    [0.35,  0.35,  0.35,  0.035],
    [0.14,  0.14,  0.14,  np.inf],
    [0.21,  0.21,  0.21,  np.inf],
    [0.14,  0.14,  0.14,  np.inf],
    [0.08,  0.08,  0.08,  np.inf],
], dtype=np.float32)
avg = np.where(np.isfinite(exec_times), exec_times, np.nan)
avg = np.nanmean(avg, axis=1).astype(np.float32)
avail = np.zeros(4, dtype=np.float32)

print("=== software HEFT_RT ===")
res = heft_rt(torch.from_numpy(avg), torch.from_numpy(exec_times),
              torch.from_numpy(avail))
for i in range(8):
    t, pe = int(res.order[i]), int(res.assignment[i])
    print(f"  priority {i}: task {t} -> PE{pe} "
          f"[{float(res.start_time[i]):.3f}, {float(res.finish_time[i]):.3f}] ms")
print(f"  makespan: {float(res.new_avail.max()):.3f} ms")

print(f"=== CUDA kernel (heft_rt_hw on {dev.type}) ===")
hw = heft_rt_hw(torch.from_numpy(avg).to(dev),
                torch.from_numpy(exec_times).to(dev),
                torch.from_numpy(avail).to(dev))
same = all(torch.equal(a.cpu(), b) for a, b in zip(hw, res))
print(f"  decisions bit-identical to software: {same}  (paper Fig. 3)")

print("=== hardware latency model ===")
n = 8
rep = simulate_mapping_event(avg)
print(f"  cycles: {rep.total_cycles} (bound 3n+3 = {worst_case_cycles(n)})")
print(f"  mapping event: {worst_case_cycles(n) * PAPER_CRITICAL_PATH_NS:.1f} ns"
      f"  |  per decision (D=512 design): "
      f"{per_decision_latency_ns(512, PAPER_CRITICAL_PATH_NS, asymptotic=True):.3f} ns"
      f" (paper: 9.144 ns)")

print("=== paged serving (continuous batching, dense oracle verified) ===")
cfg = ModelConfig(name="quickstart", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=4, d_ff=64, vocab_size=64,
                  param_dtype="float32", compute_dtype="float32")
params = init_params(cfg, torch.Generator().manual_seed(0),
                     device="cpu").to(dev)     # the same weights everywhere
eng = ServeEngine(cfg, params, max_len=32, lanes=2)
eng.start_paged(max_batch=2, page_size=8)      # admit/decode_tick/retire API
rng = np.random.default_rng(0)
reqs = [(rng.integers(1, 64, size=s).astype(np.int32), nt)
        for s, nt in [(6, 5), (11, 4)]]
slots = {eng.admit(p, nt): i for i, (p, nt) in enumerate(reqs)}
done = {}
while len(done) < len(reqs):
    eng.decode_tick()                          # one batched step, all slots
    for s in eng.finished_slots():
        done[slots.pop(s)] = eng.retire(s)
oracle = ServeEngine(cfg, params, max_len=32, lanes=2)
ok = True
for i, (p, nt) in enumerate(reqs):
    same = np.array_equal(done[i], oracle.generate(p[None], nt)[0])
    ok &= same
    print(f"  request {i}: {len(p)} prompt + {nt} new tokens -> "
          f"bit-identical to dense generate: {same}")
pool = eng.paged.pool
print(f"  pages allocated == freed: {pool.allocated} == {pool.freed}")
if not (ok and pool.allocated == pool.freed):
    raise SystemExit(1)
