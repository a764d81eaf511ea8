#!/usr/bin/env python3
"""Where a full-width training step's time goes on the card.

    python3 benchmarks/port/train_step_trace.py [--arch A] [--batch B] [--seq S] [--out FILE] [--seed N]

Builds ``--arch`` (default deepseek-7b) at its published widths and depth
(bf16, random weights from a seeded generator, as ``chip_smoke.py``'s train
phase does), AdamW with int8 moments, remat on, and ``TokenPipeline``
batches of B x S tokens (default 4 x 512).  After two warm-up steps it
times the step's two halves apart, with a synchronize around each
(``loss_fn`` + ``torch.autograd.grad``, then ``adamw_update``), then traces
one whole ``make_train_step`` step under ``torch.profiler`` (CPU and CUDA
activities).  Prints the card's name and power limit, the halves' times,
the traced step's wall and device busy time, its idle share, the device
kernels and top-level aten ops, the device time by kernel class and by
kernel name, then one JSON line.  Fails without a card, or if the trace
holds no device activity.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

WARMUP = 2

# device kernels by class, first match wins (names of cuBLAS / cutlass GEMMs,
# PyTorch's elementwise, reduction, index and copy kernels)
CLASSES = (
    ("gemm", re.compile(r"gemm|cutlass|sm90_xmma|nvjet|cublas", re.I)),
    ("index / scatter", re.compile(r"index|scatter|gather|embedding", re.I)),
    ("reduction", re.compile(r"reduce|softmax|logsumexp|norm", re.I)),
    ("copy / cast", re.compile(r"copy|cat|memcpy|memset|fill", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
)


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (µs)."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_class(name: str) -> str:
    for cls, pat in CLASSES:
        if pat.search(name):
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out", help="also write the summary to FILE (JSON)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_step_trace: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params, loss_fn, model_flops
    from repro_torch.optim import (AdamWConfig, adamw_update, init_opt_state,
                                   warmup_cosine)
    from repro_torch.train import make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    params = init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed),
        device="cuda")
    params.requires_grad_(True)
    opt_cfg = AdamWConfig(moment_dtype="int8", weight_decay=0.1,
                          learning_rate=warmup_cosine(3e-3, 10, 100))
    opt = init_opt_state(dict(params.named_parameters()), opt_cfg)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed))
    step = make_train_step(cfg, opt_cfg)

    def batch_at(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in pipe.batch_at(i).items()}

    for i in range(WARMUP):
        params, opt, _, _ = step(params, opt, None, batch_at(i))

    # the two halves of one step, timed apart
    b = batch_at(WARMUP)
    names, leaves = zip(*params.named_parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = loss_fn(params, b["tokens"], b["labels"], cfg)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(grads, opt, dict(zip(names, leaves)), opt_cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads, loss
    fwd_bwd_s, adamw_s = t1 - t0, t2 - t1

    b = batch_at(WARMUP + 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, met = step(params, opt, None, b)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0

    device = defaultdict(float)
    classes = defaultdict(float)
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.end - ev.time_range.start
            device[ev.name] += dur
            classes[kernel_class(ev.name)] += dur
            intervals.append((ev.time_range.start, ev.time_range.end))
    if not intervals:
        print("train_step_trace: the trace holds no device activity",
              file=sys.stderr)
        return 1
    busy = busy_us(intervals) / 1e6
    top_level = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and e.name.startswith("aten::") and e.cpu_parent is None]
    tokens = args.batch * args.seq
    flops = model_flops(cfg, tokens, train=True)
    summary = {
        "card": card, "arch": args.arch, "layers": cfg.num_layers,
        "batch": args.batch, "seq": args.seq, "moment_dtype": "int8",
        "fwd_bwd_s": fwd_bwd_s, "adamw_s": adamw_s,
        "traced_wall_s": traced_wall, "device_busy_s": busy,
        "idle_share": 1 - busy / traced_wall,
        "device_kernels": len(intervals), "host_aten_ops": len(top_level),
        "device_s_by_class": {k: v / 1e6 for k, v in classes.items()},
        "device_s_by_name_top": {k: v / 1e6 for k, v in sorted(
            device.items(), key=lambda kv: -kv[1])[:15]},
        "model_flops_6NT": flops, "loss": float(met["loss"]),
    }
    print(f"[card] {card} | torch {torch.__version__}")
    print(f"[step] {args.arch} {cfg.num_layers} layers, batch {args.batch} x "
          f"{args.seq}, int8 moments: forward + backward {fwd_bwd_s:.6f} s, "
          f"adamw_update {adamw_s:.6f} s; traced step {traced_wall:.6f} s, "
          f"device busy {busy:.6f} s (idle share "
          f"{summary['idle_share']:.6f}), {len(intervals)} device kernels, "
          f"{len(top_level)} top-level aten ops")
    for cls, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"[class]  {us / 1e6:10.6f} s  {cls}")
    for name, us in sorted(device.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[device] {us / 1e6:10.6f} s  {name[:110]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: summary[k] for k in (
        "card", "arch", "fwd_bwd_s", "adamw_s", "traced_wall_s",
        "idle_share", "device_kernels", "host_aten_ops")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
