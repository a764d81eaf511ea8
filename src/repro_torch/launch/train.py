"""Training launcher: the end-to-end entry point of the port's training path.

A run of any smoke config with the whole substrate (data pipeline, AdamW,
checkpointing, exact restart):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch deepseek-7b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --trace /tmp/train_trace.json

It runs on the card unless ``--device cpu`` is given.  ``--trace OUT.json``
attaches a ``repro_torch.obs`` Tracer and MetricsRegistry to the Trainer
(a ``train.step`` span a step, the ``train.step_s`` histogram) and writes a
Perfetto-loadable Chrome trace with the metrics embedded
(``python -m repro_torch.obs.check OUT.json --require train.step``).
Verbosity is the ``REPRO_LOG`` env knob.

Multi-pod runs are one process a device under ``torchrun``, the world the
mesh's size: ``--mesh-shape`` over (pod, data[, model]) and
``--compress-pods`` for the int8 error-feedback pod reduction, over
``--backend`` (``gloo`` on the CPU, ``nccl`` on cards; ``gloo`` also for
several ranks on one card):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --mesh-shape 2,2 --compress-pods --steps 4

With a model axis (``--mesh-shape p,d,m``) the step is tensor-parallel
(``train.trainer.TrainLayout``: parameters and moments are ``DTensor`` s,
the cross-entropy vocab-parallel):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --mesh-shape 1,2,2 --steps 4

Rank 0 logs and writes the checkpoints and the trace.
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import init_world
from repro_torch.obs import MetricsRegistry, Tracer, get_logger
from repro_torch.obs.metrics import time_s
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig

log = get_logger("train")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None,
                    help="raise after N steps to demo checkpoint/restart")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation factor")
    ap.add_argument("--mesh-shape", default=None,
                    help="comma-separated mesh over (pod,data,model) axes; "
                         "one process a device under torchrun")
    ap.add_argument("--compress-pods", action="store_true",
                    help="int8 error-feedback cross-pod gradient reduction "
                         "(needs --mesh-shape)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend of a --mesh-shape run "
                         "(default: gloo with --device cpu, else nccl)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Chrome trace (Perfetto) of the run, with "
                         "the step-time metrics snapshot embedded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path on the CPU)")
    args = ap.parse_args(argv)

    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    if mesh_shape is not None:
        world = int(os.environ.get("WORLD_SIZE", "0"))
        if world != math.prod(mesh_shape):
            raise ValueError(
                f"--mesh-shape {args.mesh_shape} runs one process a device: "
                f"start it under torchrun with --nproc-per-node "
                f"{math.prod(mesh_shape)} (WORLD_SIZE is {world or 'unset'})")
        init_world(args.backend or ("gloo" if args.device == "cpu"
                                    else "nccl"), device=args.device)
    cfg = get_smoke_config(args.arch)
    log.info(f"arch={cfg.name} params={cfg.param_count()/1e6:.2f}M "
             f"microbatches={args.microbatches} device={args.device or 'cuda'}")
    tracer, metrics = ((Tracer(), MetricsRegistry()) if args.trace
                       else (None, None))
    trainer = Trainer(
        cfg,
        AdamWConfig(learning_rate=warmup_cosine(args.lr, 10, args.steps),
                    weight_decay=0.1),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch),
        TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir, log_every=10,
                      microbatches=args.microbatches, mesh_shape=mesh_shape,
                      compress_pods=args.compress_pods),
        tracer=tracer, metrics=metrics, device=args.device,
    )
    (_, _, history), dt = time_s(trainer.run,
                                 inject_failure_at=args.inject_failure_at)
    if trainer.rank != 0:
        return
    for step, loss in history:
        log.info(f"step {step:5d} loss {loss:.4f}")
    tok_s = args.steps * args.batch * args.seq / dt
    log.info(f"done: {dt:.1f}s, {tok_s:.0f} tok/s on {trainer.device}")
    if args.trace:
        tracer.export(args.trace, metrics=metrics)
        log.info(f"trace: {args.trace} ({len(tracer)} events, "
                 f"{len(metrics)} metrics)")


if __name__ == "__main__":
    main()
