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
``--mesh-shape`` and ``--compress-pods`` are the reference's multi-pod
knobs: they raise until ``dist/`` is ported (ROADMAP queue 1 item 11).
Verbosity is the ``REPRO_LOG`` env knob.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
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
                         "raises until dist/ is ported (ROADMAP queue 1 "
                         "item 11)")
    ap.add_argument("--compress-pods", action="store_true",
                    help="int8 error-feedback cross-pod gradient reduction; "
                         "raises until dist/ is ported (ROADMAP queue 1 "
                         "item 11)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="export a Chrome trace (Perfetto) of the run, with "
                         "the step-time metrics snapshot embedded")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain path on the CPU)")
    args = ap.parse_args(argv)

    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
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
