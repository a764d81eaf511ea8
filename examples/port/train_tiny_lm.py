"""End-to-end training on the port with fault tolerance: crash at step 60,
resume, finish.

  PYTHONPATH=src python examples/port/train_tiny_lm.py --device cpu

Without ``--device`` it trains on the CUDA card.
"""

import argparse
import os
import shutil
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.optim import AdamWConfig, warmup_cosine
from repro_torch.train import Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
args = ap.parse_args()

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt")
shutil.rmtree(CKPT, ignore_errors=True)

cfg = get_smoke_config("gemma2-9b")   # reduced gemma2: softcaps, local/global
print(f"training {cfg.name}: {cfg.param_count()/1e6:.2f}M params")


def make_trainer():
    return Trainer(
        cfg,
        AdamWConfig(learning_rate=warmup_cosine(3e-3, 10, 120),
                    weight_decay=0.1),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
        TrainerConfig(total_steps=120, checkpoint_every=25,
                      checkpoint_dir=CKPT, log_every=20),
        device=args.device,
    )


try:
    make_trainer().run(inject_failure_at=60)
except RuntimeError as e:
    print(f"!! {e} — restarting from latest checkpoint")

_, _, history = make_trainer().run()   # resumes from step 50 exactly
for step, loss in history:
    print(f"  step {step:4d}  loss {loss:.4f}")
print("restart was bitwise-exact (see tests/test_torch_train.py)")
