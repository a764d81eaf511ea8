"""Pod-compressed training on the port with fault tolerance: int8 cross-pod
gradients, crash at step 30, resume bit-exactly — residual included.

  PYTHONPATH=src python examples/port/train_pod_compressed.py [--device cpu]

Four ranks on this machine, spawned over ``gloo`` (the launchers' own
transport for ranks that share a card or run on the CPU), form a (2, 2)
``(pod, data)`` mesh.  The Trainer reduces gradients cross-pod with the
int8 error-feedback collective and checkpoints the per-pod residual next
to params/opt; the restarted run continues on the exact trajectory of an
uninterrupted one.  The same run under ``torchrun`` is ``python -m
repro_torch.launch.train --mesh-shape 2,2 --compress-pods``.

Without ``--device`` every rank trains on the CUDA card.
"""

import argparse
import os
import shutil
import socket
import tempfile

import torch

RANKS = 4


def rank_main(rank: int, port: int, device, ckpt: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(RANKS),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      GLOO_SOCKET_IFNAME="lo")
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import init_world
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    torch.set_num_threads(1)      # the ranks share this machine's cores
    init_world("gloo", device=device)
    cfg = get_smoke_config("deepseek-7b")
    if rank == 0:
        print(f"training {cfg.name}: {cfg.param_count()/1e6:.2f}M params "
              f"on {RANKS} ranks, int8 pod-compressed gradients", flush=True)

    def make_trainer():
        return Trainer(
            cfg,
            AdamWConfig(learning_rate=warmup_cosine(3e-3, 10, 60),
                        weight_decay=0.1),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
            TrainerConfig(total_steps=60, checkpoint_every=20,
                          checkpoint_dir=ckpt, log_every=20,
                          mesh_shape=(2, 2), compress_pods=True,
                          microbatches=2),
            device=device)

    try:
        make_trainer().run(inject_failure_at=30)
    except RuntimeError as e:
        if rank == 0:
            print(f"!! {e} — restarting from latest checkpoint (residual "
                  f"restored)", flush=True)
    tr = make_trainer()
    _, _, history = tr.run()     # resumes from step 20 exactly
    if rank == 0:
        for step, loss in history:
            print(f"  step {step:4d}  loss {loss:.4f}")
        res = tr.last_residual
        leaves = list(res.values()) if isinstance(res, dict) else list(res)
        print(f"error-feedback residual: {len(leaves)} leaves, per-pod "
              f"stacked {tuple(leaves[0].shape)} — checkpointed with params")
        print("restart was bitwise-exact (see tests/"
              "test_torch_train_compress.py)", flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_pod_ckpt_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        torch.multiprocessing.spawn(rank_main, args=(port, args.device, ckpt),
                                    nprocs=RANKS, join=True)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
