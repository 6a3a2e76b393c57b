"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
-- the port of ``repro/launch/train.py``.

Wires config -> model on the device -> data pipeline -> fault-tolerant
Trainer.  Runs on the card unless ``--device`` names another device
(``--device cpu --reduced`` on a host without one); without a card and
without ``--device`` it raises.  Under ``torch.distributed`` (initialised
by the caller) each process reads its own data shard: the process count
and index are the default group's world size and rank, else 1 and 0.
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.ckpt import process_count, process_index
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.straggler import StragglerPolicy

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = configs.reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    tcfg = TrainConfig(
        steps=args.steps, microbatch=args.microbatch,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        grad_compression=args.grad_compression,
        opt=OptConfig(name=args.opt, peak_lr=args.lr,
                      warmup_steps=max(args.steps // 20, 5),
                      decay_steps=args.steps),
    )
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch, num_shards=process_count(),
        seed=tcfg.seed), shard=process_index())
    policy = StragglerPolicy(process_count())
    trainer = Trainer(cfg, tcfg, data, policy=policy, device=args.device)
    trainer.run()
    for h in trainer.history:
        if "loss" in h and h["step"] % args.log_every == 0:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} "
                  f"gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e}")
    final = [h for h in trainer.history if "loss" in h][-1]
    print(f"final: step {final['step']} loss {final['loss']:.4f} on "
          f"{trainer.device}")
    return trainer


if __name__ == "__main__":
    main()
