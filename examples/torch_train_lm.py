"""End-to-end LM training on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --preset full --steps 3
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --device cpu

The port's counterpart of examples/train_lm.py, with its presets:
  tiny -- ~8M-param smollm-family model, a few hundred steps in minutes
          on a CPU (loss decreases from ~ln(V) as it learns the synthetic
          unigram+EOS structure);
  full -- the real smollm-135m in float32.

Runs on the card unless --device names another device.  Features on
display: deterministic sharded data pipeline, AdamW + cosine schedule,
grad clipping, async atomic checkpointing with restart-on-NaN, metric
history.  Checkpoints go to --ckpt-dir, or to a temporary directory that
is removed at the end.
"""
import argparse
import dataclasses
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402


def preset_cfg(name):
    if name == "full":
        cfg = configs.get("smollm-135m")
        return dataclasses.replace(cfg, param_dtype="float32",
                                   compute_dtype="float32")
    cfg = configs.reduced("smollm-135m")
    return dataclasses.replace(cfg, num_layers=4, d_model=128, num_heads=4,
                               num_kv_heads=2, head_dim=32, d_ff=512,
                               vocab_size=2048)


def train(args, ckpt_dir):
    steps = args.steps or (300 if args.preset == "tiny" else 3)
    seq = args.seq_len or (128 if args.preset == "tiny" else 512)
    cfg = preset_cfg(args.preset)
    print(f"preset={args.preset}: {lm.count_params(cfg) / 1e6:.1f}M params, "
          f"{steps} steps @ batch {args.global_batch} x seq {seq}")
    tcfg = TrainConfig(
        steps=steps, ckpt_every=max(steps // 3, 25), ckpt_dir=ckpt_dir,
        opt=OptConfig(peak_lr=1e-3 if args.preset == "tiny" else 3e-4,
                      warmup_steps=max(steps // 10, 5), decay_steps=steps))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=args.global_batch))
    trainer = Trainer(cfg, tcfg, data, device=args.device)
    t0 = time.time()
    trainer.run()
    dt = time.time() - t0

    losses = [h for h in trainer.history if "loss" in h]
    for h in losses[:: max(len(losses) // 12, 1)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f}")
    print(f"final loss {losses[-1]['loss']:.4f} (start "
          f"{losses[0]['loss']:.4f}) in {dt:.0f}s "
          f"({dt / len(losses):.2f}s/step) on {trainer.device}")
    if steps >= 50:  # too few steps to clear warmup otherwise
        first = sum(h["loss"] for h in losses[:10]) / 10
        last = sum(h["loss"] for h in losses[-10:]) / 10
        assert last < first, (first, last)
        print(f"OK: loss decreased (mean of the first ten steps {first:.4f}, "
              f"of the last ten {last:.4f})")
    else:
        print("OK: ran (too few steps to assert loss decrease)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args()
    if args.ckpt_dir:
        train(args, args.ckpt_dir)
    else:
        with tempfile.TemporaryDirectory() as d:
            train(args, d)


if __name__ == "__main__":
    main()
