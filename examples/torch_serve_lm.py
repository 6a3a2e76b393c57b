"""Batched serving on the PyTorch/CUDA port: prefill + autoregressive
decode.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch smollm-135m
    PYTHONPATH=src python examples/torch_serve_lm.py --arch rwkv6-3b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch musicgen-medium --device cpu

The port's counterpart of examples/serve_lm.py.  Runs the reduced config
of any architecture of :mod:`repro_torch.configs` with random weights
from a seeded ``torch.Generator``: a random prompt batch (or stub frame /
patch embeddings of 0.02 N(0, 1) for the audio and vision-language
architectures, with (3, B, S) M-RoPE positions for qwen2-vl), a prefill
of the decode states, then greedy tokens streamed through
``repro_torch.launch.serve.generate``.  Exercises every mixer's decode
path (KV cache, sliding-window ring, RG-LRU state, RWKV-6 matrix state)
and MoE routing.  On the card the plain causal attention layers' prefill
runs the folded attention kernel, built at first use.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.batched import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = configs.reduced(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.init(cfg, gen, device)
    B, S, T = args.batch, args.prompt_len, args.tokens

    tokens = embeds = positions = None
    if cfg.embed_inputs:            # audio / vlm: stubbed frontend embeddings
        embeds = torch.randn((B, S, cfg.d_model), generator=gen,
                             device=device) * 0.02
    else:
        tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                               device=device)
    if cfg.pos_type == "mrope":
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device).expand(3, B, S)

    t0 = time.time()
    out = serve.generate(model, tokens, T + 1, embeds=embeds,
                         positions=positions)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{args.arch} (reduced) on {device}: prefill {B}x{S} + "
          f"{T} decode steps in {dt:.2f}s ({B * T / dt:.0f} tok/s)")
    print("sample ids:", out[0, :16].tolist())
    assert out.shape == (B, T + 1)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    print("OK")


if __name__ == "__main__":
    main()
