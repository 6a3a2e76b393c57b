"""Serving launcher: batched prefill + autoregressive decode -- the port of
``repro/launch/serve.py``.

``python -m repro_torch.launch.serve --arch smollm-135m --tokens 32``
(on the card; add ``--reduced --device cpu`` on a host without one)

The two-phase server loop: prefill the prompt batch (every plain causal
attention layer through the folded causal attention kernel; builds the
KV caches and recurrent states), then step the decode loop with greedy
or temperature sampling.  ``--arch`` takes every architecture of
:mod:`repro_torch.configs`; those that take frontend embeddings
(musicgen-medium, qwen2-vl-7b) are served by examples/torch_serve_lm.py.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.batched import resolve_device
from repro_torch.models import lm

__all__ = ["generate", "sample", "main"]


def sample(logits, temperature=0.0, generator=None):
    """Greedy (temperature 0: argmax, the first maximum, as jnp.argmax
    takes) or a draw from softmax(logits / temperature)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model, prompt_tokens, steps, *, max_len=None, temperature=0.0,
             generator=None, embeds=None, positions=None):
    """prompt_tokens: (B, S) integer on the model's device -> (B, steps)
    generated ids (int64).  The first is sampled from the prefill's
    logits, each next one from a decode step.

    A frontend-embedding model (``embed_inputs``) takes ``embeds``
    (B, S, d) with ``prompt_tokens`` None, and each decode step is fed
    the generated token's row of the embedding table, as
    examples/serve_lm.py feeds them; ``positions`` (B, S), or (3, B, S)
    for M-RoPE, go to the prefill."""
    x = prompt_tokens if embeds is None else embeds
    B, S = x.shape[:2]
    max_len = max_len or (S + steps)
    logits, states = model.prefill(prompt_tokens, max_len, embeds=embeds,
                                   positions=positions)
    tok = sample(logits, temperature, generator)
    out = [tok]
    for i in range(steps - 1):
        if embeds is None:
            logits, states = model.decode_step(tok[:, None], states, S + i)
        else:
            logits, states = model.decode_step(
                None, states, S + i, embeds=model.embed[tok][:, None])
        tok = sample(logits, temperature, generator)
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    cfg = configs.reduced(args.arch) if args.reduced \
        else configs.get(args.arch)
    if cfg.embed_inputs:
        raise SystemExit(f"{args.arch} serves from frontend embeddings; "
                         "see examples/torch_serve_lm.py for the stubbed "
                         "flow")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = lm.init(cfg, gen, device)
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    t0 = time.perf_counter()
    out = generate(model, prompts, args.tokens,
                   temperature=args.temperature, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {args.batch}x{args.tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s) on {device}")
    print(out[:, :16].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
