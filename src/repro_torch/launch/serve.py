"""Serving driver, LM path: step-wise prefill + decode with a KV cache.

The port of the reference's ``launch/serve.py`` for language models. On a
CUDA device every attention runs through the hand-written flash kernel and
every MoE dispatch through the hand-written gather kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

``--smoke`` takes the reduced same-family config in float32 (the full
config runs in bfloat16, as the reference runs it); ``--device cpu`` runs
the plain PyTorch versions of the kernels on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
        --device cpu

Without ``--device`` the run needs a GPU and raises without one. Graph
serving (``--graph``) is not ported yet (ROADMAP slice A5).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..core.session import resolve_device
from ..models import Model


@torch.no_grad()
def generate(model: Model, prompts: torch.Tensor, gen_len: int, greedy: bool = True,
             seed: int = 0, step_s: Optional[List[float]] = None) -> torch.Tensor:
    """Prefill via step-wise cache fill, then decode ``gen_len`` tokens.

    ``prompts [B, P]`` (int64 on the model's device) -> ``[B, gen_len]``.
    Greedy takes the first maximum, as ``argmax`` does; sampling draws from
    a ``torch.Generator`` seeded with ``seed``. A list passed as ``step_s``
    receives the seconds of every decode step, each ended by a device
    synchronise (only then does a step wait for the card).
    """
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + gen_len)
    gen = torch.Generator(device=prompts.device).manual_seed(seed)

    def step(tok):
        nonlocal cache
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok)
        if step_s is not None:
            if prompts.is_cuda:
                torch.cuda.synchronize(prompts.device)
            step_s.append(time.perf_counter() - t0)
        return logits

    logits = None
    for t in range(plen):  # prefill (teacher forcing the prompt)
        logits = step(prompts[:, t:t + 1])
    out = []
    for _ in range(gen_len):
        last = logits[:, -1]
        if greedy:
            tok = torch.argmax(last, dim=-1, keepdim=True)
        else:
            tok = torch.multinomial(torch.softmax(last.float(), dim=-1), 1, generator=gen)
        out.append(tok)
        logits = step(tok)
    return torch.cat(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LM decode serving on the port")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config, in float32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--graph", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.graph is not None:
        ap.error("graph serving is not ported yet (ROADMAP slice A5)")

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    model = Model(cfg, dtype=torch.float32 if args.smoke else torch.bfloat16, device=device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
                               ).to(device)
    t0 = time.perf_counter()
    toks = generate(model, prompts, args.gen_len)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    n = args.batch * (args.prompt_len + args.gen_len)
    print(f"generated {tuple(toks.shape)} tokens on {device} in {dt:.2f}s ({n / dt:.1f} tok/s)")
    print(toks.numpy()[:2])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
