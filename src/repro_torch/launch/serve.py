"""Runnable serving driver: batched prefill + greedy decode of a reduced
architecture, on the CUDA card unless `--device cpu` is given.

Counterpart of `repro.launch.serve`, with its flags and defaults:

    python -m repro_torch.launch.serve [--arch qwen2-0.5b] [--batch 4]
        [--prompt-len 32] [--gen-len 32] [--device cpu]

Weights are random, drawn from a generator seeded with 0; the prompt is
drawn from `numpy.random.default_rng(0)`. The reference's host mesh and
activation shardings have no counterpart in one process on one device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.platform import resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_lib import greedy_generate


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path (per spec)")
    device = resolve_device(args.device)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(device)
    t0 = time.perf_counter()
    out = greedy_generate(model, params, prompt, steps=args.gen_len,
                          s_max=args.prompt_len + args.gen_len)
    out = out.cpu()                 # waits for the device
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen_len
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, batch={args.batch})")
    print("sample token ids:", out[0, :16].numpy())
    return out


if __name__ == "__main__":
    main()
