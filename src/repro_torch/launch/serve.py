"""Serving launcher of the port: batched generation with a registry arch.

  python -m repro_torch.launch.serve --arch mistral-nemo-12b --batch 1 \
      --prompt-len 8192 --new-tokens 16
  python -m repro_torch.launch.serve --arch rwkv6-7b --batch 1 \
      --prompt-len 8192 --new-tokens 16
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b-smoke --batch 2 \
      --prompt-len 128 --new-tokens 8 --device cpu
  python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e-smoke \
      --batch 2 --prompt-len 192 --new-tokens 8 --device cpu
  python -m repro_torch.launch.serve --arch whisper-tiny --batch 1 \
      --prompt-len 4 --new-tokens 16
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b \
      --batch 1 --prompt-len 512 --new-tokens 16

Random weights and prompts from ``--seed``, and for whisper and llava the
frontends' stub frames or patches (the engine drops llava's patches, as
the reference's does). Runs on the GPU; ``--device cpu`` runs the
kernels' plain versions on the CPU instead. A prompt
longer than an MoE layer's group (512 tokens; 64 for the smokes) must be
a multiple of it. jamba-v0.1-52b's 32 layers (205 GB in float32) do not
fit one card: ``chip_smoke.py`` serves 8 of them; of llama4-scout-17b-a16e's
48 (402.8 GB) it serves 4, one period of 3 chunked layers and a global
one, and of llama4-maverick-400b-a17b's (1.57 TB) 2.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import frontends, transformer
from ..serve import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = transformer.init_params(cfg, seed=args.seed, device=args.device)
    engine = ServeEngine(cfg, params,
                         max_len=args.prompt_len + args.new_tokens,
                         device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=args.device)
    extra = {}
    if cfg.frontend == "audio":
        extra["frames"] = frontends.audio_frames(cfg, args.batch, gen)
    elif cfg.frontend == "vision":
        extra["patch_embeds"] = frontends.vision_patches(cfg, args.batch, gen)
    t0 = time.perf_counter()
    out = engine.generate(prompts, new_tokens=args.new_tokens,
                          temperature=args.temperature, generator=gen,
                          extra_batch=extra)
    dt = time.perf_counter() - t0
    total = args.batch * args.new_tokens
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. prefill)")
    print(out[:2])


if __name__ == "__main__":
    main()
