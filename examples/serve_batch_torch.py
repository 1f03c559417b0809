"""Batched serving with a registry arch on the PyTorch/CUDA port: prefill
and decode, with the frontends' stub frames (whisper) or patch embeddings
(llava, which the engine drops, as the reference's does). The counterpart
of ``examples/serve_batch.py``.

  PYTHONPATH=src python examples/serve_batch_torch.py --arch whisper-tiny
  PYTHONPATH=src python examples/serve_batch_torch.py \\
      --arch llava-next-mistral-7b-smoke --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import frontends, transformer
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-4b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = transformer.init_params(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, params, max_len=64, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, 8),
                            generator=gen, device=args.device)
    extra = {}
    if cfg.frontend == "vision":
        extra["patch_embeds"] = frontends.vision_patches(cfg, args.batch, gen)
    elif cfg.frontend == "audio":
        extra["frames"] = frontends.audio_frames(cfg, args.batch, gen)
    t0 = time.perf_counter()
    out = engine.generate(prompts, new_tokens=args.new_tokens,
                          extra_batch=extra)
    print(f"{args.arch}: generated {out.shape} in "
          f"{time.perf_counter() - t0:.1f}s")
    print(out)
    return out


if __name__ == "__main__":
    main()
