"""Serve times of two trees of this repository, in turns, on one card.

Each turn is a fresh process that imports ``repro_torch`` and
``chip_smoke`` from one tree and, for each ``arch:run`` case, draws the
weights as ``chip_smoke.serve_phase`` does (full depth, seed 0, float32),
makes that run's prompts and frontend inputs, and times ``reps`` greedy
generations with CUDA events (``chip_smoke._greedy``): the prefill and
the median of the decode steps. A line ``AB {...}`` a turn carries the
numbers; the tree's name is printed before it.

    python3 tools/serve_decode_ab.py --tree parent=_checkout/parent \\
        --tree change=. --order parent,change,change,parent \\
        --case gemma3-4b:b --case whisper-tiny:c

Both trees must hold ``chip_smoke.py`` with ``_greedy``,
``_frontend_inputs``, ``_served``, ``SERVE_RUNS``, ``NEW_TOKENS`` and
``WHISPER_SERVE_RUNS``. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def measure(tree: pathlib.Path, cases, reps: int) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import chip_smoke as cs
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer

    _build.build_all()
    out = {}
    for case in cases:
        arch, run = case.split(":")
        runs = cs.WHISPER_SERVE_RUNS if arch == cs.WHISPER_ARCH \
            else cs.SERVE_RUNS
        _, b, s = next(r for r in runs if r[0] == run)
        cfg = get_config(arch)
        params = transformer.init_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(10 + b)
        prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                                device="cuda")
        served = cs._served(cs._frontend_inputs(cfg, b, "cuda"))
        cs._greedy(params, cfg, prompts, cs.NEW_TOKENS, extra=served)
        prefill, decode = [], []
        for _ in range(reps):
            _, _, times = cs._greedy(params, cfg, prompts, cs.NEW_TOKENS,
                                     timed=True, extra=served)
            prefill.append(times[0])
            decode.append(statistics.median(times[1:]))
        out[case] = {"prefill_ms": prefill, "decode_median_ms": decode}
        del params, prompts, served
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="name=directory of a checkout (repeatable)")
    ap.add_argument("--order", default="",
                    help="comma-separated tree names, one turn each")
    ap.add_argument("--case", action="append", default=[],
                    help="arch:run, a run of chip_smoke's serve phase")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed generations a case a turn")
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print("AB " + json.dumps(measure(pathlib.Path(args.measure).resolve(),
                                         args.case, args.reps)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    for name in args.order.split(","):
        print(f"TREE {name}", flush=True)
        cmd = [sys.executable, __file__, "--measure", trees[name],
               "--reps", str(args.reps)]
        for case in args.case:
            cmd += ["--case", case]
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
