"""NetES-trains a registry transformer (a smoke variant) on the synthetic
corpus with the replica step of the PyTorch/CUDA port: the LM analogue of
the paper's experiment. The counterpart of ``examples/lm_netes_train.py``.

  PYTHONPATH=src python examples/lm_netes_train_torch.py \\
      --arch gemma3-4b-smoke --iters 200
  PYTHONPATH=src python examples/lm_netes_train_torch.py \\
      --arch whisper-tiny-smoke --iters 4 --device cpu
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.train.loop import TrainConfig, train_lm_netes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-4b-smoke")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--topology", default="erdos_renyi")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    tc = TrainConfig(
        n_agents=args.agents, iters=args.iters,
        topology_family=args.topology,
        netes=NetESConfig(alpha=1e-3, sigma=0.01, p_broadcast=0.8,
                          weight_decay=1e-4))
    hist = train_lm_netes(cfg, tc, seq_len=args.seq_len, log=print,
                          device=args.device)
    print(f"{args.arch} via NetES/{args.topology}: "
          f"loss {hist['loss_mean'][0]:.4f} → {hist['loss_mean'][-1]:.4f} "
          f"over {args.iters} iters")
    return hist


if __name__ == "__main__":
    main()
