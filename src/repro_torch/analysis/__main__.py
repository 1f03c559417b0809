"""``python -m repro_torch.analysis``: the contract linter's CLI (``cli``)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
