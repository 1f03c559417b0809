"""``repro_torch.analysis`` — the contract linter of the PyTorch port: the
port's counterpart of ``repro.analysis``.

Two layers enforce the port's invariants (ROADMAP: no host sync inside
the step loop, a step capturable as one CUDA graph, every draw at an
explicit seam):

* **Layer 1 (AST)** — ``ast_rules``: source rules for host syncs and
  tensor-valued branches in step code, draws from the global generator,
  and factory calls without a dtype.
* **Layer 2 (ops)** — ``contracts`` + ``registry``: the registered entry
  points (core run/scheduled, probed and not, the replica and consensus
  steps, the sharded fleet and its seams, the permute mixers, the fused
  wire kernels) run once on fake tensors under ``launch.op_costs``'s
  recorder; their recorded ops are checked for host syncs, unstable
  state, rank-divergent collectives and fused seam products.

CLI: ``python -m repro_torch.analysis --strict``. Inline suppression:
``# repro: allow[rule-id] -- justification``.
"""
from .ast_rules import RULES, run_rules
from .contracts import CONTRACT_IDS, check_entry_point, run_contracts
from .findings import Finding
from .registry import EntryPoint, iter_entry_points

__all__ = [
    "CONTRACT_IDS", "EntryPoint", "Finding", "RULES",
    "check_entry_point", "iter_entry_points", "run_contracts", "run_rules",
]
