"""``python -m repro_torch.analysis`` — the port's contract linter CLI
(the port of ``repro.analysis.cli``).

Layers:

* ``ast``       — AST rules over the port's source (no trace, sub-second;
  the default for quick local runs)
* ``contracts`` — the registered entry points run on fake tensors, their
  recorded ops checked
* ``all``       — both (what ``--strict`` implies)

Exit status is 0 iff there are zero unsuppressed findings. The entry
points of more than one rank run once per rank of a fake process group
(``launch.dryrun.start_fake_group``), made and torn down here.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .findings import Finding

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "examples/*_torch.py", "chip_smoke.py")


def _default_paths() -> List[Path]:
    out: List[Path] = []
    for p in DEFAULT_PATHS:
        out.extend(sorted(REPO_ROOT.glob(p)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contract linter of the PyTorch port: AST rules "
                    "+ op contracts of its entry points.")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/directories for the AST layer "
                         f"(default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--strict", action="store_true",
                    help="run every rule tier AND the op contract layer; "
                         "exit 1 on any unsuppressed finding")
    ap.add_argument("--layer", choices=("ast", "contracts", "all"),
                    default=None,
                    help="which layer to run (default: ast, or all "
                         "under --strict)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated AST rule ids to run")
    ap.add_argument("--entry-points", default=None,
                    help="comma-separated entry-point names to check")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print findings silenced by inline allows")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--list-entry-points", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        from .ast_rules import RULES
        for r in RULES.values():
            print(f"{r.id:24s} [{r.tier}] {r.doc}")
        if not args.list_entry_points:
            return 0
    if args.list_entry_points:
        from .registry import iter_entry_points
        for ep in iter_entry_points():
            extras = []
            if ep.min_devices > 1:
                extras.append(f"min_devices={ep.min_devices}")
            if ep.min_products:
                extras.append(f"min_products={ep.min_products}")
            tail = f" ({', '.join(extras)})" if extras else ""
            print(f"{ep.name:40s} {', '.join(ep.contracts)}{tail}")
        return 0

    layer = args.layer or ("all" if args.strict else "ast")
    findings: List[Finding] = []

    if layer in ("ast", "all"):
        from .ast_rules import run_rules
        rules = args.rules.split(",") if args.rules else None
        paths = args.paths or _default_paths()
        findings.extend(run_rules(paths, rules=rules, strict=args.strict))

    if layer in ("contracts", "all"):
        from .contracts import run_contracts
        names = args.entry_points.split(",") if args.entry_points else None
        findings.extend(run_contracts(names))

    live = [f for f in findings if not f.suppressed]
    shown = findings if args.show_suppressed else live
    for f in shown:
        print(f.render())
    n_sup = sum(1 for f in findings if f.suppressed)
    print(f"{len(live)} finding(s), {n_sup} suppressed "
          f"[layer={layer}{', strict' if args.strict else ''}]")
    return 1 if live else 0


if __name__ == "__main__":
    sys.exit(main())
