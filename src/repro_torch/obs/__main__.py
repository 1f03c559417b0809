"""``python -m repro_torch.obs`` — trace file tooling.

    python -m repro_torch.obs summarize run.trace.jsonl
    python -m repro_torch.obs validate  run.trace.jsonl   (exit 1 on violation)
"""
from __future__ import annotations

import argparse
import sys

from .trace import summarize, validate_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd in ("summarize", "validate"):
        p = sub.add_parser(cmd)
        p.add_argument("trace", help="path to a trace .jsonl file")
    args = ap.parse_args(argv)

    if args.cmd == "validate":
        errors = validate_trace(args.trace)
        for e in errors:
            print(f"VIOLATION: {e}", file=sys.stderr)
        print(f"{args.trace}: " + ("INVALID" if errors else "ok"))
        return 1 if errors else 0

    print(summarize(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
