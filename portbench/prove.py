"""The readings a cell's limits are set from, at the cell's own size:

    python3 portbench/prove.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--faults a,b]
        [--out FILE]

For each seed of ``--seeds`` the program's checked steps (set-up, no
window) against the reference; for each of ``--control-seeds`` the
control (the reference in TF32 put in the program's place); for each of
``--fault-seeds`` the program with each planted fault of ``faults.py``;
for each of ``--f32-seeds`` the plain reference in float32 in the
program's place.
One JSON line a reading, on standard output and appended to ``--out``.
The benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from portbench import faults, harness  # noqa: E402


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--f32-seeds", type=seeds, default=[],
                    help="the plain reference in float32 in the program's "
                         "place: a witness of float32's own spread")
    ap.add_argument("--faults", default="",
                    help="comma-separated fault names (default: all)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    cell, _, config, traffic, limits = harness.find_cell(
        harness.load_benchmark(), args.workload)
    runner = harness.load_module("runners", config["runner"])
    device = torch.device("cuda", 0)

    def emit(seed, side, numbers, t0):
        correct, failed = harness.judge(numbers, limits)
        line = json.dumps({"workload": cell["name"], "seed": seed,
                           "side": side, "numbers": numbers,
                           "correct": correct, "failed": failed,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def program(seed, fault=None):
        t0 = time.perf_counter()
        with (faults.FAULTS[config["runner"]][fault]() if fault
              else contextlib.nullcontext()):
            outputs = runner.Run(config, traffic, seed, device).release()
        torch.cuda.empty_cache()
        numbers = runner.compare(outputs, config, traffic, seed, device)
        del outputs
        torch.cuda.empty_cache()
        emit(seed, fault or "program", numbers, t0)

    for seed in args.seeds:
        program(seed)
    for side, precision, chosen in (("control", "tf32", args.control_seeds),
                                    ("f32", "f32", args.f32_seeds)):
        for seed in chosen:
            t0 = time.perf_counter()
            outputs = runner.control_outputs(config, traffic, seed, device,
                                             precision)
            numbers = runner.compare(outputs, config, traffic, seed, device)
            del outputs
            torch.cuda.empty_cache()
            emit(seed, side, numbers, t0)
    names = ([f for f in args.faults.split(",") if f]
             or list(faults.FAULTS[config["runner"]]))
    for seed in args.fault_seeds:
        for name in names:
            program(seed, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
