"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by
name from ``BENCHMARK.json``: ``portbench/configs/``, ``traffic/``,
``limits/<cell>.json`` and ``metrics/<metric>.py``; the configuration
names its runner (``runners/<runner>.py``). Set-up (kernel builds, inputs
from the seed, the checked first steps) is timed as ``setup_s``; then the
window runs for ``--seconds``; with ``--trace 1`` one more chunk runs
under ``torch.profiler`` and the cell's per-layer metrics are read. Once
the window has closed and the program's state is freed, the reference
follows the checked steps and decides ``correct``. The last line of
standard output is the result, as JSON.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

from portbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(entries, window, prof, counts, cell) -> dict:
    ctx = {"window": window, "profile": prof, "counts": counts,
           "cell": cell}
    out = {}
    for m in entries:
        value = harness.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.cache_env()
    bench = harness.load_benchmark()
    cell, _, config, traffic, limits = harness.find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    runner = harness.load_module("runners", config["runner"])
    device = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    run = runner.Run(config, traffic, args.seed, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0
    window = run.window(args.seconds, spans=bool(args.trace))
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"]}
    prof = None
    if args.trace:
        traced = run.traced()
        prof = harness.profile_summary(traced["prof"])
        prof["iters"] = traced["iters"]
    device_info = harness.device_info(torch, cell["chips"])
    counts = run.counts()
    outputs = run.release()
    del run
    torch.cuda.empty_cache()
    e2e = dict(window["metrics"], setup_s=setup_s,
               peak_mem_gb=device_info["memory_peak_bytes"] / 1e9)
    entries = harness.cell_metrics(bench, cell["name"], bool(args.trace))
    if args.trace:
        metrics = per_layer(entries, dict(window, metrics=e2e), prof,
                            counts, cell)
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in entries}
    numbers = runner.compare(outputs, config, traffic, args.seed, device)
    correct, _ = harness.judge(numbers, limits)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    result.update(correct=correct, metrics=metrics, device=device_info,
                  checks={k: {"value": numbers.get(k), "limit": lim}
                          for k, lim in limits.items()})
    harness.print_checks(numbers, limits)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
