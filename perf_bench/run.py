"""One run of one benchmark cell on the card(s) of this machine.

    python3 perf_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Loads the cell's files by name (see
``core``), makes its weights and traffic from ``--seed``, warms the shapes
the cell uses (counted in ``setup_s``), measures for ``--seconds``, then
checks what the measured path produced against the plain reference, and
prints one JSON line last on standard output: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from a device trace (``--trace
1``). Exits non-zero, with no result, without enough CUDA cards, or when a
JAX module is loaded once the window has closed. Compile caches stay in
``build/`` inside the checkout.
"""

from __future__ import annotations

import json
import os
import sys
import time

T_START = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# fixed cache directories inside the checkout (the CUDA kernels build into
# build/torch_kernels/ by the program's own rule)
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "torch_extensions")


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), else since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perf_bench import core
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    config = core.read_json("perf_bench", "configs", f"{cell['config']}.json")
    traffic = core.read_json("perf_bench", "traffic", f"{cell['traffic']}.json")
    limits = core.read_json("perf_bench", "limits", f"{args.workload}.json")

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perf_bench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"this machine has {n}", file=sys.stderr)
        return 2
    prog_cfg, ref_cfg = core.configs_of(config)
    job = core.Job(workload=args.workload, config=config, traffic=traffic,
                   limits=limits, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=torch.device("cuda", 0),
                   chips=cell["chips"], program_config=prog_cfg, ref_config=ref_cfg,
                   setup_origin=time.perf_counter() - process_age())
    outcome = core.driver(traffic["kind"]).run(job)

    found = core.forbidden_modules()
    if found:
        print(f"perf_bench: modules that may not load in a run are loaded: "
              f"{found}", file=sys.stderr)
        return 3

    metrics, breakdown = {}, None
    if args.trace:
        from perf_bench import timers
        for m in core.metrics_of(bench, args.workload, "per_layer"):
            reader = core.load_module("metrics", f"{m['name']}.py")
            value = reader.read(job, outcome)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        breakdown = timers.breakdown(outcome.trace)
    else:
        for m in core.metrics_of(bench, args.workload, "end_to_end"):
            metrics[m["name"]] = (outcome.end_to_end[m["name"]], m["unit"])
    device = core.device_info(outcome, cell["chips"],
                              outcome.trace if args.trace else None)
    print(f"setup_parts_s: {json.dumps(job.setup_parts)}", file=sys.stderr)
    print(f"comparison: {json.dumps(job.diagnostics)}", file=sys.stderr)
    for text in core.checks_text(outcome):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(outcome, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
