"""Readings of a cell's comparison over many seeds: the numbers the
limits of ``limits/<workload>.json`` are set from.

    python3 perf_bench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--candidate <name>] [--set key=value ...]

Each seed runs the cell's driver as a run of the benchmark does (set-up,
a window of ``--seconds``, the comparison), with every limit open, in a
process of its own (two runs in one process have hung on the card), and
prints one JSON line: the seed, the candidate, each number compared, what
the comparison saw, and the end-to-end metrics. ``--candidate`` puts a
control or a fault in the program's place (``int8``: the program's int8
serving path; ``fp8``: the plain training step in fp8; ``half_batch``:
the plain step on half of each batch; ``frozen``: the program's step with
its state put back after each call; ``jitter``: the plain step on images
moved by one part in 2^20, a witness of how far rounding moves each
number). ``--set`` overrides a
parameter of the traffic mix (a JSON value), for a probe. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--candidate", default=None)
    p.add_argument("--set", nargs="*", default=[])
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds a seed may take before its stacks are dumped")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not args.one:
        for seed in args.seeds:
            cmd = [sys.executable, os.path.abspath(__file__), "--one",
                   "--workload", args.workload, "--seconds", str(args.seconds),
                   "--seeds", str(seed), "--timeout", str(args.timeout)]
            if args.candidate:
                cmd += ["--candidate", args.candidate]
            if args.set:
                cmd += ["--set", *args.set]
            subprocess.run(cmd, timeout=args.timeout + 60)
        return 0
    faulthandler.dump_traceback_later(args.timeout, exit=True)

    import torch
    from perf_bench import core
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    config = core.read_json("perf_bench", "configs", f"{cell['config']}.json")
    traffic = core.read_json("perf_bench", "traffic", f"{cell['traffic']}.json")
    for kv in args.set:
        k, v = kv.split("=", 1)
        traffic[k] = json.loads(v)
    limits = {k: float("inf") for k in
              core.read_json("perf_bench", "limits", f"{args.workload}.json")}
    drv = core.driver(traffic["kind"])
    for seed in args.seeds:
        prog_cfg, ref_cfg = core.configs_of(config)
        job = core.Job(workload=args.workload, config=config, traffic=traffic,
                       limits=limits, seed=seed, seconds=args.seconds, trace=False,
                       device=torch.device("cuda", 0), chips=cell["chips"],
                       program_config=prog_cfg, ref_config=ref_cfg,
                       candidate=args.candidate, setup_origin=time.perf_counter())
        out = drv.run(job)
        print(json.dumps({"seed": seed, "candidate": args.candidate,
                          "set": args.set,
                          "readings": {c.name: c.value for c in out.checks},
                          "diagnostics": job.diagnostics,
                          "end_to_end": out.end_to_end}), flush=True)
        del out, job
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
