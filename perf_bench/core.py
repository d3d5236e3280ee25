"""The harness: one cell's files found by name, the run's environment, and
the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. The configuration is ``configs/<config>.json``; the traffic
mix ``traffic/<traffic>.json`` names its ``kind``, the driver
``drivers/<kind>.py`` that generates that kind of traffic from the mix's
parameters; the limits of the comparison that decides ``correct`` are
``limits/<workload>.json``; each per-layer metric is ``metrics/<name>.py``,
a reader of what the driver recorded. A later cell, mix, configuration or
metric is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a run (whole names: the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "improved_body_parts_tpu")


@dataclasses.dataclass
class Job:
    """What a driver needs for one run."""
    workload: str
    config: dict              # configs/<config>.json
    traffic: dict             # traffic/<traffic>.json
    limits: dict              # limits/<workload>.json
    seed: int
    seconds: float
    trace: bool
    device: Any               # torch.device
    chips: int = 1
    program_config: Any = None   # the program's CanonicalConfig
    ref_config: Any = None       # the benchmark's frozen copy of it
    candidate: Optional[str] = None   # None: the program; else a control or fault
    setup_origin: float = 0.0         # time.perf_counter() at process start
    # what the comparison saw besides its numbers, printed on stderr
    diagnostics: dict = dataclasses.field(default_factory=dict)
    # seconds of each part of the set-up, printed on stderr
    setup_parts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Check:
    """One number of the comparison, beside its limit (``value <= limit``)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the counts, the end-to-end metrics, what the
    per-layer readers read, the comparison and the device."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    layer: Dict[str, Any]
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[dict] = None      # timers.DeviceTrace.result

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) \
            and self.failed == 0 and self.attempted > 0


def read_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json("BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_module(*parts: str):
    """A module of the benchmark by its file path (names may hold dots)."""
    path = os.path.join(BENCH_DIR, *parts)
    name = "perf_bench_" + "_".join(parts).replace(".", "_").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module("drivers", f"{kind}.py")


def dtype(name: str):
    """A traffic mix's compute type by name."""
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _plain(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)


def configs_of(config: dict):
    """(the program's configuration named by the file's
    ``program_config``, the configuration the file states
    (``reference/layout.from_file``)). The two must be equal, field for
    field: a program whose named configuration has moved fails here. The
    program runs on the first; the traffic and the reference read only the
    second."""
    from improved_body_parts_tpu_torch import configs
    from perf_bench.reference import layout
    name = config["program_config"]
    prog, ref = configs.get_config(name), layout.from_file(config)
    if _plain(prog) != _plain(ref):
        raise ValueError(f"the program's {name} differs from "
                         f"configs/{config['name']}.json")
    return prog, ref


def setup_parts(origin: float, marks: Dict[str, float], end: float) -> Dict[str, float]:
    """Seconds of each part of a set-up from the times that end them
    (``marks``, in order): the first part from ``origin``, then each from
    the one before, and ``to_window`` from the last mark to ``end``."""
    times = [origin] + list(marks.values()) + [end]
    return {n: times[i + 1] - times[i] for i, n in enumerate(list(marks) + ["to_window"])}


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``workload`` reports."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(outcome: Outcome, chips: int, trace: Optional[dict]) -> dict:
    import torch
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def result_line(outcome: Outcome, metrics: Dict[str, Tuple[float, str]],
                device: dict, breakdown: Optional[dict]) -> str:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed,
            "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return json.dumps(line)


def checks_text(outcome: Outcome) -> List[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}" for c in outcome.checks]
