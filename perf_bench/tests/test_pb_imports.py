"""Nothing a run loads may be JAX or the JAX package, compared by whole
top-level names (the port's own name begins with the JAX package's); the
plain reference loads nothing of the program either. Each check runs in a
fresh interpreter, so what this test process imported does not count."""

import ast
import glob
import os
import subprocess
import sys

from perf_bench import core

BENCH = core.BENCH_DIR
PORT = "improved_body_parts_tpu_torch"


def loaded_top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=core.ROOT, capture_output=True, text=True, timeout=300,
                         check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module():
    # the entry point, every driver and reader, and the program modules
    # the drivers call into
    code = "\n".join([
        "import perf_bench.run, perf_bench.calibrate",
        "from perf_bench import core",
        "import glob, os",
        "for p in glob.glob(os.path.join(core.BENCH_DIR, 'drivers', '*.py'))"
        " + glob.glob(os.path.join(core.BENCH_DIR, 'metrics', '*.py')):",
        "    core.load_module(os.path.basename(os.path.dirname(p)), os.path.basename(p))",
        "from improved_body_parts_tpu_torch import train_lib",
        "from improved_body_parts_tpu_torch.infer import predict, serving",
        "from improved_body_parts_tpu_torch.models import imhn, quantize",
        "from improved_body_parts_tpu_torch.ops import group_cpp",
    ])
    found = loaded_top_levels(code) & set(core.FORBIDDEN)
    assert not found, found


def test_the_reference_loads_nothing_of_the_program():
    code = ("import perf_bench.reference.post, perf_bench.reference.train, "
            "perf_bench.reference.model, perf_bench.scenes, perf_bench.weights, "
            "perf_bench.counts, perf_bench.timers")
    found = loaded_top_levels(code) & (set(core.FORBIDDEN) | {PORT})
    assert not found, found


def test_no_reference_source_names_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in set(core.FORBIDDEN) | {PORT}, (path, n)


def test_the_guard_compares_whole_names(monkeypatch):
    before = core.forbidden_modules()
    monkeypatch.setitem(sys.modules, PORT + ".probe", object())
    assert core.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "improved_body_parts_tpu.ops", object())
    assert "improved_body_parts_tpu" in core.forbidden_modules()
