"""``BENCHMARK.json`` keeps to the contract's characters and keys, and
every name in it finds its files."""

import json
import os
import re

import pytest

from perf_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
BENCH = core.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(LINE.match(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"] == f"perf_bench/configs/{c['name']}.json"
        assert json.load(open(os.path.join(core.ROOT, c["file"])))["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads_find_their_files():
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        four += w["chips"] == 4
        assert NAME.match(w["traffic"])
        traffic = core.read_json("perf_bench", "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(core.BENCH_DIR, "drivers",
                                           f"{traffic['kind']}.py"))
        assert os.path.exists(os.path.join(core.BENCH_DIR, "limits",
                                           f"{w['name']}.json"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert os.path.exists(os.path.join(core.BENCH_DIR, "metrics", f"{m['name']}.py"))
        for w in m["workloads"]:
            assert w in cells
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
        layers.setdefault(m["layer"], m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in core.metrics_of(BENCH, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_of(BENCH, w["name"], "per_layer")


def test_each_configuration_is_the_programs_and_the_frozen_copys():
    for c in BENCH["configs"]:
        config = core.read_json(*c["file"].split("/"))
        prog, ref = core.configs_of(config)
        assert prog.model.inp_dim == ref.model.inp_dim == config["model"]["inp_dim"]


def test_a_configuration_is_its_file():
    """``reference/layout.from_file`` builds a configuration from its file
    alone, and refuses a file that leaves a field to a default."""
    from perf_bench.reference import layout
    config = core.read_json("perf_bench", "configs", "dense384.json")
    ref = layout.from_file(config)
    assert ref.model.inp_dim == 384 and ref.height == 384 and ref.infer.boxsize == 512
    wider = dict(config, width=640, infer=dict(config["infer"], boxsize=640))
    assert layout.from_file(wider).infer.boxsize == 640
    short = dict(config, aug={k: v for k, v in config["aug"].items() if k != "sigma"})
    with pytest.raises(ValueError):
        layout.from_file(short)
