"""The result line: the contract's keys, the checks under a key of their
own last."""

import json

from perf_bench import core


def outcome(value=0.5):
    return core.Outcome(attempted=10, failed=0, end_to_end={}, layer={},
                        checks=[core.Check("gap", value, 1.0)],
                        memory_peak_bytes=123)


def test_keys_and_order():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 123}
    line = json.loads(core.result_line(outcome(), {"m": (1.5, "ms")}, dev, None))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"m": {"value": 1.5, "unit": "ms"}}
    assert line["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    traced = json.loads(core.result_line(outcome(2.0), {}, dict(dev, busy_s=1.0, window_s=2.0),
                                         {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device",
                            "breakdown", "checks"]
    assert traced["correct"] is False


def test_a_run_with_no_check_or_a_failure_is_not_correct():
    assert not core.Outcome(1, 0, {}, {}, [], 0).correct
    assert not core.Outcome(1, 1, {}, {}, [core.Check("g", 0.0, 1.0)], 0).correct
    assert not core.Outcome(0, 0, {}, {}, [core.Check("g", 0.0, 1.0)], 0).correct
    assert not core.Check("nan", float("nan"), 1.0).ok
